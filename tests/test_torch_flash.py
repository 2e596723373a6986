"""K2 (flash attention) and the prefill step in the port, against the
JAX reference.

On the CPU the port's ``flash_attention`` takes the kernel's plain version
(``repro_torch.kernels.ref.flash_attention_ref``); it is held against the
reference's Pallas kernel run in interpret mode and its jnp oracle over the
reference's own cells (``tests/test_kernels.py``), plus a head_dim-80
windowed cell and a non-causal windowed cell (the window is one-sided).
``attention_train(flash=True)`` and ``make_prefill_step(cfg, flash=True)``
are held against the reference's, which reach the Pallas kernel, on every
ported dense smoke config at tokens (2, 200) — not a multiple of the
reference kernel's 128 tile — with and without a window. The CUDA kernel
itself is held against the plain version on the card by the tests marked
``cuda`` (skipped without a card) and by ``chip_smoke.py``.

Tolerances: the reference's for the kernel, f32 atol 2e-5 and bf16 3e-2;
1e-4 on logits, as the port's forward test; 2e-5 between the port's own
flash and einsum paths, which differ in summation order only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels.flash_attention import (
    FlashAttention, flash_attention_cuda,
)
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import attention as port_attn
from repro_torch.models import transformer as port_tfm
from repro_torch.train import steps as port_steps

from test_torch_reference import (  # noqa: F401
    _one_torch_thread, port_cfg, port_params, reference)

F32_ATOL = 2e-5
BF16_ATOL = 3e-2
# on the card a bf16 result must also stay within 2^-6 relative RMS of the
# plain one, as chip_smoke.py holds it: at S = 1000 an output is about
# 1/sqrt(S) ~ 0.03, as large as BF16_ATOL
BF16_REL = 2.0 ** -6
LOGITS_ATOL = 1e-4


def _qkv(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, kv, hd)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", [
    (2, 128, 4, 2, 64, True, None),        # the reference's four cells
    (1, 200, 4, 4, 32, True, 64),
    (2, 256, 8, 2, 64, False, None),
    (1, 130, 2, 1, 128, True, 32),
    (1, 200, 4, 2, 80, True, 48),          # zamba2's head_dim, windowed
    (1, 200, 4, 1, 64, False, 48),         # one-sided window, no causal
])
def test_flash_attention_matches_reference(reference, b, s, h, kv, hd,
                                           causal, window):
    q, k, v = _qkv(b, s, h, kv, hd, seed=s + hd)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, hd)
    jq, jk, jv = (reference.jnp.asarray(a) for a in (q, k, v))
    want_kernel = reference.flash_attention_kernel(
        jq, jk, jv, causal=causal, window=window, interpret=True)
    want_ref = reference.ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               atol=F32_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref),
                               atol=F32_ATOL)
    # on the CPU the entry point is the plain version, bit for bit
    np.testing.assert_array_equal(
        got.numpy(), port_ref.flash_attention_ref(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
            window=window).numpy())


def test_flash_attention_bf16_matches_reference(reference):
    b, s, h, kv, hd = 1, 128, 4, 2, 64
    q, k, v = _qkv(b, s, h, kv, hd, seed=3)
    jnp = reference.jnp
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = reference.flash_attention_kernel(jq, jk, jv, causal=True,
                                            interpret=True)
    got = flash_attention(*(torch.from_numpy(a).bfloat16()
                            for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL)


@pytest.mark.parametrize("window,qk_norm", [(None, False), (5, False),
                                            (None, True)])
def test_attention_train_flash_matches_reference(reference, window, qk_norm):
    cfg = dataclasses.replace(reference.get_arch("llama3-8b", smoke=True),
                              vocab=1024, qk_norm=qk_norm)
    jax, jnp = reference.jax, reference.jnp
    ap = reference.attention.init_attention(jax.random.PRNGKey(4), cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    want = reference.attention.attention_train(
        ap, cfg, jnp.asarray(x), jnp.asarray(pos), window=window, flash=True)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in ap.items()}
    got = port_attn.attention_train(tp, port_cfg(cfg), torch.from_numpy(x),
                                    torch.from_numpy(pos), window=window,
                                    flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    # the einsum path of the port agrees: only the summation order differs
    plain = port_attn.attention_train(tp, port_cfg(cfg), torch.from_numpy(x),
                                      torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=F32_ATOL)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("arch,head_dim", [
    ("llama3-8b", None), ("granite-8b", None), ("qwen3-1.7b", None),
    ("stablelm-1.6b", None),
    ("qwen3-1.7b", 128),       # head_dim 128 from d_model 256 / 4 heads
])
def test_prefill_step_matches_reference(reference, arch, head_dim, window):
    """make_prefill_step(cfg, flash=True), port against reference (whose
    flash path runs the Pallas kernel in interpret mode), at (2, 200)
    tokens: the reference pads 200 to 256 and masks, the port does not
    pad. The smoke configs cover GQA (llama3, granite), qk-norm (qwen3),
    layernorm and MHA (stablelm); the last case a head_dim other than
    d_model / n_heads."""
    cfg = reference.get_arch(arch, smoke=True)
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    if window is not None:
        cfg = cfg.with_window(window)
    jp = reference.tfm.init_params(reference.jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 200)).astype(
        np.int32)
    want = reference.steps.make_prefill_step(cfg, flash=True)(
        jp, {"tokens": reference.jnp.asarray(toks)})
    got = port_steps.make_prefill_step(port_cfg(cfg), flash=True)(
        port_params(jp, cfg), {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 200, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("window", [None, 64])
def test_prefill_flash_matches_plain_step(window):
    """The port's flash=True prefill against its own flash=False prefill,
    einsum and chunked attention, on fresh params."""
    cfg = get_arch("llama3-8b", smoke=True)
    if window is not None:
        cfg = cfg.with_window(window)
    params = port_tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 256)).astype(np.int32))
    batch = {"tokens": toks}
    flash = port_steps.make_prefill_step(cfg, flash=True)(params, batch)
    for plain_cfg in (cfg, dataclasses.replace(cfg, attn_chunk=64)):
        plain = port_steps.make_prefill_step(plain_cfg, flash=False)(
            params, batch)
        np.testing.assert_allclose(flash.numpy(), plain.numpy(),
                                   atol=F32_ATOL)


def test_flash_attention_cuda_refuses_cpu_tensors():
    """The kernel's wrapper never runs the plain version: a tensor that is
    not on a CUDA device raises, and nothing is counted."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 4, 2, 64, seed=0))
    launches = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, causal=True)
    assert flash_attention_cuda.launches == launches


def test_flash_attention_backward_raises():
    """K2 has no backward, as the reference kernel has none: a gradient
    through it raises instead of coming back without attention's part."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FlashAttention.backward(None, torch.ones(1, 4, 2, 64))


@pytest.mark.parametrize("axis", ["batch x heads", "sequence"])
def test_flash_attention_grid_check(axis):
    """The wrapper refuses what the kernel's grid cannot index before any
    launch: B * H of 2^31 blocks along x, or a sequence past the C
    interface's int. One less passes. The inputs are one row broadcast,
    so nothing large is allocated."""
    row = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16)

    def qkv(n):
        b, s, h = (2, 1, n // 2) if axis == "batch x heads" else (1, n, 1)
        return (row.expand(b, s, h, 64), row.expand(b, s, 1, 64),
                row.expand(b, s, 1, 64))

    k2.check_layout(*qkv(2 ** 31 - 2), window=None)
    with pytest.raises(ValueError, match="grid"):
        k2.check_layout(*qkv(2 ** 31), window=None)


@pytest.mark.parametrize("where", ["row stride", "base address"])
def test_flash_attention_refuses_rows_off_16_bytes(where):
    """bf16 rows are read 16 bytes at a time (by TMA in the Hopper
    design): a head stride that is not a multiple of 8 elements, or a base
    that is not 16-byte aligned, raises before any launch."""
    b, s, h, kv, hd = 1, 16, 2, 1, 64
    k = torch.zeros((b, s, kv, hd), dtype=torch.bfloat16)
    if where == "row stride":
        q = torch.zeros((b, s, h, hd + 4), dtype=torch.bfloat16)[..., :hd]
        assert q.stride(2) % 8
    else:
        flat = torch.zeros(b * s * h * hd + 8, dtype=torch.bfloat16)
        q = flat[4:4 + b * s * h * hd].view(b, s, h, hd)
        assert q.data_ptr() % 16
    k2.check_layout(q.clone(memory_format=torch.contiguous_format), k, k,
                    window=None)
    with pytest.raises(ValueError, match="16-byte"):
        k2.check_layout(q, k, k, window=None)


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    return torch.device("cuda")


def _hold_on_card(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    tol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol)
    if dtype == "bfloat16":
        rel = float((got - want).norm() / want.norm())
        assert rel <= BF16_REL, f"relative RMS {rel} > {BF16_REL}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,dtype", [
    (2, 128, 4, 2, 64, True, None, "float32"),
    (1, 200, 4, 4, 64, True, 64, "float32"),   # its hd-32 cell, at hd 64
    (2, 256, 8, 2, 64, False, None, "float32"),
    (1, 130, 2, 1, 128, True, 32, "float32"),
    (1, 1000, 8, 2, 80, True, 96, "float32"),
    (1, 1000, 8, 2, 128, False, 96, "bfloat16"),
    (1, 200, 4, 4, 80, True, None, "bfloat16"),
    (1, 128, 4, 2, 64, True, None, "bfloat16"),
    (2, 200, 8, 2, 128, True, 64, "bfloat16"),
    (1, 5, 4, 2, 64, True, None, "bfloat16"),     # shorter than a tile
] + [  # the edges of the Hopper design's 128-row, 128-key tiles
    (2, s, 4, 2, hd, True, None, "bfloat16")
    for hd in (128, 64) for s in (1, 64, 127, 128, 129, 255, 257, 4097)
] + [
    (1, 300, 4, 2, hd, causal, window, "bfloat16")
    for hd in (128, 64) for causal in (True, False)
    for window in (1, 127, 128, 129)
] + [
    (1, 1000, 16, 8, 128, True, None, "bfloat16"),  # qwen3-1.7b's heads
    (1, 1000, 32, 32, 64, True, None, "bfloat16"),  # stablelm-1.6b's
])
def test_flash_attention_cuda_matches_plain(cuda_device, b, s, h, kv, hd,
                                            causal, window, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda_device, getattr(torch, dtype))
               for a in _qkv(b, s, h, kv, hd, seed=s))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = port_ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    _hold_on_card(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_reads_strided_views(cuda_device, dtype):
    """q, k, v as head slices of one fused (B, S, H + 2 KV, hd) buffer:
    the kernel reads them through their strides, without a copy."""
    b, s, h, kv, hd = 2, 150, 8, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, s, h, kv, hd, seed=7))
    fused = torch.cat([q, k, v], dim=2).to(cuda_device,
                                           getattr(torch, dtype))
    qv, kv_, vv = fused.split([h, kv, kv], dim=2)
    assert not qv.is_contiguous()
    got = flash_attention(qv, kv_, vv, causal=True, window=40)
    want = port_ref.flash_attention_ref(qv.contiguous(), kv_.contiguous(),
                                        vv.contiguous(), causal=True,
                                        window=40)
    _hold_on_card(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 64])
def test_flash_attention_cuda_reads_a_strided_batch(cuda_device, hd):
    """A batch of 3 taken as every other entry of a batch of 6: the batch
    stride is not the contiguous one, and TMA reads through it."""
    b, s, h, kv = 3, 200, 8, 2
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)[::2]
               for a in _qkv(2 * b, s, h, kv, hd, seed=11))
    assert q.shape[0] == b and not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    want = port_ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True)
    _hold_on_card(got, want, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "tma-wgmma-ws"),
    (torch.bfloat16, 64, "tma-wgmma-ws"),
    (torch.bfloat16, 80, "mma-sync"),
    (torch.float32, 128, "fma"),
    (torch.float32, 80, "fma"),
    (torch.float32, 64, "fma"),
])
def test_flash_attention_cuda_design(cuda_device, dtype, hd, want):
    """The built library dispatches bf16 at head_dim 64 and 128 to the
    Hopper design, bf16 at head_dim 80 to the mma.sync one and f32 to the
    FMA one."""
    assert k2.kernel_design(dtype, hd) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,rows", [(torch.bfloat16, 128, 128),
                                           (torch.bfloat16, 80, 64),
                                           (torch.float32, 64, 64)])
def test_flash_attention_cuda_grid_limit_follows_the_design(
        cuda_device, dtype, hd, rows):
    """The library refuses a sequence of more than 65535 query tiles of
    the height its design launches, before it reads any operand (the
    pointers here are null)."""
    s = 65535 * rows + 1
    strides = (s * 2 * hd, 2 * hd, hd)
    code = k2._lib().flash_attention_launch(
        None, None, None, None, k2._DTYPES[dtype], 1, s, 2, 1, hd,
        *strides, *strides, *strides, 1, 0, hd ** -0.5, None)
    assert code == 1                       # cudaErrorInvalidValue


@pytest.mark.cuda
def test_flash_attention_cuda_backward_raises(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(1, 64, 4, 2, 64, seed=1))
    out = flash_attention(q.requires_grad_(), k, v, causal=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        out.sum().backward()


@pytest.mark.cuda
def test_prefill_step_on_card_launches_k2_per_layer(cuda_device):
    cfg = get_arch("llama3-8b", smoke=True)
    params = port_tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                  device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 200)).astype(np.int32)).to(cuda_device)
    before = flash_attention_cuda.launches
    got = port_steps.make_prefill_step(cfg, flash=True)(params,
                                                        {"tokens": toks})
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + cfg.n_layers
    want = port_steps.make_prefill_step(cfg, flash=False)(params,
                                                          {"tokens": toks})
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=LOGITS_ATOL)
