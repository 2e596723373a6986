"""K1 (residual_xent) in the port against the JAX reference.

On the CPU the port's entry point takes the kernel's plain version; it is
held against the reference's jnp oracle and against the reference's Pallas
kernel run in interpret mode, over the reference's own cells
(``tests/test_kernels.py``): odd shapes, tied maxima in tiles far apart,
the padded vocab tail, bf16 input. The CUDA kernel itself is held against
the plain version on the card by ``test_residual_xent_cuda_matches_plain``
(marked ``cuda``, skipped without a card) and by ``chip_smoke.py``.

Tolerances, the reference's: f32 atol 2e-5, rows summing to 0 within
1e-4, bf16 input within 5e-3.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import losses as port_losses
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.ops import residual_xent
from repro_torch.kernels.residual_xent import residual_xent_cuda

from test_torch_reference import _one_torch_thread, reference  # noqa: F401

F32_ATOL = 2e-5
BF16_ATOL = 5e-3
ROW_SUM_ATOL = 1e-4


def _inputs(t, v, seed, dtype):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((t, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    if dtype == "bfloat16":
        # round to bf16 once, so both sides see the same bits
        logits = torch.from_numpy(logits).bfloat16().float().numpy()
    return logits, labels


def _jax_logits(reference, logits, dtype):
    jnp = reference.jnp
    return jnp.asarray(logits).astype(getattr(jnp, dtype))


def _torch_logits(logits, dtype):
    return torch.from_numpy(logits).to(getattr(torch, dtype))


@pytest.mark.parametrize("t,v", [(7, 300), (128, 512), (130, 513),
                                 (256, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_xent_matches_reference(reference, t, v, dtype):
    logits, labels = _inputs(t, v, seed=t * 7 + v, dtype=dtype)
    got = residual_xent(_torch_logits(logits, dtype),
                        torch.from_numpy(labels)).numpy()
    jl = _jax_logits(reference, logits, dtype)
    jlab = reference.jnp.asarray(labels)
    want_ref = np.asarray(reference.ref.residual_xent_ref(jl, jlab))
    want_kernel = np.asarray(
        reference.residual_xent_kernel(jl, jlab, interpret=True))
    tol = F32_ATOL if dtype == "float32" else BF16_ATOL
    assert got.dtype == np.float32 and got.shape == (t, v)
    np.testing.assert_allclose(got, want_ref, atol=tol)
    np.testing.assert_allclose(got, want_kernel, atol=tol)
    np.testing.assert_allclose(got.sum(-1), 0.0, atol=ROW_SUM_ATOL)


def test_residual_xent_tied_max_far_apart(reference):
    """Equal row maxima in vocab tiles far apart (the reference kernel's
    tile seams; the CUDA kernel's strided threads)."""
    t, v = 4, 2048
    logits = np.zeros((t, v), np.float32)
    logits[:, 3] = 9.0
    logits[:, 1900] = 9.0
    logits[1, 777] = 9.0
    labels = np.array([3, 1900, 0, 2047], np.int32)
    got = residual_xent(torch.from_numpy(logits),
                        torch.from_numpy(labels)).numpy()
    jl, jlab = reference.jnp.asarray(logits), reference.jnp.asarray(labels)
    np.testing.assert_allclose(
        got, np.asarray(reference.residual_xent_kernel(jl, jlab,
                                                       interpret=True)),
        atol=F32_ATOL)
    np.testing.assert_allclose(
        got, np.asarray(reference.ref.residual_xent_ref(jl, jlab)),
        atol=F32_ATOL)


def test_residual_xent_padded_tail_and_label_padding(reference):
    """V = 512 + 1 leaves a one-column tile in the reference kernel; a
    label of -1 (the reference's padding) sets no one-hot column."""
    logits, labels = _inputs(5, 513, seed=11, dtype="float32")
    labels[2] = -1
    labels[4] = 512
    got = residual_xent(torch.from_numpy(logits),
                        torch.from_numpy(labels)).numpy()
    jl, jlab = reference.jnp.asarray(logits), reference.jnp.asarray(labels)
    want = np.asarray(reference.residual_xent_kernel(jl, jlab,
                                                     interpret=True))
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    assert got[2].max() < 0.0                 # no +1 column on a -1 label
    np.testing.assert_allclose(got[2].sum(), -1.0, atol=ROW_SUM_ATOL)


def test_residual_xent_batched_shape_and_int64_labels():
    logits, labels = _inputs(32, 300, seed=5, dtype="float32")
    x = torch.from_numpy(logits).reshape(2, 16, 300)
    y64 = torch.from_numpy(labels).reshape(2, 16).long()
    out = residual_xent(x, y64)
    assert out.shape == (2, 16, 300)
    np.testing.assert_allclose(out.sum(-1).numpy(), 0.0, atol=ROW_SUM_ATOL)
    np.testing.assert_array_equal(
        out.numpy(), residual_xent(x, y64.int(), use_kernel=False).numpy())


def test_residual_xent_cuda_refuses_cpu_tensors():
    """The kernel's wrapper never runs the plain version: a tensor that is
    not on a CUDA device raises."""
    logits, labels = _inputs(4, 300, seed=0, dtype="float32")
    launches = residual_xent_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        residual_xent_cuda(torch.from_numpy(logits),
                           torch.from_numpy(labels))
    assert residual_xent_cuda.launches == launches


@pytest.mark.parametrize("k,soft", [(1024, False), (1024, True),
                                    (300, True)])
def test_xent_residual_route_soft_targets(reference, monkeypatch, k, soft):
    """``CrossEntropyLoss.residual`` through the kernel route (gate widened
    to the CPU) equals the reference's closed form, for one-hot and for
    smoothed targets (the ``y - onehot(argmax y)`` correction)."""
    monkeypatch.setattr(port_losses, "XENT_KERNEL_BACKENDS", ("cpu",))
    rng = np.random.default_rng(k)
    n = 16
    f = (rng.standard_normal((n, k)) * 2).astype(np.float32)
    y = np.eye(k, dtype=np.float32)[rng.integers(0, k, size=n)]
    if soft:
        y = 0.9 * y + 0.1 / k
    calls = []
    real = port_losses.residual_xent
    monkeypatch.setattr(port_losses, "residual_xent",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = port_losses.CrossEntropyLoss().residual(
        torch.from_numpy(y), torch.from_numpy(f)).numpy()
    want = np.asarray(reference.losses.CrossEntropyLoss().residual(
        reference.jnp.asarray(y), reference.jnp.asarray(f)))
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    assert len(calls) == (1 if k >= port_losses.XENT_KERNEL_MIN_CLASSES
                          else 0)


def test_xent_loss_and_init_prediction(reference):
    rng = np.random.default_rng(2)
    f = rng.standard_normal((32, 50)).astype(np.float32)
    y = np.eye(50, dtype=np.float32)[rng.integers(0, 50, size=32)]
    port, ref = port_losses.CrossEntropyLoss(), \
        reference.losses.CrossEntropyLoss()
    jy, jf = reference.jnp.asarray(y), reference.jnp.asarray(f)
    np.testing.assert_allclose(
        float(port(torch.from_numpy(y), torch.from_numpy(f))),
        float(ref(jy, jf)), rtol=1e-6)
    np.testing.assert_allclose(
        port.init_prediction(torch.from_numpy(y)).numpy(),
        np.asarray(ref.init_prediction(jy)), rtol=1e-6)
    # the Loss base's autodiff residual equals the closed form
    np.testing.assert_allclose(
        port_losses.Loss.residual(port, torch.from_numpy(y),
                                  torch.from_numpy(f)).numpy(),
        np.asarray(ref.residual(jy, jf)), atol=F32_ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,v,dtype", [
    (7, 300, "float32"), (130, 513, "float32"), (256, 2048, "float32"),
    (64, 51865, "float32"), (64, 32064, "bfloat16")])
def test_residual_xent_cuda_matches_plain(cuda_device, t, v, dtype):
    logits, labels = _inputs(t, v, seed=v, dtype=dtype)
    x = _torch_logits(logits, dtype).to(cuda_device)
    y = torch.from_numpy(labels).to(cuda_device)
    before = residual_xent_cuda.launches
    got = residual_xent(x, y)
    torch.cuda.synchronize()
    assert residual_xent_cuda.launches == before + 1
    want = port_ref.residual_xent_ref(x, y)
    tol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=tol)
