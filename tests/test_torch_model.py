"""The port's dense transformer against the reference, layer by layer.

llama3-8b smoke width in f32 with vocab 1024; params come from the
reference's ``init_params`` through ``repro_torch.convert``. Tolerances:
2e-5 on single layers, 1e-4 on the full forward's logits and the train
step's loss, and 1e-5 of each leaf's largest entry on its gradient.
After one AdamW step (lr 3e-3) params agree to 1e-6 wherever the
reference's gradient is at least 1e-6: the first step moves a param by
lr * g / (|g| + 1e-8), which hangs on the gradient's last digits only
where |g| is near that 1e-8 (the few such entries are held to the step's
bound, 2 * lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_tfm
from repro_torch.train import steps as port_steps
from repro_torch.utils.pytree import tree_leaves, tree_unflatten

from test_torch_reference import (  # noqa: F401
    _one_torch_thread, assert_trees_close, port_cfg, port_params, reference)


def _cfg(reference, **kw):
    base = reference.get_arch("llama3-8b", smoke=True)
    return dataclasses.replace(base, vocab=1024, **kw)


def _tokens(vocab, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_rotary_mlp_match(reference, norm):
    cfg = _cfg(reference, norm=norm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jnp = reference.jnp
    params = {"scale": rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32)}
    if norm == "layernorm":
        params["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    want = reference.layers.apply_norm(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    got = port_layers.apply_norm(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    q = rng.standard_normal((2, 8, cfg.n_heads, cfg.hd)).astype(np.float32)
    js, jc = reference.layers.rotary_freqs(cfg, jnp.asarray(pos))
    ts, tc = port_layers.rotary_freqs(port_cfg(cfg), torch.from_numpy(pos))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    np.testing.assert_allclose(
        port_layers.apply_rotary(torch.from_numpy(q), ts, tc).numpy(),
        np.asarray(reference.layers.apply_rotary(jnp.asarray(q), js, jc)),
        atol=2e-5)

    for act in ("swiglu", "gelu"):
        mp = reference.layers.init_mlp(reference.jax.random.PRNGKey(2),
                                       dataclasses.replace(cfg, act=act))
        want = reference.layers.apply_mlp(mp, jnp.asarray(x), act)
        got = port_layers.apply_mlp(
            {k: torch.from_numpy(np.asarray(v)) for k, v in mp.items()},
            torch.from_numpy(x), act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("window,chunk,qk_norm", [
    (None, 0, False), (5, 0, False), (None, 4, False), (None, 0, True)])
def test_attention_matches(reference, window, chunk, qk_norm):
    cfg = _cfg(reference, window=window, attn_chunk=chunk, qk_norm=qk_norm)
    jax, jnp = reference.jax, reference.jnp
    ap = reference.attention.init_attention(jax.random.PRNGKey(4), cfg)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    want = reference.attention.attention_train(
        ap, cfg, jnp.asarray(x), jnp.asarray(pos), window=window)
    got = port_attn.attention_train(
        {k: torch.from_numpy(np.asarray(v)) for k, v in ap.items()},
        port_cfg(cfg), torch.from_numpy(x), torch.from_numpy(pos),
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_forward_logits_match(reference):
    cfg = _cfg(reference)
    jp = reference.tfm.init_params(reference.jax.random.PRNGKey(0), cfg)
    toks = _tokens(cfg.vocab)
    want, _ = reference.tfm.apply(jp, cfg, reference.jnp.asarray(toks))
    got, aux = port_tfm.apply(port_params(jp, cfg), port_cfg(cfg),
                              torch.from_numpy(toks))
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_train_step_loss_and_params_match(reference):
    cfg = _cfg(reference)
    jax, jnp = reference.jax, reference.jnp
    jp = reference.tfm.init_params(jax.random.PRNGKey(0), cfg)
    toks = _tokens(cfg.vocab)
    rng = np.random.default_rng(9)
    residual = (rng.standard_normal((2, 16, cfg.vocab)) * 0.05).astype(
        np.float32)
    ref_step, ref_opt = reference.steps.make_train_step(
        cfg, "gal_residual", lr=3e-3, weight_decay=0.0)
    jp2, _, jm = ref_step(jp, ref_opt.init(jp),
                          {"tokens": jnp.asarray(toks),
                           "residual": jnp.asarray(residual)})
    step, opt = port_steps.make_train_step(
        port_cfg(cfg), "gal_residual", lr=3e-3, weight_decay=0.0)
    tp = port_params(jp, cfg)
    tp2, st, tm = step(tp, opt.init(tp),
                       {"tokens": torch.from_numpy(toks),
                        "residual": torch.from_numpy(residual)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["fit_l2"]), float(jm["fit_l2"]),
                               rtol=1e-4)
    assert int(st["step"]) == 1

    jbatch = {"tokens": jnp.asarray(toks), "residual": jnp.asarray(residual)}
    jg = jax.grad(lambda p: reference.steps.gal_residual_loss(
        p, cfg, jbatch)[0])(jp)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, _ = port_steps.gal_residual_loss(
        tree_unflatten(tp, leaves), port_cfg(cfg),
        {"tokens": torch.from_numpy(toks),
         "residual": torch.from_numpy(residual)})
    tg = tree_unflatten(tp, list(torch.autograd.grad(loss, leaves)))

    def check(got_g, want_g, got_p, want_p):
        if isinstance(want_g, dict):
            for k in want_g:
                check(got_g[k], want_g[k], got_p[k], want_p[k])
            return
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(got_g.numpy(), want_g,
                                   atol=1e-5 * np.abs(want_g).max())
        big = np.abs(want_g) >= 1e-6
        diff = np.abs(got_p.numpy() - np.asarray(want_p))
        assert diff[big].max(initial=0.0) <= 1e-6
        assert diff.max() <= 2 * 3e-3

    check(tg, jg, tp2, jp2)
    # the step returned new params and left the given ones as they were
    assert_trees_close(tp, jp, atol=0.0)


def test_bf16_forward_and_step_match(reference):
    """The working dtype of the full config. bf16 rounds at other places
    in the two frameworks, and the rounding error of a sum is absolute at
    the scale of its largest terms, so logits are held to two bf16 ulps
    of the largest logit (atol 2^-6 * max|logit|), the loss to 1e-3
    relative; params, moments and logits stay bf16 as in the reference."""
    cfg = _cfg(reference, dtype="bfloat16")
    jax, jnp = reference.jax, reference.jnp
    jp = reference.tfm.init_params(jax.random.PRNGKey(0), cfg)
    toks = _tokens(cfg.vocab)
    residual = (np.random.default_rng(9).standard_normal(
        (2, 16, cfg.vocab)) * 0.05).astype(np.float32)
    want, _ = reference.tfm.apply(jp, cfg, jnp.asarray(toks))
    tp = port_params(jp, cfg)
    got, _ = port_tfm.apply(tp, port_cfg(cfg), torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 ** -6 * np.abs(want).max())
    ref_step, ref_opt = reference.steps.make_train_step(
        cfg, "gal_residual", lr=1e-4, weight_decay=0.0)
    _, _, jm = ref_step(jp, ref_opt.init(jp),
                        {"tokens": jnp.asarray(toks),
                         "residual": jnp.asarray(residual)})
    step, opt = port_steps.make_train_step(port_cfg(cfg), "gal_residual",
                                           lr=1e-4, weight_decay=0.0)
    tp2, st, tm = step(tp, opt.init(tp),
                       {"tokens": torch.from_numpy(toks),
                        "residual": torch.from_numpy(residual)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    assert tp2["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert st["m"]["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert tp2["layers"]["ln1"]["scale"].dtype == torch.float32


def test_run_local_steps_stacks_metrics(reference):
    cfg = port_cfg(_cfg(reference))
    gen = torch.Generator().manual_seed(0)
    params = port_tfm.init_params(gen, cfg, device="cpu")
    step, opt = port_steps.make_train_step(cfg, lr=3e-3, weight_decay=0.0)
    toks = torch.from_numpy(_tokens(cfg.vocab, b=1, s=8))
    batch = {"tokens": toks, "residual": torch.zeros(1, 8, cfg.vocab)}
    _, st, metrics = port_steps.run_local_steps(step, params,
                                                opt.init(params), batch, 3)
    assert metrics["loss"].shape == (3,) and int(st["step"]) == 3
    assert float(metrics["loss"][-1]) < float(metrics["loss"][0])


def test_other_families_and_options_raise(reference):
    cfg = port_cfg(_cfg(reference))
    gen = torch.Generator().manual_seed(0)
    for bad in (dataclasses.replace(cfg, block_unit=("rwkv",)),
                dataclasses.replace(cfg, moe_experts=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            port_tfm.init_params(gen, bad, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_steps.make_train_step(cfg, microbatch=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_steps.make_train_step(cfg, loss_kind="lm_xent")
