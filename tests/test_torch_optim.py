"""The port's optimizers, line search and weight fit against the reference.

Same numpy inputs into both; f32 throughout. Tolerances: 1e-6 relative on
a few optimizer steps (the same f32 arithmetic in another order), 1e-5 on
the line search's eta and on the 60-epoch weight fit, whose fixed trip
counts the port keeps.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import weights as port_weights
from repro_torch.optim import lbfgs as port_lbfgs
from repro_torch.optim import optimizers as port_opt

from test_torch_reference import _one_torch_thread, reference  # noqa: F401


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _to_jax(reference, tree):
    return reference.jax.tree_util.tree_map(reference.jnp.asarray, tree)


@pytest.mark.parametrize("kind,wd", [("adamw", 0.0), ("adamw", 0.1),
                                     ("adam", 5e-4)])
def test_optimizer_steps_match_reference(reference, kind, wd):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(4)]
    ref_opt = getattr(reference.optimizers, kind)(3e-3, weight_decay=wd)
    port = getattr(port_opt, kind)(3e-3, weight_decay=wd)
    jp = _to_jax(reference, params)
    js = ref_opt.init(jp)
    tp = _to_torch(params)
    ts = port.init(tp)
    for g in grads:
        upd, js = ref_opt.update(_to_jax(reference, g), js, jp)
        jp = reference.optimizers.apply_updates(jp, upd)
        tupd, ts = port.update(_to_torch(g), ts, tp)
        tp = port_opt.apply_updates(tp, tupd)
    assert int(ts["step"]) == int(js["step"]) == len(grads)
    for k, want in (("a", jp["a"]), ("c", jp["b"]["c"])):
        got = tp["a"] if k == "a" else tp["b"]["c"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_adam_state_takes_param_dtype():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = port_opt.adamw(1e-3)
    st = opt.init(p)
    assert st["m"]["w"].dtype == torch.bfloat16
    upd, st = opt.update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)},
                         st, p)
    assert upd["w"].dtype == torch.float32          # JAX: bf16 / f32 -> f32
    assert port_opt.apply_updates(p, upd)["w"].dtype == torch.bfloat16


def _xent_problem(seed, n=64, k=40):
    rng = np.random.default_rng(seed)
    y = np.eye(k, dtype=np.float32)[rng.integers(0, k, size=n)]
    f = rng.standard_normal((n, k)).astype(np.float32)
    d = (y - np.exp(f) / np.exp(f).sum(-1, keepdims=True)
         + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    return y, f, d


@pytest.mark.parametrize("method", ["lbfgs", "golden", "constant"])
def test_line_search_matches_reference(reference, method):
    """eta for xent(y, f + eta * d), the fit's step-4 line search."""
    y, f, d = _xent_problem(1)
    jnp, jax = reference.jnp, reference.jax
    jy, jf, jd = jnp.asarray(y), jnp.asarray(f), jnp.asarray(d)

    def ref_fn(e):
        return -jnp.mean(jnp.sum(jy * jax.nn.log_softmax(jf + e * jd, -1),
                                 -1))

    ty, tf, td = (torch.from_numpy(a) for a in (y, f, d))

    def port_fn(e):
        return -torch.mean(torch.sum(
            ty * torch.log_softmax(tf + e * td, -1), -1))

    want = float(reference.lbfgs.line_search(ref_fn, method=method, x0=1.0))
    got = port_lbfgs.line_search(port_fn, method=method, x0=1.0)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6)
    if method != "constant":
        assert float(port_fn(got)) < float(port_fn(torch.tensor(0.0)))


def test_line_search_rejects_unknown_method():
    with pytest.raises(ValueError, match="line-search"):
        port_lbfgs.line_search(lambda e: e * e, method="newton")


def _reference_theta0(reference, rng_key, m):
    """The reference's start: 0.01 * normal(fold_in(rng, org_id))."""
    jax = reference.jax
    return np.asarray([
        0.01 * float(jax.random.normal(jax.random.fold_in(rng_key, i), (),
                                       reference.jnp.float32))
        for i in range(m)], np.float32)


@pytest.mark.parametrize("m", [2, 3])
def test_fit_weights_with_given_theta0(reference, m):
    rng = np.random.default_rng(m)
    n, k = 48, 20
    residual = rng.standard_normal((n, k)).astype(np.float32)
    preds = (residual[None] * rng.uniform(0.2, 1.0, (m, 1, 1))
             + 0.3 * rng.standard_normal((m, n, k))).astype(np.float32)
    key = reference.jax.random.fold_in(reference.jax.random.PRNGKey(5), 29)
    jnp = reference.jnp
    want = np.asarray(reference.weights.fit_weights(
        key, jnp.asarray(residual), jnp.asarray(preds),
        lambda r, f: jnp.mean(jnp.square(r - f)), epochs=60))
    got = port_weights.fit_weights(
        torch.from_numpy(residual), torch.from_numpy(preds),
        lambda r, f: torch.mean(torch.square(r - f)), epochs=60,
        theta0=torch.from_numpy(_reference_theta0(reference, key, m)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(float(got.sum()), 1.0, atol=1e-6)


def test_fit_weights_draws_from_generator_and_masks():
    rng = np.random.default_rng(0)
    residual = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    preds = torch.from_numpy(rng.standard_normal((3, 8, 5)).astype(np.float32))

    def l2(r, f):
        return torch.mean(torch.square(r - f))

    a = port_weights.fit_weights(residual, preds, l2, epochs=5,
                                 generator=torch.Generator().manual_seed(1))
    b = port_weights.fit_weights(residual, preds, l2, epochs=5,
                                 generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    mask = torch.tensor([True, False, True])
    w = port_weights.fit_weights(residual, preds, l2, epochs=5, mask=mask,
                                 theta0=torch.zeros(3))
    assert float(w[1]) == 0.0
    np.testing.assert_allclose(float(w.sum()), 1.0, atol=1e-6)
    assert torch.equal(port_weights.uniform_weights(2),
                       torch.tensor([0.5, 0.5]))
    np.testing.assert_allclose(
        port_weights.uniform_weights(3, mask).numpy(), [0.5, 0.0, 0.5])
