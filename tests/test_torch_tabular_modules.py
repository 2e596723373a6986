"""The tabular slice's modules against the reference, one by one.

Bitwise: the synthetic datasets and their splits, the feature partition
and the membership schedules (numpy draws in the reference's order).
Exactly: the protocol ledger (integer arithmetic). Within a tolerance,
on the same inputs: each loss's residual and F^0 (atol 1e-6, f32), the
closed forms against autodiff, the privacy mechanisms on the same uniform
draw (atol 1e-6, and relative 2e-6 where the Laplace noise is large), the
metrics, and the weight fit with org ids (1e-5).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import losses as port_losses
from repro_torch.core import membership as port_membership
from repro_torch.core import privacy as port_privacy
from repro_torch.core import protocol_sim as port_protocol
from repro_torch.core import weights as port_weights
from repro_torch.data import partition as port_partition
from repro_torch.data import synthetic as port_synthetic
from repro_torch.metrics import metrics as port_metrics

from test_torch_reference import _one_torch_thread, reference  # noqa: F401


def _np(a):
    return np.asarray(a)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("make,kwargs", [
    ("make_regression", {"n": 97, "d": 7}),
    ("make_blobs", {"n": 120, "d": 6, "k": 9}),
    ("make_blobs", {"n": 64, "d": 4, "k": 1024}),
    ("make_classification", {"n": 80, "d": 11, "k": 3}),
])
def test_datasets_and_split_are_bitwise(reference, make, kwargs):
    want = getattr(reference.synthetic, make)(np.random.default_rng(4),
                                              **kwargs)
    got = getattr(port_synthetic, make)(np.random.default_rng(4), **kwargs)
    assert got.x.dtype == got.y.dtype == torch.float32
    assert got.x.device.type == "cpu"
    np.testing.assert_array_equal(got.x.numpy(), _np(want.x))
    np.testing.assert_array_equal(got.y.numpy(), _np(want.y))
    assert (got.task, got.name) == (want.task, want.name)
    w_tr, w_te = reference.synthetic.train_test_split(
        want, np.random.default_rng(9), test_frac=0.25)
    g_tr, g_te = port_synthetic.train_test_split(
        got, np.random.default_rng(9), test_frac=0.25)
    for g, w in ((g_tr, w_tr), (g_te, w_te)):
        np.testing.assert_array_equal(g.x.numpy(), _np(w.x))
        np.testing.assert_array_equal(g.y.numpy(), _np(w.y))
        assert g.name == w.name


@pytest.mark.parametrize("m,seeded", [(4, False), (3, True), (7, True)])
def test_split_features_is_bitwise(reference, m, seeded):
    x = np.random.default_rng(0).standard_normal((10, 7)).astype(np.float32)
    want = reference.partition.split_features(
        reference.jnp.asarray(x), m,
        np.random.default_rng(2) if seeded else None)
    got = port_partition.split_features(
        torch.from_numpy(x), m, np.random.default_rng(2) if seeded else None)
    assert len(got) == len(want) == m
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_split_features_and_channels_refuse_and_agree(reference):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    want = reference.partition.split_channels(reference.jnp.asarray(x),
                                              [1, 3])
    got = port_partition.split_channels(torch.from_numpy(x), [1, 3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    with pytest.raises(ValueError, match="do not sum"):
        port_partition.split_channels(torch.from_numpy(x), [1, 2])
    with pytest.raises(ValueError, match="cannot split"):
        port_partition.split_features(torch.zeros((2, 3)), 4)


# ---------------------------------------------------------------- metrics
def test_metrics_match_reference(reference):
    rng = np.random.default_rng(1)
    y_cls = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 40)]
    f_cls = rng.standard_normal((40, 5)).astype(np.float32)
    y_reg = rng.standard_normal((40, 1)).astype(np.float32)
    y_bin = (rng.random((40, 1)) < 0.3).astype(np.float32)
    # quantized scores: ties, which the exact average ranks must handle
    s_bin = np.round(rng.standard_normal((40, 1)), 1).astype(np.float32)
    jnp = reference.jnp
    for name, y, f in (("accuracy", y_cls, f_cls), ("mad", y_reg, f_cls[:, :1]),
                       ("auroc", y_bin, s_bin),
                       ("auroc", np.zeros((4, 1), np.float32), s_bin[:4])):
        want = float(reference.metrics.get_metric(name)(jnp.asarray(y),
                                                        jnp.asarray(f)))
        got = port_metrics.get_metric(name)(torch.from_numpy(y),
                                            torch.from_numpy(f))
        assert got.ndim == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)
    assert port_metrics.METRICS.names() == reference.metrics.METRICS.names()
    for task in ("classification", "regression", "binary"):
        assert port_metrics.metric_for_task(task).__name__ == \
            reference.metrics.metric_for_task(task).__name__
    with pytest.raises(ValueError, match="unknown task"):
        port_metrics.metric_for_task("ranking")


# ----------------------------------------------------------------- losses
def _loss_inputs(name, n=33, k=4, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, 1 if name == "bce" else k)).astype(np.float32)
    if name == "xent":
        y = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    elif name == "bce":
        y = (rng.random((n, 1)) < 0.4).astype(np.float32)
    else:
        y = rng.standard_normal((n, k)).astype(np.float32)
    return y, f


@pytest.mark.parametrize("name", ["mse", "mae", "xent", "bce"])
def test_losses_match_reference(reference, name):
    jnp = reference.jnp
    for n in (33, 34):                    # an odd and an even median
        y, f = _loss_inputs(name, n=n)
        want = reference.losses.get_loss(name)
        got = port_losses.get_loss(name)
        ty, tf = torch.from_numpy(y), torch.from_numpy(f)
        jy, jf = jnp.asarray(y), jnp.asarray(f)
        assert got.name == want.name
        np.testing.assert_allclose(got.residual(ty, tf).numpy(),
                                   _np(want.residual(jy, jf)), atol=1e-6)
        np.testing.assert_allclose(got.init_prediction(ty).numpy(),
                                   _np(want.init_prediction(jy)), atol=1e-6)
        np.testing.assert_allclose(float(got(ty, tf)), float(want(jy, jf)),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            port_losses.autodiff_residual(got, ty, tf).numpy(),
            got.residual(ty, tf).numpy(), atol=1e-6)
        np.testing.assert_allclose(
            port_losses.autodiff_residual(got, ty, tf).numpy(),
            _np(reference.losses.autodiff_residual(want, jy, jf)), atol=1e-6)
    assert port_losses.LOSSES.names() == reference.losses.LOSSES.names()


@pytest.mark.parametrize("q", [1.0, 1.5, 2.0, 4.0])
def test_lq_loss_matches_reference_with_its_smoothing(reference, q):
    rng = np.random.default_rng(int(q * 10))
    r = rng.standard_normal((20, 3)).astype(np.float32)
    f = r.copy()
    f[:10] += rng.standard_normal((10, 3)).astype(np.float32)
    # half the rows at r == f exactly: the 1e-12 smoothing branches
    want = reference.losses.lq_loss(q)
    got = port_losses.lq_loss(q)
    assert got.q == want.q and got.__name__ == want.__name__
    jnp = reference.jnp
    np.testing.assert_allclose(
        float(got(torch.from_numpy(r), torch.from_numpy(f))),
        float(want(jnp.asarray(r), jnp.asarray(f))), rtol=1e-6)
    with torch.enable_grad():
        tf = torch.from_numpy(f).requires_grad_(True)
        (g,) = torch.autograd.grad(got(torch.from_numpy(r), tf), tf)
    jg = reference.jax.grad(lambda ff: want(jnp.asarray(r), ff))(
        jnp.asarray(f))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy(), _np(jg), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- privacy
@pytest.mark.parametrize("mechanism,kwargs", [
    ("dp", {"alpha": 1.0}), ("dp", {"alpha": 0.25}),
    ("ip", {"n_intervals": 1}), ("ip", {"n_intervals": 3})])
def test_privacy_matches_reference_on_the_same_draw(reference, mechanism,
                                                    kwargs):
    jax, jnp = reference.jax, reference.jnp
    residual = np.random.default_rng(5).standard_normal((50, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    want = reference.privacy.apply_privacy(key, jnp.asarray(residual),
                                           mechanism, **kwargs)
    shape = port_privacy.noise_shape(mechanism, residual.shape,
                                     kwargs.get("n_intervals", 1))
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, shape)).copy())
    got = port_privacy.apply_privacy(torch.from_numpy(residual), mechanism,
                                     u, **kwargs)
    # Laplace noise reaches |50| here (log1p near u = +-0.5): f32 ulps
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-6, atol=1e-6)
    if mechanism == "ip":     # at most n_intervals + 1 values per column
        for col in got.T:
            assert len(torch.unique(col)) <= kwargs["n_intervals"] + 1


def test_privacy_refuses_unknown_and_passes_none():
    r = torch.ones((3, 2))
    assert port_privacy.apply_privacy(r, None) is r
    assert port_privacy.noise_shape("none", (3, 2)) is None
    with pytest.raises(ValueError, match="unknown privacy"):
        port_privacy.apply_privacy(r, "k-anon", torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="unknown privacy"):
        port_privacy.noise_shape("k-anon", (3, 2))


# ------------------------------------------------- membership and ledgers
@pytest.mark.parametrize("rounds,m,rate,seed", [(6, 4, 0.3, 0), (5, 3, 0.9, 2),
                                                (4, 2, 0.0, 1)])
def test_membership_schedules_are_bitwise(reference, rounds, m, rate, seed):
    want = reference.membership.straggler_schedule(rounds, m, rate, seed)
    got = port_membership.straggler_schedule(rounds, m, rate, seed)
    np.testing.assert_array_equal(got, want)
    explicit = np.ones((rounds, m), int)
    explicit[0, 0] = 0
    for sched in (None, explicit):
        try:
            w = reference.membership.resolve_membership(sched, rate, seed,
                                                        rounds, m)
        except ValueError as exc:         # the AND left a round empty
            with pytest.raises(ValueError, match="no live org"):
                port_membership.resolve_membership(sched, rate, seed,
                                                   rounds, m)
            assert "no live org" in str(exc)
            continue
        g = port_membership.resolve_membership(sched, rate, seed, rounds, m)
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g, w)
        assert reference.membership.membership_comm_ledger(
            w, 40, 3, (10,), resid_dtype_bytes=2) == \
            port_membership.membership_comm_ledger(g, 40, 3, (10,),
                                                   resid_dtype_bytes=2)


def test_membership_refusals_match_reference():
    with pytest.raises(ValueError, match="straggler_sim"):
        port_membership.straggler_schedule(3, 2, 1.0)
    with pytest.raises(ValueError, match="shape"):
        port_membership.resolve_membership(np.ones((2, 2), bool), None, 0,
                                           3, 2)
    with pytest.raises(ValueError, match="boolean"):
        port_membership.resolve_membership(np.full((3, 2), 2), None, 0, 3, 2)
    with pytest.raises(ValueError, match="no live org"):
        port_membership.resolve_membership(np.zeros((3, 2), bool), None, 0,
                                           3, 2)


def test_protocol_ledger_is_exact(reference):
    ref, port = reference.protocol_sim, port_protocol
    for args in ((128, 1, 4, (32,)), (16384, 1024, 4, (4096,)),
                 (7, 3, 1, ())):
        assert port.gal_round_bytes(*args) == ref.gal_round_bytes(*args)
        assert port.gal_round_bytes(*args, resid_dtype_bytes=2) == \
            ref.gal_round_bytes(*args, resid_dtype_bytes=2)
    sched = np.array([[1, 0, 1], [0, 0, 1], [1, 1, 1]], bool)
    for dms in ([False] * 3, [True, False, True]):
        assert port.gal_model_memories(3, dms) == \
            ref.gal_model_memories(3, dms)
        assert port.gal_model_memories(3, dms, membership=sched) == \
            ref.gal_model_memories(3, dms, membership=sched)
    for dms in (False, True):
        assert port.gal_cost(100, 2, 4, 5, dms=dms) == \
            port.ProtocolCost(**vars(ref.gal_cost(100, 2, 4, 5, dms=dms)))
    assert port.al_cost(100, 2, 4, 5).bytes_total == \
        ref.al_cost(100, 2, 4, 5).bytes_total
    assert port.complexity_table(100, 2, 4, 5) == \
        ref.complexity_table(100, 2, 4, 5)


# ------------------------------------------------------------ weight fit
@pytest.mark.parametrize("org_ids,live", [
    ([0, 1, 2], None), ([3, 0, 2], None), ([5, 1, 7, 2], [1, 0, 1, 1])])
def test_fit_weights_keyed_by_org_id_matches_reference(reference, org_ids,
                                                       live):
    jax, jnp = reference.jax, reference.jnp
    m = len(org_ids)
    rng = np.random.default_rng(m)
    residual = rng.standard_normal((40, 3)).astype(np.float32)
    preds = (residual[None] * rng.uniform(0.2, 1.0, (m, 1, 1))
             + 0.3 * rng.standard_normal((m, 40, 3))).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(2), 29)
    mask = None if live is None else np.asarray(live, bool)
    want = _np(reference.weights.fit_weights(
        key, jnp.asarray(residual), jnp.asarray(preds),
        reference.losses.lq_loss(2.0), epochs=100,
        mask=None if mask is None else jnp.asarray(mask),
        org_ids=jnp.asarray(org_ids, jnp.uint32)))
    # the reference's start, drawn per id: a reordered id list reorders it
    theta0 = {i: 0.01 * float(jax.random.normal(jax.random.fold_in(key, i),
                                                (), jnp.float32))
              for i in org_ids}
    got = port_weights.fit_weights(
        torch.from_numpy(residual), torch.from_numpy(preds),
        port_losses.lq_loss(2.0), epochs=100,
        mask=None if mask is None else torch.from_numpy(mask),
        theta0=theta0, org_ids=org_ids)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if mask is not None:
        assert float(got[1]) == 0.0


def test_combine_folds_in_org_order():
    """An org with an exact-zero weight leaves the combination bitwise as
    the stack without it, wherever it sits."""
    g = torch.Generator().manual_seed(0)
    preds = torch.randn((4, 30, 2), generator=g)
    w = torch.rand(4, generator=g)
    for drop in range(4):
        wz = w.clone()
        wz[drop] = 0.0
        keep = [i for i in range(4) if i != drop]
        assert torch.equal(port_weights.combine(wz, preds),
                           port_weights.combine(w[keep], preds[keep]))
    np.testing.assert_allclose(port_weights.combine(w, preds).numpy(),
                               torch.einsum("m,mnk->nk", w, preds).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_combine_gradient_is_the_contractions():
    """combine's own backward (one dot per org) is the gradient of the
    sum, and a live org's weight gradient is bitwise the same with an
    exact-zero org in the stack as without it."""
    g = torch.Generator().manual_seed(1)
    w = torch.rand(3, generator=g, dtype=torch.float64).requires_grad_(True)
    preds = torch.randn((3, 6, 4), generator=g,
                        dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(port_weights.combine, (w, preds))

    preds = torch.randn((4, 30, 2), generator=g)
    target = torch.randn((30, 2), generator=g)

    def grad_w(w, p):
        w = w.clone().requires_grad_(True)
        loss = torch.mean((target - port_weights.combine(w, p)) ** 2)
        return torch.autograd.grad(loss, w)[0]

    w = torch.rand(4, generator=g)
    wz = w.clone()
    wz[2] = 0.0
    keep = [0, 1, 3]
    assert torch.equal(grad_w(wz, preds)[keep], grad_w(w[keep], preds[keep]))
