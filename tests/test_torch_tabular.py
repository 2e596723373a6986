"""The port's tabular GAL fit against the reference's python engine.

Cells copied from the reference's conformance matrix
(``tests/test_conformance.py``: homogeneous, hetero, custom_loss,
early_stop) and from its core tests (a blobs classification cell), plus
one cell per option of the round: dp and ip privacy, the bf16 wire, a
straggler schedule, uniform weights with the golden-section search, a
constant eta, and MLP orgs beside Linear ones. The
data come from a numpy seed; the reference fits from ``PRNGKey(0)`` and
the port from ``ReferenceDraws``, which replays that key's draws, on the
CPU.

Tolerances: etas and weights atol 1e-4, every float history column
relative 1e-4, the byte and model-memory columns exactly, and
``predict`` at every round prefix relative 1e-3, with the absolute 1e-3
that the reference's own cross-engine matrix allows entries near zero
(KernelRidge's f32 solves alone differ by up to 5e-4 between the two
frameworks at this size: each is about 1e-4 of |f| from the f64 answer,
the kernel matrix's condition number being some 4e3). Where an
Adam-fitted org widens one, the assertion says by how much and why.

Then the pins inside the port: an org masked out of every round gives
bitwise the fit of the org set without it, and a refit after
``reset_round_state`` is bitwise the first fit. Then the K1 route at
K = 1024 (on the CPU, the kernel's plain version) and what the fit
refuses.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import gal as port_gal
from repro_torch.core import losses as port_losses
from repro_torch.core.gal import GALConfig
from repro_torch.core.organizations import Organization, make_orgs
from repro_torch.data.partition import split_features
from repro_torch.data.synthetic import (make_blobs, make_regression,
                                        train_test_split)
from repro_torch.models import zoo as port_zoo
from repro_torch.utils import device as device_mod

from test_torch_reference import (  # noqa: F401
    ReferenceDraws, _one_torch_thread, reference, reference_model)

M, ROUNDS = 4, 3
ETA_ATOL, W_ATOL, HIST_RTOL, PRED_RTOL, PRED_ATOL = 1e-4, 1e-4, 1e-4, 1e-3, 1e-3


def _pseudo_huber_port(r, f):
    return torch.mean(torch.sqrt(1.0 + torch.square(r - f)) - 1.0)


def _pseudo_huber_ref(jnp):
    def _pseudo_huber(r, f):
        return jnp.mean(jnp.sqrt(1.0 + jnp.square(r - f)) - 1.0)
    return _pseudo_huber


def _regression():
    """The conformance matrix's data (n 160, d 12, seed 7)."""
    rng = np.random.default_rng(7)
    ds = make_regression(rng, n=160, d=12)
    tr, te = train_test_split(ds, rng)
    return tr.x.numpy(), tr.y.numpy(), te.x.numpy(), te.y.numpy()


def _blobs(n=150, d=10, k=5):
    """The core tests' blobs cell (n 150, d 10, k 5, seed 0)."""
    rng = np.random.default_rng(0)
    ds = make_blobs(rng, n=n, d=d, k=k)
    tr, te = train_test_split(ds, rng)
    return tr.x.numpy(), tr.y.numpy(), te.x.numpy(), te.y.numpy()


# cell -> (data, port models, local loss or None, loss, metric, config)
CELLS = {
    "homogeneous": (_regression, lambda: port_zoo.Linear(), None, "mse",
                    "mad", {}),
    "hetero": (_regression,
               lambda: [port_zoo.StumpBoost(n_stumps=8) if i % 2 == 0
                        else port_zoo.KernelRidge() for i in range(M)],
               None, "mse", "mad", {}),
    "custom_loss": (_regression, lambda: port_zoo.Linear(epochs=25),
                    "pseudo_huber", "mse", "mad", {}),
    "early_stop": (_regression, lambda: port_zoo.Linear(), None, "mse",
                   "mad", {"rounds": 8, "eta_stop_threshold": 10.0}),
    "classification": (_blobs, lambda: port_zoo.Linear(), None, "xent",
                       "accuracy", {}),
    "dp": (_regression, lambda: port_zoo.Linear(), None, "mse", "mad",
           {"privacy": "dp"}),
    "ip": (_regression, lambda: port_zoo.Linear(), None, "mse", "mad",
           {"privacy": "ip", "privacy_intervals": 2}),
    "bf16_wire": (_regression, lambda: port_zoo.Linear(), None, "mse",
                  "mad", {"residual_dtype": "bf16"}),
    "straggler": (_regression, lambda: port_zoo.Linear(), None, "mse",
                  "mad", {"straggler_sim": 0.3, "straggler_seed": 1}),
    "uniform_golden": (_regression, lambda: port_zoo.Linear(), None, "mse",
                       "mad", {"use_weights": False, "eta_method": "golden"}),
    "constant_eta": (_regression, lambda: port_zoo.Linear(), None, "mse",
                     "mad", {"eta_method": "constant", "eta0": 0.7}),
    "mlp_mix": (_regression,
                lambda: [port_zoo.MLP((8,), epochs=20), port_zoo.Linear(),
                         port_zoo.MLP((8,), epochs=20), port_zoo.Linear()],
                None, "mse", "mad", {}),
}


def _ref_models(reference, models):
    if isinstance(models, list):
        return [reference_model(reference, m) for m in models]
    return reference_model(reference, models)


def _run_both(reference, cell):
    """(reference result, port result, port eval slices, eval y)."""
    jax, jnp = reference.jax, reference.jnp
    data, models, local, loss, metric, cfg = CELLS[cell]
    x, y, x_te, y_te = data()
    cfg = {"rounds": ROUNDS, **cfg}
    xs = split_features(torch.from_numpy(x), M)
    xs_te = split_features(torch.from_numpy(x_te), M)
    port_models = models()
    ref_orgs = reference.organizations.make_orgs(
        [jnp.asarray(s.numpy()) for s in xs],
        _ref_models(reference, port_models),
        local_losses=None if local is None else _pseudo_huber_ref(jnp))
    want = reference.gal.fit(
        jax.random.PRNGKey(0), ref_orgs, jnp.asarray(y),
        reference.losses.get_loss(loss),
        reference.gal.GALConfig(engine="python", **cfg),
        eval_sets={"test": ([jnp.asarray(s.numpy()) for s in xs_te],
                            jnp.asarray(y_te))},
        metrics=(metric,))
    got = port_gal.fit(
        make_orgs(xs, port_models,
                  local_losses=None if local is None else _pseudo_huber_port),
        torch.from_numpy(y), port_losses.get_loss(loss), GALConfig(**cfg),
        eval_sets={"test": (xs_te, torch.from_numpy(y_te))},
        metrics=(metric,),
        draws=ReferenceDraws(reference, jax.random.PRNGKey(0)),
        device="cpu")
    return want, got, xs_te, [jnp.asarray(s.numpy()) for s in xs_te]


@pytest.mark.parametrize("cell", list(CELLS))
def test_fit_matches_reference_python_engine(reference, cell):
    want, got, xs_te, ref_xs_te = _run_both(reference, cell)
    assert got.engine == "python"
    assert got.rounds == want.rounds
    if cell == "early_stop":
        assert got.rounds == 1
    np.testing.assert_allclose(got.etas, want.etas, rtol=0, atol=ETA_ATOL)
    np.testing.assert_allclose(np.stack([w.numpy() for w in got.weights]),
                               np.stack([np.asarray(w) for w in want.weights]),
                               atol=W_ATOL)
    assert list(got.history) == list(want.history)
    for col, vals in want.history.items():
        if col.startswith("comm_") or col == "model_memories":
            assert got.history[col] == vals, col
            assert all(isinstance(v, int) for v in got.history[col]), col
        else:
            np.testing.assert_allclose(got.history[col], vals,
                                       rtol=HIST_RTOL, atol=0, err_msg=col)
    assert got.membership == want.membership
    for t in range(got.rounds + 1):
        np.testing.assert_allclose(
            got.predict(xs_te, rounds=t).numpy(),
            np.asarray(want.predict(ref_xs_te, rounds=t)),
            rtol=PRED_RTOL, atol=PRED_ATOL, err_msg=f"predict(rounds={t})")


# ------------------------------------------------------ pins inside the port
def _pin_data():
    x, y, x_te, y_te = _regression()
    return (split_features(torch.from_numpy(x), M), torch.from_numpy(y),
            split_features(torch.from_numpy(x_te), M), torch.from_numpy(y_te))


def _pin_models():
    return [port_zoo.Linear(), port_zoo.MLP((8,), epochs=10),
            port_zoo.StumpBoost(n_stumps=8), port_zoo.KernelRidge()]


@pytest.mark.parametrize("absent", [0, 2])
def test_masked_org_is_absent_org_bitwise(absent):
    """An org masked out of every round leaves the etas, the live orgs'
    weights and predict bitwise as the fit without it: its draws are keyed
    by its id, its weight is an exact zero, and every sum over the orgs
    folds in org order."""
    xs, y, xs_te, y_te = _pin_data()
    models = _pin_models()
    loss = port_losses.get_loss("mse")
    cfg = GALConfig(rounds=ROUNDS)
    sched = np.ones((ROUNDS, M), bool)
    sched[:, absent] = False
    masked = port_gal.fit(make_orgs(xs, models), y, loss, cfg,
                          membership=sched, device="cpu")
    keep = [i for i in range(M) if i != absent]
    reduced = port_gal.fit(
        [Organization(index=i, x_train=xs[i], model=models[i])
         for i in keep], y, loss, cfg, device="cpu")
    assert masked.etas == reduced.etas
    for wm, wr in zip(masked.weights, reduced.weights):
        assert float(wm[absent]) == 0.0
        assert torch.equal(wm[keep], wr)
    assert torch.equal(masked.predict(xs_te),
                       reduced.predict([xs_te[i] for i in keep]))
    assert masked.history["comm_gather_bytes"] == \
        reduced.history["comm_gather_bytes"]


def test_refit_after_reset_is_bitwise_the_first_fit():
    xs, y, xs_te, y_te = _pin_data()
    orgs = make_orgs(xs, _pin_models())
    loss = port_losses.get_loss("mse")
    cfg = GALConfig(rounds=ROUNDS, privacy="dp")
    first = port_gal.fit(orgs, y, loss, cfg, device="cpu",
                         eval_sets={"test": (xs_te, y_te)}, metrics=("mad",))
    pred_first = first.predict(xs_te)
    second = port_gal.fit(orgs, y, loss, cfg, device="cpu",
                          eval_sets={"test": (xs_te, y_te)},
                          metrics=("mad",))
    assert all(org.n_rounds_fit == ROUNDS for org in orgs)
    assert second.etas == first.etas
    assert second.history == first.history
    for a, b in zip(second.weights, first.weights):
        assert torch.equal(a, b)
    assert torch.equal(second.predict(xs_te), pred_first)


# ------------------------------------------------------------- the K1 route
def test_k1_route_at_1024_classes_agrees_with_closed_form(monkeypatch):
    """With the CPU let onto the route, CrossEntropyLoss.residual takes
    the kernel's plain version at K = 1024, and a whole fit through it
    agrees with the closed form to 2e-5."""
    rng = np.random.default_rng(3)
    ds = make_blobs(rng, n=192, d=8, k=1024)
    xs = split_features(ds.x, 2)
    loss = port_losses.get_loss("xent")
    cfg = GALConfig(rounds=2, weight_epochs=10)
    closed = port_gal.fit(make_orgs(xs, port_zoo.Linear()), ds.y, loss, cfg,
                          device="cpu")
    calls = []
    plain = port_losses.residual_xent

    def counted(logits, labels, use_kernel=True):
        assert logits.is_contiguous()        # what the CUDA kernel takes
        calls.append(tuple(logits.shape))
        return plain(logits, labels, use_kernel=use_kernel)

    monkeypatch.setattr(port_losses, "XENT_KERNEL_BACKENDS", ("cuda", "cpu"))
    monkeypatch.setattr(port_losses, "residual_xent", counted)
    routed = port_gal.fit(make_orgs(xs, port_zoo.Linear()), ds.y, loss, cfg,
                          device="cpu")
    assert calls == [(192, 1024)] * 2
    f = closed.f0.expand(192, 1024) + 0.3 * torch.randn(
        (192, 1024), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(loss.residual(ds.y, f).numpy(),
                               (ds.y - torch.softmax(f, -1)).numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(routed.etas, closed.etas, rtol=2e-5)
    np.testing.assert_allclose(routed.history["train_loss"],
                               closed.history["train_loss"], rtol=2e-5)
    for a, b in zip(routed.weights, closed.weights):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


# ----------------------------------------------------------- what it refuses
@pytest.mark.parametrize("change", [
    {"engine": "auto"}, {"engine": "scan"}, {"engine": "grouped"},
    {"engine": "shard"}, {"data_shards": 2}])
def test_unported_options_raise_naming_the_roadmap(change):
    xs, y, _, _ = _pin_data()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_gal.fit(make_orgs(xs, port_zoo.Linear()), y,
                     port_losses.get_loss("mse"), GALConfig(**change),
                     device="cpu")


def test_resume_and_unknown_options_raise():
    xs, y, _, _ = _pin_data()
    mse = port_losses.get_loss("mse")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_gal.fit(make_orgs(xs, port_zoo.Linear()), y, mse,
                     resume_from="artifact", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        port_gal.fit(make_orgs(xs, port_zoo.Linear()), y, mse,
                     GALConfig(engine="jit"), device="cpu")
    with pytest.raises(ValueError, match="residual_dtype"):
        port_gal.fit(make_orgs(xs, port_zoo.Linear()), y, mse,
                     GALConfig(residual_dtype="fp8"), device="cpu")
    with pytest.raises(ValueError, match="collides"):
        port_gal.fit(make_orgs(xs, port_zoo.Linear()), y, mse,
                     GALConfig(rounds=1), device="cpu",
                     eval_sets={"test": (xs, y)},
                     metrics=(_named("loss"),))


def test_metric_columns():
    """``metric_fn`` fills "<eval>_metric", each ``metrics`` entry its own
    column; a name used twice raises."""
    xs, y, xs_te, y_te = _pin_data()
    mse = port_losses.get_loss("mse")
    res = port_gal.fit(make_orgs(xs, port_zoo.Linear()), y, mse,
                       GALConfig(rounds=2), device="cpu",
                       eval_sets={"test": (xs_te, y_te)},
                       metric_fn=port_gal.get_metric("mad"),
                       metrics=("mad", _named("bias")))
    assert res.history["test_metric"] == res.history["test_mad"]
    assert len(res.history["test_bias"]) == 3
    np.testing.assert_allclose(
        res.history["test_mad"][-1],
        float(torch.mean(torch.abs(res.predict(xs_te) - y_te))), rtol=1e-6)
    with pytest.raises(ValueError, match="duplicate"):
        port_gal.fit(make_orgs(xs, port_zoo.Linear()), y, mse,
                     GALConfig(rounds=1), device="cpu",
                     eval_sets={"test": (xs_te, y_te)},
                     metrics=("mad", _named("mad")))


def _named(name):
    def fn(y, f):
        return torch.mean(y - f)
    fn.__name__ = name
    return fn


def test_fit_runs_on_the_card_by_default(monkeypatch):
    """``device=None`` is the card: without one the fit raises, and does
    not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xs, y, _, _ = _pin_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_gal.fit(make_orgs(xs, port_zoo.Linear()), y,
                     port_losses.get_loss("mse"))
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_draws_are_keyed_by_round_and_org_id():
    """The default draws: the same (seed, round, org id) gives the same
    values whatever the org set, another round or id another."""
    d = port_gal.Draws(5)
    full = d.theta0(1, [0, 1, 2, 3])
    assert torch.equal(d.theta0(1, [3, 1])[3], full[3])
    assert not torch.equal(d.theta0(2, [3])[3], full[3])
    assert not torch.equal(full[0], full[1])
    x = torch.zeros((4, 3))
    org = Organization(index=2, x_train=x, model=port_zoo.MLP((4,)))
    a = d.init_params(0, org, x, 2)
    b = port_gal.Draws(5).init_params(0, org, x, 2)
    assert torch.equal(a["layers"][0]["w"], b["layers"][0]["w"])
    assert torch.equal(d.privacy_u(0, (3, 2)), d.privacy_u(0, (3, 2)))
    assert not torch.equal(d.privacy_u(0, (3, 2)), d.privacy_u(1, (3, 2)))
