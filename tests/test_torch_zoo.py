"""The port's org models and Organization against the reference.

Each zoo model fits the same residual on the same slice from the same
starting params (the reference's ``init``, converted), then applies the
fit to held-out rows. Data: the conformance matrix's regression slices
(n 128 train, 32 test, 3 features an org; numpy seed 7). Tolerances:
Linear's ridge and KernelRidge relative 1e-4 (as a share of the largest
value; f32 solves in two frameworks), the Adam paths (Linear at q != 2,
MLP) 1e-4 after their epochs, StumpBoost's chosen features exactly, its
thresholds to an ulp and its leaves 1e-5, on data where the best gain of
every stump beats the runner-up by 1e-3 relative.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import losses as port_losses
from repro_torch.core.organizations import Organization, make_orgs
from repro_torch.data.partition import split_features
from repro_torch.data.synthetic import make_regression, train_test_split
from repro_torch.models import zoo as port_zoo
from repro_torch.utils.pytree import tree_leaves, tree_map

from test_torch_reference import (  # noqa: F401
    _one_torch_thread, jax_tree_to_torch, reference, reference_model)


def _slices(k=1):
    rng = np.random.default_rng(7)
    ds = make_regression(rng, n=160, d=12)
    tr, te = train_test_split(ds, rng)
    x = split_features(tr.x, 4)[1]
    x_te = split_features(te.x, 4)[1]
    r = tr.y if k == 1 else torch.from_numpy(
        np.random.default_rng(1).standard_normal((tr.x.shape[0], k))
        .astype(np.float32))
    return x, r, x_te


def _rel_close(got, want, rel):
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _fit_both(reference, model, q, k=1):
    jax, jnp = reference.jax, reference.jnp
    x, r, x_te = _slices(k)
    ref_model = reference_model(reference, model)
    key = jax.random.PRNGKey(3)
    ref_loss = reference.losses.lq_loss(q)
    want = ref_model.fit(key, jnp.asarray(x.numpy()), jnp.asarray(r.numpy()),
                         ref_loss)
    params0 = jax_tree_to_torch(ref_model.init(key, jnp.asarray(x.numpy()),
                                               r.shape[-1]))
    got = model.fit(params0, x, r, port_losses.lq_loss(q))
    return (want, got, ref_model.apply(want, jnp.asarray(x_te.numpy())),
            model.apply(got, x_te), ref_model, x, r)


@pytest.mark.parametrize("model,q,rel", [
    (port_zoo.Linear(), 2.0, 1e-4),
    (port_zoo.KernelRidge(), 2.0, 1e-4),
    (port_zoo.Linear(epochs=50), 1.0, 1e-4),
    (port_zoo.Linear(epochs=50), 1.5, 1e-4),
    (port_zoo.MLP((8,), epochs=50), 2.0, 1e-4),
    (port_zoo.MLP((16, 8), epochs=50), 4.0, 1e-4),
], ids=["linear-ridge", "kernel-ridge", "linear-l1-adam", "linear-l1.5-adam",
        "mlp", "mlp2-l4"])
def test_model_fit_and_apply_match_reference(reference, model, q, rel):
    want, got, want_te, got_te, _, _, _ = _fit_both(reference, model, q,
                                                    k=1 if q == 2.0 else 3)
    _rel_close(got_te, want_te, rel)
    for key in ("w", "alpha"):
        if key in want:
            _rel_close(got[key], want[key], rel)


def test_stump_boost_choices_match_reference(reference):
    model = port_zoo.StumpBoost(n_stumps=12)
    want, got, want_te, got_te, ref_model, x, r = _fit_both(reference,
                                                            model, 2.0)
    # no near tie: the reference's best gain beats its runner-up by 1e-3
    # relative at every stump, so a summation order cannot change a choice
    jnp = reference.jnp
    xs, rs = jnp.asarray(x.numpy()), jnp.asarray(r.numpy())
    thresholds = np.asarray(want["thresholds"])
    masks = np.asarray(xs)[:, :, None] <= thresholds[None]
    resid = np.asarray(rs, np.float64) - np.asarray(want["base"])
    n_left = masks.sum(0)
    for s in range(model.n_stumps):
        sl = np.einsum("ndt,nk->dtk", masks, resid)
        sr = resid.sum(0) - sl
        gain = ((sl * sl).sum(-1) / np.maximum(n_left, 1)
                + (sr * sr).sum(-1) / np.maximum(len(resid) - n_left, 1))
        top2 = np.sort(gain.ravel())[-2:]
        assert top2[1] - top2[0] >= 1e-3 * abs(top2[1]), (s, top2)
        fi = int(np.asarray(want["feat"])[s])
        go_left = np.asarray(xs)[:, fi] <= float(np.asarray(want["thr"])[s])
        resid = resid - np.where(go_left[:, None],
                                 np.asarray(want["left"])[s],
                                 np.asarray(want["right"])[s])
    np.testing.assert_array_equal(got["feat"].numpy(),
                                  np.asarray(want["feat"]))
    np.testing.assert_allclose(got["thresholds"].numpy(),
                               np.asarray(want["thresholds"]), rtol=2e-7,
                               atol=2e-7)
    np.testing.assert_allclose(got["thr"].numpy(), np.asarray(want["thr"]),
                               rtol=2e-7, atol=2e-7)
    for key in ("left", "right", "base"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)
    np.testing.assert_allclose(got_te.numpy(), np.asarray(want_te),
                               atol=1e-5)


def test_mlp_surface_matches_reference(reference):
    """features / apply_head reproduce apply, on the reference's params."""
    jnp = reference.jnp
    model = port_zoo.MLP((6, 5))
    ref_model = reference_model(reference, model)
    x, _, _ = _slices()
    p = ref_model.init(reference.jax.random.PRNGKey(0), jnp.asarray(x.numpy()),
                       2)
    tp = jax_tree_to_torch(p)
    np.testing.assert_allclose(
        model.features(tp, x).numpy(),
        np.asarray(ref_model.features(p, jnp.asarray(x.numpy()))), atol=1e-6)
    np.testing.assert_allclose(
        model.apply_head(tp["head"], model.features(tp, x)).numpy(),
        np.asarray(ref_model.apply(p, jnp.asarray(x.numpy()))), atol=1e-6)
    head = model.init_head(torch.Generator().manual_seed(0), 2)
    assert head["w"].shape == (5, 2) and model.feature_dim(x) == 5


@pytest.mark.parametrize("name,cls", [
    ("linear", port_zoo.Linear), ("mlp", port_zoo.MLP),
    ("stump_boost", port_zoo.StumpBoost),
    ("kernel_ridge", port_zoo.KernelRidge)])
def test_zoo_registry_and_init_shapes(reference, name, cls):
    """The registry names the reference's, and init gives the reference's
    tree of shapes, on the slice's device."""
    model = port_zoo.get_local_model(name)
    assert isinstance(model, cls) and name in port_zoo.ZOO
    x = torch.zeros((5, 3))
    got = model.init(torch.Generator().manual_seed(0), x, 2)
    want = reference_model(reference, model).init(
        reference.jax.random.PRNGKey(0), reference.jnp.zeros((5, 3)), 2)
    assert tree_map(lambda t: tuple(t.shape), got) == \
        tree_map(lambda t: tuple(t.shape), jax_tree_to_torch(want))
    assert all(t.device == x.device for t in tree_leaves(got))


@pytest.mark.parametrize("name", ["convnet", "grunet"])
def test_unported_models_raise_naming_the_roadmap(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_zoo.get_local_model(name)


def test_organization_rounds_and_refusals():
    x, r, x_te = _slices()
    org = Organization(index=3, x_train=x, model=port_zoo.Linear())
    fitted = org.fit_round(None, r)
    np.testing.assert_allclose(fitted.numpy(),
                               org.predict_round(0, x).numpy())
    org.fit_round(None, 2 * r, live=False)
    assert org.n_rounds_fit == 2
    np.testing.assert_allclose(org.predict_round(1, x_te).numpy(),
                               2 * org.predict_round(0, x_te).numpy(),
                               rtol=1e-4, atol=1e-5)
    org.reset_round_state()
    assert org.n_rounds_fit == 0
    orgs = make_orgs([x, x_te[:, :2]], [port_zoo.Linear(), port_zoo.MLP()],
                     local_losses=port_losses.lq_loss(1.0))
    assert [o.index for o in orgs] == [0, 1]
    assert all(o.local_loss.q == 1.0 for o in orgs)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_orgs([x], port_zoo.MLP(), dms=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_orgs([x, x], port_zoo.Linear(), noise_sigmas=[0.0, 1.0])
