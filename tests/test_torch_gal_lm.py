"""The port's LM-scale GAL fit against the reference's python engine.

Two llama3-8b smoke orgs (f32, vocab 1024, so the xent kernel's width is
reached) on the vocab-factorized views of ``examples/train_lm_gal.py``,
2 rounds of 2 local AdamW steps. Params come from the reference's
``init_params``, and each round's weight-fit start ``theta0`` from the
reference's own ``fold_in`` chain, so both fits take the same draws.
Tolerances: 1e-4 relative on etas and train xent, 1e-4 on weights, and
2e-5 relative on the ensemble logits ``predict(rounds=t)`` at every
prefix (they sit near F_0 = log(1e-6) = -13.8) — the fit carries AdamW,
the 60-epoch weight fit and the 25-iteration line search across
frameworks, each in f32.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import gal_lm as port_gal_lm
from repro_torch.core.gal_lm import LMOrganization
from repro_torch.core.losses import CrossEntropyLoss
from repro_torch.data.tokens import make_token_stream, token_batches
from repro_torch.kernels.residual_xent import residual_xent_cuda

from test_torch_reference import (  # noqa: F401
    _one_torch_thread, port_cfg, port_params, reference)

ROUNDS, LOCAL_STEPS, LR = 2, 2, 3e-3


def _views(vocab):
    root = int(math.isqrt(vocab))
    return (lambda t: (t // root) % vocab), (lambda t: (t % root) % vocab)


def _data(vocab):
    rng = np.random.default_rng(0)
    stream = make_token_stream(rng, vocab, 4000)
    return next(token_batches(stream, batch=2, seq_len=16, rng=rng))


def _theta0s(reference, key, rounds, m):
    jax = reference.jax
    out = []
    for t in range(rounds):
        rng_w = jax.random.fold_in(jax.random.fold_in(key, t), 29)
        out.append(torch.tensor([
            0.01 * float(jax.random.normal(jax.random.fold_in(rng_w, i), (),
                                           reference.jnp.float32))
            for i in range(m)]))
    return out


@pytest.fixture(scope="module")
def fits(reference):
    jax, jnp = reference.jax, reference.jnp
    cfg = dataclasses.replace(reference.get_arch("llama3-8b", smoke=True),
                              vocab=1024)
    toks, labels = _data(cfg.vocab)
    key = jax.random.PRNGKey(0)
    views = _views(cfg.vocab)
    ref_orgs = [reference.gal_lm.LMOrganization(i, cfg, views[i])
                for i in range(2)]
    for i, org in enumerate(ref_orgs):
        org.init(jax.random.fold_in(key, i), lr=LR)
    init_params = [org.params for org in ref_orgs]
    want = reference.gal_lm.fit_lm(
        key, ref_orgs, jnp.asarray(toks), jnp.asarray(labels),
        rounds=ROUNDS, local_steps=LOCAL_STEPS, engine="python")

    pcfg = port_cfg(cfg)
    orgs = [LMOrganization(i, pcfg, views[i]) for i in range(2)]
    for i, org in enumerate(orgs):
        org.init(torch.Generator().manual_seed(i), lr=LR, device="cpu")
        org.params = port_params(init_params[i], cfg)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    launches = residual_xent_cuda.launches
    got = port_gal_lm.fit_lm(orgs, tt, tl, rounds=ROUNDS,
                             local_steps=LOCAL_STEPS,
                             theta0s=_theta0s(reference, key, ROUNDS, 2))
    assert residual_xent_cuda.launches == launches    # the CPU runs plain
    return {"want": want, "got": got, "toks": toks, "tt": tt, "tl": tl,
            "jnp": jnp}


def test_fit_lm_etas_weights_history_match(fits):
    want, got = fits["want"], fits["got"]
    assert got.engine == "python" and got.rounds == ROUNDS
    np.testing.assert_allclose(got.etas, want.etas, rtol=1e-4)
    for wg, ww in zip(got.weights, want.weights):
        np.testing.assert_allclose(wg.numpy(), np.asarray(ww), atol=1e-4)
        np.testing.assert_allclose(float(wg.sum()), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.history["train_xent"],
                               want.history["train_xent"], rtol=1e-4)
    assert got.history["train_xent"][-1] < got.history["train_xent"][0]


@pytest.mark.parametrize("t", range(ROUNDS + 1))
def test_predict_every_prefix_matches(fits, t):
    want = np.asarray(fits["want"].predict(fits["jnp"].asarray(fits["toks"]),
                                           rounds=t))
    got = fits["got"].predict(fits["tt"], rounds=t)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    # the prefix replays the fit's own history
    vocab = got.shape[-1]
    y1 = torch.nn.functional.one_hot(fits["tl"].reshape(-1).long(),
                                     vocab).float()
    np.testing.assert_allclose(
        float(CrossEntropyLoss()(y1, got.reshape(-1, vocab))),
        fits["got"].history["train_xent"][t], rtol=1e-6)


def test_fit_lm_options(reference):
    """Uniform weights, the eta stop, and the options still to port."""
    cfg = port_cfg(dataclasses.replace(
        reference.get_arch("llama3-8b", smoke=True), vocab=1024))
    toks, labels = (torch.from_numpy(a) for a in _data(cfg.vocab))
    views = _views(cfg.vocab)
    orgs = [LMOrganization(i, cfg, views[i]) for i in range(2)]
    for i, org in enumerate(orgs):
        org.init(torch.Generator().manual_seed(i), lr=LR, device="cpu")
    res = port_gal_lm.fit_lm(orgs, toks, labels, rounds=3, local_steps=1,
                             use_weights=False, eta_stop_threshold=1e9)
    assert res.rounds == 1                 # |eta| < 1e9 stops after round 1
    assert torch.equal(res.weights[0], torch.tensor([0.5, 0.5]))
    assert len(res.history["train_xent"]) == 2
    assert res.group_params[0]["embed"]["tok"].shape[:2] == (1, 2)
    with pytest.raises(ValueError, match="rounds=2"):
        res.predict(toks, rounds=2)
    for kw in ({"engine": "grouped"}, {"engine": "scan"},
               {"resume_from": res}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            port_gal_lm.fit_lm(orgs, toks, labels, rounds=1, **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        port_gal_lm.fit_lm(orgs, toks, labels, engine="jit")
