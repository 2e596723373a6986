"""Step functions of the LM organizations: local fit and prefill.

Ported from ``src/repro/train/steps.py``: the paper-faithful GAL local fit
``gal_residual_loss`` — the org's model regresses (ell_2) onto the dense
broadcast pseudo-residual r in R^{B x S x V} (paper Alg. 1 step 3) — with
an AdamW step and the per-round run of local steps, and the inference
prefill ``make_prefill_step``: the full-sequence forward that produces
logits for scoring (no cache; the reference leaves that to the serving
layer). Gradients come from ``torch.autograd``; the optimizer is the
port's functional ``adamw``. ``flash=True`` routes attention through
kernel K2, which is forward-only, so a train step with it raises on the
card. The top-K residual transport, Alice's own xent objective,
microbatch accumulation and the decode step come in later slices
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import adamw, apply_updates
from repro_torch.utils.pytree import tree_leaves, tree_unflatten

AUX_COEF = 0.01  # MoE load-balance weight


def _forward(params, cfg: ModelConfig, batch, flash: bool):
    logits, aux = tfm.apply(params, cfg, batch["tokens"], flash=flash)
    return logits, aux


def gal_residual_loss(params, cfg: ModelConfig, batch, flash: bool = False):
    """ell_2 regression onto the dense broadcast pseudo-residual."""
    logits, aux = _forward(params, cfg, batch, flash)
    r = batch["residual"].to(logits.dtype)
    diff = logits - r
    l2 = torch.mean(torch.square(diff), dtype=torch.float32)
    return l2 + AUX_COEF * aux, {"fit_l2": l2, "aux": aux}


LOSS_FNS: Dict[str, Callable] = {"gal_residual": gal_residual_loss}


def make_train_step(cfg: ModelConfig, loss_kind: str = "gal_residual",
                    lr: float = 3e-4, weight_decay: float = 0.1,
                    flash: bool = False, microbatch: int = 1):
    """Returns (train_step, optimizer). train_step: (params, opt_state,
    batch) -> (params, opt_state, metrics); it returns new params and
    leaves the ones it was given untouched."""
    if loss_kind not in LOSS_FNS:
        raise NotImplementedError(
            f"loss {loss_kind!r} is not ported yet (have {sorted(LOSS_FNS)});"
            f" see ROADMAP.md")
    if microbatch != 1:
        raise NotImplementedError(
            "microbatch accumulation is not ported yet; see ROADMAP.md")
    loss_fn = LOSS_FNS[loss_kind]
    opt = adamw(lr, weight_decay=weight_decay)

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            loss, metrics = loss_fn(tree_unflatten(params, leaves), cfg,
                                    batch, flash=flash)
            grads = torch.autograd.grad(loss, leaves)
        grads = tree_unflatten(params, list(grads))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
        return params, opt_state, metrics

    return train_step, opt


def run_local_steps(train_step, params, opt_state, batch, steps: int):
    """Run ``steps`` optimizer steps over one fixed batch: a GAL
    organization's per-round local fit. Returns (params, opt_state,
    per-step metrics stacked to (steps,))."""
    history: Dict[str, Any] = {}
    for _ in range(steps):
        params, opt_state, metrics = train_step(params, opt_state, batch)
        for k, v in metrics.items():
            history.setdefault(k, []).append(v)
    return params, opt_state, {k: torch.stack(v) for k, v in history.items()}


def make_prefill_step(cfg: ModelConfig, flash: bool = False):
    """Inference prefill: full-sequence forward producing logits (scoring).
    Cache materialization is left to the serving layer, as in the
    reference. prefill_step: (params, batch) -> logits (B, S, vocab) in the
    compute dtype; batch["tokens"] is (B, S) int."""

    def prefill_step(params, batch):
        logits, _ = _forward(params, cfg, batch, flash)
        return logits

    return prefill_step
