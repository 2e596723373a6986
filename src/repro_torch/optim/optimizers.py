"""Functional optimizers (optax-style init/update pairs) on parameter trees.

Ported as the reference writes them (``src/repro/optim/optimizers.py``),
not as ``torch.optim``: ``adam`` couples its weight decay as L2 into the
gradient, ``adamw`` decouples it. Updates are returned, never applied in
place, so a caller may keep the params it passed (GAL keeps per-round
snapshots). The moments take each param's dtype (bf16 at full width); the
update itself is f32, as JAX promotes ``bf16 / f32`` — hence the explicit
``.float()`` where torch would keep bf16 — and ``apply_updates`` casts the
sum back to the param dtype.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (updates, state)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _as_schedule(lr) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam; weight_decay here is *coupled* L2 (as torch.optim.Adam, used by
    the paper's assistance-weight fit: lr 1e-1, wd 5e-4)."""
    sched = _as_schedule(lr)

    def init(params):
        device = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step - 1)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                     state["v"], grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)
        upd = tree_map(
            lambda m_, v_: -lr_t * (m_.float() / bc1)
            / (torch.sqrt(v_.float() / bc2) + eps), m, v)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW: decoupled weight decay (LM-scale local fits)."""
    sched = _as_schedule(lr)
    base = adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)

    @torch.no_grad()
    def update(grads, state, params):
        upd, state = base.update(grads, state, params)
        if weight_decay:
            lr_t = sched(state["step"] - 1)
            upd = tree_map(lambda u, p: u - lr_t * weight_decay * p.float(),
                           upd, params)
        return upd, state

    return Optimizer(base.init, update)
