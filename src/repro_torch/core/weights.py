"""Gradient assistance weights (paper Alg. 1 + Appendix D.4.2).

Alice solves  w-hat = argmin_{w in simplex}  E_N ell_1(r, sum_m w_m f_m)
with the simplex enforced by a softmax parametrization and optimized with
Adam (paper Table 9: lr 1e-1, weight decay 5e-4). Ported from
``src/repro/core/weights.py``. The reference draws the softmax logits'
start ``theta0`` from ``jax.random``, one draw per org id; the port cannot
replay those draws, so ``theta0`` is an input keyed by org id, and is
drawn from a ``torch.Generator`` when the caller gives none.

Dynamic membership enters as a per-org ``mask``: absent orgs get an exact
zero weight. Every sum over the org axis here is a fold in org order
(``combine`` and the softmax's normaliser), so an absent org's exact
zeros leave every partial sum as it was: a masked fit is bitwise the fit
of the reduced org set, given the same per-org-id starts.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.optim.optimizers import adam, apply_updates


def _masked_softmax(theta: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """softmax over the live entries only; masked entries are EXACT zeros.

    The shift is a detached max over live entries, so live thetas see the
    gradients of a reduced-size softmax and masked thetas exactly zero
    gradient. With one live entry the result is exactly 1.0.
    """
    neg = torch.full_like(theta, -torch.inf)
    shift = torch.max(torch.where(mask, theta, neg)).detach()
    e = torch.where(mask, torch.exp(theta - shift), torch.zeros_like(theta))
    total = e[0]
    for m in range(1, e.shape[0]):
        total = total + e[m]
    return e / total


class _Combine(torch.autograd.Function):
    """The fold of ``combine`` with a backward that reads each org output
    once: d/dw_m = <g, preds_m>, one dot per org, where autograd through
    the fold would write and re-read every w_m * preds_m."""

    @staticmethod
    def forward(ctx, w, *preds):
        ctx.save_for_backward(w, *preds)
        out = w[0] * preds[0]
        for m in range(1, len(preds)):
            out.addcmul_(w[m], preds[m])
        return out

    @staticmethod
    def backward(ctx, g):
        w, *preds = ctx.saved_tensors
        gw = None
        if ctx.needs_input_grad[0]:
            flat = g.reshape(-1)
            gw = torch.stack([torch.dot(flat, p.reshape(-1))
                              for p in preds]).to(w.dtype)
        gp = [w[m] * g if ctx.needs_input_grad[m + 1] else None
              for m in range(len(preds))]
        return (gw, *gp)


def combine(w: torch.Tensor, preds) -> torch.Tensor:
    """sum_m w_m preds_m over stacked (M, N, K) org outputs (or a list of
    (N, K)), folded in org order: an org with an exact-zero weight adds
    exact zeros, so the sum is bitwise that of the stack without it."""
    return _Combine.apply(w, *preds)


def fit_weights(residual: torch.Tensor, preds: torch.Tensor, loss: Callable,
                epochs: int = 100, lr: float = 0.1,
                weight_decay: float = 5e-4,
                mask: Optional[torch.Tensor] = None,
                theta0=None,
                org_ids: Optional[Sequence[int]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """preds: (M, N, K) stacked org outputs; returns w in the M-simplex.

    ``org_ids`` names the org of each row of ``preds`` (default 0..M-1).
    ``theta0`` is the start of the softmax logits keyed by org id:
    ``theta0[i]`` is org i's, a small jitter around uniform weights (the
    reference draws 0.01 * N(0, 1) from ``fold_in(rng, i)``). A mapping or
    a tensor indexed by id will do. Without it, 0.01 * N(0, 1) is drawn per
    row from ``generator`` (on its device). theta is pinned to f32 so the
    simplex stays full precision when the org outputs arrive in a lower
    dtype. ``mask`` (M,) bool pins absent orgs to an exact zero weight
    (None = all live).
    """
    m = preds.shape[0]
    device = preds.device
    if theta0 is None:
        gen_device = generator.device if generator is not None else "cpu"
        theta = 0.01 * torch.randn((m,), generator=generator,
                                   dtype=torch.float32, device=gen_device)
    else:
        ids = range(m) if org_ids is None else org_ids
        theta = torch.stack([torch.as_tensor(theta0[int(i)],
                                             dtype=torch.float32).cpu()
                             for i in ids])
    theta = theta.to(device)
    if mask is None:
        mask = torch.ones((m,), dtype=torch.bool, device=device)

    def objective(th):
        w = _masked_softmax(th, mask)
        return loss(residual, combine(w, preds))

    opt = adam(lr, weight_decay=weight_decay)
    state = opt.init(theta)
    for _ in range(epochs):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(th), th)
        upd, state = opt.update(g, state, theta)
        theta = apply_updates(theta, upd)
    return _masked_softmax(theta, mask)


def uniform_weights(m: int, mask: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """Direct-average ablation (Table 6, 'Weight = x'); with a membership
    ``mask``, the average renormalizes over the live orgs."""
    if mask is None:
        return torch.full((m,), 1.0 / m, dtype=torch.float32, device=device)
    maskf = mask.to(torch.float32)
    return maskf / torch.sum(maskf)
