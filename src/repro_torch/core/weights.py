"""Gradient assistance weights (paper Alg. 1 + Appendix D.4.2).

Alice solves  w-hat = argmin_{w in simplex}  E_N ell_1(r, sum_m w_m f_m)
with the simplex enforced by a softmax parametrization and optimized with
Adam (paper Table 9: lr 1e-1, weight decay 5e-4). Ported from
``src/repro/core/weights.py``. The reference draws the softmax logits'
start ``theta0`` from ``jax.random``; the port cannot replay those draws,
so ``theta0`` is an input, and is drawn from a ``torch.Generator`` when
the caller gives none.
"""
from __future__ import annotations

from typing import Callable, Optional

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
    return e / torch.sum(e)


def fit_weights(residual: torch.Tensor, preds: torch.Tensor, loss: Callable,
                epochs: int = 100, lr: float = 0.1,
                weight_decay: float = 5e-4,
                mask: Optional[torch.Tensor] = None,
                theta0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """preds: (M, N, K) stacked org outputs; returns w in the M-simplex.

    ``theta0`` (M,) is the start of the softmax logits, a small jitter
    around uniform weights (the reference draws 0.01 * N(0, 1) per org id).
    Without it, 0.01 * N(0, 1) is drawn from ``generator`` (on its device).
    theta is pinned to f32 so the simplex stays full precision when the org
    outputs arrive in a lower dtype. ``mask`` (M,) bool pins absent orgs to
    an exact zero weight (None = all live).
    """
    m = preds.shape[0]
    device = preds.device
    if theta0 is None:
        gen_device = generator.device if generator is not None else "cpu"
        theta0 = 0.01 * torch.randn((m,), generator=generator,
                                    dtype=torch.float32, device=gen_device)
    theta = torch.as_tensor(theta0, dtype=torch.float32).to(device)
    if mask is None:
        mask = torch.ones((m,), dtype=torch.bool, device=device)

    def objective(th):
        w = _masked_softmax(th, mask)
        return loss(residual, torch.einsum("m,mnk->nk", w, preds))

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
