"""Scalar line-search optimizers for the gradient assisted learning rate.

The paper line-searches eta with L-BFGS (Table 9, Fig. 4b/e). In 1-D,
L-BFGS reduces exactly to the secant (memory-1 BFGS) iteration; this is
that iteration with Armijo safeguarding, plus golden-section search on a
bracket. Ported from ``src/repro/optim/lbfgs.py``: the loops keep the
reference's fixed trip counts (its ``lax.fori_loop``s), and every branch
is a ``torch.where`` on 0-d device tensors, so the arithmetic is the
reference's and no iteration waits on the host.

``fn`` maps a 0-d f32 tensor to a 0-d tensor; ``device`` is where the
scalars live (that of the tensors ``fn`` closes over).
"""
from __future__ import annotations

import torch

_GOLD = 0.6180339887498949  # 1/phi


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _grad(fn, x: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xr), xr)
    return g


@torch.no_grad()
def golden_section(fn, lo, hi, iters: int = 40, device=None):
    """Minimize scalar fn over [lo, hi] by golden-section search, one fn
    evaluation per iteration (the surviving interior probe's value is
    carried: golden spacing lands it on the next interval's probe)."""
    a = _scalar(lo, device)
    b = _scalar(hi, device)
    d = _GOLD * (b - a)
    x1, x2 = b - d, a + d                 # x1 < x2 interior probes
    f1, f2 = fn(x1), fn(x2)
    for _ in range(iters):
        left = f1 < f2                    # min in [a, x2] else [x1, b]
        a_n = torch.where(left, a, x1)
        b_n = torch.where(left, x2, b)
        d_n = _GOLD * (b_n - a_n)
        x_new = torch.where(left, b_n - d_n, a_n + d_n)
        f_new = fn(x_new)                 # the ONE fresh eval
        x1, f1, x2, f2 = (torch.where(left, x_new, x2),
                          torch.where(left, f_new, f2),
                          torch.where(left, x1, x_new),
                          torch.where(left, f1, f_new))
        a, b = a_n, b_n
    return 0.5 * (a + b)


@torch.no_grad()
def _bracket(fn, x0=1.0, grow: float = 2.0, iters: int = 12, device=None):
    """Expand [0, x0] until fn stops decreasing at the right edge."""
    hi = _scalar(x0, device)
    f_hi = fn(hi)
    for _ in range(iters):
        nhi = hi * grow
        f_nhi = fn(nhi)
        take = f_nhi < f_hi
        hi, f_hi = torch.where(take, nhi, hi), torch.where(take, f_nhi, f_hi)
    return hi


@torch.no_grad()
def scalar_lbfgs(fn, x0=1.0, iters: int = 25, max_range: float = 64.0,
                 device=None):
    """1-D L-BFGS (secant) minimization of fn, Armijo-safeguarded.

    Returns the minimizing scalar. fn must be differentiable by autograd.
    """
    x = _scalar(x0, device)
    x_prev = x - 0.5
    g_prev, gx = _grad(fn, x_prev), _grad(fn, x)
    for _ in range(iters):
        denom = gx - g_prev
        # secant Hessian estimate; unit step when degenerate
        h = torch.where(torch.abs(denom) > 1e-12, (x - x_prev) / denom,
                        _scalar(1.0, x.device))
        h = torch.clamp(h, 1e-4, max_range)
        step = -h * gx
        x_new = torch.clamp(x + step, -max_range, max_range)
        # Armijo halving: fixed 6 trials, branchless; fn(x) is hoisted
        f_x = fn(x)
        for _ in range(6):
            worse = fn(x_new) > f_x + 1e-4 * gx * (x_new - x)
            x_new = torch.where(worse, 0.5 * (x_new + x), x_new)
        x_prev, g_prev, x, gx = x, gx, x_new, _grad(fn, x_new)
    return x


def line_search(fn, method: str = "lbfgs", x0: float = 1.0, iters: int = 25,
                device=None):
    """Unified entry used by the GAL fit. method in {lbfgs, golden,
    constant}."""
    if method == "constant":
        return _scalar(x0, device)
    if method == "golden":
        hi = _bracket(fn, x0=max(x0, 1e-3), device=device)
        return golden_section(fn, 0.0, hi, iters=max(iters, 40),
                              device=device)
    if method == "lbfgs":
        return scalar_lbfgs(fn, x0=x0, iters=iters, device=device)
    raise ValueError(f"unknown line-search method {method!r}")
