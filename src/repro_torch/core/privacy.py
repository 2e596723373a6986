"""Privacy enhancement of the broadcast pseudo-residuals (paper Sec. 4.5).

Ported from ``src/repro/core/privacy.py``, with the random draw taken as
an input (the port's rule for random draws): ``u`` is uniform on [0, 1),
of the shape ``noise_shape`` names for the mechanism.

GAL_DP — Laplace mechanism with privacy budget alpha: per-coordinate scale
b = sensitivity / alpha where sensitivity is the empirical column range of
the residual tensor (the quantity actually broadcast).

GAL_IP — Interval Privacy (Ding & Ding, 2022): n_intervals random split
points are drawn per column; each residual reports only the midpoint of
the bin it falls in, revealing comparison bits instead of the value.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# the open interval the reference draws the Laplace uniform from
_DP_LO, _DP_HI = -0.5 + 1e-6, 0.5 - 1e-6


def noise_shape(mechanism: Optional[str], residual_shape: Tuple[int, ...],
                n_intervals: int = 1) -> Optional[Tuple[int, ...]]:
    """The shape of the uniform draw ``mechanism`` takes for a residual of
    ``residual_shape`` (N, K), or None when it takes none."""
    if mechanism in (None, "none"):
        return None
    if mechanism == "dp":
        return tuple(residual_shape)
    if mechanism == "ip":
        return (n_intervals, residual_shape[-1])
    raise ValueError(f"unknown privacy mechanism {mechanism!r}")


def dp_laplace(residual: torch.Tensor, u: torch.Tensor,
               alpha: float = 1.0) -> torch.Tensor:
    """u: (N, K) uniform on [0, 1), mapped onto the reference's
    (-0.5 + 1e-6, 0.5 - 1e-6) as ``jax.random.uniform`` maps it."""
    lo = torch.amin(residual, dim=0, keepdim=True)
    hi = torch.amax(residual, dim=0, keepdim=True)
    sensitivity = torch.clamp_min(hi - lo, 1e-8)
    scale = sensitivity / alpha
    dp_lo = torch.tensor(_DP_LO, dtype=torch.float32, device=u.device)
    dp_hi = torch.tensor(_DP_HI, dtype=torch.float32, device=u.device)
    u = torch.maximum(dp_lo, u * (dp_hi - dp_lo) + dp_lo)
    noise = -scale * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
    return residual + noise


def ip_interval(residual: torch.Tensor, u: torch.Tensor,
                n_intervals: int = 1) -> torch.Tensor:
    """residual: (N, K); u: (n_intervals, K) uniform on [0, 1). Each value
    reports only the midpoint of its bin; bin edges are n_intervals random
    split points per column."""
    lo = torch.amin(residual, dim=0)                             # (K,)
    hi = torch.amax(residual, dim=0)
    splits = torch.sort(lo[None] + u * (hi - lo)[None], dim=0).values
    edges = torch.cat(
        [lo[None], splits, (hi + 1e-6)[None]], dim=0)            # (S+2, K)
    # bin index: count of edges (excluding last) <= value
    idx = torch.sum(residual[None] >= edges[:-1][:, None, :], dim=0) - 1
    idx = torch.clamp(idx, 0, n_intervals)                       # (N, K)
    left = torch.gather(edges, 0, idx)
    right = torch.gather(edges, 0, idx + 1)
    return 0.5 * (left + right)


def apply_privacy(residual: torch.Tensor, mechanism: Optional[str],
                  u: Optional[torch.Tensor] = None, alpha: float = 1.0,
                  n_intervals: int = 1) -> torch.Tensor:
    """``u``: the mechanism's uniform draw, of ``noise_shape(mechanism,
    residual.shape, n_intervals)``; None without a mechanism."""
    if mechanism in (None, "none"):
        return residual
    if mechanism == "dp":
        return dp_laplace(residual, u, alpha=alpha)
    if mechanism == "ip":
        return ip_interval(residual, u, n_intervals=n_intervals)
    raise ValueError(f"unknown privacy mechanism {mechanism!r}")
