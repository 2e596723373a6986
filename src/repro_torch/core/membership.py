"""Dynamic-membership schedules: org dropout, stragglers, mid-fit joins.

Ported whole from ``src/repro/core/membership.py`` (host-side numpy, so
the schedules are bit for bit the reference's). A membership schedule is a
boolean ``(rounds, M)`` matrix: row t lists the orgs that show up for
assistance round t. An absent org is masked out of the step-4 weight fit
(exact zero weight, zero gradient), contributes nothing to the ensemble
direction, and disappears from that round's communication ledger.
Schedules are static per fit, so validation and fault injection happen
once, before the first round.

Two sources compose (logical AND):

* an explicit ``gal.fit(membership=...)`` schedule — the deterministic
  "org j drops at round t / joins at round t0" story; and
* ``GALConfig.straggler_sim`` — seeded iid per-(round, org) dropout fault
  injection for robustness testing, with a guarantee that no round ever
  goes empty (the org with the luckiest draw is kept).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.protocol_sim import gal_round_bytes


def straggler_schedule(rounds: int, m: int, rate: float, seed: int = 0
                       ) -> np.ndarray:
    """Seeded iid dropout: each (round, org) cell is absent with
    probability ``rate``. Deterministic in (rounds, m, rate, seed) — the
    same config resumes onto the same schedule. Rounds where every org
    straggled are repaired by keeping the org with the largest uniform
    draw, so a fit can never face an empty round."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"straggler_sim must be in [0, 1), got {rate}")
    u = np.random.default_rng(seed).random((rounds, m))
    live = u >= rate
    for t in range(rounds):
        if not live[t].any():
            live[t, int(np.argmax(u[t]))] = True
    return live


def resolve_membership(membership, straggler_sim: Optional[float],
                       straggler_seed: int, rounds: int, m: int
                       ) -> Optional[np.ndarray]:
    """Combine the explicit schedule and the straggler simulator into one
    validated bool (rounds, M) matrix, or None when every org attends every
    round (the engines then skip membership bookkeeping entirely)."""
    sched = None
    if membership is not None:
        sched = np.asarray(membership)
        if sched.shape != (rounds, m):
            raise ValueError(
                f"membership schedule must have shape (rounds, M) = "
                f"({rounds}, {m}), got {sched.shape}")
        if sched.dtype != np.bool_:
            vals = np.unique(sched)
            if not np.isin(vals, (0, 1)).all():
                raise ValueError(
                    "membership schedule entries must be boolean / 0-1, "
                    f"got values {vals}")
            sched = sched.astype(bool)
        sched = sched.copy()
    if straggler_sim is not None and straggler_sim > 0.0:
        strag = straggler_schedule(rounds, m, straggler_sim, straggler_seed)
        sched = strag if sched is None else (sched & strag)
    if sched is None:
        return None
    empty = np.flatnonzero(~sched.any(axis=1))
    if empty.size:
        raise ValueError(
            "membership schedule has no live org in round(s) "
            f"{empty.tolist()}; every assistance round needs at least one "
            "participant")
    return sched


def membership_comm_ledger(sched: np.ndarray, n: int, k: int,
                           eval_ns=(),
                           resid_dtype_bytes: int | None = None) -> tuple:
    """Per-round (broadcast, gather) byte lists under a membership
    schedule: only the live orgs of round t receive the residual and ship
    fitted values back, so a masked round's ledger equals the reduced org
    set's ledger exactly, and an all-live round's equals the static one.
    ``resid_dtype_bytes`` is the on-the-wire residual width (2 under
    ``residual_dtype="bf16"``), threaded through to ``gal_round_bytes``."""
    bcast, gather = [], []
    for row in np.asarray(sched, bool):
        b, g = gal_round_bytes(n, k, int(row.sum()), eval_ns,
                               resid_dtype_bytes=resid_dtype_bytes)
        bcast.append(b)
        gather.append(g)
    return bcast, gather
