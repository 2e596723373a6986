"""Communication/computation accounting for the GAL protocol (paper Table 14).

Ported whole from ``src/repro/core/protocol_sim.py``: integer arithmetic,
so every count is the reference's exactly.

Counts the bytes and rounds actually exchanged by Algorithm 1 vs sequential AL
under identical ensemble sizes, and maps the protocol's collectives onto mesh
axes for the distributed runtime:

  residual broadcast  r^t (N x K)        Alice -> M-1 orgs    per round
  fitted values       f_m^t(x_m) (N x K) each org -> Alice    per round
  prediction stage    f_m^t(x_m*)        each org -> Alice    per round

GAL runs orgs in parallel (1 communication round / assistance round); AL
serializes them (M communication rounds per sweep).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProtocolCost:
    method: str
    orgs: int
    ensemble_members: int
    comm_rounds: int           # synchronization points on the wire
    bytes_broadcast: int       # Alice -> orgs
    bytes_gathered: int        # orgs -> Alice
    sequential_fits: int       # wall-clock critical-path local fits
    model_memories: int        # live model copies (DMS saves T x)

    @property
    def bytes_total(self) -> int:
        return self.bytes_broadcast + self.bytes_gathered


def gal_round_bytes(n: int, k: int, m: int, eval_ns=(),
                    dtype_bytes: int = 4,
                    resid_dtype_bytes: int | None = None) -> tuple:
    """Bytes crossing org boundaries in ONE assistance round, Table-14
    convention: Alice ships the privatized residual to the other M-1 orgs;
    all M orgs — Alice included — ship their fitted values back for the
    train set AND for each eval prediction stage (``eval_ns`` lists the
    eval-set row counts). Returns ``(broadcast, gathered)`` as exact ints.

    ``resid_dtype_bytes`` is the on-the-wire width of the residual
    broadcast alone (``GALConfig(residual_dtype="bf16")`` casts it to 2
    bytes before it leaves Alice); the gathered fitted values always travel
    at ``dtype_bytes``. Defaults to ``dtype_bytes`` — the uncompressed
    protocol.

    This is the one source of the fit's per-round communication ledger
    (``history["comm_broadcast_bytes"/"comm_gather_bytes"]``)."""
    if resid_dtype_bytes is None:
        resid_dtype_bytes = dtype_bytes
    broadcast = (m - 1) * n * k * resid_dtype_bytes
    gathered = m * n * k * dtype_bytes + sum(m * int(ne) * k * dtype_bytes
                                             for ne in eval_ns)
    return broadcast, gathered


def gal_model_memories(rounds: int, dms_flags, membership=None) -> list:
    """Per-round live model copies (paper Table 14's computation-space row,
    Sec. 5 Deep Model Sharing): after round t+1, a fresh-fit organization
    holds t+1 full models (one per round) while a DMS organization holds
    ONE shared extractor — its per-round heads are the lightweight Tx
    saving. ``dms_flags`` is the per-org DMS flag list in org order.

    ``membership`` is an optional bool (rounds, M) attendance schedule
    (see core/membership.py): a fresh-fit org only accrues a model in the
    rounds it attends, and a DMS org's shared extractor exists from its
    first attended round onward. An org that never shows up holds nothing,
    so a fully-masked org leaves the ledger identical to the reduced org
    set's — while an all-live schedule reproduces the static counts.

    This is the one source of ``history["model_memories"]``; for an all-DMS (resp. no-DMS) org set the final entry equals
    ``gal_cost(..., dms=True).model_memories`` (resp. ``dms=False``)."""
    if membership is None:
        m_dms = sum(1 for f in dms_flags if f)
        m_fresh = len(dms_flags) - m_dms
        return [m_dms + (t + 1) * m_fresh for t in range(rounds)]
    out = []
    attended = [0] * len(dms_flags)
    for t in range(rounds):
        for j, flag in enumerate(dms_flags):
            if membership[t][j]:
                attended[j] += 1
        out.append(sum((1 if dms else att) if att else 0
                       for dms, att in zip(dms_flags, attended)))
    return out


def gal_cost(n: int, k: int, m: int, rounds: int, dtype_bytes: int = 4,
             dms: bool = False) -> ProtocolCost:
    resid = n * k * dtype_bytes
    return ProtocolCost(
        method="GAL_DMS" if dms else "GAL",
        orgs=m,
        ensemble_members=rounds * m,
        comm_rounds=rounds,                       # orgs fit in parallel
        bytes_broadcast=rounds * (m - 1) * resid, # Alice already holds r
        bytes_gathered=rounds * m * resid,
        sequential_fits=rounds,                   # critical path: 1 fit/round
        model_memories=m if dms else rounds * m,
    )


def al_cost(n: int, k: int, m: int, rounds: int, dtype_bytes: int = 4
            ) -> ProtocolCost:
    """AL reaching the same ensemble size needs rounds*m sequential fits."""
    resid = n * k * dtype_bytes
    steps = rounds * m
    return ProtocolCost(
        method="AL",
        orgs=m,
        ensemble_members=steps,
        comm_rounds=steps,                        # strictly sequential
        bytes_broadcast=steps * resid,
        bytes_gathered=steps * resid,
        sequential_fits=steps,                    # critical path: every fit
        model_memories=steps,
    )


def complexity_table(n: int, k: int, m: int, rounds: int):
    """Reproduces paper Table 14's 1x / Mx / Tx relations, with real byte
    counts for the given problem size."""
    g = gal_cost(n, k, m, rounds)
    d = gal_cost(n, k, m, rounds, dms=True)
    a = al_cost(n, k, m, rounds)
    rows = []
    for c in (a, g, d):
        rows.append({
            "method": c.method,
            "computation_time_x": c.sequential_fits / g.sequential_fits,
            "computation_space_x": c.model_memories / d.model_memories,
            "communication_rounds_x": c.comm_rounds / g.comm_rounds,
            "bytes_total": c.bytes_total,
        })
    return rows
