"""Org execution planner, the part the LM-scale fit uses.

Copied from ``src/repro/core/plan.py`` (pure Python): ``OrgGroup``,
``ExecutionPlan`` and ``plan_lm_orgs``, which partitions LM organizations
into groups keyed by (architecture config, local lr). The python engine
uses the plan for the (T, Mg, ...) per-round param layout that
``GALLMResult.predict`` replays; the compiled engines that run one group
per vmap, and the tabular planner ``plan_orgs``, come in later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class OrgGroup:
    """One homogeneous slice of the org list: same model config, same local
    loss, same noise sigma, same DMS flag, stackable inputs. ``indices``
    are positions in the fitted org list (the engine's concat/permutation
    coordinates); ``org_ids`` are the organizations' ``index`` values."""
    indices: Tuple[int, ...]
    org_ids: Tuple[int, ...]
    model: Any
    local_loss: Any
    noise_sigma: float = 0.0
    dms: bool = False

    @property
    def size(self) -> int:
        return len(self.indices)

    def describe(self) -> str:
        q = getattr(self.local_loss, "q", None)
        bits = [f"{type(self.model).__name__} x{self.size}"]
        if self.dms:
            bits.append("DMS")
        if q is not None:
            bits.append(f"q={float(q):g}")
        elif self.local_loss is not None:
            bits.append(
                f"loss={getattr(self.local_loss, '__name__', 'custom')}")
        if self.noise_sigma:
            bits.append(f"sigma={float(self.noise_sigma):g}")
        return " ".join(bits)


@dataclass(frozen=True)
class ExecutionPlan:
    """The planner's verdict: the group partition plus, when the compiled
    engines cannot run it, the human-readable reason why."""
    groups: Tuple[OrgGroup, ...]
    reason: Optional[str] = None
    notes: Tuple[str, ...] = ()

    @property
    def compiled(self) -> bool:
        return self.reason is None

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def n_orgs(self) -> int:
        return sum(g.size for g in self.groups)

    @property
    def noisy(self) -> bool:
        return any(g.noise_sigma > 0.0 for g in self.groups)

    @property
    def has_dms(self) -> bool:
        return any(g.dms for g in self.groups)

    @property
    def homogeneous(self) -> bool:
        return self.n_groups == 1 and not self.noisy and not self.has_dms

    @property
    def permutation(self) -> Tuple[int, ...]:
        """Org positions in group-concatenation order."""
        return tuple(i for g in self.groups for i in g.indices)

    @property
    def inverse_permutation(self) -> Tuple[int, ...]:
        """Maps group-concatenated rows back to original org order."""
        perm = self.permutation
        inv = [0] * len(perm)
        for pos, i in enumerate(perm):
            inv[i] = pos
        return tuple(inv)

    def describe(self) -> str:
        head = f"{self.n_groups} group{'s' if self.n_groups != 1 else ''}: "
        body = " | ".join(g.describe() for g in self.groups)
        tail = f"  [fallback: {self.reason}]" if self.reason else ""
        return head + "[" + body + "]" + tail


def plan_lm_orgs(orgs: Sequence[Any]) -> ExecutionPlan:
    """The grouping for LM-scale organizations (``core.gal_lm``): groups
    keyed by (architecture config, local lr). ``fit_lm`` raises on
    non-compiled plans (uninitialized orgs) and on vocab mismatches."""
    if not orgs:
        return ExecutionPlan((), reason="no organizations to plan")
    reason = None
    for org in orgs:
        if org.params is None or org._train_step is None:
            reason = (f"LM organization {org.index} is not initialized "
                      f"(call .init() first)")
            break
    keys: List[tuple] = []
    members: List[List[int]] = []
    for i, org in enumerate(orgs):
        k = (org.cfg, org.lr)
        for gi, existing in enumerate(keys):
            if existing == k:
                members[gi].append(i)
                break
        else:
            keys.append(k)
            members.append([i])
    groups = tuple(
        OrgGroup(indices=tuple(idx),
                 org_ids=tuple(int(orgs[i].index) for i in idx),
                 model=orgs[idx[0]].cfg, local_loss=None)
        for idx in members
    )
    return ExecutionPlan(groups=groups, reason=reason)
