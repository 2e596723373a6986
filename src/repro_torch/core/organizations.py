"""Organization abstraction (paper Sec. 3.1-3.2).

Ported from ``src/repro/core/organizations.py``. An Organization privately
owns a vertical feature slice x_m, a model class F_m (any zoo model) and a
local regression loss ell_m used to fit the broadcast pseudo-residuals.
The GAL fit reads nothing of it but the fitted values f_m^t(x_m) —
matching the paper's "no sharing of data, models, objective functions"
contract.

Fresh-fit orgs only: Deep Model Sharing (``dms=True``) and noisy org
outputs (``noise_sigma > 0``, paper Table 6) are not ported yet and raise
(ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List

import torch

from repro_torch.core.losses import lq_loss


@dataclass
class Organization:
    index: int
    x_train: Any                       # private vertical slice (N, d_m)
    model: Any                         # zoo model (duck-typed)
    local_loss: Callable = field(default_factory=lambda: lq_loss(2.0))
    noise_sigma: float = 0.0           # noisy org outputs (Table 6)
    dms: bool = False                  # Deep Model Sharing
    # --- private state (never read by the fit) ---
    _round_params: List[Any] = field(default_factory=list)

    def __post_init__(self):
        if self.dms:
            raise NotImplementedError(
                "Deep Model Sharing (dms=True) is not ported yet; see "
                "ROADMAP.md")
        if self.noise_sigma > 0.0:
            raise NotImplementedError(
                "noisy organizations (noise_sigma > 0, paper Table 6) are "
                "not ported yet; see ROADMAP.md")

    # ------------------------------------------------------------------ fit
    def reset_round_state(self) -> None:
        """Clear the per-round fit state so this Organization can be fit
        again from scratch. ``gal.fit`` calls this first: without it a
        second fit would append to ``_round_params``, and
        ``predict_round(t, ...)`` would read round t of the first fit.
        So a refit invalidates earlier results built on the same
        Organization objects: their ``predict`` reads this live state."""
        self._round_params = []

    def fit_round(self, params0: Any, residual: torch.Tensor,
                  live: bool = True) -> torch.Tensor:
        """Fit this round's local model to the broadcast pseudo-residual,
        starting from ``params0`` where the model draws its start, and
        return the fitted values f_m^t(x_m) on the training set.

        ``live`` is this org's membership bit for the round
        (``core.membership``): the caller still calls ``fit_round`` every
        round so the params list stays round-aligned, but an absent round
        is dead downstream — the fit pins its assistance weight to exactly
        0.0, so the values returned here never reach the ensemble. A
        fresh-fit org fits either way; the Deep Model Sharing path (ROADMAP.md
        A, item 4) is the one that reads ``live``."""
        del live
        params = self.model.fit(params0, self.x_train, residual,
                                self.local_loss)
        self._round_params.append(params)
        return self.model.apply(params, self.x_train)

    # ------------------------------------------------------------- predict
    def predict_round(self, t: int, x: torch.Tensor) -> torch.Tensor:
        """Prediction-stage output f_m^t(x_m*) for round t (0-based)."""
        return self.model.apply(self._round_params[t], x)

    @property
    def n_rounds_fit(self) -> int:
        return len(self._round_params)


def make_orgs(xs, model_factory, local_losses=None, dms=False,
              noise_sigmas=None) -> List[Organization]:
    """Build M organizations from vertical slices ``xs`` (list of tensors).

    ``model_factory`` is either one zoo model (shared class, private
    params) or a list of per-org models — the paper's model-autonomy
    setting (GB-SVM mix). ``dms`` and ``noise_sigmas`` are taken as the
    reference takes them, and raise when set (not ported yet).
    """
    m = len(xs)
    models = model_factory if isinstance(model_factory, (list, tuple)) \
        else [model_factory] * m
    losses = local_losses if local_losses is not None else [lq_loss(2.0)] * m
    if callable(losses):
        losses = [losses] * m
    sigmas = noise_sigmas if noise_sigmas is not None else [0.0] * m
    dms_flags = list(dms) if isinstance(dms, (list, tuple)) else [dms] * m
    return [
        Organization(index=i, x_train=xs[i], model=models[i],
                     local_loss=losses[i], dms=bool(dms_flags[i]),
                     noise_sigma=sigmas[i])
        for i in range(m)
    ]
