"""The GAL round engine (paper Algorithm 1), from Alice's perspective.

Ported from ``src/repro/core/gal.py``, python engine. Per assistance
round t:
  1. r^t   = -dL1(y, F^{t-1})/dF          (pseudo-residual, Alice)
  2. broadcast r^t (optionally privatized: DP/IP)          -> all orgs
  3. f_m^t = argmin_{f in F_m} E_N ell_m(r^t, f(x_m))       (orgs, in turn)
  4. w-hat = argmin_{w in simplex} E_N ell_1(r^t, sum w_m f_m^t)   (Alice)
  5. eta-hat = argmin_eta E_N L1(y, F^{t-1} + eta sum w_m f_m^t)   (Alice)
  6. F^t = F^{t-1} + eta-hat * sum_m w-hat_m f_m^t

Prediction stage: F^T(x*) = F^0 + sum_t eta^t sum_m w_m^t f_m^t(x_m*).

``fit`` follows the reference's ``_fit_python`` line for line, on the
card unless the caller passes ``device="cpu"``; a K-class xent residual
at K >= 1024 goes through the ``residual_xent`` kernel there
(``core/losses.py``). The compiled engines (scan / grouped / shard), the
(org x data) mesh and resume come in later slices (ROADMAP.md).

Random draws. The reference draws from one ``jax.random`` key chain,
which torch cannot replay, so ``fit`` takes its draws from a ``draws``
object with three methods, each keyed by round and org id (never by
position) as the reference keys them from its round key:

  init_params(t, org, x, k)  an org's starting params  fold_in(k_round, id)
  theta0(t, org_ids)         {id: weight-fit start}    fold_in(fold_in(k_round, 29), id)
  privacy_u(t, shape)        the privacy uniform       fold_in(k_round, 13)

``Draws(seed)`` is the default. The parity tests pass one that replays
the reference's own chain.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.losses import Loss, lq_loss
from repro_torch.core.membership import (membership_comm_ledger,
                                         resolve_membership)
from repro_torch.core.organizations import Organization
from repro_torch.core.privacy import apply_privacy, noise_shape
from repro_torch.core.protocol_sim import gal_model_memories, gal_round_bytes
from repro_torch.core.weights import combine, fit_weights, uniform_weights
from repro_torch.metrics.metrics import get_metric
from repro_torch.optim.lbfgs import line_search
from repro_torch.utils.device import resolve_device

_ENGINES = ("auto", "scan", "shard", "grouped", "python")

# what each of a round's draws is for: one stream per (round, purpose, org)
_INIT, _THETA0, _PRIVACY = 0, 1, 2


class Draws:
    """The fit's random draws from a seed: each (round, purpose, org id)
    has its own CPU ``torch.Generator``, seeded through
    ``np.random.SeedSequence``, so a reduced org set draws what the full
    set draws for the orgs it keeps, and the card and the CPU fit from the
    same values (each draw is copied to the data's device)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _generator(self, t: int, purpose: int, org_id: int = 0
                   ) -> torch.Generator:
        state = np.random.SeedSequence(
            [self.seed, t, purpose, org_id]).generate_state(1)
        return torch.Generator().manual_seed(int(state[0]))

    def init_params(self, t: int, org: Organization, x: torch.Tensor,
                    k: int) -> Any:
        return org.model.init(self._generator(t, _INIT, org.index), x, k)

    def theta0(self, t: int, org_ids: Sequence[int]) -> Dict[int, torch.Tensor]:
        return {i: 0.01 * torch.randn((), generator=self._generator(
                    t, _THETA0, i)) for i in org_ids}

    def privacy_u(self, t: int, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._generator(t, _PRIVACY))


def _resolve_metrics(metric_fn, metrics):
    """Normalize the metric arguments into one ``{column: fn}`` map:
    ``metrics`` entries are registry names (``repro_torch.metrics.METRICS``)
    or callables (column = ``__name__``); the single ``metric_fn`` keeps its
    ``"<eval>_metric"`` column."""
    mmap: Dict[str, Callable] = {}
    if metric_fn is not None:
        mmap["metric"] = metric_fn
    for entry in (metrics or ()):
        name = entry if isinstance(entry, str) else \
            getattr(entry, "__name__", f"metric{len(mmap)}")
        # each metric owns one "<eval>_<name>" column: a duplicate would
        # clobber it, and "loss" would collide with the loss curve
        if name == "loss":
            raise ValueError(
                "metric name 'loss' collides with the fit's per-round "
                "'<eval>_loss' column; rename the callable")
        if name in mmap:
            raise ValueError(
                f"duplicate metric name {name!r}: each metric needs a "
                f"distinct history column (rename the callable or drop "
                f"the duplicate)")
        mmap[name] = get_metric(entry) if isinstance(entry, str) else entry
    return mmap or None


@dataclass(frozen=True)
class GALConfig:
    rounds: int = 10
    # assisted learning rate (paper: L-BFGS line search; eta=1 const ablation)
    eta_method: str = "lbfgs"          # lbfgs | golden | constant
    eta0: float = 1.0
    eta_stop_threshold: float = 0.0    # stop assistance when |eta| drops below
    # gradient assistance weights (paper: softmax+Adam; uniform ablation)
    use_weights: bool = True
    weight_epochs: int = 100
    weight_lr: float = 0.1
    weight_decay: float = 5e-4
    # Alice's regression loss ell_1 used in the weight objective
    alice_q: float = 2.0
    # privacy on the broadcast residual (paper Sec 4.5)
    privacy: Optional[str] = None      # None | dp | ip
    privacy_alpha: float = 1.0
    privacy_intervals: int = 1
    # wire dtype of the step-2 residual broadcast: "bf16" casts the
    # privatized residual to bfloat16 before it leaves Alice (halving the
    # ledgered comm_broadcast_bytes) and upcasts after
    residual_dtype: str = "float32"    # float32 | bf16
    # rows of each org sharded over a "data" mesh axis: the shard engine's,
    # not ported yet (only 1)
    data_shards: int = 1
    # dynamic-membership fault injection (core/membership.py): each org
    # independently skips each round with probability straggler_sim, from a
    # schedule seeded by straggler_seed; composes (AND) with an explicit
    # fit(membership=...) schedule
    straggler_sim: Optional[float] = None
    straggler_seed: int = 0
    # the port runs the python engine; the compiled ones are not ported yet
    engine: str = "python"             # auto / scan / shard / grouped raise


@dataclass
class GALResult:
    orgs: List[Organization]
    loss: Loss
    f0: torch.Tensor                   # (1, K)
    etas: List[float] = field(default_factory=list)
    weights: List[torch.Tensor] = field(default_factory=list)
    history: Dict[str, List[float]] = field(default_factory=dict)
    engine: str = "python"
    config: Optional[GALConfig] = None
    # one row of per-org attendance bools per executed round (org order),
    # or None when every org attended every round and no schedule was given
    membership: Optional[List[List[bool]]] = None

    @property
    def rounds(self) -> int:
        return len(self.etas)

    @torch.no_grad()
    def predict(self, xs: Sequence[torch.Tensor],
                rounds: Optional[int] = None) -> torch.Tensor:
        """Prediction stage for new data ``xs[m]`` (moved to the fit's
        device), assembled round by round and org by org as the fit
        assembled it (the reference's ``predict_legacy``).

        Reads live Organization state: a later ``fit`` on the same org
        objects resets it and invalidates this result — fit fresh orgs to
        keep old results."""
        t_max = self.rounds if rounds is None else min(rounds, self.rounds)
        dev = self.f0.device
        xs = [x.to(dev) for x in xs]
        f = self.f0.expand(xs[0].shape[0], self.f0.shape[-1])
        for t in range(t_max):
            preds = [org.predict_round(t, xs[m])
                     for m, org in enumerate(self.orgs)]
            f = f + self.etas[t] * combine(self.weights[t], preds)
        return f


def _resid_wire_bytes(config) -> int:
    """Per-element width of the residual broadcast on the wire (step 2):
    2 under ``GALConfig(residual_dtype="bf16")``, 4 otherwise."""
    return 2 if getattr(config, "residual_dtype", "float32") in (
        "bf16", "bfloat16") else 4


@torch.no_grad()
def fit(orgs: List[Organization], y: torch.Tensor, loss: Loss,
        config: GALConfig = GALConfig(),
        eval_sets: Optional[Dict[str, tuple]] = None,
        metric_fn: Optional[Callable] = None,
        metrics: Optional[Sequence] = None,
        membership: Any = None,
        draws: Optional[Draws] = None,
        device=None,
        resume_from: Any = None) -> GALResult:
    """Run ``config.rounds`` assistance rounds on ``device`` (the card
    unless ``device="cpu"``; the orgs' slices, ``y`` and the eval sets are
    moved there). ``eval_sets`` maps name -> (xs_list, y) and is evaluated
    with the prediction-stage mechanics each round, giving the per-round
    curves of Fig. 4: ``history["<eval>_loss"]`` and, for each entry of
    ``metrics`` (``repro_torch.metrics.METRICS`` names or callables),
    ``history["<eval>_<metric>"]``; ``metric_fn`` fills
    ``history["<eval>_metric"]``.

    ``membership`` is an optional (rounds, M) boolean attendance schedule
    (``core/membership.py``): orgs absent from round t still fit, but take
    an exact-zero assistance weight and drop out of the round's
    communication and model-memory ledgers. ``config.straggler_sim``
    composes a seeded dropout schedule on top (logical AND).

    ``draws`` gives the random draws (module docstring); ``Draws(0)`` when
    None."""
    if config.engine not in _ENGINES:
        raise ValueError(f"unknown engine {config.engine!r}")
    if config.engine != "python":
        raise NotImplementedError(
            f"engine={config.engine!r}: the compiled tabular engines are not "
            f"ported yet (the port runs engine='python'); see ROADMAP.md")
    if resume_from is not None:
        raise NotImplementedError(
            "resume_from= is not ported yet (artifacts and resume come in a "
            "later slice); see ROADMAP.md")
    if config.residual_dtype not in ("float32", "fp32", "bf16", "bfloat16"):
        raise ValueError(
            f"unknown residual_dtype {config.residual_dtype!r}: "
            "expected 'float32' or 'bf16'")
    if config.data_shards < 1:
        raise ValueError(f"data_shards must be >= 1, got "
                         f"{config.data_shards}")
    if config.data_shards > 1:
        raise NotImplementedError(
            f"data_shards={config.data_shards} needs the org-sharded engine, "
            f"which is not ported yet; see ROADMAP.md")
    dev = resolve_device(device)
    for org in orgs:
        org.reset_round_state()  # a refit must not read stale round params
        org.x_train = org.x_train.to(dev)
    y = y.to(dev)
    if eval_sets:
        eval_sets = {name: ([x.to(dev) for x in xs_e], y_e.to(dev))
                     for name, (xs_e, y_e) in eval_sets.items()}
    metric_map = _resolve_metrics(metric_fn, metrics)
    sched = resolve_membership(membership, config.straggler_sim,
                               config.straggler_seed, config.rounds,
                               len(orgs))
    return _fit_python(orgs, y, loss, config, eval_sets, metric_map,
                       draws if draws is not None else Draws(),
                       membership=sched)


def _fit_python(orgs, y, loss, config, eval_sets, metrics, draws,
                membership=None) -> GALResult:
    """The reference's interpreter-order loop. Losses, metrics and etas
    stay on the device and are fetched once at the end (and each round
    only under ``eta_stop_threshold``).

    ``membership`` is the resolved bool (rounds, M) schedule or None: an
    absent org still runs its local fit each round (its params stay
    round-aligned) but its round is dead — exact-zero assistance weight,
    no ledger bytes."""
    n = y.shape[0]
    k = y.shape[-1]
    dev = y.device
    f0 = loss.init_prediction(y)
    f_train = f0.expand(n, k)
    alice_loss = lq_loss(config.alice_q)
    org_ids = [org.index for org in orgs]

    result = GALResult(orgs=orgs, loss=loss, f0=f0, config=config)
    curves: Dict[str, List[torch.Tensor]] = {"train_loss": [loss(y, f_train)]}
    f_evals = {}
    for name, (xs_e, y_e) in (eval_sets or {}).items():
        f_evals[name] = f0.expand(y_e.shape[0], k)
        curves[f"{name}_loss"] = [loss(y_e, f_evals[name])]
        for mname, metric_fn in (metrics or {}).items():
            curves[f"{name}_{mname}"] = [metric_fn(y_e, f_evals[name])]
    # simulated per-round communication + model-memory ledgers (Table-14
    # convention), appended per executed round so early stopping trims them
    eval_ns = [int(y_e.shape[0]) for (_, y_e) in (eval_sets or {}).values()]
    rb = _resid_wire_bytes(config)
    if membership is None:
        bcast_b, gather_b = gal_round_bytes(n, k, len(orgs), eval_ns,
                                            resid_dtype_bytes=rb)
    else:
        bcast_l, gather_l = membership_comm_ledger(membership, n, k, eval_ns,
                                                   resid_dtype_bytes=rb)
    memories = gal_model_memories(config.rounds, [org.dms for org in orgs],
                                  membership=membership)
    ledger: Dict[str, List[int]] = {"comm_broadcast_bytes": [],
                                    "comm_gather_bytes": [],
                                    "model_memories": []}
    etas: List[torch.Tensor] = []
    shape = noise_shape(config.privacy, (n, k), config.privacy_intervals)

    for t in range(config.rounds):
        row = None if membership is None else membership[t]
        # 1. pseudo-residual
        residual = loss.residual(y, f_train)
        # 2. broadcast (privatized if configured); under
        # residual_dtype="bf16" the wire carries bfloat16, so round-trip
        # the cast
        u = None if shape is None else draws.privacy_u(t, shape).to(dev)
        r_bcast = apply_privacy(residual, config.privacy, u,
                                alpha=config.privacy_alpha,
                                n_intervals=config.privacy_intervals)
        if rb == 2:
            r_bcast = r_bcast.to(torch.bfloat16).to(residual.dtype)
        # 3. local fits, in org order
        preds = torch.stack([
            org.fit_round(draws.init_params(t, org, org.x_train, k), r_bcast,
                          live=bool(row[m]) if row is not None else True)
            for m, org in enumerate(orgs)
        ])                                                    # (M, N, K)
        # 4. gradient assistance weights (masked over this round's live orgs)
        mask = None if row is None else torch.as_tensor(row, device=dev)
        if config.use_weights and len(orgs) > 1:
            w = fit_weights(
                residual, preds, alice_loss, epochs=config.weight_epochs,
                lr=config.weight_lr, weight_decay=config.weight_decay,
                mask=mask, theta0=draws.theta0(t, org_ids), org_ids=org_ids)
        else:
            w = uniform_weights(len(orgs), mask=mask, device=dev)
        direction = combine(w, preds)
        del preds
        # 5. line-search the gradient assisted learning rate
        eta = line_search(lambda e: loss(y, f_train + e * direction),
                          method=config.eta_method, x0=config.eta0,
                          device=dev)
        # 6. update the ensemble
        f_train = f_train + eta * direction
        etas.append(eta)
        result.weights.append(w)
        curves["train_loss"].append(loss(y, f_train))
        ledger["comm_broadcast_bytes"].append(
            bcast_b if membership is None else bcast_l[t])
        ledger["comm_gather_bytes"].append(
            gather_b if membership is None else gather_l[t])
        ledger["model_memories"].append(memories[t])
        for name, (xs_e, y_e) in (eval_sets or {}).items():
            preds_e = [org.predict_round(t, xs_e[m])
                       for m, org in enumerate(orgs)]
            f_evals[name] = f_evals[name] + eta * combine(w, preds_e)
            curves[f"{name}_loss"].append(loss(y_e, f_evals[name]))
            for mname, metric_fn in (metrics or {}).items():
                curves[f"{name}_{mname}"].append(
                    metric_fn(y_e, f_evals[name]))
        if (config.eta_stop_threshold > 0.0
                and abs(float(eta)) < config.eta_stop_threshold):
            break
    result.etas = [float(e) for e in torch.stack(etas).tolist()]
    for col, vals in curves.items():
        result.history[col] = [float(v) for v in torch.stack(vals).tolist()]
    result.history.update(ledger)
    if membership is not None:
        result.membership = np.asarray(
            membership[:len(result.etas)], bool).tolist()
    return result
