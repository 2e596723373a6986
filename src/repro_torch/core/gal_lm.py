"""GAL at LM scale: the paper's protocol with assigned-architecture orgs.

Ported from ``src/repro/core/gal_lm.py``, python engine. Alice holds
next-token labels; each organization holds a private *view* of the token
stream and a private sequence model. Per round:

  1. Alice computes the pseudo-residual r = onehot(y) - softmax(F) in logit
     space with the ``residual_xent`` kernel (CUDA C++ on the card).
  2. r is broadcast (dense, paper-faithful).
  3. Each org runs ``local_steps`` AdamW steps of its architecture on the
     residual-fit objective.
  4. Alice fits assistance weights on the simplex and line-searches eta.
  5. F <- F + eta * sum_m w_m f_m.

``fit_lm`` follows the reference's python loop line for line; history is
kept on the device and fetched once at the end, and per-round param
snapshots let ``GALLMResult.predict(rounds=t)`` replay any round prefix.
The compiled engines (scan / grouped), top-K transport and resume come in
later slices (ROADMAP.md).

The reference seeds the weight fit's start from ``jax.random``; the port
cannot replay those draws, so ``fit_lm`` takes them as ``theta0s`` (one
(M,) start per round) and draws from ``generator`` when none are given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.losses import CrossEntropyLoss
from repro_torch.core.plan import ExecutionPlan, plan_lm_orgs
from repro_torch.core.weights import combine, fit_weights, uniform_weights
from repro_torch.kernels.ops import residual_xent
from repro_torch.models import transformer as tfm
from repro_torch.optim.lbfgs import line_search
from repro_torch.train.steps import make_train_step, run_local_steps
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map

# the step-4 weight fit budget at LM scale: the (M, B*S, V) pred stack is
# the dominant operand, so fewer Adam epochs than the tabular default
WEIGHT_EPOCHS = 60

_ENGINES = ("auto", "scan", "grouped", "python")


def compute_residual(labels: torch.Tensor, ensemble_logits: torch.Tensor,
                     use_kernel: bool = True) -> torch.Tensor:
    """r = onehot(labels) - softmax(F): (B, S) x (B, S, V) -> (B, S, V)."""
    return residual_xent(ensemble_logits, labels, use_kernel=use_kernel)


@dataclass
class LMOrganization:
    """One org: private token view + private architecture."""
    index: int
    cfg: ModelConfig
    view_fn: Callable[[torch.Tensor], torch.Tensor]   # tokens -> private view
    params: Any = None
    opt_state: Any = None
    lr: Optional[float] = None
    _train_step: Any = None

    def init(self, generator: torch.Generator, lr: float = 1e-3,
             device=None):
        """Draw fresh params from ``generator`` onto ``device`` (the card
        unless ``device="cpu"``). To start from given params (e.g. the
        reference's, through ``repro_torch.convert.params_from_jax``),
        assign ``params`` afterwards: the AdamW state is zeros either way."""
        self.params = tfm.init_params(generator, self.cfg,
                                      resolve_device(device))
        self.lr = lr
        self._train_step, opt = make_train_step(
            self.cfg, "gal_residual", lr=lr, weight_decay=0.0)
        self.opt_state = opt.init(self.params)

    def fit_round(self, tokens: torch.Tensor, residual: torch.Tensor,
                  local_steps: int = 10) -> torch.Tensor:
        """Fit the broadcast residual; return f_m(x_m) on the batch (f32)."""
        view = self.view_fn(tokens)
        batch = {"tokens": view, "residual": residual}
        self.params, self.opt_state, _ = run_local_steps(
            self._train_step, self.params, self.opt_state, batch, local_steps)
        return self.predict(tokens)

    @torch.no_grad()
    def predict(self, tokens: torch.Tensor) -> torch.Tensor:
        logits, _ = tfm.apply(self.params, self.cfg, self.view_fn(tokens))
        return logits.float()


@dataclass
class GALLMResult:
    """A fitted LM collaboration: etas, weights, history, the plan and the
    per-round post-fit params per group (``predict(rounds=t)`` replays any
    prefix)."""
    orgs: List[LMOrganization]
    f0: torch.Tensor
    etas: List[float] = field(default_factory=list)
    weights: List[torch.Tensor] = field(default_factory=list)
    history: Dict[str, List[float]] = field(default_factory=dict)
    engine: str = "python"
    plan: Optional[ExecutionPlan] = None
    # per group: post-fit round params stacked (T, Mg, ...)
    group_params: Optional[List[Any]] = None
    fit_spec: Optional[Dict[str, Any]] = None

    @property
    def rounds(self) -> int:
        return len(self.etas)

    @property
    def vocab(self) -> int:
        return int(self.f0.shape[-1])

    @torch.no_grad()
    def predict(self, tokens: torch.Tensor,
                rounds: Optional[int] = None) -> torch.Tensor:
        """The Prediction Stage at round prefix ``t``:
        F_t = F_0 + sum_{tau<t} eta_tau sum_m w_m,tau f_m,tau(x_m).

        ``tokens`` (B, S) route through the orgs' private ``view_fn``s.
        The sum is taken round by round, as the fit took it. Returns
        (B, S, V) f32 ensemble logits. (The reference's ``views=`` entry,
        for loaded artifacts without orgs, comes with artifacts.)"""
        t = self.rounds if rounds is None else int(rounds)
        if not 0 <= t <= self.rounds:
            raise ValueError(f"rounds={t} outside the fitted range "
                             f"[0, {self.rounds}]")
        views = [org.view_fn(tokens) for org in self.orgs]
        b, s = tokens.shape
        v = self.vocab
        f = self.f0.reshape(1, v).expand(b * s, v).float().clone()
        if t == 0:
            return f.reshape(b, s, v)
        slot = {i: (gi, j) for gi, g in enumerate(self.plan.groups)
                for j, i in enumerate(g.indices)}
        m = self.plan.n_orgs
        for tau in range(t):
            preds = []
            for i in range(m):
                gi, j = slot[i]
                cfg = self.plan.groups[gi].model
                p = tree_map(lambda l, tau=tau, j=j: l[tau, j],
                             self.group_params[gi])
                logits, _ = tfm.apply(p, cfg, views[i])
                preds.append(logits.float().reshape(b * s, v))
            direction = combine(self.weights[tau], preds)
            f = f + self.etas[tau] * direction
        return f.reshape(b, s, v)


def _l2(r, f):
    return torch.mean(torch.square(r - f))


def _make_fit_spec(orgs, labels, local_steps, eta_method, use_weights,
                   use_kernel, eta_stop_threshold) -> Dict[str, Any]:
    return {
        "local_steps": int(local_steps), "eta_method": str(eta_method),
        "use_weights": bool(use_weights), "use_kernel": bool(use_kernel),
        "eta_stop_threshold": float(eta_stop_threshold),
        "lrs": [float(org.lr) for org in orgs],
        "batch": int(labels.shape[0]), "seq": int(labels.shape[1]),
        "vocab": int(orgs[0].cfg.vocab),
    }


@torch.no_grad()
def fit_lm(orgs: List[LMOrganization], tokens: torch.Tensor,
           labels: torch.Tensor, rounds: int = 4, local_steps: int = 10,
           eta_method: str = "lbfgs", use_weights: bool = True,
           use_kernel: bool = True, engine: str = "python",
           eta_stop_threshold: float = 0.0, resume_from: Any = None,
           theta0s: Optional[Sequence[Any]] = None,
           generator: Optional[torch.Generator] = None) -> GALLMResult:
    """Run GAL assistance rounds on an LM task (one device).

    tokens/labels: (B, S) integer tensors on the orgs' device. The
    overarching loss L1 is next-token xent; orgs fit logit-space residuals
    with ell_2 (paper Table 9 defaults). ``use_kernel`` routes step 1
    through the ``residual_xent`` kernel on the card (the CPU always takes
    its plain version); ``use_kernel=False`` asks for the plain version.
    ``eta_stop_threshold`` stops assistance once |eta| drops below it.
    ``theta0s[t]`` is round t's (M,) weight-fit start; without it each
    round draws 0.01 * N(0, 1) from ``generator``.
    """
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r} (one of {_ENGINES})")
    if engine != "python":
        raise NotImplementedError(
            f"engine={engine!r}: the compiled LM engines are not ported yet "
            f"(the port runs engine='python'); see ROADMAP.md")
    if resume_from is not None:
        raise NotImplementedError(
            "resume_from= is not ported yet (artifacts and resume come in a "
            "later slice); see ROADMAP.md")
    plan = plan_lm_orgs(orgs)
    if not plan.compiled:
        raise ValueError(f"cannot fit this org set: {plan.reason}")
    vocabs = {int(org.cfg.vocab) for org in orgs}
    if len(vocabs) != 1:
        raise ValueError(
            f"all organizations must share Alice's vocab (the residual "
            f"broadcast is one (B, S, V) tensor); got vocabs "
            f"{sorted(vocabs)}")
    spec = _make_fit_spec(orgs, labels, local_steps, eta_method,
                          use_weights, use_kernel, eta_stop_threshold)
    b, s = labels.shape
    vocab = spec["vocab"]
    device = labels.device
    xent = CrossEntropyLoss()
    flat_labels = labels.reshape(-1, 1).to(torch.int64)
    y1 = (flat_labels == torch.arange(vocab, device=device)).float()
    f0 = xent.init_prediction(y1)
    f = f0.reshape(1, vocab).expand(b * s, vocab).float().clone()
    thr = spec["eta_stop_threshold"]
    result = GALLMResult(orgs=orgs, f0=f0, engine="python", plan=plan,
                         fit_spec=spec)
    etas_d, ws, xents = [], [], [xent(y1, f)]
    param_snaps: List[List[Any]] = []             # per round: per-org params

    for t in range(rounds):
        residual = compute_residual(
            labels, f.reshape(b, s, vocab), use_kernel=spec["use_kernel"])
        preds = torch.stack([
            org.fit_round(tokens, residual,
                          local_steps=spec["local_steps"]
                          ).reshape(b * s, vocab)
            for org in orgs])                          # (M, B*S, V)
        if spec["use_weights"] and len(orgs) > 1:
            w = fit_weights(residual.reshape(b * s, vocab), preds, _l2,
                            epochs=WEIGHT_EPOCHS,
                            theta0=None if theta0s is None else theta0s[t],
                            generator=generator)
        else:
            w = uniform_weights(len(orgs), device=device)
        direction = combine(w, preds)
        del preds                 # (M, B*S, V) f32: free it for the search
        eta = line_search(lambda e: xent(y1, f + e * direction),
                          method=spec["eta_method"], x0=1.0, device=device)
        f = f + eta * direction
        etas_d.append(eta)
        ws.append(w)
        xents.append(xent(y1, f))
        param_snaps.append([org.params for org in orgs])
        if thr > 0.0 and abs(float(eta)) < thr:
            break

    etas_h = torch.stack(etas_d).tolist() if etas_d else []
    result.etas = [float(e) for e in etas_h]
    result.weights = ws
    result.history["train_xent"] = [float(x) for x in
                                    torch.stack(xents).tolist()]
    # the compiled engines' (T, Mg, ...) group layout, so the prediction
    # stage is one code path for every engine
    n_snap = len(param_snaps)
    result.group_params = [
        tree_map(lambda *leaves, g=g: torch.stack(leaves).reshape(
                     n_snap, g.size, *leaves[0].shape),
                 *[snap[i] for snap in param_snaps for i in g.indices])
        for g in plan.groups
    ] if param_snaps else [None] * plan.n_groups
    return result
