"""Local model zoo for GAL organizations (paper Sec. 4.1 "model autonomy").

Ported from ``src/repro/models/zoo.py``. Each organization may privately
choose any model class F_m:

  * Linear       — closed-form ridge (ell_2) or Adam fit (other ell_q)
  * MLP          — feature extractor + head
  * StumpBoost   — gradient-boosted decision stumps (the paper's "GB")
  * KernelRidge  — RBF kernel machine (stand-in for the paper's "SVM")

Interface (duck-typed, see ``core/organizations.py``):
  init(generator, x_example, k_out) -> params   (drawn from generator,
                                                 placed on x_example's device)
  fit(params0, x, r, local_loss)    -> params   (fresh fit to pseudo-residuals)
  apply(params, x)                  -> (N, K)

The reference's ``fit`` takes a ``jax.random`` key and draws its starting
params itself; the port cannot replay those draws, so ``fit`` takes the
starting params ``params0`` (from ``init`` or from the caller). Only
Linear's Adam path (ell_q with q != 2) and MLP start from them.
ConvNet and GRUNet come with the image and series slices (ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.utils.pytree import tree_leaves, tree_unflatten
from repro_torch.utils.registry import Registry

ZOO: Registry = Registry("local model")


def _fit_adam(params, loss_of_params, epochs: int, lr: float):
    """``epochs`` full-batch Adam steps on ``loss_of_params`` from
    ``params``."""
    opt = adam(lr)
    state = opt.init(params)
    for _ in range(epochs):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            grads = torch.autograd.grad(
                loss_of_params(tree_unflatten(params, leaves)), leaves)
        upd, state = opt.update(tree_unflatten(params, list(grads)), state,
                                params)
        params = apply_updates(params, upd)
    return params


def _dense_init(generator, d_in, d_out, device):
    """N(0, 1/d_in) weights drawn from ``generator`` on its own device,
    then placed on ``device``; zero bias."""
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device) / math.sqrt(d_in)
    return {"w": w.to(device),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=device)}


def _dense(params, x):
    return x @ params["w"] + params["b"]


@ZOO.register("linear")
@dataclass(frozen=True)
class Linear:
    ridge: float = 1e-3
    epochs: int = 100          # used only for non-ell_2 local losses
    lr: float = 1e-2

    def init(self, generator, x_example, k_out):
        return _dense_init(generator, x_example.shape[-1], k_out,
                           x_example.device)

    def apply(self, params, x):
        return _dense(params, x)

    def fit(self, params0, x, r, local_loss):
        # the closed ridge form is only the ell_2 solution; a custom loss
        # without a q exponent takes the generic Adam path
        q = getattr(local_loss, "q", None)
        if q == 2.0:
            n, d = x.shape
            xb = torch.cat([x, torch.ones((n, 1), dtype=x.dtype,
                                          device=x.device)], dim=1)
            gram = xb.T @ xb
            rhs = xb.T @ r
            eye = torch.eye(d + 1, dtype=x.dtype, device=x.device)
            sol = torch.linalg.solve(gram + self.ridge * eye, rhs)
            return {"w": sol[:-1], "b": sol[-1]}
        return _fit_adam(params0, lambda p: local_loss(r, _dense(p, x)),
                         self.epochs, self.lr)


@ZOO.register("mlp")
@dataclass(frozen=True)
class MLP:
    hidden: Sequence[int] = (64, 64)
    epochs: int = 200
    lr: float = 1e-2

    def feature_dim(self, x_example):
        return self.hidden[-1]

    def init(self, generator, x_example, k_out):
        dims = [x_example.shape[-1], *self.hidden]
        dev = x_example.device
        layers = [_dense_init(generator, dims[i], dims[i + 1], dev)
                  for i in range(len(dims) - 1)]
        head = _dense_init(generator, dims[-1], k_out, dev)
        return {"layers": layers, "head": head}

    def features(self, params, x):
        h = x
        for lyr in params["layers"]:
            h = torch.relu(_dense(lyr, h))
        return h

    def init_head(self, generator, k_out):
        return _dense_init(generator, self.hidden[-1], k_out,
                           generator.device)

    def apply_head(self, head, h):
        return _dense(head, h)

    def apply(self, params, x):
        return _dense(params["head"], self.features(params, x))

    def fit(self, params0, x, r, local_loss):
        return _fit_adam(params0, lambda p: local_loss(r, self.apply(p, x)),
                         self.epochs, self.lr)


@ZOO.register("stump_boost")
@dataclass(frozen=True)
class StumpBoost:
    """Gradient-boosted decision stumps — the paper's "GB" local model.

    Greedy stump selection over a per-feature quantile grid of candidate
    thresholds; each stump fits the current residual-of-residual with
    per-leaf means, shrunk by ``shrinkage``.
    """
    n_stumps: int = 50
    n_thresholds: int = 16
    shrinkage: float = 0.3

    def init(self, generator, x_example, k_out):
        d = x_example.shape[-1]
        dev = x_example.device
        t = self.n_thresholds
        return {
            "thresholds": torch.zeros((d, t), device=dev),
            "feat": torch.zeros((self.n_stumps,), dtype=torch.int64,
                                device=dev),
            "thr": torch.zeros((self.n_stumps,), device=dev),
            "left": torch.zeros((self.n_stumps, k_out), device=dev),
            "right": torch.zeros((self.n_stumps, k_out), device=dev),
            "base": torch.zeros((k_out,), device=dev),
        }

    def fit(self, params0, x, r, local_loss):
        del params0, local_loss  # stumps always fit ell_2 (classic GB)
        n, d = x.shape
        qs = torch.linspace(0.05, 0.95, self.n_thresholds,
                            dtype=torch.float32, device=x.device)
        thresholds = torch.quantile(x, qs, dim=0).T            # (d, T)
        base = torch.mean(r, dim=0)
        resid = r - base

        masks_f = (x[:, :, None] <= thresholds[None, :, :]).float()
        n_left = torch.sum(masks_f, dim=0)                     # (d, T)
        n_right = n - n_left
        feats, thrs, lefts, rights = [], [], [], []
        for _ in range(self.n_stumps):
            sum_left = torch.einsum("ndt,nk->dtk", masks_f, resid)
            sum_all = torch.sum(resid, dim=0)                  # (k,)
            sum_right = sum_all[None, None, :] - sum_left
            mean_l = sum_left / torch.clamp_min(n_left, 1.0)[..., None]
            mean_r = sum_right / torch.clamp_min(n_right, 1.0)[..., None]
            # SSE reduction = sum_l . mean_l + sum_r . mean_r (up to const)
            gain = (torch.sum(sum_left * mean_l, dim=-1)
                    + torch.sum(sum_right * mean_r, dim=-1))   # (d, T)
            idx = torch.argmax(gain)
            fi = idx // self.n_thresholds
            ti = idx % self.n_thresholds
            thr = thresholds[fi, ti]
            lval = self.shrinkage * mean_l[fi, ti]
            rval = self.shrinkage * mean_r[fi, ti]
            go_left = (torch.index_select(x, 1, fi.reshape(1)) <= thr)
            resid = resid - torch.where(go_left, lval[None, :],
                                        rval[None, :])
            feats.append(fi)
            thrs.append(thr)
            lefts.append(lval)
            rights.append(rval)
        return {"thresholds": thresholds, "feat": torch.stack(feats),
                "thr": torch.stack(thrs), "left": torch.stack(lefts),
                "right": torch.stack(rights), "base": base}

    def apply(self, params, x):
        out = params["base"].expand(x.shape[0], -1)
        cols = x[:, params["feat"]]                            # (N, S)
        go_left = (cols <= params["thr"])[:, :, None]
        for s in range(params["feat"].shape[0]):
            out = out + torch.where(go_left[:, s], params["left"][s],
                                    params["right"][s])
        return out


@ZOO.register("kernel_ridge")
@dataclass(frozen=True)
class KernelRidge:
    """RBF kernel ridge regression (the paper's "SVM" autonomy stand-in)."""
    gamma: float = 0.5
    reg: float = 1e-2

    def init(self, generator, x_example, k_out):
        dev = x_example.device
        return {"x_train": torch.zeros((1, x_example.shape[-1]), device=dev),
                "alpha": torch.zeros((1, k_out), device=dev)}

    def _kernel(self, a, b):
        sq = (torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
              - 2.0 * a @ b.T)
        return torch.exp(-self.gamma * torch.clamp_min(sq, 0.0))

    def fit(self, params0, x, r, local_loss):
        del params0, local_loss
        k = self._kernel(x, x)
        k.diagonal().add_(self.reg)
        alpha = torch.linalg.solve(k, r)
        return {"x_train": x, "alpha": alpha}

    def apply(self, params, x):
        return self._kernel(x, params["x_train"]) @ params["alpha"]


def get_local_model(name: str, **kwargs):
    if name in ("convnet", "grunet"):
        raise NotImplementedError(
            f"local model {name!r} is not ported yet (it comes with the "
            f"image and series slices); see ROADMAP.md")
    return ZOO.get(name)(**kwargs)
