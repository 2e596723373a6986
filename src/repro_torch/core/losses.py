"""Overarching losses L1 and local regression losses ell_m (paper Sec. 3.2).

Ported from ``src/repro/core/losses.py``. Conventions as in the
reference: F lives in link space (raw logits for classification, raw
output for regression), y is one-hot (N, K) for K-class tasks and (N, 1)
for regression and binary tasks, ``residual(y, F)`` is the per-sample
pseudo-residual r = -dL(y, F)/dF (no 1/N factor), and
``init_prediction(y)`` gives F^0, E_N(y) mapped to link space.

Registered in ``LOSSES``: ``mse``, ``mae``, ``xent`` and ``bce``, each with
its closed-form residual; ``autodiff_residual`` is the generic -dL/dF they
are held against. Local losses ell_q(r, f) = mean |r - f|^q come from
``lq_loss`` (paper Table 4, q in {1, 1.5, 2, 4}).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.ops import residual_xent
from repro_torch.utils.registry import Registry

LOSSES: Registry = Registry("loss")


@dataclass(frozen=True)
class Loss:
    name: str

    def __call__(self, y, f):  # mean scalar loss
        raise NotImplementedError

    def residual(self, y, f):  # per-sample -dL/dF
        # generic fallback: autodiff of the summed loss, for a subclass
        # that only defines per_sample
        with torch.enable_grad():
            ff = f.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.per_sample(y, ff).sum(), ff)
        return -g

    def per_sample(self, y, f):
        raise NotImplementedError

    def init_prediction(self, y):
        raise NotImplementedError


def autodiff_residual(loss: Loss, y, f):
    """The generic ``-dL/dF`` of ``Loss.residual``, bypassing any closed
    form the subclass defines: the oracle the closed forms and the
    ``residual_xent`` kernel are held against."""
    return Loss.residual(loss, y, f)


# class count from which CrossEntropyLoss.residual routes through the
# residual_xent kernel: below it a second (N, K) softmax buffer is cheap.
# The tabular fit reaches K1 through this gate; fit_lm calls the kernel
# itself (gal_lm.compute_residual).
XENT_KERNEL_MIN_CLASSES = 1024
# device types where that route engages. On the CPU the kernel's plain
# version would only repeat the closed form, so the closed form stays;
# tests widen this to exercise the route.
XENT_KERNEL_BACKENDS = ("cuda",)


@LOSSES.register("mse")
@dataclass(frozen=True)
class MSELoss(Loss):
    name: str = "mse"

    def per_sample(self, y, f):
        return 0.5 * torch.sum(torch.square(y - f), dim=-1)

    def __call__(self, y, f):
        return torch.mean(self.per_sample(y, f))

    def residual(self, y, f):
        return y - f

    def init_prediction(self, y):
        return torch.mean(y, dim=0, keepdim=True)


@LOSSES.register("mae")
@dataclass(frozen=True)
class MAELoss(Loss):
    """Mean absolute deviation (the paper's regression metric and an L1
    choice)."""
    name: str = "mae"

    def per_sample(self, y, f):
        return torch.sum(torch.abs(y - f), dim=-1)

    def __call__(self, y, f):
        return torch.mean(self.per_sample(y, f))

    def residual(self, y, f):
        return torch.sign(y - f)

    def init_prediction(self, y):
        # the median as the reference takes it (jnp.median): the mean of
        # the two middle values when N is even (torch.median takes the
        # lower one)
        s = torch.sort(y, dim=0).values
        n = y.shape[0]
        return ((s[(n - 1) // 2] + s[n // 2]) * 0.5).reshape(1, -1)


@LOSSES.register("xent")
@dataclass(frozen=True)
class CrossEntropyLoss(Loss):
    """K-class cross entropy on logits; r = y - softmax(F). At K >=
    ``XENT_KERNEL_MIN_CLASSES`` on a ``XENT_KERNEL_BACKENDS`` device the
    residual goes through the ``residual_xent`` kernel, which takes
    labels: they are recovered by argmax, and the correction
    ``y - onehot(argmax y)`` (zero for one-hot y, the smoothing mass for
    soft targets) keeps both conventions exact."""
    name: str = "xent"

    def per_sample(self, y, f):
        return -torch.sum(y * torch.log_softmax(f, dim=-1), dim=-1)

    def __call__(self, y, f):
        return torch.mean(self.per_sample(y, f))

    def residual(self, y, f):
        if (f.ndim == 2 and y.shape == f.shape
                and f.shape[-1] >= XENT_KERNEL_MIN_CLASSES
                and f.device.type in XENT_KERNEL_BACKENDS):
            labels = torch.argmax(y, dim=-1)
            cols = torch.arange(f.shape[-1], device=f.device)
            hard = (labels[:, None] == cols).to(y.dtype)
            return residual_xent(f.contiguous(), labels) + (y - hard)
        return y - torch.softmax(f, dim=-1)

    def init_prediction(self, y):
        prior = torch.clamp(torch.mean(y, dim=0, keepdim=True), 1e-6, 1.0)
        return torch.log(prior)


@LOSSES.register("bce")
@dataclass(frozen=True)
class BCELoss(Loss):
    """Binary cross entropy on a single logit (imbalanced tasks,
    MIMICM-like)."""
    name: str = "bce"

    def per_sample(self, y, f):
        return torch.sum(
            torch.clamp_min(f, 0.0) - f * y
            + torch.log1p(torch.exp(-torch.abs(f))), dim=-1)

    def __call__(self, y, f):
        return torch.mean(self.per_sample(y, f))

    def residual(self, y, f):
        return y - torch.sigmoid(f)

    def init_prediction(self, y):
        p = torch.clamp(torch.mean(y, dim=0, keepdim=True), 1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))


def lq_loss(q: float):
    """Local regression loss ell_q(r, f) = mean |r - f|^q (paper Table 4)."""
    q = float(q)

    def loss(r, f):
        d = torch.abs(r - f)
        if q == 2.0:
            return torch.mean(torch.square(d))
        if q == 1.0:
            # smooth |.| for stable autodiff at 0
            return torch.mean(torch.sqrt(torch.square(d) + 1e-12))
        return torch.mean(torch.pow(d + 1e-12, q))

    loss.q = q
    loss.__name__ = f"l{q:g}"
    return loss


def get_loss(name: str) -> Loss:
    cls = LOSSES.get(name)
    return cls() if isinstance(cls, type) else cls
