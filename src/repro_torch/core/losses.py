"""Overarching loss L1 at LM scale (paper Sec. 3.2): softmax cross entropy.

Conventions as in the reference (``src/repro/core/losses.py``): F lives in
link space (raw logits), y is one-hot (N, K), ``residual(y, F)`` is the
per-sample pseudo-residual r = -dL(y, F)/dF (no 1/N factor), and
``init_prediction(y)`` gives F^0 = log of the clipped class prior. The
tabular losses (mse, mae, bce, ell_q) come with the tabular slice.
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


# vocab width from which CrossEntropyLoss.residual routes through the
# residual_xent kernel: below it a second (N, K) softmax buffer is cheap.
XENT_KERNEL_MIN_CLASSES = 1024
# device types where that route engages. On the CPU the kernel's plain
# version would only repeat the closed form, so the closed form stays;
# tests widen this to exercise the route.
XENT_KERNEL_BACKENDS = ("cuda",)


@LOSSES.register("xent")
@dataclass(frozen=True)
class CrossEntropyLoss(Loss):
    """K-class cross entropy on logits; r = y - softmax(F). At LM scale
    (K >= ``XENT_KERNEL_MIN_CLASSES`` on a ``XENT_KERNEL_BACKENDS`` device)
    the residual goes through the ``residual_xent`` kernel, which takes
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
            return residual_xent(f, labels) + (y - hard)
        return y - torch.softmax(f, dim=-1)

    def init_prediction(self, y):
        prior = torch.clamp(torch.mean(y, dim=0, keepdim=True), 1e-6, 1.0)
        return torch.log(prior)
