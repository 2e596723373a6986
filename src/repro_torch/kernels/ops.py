"""Public entry points for the port's kernels, dispatching by device.

A CUDA tensor goes to the hand-written kernel and nothing else; a tensor
on the CPU goes to the kernel's plain PyTorch version
(``repro_torch.kernels.ref``), which is what the CPU tests run.
``use_kernel=False`` keeps the reference's meaning: the plain version,
asked for by name.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.residual_xent import residual_xent_cuda


def residual_xent(logits: torch.Tensor, labels: torch.Tensor,
                  use_kernel: bool = True) -> torch.Tensor:
    """Pseudo-residual r = onehot(labels) - softmax(logits).

    logits: (..., V); labels: (...,) int. Returns the f32 residual.
    """
    lead = logits.shape[:-1]
    v = logits.shape[-1]
    flat = logits.reshape(-1, v)
    lab = labels.reshape(-1)
    if use_kernel and flat.device.type != "cpu":
        out = residual_xent_cuda(flat, lab)
    else:
        out = ref.residual_xent_ref(flat, lab)
    return out.reshape(*lead, v)
