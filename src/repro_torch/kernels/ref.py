"""Plain PyTorch versions of the port's kernels: what the CPU runs, and
what ``chip_smoke.py`` holds each kernel against on the card."""
from __future__ import annotations

import torch


def residual_xent_ref(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Pseudo-residual of cross entropy: r = onehot(labels) - softmax(logits).

    logits: (T, V) any float dtype; labels: (T,) int. Returns f32 (T, V).
    A label outside [0, V) sets no one-hot column (the reference's -1
    padding convention). This is the tensor Alice broadcasts each GAL round
    (paper Alg. 1 step 1) for an LM-scale overarching loss.
    """
    v = logits.shape[-1]
    sm = torch.softmax(logits.float(), dim=-1)
    cols = torch.arange(v, device=logits.device)
    onehot = (labels.reshape(-1, 1) == cols).to(torch.float32)
    return onehot - sm
