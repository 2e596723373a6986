"""Public entry points for the port's kernels, dispatching by device.

A CUDA tensor goes to the hand-written kernel and nothing else; a tensor
on the CPU goes to the kernel's plain PyTorch version
(``repro_torch.kernels.ref``), which is what the CPU tests run.
``use_kernel=False`` keeps the reference's meaning: the plain version,
asked for by name.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """GQA flash attention. q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd)."""
    if use_kernel and q.device.type != "cpu":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
