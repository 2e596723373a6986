"""Plain PyTorch versions of the port's kernels: what the CPU runs, and
what ``chip_smoke.py`` holds each kernel against on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain GQA attention. q: (B, S, H, hd); k, v: (B, S, KV, hd).

    Returns (B, S, H, hd) in q.dtype. Query head h reads KV head
    h // (H / KV). Key j is visible to query i iff (causal) i >= j and
    (window) i - j < window, by sequence index; the window is one-sided.
    Scores are f32 (bf16 operands widened exactly, f32 sums, as the
    reference's ``preferred_element_type=f32``), softmax in f32,
    probabilities cast to v's dtype for the value product. Builds the
    (B, KV, H/KV, S, S) f32 score tensor: small shapes only.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) \
        * (hd ** -0.5)
    qpos = torch.arange(s, device=q.device)
    mask = None
    if causal:
        mask = qpos[:, None] >= qpos[None, :]
    if window is not None:
        wmask = qpos[:, None] - qpos[None, :] < window
        mask = wmask if mask is None else (mask & wmask)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, h, hd).to(q.dtype)
