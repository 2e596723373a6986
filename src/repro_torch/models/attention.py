"""GQA attention for training and prefill: causal / sliding-window
self-attention.

Ported from ``src/repro/models/attention.py``. Shapes: x (B, S, d);
q (B, S, H, hd); k, v (B, S, KV, hd). On the einsum and chunked paths KV
heads are repeated to the full H before the score product; scores and
softmax are f32 (the reference's ``preferred_element_type=f32``: bf16
operands widened exactly, f32 sums), probabilities are cast back to v's
dtype for the value product.

``flash=True`` takes the flash-attention path of the reference: after
rotary, the un-repeated q, k, v go to ``kernels.ops.flash_attention``
(kernel K2 on a CUDA tensor, its plain version on the CPU; GQA lives in
the kernel), then ``wo``. K2 is forward-only: a backward through it
raises. Cross attention and single-token decode come with the model
families and the serving slice that use them (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.layers import (
    apply_rotary, dense_init, dtype_of, rms_head_norm, rotary_freqs,
)

NEG_INF = -1e30


def init_attention(generator, cfg: ModelConfig, *, device, lead=()):
    d, hd = cfg.d_model, cfg.hd
    dt = dtype_of(cfg)
    kw = dict(device=device, lead=lead)
    p = {
        "wq": dense_init(generator, d, cfg.n_heads * hd, dt, **kw),
        "wk": dense_init(generator, d, cfg.n_kv_heads * hd, dt, **kw),
        "wv": dense_init(generator, d, cfg.n_kv_heads * hd, dt, **kw),
        "wo": dense_init(generator, cfg.n_heads * hd, d, dt, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=torch.float32,
                                 device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=torch.float32,
                                 device=device)
    return p


def _project_qkv(params, cfg: ModelConfig, xq, xkv):
    b, s, _ = xq.shape
    skv = xkv.shape[1]
    hd = cfg.hd
    q = (xq @ params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (xkv @ params["wk"]).reshape(b, skv, cfg.n_kv_heads, hd)
    v = (xkv @ params["wv"]).reshape(b, skv, cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = rms_head_norm(q, params["q_norm"])
        k = rms_head_norm(k, params["k_norm"])
    return q, k, v


def _repeat_kv(k, n_heads: int):
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each KV head G times."""
    g = n_heads // k.shape[2]
    if g == 1:
        return k
    return torch.repeat_interleave(k, g, dim=2)


def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    mask = None
    if causal:
        mask = qpos[..., :, None] >= kpos[..., None, :]
    if window is not None:
        wmask = qpos[..., :, None] - kpos[..., None, :] < window
        mask = wmask if mask is None else (mask & wmask)
    return mask


def attention_train(params, cfg: ModelConfig, x, positions,
                    causal: bool = True, window: Optional[int] = None,
                    flash: bool = False):
    """Full-sequence self-attention. positions: (B, S). Returns (B, S, d)."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x, x)
    sin, cos = rotary_freqs(cfg, positions)
    q = apply_rotary(q, sin, cos)
    k = apply_rotary(k, sin, cos)
    if flash:
        out = flash_attention(q, k, v, causal=causal, window=window)
        out = out.reshape(out.shape[0], out.shape[1], -1)
        return out @ params["wo"]
    k = _repeat_kv(k, cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    s_len = q.shape[1]
    chunk = cfg.attn_chunk
    if chunk and s_len > chunk and s_len % chunk == 0:
        out = _chunked_attention(q, k, v, positions, causal=causal,
                                 window=window, chunk=chunk)
    else:
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
            * (cfg.hd ** -0.5)
        if causal or window is not None:
            mask = _mask(positions, positions, causal, window)
            scores = torch.where(mask[:, None, :, :], scores,
                                 torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
    out = out.reshape(b, out.shape[1], -1)
    return out @ params["wo"]


def _chunked_attention(q, k, v, positions, *, causal, window, chunk):
    """Online-softmax attention over KV chunks (the flash algorithm in
    plain PyTorch), bounding the score temporaries to (B, H, S, chunk).

    q: (B, S, H, hd); k, v: (B, T, H, hd) (heads already repeated)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    scale = hd ** -0.5
    qpos = positions if positions.ndim == 2 else positions[None]
    qf = q.float()
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, t, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kp = qpos[:, c0:c0 + chunk]
        srs = torch.einsum("bshd,bchd->bhsc", qf, kb.float()) * scale
        mask = _mask(qpos, kp, causal, window)
        if mask is not None:
            srs = torch.where(mask[:, None], srs,
                              torch.full_like(srs, NEG_INF))
        m_new = torch.maximum(m, torch.amax(srs, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(srs - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhsc,bchd->bhsd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (B,S,H,hd)
