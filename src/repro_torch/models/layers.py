"""Shared neural layers for the architecture substrate (PyTorch, dict params).

Ported from ``src/repro/models/layers.py``. Conventions:
  init_*(generator, cfg, ..., device) -> params dict of tensors
  apply signature (params, x, ...) -> y
Compute dtype follows x.dtype; norm statistics and softmax accumulate in
f32. Random draws come from the caller's ``torch.Generator`` (drawn on the
generator's device, then moved to ``device``); ``lead`` prepends stacking
dimensions, e.g. ``(n_layers,)`` for the layer stack.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.to(device)


def dense_init(generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, *, device,
               lead: Tuple[int, ...] = ()):
    scale = scale if scale is not None else d_in ** -0.5
    return (_normal(generator, (*lead, d_in, d_out), device)
            * scale).to(dtype)


# ------------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, d: int, *, device, lead: Tuple[int, ...] = ()):
    p = {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=torch.float32, device=device)
    return p


def apply_norm(params, x, eps: float = 1e-6):
    # statistics accumulate in f32; the elementwise math stays in x.dtype
    if "bias" in params:  # layernorm
        mu = torch.mean(x, dim=-1, keepdim=True, dtype=torch.float32)
        var = torch.mean(torch.square(x), dim=-1, keepdim=True,
                         dtype=torch.float32) - torch.square(mu)
        inv = torch.rsqrt(var + eps)
        return ((x - mu.to(x.dtype)) * inv.to(x.dtype)
                * params["scale"].to(x.dtype) + params["bias"].to(x.dtype))
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True,
                    dtype=torch.float32)
    inv = torch.rsqrt(ms + eps)
    return x * inv.to(x.dtype) * params["scale"].to(x.dtype)


def rms_head_norm(x, scale, eps: float = 1e-6):
    """Per-head RMSNorm over head_dim (qwen3 qk-norm)."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ------------------------------------------------------------------- rotary
def rotary_freqs(cfg: ModelConfig, positions: torch.Tensor) -> tuple:
    """positions: (..., S) int -> (sin, cos) of shape (..., S, hd/2), f32."""
    hd = cfg.hd
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (cfg.rope_theta ** exps)
    angles = positions[..., None].to(torch.float32) * inv
    return torch.sin(angles), torch.cos(angles)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
                 ) -> torch.Tensor:
    """x: (..., S, H, hd); sin/cos: (..., S, hd/2) broadcast over heads.
    Rotation in x.dtype (sin/cos cast down)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    s = sin[..., None, :].to(x.dtype)
    c = cos[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ------------------------------------------------------------------- MLP
def init_mlp(generator, cfg: ModelConfig, d: Optional[int] = None,
             ff: Optional[int] = None, *, device,
             lead: Tuple[int, ...] = ()):
    d = d or cfg.d_model
    ff = ff or cfg.d_ff
    dt = dtype_of(cfg)
    kw = dict(device=device, lead=lead)
    if cfg.act == "swiglu":
        return {"w_gate": dense_init(generator, d, ff, dt, **kw),
                "w_up": dense_init(generator, d, ff, dt, **kw),
                "w_down": dense_init(generator, ff, d, dt, **kw)}
    return {"w_up": dense_init(generator, d, ff, dt, **kw),
            "w_down": dense_init(generator, ff, d, dt, **kw)}


def apply_mlp(params, x, act: str = "swiglu"):
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")  # jax.nn.gelu
    return h @ params["w_down"]


# ------------------------------------------------------------------- embed
def init_embedding(generator, cfg: ModelConfig, *, device):
    dt = dtype_of(cfg)
    p = {"tok": (_normal(generator, (cfg.vocab, cfg.d_model), device)
                 * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab, dt,
                                  scale=cfg.d_model ** -0.5, device=device)
    return p


def embed_tokens(params, tokens):
    return F.embedding(tokens, params["tok"])


def unembed(params, h):
    if "unembed" in params:
        return h @ params["unembed"]
    return h @ params["tok"].T
