"""Dense GQA transformer: parameter init and the full-sequence forward.

Ported from ``src/repro/models/transformer.py`` for the dense ``("attn",)``
unit (llama3 / granite / stablelm / qwen3). Layer params are stored stacked
(L, ...) as the reference's ``_scan_layers`` keeps them, so converted
reference params map one to one; the forward loops over the stack. The
reference's sharding constraints and stash barrier are no-ops on one GPU
and are dropped; ``remat`` is a memory policy the port does not apply yet.
MoE, RWKV, SSM, encoder-decoder and VLM families, and decode, come in
later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dtype_of, embed_tokens, init_embedding, init_mlp,
    init_norm, unembed,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.block_unit != ("attn",) or cfg.is_moe or cfg.is_encoder_decoder
            or cfg.frontend is not None):
        raise NotImplementedError(
            f"{cfg.arch} ({cfg.family}, block unit {cfg.block_unit}) is not "
            f"ported yet: the port runs the dense attention family so far; "
            f"see ROADMAP.md")


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> Dict[str, Any]:
    """Fresh params drawn from ``generator``, placed on ``device`` (the card
    unless ``device="cpu"``)."""
    _check_supported(cfg)
    device = resolve_device(device)
    lead = (cfg.n_layers,)
    return {
        "embed": init_embedding(generator, cfg, device=device),
        "ln_f": init_norm(cfg, cfg.d_model, device=device),
        "layers": {
            "ln1": init_norm(cfg, cfg.d_model, device=device, lead=lead),
            "attn": attn.init_attention(generator, cfg, device=device,
                                        lead=lead),
            "ln2": init_norm(cfg, cfg.d_model, device=device, lead=lead),
            "mlp": init_mlp(generator, cfg, device=device, lead=lead),
        },
    }


def _attn_block_fwd(block, cfg: ModelConfig, x, positions, *, causal=True,
                    window=None, flash=False):
    h = attn.attention_train(block["attn"], cfg, apply_norm(block["ln1"], x),
                             positions, causal=causal, window=window,
                             flash=flash)
    x = x + h
    return x + apply_mlp(block["mlp"], apply_norm(block["ln2"], x), cfg.act)


def apply(params, cfg: ModelConfig, tokens, *, flash: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. tokens: (B, S) int.

    Returns (logits (B, S, vocab) in the compute dtype, aux_loss): logits
    stay in the compute dtype as in the reference; losses upcast."""
    _check_supported(cfg)
    x = embed_tokens(params["embed"], tokens).to(dtype_of(cfg))
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for i in range(cfg.n_layers):
        layer = tree_map(lambda a, i=i: a[i], params["layers"])
        x = _attn_block_fwd(layer, cfg, x, positions, causal=True,
                            window=cfg.window, flash=flash)
    x = apply_norm(params["ln_f"], x)
    logits = unembed(params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
