"""Architecture config schema + registry.

Every assigned architecture registers a FULL config (exact numbers from the
task's public-pool citation) and a SMOKE config (<=2 layers, d_model<=512,
<=4 experts) for CPU tests. Input shapes are registered alongside.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from repro_torch.utils.registry import Registry

ARCHS: Registry = Registry("architecture")


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    # attention flavor
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None     # sliding-window size (long-context variant)
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_heads: int = 0               # mamba2 value heads; 0 = derive
    ssm_expand: int = 2
    conv_width: int = 4
    # layer pattern: "attn" uniform default; hybrid uses a repeating unit
    block_unit: Tuple[str, ...] = ("attn",)
    shared_attn: bool = False        # zamba2: one shared attn block reused
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # modality frontend STUB (vlm / audio): model consumes embeddings directly
    frontend: Optional[str] = None   # "vision" | "audio" | None
    num_patches: int = 0             # vlm: image-patch embeddings per sample
    num_frames: int = 0              # audio: frame embeddings per sample
    # attention memory policy: 0 = dense scores; >0 = online-softmax over
    # KV chunks of this size (pure-JAX flash; the launcher sets this for the
    # big shapes so score temporaries stay bounded)
    attn_chunk: int = 0
    # misc
    act: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    scan_layers: bool = True         # stack+scan homogeneous layers
    remat: bool = False              # activation checkpointing in scan body
    remat_group: bool = False        # 2-level (sqrt-L) checkpointing
    source: str = ""                 # citation from the assignment

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and "attn" not in self.block_unit

    def with_window(self, window: int) -> "ModelConfig":
        return replace(self, window=window)

    def param_count(self) -> int:
        """Analytic parameter count (used in roofline MODEL_FLOPS = 6ND)."""
        d, ff, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        unit = self.block_unit
        n_units = self.n_layers // max(len([b for b in unit if b != "shared_attn"]), 1) \
            if "shared_attn" in unit else self.n_layers
        attn_p = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.act == "swiglu":
            mlp_p = 3 * d * ff
        else:
            mlp_p = 2 * d * ff
        total = emb
        for i in range(self.n_layers):
            kind = self.block_unit[i % len(self.block_unit)] \
                if len(self.block_unit) > 1 else self.block_unit[0]
            if kind == "attn":
                total += attn_p
                if self.is_moe:
                    total += self.moe_experts * mlp_p + d * self.moe_experts
                else:
                    total += mlp_p
            elif kind == "mamba":
                d_in = self.ssm_expand * d
                total += d * (2 * d_in + 2 * self.ssm_state +
                              max(self.ssm_heads, 1)) + d_in * d + d_in
            elif kind == "rwkv":
                total += 4 * d * d + d * ff * 2  # tmix + cmix approx
        if self.shared_attn:
            total += attn_p + mlp_p  # one shared block
        if self.is_encoder_decoder:
            # encoder layers (attn + gelu mlp) + decoder cross-attn
            total += self.encoder_layers * (attn_p + 2 * d * ff)
            total += self.n_layers * attn_p  # cross-attn per decoder layer
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp_p = 3 * d * ff if self.act == "swiglu" else 2 * d * ff
        inactive = self.n_layers * (self.moe_experts - self.moe_topk) * mlp_p
        return int(self.param_count() - inactive)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def register_arch(name: str):
    return ARCHS.register(name)


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    full, smoke_cfg = ARCHS.get(name)
    return smoke_cfg if smoke else full


def arch_names():
    return ARCHS.names()
