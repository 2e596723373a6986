"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig, register_arch

FULL = ModelConfig(
    arch="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352, rope_theta=10000.0,
    act="swiglu", norm="layernorm", source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = ModelConfig(
    arch="stablelm-1.6b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab=512, act="swiglu", norm="layernorm", dtype="float32",
)

register_arch("stablelm-1.6b")((FULL, SMOKE))
