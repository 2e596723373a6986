"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig, register_arch

FULL = ModelConfig(
    arch="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936, qk_norm=True, rope_theta=1e6,
    act="swiglu", norm="rmsnorm", source="hf:Qwen/Qwen3-8B",
)

SMOKE = ModelConfig(
    arch="qwen3-1.7b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab=512, qk_norm=True,
    act="swiglu", norm="rmsnorm", dtype="float32",
)

register_arch("qwen3-1.7b")((FULL, SMOKE))
