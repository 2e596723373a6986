"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig, register_arch

FULL = ModelConfig(
    arch="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500000.0,
    act="swiglu", norm="rmsnorm", source="arXiv:2407.21783",
)

SMOKE = ModelConfig(
    arch="llama3-8b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512, rope_theta=500000.0,
    act="swiglu", norm="rmsnorm", dtype="float32",
)

register_arch("llama3-8b")((FULL, SMOKE))
