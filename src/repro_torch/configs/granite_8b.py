"""granite-8b [dense] — llama-arch, code [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig, register_arch

FULL = ModelConfig(
    arch="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, rope_theta=10000.0,
    act="swiglu", norm="rmsnorm", source="arXiv:2405.04324",
)

SMOKE = ModelConfig(
    arch="granite-8b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512, act="swiglu", norm="rmsnorm", dtype="float32",
)

register_arch("granite-8b")((FULL, SMOKE))
