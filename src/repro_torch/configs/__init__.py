"""Architecture config registry. Importing this package registers the
architectures the port runs so far, the dense attention family
(``llama3-8b``, ``granite-8b``, ``qwen3-1.7b``, ``stablelm-1.6b``); the
other six of the reference's registry come with their model families (see
ROADMAP.md)."""
from repro_torch.configs.base import (
    ARCHS, SHAPES, InputShape, ModelConfig, arch_names, get_arch,
)
from repro_torch.configs import (  # noqa: F401
    llama3_8b, granite_8b, qwen3_1_7b, stablelm_1_6b,
)

ALL_ARCHS = arch_names()
