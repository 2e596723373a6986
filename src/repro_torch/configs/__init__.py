"""Architecture config registry. Importing this package registers the
architectures the port runs so far (``llama3-8b``); the other nine of the
reference's registry come with their model families (see ROADMAP.md)."""
from repro_torch.configs.base import (
    ARCHS, SHAPES, InputShape, ModelConfig, arch_names, get_arch,
)
from repro_torch.configs import llama3_8b  # noqa: F401

ALL_ARCHS = arch_names()
