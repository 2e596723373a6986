"""repro_torch: the GAL reproduction on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that keeps its layout: each module here
mirrors the module of the same path there. It imports torch, numpy and the
standard library only. Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``; see ``repro_torch.utils.device``.
"""
__version__ = "0.1.0"
