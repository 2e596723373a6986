"""Parameters from the JAX reference to the port's tensors.

``params_from_jax`` takes the tree that ``repro.models.transformer
.init_params`` builds, as numpy arrays (bf16 arriving as ``uint16`` views,
the way ``repro.checkpoint`` stores it, or as a numpy ``bfloat16`` dtype),
and returns the port's dict of tensors. Both sides keep the layer stack
as (L, ...) leaves, so the mapping is one to one: same keys, same shapes.
This module needs no JAX; only numpy arrays cross.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.utils.device import resolve_device


def _tensor(arr: np.ndarray, want: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.view(np.uint16)
    if arr.dtype == np.uint16:          # bf16 bits
        if want != torch.bfloat16:
            raise TypeError(f"bf16 leaf for a {want} config")
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(np_tree: Any, cfg: ModelConfig, device=None) -> Any:
    """The reference's param tree (numpy leaves) as the port's tensors on
    ``device`` (the card unless ``device="cpu"``). Raises when the layer
    stack or the vocab does not match ``cfg``."""
    device = resolve_device(device)
    want = dtype_of(cfg)
    layers = np_tree["layers"]
    n = np.asarray(layers["attn"]["wq"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"layer stack holds {n} layers, cfg wants "
                         f"{cfg.n_layers}")
    vocab = np.asarray(np_tree["embed"]["tok"]).shape[0]
    if vocab != cfg.vocab:
        raise ValueError(f"embedding holds vocab {vocab}, cfg wants "
                         f"{cfg.vocab}")

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, want, device)

    return walk(np_tree)
