"""Vertical partitioning of features across organizations (paper Fig. 2).

Ported from ``src/repro/data/partition.py``:

  split_features  — disjoint column blocks of tabular data (UCI setting)
  split_channels  — channel groups (modalities) of series or embeddings

Image patches (``split_image_patches``, ``flatten_for_tabular``) come with
the ConvNet org model, and the stacking helpers with the compiled engine
(ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def split_features(x: torch.Tensor, m: int,
                   rng: np.random.Generator | None = None
                   ) -> List[torch.Tensor]:
    """Random (or contiguous) disjoint column blocks, sizes as equal as
    possible."""
    d = x.shape[-1]
    if m > d:
        raise ValueError(f"cannot split {d} features across {m} orgs")
    cols = np.arange(d) if rng is None else rng.permutation(d)
    blocks = np.array_split(cols, m)
    return [x[:, torch.from_numpy(np.sort(b)).to(x.device)] for b in blocks]


def split_channels(x: torch.Tensor, sizes: Sequence[int]
                   ) -> List[torch.Tensor]:
    """Split the last axis into groups of the given sizes (modalities)."""
    if sum(sizes) != x.shape[-1]:
        raise ValueError(f"sizes {sizes} do not sum to {x.shape[-1]}")
    out, start = [], 0
    for s in sizes:
        out.append(x[..., start:start + s])
        start += s
    return out
