"""Synthetic stand-ins for the paper's tabular datasets (offline).

Ported from ``src/repro/data/synthetic.py``: the same numpy draws in the
same order, so one ``np.random.Generator`` seed gives the reference's
arrays bit for bit, returned as float32 CPU tensors (a fit moves them to
its device).

  make_regression     -> Diabetes / BostonHousing-like regression
  make_blobs          -> the paper's 'Blob' (sklearn make_blobs analogue)
  make_classification -> Wine / BreastCancer / QSAR-like margin tasks

The image and series generators (``make_patch_images``,
``make_multimodal_series``) come with the ConvNet and GRUNet org models
(ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Dataset:
    x: torch.Tensor           # (N, d) features
    y: torch.Tensor           # (N, K) one-hot or (N, 1) regression target
    task: str                 # "regression" | "classification" | "binary"
    name: str = "synthetic"


def _onehot(labels: np.ndarray, k: int) -> np.ndarray:
    return np.eye(k, dtype=np.float32)[labels]


def make_regression(rng: np.random.Generator, n: int = 442, d: int = 10,
                    noise: float = 0.3, nonlinear: float = 0.2) -> Dataset:
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, 1)).astype(np.float32)
    y = x @ w + nonlinear * np.sin(2.0 * x[:, :1]) * np.abs(x[:, 1:2])
    y = y + noise * rng.standard_normal((n, 1)).astype(np.float32)
    return Dataset(torch.from_numpy(x), torch.from_numpy(y.astype(np.float32)),
                   "regression", "regression")


def make_blobs(rng: np.random.Generator, n: int = 100, d: int = 10,
               k: int = 10, spread: float = 1.0) -> Dataset:
    centers = 4.0 * rng.standard_normal((k, d)).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    x = centers[labels] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return Dataset(torch.from_numpy(x), torch.from_numpy(_onehot(labels, k)),
                   "classification", "blob")


def make_classification(rng: np.random.Generator, n: int = 844, d: int = 41,
                        k: int = 2, informative: int | None = None,
                        margin: float = 1.0) -> Dataset:
    informative = informative or max(2, d // 2)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((informative, k)).astype(np.float32)
    logits = margin * x[:, :informative] @ w
    logits += 0.5 * np.tanh(x[:, :informative] ** 2 @ np.abs(w))
    labels = np.argmax(
        logits + 0.5 * rng.standard_normal(logits.shape).astype(np.float32), axis=-1
    )
    return Dataset(torch.from_numpy(x), torch.from_numpy(_onehot(labels, k)),
                   "classification", "classification")


def train_test_split(ds: Dataset, rng: np.random.Generator,
                     test_frac: float = 0.2) -> Tuple[Dataset, Dataset]:
    n = ds.x.shape[0]
    perm = rng.permutation(n)
    n_test = int(round(n * test_frac))
    te, tr = torch.from_numpy(perm[:n_test]), torch.from_numpy(perm[n_test:])
    return (
        Dataset(ds.x[tr], ds.y[tr], ds.task, ds.name),
        Dataset(ds.x[te], ds.y[te], ds.task, ds.name + "_test"),
    )
