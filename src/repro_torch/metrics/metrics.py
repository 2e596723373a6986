"""Evaluation metrics matching the paper: Accuracy, MAD, AUROC.

Ported from ``src/repro/metrics/metrics.py``. Each metric is a
``(y, f) -> 0-d tensor`` callable on the device of its inputs, registered
in ``METRICS`` so ``gal.fit(..., metrics=("mad",))`` can name it. The
reference also requires a metric to trace under ``jax.eval_shape``; the
port's fit runs eagerly, so any callable of two tensors will do.
"""
from __future__ import annotations

import torch

from repro_torch.utils.registry import Registry

METRICS: Registry = Registry("metric")


@METRICS.register("accuracy")
def accuracy(y_onehot: torch.Tensor, f_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(
        (torch.argmax(f_logits, -1) == torch.argmax(y_onehot, -1)).float()
    ) * 100.0


@METRICS.register("mad")
def mad(y: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Mean absolute deviation (paper's regression metric)."""
    return torch.mean(torch.abs(y - f))


@METRICS.register("auroc")
def auroc(y: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Rank-based AUROC for binary labels y in {0,1}, scores = logits.
    Mann-Whitney U with exact average ranks for ties: each score's rank is
    the mean of the 1-based positions its tie group spans, so the result
    does not depend on sample order."""
    y = y.reshape(-1)
    s = scores.reshape(-1)
    s_sorted = torch.sort(s).values
    lo = torch.searchsorted(s_sorted, s, side="left")
    hi = torch.searchsorted(s_sorted, s, side="right")
    ranks = 0.5 * (lo + hi + 1).to(s.dtype)
    n_pos = torch.sum(y)
    n_neg = y.shape[0] - n_pos
    sum_pos = torch.sum(ranks * y)
    u = sum_pos - n_pos * (n_pos + 1) / 2.0
    return torch.where((n_pos > 0) & (n_neg > 0), u / (n_pos * n_neg),
                       torch.full_like(u, 0.5))


def get_metric(name: str):
    """Resolve a registry metric by name (the ``gal.fit(metrics=...)``
    entries)."""
    return METRICS.get(name)


def metric_for_task(task: str):
    if task == "classification":
        return accuracy
    if task == "regression":
        return mad
    if task == "binary":
        return auroc
    raise ValueError(f"unknown task {task!r}")
