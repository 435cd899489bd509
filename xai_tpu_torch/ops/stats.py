"""Curve statistics: AUC, Spearman rank correlation, entropy.

Counterpart of ``xai_tpu/ops/stats.py``.  AUC matches
MASTestFunctions.py:30-32 (normalized trapezoid); Spearman matches
``scipy.stats.spearmanr`` with average-tie ranks.  Both run on host numpy
over the ~225-point curves; ``entropy_bits`` runs on the device tensors
inside the battery's forwards.
"""
from __future__ import annotations

import numpy as np
import torch


def auc_np(arr) -> float:
    arr = np.asarray(arr)
    return float((arr.sum() - arr[0] / 2 - arr[-1] / 2) / (arr.shape[0] - 1))


def spearman_np(a, b) -> float:
    """scipy-free Spearman with average-tie ranks, host numpy."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()

    def ranks(x):
        order = np.argsort(x)
        pos = np.empty_like(order)
        pos[order] = np.arange(len(x))
        xs = x[order]
        # average rank within tie groups
        _, inv, counts = np.unique(xs, return_inverse=True,
                                   return_counts=True)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        avg = starts + (counts - 1) / 2.0
        r = np.empty(len(x))
        r[order] = avg[inv]
        return r

    ra, rb = ranks(a), ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom)


def entropy_bits(probs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """-sum p log2 p, the per-step entropy column (RISETestFunctions.py:124)."""
    p = probs.clamp(1e-12, 1.0)
    return -(p * torch.log2(p)).sum(dim=dim)
