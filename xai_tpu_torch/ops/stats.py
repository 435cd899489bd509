"""Curve statistics: AUC, Spearman rank correlation, entropy.

Counterpart of ``xai_tpu/ops/stats.py``.  AUC matches
MASTestFunctions.py:30-32 (normalized trapezoid); Spearman matches
``scipy.stats.spearmanr`` with average-tie ranks.  The battery scores its
~225-point curves with the host numpy ``auc_np`` / ``spearman_np``;
``auc`` and ``spearman`` are the tensor forms, for use on the device and
inside autograd graphs (the differentiable MAS loss); ``entropy_bits``
runs on the device tensors inside the battery's forwards.
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


def auc(arr) -> torch.Tensor:
    """The normalized trapezoid of a 1-D curve, as a tensor."""
    arr = torch.as_tensor(arr)
    return (arr.sum() - arr[0] / 2 - arr[-1] / 2) / (arr.shape[0] - 1)


def _average_ranks(x: torch.Tensor) -> torch.Tensor:
    """1-D ranks from 1, ties given the mean of their positional ranks
    (``scipy.stats.rankdata(method="average")``); float64 for a float64
    ``x``, else float32."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=x.device)
    xs = x[order]
    # each element's tie group spans positions first..last of the sorted x
    first = torch.searchsorted(xs, xs, side="left")
    last = torch.searchsorted(xs, xs, side="right") - 1
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    avg = (first + last).to(dtype) / 2.0 + 1.0
    return avg[pos]


def spearman(a, b) -> torch.Tensor:
    """Spearman's rho of two tensors (flattened), with average-tie ranks:
    float64 when ``a`` is float64, else float32."""
    a = torch.as_tensor(a)
    dtype = torch.float64 if a.dtype == torch.float64 else torch.float32
    a = a.to(dtype).reshape(-1)
    b = torch.as_tensor(b, device=a.device).to(dtype).reshape(-1)
    ra = _average_ranks(a)
    rb = _average_ranks(b)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    return (ra * rb).sum() / torch.sqrt((ra * ra).sum() * (rb * rb).sum())


def entropy_bits(probs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """-sum p log2 p, the per-step entropy column (RISETestFunctions.py:124)."""
    p = probs.clamp(1e-12, 1.0)
    return -(p * torch.log2(p)).sum(dim=dim)
