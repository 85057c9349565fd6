"""Clustering quality metrics: the Rand index (paper Tables 2-5).

A numpy copy of ``repro/core/metrics.py``; labels may be numpy arrays or
tensors on any device (they are read on the host).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["rand_index"]


def _host(labels) -> np.ndarray:
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    return np.asarray(labels).astype(np.int64)


def rand_index(labels_a, labels_b) -> float:
    """Rand index between two labelings; noise (-1) is treated as a label.

    Computed from the contingency table: RI = 1 - (A + B - 2*AB) / C(n,2)
    where A/B are same-pair counts of each labeling and AB of the
    intersection.  The table is kept sparse (its nonzero cells only): two
    labelings with thousands and hundreds of thousands of labels would
    make a dense one tens of GB.
    """
    a, b = _host(labels_a), _host(labels_b)
    if a.shape != b.shape:
        raise ValueError(f"labelings of shapes {a.shape} and {b.shape}")
    n = a.shape[0]
    if n < 2:
        return 1.0
    _, a = np.unique(a, return_inverse=True)
    _, b = np.unique(b, return_inverse=True)
    _, cells = np.unique(a.astype(np.int64) * (b.max() + 1) + b,
                         return_counts=True)

    def comb2(x):
        return (x * (x - 1)) // 2

    sum_ab = comb2(cells.astype(np.int64)).sum()
    sum_a = comb2(np.bincount(a).astype(np.int64)).sum()
    sum_b = comb2(np.bincount(b).astype(np.int64)).sum()
    total = comb2(np.int64(n))
    return float((total + 2 * sum_ab - sum_a - sum_b) / total)
