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
    intersection.
    """
    a, b = _host(labels_a), _host(labels_b)
    if a.shape != b.shape:
        raise ValueError(f"labelings of shapes {a.shape} and {b.shape}")
    n = a.shape[0]
    if n < 2:
        return 1.0
    _, a = np.unique(a, return_inverse=True)
    _, b = np.unique(b, return_inverse=True)
    ka, kb = a.max() + 1, b.max() + 1
    cont = np.zeros((ka, kb), dtype=np.int64)
    np.add.at(cont, (a, b), 1)

    def comb2(x):
        return (x * (x - 1)) // 2

    sum_ab = comb2(cont).sum()
    sum_a = comb2(cont.sum(axis=1)).sum()
    sum_b = comb2(cont.sum(axis=0)).sum()
    total = comb2(np.int64(n))
    return float((total + 2 * sum_ab - sum_a - sum_b) / total)
