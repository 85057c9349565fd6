"""Direct-difference oracles of the three DPC primitives: the port of
``repro/kernels/ref.py``, on whatever device the tensors are on.

Each is the whole (n, m) distance table at once in the reference; here the
plain versions of ``kernels/sweep.py`` compute the same answers a row
block at a time, with the kernels' arithmetic (``sweep.direct_d2``).
"""
from __future__ import annotations

import torch

from .sweep import d2cut_of, masked_nn_plain, prefix_nn_plain, \
    range_count_plain


def _rooted(best: torch.Tensor, arg: torch.Tensor):
    """(sqrt(best), arg), arg -1 wherever best is not finite."""
    return torch.sqrt(best), torch.where(torch.isfinite(best), arg,
                                         -1).to(torch.int32)


def range_count_ref(x: torch.Tensor, y: torch.Tensor,
                    d_cut: float) -> torch.Tensor:
    """For each row of x: |{j : ||x_i - y_j|| < d_cut}| (int32)."""
    return range_count_plain(x, y, d2cut_of(d_cut))


def prefix_min_dist_ref(pts: torch.Tensor):
    """Prefix NN: for each i, min_{j<i} ||p_i - p_j|| and its argmin (the
    lowest index among equal distances; -1 where none is finite).

    Rows must be sorted by descending density key, so j < i means "j is
    denser" (Ex-DPC's incremental-tree invariant as a static iteration
    space)."""
    return _rooted(*prefix_nn_plain(pts))


def masked_min_dist_ref(x, x_key, y, y_key):
    """For each row of x: the nearest y with y_key strictly greater, and its
    index (the lowest among equal distances; -1 where none)."""
    return _rooted(*masked_nn_plain(x, x_key, y, y_key))
