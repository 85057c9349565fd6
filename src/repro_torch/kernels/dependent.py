"""Dependent-point (Def. 2) kernels: the strictly-denser nearest neighbour.

``masked_min_dist`` is the rectangular strictly-denser NN (the reference's
``repro/kernels/dependent.py::masked_min_dist``), a thin form over
``ops.dependent_masked``: the CUDA kernel ``masked_nn`` on CUDA tensors,
its plain version on CPU tensors.  ``masked_min_dist_gather`` is the same
NN for a row subset of one table (the reference's ``sweep.gather_nn``):
``ops.dependent_masked_gather``, the CUDA kernel ``gather_masked_nn``
(K6) on the gathered rows.  ``prefix_min_dist`` is the triangular
form, the NN among earlier rows of a density-sorted table:
``ops.dependent_prefix``, the CUDA kernel ``prefix_nn``.  On a best-1
ring worklist ``masked_min_dist`` is the CUDA kernel
``worklist_masked_nn`` (K9); ``masked_min_dist_halo`` is the NN within
d_cut inside per-row spans of a halo window: ``ops.halo_dependent``, the
CUDA kernel ``halo_masked_nn`` (K11), or ``worklist_halo_masked_nn`` (K16)
on a halo ring worklist.
"""
from __future__ import annotations

from . import ops


def prefix_min_dist(pts_sorted_desc):
    """min_{j<i} ||p_i - p_j|| and its argmin, rows sorted by descending
    key.  Returns (delta (n,), parent (n,) int32); (inf, -1) for row 0."""
    return ops.dependent_prefix(pts_sorted_desc)


def masked_min_dist(x, x_key, y, y_key, *, worklist=None):
    """NN among y rows with ``y_key > x_key``, per x row, walking a best-1
    ring worklist when one is given.  Returns (delta (n,), parent (n,)
    int32); (inf, -1) where none qualifies."""
    if worklist is None:
        return ops.dependent_masked(x, x_key, y, y_key)
    return ops.dependent_masked(x, x_key, y, y_key, worklist=worklist)


def masked_min_dist_halo(x, x_key, window, w_key, starts, ends, d_cut, *,
                         worklist=None):
    """NN among the window rows inside each x row's spans that are
    strictly denser and within d_cut, walking a halo ring worklist when one
    is given.  Returns (delta (n,), parent (n,) int32 window index, found
    (n,) bool)."""
    if worklist is None:
        return ops.halo_dependent(x, x_key, window, w_key, starts, ends,
                                  d_cut)
    return ops.halo_dependent(x, x_key, window, w_key, starts, ends, d_cut,
                              worklist=worklist)


def masked_min_dist_gather(table, keys, q_slots):
    """NN among table rows with a key strictly greater than
    ``keys[q_slots]``, per slot; slots outside [0, len(table)) are padding.
    Returns (delta (q,), parent (q,) int32); (inf, -1) where none
    qualifies."""
    return ops.dependent_masked_gather(table, keys, q_slots)
