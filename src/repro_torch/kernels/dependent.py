"""Dependent-point (Def. 2) kernels: the strictly-denser nearest neighbour.

``masked_min_dist`` is the rectangular strictly-denser NN (the reference's
``repro/kernels/dependent.py::masked_min_dist``), a thin form over
``ops.dependent_masked``: the CUDA kernel ``masked_nn`` on CUDA tensors,
its plain version on CPU tensors.  ``masked_min_dist_gather`` is the same
NN for a row subset of one table, gathered inside the kernel (the
reference's ``sweep.gather_nn``): ``ops.dependent_masked_gather``, the CUDA
kernel ``gather_masked_nn``.  ``prefix_min_dist`` is the triangular
form, the NN among earlier rows of a density-sorted table:
``ops.dependent_prefix``, the CUDA kernel ``prefix_nn``.  The halo variant
is still to be ported (ROADMAP Queue B).
"""
from __future__ import annotations

from . import ops


def prefix_min_dist(pts_sorted_desc):
    """min_{j<i} ||p_i - p_j|| and its argmin, rows sorted by descending
    key.  Returns (delta (n,), parent (n,) int32); (inf, -1) for row 0."""
    return ops.dependent_prefix(pts_sorted_desc)


def masked_min_dist(x, x_key, y, y_key):
    """NN among y rows with ``y_key > x_key``, per x row.  Returns
    (delta (n,), parent (n,) int32); (inf, -1) where none qualifies."""
    return ops.dependent_masked(x, x_key, y, y_key)


def masked_min_dist_gather(table, keys, q_slots):
    """NN among table rows with a key strictly greater than
    ``keys[q_slots]``, per slot; slots outside [0, len(table)) are padding.
    Returns (delta (q,), parent (q,) int32); (inf, -1) where none
    qualifies."""
    return ops.dependent_masked_gather(table, keys, q_slots)
