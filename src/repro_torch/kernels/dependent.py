"""Dependent-point (Def. 2) kernels: the strictly-denser nearest neighbour.

``masked_min_dist`` is the rectangular strictly-denser NN (the reference's
``repro/kernels/dependent.py::masked_min_dist``), a thin form over
``ops.dependent_masked``: the CUDA kernel ``masked_nn`` on CUDA tensors,
its plain version on CPU tensors.  The triangular ``prefix_min_dist`` and
the halo variant are still to be ported (ROADMAP Queue B).
"""
from __future__ import annotations

from . import ops


def masked_min_dist(x, x_key, y, y_key):
    """NN among y rows with ``y_key > x_key``, per x row.  Returns
    (delta (n,), parent (n,) int32); (inf, -1) where none qualifies."""
    return ops.dependent_masked(x, x_key, y, y_key)
