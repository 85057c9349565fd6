"""Range-count (Def. 1) entries of the stream: the port of
``repro/kernels/density.py``'s ``range_count`` and ``range_count_signed``.

Thin forms over ``ops.local_density_xy`` / ``ops.local_density_delta`` /
``ops.halo_density``: the CUDA kernels ``range_count`` (K4), its worklist
form ``worklist_range_count`` (K8), ``range_count_signed`` (K5), its
worklist form ``worklist_range_count_signed`` (K14), ``halo_range_count``
(K10) and its worklist form ``worklist_halo_range_count`` (K15) on CUDA
tensors, their plain versions on CPU tensors.  The kernels mask their
ragged edges, so nothing is padded.
"""
from __future__ import annotations

from . import ops


def range_count(x, y, d_cut, *, worklist=None):
    """For each row of x (n, d): |{j : ||x_i - y_j|| < d_cut}| over y (m, d),
    as (n,) f32; over a count-only worklist's in-d_cut tile pairs when one
    is given."""
    if worklist is None:
        return ops.local_density_xy(x, y, d_cut)
    return ops.local_density_xy(x, y, d_cut, worklist=worklist)


def range_count_signed(x, y, signs, d_cut, *, worklist=None):
    """For each row of x: sum_j signs[j] * [||x_i - y_j|| < d_cut], f32;
    signs are +1, -1 or 0 (padding rows); over a count-only worklist's
    in-d_cut tile pairs when one is given."""
    if worklist is None:
        return ops.local_density_delta(x, y, signs, d_cut)
    return ops.local_density_delta(x, y, signs, d_cut, worklist=worklist)


def range_count_halo(x, window, starts, ends, d_cut, *, worklist=None):
    """For each row of x: the count of window rows within d_cut inside its
    [start, end) spans ((n, S) int32, window-local), as (n,) f32; over a
    span count worklist's in-d_cut tile pairs when one is given."""
    if worklist is None:
        return ops.halo_density(x, window, starts, ends, d_cut)
    return ops.halo_density(x, window, starts, ends, d_cut,
                            worklist=worklist)
