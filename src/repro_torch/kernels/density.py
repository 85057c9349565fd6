"""Range-count (Def. 1) entries of the stream: the port of
``repro/kernels/density.py``'s ``range_count`` and ``range_count_signed``.

Thin forms over ``ops.local_density_xy`` / ``ops.local_density_delta``:
the CUDA kernels ``range_count`` (K4) and ``range_count_signed`` (K5) on
CUDA tensors, their plain versions on CPU tensors.  The kernels mask their
ragged edges, so nothing is padded.  The worklist forms and
``range_count_halo`` are still to be ported (ROADMAP Queue B).
"""
from __future__ import annotations

from . import ops


def range_count(x, y, d_cut):
    """For each row of x (n, d): |{j : ||x_i - y_j|| < d_cut}| over y (m, d),
    as (n,) f32."""
    return ops.local_density_xy(x, y, d_cut)


def range_count_signed(x, y, signs, d_cut):
    """For each row of x: sum_j signs[j] * [||x_i - y_j|| < d_cut], f32;
    signs are +1, -1 or 0 (padding rows)."""
    return ops.local_density_delta(x, y, signs, d_cut)
