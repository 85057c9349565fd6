"""Sweep constants and the plain PyTorch versions of the two hand-written
CUDA kernels in ``csrc/sweep.cu``.

The reference (``repro/kernels/sweep.py``) builds every DPC primitive from
one Pallas tile sweep over expanded-form distances |x|^2+|y|^2-2x.y fed to
the TPU's matrix unit, then re-ranks candidates in direct-difference form to
repair the expanded form's f32 cancellation.  On Hopper the f32 contract
rules out TF32 and the inner dimension is d = 2..8, so the matrix unit buys
nothing: both kernels compute **direct-difference** f32 distances on the CUDA
cores, and no re-rank is needed.

Arithmetic contract shared by the kernels and the plain versions here: the
squared distance of a pair is ``(x0-y0)^2``, then ``+ (xk-yk)^2`` for
k = 1..d-1 in order, each subtraction, product and sum rounded once
(``__fsub_rn``/``__fmul_rn``/``__fadd_rn`` in CUDA, one torch op each here),
so a kernel and its plain version agree bit for bit on the card.
"""
from __future__ import annotations

import numpy as np
import torch

# The admission bound: a real point at or beyond it is refused at the
# boundary (resilience.sanitize).  The CUDA kernels mask ragged edges
# themselves and never pad with it.
PAD_COORD = 1e9

# kept candidates per row in the fused count + kept-k sweep (compiled into
# csrc/sweep.cu as kTopK)
FUSED_TOPK = 8

# plain versions work on row blocks of at most this many pair distances
_PLAIN_PAIRS = 1 << 24


def d2cut_of(d_cut) -> float:
    """The f32 threshold ``f32(d_cut)**2``, rounded once, as the reference
    computes it (``jnp.asarray(d_cut, f32) ** 2``)."""
    c = np.float32(float(d_cut))
    return float(c * c)


def direct_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances between broadcast rows of ``a`` and ``b`` (last
    axis = coordinates), summed over dims 0..d-1 in order, one rounding per
    operation: the kernels' arithmetic."""
    d2 = None
    for k in range(a.shape[-1]):
        diff = a[..., k] - b[..., k]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def _row_block(m: int) -> int:
    return max(1, _PLAIN_PAIRS // max(m, 1))


def fused_count_topk_plain(x: torch.Tensor, y: torch.Tensor, d2cut: float,
                           k: int = FUSED_TOPK):
    """Per x-row: the count of y rows with d2 < d2cut (i32), and the k
    nearest (d2, index) pairs, lexicographic on (d2, index) — a stable sort
    over index-ordered columns.  Slots past m hold (+inf, -1)."""
    n, m = x.shape[0], y.shape[0]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    topv = torch.full((n, k), float("inf"), dtype=torch.float32,
                      device=x.device)
    topi = torch.full((n, k), -1, dtype=torch.int32, device=x.device)
    kk = min(k, m)
    if m == 0:
        return count, topv, topi
    step = _row_block(m)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        d2 = direct_d2(x[r0:r1, None, :], y[None, :, :])
        count[r0:r1] = (d2 < d2cut).sum(dim=1, dtype=torch.int32)
        v, idx = torch.sort(d2, dim=1, stable=True)
        topv[r0:r1, :kk] = v[:, :kk]
        topi[r0:r1, :kk] = idx[:, :kk].to(torch.int32)
    return count, topv, topi


def masked_nn_plain(x: torch.Tensor, x_key: torch.Tensor, y: torch.Tensor,
                    y_key: torch.Tensor):
    """Per x-row: the nearest y row with ``y_key > x_key`` as (best d2 f32,
    index i32), the lowest index among equal distances; (+inf, -1) where no
    row qualifies."""
    n, m = x.shape[0], y.shape[0]
    best = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=x.device)
    arg = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    if m == 0:
        return best, arg
    cols = torch.arange(m, device=x.device)
    step = _row_block(m)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        d2 = direct_d2(x[r0:r1, None, :], y[None, :, :])
        d2 = torch.where(y_key[None, :] > x_key[r0:r1, None], d2,
                         float("inf"))
        b = d2.min(dim=1).values
        a = torch.where(d2 == b[:, None], cols, m).min(dim=1).values
        best[r0:r1] = b
        arg[r0:r1] = torch.where(torch.isinf(b), -1, a).to(torch.int32)
    return best, arg
