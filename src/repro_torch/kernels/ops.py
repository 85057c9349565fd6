"""Wrappers around the two CUDA kernels of ``csrc/sweep.cu``.

A CUDA tensor goes to the kernel, a CPU tensor to the kernel's plain
version in ``kernels/sweep.py``; there is no other route and no fallback.
Each wrapper checks device, dtype (f32), contiguity and shape, allocates the
outputs with ``torch.empty``, launches on the current stream, and adds one
to its kernel's plain-integer launch count where it launches, so a run can
show that its main path went through the kernels.  The counts live in one
dict keyed by kernel name (``launch_counts()``), so a caller may wrap a
wrapper without losing them.
"""
from __future__ import annotations

import torch

from . import build
from .sweep import (FUSED_TOPK, d2cut_of, fused_count_topk_plain,
                    masked_nn_plain)

__all__ = ["fused_sweep", "dependent_masked", "launch_counts",
           "reset_launch_counts"]

_INT_MAX = 2**31 - 1

_LAUNCHES = {"fused_count_topk": 0, "masked_nn": 0}


def _check(name: str, x: torch.Tensor, y: torch.Tensor, *vecs) -> None:
    """Inputs a kernel takes: 2-D f32 x (n, d) and y (m, d), 1-D f32 key
    vectors matching them, all contiguous on one CPU or CUDA device."""
    for t in (x, y, *vecs):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on {x.device} and {t.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"{name}: expected x (n, d) and y (m, d), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    d = x.shape[1]
    if d < 1:
        raise ValueError(f"{name}: points need at least one coordinate")
    if max(x.shape[0], y.shape[0]) * d > _INT_MAX:
        raise ValueError(f"{name}: {max(x.shape[0], y.shape[0])} rows of "
                         f"{d} coordinates exceed the kernels' int32 indexing")
    for v, rows in zip(vecs, (x.shape[0], y.shape[0])):
        if v.shape != (rows,):
            raise ValueError(f"{name}: key of shape {tuple(v.shape)} for "
                             f"{rows} rows")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_sweep(x: torch.Tensor, y: torch.Tensor, d_cut, *, nn_sel=None):
    """Per x-row: the range count over y within ``d_cut`` AND the 8 nearest
    y rows, unmasked by density (the caller resolves the denser mask once
    the counts are complete).

    Returns (count (n,) f32, topv (n, 8) f32 direct-difference d2,
    topi (n, 8) int32 y-row index, -1 where m < 8).
    """
    if nn_sel is not None:
        raise NotImplementedError(
            "fused_sweep(nn_sel=...) is S-Approx-DPC's kept-k gate; it is "
            "ported with the S-Approx slice (ROADMAP Queue A item 4)")
    _check("fused_sweep", x, y)
    d2cut = d2cut_of(d_cut)
    if x.device.type == "cpu":
        count, topv, topi = fused_count_topk_plain(x, y, d2cut)
        return count.to(torch.float32), topv, topi
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    count = torch.empty((n,), dtype=torch.int32, device=x.device)
    topv = torch.empty((n, FUSED_TOPK), dtype=torch.float32, device=x.device)
    topi = torch.empty((n, FUSED_TOPK), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            code = lib.repro_fused_count_topk(
                x.data_ptr(), y.data_ptr(), n, m, d, d2cut, count.data_ptr(),
                topv.data_ptr(), topi.data_ptr(), _stream(x))
        build.check(lib, "fused_count_topk", code)
        _LAUNCHES["fused_count_topk"] += 1
    return count.to(torch.float32), topv, topi


def dependent_masked(x: torch.Tensor, x_key: torch.Tensor, y: torch.Tensor,
                     y_key: torch.Tensor):
    """Per x-row: the nearest y row with ``y_key > x_key`` (Def. 2).

    Returns (delta (n,) f32, parent (n,) int32); (inf, -1) where no y row
    is strictly denser.
    """
    _check("dependent_masked", x, y, x_key, y_key)
    if x.device.type == "cpu":
        best, arg = masked_nn_plain(x, x_key, y, y_key)
        return torch.sqrt(best), arg
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    best = torch.empty((n,), dtype=torch.float32, device=x.device)
    arg = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            code = lib.repro_masked_nn(
                x.data_ptr(), x_key.data_ptr(), y.data_ptr(), y_key.data_ptr(),
                n, m, d, best.data_ptr(), arg.data_ptr(), _stream(x))
        build.check(lib, "masked_nn", code)
        _LAUNCHES["masked_nn"] += 1
    return torch.sqrt(best), arg


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
