"""Wrappers around the CUDA kernels of ``csrc/sweep.cu``.

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
from .blocksparse import BLOCK_M, BLOCK_N, Worklist
from .sweep import (FUSED_TOPK, d2cut_of, fused_count_topk_plain,
                    gather_masked_nn_plain, halo_masked_nn_plain,
                    halo_range_count_plain, masked_nn_plain, prefix_nn_plain,
                    range_count_plain, range_count_signed_plain,
                    worklist_count_topk_plain, worklist_masked_nn_plain,
                    worklist_range_count_plain)

__all__ = ["fused_sweep", "dependent_masked", "dependent_prefix",
           "local_density_xy", "local_density_delta",
           "dependent_masked_gather", "halo_density", "halo_dependent",
           "launch_counts", "reset_launch_counts"]

_INT_MAX = 2**31 - 1

# the gated forms of K1 and K3 count apart from the ungated ones, so a run
# shows which form launched
_LAUNCHES = {"fused_count_topk": 0, "worklist_count_topk": 0,
             "fused_count_topk_sel": 0, "worklist_count_topk_sel": 0,
             "masked_nn": 0, "range_count": 0, "range_count_signed": 0,
             "gather_masked_nn": 0, "prefix_nn": 0,
             "worklist_range_count": 0, "worklist_masked_nn": 0,
             "halo_range_count": 0, "halo_masked_nn": 0}


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


def _check_worklist(name: str, x: torch.Tensor, y: torch.Tensor,
                    wl) -> None:
    """A worklist K3, K8 and K9 take: one entry range per row tile of x,
    column tiles of y, on x's device."""
    if not isinstance(wl, Worklist):
        raise TypeError(f"{name}: worklist must be a Worklist, got "
                        f"{type(wl).__name__}")
    nbr = -(-x.shape[0] // BLOCK_N)
    if wl.num_row_tiles != nbr:
        raise ValueError(f"{name}: worklist of {wl.num_row_tiles} row "
                         f"tiles for {x.shape[0]} rows")
    for t, dtype in ((wl.row_ptr, torch.int32), (wl.col_tile, torch.int32),
                     (wl.in_cut, torch.bool), (wl.lb, torch.float32)):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: worklist arrays must be "
                             f"contiguous {dtype} on {x.device}")
    if wl.col_tile.numel() and int(wl.col_tile.max()) * BLOCK_M >= \
            max(y.shape[0], 1):
        raise ValueError(f"{name}: worklist names a column tile past y")


def _check_live(name: str, x: torch.Tensor, wl, live) -> None:
    """``live`` counts come from a CUDA worklist kernel, into (row tiles,)
    int32 on x's device."""
    if live is not None and (
            wl is None or x.device.type != "cuda"
            or live.dtype != torch.int32 or live.device != x.device
            or live.shape != (wl.num_row_tiles,)):
        raise ValueError(f"{name}: live counts come from the CUDA "
                         f"worklist kernel, into (row tiles,) int32 on x's "
                         f"device")


def _check_spans(name: str, x: torch.Tensor, starts, ends) -> None:
    """Halo spans the kernels take: (n, S) int32, contiguous, on x's
    device, S >= 1."""
    for t in (starts, ends):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() != 2 or t.shape[0] != x.shape[0] \
                or t.shape[1] < 1 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: starts and ends must be contiguous "
                             f"({x.shape[0]}, S) int32 on {x.device}")
    if starts.shape != ends.shape:
        raise ValueError(f"{name}: starts {tuple(starts.shape)} and ends "
                         f"{tuple(ends.shape)}")


def _check_sel(y: torch.Tensor, nn_sel) -> torch.Tensor:
    """The kept-k gate the kernels take: (m,) bool or uint8 on y's device,
    contiguous (one byte per column, nonzero where it may enter)."""
    if not isinstance(nn_sel, torch.Tensor) or nn_sel.dtype not in (
            torch.bool, torch.uint8) or nn_sel.shape != (y.shape[0],) \
            or nn_sel.device != y.device:
        raise ValueError(f"fused_sweep: nn_sel must be a ({y.shape[0]},) "
                         f"bool or uint8 tensor on {y.device}")
    return nn_sel.contiguous()


def fused_sweep(x: torch.Tensor, y: torch.Tensor, d_cut, *, nn_sel=None,
                worklist: Worklist | None = None,
                live: torch.Tensor | None = None):
    """Per x-row: the range count over y within ``d_cut`` AND the 8 nearest
    y rows, unmasked by density (the caller resolves the denser mask once
    the counts are complete).

    ``nn_sel`` ((m,) bool or uint8 on y's device) gates the kept 8 to the
    columns where it is nonzero (S-Approx-DPC's representatives); the count
    ignores it.  ``worklist`` (``blocksparse.build_flat_worklist``)
    restricts the sweep to its tile pairs: K3 on a CUDA tensor, its plain
    version on a CPU one; without it, K1 / its plain version sweep all of
    y.  ``live`` (CUDA only, (row tiles,) int32) receives the number of
    entries K3 computed in each row tile.

    Returns (count (n,) f32, topv (n, 8) f32 direct-difference d2,
    topi (n, 8) int32 y-row index, -1 past the columns that may enter).
    """
    _check("fused_sweep", x, y)
    sel = None if nn_sel is None else _check_sel(y, nn_sel)
    if worklist is not None:
        _check_worklist("fused_sweep", x, y, worklist)
    _check_live("fused_sweep", x, worklist, live)
    d2cut = d2cut_of(d_cut)
    if x.device.type == "cpu":
        gate = None if sel is None else sel.bool()
        if worklist is None:
            count, topv, topi = fused_count_topk_plain(x, y, d2cut, sel=gate)
        else:
            count, topv, topi = worklist_count_topk_plain(x, y, d2cut,
                                                          worklist, sel=gate)
        return count.to(torch.float32), topv, topi
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    count = torch.empty((n,), dtype=torch.int32, device=x.device)
    topv = torch.empty((n, FUSED_TOPK), dtype=torch.float32, device=x.device)
    topi = torch.empty((n, FUSED_TOPK), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        sel_ptr = 0 if sel is None else sel.data_ptr()
        with torch.cuda.device(x.device):
            if worklist is None:
                name = "fused_count_topk"
                code = lib.repro_fused_count_topk(
                    x.data_ptr(), y.data_ptr(), n, m, d, d2cut, sel_ptr,
                    count.data_ptr(), topv.data_ptr(), topi.data_ptr(),
                    _stream(x))
            else:
                name = "worklist_count_topk"
                code = lib.repro_worklist_count_topk(
                    x.data_ptr(), y.data_ptr(), n, m, d, d2cut, sel_ptr,
                    worklist.row_ptr.data_ptr(), worklist.col_tile.data_ptr(),
                    worklist.in_cut.data_ptr(), worklist.lb.data_ptr(),
                    count.data_ptr(), topv.data_ptr(), topi.data_ptr(),
                    0 if live is None else live.data_ptr(), _stream(x))
        build.check(lib, name, code)
        if sel is not None:
            name += "_sel"
        _LAUNCHES[name] += 1
    return count.to(torch.float32), topv, topi


def dependent_masked(x: torch.Tensor, x_key: torch.Tensor, y: torch.Tensor,
                     y_key: torch.Tensor, *, worklist: Worklist | None = None,
                     live: torch.Tensor | None = None):
    """Per x-row: the nearest y row with ``y_key > x_key`` (Def. 2).

    ``worklist`` (a best-1 ring, ``blocksparse.build_flat_worklist(
    nn="best1")``) walks each row tile's tile pairs in ascending lb and
    stops where no row can improve: K9 on a CUDA tensor, its plain version
    on a CPU one; without it, K2 / its plain version scan all of y.
    ``live`` (CUDA only, (row tiles,) int32) receives the number of
    entries K9 computed in each row tile.

    Returns (delta (n,) f32, parent (n,) int32); (inf, -1) where no y row
    is strictly denser.
    """
    _check("dependent_masked", x, y, x_key, y_key)
    if worklist is not None:
        _check_worklist("dependent_masked", x, y, worklist)
    _check_live("dependent_masked", x, worklist, live)
    if x.device.type == "cpu":
        if worklist is None:
            best, arg = masked_nn_plain(x, x_key, y, y_key)
        else:
            best, arg = worklist_masked_nn_plain(x, x_key, y, y_key,
                                                 worklist)
        return torch.sqrt(best), arg
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    best = torch.empty((n,), dtype=torch.float32, device=x.device)
    arg = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            if worklist is None:
                name = "masked_nn"
                code = lib.repro_masked_nn(
                    x.data_ptr(), x_key.data_ptr(), y.data_ptr(),
                    y_key.data_ptr(), n, m, d, best.data_ptr(),
                    arg.data_ptr(), _stream(x))
            else:
                name = "worklist_masked_nn"
                code = lib.repro_worklist_masked_nn(
                    x.data_ptr(), x_key.data_ptr(), y.data_ptr(),
                    y_key.data_ptr(), n, m, d, worklist.row_ptr.data_ptr(),
                    worklist.col_tile.data_ptr(), worklist.lb.data_ptr(),
                    best.data_ptr(), arg.data_ptr(),
                    0 if live is None else live.data_ptr(), _stream(x))
        build.check(lib, name, code)
        _LAUNCHES[name] += 1
    return torch.sqrt(best), arg


def dependent_prefix(points_sorted_desc: torch.Tensor):
    """Per row of a table sorted by descending density key: the nearest
    earlier row (Def. 2 with "denser" read as "earlier"), the lowest index
    among equal distances.

    Returns (delta (n,) f32, parent (n,) int32); (inf, -1) for row 0.
    """
    x = points_sorted_desc
    _check("dependent_prefix", x, x)
    if x.device.type == "cpu":
        best, arg = prefix_nn_plain(x)
        return torch.sqrt(best), arg
    n, d = x.shape
    delta = torch.empty((n,), dtype=torch.float32, device=x.device)
    arg = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            code = lib.repro_prefix_nn(x.data_ptr(), n, d, delta.data_ptr(),
                                       arg.data_ptr(), _stream(x))
        build.check(lib, "prefix_nn", code)
        _LAUNCHES["prefix_nn"] += 1
    return delta, arg


def local_density_xy(x: torch.Tensor, y: torch.Tensor, d_cut, *,
                     worklist: Worklist | None = None):
    """Per x-row: the count of y rows within ``d_cut`` (Def. 1 with query
    rows apart from the candidates), as (n,) f32.  ``worklist`` (a
    count-only worklist, ``blocksparse.build_flat_worklist(nn=None)``)
    restricts the count to its ``in_cut`` tile pairs: K8 on a CUDA tensor,
    its plain version on a CPU one; without it, K4 / its plain version."""
    _check("local_density_xy", x, y)
    if worklist is not None:
        _check_worklist("local_density_xy", x, y, worklist)
    d2cut = d2cut_of(d_cut)
    if x.device.type == "cpu":
        if worklist is None:
            return range_count_plain(x, y, d2cut).to(torch.float32)
        return worklist_range_count_plain(x, y, d2cut,
                                          worklist).to(torch.float32)
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            if worklist is None:
                name = "range_count"
                code = lib.repro_range_count(
                    x.data_ptr(), y.data_ptr(), n, m, d, d2cut,
                    count.data_ptr(), _stream(x))
            else:
                name = "worklist_range_count"
                code = lib.repro_worklist_range_count(
                    x.data_ptr(), y.data_ptr(), n, m, d, d2cut,
                    worklist.row_ptr.data_ptr(), worklist.col_tile.data_ptr(),
                    worklist.in_cut.data_ptr(), count.data_ptr(), _stream(x))
        build.check(lib, name, code)
        if m or worklist is not None:  # K4 launches nothing for m == 0
            _LAUNCHES[name] += 1
    return count.to(torch.float32)


def local_density_delta(x: torch.Tensor, batch: torch.Tensor,
                        signs: torch.Tensor, d_cut):
    """Per x-row: the sum of ``signs[b]`` over the batch rows within
    ``d_cut``, as (n,) f32 — the sliding-window rho repair, with +1 for an
    inserted row, -1 for an evicted one and 0 for padding.  The signs must
    be +1, -1 or 0: the sum is then exact in any order."""
    _check("local_density_delta", batch, x, signs)   # signs: one per batch row
    d2cut = d2cut_of(d_cut)
    if x.device.type == "cpu":
        return range_count_signed_plain(x, batch, signs, d2cut)
    n, m, d = x.shape[0], batch.shape[0], x.shape[1]
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            code = lib.repro_range_count_signed(
                x.data_ptr(), batch.data_ptr(), signs.data_ptr(), n, m, d,
                d2cut, out.data_ptr(), _stream(x))
        build.check(lib, "range_count_signed", code)
        _LAUNCHES["range_count_signed"] += 1
    return out


def dependent_masked_gather(table: torch.Tensor, keys: torch.Tensor,
                            q_slots: torch.Tensor):
    """Per slot s of ``q_slots``: the nearest table row with a key strictly
    greater than ``keys[s]`` (Def. 2 for the row subset ``table[q_slots]``,
    the rows gathered inside the kernel).  Slots outside [0, len(table))
    are padding.

    Returns (delta (q,) f32, parent (q,) int32); (inf, -1) where no row is
    strictly denser and for padding slots.
    """
    _check("dependent_masked_gather", table, table, keys)
    if not isinstance(q_slots, torch.Tensor) or q_slots.dim() != 1 \
            or q_slots.dtype not in (torch.int32, torch.int64) \
            or q_slots.device != table.device:
        raise ValueError("dependent_masked_gather: q_slots must be a 1-D "
                         f"int32/int64 tensor on {table.device}")
    if table.device.type == "cpu":
        best, arg = gather_masked_nn_plain(table, keys, q_slots)
        return torch.sqrt(best), arg
    q, m, d = q_slots.numel(), table.shape[0], table.shape[1]
    # any slot past the table is padding: clamp into int32 range first
    slots = q_slots.clamp(-1, m).to(torch.int32).contiguous()
    packed = torch.empty((q,), dtype=torch.int64, device=table.device)
    best = torch.empty((q,), dtype=torch.float32, device=table.device)
    arg = torch.empty((q,), dtype=torch.int32, device=table.device)
    if q:
        lib = build.load_library()
        with torch.cuda.device(table.device):
            code = lib.repro_gather_masked_nn(
                table.data_ptr(), keys.data_ptr(), slots.data_ptr(), q, m, d,
                packed.data_ptr(), best.data_ptr(), arg.data_ptr(),
                _stream(table))
        build.check(lib, "gather_masked_nn", code)
        if m:                # for m == 0 only the decode epilogue runs
            _LAUNCHES["gather_masked_nn"] += 1
    return torch.sqrt(best), arg


def halo_density(x: torch.Tensor, window: torch.Tensor,
                 starts: torch.Tensor, ends: torch.Tensor, d_cut):
    """Per x-row: the count of window rows within ``d_cut`` inside the
    row's ``[start, end)`` spans (``starts``/``ends``: (n, S) int32
    window-local bounds, pairwise disjoint per row; empty, negative and
    past-the-window parts count nothing), as (n,) f32.  K10 on a CUDA
    tensor, its plain version on a CPU one."""
    _check("halo_density", x, window)
    _check_spans("halo_density", x, starts, ends)
    d2cut = d2cut_of(d_cut)
    if x.device.type == "cpu":
        return halo_range_count_plain(x, window, starts, ends,
                                      d2cut).to(torch.float32)
    (n, d), w, s = x.shape, window.shape[0], starts.shape[1]
    count = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            code = lib.repro_halo_range_count(
                x.data_ptr(), window.data_ptr(), starts.data_ptr(),
                ends.data_ptr(), n, w, d, s, d2cut, count.data_ptr(),
                _stream(x))
        build.check(lib, "halo_range_count", code)
        _LAUNCHES["halo_range_count"] += 1
    return count.to(torch.float32)


def halo_dependent(x: torch.Tensor, x_key: torch.Tensor,
                   window: torch.Tensor, w_key: torch.Tensor,
                   starts: torch.Tensor, ends: torch.Tensor, d_cut):
    """Per x-row: the nearest window row inside the row's spans that is
    strictly denser AND within ``d_cut`` (stencil semantics; the spans as
    in ``halo_density``).  K11 on a CUDA tensor, its plain version on a
    CPU one.

    Returns (delta (n,) f32, parent (n,) int32 window index, found (n,)
    bool); (inf, -1, False) where no window row qualifies.
    """
    _check("halo_dependent", x, window, x_key, w_key)
    _check_spans("halo_dependent", x, starts, ends)
    d2cut = d2cut_of(d_cut)
    if x.device.type == "cpu":
        best, arg = halo_masked_nn_plain(x, x_key, window, w_key, starts,
                                         ends, d2cut)
        return torch.sqrt(best), arg, torch.isfinite(best)
    (n, d), w, s = x.shape, window.shape[0], starts.shape[1]
    delta = torch.empty((n,), dtype=torch.float32, device=x.device)
    arg = torch.empty((n,), dtype=torch.int32, device=x.device)
    found = torch.empty((n,), dtype=torch.bool, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            code = lib.repro_halo_masked_nn(
                x.data_ptr(), x_key.data_ptr(), window.data_ptr(),
                w_key.data_ptr(), starts.data_ptr(), ends.data_ptr(), n, w,
                d, s, d2cut, delta.data_ptr(), arg.data_ptr(),
                found.data_ptr(), _stream(x))
        build.check(lib, "halo_masked_nn", code)
        _LAUNCHES["halo_masked_nn"] += 1
    return delta, arg, found


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
