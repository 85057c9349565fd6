"""Wrappers around the CUDA kernels of ``csrc/sweep.cu``.

A CUDA tensor goes to the kernel, a CPU tensor to the kernel's plain
version in ``kernels/sweep.py``; there is no other route and no fallback.
Each wrapper checks device, dtype (f32), contiguity and shape, allocates the
outputs with ``torch.empty``, launches on the current stream, and adds one
to its kernel's plain-integer launch count where it launches, so a run can
show that its main path went through the kernels.  The counts live in one
dict keyed by kernel name (``launch_counts()``), so a caller may wrap a
wrapper without losing them; ``suspend_launch_counts()`` keeps a block's
launches out of them.  Each wrapper also reports its call, on either
device, to the analyzer's launch record (``analysis.record``), which is a
no-op unless a recorder is active.
"""
from __future__ import annotations

import contextlib

import torch

from ..analysis import record
from . import build, packing
from .blocksparse import BLOCK_M, BLOCK_N, Worklist
from .sweep import (FUSED_TOPK, d2cut_of, fused_count_topk_bf16_plain,
                    fused_count_topk_plain, gather_masked_nn_plain,
                    halo_masked_nn_plain, halo_range_count_plain,
                    masked_nn_plain, prefix_nn_plain, range_count_plain,
                    range_count_signed_plain, worklist_count_topk_bf16_plain,
                    worklist_count_topk_plain,
                    worklist_halo_masked_nn_plain,
                    worklist_halo_range_count_plain, worklist_masked_nn_plain,
                    worklist_range_count_plain,
                    worklist_range_count_signed_plain)

__all__ = ["fused_sweep", "dependent_masked", "dependent_prefix",
           "local_density_xy", "local_density_delta",
           "dependent_masked_gather", "gather_form", "gather_layout",
           "gather_scan", "halo_density", "halo_layout", "halo_dependent",
           "launch_counts", "reset_launch_counts", "suspend_launch_counts"]

_INT_MAX = 2**31 - 1

# the gated forms of K1/K3 and K12/K13 count apart from the ungated ones,
# so a run shows which form launched
_LAUNCHES = {"fused_count_topk": 0, "worklist_count_topk": 0,
             "fused_count_topk_sel": 0, "worklist_count_topk_sel": 0,
             "fused_count_topk_bf16": 0, "worklist_count_topk_bf16": 0,
             "fused_count_topk_bf16_sel": 0,
             "worklist_count_topk_bf16_sel": 0,
             "masked_nn": 0, "range_count": 0, "range_count_signed": 0,
             "gather_masked_nn": 0, "prefix_nn": 0,
             "worklist_range_count": 0, "worklist_masked_nn": 0,
             "worklist_range_count_signed": 0,
             "halo_range_count": 0, "halo_masked_nn": 0,
             "worklist_halo_range_count": 0, "worklist_halo_masked_nn": 0}

PRECISIONS = ("f32", "bf16")

# K12/K13 stage a block's query rows as bf16 in shared memory: at most this
# many coordinates (kBfMaxD in csrc/sweep.cu)
BF16_MAX_D = 224

# K2's work list: at least this many column chunks per SM (about 8 waves of
# the blocks an SM holds), each at least NN_MIN_CHUNK columns long
NN_ITEMS_PER_SM = 32
NN_MIN_CHUNK = 4096

# K10/K11/K15/K16 cut a piece whose work is above 1/(SMs x this) of the
# call's into splits: about eight times the warps an SM holds
HALO_SPLITS_PER_SM = 384

# K6 takes its prefix form from this many slots on, its key form below
# (gather_form).  On an H100 (PERF.md §6), on the Airline stream's
# maxima against its 2^20-row window: key 1.96-2.13 ms against prefix
# 2.27-2.41 at 4,096 slots, 3.60-3.64 against 3.61-3.62 at 8,192, 6.42-6.76
# against 5.71-5.77 at 16,384; on random slots of the mixture's window
# 1.51-1.56 against 1.96-1.97 at 4,096 and 5.02-5.04 against 4.08-4.26 at
# 16,384.
K6_PREFIX_ROWS = 8192


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


def _ptr(t: torch.Tensor | None) -> int:
    """An optional tensor's address, 0 (a null pointer) for None."""
    return 0 if t is None else t.data_ptr()


def _check_worklist(name: str, x: torch.Tensor, y: torch.Tensor,
                    wl) -> None:
    """A worklist K3, K8, K9, K13, K14, K15 and K16 take: one entry range
    per row tile of x, column tiles of y (the halo window for K15/K16), on
    x's device."""
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


def _check_live(name: str, x: torch.Tensor, wl, live,
                walks: bool = False) -> None:
    """``live`` counts come from a CUDA worklist kernel, into (row tiles,)
    int32 on x's device; (row tiles, 2) where ``walks`` (K9, K16: the
    entries computed and the longest walk)."""
    tiles = None if wl is None else wl.num_row_tiles
    shape = (tiles, 2) if walks else (tiles,)
    if live is not None and (
            wl is None or x.device.type != "cuda"
            or live.dtype != torch.int32 or live.device != x.device
            or live.shape != shape or not live.is_contiguous()):
        form = "(row tiles, 2)" if walks else "(row tiles,)"
        raise ValueError(f"{name}: live counts come from the CUDA "
                         f"worklist kernel, into {form} int32 on x's "
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
                live: torch.Tensor | None = None,
                ran: torch.Tensor | None = None,
                inserted: torch.Tensor | None = None,
                precision: str = "f32"):
    """Per x-row: the range count over y within ``d_cut`` AND the 8 nearest
    y rows, unmasked by density (the caller resolves the denser mask once
    the counts are complete).

    ``nn_sel`` ((m,) bool or uint8 on y's device) gates the kept 8 to the
    columns where it is nonzero (S-Approx-DPC's representatives); the count
    ignores it.  ``worklist`` (``blocksparse.build_flat_worklist``)
    restricts the sweep to its tile pairs.  ``live`` (CUDA only, (row
    tiles,) int32) receives the number of entries the worklist kernel
    computed in each row tile; ``ran`` (CUDA only, f32 on a worklist,
    (row tiles, 2) int64 zeros) receives the pairs K3 ran in each row
    tile's two phases (``kernels/packing.py``); ``inserted`` (CUDA only,
    dense bf16, (n,) int32 zeros) the kept-list insertions K12 made for
    each row, summed over the lanes that share it.

    ``precision="f32"``: direct-difference d2, K1 (K3 on a worklist) on a
    CUDA tensor, their plain versions on a CPU one.  ``precision="bf16"``:
    the reference's expanded form with a bf16 cross term
    (``sweep.expanded_d2_bf16``), K12 (K13 on a worklist, with the
    reference's NN-liveness) on a CUDA tensor, their plain versions on a
    CPU one.

    Returns (count (n,) f32, topv (n, 8) f32 d2 — direct-difference under
    f32, the bf16 expanded form under bf16, where values may be negative —,
    topi (n, 8) int32 y-row index, -1 past the columns that may enter).
    """
    _check("fused_sweep", x, y)
    if precision not in PRECISIONS:
        raise ValueError(f"fused_sweep: precision must be one of "
                         f"{PRECISIONS}, got {precision!r}")
    bf16 = precision == "bf16"
    sel = None if nn_sel is None else _check_sel(y, nn_sel)
    if worklist is not None:
        _check_worklist("fused_sweep", x, y, worklist)
    _check_live("fused_sweep", x, worklist, live)
    if ran is not None and (
            bf16 or worklist is None or x.device.type != "cuda"
            or ran.dtype != torch.int64 or ran.device != x.device
            or ran.shape != (worklist.num_row_tiles, 2)
            or not ran.is_contiguous()):
        raise ValueError("fused_sweep: pair counts come from the CUDA f32 "
                         "worklist kernel, into (row tiles, 2) int64 on "
                         "x's device")
    if inserted is not None and (
            not bf16 or worklist is not None or x.device.type != "cuda"
            or inserted.dtype != torch.int32 or inserted.device != x.device
            or inserted.shape != (x.shape[0],)
            or not inserted.is_contiguous()):
        raise ValueError("fused_sweep: insertion counts come from the CUDA "
                         "dense bf16 kernel, into (n,) int32 on x's device")
    d2cut = d2cut_of(d_cut)
    record.note_launch(
        ("worklist_" if worklist is not None else "fused_") + "count_topk"
        + ("_bf16" if bf16 else "") + ("_sel" if sel is not None else ""),
        x, y, sel, d2cut=d2cut, worklist=worklist, row_tile=BLOCK_N)
    if x.device.type == "cpu":
        gate = None if sel is None else sel.bool()
        if worklist is None:
            plain = fused_count_topk_bf16_plain if bf16 \
                else fused_count_topk_plain
            count, topv, topi = plain(x, y, d2cut, sel=gate)
        else:
            plain = worklist_count_topk_bf16_plain if bf16 \
                else worklist_count_topk_plain
            count, topv, topi = plain(x, y, d2cut, worklist, sel=gate)
        return count.to(torch.float32), topv, topi
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    if bf16 and d > BF16_MAX_D:
        raise ValueError(f"fused_sweep: the bf16 kernels take at most "
                         f"{BF16_MAX_D} coordinates, got {d}")
    count = torch.empty((n,), dtype=torch.int32, device=x.device)
    topv = torch.empty((n, FUSED_TOPK), dtype=torch.float32, device=x.device)
    topi = torch.empty((n, FUSED_TOPK), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            if worklist is None and bf16:
                name = "fused_count_topk_bf16"
                rec = packing.bf16_records(y, sel)
                code = lib.repro_fused_count_topk_bf16(
                    x.data_ptr(), rec.rec.data_ptr(), rec.norms.data_ptr(),
                    _ptr(rec.gate), rec.rec.shape[1], n, m, d, d2cut,
                    count.data_ptr(), topv.data_ptr(), topi.data_ptr(),
                    _ptr(inserted), _stream(x))
            elif worklist is None:
                name = "fused_count_topk"
                rec = packing.pack_records(y, sel)
                code = lib.repro_fused_count_topk(
                    x.data_ptr(), rec.data_ptr(), rec.shape[1], n, m, d,
                    d2cut, int(sel is not None), count.data_ptr(),
                    topv.data_ptr(), topi.data_ptr(), _stream(x))
            elif bf16:
                name = "worklist_count_topk_bf16"
                rec = packing.bf16_records(y, sel)
                split = packing.phase_split(worklist)
                order = packing.heaviest_first(worklist, split)
                code = lib.repro_worklist_count_topk_bf16(
                    x.data_ptr(), rec.rec.data_ptr(), rec.norms.data_ptr(),
                    _ptr(rec.gate), rec.rec.shape[1], n, m, d, d2cut,
                    order.data_ptr(), worklist.row_ptr.data_ptr(),
                    split.data_ptr(), worklist.col_tile.data_ptr(),
                    worklist.in_cut.data_ptr(), worklist.lb.data_ptr(),
                    count.data_ptr(), topv.data_ptr(), topi.data_ptr(),
                    _ptr(live), _stream(x))
            else:
                name = "worklist_count_topk"
                lay = packing.k3_layout(worklist, y, sel)
                code = lib.repro_worklist_count_topk(
                    x.data_ptr(), lay.rec.data_ptr(),
                    lay.keep_rec.data_ptr(), _ptr(lay.keep_off),
                    lay.rec.shape[1], n, m, d, d2cut, int(sel is not None),
                    lay.order.data_ptr(), worklist.row_ptr.data_ptr(),
                    lay.split.data_ptr(), worklist.col_tile.data_ptr(),
                    worklist.in_cut.data_ptr(), worklist.lb.data_ptr(),
                    count.data_ptr(), topv.data_ptr(), topi.data_ptr(),
                    _ptr(live), _ptr(ran), _stream(x))
        build.check(lib, name, code)
        if sel is not None:
            name += "_sel"
        _LAUNCHES[name] += 1
    return count.to(torch.float32), topv, topi


def dependent_masked(x: torch.Tensor, x_key: torch.Tensor, y: torch.Tensor,
                     y_key: torch.Tensor, *, worklist: Worklist | None = None,
                     live: torch.Tensor | None = None, squared: bool = False):
    """Per x-row: the nearest y row with ``y_key > x_key`` (Def. 2).

    ``worklist`` (a best-1 ring, ``blocksparse.build_flat_worklist(
    nn="best1")``) walks each row's tile pairs in ascending lb, skipping
    those whose column tile holds no key above the row's, and stops where
    the row can no longer improve: K9 on a CUDA tensor, its plain version
    on a CPU one; without it, K2 / its plain version scan all of y.
    ``live`` (CUDA only, (row tiles, 2) int32) receives, per row tile, the
    entries K9's walks of its rows computed and the longest walk.

    Returns (delta (n,) f32, parent (n,) int32); (inf, -1) where no y row
    is strictly denser.  ``squared`` returns the kernel's d2 itself in
    place of delta, the pair a caller merges across shards before the
    square root (two d2 one ulp apart can share an f32 root).
    """
    _check("dependent_masked", x, y, x_key, y_key)
    if worklist is not None:
        _check_worklist("dependent_masked", x, y, worklist)
    _check_live("dependent_masked", x, worklist, live, walks=True)
    name = "masked_nn" if worklist is None else "worklist_masked_nn"
    if x.device.type == "cpu" or worklist is not None:
        record.note_launch(name, x, y, x_key, y_key, worklist=worklist,
                           row_tile=BLOCK_N)
    if x.device.type == "cpu":
        if worklist is None:
            best, arg = masked_nn_plain(x, x_key, y, y_key)
        else:
            best, arg = worklist_masked_nn_plain(x, x_key, y, y_key,
                                                 worklist)
        return (best if squared else torch.sqrt(best)), arg
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    best = torch.empty((n,), dtype=torch.float32, device=x.device)
    arg = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            if worklist is None:
                sms = torch.cuda.get_device_properties(
                    x.device).multi_processor_count
                lay = packing.nn_layout(
                    x, x_key, y, y_key, lib.repro_masked_nn_block_rows(),
                    NN_ITEMS_PER_SM * sms, NN_MIN_CHUNK)
                record.note_launch(name, x, y, x_key, y_key,
                                   grid=(lay.items.shape[0],))
                packed = torch.empty((n,), dtype=torch.int64,
                                     device=x.device)
                code = lib.repro_masked_nn(
                    lay.x.data_ptr(), lay.row_id.data_ptr(),
                    lay.ends.data_ptr(), lay.rec.data_ptr(),
                    lay.rec.shape[1], lay.items.data_ptr(),
                    lay.items.shape[0], n, d, packed.data_ptr(),
                    best.data_ptr(), arg.data_ptr(), _stream(x))
            else:
                rec = packing.pack_records(y, y_key.view(torch.int32))
                tmax = packing.tile_max_key(y_key)
                next_row = torch.empty((1,), dtype=torch.int32,
                                       device=x.device)
                code = lib.repro_worklist_masked_nn(
                    x.data_ptr(), x_key.data_ptr(), rec.data_ptr(),
                    rec.shape[1], n, m, d, worklist.row_ptr.data_ptr(),
                    worklist.col_tile.data_ptr(), worklist.lb.data_ptr(),
                    tmax.data_ptr(), next_row.data_ptr(), best.data_ptr(),
                    arg.data_ptr(), _ptr(live), _stream(x))
        build.check(lib, name, code)
        _LAUNCHES[name] += 1
    return (best if squared else torch.sqrt(best)), arg


def dependent_prefix(points_sorted_desc: torch.Tensor):
    """Per row of a table sorted by descending density key: the nearest
    earlier row (Def. 2 with "denser" read as "earlier"), the lowest index
    among equal distances.

    Returns (delta (n,) f32, parent (n,) int32); (inf, -1) for row 0.
    """
    x = points_sorted_desc
    _check("dependent_prefix", x, x)
    record.note_launch("prefix_nn", x, x)
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
    record.note_launch("range_count" if worklist is None
                       else "worklist_range_count", x, y, d2cut=d2cut,
                       worklist=worklist, row_tile=BLOCK_N)
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
                        signs: torch.Tensor, d_cut, *,
                        worklist: Worklist | None = None):
    """Per x-row: the sum of ``signs[b]`` over the batch rows within
    ``d_cut``, as (n,) f32 — the sliding-window rho repair, with +1 for an
    inserted row, -1 for an evicted one and 0 for padding.  The signs must
    be +1, -1 or 0: the sum is then exact in any order.  ``worklist`` (a
    count-only worklist of x over the batch,
    ``blocksparse.build_flat_worklist(nn=None)``) restricts the sum to its
    ``in_cut`` tile pairs: K14 on a CUDA tensor, its plain version on a CPU
    one; without it, K5 / its plain version."""
    _check("local_density_delta", batch, x, signs)   # signs: one per batch row
    if worklist is not None:
        _check_worklist("local_density_delta", x, batch, worklist)
    d2cut = d2cut_of(d_cut)
    record.note_launch("range_count_signed" if worklist is None
                       else "worklist_range_count_signed", x, batch, signs,
                       d2cut=d2cut, worklist=worklist, row_tile=BLOCK_N)
    if x.device.type == "cpu":
        if worklist is None:
            return range_count_signed_plain(x, batch, signs, d2cut)
        return worklist_range_count_signed_plain(x, batch, signs, d2cut,
                                                 worklist)
    n, m, d = x.shape[0], batch.shape[0], x.shape[1]
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n:
        lib = build.load_library()
        with torch.cuda.device(x.device):
            if worklist is None:
                name = "range_count_signed"
                code = lib.repro_range_count_signed(
                    x.data_ptr(), batch.data_ptr(), signs.data_ptr(), n, m,
                    d, d2cut, out.data_ptr(), _stream(x))
            else:
                name = "worklist_range_count_signed"
                code = lib.repro_worklist_range_count_signed(
                    x.data_ptr(), batch.data_ptr(), signs.data_ptr(), n, m,
                    d, d2cut, worklist.row_ptr.data_ptr(),
                    worklist.col_tile.data_ptr(), worklist.in_cut.data_ptr(),
                    out.data_ptr(), _stream(x))
        build.check(lib, name, code)
        _LAUNCHES[name] += 1
    return out


def gather_form(q: int) -> str:
    """K6's form for q slots, chosen by the shape alone: ``"prefix"`` (K2
    on the gathered rows: the columns sorted by key and packed, so only the
    strictly denser pairs are computed) from ``K6_PREFIX_ROWS`` slots on,
    else ``"key"`` (unsorted columns, each pair's key tested), where
    sorting and packing the table costs more than the pairs it saves.  The
    table's size does not enter: the sort and the pairs it saves both grow
    with it (measured at 2^20 rows; at 65,536 the key form also won at
    4,100 slots)."""
    return "prefix" if q >= K6_PREFIX_ROWS else "key"


def gather_layout(table: torch.Tensor, keys: torch.Tensor,
                  q_slots: torch.Tensor, form: str):
    """What K6's ``form`` reads for these slots (CUDA tensors, m >= 1):
    ``packing.NnLayout`` (prefix) or ``packing.KeyLayout`` (key)."""
    rows, x_key = packing.gather_rows(keys, q_slots)
    if form == "prefix":
        lib = build.load_library()
        sms = torch.cuda.get_device_properties(
            table.device).multi_processor_count
        return packing.nn_layout(table[rows], x_key, table, keys,
                                 lib.repro_masked_nn_block_rows(),
                                 NN_ITEMS_PER_SM * sms, NN_MIN_CHUNK)
    if form != "key":
        raise ValueError(f"gather_layout: unknown form {form!r}")
    return packing.key_layout(table, keys, rows, x_key)


def gather_scan(lay, d: int):
    """K6 on a layout from ``gather_layout``: (best d2 (q,) f32, index (q,)
    int32) in slot order; (inf, -1) where none is denser."""
    q = lay.x.shape[0]
    dev = lay.x.device
    packed = torch.empty((q,), dtype=torch.int64, device=dev)
    best = torch.empty((q,), dtype=torch.float32, device=dev)
    arg = torch.empty((q,), dtype=torch.int32, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        if isinstance(lay, packing.NnLayout):
            code = lib.repro_masked_nn(
                lay.x.data_ptr(), lay.row_id.data_ptr(), lay.ends.data_ptr(),
                lay.rec.data_ptr(), lay.rec.shape[1], lay.items.data_ptr(),
                lay.items.shape[0], q, d, packed.data_ptr(), best.data_ptr(),
                arg.data_ptr(), _stream(lay.x))
        else:
            code = lib.repro_gather_masked_nn(
                lay.x.data_ptr(), lay.x_key.data_ptr(), lay.row_id.data_ptr(),
                lay.rec.data_ptr(), lay.rec.shape[1], q, lay.rec.shape[0], d,
                packed.data_ptr(), best.data_ptr(), arg.data_ptr(),
                _stream(lay.x))
    build.check(lib, "gather_masked_nn", code)
    _LAUNCHES["gather_masked_nn"] += 1
    return best, arg


def dependent_masked_gather(table: torch.Tensor, keys: torch.Tensor,
                            q_slots: torch.Tensor):
    """Per slot s of ``q_slots``: the nearest table row with a key strictly
    greater than ``keys[s]`` (Def. 2 for the row subset ``table[q_slots]``).
    Slots outside [0, len(table)) are padding.

    On a CUDA tensor, K6: the rows are gathered here and take the form
    ``gather_form`` picks by the shape, K2's key-sorted prefix for many
    slots or K2's loop over unsorted columns with a key test for few
    (``gather_layout``, ``gather_scan``); either merges by the
    lexicographic (d2, index) minimum and equals the plain version bit for
    bit.

    Returns (delta (q,) f32, parent (q,) int32); (inf, -1) where no row is
    strictly denser and for padding slots.
    """
    _check("dependent_masked_gather", table, table, keys)
    if not isinstance(q_slots, torch.Tensor) or q_slots.dim() != 1 \
            or q_slots.dtype not in (torch.int32, torch.int64) \
            or q_slots.device != table.device:
        raise ValueError("dependent_masked_gather: q_slots must be a 1-D "
                         f"int32/int64 tensor on {table.device}")
    record.note_launch("gather_masked_nn", table, table, keys, q_slots,
                       rows=q_slots.numel())
    if table.device.type == "cpu":
        best, arg = gather_masked_nn_plain(table, keys, q_slots)
        return torch.sqrt(best), arg
    q, m = q_slots.numel(), table.shape[0]
    if not (q and m):    # no slot, or no row to be denser: nothing launches
        return (torch.full((q,), float("inf"), device=table.device),
                torch.full((q,), -1, dtype=torch.int32, device=table.device))
    best, arg = gather_scan(
        gather_layout(table, keys, q_slots, gather_form(q)), table.shape[1])
    return torch.sqrt(best), arg


def halo_density(x: torch.Tensor, window: torch.Tensor,
                 starts: torch.Tensor, ends: torch.Tensor, d_cut, *,
                 worklist: Worklist | None = None):
    """Per x-row: the count of window rows within ``d_cut`` inside the
    row's ``[start, end)`` spans (``starts``/``ends``: (n, S) int32
    window-local bounds, pairwise disjoint per row; empty, negative and
    past-the-window parts count nothing), as (n,) f32.  K10 on a CUDA
    tensor, its plain version on a CPU one.  ``worklist`` (a span count
    worklist, ``blocksparse.build_flat_worklist(nn=None, starts=,
    ends=)``) restricts the count to its ``in_cut`` tile pairs: K15 on a
    CUDA tensor, its plain version on a CPU one.  Both kernels take the
    window as packed records and the rows by piece (``halo_layout`` with
    no key, built here on the device)."""
    _check("halo_density", x, window)
    _check_spans("halo_density", x, starts, ends)
    if worklist is not None:
        _check_worklist("halo_density", x, window, worklist)
    d2cut = d2cut_of(d_cut)
    record.note_launch("halo_range_count" if worklist is None
                       else "worklist_halo_range_count", x, window, starts,
                       ends, d2cut=d2cut, worklist=worklist,
                       row_tile=BLOCK_N)
    if x.device.type == "cpu":
        if worklist is None:
            count = halo_range_count_plain(x, window, starts, ends, d2cut)
        else:
            count = worklist_halo_range_count_plain(x, window, starts, ends,
                                                    d2cut, worklist)
        return count.to(torch.float32)
    (n, d), w, s = x.shape, window.shape[0], starts.shape[1]
    count = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n:
        lay = halo_layout(None, window, None, starts, ends,
                          ring=worklist is not None)
        nxt = torch.empty((1,), dtype=torch.int32, device=x.device)
        head = (x.data_ptr(), lay.rec.data_ptr(), lay.rec.shape[1],
                starts.data_ptr(), ends.data_ptr(), lay.plen.data_ptr(),
                lay.order.data_ptr(), lay.item_end.data_ptr(),
                lay.meta.data_ptr(), n, w, d, s, d2cut)
        lib = build.load_library()
        with torch.cuda.device(x.device):
            if worklist is None:
                name = "halo_range_count"
                code = lib.repro_halo_range_count(
                    *head, nxt.data_ptr(), count.data_ptr(), _stream(x))
            else:
                name = "worklist_halo_range_count"
                # a bit for each column tile, per row tile: K15's in_cut
                words = (-(-w // BLOCK_M) + 31) // 32
                cut = torch.empty((worklist.num_row_tiles, words),
                                  dtype=torch.int32, device=x.device)
                code = lib.repro_worklist_halo_range_count(
                    *head, worklist.row_ptr.data_ptr(),
                    worklist.col_tile.data_ptr(), worklist.in_cut.data_ptr(),
                    cut.data_ptr(), nxt.data_ptr(), count.data_ptr(),
                    _stream(x))
        build.check(lib, name, code)
        _LAUNCHES[name] += 1
    return count.to(torch.float32)


def halo_layout(x_key: torch.Tensor | None, window: torch.Tensor,
                w_key: torch.Tensor | None, starts: torch.Tensor,
                ends: torch.Tensor, *, ring: bool) -> packing.HaloLayout:
    """K11's (``ring`` False) or K16's layout of the rows keyed ``x_key``
    with these spans over the window; with ``x_key`` and ``w_key`` None,
    K10's or K15's (``packing.halo_layout``, the pieces cut into at most
    SMs x ``HALO_SPLITS_PER_SM`` splits' worth): on a CUDA tensor built on
    the card by a few kernels and cub in one call, on a CPU one by
    ``packing.halo_layout`` itself (as for one SM)."""
    if (x_key is None) != (w_key is None):
        raise ValueError("halo_layout: give both keys or neither")
    if starts.device.type == "cpu":
        return packing.halo_layout(x_key, window, w_key, starts, ends,
                                   ring=ring, splits=HALO_SPLITS_PER_SM)
    (n, s), (w, d) = starts.shape, window.shape
    dev = starts.device
    splits = (torch.cuda.get_device_properties(dev).multi_processor_count
              * HALO_SPLITS_PER_SM)
    lib = build.load_library()
    scratch = torch.empty((lib.repro_halo_layout_scratch(n),),
                          dtype=torch.uint8, device=dev)
    lay = packing.HaloLayout(
        torch.empty((w, packing.record_width(d)), device=dev),
        torch.empty((0 if x_key is None else -(-w // BLOCK_M),), device=dev),
        *(torch.empty((n,), dtype=torch.int32, device=dev)
          for _ in range(4)),
        torch.empty((2,), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        code = lib.repro_halo_layout(
            starts.data_ptr(), ends.data_ptr(), _ptr(x_key),
            window.data_ptr(), _ptr(w_key), n, w, d, s, int(ring),
            splits, scratch.data_ptr(), scratch.numel(),
            *(t.data_ptr() for t in lay), _stream(starts))
    build.check(lib, "halo_layout", code)
    return lay


def halo_dependent(x: torch.Tensor, x_key: torch.Tensor,
                   window: torch.Tensor, w_key: torch.Tensor,
                   starts: torch.Tensor, ends: torch.Tensor, d_cut, *,
                   worklist: Worklist | None = None,
                   live: torch.Tensor | None = None):
    """Per x-row: the nearest window row inside the row's spans that is
    strictly denser AND within ``d_cut`` (stencil semantics; the spans as
    in ``halo_density``).  K11 on a CUDA tensor, its plain version on a
    CPU one.  ``worklist`` (a halo ring, ``blocksparse.build_flat_worklist(
    count=False, nn="best1", nn_dcut=True, starts=, ends=)``) walks each
    row tile's tile pairs in ascending lb and stops where no row can
    improve: K16 on a CUDA tensor, its plain version on a CPU one.  Both
    kernels take the window as packed records and the rows by piece
    (``packing.halo_layout``, built here on the device).  ``live`` (CUDA
    only, (row tiles, 2) int32) receives, per row tile, the entries K16's
    pieces computed and the longest walk among them.

    Returns (delta (n,) f32, parent (n,) int32 window index, found (n,)
    bool); (inf, -1, False) where no window row qualifies.
    """
    _check("halo_dependent", x, window, x_key, w_key)
    _check_spans("halo_dependent", x, starts, ends)
    if worklist is not None:
        _check_worklist("halo_dependent", x, window, worklist)
    _check_live("halo_dependent", x, worklist, live, walks=True)
    d2cut = d2cut_of(d_cut)
    record.note_launch("halo_masked_nn" if worklist is None
                       else "worklist_halo_masked_nn", x, window, x_key,
                       w_key, starts, ends, d2cut=d2cut, worklist=worklist,
                       row_tile=BLOCK_N)
    if x.device.type == "cpu":
        if worklist is None:
            best, arg = halo_masked_nn_plain(x, x_key, window, w_key, starts,
                                             ends, d2cut)
        else:
            best, arg = worklist_halo_masked_nn_plain(
                x, x_key, window, w_key, starts, ends, d2cut, worklist)
        return torch.sqrt(best), arg, torch.isfinite(best)
    (n, d), w, s = x.shape, window.shape[0], starts.shape[1]
    delta = torch.empty((n,), dtype=torch.float32, device=x.device)
    arg = torch.empty((n,), dtype=torch.int32, device=x.device)
    found = torch.empty((n,), dtype=torch.bool, device=x.device)
    if n:
        lay = halo_layout(x_key, window, w_key, starts, ends,
                          ring=worklist is not None)
        best = torch.empty((n,), dtype=torch.int64, device=x.device)
        nxt = torch.empty((1,), dtype=torch.int32, device=x.device)
        head = (x.data_ptr(), x_key.data_ptr(), lay.rec.data_ptr(),
                lay.rec.shape[1], lay.tmax.data_ptr(), starts.data_ptr(),
                ends.data_ptr(), lay.row_id.data_ptr(), lay.plen.data_ptr(),
                lay.order.data_ptr(), lay.item_end.data_ptr(),
                lay.meta.data_ptr(), n, w, d, s, d2cut)
        tail = (best.data_ptr(), nxt.data_ptr(), delta.data_ptr(),
                arg.data_ptr(), found.data_ptr())
        lib = build.load_library()
        with torch.cuda.device(x.device):
            if worklist is None:
                name = "halo_masked_nn"
                code = lib.repro_halo_masked_nn(*head, *tail, _stream(x))
            else:
                name = "worklist_halo_masked_nn"
                code = lib.repro_worklist_halo_masked_nn(
                    *head, worklist.row_ptr.data_ptr(),
                    worklist.col_tile.data_ptr(), worklist.lb.data_ptr(),
                    *tail, _ptr(live), _stream(x))
        build.check(lib, name, code)
        _LAUNCHES[name] += 1
    return delta, arg, found


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


@contextlib.contextmanager
def suspend_launch_counts():
    """Scope whose launches leave ``launch_counts()`` as it was at entry
    (the plan-time analyzer's canonical run)."""
    saved = dict(_LAUNCHES)
    try:
        yield
    finally:
        _LAUNCHES.update(saved)
