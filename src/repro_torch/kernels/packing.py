"""Host-side layouts of the K1, K2, K3, K6, K9, K10, K11, K12, K13, K15
and K16 kernels (``csrc/sweep.cu``).

The kernels read the columns as packed records of ``record_width(d)``
floats: the d coordinates, one 32-bit slot, then zeros up to a multiple of
4 floats, so every record is a whole number of 16-byte vectors and one
with d <= 3 is a single ``float4``.  K1's slot holds the kept-k gate (0 or
1), K2's the column's original index, K6's key form's and K9's the
column's key (its f32 bits); K9 also reads each column tile's largest key
(``tile_max_key``).

K3 (``worklist_count_topk``) walks each row tile's worklist segment in two
phases: up to its last in-d_cut entry (count and kept-k), then the rest
(kept-k alone, while some row can still take an entry).  ``k3_layout``
gives it the split, the row tiles in launch order (longest phase 1
first), phase 1's records (slot: the gate, gated; the index, ungated) and
phase 2's (slot: the index; gated: the selected columns alone, grouped by
column tile, with each tile's range).

K2 (``masked_nn``) takes the strictly-denser mask as a prefix: the columns
sorted by key, descending, so row i's candidates are exactly the first
``ends[i]`` records; the rows sorted by ``ends``, so a block of consecutive
rows scans nearly the same prefix and masks by position only past the
least end of its rows.  The block prefixes are cut into column chunks (a
work list, heaviest first), so the card fills whatever the row count; the
chunks of a row merge by the lexicographic (d2, original index) minimum.

K6 (``gather_masked_nn``) is K2's function on gathered rows
(``gather_rows``: a padding slot and a NaN key keyed +inf).  Its prefix
form is K2's layout of them; its key form (``key_layout``) sorts the rows
by key and leaves the columns unsorted, in records carrying their keys.

K12 (``fused_count_topk_bf16``) reads the columns as bf16 records
(``bf16_records``): y rounded to bf16, zero past d, ``bf16_record_width(d)``
values a column, beside their f32 norms, the halves of its cheap test and,
gated, their gate bytes, all padded to a whole number of ``BF16_GROUP``
columns, so the kernel streams whole 16-byte chunks and masks nothing: a
padding column's norm is NaN, so it fails every test.  K13
(``worklist_count_topk_bf16``) reads the same records on K3's walk, with
K3's split (``phase_split``: past it the first entry no row needs ends the
walk) and tile order (``heaviest_first``).

K11 (``halo_masked_nn``) and K16 (``worklist_halo_masked_nn``) take the
halo window as records with the key in the slot, its column tiles'
largest keys (``tile_max_key``) and the rows by piece (``halo_layout``):
consecutive rows whose spans clip to the same columns form a run (the
rows of one candidate cell, grid-sorted), each run's rows sorted by key,
cut into pieces of at most ``HALO_PIECE`` rows, which one warp walks
together, most work first, the heaviest cut into splits that several
warps share; K16's runs are also cut at the ring's row tiles.  K10
(``halo_range_count``) and K15 (``worklist_halo_range_count``) take the
same layout with no key: the rows keep their positions, the records'
slots are 0 and no tile keys are made; K15's runs are cut at its
worklist's row tiles.  On the card ``ops.halo_layout`` builds the same
arrays in one call (``repro_halo_layout``): ``halo_layout`` here is its
plain version.

The wrappers build all of this on the tensors' device; the kernels
allocate nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .blocksparse import BLOCK_M, BLOCK_N
from .sweep import sq_norms

# K12's columns per vote group, the padding unit of its records
# (kK12Group in csrc/sweep.cu)
BF16_GROUP = 16

# a column's share of K12's cheap test, y2 times this (k12_lim in
# csrc/sweep.cu): 1/2 less the test's margin of 2^-21
BF16_HALF = 0.5 - 2.0 ** -21


def record_width(d: int) -> int:
    """Floats per packed record: d coordinates and a slot, rounded up to
    a multiple of 4 (``rec_vecs`` in ``csrc/sweep.cu`` counts its
    float4s)."""
    return (d + 4) // 4 * 4


def pack_records(y: torch.Tensor, slot: torch.Tensor | None) -> torch.Tensor:
    """(m, record_width(d)) f32 records of y's rows, with ``slot`` ((m,)
    int or bool; None: 0) stored as int32 bits after the coordinates."""
    m, d = y.shape
    rec = torch.zeros((m, record_width(d)), dtype=torch.float32,
                      device=y.device)
    rec[:, :d] = y
    if slot is not None:
        rec.view(torch.int32)[:, d] = slot.to(torch.int32)
    return rec


def denser_prefix(x_key: torch.Tensor, y_key: torch.Tensor):
    """K2's key order: (cols, ends).

    ``cols`` (m,) int64 lists the columns by key, descending, equal keys in
    index order; ``ends`` (n,) int64 counts the columns strictly denser
    than each row, so ``cols[:ends[i]]`` is exactly ``{j : y_key[j] >
    x_key[i]}``.  A NaN is never greater than anything and nothing is
    greater than a NaN, as ``>`` has it: a NaN column sorts with the
    ``-inf`` ones, past every prefix, and a NaN row's prefix is empty.
    """
    neg_inf = torch.tensor(float("-inf"), device=y_key.device)
    yk = torch.where(torch.isnan(y_key), neg_inf, y_key)
    keys, cols = torch.sort(yk, descending=True, stable=True)
    # #{keys > v} = #{-keys < -v}: a left search of -v in ascending -keys
    ends = torch.searchsorted(-keys, -x_key)
    return cols, torch.where(torch.isnan(x_key), 0, ends)


def chunk_worklist(ends_sorted: torch.Tensor, block_rows: int,
                   min_items: int, min_chunk: int) -> torch.Tensor:
    """K2's work list over rows sorted by ``ends`` (ascending): (k, 4)
    int32 items (row block, chunk start, chunk end, 0).

    Row block b (rows ``[b * block_rows, (b + 1) * block_rows)``) scans the
    prefix ``[0, ends of its last row)``, cut into chunks of one length
    L = max(min_chunk, ceil(total / min_items)) over the blocks' total
    prefix, so there are about ``min_items`` items or more where the work
    allows; a block with an empty prefix gets none.  Items are ordered
    longest first, so the last wave is short.
    """
    dev = ends_sorted.device
    n = ends_sorted.numel()
    nb = -(-n // block_rows)
    last = (torch.arange(1, nb + 1, device=dev) * block_rows).clamp(max=n)
    span = ends_sorted[last - 1].long() if n else last
    total = int(span.sum())
    length = max(min_chunk, -(-total // max(min_items, 1)), 1)
    per_block = (span + length - 1) // length
    block = torch.repeat_interleave(torch.arange(nb, device=dev), per_block)
    first = torch.cumsum(per_block, 0) - per_block
    start = (torch.arange(block.numel(), device=dev) - first[block]) * length
    end = torch.minimum(start + length, span[block])
    items = torch.stack([block, start, end, torch.zeros_like(block)], 1)
    order = torch.sort(end - start, descending=True, stable=True).indices
    return items[order].to(torch.int32).contiguous()


class NnLayout(NamedTuple):
    """What K2 reads: the query rows sorted by the length of their denser
    prefix, each row's original slot, the prefix ends (ascending), the
    columns' records sorted by key (slot: the original index), and the
    work list."""
    x: torch.Tensor          # (n, d) f32
    row_id: torch.Tensor     # (n,) int32
    ends: torch.Tensor       # (n,) int32
    rec: torch.Tensor        # (m, record_width(d)) f32
    items: torch.Tensor      # (k, 4) int32


def nn_layout(x: torch.Tensor, x_key: torch.Tensor, y: torch.Tensor,
              y_key: torch.Tensor, block_rows: int, min_items: int,
              min_chunk: int) -> NnLayout:
    """K2's inputs for the strictly-denser NN of x's rows among y's."""
    cols, ends = denser_prefix(x_key, y_key)
    rows = torch.sort(ends, stable=True).indices
    ends = ends[rows].to(torch.int32)
    return NnLayout(x[rows].contiguous(), rows.to(torch.int32), ends,
                    pack_records(y[cols], cols),
                    chunk_worklist(ends, block_rows, min_items, min_chunk))


def gather_rows(keys: torch.Tensor, q_slots: torch.Tensor):
    """K6's query rows: (rows, x_key).  ``rows`` (q,) int64 is each slot
    clamped into the table (a slot outside [0, m) reads row 0); ``x_key``
    (q,) f32 is its key, +inf for such a padding slot and for a NaN key:
    nothing is strictly above +inf, and nothing is above a NaN, so either
    way the row has no denser column.  Needs m >= 1."""
    m = keys.numel()
    slots = q_slots.long()
    live = (slots >= 0) & (slots < m)
    rows = torch.where(live, slots, 0)
    key = keys[rows]
    return rows, torch.where(live & ~torch.isnan(key), key, float("inf"))


class KeyLayout(NamedTuple):
    """What K6's key form reads: the gathered rows sorted by key
    (ascending), their keys, each row's slot position, and the table's
    records in index order (slot: the row's key bits)."""
    x: torch.Tensor          # (q, d) f32
    x_key: torch.Tensor      # (q,) f32, ascending
    row_id: torch.Tensor     # (q,) int32
    rec: torch.Tensor        # (m, record_width(d)) f32


def key_layout(table: torch.Tensor, keys: torch.Tensor, rows: torch.Tensor,
               x_key: torch.Tensor) -> KeyLayout:
    """K6's key form's inputs for the rows ``table[rows]`` keyed ``x_key``
    (``gather_rows``)."""
    order = torch.sort(x_key, stable=True).indices
    return KeyLayout(table[rows[order]], x_key[order], order.to(torch.int32),
                     pack_records(table, keys.view(torch.int32)))


def tile_max_key(y_key: torch.Tensor) -> torch.Tensor:
    """K9's skip by key: (column tiles,) f32, the largest key of each
    ``BLOCK_M``-column tile, NaN keys left out (a NaN is never denser) and
    -inf for a tile with none.  No column of tile c is strictly denser than
    a row whose key is at least ``tile_max_key(y_key)[c]``."""
    m = y_key.numel()
    nbc = -(-m // BLOCK_M)
    keys = torch.full((nbc * BLOCK_M,), float("-inf"), dtype=torch.float32,
                      device=y_key.device)
    keys[:m] = torch.where(torch.isnan(y_key), float("-inf"), y_key)
    return keys.view(nbc, BLOCK_M).amax(1)


class K3Layout(NamedTuple):
    """What K3 reads besides the rows and the worklist."""
    rec: torch.Tensor        # (m, w) f32; slot: the gate, or the index
    keep_rec: torch.Tensor   # phase 2's records; slot: the column index
    keep_off: torch.Tensor | None  # (column tiles + 1,) int32, or None
    split: torch.Tensor      # (row tiles,) int32: end of each phase 1
    order: torch.Tensor      # (row tiles,) int32: launch order


def phase_split(wl) -> torch.Tensor:
    """(row tiles,) int32: the end of each row tile's phase 1, one past
    its last ``in_cut`` entry (its segment's start where it has none).
    ``build_flat_worklist``'s ``in_cut`` is ``lb <= d_cut^2`` over
    ascending lb, so phase 1 is exactly the in-d_cut entries; any entry
    before the split is counted only if it is ``in_cut``, and none after
    it is."""
    start = wl.row_ptr[:-1].long()
    cut = torch.nonzero(wl.in_cut).flatten()
    tile = torch.searchsorted(wl.row_ptr.long(), cut, right=True) - 1
    return start.scatter_reduce(0, tile, cut + 1, "amax").to(torch.int32)


def heaviest_first(wl, split: torch.Tensor) -> torch.Tensor:
    """(row tiles,) int32: the row tiles by the entries of their phase 1,
    most first, ties in tile order."""
    work = split.long() - wl.row_ptr[:-1].long()
    return torch.sort(work, descending=True, stable=True).indices.to(
        torch.int32)


def k3_layout(wl, y: torch.Tensor, sel: torch.Tensor | None) -> K3Layout:
    """K3's inputs for the worklist ``wl`` over y's columns, ``sel`` ((m,)
    bool or uint8, or None) the kept-k gate."""
    split = phase_split(wl)
    order = heaviest_first(wl, split)
    m = y.shape[0]
    if sel is None:
        rec = pack_records(y, torch.arange(m, device=y.device))
        return K3Layout(rec, rec, None, split, order)
    cols = torch.nonzero(sel).flatten()
    per_tile = torch.bincount(cols // BLOCK_M, minlength=-(-m // BLOCK_M))
    off = torch.zeros(per_tile.numel() + 1, dtype=torch.int64,
                      device=y.device)
    off[1:] = torch.cumsum(per_tile, 0)
    return K3Layout(pack_records(y, sel), pack_records(y[cols], cols),
                    off.to(torch.int32), split, order)


def bf16_record_width(d: int) -> int:
    """bf16 values per K12/K13 record (``k12_rec``): 8 for d <= 8, where the
    MMA's upper k-half is zero and never loaded, else d rounded up to the
    MMA's k of 16."""
    return 8 if d <= 8 else -(-d // 16) * 16


class Bf16Records(NamedTuple):
    """What K12 and K13 read of the columns, m rounded up to ``BF16_GROUP``
    long."""
    rec: torch.Tensor           # (m16, bf16_record_width(d)) bf16
    norms: torch.Tensor         # (2, m16) f32: y2, y2 * BF16_HALF; NaN past m
    gate: torch.Tensor | None   # (m16,) uint8, 0 past m; None ungated


def bf16_records(y: torch.Tensor, sel: torch.Tensor | None) -> Bf16Records:
    """K12's records of y's rows: y as bf16 (round to nearest even, as
    ``__float2bfloat16_rn``), the norms of ``sq_norms`` (in order, one
    rounding per operation: the kernel's own order) and their products
    with ``BF16_HALF``, and ``sel`` ((m,) bool or uint8, or None) as 0/1
    bytes."""
    m, d = y.shape
    m16 = -(-m // BF16_GROUP) * BF16_GROUP
    rec = torch.zeros((m16, bf16_record_width(d)), dtype=torch.bfloat16,
                      device=y.device)
    rec[:m, :d] = y.to(torch.bfloat16)
    norms = torch.full((2, m16), float("nan"), dtype=torch.float32,
                       device=y.device)
    norms[0, :m] = sq_norms(y)
    norms[1, :m] = norms[0, :m] * BF16_HALF
    gate = None
    if sel is not None:
        gate = torch.zeros((m16,), dtype=torch.uint8, device=y.device)
        gate[:m] = sel != 0
    return Bf16Records(rec, norms, gate)


# rows a K10/K11/K15/K16 piece holds at most: one warp, two rows a lane
# (kHaloPiece in csrc/sweep.cu)
HALO_PIECE = 64

# K10/K15 count a piece of at most this many rows a column a lane
# (kCountBallot in csrc/sweep.cu), a larger one a row a lane
COUNT_BALLOT_ROWS = 16


def clip_spans(starts: torch.Tensor, ends: torch.Tensor, w: int):
    """Each row's ``[start, end)`` spans clipped to the window ``[0, w)``,
    an empty one as ``[0, 0)``: (a, b) int32, the columns the kernels walk."""
    a = starts.clamp(0, w)
    b = ends.clamp(0, w)
    empty = b <= a
    return a.masked_fill(empty, 0), b.masked_fill(empty, 0)


def span_runs(starts: torch.Tensor, ends: torch.Tensor, w: int,
              tile_rows: int | None = None) -> torch.Tensor:
    """(n,) bool: the rows that start a run, in order: the first row, a
    row whose clipped spans (``clip_spans``) differ from the previous
    row's, and every ``tile_rows``-th row where that is given."""
    n = starts.shape[0]
    a, b = clip_spans(starts, ends, w)
    new = torch.ones((n,), dtype=torch.bool, device=starts.device)
    new[1:] = ((a[1:] != a[:-1]) | (b[1:] != b[:-1])).any(1)
    if tile_rows is not None:
        new[::tile_rows] = True
    return new


class HaloLayout(NamedTuple):
    """What K11 and K16 read besides the rows, their keys and the spans;
    with no key, what K10 and K15 read besides the rows and the spans."""
    rec: torch.Tensor       # (w, record_width(d)) f32; slot: the key's
                            # bits (0 with no key)
    tmax: torch.Tensor      # (column tiles,) f32: tile_max_key of the keys
                            # ((0,) with no key)
    row_id: torch.Tensor    # (n,) int32: the rows by run, key ascending
                            # (with no key in position order)
    plen: torch.Tensor      # (n,) int32: at a piece's first position its
                            # rows, else 0
    order: torch.Tensor     # (n,) int32: the positions, the pieces' first
                            # ones first, most work first
    item_end: torch.Tensor  # (n,) int32: the pieces' splits counted along
                            # order
    meta: torch.Tensor      # (2,) int32: the splits and the pieces in all


def key_order(key: torch.Tensor) -> torch.Tensor:
    """(n,) int64 in [0, 2^32) ordered as the f32 keys are (NaN as +inf)."""
    key = torch.where(torch.isnan(key), float("inf"), key)
    bits = key.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >= 2**31, 0xFFFFFFFF - bits, bits + 2**31)


def halo_layout(x_key: torch.Tensor | None, window: torch.Tensor,
                w_key: torch.Tensor | None, starts: torch.Tensor,
                ends: torch.Tensor, ring: bool,
                splits: int = 1) -> HaloLayout:
    """K11's (``ring`` False) or K16's (``ring`` True: runs cut at the
    ``BLOCK_N``-row tiles of its ring) layout; with ``x_key`` and
    ``w_key`` None, K10's or K15's (runs cut at its worklist's row tiles).
    Each run's rows are sorted by key (NaN as +inf, which seeks nothing),
    so a piece's keys lie in a narrow band (with no key they keep their
    positions), and cut into pieces of ``HALO_PIECE`` rows from its
    first, the last one shorter.  A run keeps its positions, so a
    position's run, and its span columns, are those of the row at that
    index.  A piece's work is its span columns times its cost a column:
    for K11/K16 its rows a lane (2 above 32 rows, else 1); for the count
    in 32nds of a row-a-lane chunk, 64 above 32 rows, 32 above
    ``COUNT_BALLOT_ROWS``, else 2 a row (a column a lane).  The pieces are
    ordered by work, most first, and one whose work is above 1/``splits``
    of all is cut into that many splits (``splits``: about eight times the
    warps the card holds), so no piece outlasts the rest."""
    n, w = starts.shape[0], window.shape[0]
    dev = starts.device
    new = span_runs(starts, ends, w, BLOCK_N if ring else None)
    run = torch.cumsum(new, 0) - 1
    pos = torch.arange(n, device=dev)
    if x_key is None:
        row_id = pos
    else:
        row_id = torch.sort((run << 32) | key_order(x_key),
                            stable=True).indices
    first = torch.searchsorted(run, run)
    end = torch.searchsorted(run, run, right=True)
    plen = torch.where((pos - first) % HALO_PIECE == 0,
                       torch.clamp(end - pos, max=HALO_PIECE), 0)
    a, b = clip_spans(starts, ends, w)
    if x_key is None:
        cost = torch.where(plen > 32, 64, torch.where(
            plen > COUNT_BALLOT_ROWS, 32, 2 * plen))
    else:
        cost = 1 + (plen > 32)
    work = torch.where(plen > 0, (b - a).long().sum(1) * cost, -1)
    work = work.clamp(max=2**31 - 1).to(torch.int32)
    order = torch.sort(work, descending=True, stable=True).indices
    work = work[order].clamp_min(0).long()
    cap = torch.clamp((work.sum() + splits - 1) // splits, min=1)
    item_end = torch.cumsum(torch.where(
        plen[order] > 0, torch.clamp((work + cap - 1) // cap, min=1), 0), 0)
    meta = torch.stack([item_end[-1], (plen > 0).sum()])
    if w_key is None:
        rec = pack_records(window, None)
        tmax = torch.empty((0,), dtype=torch.float32, device=dev)
    else:
        rec = pack_records(window, w_key.view(torch.int32))
        tmax = tile_max_key(w_key)
    return HaloLayout(rec, tmax, row_id.to(torch.int32),
                      plen.to(torch.int32), order.to(torch.int32),
                      item_end.to(torch.int32), meta.to(torch.int32))
