"""Every kernel's work, bytes and bound: the port's counterpart of
``repro/launch/hlo_cost.py``.

The reference asks XLA's compiled HLO what a program costs.  The port has
no compiler to ask, so the cost of a kernel is the kernel's own work,
counted from its shapes by the conventions below, and a launch record
(``analysis.record``) already holds every launch of an eager run, so
nothing needs multiplying through loops:

* **operations**: the f32 kernels compute direct differences, which do
  not contract into FMAs: 3d+1 f32 operations a pair (d subtractions, d
  multiplications, d additions and the compare), nothing counted for
  FMAs.  The bf16 sweeps (K12, K13) take their cross term on the tensor
  cores, 2 x 16 x ceil(d/16) operations a pair (d padded to the MMA's k),
  plus 2 f32 operations a pair for the cheap superset test; their exact
  epilogue on the few pairs that pass it is not counted;
* **bytes**: each input read once and each output written once, plus the
  packs the wrapper writes and the kernel reads (``kernels/packing.py``'s
  records, each written once and read once), as each function's docstring
  lists;
* **bound**: the larger of the bytes over the memory rate and the
  operations over their peak rate (``Rates``), and which of the two it is.

Where the work depends on the data (the pairs a worklist sweep needs, the
strictly denser pairs of a nearest-denser search, the columns inside a
row's spans), a function also takes the count that decides it.  Without
that count it returns the dense upper bound and says so: ``Work.exact``
is False.  The counts themselves need a run's answers, so the caller
computes them (``chip_smoke.py`` does, from the card's outputs).

``launch_cost(launch)`` reckons one entry of a launch record,
``record_cost(launches)`` sums a whole record per kernel.  A kernel name
the table does not know raises: it is never counted as zero.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..kernels.blocksparse import BLOCK_M, BLOCK_N
from ..kernels.packing import BF16_GROUP, bf16_record_width, record_width

__all__ = ["Rates", "H100", "F32_LANES_PER_SM", "Work", "bound_ms",
           "k1_work", "k2_work", "k3_work", "k4_work", "k5_work", "k6_work",
           "k7_work", "k8_work", "k9_work", "k10_work", "k11_work",
           "bf16_work", "k14_work", "k15_work", "k16_work", "KERNELS",
           "launch_cost", "record_cost"]

F32_LANES_PER_SM = 128           # Hopper: 128 f32 lanes per SM


@dataclass(frozen=True)
class Rates:
    """The card's peak rates.  The defaults are the published H100 SXM
    figures (NVIDIA data sheet, dense, at 700 W): HBM3 at 3.35 TB/s, bf16
    on the tensor cores at 989 TFLOP/s, and the f32 lane issue rate, SMs x
    128 lanes x the SM clock, 132 x 128 x 1980 MHz (the data sheet's 67
    TFLOP/s counts an FMA as two, and these kernels' operations do not
    contract into FMAs).  ``for_card`` takes the issue rate from a card's
    own SM count and maximum clock."""

    hbm_bytes_per_s: float = 3.35e12
    f32_ops_per_s: float = 132 * F32_LANES_PER_SM * 1980e6
    bf16_tc_ops_per_s: float = 989e12

    @classmethod
    def for_card(cls, sms: int, max_sm_mhz: float) -> "Rates":
        return cls(f32_ops_per_s=sms * F32_LANES_PER_SM * max_sm_mhz * 1e6)


H100 = Rates()


@dataclass(frozen=True)
class Work:
    """One launch's (or a sum of launches') work: ``bytes`` moved, f32
    lane ``ops``, tensor-core ``tc_ops``; ``exact`` False where a
    data-dependent count was absent and the dense upper bound stands in."""

    bytes: float
    ops: float
    tc_ops: float = 0.0
    exact: bool = True

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops,
                    self.tc_ops + other.tc_ops, self.exact and other.exact)


def bound_ms(work: Work, rates: Rates = H100) -> tuple[float, str]:
    """The least time for the work, in ms: bytes over the memory rate, or
    the operations over their rates (tensor-core and f32 lane operations
    each over its own, the larger), whichever is larger; and
    ``"bytes"`` or ``"operations"``, what bounds it."""
    t_bytes = work.bytes / rates.hbm_bytes_per_s
    t_ops = max(work.ops / rates.f32_ops_per_s,
                work.tc_ops / rates.bf16_tc_ops_per_s)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def _pair_ops(d: int) -> int:
    return 3 * d + 1


def _tile_pairs(n: int, m: int, entries: int) -> float:
    """The most pairs a worklist of ``entries`` tile pairs can hold: each
    a BLOCK_N x BLOCK_M tile, and never more than the dense n x m."""
    return float(min(entries * BLOCK_N * BLOCK_M, n * m))


def _worklist_bytes(row_tiles: int, entries: int, per_entry: int) -> int:
    """row_ptr (row tiles + 1 int32) and ``per_entry`` bytes an entry
    (col_tile 4, in_cut 1 and/or lb 4)."""
    return 4 * (row_tiles + 1) + per_entry * entries


def _or_bound(count, bound: float) -> tuple[float, bool]:
    return (bound, False) if count is None else (float(count), True)


# ------------------------------------------------------------ the kernels
def k1_work(n: int, m: int, d: int) -> Work:
    """K1 ``fused_count_topk`` (gated or not): x (n, d) and y (m, d) read
    once, the count, the 8 kept d2 and their indices written once; 3d+1
    operations for every one of the n x m pairs."""
    return Work(4 * (n * d + m * d) + 4 * n + 2 * 4 * 8 * n,
                float(n) * m * _pair_ops(d))


def k2_work(n: int, m: int, d: int, denser: float | None = None) -> Work:
    """K2 ``masked_nn`` as its schedule must do it: 3d+1 operations for
    each pair whose column is strictly denser (``denser``; the key-sorted
    prefix leaves no key test); the inputs (x, its keys, y, its keys) read
    once, (d2, parent) and the packed result written once, and the sort
    and pack of the columns (keys sorted with their indices, rows gathered
    into records) and of the rows.  Without ``denser``: all n x m."""
    pairs, exact = _or_bound(denser, float(n) * m)
    nbytes = (4 * (n * d + n + m * d + m) + 8 * n
              + 16 * m + 4 * m * (d + record_width(d)) + 16 * n
              + 4 * n * (2 * d + 1))
    return Work(nbytes, pairs * _pair_ops(d), exact=exact)


def k3_work(n: int, m: int, d: int, entries: int, row_tiles: int,
            needed: float | None = None, selected: int | None = None,
            gated: bool = False) -> Work:
    """K3 ``worklist_count_topk``: the inputs and the worklist (row_ptr,
    col_tile, in_cut, lb) read once, the outputs written once, the
    wrapper's record pack (y's records, and gated the ``selected``
    columns' with each 512-column tile's range, each written once and read
    once; the phase split and the tile order); 3d+1 operations for each
    pair it needs (``needed``: the real columns of each row's in-d_cut
    entries and of the entries whose lb is at most its final 8th d2, which
    no exact pruning skips).  Without ``needed``: every pair of every
    entry; gated without ``selected``: every column selected."""
    rec = 2 * 4 * record_width(d)
    nbytes = (4 * (n * d + m * d) + 4 * n + 2 * 4 * 8 * n
              + _worklist_bytes(row_tiles, entries, 9)
              + m * rec + 2 * 4 * row_tiles)
    pairs, exact = _or_bound(needed, _tile_pairs(n, m, entries))
    if gated:
        sel, sel_exact = _or_bound(selected, m)
        nbytes += m + sel * rec + 4 * (-(-m // BLOCK_M) + 1)
        exact = exact and sel_exact
    return Work(nbytes, pairs * _pair_ops(d), exact=exact)


def k4_work(n: int, m: int, d: int) -> Work:
    """K4 ``range_count``: x and y read once, the counts written once;
    3d+1 operations per pair."""
    return Work(4 * (n * d + m * d) + 4 * n, float(n) * m * _pair_ops(d))


def k5_work(n: int, m: int, d: int) -> Work:
    """K5 ``range_count_signed``: x (n, d), the batch (m, d) and its signs
    read once, the sums written once; 3d+1 operations per pair."""
    return Work(4 * (n * d + m * d + m) + 4 * n,
                float(n) * m * _pair_ops(d))


def k6_work(q: int, m: int, d: int, form: str = "prefix",
            denser: float | None = None, live: int | None = None) -> Work:
    """K6 ``gather_masked_nn`` on ``q`` slots of an (m, d) table, in the
    form ``ops.gather_form`` picks.  ``"prefix"``: K2's work on the
    gathered rows (``k2_work``) plus the slots read, as int64.  ``"key"``
    (K2's loop over unsorted columns): a key test for every pair of a
    ``live`` slot (one inside the table) and a column, and 3d+1 operations
    for each strictly denser pair; the table, its keys and the slots read
    once, (d2, parent) written once.  Without ``denser``: every pair;
    without ``live``: every slot."""
    if form == "prefix":
        w = k2_work(q, m, d, denser)
        return Work(w.bytes + 8 * q, w.ops, exact=w.exact)
    if form != "key":
        raise ValueError(f"k6_work: unknown form {form!r}")
    pairs, exact = _or_bound(denser, float(q) * m)
    slots, live_exact = _or_bound(live, q)
    return Work(4 * (m * d + m) + 8 * q + 8 * q,
                slots * m + pairs * _pair_ops(d), exact=exact and live_exact)


def k7_work(n: int, d: int) -> Work:
    """K7 ``prefix_nn`` on a table of n rows sorted by key: the table read
    once, (delta, parent) written once; 3d+1 operations for each of the
    n(n-1)/2 pairs of a row and an earlier one."""
    return Work(4 * n * d + 8 * n, n * (n - 1) / 2 * _pair_ops(d))


def k8_work(n: int, m: int, d: int, entries: int, row_tiles: int,
            pairs: float | None = None) -> Work:
    """K8 ``worklist_range_count``: x, y and the worklist (row_ptr,
    col_tile, in_cut) read once, the counts written once; 3d+1 operations
    per pair of an in-d_cut entry (``pairs``: each such entry's real
    columns times its row tile's real rows).  Without ``pairs``: every
    pair of every entry."""
    p, exact = _or_bound(pairs, _tile_pairs(n, m, entries))
    nbytes = (4 * (n * d + m * d) + 4 * n
              + _worklist_bytes(row_tiles, entries, 5))
    return Work(nbytes, p * _pair_ops(d), exact=exact)


def k9_work(n: int, m: int, d: int, entries: int, row_tiles: int,
            key_tests: float | None = None,
            denser: float | None = None) -> Work:
    """K9 ``worklist_masked_nn``: x, its keys, y, its keys and the ring
    (row_ptr, col_tile, lb) read once, (d2, parent) written once.  A key
    test for each column a row's walk needs (``key_tests``: the columns of
    the entries whose lb is at most its final best d2 and whose column
    tile holds a key above its own), and 3d+1 operations for each of those
    columns that is denser (``denser``).  Without them: every pair of
    every entry, each denser."""
    bound = _tile_pairs(n, m, entries)
    tests, t_exact = _or_bound(key_tests, bound)
    dense, d_exact = _or_bound(denser, bound)
    nbytes = (4 * (n * d + n + m * d + m)
              + _worklist_bytes(row_tiles, entries, 8) + 8 * n)
    return Work(nbytes, tests + dense * _pair_ops(d),
                exact=t_exact and d_exact)


def k10_work(n: int, w: int, d: int, spans: int,
             span_cols: float | None = None) -> Work:
    """K10 ``halo_range_count``: x (n, d), the window (w, d) and the
    spans ((n, spans) starts and ends, int32) read once, the counts
    written once; 3d+1 operations per window column inside a row's spans
    (``span_cols``, clipped to the window).  Without it: each row's spans
    cover the whole window (they are disjoint, so never more)."""
    cols, exact = _or_bound(span_cols, float(n) * w)
    return Work(4 * (n * d + w * d) + 8 * n * spans + 4 * n,
                cols * _pair_ops(d), exact=exact)


def k11_work(n: int, w: int, d: int, spans: int,
             key_tests: float | None = None,
             denser: float | None = None) -> Work:
    """K11 ``halo_masked_nn``: x, its keys, the window, its keys and the
    spans read once, (delta, parent, found) written once; a key test per
    window column inside a row's spans whose column tile's largest key is
    above the row's (``key_tests``), and 3d+1 operations for each denser
    one (``denser``).  Without them: the whole window a row, each
    denser."""
    tests, t_exact = _or_bound(key_tests, float(n) * w)
    dense, d_exact = _or_bound(denser, float(n) * w)
    return Work(4 * (n * d + n + w * d + w) + 8 * n * spans + 9 * n,
                tests + dense * _pair_ops(d), exact=t_exact and d_exact)


def bf16_work(n: int, m: int, d: int, pairs: float | None = None,
              gated: bool = False, entries: int | None = None,
              row_tiles: int | None = None) -> Work:
    """K12 ``fused_count_topk_bf16`` (K13 ``worklist_count_topk_bf16``
    given its worklist's ``entries`` and ``row_tiles``): x, y (and the
    gate) and the worklist read once, the outputs written once, K12's
    record pack (the bf16 records, the two f32 norms a column and the gate
    bytes, written once and read once); per pair 2 x 16 x ceil(d/16)
    tensor-core operations and 2 f32 ones, the superset test that every
    pair needs (an add and a compare).  ``pairs``: K12's are all n x m;
    K13's those of the entries its walk computed, without it every pair of
    every entry."""
    nbytes = 4 * (n * d + m * d) + 4 * n + 2 * 4 * 8 * n
    if gated:
        nbytes += m
    if entries is not None:
        nbytes += _worklist_bytes(row_tiles, entries, 9)
        p, exact = _or_bound(pairs, _tile_pairs(n, m, entries))
    else:
        m16 = -(-m // BF16_GROUP) * BF16_GROUP
        nbytes += 2 * m16 * (2 * bf16_record_width(d) + 8 + int(gated))
        p, exact = float(n) * m, True
    return Work(nbytes, p * 2.0, tc_ops=p * 32 * -(-d // 16), exact=exact)


def k14_work(n: int, m: int, d: int, entries: int, row_tiles: int,
             pairs: float | None = None) -> Work:
    """K14 ``worklist_range_count_signed``: K8's work on the window (n, d)
    against the batch (m, d), plus the batch's signs read once and one add
    a pair of an in-d_cut entry."""
    w = k8_work(n, m, d, entries, row_tiles, pairs)
    return Work(w.bytes + 4 * m, w.ops + w.ops / _pair_ops(d),
                exact=w.exact)


def k15_work(n: int, w: int, d: int, spans: int, entries: int,
             row_tiles: int, span_cols: float | None = None) -> Work:
    """K15 ``worklist_halo_range_count``: K10's work with the worklist
    (row_ptr, col_tile, in_cut) read too; 3d+1 operations per span column
    inside the in-d_cut entries, every one of which it computes
    (``span_cols``).  Without it: the most the entries hold."""
    cols, exact = _or_bound(span_cols, _tile_pairs(n, w, entries))
    base = k10_work(n, w, d, spans, cols)
    return Work(base.bytes + _worklist_bytes(row_tiles, entries, 5),
                base.ops, exact=exact)


def k16_work(n: int, w: int, d: int, spans: int, entries: int,
             row_tiles: int, key_tests: float | None = None,
             denser: float | None = None) -> Work:
    """K16 ``worklist_halo_masked_nn``: K11's work with the ring (row_ptr,
    col_tile, lb) read too; a key test per span column inside the ring
    entries a row needs (lb at most its final best d2, below d_cut^2 where
    it found none, the tile holding a key above the row's), and 3d+1
    operations for each denser one.  Without them: the most the entries
    hold, each denser."""
    bound = _tile_pairs(n, w, entries)
    tests, t_exact = _or_bound(key_tests, bound)
    dense, d_exact = _or_bound(denser, bound)
    base = k11_work(n, w, d, spans, tests, dense)
    return Work(base.bytes + _worklist_bytes(row_tiles, entries, 8),
                base.ops, exact=t_exact and d_exact)


# ------------------------------------------------- the launch record's view
def _row_tiles(launch) -> int:
    return launch.padded_rows // launch.row_tile


def _sweep(launch, gated: bool) -> Work:
    n, m, d = launch.rows, launch.cols, launch.d
    if launch.entries is None:
        return k1_work(n, m, d)
    return k3_work(n, m, d, launch.entries, _row_tiles(launch), gated=gated)


def _bf16(launch, gated: bool) -> Work:
    if launch.entries is None:
        return bf16_work(launch.rows, launch.cols, launch.d, gated=gated)
    return bf16_work(launch.rows, launch.cols, launch.d, gated=gated,
                     entries=launch.entries, row_tiles=_row_tiles(launch))


def _gather(launch) -> Work:
    from ..kernels.ops import gather_form
    return k6_work(launch.rows, launch.cols, launch.d,
                   form=gather_form(launch.rows))


def _wl(fn):
    return lambda lc: fn(lc.rows, lc.cols, lc.d, lc.entries, _row_tiles(lc))


def _halo(fn, span_arg: int, ring: bool = False):
    def cost(lc):
        spans = lc.shapes[span_arg][1]
        if ring:
            return fn(lc.rows, lc.cols, lc.d, spans, lc.entries,
                      _row_tiles(lc))
        return fn(lc.rows, lc.cols, lc.d, spans)
    return cost


# kernel name (``ops.launch_counts()``'s keys) -> (its K number, the work
# of one launch record entry, from its shapes alone)
KERNELS = {
    "fused_count_topk": ("K1", lambda lc: _sweep(lc, False)),
    "fused_count_topk_sel": ("K1", lambda lc: _sweep(lc, True)),
    "masked_nn": ("K2", lambda lc: k2_work(lc.rows, lc.cols, lc.d)),
    "worklist_count_topk": ("K3", lambda lc: _sweep(lc, False)),
    "worklist_count_topk_sel": ("K3", lambda lc: _sweep(lc, True)),
    "range_count": ("K4", lambda lc: k4_work(lc.rows, lc.cols, lc.d)),
    "range_count_signed": ("K5", lambda lc: k5_work(lc.rows, lc.cols,
                                                    lc.d)),
    "gather_masked_nn": ("K6", _gather),
    "prefix_nn": ("K7", lambda lc: k7_work(lc.rows, lc.d)),
    "worklist_range_count": ("K8", _wl(k8_work)),
    "worklist_masked_nn": ("K9", _wl(k9_work)),
    "halo_range_count": ("K10", _halo(k10_work, 2)),
    "halo_masked_nn": ("K11", _halo(k11_work, 4)),
    "fused_count_topk_bf16": ("K12", lambda lc: _bf16(lc, False)),
    "fused_count_topk_bf16_sel": ("K12", lambda lc: _bf16(lc, True)),
    "worklist_count_topk_bf16": ("K13", lambda lc: _bf16(lc, False)),
    "worklist_count_topk_bf16_sel": ("K13", lambda lc: _bf16(lc, True)),
    "worklist_range_count_signed": ("K14", _wl(k14_work)),
    "worklist_halo_range_count": ("K15", _halo(k15_work, 2, ring=True)),
    "worklist_halo_masked_nn": ("K16", _halo(k16_work, 4, ring=True)),
}


def launch_cost(launch) -> Work:
    """The work of one launch record entry (``analysis.record.Launch``),
    from its kernel, shapes, rows, cols, d and entries.  The record holds
    no data-dependent count, so a data-dependent kernel's work is its
    dense upper bound (``exact`` False)."""
    if launch.kernel not in KERNELS:
        raise KeyError(f"kernel_cost: no cost for kernel {launch.kernel!r}; "
                       f"known: {sorted(KERNELS)}")
    return KERNELS[launch.kernel][1](launch)


def record_cost(launches, rates: Rates = H100) -> dict:
    """A launch record summed per kernel: ``{name: {"kernel": K number,
    "launches", "bytes", "ops" (f32), "tc_ops", "bound_ms", "bound_by",
    "exact"}}``, in the order the kernels first launched.  ``launches``:
    the record's events (``Step`` events are passed over) or its
    ``record.launches(events)``."""
    from ..analysis.record import Launch

    sums: dict[str, tuple[int, Work]] = {}
    for lc in launches:
        if not isinstance(lc, Launch):
            continue
        w = launch_cost(lc)
        count, total = sums.get(lc.kernel, (0, None))
        sums[lc.kernel] = (count + 1, w if total is None else total + w)
    out = {}
    for name, (count, w) in sums.items():
        b_ms, by = bound_ms(w, rates)
        out[name] = {"kernel": KERNELS[name][0], "launches": count,
                     "bytes": w.bytes, "ops": w.ops, "tc_ops": w.tc_ops,
                     "bound_ms": b_ms, "bound_by": by, "exact": w.exact}
    return out
