#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py [--out PATH]

Phases, each of which raises on failure (nothing is caught):

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, and the seconds ``nvcc`` took to build ``kernels/csrc/sweep.cu``.
2. Kernels vs plain at check shapes: each CUDA kernel against its plain
   PyTorch version on the same inputs on the card, bit for bit (ragged
   rows, d = 2..64, equal keys, a lattice of exact distance ties); K3, the
   worklist sweep, also against dense K1.  Median times of five runs after
   a warm-up (CUDA events) at 65,536 rows.
3. The dense path: ``DPCEngine(d_cut, rho_min=10).fit`` on the Airline
   proxy (d = 3) at n = 1,048,576, d_cut from the benchmarks' rule
   ``pick_dcut(target_rho=30)``.  The launch counts are zeroed just before
   the timed fit and read just after it; the inputs each kernel was given
   in that fit are kept.
4. Kernels vs plain at the dense path's shapes: K1 on the fit's full
   2^20 x 2^20 against the fit's rho, and on a 65,536-row slice against
   its plain version (the plain sweep over all rows took 145 s); K2 on the
   fit's unresolved cell maxima against all 2^20 rows.  Kernel times are
   medians of five CUDA-event runs after a warm-up; a plain time is its one
   comparison run, timed by CUDA events.
5. The dense fit against float64: rho on 4,096 random rows, and the parent
   and delta of every cell maximum (rules 2 and 3) against a float64 masked
   search over all n.
6. Block-sparse at 2^20: the worklist of the same input, grid-sorted; K3
   bit-equal to dense K1 and to its plain version on all 2^20 rows; then
   the block-sparse fit (counted and timed as the dense one), whose rho,
   rho_key and delta must equal the dense fit's, and whose parent and
   labels must equal them wherever no exact distance tie decides a parent.
7. Ex-DPC and Scan at 2^20 (each fit counted and timed): Ex-DPC
   block-sparse bit-equal to Scan block-sparse, and equal to Ex-DPC dense
   as in phase 6; its rho equal to the Approx-DPC fit's; its delta and
   parent of 4,096 random rows against a float64 masked search; the rows
   each sent to K2 and K2's time on them.
8. The main path at full width: ``DPCEngine(d_cut, rho_min=10,
   exec_spec=ExecSpec(layout="block-sparse")).fit`` on the Airline proxy at
   Airline's full n = 5,810,462, run twice and the second counted and
   timed (K3 and K2 must launch, K1 must not); rho on 4,096 random rows and
   parent/delta of 4,096 random cell maxima against float64; K3 against
   its plain version and dense K1 on 256 row tiles spread over the table,
   against all columns; K2 against its plain version on a slice of the
   fit's rows; a traced fit for the phase times and each phase's peak
   device memory.
9. The stream's kernels vs plain at check shapes: K4 ``range_count``, K5
   ``range_count_signed`` and K6 ``gather_masked_nn`` bit for bit against
   their plain versions (Airline 65,536 with 4,096 query rows, a 512-row
   batch of mixed signs and 4,096 slots with padding slots and the global
   peak; mixtures n = 1,000 at d = 2, 4, 8; a 128 x 128 lattice of exact
   ties with three key levels); K6 also against K2 on the gathered rows.
10. The stream main path, the workload of ``benchmarks/stream_bench.py``
   at the card's size: ``DPCEngine(2000.0, window_capacity=2**20,
   batch_cap=4096, exec_spec=ExecSpec(layout="block-sparse"))`` on
   ``gaussian_mixture(k=15, d=2, seed=0)``: ``fit`` on 2^20 points, a
   first ``partial_fit`` that seeds the window, one traced tick (phase
   times and peaks), 32 counted ticks (launch counts zeroed just before
   them and read just after; each tick must launch K4, K5 and K6; their
   inputs kept and each tick's kernels held against the plain versions
   on a slice, the last tick's K4/K5 on all rows and K6 on 2,048 slots),
   the final state against a from-scratch block-sparse fit of the window
   (rho, rho_key, delta bit for bit, parents up to counted exact ties),
   rho against float64 on 4,096 rows, re-queried maxima against a float64
   masked search, the full recompute's time, and ``predict`` on 65,536
   queries (stream points, far rows that must fall back to a center, NaN
   rows that must be quarantined; HIT labels against a float64 nearest
   window point on 1,024 of them).
11. The same on the Airline proxy, d_cut of phase 3, 8 counted ticks.
12. S-Approx-DPC's kernels at check shapes: the gated K1 and K3
   ``fused_sweep(nn_sel=...)`` bit for bit against their plain versions
   and gated K3 against gated K1 (the phase 2 cases and the lattice of
   exact ties; gates all ones, which must equal the ungated sweep, all
   zeros, 40 % at random, 5 columns, and the representatives at eps 0.8
   with their rows as the queries; K1 on ragged row counts); the gated
   K3's computed entries; K7 ``prefix_nn`` on each case's table sorted by
   descending key, bit for bit against its plain version and against K2
   with key -position.
13. S-Approx-DPC at full width, the slice's main path:
   ``DPCEngine(d_cut, algorithm="sapproxdpc", eps=0.8, rho_min=10,
   exec_spec=ExecSpec(layout="block-sparse")).fit`` on the Airline proxy
   at n = 5,810,462, d_cut of phase 8, run twice and the second counted
   and timed (gated K3 and K2 must launch, ungated K1/K3 and gated K1 must
   not); every member's rho, parent and delta from its representative;
   rho on 4,096 random representatives against float64, and their
   phase-1/phase-2 delta and parent against a float64 masked search among
   the representatives; gated K3 against its plain version, the fit's own
   sweep and gated K1 on 256 row tiles; K2 on the rows the fit sent it; a
   traced fit for the phase times and each phase's peak.
14. The eps sweep at 2^20 (paper Table 5, ``benchmarks/eps_sweep.py``'s
   eps 0.2, 0.4, 0.6, 0.8, 1.0): each block-sparse fit's time and its Rand
   index against phase 7's Ex-DPC labels (at least 0.9); at eps 0.8 the
   dense fit too (counted: gated K1 and K2 must launch), whose rho, rho_key
   and delta must equal the block-sparse fit's and whose parents must
   equal it up to counted exact ties; gated K1 on the dense fit's inputs
   against its plain version on 8,192 rows.
15. K7 at 2^20 through ``CudaBackend.prefix_nn`` (counts zeroed just
   before, read just after) on phase 7's Ex-DPC table sorted by
   descending ``rho_key``: its delta equal to the Ex-DPC fit's bit for bit
   and its parents up to counted exact distance ties, on every row whose
   nearest earlier row is strictly denser; the rows whose nearest earlier
   row has an equal f32 key are counted (there K7 may be nearer); against
   its plain version on the first 65,536 rows; its time and bound.

16. The distributed kernels at check shapes: K8 ``worklist_range_count``,
   K9 ``worklist_masked_nn``, K10 ``halo_range_count`` and K11
   ``halo_masked_nn`` bit for bit against their plain versions on the
   phase 2 cases (and the lattice of exact ties), each table split into
   three shards as `distributed_dpc` splits it (padded 1e9 rows, a
   shard whose row count is not a multiple of the tile); K8 against dense
   K4, K9 against dense K2, K10 with spans covering the whole window (and
   a reversed and a negative span) against K4, K11 so against K2 masked to
   d_cut; each shard's halo window assembled by the ppermute ring, its
   empty spans negative.
17. Distributed Ex-DPC at full width: ``DPCEngine(d_cut, algorithm="exdpc",
   rho_min=10, mesh=ShardMesh.on("cuda", shards=4), strategy=...,
   exec_spec=ExecSpec(layout="block-sparse")).fit`` on the Airline proxy at
   n = 5,810,462, d_cut of phase 8, strategies ``halo`` (K10, K11, then K9
   on the unresolved rows) and ``gather`` (K8, K9), each run twice and the
   second counted and timed; each equal to the single-device block-sparse
   Ex-DPC fit (measured here too) up to counted exact distance ties, and
   rho and delta/parent of 4,096 random rows against float64; a traced
   fit per strategy for the phase times and peaks, the halo window W, its
   hops and the rows the ring moves against the gather's, the unresolved
   rows; K8-K11 on every call of the counted runs timed, against their
   plain versions on a few row tiles or 65,536 rows, their bounds from
   their inputs.  The four shards are logical shards of one card.
18. The dense gather strategy at 2^20 (K4 and K2 per shard, four shards):
   counted (K4 and K2 must launch, K8-K11 must not), equal to phase 7's
   dense Ex-DPC up to counted exact ties, and against float64 on 4,096
   rows.

Prints the card line and a ``{"kernels": [...]}`` line (K1 from the dense
path, K2 and K3 from the main path, K4-K6 from the mixture stream, gated
K3 from phase 13, gated K1 from phase 14's dense fit, K7 from phase 15,
K8 and K9 from phase 17's gather fit, K10 and K11 from its halo fit),
and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, where
no CUDA device is present.  ``--out`` also writes the full record
(check-shape times, issue-rate bounds, worklist statistics with K3's
computed entries, phase times and peaks) as JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 rate
# and float32 outside the tensor cores (an FMA counted as two operations).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_LANES_PER_SM = 128           # Hopper: 128 f32 lanes per SM

N_MAIN = 1 << 20                 # the dense path (quadratic)
N_FULL = 5_810_462               # Airline's size: the block-sparse main path
N_CHECK = 65536
Q_CHECK = 4096
K1_PLAIN_ROWS = 65536            # rows of the dense path's plain K1 check
TILES_CHECK = 256                # row tiles of the full path's K3 check
K2_PLAIN_ROWS = 2048             # rows of the full path's plain K2 check
REPS = 5

N_WINDOW = 1 << 20               # the stream phases' window
STREAM_BATCH = 4096              # points per stream tick
MIX_TICKS = 32                   # counted ticks of the mixture stream
AIR_TICKS = 8                    # counted ticks of the Airline stream
N_PREDICT = 65536                # predict's queries
N_FAR = N_NAN = 16               # of them: far outside coverage, and NaN
TICK_PLAIN_ROWS = 256            # rows of each counted tick's plain checks
K5_PLAIN_ROWS = 32768            # window rows of each tick's plain K5 check
K6_PLAIN_ROWS = 2048             # slots of the last tick's plain K6 check

SAPPROX_EPS = 0.8                # S-Approx-DPC's main path (paper default)
EPS_SWEEP = (0.2, 0.4, 0.6, 0.8, 1.0)   # benchmarks/eps_sweep.py
SEL_PLAIN_ROWS = 8192            # rows of the dense fit's plain gated K1
PREFIX_PLAIN_ROWS = 65536        # leading rows of K7's plain check at 2^20

DIST_SHARDS = 4                  # logical shards of the distributed phases
DIST_PLAIN_TILES = 4             # row tiles of K8/K9's plain checks at 5.8M
DIST_PLAIN_ROWS = 65536          # shard rows of K10/K11's plain checks


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median of REPS runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_once(fn):
    """(result, ms) of one run, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the f32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def k1_work(n: int, m: int, d: int) -> tuple[float, float]:
    """Bytes and operations of fused_count_topk: each input read once,
    each output written once; 3d+1 operations per pair."""
    nbytes = 4 * (n * d + m * d) + 4 * n + 2 * 4 * 8 * n
    return nbytes, float(n) * m * (3 * d + 1)


def k3_needed_pairs(wl, m: int, topv: torch.Tensor) -> int:
    """The pairs the worklist sweep needs on this run's data, from its
    inputs and its (checked) answer: per row, the real columns of its
    in-d_cut entries and of the entries whose lb is at most the row's final
    8th d2 (``topv[:, 7]``), which no exact pruning can skip.  A row tile's
    entries are in ascending lb, so the second set is a prefix of its
    segment, found by a search on (row tile, lb's bits: lb >= 0)."""
    from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N
    n = topv.shape[0]
    dev = topv.device
    width = (m - wl.col_tile.long() * BLOCK_M).clamp(max=BLOCK_M)
    cum_all = torch.zeros(wl.n_kept + 1, dtype=torch.int64, device=dev)
    cum_cut = torch.zeros_like(cum_all)
    cum_all[1:] = torch.cumsum(width, 0)
    cum_cut[1:] = torch.cumsum(width * wl.in_cut, 0)
    key = (wl.row_tile() << 32) | wl.lb.view(torch.int32).long()
    tile = torch.arange(n, device=dev) // BLOCK_N
    tau = topv[:, -1].contiguous().view(torch.int32).long()
    p = torch.searchsorted(key, (tile << 32) | tau, right=True)
    ptr = wl.row_ptr.long()
    start, end = ptr[tile], ptr[tile + 1]
    return int((cum_all[p] - cum_all[start] + cum_cut[end] - cum_cut[p])
               .sum())


def k3_work(x, y, wl, needed: int) -> tuple[float, float]:
    """Bytes and operations of worklist_count_topk on this run's data: the
    inputs and the worklist read once, the outputs written once; 3d+1
    operations per pair it needs (``needed``, from ``k3_needed_pairs``)."""
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    nbytes = (4 * (n * d + m * d) + 4 * n + 2 * 4 * 8 * n
              + 4 * wl.row_ptr.numel() + 9 * wl.n_kept)
    return nbytes, float(needed) * (3 * d + 1)


def k2_work(x_key, y_key, d: int) -> tuple[float, float]:
    """Bytes and operations of masked_nn on these keys: a key test per
    pair, and 3d+1 operations for each pair whose column is denser."""
    n, m = x_key.numel(), y_key.numel()
    ys = torch.sort(y_key).values
    denser = float((m - torch.searchsorted(ys, x_key, right=True)).sum())
    nbytes = 4 * (n * d + n + m * d + m) + 8 * n
    return nbytes, float(n) * m + denser * (3 * d + 1)


def check_equal(name: str, got, want, what: str = "its plain version"):
    """Bit-equality of every output; returns the max abs error of the
    finite float outputs (0.0 when equal)."""
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            bad = (g != w) & ~(torch.isnan(g) & torch.isnan(w)) \
                if g.is_floating_point() else g != w
            raise AssertionError(f"{name}: kernel differs from {what} on "
                                 f"{int(bad.sum())} entries")
        if g.is_floating_point():
            fin = torch.isfinite(w)
            if fin.any():
                err = max(err, float((g[fin] - w[fin]).abs().max()))
    return err


def sub_worklist(wl, tiles: torch.Tensor):
    """The entries of the row tiles ``tiles`` (ascending), as a worklist of
    len(tiles) row tiles over the same columns."""
    from repro_torch.kernels.blocksparse import Worklist
    ptr = wl.row_ptr.long()
    starts, counts = ptr[tiles], ptr[tiles + 1] - ptr[tiles]
    new_ptr = torch.zeros(tiles.numel() + 1, dtype=torch.int64,
                          device=ptr.device)
    new_ptr[1:] = torch.cumsum(counts, 0)
    idx = (torch.repeat_interleave(starts - new_ptr[:-1], counts)
           + torch.arange(int(new_ptr[-1]), device=ptr.device))
    nbc = wl.n_total // wl.num_row_tiles
    return Worklist(row_ptr=new_ptr.to(torch.int32), col_tile=wl.col_tile[idx],
                    in_cut=wl.in_cut[idx], lb=wl.lb[idx],
                    n_kept=int(new_ptr[-1]), n_total=tiles.numel() * nbc)


def downstream(parent: torch.Tensor, mark: torch.Tensor) -> torch.Tensor:
    """Rows whose parent chain (themselves included) passes a marked row."""
    n = parent.numel()
    ar = torch.arange(n, device=parent.device)
    p = torch.where(parent >= 0, parent.long(), ar)
    mark = mark.clone()
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        mark |= mark[p]
        p = p[p]
    return mark


def float64_rho_check(pts64, rho, thr: float, rows) -> tuple[int, int]:
    """rho of ``rows`` against a float64 count, off a 4-ulp band around
    d_cut^2; returns (rows checked, rows with no pair in the band)."""
    band = 4 * float(np.spacing(np.float32(thr)))
    lo = torch.empty(rows.numel(), dtype=torch.int64, device=rows.device)
    hi = torch.empty_like(lo)
    step = max(1, (1 << 26) // pts64.shape[0])
    for r0 in range(0, rows.numel(), step):
        rr = rows[r0:r0 + step]
        d2 = ((pts64[rr, None, :] - pts64[None]) ** 2).sum(-1)
        lo[r0:r0 + step] = (d2 < thr - band).sum(1)
        hi[r0:r0 + step] = (d2 < thr + band).sum(1)
    got = rho[rows].to(torch.int64)
    off = int(((got < lo) | (got > hi)).sum())
    assert off == 0, \
        f"rho off the float64 count on {off} of {rows.numel()} rows"
    return rows.numel(), int((lo == hi).sum())


def float64_dependent_check(pts64, res, rows, d_cut: float | None) -> int:
    """Parent and delta of ``rows`` against a float64 masked search over
    all n: the parent is a nearest strictly-denser point ((inf, -1) at the
    peak) and the delta its distance (Ex-DPC: ``d_cut`` None) or, for
    Approx-DPC's cell maxima, d_cut where that point is within d_cut
    (rule 2) and its distance beyond (rule 3).  Returns the number of
    rule-2 rows."""
    dc32 = float(np.float32(d_cut if d_cut is not None else 0.0))
    key64 = res.rho_key.to(torch.float64)
    n_rule2 = 0
    step = max(1, (1 << 25) // pts64.shape[0])
    for r0 in range(0, rows.numel(), step):
        rr = rows[r0:r0 + step]
        d2 = ((pts64[rr, None, :] - pts64[None]) ** 2).sum(-1)
        d2 = torch.where(key64[None, :] > key64[rr, None], d2, float("inf"))
        best = d2.min(1).values
        par, dl = res.parent[rr].long(), res.delta[rr]
        peak = torch.isinf(best)
        assert bool((par[peak] == -1).all() and torch.isinf(dl[peak]).all()), \
            "a row with no denser point must get (inf, -1)"
        got = d2.gather(1, par.clamp_min(0)[:, None])[:, 0]
        assert bool((got[~peak] <= best[~peak] * (1 + 1e-6)).all()), \
            "a cell maximum's parent is not its nearest strictly-denser point"
        rule2 = ~peak & (best.sqrt() < dc32 * (1 - 1e-6))
        rule3 = ~peak & (best.sqrt() > dc32 * (1 + 1e-6))
        if d_cut is None:
            rule2, rule3 = peak & False, ~peak
        assert bool((dl[rule2] == dc32).all()), \
            "a cell maximum with a denser point within d_cut must get d_cut"
        torch.testing.assert_close(dl[rule3].double(), best[rule3].sqrt(),
                                   rtol=1e-6, atol=0)
        n_rule2 += int(rule2.sum())
    return n_rule2


def same_up_to_ties(x, a, b, lab_a, lab_b, what: str):
    """Two fits of the table ``x`` that may decide exact distance ties
    apart: rho, rho_key and delta equal bit for bit, parents equal except
    where both are equally near, labels equal away from the rows downstream
    of such a parent.  Returns (tied parents, rows downstream of them,
    labels that differ)."""
    from repro_torch.kernels.sweep import direct_d2
    for name in ("rho", "rho_key", "delta"):
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{what}: {name} differs"
    differ = a.parent != b.parent
    rows = torch.nonzero(differ).flatten()
    pa, pb = a.parent[rows].long(), b.parent[rows].long()
    assert bool((pa >= 0).all() and (pb >= 0).all() and torch.equal(
        direct_d2(x[rows], x[pa]), direct_d2(x[rows], x[pb]))), \
        f"{what}: a parent differs without a tie"
    tied = downstream(a.parent, differ) | downstream(b.parent, differ)
    assert torch.equal(lab_a[~tied], lab_b[~tied]), \
        f"{what}: labels differ away from tie-decided parents"
    return rows.numel(), int(tied.sum()), int((lab_a != lab_b).sum())


def k4_work(n: int, m: int, d: int) -> tuple[float, float]:
    """Bytes and operations of range_count: x and y read once, the counts
    written once; 3d+1 operations per pair."""
    return 4 * (n * d + m * d) + 4 * n, float(n) * m * (3 * d + 1)


def k5_work(n: int, m: int, d: int) -> tuple[float, float]:
    """Bytes and operations of range_count_signed: x, the batch and its
    signs read once, the sums written once; 3d+1 operations per pair."""
    return 4 * (n * d + m * d + m) + 4 * n, float(n) * m * (3 * d + 1)


def k6_work(keys, slots, d: int) -> tuple[float, float]:
    """Bytes and operations of gather_masked_nn on these keys and slots:
    the table, its keys and the slots read once, (d2, parent) written
    once; a key test per pair of a live slot and 3d+1 operations for each
    pair whose column is denser."""
    m, q = keys.numel(), slots.numel()
    live = slots[(slots >= 0) & (slots < m)]
    ks = torch.sort(keys).values
    denser = float((m - torch.searchsorted(ks, keys[live], right=True)).sum())
    nbytes = 4 * (m * d + m) + 8 * q + 8 * q
    return nbytes, float(live.numel()) * m + denser * (3 * d + 1)


def stream_kernels():
    """K4, K5, K6 and their plain versions, as the checks call them."""
    from repro_torch.kernels import ops, sweep

    def k4(x, y, d_cut):
        return ops.local_density_xy(x, y, d_cut)

    def k4_plain(x, y, d_cut):
        return sweep.range_count_plain(x, y, sweep.d2cut_of(d_cut)).float()

    def k5(x, y, signs, d_cut):
        return ops.local_density_delta(x, y, signs, d_cut)

    def k5_plain(x, y, signs, d_cut):
        return sweep.range_count_signed_plain(x, y, signs,
                                              sweep.d2cut_of(d_cut))

    def k6(table, keys, slots):
        return ops.dependent_masked_gather(table, keys, slots)

    def k6_plain(table, keys, slots):
        best, arg = sweep.gather_masked_nn_plain(table, keys, slots)
        return torch.sqrt(best), arg

    return k4, k4_plain, k5, k5_plain, k6, k6_plain


def stream_check_shapes(cases, card: str) -> dict:
    """K4/K5/K6 bit for bit against their plain versions at check shapes:
    K4 on up to 4,096 rows against all, K5 on all rows against a 512-row
    batch of mixed signs, K6 on up to 4,096 slots (the global peak among
    them, padding slots past and before the table at the end); K6 also
    against K2 on the gathered rows.  Times on the first case."""
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.kernels import ops
    k4, k4_plain, k5, k5_plain, k6, k6_plain = stream_kernels()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    times = {}
    for label, pts, dc, tie_keys in cases:
        x = torch.from_numpy(pts).to(dev)
        n = len(pts)
        q = x[:min(Q_CHECK, n)].contiguous()
        check_equal(f"range_count [{label}]", [k4(q, x, dc)],
                    [k4_plain(q, x, dc)])
        batch = x[torch.from_numpy(rng.permutation(n)[:512]).to(dev)]
        signs = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], len(batch))
                                 .astype(np.float32)).to(dev)
        check_equal(f"range_count_signed [{label}]", [k5(x, batch, signs, dc)],
                    [k5_plain(x, batch, signs, dc)])
        if tie_keys:        # a few key levels: many exact distance ties
            keys = torch.from_numpy((np.arange(n) % 3).astype(np.float32))
            keys = keys.to(dev)
        else:
            keys = k4(x, x, dc) + density_jitter(n, dev)
        real = np.concatenate([[int(torch.argmax(keys))],
                               rng.permutation(n)[:min(Q_CHECK, n) - 1]])
        pad = [n, n + 7, -1, 2**40]
        slots = torch.from_numpy(np.concatenate([real, pad]).astype(
            np.int64)).to(dev)
        got = k6(x, keys, slots)
        check_equal(f"gather_masked_nn [{label}]", got,
                    k6_plain(x, keys, slots))
        rows = slots[:len(real)]
        check_equal(f"gather_masked_nn [{label}]",
                    [t[:len(real)] for t in got],
                    ops.dependent_masked(x[rows], keys[rows].contiguous(), x,
                                         keys), "masked_nn on the rows")
        none = int((got[1][:len(real)] == -1).sum())
        assert none >= 1 and bool((got[1][len(real):] == -1).all()), \
            f"gather_masked_nn [{label}]: peak or padding slots not (inf, -1)"
        print(f"range_count, range_count_signed, gather_masked_nn == plain, "
              f"bit for bit: {label}, n={n} d={pts.shape[1]} ({none} slots "
              f"with no denser row, {len(pad)} padding slots; "
              f"gather_masked_nn == masked_nn on the gathered rows)",
              flush=True)
        if not times:
            times = {
                "range_count": {
                    "shape": f"{q.shape[0]} x {n}, d={pts.shape[1]}",
                    "ms": time_ms(lambda: k4(q, x, dc)),
                    "plain_ms": time_ms(lambda: k4_plain(q, x, dc))},
                "range_count_signed": {
                    "shape": f"{n} x {len(batch)}, d={pts.shape[1]}",
                    "ms": time_ms(lambda: k5(x, batch, signs, dc)),
                    "plain_ms": time_ms(lambda: k5_plain(x, batch, signs,
                                                         dc))},
                "gather_masked_nn": {
                    "shape": f"{slots.numel()} slots x {n}, "
                             f"d={pts.shape[1]}",
                    "ms": time_ms(lambda: k6(x, keys, slots)),
                    "plain_ms": time_ms(lambda: k6_plain(x, keys, slots))}}
            for name, t in times.items():
                print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, "
                      f"plain {t['plain_ms']:.3f} ms  ({card})", flush=True)
    return times


def run_stream(label: str, pts: np.ndarray, d_cut: float, ticks: int,
               card: str) -> dict:
    """The stream main path: ``fit`` on the first N_WINDOW points seeds
    the window at the first ``partial_fit``; one traced tick; then
    ``ticks`` counted ticks of STREAM_BATCH points, whose kernel inputs are
    kept; then the checks and ``predict``.  Returns the record, with each
    kernel's launches, times and bound at this stream's shapes."""
    from repro_torch import DPCEngine, ExecSpec, obs
    from repro_torch.kernels import ops, sweep
    from repro_torch.resilience.sanitize import AdmissionConfig
    from repro_torch.stream import QueryStatus, incremental
    k4, k4_plain, k5, k5_plain, k6, k6_plain = stream_kernels()
    dev = torch.device("cuda")
    n, B, d = N_WINDOW, STREAM_BATCH, pts.shape[1]
    batches = [pts[n + i * B:n + (i + 1) * B] for i in range(ticks + 2)]
    spec = ExecSpec(layout="block-sparse")
    eng = DPCEngine(d_cut, rho_min=10, window_capacity=n, batch_cap=B,
                    exec_spec=spec, admission=AdmissionConfig(policy="drop"))
    t0 = time.perf_counter()
    eng.fit(pts[:n])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.partial_fit(batches[0])       # seeds the window: a full recompute,
    torch.cuda.synchronize()          # then a tick re-querying all maxima
    seed_s = time.perf_counter() - t0
    s = eng.stream
    seeded = s.stats()

    # one traced tick: phase times and each phase's peak device memory
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    obs.configure("trace")
    obs.reset_spans()
    try:
        eng.partial_fit(batches[1])
    finally:
        obs.configure("off")
    phases: dict[str, float] = {}
    peaks: dict[str, float] = {}
    for sp in obs.spans():
        phases[sp["name"]] = phases.get(sp["name"], 0.0) + sp["host_s"]
        peaks[sp["name"]] = max(peaks.get(sp["name"], 0.0),
                                sp.get("peak_bytes", 0) / 1e9)

    # the counted ticks: counts zeroed just before, read just after; each
    # kernel's inputs kept (the window table is updated in place, so the
    # inputs hold a clone of it per tick)
    names = ("range_count", "range_count_signed", "gather_masked_nn")
    given: dict[str, list] = {k: [] for k in names}
    launch = (ops.local_density_xy, ops.local_density_delta,
              ops.dependent_masked_gather)
    frozen: dict = {}

    def keep(t):
        if t.data_ptr() == s.window.device.data_ptr():
            return frozen.setdefault("window", t.clone())
        return t

    def rec_k4(x, y, dc):
        given["range_count"].append((x, keep(y), dc))
        return launch[0](x, y, dc)

    def rec_k5(x, y, signs, dc):
        given["range_count_signed"].append((keep(x), y, signs, dc))
        return launch[1](x, y, signs, dc)

    def rec_k6(table, keys, slots):
        given["gather_masked_nn"].append((keep(table), keys, slots))
        return launch[2](table, keys, slots)

    # dirty_near's inputs on the last counted tick: the cell maxima's
    # coords and the cells the batch touched, for timing its two routes
    near_in: dict = {}
    near_fn = incremental.IncrementalGrid.dirty_near

    def rec_near(grid, coords, rc):
        near_in.update(coords=coords, rc=rc, touched=grid.last_touched)
        return near_fn(grid, coords, rc)

    per_tick = []
    (ops.local_density_xy, ops.local_density_delta,
     ops.dependent_masked_gather) = rec_k4, rec_k5, rec_k6
    incremental.IncrementalGrid.dirty_near = rec_near
    try:
        ops.reset_launch_counts()
        for i in range(2, ticks + 2):
            frozen.clear()
            before = s.stats()
            seen = {k: len(v) for k, v in given.items()}
            t0 = time.perf_counter()
            tick = eng.partial_fit(batches[i])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = s.stats()
            for k in names:
                assert len(given[k]) > seen[k], \
                    f"{label}: tick {i} never launched {k}"
            per_tick.append({
                "ms": 1e3 * dt, "rebuilt": bool(tick.rebuilt),
                "maxima": after["nn_maxima_total"] - before["nn_maxima_total"],
                "queried": after["nn_queries"] - before["nn_queries"],
                "live_cells": after["live_cells"]})
        launches = ops.launch_counts()
    finally:
        (ops.local_density_xy, ops.local_density_delta,
         ops.dependent_masked_gather) = launch
        incremental.IncrementalGrid.dirty_near = near_fn
    for k in names:
        assert launches[k] == len(given[k]) >= ticks, (k, launches[k])
    median_ms = statistics.median(t["ms"] for t in per_tick)
    print(f"{label} stream: window {n}, d={d}, d_cut={d_cut!r}, {ticks} "
          f"ticks of {B}: median tick {median_ms:.2f} ms (first tick after "
          f"the seeding fit {1e3 * seed_s:.1f} ms with the full recompute; "
          f"fit {1e3 * fit_s:.1f} ms); launches {launches}  ({card})",
          flush=True)
    print(f"  maxima re-queried/total per tick "
          f"{[(t['queried'], t['maxima']) for t in per_tick]}; live cells "
          f"{per_tick[-1]['live_cells']}; rebuilds "
          f"{sum(t['rebuilt'] for t in per_tick)}", flush=True)
    for name in ("engine.partial_fit", "stream.snapshot", "stream.tick",
                 "stream.push", "stream.grid_apply", "stream.rho_repair",
                 "stream.maxima", "stream.nn_update", "stream.assemble",
                 "labels.assign", "stream.continuity"):
        print(f"  phase {name}: {1e3 * phases.get(name, 0.0):.2f} ms, peak "
              f"{peaks.get(name, 0.0):.3f} GB")
    print(f"  traced tick: {held_gb:.3f} GB held before it", flush=True)

    # each counted tick's kernels against their plain versions on a slice;
    # the last tick's in full (K6: its first K6_PLAIN_ROWS slots)
    r = TICK_PLAIN_ROWS
    for i, ((x4, y4, c4), (x5, y5, s5, c5), (t6, k6k, s6)) in enumerate(zip(
            given["range_count"], given["range_count_signed"],
            given["gather_masked_nn"])):
        check_equal(f"range_count [{label} tick {i}]", [k4(x4[:r], y4, c4)],
                    [k4_plain(x4[:r], y4, c4)])
        xs = x5[:K5_PLAIN_ROWS]
        check_equal(f"range_count_signed [{label} tick {i}]",
                    [k5(xs, y5, s5, c5)], [k5_plain(xs, y5, s5, c5)])
        check_equal(f"gather_masked_nn [{label} tick {i}]",
                    k6(t6, k6k, s6[:r]), k6_plain(t6, k6k, s6[:r]))
    (x4, y4, c4), = given["range_count"][-1:]
    (x5, y5, s5, c5), = given["range_count_signed"][-1:]
    (t6, k6k, s6), = given["gather_masked_nn"][-1:]
    errs, times, bounds = {}, {}, {}
    want, p4 = timed_once(lambda: k4_plain(x4, y4, c4))
    errs["range_count"] = check_equal(f"range_count [{label} last tick]",
                                      [k4(x4, y4, c4)], [want])
    want, p5 = timed_once(lambda: k5_plain(x5, y5, s5, c5))
    errs["range_count_signed"] = check_equal(
        f"range_count_signed [{label} last tick]", [k5(x5, y5, s5, c5)],
        [want])
    sl = s6[:K6_PLAIN_ROWS]
    want, p6 = timed_once(lambda: k6_plain(t6, k6k, sl))
    errs["gather_masked_nn"] = check_equal(
        f"gather_masked_nn [{label} last tick]",
        [v[:sl.numel()] for v in k6(t6, k6k, s6)], want)
    times["range_count"] = {"ms": time_ms(lambda: k4(x4, y4, c4)),
                            "plain_ms": p4, "shape": f"{x4.shape[0]} x "
                            f"{y4.shape[0]}"}
    times["range_count_signed"] = {
        "ms": time_ms(lambda: k5(x5, y5, s5, c5)), "plain_ms": p5,
        "shape": f"{x5.shape[0]} x {y5.shape[0]}"}
    rows6 = t6[s6]
    times["gather_masked_nn"] = {
        "ms": time_ms(lambda: k6(t6, k6k, s6)), "plain_ms": p6,
        "plain_rows": sl.numel(),
        "shape": f"{s6.numel()} slots x {t6.shape[0]}",
        # K2 on the same rows, gathered: the one-pass grid K6 replaces
        "masked_nn_ms": time_ms(lambda: ops.dependent_masked(
            rows6, k6k[s6].contiguous(), t6, k6k))}
    bounds["range_count"] = k4_work(x4.shape[0], y4.shape[0], d)
    bounds["range_count_signed"] = k5_work(x5.shape[0], y5.shape[0], d)
    bounds["gather_masked_nn"] = k6_work(k6k, s6, d)
    kernels = {}
    for k in names:
        b_ms, by = bound_ms(*bounds[k])
        kernels[k] = {**times[k], "launches": launches[k],
                      "launches_per_tick": launches[k] / ticks,
                      "max_abs_err": errs[k], "bound_ms": b_ms,
                      "bound_by": by}
        print(f"  {k} [{times[k]['shape']}]: kernel {times[k]['ms']:.3f} ms, "
              f"bound {b_ms:.3f} ms ({by}), plain {times[k]['plain_ms']:.1f} "
              f"ms{' on ' + str(sl.numel()) + ' slots' if k == names[2] else ''}"
              f", {launches[k] / ticks:.2f} launches per tick  ({card})",
              flush=True)
    print(f"  masked_nn on the same {s6.numel()} rows, gathered: "
          f"{times['gather_masked_nn']['masked_nn_ms']:.3f} ms  ({card})",
          flush=True)
    print(f"  every counted tick: the three kernels == plain, bit for bit, "
          f"on {r} rows ({K5_PLAIN_ROWS} window rows for K5); the last tick's "
          f"K4 and K5 on all rows, K6 on {sl.numel()} slots", flush=True)
    del given, frozen

    # dirty_near's two routes on the last tick's maxima and touched cells:
    # dilated touched-cell keys looked up in a sorted set, and chunked
    # Chebyshev differences (the only route where (2 rc + 1)^d is large)
    near_rec = None
    if near_in.get("touched") is not None:
        q = torch.as_tensor(near_in["coords"], dtype=torch.int64, device=dev)
        t = torch.unique(torch.from_numpy(near_in["touched"].astype(
            np.int64)).to(dev), dim=0)
        rc = near_in["rc"]
        routes = {"dilated": incremental._near_dilated,
                  "pairwise": incremental._near_pairwise}
        got = {k: f(q, t, rc) for k, f in routes.items()}
        assert torch.equal(got["dilated"], got["pairwise"]), \
            f"{label}: dirty_near's routes disagree"
        near_rec = {"maxima": q.shape[0], "touched": t.shape[0], "rc": rc,
                    "near": int(got["dilated"].sum()),
                    **{f"{k}_ms": time_ms(lambda f=f: f(q, t, rc))
                       for k, f in routes.items()}}
        print(f"  dirty_near [{q.shape[0]} maxima x {t.shape[0]} touched "
              f"cells, radius {rc}]: dilated keys "
              f"{near_rec['dilated_ms']:.3f} ms, pairwise "
              f"{near_rec['pairwise_ms']:.3f} ms, equal ({near_rec['near']} "
              f"near)  ({card})", flush=True)

    # the end of the stream against a from-scratch fit of its window
    res = s.result
    wpts = s.window_points()
    fresh = DPCEngine(d_cut, rho_min=10, exec_spec=spec)
    fresh.fit(wpts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.fit(wpts)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    w = torch.from_numpy(wpts).to(dev)
    ties, tied, lab_diff = same_up_to_ties(
        w, fresh.result, res, fresh.clustering.labels, s.clustering.labels,
        f"{label} stream vs from-scratch fit")
    pts64 = w.double()
    gen = torch.Generator().manual_seed(1)
    rows = torch.randperm(n, generator=gen)[:Q_CHECK].to(dev)
    _, clear = float64_rho_check(pts64, res.rho, sweep.d2cut_of(d_cut), rows)
    requeried = s6[torch.randperm(s6.numel(), generator=gen)[:Q_CHECK]
                   .to(dev)]
    n_rule2 = float64_dependent_check(pts64, res, requeried, d_cut)
    print(f"  stream == from-scratch block-sparse fit of its window: rho, "
          f"rho_key, delta bit for bit; {ties} parents decided by exact "
          f"ties ({tied} rows downstream, {lab_diff} labels differ); rho == "
          f"float64 on {Q_CHECK} rows ({clear} clear of the band); "
          f"parent/delta == float64 on {requeried.numel()} re-queried "
          f"maxima ({n_rule2} rule 2); full recompute {1e3 * full_s:.1f} ms "
          f"= {full_s * 1e3 / median_ms:.2f} x the median tick  ({card})",
          flush=True)
    del fresh

    # predict: the next points of the stream, far rows, NaN rows
    rng = np.random.default_rng(2)
    tail = pts[n + (ticks + 2) * B:][:N_PREDICT - N_FAR - N_NAN]
    far = rng.uniform(4e8, 5e8, (N_FAR, d)).astype(np.float32)
    nan = np.full((N_NAN, d), np.nan, np.float32)
    order = rng.permutation(N_PREDICT)
    queries = np.concatenate([tail, far, nan])[order]
    kind = np.concatenate([np.zeros(len(tail)), np.ones(N_FAR),
                           np.full(N_NAN, 2)])[order]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.predict(queries)
    predict_s = time.perf_counter() - t0
    assert (out.status[kind == 1] == QueryStatus.MISS_FALLBACK).all(), \
        "far queries must fall back to the nearest center"
    assert (out.status[kind == 2] == QueryStatus.QUARANTINED).all() and \
        (out.labels[kind == 2] == -1).all(), "NaN queries must be quarantined"
    hit = np.nonzero(out.status == QueryStatus.HIT)[0]
    assert len(hit) > 0, "no query landed within d_cut of the window"
    labels_w = torch.from_numpy(eng.labels_).to(dev)
    pick = hit[rng.permutation(len(hit))[:1024]]
    qq = torch.from_numpy(queries[pick]).to(dev, torch.float64)
    got = torch.from_numpy(out.labels[pick]).to(dev)
    for c0 in range(0, len(pick), 16):
        d2 = ((qq[c0:c0 + 16, None, :] - pts64[None]) ** 2).sum(-1)
        best = d2.min(1).values
        assert bool((best.sqrt() < d_cut * (1 + 1e-6)).all()), \
            "a HIT query has no window point within d_cut"
        near = d2 <= best[:, None] * (1 + 1e-6)
        ok = (near & (labels_w[None, :] == got[c0:c0 + 16, None])).any(1)
        assert bool(ok.all()), "a HIT label is not its nearest point's"
    counts = {st.name: int((out.status == st).sum()) for st in QueryStatus}
    print(f"  predict: {N_PREDICT} queries in {1e3 * predict_s:.1f} ms: "
          f"{counts}; HIT labels == float64 nearest window point on "
          f"{len(pick)} queries  ({card})", flush=True)
    return {"n": n, "d": d, "d_cut": d_cut, "batch": B, "ticks": ticks,
            "fit_ms": 1e3 * fit_s, "seed_tick_ms": 1e3 * seed_s,
            "seeded_stats": seeded, "per_tick": per_tick,
            "median_tick_ms": median_ms, "launches": launches,
            "phases_ms": {k: 1e3 * v for k, v in phases.items()},
            "phases_peak_gb": peaks, "held_gb": held_gb,
            "kernels": kernels, "full_recompute_ms": 1e3 * full_s,
            "full_over_tick": full_s * 1e3 / median_ms,
            "parent_ties": ties, "rule2_requeried": n_rule2,
            "predict_ms": 1e3 * predict_s, "predict_status": counts,
            "dirty_near": near_rec,
            "stats": s.stats()}


def sapprox_kernels():
    """Gated K1, gated K3 and K7 and their plain versions, as the checks
    call them."""
    from repro_torch.kernels import ops, sweep

    def k1s(x, y, d_cut, sel):
        return ops.fused_sweep(x, y, d_cut, nn_sel=sel)

    def k1s_plain(x, y, d_cut, sel):
        c, v, i = sweep.fused_count_topk_plain(x, y, sweep.d2cut_of(d_cut),
                                               sel=sel.bool())
        return c.to(torch.float32), v, i

    def k3s(x, y, d_cut, wl, sel, live=None):
        return ops.fused_sweep(x, y, d_cut, nn_sel=sel, worklist=wl,
                               live=live)

    def k3s_plain(x, y, d_cut, wl, sel):
        c, v, i = sweep.worklist_count_topk_plain(
            x, y, sweep.d2cut_of(d_cut), wl, sel=sel.bool())
        return c.to(torch.float32), v, i

    def k7(pts):
        return ops.dependent_prefix(pts)

    def k7_plain(pts):
        best, arg = sweep.prefix_nn_plain(pts)
        return torch.sqrt(best), arg

    return k1s, k1s_plain, k3s, k3s_plain, k7, k7_plain


def sel_counts(sel: torch.Tensor) -> torch.Tensor:
    """Per column tile, the columns a gate lets into the kept k."""
    from repro_torch.kernels.blocksparse import BLOCK_M
    nbc = -(-sel.numel() // BLOCK_M)
    return torch.bincount(torch.nonzero(sel).flatten() // BLOCK_M,
                          minlength=nbc)


def sapprox_check_shapes(cases, card: str) -> dict:
    """Gated K1/K3 bit for bit against their plain versions and gated K3
    against gated K1, under each gate; the all-ones gate against the
    ungated sweep; K7 against its plain version and K2 with key -position.
    Times on the first case, with the representatives' gate."""
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid
    from repro_torch.core.sapproxdpc import representatives
    from repro_torch.kernels import blocksparse, ops
    k1s, k1s_plain, k3s, k3s_plain, k7, k7_plain = sapprox_kernels()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    out: dict = {"live": {}}
    for label, pts, dc in cases:
        x = torch.from_numpy(pts).to(dev)
        n, d = x.shape
        grid = build_grid(x, dc) if d <= 8 else None
        gs = x if grid is None else grid.points
        few = torch.zeros(n, dtype=torch.bool, device=dev)
        few[torch.from_numpy(rng.permutation(n)[:5]).to(dev)] = True
        gates = {"ones": torch.ones(n, dtype=torch.bool, device=dev),
                 "zeros": torch.zeros(n, dtype=torch.bool, device=dev),
                 "random": torch.from_numpy(rng.uniform(size=n) < 0.4)
                 .to(dev), "few": few}
        queries = dict.fromkeys(gates, gs)
        if grid is not None:
            reps, _ = representatives(grid, dc, SAPPROX_EPS)
            sel = torch.zeros(n, dtype=torch.bool, device=dev)
            sel[reps] = True
            gates["reps"], queries["reps"] = sel, gs[reps].contiguous()
        for gname, sel in gates.items():
            q = queries[gname]
            qr = q[:min(q.shape[0], Q_CHECK + 37)].contiguous()  # ragged
            got = k1s(qr, gs, dc, sel)
            check_equal(f"fused_count_topk_sel [{label}, {gname}]", got,
                        k1s_plain(qr, gs, dc, sel))
            if gname == "ones":
                check_equal(f"fused_count_topk_sel [{label}, ones]", got,
                            ops.fused_sweep(qr, gs, dc), "the ungated K1")
            wl = blocksparse.build_flat_worklist(
                q, gs, dc, nn_col_counts=sel_counts(sel))
            got = k3s(q, gs, dc, wl, sel)
            check_equal(f"worklist_count_topk_sel [{label}, {gname}]", got,
                        k3s_plain(q, gs, dc, wl, sel))
            check_equal(f"worklist_count_topk_sel [{label}, {gname}]", got,
                        k1s(q, gs, dc, sel), "gated fused_count_topk")
            live = torch.zeros(wl.num_row_tiles, dtype=torch.int32,
                               device=dev)
            k3s(q, gs, dc, wl, sel, live=live)
            out["live"][f"{label}, {gname}"] = {
                "rows": q.shape[0], "kept": wl.n_kept, "total": wl.n_total,
                "live": int(live.sum())}
        key = ops.fused_sweep(x, x, dc)[0] + density_jitter(n, dev)
        tbl = x[torch.argsort(key, descending=True, stable=True)]
        got = k7(tbl)
        check_equal(f"prefix_nn [{label}]", got, k7_plain(tbl))
        pos = -torch.arange(n, dtype=torch.float32, device=dev)
        check_equal(f"prefix_nn [{label}]", got,
                    ops.dependent_masked(tbl, pos, tbl, pos),
                    "masked_nn with key -position")
        print(f"fused_count_topk_sel, worklist_count_topk_sel == plain "
              f"(and == each other), prefix_nn == plain == masked_nn with "
              f"key -position, bit for bit: {label}, n={n} d={d}, gates "
              f"{list(gates)}", flush=True)
        if "times" not in out and "reps" in gates:
            sel, q = gates["reps"], queries["reps"]
            wl = blocksparse.build_flat_worklist(
                q, gs, dc, nn_col_counts=sel_counts(sel))
            out["times"] = {
                "fused_count_topk_sel": {
                    "shape": f"{q.shape[0]} reps x {n}, d={d}",
                    "ms": time_ms(lambda: k1s(q, gs, dc, sel)),
                    "plain_ms": time_ms(lambda: k1s_plain(q, gs, dc, sel)),
                    "ungated_ms": time_ms(lambda: ops.fused_sweep(q, gs,
                                                                  dc))},
                "worklist_count_topk_sel": {
                    "shape": f"{q.shape[0]} reps x {n}, d={d}, "
                             f"{wl.n_kept} entries",
                    "ms": time_ms(lambda: k3s(q, gs, dc, wl, sel)),
                    "plain_ms": time_ms(lambda: k3s_plain(q, gs, dc, wl,
                                                          sel))},
                "prefix_nn": {
                    "shape": f"n={n} d={d}",
                    "ms": time_ms(lambda: k7(tbl)),
                    "plain_ms": time_ms(lambda: k7_plain(tbl))}}
            for name, t in out["times"].items():
                print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, "
                      f"plain {t['plain_ms']:.3f} ms  ({card})", flush=True)
    one = torch.zeros((1, 3), device=dev)
    d1, p1 = k7(one)
    assert bool(torch.isinf(d1).all()) and int(p1[0]) == -1, \
        "prefix_nn of one row must be (inf, -1)"
    return out


def float64_sapprox_check(pts64, res, rep_ids, is_rep, rows,
                          d_cut: float) -> tuple[int, int]:
    """S-Approx-DPC's representatives ``rows`` (original ids) against a
    float64 masked search among the representatives ``rep_ids``: the
    parent is a nearest strictly denser representative ((inf, -1) at the
    peak); the delta is d_cut where that one is within d_cut (phase 1)
    and its distance beyond (phase 2).  Returns the rows of each phase."""
    dc32 = float(np.float32(d_cut))
    key64 = res.rho_key.to(torch.float64)
    rp, rk = pts64[rep_ids], key64[rep_ids]
    n1 = n2 = 0
    step = max(1, (1 << 25) // rep_ids.numel())
    for r0 in range(0, rows.numel(), step):
        rr = rows[r0:r0 + step]
        d2 = ((pts64[rr, None, :] - rp[None]) ** 2).sum(-1)
        d2 = torch.where(rk[None, :] > key64[rr, None], d2, float("inf"))
        best = d2.min(1).values
        par, dl = res.parent[rr].long(), res.delta[rr]
        peak = torch.isinf(best)
        assert bool((par[peak] == -1).all() and torch.isinf(dl[peak]).all()), \
            "a representative with no denser one must get (inf, -1)"
        pc = par.clamp_min(0)
        got = ((pts64[rr] - pts64[pc]) ** 2).sum(-1)
        assert bool((is_rep[pc] & (key64[pc] > key64[rr]))[~peak].all()), \
            "a representative's parent is not a denser representative"
        assert bool((got[~peak] <= best[~peak] * (1 + 1e-6)).all()), \
            "a representative's parent is not its nearest denser one"
        ph1 = ~peak & (best.sqrt() < dc32 * (1 - 1e-6))
        ph2 = ~peak & (best.sqrt() > dc32 * (1 + 1e-6))
        assert bool((dl[ph1] == dc32).all()), \
            "a representative with a denser one within d_cut must get d_cut"
        torch.testing.assert_close(dl[ph2].double(), best[ph2].sqrt(),
                                   rtol=1e-6, atol=0)
        n1, n2 = n1 + int(ph1.sum()), n2 + int(ph2.sum())
    return n1, n2


def k3_row_tile_check(x, y, d_cut, wl, sel, name: str, card: str):
    """K3 (gated where ``sel`` is given) on TILES_CHECK row tiles spread
    over a fit's table, against all columns: equal to the fit's full
    sweep, to dense K1 (gated alike) and to its plain version.  Returns
    (max abs err, times, the work for the bound, the worklist record)."""
    from repro_torch.kernels import ops, sweep
    from repro_torch.kernels.blocksparse import BLOCK_N
    dev = x.device
    gate = {} if sel is None else {"nn_sel": sel}
    nbr = wl.num_row_tiles
    tiles = torch.linspace(0, nbr - 2, TILES_CHECK).round().long().unique()
    tiles = tiles.to(dev)
    sub = sub_worklist(wl, tiles)
    rows = (tiles[:, None] * BLOCK_N
            + torch.arange(BLOCK_N, device=dev)).flatten()
    sx = x[rows].contiguous()
    got = ops.fused_sweep(sx, y, d_cut, worklist=sub, **gate)
    fit_out = ops.fused_sweep(x, y, d_cut, worklist=wl, **gate)
    what = f"{name} [main path, row tiles]"
    check_equal(what, got, [t[rows] for t in fit_out], "the fit's full sweep")
    check_equal(what, got, ops.fused_sweep(sx, y, d_cut, **gate),
                "dense K1")
    plain_sel = None if sel is None else sel.bool()
    want, plain_ms = timed_once(lambda: sweep.worklist_count_topk_plain(
        sx, y, sweep.d2cut_of(d_cut), sub, sel=plain_sel))
    err = check_equal(what, got, (want[0].to(torch.float32), *want[1:]))
    live = torch.zeros(nbr, dtype=torch.int32, device=dev)
    ops.fused_sweep(x, y, d_cut, worklist=wl, live=live, **gate)
    needed = k3_needed_pairs(wl, y.shape[0], fit_out[1])
    times = {"ms": time_ms(lambda: ops.fused_sweep(x, y, d_cut, worklist=wl,
                                                   **gate)),
             "plain_ms": plain_ms, "plain_row_tiles": tiles.numel()}
    rec = {"kept": wl.n_kept, "total": wl.n_total,
           "in_cut": int(wl.in_cut.sum()), "live": int(live.sum()),
           "needed_pairs": needed, "pruned_frac": wl.pruned_frac,
           "live_frac_of_dense": int(live.sum()) / wl.n_total}
    print(f"{name} == plain == the fit's sweep == dense K1, bit for bit, on "
          f"{tiles.numel()} row tiles x {y.shape[0]} columns; worklist "
          f"{wl.n_kept} of {wl.n_total} tile pairs ({rec['in_cut']} in "
          f"d_cut), {rec['live']} computed, {needed} pairs needed; kernel "
          f"{times['ms']:.3f} ms, plain {plain_ms:.1f} ms on the row tiles  "
          f"({card})", flush=True)
    return err, times, k3_work(x, y, wl, needed), rec


def k2_fit_check(calls, what: str, card: str):
    """K2 on the calls a fit made: each against its plain version on its
    first K2_PLAIN_ROWS rows, timed on all.  Returns (max abs err, times,
    the work for the bound)."""
    from repro_torch.kernels import ops, sweep
    err, ms, plain_ms, nbytes, nops = 0.0, 0.0, 0.0, 0.0, 0.0
    for i, (xq, xk, y, yk) in enumerate(calls):
        r = min(K2_PLAIN_ROWS, xq.shape[0])
        want, p_ms = timed_once(lambda: sweep.masked_nn_plain(
            xq[:r], xk[:r], y, yk))
        err = max(err, check_equal(
            f"masked_nn [{what}, call {i}]",
            [t[:r] for t in ops.dependent_masked(xq, xk, y, yk)],
            (torch.sqrt(want[0]), want[1])))
        ms += time_ms(lambda: ops.dependent_masked(xq, xk, y, yk))
        plain_ms += p_ms
        nb, no = k2_work(xk, yk, xq.shape[1])
        nbytes, nops = nbytes + nb, nops + no
    rows = [c[0].shape[0] for c in calls]
    b_ms, by = bound_ms(nbytes, nops)
    print(f"masked_nn == plain, bit for bit, on the first {K2_PLAIN_ROWS} of "
          f"{rows} rows x {calls[0][2].shape[0]} ({what}); kernel {ms:.3f} "
          f"ms on all rows, bound {b_ms:.3f} ms ({by}), plain "
          f"{plain_ms:.3f} ms on the slice  ({card})", flush=True)
    return err, {"ms": ms, "plain_ms": plain_ms, "rows": rows,
                 "plain_rows": K2_PLAIN_ROWS, "bound_ms": b_ms,
                 "bound_by": by}, (nbytes, nops)


def traced(fit, names, card: str, what: str):
    """Phase times and each phase's peak device memory of one traced
    ``fit()`` (a span records the most allocated while it was open, the
    script's own tensors included: ``held_gb`` of them at the start)."""
    from repro_torch import obs
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    obs.configure("trace")
    obs.reset_spans()
    try:
        with obs.span("smoke.traced_fit"):
            fit()
    finally:
        obs.configure("off")
    phases: dict[str, float] = {}
    peaks: dict[str, float] = {}
    for sp in obs.spans():
        phases[sp["name"]] = phases.get(sp["name"], 0.0) + sp["host_s"]
        peaks[sp["name"]] = max(peaks.get(sp["name"], 0.0),
                                sp.get("peak_bytes", 0) / 1e9)
    for name in names:
        print(f"  phase {name}: {1e3 * phases.get(name, 0.0):.2f} ms, peak "
              f"{peaks.get(name, 0.0):.3f} GB")
    print(f"  {what}: peak device memory {peaks['smoke.traced_fit']:.3f} "
          f"GB, of which {held_gb:.3f} GB held by the script before the fit"
          f"  ({card})", flush=True)
    return {"phases_ms": {k: 1e3 * v for k, v in phases.items()},
            "phases_peak_gb": peaks, "held_gb": held_gb,
            "peak_gb": peaks["smoke.traced_fit"]}


def dist_kernels():
    """K8-K11 and their plain versions, as the checks call them."""
    from repro_torch.kernels import ops, sweep

    def k8(x, y, d_cut, wl):
        return ops.local_density_xy(x, y, d_cut, worklist=wl)

    def k8_plain(x, y, d_cut, wl):
        return sweep.worklist_range_count_plain(
            x, y, sweep.d2cut_of(d_cut), wl).float()

    def k9(x, xk, y, yk, wl, live=None):
        return ops.dependent_masked(x, xk, y, yk, worklist=wl, live=live)

    def k9_plain(x, xk, y, yk, wl):
        best, arg = sweep.worklist_masked_nn_plain(x, xk, y, yk, wl)
        return torch.sqrt(best), arg

    def k10(x, win, st, en, d_cut):
        return ops.halo_density(x, win, st, en, d_cut)

    def k10_plain(x, win, st, en, d_cut):
        return sweep.halo_range_count_plain(x, win, st, en,
                                            sweep.d2cut_of(d_cut)).float()

    def k11(x, xk, win, wk, st, en, d_cut):
        return ops.halo_dependent(x, xk, win, wk, st, en, d_cut)

    def k11_plain(x, xk, win, wk, st, en, d_cut):
        best, arg = sweep.halo_masked_nn_plain(x, xk, win, wk, st, en,
                                               sweep.d2cut_of(d_cut))
        return torch.sqrt(best), arg, torch.isfinite(best)

    return k8, k8_plain, k9, k9_plain, k10, k10_plain, k11, k11_plain


def entry_widths(wl, m: int) -> torch.Tensor:
    """(W,) int64 real columns of each worklist entry's column tile."""
    from repro_torch.kernels.blocksparse import BLOCK_M
    return (m - wl.col_tile.long() * BLOCK_M).clamp(max=BLOCK_M)


def tile_rows(wl, n: int) -> torch.Tensor:
    """(row tiles,) int64 real rows of each row tile."""
    from repro_torch.kernels.blocksparse import BLOCK_N
    t = torch.arange(wl.num_row_tiles, device=wl.row_ptr.device)
    return (n - t * BLOCK_N).clamp(max=BLOCK_N)


def k8_work(x, y, wl) -> tuple[float, float]:
    """Bytes and operations of worklist_range_count: x, y and the worklist
    read once (row_ptr, col_tile, in_cut), the counts written once; 3d+1
    operations per pair of an in-d_cut entry."""
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    pairs = float((entry_widths(wl, m) * wl.in_cut
                   * tile_rows(wl, n)[wl.row_tile()]).sum())
    nbytes = (4 * (n * d + m * d) + 4 * n + 4 * wl.row_ptr.numel()
              + 5 * wl.n_kept)
    return nbytes, pairs * (3 * d + 1)


def k9_work(x, xk, y, yk, wl, best_d2, sample: int = 2048,
            gen=None) -> tuple[float, float, dict]:
    """Bytes and operations of worklist_masked_nn on this run's data.
    Bytes: x, its keys, y, its keys and the ring (row_ptr, col_tile, lb)
    read once, (d2, parent) written once.  Operations: per row, a key test
    for each column of the entries whose lb is at most the row's final
    best d2 (a prefix of its ring, found by a search on (row tile, lb's
    bits) as in ``k3_needed_pairs``; rows keyed +inf need none), and 3d+1
    for each of those columns that is denser: counted on ``sample`` random
    rows and scaled by their share of the key tests."""
    from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    dev = x.device
    width = entry_widths(wl, m)
    cum = torch.zeros(wl.n_kept + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(width, 0)
    key = (wl.row_tile() << 32) | wl.lb.view(torch.int32).long()
    tile = torch.arange(n, device=dev) // BLOCK_N
    tau = best_d2.contiguous().view(torch.int32).long()
    p = torch.searchsorted(key, (tile << 32) | tau, right=True)
    start = wl.row_ptr.long()[tile]
    seeks = xk < float("inf")
    needed = torch.where(seeks, cum[p] - cum[start], 0)
    total = float(needed.sum())
    rows = torch.nonzero(seeks).flatten()
    rows = rows[torch.randperm(rows.numel(), generator=gen)[:sample]
                .to(dev)]
    lane = torch.arange(BLOCK_M, device=dev)
    s_needed = s_denser = 0
    for r in rows.tolist():
        tiles = wl.col_tile[int(start[r]):int(p[r])].long()
        cols = (tiles[:, None] * BLOCK_M + lane).flatten()
        cols = cols[cols < m]
        s_needed += cols.numel()
        s_denser += int((yk[cols] > xk[r]).sum())
    denser = total * s_denser / max(s_needed, 1)
    nbytes = (4 * (n * d + n + m * d + m) + 4 * wl.row_ptr.numel()
              + 8 * wl.n_kept + 8 * n)
    return nbytes, total + denser * (3 * d + 1), {
        "key_tests": total, "denser_est": denser, "sample_rows": rows.numel()}


def span_pairs(st, en, w: int) -> torch.Tensor:
    """(n,) int64 window columns inside each row's spans (clipped)."""
    a = st.long().clamp_min(0)
    b = en.long().clamp(max=w)
    return (b - a).clamp_min(0).sum(1)


def k10_work(x, win, st, en) -> tuple[float, float]:
    """Bytes and operations of halo_range_count: x, the window and the
    spans read once, the counts written once; 3d+1 operations per window
    column inside a row's spans."""
    (n, d), w = x.shape, win.shape[0]
    pairs = float(span_pairs(st, en, w).sum())
    return 4 * (n * d + w * d) + 8 * st.numel() + 4 * n, pairs * (3 * d + 1)


def k11_work(x, xk, win, wk, st, en) -> tuple[float, float]:
    """Bytes and operations of halo_masked_nn: x, its keys, the window, its
    keys and the spans read once, (delta, parent, found) written once; a
    key test per window column inside a row's spans and 3d+1 operations
    for each denser one (counted exactly, in row blocks)."""
    from repro_torch.kernels import sweep
    (n, d), w = x.shape, win.shape[0]
    pairs = float(span_pairs(st, en, w).sum())
    denser = 0
    step = sweep._span_rows(st, en)
    for r0 in range(0, n, step):
        idx, valid = sweep._span_candidates(st[r0:r0 + step],
                                            en[r0:r0 + step], w)
        denser += int((valid & (wk[idx] > xk[r0:r0 + step, None, None]))
                      .sum())
    nbytes = 4 * (n * d + n + w * d + w) + 8 * st.numel() + 9 * n
    return nbytes, pairs + denser * (3 * d + 1)


def dist_check_shapes(cases, card: str) -> dict:
    """K8-K11 bit for bit against their plain versions at check shapes,
    and against the dense kernels on the same inputs: for each case the
    grid-sorted table (d <= 8) split into three shards as
    ``distributed_dpc`` splits it (rows padded at 1e9, so the last shard
    ends in padded rows, keyed +inf as queries and -inf in the table),
    shard 1 cut to a row count that is not a multiple of the tile.  K8 on
    the count-only worklist == K4, K9 on the best-1 ring == K2 (computed
    entries counted); for d <= 8 each shard's halo window through the
    ppermute ring, K10/K11 on its window-local spans (empty spans turn
    negative), and with spans covering the whole window (plus a reversed
    and a negative span) K10 == K4 and K11 == K2 masked to d_cut.  Times
    on the first case."""
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid, point_span_bounds
    from repro_torch.distributed import dpc as ddpc
    from repro_torch.kernels import blocksparse, ops, sweep
    from repro_torch.launch import ShardMesh
    k8, k8_plain, k9, k9_plain, k10, k10_plain, k11, k11_plain = \
        dist_kernels()
    dev = torch.device("cuda")
    mesh = ShardMesh.on(dev, shards=3)
    times, computed = {}, {}
    for label, pts, dc in cases:
        x = torch.from_numpy(pts).to(dev)
        halo = pts.shape[1] <= 8
        grid = build_grid(x, dc) if halo else None
        xs = grid.points if halo else x
        n = xs.shape[0]
        m = -(-n // 3) * 3 + 3                   # three padded rows at least
        key = ops.local_density_xy(xs, xs, dc) + density_jitter(n, dev)
        tbl = ddpc._pad_rows(xs, m, sweep.PAD_COORD)
        tk = ddpc._pad_rows(key, m, float("-inf"))
        qk_all = ddpc._pad_rows(key, m, float("inf"))
        per = m // 3
        cut = per - 37 if per > 300 else per    # shard 1: a ragged count
        for s in range(3):
            r0, r1 = s * per, (s * per + cut if s == 1 else (s + 1) * per)
            q, qk = tbl[r0:r1], qk_all[r0:r1]
            wl = blocksparse.build_flat_worklist(q, tbl, dc, nn=None)
            got = k8(q, tbl, dc, wl)
            check_equal(f"worklist_range_count [{label}, shard {s}]", [got],
                        [k8_plain(q, tbl, dc, wl)])
            check_equal(f"worklist_range_count [{label}, shard {s}]", [got],
                        [ops.local_density_xy(q, tbl, dc)], "dense K4")
            ring = blocksparse.build_flat_worklist(q, tbl, count=False,
                                                   nn="best1")
            live = torch.zeros(ring.num_row_tiles, dtype=torch.int32,
                               device=dev)
            got = k9(q, qk, tbl, tk, ring, live)
            check_equal(f"worklist_masked_nn [{label}, shard {s}]", got,
                        k9_plain(q, qk, tbl, tk, ring))
            check_equal(f"worklist_masked_nn [{label}, shard {s}]", got,
                        ops.dependent_masked(q, qk, tbl, tk), "dense K2")
            computed[f"{label} shard {s}"] = [int(live.sum()), ring.n_kept]
        line = (f"worklist_range_count == plain == dense K4, "
                f"worklist_masked_nn == plain == dense K2, bit for bit: "
                f"{label}, n={n} d={pts.shape[1]}, 3 shards (shard 1 "
                f"{cut} rows; {m - n} padded rows); K9 computed "
                f"{[computed[f'{label} shard {s}'][0] for s in range(3)]} "
                f"of {ring.n_kept} ring entries per shard")
        if halo:
            st, en = (ddpc._pad_rows(a, m, 0) for a in point_span_bounds(grid))
            lo, W, hf, hb = ddpc._window_bounds(st, en, 3)
            pts_p, rk_p = mesh.shard(tbl), mesh.shard(tk)
            both = [torch.cat([p, k[:, None]], 1) for p, k in zip(pts_p, rk_p)]
            wins = ddpc._halo_window(mesh, both, lo, W, hf, hb)
            neg = 0
            for s in range(3):
                q, qk = pts_p[s], mesh.shard(qk_all)[s]
                win = wins[s][:, :-1].contiguous()
                wk = wins[s][:, -1].contiguous()
                sst = (mesh.shard(st)[s] - lo[s]).contiguous()
                sen = (mesh.shard(en)[s] - lo[s]).contiguous()
                neg += int((sen < 0).sum())
                got = k10(q, win, sst, sen, dc)
                check_equal(f"halo_range_count [{label}, shard {s}]", [got],
                            [k10_plain(q, win, sst, sen, dc)])
                got = k11(q, qk, win, wk, sst, sen, dc)
                check_equal(f"halo_masked_nn [{label}, shard {s}]", got,
                            k11_plain(q, qk, win, wk, sst, sen, dc))
                whole = torch.tensor([[0, W], [5, 2], [-9, -3]],
                                     dtype=torch.int32, device=dev)
                wst = whole[:, 0].expand(q.shape[0], 3).contiguous()
                wen = whole[:, 1].expand(q.shape[0], 3).contiguous()
                check_equal(f"halo_range_count [{label}, shard {s}]",
                            [k10(q, win, wst, wen, dc)],
                            [ops.local_density_xy(q, win, dc)],
                            "dense K4 on the whole window")
                best, arg = sweep.masked_nn_plain(q, qk, win, wk)
                within = best < sweep.d2cut_of(dc)
                k2d, k2p = ops.dependent_masked(q, qk, win, wk)
                check_equal(f"halo_masked_nn [{label}, shard {s}]",
                            k11(q, qk, win, wk, wst, wen, dc),
                            (torch.where(within, k2d, float("inf")),
                             torch.where(within, k2p, -1), within),
                            "dense K2 masked to d_cut on the whole window")
            line += (f"; halo_range_count, halo_masked_nn == plain, and == "
                     f"K4 / d_cut-masked K2 on whole-window spans: W={W}, "
                     f"hops {hf} forward {hb} back, {neg} negative span "
                     f"bounds")
        print(line, flush=True)
        if not times:
            s1 = slice(per, per + cut)
            q, qk = tbl[s1], qk_all[s1]
            wl = blocksparse.build_flat_worklist(q, tbl, dc, nn=None)
            ring = blocksparse.build_flat_worklist(q, tbl, count=False,
                                                   nn="best1")
            win = wins[1][:, :-1].contiguous()
            wk = wins[1][:, -1].contiguous()
            sst = (st[s1] - lo[1]).contiguous()
            sen = (en[s1] - lo[1]).contiguous()
            qh, qhk = pts_p[1][:cut], mesh.shard(qk_all)[1][:cut]
            times = {
                "worklist_range_count": {
                    "ms": time_ms(lambda: k8(q, tbl, dc, wl)),
                    "plain_ms": time_ms(lambda: k8_plain(q, tbl, dc, wl))},
                "worklist_masked_nn": {
                    "ms": time_ms(lambda: k9(q, qk, tbl, tk, ring)),
                    "plain_ms": time_ms(lambda: k9_plain(q, qk, tbl, tk,
                                                         ring))},
                "halo_range_count": {
                    "ms": time_ms(lambda: k10(qh, win, sst, sen, dc)),
                    "plain_ms": time_ms(lambda: k10_plain(qh, win, sst, sen,
                                                          dc))},
                "halo_masked_nn": {
                    "ms": time_ms(lambda: k11(qh, qhk, win, wk, sst, sen,
                                              dc)),
                    "plain_ms": time_ms(lambda: k11_plain(
                        qh, qhk, win, wk, sst, sen, dc))}}
            for name, t in times.items():
                t["shape"] = f"{cut} shard rows x {n}, d={pts.shape[1]}"
                print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, "
                      f"plain {t['plain_ms']:.3f} ms  ({card})", flush=True)
    return {"times": times, "k9_computed": computed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from repro_torch import DPCEngine, ExecSpec
    from repro_torch.core.approxdpc import _group_segments, _maxima_mask
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid
    from repro_torch.core.metrics import rand_index
    from repro_torch.core.sapproxdpc import representatives
    from repro_torch.core.tuning import pick_dcut
    from repro_torch.data.points import gaussian_mixture, real_proxy
    from repro_torch.kernels import blocksparse, build, ops, sweep
    from repro_torch.kernels.backend import get_backend

    dev = torch.device("cuda")
    record: dict = {}
    t_start = time.perf_counter()

    # ---------------------------------------------------- 1. card and build
    card = smi("name,power.limit")
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_rate = sms * F32_LANES_PER_SM * max_sm_mhz * 1e6
    print(f"card: {card}")
    print(f"clocks.sm, clocks.max.sm, power.draw, temperature: {clocks}")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  SMs {sms}", flush=True)
    b = build.build()
    print(f"build: {b.seconds:.2f} s  ({b.path.name})")
    regs = [line.split("Used ")[1].split(" registers")[0]
            for line in b.log.splitlines() if "registers" in line]
    spills = [line for line in b.log.splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line]
    print(f"  ptxas: registers per instantiation {regs}; spills: "
          f"{spills or 'none'}")
    record.update(card=card, clocks=clocks, build_s=b.seconds)

    # --------------------------------------- 2. kernels vs plain, check shapes
    def k1(x, y, d_cut):
        return ops.fused_sweep(x, y, d_cut)

    def k1_plain(x, y, d_cut):
        c, v, i = sweep.fused_count_topk_plain(x, y, sweep.d2cut_of(d_cut))
        return c.to(torch.float32), v, i

    def k3(x, y, d_cut, wl, live=None):
        return ops.fused_sweep(x, y, d_cut, worklist=wl, live=live)

    def k3_plain(x, y, d_cut, wl):
        c, v, i = sweep.worklist_count_topk_plain(x, y, sweep.d2cut_of(d_cut),
                                                  wl)
        return c.to(torch.float32), v, i

    def k3_live(x, y, d_cut, wl) -> int:
        """Entries K3 computes on these inputs (a separate launch)."""
        live = torch.zeros(wl.num_row_tiles, dtype=torch.int32, device=dev)
        k3(x, y, d_cut, wl, live=live)
        return int(live.sum())

    def k2(x, xk, y, yk):
        return ops.dependent_masked(x, xk, y, yk)

    def k2_plain(x, xk, y, yk):
        best, arg = sweep.masked_nn_plain(x, xk, y, yk)
        return torch.sqrt(best), arg

    cases = [("airline", real_proxy("airline", N_CHECK, seed=0)[0])]
    for d in (2, 4, 8):
        cases.append((f"mixture d={d}",
                      gaussian_mixture(1000, d=d, seed=d)[0]))
    cases.append(("normal d=64", np.random.default_rng(64).normal(
        size=(300, 64)).astype(np.float32)))
    lattice = np.stack(np.meshgrid(np.arange(128), np.arange(128)), -1)
    for label, pts in cases:
        x = torch.from_numpy(pts).to(dev)
        dc = pick_dcut(pts, target_rho=30)
        check_equal(f"fused_count_topk [{label}]", k1(x, x, dc),
                    k1_plain(x, x, dc))
        print(f"fused_count_topk == plain, bit for bit: {label}, "
              f"n={len(pts)} d={pts.shape[1]}", flush=True)

    k3_checks = {}
    for label, pts, dc in [(lb, p, pick_dcut(p, target_rho=30))
                           for lb, p in cases] + [
            ("lattice 128x128", lattice.reshape(-1, 2).astype(np.float32),
             2.5)]:
        x = torch.from_numpy(pts).to(dev)
        if pts.shape[1] <= 8:       # the drivers' layout: grid-sorted
            x = build_grid(x, dc).points
        wl = blocksparse.build_flat_worklist(x, x, dc)
        got = k3(x, x, dc, wl)
        check_equal(f"worklist_count_topk [{label}]", got,
                    k3_plain(x, x, dc, wl))
        check_equal(f"worklist_count_topk [{label}]", got, k1(x, x, dc),
                    "dense fused_count_topk")
        live = k3_live(x, x, dc, wl)
        k3_checks[label] = {"n": len(pts), "d": pts.shape[1],
                            "kept": wl.n_kept, "total": wl.n_total,
                            "in_cut": int(wl.in_cut.sum()), "live": live}
        print(f"worklist_count_topk == plain == dense K1, bit for bit: "
              f"{label}, n={len(pts)} d={pts.shape[1]}: {wl.n_kept} of "
              f"{wl.n_total} tile pairs kept, {live} computed", flush=True)

    pts = cases[0][1]
    x = torch.from_numpy(pts).to(dev)
    dc = pick_dcut(pts, target_rho=30)
    key = k1(x, x, dc)[0] + density_jitter(N_CHECK, dev)
    q, qk = x[:Q_CHECK].contiguous(), key[:Q_CHECK].contiguous()
    check_equal("masked_nn [airline]", k2(q, qk, x, key),
                k2_plain(q, qk, x, key))
    flat = torch.zeros(N_CHECK, device=dev)
    fd, fp = k2(q, flat[:Q_CHECK].contiguous(), x, flat)
    check_equal("masked_nn [equal keys]", (fd, fp),
                k2_plain(q, flat[:Q_CHECK].contiguous(), x, flat))
    assert torch.isinf(fd).all() and (fp == -1).all(), \
        "masked_nn with equal keys must return (inf, -1) everywhere"
    print(f"masked_nn == plain, bit for bit: q={Q_CHECK} m={N_CHECK} d=3, "
          f"and (inf, -1) everywhere for equal keys", flush=True)

    xs_check = build_grid(x, dc).points
    wl_check = blocksparse.build_flat_worklist(xs_check, xs_check, dc)
    check_times = {
        "fused_count_topk": {
            "shape": f"n=m={N_CHECK} d=3",
            "ms": time_ms(lambda: k1(x, x, dc)),
            "plain_ms": time_ms(lambda: k1_plain(x, x, dc))},
        "worklist_count_topk": {
            "shape": f"n=m={N_CHECK} d=3 grid-sorted, "
                     f"{wl_check.n_kept} entries",
            "ms": time_ms(lambda: k3(xs_check, xs_check, dc, wl_check)),
            "plain_ms": time_ms(lambda: k3_plain(xs_check, xs_check, dc,
                                                 wl_check)),
            "k1_sorted_ms": time_ms(lambda: k1(xs_check, xs_check, dc))},
        "masked_nn": {
            "shape": f"q={Q_CHECK} m={N_CHECK} d=3",
            "ms": time_ms(lambda: k2(q, qk, x, key)),
            "plain_ms": time_ms(lambda: k2_plain(q, qk, x, key))},
    }
    for name, t in check_times.items():
        print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms  ({card})", flush=True)

    # ------------------------------------------------- 3. the dense path
    main_pts, _ = real_proxy("airline", N_MAIN, seed=0)
    d_cut = pick_dcut(main_pts, target_rho=30)
    engine = DPCEngine(d_cut, rho_min=10)
    engine.fit(main_pts)                                   # warm-up
    torch.cuda.synchronize()

    # keep the inputs each kernel is given in a counted fit
    given: dict[str, list] = {}
    launch_sweep, launch_nn = ops.fused_sweep, ops.dependent_masked

    def recording_sweep(*a, **kw):
        kind = ("worklist_count_topk" if kw.get("worklist") is not None
                else "fused_count_topk")
        if kw.get("nn_sel") is not None:
            kind += "_sel"
        given[kind].append((*a, kw.get("worklist"), kw.get("nn_sel")))
        return launch_sweep(*a, **kw)

    def recording_nn(*a):
        given["masked_nn"].append(a)
        return launch_nn(*a)

    def counted_fit(eng, points):
        """(seconds, launch counts) of one fit, counts zeroed just before
        it and read just after; the kernels' inputs land in ``given``."""
        for name in ops.launch_counts():
            given[name] = []
        ops.fused_sweep, ops.dependent_masked = recording_sweep, recording_nn
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            eng.fit(points)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = ops.launch_counts()
        finally:
            ops.fused_sweep, ops.dependent_masked = launch_sweep, launch_nn
        for name, count in launches.items():
            assert len(given[name]) == count, (name, len(given[name]), count)
        return seconds, launches

    fit_s, launches_dense = counted_fit(engine, main_pts)
    k2_rows = [a[0].shape[0] for a in given["masked_nn"]]
    print(f"dense fit: n={N_MAIN} d=3 d_cut={d_cut!r}: {fit_s * 1e3:.1f} ms, "
          f"launches {launches_dense}, masked_nn rows {k2_rows}  ({card})",
          flush=True)
    for name in ("fused_count_topk", "masked_nn"):
        assert launches_dense[name] >= 1, \
            f"the dense path never launched {name}"
    assert launches_dense["worklist_count_topk"] == 0
    res, cl = engine.result, engine.clustering
    dense_given = dict(given)

    # ------------------------- 4. kernels vs plain, the dense path's shapes
    main_times: dict[str, dict] = {}
    errs: dict[str, float] = {}
    bounds: dict[str, tuple] = {}
    (mx, my, mdc, _, _), = dense_given["fused_count_topk"]
    full = k1(mx, my, mdc)
    assert torch.equal(res.rho, full[0]), "the fit's rho differs from K1's"
    want, plain_ms = timed_once(lambda: k1_plain(mx[:K1_PLAIN_ROWS], my, mdc))
    errs["fused_count_topk"] = check_equal(
        "fused_count_topk [dense path]", [t[:K1_PLAIN_ROWS] for t in full],
        want)
    main_times["fused_count_topk"] = {
        "ms": time_ms(lambda: k1(mx, my, mdc)), "plain_ms": plain_ms,
        "plain_rows": K1_PLAIN_ROWS}
    bounds["fused_count_topk"] = k1_work(mx.shape[0], my.shape[0],
                                         mx.shape[1])
    print(f"fused_count_topk == plain, bit for bit, on {K1_PLAIN_ROWS} rows "
          f"x {my.shape[0]} columns; the fit's rho == K1's count on all "
          f"{mx.shape[0]} rows", flush=True)

    dense_k2 = {"ms": 0.0, "plain_ms": 0.0}
    for i, (xq, xk, y, yk) in enumerate(dense_given["masked_nn"]):
        want, p_ms = timed_once(lambda: k2_plain(xq, xk, y, yk))
        check_equal(f"masked_nn [dense path, call {i}]", k2(xq, xk, y, yk),
                    want)
        dense_k2["ms"] += time_ms(lambda: k2(xq, xk, y, yk))
        dense_k2["plain_ms"] += p_ms
    print(f"masked_nn == plain, bit for bit: dense path q={k2_rows} "
          f"m={N_MAIN} d=3", flush=True)
    print(f"fused_count_topk [dense path]: kernel "
          f"{main_times['fused_count_topk']['ms']:.3f} ms, plain "
          f"{plain_ms:.3f} ms on {K1_PLAIN_ROWS} rows; masked_nn: kernel "
          f"{dense_k2['ms']:.3f} ms, plain {dense_k2['plain_ms']:.3f} ms  "
          f"({card})", flush=True)

    # ---------------------------------------- 5. the dense fit against float64
    pts64 = torch.from_numpy(main_pts).to(dev, torch.float64)
    gen = torch.Generator().manual_seed(0)
    rows = torch.randperm(N_MAIN, generator=gen)[:Q_CHECK].to(dev)
    _, exact_rows = float64_rho_check(pts64, res.rho, sweep.d2cut_of(d_cut),
                                      rows)
    print(f"rho == float64 count on {Q_CHECK} random rows ({exact_rows} "
          f"with no pair within 4 ulps of d_cut^2)", flush=True)
    xs = torch.from_numpy(main_pts).to(dev)
    grid = build_grid(xs, d_cut)
    maxima = torch.nonzero(_maxima_mask(grid, _group_segments(grid),
                                        res.rho_key)).flatten()
    n_rule2 = float64_dependent_check(pts64, res, maxima, d_cut)
    n_clusters = int(cl.num_clusters)
    assert n_clusters >= 1, "no cluster found"
    print(f"parent/delta == float64 masked search on all {maxima.numel()} "
          f"cell maxima ({n_rule2} rule 2); {n_clusters} clusters",
          flush=True)
    del pts64
    record["dense"] = {"fit_ms": fit_s * 1e3, "n": N_MAIN, "d_cut": d_cut,
                       "clusters": n_clusters, "cell_maxima": maxima.numel(),
                       "rule2_rows": n_rule2, "k2_rows": k2_rows,
                       "k2": dense_k2}

    # ------------------------------------------ 6. block-sparse at 2^20
    gs = grid.points
    wl, wl_ms = timed_once(lambda: blocksparse.build_flat_worklist(gs, gs,
                                                                   d_cut))
    got = k3(gs, gs, d_cut, wl)
    check_equal("worklist_count_topk [2^20]", got, k1(gs, gs, d_cut),
                "dense fused_count_topk")
    want, k3_plain_ms = timed_once(lambda: k3_plain(gs, gs, d_cut, wl))
    check_equal("worklist_count_topk [2^20]", got, want)
    live_2e20 = k3_live(gs, gs, d_cut, wl)
    k3_2e20 = {"kept": wl.n_kept, "total": wl.n_total,
               "in_cut": int(wl.in_cut.sum()), "live": live_2e20,
               "needed_pairs": k3_needed_pairs(wl, N_MAIN, got[1]),
               "build_ms": wl_ms, "ms": time_ms(lambda: k3(gs, gs, d_cut, wl)),
               "plain_ms": k3_plain_ms}
    print(f"worklist_count_topk == dense K1 == plain, bit for bit, on all "
          f"{N_MAIN} rows (grid-sorted): {wl.n_kept} of {wl.n_total} tile "
          f"pairs kept ({int(wl.in_cut.sum())} in d_cut), {live_2e20} "
          f"computed; K3 {k3_2e20['ms']:.3f} ms, plain {k3_plain_ms:.1f} ms, "
          f"build {wl_ms:.2f} ms  ({card})", flush=True)
    del want, got

    sparse_engine = DPCEngine(d_cut, rho_min=10,
                              exec_spec=ExecSpec(layout="block-sparse"))
    sparse_engine.fit(main_pts)                            # warm-up
    torch.cuda.synchronize()
    sparse_s, launches_2e20 = counted_fit(sparse_engine, main_pts)
    assert launches_2e20["fused_count_topk"] == 0 and \
        launches_2e20["worklist_count_topk"] >= 1, launches_2e20
    print(f"block-sparse fit: n={N_MAIN}: {sparse_s * 1e3:.1f} ms (dense "
          f"{fit_s * 1e3:.1f} ms), launches {launches_2e20}  ({card})",
          flush=True)
    ties, tied, lab_diff = same_up_to_ties(
        xs, res, sparse_engine.result, cl.labels,
        sparse_engine.clustering.labels, "Approx-DPC block-sparse vs dense")
    print(f"block-sparse fit == dense fit at n={N_MAIN}: rho, rho_key, delta "
          f"equal; parent and labels equal except {ties} exact distance "
          f"ties ({tied} rows downstream of them, {lab_diff} labels "
          f"differ)", flush=True)
    k3_2e20.update(parent_ties=ties, fit_ms=sparse_s * 1e3)
    record["block_sparse_2e20"] = k3_2e20
    del sparse_engine, wl

    # ------------------------------ 7. Ex-DPC and Scan at 2^20, both layouts
    exact_fits, exact_rec = {}, {}
    for algo, layout in (("exdpc", "block-sparse"), ("scan", "block-sparse"),
                         ("exdpc", "dense")):
        eng = DPCEngine(d_cut, rho_min=10, algorithm=algo,
                        exec_spec=ExecSpec(layout=layout))
        eng.fit(main_pts)                                  # warm-up
        torch.cuda.synchronize()
        secs, launched = counted_fit(eng, main_pts)
        swept, skipped = ("worklist_count_topk", "fused_count_topk")[
            ::1 if layout == "block-sparse" else -1]
        assert launched[swept] >= 1 and launched["masked_nn"] >= 1 \
            and launched[skipped] == 0, (algo, layout, launched)
        calls = given["masked_nn"]
        rows_k2 = [a[0].shape[0] for a in calls]
        ms_k2 = sum(time_ms(lambda a=a: k2(*a)) for a in calls)
        exact_fits[algo, layout] = eng
        exact_rec[f"{algo} {layout}"] = {
            "fit_ms": secs * 1e3, "launches": launched, "k2_rows": rows_k2,
            "k2_ms": ms_k2}
        print(f"{algo} fit, {layout}: n={N_MAIN}: {secs * 1e3:.1f} ms, "
              f"launches {launched}, masked_nn rows {rows_k2}, K2 "
              f"{ms_k2:.3f} ms  ({card})", flush=True)
    ex, sc = exact_fits["exdpc", "block-sparse"], exact_fits[
        "scan", "block-sparse"]
    for a, b in zip(ex.result, sc.result):
        assert torch.equal(a, b), "Ex-DPC differs from Scan"
    assert torch.equal(ex.clustering.labels, sc.clustering.labels), \
        "Ex-DPC labels differ from Scan's"
    assert torch.equal(ex.result.rho, res.rho), \
        "Ex-DPC rho differs from Approx-DPC's"
    ex_dense = exact_fits["exdpc", "dense"]
    ties, tied, lab_diff = same_up_to_ties(
        xs, ex_dense.result, ex.result, ex_dense.clustering.labels,
        ex.clustering.labels, "Ex-DPC block-sparse vs dense")
    pts64 = torch.from_numpy(main_pts).to(dev, torch.float64)
    rows = torch.randperm(N_MAIN, generator=gen)[:Q_CHECK].to(dev)
    float64_dependent_check(pts64, ex.result, rows, None)
    del pts64
    exact_rec["dense_ties"] = ties
    record["exact_2e20"] = exact_rec
    ex_res, ex_labels = ex.result, ex.clustering.labels   # phases 14, 15
    ex_dense_res = ex_dense.result                         # phase 18
    ex_dense_labels = ex_dense.clustering.labels
    print(f"Ex-DPC block-sparse == Scan block-sparse, bit for bit; == Ex-DPC "
          f"dense except {ties} exact distance ties ({tied} rows downstream, "
          f"{lab_diff} labels differ); rho == Approx-DPC's; delta/parent == "
          f"float64 masked search on {Q_CHECK} random rows", flush=True)
    del exact_fits, ex, sc, ex_dense

    # ---------------------------- 8. the main path at full width (5.8M)
    full_pts, _ = real_proxy("airline", N_FULL, seed=0)
    d_full = pick_dcut(full_pts, target_rho=30)
    engine = DPCEngine(d_full, rho_min=10,
                       exec_spec=ExecSpec(layout="block-sparse"))
    engine.fit(full_pts)                                   # warm-up
    torch.cuda.synchronize()
    full_s, launches = counted_fit(engine, full_pts)
    k2_rows_full = [a[0].shape[0] for a in given["masked_nn"]]
    print(f"main path fit: n={N_FULL} d=3 d_cut={d_full!r} block-sparse: "
          f"{full_s * 1e3:.1f} ms, launches {launches}, masked_nn rows "
          f"{k2_rows_full}  ({card})", flush=True)
    for name in ("worklist_count_topk", "masked_nn"):
        assert launches[name] >= 1, f"the main path never launched {name}"
    assert launches["fused_count_topk"] == 0, \
        "the block-sparse main path launched the dense sweep"
    fres, fcl = engine.result, engine.clustering

    pts64 = torch.from_numpy(full_pts).to(dev, torch.float64)
    rows = torch.randperm(N_FULL, generator=gen)[:Q_CHECK].to(dev)
    _, exact_rows = float64_rho_check(pts64, fres.rho,
                                      sweep.d2cut_of(d_full), rows)
    fx = torch.from_numpy(full_pts).to(dev)
    fgrid = build_grid(fx, d_full)
    fmax = torch.nonzero(_maxima_mask(fgrid, _group_segments(fgrid),
                                      fres.rho_key)).flatten()
    pick = fmax[torch.randperm(fmax.numel(), generator=gen)[:Q_CHECK]
                .to(dev)]
    n_rule2_full = float64_dependent_check(pts64, fres, pick, d_full)
    del pts64
    print(f"rho == float64 count on {Q_CHECK} random rows ({exact_rows} "
          f"clear of the band); parent/delta == float64 masked search on "
          f"{pick.numel()} random cell maxima of {fmax.numel()} "
          f"({n_rule2_full} rule 2, {pick.numel() - n_rule2_full} rule 3 "
          f"or peak); {int(fcl.num_clusters)} clusters", flush=True)

    # K3 against its plain version and dense K1 on 256 row tiles; K2 on
    # the fit's unresolved cell maxima, plain on a slice of them
    (fxs, fys, fdc, fwl, _), = given["worklist_count_topk"]
    (errs["worklist_count_topk"], main_times["worklist_count_topk"],
     bounds["worklist_count_topk"], wl_full) = k3_row_tile_check(
        fxs, fys, fdc, fwl, None, "worklist_count_topk", card)
    errs["masked_nn"], main_times["masked_nn"], bounds["masked_nn"] = \
        k2_fit_check(given["masked_nn"], "main path", card)

    # traced fit: phase times and each phase's peak device memory
    del given, fxs, fys, fwl, fx, fgrid
    trace_full = traced(
        lambda: engine.fit(full_pts),
        ("engine.fit", "approxdpc.grid", "approxdpc.rho_delta",
         "rho_delta.worklist", "rho_delta.sweep", "rho_delta.resolve",
         "rho_delta.fallback", "approxdpc.rules", "labels.assign"),
        card, f"traced Approx-DPC fit, fallback rows {k2_rows_full}")

    # ---------------------- 9. stream kernels vs plain, check shapes
    n_clusters_full = int(fcl.num_clusters)
    del engine, fres, fcl
    torch.cuda.empty_cache()
    stream_cases = [("airline", cases[0][1], pick_dcut(cases[0][1],
                                                       target_rho=30), False)]
    for label, pts_c in cases[1:4]:
        stream_cases.append((label, pts_c, pick_dcut(pts_c, target_rho=30),
                             False))
    stream_cases.append(("lattice 128x128",
                         lattice.reshape(-1, 2).astype(np.float32), 2.5,
                         True))
    stream_check = stream_check_shapes(stream_cases, card)

    # ------------------ 10. the stream main path: mixture, 2^20 window
    mix, _ = gaussian_mixture(N_WINDOW + (MIX_TICKS + 2) * STREAM_BATCH
                              + N_PREDICT, k=15, d=2, seed=0)
    streams = {"mixture": run_stream("mixture", mix, 2000.0, MIX_TICKS, card)}
    del mix
    torch.cuda.empty_cache()

    # ---- 11. the Airline stream, 2^20 window, the dense path's d_cut
    air, _ = real_proxy("airline", N_WINDOW + (AIR_TICKS + 2) * STREAM_BATCH
                        + N_PREDICT, seed=0)
    streams["airline"] = run_stream("airline", air, d_cut, AIR_TICKS, card)
    del air
    torch.cuda.empty_cache()

    # ------------------- 12. S-Approx-DPC's kernels vs plain, check shapes
    k1s, k1s_plain, _, _, k7, k7_plain = sapprox_kernels()
    sapprox_check = sapprox_check_shapes(
        [(label, p, pick_dcut(p, target_rho=30)) for label, p in cases]
        + [("lattice 128x128", lattice.reshape(-1, 2).astype(np.float32),
            2.5)], card)

    # ------------- 13. S-Approx-DPC at full width (5.8M): the main path
    member_delta = float(np.float32(min(SAPPROX_EPS, 1.0) * d_full))
    sa_engine = DPCEngine(d_full, algorithm="sapproxdpc", eps=SAPPROX_EPS,
                          rho_min=10, exec_spec=ExecSpec(layout="block-sparse"))
    sa_engine.fit(full_pts)                                # warm-up
    torch.cuda.synchronize()
    given = {}
    sa_s, sa_launches = counted_fit(sa_engine, full_pts)
    sres, scl = sa_engine.result, sa_engine.clustering
    sa_k2_rows = [a[0].shape[0] for a in given["masked_nn"]]
    assert sa_launches["worklist_count_topk_sel"] >= 1 and \
        sa_launches["masked_nn"] >= 1, sa_launches
    for name in ("fused_count_topk", "worklist_count_topk",
                 "fused_count_topk_sel"):
        assert sa_launches[name] == 0, \
            f"the S-Approx-DPC main path launched {name}: {sa_launches}"
    fx = torch.from_numpy(full_pts).to(dev)
    fgrid = build_grid(fx, d_full)
    rep_slots, seg = representatives(fgrid, d_full, SAPPROX_EPS)
    rep_ids = fgrid.order[rep_slots]
    n_reps = rep_ids.numel()
    print(f"S-Approx-DPC fit: n={N_FULL} d=3 d_cut={d_full!r} eps="
          f"{SAPPROX_EPS} block-sparse: {sa_s * 1e3:.1f} ms, {n_reps} "
          f"representatives ({100 * n_reps / N_FULL:.1f} %), launches "
          f"{sa_launches}, masked_nn rows {sa_k2_rows}, "
          f"{int(scl.num_clusters)} clusters  ({card})", flush=True)
    is_rep = torch.zeros(N_FULL, dtype=torch.bool, device=dev)
    is_rep[rep_ids] = True
    rep_of = fgrid.order[rep_slots[seg]][fgrid.inv_order]
    member = ~is_rep
    assert torch.equal(sres.rho, sres.rho[rep_of]), \
        "a member's rho is not its representative's"
    assert bool((sres.parent[member].long() == rep_of[member]).all()), \
        "a member's parent is not its representative"
    assert bool((sres.delta[member] == member_delta).all()), \
        "a member's delta is not min(eps, 1) * d_cut"
    pts64 = fx.double()
    pick = rep_ids[torch.randperm(n_reps, generator=gen)[:Q_CHECK].to(dev)]
    _, sa_clear = float64_rho_check(pts64, sres.rho, sweep.d2cut_of(d_full),
                                    pick)
    n_ph1, n_ph2 = float64_sapprox_check(pts64, sres, rep_ids, is_rep, pick,
                                         d_full)
    del pts64
    print(f"members: rho, parent, delta from their representative, all "
          f"{int(member.sum())}; rho == float64 count on {Q_CHECK} random "
          f"representatives ({sa_clear} clear of the band); parent/delta == "
          f"float64 masked search among the representatives on them "
          f"({n_ph1} phase 1, {n_ph2} phase 2, "
          f"{Q_CHECK - n_ph1 - n_ph2} peak or at d_cut)", flush=True)

    (sxs, sys_, sdc, swl, ssel), = given["worklist_count_topk_sel"]
    (errs["worklist_count_topk_sel"], main_times["worklist_count_topk_sel"],
     bounds["worklist_count_topk_sel"], sa_wl) = k3_row_tile_check(
        sxs, sys_, sdc, swl, ssel, "worklist_count_topk_sel", card)
    del sxs, sys_, swl, ssel
    _, sa_k2, _ = k2_fit_check(given["masked_nn"],
                               "S-Approx-DPC main path, members keyed -inf",
                               card)
    del given, fx, fgrid, rep_of, is_rep, member
    trace_sa = traced(
        lambda: sa_engine.fit(full_pts),
        ("engine.fit", "sapproxdpc.grid", "sapproxdpc.reps",
         "sapproxdpc.rep_sweep", "rho_delta.worklist", "rho_delta.sweep",
         "rho_delta.resolve", "rho_delta.fallback", "sapproxdpc.assemble",
         "labels.assign"),
        card, f"traced S-Approx-DPC fit, fallback rows {sa_k2_rows}")
    record["sapprox_full"] = {
        "fit_ms": sa_s * 1e3, "n": N_FULL, "d_cut": d_full,
        "eps": SAPPROX_EPS, "reps": n_reps, "launches": sa_launches,
        "clusters": int(scl.num_clusters), "phase1_rows": n_ph1,
        "phase2_rows": n_ph2, "k2": sa_k2, "worklist": sa_wl, **trace_sa}
    del sa_engine, sres, scl
    torch.cuda.empty_cache()

    # --------------------------- 14. the eps sweep at 2^20 (Table 5)
    ex_lab = ex_labels.cpu().numpy()
    eps_rec = {}
    for eps in EPS_SWEEP:
        eng = DPCEngine(d_cut, algorithm="sapproxdpc", eps=eps, rho_min=10,
                        exec_spec=ExecSpec(layout="block-sparse"))
        eng.fit(main_pts)                                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.fit(main_pts)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ri = rand_index(eng.clustering.labels, ex_lab)
        n_r = representatives(grid, d_cut, eps)[0].numel()
        eps_rec[eps] = {"fit_ms": secs * 1e3, "reps": n_r, "rand_index": ri,
                        "clusters": int(eng.clustering.num_clusters)}
        assert ri >= 0.9, f"eps {eps}: Rand index {ri} against Ex-DPC"
        line = (f"eps {eps}: block-sparse fit n={N_MAIN} {secs * 1e3:.1f} "
                f"ms, {n_r} representatives, Rand index vs Ex-DPC {ri:.6f}, "
                f"{eps_rec[eps]['clusters']} clusters")
        if eps == SAPPROX_EPS:
            dense = DPCEngine(d_cut, algorithm="sapproxdpc", eps=eps,
                              rho_min=10, exec_spec=ExecSpec(layout="dense"))
            dense.fit(main_pts)                            # warm-up
            torch.cuda.synchronize()
            given = {}
            dsecs, sel_launches = counted_fit(dense, main_pts)
            assert sel_launches["fused_count_topk_sel"] >= 1 and \
                sel_launches["masked_nn"] >= 1 and \
                sel_launches["worklist_count_topk_sel"] == 0 and \
                sel_launches["fused_count_topk"] == 0, sel_launches
            ties, tied, lab_diff = same_up_to_ties(
                xs, dense.result, eng.result, dense.clustering.labels,
                eng.clustering.labels, "S-Approx-DPC dense vs block-sparse")
            (dx, dy, ddc, _, dsel), = given["fused_count_topk_sel"]
            r = min(SEL_PLAIN_ROWS, dx.shape[0])
            full_out = k1s(dx, dy, ddc, dsel)
            want, p_ms = timed_once(lambda: k1s_plain(dx[:r], dy, ddc, dsel))
            errs["fused_count_topk_sel"] = check_equal(
                "fused_count_topk_sel [dense S-Approx-DPC fit]",
                [t[:r] for t in full_out], want)
            main_times["fused_count_topk_sel"] = {
                "ms": time_ms(lambda: k1s(dx, dy, ddc, dsel)),
                "plain_ms": p_ms, "plain_rows": r}
            bounds["fused_count_topk_sel"] = k1_work(dx.shape[0],
                                                     dy.shape[0], dx.shape[1])
            eps_rec["dense"] = {"fit_ms": dsecs * 1e3,
                                "launches": sel_launches,
                                "parent_ties": ties}
            line += (f"; dense fit {dsecs * 1e3:.1f} ms, launches "
                     f"{sel_launches}, == block-sparse (rho, rho_key, delta "
                     f"bit for bit; {ties} parents decided by exact ties, "
                     f"{tied} rows downstream, {lab_diff} labels differ); "
                     f"gated K1 {main_times['fused_count_topk_sel']['ms']:.3f}"
                     f" ms on {dx.shape[0]} x {dy.shape[0]}, == plain on {r} "
                     f"rows ({p_ms:.1f} ms)")
            del dense, given, full_out, want, dx, dy, dsel
        print(line + f"  ({card})", flush=True)
        del eng
    record["eps_sweep_2e20"] = eps_rec

    # ---------------------------------------------- 15. K7 at 2^20
    rk = ex_res.rho_key
    order = torch.argsort(rk, descending=True, stable=True)
    tbl = xs[order].contiguous()
    ops.reset_launch_counts()
    d7, p7 = get_backend("cuda").prefix_nn(tbl)
    torch.cuda.synchronize()
    k7_launches = ops.launch_counts()["prefix_nn"]
    assert k7_launches == 1, f"prefix_nn launched {k7_launches} times"
    want_d, want_p = ex_res.delta[order], ex_res.parent[order].long()
    has = p7 >= 0
    par = torch.where(has, order[p7.clamp_min(0).long()], -1)
    key_tie = has & (rk[par.clamp_min(0)] == rk[order])
    assert bool((rk[par[has]] >= rk[order][has]).all()), \
        "prefix_nn's parent is not an earlier row"
    ok = ~key_tie
    assert torch.equal(d7[ok], want_d[ok]), \
        "prefix_nn's delta differs from the Ex-DPC fit's"
    differ = torch.nonzero(ok & (par != want_p)).flatten()
    assert bool(torch.equal(
        sweep.direct_d2(tbl[differ], xs[par[differ]]),
        sweep.direct_d2(tbl[differ], xs[want_p[differ]]))), \
        "prefix_nn's parent differs from Ex-DPC's without a distance tie"
    assert bool((d7[key_tie] <= want_d[key_tie]).all()), \
        "prefix_nn is farther than Ex-DPC on a row with an equal-key parent"
    want, k7_plain_ms = timed_once(lambda: k7_plain(
        tbl[:PREFIX_PLAIN_ROWS]))
    errs["prefix_nn"] = check_equal(
        "prefix_nn [2^20]", [d7[:PREFIX_PLAIN_ROWS], p7[:PREFIX_PLAIN_ROWS]],
        want)
    main_times["prefix_nn"] = {"ms": time_ms(lambda: k7(tbl)),
                               "plain_ms": k7_plain_ms,
                               "plain_rows": PREFIX_PLAIN_ROWS}
    bounds["prefix_nn"] = (4 * N_MAIN * 3 + 8 * N_MAIN,
                           N_MAIN * (N_MAIN - 1) / 2 * (3 * 3 + 1))
    record["prefix_2e20"] = {"key_tie_rows": int(key_tie.sum()),
                             "parent_ties": differ.numel(),
                             "launches": k7_launches}
    print(f"prefix_nn on the Ex-DPC table sorted by rho_key, n={N_MAIN}: "
          f"delta == the Ex-DPC fit's bit for bit on {int(ok.sum())} rows, "
          f"parents equal but {differ.numel()} exact distance ties; "
          f"{int(key_tie.sum())} rows whose nearest earlier row has an "
          f"equal f32 key (there K7 is as near or nearer); == plain on the "
          f"first {PREFIX_PLAIN_ROWS} rows; kernel "
          f"{main_times['prefix_nn']['ms']:.3f} ms, plain "
          f"{k7_plain_ms:.1f} ms on the rows  ({card})", flush=True)
    del want, d7, p7, tbl

    # --------------------- 16. the distributed kernels vs plain, check shapes
    dist_check = dist_check_shapes(
        [(label, p, pick_dcut(p, target_rho=30)) for label, p in cases]
        + [("lattice 128x128", lattice.reshape(-1, 2).astype(np.float32),
            2.5)], card)

    # ------- 17. distributed Ex-DPC at full width (5.8M), four shards
    from repro_torch import obs
    from repro_torch.launch import ShardMesh
    k8, k8_plain, k9, k9_plain, k10, k10_plain, k11, k11_plain = \
        dist_kernels()
    dist_names = {"local_density_xy": ("range_count", "worklist_range_count"),
                  "dependent_masked": ("masked_nn", "worklist_masked_nn"),
                  "halo_density": ("halo_range_count",) * 2,
                  "halo_dependent": ("halo_masked_nn",) * 2}

    def counted_dist_fit(eng, points):
        """(seconds, launch counts, the kernels' inputs by kernel) of one
        fit, counts zeroed just before it and read just after."""
        given = {k: [] for names in dist_names.values() for k in names}
        launch_fns = {f: getattr(ops, f) for f in dist_names}

        def recorder(f):
            def record(*a, **kw):
                kind = dist_names[f][kw.get("worklist") is not None]
                given[kind].append((a, kw))
                return launch_fns[f](*a, **kw)
            return record

        for f in dist_names:
            setattr(ops, f, recorder(f))
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            eng.fit(points)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = ops.launch_counts()
        finally:
            for f, fn in launch_fns.items():
                setattr(ops, f, fn)
        for name, calls in given.items():
            assert len(calls) == launched[name], (name, len(calls),
                                                  launched[name])
        return seconds, launched, given

    single = DPCEngine(d_full, rho_min=10, algorithm="exdpc",
                       exec_spec=ExecSpec(layout="block-sparse"))
    single.fit(full_pts)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single.fit(full_pts)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    print(f"single-device Ex-DPC, block-sparse: n={N_FULL} d=3 d_cut="
          f"{d_full!r}: {single_s * 1e3:.1f} ms  ({card})", flush=True)
    fx = torch.from_numpy(full_pts).to(dev)
    pts64 = fx.double()
    dist_rec = {"single_exdpc_ms": single_s * 1e3, "shards": DIST_SHARDS}
    dist_given, dist_launches = {}, {}
    for strategy in ("halo", "gather"):
        eng = DPCEngine(d_full, rho_min=10, algorithm="exdpc",
                        mesh=ShardMesh.on("cuda", shards=DIST_SHARDS),
                        strategy=strategy,
                        exec_spec=ExecSpec(layout="block-sparse"))
        eng.fit(full_pts)                                  # warm-up
        torch.cuda.synchronize()
        # traced before the counted fit, whose kept inputs would count
        # towards the phases' peaks
        trace = traced(lambda: eng.fit(full_pts),
                       ("engine.fit", "dist.grid", "dist.rho", "dist.delta",
                        "dist.fallback", "labels.assign"), card,
                       f"traced distributed {strategy} fit (the shards are "
                       f"logical shards of one card: the times are the "
                       f"kernels' work split {DIST_SHARDS} ways, not an "
                       f"interconnect)")
        attrs = {sp["name"]: sp.get("attrs", {}) for sp in obs.spans()}
        secs, launched, given = counted_dist_fit(eng, full_pts)
        if strategy == "halo":
            swept = ("halo_range_count", "halo_masked_nn",
                     "worklist_masked_nn")
        else:
            swept = ("worklist_range_count", "worklist_masked_nn")
        for name in ("worklist_range_count", "worklist_masked_nn",
                     "halo_range_count", "halo_masked_nn", "range_count",
                     "masked_nn"):
            assert (launched[name] >= 1) == (name in swept), \
                f"{strategy}: launches {launched}"
        ties, tied, lab_diff = same_up_to_ties(
            fx, single.result, eng.result, single.clustering.labels,
            eng.clustering.labels, f"distributed {strategy} vs single-device")
        rows = torch.randperm(N_FULL, generator=gen)[:Q_CHECK].to(dev)
        _, clear = float64_rho_check(pts64, eng.result.rho,
                                     sweep.d2cut_of(d_full), rows)
        float64_dependent_check(pts64, eng.result, rows, None)
        kl = {k: launched[k] for k in swept + ("masked_nn", "range_count")}
        print(f"distributed Ex-DPC, {strategy}, {DIST_SHARDS} shards on one "
              f"card, block-sparse: n={N_FULL}: {secs * 1e3:.1f} ms (single "
              f"device {single_s * 1e3:.1f} ms), launches {kl}; == the "
              f"single-device fit (rho, rho_key, delta bit for bit; {ties} "
              f"parents decided by exact distance ties, {tied} rows "
              f"downstream, {lab_diff} labels differ); rho == float64 on "
              f"{Q_CHECK} random rows ({clear} clear of the band), "
              f"delta/parent == float64 masked search on them  ({card})",
              flush=True)
        rec = {"fit_ms": secs * 1e3, "launches": launched,
               "parent_ties": ties, "labels_differ": lab_diff, **trace}
        m_rows = -(-N_FULL // DIST_SHARDS)
        if strategy == "halo":
            a = attrs["dist.rho"]
            unres = attrs.get("dist.fallback", {}).get("unresolved", 0)
            rec.update(window=a["window"], hops_fwd=a["hops_fwd"],
                       hops_bwd=a["hops_bwd"], unresolved=unres)
            print(f"  halo window W={a['window']}, hops {a['hops_fwd']} "
                  f"forward {a['hops_bwd']} back: the ring moves "
                  f"{(a['hops_fwd'] + a['hops_bwd']) * m_rows} rows per "
                  f"shard against the gather's {DIST_SHARDS * m_rows}; "
                  f"{unres} rows unresolved by the stencil go to the "
                  f"fallback (K9)", flush=True)
        dist_rec[strategy] = rec
        dist_given[strategy], dist_launches[strategy] = given, launched
        del eng
    del pts64
    torch.cuda.empty_cache()

    # the kernels at the main path's shapes: times of every call of the
    # counted runs, plain versions on slices, bounds from their inputs
    def row_tile_slice(wl, n_rows, count):
        """A few row tiles spread over a worklist (the last one ragged)."""
        from repro_torch.kernels.blocksparse import BLOCK_N
        nbr = wl.num_row_tiles
        tiles = torch.linspace(0, nbr - 1, count).round().long().unique()
        tiles = tiles.to(dev)
        rows = (tiles[:, None] * BLOCK_N
                + torch.arange(BLOCK_N, device=dev)).flatten()
        return sub_worklist(wl, tiles), rows[rows < n_rows]

    g8 = dist_given["gather"]["worklist_range_count"]
    (x8, y8, dc8), kw8 = g8[0]
    sub, rows = row_tile_slice(kw8["worklist"], x8.shape[0], DIST_PLAIN_TILES)
    got = k8(x8[rows].contiguous(), y8, dc8, sub)
    check_equal("worklist_range_count [main path, row tiles]", [got],
                [k8(x8, y8, dc8, kw8["worklist"])[rows]], "the fit's call")
    want, p_ms = timed_once(lambda: k8_plain(x8[rows].contiguous(), y8, dc8,
                                             sub))
    errs["worklist_range_count"] = check_equal(
        "worklist_range_count [main path, row tiles]", [got], [want])
    main_times["worklist_range_count"] = {
        "ms": sum(time_ms(lambda a=a, kw=kw: k8(*a, kw["worklist"]))
                  for a, kw in g8), "plain_ms": p_ms,
        "plain_rows": rows.numel()}
    works = [k8_work(a[0], a[1], kw["worklist"]) for a, kw in g8]
    bounds["worklist_range_count"] = (sum(w[0] for w in works),
                                      sum(w[1] for w in works))

    k9_rec = {}
    for strategy in ("gather", "halo"):
        calls = dist_given[strategy]["worklist_masked_nn"]
        ms, nb, no, comp, ring = 0.0, 0.0, 0.0, 0, 0
        for (x9, xk9, y9, yk9), kw in calls:
            wl9 = kw["worklist"]
            live = torch.zeros(wl9.num_row_tiles, dtype=torch.int32,
                               device=dev)
            d9, _ = k9(x9, xk9, y9, yk9, wl9, live)
            comp, ring = comp + int(live.sum()), ring + wl9.n_kept
            ms += time_ms(lambda: k9(x9, xk9, y9, yk9, wl9))
            b, o, info = k9_work(x9, xk9, y9, yk9, wl9, torch.square(d9),
                                 gen=gen)
            nb, no = nb + b, no + o
        k9_rec[strategy] = {"ms": ms, "calls": len(calls),
                            "rows": [c[0][0].shape[0] for c in calls],
                            "computed": comp, "ring": ring,
                            "bound": bound_ms(nb, no), "work": (nb, no)}
    (x9, xk9, y9, yk9), kw9 = dist_given["gather"]["worklist_masked_nn"][-1]
    sub, rows = row_tile_slice(kw9["worklist"], x9.shape[0], DIST_PLAIN_TILES)
    sx, sk = x9[rows].contiguous(), xk9[rows].contiguous()
    got = k9(sx, sk, y9, yk9, sub)
    check_equal("worklist_masked_nn [main path, row tiles]", got,
                [t[rows] for t in k9(x9, xk9, y9, yk9, kw9["worklist"])],
                "the fit's call")
    want, p_ms = timed_once(lambda: k9_plain(sx, sk, y9, yk9, sub))
    errs["worklist_masked_nn"] = check_equal(
        "worklist_masked_nn [main path, row tiles]", got, want)
    main_times["worklist_masked_nn"] = {
        "ms": k9_rec["gather"]["ms"], "plain_ms": p_ms,
        "plain_rows": rows.numel(), "halo_fallback_ms": k9_rec["halo"]["ms"]}
    bounds["worklist_masked_nn"] = k9_rec["gather"]["work"]

    for name, kern, plain, work in (
            ("halo_range_count", k10, k10_plain, k10_work),
            ("halo_masked_nn", k11, k11_plain, k11_work)):
        calls = dist_given["halo"][name]
        a0 = calls[0][0]
        r = min(DIST_PLAIN_ROWS, a0[0].shape[0])
        if name == "halo_masked_nn":   # x, x_key, window, w_key, starts, ends
            sl = [a0[0][:r].contiguous(), a0[1][:r].contiguous(), a0[2],
                  a0[3], a0[4][:r].contiguous(), a0[5][:r].contiguous()]
        else:                          # x, window, starts, ends
            sl = [a0[0][:r].contiguous(), a0[1], a0[2][:r].contiguous(),
                  a0[3][:r].contiguous()]
        want, p_ms = timed_once(lambda: plain(*sl, a0[-1]))
        got = kern(*sl, a0[-1])
        full = kern(*a0)
        got = [got] if name == "halo_range_count" else got
        full = [full] if name == "halo_range_count" else full
        want = [want] if name == "halo_range_count" else want
        check_equal(f"{name} [main path, {r} rows]", got,
                    [t[:r] for t in full], "the fit's call")
        errs[name] = check_equal(f"{name} [main path, {r} rows]", got, want)
        main_times[name] = {"ms": sum(time_ms(lambda a=a: kern(*a))
                                      for a, _ in calls),
                            "plain_ms": p_ms, "plain_rows": r}
        if name == "halo_range_count":
            works = [work(a[0], a[1], a[2], a[3]) for a, _ in calls]
        else:
            works = [work(*a[:6]) for a, _ in calls]
        bounds[name] = (sum(w[0] for w in works), sum(w[1] for w in works))
    for name in ("worklist_range_count", "worklist_masked_nn",
                 "halo_range_count", "halo_masked_nn"):
        t = main_times[name]
        b_ms, by = bound_ms(*bounds[name])
        print(f"{name} [main path, all calls]: kernel {t['ms']:.3f} ms, "
              f"bound {b_ms:.3f} ms ({by}), == plain on {t['plain_rows']} "
              f"rows ({t['plain_ms']:.1f} ms)  ({card})", flush=True)
    for strategy, r9 in k9_rec.items():
        print(f"worklist_masked_nn [{strategy}]: {r9['calls']} calls on "
              f"{r9['rows']} rows, {r9['ms']:.3f} ms, computed "
              f"{r9['computed']} of {r9['ring']} ring entries, bound "
              f"{r9['bound'][0]:.3f} ms ({r9['bound'][1]})  ({card})",
              flush=True)
    dist_rec["k9"] = {k: {kk: vv for kk, vv in v.items() if kk != "work"}
                      for k, v in k9_rec.items()}
    record["distributed_full"] = dist_rec
    del dist_given, g8, x8, y8, kw8, sub, x9, xk9, y9, yk9, kw9, sx, sk
    del single, fx
    torch.cuda.empty_cache()

    # ------------- 18. the dense gather strategy at 2^20, four shards
    dense_dist = DPCEngine(d_cut, rho_min=10, algorithm="exdpc",
                           mesh=ShardMesh.on("cuda", shards=DIST_SHARDS),
                           strategy="gather")
    dense_dist.fit(main_pts)                               # warm-up
    torch.cuda.synchronize()
    secs, launched, _ = counted_dist_fit(dense_dist, main_pts)
    assert launched["range_count"] == launched["masked_nn"] == DIST_SHARDS \
        and not any(launched[k] for k in (
            "worklist_range_count", "worklist_masked_nn",
            "halo_range_count", "halo_masked_nn")), launched
    ties, tied, lab_diff = same_up_to_ties(
        xs, ex_dense_res, dense_dist.result, ex_dense_labels,
        dense_dist.clustering.labels, "dense gather vs dense Ex-DPC")
    pts64 = torch.from_numpy(main_pts).to(dev, torch.float64)
    rows = torch.randperm(N_MAIN, generator=gen)[:Q_CHECK].to(dev)
    float64_rho_check(pts64, dense_dist.result.rho, sweep.d2cut_of(d_cut),
                      rows)
    float64_dependent_check(pts64, dense_dist.result, rows, None)
    del pts64
    record["distributed_dense_2e20"] = {
        "fit_ms": secs * 1e3, "launches": launched, "parent_ties": ties,
        "exdpc_dense_ms": exact_rec["exdpc dense"]["fit_ms"]}
    print(f"distributed Ex-DPC, gather, dense, {DIST_SHARDS} shards: "
          f"n={N_MAIN}: {secs * 1e3:.1f} ms (single-device dense Ex-DPC "
          f"{exact_rec['exdpc dense']['fit_ms']:.1f} ms), launches "
          f"range_count {launched['range_count']}, masked_nn "
          f"{launched['masked_nn']}; == phase 7's dense Ex-DPC (rho, rho_key, "
          f"delta bit for bit; {ties} parents decided by exact ties, {tied} "
          f"rows downstream, {lab_diff} labels differ); rho and delta/parent "
          f"== float64 on {Q_CHECK} random rows  ({card})", flush=True)
    del dense_dist
    torch.cuda.empty_cache()

    # --------------------------------------------------------- the record
    kernels = []
    for name, launched, where in (
            ("fused_count_topk", launches_dense, "sweep.py:432"),
            ("masked_nn", launches, "sweep.py:432"),
            ("worklist_count_topk", launches, "sweep.py:432"),
            ("fused_count_topk_sel", sel_launches, "sweep.py:432"),
            ("worklist_count_topk_sel", sa_launches, "sweep.py:432"),
            ("prefix_nn", {"prefix_nn": k7_launches}, "dependent.py:28"),
            ("worklist_range_count", dist_launches["gather"],
             "sweep.py:432"),
            ("worklist_masked_nn", dist_launches["gather"], "sweep.py:432"),
            ("halo_range_count", dist_launches["halo"], "density.py:68"),
            ("halo_masked_nn", dist_launches["halo"], "dependent.py:56")):
        t = main_times[name]
        b_ms, by = bound_ms(*bounds[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep.cu",
            "replaces": f"src/repro/kernels/{where}",
            "launches": launched[name],
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        })
        record.setdefault("bounds", {})[name] = {
            "bound_ms": b_ms, "bound_by": by,
            "issue_bound_ms": 1e3 * bounds[name][1] / issue_rate}
    replaces = {"range_count": "src/repro/kernels/sweep.py:432",
                "range_count_signed": "src/repro/kernels/sweep.py:432",
                "gather_masked_nn": "src/repro/kernels/sweep.py:510"}
    for name, where in replaces.items():
        k = streams["mixture"]["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep.cu",
            "replaces": where, "launches": k["launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
    record.update(streams=streams, stream_check_shapes=stream_check,
                  sapprox_check_shapes=sapprox_check,
                  dist_check_shapes=dist_check)
    record.update(kernels=kernels, main_times=main_times,
                  check_shapes=check_times, k3_checks=k3_checks,
                  main={"fit_ms": full_s * 1e3, "n": N_FULL, "d_cut": d_full,
                        "clusters": n_clusters_full,
                        "cell_maxima": fmax.numel(), "k2_rows": k2_rows_full,
                        "worklist": wl_full, **trace_full},
                  issue_rate=issue_rate,
                  seconds=time.perf_counter() - t_start,
                  clocks_after=smi("clocks.sm,power.draw,temperature.gpu"))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(f"chip_smoke: {record['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
