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

Prints the card line and a ``{"kernels": [...]}`` line (K1 from the dense
path, K2 and K3 from the main path), and as its last line
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from repro_torch import DPCEngine, ExecSpec, obs
    from repro_torch.core.approxdpc import _group_segments, _maxima_mask
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid
    from repro_torch.core.tuning import pick_dcut
    from repro_torch.data.points import gaussian_mixture, real_proxy
    from repro_torch.kernels import blocksparse, build, ops, sweep

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
        given[kind].append((*a, kw.get("worklist")))
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
    (mx, my, mdc, _), = dense_given["fused_count_topk"]
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

    # K3 against its plain version and dense K1 on 256 row tiles
    (fxs, fys, fdc, fwl), = given["worklist_count_topk"]
    nbr = fwl.num_row_tiles
    tiles = torch.linspace(0, nbr - 2, TILES_CHECK).round().long().unique()
    tiles = tiles.to(dev)
    sub = sub_worklist(fwl, tiles)
    bn = blocksparse.BLOCK_N
    sub_rows = (tiles[:, None] * bn
                + torch.arange(bn, device=dev)).flatten()
    sx = fxs[sub_rows].contiguous()
    got = k3(sx, fys, fdc, sub)
    fit_out = k3(fxs, fys, fdc, fwl)
    check_equal("worklist_count_topk [main path, row tiles]", got,
                [t[sub_rows] for t in fit_out], "the fit's full sweep")
    check_equal("worklist_count_topk [main path, row tiles]", got,
                k1(sx, fys, fdc), "dense fused_count_topk")
    want, k3_plain_full_ms = timed_once(lambda: k3_plain(sx, fys, fdc, sub))
    errs["worklist_count_topk"] = check_equal(
        "worklist_count_topk [main path, row tiles]", got, want)
    live = torch.zeros(nbr, dtype=torch.int32, device=dev)
    k3(fxs, fys, fdc, fwl, live=live)
    live_full = int(live.sum())
    main_times["worklist_count_topk"] = {
        "ms": time_ms(lambda: k3(fxs, fys, fdc, fwl)),
        "plain_ms": k3_plain_full_ms, "plain_row_tiles": tiles.numel()}
    needed_full = k3_needed_pairs(fwl, fys.shape[0], fit_out[1])
    bounds["worklist_count_topk"] = k3_work(fxs, fys, fwl, needed_full)
    wl_full = {"kept": fwl.n_kept, "total": fwl.n_total,
               "in_cut": int(fwl.in_cut.sum()), "live": live_full,
               "needed_pairs": needed_full,
               "pruned_frac": fwl.pruned_frac,
               "live_frac_of_dense": live_full / fwl.n_total}
    print(f"worklist_count_topk == plain == dense K1, bit for bit, on "
          f"{tiles.numel()} row tiles x {fys.shape[0]} columns; worklist "
          f"{fwl.n_kept} of {fwl.n_total} tile pairs ({wl_full['in_cut']} "
          f"in d_cut), {live_full} computed, {needed_full} pairs needed; K3 "
          f"{main_times['worklist_count_topk']['ms']:.3f} ms, plain "
          f"{k3_plain_full_ms:.1f} ms on the row tiles  ({card})", flush=True)
    del got, want, fit_out, sub, sx

    # K2 on the fit's unresolved cell maxima; plain on a slice of them
    k2_ms, k2_plain_ms, k2_bytes, k2_ops = 0.0, 0.0, 0.0, 0.0
    errs["masked_nn"] = 0.0
    for i, (xq, xk, y, yk) in enumerate(given["masked_nn"]):
        r = min(K2_PLAIN_ROWS, xq.shape[0])
        want, p_ms = timed_once(lambda: k2_plain(xq[:r], xk[:r], y, yk))
        errs["masked_nn"] = max(errs["masked_nn"], check_equal(
            f"masked_nn [main path, call {i}]",
            [t[:r] for t in k2(xq, xk, y, yk)], want))
        k2_ms += time_ms(lambda: k2(xq, xk, y, yk))
        k2_plain_ms += p_ms
        nb, no = k2_work(xk, yk, xq.shape[1])
        k2_bytes, k2_ops = k2_bytes + nb, k2_ops + no
    main_times["masked_nn"] = {"ms": k2_ms, "plain_ms": k2_plain_ms,
                               "plain_rows": K2_PLAIN_ROWS}
    bounds["masked_nn"] = (k2_bytes, k2_ops)
    print(f"masked_nn == plain, bit for bit, on the first {K2_PLAIN_ROWS} of "
          f"{k2_rows_full} rows x {N_FULL}; kernel {k2_ms:.3f} ms on all "
          f"rows, plain {k2_plain_ms:.3f} ms on the slice  ({card})",
          flush=True)

    # traced fit: phase times and each phase's peak device memory (a span
    # records the most allocated while it was open, the script's own
    # tensors included: ``held_gb`` of them when the fit starts)
    del given, fxs, fys, fwl, fx, fgrid
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    obs.configure("trace")
    obs.reset_spans()
    try:
        with obs.span("smoke.traced_fit"):
            engine.fit(full_pts)
    finally:
        obs.configure("off")
    phases: dict[str, float] = {}
    peaks: dict[str, float] = {}
    for sp in obs.spans():
        phases[sp["name"]] = phases.get(sp["name"], 0.0) + sp["host_s"]
        peaks[sp["name"]] = max(peaks.get(sp["name"], 0.0),
                                sp["peak_bytes"] / 1e9)
    peak_gb = peaks["smoke.traced_fit"]
    for name in ("engine.fit", "approxdpc.grid", "approxdpc.rho_delta",
                 "rho_delta.worklist", "rho_delta.sweep", "rho_delta.resolve",
                 "rho_delta.fallback", "approxdpc.rules", "labels.assign"):
        print(f"  phase {name}: {1e3 * phases.get(name, 0.0):.2f} ms, peak "
              f"{peaks.get(name, 0.0):.3f} GB")
    print(f"  peak device memory {peak_gb:.3f} GB, of which {held_gb:.3f} GB "
          f"held by the script before the fit; fallback rows "
          f"{k2_rows_full}  ({card})", flush=True)

    # --------------------------------------------------------- the record
    kernels = []
    for name, launched in (("fused_count_topk", launches_dense),
                           ("masked_nn", launches),
                           ("worklist_count_topk", launches)):
        t = main_times[name]
        b_ms, by = bound_ms(*bounds[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep.cu",
            "replaces": "src/repro/kernels/sweep.py:432",
            "launches": launched[name],
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        })
        record.setdefault("bounds", {})[name] = {
            "bound_ms": b_ms, "bound_by": by,
            "issue_bound_ms": 1e3 * bounds[name][1] / issue_rate}
    record.update(kernels=kernels, main_times=main_times,
                  check_shapes=check_times, k3_checks=k3_checks,
                  main={"fit_ms": full_s * 1e3, "n": N_FULL, "d_cut": d_full,
                        "clusters": int(fcl.num_clusters),
                        "cell_maxima": fmax.numel(), "k2_rows": k2_rows_full,
                        "worklist": wl_full,
                        "phases_ms": {k: 1e3 * v for k, v in phases.items()},
                        "phases_peak_gb": peaks, "held_gb": held_gb,
                        "peak_gb": peak_gb},
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
