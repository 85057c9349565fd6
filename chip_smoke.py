#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--out PATH]

Phases, each of which raises on failure (nothing is caught):

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, and the seconds ``nvcc`` took to build ``kernels/csrc/sweep.cu``.
2. Kernels vs plain at check shapes: each CUDA kernel against its plain
   PyTorch version on the same inputs on the card, bit for bit (ragged
   rows, d = 2..64, equal keys), with the median time of five runs after a
   warm-up (CUDA events) at 65,536 rows.
3. The main path at full width: ``DPCEngine(d_cut, rho_min=10).fit`` on
   the Airline proxy (d = 3) at n = 1,048,576 (cut from Airline's
   5,810,462: the dense layout is quadratic), d_cut from the benchmarks'
   rule ``pick_dcut(target_rho=30)``.  The launch counts are zeroed just
   before the timed fit and read just after it; the inputs each kernel was
   given in that fit are kept.
4. Kernels vs plain at the main path's shapes: each kernel's wrapper is
   called again on the inputs the fit gave it (K1: 2^20 x 2^20; K2: the
   unresolved cell maxima against all 2^20 rows) and held bit for bit
   against its plain version; the fit's rho must equal the plain count.
   Kernel times are medians of five CUDA-event runs after a warm-up; the
   plain time is its one comparison run, timed by CUDA events.
5. The fit's answer against float64: rho on 4,096 random rows, and the
   parent and delta of every cell maximum (rules 2 and 3) against a
   float64 masked search over all n.  A traced fit gives the phase times.

Prints the card line and a ``{"kernels": [...]}`` line, and as its last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
where no CUDA device is present.  ``--out`` also writes the full record
(check-shape times, issue-rate bounds, phase times) as JSON.
"""
from __future__ import annotations

import argparse
import json
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

N_MAIN = 1 << 20
N_CHECK = 65536
Q_CHECK = 4096
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


def k2_work(x_key, y_key, d: int) -> tuple[float, float]:
    """Bytes and operations of masked_nn on these keys: a key test per
    pair, and 3d+1 operations for each pair whose column is denser."""
    n, m = x_key.numel(), y_key.numel()
    ys = torch.sort(y_key).values
    denser = float((m - torch.searchsorted(ys, x_key, right=True)).sum())
    nbytes = 4 * (n * d + n + m * d + m) + 8 * n
    return nbytes, float(n) * m + denser * (3 * d + 1)


def check_equal(name: str, got, want) -> float:
    """Bit-equality of every output; returns the max abs error of the
    finite float outputs (0.0 when equal)."""
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            bad = (g != w) & ~(torch.isnan(g) & torch.isnan(w)) \
                if g.is_floating_point() else g != w
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version on {int(bad.sum())} entries")
        if g.is_floating_point():
            fin = torch.isfinite(w)
            if fin.any():
                err = max(err, float((g[fin] - w[fin]).abs().max()))
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    from repro_torch import DPCEngine, obs
    from repro_torch.core.approxdpc import _group_segments, _maxima_mask
    from repro_torch.core.dpc_types import density_jitter
    from repro_torch.core.grid import build_grid
    from repro_torch.core.tuning import pick_dcut
    from repro_torch.data.points import gaussian_mixture, real_proxy
    from repro_torch.kernels import build, ops, sweep

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

    def k2(x, xk, y, yk):
        return ops.dependent_masked(x, xk, y, yk)

    def k2_plain(x, xk, y, yk):
        best, arg = sweep.masked_nn_plain(x, xk, y, yk)
        return torch.sqrt(best), arg

    cases = [("airline", real_proxy("airline", N_CHECK, seed=0)[0])]
    for d in (2, 4, 8):
        cases.append((f"mixture d={d}", gaussian_mixture(1000, d=d, seed=d)[0]))
    cases.append(("normal d=64", np.random.default_rng(64).normal(
        size=(300, 64)).astype(np.float32)))
    for label, pts in cases:
        x = torch.from_numpy(pts).to(dev)
        dc = pick_dcut(pts, target_rho=30)
        check_equal(f"fused_count_topk [{label}]", k1(x, x, dc),
                    k1_plain(x, x, dc))
        print(f"fused_count_topk == plain, bit for bit: {label}, "
              f"n={len(pts)} d={pts.shape[1]}", flush=True)

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

    check_times = {
        "fused_count_topk": {
            "shape": f"n=m={N_CHECK} d=3",
            "ms": time_ms(lambda: k1(x, x, dc)),
            "plain_ms": time_ms(lambda: k1_plain(x, x, dc))},
        "masked_nn": {
            "shape": f"q={Q_CHECK} m={N_CHECK} d=3",
            "ms": time_ms(lambda: k2(q, qk, x, key)),
            "plain_ms": time_ms(lambda: k2_plain(q, qk, x, key))},
    }
    for name, t in check_times.items():
        print(f"{name} [{t['shape']}]: kernel {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms  ({card})", flush=True)

    # ------------------------------------------- 3. the main path, full width
    main_pts, _ = real_proxy("airline", N_MAIN, seed=0)
    d_cut = pick_dcut(main_pts, target_rho=30)
    engine = DPCEngine(d_cut, rho_min=10)
    engine.fit(main_pts)                                   # warm-up
    torch.cuda.synchronize()

    # keep the inputs each kernel is given in the counted fit
    given: dict[str, list] = {"fused_count_topk": [], "masked_nn": []}
    launch_k1, launch_k2 = ops.fused_sweep, ops.dependent_masked

    def recording_k1(*a, **kw):
        given["fused_count_topk"].append(a)
        return launch_k1(*a, **kw)

    def recording_k2(*a):
        given["masked_nn"].append(a)
        return launch_k2(*a)

    ops.fused_sweep, ops.dependent_masked = recording_k1, recording_k2
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        engine.fit(main_pts)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        ops.fused_sweep, ops.dependent_masked = launch_k1, launch_k2
    k2_rows = [a[0].shape[0] for a in given["masked_nn"]]
    print(f"fit: n={N_MAIN} d=3 d_cut={d_cut!r}: {fit_s * 1e3:.1f} ms, "
          f"launches {launches}, masked_nn rows {k2_rows}  ({card})",
          flush=True)
    for name, count in launches.items():
        assert count >= 1, f"the main path never launched {name}"
        assert len(given[name]) == count, (name, len(given[name]), count)
    res, cl = engine.result, engine.clustering

    # ------------------------------ 4. kernels vs plain, the main path's shapes
    main_times: dict[str, dict] = {}
    errs = {"fused_count_topk": 0.0, "masked_nn": 0.0}
    bounds: dict[str, tuple] = {}
    (mx, my, mdc), = given["fused_count_topk"]
    want, plain_ms = timed_once(lambda: k1_plain(mx, my, mdc))
    errs["fused_count_topk"] = check_equal(
        "fused_count_topk [main path]", k1(mx, my, mdc), want)
    assert torch.equal(res.rho, want[0]), \
        "the fit's rho differs from the plain count"
    main_times["fused_count_topk"] = {
        "ms": time_ms(lambda: k1(mx, my, mdc)), "plain_ms": plain_ms}
    bounds["fused_count_topk"] = k1_work(mx.shape[0], my.shape[0],
                                         mx.shape[1])
    print(f"fused_count_topk == plain, bit for bit, and rho == plain count: "
          f"main path n=m={mx.shape[0]} d={mx.shape[1]}", flush=True)

    k2_ms, k2_plain_ms, k2_bytes, k2_ops = 0.0, 0.0, 0.0, 0.0
    for i, (xq, xk, y, yk) in enumerate(given["masked_nn"]):
        want, p_ms = timed_once(lambda: k2_plain(xq, xk, y, yk))
        errs["masked_nn"] = max(errs["masked_nn"], check_equal(
            f"masked_nn [main path, call {i}]", k2(xq, xk, y, yk), want))
        k2_ms += time_ms(lambda: k2(xq, xk, y, yk))
        k2_plain_ms += p_ms
        nb, no = k2_work(xk, yk, xq.shape[1])
        k2_bytes, k2_ops = k2_bytes + nb, k2_ops + no
    main_times["masked_nn"] = {"ms": k2_ms, "plain_ms": k2_plain_ms}
    bounds["masked_nn"] = (k2_bytes, k2_ops)
    print(f"masked_nn == plain, bit for bit: main path q={k2_rows} "
          f"m={N_MAIN} d=3", flush=True)
    for name, t in main_times.items():
        print(f"{name} [main path]: kernel {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms  ({card})", flush=True)

    # ---------------------------------------- 5. the fit against float64
    pts64 = torch.from_numpy(main_pts).to(dev, torch.float64)
    thr = sweep.d2cut_of(d_cut)
    band = 4 * float(np.spacing(np.float32(thr)))
    rows = torch.randperm(N_MAIN, generator=torch.Generator().manual_seed(0))
    rows = rows[:Q_CHECK].to(dev)
    lo = torch.empty(Q_CHECK, dtype=torch.int64, device=dev)
    hi = torch.empty_like(lo)
    for r0 in range(0, Q_CHECK, 64):
        d2 = ((pts64[rows[r0:r0 + 64], None, :] - pts64[None]) ** 2).sum(-1)
        lo[r0:r0 + 64] = (d2 < thr - band).sum(1)
        hi[r0:r0 + 64] = (d2 < thr + band).sum(1)
    rho = res.rho[rows].to(torch.int64)
    off = int(((rho < lo) | (rho > hi)).sum())
    assert off == 0, f"rho off the float64 count on {off} of {Q_CHECK} rows"
    exact_rows = int((lo == hi).sum())
    print(f"rho == float64 count on {Q_CHECK} random rows ({exact_rows} "
          f"with no pair within 4 ulps of d_cut^2)", flush=True)

    # every cell maximum: rule 2 (a denser point within d_cut, delta stamped
    # d_cut) or rule 3 (the exact nearest denser point, inf at the peak)
    xs = torch.from_numpy(main_pts).to(dev)
    grid = build_grid(xs, d_cut)
    cellmax = _maxima_mask(grid, _group_segments(grid), res.rho_key)
    maxima = torch.nonzero(cellmax).flatten()
    dc32 = float(np.float32(d_cut))
    key64 = res.rho_key.to(torch.float64)
    n_rule2 = 0
    for r0 in range(0, maxima.numel(), 32):
        rr = maxima[r0:r0 + 32]
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
        assert bool((dl[rule2] == dc32).all()), \
            "a cell maximum with a denser point within d_cut must get d_cut"
        torch.testing.assert_close(dl[rule3].double(), best[rule3].sqrt(),
                                   rtol=1e-6, atol=0)
        n_rule2 += int(rule2.sum())
    n_clusters = int(cl.num_clusters)
    assert n_clusters >= 1, "no cluster found"
    print(f"parent/delta == float64 masked search on all {maxima.numel()} "
          f"cell maxima ({n_rule2} rule 2); {n_clusters} clusters",
          flush=True)

    # traced fit: phase times
    obs.configure("trace")
    obs.reset_spans()
    torch.cuda.reset_peak_memory_stats()
    try:
        engine.fit(main_pts)
    finally:
        obs.configure("off")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phases: dict[str, float] = {}
    for sp in obs.spans():
        phases[sp["name"]] = phases.get(sp["name"], 0.0) + sp["host_s"]
    for name in ("engine.fit", "approxdpc.grid", "approxdpc.rho_delta",
                 "rho_delta.sweep", "rho_delta.resolve", "rho_delta.fallback",
                 "approxdpc.rules", "labels.assign"):
        print(f"  phase {name}: {1e3 * phases.get(name, 0.0):.2f} ms")
    print(f"  peak device memory {peak_gb:.2f} GB  ({card})", flush=True)

    # --------------------------------------------------------- the record
    sources = {"fused_count_topk": "src/repro/kernels/sweep.py:432",
               "masked_nn": "src/repro/kernels/dependent.py:42"}
    kernels = []
    for name, t in main_times.items():
        b_ms, by = bound_ms(*bounds[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        })
        record.setdefault("bounds", {})[name] = {
            "bound_ms": b_ms, "bound_by": by,
            "issue_bound_ms": 1e3 * bounds[name][1] / issue_rate}
    record.update(kernels=kernels, check_shapes=check_times,
                  fit_ms=fit_s * 1e3, d_cut=d_cut, n=N_MAIN,
                  clusters=n_clusters, cell_maxima=maxima.numel(),
                  rule2_rows=n_rule2, k2_rows=k2_rows,
                  phases_ms={k: 1e3 * v for k, v in phases.items()},
                  peak_gb=peak_gb, issue_rate=issue_rate,
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
