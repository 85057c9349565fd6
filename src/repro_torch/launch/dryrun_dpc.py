"""Dry run of the distributed DPC phases: the port of
``repro/launch/dryrun_dpc.py``.

    python -m repro_torch.launch.dryrun_dpc [--n N] [--d D] [--span-w W] \\
        [--window-blocks K] [--multipod] [--out DIR]

The paper's parallel algorithm itself, phase by phase, costed per shard
without allocating a point: the reference's four phases and their port
counterparts in ``distributed/dpc.py``

    rho_gather    ``_rho_stencil``   all-gather the table, K10 over it
    rho_halo      ``_rho_halo``      ppermute ring window, K10 over it
    delta_gather  ``_delta_stencil`` all-gather table and keys, K11
    delta_halo    ``_delta_halo``    ppermute ring of (point, key), K11

Per phase and shard: the kernel's work from ``launch/kernel_cost.py``
with each row's 3^(min(d, 3) - 1) spans (9 at d = 3) of ``span_w``
columns as the upper bound, as the reference's phases take them (so the
phase's ``pairs`` are an upper bound; the kernels' f32 work holds no
matrix product, so ``dot_flops`` is 0); the collective payload per kind
with ``collective_stats``' conventions (an all-gather its gathered
output, a ppermute its tensor); and the phase's bound on the published
H100 rates.  Shards hold ceil(n / S) rows, the port's padding
(``distributed_dpc`` pads the table to a multiple of S).  The halo
phases' window is ``window_blocks`` blocks, reached by
max(1, (window_blocks - 1) // 2) hops each way, as in the reference.
Defaults are the reference's: n = 2^24, d = 3, span_w = 64, 3 window
blocks, 256 shards (512 with ``--multipod``); nothing is compiled, so the
record has no ``compile_s`` or ``temp_bytes``.
"""
from __future__ import annotations

import argparse
import json
import os

from . import kernel_cost

__all__ = ["PHASES", "phase_costs", "run", "main"]

# reference phase -> (the port's phase function, its kernel)
PHASES = {"rho_gather": ("_rho_stencil", "halo_range_count"),
          "rho_halo": ("_rho_halo", "halo_range_count"),
          "delta_gather": ("_delta_stencil", "halo_masked_nn"),
          "delta_halo": ("_delta_halo", "halo_masked_nn")}


def _spans(d: int) -> int:
    return 3 ** (min(d, 3) - 1)


def phase_costs(n: int, d: int, span_w: int, shards: int,
                window_blocks: int) -> dict:
    """Per phase, one shard's kernel work, collectives and bound."""
    m = -(-n // shards)                  # rows per shard, padded
    n_pad = m * shards
    spans = _spans(d)
    hops = 2 * max(1, (window_blocks - 1) // 2)
    W = window_blocks * m
    out = {}
    for name, (fn, kernel) in PHASES.items():
        halo = name.endswith("halo")
        window = W if halo else n_pad
        pairs = float(m * min(spans * span_w, window))
        if kernel == "halo_range_count":
            work = kernel_cost.k10_work(m, window, d, spans, pairs)
            cols = d                     # the ring moves points
        else:
            work = kernel_cost.k11_work(m, window, d, spans, pairs, pairs)
            cols = d + 1                 # points and their keys
        if halo:
            coll = {"collective-permute": 4 * hops * m * cols}
            counts = {"collective-permute": hops}
        else:
            coll = {"all-gather": 4 * n_pad * cols}
            counts = {"all-gather": 1 if cols == d else 2}
        b_ms, by = kernel_cost.bound_ms(work)
        out[name] = {
            "port_phase": fn, "kernel": kernel_cost.KERNELS[kernel][0],
            "rows_per_shard": m, "window": window, "spans": spans,
            "pairs": pairs, "pairs_upper_bound": True,
            "flops": work.ops, "dot_flops": 0.0, "bytes": work.bytes,
            "collectives": {"bytes": coll, "counts": counts,
                            "total_bytes": float(sum(coll.values()))},
            "bound_ms": b_ms, "bound_by": by}
    return out


def run(n: int, d: int, span_w: int, window_blocks: int, shards: int,
        out_dir: str | None) -> dict:
    """Cost every phase, print a line each and, with ``out_dir``, write
    the reference's record shape there."""
    recs = phase_costs(n, d, span_w, shards, window_blocks)
    for name, r in recs.items():
        print(f"[dpc-dryrun] {name}: flops/dev={r['flops']:.3g} "
              f"bytes={r['bytes']:.3g} "
              f"coll={r['collectives']['total_bytes']:.3g}B "
              f"bound={r['bound_ms']:.4g}ms ({r['bound_by']})", flush=True)
    rec = {"n": n, "d": d, "span_w": span_w, "devices": shards,
           "window_blocks": window_blocks, "phases": recs}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"dpc__n{n}__s{shards}.json"),
                  "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="cost the distributed DPC "
                                 "phases per shard without data")
    ap.add_argument("--n", type=int, default=1 << 24)   # 16.7M points
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--span-w", type=int, default=64)
    ap.add_argument("--window-blocks", type=int, default=3)
    ap.add_argument("--multipod", action="store_true",
                    help="512 shards (the reference's two pods), not 256")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    run(args.n, args.d, args.span_w, args.window_blocks,
        512 if args.multipod else 256, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
