"""Streaming DPC under drift on the PyTorch/CUDA port: sliding-window
clustering with stable ids through ``DPCEngine.partial_fit``; the
counterpart of ``examples/stream_dpc.py``.

A ``drifting_batches`` stream (random-walk cluster centers that keep moving
each tick) feeds the engine: the window fills, steady-state incremental
ingest takes over, and the per-tick output shows cluster continuity (stable
center ids surviving drift, fresh ids for clusters that wander into the
window, the full-rebuild fallback when the walk leaves the indexed box).
``predict`` labels probe points read-only between ticks.

    PYTHONPATH=src python examples_torch/stream_dpc.py [--ticks 40] \\
        [--exec cuda:block-sparse] [--device cpu]

Runs on the card unless ``--device`` says otherwise, and raises where
there is none.
"""
import argparse

import numpy as np
import torch

from repro_torch import DPCEngine, ExecSpec
from repro_torch.core.device import resolve_device
from repro_torch.data.points import drifting_batches


def main(extra_ticks=24, exec_spec=None, device=None):
    dev = resolve_device(device)
    cap, batch, k = 4096, 256, 6
    spec = exec_spec or ExecSpec()
    eng = DPCEngine(d_cut=3500.0, rho_min=8.0, window_capacity=cap,
                    batch_cap=batch, exec_spec=spec,
                    stream_options={"extent_margin": 2}, device=dev)
    stream = drifting_batches(batch=batch, ticks=cap // batch + extra_ticks,
                              k=k, d=2, seed=1, sigma=0.012, drift=0.03)

    prev_ids: set[int] = set()
    print(f"window={cap} batch={batch} d_cut={eng.d_cut:.0f} "
          f"exec={spec.describe()} device={dev} (drifting {k}-cluster walk)")
    for t, (pts, _, centers) in enumerate(stream):
        tick = eng.partial_fit(pts)
        if not eng.stream.window.full:
            continue
        ids = set(int(x) for x in tick.stable_ids)
        born, died = sorted(ids - prev_ids), sorted(prev_ids - ids)
        prev_ids = ids
        noise = int((np.asarray(tick.labels) < 0).sum())
        flags = "".join(["R" if tick.rebuilt else "",
                         "F" if tick.full_recompute else ""])
        print(f"tick {t:3d}  clusters={tick.num_clusters:2d} "
              f"ids={sorted(ids)} born={born or '-'} died={died or '-'} "
              f"noise={noise:4d} {flags}")
    st = eng.stream.stats()
    q = eng.predict(pts)                 # read-only: label the last batch
    status = q.status.cpu() if isinstance(q.status, torch.Tensor) \
        else np.asarray(q.status)
    print(f"\n{st['ticks']} ticks, {st['rebuilds']} grid rebuilds, "
          f"{st['full_recomputes']} full recomputes, "
          f"{st['live_cells']} live cells "
          f"(budget {st['maxima_cap']})")
    print(f"predict on the last batch: {int((status == 0).sum())}"
          f"/{len(q.labels)} HIT")
    print("stable ids persisted across drift; fresh ids only when a "
          "cluster entered/left the window")
    return st


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ticks", type=int, default=24,
                    help="steady-state ticks after the window fills")
    ap.add_argument("--exec", dest="exec_spec", default=None,
                    help="backend:layout:precision (ExecSpec.parse)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    main(extra_ticks=a.ticks, exec_spec=ExecSpec.parse(a.exec_spec)
         if a.exec_spec else None, device=a.device)
