"""Quickstart on the PyTorch/CUDA port: cluster a 2-D Gaussian mixture
with every DPC algorithm through ``DPCEngine`` and print the decision
graph's peaks (paper Fig. 1) and the Rand agreement; the counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py [--n 8000] \\
        [--exec cuda:block-sparse] [--device cpu]

``--exec backend:layout:precision`` is the uniform execution flag
(``ExecSpec.parse``): ``cuda`` (the kernels) or ``torch`` (the plain
reference math), ``dense`` or ``block-sparse``, ``f32`` or ``bf16``.
Runs on the card unless ``--device`` says otherwise, and raises where
there is none.
"""
import argparse

import numpy as np
import torch

from repro_torch import DPCEngine, ExecSpec
from repro_torch.core.device import resolve_device
from repro_torch.core.metrics import rand_index
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import gaussian_mixture


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def main(n=8000, exec_spec=None, device=None):
    dev = resolve_device(device)
    k = 15
    pts, true_labels = gaussian_mixture(n, k=k, d=2, overlap=0.015, seed=0)
    # d_cut: ~1.5% distance quantile (the paper's rule of thumb)
    d_cut = pick_dcut(pts, target_rho=max(min(40, n // 200), 5))
    spec = exec_spec or ExecSpec()
    print(f"n={n}, k={k}, d_cut={d_cut:.1f}, exec={spec.describe()}, "
          f"device={dev}")

    ref_labels = ref_eng = None
    for algo in ("exdpc", "approxdpc", "sapproxdpc", "scan", "lsh_ddp"):
        eng = DPCEngine(d_cut=d_cut, rho_min=8, algorithm=algo,
                        exec_spec=spec, device=dev).fit(pts)
        labels = eng.labels_
        if ref_labels is None:          # exdpc = reference
            ref_labels, ref_eng = labels, eng
            dg = _np(eng.decision_graph())
            gamma = dg[:, 0] * np.where(np.isfinite(dg[:, 1]), dg[:, 1],
                                        dg[np.isfinite(dg[:, 1]), 1].max())
            top = np.sort(gamma)[-k - 3:]
            print(f"  decision-graph gap: top-{k} gamma >= {top[3]:.3g}, "
                  f"next {top[2]:.3g} (clear gap = easy center selection)")
        ri = rand_index(ref_labels, labels)
        vs_true = rand_index(true_labels, labels)
        print(f"  {algo:12s} clusters={int(eng.clustering.num_clusters):3d} "
              f"rand_vs_exdpc={ri:.4f} rand_vs_truth={vs_true:.4f}")

    # the engine's serve-side read path: label unseen points without refit
    # (on the exact reference engine, not whichever baseline ran last)
    probe, _ = gaussian_mixture(64, k=k, d=2, overlap=0.015, seed=1)
    q = ref_eng.predict(probe)
    hits = int((_np(q.status) == 0).sum())
    print(f"  predict: {hits}/{len(probe)} probes HIT within d_cut "
          f"(rest fall back to the nearest center)")
    return ref_eng


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--exec", dest="exec_spec", default=None,
                    help="backend:layout:precision (ExecSpec.parse)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    main(n=a.n, exec_spec=ExecSpec.parse(a.exec_spec)
         if a.exec_spec else None, device=a.device)
