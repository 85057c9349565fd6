"""HuBERT-style unit discovery with DPC instead of k-means, on the
PyTorch/CUDA port; the counterpart of ``examples/hubert_units.py``.

HuBERT's pseudo-labels come from clustering frame features; k-means is
noise-sensitive and needs k fixed a priori, the weaknesses the DPC paper
targets.  This example embeds synthetic frames with the reduced
hubert-xlarge backbone, clusters the hidden states with Approx-DPC, and
reports cluster quality against k-means on the underlying phone-like
modes.

    PYTHONPATH=src python examples_torch/hubert_units.py [--device cpu]

Runs on the card unless ``--device`` says otherwise, and raises where
there is none.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.core.cfsfdp_a import kmeans_pivots
from repro_torch.core.device import resolve_device
from repro_torch.core.dpc_api import DPCConfig, cluster
from repro_torch.core.metrics import rand_index
from repro_torch.core.tuning import pick_dcut
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm


def main(device=None):
    dev = resolve_device(device)
    cfg = reduce_config(ARCHS["hubert-xlarge"])
    model = build_model(cfg)
    params = model.init(0, device=dev)

    # synthetic "audio": frames drawn around `units` phone modes
    rng = np.random.default_rng(0)
    units, B, L = 10, 4, 256
    modes = rng.normal(0, 1.0, (units, cfg.frontend_dim)).astype(np.float32)
    assign = rng.integers(0, units, (B, L))
    feats = modes[assign] + rng.normal(0, 0.25, (B, L, cfg.frontend_dim))

    # embed with the encoder backbone, project to 3 dims for DPC (the
    # paper's low-dim regime; §2.1 prescribes dimensionality reduction)
    with torch.inference_mode():
        x = torch.einsum("blf,fd->bld", torch.as_tensor(
            feats, dtype=torch.float32, device=dev).to(cfg.dtype),
            params.frontend)
        h = tfm.forward(params, x, cfg,
                        torch.arange(L, dtype=torch.int32, device=dev))
    hidden = h.float().cpu().numpy().reshape(B * L, -1)
    hidden = hidden - hidden.mean(0)
    u, s, _ = np.linalg.svd(hidden, full_matrices=False)
    proj = (u[:, :3] * s[:3]).astype(np.float32)
    truth = assign.reshape(-1)

    d_cut = pick_dcut(proj, target_rho=30)
    out, _ = cluster(proj, DPCConfig(d_cut=d_cut, rho_min=5,
                                     algorithm="approxdpc"), device=dev)
    ri_dpc = rand_index(truth, out.labels.cpu().numpy())

    _, km_assign = kmeans_pivots(torch.from_numpy(proj).to(dev), k=units,
                                 iters=20)
    ri_km = rand_index(truth, km_assign.cpu().numpy())

    print(f"[hubert-units] frames={B * L}, true units={units}, device={dev}")
    print(f"  DPC     units={int(out.num_clusters)}  rand={ri_dpc:.4f} "
          f"(k discovered from the decision graph)")
    print(f"  k-means units={units} (given!)  rand={ri_km:.4f}")
    return ri_dpc, ri_km


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
