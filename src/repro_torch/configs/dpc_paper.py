"""The paper's own experiment configurations (§6).

Dataset cards (dims / cardinality / domain / default d_cut) from the paper,
plus the parameter defaults used across its tables.  At container scale the
benchmarks regenerate distribution-matched proxies via data/points.py and
re-derive d_cut with the same quantile rule (core/tuning.pick_dcut); these
cards document the paper-exact values for full-scale runs.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dpc_api import DPCConfig


@dataclass(frozen=True)
class DatasetCard:
    name: str
    d: int
    n: int
    domain: float
    d_cut: float          # the paper's default
    source: str


PAPER_DATASETS = {
    "syn": DatasetCard("syn", 2, 100_000, 1e5, 250.0,
                       "random-walk generator of [Gan & Tao '15]"),
    "s1": DatasetCard("s1", 2, 5_000, 1e5, 250.0, "Franti & Sieranoja"),
    "s2": DatasetCard("s2", 2, 5_000, 1e5, 250.0, "Franti & Sieranoja"),
    "s3": DatasetCard("s3", 2, 5_000, 1e5, 250.0, "Franti & Sieranoja"),
    "s4": DatasetCard("s4", 2, 5_000, 1e5, 250.0, "Franti & Sieranoja"),
    "airline": DatasetCard("airline", 3, 5_810_462, 1e6, 1000.0,
                           "stat-computing.org dataexpo 2009"),
    "household": DatasetCard("household", 4, 2_049_280, 1e5, 1000.0, "UCI"),
    "pamap2": DatasetCard("pamap2", 4, 3_850_505, 1e5, 1000.0, "UCI"),
    "sensor": DatasetCard("sensor", 8, 928_991, 1e5, 5000.0, "UCI"),
}

# Table 5: per-dataset eps chosen by the paper from the time/accuracy trade
PAPER_EPS = {"airline": 0.8, "household": 0.8, "pamap2": 0.8, "sensor": 0.6}

# rho_min "specified to remove points with (very) small local densities"
PAPER_RHO_MIN = 10.0


def paper_config(dataset: str, algorithm: str = "approxdpc") -> DPCConfig:
    card = PAPER_DATASETS[dataset]
    return DPCConfig(d_cut=card.d_cut, rho_min=PAPER_RHO_MIN,
                     algorithm=algorithm,
                     eps=PAPER_EPS.get(dataset, 0.8))
