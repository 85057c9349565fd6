"""Noise/center selection (Defs. 4-5) and cluster label propagation (Def. 6).

Labels propagate by pointer jumping on the dependency forest,
``parent <- parent[parent]`` for ceil(log2 n) rounds, as in the reference
(``repro/core/labels.py``).  Chains ascend strictly in density, so the
forest is acyclic and every non-noise point reaches its root.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import obs
from .dpc_types import DPCResult


class Clustering(NamedTuple):
    labels: torch.Tensor        # (n,) int32 — cluster id 0..k-1, -1 for noise
    centers: torch.Tensor       # (n,) bool — cluster-center mask
    num_clusters: torch.Tensor  # () int32


def select_centers(res: DPCResult, rho_min: float, delta_min: float):
    noise = res.rho < rho_min
    centers = (~noise) & (res.delta >= delta_min)
    return centers, noise


def _propagate(parent: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """Pointer-jump until every point points at its root (roots and the
    global peak, whose parent is -1, are self-loops)."""
    n = parent.shape[0]
    ar = torch.arange(n, dtype=torch.int64, device=parent.device)
    p = torch.where(roots, ar, parent.long())
    p = torch.where(p < 0, ar, p)
    for _ in range(max(int(math.ceil(math.log2(max(n, 2)))), 1)):
        p = p[p]
    return p


def assign_labels(res: DPCResult, rho_min: float,
                  delta_min: float) -> Clustering:
    with obs.span("labels.assign") as sp:
        centers, noise = select_centers(res, rho_min, delta_min)
        root = _propagate(res.parent, centers)
        cid = torch.cumsum(centers.to(torch.int32), 0) - 1
        labels = cid[root]
        # a chain that tops out at a noise peak or a sub-delta_min global
        # peak reaches no center: unassigned -> noise
        reached = centers[root]
        labels = torch.where(noise | ~reached, -1, labels).to(torch.int32)
        sp.sync(labels)
    return Clustering(labels=labels, centers=centers,
                      num_clusters=centers.sum(dtype=torch.int32))


def decision_graph(res: DPCResult) -> torch.Tensor:
    """(rho_i, delta_i) pairs for the paper's Fig. 1 decision graph."""
    return torch.stack([res.rho, res.delta], dim=-1)
