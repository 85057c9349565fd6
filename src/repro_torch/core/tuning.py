"""Parameter selection helpers (d_cut from the paper's quantile rule); a
numpy copy of ``repro/core/tuning.py``."""
from __future__ import annotations

import numpy as np


def pick_dcut(points: np.ndarray, target_rho: float = 30.0,
              sample: int = 512, seed: int = 0) -> float:
    """d_cut such that the average local density is ~target_rho.

    rho(d) ~ n * F(d) with F the pairwise-distance CDF; pick the distance
    quantile q = target_rho / n from a sampled distance matrix.
    """
    points = np.asarray(points)
    n = len(points)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(sample, n), replace=False)
    sub = points[idx].astype(np.float64)
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    d = np.sqrt(d2[np.triu_indices(len(sub), 1)])
    q = min(max(target_rho / n, 1e-4), 0.5)
    return float(np.quantile(d, q))
