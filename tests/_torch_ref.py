"""Shared float64 references for the tests of the PyTorch port.

Every helper works in numpy float64 on the f32 points the tests hand to
both packages, so a margin computed here is independent of either
package's f32 arithmetic.
"""
from __future__ import annotations

import numpy as np


def f32_d2cut(d_cut: float) -> float:
    """The threshold both packages compare against: f32(d_cut)**2 in f32."""
    c = np.float32(d_cut)
    return float(c * c)


def pair_d2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(n, m) float64 squared distances."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def near_threshold_rows(x, y, thr: float, margin: float) -> np.ndarray:
    """(n,) bool: the row has a pair whose float64 d2 lies within
    ``margin`` of ``thr`` — where f32 rounding may decide the count."""
    out = np.zeros(len(x), bool)
    for r0 in range(0, len(x), 512):
        d2 = pair_d2(x[r0:r0 + 512], y)
        out[r0:r0 + 512] = (np.abs(d2 - thr) <= margin).any(axis=1)
    return out


def f32_ulp(v: float) -> float:
    """Spacing of f32 values at ``v``."""
    v = np.float32(v)
    return float(np.nextafter(v, np.float32(np.inf)) - v)


def clear_dcut(pts: np.ndarray, target_rho: float = 20.0,
               rel_gap: float = 1e-4) -> float:
    """A d_cut near the ``target_rho`` quantile whose square is farther
    than ``rel_gap`` (relative) from every pair's squared distance, so no
    count depends on rounding: data drawn away from the threshold."""
    n = len(pts)
    d2 = np.sort(pair_d2(pts, pts)[np.triu_indices(n, 1)])
    k = int(min(max(target_rho / n, 1e-4), 0.5) * len(d2))
    lo, hi = max(k - 2000, 0), min(k + 2000, len(d2) - 1)
    window = d2[lo:hi + 1]
    gaps = (window[1:] - window[:-1]) / window[1:]
    j = int(np.argmax(gaps))
    assert gaps[j] > 2 * rel_gap, "no clear threshold near the target"
    return float(np.sqrt(0.5 * (window[j] + window[j + 1])))


def uniform_points(n: int, d: int, seed: int) -> np.ndarray:
    """Unit-scale uniform points, f32: where the expanded form is exact."""
    return np.random.default_rng(seed).uniform(size=(n, d)).astype(np.float32)
