"""Synthetic point-set generators mirroring the paper's datasets (§6); a
numpy copy of ``repro/data/points.py``'s ``gaussian_mixture``,
``random_walk``, ``with_noise``, ``drifting_batches`` and ``real_proxy``.

``real_proxy`` differs in one place: the reference offsets the seed by
``hash(name)``, which Python salts per process, so its data changes from
run to run.  Here the offset is ``zlib.crc32(name)``, so a seed gives the
same points in every process.
"""
from __future__ import annotations

import zlib

import numpy as np

DOMAIN = 1e5


def gaussian_mixture(n: int, k: int = 15, d: int = 2, overlap: float = 0.02,
                     seed: int = 0, domain: float = DOMAIN):
    """k Gaussian blobs; ``overlap`` scales sigma relative to the domain."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.15 * domain, 0.85 * domain, size=(k, d))
    sizes = np.full(k, n // k)
    sizes[: n - sizes.sum()] += 1
    pts, labels = [], []
    for i, (c, m) in enumerate(zip(centers, sizes)):
        pts.append(rng.normal(c, overlap * domain, size=(m, d)))
        labels.append(np.full(m, i))
    x = np.concatenate(pts).astype(np.float32)
    y = np.concatenate(labels).astype(np.int32)
    p = rng.permutation(n)
    return np.clip(x[p], 0, domain), y[p]


def random_walk(n: int, k: int = 13, d: int = 2, seed: int = 0,
                domain: float = DOMAIN, step: float = 0.18,
                sigma: float = 0.025):
    """Syn-style dataset: cluster centers on a random walk [Gan & Tao '15]."""
    rng = np.random.default_rng(seed)
    centers = [rng.uniform(0.2 * domain, 0.8 * domain, size=d)]
    for _ in range(k - 1):
        nxt = centers[-1] + rng.normal(0, step * domain, size=d)
        centers.append(np.clip(nxt, 0.1 * domain, 0.9 * domain))
    centers = np.stack(centers)
    sizes = rng.multinomial(n, np.ones(k) / k)
    pts, labels = [], []
    for i, (c, m) in enumerate(zip(centers, sizes)):
        pts.append(rng.normal(c, sigma * domain, size=(m, d)))
        labels.append(np.full(m, i))
    x = np.concatenate(pts).astype(np.float32)
    y = np.concatenate(labels).astype(np.int32)
    p = rng.permutation(len(x))
    return np.clip(x[p], 0, domain), y[p]


def drifting_batches(batch: int, ticks: int, k: int = 13, d: int = 2,
                     seed: int = 0, domain: float = DOMAIN,
                     step: float = 0.18, sigma: float = 0.025,
                     drift: float = 0.01):
    """Streaming variant of ``random_walk``: yields one micro-batch per tick
    while the cluster centers keep random-walking (``drift`` * domain per
    tick).  Yields ``(points (batch, d), labels (batch,), centers (k, d))``.
    """
    rng = np.random.default_rng(seed)
    centers = [rng.uniform(0.2 * domain, 0.8 * domain, size=d)]
    for _ in range(k - 1):
        nxt = centers[-1] + rng.normal(0, step * domain, size=d)
        centers.append(np.clip(nxt, 0.1 * domain, 0.9 * domain))
    centers = np.stack(centers)
    for _ in range(ticks):
        centers = np.clip(centers + rng.normal(0, drift * domain,
                                               centers.shape),
                          0.05 * domain, 0.95 * domain)
        idx = rng.integers(0, k, size=batch)
        pts = centers[idx] + rng.normal(0, sigma * domain, size=(batch, d))
        yield (np.clip(pts, 0, domain).astype(np.float32),
               idx.astype(np.int32), centers.copy())


_REAL_PROXIES = {
    # name: (d, skew, n_clusters) — domains per §6 of the paper
    "airline": (3, 2.5, 24),
    "household": (4, 1.8, 18),
    "pamap2": (4, 2.2, 20),
    "sensor": (8, 1.5, 12),
}


def real_proxy(name: str, n: int, seed: int = 0, domain: float = DOMAIN):
    """Skewed-density mixture matched to the real dataset's dim/cardinality."""
    d, skew, k = _REAL_PROXIES[name]
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)
    centers = rng.uniform(0.1 * domain, 0.9 * domain, size=(k, d))
    # power-law cluster sizes -> skewed densities
    weights = rng.pareto(skew, k) + 0.05
    weights /= weights.sum()
    sizes = rng.multinomial(n, weights)
    sigmas = rng.uniform(0.005, 0.05, k) * domain
    pts, labels = [], []
    for i in range(k):
        pts.append(rng.normal(centers[i], sigmas[i], size=(sizes[i], d)))
        labels.append(np.full(sizes[i], i))
    x = np.concatenate(pts).astype(np.float32)
    y = np.concatenate(labels).astype(np.int32)
    p = rng.permutation(len(x))
    return np.clip(x[p], 0, domain), y[p]


def with_noise(points: np.ndarray, labels: np.ndarray, rate: float,
               seed: int = 1, domain: float = DOMAIN):
    """Add ``int(len(points) * rate)`` uniform noise points; noise gets
    label -1 (the paper's Table 2 setup).  Returns the shuffled union."""
    rng = np.random.default_rng(seed)
    m = int(len(points) * rate)
    noise = rng.uniform(0, domain, size=(m, points.shape[1])).astype(np.float32)
    x = np.concatenate([points, noise])
    y = np.concatenate([labels, np.full(m, -1, np.int32)])
    p = rng.permutation(len(x))
    return x[p], y[p]
