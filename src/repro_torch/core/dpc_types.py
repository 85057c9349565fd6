"""Shared DPC result type and the density tie-break rule.

The paper assumes all local densities are distinct, "which is practically
possible by adding a random value in (0,1) to rho_i" (§3).  The jitter is
*deterministic* — a fixed pseudo-random permutation of point indices scaled
into (0,1) — and bit-identical to the reference's
``repro/core/dpc_types.py::density_jitter``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_KNUTH = 2654435761  # Fibonacci hashing multiplier


class DPCResult(NamedTuple):
    rho: torch.Tensor      # (n,) float32 — integer local density (self included)
    rho_key: torch.Tensor  # (n,) float32 — rho + jitter, all-distinct key
    delta: torch.Tensor    # (n,) float32 — dependent distance (inf at the peak)
    parent: torch.Tensor   # (n,) int32 — dependent point (original index); -1 = none


def density_jitter(n: int, device=None) -> torch.Tensor:
    """Deterministic jitter in (0, 1), one value per point.

    The uint32 hash ``(idx*K) ^ (idx>>13)`` is computed in int64 and masked
    to 32 bits.  It is not a bijection, so equal hashes happen and their
    order decides their ranks: both argsorts are stable, as ``jnp.argsort``
    is by default.  The division is tensor by tensor, so no backend swaps it
    for a product with the reciprocal.
    """
    idx = torch.arange(n, dtype=torch.int64, device=device)
    h = ((idx * _KNUTH) & 0xFFFFFFFF) ^ (idx >> 13)
    rank = torch.argsort(torch.argsort(h, stable=True), stable=True)
    num = rank.to(torch.float32) + 0.5
    return num / torch.full_like(num, float(n))


def with_jitter(rho: torch.Tensor) -> torch.Tensor:
    return rho.to(torch.float32) + density_jitter(rho.shape[0], rho.device)
