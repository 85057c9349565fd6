"""Fixed-capacity sliding-window point store (ring buffer, slot-stable):
the port of ``repro/stream/window.py``.

``capacity`` slots whose identity is stable: a point keeps its slot for its
whole lifetime, so every per-point quantity (rho, cell id, the density
jitter) is slot-indexed and survives ticks without reindexing.  The oldest
point always sits at the cursor, so eviction overwrites the next ``r``
slots.  During warm-up the occupied slots are exactly the prefix
``[0, count)``.

The window lives twice: a host numpy mirror (the grid bookkeeping and the
center registry read it) and a device tensor (the kernels read it).
``push`` updates the device tensor **in place** (``index_copy_`` of the
real rows only; padding rows are dropped by mask, where the reference
scatters them out of range), so a caller that must roll a push back keeps
a clone of ``device``, not a reference to it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.sweep import PAD_COORD


class SlidingWindow:
    """Ring buffer of points with a host mirror and a device table."""

    def __init__(self, capacity: int, dim: int, device="cpu"):
        self.capacity = int(capacity)
        self.dim = int(dim)
        # empty slots sit at PAD_COORD: far outside any d_cut, so warm-up
        # reads (a query's NN) never match them
        self.host = np.full((capacity, dim), PAD_COORD, np.float32)
        self.device = torch.full((capacity, dim), PAD_COORD,
                                 dtype=torch.float32, device=device)
        self.count = 0          # occupied slots (== capacity at steady state)
        self.cursor = 0         # next slot to fill / evict (ring order)
        self.ticks = 0

    @property
    def full(self) -> bool:
        return self.count == self.capacity

    def contents(self) -> np.ndarray:
        """Current window contents in slot order (host copy, (count, d))."""
        return self.host[: self.count].copy()

    def push(self, batch: np.ndarray, r: int):
        """Overwrite the next ``r`` ring slots with ``batch[:r]``.

        ``batch`` is the (batch_cap, d) micro-batch; rows past ``r`` are
        padding.  Returns ``(slots, evicted, evicted_valid)``:

        * ``slots``          (batch_cap,) int64 — target slot per batch row,
                             ``capacity`` for padding rows;
        * ``evicted``        (batch_cap, d) f32 — the *old* contents of those
                             slots (garbage where not ``evicted_valid``);
        * ``evicted_valid``  (batch_cap,) bool — True where the slot held a
                             live point that this push evicts.
        """
        cap, B = self.capacity, batch.shape[0]
        if not 0 <= r <= min(B, cap):
            raise ValueError(f"push of {r} rows from a batch of {B} into a "
                             f"window of {cap}")
        slots = np.full((B,), cap, np.int64)
        ring = (self.cursor + np.arange(r)) % cap
        slots[:r] = ring
        evicted = self.host[np.minimum(slots, cap - 1)].copy()
        evicted_valid = np.zeros((B,), bool)
        evicted_valid[:r] = ring < self.count
        self.host[ring] = batch[:r]
        if r:
            dev = self.device.device
            self.device.index_copy_(
                0, torch.from_numpy(ring).to(dev),
                torch.from_numpy(np.ascontiguousarray(batch[:r])).to(dev))
        self.cursor = int((self.cursor + r) % cap)
        self.count = min(self.count + r, cap)
        self.ticks += 1
        return slots, evicted, evicted_valid
