"""The card's kernel limits, shared by R4 and R9: the port of
``repro/analysis/limits.py``.

The port's kernels are written for one card, the H100 (``sm_90a``), so the
table has its row.  The figures are the architecture's (CUDA C++
Programming Guide, compute capability 9.0):

=============================  ===========================================
shared memory per block        48 KiB by default, 227 KiB (232,448 B)
                               with the opt-in (``smem_bytes``)
shared memory per SM           228 KiB (233,472 B)
registers                      65,536 per SM, 255 per thread
local memory                   512 KiB per thread
threads per block              1,024
grid                           x up to 2^31 - 1, y and z up to 65,535
SMs                            132 (H100 SXM)
=============================  ===========================================

``chip_smoke.py`` holds the row against ``torch.cuda.get_device_properties``
on the card.

Environment overrides (operators raising/lowering the gate without a code
change), the reference's names::

    REPRO_LIMIT_SMEM_BYTES      R9's budget of a block's shared memory,
                                static plus dynamic (default: the
                                opt-in; R4 holds the card's opt-in)
    REPRO_LIMIT_LIVE_BYTES      peak device bytes of a plan's canonical
                                run (unset = report-only, no gate)

This module imports nothing of the port.
"""
from __future__ import annotations

import os
from dataclasses import asdict, dataclass, replace

__all__ = ["KernelLimits", "card_limits", "live_budget_bytes"]

_KIB = 1024


@dataclass(frozen=True)
class KernelLimits:
    """One card's launch and memory limits; bytes, threads, blocks."""

    platform: str
    smem_bytes: int            # the budget of a block's static + dynamic
    smem_optin_bytes: int      # the card's most for a block, opted in
    smem_default_bytes: int    # a block's without the opt-in
    smem_sm_bytes: int
    regs_sm: int
    regs_thread: int
    local_thread_bytes: int
    threads_block: int
    grid_x: int
    grid_yz: int
    sms: int

    def to_dict(self) -> dict:
        return asdict(self)


_TABLE: dict[str, KernelLimits] = {
    "h100": KernelLimits("h100", smem_bytes=232_448,
                         smem_optin_bytes=232_448,
                         smem_default_bytes=48 * _KIB,
                         smem_sm_bytes=228 * _KIB, regs_sm=65_536,
                         regs_thread=255, local_thread_bytes=512 * _KIB,
                         threads_block=1024, grid_x=2**31 - 1,
                         grid_yz=65_535, sms=132),
}


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def card_limits() -> KernelLimits:
    """The limits row of the card every kernel of the port is built for,
    the H100 (also for a launch record of the CPU's plain versions), with
    ``REPRO_LIMIT_SMEM_BYTES`` applied."""
    base = _TABLE["h100"]
    smem = _env_int("REPRO_LIMIT_SMEM_BYTES")
    return base if smem is None else replace(base, smem_bytes=smem)


def live_budget_bytes() -> int | None:
    """The budget of a canonical run's peak device bytes, or None when the
    gate is report-only (the default: peaks scale with the caller's data,
    so a hard default would fail legitimate fits)."""
    return _env_int("REPRO_LIMIT_LIVE_BYTES")
