"""Carry the JAX package's state across into the port's objects.

DPC has no weights: its state is the point table, the execution spec and
the intermediate results.  These functions take that state as numpy arrays
and plain dicts — what ``np.asarray`` and ``dataclasses.asdict`` give for
the reference's objects — and build the port's counterparts, so one
stage's reference output can feed the port's next stage.  Backend names map
``pallas``/``pallas-interpret`` -> ``cuda``; ``jnp`` is refused until the
port has a reference backend.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.dpc_types import DPCResult
from .core.grid import Grid
from .engine.spec import ExecSpec

__all__ = ["dpc_result", "grid", "exec_spec"]

_BACKENDS = {None: None, "auto": None, "pallas": "cuda",
             "pallas-interpret": "cuda", "cuda": "cuda"}

_GRID_ARRAYS = ("points", "order", "inv_order", "cand_key", "group_key",
                "cand_coords", "cand_extent", "cand_strides", "cell_keys",
                "cell_start", "cell_count", "point_cell")
_GRID_STATIC = ("num_cells", "span_cap", "cell_cap", "g", "d", "d_cut")


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def dpc_result(arrays: Mapping, device="cpu") -> DPCResult:
    """A ``DPCResult`` from its four arrays (rho, rho_key, delta, parent)."""
    f32 = torch.float32
    return DPCResult(rho=_tensor(arrays["rho"], f32, device),
                     rho_key=_tensor(arrays["rho_key"], f32, device),
                     delta=_tensor(arrays["delta"], f32, device),
                     parent=_tensor(arrays["parent"], torch.int32, device))


def grid(arrays: Mapping, static: Mapping, device="cpu") -> Grid:
    """A ``Grid`` from its array fields and its static fields."""
    fields = {}
    for name in _GRID_ARRAYS:
        a = np.asarray(arrays[name])
        dtype = torch.float32 if a.dtype.kind == "f" else (
            torch.int32 if name in ("cand_coords", "cell_start", "cell_count",
                                    "point_cell") else torch.int64)
        fields[name] = _tensor(a, dtype, device)
    for name in _GRID_STATIC:
        fields[name] = float(static[name]) if name == "d_cut" \
            else int(static[name])
    return Grid(**fields)


def exec_spec(fields: Mapping) -> ExecSpec:
    """An ``ExecSpec`` from the reference spec's fields."""
    backend = fields.get("backend")
    if backend == "jnp":
        raise NotImplementedError(
            "backend 'jnp' has no counterpart yet: the port's direct-"
            "difference reference backend comes with ROADMAP Queue A item 1")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown reference backend {backend!r}")
    return ExecSpec(backend=_BACKENDS[backend], layout=fields.get("layout"),
                    precision=fields.get("precision"),
                    block=fields.get("block"),
                    data_axis=fields.get("data_axis", "data"))
