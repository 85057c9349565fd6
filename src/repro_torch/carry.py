"""Carry the JAX package's state across into the port's objects.

DPC has no weights: its state is the point table, the execution spec, the
distributed configuration, the block-sparse worklists, the intermediate
results and a live stream; the serving path adds a language model's
weights and its cache (a KV cache, or the ssm and hybrid families' dict
of recurrent state).  These
functions take that state as numpy arrays and plain dicts — what
``np.asarray`` and ``dataclasses.asdict`` give for the reference's objects
— and build the port's counterparts, so one stage's reference output can
feed the port's next stage.  Backend names map
``pallas``/``pallas-interpret`` -> ``cuda`` and ``jnp`` -> ``torch``, the
direct-difference reference backend.  ``stream_state`` reads a reference
``StreamDPC`` by its attributes, through ``np.asarray``, and imports
nothing of the reference.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.dpc_types import DPCResult
from .core.grid import Grid
from .core.labels import Clustering
from .distributed.dpc import DistDPCConfig
from .engine.spec import ExecSpec
from .kernels.blocksparse import Worklist
from .models import moe, rglru, ssm
from .models.attention import KVCache
from .models.common import ArchConfig, StackedParams
from .models.transformer import TransformerParams
from .stream.incremental import IncrementalGrid
from .stream.stream_dpc import StreamDPC, StreamDPCConfig, StreamTick
from .stream.window import SlidingWindow

__all__ = ["dpc_result", "grid", "exec_spec", "dist_config",
           "flat_worklist", "stream_state", "model_params", "kv_cache",
           "model_cache"]

_BACKENDS = {None: None, "auto": None, "pallas": "cuda",
             "pallas-interpret": "cuda", "cuda": "cuda", "jnp": "torch",
             "torch": "torch"}

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
    if backend not in _BACKENDS:
        raise ValueError(f"unknown reference backend {backend!r}")
    return ExecSpec(backend=_BACKENDS[backend], layout=fields.get("layout"),
                    precision=fields.get("precision"),
                    block=fields.get("block"),
                    data_axis=fields.get("data_axis", "data"))


def dist_config(fields: Mapping) -> DistDPCConfig:
    """A ``DistDPCConfig`` from the reference config's fields
    (``dataclasses.asdict``): ``exec_spec`` as a mapping of the spec's
    fields, or, where it is None, the legacy ``backend`` / ``layout`` /
    ``block`` / ``data_axis`` fields folded into one spec."""
    spec = fields.get("exec_spec")
    if spec is None:
        spec = {k: fields.get(k) for k in ("backend", "layout", "block")}
        spec["data_axis"] = fields.get("data_axis") or "data"
    return DistDPCConfig(d_cut=float(fields["d_cut"]),
                         fallback_cap_factor=float(
                             fields.get("fallback_cap_factor", 0.05)),
                         strategy=fields.get("strategy", "gather"),
                         exec_spec=exec_spec(spec))


def flat_worklist(meta, lb, n_kept: int, n_total: int, *,
                  device="cpu") -> Worklist:
    """A ``Worklist`` from the reference's ``FlatWorklist``: ``meta`` (4, W)
    rows (row tile, column tile, first visit, in_cut), sorted by row tile,
    and ``lb`` (W,): any of its forms, the fused count + kept-k worklist
    (K3), the count-only one (K8) or the best-1 ring (K9).  It must have
    been built at the port's tile shape (``blocksparse.BLOCK_N`` x
    ``BLOCK_M``, 256 x 512)."""
    meta = np.asarray(meta)
    wi = meta[0].astype(np.int64)
    if wi.size and np.any(np.diff(wi) < 0):
        raise ValueError("worklist entries must be sorted by row tile")
    nbr = int(wi.max()) + 1 if wi.size else 0
    row_ptr = np.zeros(nbr + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(wi, minlength=nbr))
    return Worklist(row_ptr=_tensor(row_ptr, torch.int32, device),
                    col_tile=_tensor(meta[1], torch.int32, device),
                    in_cut=_tensor(meta[3] != 0, torch.bool, device),
                    lb=_tensor(lb, torch.float32, device),
                    n_kept=int(n_kept), n_total=int(n_total))


_STREAM_CFG = ("d_cut", "capacity", "batch_cap", "rho_min", "delta_min",
               "cell_slack", "extent_margin", "continuity_radius",
               "dirty_tracking", "transactional")
_GRID_HOST = ("box_lo", "box_extent", "strides", "cell_count", "seg_np")
_GRID_SCALARS = ("live_cells", "next_id", "maxima_cap", "rebuilds")


def stream_state(ref_stream, *, exec_spec: ExecSpec | None = None,
                 device=None):
    """A port ``StreamDPC`` that continues a live reference ``StreamDPC``.

    Carries the configuration (its layout; the backend is the port's own,
    or ``exec_spec``), the window (host mirror, device table, count,
    cursor, ticks), the grid bookkeeping, rho, the raw NN caches, the
    center registry, ``next_stable``, the counters and the last tick's
    result, clustering and ``StreamTick``, so both packages ingest the
    next batch from one state.  Like every entry point of the port it
    targets the card unless given ``device="cpu"``, and raises where no
    GPU exists.
    """
    rc = ref_stream.cfg
    if exec_spec is None:
        exec_spec = ExecSpec(layout=rc.resolved_exec().layout)
    cfg = StreamDPCConfig(**{k: getattr(rc, k) for k in _STREAM_CFG},
                          exec_spec=exec_spec)
    s = StreamDPC(cfg, device=device)
    rw = ref_stream.window
    if rw is None:
        return s
    f32, i32 = torch.float32, torch.int32
    w = SlidingWindow(rw.capacity, rw.dim, s.device)
    w.host = np.array(rw.host, np.float32)
    w.device = _tensor(rw.device, f32, s.device)
    w.count, w.cursor, w.ticks = int(rw.count), int(rw.cursor), int(rw.ticks)
    s.window = w
    rg = ref_stream.grid
    g = IncrementalGrid(rg.d_cut, rg.capacity, rg.dim,
                        cell_slack=rg.cell_slack,
                        extent_margin=rg.extent_margin, device=s.device)
    g.rebuilds = int(rg.rebuilds)
    g._built = bool(rg._built)
    if g._built:
        for name in _GRID_HOST:
            setattr(g, name, np.array(getattr(rg, name)))
        for name in _GRID_SCALARS:
            setattr(g, name, int(getattr(rg, name)))
        g.key_to_id = {int(k): int(v) for k, v in rg.key_to_id.items()}
        g.free_ids = [int(i) for i in rg.free_ids]
        g.seg_dev = _tensor(rg.seg_dev, i32, s.device)
    g.last_touched = (None if rg.last_touched is None
                      else np.array(rg.last_touched, np.int64))
    s.grid = g
    s._rho = None if ref_stream._rho is None \
        else _tensor(ref_stream._rho, f32, s.device)
    s._nn_delta_cache = np.array(ref_stream._nn_delta_cache, np.float32)
    s._nn_parent_cache = np.array(ref_stream._nn_parent_cache, np.int32)
    s._nn_valid = np.array(ref_stream._nn_valid, bool)
    s._registry = [(int(i), np.array(p, np.float32))
                   for i, p in ref_stream._registry]
    s._next_stable = int(ref_stream._next_stable)
    s._ticks = int(ref_stream._ticks)
    s._full_recomputes = int(ref_stream._full_recomputes)
    s._nn_maxima_total = int(ref_stream._nn_maxima_total)
    s._nn_queries = int(ref_stream._nn_queries)
    if ref_stream._result is not None:
        s._result = dpc_result(ref_stream._result._asdict(), s.device)
        rcl = ref_stream._clustering
        s._clustering = Clustering(
            labels=_tensor(rcl.labels, i32, s.device),
            centers=_tensor(rcl.centers, torch.bool, s.device),
            num_clusters=_tensor(rcl.num_clusters, i32, s.device))
    last = ref_stream._last
    if last is not None:
        s._last = StreamTick(
            labels=np.array(last.labels), centers=np.array(last.centers),
            stable_ids=np.array(last.stable_ids),
            num_clusters=int(last.num_clusters), rebuilt=bool(last.rebuilt),
            full_recompute=bool(last.full_recompute), tick=int(last.tick))
    return s


def _weights(a, device) -> torch.Tensor:
    """A numpy array as a tensor of its own dtype; bf16 (ml_dtypes'
    ``bfloat16``, what ``np.asarray`` gives for a jax bf16 array) through
    its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


_PARAMS = {"dense": TransformerParams, "vlm": TransformerParams,
           "encoder": TransformerParams, "moe": moe.MoEParams,
           "ssm": ssm.SSMParams, "hybrid": rglru.RGLRUParams}


def _flat(tree: Mapping, prefix: str = ""):
    """(dotted path, leaf) of a nested dict's leaves."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def model_params(cfg: ArchConfig, params: Mapping,
                 device="cpu") -> StackedParams:
    """A model's weights from the reference's param pytree (nested dicts
    of numpy arrays: ``layers`` stacked on axis 0, the hybrid's
    ``supers``/``tail`` stacks), in the same shapes and dtypes, as the
    params module of ``cfg.family``."""
    return _PARAMS[cfg.family](cfg, {name: _weights(a, device)
                                     for name, a in _flat(params)})


def kv_cache(cache, device="cpu") -> KVCache:
    """The port's ``KVCache`` from the reference's (its ``k`` and ``v``
    as numpy arrays)."""
    return KVCache(k=_weights(cache.k, device), v=_weights(cache.v, device))


def model_cache(cache, device="cpu"):
    """Any family's cache from the reference's: the ssm and hybrid
    families' dict of arrays as a dict of tensors, a ``KVCache`` through
    ``kv_cache``."""
    if isinstance(cache, Mapping):
        return {k: _weights(a, device) for k, a in cache.items()}
    return kv_cache(cache, device)
