"""Versioned, atomic checkpoints of the complete StreamDPC state: the port
of ``repro/resilience/checkpoint.py``, in the same file format.

A checkpoint is one ``.npz`` file, ``repro.stream-ckpt`` version 1: a JSON
metadata blob (format tag, version, ExecSpec fingerprint, config, scalar
counters) and every array the incremental tick reads — the window in slot
order, the grid bookkeeping with its measured capacities and free list,
the repaired rho, the cached maxima NN answers and their validity mask,
the stable-center registry and the last tick.  The array names and meta
keys are the reference's, so a file written by either package restores in
the other.  A restored stream's next ticks equal the uninterrupted run's
bit for bit, onto a different shard count too: the arrays do not depend on
the mesh, and the sharded stages equal the single-device ones.

Writes are atomic: the file is written to ``<path>.tmp.<pid>``, fsynced,
then moved over ``path`` with ``os.replace``; a crash in between (the
``checkpoint.write`` fault site) leaves the previous checkpoint intact.
Readers check the format tag and version and raise
:class:`CheckpointError` on anything unreadable, truncated or of another
version, never returning a half-restored stream.

Restore checks the fingerprint as the reference does, on the file's own
``exec`` fields, then maps the backend name as ``carry.exec_spec`` does
(``pallas`` / ``pallas-interpret`` / ``auto`` -> ``cuda``).  A file saved
with the reference's ``jnp`` backend is refused until the port has a
direct-difference reference backend (ROADMAP Queue A item 1).
"""
from __future__ import annotations

import json
import os
from dataclasses import fields

import numpy as np
import torch

from repro_torch.resilience import faultinject

__all__ = ["CheckpointError", "FORMAT", "VERSION", "restore_stream",
           "save_stream"]

FORMAT = "repro.stream-ckpt"
VERSION = 1

class CheckpointError(RuntimeError):
    """The file is not a readable checkpoint of the current version."""


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_stream(stream, path: str) -> None:
    """Write ``stream`` (a :class:`repro_torch.stream.StreamDPC`) to
    ``path`` atomically.  Raises ValueError on a stream that has never seen
    data."""
    faultinject.fire("checkpoint.serialize")
    w = stream.window
    if w is None:
        raise ValueError("cannot checkpoint a StreamDPC before its first "
                         "initialize()/ingest() — there is no window state")
    g = stream.grid
    spec = stream.cfg.resolved_exec()
    meta = {
        "format": FORMAT,
        "version": VERSION,
        "fingerprint": spec.describe(),
        "exec": {"backend": spec.backend, "layout": spec.layout,
                 "precision": spec.precision, "block": spec.block,
                 "data_axis": spec.data_axis},
        # every config field but the spec, which "exec" carries
        "cfg": {f.name: getattr(stream.cfg, f.name)
                for f in fields(stream.cfg) if f.name != "exec_spec"},
        "dim": w.dim,
        "window": {"count": w.count, "cursor": w.cursor, "ticks": w.ticks},
        "counters": {"ticks": stream._ticks,
                     "full_recomputes": stream._full_recomputes,
                     "next_stable": stream._next_stable,
                     "nn_maxima_total": stream._nn_maxima_total,
                     "nn_queries": stream._nn_queries},
        "grid": {"built": g._built, "rebuilds": g.rebuilds},
        "has_rho": stream._rho is not None,
        "has_result": stream._result is not None,
        "has_last": stream._last is not None,
        "registry_ids": [int(s) for s, _ in stream._registry],
    }
    arrays: dict[str, np.ndarray] = {"win_host": w.host}
    if stream._rho is not None:
        arrays["rho"] = _np(stream._rho)
    arrays["nn_delta"] = stream._nn_delta_cache
    arrays["nn_parent"] = stream._nn_parent_cache
    arrays["nn_valid"] = stream._nn_valid
    if g._built:
        meta["grid"].update({
            "live_cells": int(g.live_cells), "next_id": int(g.next_id),
            "maxima_cap": int(g.maxima_cap),
            "free_ids": [int(i) for i in g.free_ids],
            "has_touched": g.last_touched is not None})
        arrays["grid_box_lo"] = np.asarray(g.box_lo)
        arrays["grid_box_extent"] = np.asarray(g.box_extent)
        arrays["grid_strides"] = np.asarray(g.strides)
        arrays["grid_cell_count"] = g.cell_count
        arrays["grid_seg"] = g.seg_np
        arrays["grid_keys"] = np.fromiter(g.key_to_id.keys(), np.int64,
                                          len(g.key_to_id))
        arrays["grid_ids"] = np.fromiter(g.key_to_id.values(), np.int32,
                                         len(g.key_to_id))
        if g.last_touched is not None:
            arrays["grid_touched"] = g.last_touched
    if stream._registry:
        arrays["reg_pos"] = np.stack([p for _, p in stream._registry])
    if stream._result is not None:
        r = stream._result
        arrays["res_rho"] = _np(r.rho)
        arrays["res_rho_key"] = _np(r.rho_key)
        arrays["res_delta"] = _np(r.delta)
        arrays["res_parent"] = _np(r.parent)
        cl = stream._clustering
        arrays["cl_labels"] = _np(cl.labels)
        arrays["cl_centers"] = _np(cl.centers)
        meta["num_clusters"] = int(cl.num_clusters)
    if stream._last is not None:
        t = stream._last
        meta["last"] = {"num_clusters": int(t.num_clusters),
                        "rebuilt": bool(t.rebuilt),
                        "full_recompute": bool(t.full_recompute),
                        "tick": int(t.tick)}
        arrays["last_labels"] = np.asarray(t.labels)
        arrays["last_centers"] = np.asarray(t.centers)
        arrays["last_stable"] = np.asarray(t.stable_ids)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    faultinject.fire("checkpoint.write")    # kill/raise: old file survives
    if faultinject.should_corrupt("checkpoint.write"):
        with open(tmp, "r+b") as fh:
            fh.truncate(max(os.path.getsize(tmp) // 2, 8))
    os.replace(tmp, path)


def _meta_of(z) -> dict:
    try:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
    except Exception as exc:
        raise CheckpointError(f"checkpoint metadata unreadable: {exc}") \
            from exc
    if meta.get("format") != FORMAT:
        raise CheckpointError(
            f"not a {FORMAT} file (format={meta.get('format')!r})")
    if meta.get("version") != VERSION:
        raise CheckpointError(
            f"checkpoint version {meta.get('version')!r} != supported "
            f"{VERSION}; restore accepts exactly the current version")
    return meta


def _exec_spec(meta: dict):
    """The port's ExecSpec for the file's ``exec`` fields, after the
    fingerprint check."""
    from repro_torch.carry import exec_spec

    ex = meta["exec"]
    described = (f"{ex.get('backend') or 'auto'}:"
                 f"{ex.get('layout') or 'dense'}:"
                 f"{ex.get('precision') or 'f32'}")
    if described != meta["fingerprint"]:
        raise CheckpointError(
            f"ExecSpec fingerprint mismatch: file says "
            f"{meta['fingerprint']!r}, rebuilt {described!r}")
    try:
        return exec_spec(ex)
    except NotImplementedError as exc:
        raise CheckpointError(
            f"the checkpoint was saved with backend {ex.get('backend')!r}, "
            f"which has no counterpart in the port until its direct-"
            f"difference reference backend (ROADMAP Queue A item 1)") \
            from exc
    except ValueError as exc:
        raise CheckpointError(f"checkpoint exec fields {ex}: {exc}") from exc


def restore_stream(path: str, mesh=None, device=None):
    """Rebuild a :class:`repro_torch.stream.StreamDPC` from ``path``, onto
    ``mesh`` (any shard count that divides the capacity) or, with
    ``mesh=None``, one device."""
    from repro_torch.stream.stream_dpc import StreamDPC, StreamDPCConfig

    try:
        z = np.load(path, allow_pickle=False)
    except Exception as exc:
        raise CheckpointError(f"cannot read checkpoint {path!r}: {exc}") \
            from exc
    with z:
        try:
            meta = _meta_of(z)
            cfg = StreamDPCConfig(exec_spec=_exec_spec(meta), **meta["cfg"])
        except CheckpointError:
            raise
        except Exception as exc:
            raise CheckpointError(
                f"checkpoint {path!r} has a missing or malformed field: "
                f"{exc!r}") from exc
        # a mesh that does not fit the stream raises as StreamDPC does
        s = StreamDPC(cfg, mesh=mesh, device=device)
        try:
            _load(s, z, meta)
        except Exception as exc:
            raise CheckpointError(
                f"checkpoint {path!r} has a missing or unreadable array: "
                f"{exc!r}") from exc
    return s


def _load(s, z, meta: dict) -> None:
    """Fill the fresh stream ``s`` from the file's arrays and meta."""
    from repro_torch.core.dpc_types import DPCResult
    from repro_torch.core.labels import Clustering
    from repro_torch.stream.stream_dpc import StreamTick

    dev = s.device

    def tensor(name, dtype):
        return torch.from_numpy(np.array(z[name])).to(dev, dtype)

    s._ensure_window(int(meta["dim"]))
    w = s.window
    w.host[:] = z["win_host"]
    w.device = torch.from_numpy(w.host.copy()).to(dev)
    wm = meta["window"]
    w.count, w.cursor, w.ticks = wm["count"], wm["cursor"], wm["ticks"]
    gm = meta["grid"]
    g = s.grid
    g.rebuilds = gm["rebuilds"]
    if gm["built"]:
        g.box_lo = z["grid_box_lo"]
        g.box_extent = z["grid_box_extent"]
        g.strides = z["grid_strides"]
        g.cell_count = z["grid_cell_count"].copy()
        g.seg_np = z["grid_seg"].astype(np.int32)
        g.seg_dev = torch.from_numpy(g.seg_np.copy()).to(dev)
        g.key_to_id = {int(k): int(i) for k, i in
                       zip(z["grid_keys"], z["grid_ids"])}
        g.live_cells = gm["live_cells"]
        g.next_id = gm["next_id"]
        g.maxima_cap = gm["maxima_cap"]
        g.free_ids = list(gm["free_ids"])
        g._built = True
        g.last_touched = (z["grid_touched"].astype(np.int64)
                          if gm["has_touched"] else None)
    if meta["has_rho"]:
        s._rho = tensor("rho", torch.float32)
    s._nn_delta_cache[:] = z["nn_delta"]
    s._nn_parent_cache[:] = z["nn_parent"]
    s._nn_valid[:] = z["nn_valid"]
    c = meta["counters"]
    s._ticks = c["ticks"]
    s._full_recomputes = c["full_recomputes"]
    s._next_stable = c["next_stable"]
    s._nn_maxima_total = c["nn_maxima_total"]
    s._nn_queries = c["nn_queries"]
    ids = meta["registry_ids"]
    if ids:
        pos = z["reg_pos"]
        s._registry = [(int(i), pos[j].astype(np.float32))
                       for j, i in enumerate(ids)]
    if meta["has_result"]:
        s._result = DPCResult(
            rho=tensor("res_rho", torch.float32),
            rho_key=tensor("res_rho_key", torch.float32),
            delta=tensor("res_delta", torch.float32),
            parent=tensor("res_parent", torch.int32))
        s._clustering = Clustering(
            labels=tensor("cl_labels", torch.int32),
            centers=tensor("cl_centers", torch.bool),
            num_clusters=torch.tensor(meta["num_clusters"],
                                      dtype=torch.int32, device=dev))
    if meta["has_last"]:
        lm = meta["last"]
        s._last = StreamTick(
            labels=z["last_labels"].copy(), centers=z["last_centers"].copy(),
            stable_ids=z["last_stable"].copy(),
            num_clusters=lm["num_clusters"], rebuilt=lm["rebuilt"],
            full_recompute=lm["full_recompute"], tick=lm["tick"])
