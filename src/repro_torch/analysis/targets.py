"""Targets: the canonical calls the analyzer runs and records, the port of
``repro/analysis/targets.py``.

Two consumers share them:

* **plan time** — ``repro_torch.engine.planner.plan`` calls
  :func:`analyze_plan` on every fresh plan (memoized per spec): the plan's
  two driver-facing primitives run on a small canonical input on the
  plan's device under a launch recorder (:mod:`.record`), every launch
  rule checks the record, and every plan rule checks the plan, so an
  ExecSpec that would dispatch into a flagged kernel path fails at
  ``plan()`` — before any data is touched.
* **the CLI sweep** (``python -m repro_torch.analysis``) — every valid
  ExecSpec x every subsystem entry point: the batch primitives (as at
  plan time), the distributed driver's halo and gather strategies on four
  logical shards (its dense or stencil dispatch as the plan selects), the
  sharded stream's stages and the DPC-KV compression of one head.

Eager PyTorch has no tracer: a target *runs* (a few milliseconds on 96
points) and its record stands in for the reference's jaxpr.  The run is
neutral (:func:`neutral`): it leaves ``ops.launch_counts()``, the worklist
counters and every plan's worklist cache as they were, fires no
fault-injection site and records no span.  A plan's targets run once
(:func:`canonical_run`, kept on the plan): the gate's launch rules, R7's
float spelling, R9's peak bytes and ``telemetry()``'s memory block all
read that one run.  A target that raises is an error finding: on the card
it is a kernel that will not launch.

The device is the plan's: the card wherever one exists, as the backend
probe takes it (``resilience/degrade.py``); on a host without one, the CPU,
where a ``cuda`` plan runs its kernels' plain versions under the same
launch names.

Targets that a plan cannot express return a skip *reason* (DPC-KV rejects
block-sparse kernel layouts and bf16 at construction) rather than a
finding: an impossible combination is the validation table working, not
a defect — R5 checks that table separately.
"""
from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

from . import record
from .rules import Finding, analyze_launches

# Canonical input: small (it runs on every plan() miss), 2-D (the paper's
# regime), the reference's points bit for bit: a fixed low-discrepancy
# lattice, no RNG, identical across processes.
N_POINTS = 96
DIM = 2
D_CUT = 0.35
SHARDS = 4


def canonical_points() -> np.ndarray:
    i = np.arange(N_POINTS, dtype=np.float32)
    pts = np.stack([(i * 0.6180339887) % 1.0, (i * 0.7548776662) % 1.0], 1)
    return np.ascontiguousarray(pts[:, :DIM], dtype=np.float32)


# the device an enclosing on_device() pins, innermost last
_DEVICE: list = []


def gate_device() -> torch.device:
    """The device the targets run on: the one ``on_device`` pins, else
    the card wherever one exists, else the CPU."""
    if _DEVICE:
        return _DEVICE[-1]
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@contextlib.contextmanager
def on_device(device: Any = None) -> Iterator[torch.device]:
    """Pin the targets' device for the block (None: ``gate_device()``'s
    own choice)."""
    dev = gate_device() if device is None else torch.device(device)
    _DEVICE.append(dev)
    try:
        yield dev
    finally:
        _DEVICE.pop()


def failure(target: str, exc: Exception) -> Finding:
    """A target that raised: an error, on the card as on the CPU."""
    return Finding(rule="trace", severity="error", target=target,
                   message=f"could not run: {type(exc).__name__}: {exc}",
                   where="<run>")


@contextlib.contextmanager
def neutral(pl: Any = None) -> Iterator[None]:
    """The canonical run's scope: no fault site fires or spends its hits,
    the worklist metrics and the launch counts are restored on exit, no
    span is recorded, and ``pl``'s wrappers build into a throwaway
    worklist cache."""
    from repro_torch.kernels import blocksparse, ops
    from repro_torch.obs import tracer
    from repro_torch.resilience import faultinject

    with contextlib.ExitStack() as stack:
        stack.enter_context(faultinject.suspended())
        stack.enter_context(blocksparse.suspend_counters())
        stack.enter_context(ops.suspend_launch_counts())
        stack.enter_context(tracer.suspended())
        if pl is not None:
            stack.enter_context(pl.scratch_worklists())
        yield


def run_target(thunk: Any) -> tuple[list, Any]:
    """Run one target under a recorder: (its events, its result), the
    device work finished."""
    with record.recording() as events:
        out = thunk()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return events, out


def count_syncs(thunk: Any) -> tuple[Any, int]:
    """Run ``thunk`` under ``torch.cuda.set_sync_debug_mode("warn")``:
    (its result, the host syncs it made)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = thunk()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def label_of(pl: Any) -> str:
    return f"plan[{pl.backend_name}:{pl.layout}:{pl.precision}]"


# --------------------------------------------------------- batch (plan time)
def plan_targets(pl: Any, device: Any = None) -> list:
    """``(name, thunk)`` pairs calling the plan's driver-facing primitives
    as a driver does, on the canonical points on ``device`` (default: the
    gate's): ``rho_delta`` (the fused sweep, its resolve and the
    unresolved tail) and ``denser_nn``."""
    dev = gate_device() if device is None else torch.device(device)
    x = torch.from_numpy(canonical_points()).to(dev)
    rk = torch.arange(N_POINTS, dtype=torch.float32, device=dev)
    return [("rho_delta", lambda: pl.rho_delta(x, x, D_CUT)),
            ("denser_nn", lambda: pl.denser_nn(x, rk, x, rk))]


@dataclass
class CanonicalRun:
    """One neutral run of a plan's :func:`plan_targets` on the gate's
    device: per target that ran, its launch record and result (and, on
    the card, its host syncs); a target that raised, as an error finding;
    the run's peak device bytes above what was allocated before it (None
    on the CPU, ``peak_how`` saying why)."""

    device: torch.device
    names: list = field(default_factory=list)
    events: dict = field(default_factory=dict)
    outputs: dict = field(default_factory=dict)
    syncs: dict | None = None
    failures: list = field(default_factory=list)
    peak_bytes: int | None = None
    peak_how: str = ""


def canonical_run(pl: Any) -> CanonicalRun:
    """The plan's canonical run on the gate's device, made on first use
    and kept on the plan.  On the card the peak statistic is reset for it
    once, through ``obs.tracer.reset_peak_memory`` (an open span keeps the
    peak it had reached)."""
    from repro_torch.obs import tracer

    dev = gate_device()
    run = pl._canonical
    if run is not None and run.device.type == dev.type:
        return run
    card = dev.type == "cuda"
    run = CanonicalRun(device=dev, syncs={} if card else None)
    label = label_of(pl)
    with neutral(pl):
        if card:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            tracer.reset_peak_memory(dev)
        for name, thunk in plan_targets(pl, dev):
            run.names.append(name)
            try:
                if card:
                    (events, out), run.syncs[name] = count_syncs(
                        lambda t=thunk: run_target(t))
                else:
                    events, out = run_target(thunk)
            except Exception as exc:      # noqa: BLE001 — an error finding
                run.failures.append(failure(f"{label}:{name}", exc))
                continue
            run.events[name], run.outputs[name] = events, out
        if card:
            run.peak_bytes = int(torch.cuda.max_memory_allocated(dev)
                                 - base)
            run.peak_how = "max_memory_allocated delta over the canonical run"
        else:
            run.peak_how = ("no CUDA device: device memory is measured on "
                            "the card only")
    pl._canonical = run
    return run


def analyze_plan(pl: Any) -> list:
    """Every launch rule over the records of the plan's canonical run
    (:func:`canonical_run`), its failed targets, then every plan rule over
    the plan itself."""
    from .rules import plan_rules

    label = label_of(pl)
    run = canonical_run(pl)
    findings: list[Finding] = list(run.failures)
    for name, events in run.events.items():
        findings.extend(analyze_launches(f"{label}:{name}", events))
    for rule in plan_rules():
        findings.extend(rule.check_plan(pl))
    return findings


# ------------------------------------------------------- sweep-only targets
def _mesh(device: Any):
    from repro_torch.launch.mesh import ShardMesh

    return ShardMesh.on(gate_device() if device is None else device,
                        shards=SHARDS)


def distributed_targets(pl: Any, device: Any = None) -> tuple[list, list]:
    """The distributed driver's two strategies on four logical shards of
    the device: ``halo`` (the ppermute window, K10/K11 or K15/K16, the
    fallback) and ``gather`` (the engine tiles, K4/K2 or K8/K9 on a
    block-sparse plan; on a backend that is not ``mxu_dense`` in the dense
    layout, the stencil phases and the fallback) — ``distributed_dpc``'s
    own dispatch, so the records show the phases that would run.  Returns
    (targets, skip reasons)."""
    from repro_torch.distributed.dpc import distributed_dpc

    mesh = _mesh(device)
    x = torch.from_numpy(canonical_points()).to(mesh.devices[0])
    stencil = not pl.backend.mxu_dense and not pl.grid_sort
    gather = "gather:stencil" if stencil else "gather:engine"
    return [(f"distributed:{name}",
             lambda s=strategy: distributed_dpc(x, mesh=mesh, d_cut=D_CUT,
                                                exec_spec=pl.spec,
                                                strategy=s))
            for name, strategy in (("halo", "halo"),
                                   (gather, "gather"))], []


def stream_targets(pl: Any, device: Any = None) -> tuple[list, list]:
    """Every sharded stage of the stream's repair tail on four logical
    shards: the rho repair (K5 and K4 per shard, the psum), the maxima's
    NN re-query at the plan's shard layout (K2, or K9 on the ring, the
    pmin merge), label propagation (the all-gathered pointer jumps) and
    the center distances.  Inputs are made before the recorder starts."""
    from repro_torch.core.dpc_types import DPCResult
    from repro_torch.distributed.dpc import shard_blocksparse_layout
    from repro_torch.stream.incremental import make_sharded_repair
    from repro_torch.stream.sharded import (make_sharded_center_dists,
                                            make_sharded_labels,
                                            make_sharded_nn_update)

    mesh = _mesh(device)
    dev = mesh.devices[0]
    be = pl.backend
    pts = canonical_points()
    window = torch.from_numpy(pts).to(dev)
    rho = torch.zeros((N_POINTS,), dtype=torch.float32, device=dev)
    batch = window[:8].contiguous()
    signs = torch.tensor([1.0, -1.0] * 4, device=dev)
    ins = window[8:12].contiguous()
    slots = torch.arange(8, 12, device=dev)
    rho_key = torch.arange(N_POINTS, dtype=torch.float32, device=dev)
    q_slots = torch.tensor([0, 17, 95, N_POINTS], device=dev)
    parent = torch.arange(-1, N_POINTS - 1, dtype=torch.int32, device=dev)
    res = DPCResult(rho=rho_key, rho_key=rho_key,
                    delta=torch.ones((N_POINTS,), device=dev), parent=parent)
    repair = make_sharded_repair(mesh, pl.data_axis, be, D_CUT)
    layout = shard_blocksparse_layout(pl, mesh)
    nn = make_sharded_nn_update(mesh, pl.data_axis, be, layout=layout)
    labels = make_sharded_labels(mesh, pl.data_axis, N_POINTS)
    cdist = make_sharded_center_dists(mesh, pl.data_axis)
    return [
        ("stream:sharded_repair",
         lambda: repair(window, rho, batch, signs, ins, slots)),
        (f"stream:sharded_nn[{layout or 'dense'}]",
         lambda: nn(window, rho_key, q_slots)),
        ("stream:sharded_labels", lambda: labels(res, 1.0, 0.5)),
        ("stream:sharded_center_dists",
         lambda: cdist(pts[:5], pts[40:43])),
    ], []


def serve_targets(spec: Any, device: Any = None) -> tuple[list, list]:
    """DPC-KV's compression of one head (32 cached keys of 8 dims, a
    budget of 8) for a spec."""
    from repro_torch.serve.dpc_kv import DPCKVConfig, compress_kv

    try:
        cfg = DPCKVConfig(budget=8, exec_spec=spec)
    except ValueError as exc:
        return [], [f"serve: spec {spec.describe()} rejected at config "
                    f"time ({exc})"]
    dev = gate_device() if device is None else torch.device(device)
    g = torch.Generator().manual_seed(0)
    k = torch.randn((1, 32, 1, 8), generator=g).to(dev)
    v = torch.randn((1, 32, 1, 8), generator=g).to(dev)
    return [("serve:compress_head", lambda: compress_kv(k, v, 32, cfg))], []


# -------------------------------------------------------------- sweep specs
def sweep_specs() -> list:
    """Every ExecSpec the sweep analyzes: the default spec plus the
    explicit backend x layout x precision product, minus the specs the
    spec / plan validation rejects (R5 checks that table separately)."""
    from repro_torch.engine.spec import LAYOUTS, PRECISIONS, ExecSpec
    from repro_torch.kernels.backend import available_backends, get_backend

    specs = [ExecSpec()]
    for backend in available_backends():
        for layout in (None, *LAYOUTS):
            for precision in (None, *PRECISIONS):
                try:
                    spec = ExecSpec(backend=backend, layout=layout,
                                    precision=precision)
                except ValueError:
                    continue
                if spec.resolved_precision == "bf16" \
                        and not get_backend(backend).mxu_dense:
                    continue
                specs.append(spec)
    return specs
