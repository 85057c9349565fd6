"""Dry run of the model cells on fake tensors: the port of
``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S] \\
        [--microbatches K] [--accumulation grad|loss] [--moe-scatter] \\
        [--tuned] [--smoke-config] [--out DIR]

For each ``(arch, shape)`` cell of ``configs.cells()`` the cell's step
runs once under ``torch._subclasses.fake_tensor.FakeTensorMode``: the
parameters are fake tensors of each family's ``param_shapes`` (never
``init_params``, whose truncated normal reads a scalar), the AdamW state
comes alongside for ``train``, the cache for prefill and decode, the batch
from ``configs.input_specs``.  What runs is the port's own step:
``train.make_train_step``'s (with its ``microbatches`` and
``accumulation``), the model's ``prefill`` (``vlm_prefill`` for the vlm),
``transformer.encode_step`` for the encoder, and ``decode_step``.  A fake
tensor has shapes and dtypes and no storage, so a dry run allocates
nothing and launches nothing on any device: it runs alike with or without
a card.

The reference lowers and compiles each cell for a 512-device mesh and
reads the compiled HLO (``launch/hlo_cost.py``).  The port is eager, so
the record counts the ops that dispatch, with ``hlo_cost.py``'s
conventions:

* ``cost.dot_flops``: the matrix products' flops (2 M N K) by
  ``torch.utils.flop_counter``'s formulas, the backward's included, so
  a layer recomputed in the backward pass (``common.remat``) counts
  twice, as the reference's compiled remat does;
* ``cost.flops``: the dot FLOPs plus one per result element of each
  elementwise op of ``hlo_cost.py``'s list and one per input element of
  each reduction;
* ``cost.bytes``: the operands and results of every op that is not a
  view (nor a metadata query), the eager program's own traffic, since
  eager PyTorch fuses nothing;
* ``memory``: ``argument_bytes`` (every input of the step),
  ``output_bytes`` (every output) and ``alias_bytes`` (the outputs that
  are inputs updated in place: the parameters and optimizer state of a
  train step, the cache of prefill and decode).

XLA's ``temp_bytes`` and ``code_bytes`` have no counterpart (an eager
program's temporaries are the caching allocator's, which a fake tensor
never reaches, and nothing is compiled), so they are left out; so are
``xla_*_body_once`` and ``collectives_body_once``.  ``trace_s`` replaces
``lower_s``/``compile_s``.

Meshes: ``one`` is a single card (no collectives).  ``--mesh pod`` and
``multipod`` trace the step as one rank of the reference's production
mesh, 16x16 ``("data", "model")`` or 2x16x16 ``("pod", "data",
"model")``, over a fake process group of 256 or 512 ranks
(``torch.testing``'s ``FakeStore``; destroyed when the cell ends), with
the parameters, the AdamW state, the batch and the cache placed as
DTensors by the model's specs (``rules_for``, ``batch_sharding``, the
cache's batch axis by ``batch_spec``, as the reference's
``_fix_batch_dim``).  ``--data-only`` folds the model axis into the data
axes (on the pod mesh where ``--mesh`` is ``one``).  The record then
holds ``devices``, and everything per device, from rank 0's local
shards: ``memory`` from the local shapes, ``cost`` from the ops on local
tensors (DTensor's own shape propagation, which runs each op once on
the global shapes, is not counted), and ``collectives`` from the
functional collectives DTensor issues, with ``collective_stats.py``'s
conventions.  Each record names the ``torch`` release that traced it:
DTensor's sharding strategies, hence a mesh cell's per-device counts,
differ between releases.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import ARCHS, SHAPES, input_specs, reduce_config, skip_reason
from ..models import build_model, moe, rglru, ssm
from ..models import transformer as tfm
from ..models.common import P
from ..train.optimizer import local
from . import collective_stats
from . import mesh as lmesh

__all__ = ["fake_params", "fake_inputs", "step_cost", "trace_step", "run_cell",
           "main", "MESHES"]

MESHES = ("one", "pod", "multipod")

# family -> (its module, its parameter class)
_FAMILIES = {"dense": (tfm, tfm.TransformerParams),
             "vlm": (tfm, tfm.TransformerParams),
             "encoder": (tfm, tfm.TransformerParams),
             "moe": (moe, moe.MoEParams), "ssm": (ssm, ssm.SSMParams),
             "hybrid": (rglru, rglru.RGLRUParams)}

_aten = torch.ops.aten

# one flop per result element (hlo_cost.py's elementwise list)
_ELEMENTWISE = {
    _aten.add, _aten.sub, _aten.rsub, _aten.mul, _aten.div,
    _aten.maximum, _aten.minimum, _aten.abs, _aten.neg, _aten.exp,
    _aten.exp2, _aten.log, _aten.tanh, _aten.sqrt, _aten.rsqrt, _aten.pow,
    _aten.floor, _aten.ceil, _aten.sign, _aten.eq, _aten.ne, _aten.lt,
    _aten.le, _aten.gt, _aten.ge, _aten.where, _aten.logical_and,
    _aten.logical_or, _aten.logical_not, _aten.logical_xor,
    _aten.bitwise_and, _aten.bitwise_or, _aten.bitwise_not,
    _aten.bitwise_xor, _aten.atan2, _aten.expm1, _aten.log1p,
    _aten.sigmoid, _aten.erf, _aten.remainder, _aten.fmod,
    _aten.bitwise_left_shift, _aten.bitwise_right_shift, _aten.clamp,
    _aten.clamp_min, _aten.clamp_max, _aten.round, _aten.cos, _aten.sin,
    _aten.tan, _aten.reciprocal, _aten.silu, _aten.gelu, _aten.softplus,
    _aten.square, _aten.addcmul, _aten.addcdiv, _aten.lerp,
    _aten.nan_to_num, _aten.trunc}
# one flop per input element
_REDUCTIONS = {
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
    _aten.prod, _aten.argmax, _aten.argmin, _aten.logsumexp,
    _aten._softmax, _aten._log_softmax, _aten.cumsum, _aten.cumprod,
    _aten.var_mean, _aten.var, _aten.std, _aten.all, _aten.any,
    _aten.topk, _aten.sort}
# ops that move no data (``_unsafe_view`` is a view its schema does not
# mark as one)
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.detach,
         _aten.lift_fresh, _aten.alias, _aten._unsafe_view}


def _nbytes(tree) -> int:
    """Bytes of every tensor of ``tree``; of a DTensor, its local shard."""
    return sum(local(t).numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _numel(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _OpCost(TorchDispatchMode):
    """Counts the matrix products' flops (``dot_flops``, by
    ``flop_registry``'s formulas), the elementwise and reduction flops
    and the bytes of every op that dispatches inside it (``hlo_cost.py``'s
    conventions).

    ``local``: count one rank's program on a mesh.  A DTensor op is let
    through (``NotImplemented``) so that the ops DTensor runs on the
    local shards dispatch here, and are counted, with each functional
    collective's payload (``collectives``); the ops of DTensor's shape propagation,
    which run on tensors it makes with ``empty_strided`` from the global
    shapes, are not counted."""

    def __init__(self, local: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.local = local
        self.dot_flops = 0
        self.collectives = collective_stats.CollectiveStats()
        self._shadow: dict = {}     # id -> weakref of a propagation tensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.local:
            from torch.distributed.tensor import DTensor

            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            from torch._subclasses.fake_tensor import FakeTensor

            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            out = func(*args, **kwargs)
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if func is _aten.empty_strided.default or any(
                    self._is_shadow(t) for t in ins):
                self._shadow.update((id(t), weakref.ref(t)) for t in outs)
                return out
            if not any(isinstance(t, FakeTensor) for t in ins + outs):
                return out          # the planner's own index arithmetic
            self._count_local(func, args, kwargs, out)
        else:
            out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _is_shadow(self, t: torch.Tensor) -> bool:
        ref = self._shadow.get(id(t))
        return ref is not None and ref() is t

    def _count_local(self, func, args, kwargs, out) -> None:
        payload = collective_stats.functional_payload(func, args, out)
        if payload is not None:
            self.collectives.add(*payload)

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        if packet in flop_registry:
            self.dot_flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        # a view, a free op, or a metadata query (``prim.device``, sizes):
        # no data moves
        if packet in _FREE or _is_view(func) or not any(
                isinstance(t, torch.Tensor) for t in tree_leaves(out)):
            return
        if packet in _ELEMENTWISE:
            self.flops += _numel(out)
        elif packet in _REDUCTIONS:
            self.flops += _numel(args[0])
        self.bytes += _nbytes((args, kwargs)) + _nbytes(out)


def fake_params(cfg, mode):
    """The model's parameters as fake tensors of its family's
    ``param_shapes`` and dtypes, built inside ``mode``."""
    mod, cls = _FAMILIES[cfg.family]
    dtype = getattr(mod, "_dtype", lambda c, _: c.dtype)
    with mode:
        tensors = {n: torch.empty(s, dtype=dtype(cfg, n), device="cpu")
                   for n, s in mod.param_shapes(cfg).items()}
        return cls(cfg, tensors)


def fake_inputs(mode, tree: dict) -> dict:
    """Meta-device stand-ins (``input_specs``) as fake CPU tensors."""
    with mode:
        return {k: torch.empty(v.shape, dtype=v.dtype, device="cpu")
                for k, v in tree.items()}


def _fix_batch_dim(spec_tree, rules, batch: int):
    """The cache's specs with each data-axes entry replaced by the
    batch-aware ``batch_spec`` entry (long_500k's batch of 1 does not
    shard 16 ways), as the reference's ``_fix_batch_dim``."""
    bs = lmesh.batch_spec(rules, batch)
    repl = bs[0] if len(bs) else None
    data = {rules.data, tuple(rules.data_axes), *rules.data_axes}

    def fix(spec):
        return P(*(repl if (tuple(e) if isinstance(e, (tuple, list)) else e)
                   in data else e for e in spec))

    return lmesh.map_specs(fix, spec_tree)


def _spec_step(cfg, shape, mode, microbatches: int, accumulation: str,
               mesh=None, rules=None):
    """(fn, args, the args the step updates in place) for one cell; on
    ``mesh`` every tensor argument placed as a DTensor by the specs."""
    from ..train import TrainStepConfig, make_train_step
    from ..train.optimizer import adamw_init, opt_state_specs

    def place(tree, specs):
        if mesh is None:
            return tree
        with mode:
            return lmesh.distribute(tree, mesh, specs)

    model = build_model(cfg)
    pspecs = None if mesh is None else model.param_specs(rules)
    params = place(fake_params(cfg, mode), pspecs)
    batch = fake_inputs(mode, input_specs(cfg, shape))
    batch = place(batch, None if mesh is None
                  else lmesh.batch_sharding(rules, batch))
    B = shape.global_batch
    if shape.kind == "train":
        with mode:
            opt = adamw_init(params)
            step_idx = torch.zeros((), dtype=torch.int32)
        opt = place(opt, None if mesh is None else opt_state_specs(pspecs))
        step = make_train_step(model.loss_fn, TrainStepConfig(
            microbatches=microbatches, accumulation=accumulation),
            rules=rules)
        return step, (params, opt, batch, step_idx), (params, opt)
    if shape.kind == "prefill" and cfg.family == "encoder":
        def enc(params, batch):
            return tfm.encode_step(params, batch, cfg, rules=rules)
        return enc, (params, batch), ()
    with mode:
        cache = model.init_cache(B, shape.seq_len, device="cpu")
    cache = place(cache, None if mesh is None else _fix_batch_dim(
        model.cache_specs(rules), rules, B))
    if shape.kind == "prefill":
        def pf(params, batch, cache):
            return model.prefill(params, batch, cache, rules=rules)
        return pf, (params, batch, cache), (cache,)
    pos = shape.seq_len - 1         # the step that fills the cache's last slot

    def dec(params, cache, tokens):
        return model.decode_step(params, cache, tokens, pos, rules=rules)
    return dec, (params, cache, batch["tokens"]), (cache,)


def _tensors(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):          # NamedTuples too
        return [t for v in tree for t in _tensors(v)]
    return []


def step_cost(fn, args, updated, mode, local: bool = False) -> dict:
    """Run ``fn(*args)`` once on fake tensors (``args`` made in ``mode``)
    and count it: ``{"cost": {"flops", "dot_flops", "bytes",
    "collectives"}, "memory": {...}, "trace_s"}``; ``updated`` holds the
    arguments the step updates in place (``memory.alias_bytes``).
    ``local``: the arguments are DTensors on a mesh, and everything is
    counted on this rank's local shards (``_OpCost``)."""
    ops = _OpCost(local=local)
    planner = (_strided_shard_sizes_unfaked() if local
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with planner, mode, ops:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    ins = {id(t): t for t in _tensors(args)}
    outs = {id(t): t for t in _tensors(out)}
    upd = {id(t) for t in _tensors(updated)}
    dot = ops.dot_flops
    coll = ops.collectives.as_dict()
    del coll["per_shard"]
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": _nbytes(list(ins.values())),
            "output_bytes": _nbytes(list(outs.values())),
            "alias_bytes": _nbytes([t for i, t in outs.items()
                                    if i in ins and i in upd]),
        },
        "cost": {"flops": float(dot + ops.flops), "dot_flops": float(dot),
                 "bytes": float(ops.bytes), "collectives": coll},
    }


@contextlib.contextmanager
def _strided_shard_sizes_unfaked():
    """DTensor's redistribution planner sizes a ``_StridedShard``'s local
    slice with real index tensors (``torch.arange``, ``tolist``), which
    the active ``FakeTensorMode`` would turn into data-dependent fakes and
    refuse; for the block that method runs with the fake mode unset."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    sized = _StridedShard.local_shard_size_and_offset

    def unfaked(self, *args, **kwargs):
        with unset_fake_temporarily():
            return sized(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = unfaked
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = sized


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the block (``FakeStore``: no communication, the collectives'
    results unspecified); destroyed after.  Refused inside a real
    group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run on a mesh starts its own fake process "
                           "group; one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_step(cfg, shape, microbatches: int = 1,
               accumulation: str = "grad", mesh=None,
               data_only: bool = False) -> dict:
    """Trace the step of ``cfg`` at ``shape`` (a ``configs.ShapeSpec``)
    on fake tensors and count it (``step_cost``): on one card, or on
    ``mesh`` (a ``DeviceMesh``) as its rank 0 with the rules of
    ``rules_for(mesh, data_only=data_only)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    rules = None if mesh is None else lmesh.rules_for(mesh,
                                                       data_only=data_only)
    fn, args, updated = _spec_step(cfg, shape, mode, microbatches,
                                   accumulation, mesh, rules)
    return step_cost(fn, args, updated, mode, local=mesh is not None)


def run_cell(arch: str, shape_name: str, mesh: str = "one",
             microbatches: int = 8, arch_override=None,
             accumulation: str = "grad", data_only: bool = False) -> dict:
    """Trace one (arch x shape x mesh) cell on fake tensors; return its
    record.  ``data_only`` on ``mesh="one"`` runs on the pod mesh."""
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: one of {MESHES}")
    if data_only and mesh == "one":
        mesh = "pod"
    cfg = arch_override if arch_override is not None else ARCHS[arch]
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "kind": shape.kind, "torch": torch.__version__}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["skipped"] = reason
        return rec
    rec["variant"] = {"accumulation": accumulation, "data_only": data_only}
    if mesh == "one":
        rec["devices"] = 1
        rec.update(trace_step(cfg, shape, microbatches, accumulation))
    else:
        multi_pod = mesh == "multipod"
        with fake_group(512 if multi_pod else 256):
            dmesh = lmesh.make_production_mesh(multi_pod=multi_pod)
            rec["devices"] = dmesh.size()
            rec.update(trace_step(cfg, shape, microbatches, accumulation,
                                  dmesh, data_only))
    rec["flops_per_device"] = rec["cost"]["flops"]
    rec["bytes_per_device"] = rec["cost"]["bytes"]
    rec["collectives"] = rec["cost"]["collectives"]
    rec["microbatches"] = microbatches if shape.kind == "train" else 1
    return rec


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="trace each model cell's step "
                                 "on fake tensors and count its work")
    ap.add_argument("--arch", default=None, choices=list(ARCHS),
                    help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="one shape (default: all)")
    ap.add_argument("--mesh", default="one", choices=MESHES,
                    help="one card, or rank 0 of the 16x16 (pod) or "
                         "2x16x16 (multipod) mesh on a fake process group")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--smoke-config", action="store_true",
                    help="use the reduced config (debugging the harness)")
    ap.add_argument("--accumulation", default="grad",
                    choices=["grad", "loss"],
                    help="microbatch gradient accumulation mode")
    ap.add_argument("--data-only", action="store_true",
                    help="fold the model axis into data parallelism (on "
                         "the pod mesh where --mesh is one)")
    ap.add_argument("--moe-gather", action="store_true",
                    help="gather-based MoE dispatch/combine (the default; "
                         "flag kept for provenance)")
    ap.add_argument("--moe-scatter", action="store_true",
                    help="scatter-based MoE dispatch")
    ap.add_argument("--tuned", action="store_true",
                    help="apply per-arch tuned launch settings "
                         "(launch/tuned.py)")
    return ap


def main(argv=None) -> int:
    from .tuned import launch_kwargs

    args = _parser().parse_args(argv)
    mesh_name = "pod" if args.data_only and args.mesh == "one" else args.mesh
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    mode = "scatter" if args.moe_scatter else "gather"
    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{mesh_name}"
            override = (reduce_config(ARCHS[arch]) if args.smoke_config
                        else None)
            try:
                tk = launch_kwargs(arch, SHAPES[shape].kind, args.tuned)
                # a tuned layout that folds the model axis away: on one
                # card there is no model axis to fold, so it is recorded
                data_only = tk.get("data_only", args.data_only)
                with moe.dispatch_mode(mode):
                    rec = run_cell(
                        arch, shape, mesh_name,
                        microbatches=tk.get("microbatches",
                                            args.microbatches),
                        arch_override=override,
                        accumulation=args.accumulation,
                        data_only=data_only and mesh_name != "one")
                if "variant" in rec:
                    rec["variant"]["data_only"] = data_only
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=2)
            if "skipped" in rec:
                status = "SKIP " + rec["skipped"]
            elif "error" in rec:
                status = "FAIL " + rec["error"][:120]
            else:
                status = (f"ok trace={rec['trace_s']}s "
                          f"flops/dev={rec['flops_per_device']:.3g} "
                          f"dot={rec['cost']['dot_flops']:.3g} "
                          f"bytes/dev={rec['bytes_per_device']:.3g}")
            print(f"[dryrun] {tag}: {status}", flush=True)
    print(f"[dryrun] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
