"""The training driver: data pipeline -> train loop -> step-atomic
checkpoints -> restart (the port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch gemma-2b --smoke \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT [--device cpu]

Runs on the card unless ``--device`` says otherwise (and raises where
there is none).  The model starts from random weights (a torch generator
seeded with ``--seed``) or, where ``--ckpt-dir`` holds a checkpoint, from
its latest step: parameters, optimizer state, the pipeline's cursor and
the step, so a stopped run resumes bit for bit.  Batches are the
synthetic ``TokenPipeline``'s.  The log lines are the reference's.

A mesh: ``--mesh-shape``/``--mesh-names`` build a ``DeviceMesh`` over
the process group, one rank per device (NCCL on cards, gloo with
``--device cpu``).  The group is the caller's, or, under ``torchrun``
(``WORLD_SIZE`` set), one this script starts and ends:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gemma-2b --smoke --mesh-shape 2 2

The mesh's size must be the group's (1 with no group).  On a mesh the
parameters are placed by ``param_specs``, the optimizer state by
``opt_state_specs`` and each batch by ``batch_sharding`` (every rank
draws the same global batch and keeps its own rows), the step is the
sharded one, checkpoints are gathered and written by rank 0 and restore
onto any mesh, and rank 0 alone logs.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..configs import ARCHS, reduce_config
from ..core.device import resolve_device
from ..data.tokens import TokenPipeline
from ..models import build_model
from ..train import TrainStepConfig, make_train_step
from ..train import checkpoint as ckpt
from ..train.optimizer import adamw_init, opt_state_specs
from . import mesh as lmesh

__all__ = ["TrainRun", "run", "main"]


@dataclass
class TrainRun:
    """What a run leaves: the final parameters and optimizer state, and
    per step taken its loss, gradient norm, learning rate and wall time
    (each step ends in a synchronize on the card)."""
    params: object
    opt_state: dict
    start_step: int
    restore_s: float = 0.0      # reading the checkpoint resumed from
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    lrs: list = field(default_factory=list)
    step_s: list = field(default_factory=list)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="train a model of the zoo on "
                                 "the synthetic token stream")
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh-shape", type=int, nargs="+", default=[1, 1])
    ap.add_argument("--mesh-names", nargs="+", default=["data", "model"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def _build_mesh(args, dev):
    """The ``DeviceMesh`` of ``--mesh-shape``/``--mesh-names`` over the
    process group (None with no group: one device)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(args.mesh_shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise SystemExit(f"--mesh-shape {args.mesh_shape}: a mesh of {n} "
                         f"devices, but the world size is {world} (a "
                         f"process group of {n} ranks runs it)")
    if len(args.mesh_names) != len(args.mesh_shape):
        raise SystemExit(f"--mesh-names {args.mesh_names} do not name the "
                         f"{len(args.mesh_shape)} axes of --mesh-shape")
    if not dist.is_initialized():
        return None
    return init_device_mesh(dev.type, tuple(args.mesh_shape),
                            mesh_dim_names=tuple(args.mesh_names))


def run(argv=None) -> TrainRun:
    """Train as ``python -m repro_torch.launch.train`` does with the
    arguments ``argv``; returns the final state and per-step numbers."""
    args = _parser().parse_args(argv)
    own_group = (not dist.is_initialized()
                 and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if own_group:               # torchrun's environment
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    try:
        return _run(args)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args) -> TrainRun:
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    mesh = _build_mesh(args, dev)
    rules = None if mesh is None else lmesh.rules_for(mesh)
    chief = not dist.is_initialized() or dist.get_rank() == 0

    def log(msg: str) -> None:
        if chief:
            print(msg, flush=True)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_config(cfg)
    model = build_model(cfg)
    pipeline = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed)
    tcfg = TrainStepConfig(peak_lr=args.lr, warmup_steps=min(20, args.steps),
                           total_steps=args.steps,
                           microbatches=args.microbatches)
    step_fn = make_train_step(model.loss_fn, tcfg, rules=rules)

    params = model.init(args.seed, device=dev)
    if mesh is not None:
        pspecs = model.param_specs(rules)
        params = lmesh.distribute(params, mesh, pspecs)
    opt_state = adamw_init(params)
    if mesh is not None:
        opt_state = lmesh.distribute(opt_state, mesh,
                                     opt_state_specs(pspecs))
    out = TrainRun(params=params, opt_state=opt_state, start_step=0)
    latest = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if latest is not None:
        t_restore = time.perf_counter()
        _, extras = ckpt.restore(args.ckpt_dir, latest, (params, opt_state))
        out.restore_s = time.perf_counter() - t_restore
        pipeline.load_state_dict(extras["pipeline"])
        out.start_step = int(extras["step"]) + 1
        log(f"[train] restored step {latest} (cursor={pipeline.cursor})")
    start_step = out.start_step
    t0 = time.time()
    tokens_seen = 0
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(pipeline).items()}
        if mesh is not None:
            batch = lmesh.distribute(batch, mesh,
                                     lmesh.batch_sharding(rules, batch))
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.step_s.append(time.perf_counter() - t_step)
        out.losses.append(float(metrics["loss"]))
        out.grad_norms.append(float(metrics["grad_norm"]))
        out.lrs.append(float(metrics["lr"]))
        tokens_seen += args.batch * args.seq
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            log(f"[train] step {step:5d} loss {out.losses[-1]:.4f}"
                f" gnorm {out.grad_norms[-1]:.3f}"
                f" lr {out.lrs[-1]:.2e}"
                f" tok/s {tokens_seen / max(dt, 1e-9):.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save(args.ckpt_dir, step, (params, opt_state),
                             extras={"step": step,
                                     "pipeline": pipeline.state_dict(),
                                     "arch": cfg.name})
            log(f"[train] checkpoint -> {path}")
    log(f"[train] done: {args.steps - start_step} steps in "
        f"{time.time() - t0:.1f}s")
    return out


def main(argv=None) -> float:
    """Train as ``run`` does; the last step's loss (NaN if the
    checkpoint was already at ``--steps``)."""
    losses = run(argv).losses
    return losses[-1] if losses else float("nan")


if __name__ == "__main__":
    main()
