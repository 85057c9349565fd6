"""The training driver: data pipeline -> train loop -> step-atomic
checkpoints -> restart (the port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch gemma-2b --smoke \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT [--device cpu]

Runs on the card unless ``--device`` says otherwise (and raises where
there is none).  The model starts from random weights (a torch generator
seeded with ``--seed``) or, where ``--ckpt-dir`` holds a checkpoint, from
its latest step: parameters, optimizer state, the pipeline's cursor and
the step, so a stopped run resumes bit for bit.  Batches are the
synthetic ``TokenPipeline``'s.  The log lines are the reference's.  One
device: a ``--mesh-shape`` other than ``1 1`` waits for ROADMAP item 9b.
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field

import torch

from ..configs import ARCHS, reduce_config
from ..core.device import resolve_device
from ..data.tokens import TokenPipeline
from ..models import build_model
from ..train import TrainStepConfig, make_train_step
from ..train import checkpoint as ckpt
from ..train.optimizer import adamw_init

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


def run(argv=None) -> TrainRun:
    """Train as ``python -m repro_torch.launch.train`` does with the
    arguments ``argv``; returns the final state and per-step numbers."""
    args = _parser().parse_args(argv)
    if math.prod(args.mesh_shape) != 1:
        raise SystemExit(f"--mesh-shape {args.mesh_shape}: training runs on "
                         f"one device; a mesh across cards is ROADMAP item "
                         f"9b")
    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_config(cfg)
    model = build_model(cfg)
    pipeline = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed)
    tcfg = TrainStepConfig(peak_lr=args.lr, warmup_steps=min(20, args.steps),
                           total_steps=args.steps,
                           microbatches=args.microbatches)
    step_fn = make_train_step(model.loss_fn, tcfg)

    params = model.init(args.seed, device=dev)
    opt_state = adamw_init(params)
    out = TrainRun(params=params, opt_state=opt_state, start_step=0)
    latest = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if latest is not None:
        t_restore = time.perf_counter()
        _, extras = ckpt.restore(args.ckpt_dir, latest, (params, opt_state))
        out.restore_s = time.perf_counter() - t_restore
        pipeline.load_state_dict(extras["pipeline"])
        out.start_step = int(extras["step"]) + 1
        print(f"[train] restored step {latest} "
              f"(cursor={pipeline.cursor})", flush=True)
    start_step = out.start_step
    t0 = time.time()
    tokens_seen = 0
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(pipeline).items()}
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
            print(f"[train] step {step:5d} loss {out.losses[-1]:.4f}"
                  f" gnorm {out.grad_norms[-1]:.3f}"
                  f" lr {out.lrs[-1]:.2e}"
                  f" tok/s {tokens_seen / max(dt, 1e-9):.0f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save(args.ckpt_dir, step, (params, opt_state),
                             extras={"step": step,
                                     "pipeline": pipeline.state_dict(),
                                     "arch": cfg.name})
            print(f"[train] checkpoint -> {path}", flush=True)
    print(f"[train] done: {args.steps - start_step} steps in "
          f"{time.time() - t0:.1f}s", flush=True)
    return out


def main(argv=None) -> float:
    """Train as ``run`` does; the last step's loss (NaN if the
    checkpoint was already at ``--steps``)."""
    losses = run(argv).losses
    return losses[-1] if losses else float("nan")


if __name__ == "__main__":
    main()
