"""The train step: loss -> gradients -> clip -> AdamW, with optional
microbatch accumulation (the port of ``repro/train/step.py``).

``make_train_step(loss_fn, cfg)`` returns
    train_step(params, opt_state, batch, step_idx) -> (params, opt_state,
                                                       metrics)
which updates ``params`` and ``opt_state`` in place and returns them.
With ``microbatches`` k > 1 the batch splits into k slices of its leading
axis; ``accumulation="grad"`` takes each slice's gradients and adds them
into f32 buffers (the reference's f32 scan carry: ``.grad`` would add
bf16 gradients in bf16), ``"loss"`` averages the k losses, each slice
recomputed in the backward pass, and takes one gradient.

On a mesh (``rules`` given, the reference's ``make_train_step(...,
rules=rules)``) the parameters and the optimizer state are DTensors and
the batch leaves DTensors sharded over the data axes; ``loss_fn`` gets
``rules=rules``.  The microbatch split cuts each rank's local rows (so a
microbatch holds rows of every data shard, not the reference's
contiguous block of the global batch: the same result wherever each
microbatch's loss is a mean of per-row terms over equal counts, as the
next-token losses are; not the MoE's aux loss), each gradient is
redistributed to its parameter's placements (the data-axis reduction)
and accumulated on the local shards, and AdamW updates the local shards
in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import functools

import torch
import torch.utils.checkpoint
from torch import nn

from ..models.common import on_mesh
from .optimizer import AdamWConfig, adamw_update, local, named_params
from .schedule import warmup_cosine

__all__ = ["TrainStepConfig", "make_train_step", "value_and_grad"]


@dataclass(frozen=True)
class TrainStepConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1          # gradient-accumulation factor
    accumulation: str = "grad"     # 'grad' | 'loss' (see the module doc)
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def _split_batch(batch: dict, k: int) -> list[dict]:
    """k microbatches: every leaf (B, ...) cut into k slices of B // k;
    a DTensor leaf's local rows cut into k slices of its local rows."""
    from torch.distributed.tensor import DTensor

    out = [{} for _ in range(k)]
    for name, x in batch.items():
        rows = local(x)
        if rows.shape[0] % k:
            raise ValueError(f"batch {rows.shape[0]} not divisible by {k} "
                             f"microbatches")
        for i, piece in enumerate(torch.chunk(rows, k)):
            out[i][name] = piece if rows is x else DTensor.from_local(
                piece, x.device_mesh, x.placements, run_check=False)
    return out


def _trainable(params) -> dict[str, torch.Tensor]:
    """The parameters by name, gradients turned on."""
    if isinstance(params, nn.Module):
        params.requires_grad_(True)
    named = named_params(params)
    for t in named.values():
        t.requires_grad_(True)
    return named


def _grad(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d each leaf; zeros for a leaf the loss does not use (the
    encoder's token embedding), as JAX gives.  A DTensor leaf's gradient
    is redistributed to the leaf's placements (a partial sum over the
    data axes is reduced)."""
    from torch.distributed.tensor import DTensor

    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return [g.redistribute(t.device_mesh, t.placements)
            if isinstance(g, DTensor) else g for g, t in zip(grads, leaves)]


def _full(loss: torch.Tensor) -> torch.Tensor:
    """The loss as a plain tensor (a DTensor's full value)."""
    from torch.distributed.tensor import DTensor

    loss = loss.detach()
    return loss.full_tensor() if isinstance(loss, DTensor) else loss


def value_and_grad(loss_fn: Callable, params, batch: dict,
                   cfg: TrainStepConfig, rules=None):
    """(loss, name -> gradient) of ``loss_fn(params, batch)``, with the
    microbatching of ``cfg``: the gradients are f32 in the ``'grad'`` mode
    with k > 1, else in each parameter's dtype, as the reference's.  With
    ``rules`` the call is ``loss_fn(params, batch, rules=rules)`` on
    DTensors (see the module doc); the loss comes back a plain tensor."""
    if rules is not None:
        loss_fn = functools.partial(loss_fn, rules=rules)
    with on_mesh(rules):
        return _value_and_grad(loss_fn, params, batch, cfg)


def _value_and_grad(loss_fn, params, batch, cfg):
    named = _trainable(params)
    names, leaves = list(named), list(named.values())
    k = cfg.microbatches
    if k > 1 and cfg.accumulation == "loss":
        total = 0
        for b in _split_batch(batch, k):
            total = total + torch.utils.checkpoint.checkpoint(
                loss_fn, params, b, use_reentrant=False)
        loss = total / k
        grads = _grad(loss, leaves)
    elif k > 1:
        if cfg.accumulation != "grad":
            raise ValueError(f"accumulation {cfg.accumulation!r}: 'grad' "
                             f"or 'loss'")
        grads = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        loss_sum = 0
        for b in _split_batch(batch, k):
            loss = loss_fn(params, b)
            for acc, g in zip(grads, _grad(loss, leaves)):
                local(acc).add_(local(g))
            loss_sum = loss_sum + _full(loss)
        inv = 1.0 / k
        loss = loss_sum * inv
        for g in grads:
            local(g).mul_(inv)
    else:
        loss = loss_fn(params, batch)
        grads = _grad(loss, leaves)
    return _full(loss), dict(zip(names, grads))


def make_train_step(loss_fn: Callable, cfg: TrainStepConfig,
                    rules=None) -> Callable:
    """loss_fn: (params, batch) -> f32 scalar, or (params, batch,
    rules=rules) on a mesh.  The step turns the parameters' gradients
    on."""

    def train_step(params, opt_state, batch, step_idx):
        loss, grads = value_and_grad(loss_fn, params, batch, cfg, rules)
        lr = warmup_cosine(step_idx, peak_lr=cfg.peak_lr,
                           warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.total_steps)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, lr,
                                                cfg.opt)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step
