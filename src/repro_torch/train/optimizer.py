"""AdamW with f32 master weights for bf16 parameters: the port of
``repro/train/optimizer.py``.

The model's parameters live in their dtype (bf16 by default); the state
carries an f32 master copy and f32 first and second moments, keyed by
the parameters' dotted names (``layers.wq``), and an int32 step.
``adamw_update`` takes the gradients, clips them by their global norm,
updates the masters and writes them, cast to each parameter's dtype,
into the same tensors.  Everything is in place, a slice of at most
``PIECE`` elements at a time: gemma-2b's stacked ``layers.w_in`` alone
is 1.2e9 elements, whose f32 temporaries would take 4.8 GB each.

On a mesh every per-parameter state tensor is a DTensor placed as its
parameter (``opt_state_specs``: the parameters' specs under ``master``,
``mu`` and ``nu``, the step replicated), and the gradients come placed
so too: the update runs on each rank's local shards, and the global norm
sums each leaf's local squares as a partial sum over the axes it is
sharded on.
"""
from __future__ import annotations

from collections.abc import Iterator, Mapping
from dataclasses import dataclass

import torch
from torch import nn

__all__ = ["AdamWConfig", "named_params", "local", "adamw_init",
           "opt_state_specs", "global_norm", "adamw_update"]

PIECE = 1 << 26     # elements of one in-place slice (256 MB in f32)


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def named_params(params) -> dict[str, torch.Tensor]:
    """Dotted name -> tensor of a params module (``named_parameters``) or
    of a flat dict of tensors."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage); any other tensor
    as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _pieces(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` along its first axis of at most ``PIECE`` elements
    (a row at least)."""
    if t.dim() == 0 or t.numel() <= PIECE:
        yield t
        return
    rows = max(1, PIECE // max(1, t[0].numel()))
    yield from torch.split(t, rows)


def adamw_init(params) -> dict:
    """``step`` int32 0 and f32 ``master`` (a copy), ``mu`` and ``nu``
    (zeros) per parameter name, on the parameters' devices."""
    named = named_params(params)
    dev = next(iter(named.values())).device
    with torch.no_grad():
        return {
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "master": {n: p.detach().to(torch.float32, copy=True)
                       for n, p in named.items()},
            "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named.items()},
        }


def opt_state_specs(param_specs: Mapping) -> dict:
    """The state's specs: each parameter's under ``master``, ``mu`` and
    ``nu``, the step replicated."""
    from ..models.common import P

    specs = dict(param_specs)
    return {"step": P(), "master": specs, "mu": dict(specs),
            "nu": dict(specs)}


def _sum_squares(t: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of ``t``; of a DTensor, its local shards'
    sum made whole over the mesh axes it is sharded on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    total = 0
    for x in _pieces(local(t)):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    if not isinstance(t, DTensor):
        return total
    partial = [Replicate() if p.is_replicate() else Partial()
               for p in t.placements]
    return DTensor.from_local(torch.as_tensor(total, device=local(t).device),
                              t.device_mesh, partial,
                              run_check=False).full_tensor()


def global_norm(tree: Mapping) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, leaves in sorted
    name order (the reference's flattening order)."""
    total = 0
    with torch.no_grad():
        for name in sorted(tree):
            total = total + _sum_squares(tree[name])
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Mapping, state: dict, params, lr,
                 cfg: AdamWConfig):
    """One AdamW step, in place: ``state`` and the parameters' tensors
    are updated and returned with the gradients' global norm, as
    (params, state, grad_norm).  ``lr`` is a float or a 0-d tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    step = local(state["step"]) + 1
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    for name, p in named_params(params).items():
        for g, m, v, w, q in zip(*(_pieces(local(x)) for x in (
                grads[name], state["mu"][name], state["nu"][name],
                state["master"][name], p))):
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
            del g
            upd = m / bc1
            upd.div_(torch.sqrt(v / bc2).add_(cfg.eps))
            upd.add_(cfg.weight_decay * w)
            w.sub_(upd.mul_(lr))
            q.copy_(w)
    local(state["step"]).copy_(step)
    return params, state, gnorm
