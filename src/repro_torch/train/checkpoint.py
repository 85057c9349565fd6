"""Step-atomic checkpoints in the reference's on-disk layout: the port of
``repro/train/checkpoint.py``.

    <dir>/step_<N>.tmp/           -- written first
        meta.json                 -- step, extras, each leaf's path,
                                     shape and dtype
        arr_<k>.npy               -- one file per leaf
    <dir>/step_<N>/               -- renamed after meta.json's fsync

* **Atomicity**: the rename is the commit point; a crash mid-write leaves
  only a ``.tmp`` directory, which ``latest_step`` ignores and ``save``
  removes.
* **Either package**: the leaves are in the order of JAX's flattening of
  the same tree (a tuple by index, a dict by sorted keys at every level,
  a dotted name ``layers.wq`` as the nested ``['layers']['wq']``), each
  ``path`` is ``jax.tree_util.keystr``'s string, and bf16 is stored as
  its 16-bit pattern (``uint16``) under the dtype name ``bfloat16``, as
  there.  So a checkpoint of ``(params, opt_state)`` written by either
  package restores into the other.
* **Elasticity**: the leaves are global arrays.  ``save`` on a mesh
  gathers each DTensor (every rank calls it) and rank 0 alone writes;
  ``restore`` places each saved array on the placements of its
  ``tree_like`` leaf, so a checkpoint written on one mesh restores on any
  mesh whose axes divide the shapes, or on one device.
* **Determinism**: the data pipeline's cursor rides along in ``extras``,
  so a restarted run replays the stream the stopped one would have read.
"""
from __future__ import annotations

import json
import os
import shutil
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = ["leaves", "save", "latest_step", "restore"]

_BF16 = "bfloat16"


def _nest(flat: Mapping) -> dict:
    """A dict whose keys may be dotted names as nested dicts."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = str(name).split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = v
    return out


def leaves(tree, path: str = ""):
    """(keystr path, leaf) in JAX's flattening order."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    elif isinstance(tree, Mapping):
        tree = _nest(tree)
        for key in sorted(tree):
            yield from leaves(tree[key], f"{path}[{key!r}]")
    else:
        yield path, tree


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array stored on disk and its dtype's name (a
    DTensor's full value)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, arr.dtype.name
    t = leaf.detach()
    if _is_dtensor(t):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
    arr = t.cpu().numpy()
    return arr, arr.dtype.name


def save(directory: str, step: int, tree, extras: dict | None = None) -> str:
    """Write ``tree`` (tensors, arrays, nested in tuples, lists, dicts and
    params modules) as ``<directory>/step_<step>``; returns that path.
    A tree holding DTensors is saved by every rank of the process group
    together: each DTensor is gathered, rank 0 writes, and every rank
    returns once the step is committed."""
    flat = list(leaves(tree))
    arrays = (_to_numpy(leaf) for _, leaf in flat)    # one leaf at a time
    if not any(_is_dtensor(leaf) for _, leaf in flat):
        return _write(directory, step, flat, arrays, extras)
    if dist.get_rank() == 0:
        final = _write(directory, step, flat, arrays, extras)
    else:       # take part in each gather, in the writer's order
        final = os.path.join(directory, f"step_{step}")
        for _, leaf in flat:
            if _is_dtensor(leaf):
                leaf.detach().full_tensor()
    dist.barrier()
    return final


def _write(directory, step, flat, arrays, extras) -> str:
    os.makedirs(directory, exist_ok=True)
    for name in os.listdir(directory):          # stale partial writes
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp)
    meta = {"step": int(step), "extras": extras or {}, "leaves": []}
    for i, ((path, _), (arr, dtype)) in enumerate(zip(flat, arrays)):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        meta["leaves"].append({"path": path, "shape": list(arr.shape),
                               "dtype": dtype})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    """The largest committed step in ``directory`` (``.tmp`` ignored), or
    None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(n.split("_", 1)[1]) for n in os.listdir(directory)
             if n.startswith("step_") and not n.endswith(".tmp")]
    return max(steps) if steps else None


@torch.no_grad()
def restore(directory: str, step: int, tree_like):
    """Load ``<directory>/step_<step>`` into the tensors of ``tree_like``
    in place (each cast to its tensor's dtype and device); the leaves must
    match in count, path and shape.  A DTensor leaf takes its own slice
    of the saved array, on its placements (nothing moves between ranks).
    Returns (tree_like, extras)."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    flat = list(leaves(tree_like))
    if len(flat) != len(meta["leaves"]):
        raise ValueError(f"checkpoint has {len(meta['leaves'])} leaves, "
                         f"target tree has {len(flat)}")
    for i, ((kpath, like), desc) in enumerate(zip(flat, meta["leaves"])):
        if kpath != desc["path"]:
            raise ValueError(f"leaf {i}: saved {desc['path']}, target "
                             f"{kpath}")
        arr = np.load(os.path.join(path, f"arr_{i}.npy"))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {desc['path']}: saved {arr.shape} != "
                             f"target {tuple(like.shape)}")
        arr = np.require(arr, requirements="C")    # keeps a 0-d shape
        if desc["dtype"] == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if _is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor

            t = distribute_tensor(t.to(like.dtype), like.device_mesh,
                                  like.placements, src_data_rank=None)
            like.to_local().copy_(t.to_local())
        else:
            like.copy_(t)
    return tree_like, meta["extras"]
