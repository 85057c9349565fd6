"""Shared model config, layers, init and sharding helpers: the port of
``repro/models/common.py``.

Parameters are stored in the config's dtype (bf16 by default); norms,
RoPE, the GLU activation and softmax compute in f32 and cast back, at
the same points as the reference.  ``StackedParams`` holds any family's
weights under the reference's pytree names.  ``cross_entropy`` and
``remat`` serve training: the loss in f32, and a layer recomputed in the
backward pass where gradients are on.

Sharding: a ``torch.distributed`` ``DeviceMesh`` with DTensor placements
takes the place of GSPMD.  ``P`` is the port's partition spec (a tuple
with one entry per dimension: None, a mesh axis name, or a tuple of
names); ``MeshRules`` resolves the logical axes ``"model"`` and
``"data"`` against the mesh's axis sizes (a dimension the axis does not
divide is replicated, e.g. MQA's one kv head), ``logical_to_spec``
builds a spec, ``spec_to_placements`` turns one into a mesh's placement
list, and ``constrain`` redistributes a DTensor (the reference's
``with_sharding_constraint``) and is the identity on anything else.
Every family's entry points take ``rules=None``: with None they run
exactly as on one device; with rules their tensors are DTensors, and
``on_mesh(rules)`` treats the plain tensors they make (positions,
masks) as replicated.  The dry run's ``mscan`` has no counterpart: the
port's layers are a Python loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..core.device import resolve_device

__all__ = ["ArchConfig", "StackedParams", "P", "MeshRules",
           "logical_to_spec", "spec_to_placements", "constrain", "on_mesh",
           "rms_norm", "rope_angles", "apply_rope", "softcap", "softplus",
           "glu_ffn", "cross_entropy", "remat", "init_generator",
           "dense_init", "embed_init"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    activation: str = "swiglu"   # swiglu | geglu
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    embed_scale: bool = False    # gemma-style sqrt(d) embedding scaling
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_experts_padded: int = 0   # pad expert count to a shardable multiple
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # hybrid (recurrentgemma): block pattern, local-attn window, rnn width
    pattern: tuple = ()
    local_window: int = 0
    rnn_width: int = 0
    # modality frontends (STUBS: inputs are precomputed embeddings)
    frontend_dim: int = 0        # audio frame / vision patch feature dim
    num_patches: int = 0         # vlm image tokens per example
    is_causal: bool = True
    dtype: Any = torch.bfloat16

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)


# ---------------------------------------------------------------- sharding
class P(tuple):
    """A partition spec: one entry per tensor dimension, each None
    (replicated), a mesh axis name, or a tuple of names (sharded over
    their product, the first the major one).  Dimensions past the last
    entry are replicated.  Equal to the plain tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


@dataclass(frozen=True)
class MeshRules:
    """Logical-axis -> mesh-axis rules, resolved against axis sizes."""
    data_axes: tuple = ("data",)      # ('pod','data') on the multi-pod mesh
    model_axis: str | None = "model"
    axis_sizes: dict | None = None    # name -> size (for divisibility checks)

    def model(self, dim_size: int):
        """Shard over the model axis if divisible, else replicate.

        model_axis=None disables tensor parallelism entirely (small archs
        fold the model axis into data parallelism instead)."""
        if self.model_axis is None:
            return None
        if self.axis_sizes is not None:
            m = self.axis_sizes.get(self.model_axis, 1)
            if dim_size % m != 0 or dim_size < m:
                return None
        return self.model_axis

    @property
    def data(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def data_if(self, dim_size: int):
        """Shard over the data axes if divisible, else replicate."""
        if self.axis_sizes is not None:
            total = math.prod(self.axis_sizes.get(a, 1)
                              for a in self.data_axes)
            if dim_size % total != 0 or dim_size < total:
                return None
        return self.data


def logical_to_spec(rules: MeshRules, *axes_and_sizes) -> P:
    """Build a spec from (logical_axis, dim_size) pairs.

    Logical axes: 'model' (tensor-parallel), 'data' (batch), None
    (replicated)."""
    parts = []
    for logical, size in axes_and_sizes:
        if logical == "model":
            parts.append(rules.model(size))
        elif logical == "data":
            parts.append(rules.data)
        else:
            parts.append(None)
    return P(*parts)


def spec_to_placements(mesh, spec) -> list:
    """The placement list, one per mesh dimension, of ``spec`` on the
    ``DeviceMesh`` ``mesh``: ``Shard(d)`` on each mesh axis that tensor
    dimension d's entry names, ``Replicate()`` on the others and on an
    axis of size 1 (the same layout; DTensor's view rules refuse some
    reshapes of a dimension sharded over one device).  An entry's axes
    must be mesh axes, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    placements = [Replicate() for _ in names]
    used = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r}: {a!r} is not an axis of "
                                 f"the mesh {names}")
            i = names.index(a)
            if i in used:
                raise ValueError(f"spec {spec!r}: axis {a!r} used twice")
            used.add(i)
            if mesh.size(i) > 1:
                placements[i] = Shard(dim)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: the axes {axes} are not in "
                             f"the mesh's order {names}")
    return placements


def constrain(x, spec):
    """Redistribute the DTensor ``x`` to ``spec`` on its own mesh (the
    reference's ``with_sharding_constraint``); anything else is returned
    as it is.  A dimension that the product of its axes' sizes does not
    divide is replicated over them: GSPMD pads an uneven shard, where
    DTensor's view rules refuse one (long_500k's batch of 1 over 16 data
    ranks)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = spec_to_placements(mesh, spec)
    for dim in range(x.ndim):
        axes = [i for i, p in enumerate(placements)
                if isinstance(p, Shard) and p.dim == dim]
        if x.shape[dim] % math.prod(mesh.size(i) for i in axes):
            for i in axes:
                placements[i] = Replicate()
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


@contextlib.contextmanager
def on_mesh(rules: MeshRules | None):
    """The context a model function runs in: with rules, plain tensors
    that meet DTensors (positions, masks, constants) count as replicated,
    as under ``implicit_replication``; without, nothing.  It nests:
    ``implicit_replication`` turns the setting off on exit whatever it
    was, so this saves and restores the dispatcher's flag itself."""
    if rules is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    old = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = old


class StackedParams(nn.Module):
    """The weights of one model from a name -> tensor dict checked against
    ``specs`` (name -> (shape, dtype)).  The names are the reference's
    pytree paths joined by dots; each dotted prefix is a ``ParameterDict``
    (or a ``ModuleDict`` of them), so ``layers.wq`` is
    ``self.layers["wq"]``, ``supers.rec1.wg`` ``self.supers["rec1"]["wg"]``,
    and ``state_dict()`` gives back the same names.

    The parameters are built with ``requires_grad=False``: serving needs
    no graph.  A trainer turns gradients on with
    ``params.requires_grad_(True)`` (``train.step.make_train_step``'s step
    does); ``ServeEngine`` runs under ``torch.inference_mode()`` either
    way, so it builds no graph on trainable parameters."""

    def __init__(self, cfg: ArchConfig, tensors: dict, specs: dict):
        super().__init__()
        if set(tensors) != set(specs):
            raise ValueError(f"{cfg.name}: tensors {sorted(tensors)}, "
                             f"expected {sorted(specs)}")
        tree: dict = {}
        for name, (shape, dtype) in specs.items():
            t = tensors[name]
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(f"{cfg.name}: {name} is {tuple(t.shape)} "
                                 f"{t.dtype}, expected {tuple(shape)} "
                                 f"{dtype}")
            *path, leaf = name.split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = nn.Parameter(t, requires_grad=False)
        self.cfg = cfg
        for key, node in tree.items():
            if isinstance(node, dict):
                self.add_module(key, _node(node))
            else:
                self.register_parameter(key, node)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @staticmethod
    def stacked(group, i: int) -> dict:
        """Layer ``i`` of a ``ParameterDict`` of stacks: views."""
        return {k: t[i] for k, t in group.items()}


def _node(node: dict) -> nn.Module:
    if all(isinstance(v, dict) for v in node.values()):
        return nn.ModuleDict({k: _node(v) for k, v in node.items()})
    return nn.ParameterDict(node)


def remat(fn: Callable, enabled: bool | None, *args):
    """``fn(*args)``, recomputed in the backward pass (the counterpart of
    the reference's ``jax.checkpoint`` around each layer): only ``args``
    are kept for the backward, not the layer's activations.  ``enabled``
    None means where it matters: grad mode on and a tensor among ``args``
    (or one layer's dict of weights) requiring grad.  Inference runs
    ``fn`` as it is."""
    if enabled is None:
        enabled = torch.is_grad_enabled() and any(
            t.requires_grad for a in args
            for t in (a.values() if isinstance(a, dict) else (a,))
            if isinstance(t, torch.Tensor))
    if not enabled:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ----------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.to(torch.float32))).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim/2) in f32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exponent)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(torch.float32)
    s = sin[..., None, :].to(torch.float32)
    x1f, x2f = x1.to(torch.float32), x2.to(torch.float32)
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def softplus(x: torch.Tensor):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` takes log1p(exp(x)) below its threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def glu_ffn(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
            activation: str):
    """SwiGLU/GeGLU: w_in (d, 2, ff) fused gate+up, w_out (ff, d).  The
    activation runs in f32 and is cast to x's dtype before the product
    with ``up``."""
    from torch.distributed.tensor import DTensor

    if isinstance(w_in, DTensor):
        # on a mesh, the gate and up products apart: the fused product
        # reshapes (d, 2, ff) with ff over model into a strided layout
        # whose redistributions DTensor plans by a slow search
        gate, up = torch.matmul(x, w_in[:, 0]), torch.matmul(x, w_in[:, 1])
    else:
        h = torch.einsum("...d,dcf->...cf", x, w_in)
        gate, up = h[..., 0, :], h[..., 1, :]
    g = gate.to(torch.float32)
    act = F.silu(g) if activation == "swiglu" else F.gelu(
        g, approximate="tanh")
    hidden = act.to(x.dtype) * up
    return torch.einsum("...f,fd->...d", hidden, w_out)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token cross-entropy in f32: logsumexp minus the gold logit, the
    mean over the positions ``mask`` selects (at least one)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


# -------------------------------------------------------------------- init
def init_generator(seed: int, device, generator: torch.Generator | None):
    """(generator, device) of a family's ``init_params``: ``generator``
    where given (on its own device unless ``device`` says otherwise),
    else one seeded with ``seed`` on ``device``, the card by default."""
    if generator is None:
        dev = resolve_device(device)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        return generator, dev
    return generator, (generator.device if device is None
                       else resolve_device(device))


def _truncated_normal(shape, generator: torch.Generator,
                      device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, shape, dtype, in_axis: int = 0,
               device=None) -> torch.Tensor:
    """A normal truncated at +-2 in f32, times 1/sqrt(fan_in), cast to
    ``dtype``; drawn from ``generator`` on ``device`` (the generator's
    device by default)."""
    device = generator.device if device is None else device
    std = 1.0 / math.sqrt(shape[in_axis])
    return (_truncated_normal(shape, generator, device) * std).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype,
               device=None) -> torch.Tensor:
    device = generator.device if device is None else device
    return _truncated_normal(shape, generator, device).to(dtype)
