"""Shared model config, layers and init: the port of
``repro/models/common.py``.

Parameters are stored in the config's dtype (bf16 by default); norms,
RoPE, the GLU activation and softmax compute in f32 and cast back, at
the same points as the reference.  ``StackedParams`` holds any family's
weights under the reference's pytree names.  The sharding helpers
(``MeshRules``, ``logical_to_spec``, ``constrain``) and the dry-run's
``mscan`` are not ported: they wait for the tooling and the multi-card
mesh (ROADMAP Queue A items 11 and 9b).  ``cross_entropy`` and ``remat``
serve training: the loss in f32, and a layer recomputed in the backward
pass where gradients are on.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..core.device import resolve_device

__all__ = ["ArchConfig", "StackedParams", "rms_norm", "rope_angles",
           "apply_rope", "softcap", "softplus", "glu_ffn", "cross_entropy",
           "remat", "init_generator", "dense_init", "embed_init"]


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
