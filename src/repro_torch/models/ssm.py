"""Mamba-2 (SSD, state-space duality), serving half: the port of
``repro/models/ssm.py`` for mamba2-130m.

The recurrence  h_t = a_t h_{t-1} + dt_t B_t x_t^T,  y_t = C_t . h_t  runs
in the paper's chunked dual form over a prompt (within a chunk of Q an
attention-like masked product, across chunks a carried (H, P, N) state)
and as the O(1) recurrent step in decode.  d_inner = expand * d_model, H
heads of head_dim P, one shared B/C group, state N.

Parameters are an ``SSMParams`` module with the reference's pytree
shapes (``layers.*`` stacked on axis 0; ``A_log``, ``D`` and ``dt_bias``
in f32).  ``init_params`` gives ``A_log``, ``D`` and ``dt_bias`` bit for
bit as the reference computes them, which is not a draw.  The cache is a
dict ``{"conv": (layers, B, K-1, conv_dim), "state": (layers, B, H, P,
N) f32}``, written in place.  As there, ``prefill`` takes the final
state from a cumsum over the whole prompt, not from the chunk scan's
carry, a prompt must be a multiple of ``ssm_chunk`` long (``ValueError``
where the reference asserts), and ``decode_step`` ignores ``pos``.
Training: ``loss_fn``, the next-token loss (an optional ``mask``), with
each layer recomputed in the backward pass where gradients are on.
Sharding: ``param_specs`` and ``cache_specs`` as the reference's (the
heads and the inner width over ``model``; ``wxbc`` and the conv
replicated, since the conv's width mixes x, B and C); with ``rules`` the
entry points run on DTensors, the x heads constrained over ``model``
before the SSD and each layer's output over the data axes, as there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from . import transformer as tfm
from .common import (ArchConfig, MeshRules, P, StackedParams, constrain,
                     dense_init, embed_init, init_generator,
                     logical_to_spec, on_mesh, remat as remat_layer,
                     rms_norm, softplus)

__all__ = ["SSMParams", "param_shapes", "init_params", "param_specs",
           "cache_specs", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill"]

LAYER_KEYS = ("ln", "wz", "wxbc", "wdt", "conv_w", "conv_b", "A_log", "D",
              "dt_bias", "gnorm", "wo")
_F32 = ("A_log", "D", "dt_bias")


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    G = 1                                   # mamba2 default: one BC group
    conv_dim = d_inner + 2 * G * N
    return d_inner, H, cfg.ssm_head_dim, N, G, conv_dim


def param_shapes(cfg: ArchConfig) -> dict:
    """Name -> shape of every tensor, as the reference's pytree holds it
    (no ``unembed``: its mamba2 ties the embedding)."""
    d = cfg.d_model
    d_inner, H, _, _, _, conv_dim = _dims(cfg)
    shapes = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    shapes.update({f"layers.{k}": (cfg.n_layers, *s) for k, s in (
        ("ln", (d,)), ("wz", (d, d_inner)), ("wxbc", (d, conv_dim)),
        ("wdt", (d, H)), ("conv_w", (cfg.ssm_conv, conv_dim)),
        ("conv_b", (conv_dim,)), ("A_log", (H,)), ("D", (H,)),
        ("dt_bias", (H,)), ("gnorm", (d_inner,)), ("wo", (d_inner, d)))})
    return shapes


def _dtype(cfg: ArchConfig, name: str) -> torch.dtype:
    return torch.float32 if name.split(".")[-1] in _F32 else cfg.dtype


class SSMParams(StackedParams):
    """The weights of one mamba2 model: ``embed``,
    ``final_norm`` and ``layers`` holding each of ``LAYER_KEYS`` stacked
    over the layers."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__(cfg, tensors, {n: (s, _dtype(cfg, n)) for n, s in
                                        param_shapes(cfg).items()})

    def layer(self, i: int) -> dict:
        """Layer ``i``'s tensors: views into the stacks."""
        return self.stacked(self.layers, i)


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                generator: torch.Generator | None = None) -> SSMParams:
    """Random weights as the reference initializes them (norm gains and
    ``conv_b`` 0, truncated normals scaled by 1/sqrt(the first axis), the
    embedding unscaled) and its fixed ``A_log`` = log(linspace(1, 16,
    H)), ``D`` = 1 and ``dt_bias`` = log(expm1(0.01)), bit for bit: the
    reference computes them in f64 (the JAX package enables x64) and
    rounds to f32, as here.  Drawn from ``generator`` or one seeded with
    ``seed``, on the card unless ``device`` says otherwise."""
    g, dev = init_generator(seed, device, generator)
    shapes = param_shapes(cfg)
    H = shapes["layers.D"][1]
    t = {"embed": embed_init(g, shapes["embed"], cfg.dtype, device=dev),
         "final_norm": torch.zeros(shapes["final_norm"], dtype=cfg.dtype,
                                   device=dev)}
    for k in LAYER_KEYS:
        name = f"layers.{k}"
        t[name] = torch.zeros(shapes[name], dtype=_dtype(cfg, name),
                              device=dev)
    t["layers.A_log"][:] = torch.log(torch.linspace(
        1.0, 16.0, H, dtype=torch.float64)).to(torch.float32).to(dev)
    t["layers.D"][:] = 1.0
    t["layers.dt_bias"][:] = math.log(math.expm1(0.01))
    for i in range(cfg.n_layers):
        for k in ("wz", "wxbc", "wdt", "conv_w", "wo"):
            name = f"layers.{k}"
            t[name][i] = dense_init(g, shapes[name][1:], cfg.dtype,
                                    device=dev)
    return SSMParams(cfg, t)


def param_specs(cfg: ArchConfig, rules: MeshRules) -> dict:
    """Dotted name -> spec of every tensor of ``param_shapes``."""
    d = cfg.d_model
    d_inner, H, _, _, _, _ = _dims(cfg)
    L = cfg.n_layers

    def spec(*ax):
        return logical_to_spec(rules, *ax)

    layers = {
        "ln": P(None, None),
        "wz": spec((None, L), (None, d), ("model", d_inner)),
        "wxbc": P(None, None, None),   # conv_dim mixes x/B/C: replicate
        "wdt": spec((None, L), (None, d), ("model", H)),
        "conv_w": P(None, None, None),
        "conv_b": P(None, None),
        "A_log": spec((None, L), ("model", H)),
        "D": spec((None, L), ("model", H)),
        "dt_bias": spec((None, L), ("model", H)),
        "gnorm": spec((None, L), ("model", d_inner)),
        "wo": spec((None, L), ("model", d_inner), (None, d)),
    }
    specs = {"embed": spec(("model", cfg.vocab), (None, d))}
    specs.update({f"layers.{k}": v for k, v in layers.items()})
    specs["final_norm"] = P(None)
    return specs


def _cumsum_seq(x):
    """The cumulative sum over dim 1.  On a DTensor, shard by shard
    (``local_map``, dim 1 gathered where sharded): torch 2.11's DTensor
    has no rule for the ``flip`` of cumsum's backward."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(x, DTensor):
        return torch.cumsum(x, dim=1)
    placements = [Replicate() if isinstance(p, Shard)
                  and p.dim % x.ndim == 1 else p for p in x.placements]
    cumsum = local_map(lambda t: torch.cumsum(t, dim=1),
                       out_placements=placements, in_placements=(placements,),
                       device_mesh=x.device_mesh, redistribute_inputs=True)
    return cumsum(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv1d, tap by tap in x's dtype. x: (B, L, C);
    w: (K, C)."""
    from torch.distributed.tensor import DTensor

    K, L = w.shape[0], x.shape[1]
    if isinstance(x, DTensor):
        # zeros on x's own placements: F.pad's redistribution plan fails
        # in torch 2.11's DTensor
        xp = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, K - 1, -1), x],
                       dim=1)
    else:
        xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + L, :] * w[k]
    return out + b


def _ssd_chunked(xh, dtv, Bm, Cm, A_log, Q: int):
    """Chunked SSD scan.

    xh: (B, L, H, P) inputs; dtv: (B, L, H) discretization (post-softplus);
    Bm/Cm: (B, L, G, N); A_log: (H,).  Returns y: (B, L, H, P) in f32.
    L must be a multiple of Q.
    """
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the SSD "
                         f"chunk {Q} (the reference asserts it)")
    nc = L // Q
    hpg = H // G
    f32 = torch.float32
    xf = xh.to(f32).reshape(Bsz, nc, Q, H, P)
    dtf = dtv.to(f32).reshape(Bsz, nc, Q, H)
    Bf = Bm.to(f32).reshape(Bsz, nc, Q, G, N)
    Cf = Cm.to(f32).reshape(Bsz, nc, Q, G, N)
    neg_A = -torch.exp(A_log.to(f32))                        # (H,)
    iota = torch.arange(Q, device=xh.device)
    causal = (iota[:, None] >= iota[None, :])[None, :, :, None]
    state = torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
    ys = []
    for c in range(nc):
        x_c, dt_c, B_c, C_c = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        la = dt_c * neg_A                    # log a_t  (B, Q, H)
        cum = _cumsum_seq(la)
        # intra-chunk: decay matrix L[i, j] = exp(cum_i - cum_j), j <= i.
        # Masked before the exp: above the diagonal cum_i - cum_j > 0 may
        # overflow, and exp's gradient there, 0 * inf, would be NaN (the
        # reference masks after it; its forward values are the same)
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # (B, Q, Q, H)
        decay = torch.exp(torch.where(causal, diff, float("-inf")))
        CB = torch.einsum("bign,bjgn->bijg", C_c, B_c)
        CB = CB.repeat_interleave(hpg, dim=-1)               # (B, Q, Q, H)
        att = decay * CB * dt_c[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", att, x_c)
        # inter-chunk: the carried state's contribution
        Ch = C_c.repeat_interleave(hpg, dim=2)               # (B, Q, H, N)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bihn,bhpn->bihp", Ch, state)
        # S <- exp(cum_Q) S + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
        tail = torch.exp(cum[:, -1:, :] - cum) * dt_c        # (B, Q, H)
        Bh = B_c.repeat_interleave(hpg, dim=2)               # (B, Q, H, N)
        state = (torch.exp(cum[:, -1, :])[..., None, None] * state
                 + torch.einsum("bjh,bjhn,bjhp->bhpn", tail, Bh, x_c))
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(Bsz, L, H, P)


def _project(x, lp: dict, cfg: ArchConfig):
    """The block's input projections and conv: (z, xbc before the conv,
    x heads, B, C, dt after softplus)."""
    B, L, _ = x.shape
    d_inner, H, P, N, G, _ = _dims(cfg)
    z = torch.matmul(x, lp["wz"])
    xbc_in = torch.matmul(x, lp["wxbc"])
    dt_raw = torch.matmul(x, lp["wdt"])
    xbc = _causal_conv(xbc_in, lp["conv_w"], lp["conv_b"])
    xbc = F.silu(xbc.to(torch.float32)).to(x.dtype)
    xs = xbc[..., :d_inner].reshape(B, L, H, P)
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(B, L, G, N)
    Cm = xbc[..., d_inner + G * N:].reshape(B, L, G, N)
    dtv = softplus(dt_raw.to(torch.float32) + lp["dt_bias"])
    return z, xbc_in, xs, Bm, Cm, dtv


def _gate_out(y, xs, z, lp: dict, cfg: ArchConfig, dtype, rules=None):
    """D skip, the silu(z) gate, the group norm and the out projection of
    the f32 SSD output y (B, L, H, P)."""
    B, L = y.shape[:2]
    y = y + lp["D"][:, None] * xs.to(torch.float32)
    y = y.reshape(B, L, -1).to(dtype)
    if rules is not None:
        # the inner width sharded as z's: the gradient then reaches the
        # (heads, head_dim) view as the heads lie, which torch 2.11's
        # DTensor needs where they do not divide the model axis (mamba2)
        y = constrain(y, P(rules.data, None, rules.model(y.shape[-1])))
    y = y * F.silu(z.to(torch.float32)).to(dtype)
    y = rms_norm(y, lp["gnorm"], cfg.norm_eps)
    return torch.matmul(y, lp["wo"])


def _mix(x, lp: dict, cfg: ArchConfig, rules: MeshRules | None = None):
    """One mamba2 mixing block (the pre-norm residual is the caller's)."""
    z, _, xs, Bm, Cm, dtv = _project(x, lp, cfg)
    if rules is not None:
        xs = constrain(xs, P(rules.data, None, rules.model(_dims(cfg)[1]),
                             None))
    y = _ssd_chunked(xs, dtv, Bm, Cm, lp["A_log"], cfg.ssm_chunk)
    return _gate_out(y, xs, z, lp, cfg, x.dtype, rules)


def forward(params: SSMParams, x, cfg: ArchConfig, rules=None,
            remat: bool | None = None):
    """x: (B, L, d) embedded input -> final hidden states (B, L, d).
    ``remat``: recompute each layer in the backward pass (None: where
    gradients are on)."""
    def layer(h, lp):
        h = h + _mix(rms_norm(h, lp["ln"], cfg.norm_eps), lp, cfg, rules)
        if rules is not None:
            h = constrain(h, tfm.data_spec(rules))
        return h

    with on_mesh(rules):
        for i in range(cfg.n_layers):
            x = remat_layer(layer, remat, x, params.layer(i))
        return rms_norm(x, params.final_norm, cfg.norm_eps)


def loss_fn(params: SSMParams, batch: dict, cfg: ArchConfig, rules=None,
            remat: bool | None = None, q_chunk: int = 512):
    """The next-token loss of ``batch["tokens"]`` (an optional bool
    ``mask`` selects the positions), f32.  The sequence must be a
    multiple of ``ssm_chunk`` (``ValueError``).  ``q_chunk`` is unused
    (no attention)."""
    with on_mesh(rules):
        tokens = batch["tokens"]
        x = tfm.embed_tokens(params, tokens, cfg)
        h = forward(params, x, cfg, rules, remat=remat)
        labels, lmask = tfm.shifted_labels(tokens)
        if "mask" in batch:
            lmask = lmask & batch["mask"]
        return tfm.chunked_ce_loss(params, h, labels, cfg, mask=lmask,
                                   rules=rules)


# ---------------------------------------------------------------- serving
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeros ``{"conv": (layers, B, K-1, conv_dim)`` in the config's dtype,
    ``"state": (layers, B, H, P, N)`` f32}, whatever ``max_len``; on the
    card unless ``device`` says otherwise."""
    _, H, P, N, _, conv_dim = _dims(cfg)
    dev = resolve_device(device)
    return {"conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                                 conv_dim), dtype=cfg.dtype, device=dev),
            "state": torch.zeros((cfg.n_layers, batch, H, P, N),
                                 dtype=torch.float32, device=dev)}


def cache_specs(cfg: ArchConfig, rules: MeshRules) -> dict:
    """The batch over the data axes, the state's heads over ``model``."""
    H = _dims(cfg)[1]
    return {
        "conv": logical_to_spec(rules, (None, cfg.n_layers), ("data", 0),
                                (None, 0), (None, 0)),
        "state": logical_to_spec(rules, (None, cfg.n_layers), ("data", 0),
                                 ("model", H), (None, 0), (None, 0)),
    }


def _mix_step(x1, conv_st, state, lp: dict, cfg: ArchConfig):
    """One-token recurrent step. x1: (B, d).  Returns (y1, conv_st,
    state)."""
    B = x1.shape[0]
    d_inner, H, P, N, G, _ = _dims(cfg)
    f32 = torch.float32
    z = x1 @ lp["wz"]
    xbc = x1 @ lp["wxbc"]                                  # (B, conv_dim)
    dt_raw = x1 @ lp["wdt"]
    window = torch.cat([conv_st, xbc[:, None, :]], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window, lp["conv_w"]) \
        + lp["conv_b"]
    conv_out = F.silu(conv_out.to(f32)).to(x1.dtype)
    xs = conv_out[:, :d_inner].reshape(B, H, P).to(f32)
    Bm = conv_out[:, d_inner:d_inner + G * N].reshape(B, G, N).to(f32)
    Cm = conv_out[:, d_inner + G * N:].reshape(B, G, N).to(f32)
    dtv = softplus(dt_raw.to(f32) + lp["dt_bias"])
    a = torch.exp(-torch.exp(lp["A_log"].to(f32)) * dtv)
    Bh = Bm.repeat_interleave(H // G, dim=1)               # (B, H, N)
    Ch = Cm.repeat_interleave(H // G, dim=1)
    state = a[..., None, None] * state + (dtv[..., None, None]
                                          * Bh[:, :, None, :]
                                          * xs[..., None])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + lp["D"][:, None] * xs
    y = y.reshape(B, d_inner).to(x1.dtype)
    y = y * F.silu(z.to(f32)).to(x1.dtype)
    y = rms_norm(y, lp["gnorm"], cfg.norm_eps)
    return y @ lp["wo"], window[:, 1:, :], state


def decode_step(params: SSMParams, cache: dict, tokens, pos,
                cfg: ArchConfig, rules=None):
    """tokens: (B, 1).  ``pos`` is unused (the state has no position).
    Updates ``cache`` in place; returns (f32 logits (B, V), cache)."""
    with on_mesh(rules):
        return _decode(params, cache, tokens, cfg)


def _decode(params, cache, tokens, cfg):
    h = tfm.embed_tokens(params, tokens, cfg)[:, 0, :]      # (B, d)
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        hn = rms_norm(h, lp["ln"], cfg.norm_eps)
        y, conv, state = _mix_step(hn, cache["conv"][i], cache["state"][i],
                                   lp, cfg)
        cache["conv"][i] = conv
        cache["state"][i] = state
        h = h + y
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return tfm.logits_at(params, h, cfg), cache


def prefill(params: SSMParams, tokens, cfg: ArchConfig, cache: dict,
            rules=None, q_chunk: int = 512):
    """Prompt pass through the chunked SSD; each layer's trailing conv
    inputs and final state written into ``cache`` in place.  Returns
    (last-position f32 logits (B, V), cache).  ``q_chunk`` is unused
    (no attention)."""
    with on_mesh(rules):
        return _prefill(params, tokens, cfg, cache)


def _prefill(params, tokens, cfg, cache):
    B, L = tokens.shape
    H = _dims(cfg)[1]
    h = tfm.embed_tokens(params, tokens, cfg)
    f32 = torch.float32
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        hn = rms_norm(h, lp["ln"], cfg.norm_eps)
        z, xbc_in, xs, Bm, Cm, dtv = _project(hn, lp, cfg)
        cache["conv"][i] = xbc_in[:, -(cfg.ssm_conv - 1):, :]
        y = _ssd_chunked(xs, dtv, Bm, Cm, lp["A_log"], cfg.ssm_chunk)
        # the final state from one pass over the whole prompt
        la = dtv * (-torch.exp(lp["A_log"].to(f32)))
        cum = torch.cumsum(la, dim=1)
        tailw = torch.exp(cum[:, -1:, :] - cum) * dtv
        Bh = Bm.to(f32).repeat_interleave(H // Bm.shape[2], dim=2)
        cache["state"][i] = torch.einsum("bjh,bjhn,bjhp->bhpn", tailw, Bh,
                                         xs.to(f32))
        h = h + _gate_out(y, xs, z, lp, cfg, h.dtype)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return tfm.logits_at(params, h[:, -1, :], cfg), cache
