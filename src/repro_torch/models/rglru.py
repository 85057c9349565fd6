"""RecurrentGemma / Griffin hybrid, serving half: the port of
``repro/models/rglru.py`` for recurrentgemma-9b.

RG-LRU recurrent blocks and local attention in a repeating (rec, rec,
attn) pattern; layers that do not fill a pattern form a recurrent tail
(38 = 12 x (rec, rec, attn) + 2 rec).  The recurrence
h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t),  a_t = exp(-c r_t
softplus(lam)), runs over a prompt as ``jax.lax.associative_scan`` does
(its odd/even recursion, log2 L levels of whole-tensor products, in its
order of products) and as the O(1) step in decode.  Gates are
block-diagonal (n_heads blocks).  Each layer is a temporal block and a
GeGLU MLP, both pre-norm residual.

Parameters are an ``RGLRUParams`` module with the reference's pytree
(``supers.{rec1,rec2,attn}.*`` stacked over the superblocks, ``tail.*``
over the tail layers; ``ba``, ``bi`` and ``lam`` in f32).  The cache is
the reference's dict: per superblock the two conv windows and f32
states and the local-attention ring (``k``, ``v``), and the tail's
``tconv``/``th``; the recurrent entries are written in place.  As there,
``prefill`` keeps the prompt's last min(L, S) keys rolled by L % S, so a
prompt shorter than the cache's S slots leaves a ring of L slots, which
decode then treats as the whole ring (ROADMAP "Reference gaps").
Training: ``loss_fn``, the next-token loss, with each superblock and tail
layer recomputed in the backward pass where gradients are on; the scan's
emulated exp carries exp's gradient (``threefry._exp``).
Sharding: ``param_specs`` and ``cache_specs`` as the reference's (the
recurrence width, the gate blocks, the heads and the MLP width over
``model``); with ``rules`` the entry points run on DTensors, and the
training forward constrains each recurrent block's gated output over
``model`` and each layer's output over the data axes, as there; its
serving steps take ``rules`` and constrain nothing, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.threefry import _exp
from . import transformer as tfm
from .attention import attention, out_project, qkv_project, seq_update
from .common import (ArchConfig, MeshRules, P, StackedParams, constrain,
                     dense_init, embed_init, glu_ffn, init_generator,
                     logical_to_spec, on_mesh, remat as remat_layer,
                     rms_norm, softplus)
from .ssm import _causal_conv

__all__ = ["RGLRUParams", "param_shapes", "init_params", "param_specs",
           "cache_specs", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill"]

_C = 8.0  # Griffin's fixed gate sharpness
_F32 = ("ba", "bi", "lam")
PARTS = ("rec1", "rec2", "attn")


def _counts(cfg: ArchConfig):
    n_super = cfg.n_layers // 3
    return n_super, cfg.n_layers - 3 * n_super      # trailing rec layers


def _rec_shapes(cfg: ArchConfig) -> dict:
    d, w, nb, ff = cfg.d_model, cfg.rnn_width, cfg.n_heads, cfg.d_ff
    bs = w // nb
    return {"ln1": (d,), "wg": (d, w), "wx": (d, w),
            "conv_w": (cfg.ssm_conv, w), "conv_b": (w,), "wa": (nb, bs, bs),
            "ba": (w,), "wi": (nb, bs, bs), "bi": (w,), "lam": (w,),
            "wo": (w, d), "ln2": (d,), "w_in": (d, 2, ff), "w_out": (ff, d)}


def _attn_shapes(cfg: ArchConfig) -> dict:
    d, H, K, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    return {"ln1": (d,), "wq": (d, H, hd), "wk": (d, K, hd),
            "wv": (d, K, hd), "wo": (H, hd, d), "ln2": (d,),
            "w_in": (d, 2, ff), "w_out": (ff, d)}


def param_shapes(cfg: ArchConfig) -> dict:
    """Name -> shape of every tensor, as the reference's pytree holds it
    (``supers.*`` stacked over the superblocks, ``tail.*`` over the tail
    layers; no ``unembed``: its recurrentgemma ties the embedding)."""
    n_super, n_tail = _counts(cfg)
    shapes = {"embed": (cfg.vocab, cfg.d_model), "final_norm": (cfg.d_model,)}
    for part in PARTS:
        group = _attn_shapes(cfg) if part == "attn" else _rec_shapes(cfg)
        shapes.update({f"supers.{part}.{k}": (n_super, *s)
                       for k, s in group.items()})
    if n_tail:
        shapes.update({f"tail.{k}": (n_tail, *s)
                       for k, s in _rec_shapes(cfg).items()})
    return shapes


def _dtype(cfg: ArchConfig, name: str) -> torch.dtype:
    return torch.float32 if name.split(".")[-1] in _F32 else cfg.dtype


class RGLRUParams(StackedParams):
    """The weights of one hybrid model: ``embed``,
    ``final_norm``, ``supers`` (``rec1``, ``rec2``, ``attn``, each a
    ``ParameterDict`` of stacks over the superblocks) and, where the
    layers leave one, ``tail`` (stacks over the tail layers)."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__(cfg, tensors, {n: (s, _dtype(cfg, n)) for n, s in
                                        param_shapes(cfg).items()})

    def superblock(self, i: int) -> dict:
        """Superblock ``i``: part -> its tensors, views into the stacks."""
        return {part: self.stacked(self.supers[part], i) for part in PARTS}

    def tail_layer(self, i: int) -> dict:
        return self.stacked(self.tail, i)


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                generator: torch.Generator | None = None) -> RGLRUParams:
    """Random weights as the reference initializes them (norm gains and
    biases 0, truncated normals scaled by 1/sqrt(fan_in), the block-
    diagonal gates' fan-in their block size, the embedding unscaled, and
    ``lam`` such that a^c lies in [0.9, 0.999] at r = 1, from a uniform
    draw); drawn from ``generator`` or one seeded with ``seed``, on the
    card unless ``device`` says otherwise."""
    g, dev = init_generator(seed, device, generator)
    shapes = param_shapes(cfg)
    t = {name: torch.zeros(s, dtype=_dtype(cfg, name), device=dev)
         for name, s in shapes.items() if name != "embed"}
    t["embed"] = embed_init(g, shapes["embed"], cfg.dtype, device=dev)
    n_super, n_tail = _counts(cfg)
    stacks = [(f"supers.{part}.", i) for i in range(n_super)
              for part in PARTS] + [("tail.", i) for i in range(n_tail)]
    for prefix, i in stacks:
        for k in ("wg", "wx", "conv_w", "wa", "wi", "wo", "wq", "wk", "wv",
                  "w_in", "w_out"):
            name = prefix + k
            if name in t:
                t[name][i] = dense_init(g, shapes[name][1:], cfg.dtype,
                                        in_axis=1 if k in ("wa", "wi")
                                        else 0, device=dev)
        if prefix + "lam" in t:
            u = torch.empty(cfg.rnn_width, dtype=torch.float32, device=dev)
            u.uniform_(0.9 ** 2, 0.999 ** 2, generator=g)
            t[prefix + "lam"][i] = torch.log(torch.expm1(
                -torch.log(u) / (2.0 * _C)))
    return RGLRUParams(cfg, t)


# ------------------------------------------------------------------ blocks
def _rec_specs(cfg: ArchConfig, rules: MeshRules, L: int) -> dict:
    d, w, nb, ff = cfg.d_model, cfg.rnn_width, cfg.n_heads, cfg.d_ff

    def spec(*ax):
        return logical_to_spec(rules, *ax)

    return {
        "ln1": P(None, None),
        "wg": spec((None, L), (None, d), ("model", w)),
        "wx": spec((None, L), (None, d), ("model", w)),
        "conv_w": spec((None, L), (None, 0), ("model", w)),
        "conv_b": spec((None, L), ("model", w)),
        "wa": spec((None, L), ("model", nb), (None, 0), (None, 0)),
        "ba": spec((None, L), ("model", w)),
        "wi": spec((None, L), ("model", nb), (None, 0), (None, 0)),
        "bi": spec((None, L), ("model", w)),
        "lam": spec((None, L), ("model", w)),
        "wo": spec((None, L), ("model", w), (None, d)),
        "ln2": P(None, None),
        "w_in": spec((None, L), (None, d), (None, 2), ("model", ff)),
        "w_out": spec((None, L), ("model", ff), (None, d)),
    }


def _attn_specs(cfg: ArchConfig, rules: MeshRules, L: int) -> dict:
    d, H, K, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)

    def spec(*ax):
        return logical_to_spec(rules, *ax)

    return {
        "ln1": P(None, None),
        "wq": spec((None, L), (None, d), ("model", H), (None, hd)),
        "wk": spec((None, L), (None, d), ("model", K), (None, hd)),
        "wv": spec((None, L), (None, d), ("model", K), (None, hd)),
        "wo": spec((None, L), ("model", H), (None, hd), (None, d)),
        "ln2": P(None, None),
        "w_in": spec((None, L), (None, d), (None, 2), ("model", ff)),
        "w_out": spec((None, L), ("model", ff), (None, d)),
    }


def param_specs(cfg: ArchConfig, rules: MeshRules) -> dict:
    """Dotted name -> spec of every tensor of ``param_shapes``."""
    n_super, n_tail = _counts(cfg)
    specs = {"embed": logical_to_spec(rules, ("model", cfg.vocab),
                                      (None, cfg.d_model))}
    for part in PARTS:
        group = (_attn_specs if part == "attn" else _rec_specs)(
            cfg, rules, n_super)
        specs.update({f"supers.{part}.{k}": v for k, v in group.items()})
    specs["final_norm"] = P(None)
    if n_tail:
        specs.update({f"tail.{k}": v
                      for k, v in _rec_specs(cfg, rules, n_tail).items()})
    return specs


def cache_specs(cfg: ArchConfig, rules: MeshRules) -> dict:
    """The batch over the data axes, the recurrence width and the kv
    heads over ``model`` where they divide."""
    n_super, n_tail = _counts(cfg)
    w = cfg.rnn_width

    def spec(*ax):
        return logical_to_spec(rules, *ax)

    conv = spec((None, 0), ("data", 0), (None, 0), ("model", w))
    hsp = spec((None, 0), ("data", 0), ("model", w))
    kv = spec((None, 0), ("data", 0), (None, 0),
              ("model", cfg.n_kv_heads), (None, 0))
    out = {"conv1": conv, "h1": hsp, "conv2": conv, "h2": hsp,
           "k": kv, "v": kv}
    if n_tail:
        out["tconv"] = conv
        out["th"] = hsp
    return out


def _blockdiag(x, w, b):
    """x: (..., width) -> block-diagonal linear; w: (nb, bs, bs).  The f32
    bias is cast to x's dtype before the add."""
    nb, bs, _ = w.shape
    xh = x.reshape(*x.shape[:-1], nb, bs)
    y = torch.einsum("...nb,nbc->...nc", xh, w)
    return y.reshape(x.shape) + b.to(x.dtype)


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even at positions 0, 2, ... and odd at 1, 3, ... of axis 1."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1],
                          *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """``jax.lax.associative_scan(_combine, (a, b), axis=1)`` in its
    order: combine adjacent pairs, scan those recursively (the odd
    outputs), combine each with the next even input (the even outputs),
    interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                         (a[:, 1::2], b[:, 1::2])))
    last = -1 if n % 2 == 0 else None
    ea, eb = _combine((oa[:, :last], ob[:, :last]), (a[:, 2::2], b[:, 2::2]))
    return (_interleave(torch.cat([a[:, :1], ea], dim=1), oa),
            _interleave(torch.cat([b[:, :1], eb], dim=1), ob))


def _rglru_scan(x, r, i, lam):
    """x/r/i: (B, L, w); lam: (w,).  Full-sequence linear recurrence
    (f32), h (B, L, w).  exp is XLA's, bit for bit: 1 - exp(2 log a)
    cancels where a nears 1, which would magnify an ulp of exp."""
    log_a = -_C * r * softplus(lam.to(torch.float32))
    a = _exp(log_a)
    # the reference's jnp.maximum splits the gradient 0.5/0.5 at an exact
    # tie with 1e-12; clamp_min passes all of it (no input meets the tie)
    gated = torch.sqrt(torch.clamp_min(1.0 - _exp(2.0 * log_a),
                                       1e-12)) * (i * x)
    return _associative_scan(a, gated)[1]


def _rec_mix(x, lp: dict):
    """The recurrent block's f32 states h (B, L, w) and GELU gate, and its
    input u before the conv (the conv cache's source)."""
    gate = F.gelu(torch.matmul(x, lp["wg"]).to(torch.float32),
                  approximate="tanh")
    u = torch.matmul(x, lp["wx"])
    conv = _causal_conv(u, lp["conv_w"], lp["conv_b"])
    r = torch.sigmoid(_blockdiag(conv, lp["wa"], lp["ba"])
                      .to(torch.float32))
    i = torch.sigmoid(_blockdiag(conv, lp["wi"], lp["bi"])
                      .to(torch.float32))
    return _rglru_scan(conv.to(torch.float32), r, i, lp["lam"]), gate, u


def _mlp(x, lp: dict, cfg: ArchConfig, rules=None):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + glu_ffn(h, lp["w_in"], lp["w_out"], cfg.activation)
    if rules is not None:
        x = constrain(x, tfm.data_spec(rules))
    return x


def _rec_layer(x, lp: dict, cfg: ArchConfig, rules=None):
    """A recurrent layer: (output, its conv tail (B, K-1, w), its last
    state (B, w))."""
    hs, gate, u = _rec_mix(rms_norm(x, lp["ln1"], cfg.norm_eps), lp)
    y = (hs * gate).to(x.dtype)
    if rules is not None:
        y = constrain(y, P(rules.data, None, rules.model(cfg.rnn_width)))
    x = x + torch.matmul(y, lp["wo"])
    return (_mlp(x, lp, cfg, rules), u[:, -(cfg.ssm_conv - 1):, :],
            hs[:, -1, :])


def _attn_layer(x, lp: dict, cfg: ArchConfig, positions, q_chunk: int,
                rules=None):
    """A local-attention layer: (output, its keys, its values)."""
    hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(hn, lp["wq"], lp["wk"], lp["wv"], cfg, positions)
    o = attention(q, k, v, positions, positions, cfg, causal=True,
                  window=cfg.local_window, q_chunk=q_chunk)
    return _mlp(x + out_project(o, lp["wo"]), lp, cfg, rules), k, v


# ----------------------------------------------------------------- forward
def forward(params: RGLRUParams, x, cfg: ArchConfig, positions, rules=None,
            remat: bool | None = None, q_chunk: int = 512):
    """x: (B, L, d) embedded input -> final hidden states (B, L, d).
    ``remat``: recompute each superblock and each tail layer in the
    backward pass (None: where gradients are on)."""
    def superblock(h, rec1, rec2, attn):
        h = _rec_layer(h, rec1, cfg, rules)[0]
        h = _rec_layer(h, rec2, cfg, rules)[0]
        return _attn_layer(h, attn, cfg, positions, q_chunk, rules)[0]

    def tail_layer(h, lp):
        return _rec_layer(h, lp, cfg, rules)[0]

    n_super, n_tail = _counts(cfg)
    with on_mesh(rules):
        for s in range(n_super):
            sp = params.superblock(s)
            x = remat_layer(superblock, remat, x, *(sp[p] for p in PARTS))
        for i in range(n_tail):
            x = remat_layer(tail_layer, remat, x, params.tail_layer(i))
        return rms_norm(x, params.final_norm, cfg.norm_eps)


def loss_fn(params: RGLRUParams, batch: dict, cfg: ArchConfig, rules=None,
            remat: bool | None = None, q_chunk: int = 512):
    """The next-token loss of ``batch["tokens"]`` (an optional bool
    ``mask`` selects the positions), f32."""
    with on_mesh(rules):
        tokens = batch["tokens"]
        x = tfm.embed_tokens(params, tokens, cfg)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)
        h = forward(params, x, cfg, positions, rules, remat=remat,
                    q_chunk=q_chunk)
        labels, lmask = tfm.shifted_labels(tokens)
        if "mask" in batch:
            lmask = lmask & batch["mask"]
        return tfm.chunked_ce_loss(params, h, labels, cfg, mask=lmask,
                                   rules=rules)


# ---------------------------------------------------------------- serving
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> dict:
    """The reference's zero cache: per superblock ``conv1``/``conv2``
    (B, K-1, w) in the config's dtype, ``h1``/``h2`` (B, w) f32 and the
    local-attention ring ``k``/``v`` (B, S, n_kv, hd), S = min(max_len,
    local_window); per tail layer ``tconv``/``th``.  On the card unless
    ``device`` says otherwise."""
    n_super, n_tail = _counts(cfg)
    w, K = cfg.rnn_width, cfg.ssm_conv
    S = min(max_len, cfg.local_window)
    dev = resolve_device(device)

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache = {"conv1": zeros(n_super, batch, K - 1, w),
             "h1": zeros(n_super, batch, w, dtype=torch.float32),
             "conv2": zeros(n_super, batch, K - 1, w),
             "h2": zeros(n_super, batch, w, dtype=torch.float32),
             "k": zeros(n_super, batch, S, cfg.n_kv_heads, cfg.head_dim),
             "v": zeros(n_super, batch, S, cfg.n_kv_heads, cfg.head_dim)}
    if n_tail:
        cache["tconv"] = zeros(n_tail, batch, K - 1, w)
        cache["th"] = zeros(n_tail, batch, w, dtype=torch.float32)
    return cache


def _rec_step(x1, conv_st, h_st, lp: dict):
    """One-token RG-LRU step. x1: (B, d).  Returns (y1, conv_st, h_st)."""
    f32 = torch.float32
    gate = F.gelu((x1 @ lp["wg"]).to(f32), approximate="tanh")
    u = x1 @ lp["wx"]                                           # (B, w)
    window = torch.cat([conv_st, u[:, None, :]], dim=1)         # (B, K, w)
    conv = torch.einsum("bkw,kw->bw", window, lp["conv_w"]) + lp["conv_b"]
    r = torch.sigmoid(_blockdiag(conv, lp["wa"], lp["ba"]).to(f32))
    i = torch.sigmoid(_blockdiag(conv, lp["wi"], lp["bi"]).to(f32))
    a = _exp(-_C * r * softplus(lp["lam"].to(f32)))     # as in the scan
    h_st = a * h_st + torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        i * conv.to(f32))
    return (h_st * gate).to(x1.dtype) @ lp["wo"], window[:, 1:, :], h_st


def _rec_layer_step(h, lp: dict, cfg: ArchConfig, conv, state):
    """A recurrent layer's decode step; its conv window and state
    (views into the cache) updated in place."""
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    y, conv_new, state_new = _rec_step(hn[:, 0, :], conv, state, lp)
    conv.copy_(conv_new)
    state.copy_(state_new)
    return _mlp(h + y[:, None, :], lp, cfg)


def _attn_layer_step(h, lp: dict, cfg: ArchConfig, kc, vc, pos: int):
    """A local-attention layer's decode step on its ring (B, S, n_kv, hd),
    written in place at slot pos % S."""
    B, S = kc.shape[:2]
    dev = kc.device
    slot = pos % S
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=dev)
    idx = torch.arange(S, dtype=torch.int32, device=dev)
    k_pos = torch.where(idx <= slot, pos - slot + idx, pos - slot - S + idx)
    k_valid = ((k_pos >= 0) & (k_pos <= pos)).expand(B, S)
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    q, k_new, v_new = qkv_project(hn, lp["wq"], lp["wk"], lp["wv"], cfg,
                                  q_pos)
    seq_update(kc, k_new, slot)
    seq_update(vc, v_new, slot)
    o = attention(q, kc, vc, q_pos, k_pos, cfg, causal=True,
                  window=cfg.local_window, k_valid=k_valid)
    return _mlp(h + out_project(o, lp["wo"]), lp, cfg)


def decode_step(params: RGLRUParams, cache: dict, tokens, pos: int,
                cfg: ArchConfig, rules=None):
    """One decode step: tokens (B, 1) at absolute position ``pos``.
    Updates ``cache`` in place; returns (f32 logits (B, V), cache)."""
    with on_mesh(rules):
        return _decode(params, cache, tokens, pos, cfg)


def _decode(params, cache, tokens, pos, cfg):
    pos = int(pos)
    n_super, n_tail = _counts(cfg)
    h = tfm.embed_tokens(params, tokens, cfg)                  # (B, 1, d)
    for s in range(n_super):
        sp = params.superblock(s)
        h = _rec_layer_step(h, sp["rec1"], cfg, cache["conv1"][s],
                            cache["h1"][s])
        h = _rec_layer_step(h, sp["rec2"], cfg, cache["conv2"][s],
                            cache["h2"][s])
        h = _attn_layer_step(h, sp["attn"], cfg, cache["k"][s],
                             cache["v"][s], pos)
    for i in range(n_tail):
        h = _rec_layer_step(h, params.tail_layer(i), cfg, cache["tconv"][i],
                            cache["th"][i])
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return tfm.logits_at(params, h[:, -1, :], cfg), cache


def prefill(params: RGLRUParams, tokens, cfg: ArchConfig, cache: dict,
            rules=None, q_chunk: int = 512):
    """Prompt pass.  The recurrent states and conv windows are written
    into ``cache`` in place; the ring becomes each attention layer's last
    min(L, S) keys and values rolled by L % S (slot of position p: p % S),
    a new tensor, so a prompt shorter than S leaves a ring of L slots, as
    the reference's does.  Returns (last-position f32 logits (B, V), the
    cache)."""
    with on_mesh(rules):
        return _prefill(params, tokens, cfg, cache, q_chunk)


def _prefill(params, tokens, cfg, cache, q_chunk):
    L = tokens.shape[1]
    n_super, n_tail = _counts(cfg)
    h = tfm.embed_tokens(params, tokens, cfg)
    positions = torch.arange(L, dtype=torch.int32, device=h.device)
    S = cache["k"].shape[2]
    ring = {"k": [], "v": []}
    for s in range(n_super):
        sp = params.superblock(s)
        for part, conv, state in (("rec1", "conv1", "h1"),
                                  ("rec2", "conv2", "h2")):
            h, cache[conv][s], cache[state][s] = _rec_layer(h, sp[part], cfg)
        h, k_new, v_new = _attn_layer(h, sp["attn"], cfg, positions,
                                      q_chunk)
        for name, new in (("k", k_new), ("v", v_new)):
            ring[name].append(torch.roll(new[:, -S:], L % S, dims=1)
                              .to(cache[name].dtype))
    for i in range(n_tail):
        h, cache["tconv"][i], cache["th"][i] = _rec_layer(
            h, params.tail_layer(i), cfg)
    for name in ("k", "v"):
        cache[name] = (torch.stack(ring[name]) if n_super
                       else cache[name][:, :, :min(L, S)])
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return tfm.logits_at(params, h[:, -1, :], cfg), cache
