"""Mixture-of-Experts family, serving half: the port of
``repro/models/moe.py`` for granite-moe-3b-a800m (40 experts padded to 48,
top-8) and qwen3-moe-30b-a3b (128 experts, top-8).

Dispatch is sort-based, as there: the token -> expert assignments are
sorted by expert id (stably), ranked within their expert, dropped past
the capacity C, and gathered into an (Ep, C, d) buffer that feeds one
batched product per FFN matrix; a Switch load-balancing aux loss comes
back beside the output.  Left-pad tokens are routed and take capacity
like any other, and a dropped assignment's weight is not renormalised
away, as there.  ``DISPATCH_MODE`` picks the reference's two
formulations: ``"gather"`` (the default: only the int slot map is
scattered, the combine is a per-token gather summed in f32) and
``"scatter"`` (the buffer written by a scatter, the combine an
``index_add_`` in the activations' dtype, whose order of additions is
not fixed on the card).

Parameters are a ``MoEParams`` module with the reference's pytree shapes
(``layers.*`` stacked on axis 0, the expert weights padded to
``max(n_experts_padded, n_experts)``, the router in f32), so
``repro_torch.carry.model_params`` moves the reference's weights across
unchanged.  The attention half and the cache are the dense family's
(``models/transformer.py``).  Training: ``loss_fn``, the next-token loss
plus the aux loss (its mean over the layers, times ``aux_weight``); both
dispatch modes carry gradients (the drop slot's gradient is 0: its row is
cut off the buffer), and ``forward`` recomputes each layer in the
backward pass where gradients are on.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..analysis.audit import audit_determinism
from . import transformer as tfm
from .attention import KVCache, attention, out_project, qkv_project, seq_update
from .common import (ArchConfig, StackedParams, dense_init, embed_init,
                     init_generator, remat as remat_layer, rms_norm)

__all__ = ["MoEParams", "param_shapes", "init_params", "DISPATCH_MODE",
           "dispatch_mode", "capacity", "moe_ffn", "forward", "loss_fn",
           "decode_step", "prefill"]

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "router", "w_gate",
              "w_up", "w_down")


def _padded_experts(cfg: ArchConfig) -> int:
    return max(cfg.n_experts_padded, cfg.n_experts)


def param_shapes(cfg: ArchConfig) -> dict:
    """Name -> shape of every tensor, as the reference's pytree holds it
    (``layers.*`` stacked on a leading axis of ``n_layers``)."""
    d, H, K, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    Ep = _padded_experts(cfg)
    shapes = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    shapes.update({f"layers.{k}": (cfg.n_layers, *s) for k, s in (
        ("ln1", (d,)), ("wq", (d, H, hd)), ("wk", (d, K, hd)),
        ("wv", (d, K, hd)), ("wo", (H, hd, d)), ("ln2", (d,)),
        ("router", (d, cfg.n_experts)), ("w_gate", (Ep, d, ff)),
        ("w_up", (Ep, d, ff)), ("w_down", (Ep, ff, d)))})
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab)
    return shapes


def _dtype(cfg: ArchConfig, name: str) -> torch.dtype:
    return torch.float32 if name == "layers.router" else cfg.dtype


class MoEParams(StackedParams):
    """The weights of one MoE-family model: ``embed``,
    ``final_norm``, optional ``unembed``, and ``layers`` holding each of
    ``LAYER_KEYS`` stacked over the layers."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__(cfg, tensors, {n: (s, _dtype(cfg, n)) for n, s in
                                        param_shapes(cfg).items()})

    def layer(self, i: int) -> dict:
        """Layer ``i``'s tensors: views into the stacks."""
        return self.stacked(self.layers, i)


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                generator: torch.Generator | None = None) -> MoEParams:
    """Random weights as the reference initializes them: norm gains 0,
    truncated normals scaled by 1/sqrt(the first axis) (for the expert
    weights that is the padded expert count, as there), the router in
    f32, the embedding unscaled; drawn from ``generator`` or one seeded
    with ``seed``, on the card unless ``device`` says otherwise."""
    g, dev = init_generator(seed, device, generator)
    shapes = param_shapes(cfg)
    t = {"embed": embed_init(g, shapes["embed"], cfg.dtype, device=dev),
         "final_norm": torch.zeros(shapes["final_norm"], dtype=cfg.dtype,
                                   device=dev)}
    for k in LAYER_KEYS:
        name = f"layers.{k}"
        t[name] = torch.zeros(shapes[name], dtype=_dtype(cfg, name),
                              device=dev)
    for i in range(cfg.n_layers):   # one layer's draws at a time
        for k in LAYER_KEYS:
            name = f"layers.{k}"
            if k not in ("ln1", "ln2"):
                t[name][i] = dense_init(g, shapes[name][1:],
                                        _dtype(cfg, name), device=dev)
    if not cfg.tie_embeddings:
        t["unembed"] = dense_init(g, shapes["unembed"], cfg.dtype,
                                  device=dev)
    return MoEParams(cfg, t)


# The reference's two dispatch/combine formulations; "gather" is its
# production default.
DISPATCH_MODE = "gather"


@contextlib.contextmanager
def dispatch_mode(mode: str):
    global DISPATCH_MODE
    old = DISPATCH_MODE
    DISPATCH_MODE = mode
    try:
        yield
    finally:
        DISPATCH_MODE = old


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: 1.25x (the capacity
    factor) an even share, at least 8, at most the token count, rounded
    up to a multiple of 32 (so it may exceed the token count)."""
    E, k = cfg.n_experts, cfg.top_k
    C = int(max(8, -(-tokens * k // E) * cfg.capacity_factor))
    C = min(C, tokens)
    return -(-C // 32) * 32


@audit_determinism(
    "the scatter dispatch mode's combine adds each token's k expert "
    "outputs with an index_add_ in the activations' dtype, whose order of "
    "additions the card does not fix (atomics): a token's output may move "
    "in its last bits between runs, as the reference's scatter-add "
    "combine; the default gather mode sums in a fixed order in f32",
    ops=("index_add_",))
def moe_ffn(x: torch.Tensor, lp: dict, cfg: ArchConfig):
    """x: (B, L, d) -> (y (B, L, d), the f32 aux loss).  Sort-based
    top-k dispatch."""
    B, L, d = x.shape
    T = B * L
    E, k = cfg.n_experts, cfg.top_k
    Ep = _padded_experts(cfg)       # buffer / product expert count
    dev = x.device
    xt = x.reshape(T, d)

    logits = torch.matmul(xt.to(torch.float32), lp["router"])   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the larger first, the lower index first among equals
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    # Switch aux loss: E * sum_e f_e * P_e
    dispatch_frac = torch.mean(
        F.one_hot(topi[:, 0], E).to(torch.float32), dim=0)
    router_frac = torch.mean(probs, dim=0)
    aux = E * torch.sum(dispatch_frac * router_frac)

    C = capacity(cfg, T)
    eflat = topi.reshape(-1)                                   # (T*k,)
    sorted_e, sort_idx = torch.sort(eflat, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e)             # side left
    rank = torch.arange(T * k, device=dev) - first
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, Ep * C)      # drop: Ep*C
    token_of = sort_idx // k

    if DISPATCH_MODE == "gather":
        # scatter only the slot -> token map; the drop slot Ep*C takes
        # every dropped write and is cut off
        slot_token = torch.full((Ep * C + 1,), T, dtype=torch.long,
                                device=dev)
        slot_token[dest] = token_of
        xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
        buf = xt_pad[slot_token[:Ep * C]]
    else:
        buf = x.new_zeros((Ep * C + 1, d))
        buf[dest] = xt[token_of]
        buf = buf[:Ep * C]
    buf = buf.reshape(Ep, C, d)

    gate = torch.bmm(buf, lp["w_gate"])
    up = torch.bmm(buf, lp["w_up"])
    hidden = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    out_flat = torch.bmm(hidden, lp["w_down"]).reshape(Ep * C, d)

    if DISPATCH_MODE == "gather":
        # per-token gather of its k expert outputs: the inverse of
        # sort_idx maps (token, choice) -> sorted position
        inv_sort = torch.empty_like(sort_idx)
        inv_sort[sort_idx] = torch.arange(T * k, device=dev)
        dest_tc = dest[inv_sort].reshape(T, k)
        keep_tc = keep[inv_sort].reshape(T, k)
        got = out_flat[torch.clamp_max(dest_tc, Ep * C - 1)]   # (T, k, d)
        got = torch.where(keep_tc[..., None], got, 0)
        y = torch.einsum("tkd,tk->td", got.to(torch.float32),
                         topw).to(x.dtype)
        return y.reshape(B, L, d), aux
    gathered = torch.where(keep[:, None],
                           out_flat[torch.clamp_max(dest, Ep * C - 1)], 0)
    w_flat = topw.reshape(-1)[sort_idx]
    contrib = gathered * w_flat[:, None].to(x.dtype)
    y = x.new_zeros((T, d)).index_add_(0, token_of, contrib)
    return y.reshape(B, L, d), aux


def _block(x, lp: dict, cfg: ArchConfig, positions, q_chunk: int = 512):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, kk, vv = qkv_project(h, lp["wq"], lp["wk"], lp["wv"], cfg, positions)
    o = attention(q, kk, vv, positions, positions, cfg, causal=True,
                  window=cfg.sliding_window, q_chunk=q_chunk)
    x = x + out_project(o, lp["wo"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = moe_ffn(h, lp, cfg)
    return x + y, aux


def forward(params: MoEParams, x, cfg: ArchConfig, positions,
            remat: bool | None = None, q_chunk: int = 512):
    """x: (B, L, d) embedded input -> (final hidden states, the aux loss
    summed over the layers).  ``remat``: recompute each layer in the
    backward pass (None: where gradients are on)."""
    def block(h, lp):
        return _block(h, lp, cfg, positions, q_chunk)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = remat_layer(block, remat, x, params.layer(i))
        aux = aux + a
    return rms_norm(x, params.final_norm, cfg.norm_eps), aux


def loss_fn(params: MoEParams, batch: dict, cfg: ArchConfig,
            aux_weight: float = 0.01, remat: bool | None = None,
            q_chunk: int = 512):
    """The next-token loss of ``batch["tokens"]`` plus ``aux_weight``
    times the aux loss averaged over the layers, f32."""
    tokens = batch["tokens"]
    x = tfm.embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    h, aux = forward(params, x, cfg, positions, remat=remat, q_chunk=q_chunk)
    labels, lmask = tfm.shifted_labels(tokens)
    ce = tfm.chunked_ce_loss(params, h, labels, cfg, mask=lmask)
    return ce + aux_weight * aux / cfg.n_layers


def decode_step(params: MoEParams, cache: KVCache, tokens, pos: int,
                cfg: ArchConfig):
    """One decode step: tokens (B, 1) at absolute position ``pos``.
    Writes the new keys and values into ``cache`` in place; returns (f32
    logits (B, V), cache)."""
    B = tokens.shape[0]
    dev = cache.k.device
    pos = int(pos)
    h = tfm.embed_tokens(params, tokens, cfg)
    S = cache.k.shape[2]
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=dev)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev)
    k_valid = (k_pos <= pos).expand(B, S)
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = qkv_project(hn, lp["wq"], lp["wk"], lp["wv"], cfg,
                                      q_pos)
        kc = seq_update(cache.k[i], k_new, pos)
        vc = seq_update(cache.v[i], v_new, pos)
        o = attention(q, kc, vc, q_pos, k_pos, cfg, causal=True,
                      k_valid=k_valid)
        h = h + out_project(o, lp["wo"])
        hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + moe_ffn(hn, lp, cfg)[0]
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return tfm.logits_at(params, h[:, -1, :], cfg), cache


def prefill(params: MoEParams, tokens, cfg: ArchConfig, cache: KVCache,
            q_chunk: int = 512):
    """Prompt pass: last-position f32 logits (B, V) and the cache, filled
    in place (each layer's last S keys and values written from slot
    0)."""
    L = tokens.shape[1]
    h = tfm.embed_tokens(params, tokens, cfg)
    positions = torch.arange(L, dtype=torch.int32, device=h.device)
    S = cache.k.shape[2]
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = qkv_project(hn, lp["wq"], lp["wk"], lp["wv"], cfg,
                                      positions)
        o = attention(q, k_new, v_new, positions, positions, cfg,
                      causal=True, q_chunk=q_chunk)
        h = h + out_project(o, lp["wo"])
        hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + moe_ffn(hn, lp, cfg)[0]
        seq_update(cache.k[i], k_new[:, -S:], 0)
        seq_update(cache.v[i], v_new[:, -S:], 0)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return tfm.logits_at(params, h[:, -1, :], cfg), cache
