"""Dense transformer family, serving half: the port of
``repro/models/transformer.py`` for gemma-2b, granite-8b, phi3-mini,
h2o-danube (causal LMs), hubert-xlarge (bidirectional encoder) and
paligemma-3b (prefix-LM VLM backbone).  One implementation, configured by
``ArchConfig``.

Parameters are a ``TransformerParams`` module whose state has the
reference's pytree shapes and dtypes, layers stacked on axis 0
(``layers.wq`` is (L, d, H, hd)), so ``repro_torch.carry.model_params``
moves the reference's weights across unchanged.  Layers run in a Python
loop, eagerly, over views of the stacked tensors; the KV cache is written
in place.  Every cast of the reference is kept where it is (the
``embed_scale`` factor rounded to the dtype before the multiply, logits
cast to f32 after the bf16 product, then softcapped); left-pad tokens are
attended as real tokens, as there.  Training: ``loss_fn`` (the causal
LM's next-token loss, the encoder's per-frame loss, the vlm's loss over
its text suffix) through ``chunked_ce_loss``, which forms the f32 logits
one sequence chunk at a time; ``forward`` recomputes each layer in the
backward pass where gradients are on (``common.remat``), as the
reference's ``jax.checkpoint`` does.

Sharding: ``layer_specs``, ``param_specs`` (by dotted name) and
``cache_specs`` give each tensor's ``P`` under ``MeshRules``, as the
reference's do.  Every entry point takes ``rules=None``; with rules its
tensors are DTensors on the rules' mesh, and ``constrain`` redistributes
them where the reference's ``with_sharding_constraint``s stand (the
queries' heads over ``model``, each layer's output over the data axes,
the loss's logits' vocabulary over ``model``).  The port adds two
points the reference has not: ``chunked_ce_loss`` replicates a chunk's
logits over ``model`` before the gold logit's ``gather``, whose DTensor
rule on a vocabulary-sharded input fails, and ``embed_tokens`` looks the
tokens up in the table replicated over the mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .attention import KVCache, attention, out_project, qkv_project, seq_update
from .common import (ArchConfig, MeshRules, P, StackedParams, constrain,
                     dense_init, embed_init, glu_ffn, init_generator,
                     logical_to_spec, on_mesh, remat as remat_layer,
                     rms_norm, softcap)

__all__ = ["TransformerParams", "init_params", "param_shapes",
           "layer_specs", "param_specs", "cache_specs", "forward",
           "embed_tokens", "logits_at", "shifted_labels", "chunked_ce_loss",
           "loss_fn", "init_cache", "decode_step", "prefill_embedded",
           "prefill", "vlm_prefill", "encode_step"]

LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_in", "w_out")


def param_shapes(cfg: ArchConfig) -> dict:
    """Name -> shape of every tensor, as the reference's pytree holds it
    (``layers.*`` stacked on a leading axis of ``n_layers``)."""
    d, H, K, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    L = cfg.n_layers
    shapes = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    shapes.update({f"layers.{k}": (L, *s) for k, s in (
        ("ln1", (d,)), ("wq", (d, H, hd)), ("wk", (d, K, hd)),
        ("wv", (d, K, hd)), ("wo", (H, hd, d)), ("ln2", (d,)),
        ("w_in", (d, 2, ff)), ("w_out", (ff, d)))})
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab)
    if cfg.frontend_dim:
        shapes["frontend"] = (cfg.frontend_dim, d)
    return shapes


class TransformerParams(StackedParams):
    """The weights of one dense-family model.

    ``embed`` (V, d), ``final_norm`` (d,), optional ``unembed`` (d, V) and
    ``frontend`` (frontend_dim, d), and ``layers`` holding each of
    ``LAYER_KEYS`` stacked over the layers.  Built from a name -> tensor
    dict whose names are ``param_shapes``'s."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__(cfg, tensors, {n: (s, cfg.dtype) for n, s in
                                        param_shapes(cfg).items()})

    def layer(self, i: int) -> dict:
        """Layer ``i``'s tensors: views into the stacks."""
        return self.stacked(self.layers, i)


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                generator: torch.Generator | None = None
                ) -> TransformerParams:
    """Random weights as the reference initializes them (norm gains 0,
    truncated normals scaled by 1/sqrt(fan_in), the embedding unscaled),
    drawn from ``generator`` or a generator seeded with ``seed``, on the
    card unless ``device`` says otherwise.  The draws are torch's, not
    jax.random's: carry the reference's weights with
    ``carry.model_params`` to compare the two."""
    g, dev = init_generator(seed, device, generator)
    dt, L = cfg.dtype, cfg.n_layers
    shapes = param_shapes(cfg)
    t = {"embed": embed_init(g, shapes["embed"], dt, device=dev),
         "final_norm": torch.zeros(shapes["final_norm"], dtype=dt,
                                   device=dev)}
    for k in LAYER_KEYS:
        t[f"layers.{k}"] = torch.zeros(shapes[f"layers.{k}"], dtype=dt,
                                       device=dev)
    for i in range(L):          # one layer's draws at a time: small temps
        for k in ("wq", "wk", "wv", "wo", "w_in", "w_out"):
            t[f"layers.{k}"][i] = dense_init(
                g, shapes[f"layers.{k}"][1:], dt, device=dev)
    if not cfg.tie_embeddings:
        t["unembed"] = dense_init(g, shapes["unembed"], dt, device=dev)
    if cfg.frontend_dim:
        t["frontend"] = dense_init(g, shapes["frontend"], dt, device=dev)
    return TransformerParams(cfg, t)


# ---------------------------------------------------------------- sharding
def layer_specs(cfg: ArchConfig, rules: MeshRules) -> dict:
    """The stacked layer tensors' specs, by their names under
    ``layers``; the leading (layer) axis is never sharded."""
    d, H, K, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    L = cfg.n_layers

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
    specs = {"embed": logical_to_spec(rules, ("model", cfg.vocab),
                                      (None, cfg.d_model))}
    specs.update({f"layers.{k}": v
                  for k, v in layer_specs(cfg, rules).items()})
    specs["final_norm"] = P(None)
    if not cfg.tie_embeddings:
        specs["unembed"] = logical_to_spec(rules, (None, cfg.d_model),
                                           ("model", cfg.vocab))
    if cfg.frontend_dim:
        specs["frontend"] = P(None, None)
    return specs


def cache_specs(cfg: ArchConfig, rules: MeshRules) -> KVCache:
    """(L, B, S, K, hd): the batch over the data axes, the kv heads over
    ``model`` where they divide."""
    s = logical_to_spec(rules, (None, cfg.n_layers), ("data", 0),
                        (None, 0), ("model", cfg.n_kv_heads), (None, 0))
    return KVCache(k=s, v=s)


def data_spec(rules: MeshRules) -> P:
    """(B, L, d) activations: the batch over the data axes."""
    return P(rules.data, None, None)


# ------------------------------------------------------------------ forward
def _block(x, lp: dict, cfg: ArchConfig, positions, rules=None,
           prefix_len=None, q_chunk: int = 512):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(h, lp["wq"], lp["wk"], lp["wv"], cfg, positions)
    if rules is not None:
        q = constrain(q, P(rules.data, None, rules.model(cfg.n_heads), None))
    o = attention(q, k, v, positions, positions, cfg, causal=cfg.is_causal,
                  window=cfg.sliding_window, prefix_len=prefix_len,
                  q_chunk=q_chunk)
    x = x + out_project(o, lp["wo"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + glu_ffn(h, lp["w_in"], lp["w_out"], cfg.activation)
    if rules is not None:
        x = constrain(x, data_spec(rules))
    return x


def forward(params: TransformerParams, x, cfg: ArchConfig, positions,
            rules=None, prefix_len=None, remat: bool | None = None,
            q_chunk: int = 512):
    """x: (B, L, d) embedded input -> final hidden states (B, L, d).
    ``remat``: recompute each layer in the backward pass (None: where
    gradients are on, ``common.remat``)."""
    def block(h, lp):
        return _block(h, lp, cfg, positions, rules, prefix_len, q_chunk)

    with on_mesh(rules):
        for i in range(cfg.n_layers):
            x = remat_layer(block, remat, x, params.layer(i))
        return rms_norm(x, params.final_norm, cfg.norm_eps)


def embed_tokens(params: TransformerParams, tokens, cfg: ArchConfig):
    from torch.distributed.tensor import DTensor

    if isinstance(params.embed, DTensor):
        # on a mesh, the lookup in the table replicated over the mesh:
        # DTensor's vocabulary-parallel lookup leaves a masked partial sum
        # that loses its mask in a recomputed layer or fails to take its
        # gradient, and the backward of an indexed lookup (an accumulating
        # index_put) has no working rule in every torch release
        from torch.distributed.tensor import Replicate

        mesh = params.embed.device_mesh
        x = F.embedding(tokens, params.embed.redistribute(
            mesh, [Replicate()] * mesh.ndim))
    else:
        x = params.embed[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def _unembed_matrix(params: TransformerParams, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params.embed.T          # (d, V)
    return params.unembed


def logits_at(params: TransformerParams, h, cfg: ArchConfig):
    """h (..., d) -> f32 logits (..., V): the product in the weights'
    dtype, then cast to f32, then softcapped."""
    logits = torch.matmul(h, _unembed_matrix(params, cfg))
    return softcap(logits.to(torch.float32), cfg.final_logit_softcap)


def shifted_labels(tokens: torch.Tensor):
    """Next-token labels at full length: position L-1 is masked out (no
    target), so callers never slice the hidden states to L-1."""
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    mask[:, -1] = False
    return labels, mask


def chunked_ce_loss(params: TransformerParams, h, labels, cfg: ArchConfig,
                    mask=None, rules: MeshRules | None = None,
                    chunk: int = 512):
    """Cross-entropy with the f32 logits formed one sequence chunk of
    ``chunk`` positions at a time (the full (B, L, V) would dominate the
    card's memory); a sequence that does not divide ``chunk`` is padded
    with masked positions.  The sum over each chunk, then over chunks, in
    f32, over the masked count (at least one), as the reference's scan."""
    B, L, d = h.shape
    chunk = min(chunk, L)
    if mask is None:
        mask = torch.ones((B, L), dtype=torch.bool, device=h.device)
    if L % chunk:
        pad = chunk - L % chunk
        h = torch.cat([h, h.new_zeros((B, pad, d))], dim=1)
        labels = torch.cat([labels, labels.new_zeros((B, pad))], dim=1)
        mask = torch.cat([mask, mask.new_zeros((B, pad))], dim=1)
        L += pad
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, L, chunk):
        logits = logits_at(params, h[:, c0:c0 + chunk], cfg)
        if rules is not None:
            logits = constrain(logits, P(rules.data, None,
                                         rules.model(cfg.vocab)))
        logz = torch.logsumexp(logits, dim=-1)
        if rules is not None:
            # DTensor's gather on a vocabulary-sharded input fails: the
            # gold logit is gathered from the chunk replicated over model
            logits = constrain(logits, P(rules.data, None, None))
        gold = torch.gather(logits, -1,
                            labels[:, c0:c0 + chunk, None].long())[..., 0]
        m = mask[:, c0:c0 + chunk].to(torch.float32)
        tot = tot + torch.sum((logz - gold) * m)
        cnt = cnt + torch.sum(m)
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(params: TransformerParams, batch: dict, cfg: ArchConfig,
            rules=None, remat: bool | None = None, q_chunk: int = 512):
    """The f32 training loss of a batch dict: the causal LM's next-token
    loss over ``tokens`` (an optional bool ``mask`` (B, L) selects the
    positions), the encoder's per-frame loss of ``features`` against
    ``labels``, the vlm's next-token loss over the text suffix after the
    ``patches`` prefix."""
    with on_mesh(rules):
        return _loss(params, batch, cfg, rules, remat, q_chunk)


def _loss(params, batch, cfg, rules, remat, q_chunk):
    if cfg.family == "encoder":
        feats = batch["features"].to(cfg.dtype)
        x = torch.einsum("blf,fd->bld", feats, params.frontend)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        h = forward(params, x, cfg, positions, rules, remat=remat,
                    q_chunk=q_chunk)
        return chunked_ce_loss(params, h, batch["labels"], cfg,
                               mask=batch.get("mask"), rules=rules)
    if cfg.family == "vlm":
        patches = batch["patches"].to(cfg.dtype)
        img = torch.einsum("bpf,fd->bpd", patches, params.frontend)
        tok = embed_tokens(params, batch["tokens"], cfg)
        x = torch.cat([img, tok], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        h = forward(params, x, cfg, positions, rules,
                    prefix_len=cfg.num_patches, remat=remat, q_chunk=q_chunk)
        labels, lmask = shifted_labels(batch["tokens"])
        return chunked_ce_loss(params, h[:, cfg.num_patches:], labels, cfg,
                               mask=lmask, rules=rules)
    tokens = batch["tokens"]
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    h = forward(params, x, cfg, positions, rules, remat=remat,
                q_chunk=q_chunk)
    labels, lmask = shifted_labels(tokens)
    if "mask" in batch:
        lmask = lmask & batch["mask"]
    return chunked_ce_loss(params, h, labels, cfg, mask=lmask, rules=rules)


# ---------------------------------------------------------------- serving
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device=None) -> KVCache:
    """Zeros (L, B, S, K, hd) in the config's dtype, S = max_len or the
    sliding window; on the card unless ``device`` says otherwise."""
    S = max_len if cfg.sliding_window is None else min(max_len,
                                                       cfg.sliding_window)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev))


def decode_step(params: TransformerParams, cache: KVCache, tokens, pos: int,
                cfg: ArchConfig, rules=None):
    """One decode step: tokens (B, 1) at absolute position ``pos``.

    Writes the new keys and values into ``cache`` in place and returns
    (f32 logits (B, V), cache).  With a sliding window the cache is a ring
    buffer of size window and the write slot is pos % window.
    """
    with on_mesh(rules):
        return _decode(params, cache, tokens, pos, cfg, rules)


def _decode(params, cache, tokens, pos, cfg, rules):
    B = tokens.shape[0]
    dev = cache.k.device
    pos = int(pos)
    x = embed_tokens(params, tokens, cfg)
    S = cache.k.shape[2]
    slot = pos if cfg.sliding_window is None else pos % S
    q_pos = torch.full((1,), pos, dtype=torch.int32, device=dev)
    idx = torch.arange(S, dtype=torch.int32, device=dev)
    if cfg.sliding_window is None:
        k_pos = idx
    else:
        # ring buffer: absolute position of slot s given write head at slot
        k_pos = torch.where(idx <= slot, pos - slot + idx,
                            pos - slot - S + idx)
    k_valid = ((k_pos >= 0) & (k_pos <= pos)).expand(B, S)
    h = x
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = qkv_project(hn, lp["wq"], lp["wk"], lp["wv"], cfg,
                                      q_pos)
        kc = seq_update(cache.k[i], k_new, slot)
        vc = seq_update(cache.v[i], v_new, slot)
        o = attention(q, kc, vc, q_pos, k_pos, cfg, causal=True,
                      window=cfg.sliding_window, k_valid=k_valid)
        h = h + out_project(o, lp["wo"])
        hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + glu_ffn(hn, lp["w_in"], lp["w_out"], cfg.activation)
        if rules is not None:
            h = constrain(h, data_spec(rules))
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return logits_at(params, h[:, -1, :], cfg), cache


def prefill_embedded(params: TransformerParams, x, cfg: ArchConfig,
                     cache: KVCache, rules=None, prefix_len=None,
                     q_chunk: int = 512):
    """Prompt pass over pre-embedded inputs x (B, L, d): returns
    last-position f32 logits (B, V) and the cache, filled in place (the
    last S of each layer's keys and values written from slot 0).

    Full-sequence logits are never materialized: serving only needs the
    last position.
    """
    with on_mesh(rules):
        return _prefill(params, x, cfg, cache, rules, prefix_len, q_chunk)


def _prefill(params, x, cfg, cache, rules, prefix_len, q_chunk):
    L = x.shape[1]
    positions = torch.arange(L, dtype=torch.int32, device=x.device)
    S = cache.k.shape[2]
    h = x
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k_new, v_new = qkv_project(hn, lp["wq"], lp["wk"], lp["wv"], cfg,
                                      positions)
        o = attention(q, k_new, v_new, positions, positions, cfg,
                      causal=True, window=cfg.sliding_window,
                      prefix_len=prefix_len, q_chunk=q_chunk)
        h = h + out_project(o, lp["wo"])
        hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + glu_ffn(hn, lp["w_in"], lp["w_out"], cfg.activation)
        if rules is not None:
            h = constrain(h, data_spec(rules))
        seq_update(cache.k[i], k_new[:, -S:], 0)
        seq_update(cache.v[i], v_new[:, -S:], 0)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return logits_at(params, h[:, -1, :], cfg), cache


def prefill(params: TransformerParams, tokens, cfg: ArchConfig,
            cache: KVCache, rules=None, q_chunk: int = 512):
    """Token-prompt prefill (dense LMs)."""
    with on_mesh(rules):
        x = embed_tokens(params, tokens, cfg)
        return prefill_embedded(params, x, cfg, cache, rules=rules,
                                q_chunk=q_chunk)


def vlm_prefill(params: TransformerParams, batch: dict, cfg: ArchConfig,
                cache: KVCache, rules=None, q_chunk: int = 512):
    """VLM prompt pass: image patches (stub frontend) + text tokens, the
    patches a bidirectional prefix."""
    with on_mesh(rules):
        patches = batch["patches"].to(cfg.dtype)
        img = torch.einsum("bpf,fd->bpd", patches, params.frontend)
        tok = embed_tokens(params, batch["tokens"], cfg)
        x = torch.cat([img, tok], dim=1)
        return prefill_embedded(params, x, cfg, cache, rules=rules,
                                prefix_len=cfg.num_patches, q_chunk=q_chunk)


def encode_step(params: TransformerParams, batch: dict, cfg: ArchConfig,
                rules=None, q_chunk: int = 512):
    """Encoder serving (hubert): frame features -> per-frame f32 unit
    logits (B, L, V)."""
    with on_mesh(rules):
        feats = batch["features"].to(cfg.dtype)
        x = torch.einsum("blf,fd->bld", feats, params.frontend)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        h = forward(params, x, cfg, positions, rules, q_chunk=q_chunk)
        return logits_at(params, h, cfg)
