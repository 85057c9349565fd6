"""GQA/MQA attention with RoPE, sliding windows, prefix-LM masks and KV
caches: the port of ``repro/models/attention.py``.

Prefill attention is chunked over the query axis, so the live score
tensor is (B, K, G, q_chunk, Lk).  The QK^T logits are f32: q and k are
upcast before the product (the product of two bf16 values is exact in
f32, as the reference's ``preferred_element_type=float32`` einsum gives),
softmax is f32, and the probabilities are cast to q's dtype before the
product with v.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .common import ArchConfig, apply_rope, rope_angles, softcap

__all__ = ["KVCache", "attn_mask", "attention", "qkv_project",
           "out_project", "seq_update", "update_cache"]


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, n_kv, head_dim), or (L, B, S, ...) per model
    v: torch.Tensor
    # number of valid positions is tracked by the serving engine


def attn_mask(q_pos, k_pos, *, causal: bool, window: int | None,
              prefix_len: int | None, k_valid=None):
    """Boolean mask (..., Lq, Lk). True = attend."""
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if causal:
        c = kp <= qp
        if prefix_len is not None:
            c = c | (kp < prefix_len)
        m = m & c
    if window is not None:
        m = m & (kp > qp - window)
    if k_valid is not None:
        m = m & k_valid[..., None, :]
    return m


def _sdpa(q, k, v, mask, cfg: ArchConfig):
    """q: (B, Lq, K, G, hd); k/v: (B, Lk, K, hd); mask: (B, Lq, Lk)."""
    scale = cfg.head_dim ** -0.5
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = softcap(logits, cfg.attn_logit_softcap)
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def attention(q, k, v, q_positions, k_positions, cfg: ArchConfig, *,
              causal=True, window=None, prefix_len=None, k_valid=None,
              q_chunk: int = 512):
    """q: (B, Lq, H, hd); k/v: (B, Lk, K, hd).  Chunked over Lq.

    q_positions/k_positions: (Lq,)/(Lk,) absolute positions (RoPE applied
    by the caller).  Returns (B, Lq, H, hd).
    """
    B, Lq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Lq, K, G, hd)
    kp = k_positions.expand(B, k.shape[1])
    if Lq <= q_chunk:
        mask = attn_mask(q_positions.expand(B, Lq), kp, causal=causal,
                         window=window, prefix_len=prefix_len,
                         k_valid=k_valid)
        return _sdpa(qg, k, v, mask, cfg).reshape(B, Lq, H, hd)
    assert Lq % q_chunk == 0, "query length must be divisible by q_chunk"
    outs = []
    for s in range(0, Lq, q_chunk):
        mask = attn_mask(q_positions[s:s + q_chunk].expand(B, q_chunk), kp,
                         causal=causal, window=window,
                         prefix_len=prefix_len, k_valid=k_valid)
        outs.append(_sdpa(qg[:, s:s + q_chunk], k, v, mask, cfg))
    return torch.cat(outs, dim=1).reshape(B, Lq, H, hd)


def qkv_project(x, wq, wk, wv, cfg: ArchConfig, positions):
    """x: (B, L, d) -> RoPE'd q (B,L,H,hd), k/v (B,L,K,hd)."""
    q = torch.einsum("bld,dnh->blnh", x, wq)
    k = torch.einsum("bld,dnh->blnh", x, wk)
    v = torch.einsum("bld,dnh->blnh", x, wv)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def out_project(o, wo):
    """o: (B, L, H, hd) x wo (H, hd, d) -> (B, L, d)."""
    return torch.einsum("blnh,nhd->bld", o, wo)


def seq_update(arr: torch.Tensor, new: torch.Tensor, slot: int):
    """Write ``new`` into the (B, S, heads, head_dim) buffer ``arr`` at
    sequence position ``slot`` (axis 1), in place; returns ``arr``.  As
    ``lax.dynamic_update_slice`` does, a slot past the end is clamped so
    the whole update fits."""
    slot = max(0, min(int(slot), arr.shape[1] - new.shape[1]))
    arr[:, slot:slot + new.shape[1]] = new.to(arr.dtype)
    return arr


def update_cache(cache: KVCache, k_new, v_new, pos) -> KVCache:
    """Write k/v at [pos : pos+Lnew) (decode Lnew=1; prefill writes a
    prompt), in place."""
    return KVCache(k=seq_update(cache.k, k_new, pos),
                   v=seq_update(cache.v, v_new, pos))
