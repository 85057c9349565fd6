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


def _sdpa_on_mesh(q, k, v, mask, cfg: ArchConfig):
    """``_sdpa`` on DTensors, shard by shard: attention is independent per
    sequence and kv head, so each rank attends its own (batch, kv-head)
    block (``local_map``), q's other dims gathered first.  DTensor's
    einsum folds a sharded batch dim and a sharded kv-head dim into one
    product batch, which torch 2.11 refuses."""
    import functools

    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    qpl = tuple(Shard(p.dim % q.ndim) if isinstance(p, Shard)
                and p.dim % q.ndim in (0, 2) else Replicate()
                for p in q.placements)
    mpl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in qpl)
    k, v, mask = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in (k, v, mask))
    fn = local_map(functools.partial(_sdpa, cfg=cfg),
                   out_placements=list(qpl),   # a tuple reads as per output
                   in_placements=(qpl, qpl, qpl, mpl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v, mask)


def _groupable(q, K: int):
    """``q`` as a DTensor may split its heads into (K, G): DTensor splits
    a sharded dim only where the first factor divides by the shards, so
    the heads are gathered over any mesh axis that does not divide K
    (qwen3-moe's 4 kv heads on a 16-way model axis).  A port-added
    layout: GSPMD splits the heads as they lie.  Returns ``q`` and the
    mesh dims gathered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor):
        return q, ()
    mesh = q.device_mesh
    gathered = tuple(i for i, p in enumerate(q.placements)
                     if isinstance(p, Shard) and p.dim % q.ndim == 2
                     and K % mesh.size(i))
    if not gathered:
        return q, ()
    placements = [Replicate() if i in gathered else p
                  for i, p in enumerate(q.placements)]
    return q.redistribute(mesh, placements), gathered


def _regroup(out, gathered):
    """``out`` (B, L, H, hd) sharded again over the heads on the mesh
    dims ``_groupable`` gathered (a local slice): the output projection
    then meets its head-sharded weight as the reference's does."""
    from torch.distributed.tensor import Shard

    if not gathered:
        return out
    placements = [Shard(2) if i in gathered else p
                  for i, p in enumerate(out.placements)]
    return out.redistribute(out.device_mesh, placements)


def attention(q, k, v, q_positions, k_positions, cfg: ArchConfig, *,
              causal=True, window=None, prefix_len=None, k_valid=None,
              q_chunk: int = 512):
    """q: (B, Lq, H, hd); k/v: (B, Lk, K, hd).  Chunked over Lq.

    q_positions/k_positions: (Lq,)/(Lk,) absolute positions (RoPE applied
    by the caller).  Returns (B, Lq, H, hd).
    """
    from torch.distributed.tensor import DTensor

    B, Lq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q, gathered = _groupable(q, K)
    qg = q.reshape(B, Lq, K, G, hd)
    sdpa = _sdpa_on_mesh if isinstance(qg, DTensor) else _sdpa
    kp = k_positions.expand(B, k.shape[1])
    if Lq <= q_chunk:
        mask = attn_mask(q_positions.expand(B, Lq), kp, causal=causal,
                         window=window, prefix_len=prefix_len,
                         k_valid=k_valid)
        return _regroup(sdpa(qg, k, v, mask, cfg).reshape(B, Lq, H, hd),
                        gathered)
    assert Lq % q_chunk == 0, "query length must be divisible by q_chunk"
    outs = []
    for s in range(0, Lq, q_chunk):
        mask = attn_mask(q_positions[s:s + q_chunk].expand(B, q_chunk), kp,
                         causal=causal, window=window,
                         prefix_len=prefix_len, k_valid=k_valid)
        outs.append(sdpa(qg[:, s:s + q_chunk], k, v, mask, cfg))
    return _regroup(torch.cat(outs, dim=1).reshape(B, Lq, H, hd),
                    gathered)


def qkv_project(x, wq, wk, wv, cfg: ArchConfig, positions):
    """x: (B, L, d) -> RoPE'd q (B,L,H,hd), k/v (B,L,K,hd)."""
    q = torch.einsum("bld,dnh->blnh", x, wq)
    k = torch.einsum("bld,dnh->blnh", x, wk)
    v = torch.einsum("bld,dnh->blnh", x, wv)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def out_project(o, wo):
    """o: (B, L, H, hd) x wo (H, hd, d) -> (B, L, d)."""
    from torch.distributed.tensor import DTensor

    if isinstance(o, DTensor) or isinstance(wo, DTensor):
        # the heads and head_dim flattened in that order: einsum may
        # flatten them as (hd, heads), which torch 2.11's DTensor refuses
        # where the heads are sharded
        B, L, H, hd = o.shape
        return torch.matmul(o.reshape(B, L, H * hd), wo.reshape(H * hd, -1))
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
