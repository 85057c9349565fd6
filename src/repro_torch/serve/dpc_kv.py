"""DPC-KV: density-peaks compression of attention KV caches, the port of
``repro/serve/dpc_kv.py``.

The cached keys of each (sequence, kv-head) are clustered with DPC and
the cache is replaced by one (k, v) pair per cluster: the centers are the
density peaks of the key distribution (the attention modes), and members
are merged into their center.  Keys are first projected with a fixed
random orthonormal matrix to ``proj_dim`` dimensions; rho and the
dependent structure are computed there, and the centers are the top-M
gamma = rho * delta peaks (the decision-graph rule with the threshold
replaced by a budget, so the compressed cache has a fixed size).

``compress_kv`` batches everything but the kernels over all H = B * K
heads: the projection, the masking of rows past ``length``, the d_cut
estimate (copied to the host once for all heads), gamma, the top-M, the
pointer jump and the member sums.  Per head it then takes the reference's
own route for the plan's backend: on ``cuda`` K4 (``range_count``), the
jitter, keys at -inf on invalid rows, then K2 (``denser_nn``), as the
reference's ``pallas`` route; on ``torch`` the fused ``rho_delta`` with a
-inf jitter mask, as its ``jnp`` route.

The member sums are ``index_add_``: on the card they run as atomics, so
``k_c``/``v_c`` may differ in the last bit between runs.  The reference
accepts the same of its scatter-adds (its ``audit_determinism`` note:
the centroids are approximate summaries by construction), and so does
``compress_kv``'s own ``@audit_determinism`` (R8 of
``repro_torch.analysis``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..analysis.audit import audit_determinism
from ..core import threefry
from ..core.dpc_types import density_jitter, with_jitter
from ..engine.planner import as_plan
from ..engine.spec import ExecSpec
from ..kernels import ops
from ..kernels.sweep import direct_d2
from ..resilience.sanitize import finite_or

__all__ = ["DPCKVConfig", "compress_kv", "attend_compressed"]

_KERNELS = ("range_count", "masked_nn")


@dataclass(frozen=True)
class DPCKVConfig:
    """DPC-KV compression parameters.

    Execution is one :class:`repro_torch.engine.ExecSpec` on
    ``exec_spec``: ``cuda`` (the default; K4 and K2, dense only) or
    ``torch`` (the plain reference math; dense, or ``"block-sparse"``,
    the ring walk).  ``cuda`` with ``layout="block-sparse"`` raises, as the
    reference's ``pallas`` does (its worklists are built per call on the
    host side of the plan), and ``precision="bf16"`` raises on every
    backend, as in the reference, where no backend is both jit-safe and
    MXU-dense.  The plan is resolved at construction, so the backend's
    probe runs there.
    """

    budget: int = 256          # M: kept (k, v) pairs per head
    d_cut_quantile: float = 0.05   # d_cut = this quantile of pair distances
    proj_dim: int = 4
    exec_spec: ExecSpec | None = None

    def __post_init__(self):
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget!r}")
        ex = self.exec_spec if self.exec_spec is not None else ExecSpec()
        object.__setattr__(self, "exec_spec", ex)
        be = as_plan(ex).backend
        if ex.sparse and be.builds_worklists:
            raise ValueError(
                f"DPC-KV: layout='block-sparse' on the {be.name!r} backend "
                f"builds tile-pair worklists, which the reference refuses "
                f"for its kernel backend here — use the 'torch' backend "
                f"(the ring walk) or the dense layout")
        if ex.resolved_precision == "bf16":
            raise ValueError(
                f"DPC-KV refuses precision='bf16' on every backend, "
                f"{be.name!r} included, as the reference does: none of its "
                f"backends has a fused rho_delta both jit-safe and dense on "
                f"the matrix unit")

    def resolved_exec(self) -> ExecSpec:
        return self.exec_spec


_PROJ: dict = {}


def _projection(hd: int, proj_dim: int, seed: int, device) -> torch.Tensor:
    """The first ``proj_dim`` columns of Q from the QR of jax.random's
    (hd, hd) f32 normal of ``seed``: drawn and factored once on the host
    (LAPACK Householder, as the reference's), cached on ``device``."""
    key = (hd, proj_dim, seed, str(device))
    q = _PROJ.get(key)
    if q is None:
        g = threefry.normal(threefry.prng_key(seed), (hd, hd))
        q = torch.linalg.qr(g)[0][:, :proj_dim].contiguous().to(device)
        _PROJ[key] = q
    return q


def _project(keys: torch.Tensor, proj_dim: int, seed: int = 0):
    """Fixed random orthonormal projection (..., S, hd) -> (..., S,
    proj_dim), f32."""
    q = _projection(keys.shape[-1], proj_dim, seed, keys.device)
    return torch.matmul(keys.to(torch.float32), q)


def _dcut_estimate(pts: torch.Tensor, quantile: float) -> torch.Tensor:
    """d_cut of each head from a sampled pairwise-distance quantile:
    pts (H, S, p) -> (H,) f32.  The strided 256-row sample, f32 direct
    differences, and ``jnp.quantile``'s linear rule (its interpolation in
    f64, rounded to f32), plus 1e-6."""
    S = pts.shape[1]
    m = min(S, 256)
    sub = pts[:, ::max(S // m, 1)][:, :m]
    d2 = direct_d2(sub[:, :, None, :], sub[:, None, :, :])
    d = torch.sqrt(torch.clamp_min(d2, 0.0)).reshape(pts.shape[0], -1)
    d = torch.sort(d, dim=1).values
    n = d.shape[1]
    pos = float(quantile) * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    hw = pos - lo
    lo, hi = min(max(lo, 0), n - 1), min(max(hi, 0), n - 1)
    q = d[:, lo].double() * (1.0 - hw) + d[:, hi].double() * hw
    return q.to(torch.float32) + np.float32(1e-6)


def _head_rho_delta(be, pts, valid, d_cut: float, layout):
    """One head's (rho, delta, parent) on the reference's route for its
    backend: rho 0 and key -inf on invalid rows."""
    S = pts.shape[0]
    if be.name == "cuda":
        rho = be.range_count(pts, pts, d_cut)
        rho = torch.where(valid, rho, 0.0)
        rho_key = torch.where(valid, with_jitter(rho), float("-inf"))
        delta, parent = be.denser_nn(pts, rho_key, pts, rho_key)
        return rho, delta, parent
    jit_mask = torch.where(valid, density_jitter(S, pts.device),
                           float("-inf"))
    rho, _, delta, parent = be.rho_delta(pts, pts, d_cut, jitter=jit_mask,
                                         layout=layout)
    return torch.where(valid, rho, 0.0), delta, parent


def _cluster_heads(kh: torch.Tensor, valid: torch.Tensor,
                   cfg: DPCKVConfig) -> dict:
    """DPC over each head's keys: kh (H, S, hd), valid (H, S).

    Returns the projected points ``pts`` (H, S, p), ``d_cut`` (H,),
    ``rho`` (H, S), the top-M ``centers`` (H, M) in gamma order, and each
    row's ``member_slot`` (H, S): its center's slot, M for rows that join
    none (invalid rows, and chains that reach no kept center).
    """
    H, S, _ = kh.shape
    M = cfg.budget
    dev = kh.device
    ex = cfg.resolved_exec()
    be = as_plan(ex).backend
    pts = _project(kh, cfg.proj_dim)
    # push invalid rows far away so they count towards no density
    far = (1e9 + torch.arange(S, dtype=torch.float64, device=dev)
           * 1e3).to(torch.float32)
    pts = torch.where(valid[:, :, None], pts, far[:, None])
    d_cut = _dcut_estimate(torch.where(valid[:, :, None], pts, 0.0),
                           cfg.d_cut_quantile)
    cuts = d_cut.tolist()                 # one copy for all heads
    per_head = [_head_rho_delta(be, pts[h].contiguous(), valid[h], cuts[h],
                                ex.resolved_layout) for h in range(H)]
    rho, delta, parent = (torch.stack(t) for t in zip(*per_head))
    # global peak: delta = inf -> capped for gamma
    delta = finite_or(delta, (2.0 * d_cut * 10.0)[:, None])
    gamma = torch.where(valid, rho * delta, float("-inf"))

    # top-M gamma peaks, the lower index first among equal values
    centers = torch.sort(gamma, dim=1, descending=True,
                         stable=True).indices[:, :M]
    is_center = torch.zeros((H, S), dtype=torch.bool, device=dev)
    is_center.scatter_(1, centers, True)
    is_center &= valid

    # members follow dependent chains to the nearest center (pointer jump)
    idx = torch.arange(S, device=dev).expand(H, S)
    p = torch.where(is_center | (parent < 0), idx, parent.long())
    for _ in range(max(int(math.ceil(math.log2(max(S, 2)))), 1)):
        p = torch.where(torch.gather(is_center, 1, p), p,
                        torch.gather(p, 1, p))
    slot_of = torch.full((H, S), M, dtype=torch.long, device=dev)
    slot_of.scatter_(1, centers, torch.arange(M, device=dev).expand(H, M))
    member_slot = torch.where(valid & torch.gather(is_center, 1, p),
                              torch.gather(slot_of, 1, p), M)
    return {"pts": pts, "d_cut": d_cut, "rho": rho, "centers": centers,
            "member_slot": member_slot}


def _heads(k: torch.Tensor, length) -> tuple:
    """(B, S, K, hd) and the valid prefix lengths -> the heads (b, k) in
    row-major order, (H, S, hd), and their valid rows (H, S)."""
    B, S, K, hd = k.shape
    length = torch.as_tensor(length, device=k.device).expand(B)
    valid = torch.arange(S, device=k.device)[None, :] < length[:, None]
    valid = valid[:, None, :].expand(B, K, S).reshape(B * K, S)
    return k.permute(0, 2, 1, 3).reshape(B * K, S, hd), valid


@audit_determinism(
    "the member sums' index_add_ collide by design (every member of a "
    "cluster lands on its center's slot); the counts are integer-valued, "
    "exact in f32 in any order, but on the card the k and v sums are float "
    "atomics whose order of arrival can move k_c and v_c in their last "
    "bits between runs; the centroids are approximate summaries by "
    "construction and that wobble is within the compressor's accepted "
    "error, as the reference accepts of its scatter-adds",
    ops=("index_add_",))
def compress_kv(k: torch.Tensor, v: torch.Tensor, length,
                cfg: DPCKVConfig):
    """k/v: (B, S, n_kv, hd); length: an int or (B,) valid prefix lengths.

    Raises ``ValueError`` where the budget M exceeds S.
    Returns (k_c, v_c, counts): (B, M, n_kv, hd) x2 in k's and v's dtypes
    and (B, M, n_kv) f32, on k's device.  ``counts`` feed the attention
    correction log(count) added to logits: a merged center stands for
    ``count`` keys (mass-preserving softmax).
    """
    B, S, K, hd = k.shape
    M = cfg.budget
    if M > S:
        raise ValueError(f"DPC-KV budget {M} exceeds the cache's {S} slots "
                         f"(the reference's top_k raises there)")
    H = B * K
    dev = k.device
    before = sum(ops.launch_counts()[n] for n in _KERNELS)
    with obs.span("serve.compress", heads=H, budget=M,
                  backend=cfg.resolved_exec().backend or "cuda") as sp:
        kh, valid = _heads(k, length)
        vh = v.permute(0, 2, 1, 3).reshape(H, S, hd)
        member_slot = _cluster_heads(kh, valid, cfg)["member_slot"]
        # the member sums, one row of M + 1 slots a head (slot M: dropped)
        ones = (member_slot < M).to(torch.float32)
        flat = (member_slot + (M + 1) * torch.arange(
            H, device=dev)[:, None]).reshape(-1)
        counts = torch.zeros(H * (M + 1), dtype=torch.float32, device=dev)
        counts.index_add_(0, flat, ones.reshape(-1))
        ksum = torch.zeros((H * (M + 1), hd), dtype=torch.float32,
                           device=dev)
        ksum.index_add_(0, flat, (kh.to(torch.float32)
                                  * ones[..., None]).reshape(-1, hd))
        vsum = torch.zeros_like(ksum)
        vsum.index_add_(0, flat, (vh.to(torch.float32)
                                  * ones[..., None]).reshape(-1, hd))
        counts = counts.view(H, M + 1)[:, :M]
        denom = torch.clamp_min(counts, 1.0)[..., None]
        k_out = (ksum.view(H, M + 1, hd)[:, :M] / denom).to(k.dtype)
        v_out = (vsum.view(H, M + 1, hd)[:, :M] / denom).to(v.dtype)
        sp.set(launches=sum(ops.launch_counts()[n] for n in _KERNELS)
               - before)
        sp.sync((k_out, v_out, counts))
    return (k_out.view(B, K, M, hd).permute(0, 2, 1, 3).contiguous(),
            v_out.view(B, K, M, hd).permute(0, 2, 1, 3).contiguous(),
            counts.view(B, K, M).permute(0, 2, 1).contiguous())


def attend_compressed(q, k_c, v_c, counts, scale=None):
    """Reference attention over a compressed cache with mass correction.

    q: (B, H, hd); k_c/v_c: (B, M, K, hd); counts: (B, M, K).
    Returns (B, H, hd) f32.  Measures the output error of DPC-KV against
    full-cache attention.
    """
    B, H, hd = q.shape
    Kh = k_c.shape[2]
    G = H // Kh
    qg = q.reshape(B, Kh, G, hd).to(torch.float32)
    scale = scale if scale is not None else hd ** -0.5
    logits = torch.einsum("bkgh,bmkh->bkgm", qg, k_c.to(torch.float32))
    ct = counts.permute(0, 2, 1)[:, :, None, :]
    logits = logits * scale + torch.log(torch.clamp_min(ct, 1e-9))
    logits = torch.where(ct > 0, logits, torch.tensor(
        -1e30, dtype=torch.float32, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgm,bmkh->bkgh", probs, v_c.to(torch.float32))
    return out.reshape(B, H, hd)
