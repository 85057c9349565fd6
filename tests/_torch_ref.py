"""Shared float64 references for the tests of the PyTorch port.

Every helper works in numpy float64 on the f32 points the tests hand to
both packages, so a margin computed here is independent of either
package's f32 arithmetic.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch


@contextlib.contextmanager
def single_thread():
    """One intra-op torch thread inside, the setting restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def one_thread():
    """Run a test on one intra-op torch thread, the setting restored
    after.  The schedule emulations issue many small torch ops; where
    several test workers share the machine, each worker's default pool of
    one thread per core makes every such op contend for all the cores,
    which slowed those tests by one to two orders of magnitude.  Results
    do not change: the tests compare integers, orders and exact values
    computed under the same setting."""
    with single_thread():
        yield


def f32_d2cut(d_cut: float) -> float:
    """The threshold both packages compare against: f32(d_cut)**2 in f32."""
    c = np.float32(d_cut)
    return float(c * c)


def pair_d2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(n, m) float64 squared distances."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def near_threshold_rows(x, y, thr: float, margin: float) -> np.ndarray:
    """(n,) bool: the row has a pair whose float64 d2 lies within
    ``margin`` of ``thr`` — where f32 rounding may decide the count."""
    out = np.zeros(len(x), bool)
    for r0 in range(0, len(x), 512):
        d2 = pair_d2(x[r0:r0 + 512], y)
        out[r0:r0 + 512] = (np.abs(d2 - thr) <= margin).any(axis=1)
    return out


def f32_ulp(v: float) -> float:
    """Spacing of f32 values at ``v``."""
    v = np.float32(v)
    return float(np.nextafter(v, np.float32(np.inf)) - v)


def clear_dcut(pts: np.ndarray, target_rho: float = 20.0,
               rel_gap: float = 1e-4) -> float:
    """A d_cut near the ``target_rho`` quantile whose square is farther
    than ``rel_gap`` (relative) from every pair's squared distance, so no
    count depends on rounding: data drawn away from the threshold."""
    n = len(pts)
    d2 = np.sort(pair_d2(pts, pts)[np.triu_indices(n, 1)])
    k = int(min(max(target_rho / n, 1e-4), 0.5) * len(d2))
    lo, hi = max(k - 2000, 0), min(k + 2000, len(d2) - 1)
    window = d2[lo:hi + 1]
    gaps = (window[1:] - window[:-1]) / window[1:]
    j = int(np.argmax(gaps))
    assert gaps[j] > 2 * rel_gap, "no clear threshold near the target"
    return float(np.sqrt(0.5 * (window[j] + window[j + 1])))


def uniform_points(n: int, d: int, seed: int) -> np.ndarray:
    """Unit-scale uniform points, f32: where the expanded form is exact."""
    return np.random.default_rng(seed).uniform(size=(n, d)).astype(np.float32)


def assert_same_fit(port, ref, pts, dc, band_margin):
    """Two fitted engines agree: labels, centers and cluster count equal;
    rho equal off the threshold band; parent equal; delta to f32 rounding
    (both sides take sqrt of a direct-difference f32 d2, or stamp d_cut,
    and may sum the dims in another order)."""
    tr, jr = port.result, ref.result
    np.testing.assert_array_equal(port.labels_, np.asarray(ref.labels_))
    np.testing.assert_array_equal(np.asarray(port.clustering.centers),
                                  np.asarray(ref.clustering.centers))
    assert int(port.clustering.num_clusters) == \
        int(ref.clustering.num_clusters) > 0
    band = near_threshold_rows(pts, pts, f32_d2cut(dc), band_margin)
    np.testing.assert_array_equal(np.asarray(tr.rho)[~band],
                                  np.asarray(jr.rho)[~band])
    np.testing.assert_array_equal(np.asarray(tr.parent),
                                  np.asarray(jr.parent))
    np.testing.assert_allclose(np.asarray(tr.delta), np.asarray(jr.delta),
                               rtol=1e-6)


def ref_model_params(rc, seed: int):
    """The reference model's param pytree for config ``rc`` (its names,
    shapes and dtypes, from ``jax.eval_shape`` of its init) filled from a
    numpy seed: weights scaled by 1/sqrt(their first per-layer axis) (the
    first axis after the stack's, for the names under ``layers`` and the
    hybrid family's ``supers`` and ``tail``), the embedding unscaled, norm
    gains small and nonzero.  The port takes the
    same weights through ``repro_torch.carry.model_params``."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(build_model(rc).init, jax.random.PRNGKey(0))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        a = rng.normal(size=s.shape).astype(np.float32)
        if "ln" in name or "norm" in name:
            a *= 0.1
        elif "embed']" not in name or "unembed" in name:
            stacked = any(f"['{k}']" in name
                          for k in ("layers", "supers", "tail"))
            a /= np.sqrt(s.shape[1] if stacked else s.shape[0])
        return jnp.asarray(a).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def strict_jit(fn):
    """``jax.jit(fn)`` compiled with XLA's excess precision off, one
    executable per argument shape: every bf16 operation then rounds to
    bf16 as the jnp code reads, and as the port computes eagerly.  By
    default XLA's CPU compiler keeps f32 across fused bf16 operations,
    which moves a reduced bf16 MoE's logits by up to 2.5 % of their
    largest magnitude from an op-by-op bf16 run; f32 is unchanged."""
    import jax
    import jax.numpy as jnp

    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = str(jax.tree.map(lambda a: (jnp.shape(a), jnp.result_type(a)),
                               args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)
    return call


def as_np(a) -> np.ndarray:
    """A jax or torch array as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, dt: str):
    """Within 1e-5 (f32) or 2e-2 (bf16) of the largest |want|."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= (1e-5 if dt == "f32" else 2e-2) * scale, (err, scale)


def cache_arrays(cache) -> dict:
    """Name -> array of a cache: a ``KVCache`` (either package's) by its
    fields, a dict as it is; torch tensors cloned."""
    items = cache._asdict() if hasattr(cache, "_asdict") else dict(cache)
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in items.items()}


def decoder_runs(rc, tc, rparams, tparams, toks, steps) -> tuple:
    """The reference's and the port's prefill of ``toks`` (B, L) and one
    decode step per column of ``steps`` (B, n) on the same weights:
    (ref, got), each a list of (f32 logits, name -> cache array) after
    the prefill and after every step.  The reference runs under
    ``strict_jit``."""
    import jax.numpy as jnp
    from repro.models import build_model as rbuild
    from repro_torch.models import build_model as tbuild

    B, L = toks.shape
    S = L + steps.shape[1]
    rm, tm = rbuild(rc), tbuild(tc)
    prefill, decode = strict_jit(rm.prefill), strict_jit(rm.decode_step)
    rl, rcache = prefill(rparams, {"tokens": jnp.asarray(toks)},
                         rm.init_cache(B, S))
    ref = [(rl, cache_arrays(rcache))]
    for i in range(steps.shape[1]):
        rl, rcache = decode(rparams, rcache, jnp.asarray(steps[:, i:i + 1]),
                            jnp.int32(L + i))
        ref.append((rl, cache_arrays(rcache)))
    with torch.inference_mode(), single_thread():
        tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                tm.init_cache(B, S, device="cpu"))
        got = [(tl, cache_arrays(tcache))]
        for i in range(steps.shape[1]):
            tl, tcache = tm.decode_step(
                tparams, tcache, torch.from_numpy(steps[:, i:i + 1]).long(),
                L + i)
            got.append((tl, cache_arrays(tcache)))
    return ref, got


def assert_runs_match(ref, got, dt: str, cache_dtypes: dict):
    """Every logit and cache array of ``decoder_runs``'s two lists agree
    (``assert_close``); the port's caches have ``cache_dtypes``."""
    assert len(ref) == len(got)
    for (rl, rcache), (tl, tcache) in zip(ref, got):
        assert tl.dtype == torch.float32
        assert_close(tl, rl, dt)
        assert set(tcache) == set(rcache) == set(cache_dtypes)
        for name, r in rcache.items():
            assert tcache[name].dtype == cache_dtypes[name], name
            assert_close(tcache[name], r, dt)
