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


# ----------------------------------------------------------------- training
TRAIN_DTYPES = {"f32": ("float32", torch.float32, 1e-5, 1e-4),
                "bf16": ("bfloat16", torch.bfloat16, 2e-2, 2e-2)}


def train_cfgs(arch: str, dt: str):
    """(reference, port) ``reduce_config`` of ``arch`` in dtype ``dt``."""
    import jax.numpy as jnp
    from repro import configs as rconfigs
    from repro_torch import configs as tconfigs

    rc = rconfigs.reduce_config(rconfigs.ARCHS[arch]).replace(
        dtype=getattr(jnp, TRAIN_DTYPES[dt][0]))
    tc = tconfigs.reduce_config(tconfigs.ARCHS[arch]).replace(
        dtype=TRAIN_DTYPES[dt][1])
    return rc, tc


def dispatch_modes(mode):
    """Both packages' MoE dispatch mode inside (``None``: unchanged)."""
    from repro.models import moe as rmoe
    from repro_torch.models import moe as tmoe

    stack = contextlib.ExitStack()
    if mode is not None:
        stack.enter_context(rmoe.dispatch_mode(mode))
        stack.enter_context(tmoe.dispatch_mode(mode))
    return stack


def port_loss_and_grads(tc, tparams, tbatch, mode=None, **kw):
    """The port's f32 ``loss_fn`` and name -> gradient (zeros where the
    loss does not use a parameter, as JAX gives), one thread."""
    from repro_torch.models import build_model

    tparams.requires_grad_(True)
    named = dict(tparams.named_parameters())
    with dispatch_modes(mode), single_thread():
        loss = build_model(tc).loss_fn(tparams, tbatch, **kw)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    materialize_grads=True)
    return loss.detach(), dict(zip(named, grads))


def loss_grad_runs(arch: str, dt: str, mode=None, batch: int = 2,
                   seq: int = 48, seed: int = 7) -> dict:
    """The reference's ``jax.value_and_grad`` of its ``loss_fn`` (under
    ``jax.jit`` in f32; in bf16 under ``strict_jit``, and under
    ``jax.jit`` as a second reading of its own precision) and the port's,
    on ``ref_model_params`` carried across and the reference
    ``TokenPipeline``'s batch 0 (seed 3)."""
    import jax
    import jax.numpy as jnp
    from repro.data.tokens import TokenPipeline
    from repro.models import build_model as rbuild
    from repro_torch import carry

    rc, tc = train_cfgs(arch, dt)
    rparams = ref_model_params(rc, seed)
    np_batch = TokenPipeline(rc, batch, seq, seed=3).batch_at(0)
    rm = rbuild(rc)
    vg = jax.value_and_grad(lambda p, b: rm.loss_fn(p, b))
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    out = {}
    with dispatch_modes(mode):
        rloss, rgrads = (jax.jit(vg) if dt == "f32" else strict_jit(vg))(
            rparams, jb)
        if dt == "bf16":
            out["rgrads_xla"] = {n: as_np(g) for n, g in carry._flat(
                jax.jit(vg)(rparams, jb)[1])}
    tparams = carry.model_params(tc, jax.tree.map(np.asarray, rparams))
    tbatch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    tloss, tgrads = port_loss_and_grads(tc, tparams, tbatch, mode)
    out.update(tc=tc, tparams=tparams, tbatch=tbatch, mode=mode,
               rloss=float(rloss),
               rgrads={n: as_np(g) for n, g in carry._flat(rgrads)},
               tloss=tloss, tgrads=tgrads)
    return out


def assert_loss_matches(r: dict, dt: str):
    """The port's loss within the dtype's share (1e-5 f32, 2e-2 bf16) of
    the reference's, relative."""
    assert r["tloss"].dtype == torch.float32 and r["tloss"].shape == ()
    assert np.isfinite(r["rloss"])
    assert abs(float(r["tloss"]) - r["rloss"]) <= \
        TRAIN_DTYPES[dt][2] * abs(r["rloss"]), (float(r["tloss"]),
                                                r["rloss"])


def assert_grads_match(r: dict, dt: str):
    """Every leaf's gradient in its parameter's dtype, within the dtype's
    share (1e-4 f32, 2e-2 bf16) of the leaf's largest reference |g|.  In
    bf16 the reference's own two compilations (``strict_jit`` and
    ``jax.jit``) may disagree by more on a gradient summed over many
    positions in bf16 (mamba2's ``conv_b``: 8.3 % of its largest |g|);
    that disagreement is added to the bound."""
    assert set(r["tgrads"]) == set(r["rgrads"])
    for name, want in r["rgrads"].items():
        got = r["tgrads"][name]
        assert got.dtype == r["tparams"].get_parameter(name).dtype, name
        got = as_np(got)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        bound = TRAIN_DTYPES[dt][3] * np.abs(want).max()
        if "rgrads_xla" in r:
            bound += np.abs(r["rgrads_xla"][name] - want).max()
        err = np.abs(got - want).max()
        assert err <= bound, (name, err, bound)


def assert_remat_changes_no_bit(r: dict):
    """The port's loss and gradients with each layer recomputed in the
    backward pass equal those with the activations kept, bit for bit."""
    args = (r["tc"], r["tparams"], r["tbatch"], r["mode"])
    loss_off, off = port_loss_and_grads(*args, remat=False)
    loss_on, on = port_loss_and_grads(*args, remat=True)
    assert torch.equal(loss_on, loss_off) and torch.equal(loss_on,
                                                          r["tloss"])
    for name in off:
        assert torch.equal(on[name], off[name]), name
        assert torch.equal(on[name], r["tgrads"][name]), name
