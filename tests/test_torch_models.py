"""The port's dense model family (``repro_torch.models``, ``configs``)
against the JAX package's on the same weights.

Each reduced architecture gets weights of the reference's pytree shapes
and dtypes drawn from a numpy seed, the port the same weights through
``carry.model_params``, and both run on the same tokens:
prefill logits, the filled cache and four decode steps within rtol/atol
1e-5 in f32, within 2e-2 of the largest |logit| in bf16.  h2o-danube's
sliding window of 32 wraps inside the 48 positions (a 44-token prompt and
four steps); paligemma prefills image patches as a bidirectional prefix;
hubert encodes frames.  All inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import one_thread, ref_model_params  # noqa: F401
from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import build_model as rbuild
from repro.models import transformer as rtfm
from repro_torch import carry
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer as ttfm

B, PROMPT, STEPS = 2, 44, 4
DECODERS = ("gemma-2b", "granite-8b", "phi3-mini-3.8b", "h2o-danube-1.8b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch: str, dt: str):
    jd, td = DTYPES[dt]
    rc = rconfigs.reduce_config(rconfigs.ARCHS[arch]).replace(dtype=jd)
    tc = tconfigs.reduce_config(tconfigs.ARCHS[arch]).replace(dtype=td)
    return rc, tc


def _np(a) -> np.ndarray:
    """A jax or torch array as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dt: str, scale=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(want).max() if scale is None else scale
        assert np.abs(got - want).max() <= 2e-2 * scale, \
            (np.abs(got - want).max(), scale)


def _carried(rc, tc, seed: int = 0):
    rparams = ref_model_params(rc, seed)
    tparams = carry.model_params(tc, jax.tree.map(np.asarray, rparams))
    return rparams, tparams


def _tokens(vocab: int, seed: int, L: int = PROMPT) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, L)) \
        .astype(np.int32)


def test_archs_and_shapes_match_reference():
    assert list(tconfigs.ARCHS) == list(rconfigs.ARCHS)
    for name, rc in rconfigs.ARCHS.items():
        tc = tconfigs.ARCHS[name]
        want = {k: v for k, v in dataclasses.asdict(rc).items()
                if k != "dtype"}
        got = {k: v for k, v in dataclasses.asdict(tc).items()
               if k != "dtype"}
        assert got == want, name
        assert tc.dtype == torch.bfloat16 and rc.dtype == jnp.bfloat16
        red = {k: v for k, v in dataclasses.asdict(
            tconfigs.reduce_config(tc)).items() if k != "dtype"}
        assert red == {k: v for k, v in dataclasses.asdict(
            rconfigs.reduce_config(rc)).items() if k != "dtype"}, name
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    assert tconfigs.SUB_QUADRATIC == rconfigs.SUB_QUADRATIC
    assert tconfigs.cells() == rconfigs.cells()
    with pytest.raises(KeyError):
        tconfigs.get("gpt-5")
    assert tconfigs.get("gemma-2b") is tconfigs.ARCHS["gemma-2b"]


@pytest.fixture(scope="module")
def decoder_runs():
    """Per (arch, dtype): the reference's prefill logits, filled cache and
    decode-step logits/caches, and the port's on the carried weights."""
    out = {}
    for arch in DECODERS:
        for dt in DTYPES:
            rc, tc = _cfgs(arch, dt)
            rparams, tparams = _carried(rc, tc)
            toks = _tokens(rc.vocab, 1)
            steps = _tokens(rc.vocab, 2, STEPS)
            prefill = jax.jit(lambda p, t, c: rtfm.prefill(p, t, rc, c))
            decode = jax.jit(lambda p, c, t, pos: rtfm.decode_step(
                p, c, t, pos, rc))
            rcache = rtfm.init_cache(rc, B, PROMPT + STEPS)
            rl, rcache = prefill(rparams, jnp.asarray(toks), rcache)
            ref = [(rl, rcache)]
            for i in range(STEPS):
                rl, rcache = decode(rparams, rcache,
                                    jnp.asarray(steps[:, i:i + 1]),
                                    jnp.int32(PROMPT + i))
                ref.append((rl, rcache))
            with torch.inference_mode():
                tcache = ttfm.init_cache(tc, B, PROMPT + STEPS, device="cpu")
                tl, tcache = ttfm.prefill(tparams, torch.from_numpy(toks),
                                          tc, tcache)
                got = [(tl, tuple(t.clone() for t in tcache))]
                for i in range(STEPS):
                    tl, tcache = ttfm.decode_step(
                        tparams, tcache,
                        torch.from_numpy(steps[:, i:i + 1]).long(),
                        PROMPT + i, tc)
                    got.append((tl, tuple(t.clone() for t in tcache)))
            out[arch, dt] = (ref, got)
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(decoder_runs, arch, dt):
    ref, got = decoder_runs[arch, dt]
    assert len(ref) == len(got) == STEPS + 1
    for (rl, rcache), (tl, tcache) in zip(ref, got):
        assert tl.dtype == torch.float32 and tl.shape == (B, 128)
        _close(tl, rl, dt)
        assert tcache[0].dtype == DTYPES[dt][1]
        for r, t in zip(rcache, tcache):
            _close(t, r, dt)


def test_window_ring_wraps(decoder_runs):
    """h2o-danube's ring holds 32 slots; prefill wrote the last 32 of 44
    positions from slot 0, and the steps write slots 12-15."""
    ref, got = decoder_runs["h2o-danube-1.8b", "f32"]
    assert got[0][1][0].shape[2] == 32
    before, after = got[0][1][0], got[-1][1][0]
    changed = (before != after).any(dim=(0, 1, 3, 4))
    assert changed.nonzero().flatten().tolist() == [12, 13, 14, 15]


def test_chunked_prefill_matches_reference():
    """Attention chunked over the query axis (q_chunk 11 of 44)."""
    rc, tc = _cfgs("gemma-2b", "f32")
    rparams, tparams = _carried(rc, tc, seed=3)
    toks = _tokens(rc.vocab, 4)
    rl, rcache = jax.jit(lambda p, t, c: rtfm.prefill(p, t, rc, c,
                                                      q_chunk=11))(
        rparams, jnp.asarray(toks), rtfm.init_cache(rc, B, PROMPT))
    with torch.inference_mode():
        tl, tcache = ttfm.prefill(tparams, torch.from_numpy(toks), tc,
                                  ttfm.init_cache(tc, B, PROMPT,
                                                  device="cpu"),
                                  q_chunk=11)
    _close(tl, rl, "f32")
    _close(tcache.k, rcache.k, "f32")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_vlm_prefill_matches_reference(dt):
    rc, tc = _cfgs("paligemma-3b", dt)
    rparams, tparams = _carried(rc, tc, seed=5)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, rc.vocab, (B, 12)).astype(np.int32)
    patches = rng.normal(size=(B, rc.num_patches, rc.frontend_dim)) \
        .astype(np.float32)
    S = rc.num_patches + 12 + 2
    rmodel, tmodel = rbuild(rc), tbuild(tc)
    rl, rcache = jax.jit(rmodel.prefill)(
        rparams, {"tokens": jnp.asarray(toks),
                  "patches": jnp.asarray(patches)}, rmodel.init_cache(B, S))
    rl2, rcache = jax.jit(rmodel.decode_step)(
        rparams, rcache, jnp.asarray(toks[:, :1]), jnp.int32(S - 2))
    with torch.inference_mode():
        tl, tcache = tmodel.prefill(tparams, {
            "tokens": torch.from_numpy(toks),
            "patches": torch.from_numpy(patches)},
            tmodel.init_cache(B, S, device="cpu"))
        tl2, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.from_numpy(toks[:, :1]).long(),
                                         S - 2)
    _close(tl, rl, dt)
    _close(tl2, rl2, dt)
    _close(tcache.v, rcache.v, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_encoder_matches_reference(dt):
    rc, tc = _cfgs("hubert-xlarge", dt)
    rparams, tparams = _carried(rc, tc, seed=7)
    feats = np.random.default_rng(8).normal(size=(B, 20, rc.frontend_dim)) \
        .astype(np.float32)
    want = jax.jit(lambda p, b: rtfm.encode_step(p, b, rc))(
        rparams, {"features": jnp.asarray(feats)})
    tmodel = tbuild(tc)
    assert not tmodel.is_decoder and tmodel.init_cache is None
    with torch.inference_mode():
        got = ttfm.encode_step(tparams, {"features": torch.from_numpy(feats)},
                               tc)
    assert got.shape == (B, 20, rc.vocab)
    _close(got, want, dt)


def test_attn_mask_equal(one_thread):
    rng = np.random.default_rng(9)
    for causal in (True, False):
        for window in (None, 5):
            for prefix in (None, 3):
                qp = rng.integers(0, 20, (2, 7)).astype(np.int32)
                kp = rng.integers(-3, 20, (2, 11)).astype(np.int32)
                kv = rng.random((2, 11)) < 0.8
                want = rattn.attn_mask(jnp.asarray(qp), jnp.asarray(kp),
                                       causal=causal, window=window,
                                       prefix_len=prefix,
                                       k_valid=jnp.asarray(kv))
                got = tattn.attn_mask(torch.from_numpy(qp),
                                      torch.from_numpy(kp), causal=causal,
                                      window=window, prefix_len=prefix,
                                      k_valid=torch.from_numpy(kv))
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_carry_round_trip(dt):
    """Carried weights keep the reference's names, shapes, dtypes and
    bits; a port init has the same shapes and dtypes."""
    rc, tc = _cfgs("paligemma-3b", dt)
    rparams, tparams = _carried(rc, tc, seed=11)
    flat = {"layers." + k: v for k, v in rparams["layers"].items()}
    flat.update({k: v for k, v in rparams.items() if k != "layers"})
    state = tparams.state_dict()
    assert set(state) == set(flat)
    for name, r in flat.items():
        r = np.asarray(r)
        t = state[name]
        assert tuple(t.shape) == r.shape and t.dtype == tc.dtype, name
        bits = t.view(torch.int16 if dt == "bf16" else torch.int32).numpy()
        np.testing.assert_array_equal(
            bits, r.view(np.int16 if dt == "bf16" else np.int32))
    init = ttfm.init_params(tc, 0, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            init.state_dict().items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
    rk = jax.random.normal(jax.random.PRNGKey(0), (B, 3, 1, 16), jnp.float32)
    kv = carry.kv_cache(rattn.KVCache(k=np.asarray(rk), v=np.asarray(rk)))
    np.testing.assert_array_equal(kv.k.numpy(), np.asarray(rk))


def test_init_params_on_the_host(one_thread):
    """The port's own init: zero norm gains, truncated normals scaled by
    1/sqrt(fan_in), the same draws for the same seed; on the card unless
    asked, so it raises here without one."""
    tc = tconfigs.reduce_config(tconfigs.ARCHS["granite-8b"])
    a = ttfm.init_params(tc, 3, device="cpu")
    b = ttfm.init_params(tc, 3, device="cpu")
    c = ttfm.init_params(tc, 4, device="cpu")
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if "ln" in name or name == "final_norm":
            assert not x.any(), name
            continue
        assert not torch.equal(x, z), name
        xf = x.float()
        fan = 1.0 if name == "embed" else x.shape[1 if name.startswith(
            "layers.") else 0]
        assert xf.abs().max() <= 2.0 / fan ** 0.5 * 1.01, name
        assert 0.6 < float(xf.std()) * fan ** 0.5 < 1.1, name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttfm.init_params(tc, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttfm.init_cache(tc, 1, 8)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                                  "mamba2-130m", "recurrentgemma-9b"])
def test_every_family_builds(arch):
    """The moe, ssm and hybrid families build decoders (their numerics:
    tests/test_torch_moe.py, test_torch_ssm.py, test_torch_rglru.py); an
    unknown family raises."""
    model = tbuild(tconfigs.ARCHS[arch])
    assert model.is_decoder and model.cfg is tconfigs.ARCHS[arch]
    tc = tconfigs.reduce_config(tconfigs.ARCHS[arch])
    small = tbuild(tc)
    params = small.init(0, device="cpu")
    cache = small.init_cache(1, 8, device="cpu")
    with torch.inference_mode():
        logits, _ = small.prefill(params, {"tokens": torch.zeros(
            (1, 8), dtype=torch.long)}, cache)
    assert logits.shape == (1, tc.vocab) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="unknown family"):
        tbuild(tconfigs.ARCHS["gemma-2b"].replace(family="mlp"))
