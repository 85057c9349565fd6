"""The port's RecurrentGemma hybrid family (``repro_torch.models.rglru``)
against the JAX package's on the same weights.

Reduced recurrentgemma-9b (5 layers: one (rec, rec, attn) superblock and
a tail of 2 rec, rnn width 64, local window 16), f32 and bf16, with
weights of the reference's pytree (``supers``/``tail`` stacks) from a
numpy seed, carried with ``carry.model_params``: a 44-token prompt (the
window of 16 wraps the ring), its prefill logits, every cache tensor and
four decode steps agree within 1e-5 (f32) or 2e-2 (bf16) of the largest
magnitude (the reference compiled with XLA's excess precision off,
``strict_jit``).  ``_rglru_scan`` alone, including gates near 1 where
sqrt(1 - a^2) cancels; the shrunken ring after a prompt shorter than the
cache (prompt 24, window 64: 24 slots, both packages).  ``ServeEngine``
gives the reference's greedy and temperature 0.7 tokens and refuses
``compress_prompt_cache`` on the dict cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import (assert_close, assert_runs_match, cache_arrays,
                        decoder_runs, one_thread,  # noqa: F401
                        ref_model_params, single_thread)
from repro import configs as rconfigs
from repro.models import build_model as rbuild
from repro.models import rglru as rrg
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.dpc_kv import DPCKVConfig as RefKV
from repro_torch import carry
from repro_torch import configs as tconfigs
from repro_torch.core.threefry import _exp
from repro_torch.models import build_model as tbuild
from repro_torch.models import rglru as trg
from repro_torch.serve import DPCKVConfig, ServeConfig, ServeEngine

B, PROMPT, STEPS = 2, 44, 4
ARCH = "recurrentgemma-9b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dt: str, **kw):
    jd, td = DTYPES[dt]
    rc = rconfigs.reduce_config(rconfigs.ARCHS[ARCH]).replace(dtype=jd, **kw)
    tc = tconfigs.reduce_config(tconfigs.ARCHS[ARCH]).replace(dtype=td, **kw)
    return rc, tc


def _carried(rc, tc, seed: int = 0):
    rparams = ref_model_params(rc, seed)
    return rparams, carry.model_params(tc, jax.tree.map(np.asarray, rparams))


def _tokens(vocab: int, seed: int, L: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, L)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def hybrid_runs():
    out = {}
    for dt in DTYPES:
        rc, tc = _cfgs(dt)
        rparams, tparams = _carried(rc, tc)
        out[dt] = decoder_runs(rc, tc, rparams, tparams,
                               _tokens(rc.vocab, 1, PROMPT),
                               _tokens(rc.vocab, 2, STEPS))
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
def test_prefill_and_decode_match_reference(hybrid_runs, dt):
    ref, got = hybrid_runs[dt]
    assert len(got) == STEPS + 1 and got[0][0].shape == (B, 128)
    td, f32 = DTYPES[dt][1], torch.float32
    assert_runs_match(ref, got, dt, {
        "conv1": td, "h1": f32, "conv2": td, "h2": f32, "k": td, "v": td,
        "tconv": td, "th": f32})
    cache = got[0][1]
    assert cache["k"].shape == (1, B, 16, 1, 16)      # the window's ring
    assert cache["tconv"].shape == (2, B, 3, 64) and cache["th"].shape == \
        (2, B, 64)
    # the steps write ring slots 44 % 16 .. 47 % 16
    changed = (got[0][1]["k"] != got[-1][1]["k"]).any(dim=(0, 1, 3, 4))
    assert changed.nonzero().flatten().tolist() == [12, 13, 14, 15]


def test_rglru_scan_matches_reference(one_thread):
    """The associative scan over 44 and 45 steps (odd and even levels),
    with gates r from 0 to 1: where r is near 0, a nears 1 and
    sqrt(1 - exp(2 log a)) cancels, so the port takes XLA's exp."""
    rng = np.random.default_rng(3)
    for L in (44, 45):
        x = rng.normal(size=(B, L, 64)).astype(np.float32)
        r = rng.uniform(size=(B, L, 64)).astype(np.float32)
        r[:, ::3] *= 1e-4
        i = rng.uniform(size=(B, L, 64)).astype(np.float32)
        lam = rng.normal(size=(64,)).astype(np.float32)
        want = jax.jit(rrg._rglru_scan)(*(jnp.asarray(a)
                                          for a in (x, r, i, lam)))
        got = trg._rglru_scan(*(torch.from_numpy(a) for a in (x, r, i, lam)))
        assert got.shape == (B, L, 64)
        assert_close(got, want, "f32")
    v = np.concatenate([-np.geomspace(1e-9, 80.0, 20000),
                        np.linspace(-80.0, 80.0, 20001)]).astype(np.float32)
    np.testing.assert_array_equal(
        _exp(torch.from_numpy(v)).numpy().view(np.int32),
        np.asarray(jax.jit(jnp.exp)(v)).view(np.int32))


def test_prefill_shrinks_the_ring(one_thread):
    """A prompt of 24 in a cache of min(24 + 4, 64) = 28 slots: both
    packages keep a ring of 24 after the prefill, and decode treats those
    24 slots as the whole ring."""
    rc, tc = _cfgs("f32", local_window=64)
    rparams, tparams = _carried(rc, tc, seed=4)
    toks = _tokens(rc.vocab, 5, 24)
    steps = _tokens(rc.vocab, 6, 4)
    rm, tm = rbuild(rc), tbuild(tc)
    assert rm.init_cache(B, 28)["k"].shape[2] == 28
    assert tm.init_cache(B, 28, device="cpu")["k"].shape[2] == 28
    ref, got = decoder_runs(rc, tc, rparams, tparams, toks, steps)
    assert ref[0][1]["k"].shape == (1, B, 24, 1, 16)
    assert tuple(got[0][1]["k"].shape) == (1, B, 24, 1, 16)
    assert_runs_match(ref, got, "f32", {
        n: t.dtype for n, t in got[0][1].items()})


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_serve_engine_matches_reference(temperature):
    rc, tc = _cfgs("f32")
    rparams = ref_model_params(rc, 1)
    rparams["embed"] = rparams["embed"] * 0.05   # logits of a few units
    tparams = carry.model_params(tc, jax.tree.map(np.asarray, rparams))
    kw = dict(batch=3, max_prompt=32, max_new_tokens=6,
              temperature=temperature, seed=3)
    ref = RefServeEngine(rbuild(rc), rparams,
                         RefServeConfig(dpc_kv=RefKV(budget=8), **kw))
    port = ServeEngine(tbuild(tc), tparams,
                       ServeConfig(dpc_kv=DPCKVConfig(budget=8), **kw),
                       device="cpu")
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(0, rc.vocab, 20)),
               list(rng.integers(0, rc.vocab, 40)), [5]]
    want = ref.generate(prompts)
    with single_thread():
        got = port.generate(prompts)
    assert got.shape == (3, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if temperature:
        return
    # the dict cache keeps O(1) state and a window's ring: no DPC-KV
    with pytest.raises(AssertionError, match="KVCache"):
        ref.compress_prompt_cache()
    with pytest.raises(ValueError, match="KVCache"):
        port.compress_prompt_cache()
    carried = carry.model_cache(jax.tree.map(np.asarray, ref.cache))
    for name, t in cache_arrays(port.cache).items():
        assert_close(t, carried[name], "f32")


def test_carry_and_init_shapes(one_thread):
    """Carried weights keep the reference's nested names (``supers.rec1.*``,
    ``tail.*``), shapes, dtypes (``ba``, ``bi``, ``lam`` f32) and bits; the
    port's own init has the same shapes and dtypes, ``lam`` such that a^c
    lies in [0.9, 0.999] at r = 1."""
    rc, tc = _cfgs("bf16")
    rparams, tparams = _carried(rc, tc, seed=7)
    state = tparams.state_dict()
    flat = dict(carry._flat(rparams))
    assert set(state) == set(flat)
    assert {"supers.rec1.lam", "supers.attn.wq", "tail.wa"} <= set(state)
    for name, r in flat.items():
        r = np.asarray(r)
        assert tuple(state[name].shape) == r.shape, name
        np.testing.assert_array_equal(state[name].float().numpy(),
                                      r.astype(np.float32))
    init = trg.init_params(tc, 0, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            init.state_dict().items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
    assert init.supers["rec1"]["lam"].dtype == torch.float32
    a_c = torch.exp(-8.0 * torch.nn.functional.softplus(init.tail["lam"]))
    assert (a_c >= 0.9 - 1e-6).all() and (a_c <= 0.999 + 1e-6).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trg.init_cache(tc, 1, 8)
