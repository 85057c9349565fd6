"""The port's Mamba-2 family (``repro_torch.models.ssm``) against the JAX
package's on the same weights.

Reduced mamba2-130m (d_inner 128, 8 SSD heads of 16, state 16, chunk 8),
f32 and bf16, with weights of the reference's pytree from a numpy seed,
carried with ``carry.model_params``: a 40-token prompt's prefill logits
(5 chunks), the filled ``{"conv", "state"}`` cache and four decode steps
agree within 1e-5 (f32) or 2e-2 (bf16) of the largest magnitude (the
reference compiled with XLA's excess precision off, ``strict_jit``).
``_ssd_chunked`` over several chunks; the prefill's final state, which
both packages take from one cumsum over the prompt, against the decode
recurrence run token by token; a prompt that is not a multiple of the
chunk raises (``ValueError``; the reference asserts); ``init_params``
gives the reference's ``A_log``, ``D`` and ``dt_bias`` bit for bit.
``ServeEngine`` gives the reference's greedy and temperature 0.7 tokens
and refuses ``compress_prompt_cache`` on the dict cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import (assert_close, assert_runs_match, decoder_runs,
                        one_thread, ref_model_params,  # noqa: F401
                        single_thread)
from repro import configs as rconfigs
from repro.models import build_model as rbuild
from repro.models import ssm as rssm
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.dpc_kv import DPCKVConfig as RefKV
from repro_torch import carry
from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.models import ssm as tssm
from repro_torch.serve import DPCKVConfig, ServeConfig, ServeEngine

B, PROMPT, STEPS = 2, 40, 4
ARCH = "mamba2-130m"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dt: str, arch: str = ARCH, reduce: bool = True):
    jd, td = DTYPES[dt]
    rc, tc = rconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    if reduce:
        rc, tc = rconfigs.reduce_config(rc), tconfigs.reduce_config(tc)
    return rc.replace(dtype=jd), tc.replace(dtype=td)


def _carried(rc, tc, seed: int = 0):
    rparams = ref_model_params(rc, seed)
    return rparams, carry.model_params(tc, jax.tree.map(np.asarray, rparams))


def _tokens(vocab: int, seed: int, L: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, L)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def ssm_runs():
    out = {}
    for dt in DTYPES:
        rc, tc = _cfgs(dt)
        rparams, tparams = _carried(rc, tc)
        out[dt] = decoder_runs(rc, tc, rparams, tparams,
                               _tokens(rc.vocab, 1, PROMPT),
                               _tokens(rc.vocab, 2, STEPS))
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
def test_prefill_and_decode_match_reference(ssm_runs, dt):
    ref, got = ssm_runs[dt]
    assert len(got) == STEPS + 1 and got[0][0].shape == (B, 128)
    assert_runs_match(ref, got, dt, {"conv": DTYPES[dt][1],
                                     "state": torch.float32})
    assert got[0][1]["conv"].shape == (2, B, 3, 128 + 2 * 16)
    assert got[0][1]["state"].shape == (2, B, 8, 16, 16)


def test_ssd_chunked_matches_reference(one_thread):
    """Five chunks of 8 on random inputs (dt after a softplus)."""
    rng = np.random.default_rng(3)
    L, H, P, N = 40, 8, 16, 16
    xh = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    Bm = rng.normal(size=(B, L, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, 1, N)).astype(np.float32)
    A_log = rng.normal(size=(H,)).astype(np.float32)
    want = jax.jit(lambda *a: rssm._ssd_chunked(*a, 8))(
        *(jnp.asarray(a) for a in (xh, dtv, Bm, Cm, A_log)))
    got = tssm._ssd_chunked(*(torch.from_numpy(a) for a in
                              (xh, dtv, Bm, Cm, A_log)), 8)
    assert got.dtype == torch.float32
    assert_close(got, want, "f32")
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm._ssd_chunked(*(torch.from_numpy(a[:, :20]) for a in
                            (xh, dtv, Bm, Cm)), torch.from_numpy(A_log), 8)


def test_prefill_state_is_the_recurrence(ssm_runs, one_thread):
    """The prefill's final state (a cumsum over the whole prompt, not the
    chunk scan's carry) equals the reference's and the state the decode
    step's recurrence reaches over the same prompt, token by token."""
    rc, tc = _cfgs("f32")
    _, tparams = _carried(rc, tc)
    toks = torch.from_numpy(_tokens(rc.vocab, 1, PROMPT))
    ref, got = ssm_runs["f32"]
    assert_close(got[0][1]["state"], ref[0][1]["state"], "f32")
    with torch.inference_mode():
        cache = tssm.init_cache(tc, B, PROMPT, device="cpu")
        for i in range(PROMPT):
            logits, cache = tssm.decode_step(tparams, cache,
                                             toks[:, i:i + 1], i, tc)
    np.testing.assert_allclose(cache["state"].numpy(),
                               got[0][1]["state"].numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(cache["conv"].numpy(),
                               got[0][1]["conv"].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), got[0][0].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_prompt_not_a_chunk_multiple_raises(one_thread):
    rc, tc = _cfgs("f32")
    rparams, tparams = _carried(rc, tc)
    toks = _tokens(rc.vocab, 1, 20)          # chunk 8
    with pytest.raises(AssertionError):
        rssm.prefill(rparams, jnp.asarray(toks), rc,
                     rssm.init_cache(rc, B, 24))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.prefill(tparams, torch.from_numpy(toks), tc,
                     tssm.init_cache(tc, B, 24, device="cpu"))


@pytest.mark.parametrize("reduce", [True, False], ids=["reduced", "full"])
def test_init_params_fixed_tensors_bit_for_bit(reduce):
    """A_log = log(linspace(1, 16, H)), D = 1 and dt_bias =
    log(expm1(0.01)) as the reference's init computes them (H = 8 and, at
    full width, 24), and the port's init otherwise in the reference's
    shapes and dtypes, on the card unless asked."""
    rc, tc = _cfgs("bf16", reduce=reduce)
    want = rssm.init_layer_params(rc, jax.random.PRNGKey(0))
    got = tssm.init_params(tc.replace(n_layers=1, vocab=8), 0, device="cpu")
    for k in ("A_log", "D", "dt_bias"):
        w = np.asarray(want[k])
        g = got.layers[k][0]
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.view(np.int32))
    H = tssm._dims(tc)[1]
    shapes = tssm.param_shapes(tc)
    assert shapes["layers.A_log"] == (tc.n_layers, H)
    if reduce and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tssm.init_params(tc, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tssm.init_cache(tc, 1, 8)


def _engines(temperature: float):
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
    return ref, port, prompts


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_serve_engine_matches_reference(temperature):
    ref, port, prompts = _engines(temperature)
    want = ref.generate(prompts)
    with single_thread():
        got = port.generate(prompts)
    assert got.shape == (3, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert isinstance(port.cache, dict) and set(port.cache) == {"conv",
                                                                "state"}
    if temperature:
        return
    # the dict cache is O(1) in length: DPC-KV does not apply
    with pytest.raises(AssertionError, match="KVCache"):
        ref.compress_prompt_cache()
    with pytest.raises(ValueError, match="KVCache"):
        port.compress_prompt_cache()
    assert carry.model_cache(jax.tree.map(np.asarray, ref.cache)).keys() \
        == port.cache.keys()
