"""The port's serving engine (``repro_torch.serve.engine``) against the
JAX package's, on the same weights and prompts.

f32 ``reduce_config(gemma-2b)`` with weights from a numpy seed (the tied
embedding scaled to keep the logits within a few units), carried
into the port with ``carry.model_params``: greedy tokens equal the
reference's (ragged and over-long prompts included), temperature 0.7
draws the reference's gumbel noise bit for bit and samples its tokens,
and ``compress_prompt_cache`` on one carried cache equals the
reference's (counts exactly, k_c/v_c within one ulp) on every head off
the 4-ulp band around d_cut^2.  With no GPU, ``ServeEngine(device=None)``
raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import f32_ulp, ref_model_params
from repro import configs as rconfigs
from repro.engine import ExecSpec as RefSpec
from repro.models import build_model as rbuild
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import dpc_kv as R
from repro_torch import carry, obs
from repro_torch import configs as tconfigs
from repro_torch.core import threefry
from repro_torch.engine.spec import ExecSpec
from repro_torch.models import build_model as tbuild
from repro_torch.serve import DPCKVConfig, ServeConfig, ServeEngine

B, PROMPT, NEW = 3, 32, 6


def _prompts(vocab: int):
    rng = np.random.default_rng(2)
    return [list(rng.integers(0, vocab, 20)), list(rng.integers(0, vocab, 40)),
            [5]]                     # short, longer than max_prompt, one


def _engines(temperature: float, seed: int = 0, dpc_kv=None,
             ref_dpc_kv=None):
    rc = rconfigs.reduce_config(rconfigs.ARCHS["gemma-2b"]).replace(
        dtype=jnp.float32)
    tc = tconfigs.reduce_config(tconfigs.ARCHS["gemma-2b"]).replace(
        dtype=torch.float32)
    rparams = ref_model_params(rc, 1)
    # a small tied embedding keeps the logits within a few units, so that
    # temperature sampling departs from the argmax
    rparams["embed"] = rparams["embed"] * 0.05
    tparams = carry.model_params(tc, jax.tree.map(np.asarray, rparams))
    kw = dict(batch=B, max_prompt=PROMPT, max_new_tokens=NEW,
              temperature=temperature, seed=seed)
    ref = RefServeEngine(rbuild(rc), rparams,
                         RefServeConfig(dpc_kv=ref_dpc_kv, **kw))
    port = ServeEngine(tbuild(tc), tparams, ServeConfig(dpc_kv=dpc_kv, **kw),
                       device="cpu")
    return ref, port, rc.vocab


@pytest.fixture(scope="module")
def greedy():
    kv = DPCKVConfig(budget=8, exec_spec=ExecSpec(backend="cuda"))
    rkv = R.DPCKVConfig(budget=8, exec_spec=RefSpec(backend="jnp"))
    ref, port, vocab = _engines(0.0, dpc_kv=kv, ref_dpc_kv=rkv)
    prompts = _prompts(vocab)
    return ref, port, ref.generate(prompts), port.generate(prompts), vocab


def test_greedy_tokens_match_reference(greedy):
    ref, port, want, got, vocab = greedy
    assert got.shape == (B, NEW) and got.dtype == np.int32
    assert ((got >= 0) & (got < vocab)).all()
    np.testing.assert_array_equal(got, want)
    # the filled caches agree too (f32 model: rtol/atol 1e-5)
    np.testing.assert_allclose(port.cache.k.numpy(), np.asarray(ref.cache.k),
                               rtol=1e-5, atol=1e-5)


def test_temperature_sampling_matches_reference():
    """The gumbel noise bit for bit, and the sampled tokens equal."""
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        _, sub = jax.random.split(key)
        want = np.asarray(jax.random.gumbel(sub, (B, 128), jnp.float32))
        got = threefry.gumbel(threefry.split(threefry.prng_key(seed))[1],
                              (B, 128)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    ref, port, vocab = _engines(0.7, seed=3)
    prompts = _prompts(vocab)
    want = ref.generate(prompts)
    got = port.generate(prompts)
    np.testing.assert_array_equal(got, want)
    greedy_port = _engines(0.0)[1].generate(prompts)
    assert not np.array_equal(got, greedy_port)


def test_compress_prompt_cache_matches_reference(greedy):
    """One cache (the reference's, carried) compressed by both: equal on
    every head off the 4-ulp band around d_cut^2."""
    ref, port, _, _, _ = greedy
    port.cache = carry.kv_cache(jax.tree.map(np.asarray, ref.cache))
    rk, rv, rc = (np.asarray(a) for a in ref.compress_prompt_cache())
    spans_before = len(obs.spans())
    obs.configure(level="metrics")
    try:
        k_c, v_c, counts = port.compress_prompt_cache()
    finally:
        obs.configure(level="off")
    sp = [s for s in obs.spans()[spans_before:]
          if s["name"] == "serve.compress"]
    assert sp and sp[-1]["attrs"]["heads"] == 2 * B
    assert sp[-1]["attrs"]["launches"] == 0      # plain versions: no launch
    L, _, M, K = rc.shape
    assert k_c.shape == (L, B, M, K, 16) and counts.shape == (L, B, M, K)
    assert float(counts.max()) <= PROMPT
    # the band, from the reference's projected points of each head
    S = ref.cache.k.shape[2]
    keys = np.asarray(ref.cache.k).reshape(L * B, S, K, 16)
    off = np.ones((L * B, K), bool)
    for h in range(L * B):
        for kk in range(K):
            pts = np.asarray(R._project(jnp.asarray(keys[h, :PROMPT, kk]), 4))
            d_cut = float(R._dcut_estimate(jnp.asarray(np.concatenate(
                [pts, np.zeros((S - PROMPT, 4), np.float32)])), 0.05))
            thr = float(np.float32(d_cut) ** 2)
            x = pts.astype(np.float64)
            d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
            off[h, kk] = not (np.abs(d2 - thr) <= 4 * f32_ulp(thr)).any()
    assert off.sum() >= off.size - 1, off
    off = off.reshape(L, B, K)
    np.testing.assert_array_equal(counts.numpy().transpose(0, 1, 3, 2)[off],
                                  rc.transpose(0, 1, 3, 2)[off])
    for g, w in ((k_c, rk), (v_c, rv)):
        g = g.numpy().transpose(0, 1, 3, 2, 4)[off]
        w = w.transpose(0, 1, 3, 2, 4)[off]
        assert np.all(np.abs(g - w) <= 2.0 ** -23 * np.abs(w))


def test_engine_needs_a_card_or_cpu():
    tc = tconfigs.reduce_config(tconfigs.ARCHS["gemma-2b"])
    model = tbuild(tc)
    params = model.init(0, device="cpu")
    cfg = ServeConfig(batch=1, max_prompt=8, max_new_tokens=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(model, params, cfg)
    eng = ServeEngine(model, params, cfg, device="cpu")
    out = eng.generate([[1, 2, 3]])
    assert out.shape == (1, 2) and eng.cache.k.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dpc_kv"):
        eng.compress_prompt_cache()
    with pytest.raises(ValueError, match="prompts"):
        eng.generate([[1]] * 2)
    enc = tbuild(tconfigs.reduce_config(tconfigs.ARCHS["hubert-xlarge"]))
    with pytest.raises(ValueError, match="cannot decode"):
        ServeEngine(enc, enc.init(0, device="cpu"), cfg, device="cpu")


def test_unported_family_raises():
    """Every family of the ten configurations builds a model now (mamba2
    serves on the CPU, its dict cache refusing DPC-KV); a family the port
    does not know raises."""
    with pytest.raises(ValueError, match="unknown family"):
        tbuild(tconfigs.ARCHS["mamba2-130m"].replace(family="mlp"))
    model = tbuild(tconfigs.reduce_config(tconfigs.ARCHS["mamba2-130m"]))
    eng = ServeEngine(model, model.init(0, device="cpu"),
                      ServeConfig(batch=1, max_prompt=8, max_new_tokens=2,
                                  dpc_kv=DPCKVConfig(budget=4)),
                      device="cpu")
    assert eng.generate([[1, 2, 3]]).shape == (1, 2)
    with pytest.raises(ValueError, match="KVCache"):
        eng.compress_prompt_cache()
