"""The port's MoE family (``repro_torch.models.moe``) against the JAX
package's on the same weights.

Reduced granite-moe-3b-a800m and qwen3-moe-30b-a3b (4 experts, top-2),
f32 and bf16, with weights of the reference's pytree from a numpy seed,
carried into the port with ``carry.model_params``: a 44-token prompt's
prefill logits, the filled cache and four decode steps agree within
rtol/atol 1e-5 in f32 and within 2e-2 of the largest |logit| in bf16 (the
reference compiled with XLA's excess precision off, ``strict_jit``).
``moe_ffn`` alone, ``y`` and the aux loss, in both dispatch modes: a
router biased to one expert (assignments past the capacity dropped), an
all-zero router (the top-k ties resolve to experts 0..k-1) and padded
experts.  ``ServeEngine`` gives the reference's greedy and temperature
0.7 tokens, and ``compress_prompt_cache`` on a carried MoE cache equals
the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import (assert_close, assert_runs_match, decoder_runs,
                        f32_ulp, one_thread, ref_model_params,  # noqa: F401
                        single_thread, strict_jit)
from repro import configs as rconfigs
from repro.engine import ExecSpec as RefSpec
from repro.models import build_model as rbuild
from repro.models import moe as rmoe
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import dpc_kv as R
from repro_torch import carry
from repro_torch import configs as tconfigs
from repro_torch.engine.spec import ExecSpec
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.serve import DPCKVConfig, ServeConfig, ServeEngine

B, PROMPT, STEPS = 2, 44, 4
ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch: str, dt: str, **kw):
    jd, td = DTYPES[dt]
    rc = rconfigs.reduce_config(rconfigs.ARCHS[arch]).replace(dtype=jd, **kw)
    tc = tconfigs.reduce_config(tconfigs.ARCHS[arch]).replace(dtype=td, **kw)
    return rc, tc


def _carried(rc, tc, seed: int = 0):
    rparams = ref_model_params(rc, seed)
    return rparams, carry.model_params(tc, jax.tree.map(np.asarray, rparams))


def _tokens(vocab: int, seed: int, L: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, L)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def moe_runs():
    """Per (arch, dtype): the reference's and the port's prefill and
    decode steps on the carried weights."""
    out = {}
    for arch in ARCHS:
        for dt in DTYPES:
            rc, tc = _cfgs(arch, dt)
            rparams, tparams = _carried(rc, tc)
            out[arch, dt] = decoder_runs(
                rc, tc, rparams, tparams, _tokens(rc.vocab, 1, PROMPT),
                _tokens(rc.vocab, 2, STEPS))
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(moe_runs, arch, dt):
    ref, got = moe_runs[arch, dt]
    assert len(got) == STEPS + 1
    assert got[0][0].shape == (B, 128)
    td = DTYPES[dt][1]
    assert_runs_match(ref, got, dt, {"k": td, "v": td})
    assert got[0][1]["k"].shape == (2, B, PROMPT + STEPS, 4, 16)


def _ffn_case(case: str, dt: str = "f32"):
    """(rc, tc, reference layer params, port layer params, x) for one
    ``moe_ffn`` case on reduced granite-moe (4 experts, top-2)."""
    kw = {"n_experts_padded": 8} if case == "padded" else {}
    rc, tc = _cfgs("granite-moe-3b-a800m", dt, **kw)
    rparams, tparams = _carried(rc, tc, seed=3)
    rlp = jax.tree.map(lambda a: a[0], rparams["layers"])
    x = np.random.default_rng(4).normal(size=(B, PROMPT, rc.d_model)) \
        .astype(np.float32)
    if case == "biased":        # every token's first choice: expert 0
        x = np.abs(x)
        rlp["router"] = rlp["router"].at[:, 0].add(1.0)
    elif case == "zero":        # all probabilities equal: a k-way tie
        rlp["router"] = jnp.zeros_like(rlp["router"])
    tlp = {k: carry._weights(np.asarray(v), "cpu") for k, v in rlp.items()}
    return rc, tc, rlp, tlp, x


@pytest.mark.parametrize("mode", ["gather", "scatter"])
@pytest.mark.parametrize("case", ["biased", "zero", "padded"])
def test_moe_ffn_matches_reference(one_thread, case, mode):
    rc, tc, rlp, tlp, x = _ffn_case(case)
    T = B * PROMPT
    C = tmoe.capacity(tc, T)
    assert C == 64                   # 1.25 x 44, at least 8, rounded to 32
    with rmoe.dispatch_mode(mode):
        ry, raux = jax.jit(lambda x, lp: rmoe.moe_ffn(x, lp, rc, None))(
            jnp.asarray(x), rlp)
    with tmoe.dispatch_mode(mode), torch.inference_mode():
        ty, taux = tmoe.moe_ffn(torch.from_numpy(x), tlp, tc)
    assert tmoe.DISPATCH_MODE == "gather"
    assert_close(ty, ry, "f32")
    assert abs(float(taux) - float(raux)) <= 1e-6 * abs(float(raux))
    probs = torch.softmax(torch.from_numpy(x).reshape(T, -1)
                          @ tlp["router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :tc.top_k]
    per_expert = torch.bincount(top.flatten(), minlength=tc.n_experts)
    if case == "padded":
        assert tlp["w_gate"].shape[0] == 8 > tc.n_experts
    else:
        # T = 88 tokens onto one expert (or two) against C = 64: drops
        assert int(torch.clamp_min(per_expert - C, 0).sum()) > 0
    if case == "zero":
        # jax.lax.top_k's ties: the lower index first, experts 0 and 1
        assert (top == torch.arange(tc.top_k)).all()
        assert float(taux) == float(raux) == 1.0


def test_moe_ffn_bf16_and_aux(one_thread):
    """bf16 activations with the f32 router, gather mode, through
    ``forward``'s aux sum against the reference's."""
    rc, tc = _cfgs("qwen3-moe-30b-a3b", "bf16")
    rparams, tparams = _carried(rc, tc, seed=5)
    x = np.random.default_rng(6).normal(size=(B, 12, rc.d_model)) \
        .astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    pos = jnp.arange(12, dtype=jnp.int32)
    rh, raux = strict_jit(lambda p, x: rmoe.forward(p, x, rc, pos,
                                                     remat=False))(rparams, xb)
    with torch.inference_mode():
        th, taux = tmoe.forward(tparams, carry._weights(np.asarray(xb),
                                                        "cpu"),
                                tc, torch.arange(12, dtype=torch.int32))
    assert th.dtype == torch.bfloat16
    assert_close(th, rh, "bf16")
    assert abs(float(taux) - float(raux)) <= 1e-5 * abs(float(raux))


def _engines(temperature: float, dpc_kv=None, ref_dpc_kv=None):
    rc, tc = _cfgs("granite-moe-3b-a800m", "f32")
    rparams = ref_model_params(rc, 1)
    rparams["embed"] = rparams["embed"] * 0.05   # logits of a few units
    tparams = carry.model_params(tc, jax.tree.map(np.asarray, rparams))
    kw = dict(batch=3, max_prompt=32, max_new_tokens=6,
              temperature=temperature, seed=3)
    ref = RefServeEngine(rbuild(rc), rparams,
                         RefServeConfig(dpc_kv=ref_dpc_kv, **kw))
    port = ServeEngine(tbuild(tc), tparams, ServeConfig(dpc_kv=dpc_kv, **kw),
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
    if temperature:
        _, greedy, _ = _engines(0.0)
        with single_thread():
            assert not np.array_equal(got, greedy.generate(prompts))


def test_compress_prompt_cache_matches_reference():
    """The reference's prefilled MoE cache, carried, compressed by both
    (budget 8; the port's ``cuda`` route on the plain versions, the
    reference's ``jnp``): counts equal and k_c/v_c within one ulp on every
    head off the 4-ulp band around d_cut^2."""
    kv = DPCKVConfig(budget=8, exec_spec=ExecSpec(backend="cuda"))
    rkv = R.DPCKVConfig(budget=8, exec_spec=RefSpec(backend="jnp"))
    ref, port, prompts = _engines(0.0, dpc_kv=kv, ref_dpc_kv=rkv)
    ref.generate(prompts)
    port.cache = carry.model_cache(jax.tree.map(np.asarray, ref.cache))
    rk, rv, rcnt = (np.asarray(a) for a in ref.compress_prompt_cache())
    with single_thread():
        k_c, v_c, counts = port.compress_prompt_cache()
    L, Bn, M, K = rcnt.shape
    hd = k_c.shape[-1]
    assert k_c.shape == (L, Bn, M, K, hd) == rk.shape
    S = ref.cache.k.shape[2]
    keys = np.asarray(ref.cache.k).reshape(L * Bn, S, K, hd)
    off = np.ones((L * Bn, K), bool)
    for h in range(L * Bn):
        for kk in range(K):
            pts = np.asarray(R._project(jnp.asarray(keys[h, :32, kk]), 4))
            d_cut = float(R._dcut_estimate(jnp.asarray(np.concatenate(
                [pts, np.zeros((S - 32, 4), np.float32)])), 0.05))
            thr = float(np.float32(d_cut) ** 2)
            x = pts.astype(np.float64)
            d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
            off[h, kk] = not (np.abs(d2 - thr) <= 4 * f32_ulp(thr)).any()
    assert off.sum() >= off.size - 1, off
    off = off.reshape(L, Bn, K)
    np.testing.assert_array_equal(counts.numpy().transpose(0, 1, 3, 2)[off],
                                  rcnt.transpose(0, 1, 3, 2)[off])
    for g, w in ((k_c, rk), (v_c, rv)):
        g = g.numpy().transpose(0, 1, 3, 2, 4)[off]
        w = w.transpose(0, 1, 3, 2, 4)[off]
        assert np.all(np.abs(g - w) <= 2.0 ** -23 * np.abs(w))


def test_carry_and_init_shapes(one_thread):
    """Carried weights keep the reference's names, shapes, dtypes (the
    router f32) and bits; the port's own init has the same shapes and
    dtypes, on the card unless asked."""
    rc, tc = _cfgs("qwen3-moe-30b-a3b", "bf16", n_experts_padded=6)
    rparams, tparams = _carried(rc, tc, seed=7)
    state = tparams.state_dict()
    flat = dict(carry._flat(rparams))
    assert set(state) == set(flat) and "unembed" in state
    for name, r in flat.items():
        r = np.asarray(r)
        assert tuple(state[name].shape) == r.shape, name
        assert state[name].dtype == (torch.float32 if name == "layers.router"
                                     else torch.bfloat16), name
        np.testing.assert_array_equal(state[name].float().numpy(),
                                      r.astype(np.float32))
    init = tmoe.init_params(tc, 0, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            init.state_dict().items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
    assert not init.layers["ln1"].any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmoe.init_params(tc, 0)
