"""The dense, vlm and encoder families' training loss and its gradients
in the port (``Model.loss_fn``) against the JAX package's
``jax.value_and_grad`` of its ``loss_fn`` on the same weights.

Reduced gemma-2b and h2o-danube (its sliding window of 32 inside 48
positions), paligemma (4 image patches, the loss over the text suffix)
and hubert (frames against labels, the unused token embedding's
gradient 0).  Weights of the reference's pytree come from a numpy seed
(``ref_model_params``) and are carried into the port with
``carry.model_params``; the batch is the reference's ``TokenPipeline``'s
(batch 2, 48 positions).  In f32 the loss agrees within 1e-5 relative and
every leaf's gradient within 1e-4 of its largest |g|; in bf16, against
the reference compiled with XLA's excess precision off (``strict_jit``),
within 2e-2 (``_torch_ref.assert_grads_match``).  The reference runs
under ``jax.jit``, each (family, dtype) once per module.  Recomputing
the layers in the backward pass (``remat``) changes no bit of the port's
gradients, and is the default only where gradients are on.  The
hybrid's emulated exp has exp's gradient.  ``moe_ffn`` alone, on a
router biased to one expert so that assignments past the capacity are
dropped, gives the reference's gradients in both modes: the drop slot
takes every dropped write and is cut off, so they take no gradient.  The
SSD scan's gradient stays finite where its decay overflows.  An ssm loss
off a chunk multiple raises.  The moe, ssm and hybrid families' whole
models are in ``test_torch_train_families.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import (as_np, assert_grads_match,  # noqa: F401
                        assert_loss_matches, assert_remat_changes_no_bit,
                        loss_grad_runs, one_thread, ref_model_params,
                        train_cfgs)
from repro.models import moe as rmoe
from repro_torch import carry
from repro_torch.core.threefry import _exp
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe

B = 2

CASES = {"gemma": "gemma-2b", "h2o": "h2o-danube-1.8b",
         "vlm": "paligemma-3b", "encoder": "hubert-xlarge"}
DTYPES = ("f32", "bf16")


@pytest.fixture(scope="module")
def runs():
    """(case, dtype) -> both packages' loss and gradients, each computed
    once for the module."""
    cache: dict = {}

    def get(case: str, dt: str) -> dict:
        if (case, dt) not in cache:
            cache[case, dt] = loss_grad_runs(CASES[case], dt)
        return cache[case, dt]
    return get


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(runs, case, dt):
    assert_loss_matches(runs(case, dt), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_reference(runs, case, dt):
    assert_grads_match(runs(case, dt), dt)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_changes_no_bit(runs, case):
    assert_remat_changes_no_bit(runs(case, "f32"))


def test_remat_default_follows_grad_mode(monkeypatch):
    """``remat=None`` recomputes in the backward pass only where
    gradients are on: never under ``no_grad`` or for frozen weights."""
    import torch.utils.checkpoint as tuc
    calls = []
    real = tuc.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tuc, "checkpoint", counting)
    _, tc = train_cfgs("gemma-2b", "f32")
    model = tbuild(tc)
    params = model.init(0, device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    model.loss_fn(params, batch)                       # frozen weights
    params.requires_grad_(True)
    with torch.no_grad():
        model.loss_fn(params, batch)
    assert not calls
    model.loss_fn(params, batch)
    assert len(calls) == tc.n_layers


def test_exp_gradient_is_grad_times_out(one_thread):
    """``threefry._exp`` keeps XLA's f32 exp bit for bit forward and
    differentiates as g * exp(x): the reference's gradient of
    ``jnp.exp`` under jit, bit for bit."""
    rng = np.random.default_rng(5)
    v = rng.uniform(-30.0, 5.0, 4096).astype(np.float32)
    g = rng.normal(size=4096).astype(np.float32)
    tv = torch.from_numpy(v).requires_grad_(True)
    out = _exp(tv)
    got, = torch.autograd.grad(out, tv, torch.from_numpy(g))
    assert torch.equal(got, torch.from_numpy(g) * out.detach())
    want = jax.jit(lambda v, g: jax.vjp(jnp.exp, v)[1](g)[0])(v, g)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))




@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    """``common.cross_entropy`` on bf16 logits: the f32 logsumexp minus
    the gold logit, the mean over the masked positions (an all-False mask
    divides by 1)."""
    from repro.models.common import cross_entropy as ref_ce
    from repro_torch.models.common import cross_entropy

    rng = np.random.default_rng(8)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    masks = [rng.uniform(size=(3, 7)) < 0.5, np.zeros((3, 7), bool)] \
        if masked else [None]
    for mask in masks:             # bf16 logits: the f32 cast inside
        got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                            torch.from_numpy(labels),
                            None if mask is None else torch.from_numpy(mask))
        want = float(ref_ce(jnp.asarray(logits).astype(jnp.bfloat16),
                            jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask)))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1.0)


def _ffn_case(seed: int):
    """granite-moe's reduced layer 0 with the router's expert 0 raised
    and |x|: every token's first choice is expert 0, so assignments past
    the capacity of 96 (128 tokens) are dropped."""
    rc, tc = train_cfgs("granite-moe-3b-a800m", "f32")
    rp = ref_model_params(rc, seed)
    rlp = {k: v[0] for k, v in rp["layers"].items()}
    rlp["router"] = rlp["router"].at[:, 0].add(1.0)
    x = np.abs(np.random.default_rng(seed).normal(
        size=(B, 64, rc.d_model))).astype(np.float32)
    tlp = {k: carry._weights(np.asarray(v), "cpu").requires_grad_(True)
           for k, v in rlp.items()}
    return rc, tc, rlp, tlp, x


@pytest.mark.parametrize("mode", ["gather", "scatter"])
def test_moe_ffn_grads_with_drops(one_thread, mode):
    """d(sum(y * w) + aux)/d(x, weights) against the reference's, with
    drops: a dropped assignment writes the cut-off slot Ep*C and takes no
    gradient from it."""
    rc, tc, rlp, tlp, x = _ffn_case(11)
    T = x.shape[0] * x.shape[1]
    C = tmoe.capacity(tc, T)
    assert C == 96
    w = np.random.default_rng(12).normal(size=x.shape).astype(np.float32)

    def rloss(x, lp):
        y, aux = rmoe.moe_ffn(x, lp, rc, None)
        return jnp.sum(y * w) + aux

    with rmoe.dispatch_mode(mode):
        rv, (rgx, rglp) = jax.jit(jax.value_and_grad(rloss, (0, 1)))(
            jnp.asarray(x), rlp)
    tx = torch.from_numpy(x).requires_grad_(True)
    with tmoe.dispatch_mode(mode):
        y, aux = tmoe.moe_ffn(tx, tlp, tc)
        tv = torch.sum(y * torch.from_numpy(w)) + aux
        names = list(tlp)
        grads = torch.autograd.grad(tv, [tx] + [tlp[n] for n in names],
                                    materialize_grads=True)
    # the drops happened: expert 0 holds more assignments than slots
    probs = torch.softmax(tx.detach().reshape(T, -1) @ tlp["router"].detach(),
                          dim=-1)
    top = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :tc.top_k]
    assert int(torch.bincount(top.flatten())[0]) > C
    assert abs(float(tv.detach()) - float(rv)) <= 1e-5 * abs(float(rv))
    for got, want in zip(grads, [rgx] + [rglp[n] for n in names]):
        got, want = as_np(got), as_np(want)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_ssm_loss_needs_a_chunk_multiple():
    _, tc = train_cfgs("mamba2-130m", "f32")
    model = tbuild(tc)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        model.loss_fn(params, {"tokens": torch.zeros((1, 12),
                                                     dtype=torch.int32)})


def _ssd_sequential(xh, dtv, Bm, Cm, A_log):
    """The SSD recurrence one step at a time, f32: h_t = exp(-exp(A_log)
    dt_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t . h_t (one B/C group)."""
    Bsz, L, H, P = xh.shape
    a = torch.exp(-torch.exp(A_log) * dtv)                   # (B, L, H)
    h = xh.new_zeros((Bsz, H, P, Bm.shape[-1]))
    ys = []
    for t in range(L):
        h = (a[:, t, :, None, None] * h + dtv[:, t, :, None, None]
             * xh[:, t, :, :, None] * Bm[:, t, 0, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t, 0]))
    return torch.stack(ys, dim=1)


def test_ssd_gradient_where_the_decay_overflows(one_thread):
    """A chunk whose cumulative log-decay spans more than 88 (dt of 2-4,
    A up to 16 over 16 positions): exp(cum_i - cum_j) above the diagonal
    overflows in f32.  The reference masks after the exp, so its
    gradient is NaN there (ROADMAP Reference gaps); the port masks
    before it: the same forward values, and gradients finite and equal
    to the step-by-step recurrence's within 1e-4 of their largest."""
    from repro.models import ssm as rssm
    from repro_torch.models import ssm as tssm

    rng = np.random.default_rng(21)
    Bsz, L, H, P, N = 2, 32, 4, 8, 8
    xh = rng.normal(size=(Bsz, L, H, P)).astype(np.float32)
    dtv = rng.uniform(2.0, 4.0, (Bsz, L, H)).astype(np.float32)
    Bm = rng.normal(size=(Bsz, L, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(Bsz, L, 1, N)).astype(np.float32)
    A_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    w = rng.normal(size=(Bsz, L, H, P)).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (xh, dtv, Bm, Cm, A_log)]
    y = tssm._ssd_chunked(*args, 16)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)), args)
    ry, rgrads = jax.value_and_grad(
        lambda *a: jnp.sum(rssm._ssd_chunked(*a, 16) * w),
        argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a)
                                  for a in (xh, dtv, Bm, Cm, A_log)))
    assert np.isnan(np.asarray(rgrads[1])).any()       # the reference's
    np.testing.assert_allclose(
        float(torch.sum(y.detach() * torch.from_numpy(w))), float(ry),
        rtol=1e-5)
    seq = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(
        torch.sum(_ssd_sequential(*seq) * torch.from_numpy(w)), seq)
    assert torch.allclose(y, _ssd_sequential(*seq).detach(), rtol=0,
                          atol=1e-4 * float(y.detach().abs().max()))
    for got, ref in zip(grads, want):
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max())
