"""The port's training substrate (``repro_torch.train``, ``data.tokens``,
``launch.train``) against the JAX package's.

``warmup_cosine`` at its turning points; ``adamw_update`` over five
steps on a toy tree of f32 and bf16 leaves (masters within 1e-6
relative, bf16 parameters within one ulp) and under a 1e9 gradient
(clipped); ``make_train_step`` with 1, 2 and 4 microbatches in both
accumulation modes on a toy loss; the ``'grad'`` mode's f32 accumulators
on gradients that a bf16 sum would round away; checkpoints of a reduced
gemma's ``(params, opt_state)`` written by either package and restored
by the other, bit for bit, with the same leaf paths, and stale ``.tmp``
directories ignored and removed; ``TokenPipeline``'s batches equal to
the reference's, array for array, also after ``load_state_dict``; the
CLI (``python -m repro_torch.launch.train``) resumed from a checkpoint
equal to the uninterrupted run bit for bit, and its per-step losses
within 2e-2 of ``repro.launch.train.main``'s from the same weights;
``ServeEngine`` building no graph on trainable parameters.
"""
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import one_thread, ref_model_params  # noqa: F401
from repro import configs as rconfigs
from repro.data.tokens import TokenPipeline as RefPipeline
from repro.launch import train as rtrain_cli
from repro.models import build_model as rbuild
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import TrainStepConfig as RefStepConfig
from repro.train import adamw_init as ref_adamw_init
from repro.train import adamw_update as ref_adamw_update
from repro.train import checkpoint as rckpt
from repro.train import make_train_step as ref_make_train_step
from repro.train import warmup_cosine as ref_warmup_cosine
from repro_torch import carry
from repro_torch import configs as tconfigs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model as tbuild
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import (AdamWConfig, TrainStepConfig, adamw_init,
                               adamw_update, make_train_step, warmup_cosine)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.step import value_and_grad


def _np(t) -> np.ndarray:
    """A tensor or jax array as numpy, bf16 as its uint16 pattern."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("step", [0, 7, 10, 11, 55, 99, 100, 140])
def test_warmup_cosine_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    got = warmup_cosine(step, **kw)
    want = np.asarray(ref_warmup_cosine(step, **kw))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# ------------------------------------------------------------ optimizer
def _toy(seed: int):
    """A toy tree: f32 ``w`` (8, 4) and bf16 ``b`` (4,), as numpy f32."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def _toy_pair(seed: int):
    p = _toy(seed)
    ref = {"w": jnp.asarray(p["w"]),
           "b": jnp.asarray(p["b"]).astype(jnp.bfloat16)}
    port = {"w": torch.from_numpy(p["w"]),
            "b": torch.from_numpy(p["b"]).to(torch.bfloat16)}
    return ref, port


def _assert_state_close(tparams, tstate, rparams, rstate):
    """Masters and f32 parameters within 1e-6 relative, the moments
    within 1e-6 of their leaf's largest magnitude (a first moment whose
    gradients change sign cancels: its small entries carry the ulps of
    the clip scale, whose norm both sum in their own order), bf16
    parameters within one ulp."""
    assert int(tstate["step"]) == int(rstate["step"])
    for part in ("master", "mu", "nu"):
        for k in tstate[part]:
            got, want = _np(tstate[part][k]), np.asarray(rstate[part][k])
            assert tstate[part][k].dtype == torch.float32
            if part == "master":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(_np(tparams["w"]), np.asarray(rparams["w"]),
                               rtol=1e-6)
    assert tparams["b"].dtype == torch.bfloat16
    ulps = np.abs(_np(tparams["b"]).astype(np.int32)
                  - _np(rparams["b"]).astype(np.int32))
    assert ulps.max() <= 1, ulps


def test_adamw_five_steps_match_reference(one_thread):
    rparams, tparams = _toy_pair(0)
    rstate, tstate = ref_adamw_init(rparams), adamw_init(tparams)
    assert tstate["step"].dtype == torch.int32
    assert tstate["master"]["b"].dtype == torch.float32
    assert tstate["master"]["w"] is not tparams["w"]
    cfg, rcfg = AdamWConfig(), RefAdamWConfig()
    rng = np.random.default_rng(1)
    for i in range(5):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 0.3
             for k, v in _toy(0).items()}
        rg = {"w": jnp.asarray(g["w"]),
              "b": jnp.asarray(g["b"]).astype(jnp.bfloat16)}
        tg = {"w": torch.from_numpy(g["w"]),
              "b": torch.from_numpy(g["b"]).to(torch.bfloat16)}
        lr = 1e-2 * (i + 1)
        rparams, rstate, rn = ref_adamw_update(rg, rstate, rparams, lr, rcfg)
        same = tparams["w"]
        tparams, tstate, tn = adamw_update(tg, tstate, tparams, lr, cfg)
        assert tparams["w"] is same                     # in place
        np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
        _assert_state_close(tparams, tstate, rparams, rstate)


def test_adamw_clips_a_huge_gradient(one_thread):
    rparams, tparams = _toy_pair(2)
    before = {k: v.float().clone() for k, v in tparams.items()}
    rstate, tstate = ref_adamw_init(rparams), adamw_init(tparams)
    cfg = AdamWConfig(grad_clip=1.0, weight_decay=0.0)
    rcfg = RefAdamWConfig(grad_clip=1.0, weight_decay=0.0)
    rg = jax.tree.map(lambda p: jnp.full_like(p, 1e9), rparams)
    tg = {k: torch.full_like(v, 1e9) for k, v in tparams.items()}
    rparams, rstate, rn = ref_adamw_update(rg, rstate, rparams, 1e-3, rcfg)
    tparams, tstate, tn = adamw_update(tg, tstate, tparams, 1e-3, cfg)
    assert float(tn) > 1e8
    np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    _assert_state_close(tparams, tstate, rparams, rstate)
    for k in tparams:                                   # lr-scale steps
        assert float((tparams[k].float() - before[k]).abs().max()) < 1.0


# ------------------------------------------------------------------ step
def _toy_batch(n: int = 16):
    rng = np.random.default_rng(3)
    return {"x": rng.normal(size=(n, 8)).astype(np.float32),
            "y": rng.normal(size=(n, 4)).astype(np.float32)}


def ref_toy_loss(params, batch, rules=None):
    pred = batch["x"] @ params["w"] + params["b"].astype(jnp.float32)
    return jnp.mean((pred - batch["y"]) ** 2)


def toy_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"].to(torch.float32)
    return torch.mean((pred - batch["y"]) ** 2)


@pytest.mark.parametrize("mode", ["grad", "loss"])
@pytest.mark.parametrize("mb", [1, 2, 4])
def test_train_step_matches_reference(one_thread, mb, mode):
    """Three steps of ``make_train_step`` (f32 ``w``, bf16 ``b``): the
    loss, the gradient norm, the learning rate, the parameters and the
    state."""
    rparams, tparams = _toy_pair(4)
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10, microbatches=mb,
              accumulation=mode)
    rstep = jax.jit(ref_make_train_step(ref_toy_loss, RefStepConfig(**kw)))
    tstep = make_train_step(toy_loss, TrainStepConfig(**kw))
    rstate, tstate = ref_adamw_init(rparams), adamw_init(tparams)
    batch = _toy_batch()
    for i in range(3):
        rparams, rstate, rm = rstep(rparams, rstate,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                                    jnp.int32(i))
        tparams, tstate, tm = tstep(tparams, tstate,
                                    {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, i)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(rm[name]),
                                       rtol=1e-6, err_msg=name)
        _assert_state_close(tparams, tstate, rparams, rstate)


def test_microbatches_must_divide_the_batch():
    step = make_train_step(toy_loss, TrainStepConfig(microbatches=3))
    params = {k: torch.from_numpy(v) for k, v in _toy(0).items()}
    with pytest.raises(ValueError, match="not divisible"):
        step(params, adamw_init(params),
             {k: torch.from_numpy(v) for k, v in _toy_batch().items()}, 0)


def test_grad_mode_accumulates_in_f32(one_thread):
    """Four microbatches whose bf16 gradients are 1 and three times
    2^-8: in f32 they sum to 1 + 3 * 2^-8, where a bf16 sum (``.grad``'s,
    in the parameter's dtype) stays at 1 (2^-8 is half of bf16's spacing
    at 1).  The accumulators are f32, as the reference's scan carry."""
    w = torch.zeros(5, dtype=torch.bfloat16)
    c = torch.tensor([1.0, 2 ** -8, 2 ** -8, 2 ** -8])[:, None].expand(4, 5)

    def loss_fn(params, batch):
        return torch.sum(params["w"].to(torch.float32) * batch["c"])

    cfg = TrainStepConfig(microbatches=4, accumulation="grad")
    _, grads = value_and_grad(loss_fn, {"w": w}, {"c": c.contiguous()}, cfg)
    assert grads["w"].dtype == torch.float32
    assert torch.equal(grads["w"], torch.full((5,), (1 + 3 * 2 ** -8) / 4))
    # the same gradients summed in bf16 would lose the small ones
    bf = torch.zeros(5, dtype=torch.bfloat16)
    for ci in c:
        bf += ci.to(torch.bfloat16)
    assert torch.equal(bf.float() / 4, torch.full((5,), 0.25))
    # one microbatch (and the loss mode) keep the parameters' dtype
    _, g1 = value_and_grad(loss_fn, {"w": w}, {"c": c.contiguous()},
                           TrainStepConfig())
    assert g1["w"].dtype == torch.bfloat16


# ----------------------------------------------------------- checkpoints
def _gemma_pair(seed: int):
    """Reduced gemma (bf16): the reference's ``(params, opt_state)`` with
    nonzero moments at step 3, and the port's carrying the same values."""
    rc = rconfigs.reduce_config(rconfigs.ARCHS["gemma-2b"])
    tc = tconfigs.reduce_config(tconfigs.ARCHS["gemma-2b"])
    rparams = ref_model_params(rc, seed)
    rng = np.random.default_rng(seed)
    rstate = ref_adamw_init(rparams)
    rstate["step"] = jnp.int32(3)
    for part in ("mu", "nu"):
        rstate[part] = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
            rstate[part])
    tparams = carry.model_params(tc, jax.tree.map(np.asarray, rparams))
    tstate = adamw_init(tparams)
    tstate["step"].fill_(3)
    for part in ("mu", "nu"):
        for name, a in carry._flat(rstate[part]):
            tstate[part][name].copy_(torch.from_numpy(np.array(a)))
    return rc, tc, (rparams, rstate), (tparams, tstate)


def _blank(tc):
    params = tbuild(tc).init(9, device="cpu")
    return params, adamw_init(params)


def _leaves_equal(a, b):
    """Two checkpoints' trees equal leaf for leaf, bit for bit."""
    la = [(n, _np(t)) for n, t in tckpt.leaves(a)]
    lb = [(n, _np(t)) for n, t in tckpt.leaves(b)]
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y), n


def test_checkpoint_port_to_reference(tmp_path):
    rc, tc, ref, port = _gemma_pair(1)
    d = str(tmp_path / "ck")
    tckpt.save(d, 3, port, extras={"step": 3, "cursor": 17})
    assert rckpt.latest_step(d) == 3
    like = jax.eval_shape(lambda: ref)
    restored, extras = rckpt.restore(d, 3, like)
    assert extras == {"step": 3, "cursor": 17}
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))
    # the same paths in the same order as the reference writes them
    d2 = str(tmp_path / "ck_ref")
    rckpt.save(d2, 3, ref)
    import json
    metas = []
    for x in (d, d2):
        with open(os.path.join(x, "step_3", "meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0]["leaves"] == metas[1]["leaves"]
    assert metas[0]["leaves"][0]["path"] == "[0]['embed']"
    assert any(m["path"] == "[0]['layers']['wq']" and m["dtype"] ==
               "bfloat16" for m in metas[0]["leaves"])
    assert metas[0]["leaves"][-1]["path"] == "[1]['step']"


def test_checkpoint_reference_to_port(tmp_path):
    rc, tc, ref, port = _gemma_pair(2)
    d = str(tmp_path / "ck")
    rckpt.save(d, 5, ref, extras={"step": 5})
    assert tckpt.latest_step(d) == 5
    target = _blank(tc)
    restored, extras = tckpt.restore(d, 5, target)
    assert restored is target and extras == {"step": 5}
    assert target[0].embed.dtype == torch.bfloat16
    _leaves_equal(target, port)


def test_checkpoint_tmp_dirs_ignored_and_removed(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "step_9.tmp"))
    assert tckpt.latest_step(d) is None
    for s in (1, 5, 3):
        tckpt.save(d, s, {"w": torch.ones(2) * s})
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert tckpt.latest_step(d) == 5
    os.makedirs(os.path.join(d, "step_7.tmp"))          # a crashed write
    assert tckpt.latest_step(d) == 5
    out = {"w": torch.zeros(2)}
    tckpt.restore(d, 3, out)
    assert torch.equal(out["w"], torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="saved"):
        tckpt.restore(d, 3, {"w": torch.zeros(4)})


# -------------------------------------------------------------- tokens
@pytest.mark.parametrize("arch", ["gemma-2b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_token_pipeline_matches_reference(arch):
    rp = RefPipeline(rconfigs.ARCHS[arch], 3, 600, seed=7)
    tp = TokenPipeline(tconfigs.ARCHS[arch], 3, 600, seed=7)
    for _ in range(3):
        want, got = next(rp), next(tp)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    state = tp.state_dict()
    assert state == rp.state_dict() == {"seed": 7, "cursor": 3}
    again = TokenPipeline(tconfigs.ARCHS[arch], 3, 600, seed=7)
    again.load_state_dict({"seed": 7, "cursor": 1})
    replay = next(again)
    for k, v in rp.batch_at(1).items():
        np.testing.assert_array_equal(replay[k], v)
    with pytest.raises(ValueError, match="seed"):
        again.load_state_dict({"seed": 8, "cursor": 0})


# ----------------------------------------------------------------- CLI
CLI = ["--arch", "gemma-2b", "--smoke", "--steps", "6", "--batch", "2",
       "--seq", "32", "--log-every", "1"]


def _losses(text: str) -> list[float]:
    return [float(m) for m in re.findall(r"\[train\] step +\d+ loss (\S+)",
                                         text)]


def test_cli_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """A 6-step run checkpointing every 3 steps; a second run from its
    step-2 checkpoint alone (the run stopped after it) takes steps 3-5
    and ends in the same parameters and state, bit for bit, and the same
    losses.  (A run with ``--steps 3`` would warm up over 3 steps, not
    6: the schedule follows ``--steps``.)"""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = CLI + ["--device", "cpu", "--ckpt-every", "3"]
    loss_a = train_cli.main(args + ["--ckpt-dir", a])
    out_a = capsys.readouterr().out
    assert sorted(os.listdir(a)) == ["step_2", "step_5"]
    shutil.copytree(os.path.join(a, "step_2"), os.path.join(b, "step_2"))
    loss_b = train_cli.main(args + ["--ckpt-dir", b])
    out_b = capsys.readouterr().out
    assert "[train] restored step 2 (cursor=3)" in out_b
    assert loss_a == loss_b and _losses(out_b) == _losses(out_a)[3:]
    tc = tconfigs.reduce_config(tconfigs.ARCHS["gemma-2b"])
    trees = []
    for d in (a, b):
        tree = _blank(tc)
        _, extras = tckpt.restore(d, 5, tree)
        assert extras["step"] == 5 and extras["pipeline"]["cursor"] == 6
        trees.append(tree)
    _leaves_equal(*trees)


def test_cli_losses_match_reference(tmp_path, capsys, monkeypatch):
    """Both CLIs from the same weights (the reference's init at seed 0,
    written as a checkpoint before step 0), the same arguments: each
    step's loss within 2e-2 relative (bf16).  jax 0.9.0's ``make_mesh``
    makes explicit-sharding axes, under which the reference's embedding
    gather is ambiguous; the reference runs here on auto axes, with its
    shardings explicit and no global mesh set (``jax.set_mesh`` would
    leak into every later test of this process)."""
    rc = rconfigs.reduce_config(rconfigs.ARCHS["gemma-2b"])
    rparams = rbuild(rc).init(jax.random.PRNGKey(0))
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    for d in (a, b):
        rckpt.save(d, -1, (rparams, ref_adamw_init(rparams)),
                   extras={"step": -1, "pipeline": {"seed": 0, "cursor": 0},
                           "arch": rc.name})
    real = jax.make_mesh
    monkeypatch.setattr(jax, "make_mesh", lambda shape, names, **kw: real(
        shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(shape)))
    monkeypatch.setattr(jax, "set_mesh", lambda mesh: None)
    args = CLI + ["--ckpt-every", "100"]
    want_last = rtrain_cli.main(args + ["--ckpt-dir", a])
    want = _losses(capsys.readouterr().out)
    got_last = train_cli.main(args + ["--device", "cpu", "--ckpt-dir", b])
    got = _losses(capsys.readouterr().out)
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=2e-2)
    np.testing.assert_allclose(got_last, want_last, rtol=2e-2)


def test_cli_refuses_a_mesh_and_a_missing_card():
    """A mesh of 2 needs a process group of 2 ranks: with no group the
    world size is 1, and the message names both numbers."""
    with pytest.raises(SystemExit, match=r"a mesh of 2 devices, but the "
                       r"world size is 1"):
        train_cli.main(CLI + ["--device", "cpu", "--mesh-shape", "2", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(CLI)


# ------------------------------------------------------------- serving
def test_serving_builds_no_graph_on_trainable_params(one_thread):
    """After ``requires_grad_(True)`` the model's own calls build a graph,
    and ``ServeEngine.generate`` builds none: its cache has no
    ``grad_fn``."""
    tc = tconfigs.reduce_config(tconfigs.ARCHS["gemma-2b"])
    model = tbuild(tc)
    params = model.init(0, device="cpu").requires_grad_(True)
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}
    logits, _ = model.prefill(params, toks, model.init_cache(1, 8,
                                                             device="cpu"))
    assert logits.grad_fn is not None
    eng = ServeEngine(model, params, ServeConfig(batch=2, max_prompt=8,
                                                 max_new_tokens=3),
                      device="cpu")
    out = eng.generate([[1, 2, 3], [4, 5]])
    assert out.shape == (2, 3)
    for t in eng.cache:
        assert t.grad_fn is None and not t.requires_grad
    assert all(p.requires_grad for p in params.parameters())


def test_training_modules_import_no_jax_or_ml_dtypes():
    """The training path's modules import neither JAX, ``ml_dtypes`` nor
    the JAX package (bf16 checkpoints go through torch's int16 view)."""
    import subprocess
    import sys
    mods = ["repro_torch.train", "repro_torch.train.checkpoint",
            "repro_torch.train.step", "repro_torch.data.tokens",
            "repro_torch.launch.train", "repro_torch.launch.tuned"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'repro')]\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr
