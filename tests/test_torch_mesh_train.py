"""The port's sharded train step, elastic restore and mesh CLI
(``train.step``, ``train.checkpoint``, ``launch.train`` on a
``DeviceMesh``) against its one-device step and the JAX package's.

Ranks are separate processes on gloo, started with
``torch.multiprocessing`` on a ``FileStore`` under ``tmp_path``; the
parent joins them within a wall-clock limit of its own and kills them on
overrun.  One spawn of 4 ranks (a 2x2 ``("data", "model")`` mesh) trains
each family's reduced config (gemma-2b in f32 with 2 microbatches and in
bf16, paligemma-3b, hubert-xlarge, granite-moe-3b-a800m with the default
``"gather"`` combine, mamba2-130m, recurrentgemma-9b) for 3 steps from
``ref_model_params`` weights on the reference ``TokenPipeline``'s
batches, then saves gemma's ``(params, opt_state)``.  The losses and the
final parameters agree with the port's one-device run and with the
reference's ``jax.jit(make_train_step)`` within 1e-5 of each array's
largest |value| in f32, 2e-2 in bf16.  The same spawn serves gemma-2b
and granite-moe (whose routing runs on a mesh's replicated choices) on
the mesh: ``prefill`` and a ``decode_step`` with ``rules``, the cache
placed by ``cache_specs``, under ``torch.no_grad``, their f32 logits
within 1e-5 of the one-device port's largest |logit|.  A second spawn of 2 ranks restores
that 2x2 checkpoint onto a 2x1 mesh, bit for bit, as do the port's
one-device ``restore`` and the reference's; and runs ``launch.train
--mesh-shape 2 1 --device cpu``, whose rank 0 alone logs, within 2e-2 of
the one-device CLI's losses.
"""
import contextlib
import datetime
import os
import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.train import TrainStepConfig, adamw_init, make_train_step
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import opt_state_specs

# case -> (arch, dtype, microbatches)
CASES = {"dense": ("gemma-2b", "f32", 2),
         "dense-bf16": ("gemma-2b", "bf16", 1),
         "vlm": ("paligemma-3b", "f32", 1),
         "encoder": ("hubert-xlarge", "f32", 1),
         "moe": ("granite-moe-3b-a800m", "f32", 1),
         "ssm": ("mamba2-130m", "f32", 1),
         "hybrid": ("recurrentgemma-9b", "f32", 1)}
TOL = {"f32": 1e-5, "bf16": 2e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
STEPS, BATCH, SEQ = 3, 4, 8
STEP_KW = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
CKPT_CASE, CKPT_STEP = "dense", STEPS - 1
CLI = ["--arch", "gemma-2b", "--smoke", "--steps", "3", "--batch", "4",
       "--seq", "16", "--log-every", "1", "--device", "cpu"]
PARAMS_CLASS = {"dense": ttfm.TransformerParams,
                "vlm": ttfm.TransformerParams,
                "encoder": ttfm.TransformerParams, "moe": tmoe.MoEParams,
                "ssm": tssm.SSMParams, "hybrid": trglru.RGLRUParams}
WALL_S = 420          # a spawn's wall-clock limit
SERVE_ARCHS = ("gemma-2b", "granite-moe-3b-a800m")


def _tcfg(case: str):
    arch, dt, _ = CASES[case]
    return tconfigs.reduce_config(tconfigs.ARCHS[arch]).replace(
        dtype=DTYPES[dt])


def _step_cfg(case: str) -> TrainStepConfig:
    return TrainStepConfig(microbatches=CASES[case][2], **STEP_KW)


def _full(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t.clone()


def _train(case: str, work: str, mesh=None):
    """3 steps of ``case`` from its saved weights and batches, on
    ``mesh`` (sharded) or on one device: (losses, params, opt_state)."""
    tc = _tcfg(case)
    model = tbuild(tc)
    params = PARAMS_CLASS[tc.family](
        tc, torch.load(os.path.join(work, f"init_{case}.pt")))
    batches = np.load(os.path.join(work, f"batches_{case}.npz"))
    rules = None if mesh is None else tmesh.rules_for(mesh)
    if mesh is not None:
        pspecs = model.param_specs(rules)
        params = tmesh.distribute(params, mesh, pspecs)
    opt = adamw_init(params)
    if mesh is not None:
        opt = tmesh.distribute(opt, mesh, opt_state_specs(pspecs))
    step = make_train_step(model.loss_fn, _step_cfg(case), rules=rules)
    losses = []
    for i in range(STEPS):
        batch = {k.split("/")[1]: torch.from_numpy(batches[k])
                 for k in batches.files if k.startswith(f"{i}/")}
        if mesh is not None:
            batch = tmesh.distribute(batch, mesh,
                                     tmesh.batch_sharding(rules, batch))
        params, opt, metrics = step(params, opt, batch, i)
        losses.append(float(metrics["loss"]))
    return losses, params, opt


def _serve(arch: str, mesh=None) -> dict:
    """A reduced f32 ``arch`` (torch seed 0) prefilling 4 prompts of 8
    tokens (a numpy seed; the vlm's patches too) and taking one decode
    step, on ``mesh`` or one device: both steps' logits as plain
    tensors."""
    cfg = tconfigs.reduce_config(tconfigs.ARCHS[arch]).replace(
        dtype=torch.float32)
    model = tbuild(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (BATCH, 8)))}
    if cfg.num_patches:
        batch["patches"] = torch.from_numpy(rng.normal(size=(
            BATCH, cfg.num_patches, cfg.frontend_dim)).astype(np.float32))
    pos = 8 + cfg.num_patches
    cache = model.init_cache(BATCH, pos + 4, device="cpu")
    step = batch["tokens"][:, :1].contiguous()
    rules = None
    if mesh is not None:
        rules = tmesh.rules_for(mesh)
        params = tmesh.distribute(params, mesh, model.param_specs(rules))
        batch = tmesh.distribute(batch, mesh,
                                 tmesh.batch_sharding(rules, batch))
        cache = tmesh.distribute(cache, mesh, model.cache_specs(rules))
        step = tmesh.distribute(step, mesh, tmesh.batch_sharding(
            rules, {"t": step})["t"])
    with torch.no_grad():
        prefill, cache = model.prefill(params, batch, cache, rules=rules)
        decode, _ = model.decode_step(params, cache, step, pos, rules=rules)
    return {"prefill": _full(prefill), "decode": _full(decode)}


def _named(params) -> dict:
    """Dotted name -> the parameter's full value (a plain tensor)."""
    return {n: _full(t) for n, t in params.named_parameters()}


def _leaves(tree) -> dict:
    """Checkpoint path -> the leaf's full value."""
    return {path: _full(t) for path, t in tckpt.leaves(tree)}


def _rank_main(rank: int, world: int, work: str, job: str) -> None:
    """One rank of a spawn: its gloo group, its 2x2 or 2x1 mesh, its
    job."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, f"store_{job}"),
                                     world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        if job == "train":
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            out = {}
            for case in CASES:
                losses, params, opt = _train(case, work, mesh)
                out[case] = {"losses": losses, "params": _named(params)}
                if case == CKPT_CASE:
                    tckpt.save(os.path.join(work, "ckpt"), CKPT_STEP,
                               (params, opt), extras={"step": CKPT_STEP})
            out["serve"] = {arch: _serve(arch, mesh) for arch in SERVE_ARCHS}
            if rank == 0:
                torch.save(out, os.path.join(work, "mesh_train.pt"))
            return
        mesh = init_device_mesh("cpu", (2, 1),
                                mesh_dim_names=("data", "model"))
        tc = _tcfg(CKPT_CASE)
        model = tbuild(tc)
        pspecs = model.param_specs(tmesh.rules_for(mesh))
        params = tmesh.distribute(model.init(1, device="cpu"), mesh, pspecs)
        opt = tmesh.distribute(adamw_init(params), mesh,
                               opt_state_specs(pspecs))
        _, extras = tckpt.restore(os.path.join(work, "ckpt"), CKPT_STEP,
                                  (params, opt))
        restored = _leaves((params, opt))
        log = os.path.join(work, f"cli_rank{rank}.txt")
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            run = train_cli.run(CLI + ["--mesh-shape", "2", "1"])
        if rank == 0:
            torch.save({"restored": restored, "extras": extras,
                        "cli_losses": run.losses},
                       os.path.join(work, "mesh_elastic.pt"))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _spawned(work: str, job: str, world: int):
    """``job`` on ``world`` ranks while the block runs; then joined, its
    ranks killed and the test failed past ``WALL_S`` seconds from the
    start."""
    ctx = mp.start_processes(_rank_main, args=(world, work, job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + WALL_S
    try:
        yield
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {job} spawn ran past {WALL_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the module checks, run once: the saved weights and
    batches, both spawns and, while they run, the reference's runs and
    the port's one-device runs."""
    import jax
    import jax.numpy as jnp
    from _torch_ref import ref_model_params, single_thread, train_cfgs
    from repro.data.tokens import TokenPipeline as RefPipeline
    from repro.models import build_model as rbuild
    from repro.train import TrainStepConfig as RefStepConfig
    from repro.train import adamw_init as ref_adamw_init
    from repro.train import make_train_step as ref_make_train_step
    from repro_torch import carry

    work = str(tmp_path_factory.mktemp("mesh"))
    inputs = {}
    for case, (arch, dt, mb) in CASES.items():
        rc, tc = train_cfgs(arch, dt)
        rparams = ref_model_params(rc, seed=5)
        tparams = carry.model_params(tc, jax.tree.map(np.asarray, rparams))
        torch.save({n: t.detach() for n, t in tparams.named_parameters()},
                   os.path.join(work, f"init_{case}.pt"))
        pipe = RefPipeline(rc, BATCH, SEQ, seed=3)
        batches = [pipe.batch_at(i) for i in range(STEPS)]
        np.savez(os.path.join(work, f"batches_{case}.npz"),
                 **{f"{i}/{k}": v for i, b in enumerate(batches)
                    for k, v in b.items()})
        inputs[case] = (rc, mb, rparams, batches)
    ref = {}
    with _spawned(work, "train", 4):
        for case, (rc, mb, rparams, batches) in inputs.items():
            rstep = jax.jit(ref_make_train_step(rbuild(rc).loss_fn,
                                                RefStepConfig(microbatches=mb,
                                                              **STEP_KW)))
            ropt = ref_adamw_init(rparams)
            losses = []
            for i, b in enumerate(batches):
                rparams, ropt, m = rstep(rparams, ropt, {
                    k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i))
                losses.append(float(m["loss"]))
            ref[case] = {"losses": losses, "params": {
                n: np.asarray(jnp.asarray(a, jnp.float32))
                for n, a in carry._flat(rparams)}}
    one = {}
    with _spawned(work, "elastic", 2), single_thread():
        for case in CASES:
            losses, params, opt = _train(case, work)
            one[case] = {"losses": losses, "params": _named(params)}
            if case == CKPT_CASE:
                one_tree = (params, opt)
        one["serve"] = {arch: _serve(arch) for arch in SERVE_ARCHS}
        cli_one = train_cli.run(CLI).losses
    return {"work": work, "ref": ref, "one": one, "one_tree": one_tree,
            "cli_one": cli_one,
            "mesh": torch.load(os.path.join(work, "mesh_train.pt")),
            "elastic": torch.load(os.path.join(work, "mesh_elastic.pt"))}


def _within(got, want, tol: float, what: str):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * np.abs(want).max(initial=0.0), (what, err)


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("against", ["one-device", "reference"])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_training_matches(runs, case, against):
    """The 2x2 mesh's losses and final parameters, leaf for leaf."""
    tol = TOL[CASES[case][1]]
    got = runs["mesh"][case]
    want = runs["one" if against == "one-device" else "ref"][case]
    _within(got["losses"], want["losses"], tol, f"{case} losses")
    assert set(got["params"]) == set(want["params"])
    for name, t in got["params"].items():
        assert t.dtype == DTYPES[CASES[case][1]] or t.dtype == torch.float32
        _within(_np(t), _np(want["params"][name]), tol, f"{case} {name}")


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_serving_matches(runs, arch):
    """Prefill and a decode step on the 2x2 mesh: the one-device logits
    within 1e-5 of their largest |value|."""
    for what in ("prefill", "decode"):
        got = runs["mesh"]["serve"][arch][what]
        want = runs["one"]["serve"][arch][what]
        assert got.dtype == torch.float32
        _within(_np(got), _np(want), TOL["f32"], f"{arch} {what}")


def _bits(t) -> np.ndarray:
    t = torch.as_tensor(t)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_checkpoint_restores_elastically(runs):
    """The 2x2 mesh's checkpoint restores bit for bit on 2x1 ranks, on
    one device (the port's ``restore``) and in the reference's; it holds
    the 2x2 run's final state, which the one-device run's matches."""
    import jax
    from _torch_ref import ref_model_params, train_cfgs
    from repro.train import adamw_init as ref_adamw_init
    from repro.train import checkpoint as rckpt

    ckpt_dir = os.path.join(runs["work"], "ckpt")
    on_2x1 = runs["elastic"]["restored"]
    assert runs["elastic"]["extras"] == {"step": CKPT_STEP}
    fresh = tbuild(_tcfg(CKPT_CASE)).init(1, device="cpu")
    tree = (fresh, adamw_init(fresh))
    assert tckpt.restore(ckpt_dir, CKPT_STEP, tree)[1] == {"step": CKPT_STEP}
    one = _leaves(tree)
    rc, _ = train_cfgs(*CASES[CKPT_CASE][:2])
    rparams = ref_model_params(rc, seed=5)
    rtree, _ = rckpt.restore(ckpt_dir, CKPT_STEP,
                             (rparams, ref_adamw_init(rparams)))
    rflat = jax.tree_util.tree_flatten_with_path(rtree)[0]
    assert [jax.tree_util.keystr(k) for k, _ in rflat] == list(one)
    assert list(on_2x1) == list(one)
    for (path, t), (_, r) in zip(one.items(), rflat):
        np.testing.assert_array_equal(_bits(on_2x1[path]), _bits(t),
                                      err_msg=path)
        r = np.asarray(r)
        r = r.view(np.int16) if r.dtype.name == "bfloat16" else r
        np.testing.assert_array_equal(r, _bits(t), err_msg=path)
    params, opt = runs["one_tree"]
    for path, t in _leaves((params, opt)).items():
        _within(_np(t), _np(one[path]), TOL["f32"], path)


def test_cli_trains_on_a_mesh(runs):
    """``launch.train --mesh-shape 2 1`` on 2 ranks: the one-device CLI's
    losses within 2e-2, logged by rank 0 alone."""
    work = runs["work"]
    got = runs["elastic"]["cli_losses"]
    want = runs["cli_one"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=2e-2)
    logged = [float(m) for m in re.findall(
        r"\[train\] step +\d+ loss ([-\d.]+)",
        open(os.path.join(work, "cli_rank0.txt")).read())]
    np.testing.assert_allclose(logged, got, rtol=1e-3)
    assert open(os.path.join(work, "cli_rank1.txt")).read() == ""
