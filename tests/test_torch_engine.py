"""The whole slice: the port's ``DPCEngine(d_cut).fit`` held against the
JAX package's, plus the port's rules (device default, no JAX, no nvcc on
CPU tensors, unported axes refused)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.tuning import pick_dcut
from repro.data.points import gaussian_mixture, real_proxy
from repro.engine import DPCEngine as JEngine
from repro.engine import ExecSpec as JExecSpec

from repro_torch import DPCEngine, ExecSpec
from repro_torch.core.approxdpc import run_approxdpc
from repro_torch.core.dpc_api import DPCConfig, cluster, compute_dpc
from repro_torch.core.sapproxdpc import run_sapproxdpc
from repro_torch.kernels import build, ops
from repro_torch.kernels.backend import get_backend
from repro_torch.resilience.checkpoint import CheckpointError
from repro_torch.resilience.sanitize import PoisonedInputError
from repro_torch.stream import StreamDPC, StreamDPCConfig

from _torch_ref import (assert_same_fit, clear_dcut, f32_d2cut, f32_ulp,
                        uniform_points)

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("data", ["airline", "gaussian_mixture"])
def test_fit_matches_jnp_on_realistic_data(data):
    pts = (real_proxy("airline", 2048)[0] if data == "airline"
           else gaussian_mixture(4000, d=2)[0])
    dc = pick_dcut(pts)
    ref = JEngine(dc, rho_min=8, exec_spec=JExecSpec(backend="jnp")).fit(pts)
    port = DPCEngine(dc, rho_min=8, device="cpu").fit(pts)
    # domain 1e5: a pair within 4 f32 ulps of d_cut^2 may round either way
    thr = f32_d2cut(dc)
    assert_same_fit(port, ref, pts, dc, 4 * f32_ulp(thr))


def test_fit_matches_pallas_interpret_on_unit_data(monkeypatch):
    # the reference's plan-time analyzer raises on the installed jax for
    # every pallas plan (ROADMAP "Reference gaps"); suspend it
    monkeypatch.setenv("REPRO_ANALYSIS", "suspend")
    pts = uniform_points(1500, 3, seed=11)
    dc = clear_dcut(pts, target_rho=25)
    ref = JEngine(dc, rho_min=15, exec_spec=JExecSpec(
        backend="pallas-interpret")).fit(pts)
    port = DPCEngine(dc, rho_min=15, device="cpu").fit(torch.from_numpy(pts))
    assert_same_fit(port, ref, pts, dc, 1e-5 * f32_d2cut(dc))


def test_fit_without_device_targets_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPCEngine(1.0).fit(uniform_points(10, 2, seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster(uniform_points(10, 2, seed=0), DPCConfig(d_cut=1.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_approxdpc(uniform_points(10, 2, seed=0), 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sapproxdpc(uniform_points(10, 2, seed=0), 1.0)


def test_drivers_run_on_the_device_of_a_tensor():
    pts = uniform_points(200, 2, seed=4)
    res = run_approxdpc(torch.from_numpy(pts), 0.1)
    assert res.rho.device.type == res.parent.device.type == "cpu"
    want = cluster(pts, DPCConfig(d_cut=0.1), device="cpu")[1]
    for got, ref in zip(res, want):
        assert torch.equal(got, ref)


def test_cpu_fit_never_invokes_nvcc(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("nvcc must not run on a CPU fit")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    ops.reset_launch_counts()
    for layout in ("dense", "block-sparse"):
        for algo in ("approxdpc", "sapproxdpc"):
            for precision in ("f32", "bf16"):
                eng = DPCEngine(0.1, algorithm=algo, device="cpu",
                                exec_spec=ExecSpec(layout=layout,
                                                   precision=precision)).fit(
                                    uniform_points(500, 2, seed=1))
                assert eng.clustering.labels.device.type == "cpu"
    assert ops.launch_counts() == {
        "fused_count_topk": 0, "worklist_count_topk": 0,
        "fused_count_topk_sel": 0, "worklist_count_topk_sel": 0,
        "fused_count_topk_bf16": 0, "worklist_count_topk_bf16": 0,
        "fused_count_topk_bf16_sel": 0, "worklist_count_topk_bf16_sel": 0,
        "masked_nn": 0, "range_count": 0, "range_count_signed": 0,
        "gather_masked_nn": 0, "prefix_nn": 0, "worklist_range_count": 0,
        "worklist_masked_nn": 0, "worklist_range_count_signed": 0,
        "halo_range_count": 0, "halo_masked_nn": 0,
        "worklist_halo_range_count": 0, "worklist_halo_masked_nn": 0}


def test_refit_reuses_plan_and_decision_graph():
    pts = uniform_points(300, 2, seed=2)
    eng = DPCEngine(0.1, rho_min=3, device="cpu")
    with pytest.raises(ValueError):
        eng.result
    plan = eng.fit(pts).plan
    assert eng.fit(pts + 1.0).plan is plan
    dg = eng.decision_graph()
    assert dg.shape == (300, 2)
    assert torch.isinf(dg[:, 1]).sum() == 1      # the global density peak


def test_unported_axes_and_entry_points_raise():
    """Refused axes raise; the paper's two baselines, once refused, run
    through the engine as through ``compute_dpc``."""
    pts = uniform_points(50, 2, seed=3)
    for algo in ("lsh_ddp", "cfsfdp_a"):
        fit = DPCEngine(0.1, algorithm=algo, device="cpu").fit(pts)
        res = compute_dpc(pts, DPCConfig(d_cut=0.1, algorithm=algo),
                          device="cpu")
        for a, b in zip(fit.result, res):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="eps"):
        DPCEngine(0.1, algorithm="sapproxdpc", eps=0.0, device="cpu")
    with pytest.raises(ValueError, match="eps"):
        DPCConfig(d_cut=0.1, algorithm="sapproxdpc", eps=0.0)
    with pytest.raises(ValueError):
        DPCEngine(0.1, algorithm="kmeans", device="cpu")
    for spec in (ExecSpec(precision="bf16"),
                 ExecSpec(layout="block-sparse", precision="bf16")):
        bf = DPCEngine(0.1, exec_spec=spec, device="cpu").fit(pts)
        assert bf.plan.describe().endswith(
            f"{spec.resolved_layout}:bf16 n=50 d=2]")
        assert len(bf.labels_) == 50 and bf.result.rho.shape == (50,)
    eng = DPCEngine(0.1, device="cpu").fit(pts)
    cfg = StreamDPCConfig(d_cut=0.1)
    with pytest.raises(TypeError, match="ShardMesh"):
        StreamDPC(cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="window state"):
        StreamDPC(cfg, device="cpu").save("ckpt")
    with pytest.raises(CheckpointError):
        StreamDPC.restore("no-such-ckpt.npz", device="cpu")
    x, be = torch.from_numpy(pts), get_backend("cuda")
    spans = torch.zeros((50, 3), dtype=torch.int32)
    assert torch.equal(be.range_count_delta(x, x, torch.ones(50), 0.1,
                                            layout="block-sparse"),
                       be.range_count_delta(x, x, torch.ones(50), 0.1))
    keys = torch.rand(50)
    for g, w in zip(be.denser_nn_update(x, keys, torch.arange(5),
                                        layout="block-sparse"),
                    be.denser_nn_update(x, keys, torch.arange(5))):
        assert torch.equal(g, w)
    assert torch.equal(be.range_count_halo(x, x, spans, spans, 0.1,
                                           span_cap=1,
                                           layout="block-sparse"),
                       be.range_count_halo(x, x, spans, spans, 0.1,
                                           span_cap=1))
    with pytest.raises(PoisonedInputError):
        eng.fit(np.array([[0.0, np.inf]] * 4, np.float32))
    with pytest.raises(ValueError):
        DPCEngine(0.1, delta_min=0.05, device="cpu")


def test_port_imports_no_jax():
    mods = sorted(p.relative_to(SRC).with_suffix("").as_posix()
                  .replace("/", ".").removesuffix(".__init__")
                  for p in (SRC / "repro_torch").rglob("*.py"))
    assert {"repro_torch.stream", "repro_torch.stream.stream_dpc",
            "repro_torch.stream.service", "repro_torch.kernels.density",
            "repro_torch.carry", "repro_torch.distributed.dpc",
            "repro_torch.launch.mesh"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == len(mods) >= 30
