"""The distributed slice: ``DPCEngine(mesh=ShardMesh.on("cpu", shards=S))``
and ``distributed_dpc`` in both strategies and both layouts, held against
the JAX package's single-device Ex-DPC (``run_exdpc`` on its ``jnp``
backend: the reference's own contract for ``distributed_dpc``) and, in a
subprocess with four host devices, against its 4-device ``jnp``
block-sparse ``distributed_dpc``; the shard mesh's collectives and the halo
window.  Inputs are built once with numpy and handed to both packages."""
import json
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.exdpc import run_exdpc as jrun_exdpc
from repro.data.points import gaussian_mixture, with_noise
from repro.distributed import DistDPCConfig as JDistDPCConfig
from repro.engine import ExecSpec as JExecSpec

from repro_torch import DPCEngine, ExecSpec, carry, obs
from repro_torch.core.exdpc import run_exdpc
from repro_torch.core.grid import build_grid, point_span_bounds
from repro_torch.distributed import DistDPCConfig, distributed_dpc
from repro_torch.distributed import dpc as ddpc
from repro_torch.kernels import sweep
from repro_torch.launch import ShardMesh

SRC = Path(__file__).resolve().parents[1] / "src"

_REF: dict = {}


def _data(name):
    """The reference test's inputs (tests/test_distributed_dpc.py) and
    uniform 800 x 3."""
    if name == "uniform":
        rng = np.random.default_rng(5)
        return rng.uniform(0, 10 * 900.0, size=(800, 3)).astype(
            np.float32), 900.0
    seed, d, k = (0, 2, 6) if name == "mixture-2d" else (1, 3, 4)
    pts, labels = gaussian_mixture(1200, k=k, d=d, overlap=0.03, seed=seed)
    pts, _ = with_noise(pts, labels, 0.05, seed=seed)
    return pts, 3000.0


def _ref(name):
    """(points, d_cut, the reference's jnp Ex-DPC, the port's
    single-device Ex-DPC), memoized per input."""
    if name not in _REF:
        pts, dc = _data(name)
        ref = [np.asarray(a) for a in jrun_exdpc(
            pts, dc, exec_spec=JExecSpec(backend="jnp"))]
        _REF[name] = (pts, dc, ref, run_exdpc(torch.from_numpy(pts), dc))
    return _REF[name]


def _tied_parents(pts, got, want) -> int:
    """Rows whose parents differ, each shown to be an exact distance tie."""
    rows = np.nonzero(got != want)[0]
    if rows.size:
        x = torch.from_numpy(pts)
        r = torch.from_numpy(rows)
        a = x[torch.from_numpy(got[rows]).long()]
        b = x[torch.from_numpy(want[rows]).long()]
        assert (got[rows] >= 0).all() and (want[rows] >= 0).all()
        assert torch.equal(sweep.direct_d2(x[r], a), sweep.direct_d2(x[r], b))
    return rows.size


def _check_against_reference(pts, res, ref, own):
    """rho equal; parents equal except at counted exact ties; delta equal
    to the port's single-device Ex-DPC (or both inf) and to the reference's
    to f32 rounding (XLA may contract its d2 sum into FMAs)."""
    rho, _, delta, parent = (a.numpy() for a in res)
    np.testing.assert_array_equal(rho, ref[0])
    assert _tied_parents(pts, parent, ref[3]) == 0
    assert _tied_parents(pts, parent, own.parent.numpy()) == 0
    both_inf = np.isinf(delta) & np.isinf(own.delta.numpy())
    assert ((delta == own.delta.numpy()) | both_inf).all()
    assert np.isinf(delta).sum() == np.isinf(ref[2]).sum() == 1
    fin = np.isfinite(delta)
    np.testing.assert_allclose(delta[fin], ref[2][fin], rtol=1e-6)


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
@pytest.mark.parametrize("strategy", ["gather", "halo"])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("data", ["mixture-2d", "mixture-3d", "uniform"])
def test_engine_mesh_fit_equals_exdpc(data, shards, strategy, layout):
    pts, dc, ref, own = _ref(data)
    eng = DPCEngine(dc, algorithm="exdpc", device="cpu",
                    mesh=ShardMesh.on("cpu", shards=shards),
                    strategy=strategy, exec_spec=ExecSpec(layout=layout))
    obs.configure("metrics")
    obs.reset_spans()
    try:
        eng.fit(pts)
    finally:
        obs.configure("off")
    _check_against_reference(pts, eng.result, ref, own)
    single = DPCEngine(dc, algorithm="exdpc", device="cpu").fit(pts)
    assert torch.equal(eng.clustering.labels, single.clustering.labels)
    names = [s["name"] for s in obs.spans()]
    for name in ("dist.grid", "dist.rho", "dist.delta"):
        assert names.count(name) == 1, (name, names)
    # the halo stencil leaves rows with no denser point within d_cut to the
    # fallback; the gather strategy's delta phase is globally exact
    assert names.count("dist.fallback") == (strategy == "halo")


@pytest.mark.parametrize("strategy", ["gather", "halo"])
def test_distributed_dpc_spellings(strategy):
    """The config spelling equals the keyword spelling and the function
    the engine calls; the spellings cannot be mixed."""
    pts, dc, ref, own = _ref("uniform")
    mesh = ShardMesh.on("cpu", shards=3)
    spec = ExecSpec(layout="block-sparse")
    a = distributed_dpc(pts, DistDPCConfig(d_cut=dc, strategy=strategy,
                                           exec_spec=spec), mesh)
    b = distributed_dpc(torch.from_numpy(pts), mesh=mesh, d_cut=dc,
                        exec_spec=spec, strategy=strategy)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _check_against_reference(pts, a, ref, own)
    with pytest.raises(ValueError, match="not both"):
        distributed_dpc(pts, DistDPCConfig(d_cut=dc), mesh, d_cut=dc)
    with pytest.raises(ValueError, match="d_cut"):
        distributed_dpc(pts, mesh=mesh)
    with pytest.raises(ValueError, match="ShardMesh"):
        distributed_dpc(pts, d_cut=dc)
    with pytest.raises(ValueError, match="strategy"):
        DistDPCConfig(d_cut=dc, strategy="ring")
    with pytest.raises(ValueError, match="positive"):
        DistDPCConfig(d_cut=0.0)


_JAX_SCRIPT = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np, jax
from repro.distributed import distributed_dpc
from repro.engine import ExecSpec
pts = np.load(sys.argv[1])
res = distributed_dpc(pts, mesh=jax.make_mesh((4,), ("data",)),
                      d_cut=float(sys.argv[2]),
                      exec_spec=ExecSpec(backend="jnp",
                                         layout="block-sparse"))
print("RESULT" + json.dumps([np.asarray(a).tolist() for a in res]))
"""


def test_matches_reference_four_device_block_sparse(tmp_path):
    """The reference's 4-device jnp block-sparse distributed_dpc (its one
    distributed configuration that runs on the installed jax), on the input
    of its own test, against the port's four shards in both strategies, on
    the cuda backend and on the torch backend in both layouts."""
    pts, _ = gaussian_mixture(1024, k=5, d=2, overlap=0.03, seed=3)
    np.save(tmp_path / "pts.npy", pts)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp_path / "pts.npy"),
         "2500.0"], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    ref = [np.asarray(a) for a in json.loads(line[0][len("RESULT"):])]
    own = run_exdpc(torch.from_numpy(pts), 2500.0)
    mesh = ShardMesh.on("cpu", shards=4)
    for strategy in ("gather", "halo"):
        res = distributed_dpc(pts, mesh=mesh, d_cut=2500.0,
                              exec_spec=ExecSpec(layout="block-sparse"),
                              strategy=strategy)
        _check_against_reference(pts, res, ref, own)
    # the torch reference backend, both layouts (the dense gather strategy
    # runs the gather-form stencil phases)
    for layout in ("dense", "block-sparse"):
        spec = ExecSpec(backend="torch", layout=layout)
        own = run_exdpc(torch.from_numpy(pts), 2500.0, exec_spec=spec)
        for strategy in ("gather", "halo"):
            res = distributed_dpc(pts, mesh=mesh, d_cut=2500.0,
                                  exec_spec=spec, strategy=strategy)
            _check_against_reference(pts, res, ref, own)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_halo_window_is_the_gathered_tables_rows(shards):
    pts, dc = _data("mixture-3d")
    grid = build_grid(torch.from_numpy(pts), dc)
    n = len(pts)
    m = -(-n // shards) * shards
    tbl = ddpc._pad_rows(grid.points, m, sweep.PAD_COORD)
    st, en = (ddpc._pad_rows(a, m, 0) for a in point_span_bounds(grid))
    lo, W, hf, hb = ddpc._window_bounds(st, en, shards)
    mesh = ShardMesh.on("cpu", shards=shards)
    windows = ddpc._halo_window(mesh, mesh.shard(tbl), lo, W, hf, hb)
    full = torch.cat([tbl, torch.zeros((W, tbl.shape[1]))])
    rows_per = m // shards
    for s, win in enumerate(windows):
        assert torch.equal(win, full[lo[s]:lo[s] + W])
        # the window holds the shard's rows and every slot its spans reach
        mine = slice(s * rows_per, (s + 1) * rows_per)
        live = en[mine] > st[mine]
        assert lo[s] <= s * rows_per and (s + 1) * rows_per <= lo[s] + W
        if live.any():
            assert lo[s] <= int(st[mine][live].min())
            assert int(en[mine][live].max()) <= lo[s] + W
    assert 0 <= hf < shards and 0 <= hb < shards
    if shards > 1:
        assert hf + hb >= 1          # the spans reach past a shard's block


def test_shard_mesh_collectives():
    """On one device all_gather shares one table; with distinct devices
    every collective copies to the shard's own device."""
    for mesh in (ShardMesh.on("cpu", shards=3),
                 ShardMesh(["cpu", "cpu:0", "cpu"])):
        x = torch.arange(12.0).reshape(6, 2)
        parts = mesh.shard(x)
        assert [p.shape[0] for p in parts] == [2, 2, 2]
        assert torch.equal(mesh.unshard(parts), x)
        full = mesh.all_gather(parts)
        assert all(torch.equal(f, x) for f in full)
        assert (full[0] is full[2]) == mesh.one_device
        right = mesh.ppermute(parts, [(i, (i + 1) % 3) for i in range(3)])
        assert [torch.equal(r, parts[(s - 1) % 3])
                for s, r in enumerate(right)] == [True] * 3
        half = mesh.ppermute(parts, [(0, 1)])
        assert torch.equal(half[1], parts[0]) and not half[0].any()
        low = mesh.pmin([torch.tensor([3.0, 1.0]), torch.tensor([2.0, 5.0]),
                         torch.tensor([4.0, 0.0])])
        assert all(torch.equal(v, torch.tensor([2.0, 0.0])) for v in low)
        assert [mesh.axis_index(s) for s in range(3)] == [0, 1, 2]
    assert ShardMesh(["cpu", "cpu:0"]).one_device is False
    with pytest.raises(ValueError, match="split"):
        ShardMesh.on("cpu", shards=4).shard(torch.zeros(6, 2))
    with pytest.raises(ValueError):
        ShardMesh.on("cpu", shards=0)
    with pytest.raises(ValueError):
        ShardMesh([])
    assert ShardMesh.on("cpu", 2).flatten("rows").axis == "rows"


def test_distinct_device_mesh_fit():
    pts, dc, ref, own = _ref("mixture-2d")
    mesh = ShardMesh(["cpu", "cpu:0", "cpu", "cpu:0"])
    for strategy in ("gather", "halo"):
        res = distributed_dpc(pts, mesh=mesh, d_cut=dc, strategy=strategy)
        _check_against_reference(pts, res, ref, own)


def test_block_sparse_decisions_are_counted():
    from repro_torch.engine.planner import plan
    enabled = obs.counter("dist_bs_enabled")
    before = enabled.value(reason="device-worklist-backend")
    mesh = ShardMesh.on("cpu", shards=2)
    assert ddpc.shard_blocksparse_layout(
        plan(None, ExecSpec(layout="block-sparse")), mesh) == "block-sparse"
    assert ddpc.shard_blocksparse_layout(plan(None, ExecSpec()), mesh) is None
    assert enabled.value(reason="device-worklist-backend") == before + 1
    assert obs.gauge("dist_bs_layout").value(
        reason="device-worklist-backend") == 1.0
    assert obs.counter("dist_bs_degrade_total").value(
        reason="device-worklist-backend") == 0


def test_engine_refusals(monkeypatch):
    pts, dc = _data("uniform")
    mesh = ShardMesh.on("cpu", shards=2)
    with pytest.raises(ValueError, match="exact DPC"):
        DPCEngine(dc, algorithm="approxdpc", mesh=mesh, device="cpu").fit(pts)
    eng = DPCEngine(dc, algorithm="exdpc", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="does not stream"):
        eng.partial_fit(pts[:64])
    with pytest.raises(ValueError, match="strategy"):
        DPCEngine(dc, mesh=mesh, strategy="ring", device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        DPCEngine(dc, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardMesh.on(shards=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPCEngine(dc, algorithm="exdpc", mesh=mesh)
    card_mesh = ShardMesh.on("cpu", shards=2)
    card_mesh.devices = [torch.device("cuda")] * 2
    with pytest.raises(ValueError, match="device type"):
        DPCEngine(dc, algorithm="exdpc", device="cpu", mesh=card_mesh)


def test_carried_dist_config():
    """The reference config's fields build the port's config: the pallas
    backends map to cuda and jnp to torch, the spec's layout and axis carry
    over, and the legacy fields fold into the spec where it is absent."""
    ref = JDistDPCConfig(d_cut=900.0, strategy="halo",
                         exec_spec=JExecSpec(backend="pallas-interpret",
                                             layout="block-sparse",
                                             data_axis="rows"))
    cfg = carry.dist_config(asdict(ref))
    assert cfg == DistDPCConfig(d_cut=900.0, strategy="halo",
                                exec_spec=ExecSpec(backend="cuda",
                                                   layout="block-sparse",
                                                   data_axis="rows"))
    legacy = carry.dist_config({"d_cut": 50.0, "exec_spec": None,
                                "backend": "pallas", "layout": "dense"})
    assert legacy.exec_spec == ExecSpec(backend="cuda", layout="dense")
    assert legacy.strategy == "gather"
    jnp_cfg = carry.dist_config(asdict(JDistDPCConfig(
        d_cut=1.0, exec_spec=JExecSpec(backend="jnp"))))
    assert jnp_cfg.exec_spec == ExecSpec(backend="torch")
