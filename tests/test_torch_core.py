"""The port's core stages, spec, planner, admission and obs layers held
against the JAX package (inputs built once with numpy)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import grid as jgrid
from repro.core.dpc_types import DPCResult as JResult
from repro.core.dpc_types import density_jitter as jjitter
from repro.core.dpc_types import with_jitter as jwith_jitter
from repro.core.labels import assign_labels as jassign
from repro.core.tuning import pick_dcut as jpick_dcut
from repro.data import points as jpoints
from repro.engine.spec import ExecSpec as JExecSpec

from repro_torch import carry, obs
from repro_torch.core import grid as tgrid
from repro_torch.core.dpc_types import density_jitter, with_jitter
from repro_torch.core.labels import assign_labels, decision_graph
from repro_torch.core.tuning import pick_dcut
from repro_torch.data import points as tpoints
from repro_torch.engine import planner
from repro_torch.engine.spec import ExecSpec
from repro_torch.resilience.sanitize import (AdmissionConfig,
                                             PoisonedInputError, admit)

from _torch_ref import uniform_points

_ARRAYS = ("points", "order", "inv_order", "cand_key", "group_key",
           "cand_coords", "cand_extent", "cand_strides", "cell_keys",
           "cell_start", "cell_count", "point_cell")
_STATIC = ("num_cells", "span_cap", "cell_cap", "g", "d", "d_cut")


@pytest.mark.parametrize("n", [1, 7, 1000, 65537])
def test_density_jitter_bit_exact(n):
    a = np.asarray(jjitter(n))
    b = density_jitter(n).numpy()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("d", [2, 3, 4, 8])
def test_build_grid_matches_reference(d):
    pts, _ = jpoints.gaussian_mixture(1500, k=6, d=d, seed=d)
    dc = jpick_dcut(pts, target_rho=25)
    jg = jgrid.build_grid(jnp.asarray(pts), dc)
    tg = tgrid.build_grid(torch.from_numpy(pts), dc)
    for name in _ARRAYS:
        a = np.asarray(getattr(jg, name))
        b = getattr(tg, name).numpy()
        np.testing.assert_array_equal(b, a, err_msg=name)
        if name in ("cand_key", "group_key", "cell_keys"):
            assert a.dtype == b.dtype == np.int64, name
    for name in _STATIC:
        assert getattr(tg, name) == getattr(jg, name), name


def test_unsort_and_with_jitter_match_reference():
    pts = uniform_points(700, 2, seed=9)
    jg = jgrid.build_grid(jnp.asarray(pts), 0.05)
    tg = tgrid.build_grid(torch.from_numpy(pts), 0.05)
    rng = np.random.default_rng(9)
    rho = rng.integers(1, 30, 700).astype(np.float32)
    delta = rng.uniform(0, 1, 700).astype(np.float32)
    parent = rng.integers(-1, 700, 700).astype(np.int32)
    rk = np.asarray(jwith_jitter(jnp.asarray(rho)))
    np.testing.assert_array_equal(with_jitter(torch.from_numpy(rho)).numpy(),
                                  rk)
    want = jgrid.unsort_dpc(jg, *(jnp.asarray(a)
                                  for a in (rho, rk, delta, parent)))
    got = tgrid.unsort_dpc(tg, *(torch.tensor(a)
                                 for a in (rho, rk, delta, parent)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grid_carries_across():
    pts = uniform_points(400, 3, seed=4)
    jg = jgrid.build_grid(jnp.asarray(pts), 0.1)
    arrays = {k: np.asarray(getattr(jg, k)) for k in _ARRAYS}
    static = {k: getattr(jg, k) for k in _STATIC}
    got = carry.grid(arrays, static)
    want = tgrid.build_grid(torch.from_numpy(pts), 0.1)
    for name in _ARRAYS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    for name in _STATIC:
        assert getattr(got, name) == getattr(want, name)


def _random_result(n, seed):
    """A DPC result with a valid dependency forest (parents denser)."""
    rng = np.random.default_rng(seed)
    rho = rng.integers(1, 40, n).astype(np.float32)
    rho_key = rho + np.asarray(jjitter(n))
    order = np.argsort(-rho_key)
    parent = np.full(n, -1, np.int32)
    delta = np.full(n, np.inf, np.float32)
    for pos in range(1, n):
        parent[order[pos]] = order[rng.integers(0, pos)]
        delta[order[pos]] = rng.uniform(0.1, 5.0)
    return JResult(rho=jnp.asarray(rho), rho_key=jnp.asarray(rho_key),
                   delta=jnp.asarray(delta), parent=jnp.asarray(parent))


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_labels_on_carried_result(seed):
    jres = _random_result(3000, seed)
    jcl = jassign(jres, 12.0, 3.0)
    tres = carry.dpc_result({k: np.asarray(v)
                             for k, v in jres._asdict().items()})
    tcl = assign_labels(tres, 12.0, 3.0)
    np.testing.assert_array_equal(tcl.labels.numpy(), np.asarray(jcl.labels))
    np.testing.assert_array_equal(tcl.centers.numpy(),
                                  np.asarray(jcl.centers))
    assert int(tcl.num_clusters) == int(jcl.num_clusters) > 0
    np.testing.assert_array_equal(decision_graph(tres).numpy(),
                                  np.stack([np.asarray(jres.rho),
                                            np.asarray(jres.delta)], -1))


def test_exec_spec_carries_across():
    got = carry.exec_spec(dataclasses.asdict(JExecSpec(
        backend="pallas-interpret", block=128)))
    assert got == ExecSpec(backend="cuda", block=128)
    assert carry.exec_spec(dataclasses.asdict(JExecSpec())) == ExecSpec()
    with pytest.raises(NotImplementedError):
        carry.exec_spec(dataclasses.asdict(JExecSpec(backend="jnp")))


def test_data_copies_match_reference():
    for fn in ("gaussian_mixture", "random_walk"):
        a, la = getattr(jpoints, fn)(1000, seed=3)
        b, lb = getattr(tpoints, fn)(1000, seed=3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    pts, _ = tpoints.real_proxy("sensor", 2000, seed=2)
    assert pts.shape == (2000, 8) and pts.dtype == np.float32
    assert pick_dcut(pts) == jpick_dcut(pts)
    # seeded in every process alike (no salted string hash)
    again, _ = tpoints.real_proxy("sensor", 2000, seed=2)
    np.testing.assert_array_equal(pts, again)


def test_exec_spec_validation_and_parse():
    assert ExecSpec.parse("cuda:dense:f32") == ExecSpec(
        backend="cuda", layout="dense", precision="f32")
    assert ExecSpec.parse("") == ExecSpec()
    assert ExecSpec().describe() == "auto:dense:f32"
    for bad in ("jnp", "cuda:sparse", "cuda:dense:f16", "dense", "a:b:c:d"):
        with pytest.raises(ValueError):
            ExecSpec.parse(bad)
    with pytest.raises(ValueError):
        ExecSpec(block=0)
    with pytest.raises(ValueError):
        ExecSpec(data_axis="")


def test_planner_memoizes_and_refuses_unported_axes():
    planner.plan_cache_clear()
    a = planner.plan((100, 3), ExecSpec())
    assert planner.plan((100, 3), ExecSpec(backend="cuda")) is not a
    assert planner.plan((100, 3), ExecSpec()) is a
    assert planner.as_plan(a, torch.zeros((100, 3))) is a
    assert planner.as_plan(a, torch.zeros((50, 3))).pspec.n == 50
    info = planner.plan_cache_info()
    assert (info["hits"], info["misses"]) == (1, 3)
    assert a.describe() == "DPCPlan[cuda:dense:f32 n=100 d=3]"
    x = torch.from_numpy(uniform_points(100, 3, seed=8))
    key = torch.arange(100, dtype=torch.float32)
    delta, parent = a.denser_nn(x, key, x, key)
    assert parent[-1] == -1 and torch.isinf(delta[-1])
    assert (key[parent[:-1].long()] > key[:-1]).all()
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        planner.plan((100, 3), ExecSpec(layout="block-sparse"))
    with pytest.raises(NotImplementedError, match="bf16"):
        planner.plan((100, 3), ExecSpec(precision="bf16"))
    with pytest.raises(TypeError):
        planner.as_plan("cuda")


def test_admission_policies():
    pts = np.array([[0.0, 1.0], [np.nan, 2.0], [3.0, 2e9]], np.float32)
    caught = obs.counter("resilience_quarantined_points")
    before = caught.value(reason="non_finite", policy="reject", where="t")
    with pytest.raises(PoisonedInputError):
        admit(pts, AdmissionConfig(), where="t")
    assert caught.value(reason="non_finite", policy="reject",
                        where="t") == before + 1
    dropped = admit(pts, AdmissionConfig(policy="drop"))
    np.testing.assert_array_equal(dropped.keep, [True, False, False])
    assert dropped.quarantined == 2 and dropped.points.shape == (1, 2)
    clamped = admit(torch.from_numpy(pts), AdmissionConfig(policy="clamp"))
    assert np.isfinite(clamped.points).all()
    assert np.abs(clamped.points).max() < 1e9
    with pytest.raises(PoisonedInputError):
        admit(np.array([["a", "b"]]), AdmissionConfig(policy="drop"))
    with pytest.raises(ValueError):
        AdmissionConfig(policy="ignore")


def test_spans_record_only_when_enabled():
    obs.reset_spans()
    with obs.span("off") as sp:
        assert sp.sync(3) == 3
    assert obs.spans() == []
    obs.configure("trace")
    try:
        with obs.span("outer", n=1):
            with obs.span("inner") as sp:
                sp.sync(torch.ones(2))
    finally:
        obs.configure("off")
    inner, outer = obs.spans()
    assert inner["path"] == "outer/inner" and inner["parent"] == outer["id"]
    assert inner["device_s"] is not None and outer["attrs"] == {"n": 1}
    with pytest.raises(ValueError):
        obs.configure("loud")
