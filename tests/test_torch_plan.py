"""The plan layer of the port: the per-plan worklist cache and its content
fingerprint (``kernels/blocksparse.py``), the planner's worklist strategy
and telemetry (``engine/planner.py``), and the plan-time backend probe
(``resilience/degrade.py``), each held against the reference's own tests
(``tests/test_engine.py``, ``tests/test_obs.py::TestPlanTelemetry``,
``tests/test_resilience.py::TestDegrade``) and, where a counterpart
exists, against ``repro`` itself."""
import contextlib
import subprocess
from collections import OrderedDict

import numpy as np
import pytest
import torch

from repro.data.points import real_proxy
from repro.core.tuning import pick_dcut
from repro.engine import ExecSpec as JExecSpec
from repro.engine import as_plan as j_as_plan
from repro.kernels import blocksparse as jbs
from repro.resilience import degrade as jdegrade

from repro_torch import DPCEngine, ExecSpec, obs
from repro_torch.engine import planner
from repro_torch.kernels import blocksparse, build
from repro_torch.kernels.backend import get_backend
from repro_torch.resilience import degrade, faultinject

from _torch_ref import one_thread, uniform_points  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    faultinject.deactivate()
    degrade.reset()
    yield
    faultinject.deactivate()
    degrade.reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _airline(n=2000):
    pts, _ = real_proxy("airline", n, seed=0)
    return pts, pick_dcut(pts, target_rho=30)


def _uncached(monkeypatch):
    """Fits with the plans' worklist cache switched off."""
    monkeypatch.setattr(planner.DPCPlan, "_ctx",
                        lambda self: contextlib.nullcontext())


def _same(a, b):
    for name in ("rho", "rho_key", "delta", "parent"):
        assert torch.equal(getattr(a.result, name), getattr(b.result, name)), \
            name
    assert torch.equal(a.clustering.labels, b.clustering.labels)


# ------------------------------------------------------------ the cache
@pytest.mark.parametrize("algorithm", ["approxdpc", "sapproxdpc"])
def test_refit_builds_no_worklist(algorithm, monkeypatch, one_thread):
    """A refit of the same input serves every sweep worklist from the
    plan's cache (the reference's ``test_host_worklist_reuse``) and builds
    only its uncached best-1 rings again, with results equal bit for bit
    to an uncached fit's."""
    pts, dc = _airline()
    spec = ExecSpec(layout="block-sparse")
    planner.plan_cache_clear()
    eng = DPCEngine(dc, algorithm=algorithm, rho_min=10, exec_spec=spec,
                    device="cpu")
    b0, h0 = blocksparse.worklist_build_count(), \
        blocksparse.worklist_cache_hits()
    m0 = blocksparse.worklist_fingerprint_misses()
    eng.fit(pts)
    built = blocksparse.worklist_build_count() - b0
    cached = blocksparse.worklist_fingerprint_misses() - m0
    assert cached >= 1 and built > cached, "the fit's K3 worklist and ring"
    assert blocksparse.worklist_cache_hits() == h0
    assert eng.plan.worklist_cache_info()["entries"] == cached
    cold = {n: getattr(eng.result, n).clone()
            for n in ("rho", "delta", "parent")}
    eng.fit(pts)
    assert blocksparse.worklist_build_count() == b0 + 2 * built - cached, \
        "a same-data refit rebuilt a sweep worklist"
    assert blocksparse.worklist_cache_hits() == h0 + cached
    assert blocksparse.worklist_fingerprint_misses() == m0 + cached
    for n, v in cold.items():
        assert torch.equal(getattr(eng.result, n), v)
    _uncached(monkeypatch)
    plain = DPCEngine(dc, algorithm=algorithm, rho_min=10, exec_spec=spec,
                      device="cpu").fit(pts)
    assert blocksparse.worklist_build_count() == b0 + 3 * built - cached
    _same(eng, plain)


def test_refit_misses_on_a_moved_point_and_a_new_dcut(monkeypatch,
                                                      one_thread):
    """One coordinate one ulp away is another identity, and so is another
    d_cut; each refit equals an uncached fit of the same points."""
    pts, dc = _airline()
    spec = ExecSpec(layout="block-sparse")
    planner.plan_cache_clear()
    eng = DPCEngine(dc, rho_min=10, exec_spec=spec, device="cpu").fit(pts)
    nudged = pts.copy()
    nudged[717, 1] = np.nextafter(nudged[717, 1], np.float32(np.inf))
    m0 = blocksparse.worklist_fingerprint_misses()
    b0 = blocksparse.worklist_build_count()
    eng.fit(nudged)
    assert blocksparse.worklist_fingerprint_misses() > m0
    assert blocksparse.worklist_build_count() > b0
    m1 = blocksparse.worklist_fingerprint_misses()
    other = DPCEngine(dc * 1.25, rho_min=10, exec_spec=spec,
                      device="cpu").fit(pts)
    assert other.plan is eng.plan
    assert blocksparse.worklist_fingerprint_misses() > m1
    _uncached(monkeypatch)
    want = DPCEngine(dc, rho_min=10, exec_spec=spec, device="cpu").fit(nudged)
    _same(eng, want)
    want = DPCEngine(dc * 1.25, rho_min=10, exec_spec=spec,
                     device="cpu").fit(pts)
    _same(other, want)


def counts():
    return blocksparse.worklist_build_count()


def test_source_dtype_and_perturbation_miss_as_in_the_reference():
    """The reference's ``test_worklist_fingerprint_source_dtype_miss`` and
    ``_perturbation_miss``: the same calls give the same hits and misses in
    both packages."""
    pts32 = uniform_points(600, 2, seed=16)
    pts64 = pts32.astype(np.float64)
    bumped = pts32.copy()
    bumped[17, 0] = np.nextafter(bumped[17, 0], np.float32(2.0))
    dc = 0.05
    seq = [(pts32, pts32), (pts32, pts32), (pts64, pts64), (pts64, pts32),
           (bumped, bumped), (pts32, pts32)]

    def port(x, y):
        return blocksparse.build_flat_worklist(_t(x), _t(y), dc)

    got = []
    with blocksparse.worklist_cache(OrderedDict()):
        for x, y in seq:
            b = counts()
            port(x, y)
            got.append(counts() - b)
    want = []
    with jbs.worklist_cache(OrderedDict()):
        for x, y in seq:
            b = jbs.worklist_build_count()
            jbs.build_flat_worklist(x, y, dc, block_n=256, block_m=512,
                                    count=True, nn="topk", k=8)
            want.append(jbs.worklist_build_count() - b)
    assert got == want == [1, 0, 1, 1, 1, 0]


def test_column_counts_and_knobs_are_in_the_key():
    """S-Approx-DPC's gate reaches the build as ``nn_col_counts``: other
    counts, like any other form knob, miss."""
    x = _t(uniform_points(900, 2, seed=3))
    nbc = -(-900 // blocksparse.BLOCK_M)
    c1 = torch.tensor([3] * nbc)
    c2 = torch.tensor([3] * (nbc - 1) + [4])
    calls = [dict(nn_col_counts=c1), dict(nn_col_counts=c1.clone()),
             dict(nn_col_counts=c2), dict(), dict(count=True, nn=None),
             dict(count=True, nn=None), dict(k=4)]
    got = []
    with blocksparse.worklist_cache(OrderedDict()):
        for kw in calls:
            b = counts()
            blocksparse.build_flat_worklist(x, x, 0.05, **kw)
            got.append(counts() - b)
    assert got == [1, 0, 1, 1, 1, 0, 1]


def test_rings_are_never_cached():
    """A best-1 ring (K9's, and the halo ring of K16) is built every time,
    inside a cache scope too, and takes no fingerprint."""
    x = _t(uniform_points(900, 2, seed=4))
    cache = OrderedDict()
    h, m = blocksparse.worklist_cache_hits(), \
        blocksparse.worklist_fingerprint_misses()
    with blocksparse.worklist_cache(cache):
        for _ in range(2):
            b = counts()
            blocksparse.build_flat_worklist(x, x, count=False, nn="best1")
            assert counts() == b + 1
        starts = torch.zeros((900, 1), dtype=torch.int64)
        ends = torch.full((900, 1), 900, dtype=torch.int64)
        for _ in range(2):
            b = counts()
            blocksparse.build_flat_worklist(
                x, x, 0.05, count=False, nn="best1", nn_dcut=True,
                starts=starts, ends=ends)
            assert counts() == b + 1
    assert len(cache) == 0
    assert blocksparse.worklist_cache_hits() == h
    assert blocksparse.worklist_fingerprint_misses() == m


def test_trim_oldest_first_by_entries_and_bytes(monkeypatch):
    xs = [_t(uniform_points(700, 2, seed=s)) for s in range(4)]
    cache = OrderedDict()
    monkeypatch.setattr(blocksparse, "WL_CACHE_MAX_ENTRIES", 2)
    with blocksparse.worklist_cache(cache):
        wls = [blocksparse.build_flat_worklist(x, x, 0.05) for x in xs]
    assert [id(w) for w in cache.values()] == [id(w) for w in wls[2:]]
    with blocksparse.worklist_cache(cache):
        b = counts()
        assert blocksparse.build_flat_worklist(xs[2], xs[2], 0.05) is wls[2]
        blocksparse.build_flat_worklist(xs[0], xs[0], 0.05)
        assert counts() == b + 1
    assert len(cache) == 2 and list(cache.values())[0] is wls[2]
    monkeypatch.undo()
    cache = OrderedDict()
    one = wls[0].nbytes
    monkeypatch.setattr(blocksparse, "WL_CACHE_MAX_BYTES",
                        one + wls[1].nbytes)
    with blocksparse.worklist_cache(cache):
        for x in xs:
            blocksparse.build_flat_worklist(x, x, 0.05)
    assert sum(w.nbytes for w in cache.values()) <= one + wls[1].nbytes
    assert list(cache.values())[-1].n_kept == wls[3].n_kept
    assert len(cache) < 4
    cache = OrderedDict()
    monkeypatch.setattr(blocksparse, "WL_CACHE_MAX_BYTES", 1)
    with blocksparse.worklist_cache(cache):
        blocksparse.build_flat_worklist(xs[0], xs[0], 0.05)
        blocksparse.build_flat_worklist(xs[1], xs[1], 0.05)
    assert len(cache) == 1, "the newest entry always stays"


def test_direct_backend_calls_never_cache(one_thread):
    x = _t(uniform_points(800, 2, seed=15))
    be = get_backend("cuda")
    b = counts()
    be.rho_delta(x, x, 0.05, layout="block-sparse")
    per_call = counts() - b
    assert per_call >= 1
    be.rho_delta(x, x, 0.05, layout="block-sparse")
    assert counts() == b + 2 * per_call
    b = counts()
    blocksparse.build_flat_worklist(x, x, 0.05)
    blocksparse.build_flat_worklist(x, x, 0.05)
    assert counts() == b + 2


def test_the_innermost_cache_serves():
    x = _t(uniform_points(500, 2, seed=9))
    outer, inner = OrderedDict(), OrderedDict()
    with blocksparse.worklist_cache(outer):
        blocksparse.build_flat_worklist(x, x, 0.05)
        with blocksparse.worklist_cache(inner):
            b = counts()
            blocksparse.build_flat_worklist(x, x, 0.05)
            assert counts() == b + 1
    assert len(outer) == len(inner) == 1


def test_suspend_counters_restores_every_worklist_family():
    """The reference's ``test_suspend_counters_restores_worklist_metrics``,
    over every worklist family."""
    names = ("worklist_builds", "worklist_cache_hits",
             "worklist_fingerprint_misses", "worklist_len",
             "worklist_pruned_frac")
    x = _t(uniform_points(400, 2, seed=1))
    before = {n: obs.get_metric(n).series() for n in names}
    with blocksparse.suspend_counters():
        with blocksparse.worklist_cache(OrderedDict()):
            blocksparse.build_flat_worklist(x, x, 0.05)
            blocksparse.build_flat_worklist(x, x, 0.05)
        assert obs.get_metric("worklist_builds").value() == \
            before["worklist_builds"].get("", 0) + 1
    assert {n: obs.get_metric(n).series() for n in names} == before
    assert set(names) <= set(obs.metrics_snapshot())


class _NoHost(torch.Tensor):
    """A tensor whose values may not be copied to the host."""

    def cpu(self, *a, **k):
        raise AssertionError("the fingerprint copied the points to the host")

    def numpy(self, *a, **k):
        raise AssertionError("the fingerprint read the points as numpy")


def test_fingerprint_reads_the_points_where_they_are():
    pts = uniform_points(1000, 3, seed=21)
    x = _t(pts).as_subclass(_NoHost)
    with pytest.raises(AssertionError):
        x.cpu()
    want = blocksparse.fingerprint(_t(pts))
    assert blocksparse.fingerprint(x) == want
    key = blocksparse._wl_key(x, x, ("torch.float32",) * 2, 0.01,
                              (True, "topk", 8, False), None, None, None)
    with blocksparse.worklist_cache(OrderedDict()):
        b = counts()
        blocksparse.build_flat_worklist(x, x, 0.1)
        blocksparse.build_flat_worklist(x, x, 0.1)
        assert counts() == b + 1
    assert isinstance(key, bytes) and len(key) == 16


def test_fingerprint_is_construction_independent():
    """The same values give the same key whatever made the tensor: numpy's
    buffer, a list, a transposed copy, a slice of a larger table."""
    pts = uniform_points(999, 3, seed=22)
    big = np.zeros((1200, 3), np.float32)
    big[100:1099] = pts
    ways = [_t(pts), torch.tensor(pts.tolist(), dtype=torch.float32),
            _t(np.asfortranarray(pts)), torch.from_numpy(pts.T.copy()).t(),
            _t(big)[100:1099]]
    assert not ways[3].is_contiguous()
    fps = {blocksparse.fingerprint(t) for t in ways}
    assert len(fps) == 1
    keys = {blocksparse._wl_key(t, t, ("torch.float32",) * 2, 0.01,
                                (True, "topk", 8, False), None, None, None)
            for t in ways}
    assert len(keys) == 1


def test_fingerprint_sees_one_changed_word_anywhere(monkeypatch):
    """Every single-word change moves the key: each bit of a few words
    across the chunk and row boundaries, and a word's two halves swapped.
    The lanes are exact residues, so the chunking (shrunk here) changes
    no result."""
    n = (1 << 12) + 3 * (1 << 6) + 5
    w = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(0))
    base = blocksparse.fingerprint(w)
    monkeypatch.setattr(blocksparse, "_FP_CHUNK", 1 << 12)
    monkeypatch.setattr(blocksparse, "_FP_ROW", 1 << 6)
    assert blocksparse.fingerprint(w) == base
    for pos in (0, blocksparse._FP_ROW - 1, blocksparse._FP_CHUNK,
                n - 1):
        for bit in range(32):
            v = w.clone()
            v[pos] ^= (1 << bit) if bit < 31 else -2**31
            assert blocksparse.fingerprint(v) != base, (pos, bit)
        v = w.clone()
        u = int(v[pos]) & 0xFFFFFFFF
        v[pos] = int(np.uint32(((u & 0xFFFF) << 16) | (u >> 16))
                     .view(np.int32))
        if int(v[pos]) != int(w[pos]):
            assert blocksparse.fingerprint(v) != base
    # the two lanes are the residues of sum(u_i * a_i) mod p, by big ints
    small = w[:3000]
    u = [int(t) & 0xFFFFFFFF for t in small.tolist()]
    want = tuple(sum(ui * (1 + (i * mult) % (p - 1))
                     for i, ui in enumerate(u)) % p
                 for p, mult in blocksparse._FP_LANES)
    assert blocksparse.fingerprint(small) == want


# ----------------------------------------------------------- the planner
@pytest.mark.parametrize("backend,layout,strategy,jstrategy", [
    ("cuda", "dense", "dense", "dense"),
    ("cuda", "block-sparse", "device", "host"),
    ("torch", "dense", "dense", "dense"),
    ("torch", "block-sparse", "ring", "traced")])
def test_worklist_strategy(backend, layout, strategy, jstrategy,
                           monkeypatch):
    """The port's strategies against the reference's for the counterpart
    backend (cuda ~ pallas, torch ~ jnp); the reference's probe off."""
    monkeypatch.setenv("REPRO_ANALYSIS", "suspend")
    monkeypatch.setenv("REPRO_DEGRADE", "0")
    pl = planner.plan((300, 2), ExecSpec(backend=backend, layout=layout))
    assert pl.worklist_strategy == strategy
    assert pl.telemetry()["worklists"]["strategy"] == strategy
    jbackend = {"cuda": "pallas-interpret", "torch": "jnp"}[backend]
    jpl = j_as_plan(JExecSpec(backend=jbackend, layout=layout))
    assert jpl.worklist_strategy == jstrategy
    assert pl.describe() == \
        f"DPCPlan[{backend}:{layout}:f32 n=300 d=2]"


def test_telemetry_static_axes_and_pad(monkeypatch):
    """The reference's ``TestPlanTelemetry.test_static_axes_and_pad``: the
    ring walk's plan against the jnp block-sparse plan, field by field."""
    monkeypatch.setenv("REPRO_ANALYSIS", "suspend")
    pts = uniform_points(200, 2, seed=0)
    t = planner.as_plan(ExecSpec(backend="torch", layout="block-sparse"),
                        _t(pts)).telemetry()
    import jax.numpy as jnp
    jt = j_as_plan(JExecSpec(backend="jnp", layout="block-sparse"),
                   jnp.asarray(pts)).telemetry()
    for k in ("layout", "precision", "grid_sort", "data_axis", "shape",
              "pad"):
        assert t[k] == jt[k], k
    assert t["backend"] == "torch" and jt["backend"] == "jnp"
    assert t["pad"]["row_block"] == blocksparse.BS_BLOCK_N
    assert t["pad"]["padded_n"] % t["pad"]["row_block"] == 0
    assert 0.0 <= t["pad"]["pad_waste_frac"] < 1.0
    assert "hlo_cost" not in t and "hlo_cost" not in jt
    assert set(jt["memory"]) <= set(t["memory"])     # the analyzer's block
    dense = planner.as_plan(ExecSpec(), _t(pts)).telemetry()
    assert dense["pad"] == {"row_block": 1, "n": 200, "padded_n": 200,
                            "pad_waste_frac": 0.0}
    assert planner.plan(None, ExecSpec()).telemetry()["pad"] is None


def test_telemetry_reports_the_cached_worklists(one_thread):
    pts, dc = _airline(1500)
    eng = DPCEngine(dc, rho_min=10, exec_spec=ExecSpec(
        layout="block-sparse"), device="cpu")
    planner.plan_cache_clear()
    eng.fit(pts)
    t = eng.plan.telemetry()["worklists"]
    assert t["strategy"] == "device"
    assert t["cache_entries"] == len(t["cached"]) >= 1
    assert t["cache_bytes"] == sum(c["bytes"] for c in t["cached"]) > 0
    for c in t["cached"]:
        assert 0 < c["n_kept"] <= c["n_total"]
        assert 0.0 <= c["pruned_frac"] < 1.0
        assert c["bytes"] >= 9 * c["n_kept"]
    info = eng.plan.worklist_cache_info()
    assert info["entries"] == t["cache_entries"]
    assert info["max"] == 8 and info["max_bytes"] == 1 << 30
    assert planner.plan_cache_bytes() >= t["cache_bytes"]
    planner.plan_cache_clear()
    assert eng.plan.worklist_bytes() == 0 and planner.plan_cache_bytes() == 0


def _fit_sizes(sizes, seed=0):
    """Block-sparse fits at each size in turn, each on its own plan;
    returns the engines."""
    engs = []
    for n in sizes:
        eng = DPCEngine(0.05, rho_min=2, exec_spec=ExecSpec(
            layout="block-sparse"), device="cpu")
        eng.fit(uniform_points(n, 2, seed=seed + n))
        engs.append(eng)
    return engs


def test_all_plans_together_hold_to_the_cap(monkeypatch, one_thread):
    """Plans are memoized per shape, each with its worklists: fitting many
    sizes keeps ``plan_cache_bytes()`` under ``WL_CACHE_MAX_BYTES``, the
    least recently used plans giving theirs up first."""
    planner.plan_cache_clear()
    one = _fit_sizes([900])[0].plan.worklist_bytes()
    assert one > 0
    cap = 2 * one + one // 2
    monkeypatch.setattr(blocksparse, "WL_CACHE_MAX_BYTES", cap)
    engs = _fit_sizes([600, 700, 800, 1000, 1100])
    assert len({id(e.plan) for e in engs}) == len(engs)
    held = planner.plan_cache_bytes()
    assert 0 < held <= cap
    assert engs[-1].plan.worklist_bytes() > 0, "the plan just used keeps its"
    assert engs[0].plan.worklist_bytes() == 0, "the oldest gave its up"
    b = counts()
    engs[-1].fit(uniform_points(1100, 2, seed=1100))
    assert counts() - b < 2, "the newest plan's refit still hits"
    assert planner.plan_cache_bytes() <= cap
    planner.plan_cache_clear()


def test_an_evicted_plan_frees_its_worklists(monkeypatch, one_thread):
    planner.plan_cache_clear()
    monkeypatch.setattr(planner, "_PLAN_CACHE_MAX", 2)
    engs = _fit_sizes([600, 700])
    first = engs[0].plan
    assert first.worklist_bytes() > 0
    engs += _fit_sizes([800])
    assert planner.plan_cache_info()["entries"] == 2
    assert first.worklist_bytes() == 0
    assert planner.plan_cache_bytes() == sum(
        e.plan.worklist_bytes() for e in engs[1:])
    planner.plan_cache_clear()


# ------------------------------------------------------------- degrade
def _fresh_spec(**kw):
    planner.plan_cache_clear()
    return ExecSpec(**kw)


def test_failed_probe_raises_at_plan_by_default(monkeypatch):
    """A forced ``degrade.probe`` failure raises at ``plan()``, naming the
    reason and the explicit way to the plain math; no plan is memoized."""
    faultinject.activate("degrade.probe", trigger=0)
    with pytest.raises(RuntimeError, match="failed its probe.*FaultError"):
        planner.plan((64, 2), _fresh_spec())
    with pytest.raises(RuntimeError, match=r"ExecSpec\(backend='torch'\)"):
        degrade.resolve_backend("cuda")
    assert planner.plan_cache_info()["entries"] == 0


def test_degrade_only_by_explicit_choice(monkeypatch):
    """The one way onto the plain PyTorch math is to ask for it,
    ``ExecSpec(backend="torch")``, which is never probed; the reference's
    ``REPRO_DEGRADE`` setting changes nothing here.  The reference, under
    the same probe failure, degrades by default (its
    ``test_forced_full_chain_lands_on_jnp``)."""
    monkeypatch.setenv("REPRO_DEGRADE", "1")
    fp = faultinject.activate("degrade.probe", trigger=0)
    with pytest.raises(RuntimeError, match="failed its probe"):
        planner.plan((64, 2), _fresh_spec())
    pl = planner.plan((64, 2), _fresh_spec(backend="torch"))
    assert pl.backend_name == "torch"
    assert pl.describe() == "DPCPlan[torch:dense:f32 n=64 d=2]"
    assert degrade.resolve_backend("torch") == "torch"
    assert fp.hits == 1, "only the cuda plan was probed"
    monkeypatch.setenv("REPRO_DEGRADE", "0")
    degrade.reset()
    with pytest.raises(RuntimeError, match="failed its probe"):
        degrade.resolve_backend(None)
    assert not hasattr(degrade, "DEGRADE_CHAIN")
    jdegrade.reset()
    from repro.resilience import faultinject as jfault
    monkeypatch.delenv("REPRO_DEGRADE")
    jfault.activate("degrade.probe", trigger=0)
    try:
        with pytest.warns(RuntimeWarning, match="degrading"):
            assert jdegrade.resolve_backend("pallas") == "jnp"
    finally:
        jfault.deactivate()
        jdegrade.reset()
    planner.plan_cache_clear()


def test_bf16_never_degrades(monkeypatch):
    """A bf16 plan whose probe fails raises, as every plan does; on the
    ``torch`` backend, which has no bf16 path, it raises too."""
    faultinject.activate("degrade.probe", trigger=0)
    with pytest.raises(RuntimeError, match="failed its probe"):
        planner.plan((64, 2), _fresh_spec(precision="bf16"))
    with pytest.raises(ValueError, match="bf16"):
        planner.plan((64, 2), _fresh_spec(backend="torch", precision="bf16"))
    planner.plan_cache_clear()


def test_probe_on_a_host_without_cuda_builds_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the probe must not build on a CPU host")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fp = faultinject.activate("degrade.probe", trigger=2)
    assert degrade.probe_backend("cuda") is None
    assert fp.hits == 1, "the probe fires its fault site"
    assert degrade.probe_backend("cuda") is None
    assert fp.hits == 1, "memoized per process"
    assert degrade.resolve_backend(None) == "cuda"
    assert planner.plan((64, 2), _fresh_spec()).backend_name == "cuda"
    planner.plan_cache_clear()
