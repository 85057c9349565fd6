"""The cost tooling: ``launch/kernel_cost.py`` (every kernel's work,
bytes and bound) against hand counts, ``record_cost`` of a recorded CPU
fit, ``launch/collective_stats.py`` on a 4-shard CPU mesh during the
distributed fits, ``launch/dryrun_dpc.py`` against the phases run on the
CPU, and ``DPCPlan.telemetry(include_cost=True)`` (the counterpart of
``tests/test_obs.py``'s ``hlo_cost`` checks)."""
import json
import math

import pytest
import torch

from repro_torch import DPCEngine, ExecSpec
from repro_torch.analysis import record
from repro_torch.core.dpc_types import with_jitter
from repro_torch.core.grid import build_grid, point_span_bounds
from repro_torch.distributed import distributed_dpc
from repro_torch.distributed import dpc as ddpc
from repro_torch.engine import planner
from repro_torch.kernels import blocksparse, ops
from repro_torch.kernels.sweep import PAD_COORD
from repro_torch.launch import ShardMesh, collective_stats, dryrun_dpc
from repro_torch.launch import kernel_cost as kc

from tests._torch_ref import uniform_points

N, M, D = 300, 200, 3            # query rows, columns, coordinates
ENTRIES, TILES = 5, 2            # a worklist's entries and row tiles
SPANS = 9


def _launch(kernel, shapes, rows, cols, entries=None, row_tiles=1):
    tile = blocksparse.BLOCK_N if entries is not None else 1
    return record.Launch(kernel=kernel, shapes=shapes,
                         dtypes=("float32",) * len(shapes), rows=rows,
                         cols=cols, d=D, row_tile=tile,
                         padded_rows=row_tiles * tile if entries is not None
                         else rows, entries=entries, device="cpu",
                         d2cut=1.0)


# per kernel name: (its launch record entry at the small shapes, the
# bytes and f32 / tensor-core operations counted by hand from the
# conventions, with every data-dependent count at its dense upper bound)
X, Y = (N, D), (M, D)
ST = (N, SPANS)
WL_PAIRS = min(ENTRIES * 256 * 512, N * M)     # every pair of every entry
HAND = {
    "fused_count_topk": (
        _launch("fused_count_topk", (X, Y), N, M),
        4 * N * D + 4 * M * D + 4 * N + 64 * N, N * M * 10, 0, True),
    "fused_count_topk_sel": (
        _launch("fused_count_topk_sel", (X, Y, (M,)), N, M),
        4 * N * D + 4 * M * D + 4 * N + 64 * N, N * M * 10, 0, True),
    "masked_nn": (
        _launch("masked_nn", (X, Y, (N,), (M,)), N, M),
        # x, keys, y, keys; (d2, parent); columns sorted and packed
        # (records of 4 floats at d = 3); rows sorted and packed
        4 * (N * D + N + M * D + M) + 8 * N + 16 * M + 4 * M * (D + 4)
        + 16 * N + 4 * N * (2 * D + 1), N * M * 10, 0, False),
    "worklist_count_topk": (
        _launch("worklist_count_topk", (X, Y), N, M, ENTRIES, TILES),
        4 * N * D + 4 * M * D + 4 * N + 64 * N + 4 * (TILES + 1)
        + 9 * ENTRIES + M * 32 + 8 * TILES, WL_PAIRS * 10, 0, False),
    "worklist_count_topk_sel": (
        _launch("worklist_count_topk_sel", (X, Y, (M,)), N, M, ENTRIES,
                TILES),
        4 * N * D + 4 * M * D + 4 * N + 64 * N + 4 * (TILES + 1)
        + 9 * ENTRIES + M * 32 + 8 * TILES + M + M * 32 + 4 * 2,
        WL_PAIRS * 10, 0, False),
    "range_count": (
        _launch("range_count", (X, Y), N, M),
        4 * N * D + 4 * M * D + 4 * N, N * M * 10, 0, True),
    "range_count_signed": (
        _launch("range_count_signed", (X, Y, (M,)), N, M),
        4 * N * D + 4 * M * D + 4 * M + 4 * N, N * M * 10, 0, True),
    "gather_masked_nn": (      # 300 slots: the key form
        _launch("gather_masked_nn", (Y, Y, (M,), (N,)), N, M),
        4 * (M * D + M) + 16 * N, N * M + N * M * 10, 0, False),
    "prefix_nn": (
        _launch("prefix_nn", (X, X), N, N),
        4 * N * D + 8 * N, N * (N - 1) // 2 * 10, 0, True),
    "worklist_range_count": (
        _launch("worklist_range_count", (X, Y), N, M, ENTRIES, TILES),
        4 * N * D + 4 * M * D + 4 * N + 4 * (TILES + 1) + 5 * ENTRIES,
        WL_PAIRS * 10, 0, False),
    "worklist_masked_nn": (
        _launch("worklist_masked_nn", (X, Y, (N,), (M,)), N, M, ENTRIES,
                TILES),
        4 * (N * D + N + M * D + M) + 4 * (TILES + 1) + 8 * ENTRIES + 8 * N,
        WL_PAIRS + WL_PAIRS * 10, 0, False),
    "halo_range_count": (
        _launch("halo_range_count", (X, Y, ST, ST), N, M),
        4 * N * D + 4 * M * D + 8 * N * SPANS + 4 * N, N * M * 10, 0,
        False),
    "halo_masked_nn": (
        _launch("halo_masked_nn", (X, Y, (N,), (M,), ST, ST), N, M),
        4 * (N * D + N + M * D + M) + 8 * N * SPANS + 9 * N,
        N * M + N * M * 10, 0, False),
    "fused_count_topk_bf16": (
        # records of 8 bf16 values a column at d <= 8, in groups of 16
        _launch("fused_count_topk_bf16", (X, Y), N, M),
        4 * N * D + 4 * M * D + 4 * N + 64 * N + 2 * 208 * (2 * 8 + 8),
        2 * N * M, 32 * N * M, True),
    "fused_count_topk_bf16_sel": (
        _launch("fused_count_topk_bf16_sel", (X, Y, (M,)), N, M),
        4 * N * D + 4 * M * D + 4 * N + 64 * N + M
        + 2 * 208 * (2 * 8 + 8 + 1), 2 * N * M, 32 * N * M, True),
    "worklist_count_topk_bf16": (
        _launch("worklist_count_topk_bf16", (X, Y), N, M, ENTRIES, TILES),
        4 * N * D + 4 * M * D + 4 * N + 64 * N + 4 * (TILES + 1)
        + 9 * ENTRIES, 2 * WL_PAIRS, 32 * WL_PAIRS, False),
    "worklist_count_topk_bf16_sel": (
        _launch("worklist_count_topk_bf16_sel", (X, Y, (M,)), N, M, ENTRIES,
                TILES),
        4 * N * D + 4 * M * D + 4 * N + 64 * N + M + 4 * (TILES + 1)
        + 9 * ENTRIES, 2 * WL_PAIRS, 32 * WL_PAIRS, False),
    "worklist_range_count_signed": (
        _launch("worklist_range_count_signed", (X, Y, (M,)), N, M, ENTRIES,
                TILES),
        4 * N * D + 4 * M * D + 4 * N + 4 * (TILES + 1) + 5 * ENTRIES
        + 4 * M, WL_PAIRS * 11, 0, False),
    "worklist_halo_range_count": (
        _launch("worklist_halo_range_count", (X, Y, ST, ST), N, M, ENTRIES,
                TILES),
        4 * N * D + 4 * M * D + 8 * N * SPANS + 4 * N + 4 * (TILES + 1)
        + 5 * ENTRIES, WL_PAIRS * 10, 0, False),
    "worklist_halo_masked_nn": (
        _launch("worklist_halo_masked_nn", (X, Y, (N,), (M,), ST, ST), N, M,
                ENTRIES, TILES),
        4 * (N * D + N + M * D + M) + 8 * N * SPANS + 9 * N
        + 4 * (TILES + 1) + 8 * ENTRIES, WL_PAIRS + WL_PAIRS * 10, 0, False),
}


def test_every_kernel_has_a_cost():
    assert set(kc.KERNELS) == set(ops.launch_counts()) == set(HAND)
    assert sorted({k for k, _ in kc.KERNELS.values()},
                  key=lambda s: int(s[1:])) == [f"K{i}" for i in
                                                range(1, 17)]


@pytest.mark.parametrize("name", sorted(HAND))
def test_launch_cost_hand_counts(name):
    launch, nbytes, ops_, tc, exact = HAND[name]
    w = kc.launch_cost(launch)
    assert (w.bytes, w.ops, w.tc_ops, w.exact) == (nbytes, ops_, tc, exact)
    b_ms, by = kc.bound_ms(w)
    t_bytes = nbytes / 3.35e12
    t_ops = max(ops_ / (132 * 128 * 1980e6), tc / 989e12)
    assert b_ms == pytest.approx(1e3 * max(t_bytes, t_ops), rel=1e-12)
    assert by == ("bytes" if t_bytes > t_ops else "operations")


def test_data_dependent_counts_make_the_count_exact():
    """With the count that decides the work, each function counts it and
    says so; the counts enter as the conventions say."""
    w = kc.k2_work(N, M, D, denser=1234)
    assert w.exact and w.ops == 1234 * 10
    w = kc.k3_work(N, M, D, ENTRIES, TILES, needed=777, gated=True,
                   selected=50)
    assert w.exact and w.ops == 7770
    assert w.bytes == HAND["worklist_count_topk"][1] + M + 50 * 32 + 8
    assert not kc.k3_work(N, M, D, ENTRIES, TILES, needed=777,
                          gated=True).exact
    w = kc.k9_work(N, M, D, ENTRIES, TILES, key_tests=500, denser=40)
    assert w.exact and w.ops == 500 + 400
    w = kc.k10_work(N, M, D, SPANS, span_cols=999)
    assert w.exact and w.ops == 9990
    w = kc.k11_work(N, M, D, SPANS, key_tests=300, denser=20)
    assert w.exact and w.ops == 300 + 200
    w = kc.k6_work(N, M, D, "prefix", denser=60)
    assert w.exact and w.ops == 600
    assert w.bytes == kc.k2_work(N, M, D).bytes + 8 * N
    w = kc.k6_work(N, M, D, "key", denser=60, live=250)
    assert w.exact and w.ops == 250 * M + 600
    w = kc.k14_work(N, M, D, ENTRIES, TILES, pairs=100)
    assert w.exact and w.ops == 1100
    w = kc.k15_work(N, M, D, SPANS, ENTRIES, TILES, span_cols=70)
    assert w.exact and w.ops == 700
    w = kc.k16_work(N, M, D, SPANS, ENTRIES, TILES, key_tests=80, denser=8)
    assert w.exact and w.ops == 160
    w = kc.bf16_work(N, M, 20, pairs=1000, entries=ENTRIES, row_tiles=TILES)
    assert w.exact and (w.ops, w.tc_ops) == (2000, 1000 * 32 * 2)
    with pytest.raises(ValueError, match="form"):
        kc.k6_work(N, M, D, "other")


def test_rates_for_card_and_sums():
    r = kc.Rates.for_card(114, 1755.0)
    assert r.f32_ops_per_s == 114 * 128 * 1755e6
    assert r.hbm_bytes_per_s == kc.H100.hbm_bytes_per_s
    w = kc.k4_work(N, M, D)
    assert kc.bound_ms(w, r)[0] > kc.bound_ms(w)[0]
    s = kc.k4_work(N, M, D) + kc.k2_work(N, M, D)
    assert s.bytes == kc.k4_work(N, M, D).bytes + kc.k2_work(N, M, D).bytes
    assert s.exact is False


def test_unknown_kernel_raises():
    bad = _launch("range_count_fast", (X, Y), N, M)
    with pytest.raises(KeyError, match="range_count_fast"):
        kc.launch_cost(bad)
    with pytest.raises(KeyError):
        kc.record_cost([bad])


@pytest.mark.parametrize("layout", [None, "block-sparse"])
def test_record_cost_of_a_recorded_fit(layout):
    """A CPU fit on the cuda plan (plain versions standing in for the
    kernels) under a launch recorder: ``record_cost`` is the per-kernel
    sum of ``launch_cost`` of its launches."""
    pts = uniform_points(3000, 3, seed=4)
    dc = 0.1
    eng = DPCEngine(dc, rho_min=5, device="cpu",
                    exec_spec=ExecSpec(backend="cuda", layout=layout))
    eng.fit(pts)                       # plans (and gates) outside the record
    with record.recording() as events:
        eng.fit(pts)
    launches = record.launches(events)
    assert launches
    got = kc.record_cost(events)
    want: dict = {}
    for lc in launches:
        w = kc.launch_cost(lc)
        n, s = want.get(lc.kernel, (0, kc.Work(0.0, 0.0)))
        want[lc.kernel] = (n + 1, s + w)
    assert list(got) == list(want)
    for name, (n, w) in want.items():
        g = got[name]
        assert (g["launches"], g["bytes"], g["ops"], g["tc_ops"],
                g["exact"]) == (n, w.bytes, w.ops, w.tc_ops, w.exact)
        assert (g["bound_ms"], g["bound_by"]) == kc.bound_ms(w)
        assert g["kernel"] == kc.KERNELS[name][0]
    sweep = "worklist_count_topk" if layout else "fused_count_topk"
    assert sweep in got


# ---------------------------------------------------------- collectives
def _mesh_points(n=4096, seed=11):
    return uniform_points(n, 3, seed=seed), 0.08


@pytest.mark.parametrize("strategy", ["gather", "halo"])
def test_collective_stats_during_distributed_fit(strategy):
    """Per-shard payload bytes of every collective of a 4-shard fit,
    against the hand formula from the shard shapes."""
    from repro_torch import obs

    S = 4
    pts, dc = _mesh_points()
    mesh = ShardMesh.on("cpu", shards=S)
    obs.configure("trace")
    obs.reset_spans()
    try:
        with collective_stats.counting() as cs:
            distributed_dpc(pts, mesh=mesh, d_cut=dc, strategy=strategy,
                            exec_spec=ExecSpec(backend="cuda"))
    finally:
        obs.configure("off")
    spans = {s["name"]: s.get("attrs", {}) for s in obs.spans()}
    n_pad = -(-len(pts) // S) * S
    m, d = n_pad // S, 3
    got = cs.as_dict()
    if strategy == "gather":
        # rho: the table; delta: the table and its keys
        want = {"all-gather": 4 * n_pad * d * 2 + 4 * n_pad}
        counts = {"all-gather": 3}
    else:
        hops = spans["dist.rho"]["hops_fwd"] + spans["dist.rho"]["hops_bwd"]
        want = {"collective-permute": 4 * hops * m * d
                + 4 * hops * m * (d + 1)}
        counts = {"collective-permute": 2 * hops}
        if "dist.fallback" in spans:   # the fallback gathers both again
            want["all-gather"] = 4 * n_pad * d + 4 * n_pad
            counts["all-gather"] = 2
    assert got["bytes"] == want
    assert got["counts"] == counts
    assert got["total_bytes"] == sum(want.values())
    assert all(v == [want[k]] * S for k, v in got["per_shard"].items())


def test_collective_stats_nesting_and_idle():
    mesh = ShardMesh.on("cpu", shards=2)
    parts = [torch.zeros(3, 2), torch.zeros(3, 2)]
    mesh.all_gather(parts)                 # no counter: nothing to count
    with collective_stats.counting() as outer:
        mesh.psum([torch.zeros(5), torch.zeros(5)])
        with collective_stats.counting() as inner:
            mesh.pmin([torch.zeros(2, dtype=torch.float64)] * 2)
            mesh.ppermute(parts, [(0, 1)])
    assert inner.as_dict()["bytes"] == {"all-reduce": 16,
                                        "collective-permute": 24}
    assert outer.as_dict()["bytes"] == {"all-reduce": 20 + 16,
                                        "collective-permute": 24}
    assert outer.as_dict()["counts"] == {"all-reduce": 2,
                                         "collective-permute": 1}
    assert collective_stats._STACK == []


# ------------------------------------------------------------ dryrun_dpc
def _phase_inputs(S=4):
    """The distributed phases' inputs as ``distributed_dpc`` builds
    them, for a uniform 4,096 x 3 table on S shards."""
    pts, dc = _mesh_points()
    mesh = ShardMesh.on("cpu", shards=S)
    grid = build_grid(torch.from_numpy(pts), dc)
    n = grid.points.shape[0]
    m_all = -(-n // S) * S
    starts, ends = point_span_bounds(grid)
    starts = ddpc._pad_rows(starts, m_all, 0)
    ends = ddpc._pad_rows(ends, m_all, 0)
    keys = with_jitter(torch.rand(n, generator=torch.Generator()
                                  .manual_seed(3)) * 50)
    return dict(
        mesh=mesh, dc=dc, n=n, span_w=grid.span_cap, starts=starts,
        ends=ends, pts_p=mesh.shard(ddpc._pad_rows(grid.points, m_all,
                                                   PAD_COORD)),
        st_p=mesh.shard(starts), en_p=mesh.shard(ends),
        rk_p=mesh.shard(ddpc._pad_rows(keys, m_all, float("-inf"))),
        rkq_p=mesh.shard(ddpc._pad_rows(keys, m_all, float("inf"))),
        be=planner.as_plan(ExecSpec(backend="cuda")).backend)


def test_dryrun_dpc_matches_the_phases_on_the_cpu():
    """Each phase run on the CPU at the same n, d and shards: the
    collective bytes ``collective_stats`` counts equal the dry run's, and
    the pairs its kernel launches cover are at most the dry run's upper
    bound (9 spans of span_w columns a row)."""
    S = 4
    a = _phase_inputs(S)
    lo, W, hf, hb = ddpc._window_bounds(a["starts"], a["ends"], S)
    assert hf == hb == 1            # what 3 window blocks reach
    dry = dryrun_dpc.phase_costs(a["n"], 3, a["span_w"], S, 3)
    mesh, be, dc, sw = a["mesh"], a["be"], a["dc"], a["span_w"]
    calls = {
        "rho_gather": lambda: ddpc._rho_stencil(
            mesh, be, dc, sw, a["pts_p"], a["st_p"], a["en_p"]),
        "rho_halo": lambda: ddpc._rho_halo(
            mesh, be, dc, sw, lo, W, hf, hb, a["pts_p"], a["st_p"],
            a["en_p"]),
        "delta_gather": lambda: ddpc._delta_stencil(
            mesh, be, dc, sw, a["pts_p"], a["rkq_p"], a["st_p"], a["en_p"],
            a["rk_p"]),
        "delta_halo": lambda: ddpc._delta_halo(
            mesh, be, dc, sw, lo, W, hf, hb, a["pts_p"], a["rkq_p"],
            a["st_p"], a["en_p"], a["rk_p"]),
    }
    assert set(calls) == set(dry) == set(dryrun_dpc.PHASES)
    for name, call in calls.items():
        with collective_stats.counting() as cs, record.recording() as ev:
            call()
        d = dry[name]
        got = cs.as_dict()
        assert got["bytes"] == d["collectives"]["bytes"], name
        assert got["counts"] == d["collectives"]["counts"], name
        launches = record.launches(ev)
        kernel = dryrun_dpc.PHASES[name][1]
        assert [lc.kernel for lc in launches] == [kernel] * S, name
        for lc, st, en in zip(launches, a["st_p"], a["en_p"]):
            assert lc.rows == d["rows_per_shard"]
            assert lc.cols <= d["window"]
            assert lc.shapes[-1] == (d["rows_per_shard"], d["spans"])
            if name.endswith("halo"):   # the phase shifts the spans to
                continue                # its window: bounded by it above
            cols = (en.long().clamp(max=lc.cols)
                    - st.long().clamp_min(0)).clamp_min(0).sum()
            assert 0 < int(cols) <= d["pairs"], name
        assert d["bound_ms"] > 0 and d["dot_flops"] == 0.0


def test_dryrun_dpc_cli_record(tmp_path, capsys):
    assert dryrun_dpc.main(["--n", "65536", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "dpc__n65536__s256.json").read_text())
    assert set(rec) == {"n", "d", "span_w", "devices", "window_blocks",
                        "phases"}
    assert (rec["devices"], rec["span_w"], rec["window_blocks"]) == (256,
                                                                     64, 3)
    assert set(rec["phases"]) == set(dryrun_dpc.PHASES)
    halo = rec["phases"]["rho_halo"]      # 256 rows a shard, window 768
    assert halo["collectives"]["bytes"] == {
        "collective-permute": 4 * 2 * 256 * 3}
    assert halo["pairs"] == 256 * 576
    assert rec["phases"]["delta_halo"]["pairs"] == 256 * 576
    assert dryrun_dpc.main(["--n", "65536", "--multipod", "--out",
                            str(tmp_path)]) == 0
    assert json.loads((tmp_path / "dpc__n65536__s512.json")
                      .read_text())["devices"] == 512
    assert "[dpc-dryrun] delta_halo" in capsys.readouterr().out
    big = dryrun_dpc.phase_costs(1 << 24, 3, 64, 512, 3)
    assert big["rho_gather"]["rows_per_shard"] == (1 << 24) // 512
    assert math.isclose(big["rho_gather"]["collectives"]["total_bytes"],
                        4.0 * 3 * (1 << 24))


# -------------------------------------------------- the plan's "cost" block
def test_telemetry_include_cost():
    pts = uniform_points(256, 2, seed=9)
    dense = planner.as_plan(ExecSpec(backend="cuda"), torch.from_numpy(pts))
    sparse = planner.as_plan(ExecSpec(backend="cuda", layout="block-sparse"),
                             torch.from_numpy(pts))
    for pl in (dense, sparse):
        assert "cost" not in pl.telemetry()
    launches0 = ops.launch_counts()
    builds0 = blocksparse.worklist_build_count()
    hits0 = blocksparse.worklist_cache_hits()
    caches0 = [p.worklist_cache_info() for p in (dense, sparse)]
    plans0 = planner.plan_cache_info()
    cost = dense.telemetry(include_cost=True)["cost"]
    assert cost["formulation"] == "dense"
    assert set(cost["kernels"]) == {"fused_count_topk", "masked_nn"}
    assert cost["kernels"]["fused_count_topk"]["ops"] == 256 * 256 * 7
    assert cost["kernels"]["fused_count_topk"]["exact"] is True
    assert cost["kernels"]["masked_nn"]["exact"] is False
    assert cost["bytes"] > 0 and cost["bound_ms"] > 0
    assert dense.telemetry(include_cost=True)["cost"] is cost   # cached
    sc = sparse.telemetry(include_cost=True)["cost"]
    assert sc["formulation"] == "dense-upper-bound"
    assert set(sc["kernels"]) == {"worklist_count_topk",
                                  "worklist_masked_nn"}
    assert sc["kernels"]["worklist_count_topk"]["ops"] == 256 * 256 * 7
    # launched nothing, built and looked up no worklist, cached nothing
    assert ops.launch_counts() == launches0
    assert blocksparse.worklist_build_count() == builds0
    assert blocksparse.worklist_cache_hits() == hits0
    assert [p.worklist_cache_info() for p in (dense, sparse)] == caches0
    assert planner.plan_cache_info() == plans0
    bf = planner.plan((1000, 3), ExecSpec(backend="cuda", precision="bf16"))
    bc = bf.telemetry(include_cost=True)["cost"]
    assert set(bc["kernels"]) == {"fused_count_topk_bf16", "masked_nn"}
    assert bc["tc_ops"] == 1000 * 1000 * 32
    assert planner.plan(None, ExecSpec(backend="cuda")).telemetry(
        include_cost=True)["cost"] == {"error": "plan has no bound shape"}


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
def test_torch_plan_cost_names_no_kernel(layout):
    """A ``torch`` plan launches no CUDA kernel, so its cost block names
    none: it names its route (the stencil dense, the ring walk
    block-sparse), holds no bound and says why."""
    pts = torch.from_numpy(uniform_points(256, 2, seed=0))
    pl = planner.as_plan(ExecSpec(backend="torch", layout=layout), pts)
    launches0 = ops.launch_counts()
    cost = pl.telemetry(include_cost=True)["cost"]
    assert cost["kernels"] == {}
    assert "bound_ms" not in cost
    assert cost["route"] == ("stencil" if layout == "dense" else "ring")
    assert "no CUDA kernel" in cost["note"]
    names = {entry[0] for entry in kc.KERNELS.values()} | set(kc.KERNELS)
    assert not any(name in json.dumps(cost) for name in names)
    assert (cost["n"], cost["d"]) == (256, 2)
    assert ops.launch_counts() == launches0
