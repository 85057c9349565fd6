"""The ``torch`` reference backend (``kernels/backend.py::TorchBackend``),
its ring walk (``blocksparse.ring_range_count`` / ``ring_denser_nn``) and
``kernels/ref.py``, held against the JAX package's ``jnp`` backend, its
jit-built ring walk and its ``kernels/ref.py`` on the same numpy inputs.

Contracts: on exact (integer lattice) data everything bit for bit — the
ties decide the NN there, so this checks the tie order; elsewhere counts
equal off the 4-ulp band around d_cut^2, parents equal, delta to f32
rounding (XLA may sum the d2 of a pair in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.grid import build_grid as jbuild_grid
from repro.core.grid import point_span_bounds as jpoint_span_bounds
from repro.kernels import blocksparse as jbs
from repro.kernels import ref as jref
from repro.kernels.backend import get_backend as jget_backend

from repro_torch import ExecSpec, carry
from repro_torch.core.dpc_types import density_jitter
from repro_torch.engine import planner
from repro_torch.kernels import blocksparse, ref
from repro_torch.kernels.backend import (TorchBackend, available_backends,
                                         default_backend_name, get_backend,
                                         rho_delta_sequential)
from repro_torch.kernels.sweep import halo_range_count_plain

from _torch_ref import f32_d2cut, f32_ulp, near_threshold_rows
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def _lattice(high, d, n=3000, seed=0):
    return np.random.default_rng(seed).integers(
        0, high, size=(n, d)).astype(np.float32)


def _airline():
    from repro_torch.core.tuning import pick_dcut
    from repro_torch.data.points import real_proxy
    pts = real_proxy("airline", 2048, seed=2)[0]
    return pts, pick_dcut(pts)


# (points, d_cut, exact): the [0, 20)^2 and [0, 12)^3 lattices of exact
# distance ties, and the Airline proxy (domain 1e5)
_DATA = {"lattice2": lambda: (_lattice(20, 2), 1.5, True),
         "lattice3": lambda: (_lattice(12, 3), 1.01, True),
         "airline": lambda: (*_airline(), False)}
_CACHE: dict = {}


def _data(name):
    if name not in _CACHE:
        pts, dc, exact = _DATA[name]()
        rng = np.random.default_rng(len(pts))
        jit = np.asarray(density_jitter(len(pts)))
        # keys: integer levels with ties and the all-distinct jitter
        key = (rng.integers(0, 6, len(pts)) + jit).astype(np.float32)
        _CACHE[name] = (pts, dc, exact, key)
    return _CACHE[name]


def _t(a):
    return torch.from_numpy(np.array(a))


def _band(x, y, dc, exact):
    if exact:
        return np.zeros(len(x), bool)
    thr = f32_d2cut(dc)
    return near_threshold_rows(x, y, thr, 4 * f32_ulp(thr))


def _same_count(got, want, band):
    np.testing.assert_array_equal(np.asarray(got)[~band],
                                  np.asarray(want)[~band])


def _same_nn(got, want, exact):
    gd, gp = (np.asarray(a) for a in got[:2])
    wd, wp = (np.asarray(a) for a in want[:2])
    np.testing.assert_array_equal(gp, wp)
    assert (np.isinf(gd) == np.isinf(wd)).all()
    if exact:
        np.testing.assert_array_equal(gd, wd)
    else:
        fin = np.isfinite(gd)
        np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_registry_and_plan():
    """``torch`` is registered beside ``cuda``, chosen only by name; None
    and "auto" still resolve to ``cuda``; bf16 on it raises at the spec and
    at the backend; the reference's ``jnp`` specs carry to it."""
    assert available_backends() == ["cuda", "torch"]
    assert default_backend_name() == "cuda"
    assert get_backend(None).name == get_backend("auto").name == "cuda"
    be = get_backend("torch")
    assert isinstance(be, TorchBackend) and not be.mxu_dense
    assert get_backend("cuda").mxu_dense
    pl = planner.plan((10, 2), ExecSpec(backend="torch", block=64))
    assert pl.backend is be and pl.block == 64
    assert planner.plan((10, 2), ExecSpec()).backend.name == "cuda"
    with pytest.raises(ValueError, match="bf16"):
        ExecSpec(backend="torch", precision="bf16")
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="f32"):
        be.rho_delta(x, x, 1.0, precision="bf16")
    assert carry.exec_spec({"backend": "jnp", "layout": "block-sparse"}) \
        == ExecSpec(backend="torch", layout="block-sparse")
    assert ExecSpec.parse("torch:block-sparse") == ExecSpec(
        backend="torch", layout="block-sparse")


@pytest.mark.parametrize("data", list(_DATA))
def test_dense_primitives_match_jnp(data):
    pts, dc, exact, key = _data(data)
    be, jbe = get_backend("torch"), jget_backend("jnp")
    x, k = _t(pts), _t(key)
    band = _band(pts, pts, dc, exact)
    _same_count(be.range_count(x, x, dc),
                jbe.range_count(pts, pts, dc), band)
    _same_nn(be.denser_nn(x, k, x, k), jbe.denser_nn(pts, key, pts, key),
             exact)
    d2, p = be.denser_nn(x, k, x, k, squared=True)
    dd, pp = be.denser_nn(x, k, x, k)
    assert torch.equal(torch.sqrt(d2), dd) and torch.equal(p, pp)
    order = np.argsort(-key, kind="stable")
    _same_nn(be.prefix_nn(x[order]), jbe.prefix_nn(pts[order]), exact)
    # the stream's signed count over an insert/evict batch with padding
    rng = np.random.default_rng(1)
    rows = rng.choice(len(pts), 300, replace=False)
    signs = rng.choice([-1.0, 0.0, 1.0], 300).astype(np.float32)
    _same_count(be.range_count_delta(x, x[rows], _t(signs), dc),
                jbe.range_count_delta(pts, pts[rows], signs, dc),
                _band(pts, pts[rows], dc, exact))


@pytest.mark.parametrize("data", list(_DATA))
def test_rho_delta_and_sequential_match_jnp(data):
    """The fused call equals the reference's fused jnp forms (dense and
    block-sparse), with and without the representatives' gate, and the
    port's two-pass ``rho_delta_sequential`` bit for bit."""
    pts, dc, exact, _ = _data(data)
    be, jbe = get_backend("torch"), jget_backend("jnp")
    x = _t(pts)
    band = _band(pts, pts, dc, exact)
    sel = np.sort(np.random.default_rng(3).choice(len(pts), len(pts) // 3,
                                                  replace=False))
    for layout in ("dense", "block-sparse"):
        got = be.rho_delta(x, x, dc, layout=layout,
                           fallback_interest=lambda rk: rk < 0)
        want = jbe.rho_delta(pts, pts, dc, layout=layout)
        _same_count(got[0], want[0], band)
        _same_nn((got[2], got[3]), (want[2], want[3]), exact)
        seq = rho_delta_sequential(be, x, x, dc, layout=layout)
        for a, b in zip(got, seq):
            assert torch.equal(a, b)
        jit = density_jitter(len(sel))
        got = be.rho_delta(x[sel], x, dc, jitter=jit, y_sel_slots=_t(sel),
                           layout=layout)
        want = jbe.rho_delta(pts[sel], pts, dc, jitter=np.asarray(jit),
                             y_sel_slots=sel, layout=layout)
        _same_count(got[0], want[0], band[sel])
        _same_nn((got[2], got[3]), (want[2], want[3]), exact)


@pytest.mark.parametrize("data", list(_DATA))
def test_block_sparse_primitives_match_jnp(data):
    """The ring walk equals the reference's ring walk on the grid-sorted
    table (compact tiles), and the port's dense primitives bit for bit on
    it and on the unsorted table (where little prunes)."""
    pts, dc, exact, key = _data(data)
    be, jbe = get_backend("torch"), jget_backend("jnp")
    sp = np.asarray(jbuild_grid(jnp.asarray(pts), dc).points)
    signs = np.where(np.arange(len(pts)) % 3 == 0, -1.0, 1.0).astype(
        np.float32)[::2]
    for p in (pts, sp):             # the sorted table's answers kept last
        x, k, w = _t(p), _t(key), _t(signs)
        got = [be.range_count(x, x, dc, layout="block-sparse"),
               *be.denser_nn(x, k, x, k, layout="block-sparse"),
               be.range_count_delta(x, x[::2], w, dc, layout="block-sparse")]
        dense = [be.range_count(x, x, dc), *be.denser_nn(x, k, x, k),
                 be.range_count_delta(x, x[::2], w, dc)]
        for a, b in zip(got, dense):
            assert torch.equal(a, b)
    band = _band(sp, sp, dc, exact)
    _same_count(got[0], jbe.range_count(sp, sp, dc, layout="block-sparse"),
                band)
    _same_nn(got[1:3], jbe.denser_nn(sp, key, sp, key,
                                     layout="block-sparse"), exact)
    _same_count(got[3], jbe.range_count_delta(
        sp, sp[::2], signs, dc, layout="block-sparse"),
        _band(sp, sp[::2], dc, exact))


@pytest.mark.parametrize("n,m", [(1, 1), (129, 255), (300, 7), (257, 600),
                                 (500, 500)])
def test_ring_walk_edges(n, m):
    """Ragged tiles, fewer columns than a tile, a single row, query rows
    keyed +inf (padding: never resolved) and columns keyed -inf (never
    denser); both walks against the reference's and against the dense
    plain versions."""
    rng = np.random.default_rng(n + m)
    x = rng.integers(0, 9, (n, 2)).astype(np.float32)
    y = rng.integers(0, 9, (m, 2)).astype(np.float32)
    xk = (rng.integers(0, 4, n) + 0.5).astype(np.float32)
    yk = rng.integers(0, 4, m).astype(np.float32)
    xk[::5] = np.inf
    yk[::7] = -np.inf
    w = rng.choice([-1.0, 0.0, 1.0], m).astype(np.float32)
    dc = 2.5
    be = get_backend("torch")
    cnt = blocksparse.ring_range_count(_t(x), _t(y), dc)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(
        jbs._count_bs_jnp(x, y, None, dc)))
    np.testing.assert_array_equal(cnt.numpy(), be.range_count(
        _t(x), _t(y), dc).numpy())
    sgn = blocksparse.ring_range_count(_t(x), _t(y), dc, _t(w))
    np.testing.assert_array_equal(sgn.numpy(), np.asarray(
        jbs._count_bs_jnp(x, y, w, dc, signed=True)))
    best, arg = blocksparse.ring_denser_nn(_t(x), _t(xk), _t(y), _t(yk))
    jd, jp = (np.asarray(a) for a in jbs._denser_nn_bs_jnp(x, xk, y, yk))
    np.testing.assert_array_equal(arg.numpy(), jp)
    np.testing.assert_array_equal(torch.sqrt(best).numpy(), jd)
    dd, dp = be.denser_nn(_t(x), _t(xk), _t(y), _t(yk))
    assert torch.equal(arg, dp) and torch.equal(torch.sqrt(best), dd)
    assert (arg.numpy()[np.isinf(xk)] == -1).all()


def _halo_case(data):
    """Spans of each row of a slice of the grid-sorted table into a
    window of it, as a halo shard sees them: window-local, some negative
    or past the window (clipped), some empty."""
    pts, dc, exact, key = _data(data)
    grid = jbuild_grid(jnp.asarray(pts), dc)
    sp = np.asarray(grid.points)
    st, en = (np.asarray(a).astype(np.int64)
              for a in jpoint_span_bounds(grid))
    n = len(sp)
    lo, hi = n // 4, n - n // 5
    rows = np.arange(n // 3, n // 3 + 700)
    win = sp[lo:hi]
    return (sp[rows], key[rows], win, key[lo:hi], st[rows] - lo,
            en[rows] - lo, dc, exact)


@pytest.mark.parametrize("data", list(_DATA))
def test_halo_primitives_match_jnp(data):
    """Gather form: the count, and the NN's delta, window parent and
    found, against the reference's gather-form jnp halo primitives (which
    run every span of the window); ``layout`` is checked and ignored."""
    x, xk, win, wk, st, en, dc, exact = _halo_case(data)
    # the reference clamps a column past the window to its last row where
    # the port clips; hand it spans inside the window
    st, en = np.clip(st, 0, len(win)), np.clip(en, 0, len(win))
    be, jbe = get_backend("torch"), jget_backend("jnp")
    span = int((en - st).max())
    band = _band(x, win, dc, exact)
    for layout in (None, "block-sparse"):
        got = be.range_count_halo(_t(x), _t(win), _t(st), _t(en), dc,
                                  span_cap=span, layout=layout)
        _same_count(got, jbe.range_count_halo(x, win, st, en, dc,
                                              span_cap=span), band)
        got = be.denser_nn_halo(_t(x), _t(xk), _t(win), _t(wk), _t(st),
                                _t(en), dc, span_cap=span, layout=layout)
        _same_nn(got, jbe.denser_nn_halo(x, xk, win, wk, st, en, dc,
                                         span_cap=span), exact)
    with pytest.raises(ValueError, match="layout"):
        be.range_count_halo(_t(x), _t(win), _t(st), _t(en), dc,
                            span_cap=span, layout="sparse")


def test_halo_count_clips_spans_to_the_window():
    """Spans reaching before 0 or past the window count only their
    columns inside it; the chunk cap ``block`` changes nothing."""
    x, _, win, _, st, en, dc, _ = _halo_case("lattice2")
    st[::3] -= 40
    en[::4] += 10_000
    want = np.zeros(len(x), np.int64)
    for i in range(len(x)):
        for a, b in zip(np.clip(st[i], 0, len(win)),
                        np.clip(en[i], 0, len(win))):
            d2 = ((win[a:b] - x[i]) ** 2).sum(-1)
            want[i] += int((d2 < np.float32(dc) ** 2).sum())
    for block in (None, 1, 37):
        got = halo_range_count_plain(_t(x), _t(win), _t(st), _t(en),
                                     f32_d2cut(dc), block=block)
        np.testing.assert_array_equal(got.numpy(), want)


def test_denser_nn_update_is_the_reference_default():
    """The stream's subset NN: padding slots (>= n) come back (inf, -1),
    in both layouts, equal to the reference's base-class default."""
    pts, dc, exact, key = _data("lattice2")
    be, jbe = get_backend("torch"), jget_backend("jnp")
    n = len(pts)
    slots = np.concatenate([np.arange(0, n, 17), [n, n + 5]]).astype(np.int32)
    want = jbe.denser_nn_update(pts, key, slots)
    for layout in (None, "block-sparse"):
        got = be.denser_nn_update(_t(pts), _t(key), _t(slots), layout=layout)
        _same_nn(got, want, exact)
        assert (got[1][-2:] == -1).all() and torch.isinf(got[0][-2:]).all()


@pytest.mark.parametrize("data", ["lattice3", "airline"])
def test_reference_oracles_match(data):
    """``kernels/ref.py``: the three oracles of the reference's."""
    pts, dc, exact, key = _data(data)
    x = pts[:900]
    np.testing.assert_array_equal(
        ref.range_count_ref(_t(x), _t(pts), dc).numpy()[~_band(
            x, pts, dc, exact)],
        np.asarray(jref.range_count_ref(x, pts, dc))[~_band(
            x, pts, dc, exact)])
    order = np.argsort(-key[:900], kind="stable")
    _same_nn(ref.prefix_min_dist_ref(_t(x[order])),
             jref.prefix_min_dist_ref(x[order]), exact)
    _same_nn(ref.masked_min_dist_ref(_t(x), _t(key[:900]), _t(pts),
                                     _t(key)),
             jref.masked_min_dist_ref(x, key[:900], pts, key), exact)
