"""The host side of the K1 and K2 kernels (``kernels/packing.py``).

K2 scans, per block of rows sorted by prefix length, the columns sorted by
key, descending, cut into column chunks, and merges a row's chunks by the
lexicographic (d2, original index) minimum.  ``schedule_nn`` below runs that
schedule in plain PyTorch on what the wrapper builds, with the kernel's
update rule, so the tests can hold it against ``masked_nn_plain`` (the
kernel's plain version) bit for bit and against the JAX package.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from repro.kernels import ops as jops

from repro_torch.kernels import packing, sweep

from _torch_ref import uniform_points
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_NONE = (1 << 63) - 1          # the kernel's all-ones "no denser column"
KEY_VALUES = [float("-inf"), -1.0, 0.0, 0.5, 1.0, 2.0, float("inf"),
              float("nan")]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def unpack(rec, d):
    """(coordinates (m, d) f32, slot (m,) int32) of packed records."""
    return rec[:, :d], rec.view(torch.int32)[:, d]


def schedule_nn(x, x_key, y, y_key, block_rows=8, min_items=16,
                min_chunk=3):
    """(best d2, index) through K2's schedule: the wrapper's layout (key
    order, records, work list), each item's masked search with the
    kernel's update rule, the merge by min over (d2 bits << 32 | index)
    into each row's original slot."""
    n, d = x.shape
    xs, rows, ends, rec, items = packing.nn_layout(
        x, x_key, y, y_key, block_rows, min_items, min_chunk)
    rows, ends = rows.long(), ends.long()
    yc, idx = unpack(rec, d)
    packed = torch.full((n,), _NONE, dtype=torch.int64)
    for b, c0, c1, _ in items.tolist():
        r = torch.arange(b * block_rows, min(n, (b + 1) * block_rows))
        # the kernel takes [c0, ends[first]) unmasked: sorted rows make
        # the block's first end its least
        assert bool((ends[r] >= ends[r[0]]).all())
        d2 = sweep.direct_d2(xs[r][:, None, :], yc[None, c0:c1, :])
        inside = torch.arange(c0, c1)[None, :] < ends[r][:, None]
        key = (d2.view(torch.int32).long() << 32) | idx[c0:c1].long()
        key = torch.where(inside & (d2 < float("inf")), key, _NONE)
        packed[rows[r]] = torch.minimum(packed[rows[r]], key.min(1).values)
    none = packed == _NONE
    best = torch.where(none, float("inf"),
                       (packed >> 32).to(torch.int32).view(torch.float32))
    arg = torch.where(none, -1, packed & 0xFFFFFFFF).to(torch.int32)
    return best, arg


def _strict_sets(x_key, y_key):
    return [set(np.nonzero(y_key > k)[0].tolist()) for k in x_key]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(KEY_VALUES), max_size=20),
       st.lists(st.sampled_from(KEY_VALUES), max_size=20))
def test_prefix_is_exactly_the_strictly_denser_columns(xk, yk):
    x_key = np.asarray(xk, np.float32)
    y_key = np.asarray(yk, np.float32)
    cols, ends = packing.denser_prefix(_t(x_key), _t(y_key))
    assert sorted(cols.tolist()) == list(range(len(y_key)))
    for i, want in enumerate(_strict_sets(x_key, y_key)):
        assert set(cols[:int(ends[i])].tolist()) == want, i


@pytest.mark.parametrize("case", ["ties", "neg-inf columns", "nan", "equal",
                                  "predict", "n=0", "m=0", "m<8"])
def test_prefix_edge_cases(case):
    rng = np.random.default_rng(3)
    n, m = 40, 50
    x_key = rng.integers(0, 5, n).astype(np.float32)
    y_key = rng.integers(0, 5, m).astype(np.float32)
    if case == "neg-inf columns":    # S-Approx-DPC's col_key off the reps
        y_key[rng.uniform(size=m) < 0.6] = -np.inf
    elif case == "nan":
        x_key[::7] = np.nan
        y_key[::5] = np.nan
    elif case == "equal":
        x_key[:], y_key[:] = 1.0, 1.0
    elif case == "predict":          # StreamService.predict's keys
        x_key[:], y_key[:] = -np.inf, 0.0
    elif case == "n=0":
        x_key = x_key[:0]
    elif case == "m=0":
        y_key = y_key[:0]
    elif case == "m<8":
        y_key = y_key[:5]
    cols, ends = packing.denser_prefix(_t(x_key), _t(y_key))
    for i, want in enumerate(_strict_sets(x_key, y_key)):
        assert set(cols[:int(ends[i])].tolist()) == want, i
    if case == "equal":
        assert int(ends.max()) == 0
    if case == "predict":
        assert bool((ends == m).all())
    if case == "neg-inf columns":
        assert int(ends.max()) <= int(np.isfinite(y_key).sum())


def _nn_case(case):
    rng = np.random.default_rng(11)
    if case.startswith("lattice"):       # exact distance ties everywhere
        g = np.stack(np.meshgrid(np.arange(12), np.arange(12)), -1)
        y = g.reshape(-1, 2).astype(np.float32)
        y_key = rng.integers(0, 3, len(y)).astype(np.float32)  # 3 levels
        x, x_key = y, y_key
        if case == "lattice, reversed index ties":
            # equal distances whose key order is the reverse of index order
            y_key = np.arange(len(y))[::-1].astype(np.float32) % 7
            x_key = np.zeros(len(y), np.float32) - 1
        return x, x_key, y, y_key
    x = uniform_points(70, 3, seed=5)
    y = uniform_points(90, 3, seed=6)
    x_key = rng.integers(0, 10, len(x)).astype(np.float32)
    y_key = rng.integers(0, 10, len(y)).astype(np.float32)
    if case == "neg-inf columns":
        y_key[rng.uniform(size=len(y)) < 0.5] = -np.inf
    elif case == "nan keys":
        x_key[::6] = np.nan
        y_key[::4] = np.nan
    elif case == "overflow":             # every d2 is inf: (inf, -1)
        x = ((x + 1) * 2e19).astype(np.float32)
        y = (-(y + 1) * 2e19).astype(np.float32)
    elif case == "few rows":
        x, x_key = x[:5], x_key[:5]
    elif case == "d=9":
        x = uniform_points(70, 9, seed=7)
        y = uniform_points(90, 9, seed=8)
    return x, x_key, y, y_key


NN_CASES = ["uniform", "lattice", "lattice, reversed index ties",
            "neg-inf columns", "nan keys", "overflow", "few rows", "d=9"]


@pytest.mark.parametrize("case", NN_CASES)
@pytest.mark.parametrize("block_rows,min_items,min_chunk",
                         [(8, 16, 3), (32, 1, 1 << 20), (4, 400, 1)])
def test_schedule_equals_masked_nn_plain(case, block_rows, min_items,
                                         min_chunk):
    x, x_key, y, y_key = (_t(a) for a in _nn_case(case))
    got = schedule_nn(x, x_key, y, y_key, block_rows, min_items, min_chunk)
    want = sweep.masked_nn_plain(x, x_key, y, y_key)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "overflow":
        assert bool(torch.isinf(got[0]).all() and (got[1] == -1).all())


def test_schedule_equals_jax_masked_min_dist():
    pts = uniform_points(600, 3, seed=21)
    key = np.random.default_rng(2).permutation(600).astype(np.float32)
    jd, jp = (np.asarray(a) for a in jops.dependent_masked(
        jnp.asarray(pts), jnp.asarray(key), jnp.asarray(pts),
        jnp.asarray(key), interpret=True))
    best, arg = schedule_nn(_t(pts), _t(key), _t(pts), _t(key), 32, 64, 16)
    np.testing.assert_array_equal(arg.numpy(), jp)
    # both deltas are direct-difference f32 sqrt; summation order may
    # differ by an ulp
    np.testing.assert_allclose(torch.sqrt(best).numpy(), jd, rtol=1e-6)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 300), max_size=60), st.integers(1, 9),
       st.integers(1, 50), st.integers(1, 40))
def test_work_list_covers_each_block_prefix_once(ends, block_rows,
                                                 min_items, min_chunk):
    ends = torch.tensor(sorted(ends), dtype=torch.int32)
    items = packing.chunk_worklist(ends, block_rows, min_items, min_chunk)
    n = ends.numel()
    nb = -(-n // block_rows)
    assert items.dtype == torch.int32 and items.shape[1] == 4
    lengths = (items[:, 2] - items[:, 1]).tolist()
    assert all(v > 0 for v in lengths)
    assert lengths == sorted(lengths, reverse=True)      # heaviest first
    for b in range(nb):
        span = int(ends[min(n, (b + 1) * block_rows) - 1])
        mine = sorted(tuple(t[1:3]) for t in items.tolist() if t[0] == b)
        cover = [c for c0, c1 in mine for c in range(c0, c1)]
        assert cover == list(range(span)), b
    assert set(items[:, 0].tolist()) <= set(range(nb))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 8, 9])
def test_records_round_trip(d):
    rng = np.random.default_rng(d)
    y = _t(rng.normal(size=(37, d)).astype(np.float32) * 1e5)
    assert packing.record_width(d) % 4 == 0
    assert packing.record_width(d) >= d + 1
    idx = torch.arange(37) * 997 + (1 << 30)             # index bits
    coords, slot = unpack(packing.pack_records(y, idx), d)
    assert torch.equal(coords, y) and torch.equal(slot, idx.int())
    gate = torch.from_numpy(rng.uniform(size=37) < 0.4)  # the kept-k gate
    rec = packing.pack_records(y, gate)
    coords, slot = unpack(rec, d)
    assert torch.equal(coords, y) and torch.equal(slot, gate.int())
    assert not bool(rec[:, d + 1:].any())                # zero padding
    _, slot = unpack(packing.pack_records(y, None), d)
    assert not bool(slot.any())
