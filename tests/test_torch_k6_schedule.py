"""The host side of K6 (``gather_masked_nn``) and its two schedules.

K6 is K2's strictly-denser NN on the rows ``table[q_slots]``, gathered by
the wrapper (``packing.gather_rows``: a padding slot and a NaN key keyed
+inf).  The prefix form runs K2's schedule on them (the columns sorted by
key, the rows by prefix length, column-chunk work items); the key form
sorts the rows by key and scans unsorted columns in records carrying their
keys, each block of rows skipping a column below its least key, taking one
above its greatest unmasked and masking the rest by key.  The functions
below run both schedules in plain PyTorch on what the wrapper builds, with
the kernel's update and merge rules, so the tests hold them against
``gather_masked_nn_plain`` (the kernel's plain version) bit for bit and
against the JAX package.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops

from repro_torch.core.approxdpc import _group_segments, _maxima_mask
from repro_torch.core.dpc_types import density_jitter
from repro_torch.core.grid import build_grid
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import gaussian_mixture
from repro_torch.kernels import ops, packing, sweep

from _torch_ref import uniform_points
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_NONE = (1 << 63) - 1          # the kernel's all-ones "no denser row"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _merge(packed, slot, d2, idx, inside):
    """The kernel's merge: each row's lexicographic (d2, index) minimum
    over the columns it takes, by min over (d2 bits << 32 | index), into
    the row's slot position; a row whose best is +inf never merges."""
    key = (d2.view(torch.int32).long() << 32) | idx[None, :].long()
    key = torch.where(inside & (d2 < float("inf")), key, _NONE)
    packed[slot] = torch.minimum(packed[slot], key.min(1).values)


def _decode(packed):
    none = packed == _NONE
    best = torch.where(none, float("inf"),
                       (packed >> 32).to(torch.int32).view(torch.float32))
    return best, torch.where(none, -1, packed & 0xFFFFFFFF).to(torch.int32)


def schedule_prefix(table, keys, q_slots, block_rows=8, min_items=16,
                    min_chunk=3):
    """(best d2, index) through the prefix form: K2's layout of the
    gathered rows and its work items, position-masked past each row's
    end."""
    q, d = q_slots.numel(), table.shape[1]
    rows, x_key = packing.gather_rows(keys, q_slots)
    lay = packing.nn_layout(table[rows], x_key, table, keys, block_rows,
                            min_items, min_chunk)
    ends = lay.ends.long()
    yc, idx = lay.rec[:, :d], lay.rec.view(torch.int32)[:, d]
    packed = torch.full((q,), _NONE, dtype=torch.int64)
    for b, c0, c1, _ in lay.items.tolist():
        r = torch.arange(b * block_rows, min(q, (b + 1) * block_rows))
        d2 = sweep.direct_d2(lay.x[r][:, None, :], yc[None, c0:c1, :])
        inside = torch.arange(c0, c1)[None, :] < ends[r][:, None]
        _merge(packed, lay.row_id[r].long(), d2, idx[c0:c1], inside)
    return _decode(packed)


def schedule_key(table, keys, q_slots, block_rows=8, chunk=5):
    """(best d2, index) through the key form: rows sorted by key, blocks
    of ``block_rows`` rows x column chunks of ``chunk``, each column of a
    chunk skipped by the block (key not above its least row key), taken
    unmasked (above its greatest) or masked by key, the index its
    position."""
    q, d = q_slots.numel(), table.shape[1]
    m = table.shape[0]
    rows, x_key = packing.gather_rows(keys, q_slots)
    lay = packing.key_layout(table, keys, rows, x_key)
    assert bool((lay.x_key[1:] >= lay.x_key[:-1]).all())   # ascending
    assert not bool(torch.isnan(lay.x_key).any())
    yc = lay.rec[:, :d]
    yk = lay.rec[:, d]              # the key's bits, read back as f32
    assert torch.equal(yk.view(torch.int32), keys.view(torch.int32))
    packed = torch.full((q,), _NONE, dtype=torch.int64)
    for r0 in range(0, q, block_rows):
        r = torch.arange(r0, min(q, r0 + block_rows))
        lo, hi = lay.x_key[r[0]], lay.x_key[r[-1]]
        for c0 in range(0, m, chunk):
            c = torch.arange(c0, min(m, c0 + chunk))
            k = yk[c]
            skip = ~(k > lo)
            open_ = k > hi
            by_key = k[None, :] > lay.x_key[r][:, None]
            # the block's two tests are exact: a skipped column is denser
            # than no row of the block, an open one than every row
            assert not bool(by_key[:, skip].any())
            assert bool(by_key[:, open_].all())
            inside = ~skip[None, :] & (open_[None, :] | by_key)
            d2 = sweep.direct_d2(lay.x[r][:, None, :], yc[None, c, :])
            _merge(packed, lay.row_id[r].long(), d2, c.int(), inside)
    return _decode(packed)


def _case(case):
    """(table, keys, q_slots) as numpy arrays."""
    rng = np.random.default_rng(7)
    if case.startswith("d="):
        d = int(case[2:])
        table = rng.normal(size=(300, d)).astype(np.float32)
    elif case == "lattice ties":       # exact distance ties everywhere
        g = np.stack(np.meshgrid(np.arange(14), np.arange(14)), -1)
        table = g.reshape(-1, 2).astype(np.float32)
    else:
        table = uniform_points(300, 3, seed=8)
    m = len(table)
    keys = rng.integers(0, 12, m).astype(np.float32)
    slots = rng.integers(0, m, 90)
    if case == "lattice ties":
        keys = (np.arange(m) % 3).astype(np.float32)
        slots = np.arange(m)
    elif case == "padding":
        slots = np.concatenate([slots, [-1, -7, m, m + 3, 2**40]])
    elif case == "repeated":
        slots = np.concatenate([slots, slots[:30], slots[:5]])
    elif case == "peak":
        keys[17] = 99.0
        slots = np.concatenate([[17], slots, [17]])
    elif case == "inf and nan keys":
        keys[::5] = np.inf
        keys[::7] = -np.inf
        keys[::11] = np.nan
        slots = np.concatenate([slots, np.nonzero(np.isnan(keys))[0][:4],
                                np.nonzero(np.isinf(keys))[0][:6]])
    elif case == "equal keys":
        keys[:] = 3.0
    elif case == "q=1":
        slots = slots[:1]
    elif case == "q=0":
        slots = slots[:0]
    elif case == "overflow":           # every d2 is +inf: (inf, -1)
        table = np.repeat(np.arange(m, dtype=np.float32)[:, None] * 4e19,
                          3, 1).astype(np.float32)
    return table, keys, slots.astype(np.int64)


CASES = ["uniform", "d=1", "d=2", "d=8", "d=9", "lattice ties", "padding",
         "repeated", "peak", "inf and nan keys", "equal keys", "q=1", "q=0",
         "overflow"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", ["prefix", "key"])
def test_schedule_equals_gather_plain(case, form):
    table, keys, slots = (_t(a) for a in _case(case))
    want = sweep.gather_masked_nn_plain(table, keys, slots)
    for params in ((8, 16, 3), (32, 1, 1 << 20)) if form == "prefix" \
            else ((8, 5), (32, 1 << 20), (4, 64)):
        got = (schedule_prefix if form == "prefix" else schedule_key)(
            table, keys, slots, *params)
        for g, w in zip(got, want):
            assert torch.equal(g, w), params
    if case == "overflow":
        assert bool((want[1] == -1).all())
    if case == "peak":
        assert want[1][0] == -1 and want[1][-1] == -1
    if case == "padding":
        assert bool((want[1][-5:] == -1).all())


def test_no_table_rows():
    """m = 0: every slot is padding; the wrapper runs only the decode."""
    table = torch.zeros((0, 3))
    best, arg = ops.dependent_masked_gather(table, torch.zeros(0),
                                            torch.tensor([0, 1, -1]))
    assert bool(torch.isinf(best).all()) and bool((arg == -1).all())


def _stream_window(n=3000, seed=4):
    """A window of a mixture with its density keys and cell maxima, and a
    dirty subset of them (the peak among them) as the stream sends K6."""
    pts, _ = gaussian_mixture(n, k=6, d=2, seed=seed)
    x = torch.from_numpy(pts)
    dc = pick_dcut(pts, target_rho=20)
    keys = sweep.range_count_plain(x, x, sweep.d2cut_of(dc)).float() \
        + density_jitter(n)
    grid = build_grid(x, dc)
    maxima = torch.nonzero(_maxima_mask(grid, _group_segments(grid),
                                        keys)).flatten()
    rng = np.random.default_rng(seed)
    dirty = maxima[_t(rng.uniform(size=maxima.numel()) < 0.7)]
    dirty = torch.unique(torch.cat([dirty, torch.argmax(keys)[None]]))
    return x, keys, dirty


@pytest.mark.parametrize("form", ["prefix", "key"])
def test_schedule_on_a_stream_window(form):
    table, keys, slots = _stream_window()
    assert slots.numel() > 100
    want = sweep.gather_masked_nn_plain(table, keys, slots)
    got = (schedule_prefix(table, keys, slots, 64, 32, 256)
           if form == "prefix" else schedule_key(table, keys, slots, 64, 512))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((want[1] == -1).sum()) == 1          # the global peak


@pytest.mark.parametrize("d", [2, 3])
def test_schedules_equal_jax_gather(d):
    """Against the reference's gather_nn (Pallas, interpret mode), on small
    integers with many duplicate distances, where its expanded form is
    exact: delta and parent agree bit for bit.  Its padding slots are the
    values at or past m (a negative slot is outside its contract)."""
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 24 if d == 2 else 12, (600, d)).astype(np.float32)
    n = len(pts)
    key = rng.permutation(n).astype(np.float32)
    slots = np.concatenate([rng.permutation(n)[:150], [int(np.argmax(key))],
                            [n, n + 2, n + 100]])
    jd, jp = (np.asarray(a) for a in jops.dependent_masked_gather(
        jnp.asarray(pts), jnp.asarray(key), jnp.asarray(slots.astype(
            np.int32)), interpret=True))
    for best, arg in (schedule_prefix(_t(pts), _t(key), _t(slots), 32, 8,
                                      64),
                      schedule_key(_t(pts), _t(key), _t(slots), 32, 128)):
        np.testing.assert_array_equal(arg.numpy(), jp)
        np.testing.assert_array_equal(torch.sqrt(best).numpy(), jd)
        assert (arg.numpy()[-4:] == -1).all()


def test_gather_rows_keys_padding_and_nan_as_inf():
    keys = _t(np.array([1.0, np.nan, -np.inf, np.inf, 2.0], np.float32))
    rows, x_key = packing.gather_rows(keys, torch.tensor([0, 1, 2, 3, 5, -1,
                                                          2**40, 4]))
    assert rows.tolist() == [0, 1, 2, 3, 0, 0, 0, 4]
    inf = float("inf")
    assert x_key.tolist() == [1.0, inf, -inf, inf, inf, inf, inf, 2.0]


def test_key_layout_sorts_rows_and_keeps_index_order():
    table, keys, slots = (_t(a) for a in _case("inf and nan keys"))
    rows, x_key = packing.gather_rows(keys, slots)
    lay = packing.key_layout(table, keys, rows, x_key)
    order = lay.row_id.long()
    assert sorted(order.tolist()) == list(range(slots.numel()))
    assert torch.equal(lay.x, table[rows[order]])
    assert torch.equal(lay.x_key, x_key[order])
    d = table.shape[1]
    assert torch.equal(lay.rec[:, :d], table)       # columns in index order
    assert lay.rec.shape[1] == packing.record_width(d)


@pytest.mark.parametrize("q,form", [
    (1, "key"), (1342, "key"), (ops.K6_PREFIX_ROWS - 1, "key"),
    (ops.K6_PREFIX_ROWS, "prefix"), (489_464, "prefix")])
def test_form_by_slot_count(q, form):
    """The form is the shape's alone: the Airline stream's 489,464 dirty
    maxima take the prefix form, the mixture's 1,342 the key form."""
    assert ops.gather_form(q) == form
