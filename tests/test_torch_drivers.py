"""The grid-sorted drivers: ``DPCEngine.fit`` with Approx-DPC, Ex-DPC and
Scan in the block-sparse and dense layouts, held against the JAX package's
block-sparse fits (inputs built once with numpy, handed to both)."""
import numpy as np
import pytest
import torch

from repro.engine import DPCEngine as JEngine
from repro.engine import ExecSpec as JExecSpec

from repro_torch import DPCEngine, ExecSpec
from repro_torch.core.grid import build_grid
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import gaussian_mixture, real_proxy

from _torch_ref import assert_same_fit, f32_d2cut, f32_ulp

_REF_FITS: dict = {}


def _ref_fit(data, algo):
    """The JAX package's fit with its direct-difference backend in the
    block-sparse layout (memoized: one per data set and algorithm)."""
    key = (data, algo)
    if key not in _REF_FITS:
        pts = (real_proxy("airline", 2048, seed=4)[0] if data == "airline"
               else gaussian_mixture(4000, d=2, seed=5)[0])
        dc = pick_dcut(pts)
        ref = JEngine(dc, rho_min=8, algorithm=algo, exec_spec=JExecSpec(
            backend="jnp", layout="block-sparse")).fit(pts)
        _REF_FITS[key] = (pts, dc, ref)
    return _REF_FITS[key]


@pytest.mark.parametrize("algo", ["approxdpc", "exdpc", "scan"])
@pytest.mark.parametrize("data", ["airline", "gaussian_mixture"])
def test_fit_matches_jnp_block_sparse(data, algo):
    pts, dc, ref = _ref_fit(data, algo)
    thr = f32_d2cut(dc)
    for layout in ("block-sparse", "dense"):
        port = DPCEngine(dc, rho_min=8, algorithm=algo, device="cpu",
                         exec_spec=ExecSpec(layout=layout)).fit(pts)
        # domain 1e5: a pair within 4 f32 ulps of d_cut^2 may round either
        # way
        assert_same_fit(port, ref, pts, dc, 4 * f32_ulp(thr))


@pytest.mark.parametrize("data", ["airline", "gaussian_mixture"])
def test_exdpc_equals_scan(data):
    """The exactness contract: Ex-DPC is the Scan oracle, bit for bit."""
    pts, dc, _ = _ref_fit(data, "scan")
    spec = ExecSpec(layout="block-sparse")
    ex = DPCEngine(dc, algorithm="exdpc", device="cpu",
                   exec_spec=spec).fit(pts)
    sc = DPCEngine(dc, algorithm="scan", device="cpu",
                   exec_spec=spec).fit(pts)
    for a, b in zip(ex.result, sc.result):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ex.labels_, sc.labels_)


@pytest.mark.parametrize("algo", ["approxdpc", "exdpc", "scan"])
def test_block_sparse_fit_equals_dense_on_sorted_table(algo):
    """On a table that is already grid-sorted the block-sparse fit's sort is
    the identity, and its result is the dense fit's bit for bit."""
    pts = real_proxy("airline", 4096, seed=1)[0]
    dc = pick_dcut(pts)
    gp = build_grid(torch.from_numpy(pts), dc).points.numpy()
    fits = [DPCEngine(dc, algorithm=algo, device="cpu", exec_spec=ExecSpec(
        layout=layout)).fit(gp) for layout in ("dense", "block-sparse")]
    for a, b in zip(fits[0].result, fits[1].result):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(fits[0].labels_, fits[1].labels_)
