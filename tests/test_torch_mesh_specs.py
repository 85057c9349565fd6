"""The port's sharding rules and specs (``repro_torch.models.common``,
each family's ``*_specs``, ``train.optimizer.opt_state_specs`` and
``launch/mesh.py``) against the JAX package's.

For each of the 10 architectures of ``configs.ARCHS`` at full size, and
for the rules of a 16x16 mesh, a 2x16x16 mesh, the 16x16 mesh with
``data_only`` and a 2x2 mesh, the port's specs equal the reference's
``PartitionSpec``s read as tuples, leaf for leaf by dotted name:
``param_specs``, ``layer_specs``, ``cache_specs``, ``opt_state_specs``
and ``batch_spec``; and ``logical_to_spec``, ``MeshRules.model`` and
``data_if`` agree on sizes that do and do not divide.  A spec's rank is
at most its tensor's (``tests/test_archs.py``'s congruence check).  The
rules are pure functions of the axis sizes: no process group and no
device mesh is built (the reference's ``rules_for`` reads only the
mesh's axis names and shape).
"""
import types

import numpy as np
import pytest
from jax.sharding import PartitionSpec as RP

from repro import configs as rconfigs
from repro.launch import mesh as rmesh
from repro.models import build_model as rbuild
from repro.models import rglru as rrglru
from repro.models import transformer as rtfm
from repro.models.common import logical_to_spec as rlogical
from repro.train.optimizer import opt_state_specs as ropt_specs
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models.attention import KVCache
from repro_torch.models.common import P, logical_to_spec, spec_to_placements
from repro_torch.train.optimizer import opt_state_specs

MESHES = {"16x16": ((16, 16), ("data", "model"), False),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), False),
          "data-only": ((16, 16), ("data", "model"), True),
          "2x2": ((2, 2), ("data", "model"), False)}
SIZES = (0, 1, 2, 3, 4, 8, 15, 16, 24, 32, 48, 100, 256, 512, 4096)
SHAPE_MODULES = {"dense": ttfm, "vlm": ttfm, "encoder": ttfm, "moe": tmoe,
                 "ssm": tssm, "hybrid": trglru}


def _rules(name):
    shape, names, data_only = MESHES[name]
    ref_mesh = types.SimpleNamespace(axis_names=names,
                                     devices=np.empty(shape, np.int8))
    return (rmesh.rules_for(ref_mesh, data_only=data_only),
            tmesh.rules_for(dict(zip(names, shape)), data_only=data_only))


def _flat(tree, prefix=""):
    """Dotted name -> spec tuple of a tree of specs (dicts, NamedTuples)."""
    if isinstance(tree, (RP, P)):
        return {prefix: tuple(tree)}
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rules_resolve_as_the_reference(mesh):
    rr, tr = _rules(mesh)
    assert (tr.data_axes, tr.model_axis, tr.axis_sizes) == (
        rr.data_axes, rr.model_axis, rr.axis_sizes)
    assert tr.data == rr.data
    for size in SIZES:
        assert tr.model(size) == rr.model(size), size
        assert tr.data_if(size) == rr.data_if(size), size
        for logical in ("model", "data", None):
            got = logical_to_spec(tr, (logical, size), (None, size))
            assert isinstance(got, P)
            assert got == tuple(rlogical(rr, (logical, size), (None, size)))
    for batch in (1, 8, 256, 512):
        assert tmesh.batch_spec(tr, batch) == tuple(
            rmesh.batch_spec(rr, batch)), batch


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_specs_equal_the_reference(arch, mesh):
    rr, tr = _rules(mesh)
    rc, tc = rconfigs.ARCHS[arch], tconfigs.ARCHS[arch]
    rmodel, tmodel = rbuild(rc), tbuild(tc)
    rspecs, tspecs = rmodel.param_specs(rr), tmodel.param_specs(tr)
    assert tspecs == _flat(rspecs)
    assert all(isinstance(s, P) for s in tspecs.values())
    assert _flat(opt_state_specs(tspecs)) == _flat(ropt_specs(rspecs))
    if tc.family in ("dense", "vlm", "encoder", "moe"):
        dense = tc.replace(family="dense")
        assert ttfm.layer_specs(dense, tr) == _flat(
            rtfm.layer_specs(rc.replace(family="dense"), rr))
    if tc.family == "hybrid":
        n_super, n_tail = trglru._counts(tc)
        for L in (n_super, n_tail):
            assert trglru._rec_specs(tc, tr, L) == _flat(
                rrglru._rec_specs(rc, rr, L))
        assert trglru._attn_specs(tc, tr, n_super) == _flat(
            rrglru._attn_specs(rc, rr, n_super))
    assert (tmodel.cache_specs is None) == (rmodel.cache_specs is None)
    if tmodel.cache_specs is not None:
        assert _flat(tmodel.cache_specs(tr)) == _flat(rmodel.cache_specs(rr))
    # ranks: no spec longer than its tensor
    shapes = SHAPE_MODULES[tc.family].param_shapes(tc)
    assert set(shapes) == set(tspecs)
    for name, spec in tspecs.items():
        assert len(spec) <= len(shapes[name]), (name, spec, shapes[name])


@pytest.mark.parametrize("mesh", ["2x16x16", "data-only"])
def test_batch_sharding(mesh):
    """Each batch leaf's spec: ``batch_spec`` on its leading dim, then
    replicated dims, as the reference's ``batch_sharding``."""
    rr, tr = _rules(mesh)
    batch = {"tokens": np.zeros((256, 8), np.int32),
             "patches": np.zeros((8, 4, 16), np.float32),
             "mask": np.zeros((1, 8), bool)}
    got = tmesh.batch_sharding(tr, batch)
    want = rmesh.batch_sharding(rr, batch)
    assert got == {k: tuple(v) for k, v in want.items()}


class _Mesh:
    """What ``spec_to_placements`` reads of a ``DeviceMesh``: its axis
    names and sizes."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)

    def size(self, i: int) -> int:
        return self.shape[i]


def test_spec_to_placements():
    """A spec's placement list: ``Shard`` on each axis an entry names, in
    the mesh's order; ``Replicate`` elsewhere and on an axis of size 1;
    an unknown axis, an axis used twice and a tuple out of the mesh's
    order raise.  ``specs_to_placements`` maps a tree."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh(("pod", "data", "model"), (2, 16, 16))
    R = Replicate()
    assert spec_to_placements(mesh, P(None, "model")) == [R, R, Shard(1)]
    assert spec_to_placements(mesh, P(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert spec_to_placements(mesh, P()) == [R, R, R]
    assert spec_to_placements(_Mesh(("data", "model"), (2, 1)),
                              P("data", "model")) == [Shard(0), R]
    for bad in (P("expert"), P("model", "model"), P(("data", "pod"))):
        with pytest.raises(ValueError):
            spec_to_placements(mesh, bad)
    tree = {"a": P("data"), "cache": KVCache(k=P(None, "model"), v=P())}
    got = tmesh.specs_to_placements(mesh, tree)
    assert got == {"a": [R, Shard(0), R],
                   "cache": KVCache(k=[R, R, Shard(1)], v=[R, R, R])}
