"""The model dry run on fake tensors (``launch/dryrun.py``) and
``configs.input_specs``: the inputs against the reference's for every
cell, each family's forward loss and prefill dot FLOPs against the
reference's ``hlo_cost.analyze_compiled`` of its jitted function on the
same reduced config, the per-layer part doubling with the layers, remat's
recompute counted, and the CLI.  The gradients' counts are in
``tests/test_torch_dryrun_grad.py``."""
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as rconfigs
from repro.launch.hlo_cost import analyze_compiled
from repro.models import build_model as rbuild
from repro.models import transformer as rtfm

from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer as ttfm
from repro_torch.train.step import TrainStepConfig, value_and_grad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one architecture per family
FAMILIES = {"dense": "gemma-2b", "vlm": "paligemma-3b",
            "encoder": "hubert-xlarge", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-130m", "hybrid": "recurrentgemma-9b"}


def ref_dot_flops(arch: str, batch: int, seq: int, what: str) -> float:
    """The reference's ``hlo_cost`` dot FLOPs of its jitted ``loss_fn``
    (``what`` "loss"), the gradient of it (``"grad"``, remat on, as the
    reference's layers always are) or its prefill (``"prefill"``,
    ``encode_step`` for the encoder) on the reduced config, lowered from
    abstract inputs."""
    rc = rconfigs.reduce_config(rconfigs.ARCHS[arch])
    m = rbuild(rc)
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    kind = "train" if what in ("loss", "grad") else "prefill"
    b = rconfigs.input_specs(rc, rconfigs.ShapeSpec("x", seq, batch, kind))
    if what == "loss":
        c = jax.jit(m.loss_fn).lower(params, b).compile()
    elif what == "grad":
        c = jax.jit(jax.grad(m.loss_fn)).lower(params, b).compile()
    elif rc.family == "encoder":
        c = jax.jit(lambda p, x: rtfm.encode_step(p, x, rc)).lower(
            params, b).compile()
    else:
        cache = jax.eval_shape(lambda: m.init_cache(batch, seq))
        c = jax.jit(m.prefill).lower(params, b, cache).compile()
    return analyze_compiled(c)["dot_flops"]


def port_dot_flops(arch: str, batch: int, seq: int, what: str,
                   **cfg_kw) -> float:
    """The port's dry-run dot FLOPs of the same function."""
    tc = tconfigs.reduce_config(tconfigs.ARCHS[arch]).replace(**cfg_kw)
    m = tbuild(tc)
    mode = FakeTensorMode()
    params = dryrun.fake_params(tc, mode)
    kind = "train" if what in ("loss", "grad") else "prefill"
    b = dryrun.fake_inputs(mode, tconfigs.input_specs(
        tc, tconfigs.ShapeSpec("x", seq, batch, kind)))
    if what == "loss":
        fn, args = m.loss_fn, (params, b)
    elif what == "grad":
        def fn(p, x):
            return value_and_grad(m.loss_fn, p, x, TrainStepConfig())
        args = (params, b)
    elif tc.family == "encoder":
        def fn(p, x):
            return ttfm.encode_step(p, x, tc)
        args = (params, b)
    else:
        with mode:
            cache = m.init_cache(batch, seq, device="cpu")
        fn, args = m.prefill, (params, b, cache)
    return dryrun.step_cost(fn, args, (), mode)["cost"]["dot_flops"]


@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_input_specs_match_reference(arch):
    """Shape and dtype of every input of every non-skipped cell equal the
    reference's ``ShapeDtypeStruct`` stand-ins; none holds storage."""
    for shape_name, spec in tconfigs.SHAPES.items():
        assert tconfigs.skip_reason(arch, shape_name) == \
            rconfigs.skip_reason(arch, shape_name)
        if tconfigs.skip_reason(arch, shape_name):
            continue
        got = tconfigs.input_specs(tconfigs.ARCHS[arch], spec)
        want = rconfigs.input_specs(rconfigs.ARCHS[arch],
                                    rconfigs.SHAPES[shape_name])
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (shape_name, k)
            assert str(t.dtype).removeprefix("torch.") == \
                jnp.dtype(want[k].dtype).name, (shape_name, k)


def test_gemma_loss_reads_the_reference_count():
    assert port_dot_flops("gemma-2b", 2, 64, "loss") == 24_117_248
    assert ref_dot_flops("gemma-2b", 2, 64, "loss") == 24_117_248


@pytest.mark.parametrize("what", ["loss", "prefill"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_dot_flops_match_reference(family, what):
    arch = FAMILIES[family]
    assert port_dot_flops(arch, 1, 16, what) == \
        ref_dot_flops(arch, 1, 16, what)


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-3b-a800m",
                                  "mamba2-130m"])
def test_layers_double_the_per_layer_part(arch):
    """The counterpart of the reference's trip-count tests: the count is
    a fixed part plus one per layer, forward and backward alike."""
    for what in ("loss", "grad"):
        f = {n: port_dot_flops(arch, 1, 16, what, n_layers=n)
             for n in (1, 2, 4)}
        assert f[4] - f[2] == 2 * (f[2] - f[1]) > 0, (what, f)


def test_grad_with_remat_counts_recompute():
    """Each layer recomputed in the backward (``common.remat``) adds its
    forward products but the last, whose output the backward never reads
    (non-reentrant checkpointing stops early, as XLA drops the dead
    recompute), once a layer."""
    tc = tconfigs.reduce_config(tconfigs.ARCHS["gemma-2b"])
    extra = {}
    for n in (1, 3):
        counts = {}
        for remat in (False, True):
            c = tc.replace(n_layers=n)
            m = tbuild(c)
            mode = FakeTensorMode()
            p = dryrun.fake_params(c, mode)
            b = dryrun.fake_inputs(mode, tconfigs.input_specs(
                c, tconfigs.ShapeSpec("x", 16, 1, "train")))

            def fn(p, x, r=remat, m=m):
                return value_and_grad(
                    lambda q, y: m.loss_fn(q, y, remat=r), p, x,
                    TrainStepConfig())
            counts[remat] = dryrun.step_cost(fn, (p, b), (),
                                             mode)["cost"]["dot_flops"]
        extra[n] = counts[True] - counts[False]
    per_layer = (port_dot_flops("gemma-2b", 1, 16, "loss", n_layers=2)
                 - port_dot_flops("gemma-2b", 1, 16, "loss", n_layers=1))
    w_out = 2 * 16 * tc.d_ff * tc.d_model      # the layer's last product
    assert extra[1] == per_layer - w_out
    assert extra[3] == 3 * extra[1]


def test_cell_records_and_memory(tmp_path):
    """The CLI on the reduced configs writes the reference's keys (with
    ``trace_s`` for ``lower_s``/``compile_s``); the updated state is
    aliased; skipped cells say why."""
    assert dryrun.main(["--arch", "gemma-2b", "--smoke-config",
                        "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "hubert-xlarge", "--smoke-config",
                        "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "gemma-2b__decode_32k__one.json")
                     .read_text())
    assert {"arch", "shape", "mesh", "kind", "devices", "microbatches",
            "flops_per_device", "bytes_per_device", "collectives",
            "trace_s", "cost", "memory", "variant"} <= set(rec)
    assert not {"lower_s", "compile_s"} & set(rec)
    assert (rec["mesh"], rec["devices"], rec["kind"]) == ("one", 1, "decode")
    assert rec["cost"]["flops"] > rec["cost"]["dot_flops"] > 0
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "alias_bytes"}
    tc = tconfigs.reduce_config(tconfigs.ARCHS["gemma-2b"])
    cache = 2 * tc.n_layers * 128 * 32768 * tc.n_kv_heads * tc.head_dim * 2
    assert rec["memory"]["alias_bytes"] == cache
    skipped = json.loads((tmp_path / "hubert-xlarge__decode_32k__one.json")
                         .read_text())
    assert skipped["skipped"] == "encoder-only: no decode step"
    train = dryrun.trace_step(tc, tconfigs.ShapeSpec("x", 16, 4, "train"),
                              microbatches=2, accumulation="loss")
    params_bytes = sum(
        torch.Size(s).numel() * 2 for s in ttfm.param_shapes(tc).values())
    # parameters (bf16) and the f32 master, mu and nu, updated in place
    assert train["memory"]["alias_bytes"] == params_bytes * 7 + 4


def _local_bytes(shape, spec, sizes: dict, itemsize: int) -> int:
    """Rank 0's bytes of a tensor of ``shape`` sharded by ``spec`` (each
    dim over the product of its entry's axes, rank 0 taking the ceiling
    share)."""
    n = 1
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        n *= -(-d // math.prod(sizes[a] for a in axes))
    return n * itemsize


def _ref_decode_argument_bytes(names, mesh_shape, data_only: bool) -> int:
    """Per-device bytes of gemma-2b's decode_32k arguments: the
    parameters by the reference's ``param_specs``, the cache by its
    ``cache_specs`` with the batch axis by ``batch_spec``, and the
    tokens by ``batch_spec``, on ``rules_for``'s rules."""
    from jax.sharding import PartitionSpec
    from repro.launch import mesh as rmesh

    rc, shape = rconfigs.ARCHS["gemma-2b"], rconfigs.SHAPES["decode_32k"]
    rules = rmesh.rules_for(types.SimpleNamespace(
        axis_names=names, devices=np.empty(mesh_shape, np.int8)),
        data_only=data_only)
    sizes = dict(zip(names, mesh_shape))
    m = rbuild(rc)
    leaves = jax.tree.leaves(jax.eval_shape(m.init, jax.random.PRNGKey(0)))
    specs = jax.tree.leaves(m.param_specs(rules),
                            is_leaf=lambda x: isinstance(x, PartitionSpec))
    total = sum(_local_bytes(a.shape, tuple(s), sizes, a.dtype.itemsize)
                for a, s in zip(leaves, specs))
    B = shape.global_batch
    bs = tuple(rmesh.batch_spec(rules, B))
    data = {rules.data, tuple(rules.data_axes), *rules.data_axes}
    cache = jax.eval_shape(lambda: m.init_cache(B, shape.seq_len))
    for a, s in zip(cache, m.cache_specs(rules)):
        s = tuple(bs[0] if (tuple(e) if isinstance(e, (tuple, list))
                            else e) in data else e for e in s)
        total += _local_bytes(a.shape, s, sizes, a.dtype.itemsize)
    tok = tconfigs.input_specs(tconfigs.ARCHS["gemma-2b"],
                               tconfigs.SHAPES["decode_32k"])["tokens"]
    return total + _local_bytes(tuple(tok.shape), bs, sizes,
                                tok.element_size())


MESH_ARGV = {"pod": (["--mesh", "pod"], "pod", 256,
                     (("data", "model"), (16, 16), False)),
             "multipod": (["--mesh", "multipod"], "multipod", 512,
                          (("pod", "data", "model"), (2, 16, 16), False)),
             "data-only": (["--data-only"], "pod", 256,
                           (("data", "model"), (16, 16), True))}


@pytest.mark.parametrize("case", list(MESH_ARGV))
def test_meshes_across_cards(tmp_path, case):
    """``--mesh pod``, ``--mesh multipod`` and ``--data-only`` trace
    gemma-2b's decode_32k step as rank 0 of a fake process group of 256,
    512 and 256 ranks (the CLI in a subprocess, so no group outlives
    it): the record's ``devices``, its per-device ``argument_bytes``
    equal to the reference's specs' division of the same tensors, the
    collectives counted per device, and the torch release named."""
    argv, mesh, devices, (names, shape, data_only) = MESH_ARGV[case]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--arch",
         "gemma-2b", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    rec = json.loads((tmp_path / f"gemma-2b__decode_32k__{mesh}.json")
                     .read_text())
    assert (rec["mesh"], rec["devices"]) == (mesh, devices)
    assert rec["variant"]["data_only"] is data_only
    assert rec["memory"]["argument_bytes"] == _ref_decode_argument_bytes(
        names, shape, data_only)
    assert rec["collectives"]["total_bytes"] > 0
    assert 0 < rec["cost"]["dot_flops"] < rec["cost"]["flops"]
    assert rec["torch"] == torch.__version__


_COMM_CHECK = """
import json
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun, mesh as lmesh

comm = {}
with dryrun.fake_group(256):
    dmesh = lmesh.make_production_mesh()
    mode = FakeTensorMode()
    fn, args, updated = dryrun._spec_step(
        ARCHS["gemma-2b"], SHAPES["decode_32k"], mode, 1, "grad", dmesh,
        lmesh.rules_for(dmesh))

    def counted(*a):
        with CommDebugMode() as debug:
            out = fn(*a)
        comm.update((str(op), n) for op, n in debug.get_comm_counts().items())
        return out

    rec = dryrun.step_cost(counted, args, updated, mode, local=True)
print(json.dumps({"counts": rec["cost"]["collectives"]["counts"],
                  "comm": comm}))
"""


def _last_json_line(code: str) -> dict:
    """Run ``code`` in a fresh interpreter (so no fake process group
    outlives it) and parse the last line it prints."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_mesh_collectives_match_comm_debug_mode():
    """The dry run's per-device collective counts on the pod mesh equal
    ``CommDebugMode``'s count of DTensor's collectives in the same
    trace."""
    got = _last_json_line(_COMM_CHECK)
    kinds = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
    assert got["counts"] and got["counts"] == {
        kinds[op.split(".")[-1]]: n for op, n in got["comm"].items()}


_POD_CELL = """
import json
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.launch import dryrun

cfg = {cfg}
rec = dryrun.run_cell({arch!r}, {shape!r}, "pod", microbatches=1,
                      arch_override=cfg)
print(json.dumps({{"devices": rec["devices"],
                  "argument_bytes": rec["memory"]["argument_bytes"]}}))
"""

POD_CELLS = {
    # 32 query heads over the 16-way model axis, 4 kv heads, which do
    # not divide it: the GQA split needs the heads gathered first
    # (``attention._groupable``)
    "uneven-kv-groups": ("qwen3-moe-30b-a3b", "train_4k",
                         'reduce_config(ARCHS["qwen3-moe-30b-a3b"])'
                         '.replace(n_heads=32, n_kv_heads=4)'),
    # a batch of 1 over 16 data ranks: ``constrain`` replicates it
    "batch-of-one": ("h2o-danube-1.8b", "long_500k",
                     'ARCHS["h2o-danube-1.8b"]'),
}


@pytest.mark.parametrize("case", list(POD_CELLS))
def test_pod_mesh_traces(case):
    """Layouts GSPMD takes as they lie and DTensor does not trace on the
    pod mesh as rank 0 of 256."""
    arch, shape, cfg = POD_CELLS[case]
    got = _last_json_line(_POD_CELL.format(arch=arch, shape=shape, cfg=cfg))
    assert got["devices"] == 256 and got["argument_bytes"] > 0
