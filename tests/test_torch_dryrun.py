"""The model dry run on fake tensors (``launch/dryrun.py``) and
``configs.input_specs``: the inputs against the reference's for every
cell, each family's forward loss and prefill dot FLOPs against the
reference's ``hlo_cost.analyze_compiled`` of its jitted function on the
same reduced config, the per-layer part doubling with the layers, remat's
recompute counted, and the CLI.  The gradients' counts are in
``tests/test_torch_dryrun_grad.py``."""
import json

import jax
import jax.numpy as jnp
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


@pytest.mark.parametrize("argv", [["--mesh", "pod"], ["--mesh", "multipod"],
                                  ["--data-only"]])
def test_meshes_across_cards_wait_for_9b(argv):
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv + ["--arch", "gemma-2b", "--shape", "decode_32k"])
    assert e.value.code != 0 and "9b" in str(e.value.code)
