"""The port's examples (``examples_torch/``), each ``main`` run on the CPU
at a small size (``--device cpu``), and each refusing to run without a
card when no device is given."""
import importlib.util
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_is_ported():
    ref = {p.name for p in (EXAMPLES.parent / "examples").glob("*.py")}
    # dpc_paper_repro.py drives benchmarks/, which waits for the port's
    # benchmark
    assert {p.name for p in EXAMPLES.glob("*.py")} == \
        ref - {"dpc_paper_repro.py"}


def test_quickstart(capsys):
    from repro_torch import ExecSpec
    eng = _load("quickstart").main(n=2000, device="cpu")
    out = capsys.readouterr().out
    assert "exdpc        clusters=" in out and "rand_vs_exdpc=1.0000" in out
    assert eng.device.type == "cpu"
    _load("quickstart").main(n=1500, device="cpu",
                             exec_spec=ExecSpec.parse("torch:block-sparse"))
    assert "exec=torch:block-sparse:f32" in capsys.readouterr().out


def test_stream_dpc(capsys):
    st = _load("stream_dpc").main(extra_ticks=2, device="cpu",
                                  exec_spec=None)
    assert st["ticks"] == 4096 // 256 + 2
    assert "predict on the last batch" in capsys.readouterr().out


def test_serve_dpc_kv(capsys):
    err = _load("serve_dpc_kv").main(device="cpu")
    assert 0.0 <= err < 1.0
    assert "[dpc-kv] cache" in capsys.readouterr().out


def test_train_lm(tmp_path, capsys):
    loss = _load("train_lm").main(["--steps", "2", "--device", "cpu",
                                   "--ckpt-dir", str(tmp_path)])
    assert loss == loss                       # finite, not NaN
    assert "[example] final loss" in capsys.readouterr().out


def test_hubert_units(capsys):
    ri_dpc, ri_km = _load("hubert_units").main(device="cpu")
    assert 0.5 < ri_dpc <= 1.0 and 0.5 < ri_km <= 1.0
    assert "[hubert-units] frames=1024" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["quickstart", "stream_dpc",
                                  "serve_dpc_kv", "hubert_units"])
def test_examples_need_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main()


def test_train_lm_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("train_lm").main(["--steps", "1", "--ckpt-dir",
                                str(tmp_path)])
