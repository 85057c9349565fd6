"""Architecture registry, assigned input shapes and the cell table: the
port of ``repro/configs/__init__.py``.

``ARCHS`` maps the 10 assigned architecture ids to their exact
``ArchConfig``, every one of which builds a model (``models.build_model``:
the dense, vlm, encoder, moe, ssm and hybrid families); ``SHAPES`` are the
4 assigned input shapes; ``cells()`` enumerates the 40 (arch x shape)
cells with their skip reasons.  ``input_specs(cfg, shape)`` returns
stand-ins for every model input on the ``meta`` device (shapes and dtypes,
no storage: the counterpart of ``jax.ShapeDtypeStruct``), which is what
``launch/dryrun.py`` traces against; ``reduce_config(cfg)`` is the small
same-family config of the CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.models.common import ArchConfig

from .gemma_2b import CONFIG as GEMMA_2B
from .granite_8b import CONFIG as GRANITE_8B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE
from .h2o_danube_1p8b import CONFIG as H2O_DANUBE
from .hubert_xlarge import CONFIG as HUBERT_XLARGE
from .mamba2_130m import CONFIG as MAMBA2_130M
from .paligemma_3b import CONFIG as PALIGEMMA_3B
from .phi3_mini_3p8b import CONFIG as PHI3_MINI
from .qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE
from .recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        HUBERT_XLARGE, GEMMA_2B, GRANITE_8B, PHI3_MINI, H2O_DANUBE,
        PALIGEMMA_3B, GRANITE_MOE, QWEN3_MOE, MAMBA2_130M, RECURRENTGEMMA_9B,
    )
}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs whose decode state is bounded in sequence length (SSM state /
# RG-LRU state + local window / sliding window ring buffer)
SUB_QUADRATIC = {"mamba2-130m", "recurrentgemma-9b", "h2o-danube-1.8b"}


def skip_reason(arch: str, shape: str) -> str | None:
    """None if the (arch, shape) cell runs; otherwise why it is skipped."""
    cfg = ARCHS[arch]
    spec = SHAPES[shape]
    if cfg.family == "encoder" and spec.kind == "decode":
        return "encoder-only: no decode step"
    if shape == "long_500k" and arch not in SUB_QUADRATIC:
        return "full-attention decode: 500k KV cache needs sub-quadratic arch"
    return None


def cells():
    """All 40 (arch, shape, skip_reason) cells."""
    return [(a, s, skip_reason(a, s)) for a in ARCHS for s in SHAPES]


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Stand-ins for the step function's batch argument, on the ``meta``
    device.

    train / prefill: the full batch dict.  decode: ``{"tokens": (B, 1)}``
    (the dry run builds the cache itself).  The encoder takes bf16 frame
    features and int32 labels, the vlm bf16 image patches and the text
    tokens that fill the rest of ``seq_len``, every other family int32
    tokens."""
    B, L = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((B, 1), torch.int32)}
    if cfg.family == "encoder":
        return {"features": spec((B, L, cfg.frontend_dim), torch.bfloat16),
                "labels": spec((B, L), torch.int32)}
    if cfg.family == "vlm":
        # image patches + text fill the assigned seq_len exactly
        return {"patches": spec((B, cfg.num_patches, cfg.frontend_dim),
                                torch.bfloat16),
                "tokens": spec((B, L - cfg.num_patches), torch.int32)}
    return {"tokens": spec((B, L), torch.int32)}


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=128,
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, d_ff=32, n_experts_padded=0)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                  n_heads=8, n_kv_heads=8)   # d_inner 128 / 16
    if cfg.family == "hybrid":
        kw.update(n_layers=5, rnn_width=64, local_window=16)  # 1 super + 2 tail
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.frontend_dim:
        kw.update(frontend_dim=16)
    if cfg.num_patches:
        kw.update(num_patches=4)
    return dataclasses.replace(cfg, **kw)


def get(arch: str) -> ArchConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "SUB_QUADRATIC", "cells",
           "skip_reason", "input_specs", "reduce_config", "get"]
