"""A uniform ``Model`` facade over the model families: the port of
``repro/models/model_api.py``.

``build_model(cfg)`` dispatches on ``cfg.family``.  The dense, vlm and
encoder families (``models/transformer.py``) are ported; the moe, ssm and
hybrid families are not yet (ROADMAP Queue A item 10b) and raise.  The
training and sharding members of the reference's facade (``loss_fn``,
``param_specs``, ``cache_specs``) wait for items 10c and 11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from . import transformer as tfm
from .common import ArchConfig

__all__ = ["Model", "build_model"]


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]                       # (seed=0, device=None, generator=None) -> params
    init_cache: Callable[..., Any] | None = None   # (batch, max_len, device=None) -> cache
    prefill: Callable[..., Any] | None = None      # (params, batch, cache) -> (logits, cache)
    decode_step: Callable[..., Any] | None = None  # (params, cache, tokens, pos) -> (logits, cache)

    @property
    def is_decoder(self) -> bool:
        return self.decode_step is not None


def _tfm_prefill(params, batch, cfg, cache, q_chunk: int = 512):
    if cfg.family == "vlm" and "patches" in batch:
        return tfm.vlm_prefill(params, batch, cfg, cache, q_chunk=q_chunk)
    return tfm.prefill(params, batch["tokens"], cfg, cache, q_chunk=q_chunk)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "encoder", "vlm"):
        decoder = cfg.family != "encoder"

        def init(seed: int = 0, *, device=None, generator=None):
            return tfm.init_params(cfg, seed, device=device,
                                   generator=generator)

        if not decoder:          # encoders serve through tfm.encode_step
            return Model(cfg=cfg, init=init)
        return Model(
            cfg=cfg, init=init,
            init_cache=lambda b, s, device=None: tfm.init_cache(
                cfg, b, s, device=device),
            prefill=lambda p, b, c, **kw: _tfm_prefill(p, b, cfg, c, **kw),
            decode_step=lambda p, c, t, pos: tfm.decode_step(p, c, t, pos,
                                                             cfg))
    if cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue A item 10b: models/moe.py, ssm.py, rglru.py)")
    raise ValueError(f"unknown family: {cfg.family}")
