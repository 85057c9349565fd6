"""A uniform ``Model`` facade over the model families: the port of
``repro/models/model_api.py``.

``build_model(cfg)`` dispatches on ``cfg.family``: the dense, vlm and
encoder families (``models/transformer.py``), moe (``models/moe.py``),
ssm (``models/ssm.py``) and hybrid (``models/rglru.py``).  Every family
has ``init(seed=0, device=None, generator=None)`` and ``loss_fn(params,
batch, **kw)`` (the f32 training loss); every decoder also
``init_cache(batch, max_len, device=None)``, ``prefill`` and
``decode_step``; the moe family keeps the dense family's 5-d
``KVCache``, the ssm and hybrid families a dict of recurrent state.  The
sharding members of the reference's facade (``param_specs``,
``cache_specs``) wait for ROADMAP item 9b.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from . import moe, rglru, ssm, transformer as tfm
from .common import ArchConfig

__all__ = ["Model", "build_model"]


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]                       # (seed=0, device=None, generator=None) -> params
    loss_fn: Callable[..., Any]                    # (params, batch, **kw) -> f32 loss
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


# family -> (its module, the module of its cache)
_FAMILIES = {"dense": (tfm, tfm), "vlm": (tfm, tfm), "encoder": (tfm, tfm),
             "moe": (moe, tfm), "ssm": (ssm, ssm), "hybrid": (rglru, rglru)}


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family: {cfg.family}")
    mod, cache_mod = _FAMILIES[cfg.family]

    def init(seed: int = 0, *, device=None, generator=None):
        return mod.init_params(cfg, seed, device=device, generator=generator)

    def loss_fn(params, batch, **kw):
        return mod.loss_fn(params, batch, cfg, **kw)

    if cfg.family == "encoder":      # encoders serve through tfm.encode_step
        return Model(cfg=cfg, init=init, loss_fn=loss_fn)

    def prefill(params, batch, cache, **kw):
        if mod is tfm:
            return _tfm_prefill(params, batch, cfg, cache, **kw)
        return mod.prefill(params, batch["tokens"], cfg, cache, **kw)

    return Model(
        cfg=cfg, init=init, loss_fn=loss_fn,
        init_cache=lambda b, s, device=None: cache_mod.init_cache(
            cfg, b, s, device=device),
        prefill=prefill,
        decode_step=lambda p, c, t, pos: mod.decode_step(p, c, t, pos, cfg))
