"""A uniform ``Model`` facade over the model families: the port of
``repro/models/model_api.py``.

``build_model(cfg)`` dispatches on ``cfg.family``: the dense, vlm and
encoder families (``models/transformer.py``), moe (``models/moe.py``),
ssm (``models/ssm.py``) and hybrid (``models/rglru.py``).  Every family
has ``init(seed=0, device=None, generator=None)`` and ``loss_fn(params,
batch, **kw)`` (the f32 training loss); every decoder also
``init_cache(batch, max_len, device=None)``, ``prefill`` and
``decode_step``; the moe family keeps the dense family's 5-d
``KVCache``, the ssm and hybrid families a dict of recurrent state.
``param_specs(rules)`` and ``cache_specs(rules)`` give the specs of the
parameters (by dotted name) and of the cache under ``MeshRules``, and
``loss_fn``, ``prefill`` and ``decode_step`` take ``rules=None``: with
rules their tensors are DTensors on the rules' mesh.
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
    loss_fn: Callable[..., Any]                    # (params, batch, rules=None, **kw) -> f32 loss
    param_specs: Callable[..., Any]                # (rules) -> name -> P
    init_cache: Callable[..., Any] | None = None   # (batch, max_len, device=None) -> cache
    cache_specs: Callable[..., Any] | None = None  # (rules) -> cache of P
    prefill: Callable[..., Any] | None = None      # (params, batch, cache, rules=None) -> (logits, cache)
    decode_step: Callable[..., Any] | None = None  # (params, cache, tokens, pos, rules=None) -> (logits, cache)

    @property
    def is_decoder(self) -> bool:
        return self.decode_step is not None


def _tfm_prefill(params, batch, cfg, cache, rules=None, q_chunk: int = 512):
    if cfg.family == "vlm" and "patches" in batch:
        return tfm.vlm_prefill(params, batch, cfg, cache, rules=rules,
                               q_chunk=q_chunk)
    return tfm.prefill(params, batch["tokens"], cfg, cache, rules=rules,
                       q_chunk=q_chunk)


# family -> (its module, the module of its cache)
_FAMILIES = {"dense": (tfm, tfm), "vlm": (tfm, tfm), "encoder": (tfm, tfm),
             "moe": (moe, tfm), "ssm": (ssm, ssm), "hybrid": (rglru, rglru)}


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family: {cfg.family}")
    mod, cache_mod = _FAMILIES[cfg.family]

    def init(seed: int = 0, *, device=None, generator=None):
        return mod.init_params(cfg, seed, device=device, generator=generator)

    def loss_fn(params, batch, rules=None, **kw):
        return mod.loss_fn(params, batch, cfg, rules=rules, **kw)

    def param_specs(rules):
        return mod.param_specs(cfg, rules)

    if cfg.family == "encoder":      # encoders serve through tfm.encode_step
        return Model(cfg=cfg, init=init, loss_fn=loss_fn,
                     param_specs=param_specs)

    def prefill(params, batch, cache, rules=None, **kw):
        if mod is tfm:
            return _tfm_prefill(params, batch, cfg, cache, rules=rules, **kw)
        return mod.prefill(params, batch["tokens"], cfg, cache, rules=rules,
                           **kw)

    return Model(
        cfg=cfg, init=init, loss_fn=loss_fn, param_specs=param_specs,
        init_cache=lambda b, s, device=None: cache_mod.init_cache(
            cfg, b, s, device=device),
        cache_specs=lambda rules: cache_mod.cache_specs(cfg, rules),
        prefill=prefill,
        decode_step=lambda p, c, t, pos, rules=None: mod.decode_step(
            p, c, t, pos, cfg, rules=rules))
