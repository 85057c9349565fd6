"""Batched serving engine, prefill then decode with fixed shapes: the
port of ``repro/serve/engine.py``.

* fixed batch and prompt shapes: prompts are left-padded to
  ``max_prompt``, never reshaped;
* greedy or temperature sampling with the reference's keys: ``generate``
  splits ``PRNGKey(seed)`` as the reference does and samples with
  ``threefry.categorical``, so the same logits give the same tokens;
* optional DPC-KV compression of the prompt cache after the prefill
  (the dense and moe families' 5-d ``KVCache``; the ssm and hybrid
  families' dict caches are O(1) in length and refuse it).

It runs eagerly under ``torch.inference_mode()``, on the card unless
given ``device="cpu"``; with no device named and no GPU present it raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..core import threefry
from ..core.device import resolve_device
from ..models import Model
from ..models.attention import KVCache
from .dpc_kv import DPCKVConfig, compress_kv

__all__ = ["ServeConfig", "ServeEngine"]


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    max_prompt: int = 512
    max_new_tokens: int = 64
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0
    # Optional DPC-KV compression of the prompt cache (5-d KVCache
    # models only).  Its DPC primitives run on dpc_kv.exec_spec.
    dpc_kv: DPCKVConfig | None = None


class ServeEngine:
    def __init__(self, model: Model, params, cfg: ServeConfig, device=None):
        if not model.is_decoder:
            raise ValueError(f"{model.cfg.name} cannot decode")
        self.device = resolve_device(device)
        self.model = model
        self.params = params.to(self.device)
        self.cfg = cfg
        total = cfg.max_prompt + cfg.max_new_tokens
        self.cache = model.init_cache(cfg.batch, total, device=self.device)

    def _pad_prompts(self, prompts: list[list[int]]):
        B, Lp = self.cfg.batch, self.cfg.max_prompt
        if len(prompts) > B:
            raise ValueError(f"{len(prompts)} prompts for a batch of {B}")
        toks = np.zeros((B, Lp), np.int64)
        lens = np.zeros((B,), np.int64)
        for i, p in enumerate(prompts):
            p = list(p)[-Lp:]
            toks[i, Lp - len(p):] = p      # left-pad: all rows end at Lp
            lens[i] = len(p)
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(lens).to(self.device))

    @torch.inference_mode()
    def compress_prompt_cache(self):
        """DPC-KV compression of the prefilled prompt KV cache.

        Needs ``cfg.dpc_kv`` and a dense-attention ``KVCache`` (L, B, S,
        K, hd), the dense and moe families'; call after ``generate``.
        Returns the per-layer compressed caches stacked over layers:
        (k_c, v_c, counts), (L, B, M, K, hd) x2 and (L, B, M, K).  Every
        prompt slot takes part (prompts are left-padded, so slots
        [0, max_prompt) all hold prefill keys).
        """
        kv_cfg = self.cfg.dpc_kv
        if kv_cfg is None:
            raise ValueError("ServeConfig.dpc_kv is not set")
        if not (isinstance(self.cache, KVCache) and self.cache.k.ndim == 5):
            raise ValueError(f"{self.model.cfg.name}: cache is not a "
                             f"dense-attention KVCache")
        k, v = self.cache.k, self.cache.v
        L, B, S, K, hd = k.shape
        length = min(self.cfg.max_prompt, S)
        # fold the layers into the batch axis
        k_c, v_c, counts = compress_kv(k.reshape(L * B, S, K, hd),
                                       v.reshape(L * B, S, K, hd),
                                       length, kv_cfg)
        M = kv_cfg.budget
        return (k_c.reshape(L, B, M, K, hd), v_c.reshape(L, B, M, K, hd),
                counts.reshape(L, B, M, K))

    @torch.inference_mode()
    def generate(self, prompts: list[list[int]]) -> np.ndarray:
        """Greedy/temperature generation; returns (B, max_new_tokens)
        int32."""
        toks, _ = self._pad_prompts(prompts)
        with obs.span("serve.prefill", batch=self.cfg.batch,
                      prompt=self.cfg.max_prompt) as sp:
            logits, self.cache = self.model.prefill(
                self.params, {"tokens": toks}, self.cache)
            sp.sync(logits)
        key = threefry.prng_key(self.cfg.seed, device=self.device)
        out = []
        pos = self.cfg.max_prompt
        tok = self._sample(logits, key)
        with obs.span("serve.decode", steps=self.cfg.max_new_tokens) as sp:
            for i in range(self.cfg.max_new_tokens):
                out.append(tok)
                logits, self.cache = self.model.decode_step(
                    self.params, self.cache, tok, pos + i)
                key, sub = threefry.split(key)
                tok = self._sample(logits, sub)
            sp.sync(tok)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()

    def _sample(self, logits: torch.Tensor, key: torch.Tensor):
        """(B, 1) int64 tokens: the first argmax, or with a temperature
        jax.random.categorical's draw over the f32 logits / temperature."""
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        scaled = logits.to(torch.float32) / torch.full_like(
            logits, self.cfg.temperature, dtype=torch.float32)
        return threefry.categorical(key, scaled, axis=-1)[:, None]
