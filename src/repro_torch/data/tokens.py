"""Deterministic synthetic LM data with a restorable cursor: the port of
``repro/data/tokens.py`` (numpy, batch for batch the reference's).

* fixed-shape batches;
* stateless indexing: batch ``i`` is a pure function of (seed, i), so a
  restore from step N replays exactly the stream the stopped run would
  have read (the checkpoint stores only the cursor);
* per-family batch dicts: ``tokens`` (B, L) for the decoders, ``features``
  and ``labels`` for the encoder, ``patches`` and text ``tokens`` for the
  vlm.

Tokens mix Zipf-distributed unigrams with repeated 16-token motifs, a
learnable stream.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.common import ArchConfig

__all__ = ["TokenPipeline"]


@dataclass
class TokenPipeline:
    cfg: ArchConfig
    batch: int
    seq_len: int
    seed: int = 0
    cursor: int = 0           # batches already emitted (checkpointed)

    def _rng(self, i: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, i]))

    def _tokens(self, rng, shape) -> np.ndarray:
        V = self.cfg.vocab
        z = rng.zipf(1.3, size=shape).astype(np.int64)   # Zipf unigrams
        toks = (z - 1) % V
        B, L = shape
        motif = rng.integers(0, V, size=16)
        for b in range(B):          # random spans overwritten by the motif
            for _ in range(max(1, L // 256)):
                s = int(rng.integers(0, max(L - 16, 1)))
                toks[b, s:s + 16] = motif[: max(0, min(16, L - s))]
        return toks.astype(np.int32)

    def batch_at(self, i: int) -> dict:
        """Batch ``i`` as numpy arrays (a pure function of seed and i)."""
        rng = self._rng(i)
        cfg, B, L = self.cfg, self.batch, self.seq_len
        if cfg.family == "encoder":
            return {
                "features": rng.normal(0, 1, (B, L, cfg.frontend_dim))
                               .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
            }
        if cfg.family == "vlm":
            return {
                "patches": rng.normal(0, 1, (B, cfg.num_patches,
                                             cfg.frontend_dim))
                              .astype(np.float32),
                "tokens": self._tokens(rng, (B, L - cfg.num_patches)),
            }
        return {"tokens": self._tokens(rng, (B, L))}

    def __next__(self) -> dict:
        out = self.batch_at(self.cursor)
        self.cursor += 1
        return out

    def __iter__(self):
        return self

    def state_dict(self) -> dict:
        return {"seed": self.seed, "cursor": self.cursor}

    def load_state_dict(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError("restoring a pipeline with a different data "
                             "seed")
        self.cursor = int(state["cursor"])
