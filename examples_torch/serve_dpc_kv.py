"""Serve a small LM with batched requests and DPC-KV cache compression on
the PyTorch/CUDA port; the counterpart of ``examples/serve_dpc_kv.py``.

Runs the batched engine (prefill -> decode) on a reduced gemma config,
then compresses the prompt KV cache with density-peaks clustering and
compares one attention step against the full cache: the paper's
clustering as a serving feature.

    PYTHONPATH=src python examples_torch/serve_dpc_kv.py [--device cpu]

Runs on the card unless ``--device`` says otherwise, and raises where
there is none.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduce_config
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.dpc_kv import (DPCKVConfig, attend_compressed,
                                      compress_kv)
from repro_torch.serve.engine import ServeConfig, ServeEngine


def main(device=None):
    dev = resolve_device(device)
    cfg = reduce_config(ARCHS["gemma-2b"])
    model = build_model(cfg)
    params = model.init(0, device=dev)

    engine = ServeEngine(model, params, ServeConfig(
        batch=4, max_prompt=96, max_new_tokens=16, temperature=0.0),
        device=dev)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab, rng.integers(20, 90)))
               for _ in range(4)]
    out = engine.generate(prompts)
    print(f"[serve] generated {out.shape[1]} tokens x {out.shape[0]} "
          f"requests on {dev}")
    print(f"[serve] first request: {out[0][:12].tolist()} ...")

    # --- DPC-KV: compress the final cache and compare one attention step
    cache = engine.cache
    k, v = cache.k[0].float(), cache.v[0].float()   # layer 0: (B, S, K, hd)
    B, S, K, hd = k.shape
    budget = max(16, S // 8)
    kc, vc, cnt = compress_kv(k, v, S, DPCKVConfig(budget=budget))
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, cfg.n_heads, hd), generator=g, device=dev)
    full = attend_compressed(q, k, v, torch.ones((B, S, K), device=dev))
    comp = attend_compressed(q, kc, vc, cnt)
    err = float(torch.linalg.norm(comp - full) / torch.linalg.norm(full))
    print(f"[dpc-kv] cache {S} -> {budget} centers "
          f"({S / budget:.0f}x smaller), attention output rel-err {err:.3f}")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
