"""Learning-rate schedule (warmup then cosine decay, the LM default): the
port of ``repro/train/schedule.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """The f32 learning rate at ``step`` (an int or a tensor): linear from
    0 to ``peak_lr`` over ``warmup_steps``, then a cosine down to
    ``min_ratio * peak_lr`` at ``total_steps``, flat after.  A 0-d f32
    tensor on ``step``'s device (the CPU for an int)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(
        math.pi * prog))
    return peak_lr * torch.where(s < warmup_steps, warm, cos)
