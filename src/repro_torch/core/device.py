"""Where an entry point runs: on the card unless the caller asks otherwise.

Tensors keep their own device; anything else (numpy arrays, lists) goes to
the device the caller names, which defaults to ``"cuda"``.  Where no GPU is
present that default raises instead of running on the CPU unasked.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Raises where no GPU is present rather than running on the CPU unasked.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU")
    return dev


def as_points(points, device=None) -> torch.Tensor:
    """A tensor keeps its device unless ``device`` is given; anything else
    goes to ``device``, which defaults to the card."""
    if isinstance(points, torch.Tensor) and device is None:
        return points.to(torch.float32).contiguous()
    return torch.as_tensor(points, dtype=torch.float32,
                           device=resolve_device(device)).contiguous()
