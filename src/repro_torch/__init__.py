"""repro_torch: the PyTorch/CUDA port of the ``repro`` DPC package.

Mirrors ``repro``'s module layout and public names.  Entry points run on the
card unless the caller passes ``device="cpu"``; on CUDA tensors the hot
primitives are the hand-written Hopper kernels in ``kernels/csrc/``, on CPU
tensors their plain PyTorch versions.  Imports torch and numpy, never jax.
"""
from .engine.dpc_engine import DPCEngine
from .engine.spec import ExecSpec

__all__ = ["DPCEngine", "ExecSpec"]
