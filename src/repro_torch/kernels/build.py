"""Build ``csrc/sweep.cu`` with ``nvcc`` and bind it through ``ctypes``.

The library is compiled at first use, for ``sm_90a``, into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), under a name keyed by the hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs when the module is imported; CPU tensors never reach it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

SOURCE = Path(__file__).resolve().parent / "csrc" / "sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Build(NamedTuple):
    path: Path          # the shared library
    seconds: float      # nvcc wall time (0.0 when reused)
    log: str            # nvcc's output, ptxas register/spill report included


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def build() -> Build:
    """Compile the kernels unless this source's library already exists."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"sweep_{key}.so"
    if lib.exists():
        return Build(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                           f"{SOURCE.name}:\n{log}")
    os.replace(tmp, lib)        # atomic: a concurrent build sees all or none
    return Build(lib, seconds, log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    lib = ctypes.CDLL(str(build().path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_fused_count_topk.argtypes = [p, p, i, i, i, f, p, p, p, p, p]
    lib.repro_fused_count_topk.restype = i
    lib.repro_worklist_count_topk.argtypes = [p, p, i, i, i, f, p, p, p, p,
                                              p, p, p, p, p, p]
    lib.repro_worklist_count_topk.restype = i
    lib.repro_masked_nn.argtypes = [p, p, p, p, i, i, i, p, p, p]
    lib.repro_masked_nn.restype = i
    lib.repro_range_count.argtypes = [p, p, i, i, i, f, p, p]
    lib.repro_range_count.restype = i
    lib.repro_range_count_signed.argtypes = [p, p, p, i, i, i, f, p, p]
    lib.repro_range_count_signed.restype = i
    lib.repro_gather_masked_nn.argtypes = [p, p, p, i, i, i, p, p, p, p]
    lib.repro_gather_masked_nn.restype = i
    lib.repro_prefix_nn.argtypes = [p, i, i, p, p, p]
    lib.repro_prefix_nn.restype = i
    lib.repro_worklist_range_count.argtypes = [p, p, i, i, i, f, p, p, p, p,
                                               p]
    lib.repro_worklist_range_count.restype = i
    lib.repro_worklist_masked_nn.argtypes = [p, p, p, p, i, i, i, p, p, p, p,
                                             p, p, p]
    lib.repro_worklist_masked_nn.restype = i
    lib.repro_halo_range_count.argtypes = [p, p, p, p, i, i, i, i, f, p, p]
    lib.repro_halo_range_count.restype = i
    lib.repro_halo_masked_nn.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p,
                                         p, p, p]
    lib.repro_halo_masked_nn.restype = i
    lib.repro_error_string.argtypes = [i]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch ({msg})")
