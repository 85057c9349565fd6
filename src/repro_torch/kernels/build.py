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


def ptxas_usage(log: str) -> dict[str, dict]:
    """Per compiled kernel (mangled name) in an ``nvcc -Xptxas -v`` log:
    its registers, its stack frame and its spill stores and loads in
    bytes."""
    usage: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            usage[name] = {"registers": 0, "stack_frame": 0,
                           "spill_stores": 0, "spill_loads": 0}
        elif name is not None and "bytes spill stores" in line:
            words = line.replace(",", " ").split()
            usage[name]["stack_frame"] = int(words[0])
            usage[name]["spill_stores"] = int(words[words.index("spill") - 2])
            usage[name]["spill_loads"] = int(words[-4])
        elif name is not None and "Used " in line and " registers" in line:
            usage[name]["registers"] = int(
                line.split("Used ")[1].split(" registers")[0])
    return usage


def kernel_name(mangled: str) -> str:
    """A kernel's name as ``kernel_attrs`` gives it, from its mangled name
    in the ptxas log (``_ZN12_GLOBAL__N_123masked_nn_kernelILi2ELb0EEEv...``
    -> ``masked_nn_kernel<2,false>``); the name itself where it is not one
    of this source's kernels."""
    s = mangled
    if not s.startswith("_Z"):
        return s
    i = 3 if s.startswith("_ZN") else 2
    last = ""
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        size = int(s[i:j])
        last, i = s[j:j + size], j + size
    if not s.startswith("I", i):
        return last
    args, i = [], i + 1
    while s.startswith("L", i):
        kind, j = s[i + 1], s.index("E", i)
        value = s[i + 2:j]
        args.append({"1": "true", "0": "false"}[value] if kind == "b"
                    else value)
        i = j + 1
    return f"{last}<{','.join(args)}>"


class KernelAttr(ctypes.Structure):
    """One row of ``repro_kernel_attrs`` (``csrc/sweep.cu``)."""

    _fields_ = [("dyn_smem", ctypes.c_longlong),
                ("name", ctypes.c_char * 64),
                ("launch", ctypes.c_char * 128),
                *((f, ctypes.c_int) for f in (
                    "d_lo", "d_hi", "threads", "rows_per_block",
                    "grid_y_max", "num_regs", "static_smem", "local_bytes",
                    "max_threads", "max_dyn_smem", "occupancy", "error"))]


def kernel_attrs(d: int) -> list[dict]:
    """The attribute table of every ``__global__`` instantiation the entry
    points can launch, on the current CUDA device, with dynamic shared
    memory at dimension ``d`` (clamped into each row's range of d): its
    name, the launch-count names of the wrappers that launch it
    (``launch``, a tuple), the d its dispatch routes to it, its block,
    the query rows a block covers along grid x, the most blocks along y,
    ``cudaFuncGetAttributes`` (``num_regs``, ``static_smem``,
    ``local_bytes``, ``max_threads``, ``max_dyn_smem``), its blocks per SM
    and the CUDA error of its query (0: none).  Launches nothing."""
    lib = load_library()
    rows = (KernelAttr * 256)()
    count = lib.repro_kernel_attrs(int(d), rows, len(rows))
    if count < 0:
        msg = lib.repro_error_string(-count).decode()
        raise RuntimeError(f"kernel_attrs: CUDA error {-count} ({msg})")
    if count > len(rows):
        raise RuntimeError(f"kernel_attrs: {count} rows for a table of "
                           f"{len(rows)}")
    out = []
    for r in rows[:count]:
        row = {f: getattr(r, f) for f, _ in KernelAttr._fields_}
        row["name"] = r.name.decode()
        row["launch"] = tuple(r.launch.decode().split(","))
        out.append(row)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    lib = ctypes.CDLL(str(build().path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_fused_count_topk.argtypes = [p, p, i, i, i, i, f, i, p, p, p,
                                           p]
    lib.repro_fused_count_topk.restype = i
    lib.repro_worklist_count_topk.argtypes = [p, p, p, p, i, i, i, i, f, i,
                                              p, p, p, p, p, p, p, p, p, p,
                                              p, p]
    lib.repro_worklist_count_topk.restype = i
    lib.repro_masked_nn.argtypes = [p, p, p, p, i, p, i, i, i, p, p, p, p]
    lib.repro_masked_nn.restype = i
    lib.repro_masked_nn_block_rows.argtypes = []
    lib.repro_masked_nn_block_rows.restype = i
    lib.repro_range_count.argtypes = [p, p, i, i, i, f, p, p]
    lib.repro_range_count.restype = i
    lib.repro_range_count_signed.argtypes = [p, p, p, i, i, i, f, p, p]
    lib.repro_range_count_signed.restype = i
    lib.repro_gather_masked_nn.argtypes = [p, p, p, p, i, i, i, i, p, p, p,
                                           p]
    lib.repro_gather_masked_nn.restype = i
    lib.repro_prefix_nn.argtypes = [p, i, i, p, p, p]
    lib.repro_prefix_nn.restype = i
    lib.repro_worklist_range_count.argtypes = [p, p, i, i, i, f, p, p, p, p,
                                               p]
    lib.repro_worklist_range_count.restype = i
    lib.repro_worklist_masked_nn.argtypes = [p, p, p, i, i, i, i, p, p, p, p,
                                             p, p, p, p, p]
    lib.repro_worklist_masked_nn.restype = i
    lib.repro_halo_range_count.argtypes = [p, p, i, p, p, p, p, p, p, i, i,
                                           i, i, f, p, p, p]
    lib.repro_halo_range_count.restype = i
    lib.repro_halo_masked_nn.argtypes = [p, p, p, i, p, p, p, p, p, p, p, p,
                                         i, i, i, i, f, p, p, p, p, p, p]
    lib.repro_halo_masked_nn.restype = i
    lib.repro_worklist_halo_range_count.argtypes = [p, p, i, p, p, p, p, p,
                                                    p, i, i, i, i, f, p, p,
                                                    p, p, p, p, p]
    lib.repro_worklist_halo_range_count.restype = i
    lib.repro_worklist_halo_masked_nn.argtypes = [p, p, p, i, p, p, p, p, p,
                                                  p, p, p, i, i, i, i, f, p,
                                                  p, p, p, p, p, p, p, p, p]
    lib.repro_worklist_halo_masked_nn.restype = i
    ll = ctypes.c_longlong
    lib.repro_halo_layout_scratch.argtypes = [i]
    lib.repro_halo_layout_scratch.restype = ll
    lib.repro_halo_layout.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, p,
                                      ll, p, p, p, p, p, p, p, p]
    lib.repro_halo_layout.restype = i
    lib.repro_worklist_range_count_signed.argtypes = [p, p, p, i, i, i, f,
                                                      p, p, p, p, p]
    lib.repro_worklist_range_count_signed.restype = i
    lib.repro_fused_count_topk_bf16.argtypes = [p, p, p, p, i, i, i, i, f,
                                                p, p, p, p, p]
    lib.repro_fused_count_topk_bf16.restype = i
    lib.repro_worklist_count_topk_bf16.argtypes = [p, p, p, p, i, i, i, i,
                                                   f, p, p, p, p, p, p, p,
                                                   p, p, p, p]
    lib.repro_worklist_count_topk_bf16.restype = i
    lib.repro_kernel_attrs.argtypes = [i, p, i]
    lib.repro_kernel_attrs.restype = i
    lib.repro_error_string.argtypes = [i]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch ({msg})")
