"""Build and load the port's CUDA kernels.

The kernels' sources are `csrc/*.cu` and the headers they share,
`csrc/*.cuh`. They are compiled with `nvcc` for `sm_90a` into one shared
library with a plain C interface under `reverie_tpu_torch/_build/` at first
use, and loaded with ctypes. Each C entry point returns `cudaGetLastError()`
after its launch; `check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libreverie_torch_cuda.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(ptxas_verbose: bool = False) -> str:
    """Compile every `csrc/*.cu` into LIB_PATH; returns the compiler's
    output (register and spill counts per kernel with ptxas_verbose)."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if ptxas_verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return res.stdout + res.stderr


def _stale() -> bool:
    """True when the library is missing or older than a source or a shared
    header."""
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = [*sources(), *CSRC.glob("*.cuh")]
    return any(s.stat().st_mtime > built for s in deps)


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or older than its
    sources."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.reverie_aes_tape_gf2.argtypes = [vp, vp, vp, i64, i32, i64, vp]
        lib.reverie_aes_tape_gf2.restype = i32
        lib.reverie_aes_tape_z64.argtypes = [vp, vp, vp, i64, i32, i64, vp]
        lib.reverie_aes_tape_z64.restype = i32
        lib.reverie_blake3_chunk_cvs.argtypes = [vp, i32, i64, i64, vp, vp]
        lib.reverie_blake3_chunk_cvs.restype = i32
        lib.reverie_cuda_error_string.argtypes = [i32]
        lib.reverie_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        msg = kernels().reverie_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
