"""Build and load the port's CUDA kernels.

The kernels' sources are `csrc/*.cu` and the headers they share,
`csrc/*.cuh`. At first use each source is compiled with `nvcc` for
`sm_90a` into an object file, all of them at once (one nvcc process per
source), and the objects are linked into one shared library with a plain C
interface under `reverie_tpu_torch/_build/`, loaded with ctypes. Each C
entry point returns `cudaGetLastError()` after its launch; `check` raises on
anything but 0.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    """Compile every `csrc/*.cu` (one nvcc per source, run in parallel) and
    link them into LIB_PATH; returns the compilers' output (register and
    spill counts per kernel with ptxas_verbose)."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    failed = [(src.name, p.returncode, log) for src, p, log in zip(sources(), procs, logs)
              if p.returncode != 0]
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}.tmp")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(logs)


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
        lib.reverie_aes_ctr_planes.argtypes = [vp, vp, i64, i32, vp]
        lib.reverie_aes_ctr_planes.restype = i32
        lib.reverie_copy.argtypes = [vp, vp, i64, vp]
        lib.reverie_copy.restype = i32
        lib.reverie_u32_to_u8_rows.argtypes = [vp, vp, i64, i32, vp]
        lib.reverie_u32_to_u8_rows.restype = i32
        lib.reverie_pack_shift.argtypes = [vp, vp, vp, i64, i32, vp]
        lib.reverie_pack_shift.restype = i32
        lib.reverie_cuda_error_string.argtypes = [i32]
        lib.reverie_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        msg = kernels().reverie_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
