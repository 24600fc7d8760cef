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
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

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
        for launch in (lib.reverie_aes_tape_gf2, lib.reverie_aes_tape_z64):
            launch.argtypes = [vp, vp, vp, i64, i32, i64, vp]
            launch.restype = i32
        for plan in (lib.reverie_aes_tape_gf2_plan, lib.reverie_aes_tape_z64_plan,
                     lib.reverie_aes_ctr_planes_plan):
            plan.argtypes = [i64, i32, vp]
            plan.restype = i32
        # buf, R, n_chunks, chunk_base, out, then the plan (blake3.py ChunkPlan:
        # route, cols, chunks, chunk_stage, stages, threads) and the stream
        lib.reverie_blake3_chunk_cvs.argtypes = [vp, i32, i64, i64, vp, *[i32] * 6, vp]
        lib.reverie_blake3_chunk_cvs.restype = i32
        lib.reverie_blake3_chunk_cvs_registers.argtypes = []
        lib.reverie_blake3_chunk_cvs_registers.restype = i32
        lib.reverie_blake3_tail.argtypes = [vp, vp]  # the launch's int64 words, the stream
        lib.reverie_blake3_tail.restype = i32
        lib.reverie_blake3_tail_registers.argtypes = []
        lib.reverie_blake3_tail_registers.restype = i32
        lib.reverie_aes_ctr_planes.argtypes = [vp, vp, i64, i32, vp]
        lib.reverie_aes_ctr_planes.restype = i32
        lib.reverie_copy.argtypes = [vp, vp, i64, vp]
        lib.reverie_copy.restype = i32
        lib.reverie_u32_to_u8_rows.argtypes = [vp, vp, i64, i32, vp]
        lib.reverie_u32_to_u8_rows.restype = i32
        lib.reverie_pack_shift.argtypes = [vp, vp, vp, i64, i32, vp]
        lib.reverie_pack_shift.restype = i32
        for launch in (lib.reverie_scan_gf2, lib.reverie_scan_z64):
            launch.argtypes = [vp]  # the launch's int64 words (backend/scan.py wave_run)
            launch.restype = i32
        for plan in (lib.reverie_scan_gf2_plan, lib.reverie_scan_z64_plan,
                     lib.reverie_scan_z64_smem):
            plan.argtypes = [vp, vp]
            plan.restype = i32
        lib.reverie_cuda_error_string.argtypes = [i32]
        lib.reverie_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_FIELDS = {
    "registers": re.compile(r"Used (\d+) registers"),
    "spill_stores": re.compile(r"(\d+) bytes spill stores"),
    "spill_loads": re.compile(r"(\d+) bytes spill loads"),
    "smem_static": re.compile(r"(\d+) bytes smem"),
}


def ptxas_summary(log: str) -> List[Dict[str, object]]:
    """Per kernel of a `build(ptxas_verbose=True)` log: its (mangled) name,
    registers, spill store and load bytes and static shared memory bytes
    (dynamic shared memory is set at launch, not here)."""
    rows: List[Dict[str, object]] = []
    for line in log.splitlines():
        entry = _PTXAS_ENTRY.search(line)
        if entry:
            rows.append({"kernel": entry.group(1), "registers": None, "spill_stores": 0,
                         "spill_loads": 0, "smem_static": 0})
            continue
        for key, pat in _PTXAS_FIELDS.items():
            m = pat.search(line)
            if m and rows:
                rows[-1][key] = int(m.group(1))
    return rows


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        msg = kernels().reverie_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
