"""ctypes bindings to the port's host crypto library (AES-128-CTR and
BLAKE3 in C).

The port's copy of reverie_tpu/crypto/native.py.  The sources are
`reverie_tpu_torch/native/*.c` (copies of reverie_tpu/native/); they are
compiled with gcc at first use, with the flags of reverie_tpu's
native/Makefile, into the gitignored `reverie_tpu_torch/_build/` beside the
CUDA library, and rebuilt when a source is newer than the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

from .._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
LIB_PATH = BUILD_DIR / "libreverie_native.so"
CFLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra", "-std=c11", "-shared"]

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(NATIVE_DIR.glob("*.c"))


def build() -> None:
    """Compile the host C sources into LIB_PATH (atomically replaced, so
    concurrent processes never load a half-written library)."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = ["gcc", *CFLAGS, "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"gcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, LIB_PATH)


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources())


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
        vp, size = ctypes.c_void_p, ctypes.c_size_t
        lib.aes128_ctr_keystream_batch.argtypes = [vp, ctypes.c_uint64, vp, size, size]
        lib.aes128_key_expand_batch.argtypes = [vp, vp, size]
        lib.blake3_hash.argtypes = [vp, size, vp]
        lib.blake3_xof.argtypes = [vp, size, vp, size]
        lib.blake3_hash_many.argtypes = [vp, size, size, vp]
        for fn in (lib.aes128_ctr_keystream_batch, lib.aes128_key_expand_batch,
                   lib.blake3_hash, lib.blake3_xof, lib.blake3_hash_many):
            fn.restype = None
        _lib = lib
        return _lib
