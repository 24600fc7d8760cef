"""The CUDA library's build time, built two ways on the same machine.

    python -m reverie_tpu_torch.tools.build_time

`parallel`: what the port does (`_build.build`), one nvcc per `csrc/*.cu`,
all started together, then a link.  `single_nvcc`: one nvcc over all the
sources into a shared library in a temporary directory under `_build/`.
The two alternate, `ROUNDS` times each, so that a cold file cache does not
favour either.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from typing import Dict, List

from .. import _build
from ._timing import print_results

ROUNDS = 2


def _single_nvcc() -> None:
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", f"{tmp}/lib.so",
               *map(str, _build.sources())]
        subprocess.run(cmd, check=True, capture_output=True)


def run() -> List[Dict]:
    rows = []
    for _ in range(ROUNDS):
        for way, build in (("parallel", _build.build), ("single_nvcc", _single_nvcc)):
            t = time.perf_counter()
            build()
            rows.append({"probe": "build_time", "way": way,
                         "sources": len(_build.sources()),
                         "seconds": time.perf_counter() - t})
    return rows


def main() -> int:
    print_results(run())
    return 0


if __name__ == "__main__":
    sys.exit(main())
