"""Build/version metadata; the port's copy of reverie_tpu/utils/buildinfo.py
(reference: build.rs + the `built` crate embed the git SHA and dirty flag at
compile time, printed by main.rs:277-286).

Python has no build step here, so the SHA is resolved at run time from the
enclosing git checkout (reverie_tpu's `_build_info.py` snapshot, which no
install of the port writes, is left out).
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def git_commit_info() -> Tuple[Optional[str], Optional[bool]]:
    """Returns (commit_sha, dirty) or (None, None) when unavailable."""
    try:
        sha = subprocess.run(
            ["git", "-C", _PKG_DIR, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5, check=True,
        ).stdout.strip()
        status = subprocess.run(
            ["git", "-C", _PKG_DIR, "status", "--porcelain"],
            capture_output=True, text=True, timeout=5, check=True,
        ).stdout
        return sha, bool(status.strip())
    except (OSError, subprocess.SubprocessError):
        return None, None
