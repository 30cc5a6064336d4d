"""Build the port's copy of the native preprocessing core (g++ → shared library).

The counterpart of :mod:`cask_tpu.native.build`, for the port's own copy of
``src/preprocess.cpp`` (plain ``extern "C"``, no framework, consumed with
ctypes).  The library is compiled at first use with ``g++ -O3
-march=native -shared -fPIC -std=c++17``, and once more without
``-march=native`` where that fails.  It lands in the package's own
``build/native/`` (``$CASK_TPU_TORCH_BUILD_DIR`` instead, where the package
is installed read-only), under a name keyed by a hash of the source, the
flags and what ``-march=native`` means on this host, so an edited source,
or a checkout copied to a machine with another CPU, builds anew and an
unchanged one loads at once.  A failed build returns None: every caller of
the core has a numpy path, and the entry points that are asked for the
core by name raise.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "src" / "preprocess.cpp"
BUILD_DIR = Path(os.environ.get("CASK_TPU_TORCH_BUILD_DIR")
                 or Path(__file__).resolve().parents[1] / "build" / "native")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()


def _native_target(cxx: str) -> str:
    """What ``-march=native`` expands to on this host (the target flags of the
    compiler's own command line for it), or "" where the compiler cannot say."""
    try:
        r = subprocess.run([cxx, "-march=native", "-###", "-x", "c++", "-c", os.devnull,
                            "-o", os.devnull], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return " ".join(re.findall(r"-m[\w=.+-]+|[\w-]+-cache-[\w-]+=\d+", r.stderr))


def library_path() -> Path:
    """Where the library of this source, these flags and this host's CPU
    lives (built or not)."""
    cxx = os.environ.get("CXX", "g++")
    key = hashlib.sha256(SRC.read_bytes())
    key.update(" ".join((cxx, *FLAGS)).encode())
    key.update(_native_target(cxx).encode())
    return BUILD_DIR / f"libcasknative_{key.hexdigest()[:16]}.so"


def lib_path() -> Optional[str]:
    """Path to the built library, building it if needed; None if unbuildable."""
    with _lock:
        out = library_path()
        if out.exists():
            return str(out)
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *FLAGS, "-o", str(tmp), str(SRC)]
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if r.returncode != 0:  # retry without -march=native (portability)
                cmd.remove("-march=native")
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                return None
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            return str(out)
        except (OSError, subprocess.SubprocessError):
            return None
