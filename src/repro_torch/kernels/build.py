"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled from the repository's own sources with ``nvcc``
into a ``.so`` with a plain C interface and loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds). Builds happen at first use, into
``build/kernels/`` at the repository root (listed in ``.gitignore``), under a
file name that carries a hash of the sources and flags: a changed source is
rebuilt, an unchanged one is loaded again. Within a process each library is
loaded once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "--fmad=false", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# what the last build of each library reported: seconds, ptxas resource lines
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, which has the CUDA toolkit")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build ``name`` from ``sources`` at first use (or find it built) and
    load it."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        out = BUILD_DIR / f"lib{name}-{_digest(sources)}.so"
        if out.exists():
            BUILD_LOG[name] = {"seconds": 0.0, "ptxas": [], "cached": True}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *map(str, sources)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name}:\n{log}")
            os.replace(tmp, out)
            BUILD_LOG[name] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "Compiling entry" in ln],
            }
        _LOADED[name] = ctypes.CDLL(str(out))
        return _LOADED[name]
