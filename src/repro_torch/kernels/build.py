"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled from the repository's own sources with ``nvcc``
into a ``.so`` with a plain C interface and loaded with :mod:`ctypes` (no
PyTorch headers, so a build takes seconds). Builds happen at first use, into
``build/kernels/`` at the repository root (listed in ``.gitignore``), under a
file name that carries a hash of the sources and flags: a changed source is
rebuilt, an unchanged one is loaded again. Within a process each library is
loaded once. Each library has its own lock, so callers that ask for several
libraries from several threads run one ``nvcc`` each, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -I: the headers the sources share (hopper.cuh) lie beside this file
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "--fmad=false", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                           f"-I{Path(__file__).resolve().parent}"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
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


def _out_path(name: str, sources: Sequence[Path]) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(sources)}.so"


def _build(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``name`` unless it is built; raise with the compiler's
    output if ``nvcc`` fails. Returns the library's path."""
    out = _out_path(name, sources)
    if out.exists():
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": [],
                                    "cached": True})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # every source is hashed; the .cu files are compiled, headers included
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources if s.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n{proc.stdout}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {
        "seconds": time.perf_counter() - t0,
        # resources of each entry, and ptxas's notes on wgmma sequences
        # (one it had to serialize is slow)
        "ptxas": [ln.strip() for ln in proc.stdout.splitlines()
                  if "registers" in ln or "spill" in ln
                  or "Compiling entry" in ln or "wgmma" in ln
                  or "warpgroup" in ln],
    }
    return out


def ptxas_resources(name: str) -> Dict[str, list]:
    """{mangled entry: [registers, spill bytes (stores + loads)]} from the
    ptxas lines of library ``name``'s build in this process (empty if it
    was found built)."""
    out, cur = {}, None
    for ln in BUILD_LOG.get(name, {}).get("ptxas", []):
        m = re.search(r"Compiling entry function '([^']*)'", ln)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out.setdefault(cur, [0, 0])[0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur:
            out.setdefault(cur, [0, 0])[1] = int(m.group(1)) + int(m.group(2))
    return out


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build ``name`` from ``sources`` at first use (or find it built) and
    load it. Safe to call from several threads: builds of different
    libraries run at the same time."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(_build(name, sources)))
        return _LOADED[name]


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel library's launch function returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
