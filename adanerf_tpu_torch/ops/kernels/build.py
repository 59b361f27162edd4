"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``adanerf_tpu_torch/csrc/`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), cached in ``adanerf_tpu_torch/_build/`` under a hash of the
source and the flags. Sources build in parallel, one ``nvcc`` each.
Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# no -use_fast_math: the positional encode needs full-precision sinf/cosf
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a host "
                       "with the CUDA toolkit")


def library_path(source: str) -> str:
    """Cache path of ``source``'s library: a hash of its text and the flags."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")


def nvcc_command(nvcc: str, source: str, out: str) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out, os.path.join(CSRC_DIR, source)]


def build(sources: List[str]) -> Dict[str, str]:
    """Compile every source whose library is not cached, all at once.
    Returns {source: compiler log} for the sources compiled now; raises
    RuntimeError with the log if one fails."""
    todo = [s for s in sources if not os.path.exists(library_path(s))]
    if not todo:
        return {}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for src in todo:
        tmp = library_path(src) + f".tmp{os.getpid()}"
        procs[src] = (tmp, subprocess.Popen(nvcc_command(nvcc, src, tmp),
                                            stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for src, (tmp, proc) in procs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, library_path(src))  # atomic: no half-written .so
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {s}\n{logs[s]}" for s in failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        path = library_path(source)
        if path not in _loaded:
            build([source])
            _loaded[path] = ctypes.CDLL(path)
        return _loaded[path]
