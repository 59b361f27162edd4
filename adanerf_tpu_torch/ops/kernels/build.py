"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``.cu`` source under ``adanerf_tpu_torch/csrc/`` compiles on its own
(with ``csrc/`` on the include path for the shared ``.cuh`` headers) into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), cached in ``adanerf_tpu_torch/_build/`` under a hash of the
source and the flags. A library is named by its source, or by a variant of
it, ``"<source>:<MACRO>=<value>"`` (``variant``), which compiles the source
with ``-D<MACRO>=<value>``: the fused kernels' MLP width is such a macro,
one library per width (the wide path, ``wide.cu``, takes its width at run
time: one library). Libraries build in parallel, one ``nvcc`` each.
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
_paths: Dict[str, str] = {}  # source -> library path, hashed once a process


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


def variant(source: str, macro: str, value: int) -> str:
    """The library of ``source`` compiled with ``-D<macro>=<value>``."""
    return f"{source}:{macro}={value}"


def _split(lib: str):
    """(source file, [-D flags]) of a library name."""
    source, _, define = lib.partition(":")
    return source, ([f"-D{define}"] if define else [])


def library_path(source: str) -> str:
    """Cache path of ``source``'s library (a source, or a ``variant``): a
    hash of its text, the shared headers of ``csrc/`` and the flags."""
    src, defines = _split(source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for name in [src] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    stem = os.path.splitext(src)[0] + "".join("-" + d[2:].replace("=", "") for d in defines)
    return os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")


def nvcc_command(nvcc: str, source: str, out: str) -> List[str]:
    src, defines = _split(source)
    return [nvcc, *NVCC_FLAGS, *defines, "-I", CSRC_DIR, "-o", out, os.path.join(CSRC_DIR, src)]


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
    """The loaded library of ``source``, built first if needed. Its path is
    hashed from the sources once a process: the wrappers call this at every
    launch, and hashing reads every source and header."""
    with _lock:
        path = _paths.get(source)
        if path is None:
            path = _paths[source] = library_path(source)
        if path not in _loaded:
            build([source])
            _loaded[path] = ctypes.CDLL(path)
        return _loaded[path]
