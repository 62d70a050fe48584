"""Build and load the package's CUDA sources (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds).  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  Libraries go to ``unet_design_tpu_torch/_build/`` (listed in
``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (with ``-Xptxas -v``: registers, shared memory, spills) and
#: build seconds of each source built by this process, by source name
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path(source: str) -> str:
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; return its path."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_LOG[source] = (time.perf_counter() - t0,
                         (proc.stdout + proc.stderr).strip())
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(build(source))
    return _LOADED[source]
