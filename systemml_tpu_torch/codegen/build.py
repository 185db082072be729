"""Builds the port's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` becomes `_build/lib<name>-<hash>.so`: nvcc for
`sm_90a`, a plain C interface, loaded with ctypes. The hash covers the
source and the flags, so an edited source never loads a stale library.
Nothing here runs at import: the CPU tests import every module, and a
machine without a card may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, the compiler's -Xptxas -v report) of builds this
# process ran; chip_smoke.py prints them
build_reports: Dict[str, Tuple[float, str]] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                           "port's CUDA kernels build on the machine with "
                           "the card")
    return path


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _build(name: str) -> str:
    """The path of library `name`, compiling it first if it is not built
    yet; raises with the compiler's output on a failed build."""
    src, lib = _target(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    p = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{p.stdout}")
    os.replace(tmp, lib)
    build_reports[name] = (time.perf_counter() - t0, p.stdout)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library `name`, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(_build(name))
        return lib
