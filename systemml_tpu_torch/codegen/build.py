"""Builds the port's CUDA sources into shared libraries at first use.

Two kinds of source:

- named: each `csrc/<name>.cu` becomes `_build/lib<name>-<hash>.so`;
- generated: one fused plan (a spoof hop's CPlan) becomes a source that
  includes `csrc/spoof.cuh`, defines the plan's functor from
  cplan.emit_cuda and exports the template's extern "C" launcher
  (`plan_source`); it is written to `_build/gen/` and built to
  `_build/libspoof_<template>-<hash>.so`.

Either is built by nvcc for `sm_90a` with a plain C interface and loaded
with ctypes. The hash covers the source, the headers it includes and the
flags, so an edited source never loads a stale library. `build_plans`
builds every plan of a program at once, one nvcc per source, all running
together, before the program runs: no nvcc runs inside a loop iteration.
An nvcc that runs past NVCC_TIMEOUT_S is killed with the processes it
started, and the build raises.
Nothing here runs at import: the CPU tests import every module, and a
machine without a card may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# seconds one nvcc may take: a plan of the paths builds in about 5 s on
# the H100's host (PERF.md), and emit_cuda's text grows linearly with
# the plan's nodes
NVCC_TIMEOUT_S = 300.0
SPOOF_HEADER = os.path.join(CSRC, "spoof.cuh")
# template -> the launcher macro of csrc/spoof.cuh that a source exports
SPOOF_LAUNCHERS = {"cell": "SPOOF_CELL_LAUNCHER", "row": "SPOOF_ROW_LAUNCHER",
                   "multiagg": "SPOOF_MULTIAGG_LAUNCHER",
                   "outer": "SPOOF_OUTER_LAUNCHER"}

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


def _digest(*parts: bytes) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(p)
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = _digest(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _compile(name: str, src: str, lib: str) -> str:
    """Runs nvcc on `src` into `lib` unless it is built; raises with the
    compiler's output on a failed build, and on one that runs past
    NVCC_TIMEOUT_S, after killing nvcc's process group (nvcc runs cicc
    and ptxas as children)."""
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    p = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc for {os.path.relpath(src, BUILD_DIR)} ran "
                           f"past its limit of {NVCC_TIMEOUT_S:g} s") from None
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {os.path.relpath(src, BUILD_DIR)}"
                           f":\n{out}")
    os.replace(tmp, lib)
    build_reports[name] = (time.perf_counter() - t0, out)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library `name` (csrc/<name>.cu), building it
    first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(_compile(name, *_target(name)))
        return lib


# --------------------------------------------------------------------------
# generated sources: one per spoof plan
# --------------------------------------------------------------------------

_SOURCE = """\
// Generated by systemml_tpu_torch/codegen/build.py for the {template} plan
//   {pretty}
#include "spoof.cuh"

namespace {{
struct Plan {{
  template <typename T>
  __device__ __forceinline__ T operator()(const spoof::Args<T>& a, long long r,
                                          long long c{params}) const {{
    using namespace spoof::ops;
#define LEAF(i) {leaf}
    return {expr};
#undef LEAF
  }}
}};
}}  // namespace

{launcher}(Plan)
"""

_header_bytes: List[bytes] = []


def plan_source(template: str, plan) -> Tuple[str, str]:
    """(name, source text) of `plan`'s library for `template` ("cell",
    "row", "multiagg" or "outer"). An outer plan's functor takes the cell's
    uv = U[r, :] . V[c, :] as an argument, and its leaf "UV" reads it; its
    other leaves ("X" and the scalars) are read as any template's. The
    name carries the hash of the text, csrc/spoof.cuh and the flags."""
    from systemml_tpu_torch.codegen.cplan import emit_cuda

    if template not in SPOOF_LAUNCHERS:
        raise ValueError(f"no CUDA skeleton for spoof template {template!r}")
    leaf, params = "spoof::leaf<T>(a, i, r, c)", ""
    names = plan.input_names()
    if template == "outer":
        params = ", T uv"
        if "UV" in names:
            leaf = f"((i) == {names.index('UV')} ? uv : {leaf})"
    text = _SOURCE.format(template=template, pretty=plan.pretty()[:2000],
                          expr=emit_cuda(plan), leaf=leaf, params=params,
                          launcher=SPOOF_LAUNCHERS[template])
    if not _header_bytes:
        with open(SPOOF_HEADER, "rb") as f:
            _header_bytes.append(f.read())
    return (f"spoof_{template}-{_digest(text.encode(), _header_bytes[0])}",
            text)


def _plan_paths(name: str) -> Tuple[str, str]:
    return (os.path.join(BUILD_DIR, "gen", name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _write_plan(name: str, text: str) -> None:
    src, lib = _plan_paths(name)
    if not os.path.exists(lib):
        os.makedirs(os.path.dirname(src), exist_ok=True)
        tmp = f"{src}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, src)


def load_plan(template: str, plan) -> ctypes.CDLL:
    """The ctypes handle of `plan`'s library for `template`, building it
    first if build_plans has not."""
    name, text = plan_source(template, plan)
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _write_plan(name, text)
            lib = _loaded[name] = ctypes.CDLL(_compile(name,
                                                       *_plan_paths(name)))
        return lib


def build_plans(plans: Iterable[Tuple[str, object]],
                named: Iterable[str] = ()) -> List[str]:
    """Builds and loads the libraries of (template, plan) pairs, and of
    the named sources `named` (csrc/<name>.cu), that are not loaded yet:
    one nvcc per source, all running together (as many at a time as the
    host has cores). Returns the names built or loaded."""
    todo: Dict[str, Tuple[str, str]] = {}
    for name in named:
        if name not in _loaded:
            todo[name] = _target(name)
    for template, plan in plans:
        name, text = plan_source(template, plan)
        if name not in _loaded and name not in todo:
            todo[name] = _plan_paths(name)
            _write_plan(name, text)
    if not todo:
        return []
    workers = max(1, min(len(todo), os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        libs = dict(zip(todo, pool.map(lambda kv: _compile(kv[0], *kv[1]),
                                       todo.items())))
    with _lock:
        for name, path in libs.items():
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(path)
    return list(libs)
