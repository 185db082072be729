"""Builds the port's CUDA sources into shared libraries at first use.

Two kinds of source:

- named: each `csrc/<name>.cu` becomes `_build/lib<name>-<hash>.so`;
- generated: one fused plan (a spoof hop's CPlan) and its Variant (the
  aggregates, the scalar and the aliased leaves) become a source that
  includes `csrc/spoof.cuh`, defines the plan's functor from
  cplan.hoist and cplan.emit_cuda and exports the template's extern "C"
  launcher (`plan_source`); it is written to `_build/gen/` and built to
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
from typing import (Dict, FrozenSet, Iterable, List, NamedTuple, Optional,
                    Tuple)

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# seconds one nvcc may take: a plan of the paths builds in about 5 s on
# the H100's host (PERF.md), and emit_cuda's text grows linearly with
# the plan's nodes
NVCC_TIMEOUT_S = 300.0
_DEFAULT = object()
SPOOF_HEADER = os.path.join(CSRC, "spoof.cuh")
# template -> the launcher macro of csrc/spoof.cuh that a source exports
SPOOF_LAUNCHERS = {"cell": "SPOOF_CELL_LAUNCHER", "row": "SPOOF_ROW_LAUNCHER",
                   "multiagg": "SPOOF_MULTIAGG_LAUNCHER",
                   "outer": "SPOOF_OUTER_LAUNCHER"}

_lock = threading.RLock()
_loaded: Dict[str, ctypes.CDLL] = {}
# library path -> the lock its one nvcc runs under: callers that reach a
# source at once (parfor workers, build_plans beside a wrapper's first
# launch) build it once, the others wait and load the result
_lib_locks: Dict[str, threading.Lock] = {}
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


def _compile(name: str, src: str, lib: str,
             limit: Optional[float] = _DEFAULT) -> str:
    """Runs nvcc on `src` into `lib` unless it is built; raises with the
    compiler's output on a failed build, and on one that runs past
    `limit` seconds (NVCC_TIMEOUT_S unless given; None: no limit), after
    killing nvcc's process group (nvcc runs cicc and ptxas as
    children)."""
    if limit is _DEFAULT:
        limit = NVCC_TIMEOUT_S
    if os.path.exists(lib):
        return lib
    with _lock:
        one = _lib_locks.setdefault(lib, threading.Lock())
    with one:
        return _compile_once(name, src, lib, limit)


def _compile_once(name: str, src: str, lib: str,
                  limit: Optional[float]) -> str:
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    p = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc for {os.path.relpath(src, BUILD_DIR)} ran "
                           f"past its limit of {limit:g} s") from None
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

class Variant(NamedTuple):
    """What a plan's generated source is specialised for beyond the plan:
    the aggregates of a multi-aggregate plan, in output order; the leaves
    that are scalars (read once per thread, their subtrees hoisted); and
    the leaves that alias an earlier leaf, as (leaf, earlier leaf) name
    pairs (the flat walk reuses the earlier leaf's registers). Part of the
    source's name and of the launcher cache's key."""
    aggs: Tuple[str, ...] = ()
    scalars: FrozenSet[str] = frozenset()
    aliases: Tuple[Tuple[str, str], ...] = ()


# csrc/spoof.cuh's leaf kinds and aggregate codes
_KIND = {"cell": "spoof::kCellLeaf", "scalar": "spoof::kScalarLeaf",
         "uv": "spoof::kUVLeaf"}
_AGG_CODES = {"sum": "spoof::kSum", "min": "spoof::kMin", "max": "spoof::kMax"}

_SOURCE = """\
// Generated by systemml_tpu_torch/codegen/build.py for the {template} plan
//   {pretty}
// leaves: {leaf_notes}{agg_note}
#include "spoof.cuh"

namespace {{
struct Plan {{
  static constexpr int kLeaves = {n_leaves};
  static constexpr int kHoisted = {n_hoisted};
  // per leaf: read at every cell, a scalar, the outer template's uv, or
  // the earlier leaf it aliases
  __host__ __device__ static constexpr int kind(int i) {{
    return {kinds};
  }}
  // the scalar-only subtrees, once per thread
  template <typename T>
  __device__ __forceinline__ void hoist(const spoof::Args<T>& a,
                                        T* h) const {{
    using namespace spoof::ops;
    (void)a;
    (void)h;
#define LEAF(i) spoof::scalar<T>(a, i)
{hoisted}#undef LEAF
  }}
  // the plan at one cell: v[i] the value of leaf i there, h the hoisted
  template <typename T>
  __device__ __forceinline__ T operator()(const T* v, const T* h) const {{
    using namespace spoof::ops;
    (void)v;
    (void)h;
#define LEAF(i) v[i]
#define HOISTED(k) h[k]
    return {expr};
#undef HOISTED
#undef LEAF
  }}
}};
}}  // namespace

{launcher}
"""

_header_bytes: List[bytes] = []


def _leaf_kinds(template: str, names: List[str], variant: Variant
               ) -> List[str]:
    """Per leaf of `names`: "cell", "scalar", "uv" (the outer template's
    UV) or the name of the earlier leaf it aliases."""
    alias = dict(variant.aliases)
    kinds = []
    for k, nm in enumerate(names):
        if template == "outer" and nm == "UV":
            kinds.append("uv")
        elif nm in variant.scalars:
            kinds.append("scalar")
        elif nm in alias:
            tgt = alias[nm]
            if tgt not in names[:k] or kinds[names.index(tgt)] != "cell":
                raise ValueError(f"leaf {nm!r} aliases {tgt!r}, which is "
                                 f"not an earlier leaf read at every cell")
            kinds.append(tgt)
        else:
            kinds.append("cell")
    return kinds


def plan_source(template: str, plan, variant: Variant = Variant()
                ) -> Tuple[str, str]:
    """(name, source text) of `plan`'s library for `template` ("cell",
    "row", "multiagg" or "outer") and `variant`. An outer plan's leaf "UV"
    is the cell's uv = U[r, :] . V[c, :], which the skeleton computes; its
    other leaves ("X" and the scalars) are read as any template's. A
    multi-aggregate source carries its aggregates, in order; the others
    take none. The name carries the hash of the text, csrc/spoof.cuh and
    the flags."""
    from systemml_tpu_torch.codegen.cplan import emit_cuda, hoist

    if template not in SPOOF_LAUNCHERS:
        raise ValueError(f"no CUDA skeleton for spoof template {template!r}")
    if (template == "multiagg") != bool(variant.aggs):
        raise ValueError(f"{template} source with aggregates "
                         f"{list(variant.aggs)}")
    if any(a not in _AGG_CODES for a in variant.aggs):
        raise ValueError(f"unknown aggregates {list(variant.aggs)}")
    names = plan.input_names()
    kinds = _leaf_kinds(template, names, variant)
    scalars = {nm for nm, kd in zip(names, kinds) if kd == "scalar"}
    cell_plan, subs = hoist(plan, scalars)
    codes = [_KIND.get(kd) or str(names.index(kd)) for kd in kinds]
    kind_expr = "".join(f"i == {k} ? {c} : " for k, c in
                        enumerate(codes[:-1])) + (codes[-1] if codes
                                                  else "spoof::kCellLeaf")
    hoisted = "".join(f"    h[{k}] = {emit_cuda(sub, names)};\n"
                      for k, sub in enumerate(subs))
    launcher = SPOOF_LAUNCHERS[template]
    args = ["Plan"] + [_AGG_CODES[a] for a in variant.aggs]
    notes = ", ".join(f"{nm} {kd if kd in _KIND else '= ' + kd}"
                      for nm, kd in zip(names, kinds))
    text = _SOURCE.format(
        template=template, pretty=plan.pretty()[:2000],
        leaf_notes=notes[:2000],
        agg_note=(f"; aggregates {', '.join(variant.aggs)}"
                  if variant.aggs else ""),
        n_leaves=len(names), n_hoisted=len(subs), kinds=kind_expr,
        hoisted=hoisted, expr=emit_cuda(cell_plan, names),
        launcher=f"{launcher}({', '.join(args)})")
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


def load_plan(template: str, plan,
              variant: Variant = Variant()) -> ctypes.CDLL:
    """The ctypes handle of `plan`'s library for `template` and
    `variant`, building it first if build_plans has not."""
    name, text = plan_source(template, plan, variant)
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _write_plan(name, text)
            lib = _loaded[name] = ctypes.CDLL(_compile(name,
                                                       *_plan_paths(name)))
        return lib


def build_plans(plans: Iterable[Tuple], named: Iterable[str] = (),
                limit: Optional[float] = _DEFAULT) -> List[str]:
    """Builds and loads the libraries of (template, plan) pairs or
    (template, plan, Variant) triples, and of the named sources `named`
    (csrc/<name>.cu), that are not loaded yet: one nvcc per source, all
    running together (as many at a time as the host has cores), each
    under `limit` seconds (NVCC_TIMEOUT_S unless given; a program's and a
    block's plans take `compile_timeout_s`, 0 meaning none). Returns the
    names built or loaded."""
    todo: Dict[str, Tuple[str, str]] = {}
    for name in named:
        if name not in _loaded:
            todo[name] = _target(name)
    for template, plan, *variant in plans:
        name, text = plan_source(template, plan, *variant)
        if name not in _loaded and name not in todo:
            todo[name] = _plan_paths(name)
            _write_plan(name, text)
    if not todo:
        return []
    workers = max(1, min(len(todo), os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        libs = dict(zip(todo, pool.map(
            lambda kv: _compile(kv[0], *kv[1], limit), todo.items())))
    with _lock:
        for name, path in libs.items():
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(path)
    return list(libs)
