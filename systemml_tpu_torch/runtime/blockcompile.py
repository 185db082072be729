"""The whole-block compile: each basic block outside a loop region run
through a plan keyed by the values it reads.

Port of the JAX package's fused block path
(systemml_tpu/runtime/program.py:93-150 BasicBlock.execute, :151
_execute_fused). Where the JAX package jits a block into one XLA
executable per key, the port's counterpart is:

1. Key. At a block's execution its reads are keyed as `_execute_fused`
   keys them: each tensor by shape, dtype and device, each 0-d tensor by
   dtype, each host number that sizes something (the analysis's
   `static_scalars`) by value and every other host number by type.
2. Plan. A new key compiles once. For a block at the top level of the
   main program, a copy of the block's hops takes the run-time dims of
   its inputs (hops/ipa.propagate_sizes), and at optlevel >= 3 the
   spoof selection (codegen/compiler.py) runs over it with those dims,
   taking also an aggregate of one cellwise op over a matrix of more
   than one column (the fusion XLA makes in the JAX package's
   whole-block jit, so that Kmeans's `rowSums(X ^ 2)` is a K4 row plan
   and `X ^ 2` is never formed); on the card the new plans' kernels are
   built (codegen/build.py, each nvcc under `compile_timeout_s`). Below
   optlevel 3 the plan is the block's own hops, as it launches no spoof
   kernel anywhere else. For a block inside a loop or a function body
   the plan is the block's own hops: such a block runs inside a loop
   region whenever its loop is one, with the compile-time plans, and a
   loop run with regions and without must launch the same kernels. A
   key seen before reuses its plan. The block
   then runs through the plan, sinks and host writes included: nothing
   traces, so nothing replays.
3. Graph, in JMLC re-execution only (api/jmlc.py: `Program.execute`
   with `block_graphs`), where a prepared script runs once a request: a
   capture costs 4-34 ms of host time and saves a few tenths of a ms a
   run at most (PERF.md), which a block of a refused loop or a function
   body seldom runs often enough to recover. On the card a key runs
   through the plan without a capture, under torch's sync debug mode,
   which shows whether the block reads the device from the host, until
   one such run is free of synchronizing calls (a second run that
   synchronizes refuses the key's graph: the first may be one-time set-up,
   such as cuBLAS's). The next run captures the block into one CUDA graph
   (the loop regions' capture code: codegen/loop_graph.py,
   runtime/loopfuse.capture_streams) over static input buffers, and
   launches it; later runs copy their inputs into those buffers (a tensor
   already there is not copied) and launch. So a block that runs once
   pays no capture. A key's graph holds the values of the host numbers
   the block reads; GRAPHS_PER_PLAN values at most, then the key runs
   without one. A block
   that prints, writes, calls a function, reads the host, writes a host
   string, draws a rand() whose seed is not a literal other than -1 (its
   key may come from the host's stream, which a graph would freeze),
   holds one op only (one launch either way), or reads more than
   GRAPH_INPUT_BYTES of tensors runs without a graph, counted by reason
   (`nograph:<reason>`).

Threads. One prepared script may be executed from any number of
threads at once (api/serving.py). A key's plan holds a lock under which
its runs are counted, its watched runs run and a new graph is captured:
a second thread that reaches a graph being captured waits for it and
launches it. Captures of different keys take turns (they share the
capture streams), and a watched run holds a process-wide lock while
torch's sync debug mode, which is process-wide, is on; synchronizing
calls of other threads in that window are not the block's: they do not
count against it, and their warnings are dropped (one that torch hands
to Python only after the window has closed is printed once). A launch
(copy in, launch, clone out) holds its graph's lock, so two requests
never interleave in one graph's buffers; launches of different keys do
not wait for each other. A capture counts into a Statistics of its own,
so that what other threads count meanwhile does not enter the counts
that each launch adds again.

A block takes the eager path, counted by reason, when it reads a sparse
or compressed value or a list (as `_execute_fused:160-207` demotes
them), or when the analysis finds nothing to plan (a `restore`, or only
host work). A block inside a running loop region is part of the region's
graph and runs as it always did.

`codegen_enabled` False turns the graphs off, as it turns off the JAX
package's whole-block jit, and the loop regions: every block then runs
through its plan without a capture. The plans themselves are made
whatever `codegen_enabled` says, so that a loop run with regions and
without launches the same kernels outside the loop (the equality the
region tests and chip_smoke.py hold).
"""

from __future__ import annotations

import copy
import math
import sys
import threading
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from systemml_tpu_torch.hops.hop import postorder

# tensor bytes a block graph copies its inputs into buffers of its own
GRAPH_INPUT_BYTES = 256 << 20
# host-number variants a key's graphs are captured for
GRAPHS_PER_PLAN = 4
# held while a new key's plan is made (and its kernels built)
_plan_lock = threading.RLock()
# held by a capture: the capture streams are shared by the threads that
# are not parfor lanes
_capture_lock = threading.RLock()
# held by a watched run: torch's sync debug mode and the warnings
# filters are process-wide
_watch_lock = threading.RLock()


class BlockPlan:
    """One key's plan: the hops it runs, how often it ran, its graphs by
    the host numbers it reads, and why it runs without one."""

    __slots__ = ("hops", "runs", "graphs", "refusal", "counted", "clean",
                 "synced", "lock")

    def __init__(self, hops, refusal: Optional[str]):
        self.hops = hops
        self.runs = 0
        self.graphs: Dict[tuple, "_BlockGraph"] = {}
        self.refusal = refusal
        self.counted = False
        # a watched run was free of synchronizing calls; watched runs
        # that synchronized
        self.clean = False
        self.synced = 0
        # guards runs, clean, synced, counted, refusal and graphs
        self.lock = threading.RLock()


class _BlockGraph:
    """A captured block: its static input buffers, its outputs (in the
    graph's pool), the host numbers it wrote, and the counters its capture
    moved (applied again at each later launch). `lock` is held from the
    copy into its buffers to the clone of its outputs; `stream` is the
    last launch's stream, which a launch on another stream waits for."""

    def __init__(self):
        self.inputs: Dict[str, torch.Tensor] = {}
        self.outputs: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, Any] = {}
        self.exec = None
        self.graph = None
        self.pool = None
        self.delta: Dict[tuple, int] = {}
        self.launched = False
        self.lock = threading.Lock()
        self.stream = None

    def __del__(self):
        if (self.exec is not None or self.graph is not None) \
                and not sys.is_finalizing():
            from systemml_tpu_torch.codegen import loop_graph as lg

            g, x = self.graph, self.exec
            self.graph = self.exec = None
            lg.destroy(g, x)


# --------------------------------------------------------------------------
# eager or planned
# --------------------------------------------------------------------------

def _value_reason(v) -> Optional[str]:
    from systemml_tpu_torch.compress import is_compressed
    from systemml_tpu_torch.runtime import sparse as sp
    from systemml_tpu_torch.runtime.data import ListObject

    if sp.is_sparse(v) or sp.is_ell(v):
        return "sparse"
    if is_compressed(v):
        return "compressed"
    if isinstance(v, (ListObject, list, tuple)):
        return "list"
    return None


def eager_reason(block, ec) -> Optional[str]:
    """Why this execution of `block` runs eagerly, or None to plan it."""
    an = block.analysis()
    if not an.jittable:
        return "restore" if "call:restore" in _ops(block) else \
            "nothing to plan"
    env = ec.vars
    for n in sorted(block.hops.reads):
        if n in env:
            r = _value_reason(env[n])
            if r is not None:
                return r
    return None


def _ops(block):
    return {h.op for h in postorder(block.hops.roots())}


# --------------------------------------------------------------------------
# keys and plans
# --------------------------------------------------------------------------

def _is_number(v) -> bool:
    return isinstance(v, (bool, int, float, np.generic))


def block_key(block, env) -> tuple:
    """The key of this execution, as `_execute_fused` keys it."""
    static = block.analysis().static_scalars
    parts = []
    for n in sorted(block.hops.reads):
        if n not in env:
            parts.append((n, "absent"))
            continue
        v = env[n]
        if isinstance(v, torch.Tensor):
            if v.ndim == 0:
                parts.append((n, "0d", v.dtype, str(v.device)))
            else:
                parts.append((n, "t", tuple(v.shape), v.dtype,
                              str(v.device)))
        elif _is_number(v):
            if isinstance(v, np.generic):
                v = v.item()
            if n in static:
                # NaN never equals itself: it would miss every time
                parts.append((n, "static", type(v),
                              "nan" if isinstance(v, float)
                              and math.isnan(v) else v))
            else:
                parts.append((n, "scalar", type(v)))
        else:
            parts.append((n, type(v).__name__))
    return tuple(parts)


def _graph_refusal(block) -> Optional[str]:
    """Why no key of this block can be a CUDA graph, or None."""
    from systemml_tpu_torch.compiler.lower import EAGER_ONLY_OPS

    an = block.analysis()
    host = sorted(_ops(block) & EAGER_ONLY_OPS)
    if host:
        return f"host op {host[0]}"
    if an.host_writes:
        return "host write"
    ops = [h for h in postorder(block.hops.roots())
           if h.op not in ("tread", "lit")]
    if any(_stream_rand(h) for h in ops):
        return "rand"
    if len(ops) < 2:
        # one launch either way: the graph's input copies and output
        # clones only add to it (PERF.md, `[jmlc]`)
        return "one op"
    return None


def _stream_rand(h) -> bool:
    """A rand() that may take its key from the host's stream: no seed,
    or one that is not a literal other than -1."""
    if h.op != "call:rand":
        return False
    names = h.params.get("argnames") or []
    if "seed" not in names:
        return True
    seed = h.inputs[names.index("seed")]
    return seed.op != "lit" or seed.value == -1


def _runtime_scalar(env):
    """The spoof leaves that give scalars, from the values read."""
    def is_scalar(h) -> bool:
        if h.op == "lit":
            return not isinstance(h.value, str)
        if h.op == "tread":
            v = env.get(h.name)
            return _is_number(v) or (isinstance(v, torch.Tensor)
                                     and v.ndim == 0)
        if h.op.startswith(("b(", "u(")):
            return all(is_scalar(c) for c in h.inputs)
        return h.dt == "scalar"
    return is_scalar


def select(hops, dims) -> list:
    """The block compile's spoof selection over `hops` (a copy of a
    block's) with the run-time `dims` of its reads ({name: (rows, cols)});
    returns the spoof hops it made."""
    from systemml_tpu_torch.codegen.compiler import compile_spoof
    from systemml_tpu_torch.hops.ipa import propagate_sizes
    from systemml_tpu_torch.utils import stats as stats_mod

    propagate_sizes(list(hops.writes.values()) + list(hops.sinks), dims)
    before = {h.id for h in postorder(hops.roots()) if h.op == "spoof"}
    # selection counters stay the compile-time pass's: the block's new
    # plans are counted apart (block_spoof_plans)
    with stats_mod.stats_scope(None):
        compile_spoof(hops, wide_single_op=True)
    return [h for h in postorder(hops.roots())
            if h.op == "spoof" and h.id not in before]


def compile_plan(block, env, cfg, stats) -> BlockPlan:
    """The plan of a new key (module docstring, step 2)."""
    from systemml_tpu_torch.codegen import build
    from systemml_tpu_torch.codegen.compiler import hop_variant
    from systemml_tpu_torch.obs import trace as obs

    refusal = _graph_refusal(block)
    if not block.top_level or cfg.optlevel < 3:
        return BlockPlan(block.hops, refusal)
    with obs.span("block_compile", obs.CAT_COMPILE):
        hops = copy.deepcopy(block.hops)
        dims = {}
        for n in hops.reads:
            v = env.get(n)
            if isinstance(v, torch.Tensor) and v.ndim in (1, 2):
                dims[n] = (int(v.shape[0]),
                           int(v.shape[1]) if v.ndim == 2 else 1)
        new = select(hops, dims)
        if new:
            stats.count_estim("block_spoof_plans", len(new))
            is_scalar = _runtime_scalar(env)
            for h in new:
                hop_variant(h, is_scalar)
            if torch.device(cfg.device).type == "cuda":
                build.build_plans(
                    [(h.params["template"], h.params["plan"],
                      h.params["variant"]) for h in new],
                    limit=cfg.compile_timeout_s or None)
    return BlockPlan(hops, refusal)


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

def execute(block, ec) -> None:
    """Runs `block` through its plan for this key (module docstring): one
    `dispatch` span, fenced on the block's writes under the profiler."""
    from systemml_tpu_torch.compiler.lower import Evaluator
    from systemml_tpu_torch.obs import profile as prof
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.runtime.loopfuse import _region_device
    from systemml_tpu_torch.utils.config import get_config

    cfg = get_config()
    env = ec.vars
    key = block_key(block, env)
    plan = block._plans.get(key)
    if plan is None:
        # parfor workers that reach a new key at once compile it once
        with _plan_lock:
            plan = block._plans.get(key)
            if plan is None:
                plan = compile_plan(block, env, cfg, ec.stats)
                block._plans[key] = plan
                ec.stats.count_compile()
    dev = _region_device(ec)
    graphs = dev.type == "cuda" and ec.block_graphs and cfg.codegen_enabled
    g = None
    with plan.lock:
        plan.runs += 1
        if graphs and plan.refusal is None:
            if not plan.clean:
                with obs.span("dispatch", obs.CAT_RUNTIME,
                              block=block.label()) as sp:
                    prof.maybe_fence(sp, _watched_run(block, plan, ec),
                                     site="block_dispatch")
                return
            gkey = tuple((n, v) for n, v in sorted(
                (n, env[n]) for n in block.hops.reads
                if n in env and _is_number(env[n])))
            g = plan.graphs.get(gkey)
            if g is None:
                if len(plan.graphs) >= GRAPHS_PER_PLAN:
                    plan.refusal = "host numbers vary"
                elif _input_bytes(block, env) > GRAPH_INPUT_BYTES:
                    plan.refusal = "inputs too large"
                else:
                    # under the plan's lock: a second thread of this key
                    # waits for the capture and launches it
                    with obs.span("recompile", obs.CAT_COMPILE,
                                  block=block.label(), graph=True):
                        g = plan.graphs[gkey] = _capture(block, plan, ec,
                                                         dev)
                    ec.stats.count_block_graph("capture")
        if g is None and graphs and plan.refusal is not None \
                and plan.runs > 1 and not plan.counted:
            plan.counted = True
            ec.stats.count_block_graph(f"nograph:{plan.refusal}")
    if g is not None:
        with obs.span("block", obs.CAT_RUNTIME, mode="graph"), \
                obs.span("dispatch", obs.CAT_RUNTIME,
                         block=block.label()) as sp:
            prof.maybe_fence(sp, _launch(block, g, ec, dev),
                             site="block_dispatch")
        ec.stats.count_block_graph("replay")
        return
    with obs.span("block", obs.CAT_RUNTIME, mode="fused"), \
            obs.span("dispatch", obs.CAT_RUNTIME, block=block.label()) as sp:
        ev = Evaluator(env, ec.call_function, ec.printer, stats=ec.stats,
                       timing=True, skip_writes=ec.skip_writes)
        writes = ev.run(plan.hops)
        env.update(writes)
        prof.maybe_fence(sp, writes, site="block_dispatch")


def _watched_run(block, plan, ec) -> dict:
    """A run of a key on the card before its capture (under the plan's
    lock): through the plan, under torch's sync debug mode. A run free of
    synchronizing calls lets the next capture; a second run that
    synchronizes refuses the key's graph ("host read"). Returns the
    block's writes."""
    from systemml_tpu_torch.compiler.lower import Evaluator
    from systemml_tpu_torch.obs import trace as obs

    if ec.stats.fine_grained:
        plan.refusal = "fine-grained stats"
    ec.stats.count_block_graph("watched")
    me = threading.get_ident()
    seen = []
    with _watch_lock, warnings.catch_warnings(), \
            obs.span("block", obs.CAT_RUNTIME, mode="fused"):
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if threading.get_ident() == me:
                seen.append((message, category, filename, lineno))
            elif "synchroniz" not in str(message):
                # another thread's own warning; its synchronizing calls
                # warn only because the debug mode is on for this run
                shown(message, category, filename, lineno, file, line)

        warnings.simplefilter("always")
        warnings.showwarning = show
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(1)
        try:
            ev = Evaluator(ec.vars, ec.call_function, ec.printer,
                           stats=ec.stats, timing=True,
                           skip_writes=ec.skip_writes)
            writes = ev.run(plan.hops)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    synced = False
    for message, category, filename, lineno in seen:
        if "synchroniz" in str(message):
            synced = True
        else:
            warnings.warn_explicit(message, category, filename, lineno)
    if synced:
        plan.synced += 1
        if plan.synced >= 2 and plan.refusal is None:
            plan.refusal = "host read"
    else:
        plan.clean = True
    if plan.refusal is None and any(
            not isinstance(v, torch.Tensor) and not _is_number(v)
            for v in writes.values()):
        plan.refusal = "host write"
    ec.vars.update(writes)
    return writes


def _input_bytes(block, env) -> int:
    return sum(v.numel() * v.element_size()
               for n in block.hops.reads if n in env
               for v in [env[n]] if isinstance(v, torch.Tensor))


def _capture(block, plan, ec, dev) -> _BlockGraph:
    """Captures the block over static copies of its tensor reads into one
    CUDA graph, in a memory pool of its own, and instantiates it. The
    capture counts into a Statistics of its own, which is then merged
    into the run's (module docstring, Threads)."""
    with _capture_lock:
        return _capture_locked(block, plan, ec, dev)


def _capture_locked(block, plan, ec, dev) -> _BlockGraph:
    from systemml_tpu_torch.codegen import loop_graph as lg
    from systemml_tpu_torch.compiler.lower import Evaluator
    from systemml_tpu_torch.runtime import loopfuse
    from systemml_tpu_torch.utils import stats as stats_mod

    env = ec.vars
    g = _BlockGraph()
    local = {}
    for n in block.hops.reads:
        if n not in env:
            continue
        v = env[n]
        if isinstance(v, torch.Tensor):
            buf = torch.empty_like(v, memory_format=torch.contiguous_format)
            buf.copy_(v)
            g.inputs[n] = local[n] = buf
        else:
            local[n] = v
    streams = loopfuse.capture_streams(dev)
    s0 = streams[0]
    s0.wait_stream(torch.cuda.current_stream(dev))
    g.pool = torch.cuda.MemPool()
    mine = stats_mod.Statistics()
    before = loopfuse._snapshot(mine)
    try:
        with torch.cuda.device(dev), torch.cuda.stream(s0), \
                torch.cuda.use_mem_pool(g.pool, dev), \
                stats_mod.stats_scope(mine):
            lg.capture_begin(s0.cuda_stream)
            ev = Evaluator(local, ec.call_function, ec.printer,
                           stats=mine, timing=False,
                           skip_writes=ec.skip_writes)
            writes = ev.run(plan.hops)
            g.graph = lg.capture_end(s0.cuda_stream)
    except BaseException:
        lg.abort(s0.cuda_stream, destroy_graph=True)
        raise
    torch.cuda.current_stream(dev).wait_stream(s0)
    g.exec = lg.instantiate(g.graph)
    g.delta = loopfuse._delta(loopfuse._snapshot(mine), before)
    ec.stats.merge(mine)
    for n, v in writes.items():
        h = plan.hops.writes[n]
        if h.op == "tread" and h.name == n:
            continue      # an identity write: the name keeps its value
        if isinstance(v, torch.Tensor):
            g.outputs[n] = v
        else:
            g.host[n] = v
    return g


def _launch(block, g: _BlockGraph, ec, dev) -> dict:
    """Copies this run's tensor reads into the graph's buffers (one that
    is already there is not copied), launches, and binds the outputs as
    copies (the next launch writes the graph's own again): all under the
    graph's lock, after the last launch's clones where that launch was on
    another stream. Returns the outputs it bound."""
    from systemml_tpu_torch.codegen import loop_graph as lg
    from systemml_tpu_torch.runtime import loopfuse

    env = ec.vars
    cur = torch.cuda.current_stream(dev)
    with g.lock:
        if g.stream is not None and g.stream != cur:
            cur.wait_stream(g.stream)
        g.stream = cur
        for n, buf in g.inputs.items():
            v = env[n]
            if v.data_ptr() != buf.data_ptr():
                buf.copy_(v)
        lg.launch(g.exec, cur.cuda_stream)
        out = {n: t.clone() for n, t in g.outputs.items()}
        launched, g.launched = g.launched, True
    if launched:
        loopfuse._apply(ec.stats, g.delta, 1)
    out.update(g.host)
    env.update(out)
    return out
