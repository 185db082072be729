"""HOP DAG evaluation on torch tensors.

Port of systemml_tpu/compiler/lower.py, the subset that runs a DML
script eagerly: the `Evaluator` on its dense single-device branches
(lower.py:1102-2108 there), the builtins that the ported scripts reach,
`host_eval_scalar` and `_to_display_str`; the block analysis of
lower.py:41-200 there (`analyze_block`, which the whole-block compile of
runtime/blockcompile.py reads); and the loop analysis and region planner
of lower.py:483-960 there (`plan_loop_regions`, whose `LoopRegion`s
runtime/loopfuse.py executes as CUDA graphs). What waits, each raising
NotImplementedError that names its ROADMAP item:

- MESH dispatch and collectives (distributed and elastic), among them
  sequence-parallel attention and the mesh branches of compressed and
  sparse operands and of the quaternary ops.

The DNN builtins (conv2d and its backwards, the pools and theirs,
bias_add, bias_multiply, lstm, batch_norm2d, and the layout pass's
internal __from_nhwc) lower to ops/dnn.py as lower.py:2730-2935 there
lower them, the nhwc flags of hops/layout.py included; `attention` to
parallel/ring.attention on one device.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from systemml_tpu_torch.compress import is_compressed
from systemml_tpu_torch.hops.builder import BlockHops, DMLValidationError
from systemml_tpu_torch.hops.hop import Hop, postorder
from systemml_tpu_torch.runtime.bufferpool import CacheableMatrix

# --------------------------------------------------------------------------
# loop-region planning (systemml_tpu/compiler/lower.py:460-960): whole
# while/for nests planned as fused regions, which runtime/loopfuse.py runs
# as CUDA graphs. Copied with its imports re-pointed: a parfor inside a
# region refuses it, and loops in a parfor body are planned per task.
# --------------------------------------------------------------------------

# hop input positions that must be static (shape-determining)
_SHAPE_POSITIONS: Dict[str, Tuple[int, ...]] = {
    "idx": (1, 2, 3, 4),
    "lidx": (2, 3, 4, 5),
}
_SHAPE_CALLS = {
    "call:matrix", "call:rand", "call:seq", "call:table", "call:rexpand",
    "call:outer",
}

# --------------------------------------------------------------------------
# whole-block analysis (systemml_tpu/compiler/lower.py:41-200), copied as
# it is: which of a block's writes the block compile
# (runtime/blockcompile.py) plans, which names are static (they size
# something), and what replays on the host. In the port nothing traces:
# the whole block runs through its keyed plan, sinks and host writes
# included, and the analysis decides the eager blocks (`jittable`) and
# the blocks a CUDA graph cannot hold (a host op, a host write).
# --------------------------------------------------------------------------

# ops that can never be traced (host IO, data-dependent shapes, side effects)
EAGER_ONLY_OPS = {
    "call:read", "call:write", "call:print", "call:stop", "call:assert",
    "call:removeEmpty", "call:toString", "call:order", "call:sample",
    "call:list", "call:listidx", "fcall", "call:exists", "exists_var",
    "call:time",
    "call:transformencode", "call:transformapply", "call:transformdecode",
    "call:transformcolmap", "call:eval",
    "call:compress", "call:decompress",
    "call:checkpoint", "call:restore", "call:checkpointExists",
    "call:interQuantile", "call:transformmeta",
}


def analyze_block(blk: BlockHops, fcall_ok=None,
                  host_names=frozenset()) -> "BlockAnalysis":
    """Partition a block into its planned writes and what replays on the
    host (strings, host IO, removeEmpty, ...). `prefetch` holds the
    maximal planned subtrees under the host part."""
    static: Set[str] = set()

    traceable_memo: Dict[int, bool] = {}

    def traceable(h: Hop) -> bool:
        if h.id in traceable_memo:
            return traceable_memo[h.id]
        if h.op == "tread" and h.name in host_names:
            traceable_memo[h.id] = False
            return False
        op_ok = h.op not in EAGER_ONLY_OPS
        if h.op == "fcall" and fcall_ok is not None:
            op_ok = fcall_ok(h)
        # scalar-only list literals (the conv2d-family shape lists)
        scalar_list = (h.op in ("call:list", "elist")
                       and all(c.dt == "scalar" for c in h.inputs))
        if scalar_list:
            op_ok = True
        is_str_lit = h.op == "lit" and isinstance(h.value, str)
        ok = (op_ok and (h.dt != "string" or is_str_lit)
              and h.dt != "frame" and (h.dt != "list" or scalar_list)
              and all(traceable(c) for c in h.inputs))
        traceable_memo[h.id] = ok
        return ok

    # restore(path) rebinds symbol-table names as a side effect: the
    # whole block runs eagerly (sinks execute before writes there)
    all_roots = list(blk.writes.values()) + list(blk.sinks)
    if any(h.op == "call:restore" for h in postorder(all_roots)):
        return BlockAnalysis(False, static, [], set(blk.reads), [],
                             sorted(blk.writes))

    # program order: the order rand() draws consume the seed stream
    fused_writes = [n for n, h in blk.writes.items()
                    if traceable(h) and h.dt != "string"
                    and not (h.op == "lit" and isinstance(h.value, str))]
    host_writes = [n for n in blk.writes if n not in set(fused_writes)]

    prefetch: List[Hop] = []
    seen_pf: Set[int] = set()

    def collect(h: Hop):
        if traceable(h):
            if h.op not in ("lit", "tread") and h.id not in seen_pf:
                seen_pf.add(h.id)
                prefetch.append(h)
            return
        if h.op == "b(*)" and len(h.inputs) == 2:
            # sampled-product candidate: W * (A %*% B) with an untraceable
            # W (a sparse mask): the factors, not the product
            for i, c in enumerate(h.inputs):
                o = h.inputs[1 - i]
                if c.op == "ba+*" and traceable(c) and not traceable(o):
                    for cc in c.inputs:
                        collect(cc)
                    collect(o)
                    return
        for c in h.inputs:
            collect(c)

    for s in blk.sinks:
        collect(s)
    for n in host_writes:
        collect(blk.writes[n])

    fused_roots = [blk.writes[n] for n in fused_writes] + prefetch
    order = postorder(fused_roots)
    jittable = bool(fused_roots)

    def mark_static(h: Hop):
        for x in postorder([h]):
            if x.op == "tread":
                static.add(x.name)

    for h in order:
        pos = _SHAPE_POSITIONS.get(h.op)
        if pos:
            for i in pos:
                mark_static(h.inputs[i])
        elif h.op in _SHAPE_CALLS:
            for c in h.inputs:
                mark_static(c)
        elif h.op.startswith("call:"):
            # every scalar arg of a generic builtin may size something
            for c in h.inputs:
                if c.dt != "matrix":
                    mark_static(c)
    fused_reads = {h.name for h in order if h.op == "tread"}
    host_read_names: Set[str] = set()
    for s in list(blk.sinks) + [blk.writes[n] for n in host_writes]:
        for x in postorder([s]):
            if x.op == "tread":
                host_read_names.add(x.name)
    return BlockAnalysis(jittable, static, prefetch, fused_reads,
                         fused_writes, host_writes, host_read_names)


class BlockAnalysis:
    __slots__ = ("jittable", "static_scalars", "prefetch", "fused_reads",
                 "fused_writes", "host_writes", "host_read_names")

    def __init__(self, jittable, static_scalars, prefetch, fused_reads,
                 fused_writes, host_writes, host_read_names=frozenset()):
        self.jittable = jittable
        self.static_scalars = static_scalars
        self.prefetch = prefetch
        self.fused_reads = fused_reads
        self.fused_writes = fused_writes
        self.host_writes = host_writes
        self.host_read_names = host_read_names


class NotLoopFusable(Exception):
    """A loop body cannot run as a region (impure fcalls, side-effect
    sinks, host-only ops). Raised by the planner, which records it as the
    region's refusal (the loop then runs eagerly), and by the region
    executor inside a capture, where it is an error (runtime/loopfuse.py
    refuses before any capture)."""


def _live_after(loop) -> Set[str]:
    la = getattr(loop, "live_after", None)
    return set(la) if la else set()


def _unit_rw(b) -> Tuple[Set[str], Set[str], Set[str]]:
    """(external reads, writes, kills) of ONE ProgramBlock, recursing into
    nested If/While/For bodies. "External reads" = names whose value flows
    in from before the block (read-before-write in program order)."""
    from systemml_tpu_torch.runtime import program as P

    if isinstance(b, P.BasicBlock):
        for s in b.hops.sinks:
            # print() plans as in the JAX package (whose trace lowers it to
            # jax.debug.print; the port's region writes it to a print ring
            # on the device); any other side effect (write/stop/assert)
            # keeps the loop on the host
            if s.op != "call:print":
                raise NotLoopFusable(f"side-effect sink {s.op}")
        for h in postorder(b.hops.roots()):
            # only PURE function calls may execute during the loop trace
            # (an impure one would fire its side effects once at compile
            # time instead of once per iteration)
            if h.op == "fcall" and not b.program.fn_is_pure(
                    b.file_id, h.params.get("namespace"),
                    h.params.get("name")):
                raise NotLoopFusable(
                    f"impure fcall {h.params.get('namespace')}::"
                    f"{h.params.get('name')}")
        # blk.writes holds the whole end-of-block env, including pure
        # reads (identity treads). Those are NOT writes: counting them
        # would carry every invariant (X, batch_size, ...) through the
        # loop state as tracers — no invariant would ever stay static.
        writes = {n for n, h in b.hops.writes.items()
                  if not (h.op == "tread" and h.name == n)}
        return set(b.hops.reads), writes, set(b.kill_after)
    if isinstance(b, P.ParForBlock):
        raise NotLoopFusable("parfor body: host task orchestration")
    if isinstance(b, P.IfBlock):
        pr = set(b.pred.block.hops.reads)
        ir, iw = _collect_rw(b.if_body)
        er, ew = _collect_rw(b.else_body)
        return pr | ir | er, iw | ew, set()
    if isinstance(b, P.WhileBlock):
        pr = set(b.pred.block.hops.reads)
        br, bw = _collect_rw(b.body,
                             keep=pr | _live_after(b))
        # names both read and written by the body are read from OUTSIDE on
        # iteration 1 only if read-before-write within a pass — which is
        # exactly what _collect_rw's sequential accumulation computes
        return pr | br, bw, set()
    if isinstance(b, P.ForBlock):
        pr: Set[str] = set()
        for p in (b.from_h, b.to_h, b.incr_h):
            if p is not None:
                pr |= set(p.block.hops.reads)
        br, bw = _collect_rw(b.body, keep=_live_after(b))
        # the loop variable is supplied by the loop itself, never an
        # external read; after the loop it holds the last value (a write)
        return pr | (br - {b.var}), bw | {b.var}, set()
    raise NotLoopFusable(f"unknown block type {type(b).__name__}")


def _collect_rw_seq(blocks) -> Tuple[Set[str], Set[str], Set[str]]:
    """Raw (reads, writes, killed) of a body of ProgramBlocks. Kills are
    POSITIONAL: a block's kill_after marks the death of the value read
    there, so a LATER block re-writing the same name resurrects it — the
    final write is live at body end (`x = 10; ...; x = 20` split across
    blocks by nested control flow, or CG's read-then-rewrite `rr`)."""
    reads: Set[str] = set()
    writes: Set[str] = set()
    killed: Set[str] = set()
    for b in blocks:
        r, w, k = _unit_rw(b)
        reads |= (r - writes)  # read-before-write across blocks
        writes |= w
        killed -= w            # later write resurrects a killed name
        killed |= k
    return reads, writes, killed


def _collect_rw(blocks, keep=frozenset()) -> Tuple[Set[str], Set[str]]:
    """(reads, writes) of a loop/branch body. Body-local temporaries the
    liveness pass kills (rmvar) never cross an iteration boundary — they
    are dropped from the carried writes — EXCEPT names the kill does not
    actually retire: a name read by block 1 may be killed there (its read
    value dies) yet RE-WRITTEN by a later block and read again around the
    back edge (CG's `rr0 = rr` ... inner loop ... `rr = ...` pattern).
    Subtracting those produced a fused loop whose update was silently
    discarded, so the exclusion is limited to names that are neither
    externally read (back-edge consumers) nor in `keep` (predicate reads
    + loop.live_after)."""
    reads, writes, killed = _collect_rw_seq(blocks)
    return reads, writes - (killed - (reads | set(keep)))


def _dead_string_accumulators(body, pred_reads, live_after) -> Set[str]:
    """Write-only STRING accumulators whose value nothing observes:
    GLM-style per-iteration log builders (`log_str = log_str + "OBJ," +
    iter + "\\n"`, reference scripts/algorithms/GLM.dml's $Log output)
    read only by their own redefinition, with the consuming write()
    branch pruned because $Log is unbound. Strings cannot trace, so an
    observed accumulator keeps the loop on host — but an UNOBSERVED one
    (not live after the loop, not read by any predicate/sink/other
    write, transitively) can simply be dropped from the fused loop; the
    reference analog is dead-store removal after branch pruning
    (RewriteRemoveUnnecessaryBranches + unused-assignment cleanup)."""
    from systemml_tpu_torch.runtime import program as P

    string_writes: Set[str] = set()
    readers: Dict[str, Set[str]] = {}   # name -> write-names reading it
    observed: Set[str] = set(live_after) | set(pred_reads)
    memo: Dict[int, frozenset] = {}     # hop id -> the names it reads

    def tread_names(h) -> frozenset:
        got = memo.get(h.id)
        if got is None:
            acc = {h.name} if h.op == "tread" else set()
            for c in h.inputs:
                acc |= tread_names(c)
            got = memo[h.id] = frozenset(acc)
        return got

    def scan_basic(b):
        for n, h in b.hops.writes.items():
            if h.op == "tread" and h.name == n:
                continue
            if h.dt == "string" or (h.op == "lit"
                                    and isinstance(h.value, str)):
                string_writes.add(n)
            for name in tread_names(h):
                readers.setdefault(name, set()).add(n)
        for s in b.hops.sinks:
            observed.update(tread_names(s))

    def walk(bs):
        for b in bs:
            if isinstance(b, P.BasicBlock):
                scan_basic(b)
            elif isinstance(b, P.IfBlock):
                observed.update(b.pred.block.hops.reads)
                walk(b.if_body)
                walk(b.else_body)
            elif isinstance(b, (P.WhileBlock, P.ForBlock)):
                for p in (getattr(b, "pred", None),
                          getattr(b, "from_h", None),
                          getattr(b, "to_h", None),
                          getattr(b, "incr_h", None)):
                    if p is not None:
                        observed.update(p.block.hops.reads)
                walk(b.body)

    walk(body)
    changed = True
    while changed:
        changed = False
        for n, rd in readers.items():
            if n not in observed and any(u in observed and u != n
                                         for u in rd):
                observed.add(n)
                changed = True
    return {n for n in string_writes if n not in observed}


# the inputs of a shape call that size its output, by argument name and
# position, where not all of them do: rexpand's target, table's vectors
# and weights, a matrix()'s data, outer()'s vectors and rand()'s bounds,
# sparsity and seed are values
_SIZING_ARGS: Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...]]] = {
    "call:rexpand": (("max",), ()),
    "call:matrix": (("rows", "cols"), (1, 2)),
    "call:outer": ((), ()),
    "call:rand": (("rows", "cols"), (0, 1)),
}


def _sizing_inputs(h: Hop) -> List[Hop]:
    """The inputs of shape call `h` whose values size its output."""
    if h.op == "call:table":
        argn = h.params.get("argnames") or [None] * len(h.inputs)
        pos = [c for n, c in zip(argn, h.inputs) if n is None]
        named = [c for n, c in zip(argn, h.inputs)
                 if n in ("odim1", "odim2")]
        return named + (pos[2:] if len(pos) == 4 else pos[3:])
    if h.op not in _SIZING_ARGS:
        return list(h.inputs)
    names, positions = _SIZING_ARGS[h.op]
    argn = h.params.get("argnames") or [None] * len(h.inputs)
    out, i = [], 0
    for n, c in zip(argn, h.inputs):
        if n is None:
            if i in positions:
                out.append(c)
            i += 1
        elif n in names:
            out.append(c)
    return out


def _static_shape_names(blocks, sizing_only: bool = False) -> Set[str]:
    """Names whose values SIZE something in the loop body (matrix()/rand()
    dims, rexpand max, table dims, conv2d shape lists): these must enter
    the fused plan as host constants — XLA shapes are static — even when
    they live on device as 0-d floats (MultiLogReg's `k = max(Y_vec)`
    sizing `matrix(0, cols=k)`). The fused-plan analog of analyze_block's
    static marking above and the reference's size-expression literal
    replacement (hops/recompile/LiteralReplacement.java).

    Slice bounds (idx) are deliberately NOT marked: the Evaluator lowers
    tracer bounds to lax.dynamic_slice — the minibatch pattern.

    `sizing_only` marks only the inputs that size a shape call's output
    (_sizing_inputs): the names a loop region must not write, where the
    planner's set (the JAX package's) also holds value inputs, such as
    the cluster ids Kmeans expands with rexpand(target=assign, max=k)."""
    from systemml_tpu_torch.runtime import program as P

    names: Set[str] = set()

    def mark(h):
        if sizing_only:
            # a name read only through nrow/ncol/length sizes nothing a
            # region could change: the region keeps every carried shape
            # (the conv layers' N = nrow(X), F = nrow(W) in their
            # [N, C, H, W] lists)
            stack, seen = [h], set()
            while stack:
                x = stack.pop()
                if x.id in seen:
                    continue
                seen.add(x.id)
                if x.op == "tread":
                    names.add(x.name)
                elif x.op not in ("nrow", "ncol", "length"):
                    stack.extend(x.inputs)
            return
        for x in postorder([h]):
            if x.op == "tread":
                names.add(x.name)

    def scan(roots):
        for h in postorder(roots):
            if h.op in _SHAPE_CALLS:
                # no dt filter: treads default to dt="matrix" even for
                # scalars (m = ncol(X)); marking a true matrix name is
                # harmless — _env_of consults the set only for scalars
                for c in (_sizing_inputs(h) if sizing_only else h.inputs):
                    mark(c)
            elif h.op.startswith("call:"):
                # conv2d-family [N,C,H,W] scalar shape lists
                for c in h.inputs:
                    if c.op in ("call:list", "elist") and all(
                            x.dt == "scalar" for x in c.inputs):
                        mark(c)

    def walk(bs):
        for b in bs:
            if isinstance(b, P.BasicBlock):
                scan(b.hops.roots())
            elif isinstance(b, P.IfBlock):
                scan(b.pred.block.hops.roots())
                walk(b.if_body)
                walk(b.else_body)
            elif isinstance(b, (P.WhileBlock, P.ForBlock)):
                for pred in [getattr(b, "pred", None),
                             getattr(b, "from_h", None),
                             getattr(b, "to_h", None),
                             getattr(b, "incr_h", None)]:
                    if pred is not None:
                        scan(pred.block.hops.roots())
                walk(b.body)

    walk(blocks)
    return names


def _value_safe_scalar_names(loop, kind: str) -> Set[str]:
    """Names read by the loop nest whose EVERY use is a value position —
    cellwise/aggregate arithmetic, comparisons, the device-lowered
    while predicate — and therefore safe to pass as TRACED scalar
    arguments. Int invariants in this set no longer bake their VALUES
    into the compiled-region cache key, so a shape-compatible re-entry
    with a different `maxiter`/`epochs` reuses the executable instead
    of recompiling the whole nest (a cache keyed on exact invariant
    signatures would recompile).

    The inverse is what gets computed: a HAZARD set of names reaching
    any position that must be host-concrete at trace time — shape-call
    inputs (matrix/rand/seq/... dims and seeds), indexing bounds
    (static-extent affine analysis needs concrete offsets), any
    call:*/fcall argument, if-block predicates (the trace-time-constant
    predicate optimization evaluates them host-side), and inner
    for-loop bounds (host-known trip counts). Everything read but
    never hazarded is value-safe."""
    from systemml_tpu_torch.runtime import program as P

    hazard: Set[str] = set()
    reads: Set[str] = set()

    def mark(h):
        for x in postorder([h]):
            if x.op == "tread":
                hazard.add(x.name)

    def scan(roots):
        for h in postorder(roots):
            if h.op == "tread":
                reads.add(h.name)
            if (h.op in _SHAPE_CALLS or h.op.startswith("call:")
                    or h.op == "fcall"):
                for c in h.inputs:
                    mark(c)
            elif h.op in _SHAPE_POSITIONS:
                for i in _SHAPE_POSITIONS[h.op]:
                    if i < len(h.inputs):
                        mark(h.inputs[i])

    def walk(bs):
        for b in bs:
            if isinstance(b, P.BasicBlock):
                scan(b.hops.roots())
            elif isinstance(b, P.IfBlock):
                for r in b.pred.block.hops.roots():
                    mark(r)
                walk(b.if_body)
                walk(b.else_body)
            elif isinstance(b, P.WhileBlock):
                # inner while predicates lower into the device carried
                # state (value position)
                scan(b.pred.block.hops.roots())
                walk(b.body)
            elif isinstance(b, P.ForBlock):
                for p in (b.from_h, b.to_h, b.incr_h):
                    if p is not None:
                        for r in p.block.hops.roots():
                            mark(r)
                walk(b.body)

    if kind == "while":
        # the OUTER predicate compares against carried state on device
        scan(loop.pred.block.hops.roots())
    walk(loop.body)
    return reads - hazard


class LoopRegion:
    """Compile-time plan for one fused-loop region (a whole while/for
    nest). Emitted by `plan_loop_regions`, consumed by the runtime
    executor (runtime/loopfuse.FusedLoop) and the per-region
    observability view (obs.dispatch_stats `loop_regions`).

    `donation` classifies each carried name by LIVENESS: "dead" names
    are not read after the loop, so their buffers can always be aliased
    into the loop output once the runtime alias check clears; "live"
    names outlive the region and additionally key the caller-visible
    result. Shared/caller-owned leaves are still host-copied exactly
    once at region entry (loopfuse._donation_plan) — the plan only
    removes the per-entry re-derivation."""

    __slots__ = ("kind", "label", "carried", "reads", "pred_reads",
                 "drop", "static_names", "traced_ints", "pred_mode",
                 "depth", "inner_loops", "donation", "refused", "inlined",
                 "lifetime")

    def __init__(self, kind: str, label: str, carried=(), reads=frozenset(),
                 pred_reads=frozenset(), drop=frozenset(),
                 static_names=frozenset(), pred_mode: str = "device",
                 depth: int = 1, inner_loops: int = 0, donation=None,
                 refused: Optional[str] = None, inlined: bool = False,
                 traced_ints=frozenset()):
        self.kind = kind
        self.label = label
        self.carried = tuple(carried)
        self.reads = frozenset(reads)
        self.pred_reads = frozenset(pred_reads)
        self.drop = frozenset(drop)
        self.static_names = frozenset(static_names)
        # int invariants safe to pass TRACED (value positions only):
        # their values stay out of the executable cache key, so
        # shape-compatible re-entries reuse the compiled region
        self.traced_ints = frozenset(traced_ints)
        # "device": data-dependent predicate lowered into the
        # lax.while_loop cond — the convergence check lives in the
        # carried state, zero host syncs per iteration. "host-trip":
        # for-loops evaluate their (host-known) bounds once at entry;
        # the trip count is static inside the region.
        self.pred_mode = pred_mode
        self.depth = depth              # nest depth (1 = no inner loops)
        self.inner_loops = inner_loops  # count of loops lowered inside
        self.donation = dict(donation or {})
        self.refused = refused          # None, or the classified reason
        self.inlined = inlined          # nested inside a parent region
        # per-leaf LeafVerdicts attached by the buffer-lifetime pass
        # (analysis/lifetime.analyze_program); None when the pass has
        # not run — the runtime verdict API then refines from scratch
        self.lifetime = None

    def __repr__(self):
        state = f"refused: {self.refused}" if self.refused else \
            f"carried={len(self.carried)} depth={self.depth}"
        return f"<LoopRegion {self.label} {state}>"


def _nest_shape(blocks) -> Tuple[int, int]:
    """(max loop-nest depth below `blocks`, total inner loop count)."""
    from systemml_tpu_torch.runtime import program as P

    depth = 0
    count = 0
    for b in blocks:
        if isinstance(b, P.IfBlock):
            d, c = _nest_shape(b.if_body)
            d2, c2 = _nest_shape(b.else_body)
            depth = max(depth, d, d2)
            count += c + c2
        elif isinstance(b, (P.WhileBlock, P.ForBlock)):
            d, c = _nest_shape(b.body)
            depth = max(depth, 1 + d)
            count += 1 + c
    return depth, count


def _plan_one_region(loop, kind: str, idx: int = 0) -> LoopRegion:
    """Analyze one outermost loop into a LoopRegion (refused regions keep
    the classified reason instead of carrying analysis results). `idx`
    is the region's stable position in the planner's walk order — part
    of the label so two sibling loops carrying the same leading names
    (twin CG loops) never merge in the per-region stats views."""
    if kind == "while":
        pred_reads = set(loop.pred.block.hops.reads)
        keep = pred_reads
        pred_mode = "device"
    else:
        pred_reads = set()
        for p in (loop.from_h, loop.to_h, loop.incr_h):
            if p is not None:
                pred_reads |= set(p.block.hops.reads)
        keep = set()   # matches FusedLoop.run_for's _loop_rw(set())
        pred_mode = "host-trip"
    la = _live_after(loop)
    depth, inner = _nest_shape(loop.body)
    try:
        reads, writes = _collect_rw(loop.body, keep=keep | la)
        drop = _dead_string_accumulators(loop.body, keep, la)
        statics = _static_shape_names(loop.body)
        traced_ints = _value_safe_scalar_names(loop, kind) - writes
    except NotLoopFusable as e:
        label = f"{kind}[?]@{idx}"
        return LoopRegion(kind, label, pred_reads=pred_reads,
                          pred_mode=pred_mode, depth=1 + depth,
                          inner_loops=inner,
                          refused=str(e) or "unfusable body")
    reads -= drop
    writes -= drop
    carried = tuple(sorted(writes))
    label = "{}[{}{}]@{}".format(kind, ",".join(carried[:3]),
                                 ",..." if len(carried) > 3 else "", idx)
    # liveness classification CONSUMED from the lifetime pass (the
    # single home of dead-after-dispatch reasoning) — the planner does
    # not derive it locally
    from systemml_tpu_torch.analysis.lifetime import classify_region_carried

    donation = classify_region_carried(carried, la)
    return LoopRegion(kind, label, carried=carried, reads=reads,
                      pred_reads=pred_reads, drop=drop,
                      static_names=statics, pred_mode=pred_mode,
                      depth=1 + depth, inner_loops=inner,
                      donation=donation, traced_ints=traced_ints)


def plan_loop_regions(program) -> List[LoopRegion]:
    """Walk a compiled program and attach a LoopRegion plan to every
    while/for block: OUTERMOST loops become fused regions (their nests
    lower inside the region's single trace); loops under a refused
    region — or under a parfor, whose tasks run host-side — are planned
    as their own smaller regions, so the runtime still fuses whatever
    the refusal left standing. Returns all emitted regions (inlined
    markers included) — compile_program calls this LAST, after
    rewrites, layout propagation and liveness, so the plans see the
    final hop graphs."""
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.runtime import program as P

    regions: List[LoopRegion] = []

    def mark_inlined(blocks, parent: LoopRegion):
        for b in blocks:
            if isinstance(b, P.IfBlock):
                mark_inlined(b.if_body, parent)
                mark_inlined(b.else_body, parent)
            elif isinstance(b, P.ParForBlock):
                mark_inlined(b.body, parent)
            elif isinstance(b, (P.WhileBlock, P.ForBlock)):
                kind = "while" if isinstance(b, P.WhileBlock) else "for"
                b._region = LoopRegion(
                    kind, f"{parent.label}>{kind}", inlined=True)
                b._region_parent = parent
                mark_inlined(b.body, parent)

    def plan_loop(b):
        kind = "while" if isinstance(b, P.WhileBlock) else "for"
        region = _plan_one_region(b, kind, idx=len(regions))
        b._region = region
        regions.append(region)
        if obs.recording():
            obs.instant("region_plan", obs.CAT_COMPILE, label=region.label,
                        kind=kind, carried=len(region.carried),
                        depth=region.depth, inner_loops=region.inner_loops,
                        pred_mode=region.pred_mode,
                        refused=region.refused)
        if region.refused is not None:
            # the nest cannot fuse as a unit: inner loops still get their
            # own (smaller) regions — per-iteration fusion beats none
            walk(b.body)
        else:
            mark_inlined(b.body, region)

    def walk(blocks):
        for b in blocks:
            if isinstance(b, P.IfBlock):
                walk(b.if_body)
                walk(b.else_body)
            elif isinstance(b, P.ParForBlock):
                # task bodies execute through the normal block machinery
                # in worker contexts: nested loops there fuse per task
                walk(b.body)
            elif isinstance(b, (P.WhileBlock, P.ForBlock)):
                plan_loop(b)

    walk(program.blocks)
    for fb in program.functions.values():
        walk(fb.blocks)
    return regions


# --------------------------------------------------------------------------
# inside a fused loop region (runtime/loopfuse.py): the region's run is
# installed here while its body runs (its first iteration, the plain arm,
# or the capture of its CUDA graph), and the Evaluator keeps scalars on
# the device: as.scalar gives a 0-d tensor, DML's int and boolean scalar
# semantics hold on 0-d int64 and bool tensors, and a host read of a
# device value is reported to the run (a classified refusal before a
# capture, an error inside one). Outside a region nothing changes.
# --------------------------------------------------------------------------

_REGION: contextvars.ContextVar = contextvars.ContextVar(
    "smtorch_loop_region", default=None)


def current_region():
    """The RegionRun (runtime/loopfuse.py) whose body is running, or None."""
    return _REGION.get()


@contextlib.contextmanager
def region_scope(run):
    tok = _REGION.set(run)
    try:
        yield run
    finally:
        _REGION.reset(tok)


def region_refuse(reason: str) -> None:
    """An op that a captured region could not run, met in a region's
    first iteration: the region is refused with `reason` before any
    capture (RegionRun.fault); outside a region, nothing."""
    run = _REGION.get()
    if run is not None:
        run.fault(reason)


def _host_read(v, what: str):
    """v.item(): a synchronisation, which a captured region cannot make."""
    run = _REGION.get()
    if run is not None:
        run.note_sync(what)
    return v.item()


def _is_int_scalar(v) -> bool:
    return (isinstance(v, torch.Tensor) and v.ndim == 0
            and not v.is_floating_point() and not v.is_complex())


def _is_scalar_value(v) -> bool:
    return isinstance(v, (bool, int, float, np.generic)) or (
        isinstance(v, torch.Tensor) and v.ndim == 0)


def _region_binary(o: str, a, b):
    """A binary op of two scalars of which one is a 0-d int64 or bool
    tensor (a carried DML int or boolean inside a region), with DML's
    scalar semantics as the host path (hops/rewrite._apply_scalar_binary)
    has them: int op int stays int for + - * ^ %% %/% min max, a
    comparison or a logical op gives a boolean, and / or a double operand
    gives a double (the value dtype). None when the torch path already
    agrees (no int tensor among the operands, or a floating one)."""
    from systemml_tpu_torch.ops import cellwise
    from systemml_tpu_torch.utils.config import default_dtype

    if not (_is_scalar_value(a) and _is_scalar_value(b)):
        return None
    ts = [v for v in (a, b) if isinstance(v, torch.Tensor)]
    if not any(_is_int_scalar(v) for v in ts) or any(
            v.is_floating_point() for v in ts):
        return None
    dev = ts[0].device
    ints = all(isinstance(v, torch.Tensor) or isinstance(
        v, (bool, int, np.integer)) for v in (a, b))

    def as_t(v, dtype):
        if isinstance(v, torch.Tensor):
            return v.to(dtype)
        return torch.full((), v.item() if isinstance(v, np.generic) else v,
                          dtype=dtype, device=dev)

    if o in cellwise._REL:
        dt = torch.int64 if ints else default_dtype()
        return cellwise._REL[o](as_t(a, dt), as_t(b, dt))
    if o in ("&", "|", "xor"):
        fn = {"&": torch.logical_and, "|": torch.logical_or,
              "xor": torch.logical_xor}[o]
        return fn(as_t(a, torch.bool), as_t(b, torch.bool))
    if ints and o in ("+", "-", "*", "^", "min", "max"):
        x, y = as_t(a, torch.int64), as_t(b, torch.int64)
        if o in ("min", "max"):
            return (torch.minimum if o == "min" else torch.maximum)(x, y)
        return cellwise._ARITH[o](x, y)
    if ints and o in ("%%", "%/%"):
        x, y = as_t(a, torch.int64), as_t(b, torch.int64)
        return torch.remainder(x, y) if o == "%%" else torch.div(
            x, y, rounding_mode="floor")
    dt = default_dtype()
    return cellwise.binary_op(o, as_t(a, dt), as_t(b, dt))


def _region_unary(o: str, x):
    """A unary op of a 0-d int64 or bool tensor inside a region, as the
    host path: - and abs stay int, ! gives a boolean, the rest a double."""
    from systemml_tpu_torch.ops import cellwise
    from systemml_tpu_torch.utils.config import default_dtype

    if o == "!":
        return x == 0
    if o in ("-", "abs"):
        x = x.to(torch.int64)
        return -x if o == "-" else torch.abs(x)
    return cellwise.unary_op(o, x.to(default_dtype()))


# --------------------------------------------------------------------------
# host scalar evaluation
# --------------------------------------------------------------------------


class _NotHostEvaluable(Exception):
    pass


_HOST_UNARY_MATH = {
    "abs": abs, "sign": lambda x: (x > 0) - (x < 0),
}


def host_eval_scalar(h: "Hop", env: Dict[str, Any]):
    """Evaluate a scalar hop cone entirely on the host: literals, host
    scalars, matrix shape queries (no data touch) and scalar arithmetic.
    Raises _NotHostEvaluable when any node needs device data (a 0-d
    tensor counts as device data: reading it is a synchronisation)."""
    from systemml_tpu_torch.hops.rewrite import _apply_scalar_binary

    def as_host(v):
        if isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, np.generic):
            return v.item()
        raise _NotHostEvaluable()

    def shape_of(x: "Hop"):
        if x.op != "tread" or x.name not in env:
            raise _NotHostEvaluable()
        shp = getattr(env[x.name], "shape", None)
        if shp is None:
            raise _NotHostEvaluable()
        return tuple(shp)

    def rec(h: "Hop"):
        op = h.op
        if op == "lit":
            return as_host(h.value)
        if op == "tread":
            if h.name not in env:
                raise _NotHostEvaluable()
            return as_host(env[h.name])
        if op == "twrite":
            return rec(h.inputs[0])
        if op == "nrow":
            return int(shape_of(h.inputs[0])[0])
        if op == "ncol":
            shp = shape_of(h.inputs[0])
            return int(shp[1]) if len(shp) > 1 else 1
        if op == "length":
            return int(np.prod(shape_of(h.inputs[0]), dtype=np.int64))
        if op.startswith("b(") and len(h.inputs) == 2:
            a, b = rec(h.inputs[0]), rec(h.inputs[1])
            o = h.params.get("op", op[2:-1])
            if o == "+" and (isinstance(a, str) or isinstance(b, str)):
                return _to_display_str(a) + _to_display_str(b)
            try:
                return _apply_scalar_binary(o, a, b)
            except (ValueError, TypeError):
                raise _NotHostEvaluable() from None
        if op.startswith("u(") and len(h.inputs) == 1:
            x = rec(h.inputs[0])
            o = h.params.get("op", op[2:-1])
            if isinstance(x, str):
                raise _NotHostEvaluable()
            if o == "-":
                return -x
            if o == "!":
                return not bool(x)
            if o in ("floor", "ceil", "ceiling"):
                f = math.floor if o == "floor" else math.ceil
                return float(f(x))
            if o == "round":
                # half-up, as the device path and the constant folder
                return float(math.floor(x + 0.5))
            if o in ("sqrt", "exp"):
                return float(getattr(math, o)(x))
            if o in _HOST_UNARY_MATH:
                return _HOST_UNARY_MATH[o](x)
            raise _NotHostEvaluable()
        if op.startswith("call:") and len(h.inputs) == 1 \
                and not (h.params.get("argnames") or [None])[0]:
            name = op[5:]
            x = rec(h.inputs[0])
            if name in ("as.scalar", "castAsScalar", "as.double"):
                return float(x) if not isinstance(x, str) else x
            if name == "as.integer":
                return int(float(x))
            if name == "as.logical":
                return bool(x)
            raise _NotHostEvaluable()
        raise _NotHostEvaluable()

    try:
        v = rec(h)
    except (ZeroDivisionError, OverflowError, ValueError, TypeError):
        # host math that traps where the device gives Inf/NaN (0.0^-1,
        # exp(1000), sqrt(-1)): leave it to the device path
        raise _NotHostEvaluable() from None
    if not isinstance(v, (bool, int, float, str)):
        raise _NotHostEvaluable()
    return v


def _mm_chain_order(p: List[int]) -> Dict[Tuple[int, int], int]:
    """Classic O(k^3) matrix-chain DP over dims p[0..k]; returns the split
    table (i, j) -> k minimizing scalar multiplications."""
    n = len(p) - 1
    cost: Dict[Tuple[int, int], float] = {(i, i): 0.0 for i in range(n)}
    split: Dict[Tuple[int, int], int] = {}
    for length in range(2, n + 1):
        for i in range(0, n - length + 1):
            j = i + length - 1
            best, bk = None, i
            for k in range(i, j):
                c = (cost[(i, k)] + cost[(k + 1, j)]
                     + float(p[i]) * p[k + 1] * p[j + 1])
                if best is None or c < best:
                    best, bk = c, k
            cost[(i, j)] = best
            split[(i, j)] = bk
    return split


def _chain_product(vals, split, i: int, j: int):
    """vals[i] @ ... @ vals[j] in the order of the split table."""
    from systemml_tpu_torch.ops import mult

    if i == j:
        return vals[i]
    k = split[(i, j)]
    return mult.matmult(_chain_product(vals, split, i, k),
                        _chain_product(vals, split, k + 1, j))


class Evaluator:
    """Evaluates a HOP DAG bottom-up with memoization.

    `env` maps variable names to raw values (torch tensors, python
    scalars, lists). `call_function` executes user-defined functions (the
    interpreter's callback), `printer` takes print() output. With
    `timing` and `stats`, each op's exclusive wall time goes to the
    heavy-hitter table; `stats.fine_grained` synchronises the device
    after each op so that the time is the op's, not its launch's.
    """

    def __init__(self, env: Dict[str, Any],
                 call_function: Optional[Callable] = None,
                 printer: Optional[Callable[[str], None]] = None,
                 stats=None, timing: bool = False,
                 skip_writes: bool = False):
        self.env = env
        # JMLC in-memory mode: write() does nothing (api/jmlc.py)
        self.skip_writes = skip_writes
        self.call_function = call_function
        self.printer = printer or (lambda s: print(s))
        self.stats = stats
        self._timing = timing and stats is not None
        self._tstack: List[float] = []
        self.cache: Dict[int, Any] = {}
        self._consumers: Dict[int, int] = {}
        self._parent_ops: Dict[int, Set[str]] = {}

    # ---- entry -----------------------------------------------------------

    def run(self, blk: BlockHops) -> Dict[str, Any]:
        self._count_consumers(blk.roots())
        for sink in blk.sinks:
            self.eval(sink)
        return {name: self.eval(h) for name, h in blk.writes.items()}

    def _count_consumers(self, roots):
        """Parent-edge counts per hop id: mm-chain reassociation may only
        flatten intermediates consumed by a single parent."""
        from systemml_tpu_torch.hops.hop import postorder

        self._consumers = {}
        self._parent_ops: Dict[int, Set[str]] = {}
        for h in postorder(roots):
            for c in h.inputs:
                self._consumers[c.id] = self._consumers.get(c.id, 0) + 1
                self._parent_ops.setdefault(c.id, set()).add(h.op)

    # ---- core ------------------------------------------------------------

    def eval(self, h: Hop):
        if h.id in self.cache:
            return self.cache[h.id]
        if not self._timing:
            v = self._eval(h)
            self.cache[h.id] = v
            return v
        # exclusive per-op time: children add their elapsed time to the
        # parent's accumulator, which the parent subtracts
        t0 = time.perf_counter()
        self._tstack.append(0.0)
        v = self._eval(h)
        if self.stats.fine_grained and isinstance(v, torch.Tensor) \
                and v.device.type == "cuda" and _REGION.get() is None:
            torch.cuda.synchronize(v.device)
        child_t = self._tstack.pop()
        elapsed = time.perf_counter() - t0
        if self._tstack:
            self._tstack[-1] += elapsed
        if h.op not in ("lit", "tread", "twrite", "fcall"):
            self.stats.time_op(h.op, max(0.0, elapsed - child_t))
        self.cache[h.id] = v
        return v

    def _eval(self, h: Hop):
        from systemml_tpu_torch.ops import agg, cellwise, mult, reorg

        op = h.op
        if op == "lit":
            return h.value
        if op == "exists_var":
            return h.params["name"] in self.env
        if op == "clarg_unbound":
            raise DMLValidationError(
                f"command-line parameter ${h.params['name']} is not bound "
                f"(use ifdef(${h.params['name']}, default))")
        if op == "tread":
            if h.name not in self.env:
                raise DMLValidationError(f"undefined variable {h.name!r}")
            v = self.env[h.name]
            if isinstance(v, CacheableMatrix):
                # a plain copy of a VarMap holds the raw pool handles
                v = v.resolve()
            from systemml_tpu_torch.hops.hoist import FailedHoist

            if isinstance(v, FailedHoist):
                # speculative pre-loop hoist failed and the loop reads it:
                # raise the original error where the program would have
                raise v.exc
            return v
        if op == "twrite":
            return self.eval(h.inputs[0])
        if op == "ba+*":
            r = self._reassoc_matmult(h)
            if r is not None:
                return r
            r = self._compressed_t_matmult(h.inputs[0], h.inputs[1])
            if r is not None:
                return r
            return mult.matmult(self._m(h.inputs[0]), self._m(h.inputs[1]))
        if op == "tsmm":
            return mult.tsmm(self._m(h.inputs[0]), h.params.get("left", True))
        if op == "mmchain":
            from systemml_tpu_torch.runtime.sparse import ensure_dense

            xs = [self._m(c) for c in h.inputs]
            # the chain's vectors are dense operands by contract
            return mult.mmchain(xs[0], ensure_dense(xs[1]),
                                ensure_dense(xs[2]) if len(xs) > 2 else None,
                                h.params.get("ctype", "XtXv"))
        if op.startswith("q("):
            return self._quaternary(h)
        if op == "attention":
            from systemml_tpu_torch.parallel import ring

            q, k, v = (self._m(c) for c in h.inputs)
            # one device: the JAX package's sequence-parallel branch
            # (lower.py:1290-1315 there) needs a mesh
            return ring.attention(q, k, v,
                                  causal=bool(h.params.get("causal", False)))
        if op.startswith("b("):
            if op == "b(*)":
                r = self._try_sddmm(h)
                if r is not None:
                    return r
            a = self.eval(h.inputs[0])
            b = self.eval(h.inputs[1])
            o = h.params["op"]
            if o == "+" and (isinstance(a, str) or isinstance(b, str)):
                return _to_display_str(a) + _to_display_str(b)
            if isinstance(a, (int, float, bool, str, np.generic)) and \
                    isinstance(b, (int, float, bool, str, np.generic)):
                # host scalars: python semantics, no device work
                from systemml_tpu_torch.hops.rewrite import \
                    _apply_scalar_binary

                try:
                    return _apply_scalar_binary(o, a, b)
                except (ValueError, TypeError):
                    pass
            elif _REGION.get() is not None:
                r = _region_binary(o, a, b)
                if r is not None:
                    return r
            return cellwise.binary_op(o, a, b)
        if op.startswith("u("):
            x = self.eval(h.inputs[0])
            o = h.params["op"]
            if o == "-" and isinstance(x, (bool, int, float)):
                # booleans are 0/1 under arithmetic: -TRUE is -1
                return -int(x) if isinstance(x, bool) else -x
            if o == "!" and isinstance(x, (bool, int, float)):
                return not bool(x)
            if _is_int_scalar(x) and _REGION.get() is not None:
                return _region_unary(o, x)
            return cellwise.unary_op(o, x)
        if op.startswith("ua("):
            return agg.agg(h.params["aop"], self._m(h.inputs[0]),
                           h.params["dir"])
        if op.startswith("cum("):
            return agg.cumagg(h.params["op"], self._m(h.inputs[0]))
        if op == "reorg(t)":
            return reorg.transpose(self._m(h.inputs[0]))
        if op == "reorg(rev)":
            return reorg.rev(self._m(h.inputs[0]))
        if op == "reorg(diag)":
            return reorg.diag(self._m(h.inputs[0]))
        if op in ("nrow", "ncol", "length"):
            x = self.eval(h.inputs[0])
            from systemml_tpu_torch.runtime.data import (FrameObject,
                                                         ListObject)

            if isinstance(x, ListObject):
                return len(x)
            if isinstance(x, FrameObject):
                dims = (x.num_rows, x.num_cols)
            else:
                x = self._m(h.inputs[0])
                dims = (int(x.shape[0]), int(x.shape[1]))
            if op == "nrow":
                return dims[0]
            if op == "ncol":
                return dims[1]
            return dims[0] * dims[1]
        if op in ("cbind", "rbind"):
            from systemml_tpu_torch.runtime.data import FrameObject

            vals = [self.eval(c) for c in h.inputs]
            if any(isinstance(v, FrameObject) for v in vals):
                if not all(isinstance(v, FrameObject) for v in vals):
                    raise DMLValidationError(
                        f"{op}: cannot mix frame and matrix operands")
                out = vals[0]
                for v in vals[1:]:
                    out = (out.cbind(v) if op == "cbind" else out.rbind(v))
                return out
            vals = [self._m(c) for c in h.inputs]
            return (reorg.cbind(*vals) if op == "cbind"
                    else reorg.rbind(*vals))
        if op == "idx":
            return self._right_index(h)
        if op == "lidx":
            return self._left_index(h)
        if op == "elist":
            return [self.eval(c) for c in h.inputs]
        if op == "pick":
            v = self.eval(h.inputs[0])
            i = h.params["index"]
            if not isinstance(v, tuple):  # single-output call via [x] = f(...)
                if i == 0:
                    return v
                raise DMLValidationError("function returns a single value")
            return v[i]
        if op == "spoof":
            from systemml_tpu_torch.codegen.compiler import execute_spoof

            args = [self.eval(c) for c in h.inputs]
            return execute_spoof(h, args)
        if op == "fcall":
            args = [self.eval(c) for c in h.inputs]
            return self.call_function(
                h.params.get("namespace"), h.params["name"], args,
                h.params.get("argnames"), h.params.get("n_outputs", 1))
        if op.startswith("call:"):
            return self._builtin(h, op[5:])
        raise DMLValidationError(f"cannot evaluate hop {op!r}")

    def _quaternary(self, h: Hop):
        """Weighted quaternary hop execution, the JAX package's
        `_quaternary` (systemml_tpu/compiler/lower.py:1619-1647) without
        its mesh branch (_try_dist_quaternary, which waits for ROADMAP
        queue 1, distributed and elastic): the kernels of ops/mult.py take
        the dense-or-sampled decision."""
        from systemml_tpu_torch.ops import mult

        kind = h.op[2:-1]
        p = h.params
        x = self.eval(h.inputs[0])
        u = self._m(h.inputs[1])
        v = self._m(h.inputs[2])
        w = self.eval(h.inputs[3]) if len(h.inputs) > 3 else None
        if kind == "wsloss":
            return mult.wsloss(x, u, v, w, p.get("post", "NONE"))
        if kind == "wsigmoid":
            return mult.wsigmoid(x, u, v, p.get("flags", ""))
        if kind == "wdivmm":
            return mult.wdivmm(x, u, v, bool(p.get("left")),
                               bool(p.get("mult")), float(p.get("eps", 0.0)))
        if kind == "wcemm":
            return mult.wcemm(x, u, v, float(p.get("eps", 0.0)))
        return mult.wumm(x, u, v, op=p.get("op", "*"), uop=p.get("uop"))

    def _try_sddmm(self, h: Hop):
        """The value-aware SDDMM peephole on `b(*)`, as the JAX package's
        (systemml_tpu/compiler/lower.py:1709): when one side evaluates to a
        sparse or ELL matrix and the other is a matmult that only this op
        consumes and that is not evaluated yet, the product is sampled at
        the sparse side's stored cells (runtime/sparse.sddmm) and never
        formed: ALS's W * (A %*% t(B)). Value-aware, not a hop rewrite, so
        that the spoof outer template still sees the raw pattern when W is
        dense. Where the JAX package asks for a product with one consumer,
        the port takes one whose every consumer is a `b(*)`, and samples it
        for each: ALS-CG.dml's loss check reads L %*% t(R) twice (D = W *
        (L %*% t(R)) and WV * (L %*% t(R))), which would otherwise form the
        whole (users, movies) product (34 GB at the Netflix shape)."""
        from systemml_tpu_torch.runtime import sparse as sp

        for xi, pi in ((0, 1), (1, 0)):
            p = h.inputs[pi]
            if (p.op != "ba+*" or p.id in self.cache
                    or self._parent_ops.get(p.id, {"b(*)"}) != {"b(*)"}):
                continue
            x = self.eval(h.inputs[xi])
            if sp.is_ell(x) or sp.is_sparse(x):
                a = sp.ensure_dense(self.eval(p.inputs[0]))
                b = sp.ensure_dense(self.eval(p.inputs[1]))
                # a broadcast multiply (an (m, 1) mask times an (m, n)
                # product) is not a sample of the product
                if (getattr(a, "ndim", 0) != 2 or getattr(b, "ndim", 0) != 2
                        or tuple(x.shape) != (a.shape[0], b.shape[1])):
                    return None   # a and b are cached for the normal path
                if self.stats is not None:
                    self.stats.count_estim("sddmm")
                return sp.sddmm(x, a, b)
            # x is dense (evaluated and cached): try the other side
        return None

    def _reassoc_matmult(self, h: Hop):
        """Matrix-mult-chain reassociation with exact shapes (reference:
        RewriteMatrixMultChainOptimization's O(k^3) dynamic program, run
        here where concrete dims make it exact). Returns the chain
        product in cost-optimal order, or None when there is no chain
        (fewer than 3 factors) to reorder. The recursions are methods, not
        closures: a recursive closure is a reference cycle, and one that
        held this evaluator kept its cache, every intermediate of the
        block, alive until the cyclic collector ran."""
        chain: List[Hop] = []
        self._flatten_chain(h, True, chain)
        if len(chain) < 3:
            return None
        vals = [self._m(c) for c in chain]
        if not all(isinstance(v, torch.Tensor) for v in vals):
            return None  # sparse or compressed factors: pairwise dispatch
        dims = [int(vals[0].shape[0])] + [int(v.shape[1]) for v in vals]
        split = _mm_chain_order(dims)
        if self.stats is not None:
            self.stats.count_estim("mmchain_reassoc")
        return _chain_product(vals, split, 0, len(vals) - 1)

    def _flatten_chain(self, node: Hop, top: bool, chain: List[Hop]):
        """The factors of the matmult chain under `node`: a matmult that
        only this chain consumes, and that is not evaluated yet, is split
        into its operands."""
        if (node.op == "ba+*"
                and (top or self._consumers.get(node.id, 2) <= 1)
                and node.id not in self.cache):
            self._flatten_chain(node.inputs[0], False, chain)
            self._flatten_chain(node.inputs[1], False, chain)
        else:
            chain.append(node)

    def _compressed_t_matmult(self, a_hop: Hop, b_hop: Hop):
        """t(X) %*% Y with X compressed: one left_mult on the compressed
        form, never a decompressing transpose (the per-iteration cliff).
        Returns None when a_hop isn't a transpose of a compressed value."""
        if a_hop.op != "reorg(t)":
            return None
        x = self.eval(a_hop.inputs[0])
        if not is_compressed(x):
            return None
        from systemml_tpu_torch.compress import device as cla_dev

        y = self._m(b_hop)
        if is_compressed(y):
            y = y.to_dense()
        return cla_dev.left_mult(x, y.T).T

    def _m(self, h: Hop):
        return _mat(self.eval(h))

    def _int(self, h: Hop) -> int:
        return int(_scalar(self.eval(h)))

    def _host_int(self, h: Hop) -> Optional[int]:
        """The integer value of a scalar hop when it is a host number, None
        when it is a device value (a loop-carried index inside a region),
        a boolean or not an integer (the JAX package's _host_int, with a
        tensor in the place of its tracer)."""
        v = self.eval(h)
        if isinstance(v, (bool, np.bool_)):
            return None
        if isinstance(v, (int, np.integer)):
            return int(v)
        if isinstance(v, (float, np.floating)):
            return int(v) if float(v).is_integer() else None
        return None

    def _affine(self, h: Hop) -> Tuple[Optional[int], int]:
        """A scalar hop as (base hop id | None, const) with value ==
        value(base) + const, peeling b(+)/b(-) whose other side is a host
        integer; base None means fully host (systemml_tpu/compiler/
        lower.py:1944 _affine)."""
        c = self._host_int(h)
        if c is not None:
            return None, c
        if h.op in ("b(+)", "b(-)"):
            x, y = h.inputs[0], h.inputs[1]
            cy = self._host_int(y)
            if cy is not None:
                bx, cx = self._affine(x)
                return bx, cx + (cy if h.op == "b(+)" else -cy)
            if h.op == "b(+)":
                cx = self._host_int(x)
                if cx is not None:
                    by, cyy = self._affine(y)
                    return by, cyy + cx
        return h.id, 0

    def _static_offset(self, a: Hop, b: Hop) -> Optional[int]:
        """The constant c with value(a) == value(b) + c, or None: what
        makes X[beg:beg+k-1,] a slice with a device start and a static
        extent (systemml_tpu/compiler/lower.py:1966 _static_offset)."""
        if a.id == b.id:
            return 0
        ba, ca = self._affine(a)
        bb, cb = self._affine(b)
        if ba == bb:
            return ca - cb
        return None

    def _bounds_1d(self, lo: Hop, hi: Hop):
        """-> (start, extent, dynamic?) for one index dimension. Host
        bounds (and any bound outside a loop region, read on the host)
        keep the int() truncation of the JAX package; inside a region a
        device bound takes the dynamic arm when the extent is static by
        the affine analysis (start the device value), and otherwise
        refuses the region ("slice bound"), where the JAX package raises
        NotTraceableError and runs the loop on the host
        (systemml_tpu/compiler/lower.py:1994 _bounds_1d)."""
        lo_v, hi_v = self.eval(lo), self.eval(hi)
        if _REGION.get() is not None and (isinstance(lo_v, torch.Tensor)
                                          or isinstance(hi_v, torch.Tensor)):
            off = self._static_offset(hi, lo)
            if off is not None:
                return (lo_v if isinstance(lo_v, torch.Tensor)
                        else int(_scalar(lo_v))), off + 1, True
            region_refuse("slice bound: a device bound without a static "
                          "extent")
        lo_v, hi_v = _scalar(lo_v), _scalar(hi_v)
        return int(lo_v), int(hi_v) - int(lo_v) + 1, False

    def _right_index(self, h: Hop):
        from systemml_tpu_torch.ops import reorg
        from systemml_tpu_torch.runtime.data import FrameObject, ListObject

        x = self.eval(h.inputs[0])
        if isinstance(x, ListObject):
            return x.get(self._int(h.inputs[1]))
        if isinstance(x, FrameObject):
            rl, rn, _ = self._bounds_1d(h.inputs[1], h.inputs[2])
            cl, cn, _ = self._bounds_1d(h.inputs[3], h.inputs[4])
            return x.slice(int(rl), int(rl) + rn - 1,
                           int(cl), int(cl) + cn - 1)
        rl, rn, rdyn = self._bounds_1d(h.inputs[1], h.inputs[2])
        cl, cn, cdyn = self._bounds_1d(h.inputs[3], h.inputs[4])
        if rdyn or cdyn:
            return reorg.right_index_dynamic(_mat(x), rl, cl, rn, cn)
        return reorg.right_index(_mat(x), rl, rl + rn - 1, cl, cl + cn - 1)

    def _left_index(self, h: Hop):
        from systemml_tpu_torch.ops import reorg
        from systemml_tpu_torch.runtime.data import FrameObject

        x = self.eval(h.inputs[0])
        y = self.eval(h.inputs[1])
        if isinstance(x, FrameObject):
            rl, rn, _ = self._bounds_1d(h.inputs[2], h.inputs[3])
            cl, cn, _ = self._bounds_1d(h.inputs[4], h.inputs[5])
            if not isinstance(y, FrameObject):
                raise DMLValidationError(
                    "frame left-indexing requires a frame source")
            return x.left_index(y, int(rl), int(rl) + rn - 1,
                                int(cl), int(cl) + cn - 1)
        x = _mat(x)
        rl, rn, rdyn = self._bounds_1d(h.inputs[2], h.inputs[3])
        cl, cn, cdyn = self._bounds_1d(h.inputs[4], h.inputs[5])
        if isinstance(y, (int, float, bool)):
            y = float(y)
        if rdyn or cdyn:
            return reorg.left_index_dynamic(x, y, rl, cl, rn, cn)
        return reorg.left_index(x, y, rl, rl + rn - 1, cl, cl + cn - 1)

    # ---- builtin table ---------------------------------------------------

    def _builtin(self, h: Hop, name: str):
        if name == "print" and _REGION.get() is not None:
            return _region_print(self, h, _REGION.get())
        fn = _BUILTINS.get(name)
        if fn is None:
            # not a builtin: a registered Python UDF? (reference: the
            # external-function framework, udf/PackageFunction.java)
            from systemml_tpu_torch.api.udf import call_udf, lookup_udf

            entry = lookup_udf(name)
            if entry is None:
                raise DMLValidationError(
                    f"unsupported builtin function {name!r} (and no "
                    f"Python UDF registered under that name)")

            def fn(ev, pos, named, h):
                return call_udf(name, pos, named, entry)
        args = [self.eval(c) for c in h.inputs]
        argnames = h.params.get("argnames") or [None] * len(args)
        named = {n: v for n, v in zip(argnames, args) if n is not None}
        pos = [v for n, v in zip(argnames, args) if n is None]
        return fn(self, pos, named, h)


def _to_display_str(v) -> str:
    """DML print/concat formatting: scalars like Java's Double.toString."""
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, torch.Tensor) and v.numel() == 1:
        x = _host_read(v, "a device scalar in a string")
        if v.dtype == torch.bool:
            return "TRUE" if bool(x) else "FALSE"
        if not v.is_floating_point():
            return str(int(x))
        v = float(x)
    if isinstance(v, (float, np.floating)):
        f = float(v)
        if f != f:
            return "NaN"  # Java Double.toString convention
        if f == float("inf"):
            return "Infinity"
        if f == float("-inf"):
            return "-Infinity"
        if f == int(f) and abs(f) < 1e15:
            return f"{f:.1f}"
        return repr(f)
    return str(v)


# --------------------------------------------------------------------------
# builtin implementations (evaluator, positional args, named args, hop)
# --------------------------------------------------------------------------

def _mat(v):
    """A scalar as a 1x1 matrix of the value dtype (as.matrix semantics)."""
    if isinstance(v, (int, float, bool)):
        from systemml_tpu_torch.ops.cellwise import as_tensor

        return as_tensor(v).reshape(1, 1)
    return v


def _scalar(v):
    """A 1x1 matrix or 0-d tensor as a host scalar; host values pass."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise DMLValidationError("as.scalar: matrix is not 1x1")
        return _host_read(v, "a scalar argument on the host")
    if isinstance(v, np.generic):
        return v.item()
    return v


def _bi_matrix(ev, pos, named, h):
    """matrix(...) constructor: fill or reshape."""
    from systemml_tpu_torch.ops import reorg
    from systemml_tpu_torch.utils.config import default_dtype, get_config

    data = pos[0] if pos else named.get("data")
    rows = named.get("rows", pos[1] if len(pos) > 1 else None)
    cols = named.get("cols", pos[2] if len(pos) > 2 else None)
    byrow = named.get("byrow", pos[3] if len(pos) > 3 else True)
    if rows is None:
        return _mat(data)  # as.matrix semantics
    rows, cols = int(_scalar(rows)), int(_scalar(cols))
    kw = {"dtype": default_dtype(), "device": torch.device(get_config().device)}
    if isinstance(data, str):  # matrix("1 2 3 4", rows=2, cols=2)
        vals = [float(v) for v in data.split()]
        return torch.tensor(vals, **kw).reshape(rows, cols)
    if isinstance(data, (int, float, bool)):
        return torch.full((rows, cols), float(data), **kw)
    if isinstance(data, list):  # matrix from elist literal
        vals = [float(_scalar(v)) for v in data]
        return torch.tensor(vals, **kw).reshape(rows, cols)
    if isinstance(data, torch.Tensor) and data.ndim == 0:
        # a 0-d scalar fills (a 1x1 MATRIX still goes through reshape and
        # fails on a cell-count mismatch, as in the reference)
        return data.to(kw["dtype"]).expand(rows, cols).clone()
    return reorg.reshape(data, rows, cols, bool(_scalar(byrow)))


def _bi_print(ev, pos, named, h):
    from systemml_tpu_torch.runtime.sparse import is_sparse

    v = pos[0] if pos else None
    if is_sparse(v):
        msg = _matrix_to_string(v)
    elif isinstance(v, torch.Tensor) and v.numel() > 1:
        msg = _matrix_to_string(v)
    else:
        msg = _to_display_str(v) if pos else ""
    ev.printer(msg)
    return None


def _region_print(ev, h, run):
    """print() inside a loop region: the string concatenation flattened
    into static text and scalar leaves, as the JAX package's _trace_print
    (systemml_tpu/runtime/loopfuse.py:283-327), and one record of the
    leaves' device values written to the region's print ring
    (runtime/loopfuse.PrintRing), which the host formats after the
    launch with _to_display_str, in order. A matrix leaf refuses the
    region ("print matrix"); once the region's first iteration is refused
    the line prints as it would eagerly, after what the ring holds."""
    parts: List[Hop] = []

    def flat(x):
        if x.op == "b(+)" and x.dt == "string":
            flat(x.inputs[0])
            flat(x.inputs[1])
        else:
            parts.append(x)

    if h.inputs:
        flat(h.inputs[0])
    segs: List[Tuple[str, str]] = []
    vals: List[torch.Tensor] = []
    for p in parts:
        if p.op == "lit" and isinstance(p.value, str):
            segs.append(("t", p.value))
            continue
        v = ev.eval(p)
        if isinstance(v, (str, bool, int, float, np.generic)):
            segs.append(("t", _to_display_str(v)))
        elif isinstance(v, torch.Tensor) and v.numel() == 1:
            segs.append(("v", "b" if v.dtype == torch.bool else
                         "f" if v.is_floating_point() else "i"))
            vals.append(v.reshape(()))
        else:
            run.fault("print matrix: a print of a matrix")
            break
    if run.ring is None:
        run.fault("print in inner loop: a print the region has no ring for")
    if run.refusal is None:
        run.ring.write(tuple(segs), vals)
        return None
    # the first iteration is refused: what the ring holds goes out first,
    # this line as it prints eagerly
    if run.ring is not None:
        run.ring.drain_to(ev.printer)
    return _bi_print(ev, [ev.eval(h.inputs[0])] if h.inputs else [], {}, h)


def _matrix_to_string(x, rows=100, cols=100, decimal=3) -> str:
    from systemml_tpu_torch.runtime.sparse import is_sparse

    # slice on the device first: only what is printed crosses to the host
    if is_sparse(x):
        arr = x.slice(0, min(int(rows), x.shape[0]), 0,
                      min(int(cols), x.shape[1])).to_numpy()
    else:
        arr = x[:int(rows), :int(cols)].detach().cpu().numpy()
    return "\n".join(" ".join(f"{v:.{int(decimal)}f}" for v in row)
                     for row in arr)


def _bi_tostring(ev, pos, named, h):
    return _matrix_to_string(pos[0], _scalar(named.get("rows", 100)),
                             _scalar(named.get("cols", 100)),
                             _scalar(named.get("decimal", 3)))


class DMLScriptError(Exception):
    """stop() raised from script (reference: DMLScriptException)."""


def _bi_stop(ev, pos, named, h):
    raise DMLScriptError(_to_display_str(pos[0]) if pos else "stop")


def _bi_assert(ev, pos, named, h):
    if not bool(_scalar(pos[0])):
        raise DMLScriptError("assertion failed")
    return None


def _device_scalar(v):
    """Inside a region, a one-element tensor as a 0-d tensor (no host
    read); else None."""
    if _REGION.get() is not None and isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise DMLValidationError("as.scalar: matrix is not 1x1")
        return v.reshape(())
    return None


def _bi_as_scalar(ev, pos, named, h):
    d = _device_scalar(pos[0])
    return _scalar(pos[0]) if d is None else d


def _bi_as_double(ev, pos, named, h):
    from systemml_tpu_torch.utils.config import default_dtype

    d = _device_scalar(pos[0])
    if d is not None:
        return d.to(default_dtype())
    v = _scalar(pos[0])
    return float(v)


def _bi_as_integer(ev, pos, named, h):
    d = _device_scalar(pos[0])
    if d is not None:
        return d if _is_int_scalar(d) and d.dtype != torch.bool else \
            torch.floor(d.double()).to(torch.int64)
    # the host arm truncates, the device arm floors, as the JAX package
    # (systemml_tpu/compiler/lower.py:2393-2399) and this file's constant
    # folder do
    return int(float(_scalar(pos[0])))


def _bi_as_logical(ev, pos, named, h):
    d = _device_scalar(pos[0])
    return bool(_scalar(pos[0])) if d is None else d != 0


def _bi_ifelse(ev, pos, named, h):
    from systemml_tpu_torch.ops.cellwise import as_tensor

    c, a, b = pos
    a, b, c = (v.item() if isinstance(v, np.generic) else v
               for v in (a, b, c))
    host = (bool, int, float)
    if all(isinstance(v, host) for v in (a, b, c)):
        # host scalars keep their kind, as jnp.where promotes: two ints
        # give an int, two booleans a boolean, a double a double
        v = a if c else b
        if any(isinstance(x, float) for x in (a, b)):
            return float(v)
        if all(isinstance(x, bool) for x in (a, b)):
            return bool(v)
        return int(v)
    like = next((t for t in (a, b, c) if isinstance(t, torch.Tensor)), None)
    ints = all(isinstance(x, (bool, int)) or (
        _is_int_scalar(x) and x.dtype != torch.bool) for x in (a, b))
    if ints and all(isinstance(x, host) or x.ndim == 0 for x in (a, b, c)):
        # a region's 0-d int64 with an int: an int64, not the value dtype
        dev = like.device

        def as_int(x):
            return x.to(torch.int64) if isinstance(x, torch.Tensor) else \
                torch.full((), int(x), dtype=torch.int64, device=dev)

        return torch.where(as_tensor(c, like) != 0, as_int(a), as_int(b))
    return torch.where(as_tensor(c, like) != 0, as_tensor(a, like),
                       as_tensor(b, like))


def _bi_log(ev, pos, named, h):
    from systemml_tpu_torch.ops import cellwise

    return cellwise.log_base(cellwise.as_tensor(pos[0]), float(_scalar(pos[1])))


def _bi_rexpand(ev, pos, named, h):
    from systemml_tpu_torch.ops import param

    direction = str(named.get("dir", "cols")).lower()
    return param.rexpand(named.get("target", pos[0] if pos else None),
                         int(_scalar(named["max"])),
                         "cols" if direction.startswith("c") else "rows",
                         bool(_scalar(named.get("cast", True))),
                         bool(_scalar(named.get("ignore", True))))


def _bi_nnz(ev, pos, named, h):
    from systemml_tpu_torch.runtime.sparse import is_ell, is_sparse

    if is_sparse(pos[0]) or is_ell(pos[0]):
        vals = pos[0].data if is_sparse(pos[0]) else pos[0].val
        return torch.count_nonzero(vals).to(vals.dtype)
    if is_compressed(pos[0]):
        return float(np.count_nonzero(pos[0].decompress()))
    x = _mat(pos[0])
    return torch.count_nonzero(x).to(x.dtype)


def _bi_compress(ev, pos, named, h):
    """compress(X) (reference: RewriteCompressedReblock /
    CompressedMatrixBlock.compress:228; compile-time injected there,
    explicit builtin here, with the same compressed op dispatch). The
    planner runs on the host: X crosses to it once."""
    from systemml_tpu_torch.compress import compress

    if is_compressed(pos[0]):
        return pos[0]
    return compress(_mat(pos[0]).detach().cpu().numpy())


def _bi_rand(ev, pos, named, h):
    """rand(rows, cols, min, max, sparsity, pdf, seed), after the JAX
    package's `_bi_rand` (systemml_tpu/compiler/lower.py:2221-2231).
    Inside a loop region every iteration draws: a device seed derives its
    key on the device (ops/datagen.prng_key); no seed or -1 takes the
    next key of the region's device stream (RegionRun.stream_key), the
    same keys an eager loop takes from the host counter."""
    key = None
    run = _REGION.get()
    seed = named.get("seed")
    if run is not None and named.get("pdf") == "poisson":
        # its rounds end when every cell is done: a read of the device
        run.note_sync('rand(pdf="poisson")\'s rejection rounds')
    if run is not None and not isinstance(seed, torch.Tensor) and (
            seed is None or int(_scalar(seed)) == -1):
        key = run.stream_key()
    return _bi_rand_eager(pos, named, key)


def _bi_rand_eager(pos, named, key=None):
    from systemml_tpu_torch.ops import datagen

    seed = named.get("seed")
    return datagen.rand(
        int(_scalar(named.get("rows", pos[0] if pos else 1))),
        int(_scalar(named.get("cols", pos[1] if len(pos) > 1 else 1))),
        _scalar(named.get("min", 0.0)), _scalar(named.get("max", 1.0)),
        float(_scalar(named.get("sparsity", 1.0))),
        named.get("pdf", "uniform"),
        None if seed is None else (seed if isinstance(seed, torch.Tensor)
                                   else int(_scalar(seed))),
        float(_scalar(named.get("lambda", 1.0))), key=key)


def _bi_decompress(ev, pos, named, h):
    return pos[0].to_dense() if is_compressed(pos[0]) else pos[0]


# ---- algorithm breadth: the JAX package's lower.py:2234-2960 ------------

def _host_bound(v, what: str):
    """A size argument (of seq, sample) as a host number: inside a loop
    region a device value refuses the region ("device bound") before
    its capture, as its read would synchronise."""
    if isinstance(v, torch.Tensor):
        region_refuse(f"device bound: {what}")
    return _scalar(v)


def _bi_seq(ev, pos, named, h):
    from systemml_tpu_torch.ops import datagen

    incr = pos[2] if len(pos) > 2 else named.get("incr")
    return datagen.seq(_host_bound(pos[0], "seq"), _host_bound(pos[1], "seq"),
                       _host_bound(incr, "seq") if incr is not None else None)


def _bi_sample(ev, pos, named, h):
    """sample(range, size [, replace] [, seed]): a third argument that is
    not 0/1 (or a boolean) is a SEED (the reference's overload
    sample(range, size, seed)); the dispatch keys on its value, never its
    Python type, as in the JAX package."""
    from systemml_tpu_torch.ops import datagen

    replace, seed = False, None
    if len(pos) > 2:
        sv = _host_bound(pos[2], "sample")
        if isinstance(sv, (bool, np.bool_)) or len(pos) > 3 or sv in (0, 1):
            replace = bool(sv)
        else:
            seed = int(sv)
    if len(pos) > 3:
        seed = int(_host_bound(pos[3], "sample"))
    return datagen.sample(int(_host_bound(pos[0], "sample")),
                          int(_host_bound(pos[1], "sample")), replace, seed)


def _linalg(fname: str):
    def fn(ev, pos, named, h):
        from systemml_tpu_torch.ops import linalg

        return getattr(linalg, fname)(*[_mat(v) for v in pos])

    return fn


def _bi_table(ev, pos, named, h):
    from systemml_tpu_torch.ops import param

    w = pos[2] if len(pos) > 2 else 1.0
    dims = list(pos[3:5])
    if len(pos) == 4:  # table(A, B, dim1, dim2)
        w, dims = 1.0, [pos[2], pos[3]]
    d1 = int(_scalar(named.get("odim1", dims[0]))) \
        if (dims or "odim1" in named) else None
    d2 = int(_scalar(named.get("odim2", dims[1]))) \
        if (len(dims) > 1 or "odim2" in named) else None
    return param.table(pos[0], pos[1], w, d1, d2)


def _bi_remove_empty(ev, pos, named, h):
    from systemml_tpu_torch.ops import param

    target = named.get("target", pos[0] if pos else None)
    return param.remove_empty(
        target, named.get("margin", "rows"), named.get("select"),
        bool(_scalar(named.get("empty.return", True))))


def _bi_replace(ev, pos, named, h):
    from systemml_tpu_torch.ops import param

    return param.replace(named.get("target", pos[0] if pos else None),
                         float(_scalar(named["pattern"])),
                         float(_scalar(named["replacement"])))


def _bi_outer(ev, pos, named, h):
    from systemml_tpu_torch.ops import param

    return param.outer(_mat(pos[0]), _mat(pos[1]), pos[2])


def _bi_order(ev, pos, named, h):
    from systemml_tpu_torch.ops import reorg

    target = named.get("target", pos[0] if pos else None)
    return reorg.sort_matrix(
        _mat(target), int(_scalar(named.get("by", 1))),
        bool(_scalar(named.get("decreasing", False))),
        bool(_scalar(named.get("index.return", False))))


def _bi_quantile(ev, pos, named, h):
    from systemml_tpu_torch.ops import param

    if len(pos) == 3:
        return param.quantile(pos[0], pos[2], weights=pos[1])
    return param.quantile(pos[0], pos[1])


def _bi_median(ev, pos, named, h):
    from systemml_tpu_torch.ops import param

    return param.median(pos[0], pos[1] if len(pos) > 1 else None)


def _bi_iqm(ev, pos, named, h):
    from systemml_tpu_torch.ops import param

    return param.iqm(pos[0], pos[1] if len(pos) > 1 else None)


def _bi_col_stat(fname: str):
    def fn(ev, pos, named, h):
        from systemml_tpu_torch.ops import param

        return getattr(param, fname)(_mat(pos[0]))

    return fn


def _bi_moment(ev, pos, named, h):
    from systemml_tpu_torch.ops import agg

    if len(pos) == 3:
        return agg.moment(pos[0], int(_scalar(pos[2])), weights=pos[1])
    return agg.moment(pos[0], int(_scalar(pos[1])))


def _bi_cov(ev, pos, named, h):
    from systemml_tpu_torch.ops import agg

    return agg.cov(pos[0], pos[1], pos[2] if len(pos) > 2 else None)


# the inverse distributions that go through scipy on the host
_HOST_DISTS = ("t", "chisq", "f")


def _dist_call(dist: str, inv: bool, target, kw: Dict[str, Any],
               lower_tail):
    from systemml_tpu_torch.ops import param

    args = [float(kw.get(k, d)) for k, d in (
        ("mean", 0.0), ("sd", 1.0), ("df", 1.0), ("df1", 1.0),
        ("df2", 1.0), ("rate", 1.0))]
    if inv:
        if dist in _HOST_DISTS:
            region_refuse(f"host distribution: inverse {dist}")
        return param.invcdf(target, dist, *args)
    return param.cdf(target, dist, *args, bool(lower_tail))


def _bi_cdf(inv: bool):
    """cdf / invcdf(target=, dist=, ...): the target is cellwise, a matrix
    or a scalar (reference: the CDF parameterized builtin)."""
    def fn(ev, pos, named, h):
        target = named.get("target", pos[0] if pos else None)
        kw = {k: _scalar(v) for k, v in named.items()
              if k in ("mean", "sd", "df", "df1", "df2", "rate")}
        return _dist_call(str(named.get("dist", "normal")), inv, target, kw,
                          _scalar(named.get("lower.tail", True)))

    return fn


# the R-style positional parameters after the target of each shortcut:
# pnorm(q, mean, sd), pt/pchisq(q, df), pf(q, df1, df2), pexp(q, rate)
_DIST_EXTRAS = {"normal": ("mean", "sd"), "t": ("df",), "chisq": ("df",),
                "f": ("df1", "df2"), "exp": ("rate",)}


def _dist_shortcut(dist: str, inv: bool = False):
    def fn(ev, pos, named, h):
        target = named.get("target", pos[0] if pos else None)
        kw = {k.replace(".", "_") if k != "lower.tail" else k: _scalar(v)
              for k, v in named.items() if k != "target"}
        for name, v in zip(_DIST_EXTRAS[dist], pos[1:]):
            kw.setdefault(name, _scalar(v))
        return _dist_call(dist, inv, target, kw,
                          _scalar(named.get("lower.tail", True)))

    return fn


def _bi_grouped_agg(ev, pos, named, h):
    from systemml_tpu_torch.ops import agg

    target = named.get("target", pos[0] if pos else None)
    groups = named.get("groups", pos[1] if len(pos) > 1 else None)
    ngroups = named.get("ngroups")
    if ngroups is None:
        ngroups = _host_read(torch.max(groups), "groupedAggregate's groups")
    return agg.aggregate_grouped(_mat(target), _mat(groups),
                                 str(named.get("fn", "sum")),
                                 int(_scalar(ngroups)), named.get("weights"))


def _bi_binary(opname: Optional[str] = None):
    """ppred(X, y, "op") (opname None), xor and the bitw ops."""
    def fn(ev, pos, named, h):
        from systemml_tpu_torch.ops import cellwise

        if opname is None:
            return cellwise.binary_op(pos[2], _mat(pos[0]), pos[1])
        return cellwise.binary_op(opname, pos[0], pos[1])

    return fn


def _bi_tri(upper: bool):
    def fn(ev, pos, named, h):
        from systemml_tpu_torch.ops import reorg

        target = _mat(named.get("target", pos[0] if pos else None))
        d = bool(_scalar(named.get("diag", False)))
        v = bool(_scalar(named.get("values", False)))
        return (reorg.upper_tri if upper else reorg.lower_tri)(target, d, v)

    return fn


def _bi_interquantile(ev, pos, named, h):
    """interQuantile(X, [W], p): the values of X strictly between the p
    and 1-p quantiles, as a column (reference: TernaryOp INTERQUANTILE).
    Its length is the data's: the weighted form reads the kept count on
    the host."""
    x = _mat(pos[0]).reshape(-1)
    if len(pos) == 3:
        w, p = _mat(pos[1]).reshape(-1), float(_scalar(pos[2]))
        order = torch.argsort(x, stable=True)
        cw = torch.cumsum(w[order], dim=0)
        total = cw[-1]
        keep = (cw > p * total) & (cw <= (1.0 - p) * total)
        return x[order][keep].reshape(-1, 1)
    p = float(_scalar(pos[1]))
    v = torch.sort(x).values
    n = int(v.shape[0])
    i1, i2 = int(np.floor(n * p)), int(np.ceil(n * (1.0 - p)))
    return v[i1:i2].reshape(-1, 1)


def _bi_list(ev, pos, named, h):
    from systemml_tpu_torch.runtime.data import ListObject, to_data

    names = h.params.get("argnames")
    if names and any(n is not None for n in names):
        return ListObject([to_data(v) for v in pos + list(named.values())],
                          list(names))
    return ListObject([to_data(v) for v in pos])


def _bi_listidx(ev, pos, named, h):
    from systemml_tpu_torch.runtime.data import MatrixObject, ScalarObject

    lst, i = pos[0], pos[1]
    d = lst.get(i if isinstance(i, str) else int(_scalar(i)))
    if isinstance(d, MatrixObject):
        return d.array
    if isinstance(d, ScalarObject):
        return d.value
    return d


def _bi_read(ev, pos, named, h):
    """read(path, ...): io/matrixio.py, a matrix on the configured device
    (a scalar with data_type="scalar", a host frame with
    data_type="frame")."""
    from systemml_tpu_torch.io import matrixio

    path = str(pos[0])
    dt = named.get("data_type", "matrix")
    if dt == "scalar":
        vt = named.get("value_type")
        if vt is None:
            vt = matrixio.read_metadata(path).get("value_type", "double")
        with open(path) as f:
            s = f.read().strip()
        if vt == "string":
            return s
        if vt in ("int", "integer"):
            return int(float(s))
        if vt == "boolean":
            return s.upper() == "TRUE"
        return float(s)
    if dt == "frame":
        return matrixio.read_frame(path, named.get("format"),
                                   bool(named.get("header", False)),
                                   named.get("sep", ","))
    m = matrixio.read_matrix(
        path, named.get("format"),
        int(_scalar(named["rows"])) if "rows" in named else None,
        int(_scalar(named["cols"])) if "cols" in named else None,
        bool(named.get("header", False)), named.get("sep", ","))
    return m.array


def _bi_write(ev, pos, named, h):
    from systemml_tpu_torch.io import matrixio
    from systemml_tpu_torch.runtime.data import FrameObject, MatrixObject

    if ev.skip_writes:
        return None  # JMLC in-memory mode
    target, path = pos[0], str(pos[1])
    fmt = named.get("format", "csv")
    if isinstance(target, FrameObject):
        matrixio.write_frame(target, path, named.get("sep", ","),
                             bool(named.get("header", True)), fmt)
    elif isinstance(target, (int, float, bool, str, np.generic)) or (
            isinstance(target, torch.Tensor) and target.ndim == 0):
        # scalars, also 0-d device values (write(mean(...), f))
        with open(path, "w") as f:
            f.write(_to_display_str(target) + "\n")
    else:
        if is_compressed(target):
            target = target.decompress()
        matrixio.write_matrix(MatrixObject(target), path, fmt,
                              named.get("sep", ","),
                              bool(named.get("header", False)))
    return None


def _bi_checkpoint(ev, pos, named, h):
    from systemml_tpu_torch.runtime import checkpoint as ckpt
    from systemml_tpu_torch.utils import stats as stats_mod

    env = dict(ev.env)
    for n, v in zip(h.params.get("var_names", []), pos[1:]):
        env[n] = v  # in-block updates override the pre-block snapshot
    ckpt.save_snapshot(env, str(pos[0]))
    st = stats_mod.current()
    if st is not None:
        st.count_pool("checkpoint_save")
    return None


def _bi_restore(ev, pos, named, h):
    from systemml_tpu_torch.runtime import checkpoint as ckpt
    from systemml_tpu_torch.utils import stats as stats_mod

    ev.env.update(ckpt.load_snapshot(str(pos[0])))
    st = stats_mod.current()
    if st is not None:
        st.count_pool("checkpoint_restore")
    return None


def _bi_checkpoint_exists(ev, pos, named, h):
    from systemml_tpu_torch.runtime import checkpoint as ckpt

    return ckpt.snapshot_exists(str(pos[0]))


def _bi_map(ev, pos, named, h):
    """map(F, "x -> expr") — per-cell map over a frame's (string)
    columns (reference capability: FrameBlock map-style ops). The spec
    is either a registered Python UDF name (api/udf) or a lambda-arrow
    expression evaluated per cell with a restricted namespace."""
    from systemml_tpu_torch.runtime.data import FrameObject

    f, spec = pos[0], pos[1]
    if not isinstance(f, FrameObject):
        raise DMLValidationError("map() expects a frame input")
    return f.map_cells(_compile_map_fn(str(spec)))


def _compile_map_fn(spec: str):
    from systemml_tpu_torch.api.udf import lookup_udf

    entry = lookup_udf(spec)
    if entry is not None:
        from systemml_tpu_torch.api.udf import call_udf

        return lambda v: call_udf(spec, [v], {}, entry)
    if "->" not in spec:
        raise DMLValidationError(
            f"map(): {spec!r} is neither a registered UDF nor an "
            f"'x -> expression' lambda")
    arg, expr = spec.split("->", 1)
    arg = arg.strip()
    code = compile(expr.strip(), "<frame-map>", "eval")
    # the spec is TRUSTED SCRIPT CODE (a DML script already runs
    # arbitrary compute, and UDFs are arbitrary Python) — the trimmed
    # namespace is a convenience surface, not a security boundary
    allowed = {"len": len, "str": str, "int": int, "float": float,
               "abs": abs, "round": round, "min": min, "max": max}

    def fn(v):
        return eval(code, {"__builtins__": {}}, {arg: v, **allowed})

    return fn


# ---- transform builtins (reference: parameterized builtins TRANSFORMENCODE/
# APPLY/DECODE/COLMAP, runtime/transform/; EncoderFactory.java:39): the
# encoders run on the host over the frame's columns (runtime/transform.py),
# and the matrix they make goes to the configured device once ---------

def _transform_args(pos, named):
    target = named.get("target", pos[0] if pos else None)
    return target, _scalar(named.get("spec", "")), named.get("meta")


def _to_device(x: np.ndarray) -> torch.Tensor:
    from systemml_tpu_torch.utils.config import default_dtype, get_config

    dt = default_dtype()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(
        device=get_config().device, dtype=dt)


def _bi_transformencode(ev, pos, named, h):
    from systemml_tpu_torch.runtime.transform import TransformEncoder

    fr, spec, _ = _transform_args(pos, named)
    enc = TransformEncoder(spec, fr.colnames)
    x, meta = enc.encode(fr)
    return _to_device(x), meta


def _bi_transformmeta(ev, pos, named, h):
    """transformmeta(spec=..., path=...): load a stored transform
    metadata frame (reference: ParameterizedBuiltinFunctionOp
    TRANSFORMMETA reading the HDFS meta directory; here the meta frame
    written by write() after transformencode)."""
    from systemml_tpu_torch.io import matrixio

    path = _scalar(named.get("path", pos[0] if pos else ""))
    return matrixio.read_frame(str(path))


def _bi_transform_legacy(ev, pos, named, h):
    """Old-style transform() builtin (reference: the pre-encode API used
    by scripts/algorithms/transform.dml — parameterized builtin TRANSFORM,
    parser/Expression.java:157): target frame + transformSpec (inline
    JSON or a path to a spec file) -> encoded matrix."""
    import os

    from systemml_tpu_torch.runtime.transform import TransformEncoder

    target = named.get("target", pos[0] if pos else None)
    spec = named.get("transformSpec", named.get("spec", ""))
    spec = _scalar(spec)
    if isinstance(spec, str) and os.path.isfile(spec):
        with open(spec) as f:
            spec = f.read()
    enc = TransformEncoder(spec, target.colnames)
    x, _meta = enc.encode(target)
    return _to_device(x)


def _bi_transformapply(ev, pos, named, h):
    from systemml_tpu_torch.runtime.transform import TransformEncoder

    fr, spec, meta = _transform_args(pos, named)
    enc = TransformEncoder(spec, fr.colnames)
    enc.load_meta(meta)
    return _to_device(enc.apply(fr))


def _bi_transformdecode(ev, pos, named, h):
    from systemml_tpu_torch.runtime.transform import TransformDecoder

    x, spec, meta = _transform_args(pos, named)
    dec = TransformDecoder(spec, meta.colnames, meta)
    return dec.decode(_mat(x).detach().cpu().numpy())


def _bi_transformcolmap(ev, pos, named, h):
    from systemml_tpu_torch.runtime.transform import TransformEncoder

    meta, spec, _ = _transform_args(pos, named)
    enc = TransformEncoder(spec, meta.colnames)
    enc.load_meta(meta)
    return _to_device(enc.colmap())


def _bi_as_matrix(ev, pos, named, h):
    """as.matrix: a scalar as a 1x1 matrix; a frame of numeric columns as
    a matrix on the configured device (its string cells parse as
    numbers, as FrameBlock's cast does)."""
    from systemml_tpu_torch.runtime.data import FrameObject

    x = pos[0]
    if isinstance(x, FrameObject):
        try:
            cols = [np.asarray(c, dtype=np.float64) for c in x.columns]
        except ValueError as e:
            raise DMLValidationError(
                f"as.matrix: frame has non-numeric cells ({e})") from None
        return _to_device(np.column_stack(cols) if cols
                          else np.zeros((0, 0)))
    return _mat(x)


_BUILTINS: Dict[str, Callable] = {
    "read": _bi_read, "write": _bi_write, "checkpoint": _bi_checkpoint,
    "restore": _bi_restore, "checkpointExists": _bi_checkpoint_exists,
    "matrix": _bi_matrix, "print": _bi_print, "stop": _bi_stop,
    "assert": _bi_assert, "toString": _bi_tostring,
    "as.scalar": _bi_as_scalar, "castAsScalar": _bi_as_scalar,
    "as.matrix": _bi_as_matrix,
    "as.frame": lambda ev, pos, named, h: pos[0],
    "map": _bi_map, "transformmeta": _bi_transformmeta,
    "transform": _bi_transform_legacy,
    "transformencode": _bi_transformencode,
    "transformapply": _bi_transformapply,
    "transformdecode": _bi_transformdecode,
    "transformcolmap": _bi_transformcolmap,
    "as.double": _bi_as_double, "as.integer": _bi_as_integer,
    "as.logical": _bi_as_logical,
    "ifelse": _bi_ifelse, "log": _bi_log,
    "exists": lambda ev, pos, named, h: pos[0] is not None,
    "time": lambda ev, pos, named, h: int(time.time_ns()),
    "nnz": _bi_nnz, "rexpand": _bi_rexpand,
    "compress": _bi_compress, "decompress": _bi_decompress,
    "rand": _bi_rand, "Rand": _bi_rand,
    "sumSq": lambda ev, pos, named, h: __import__(
        "systemml_tpu_torch.ops.agg", fromlist=["agg"]).agg(
        "sumsq", _mat(pos[0])),
    "seq": _bi_seq, "sample": _bi_sample,
    "solve": _linalg("solve"), "inv": _linalg("inverse"),
    "inverse": _linalg("inverse"), "cholesky": _linalg("cholesky"),
    "det": _linalg("det"), "trace": _linalg("trace"), "qr": _linalg("qr"),
    "lu": _linalg("lu"), "eigen": _linalg("eigen"), "svd": _linalg("svd"),
    "table": _bi_table, "removeEmpty": _bi_remove_empty,
    "replace": _bi_replace, "outer": _bi_outer, "order": _bi_order,
    "quantile": _bi_quantile, "median": _bi_median,
    "interQuartileMean": _bi_iqm, "iqm": _bi_iqm,
    "colMedians": _bi_col_stat("col_medians"),
    "colIQMs": _bi_col_stat("col_iqms"),
    "moment": _bi_moment, "centralMoment": _bi_moment, "cov": _bi_cov,
    "cdf": _bi_cdf(False), "icdf": _bi_cdf(True), "invcdf": _bi_cdf(True),
    **{f"{pre}{short}": _dist_shortcut(dist, pre == "q")
       for short, dist in (("norm", "normal"), ("t", "t"), ("f", "f"),
                           ("chisq", "chisq"), ("exp", "exp"))
       for pre in ("p", "q")},
    "aggregate": _bi_grouped_agg, "groupedAggregate": _bi_grouped_agg,
    "ppred": _bi_binary(), "xor": _bi_binary("xor"),
    **{n: _bi_binary(n) for n in ("bitwAnd", "bitwOr", "bitwXor",
                                  "bitwShiftL", "bitwShiftR")},
    "lower.tri": _bi_tri(False), "upper.tri": _bi_tri(True),
    "interQuantile": _bi_interquantile,
    "list": _bi_list, "listidx": _bi_listidx,
    "cumsumprod": lambda ev, pos, named, h: __import__(
        "systemml_tpu_torch.ops.agg", fromlist=["agg"]).cumsumprod(
        _mat(pos[0])),
}

# ---- the DNN builtins (systemml_tpu/compiler/lower.py:2713-2935) ------

def _shape4(named, key):
    v = named.get(key)
    if v is None:
        raise DMLValidationError(f"conv builtin requires {key}")
    return [int(_scalar(x)) for x in (v if isinstance(v, list) else [v])]


def _int_list(named, key, default):
    return [int(_scalar(x)) for x in named.get(key, default)]


def _conv_params(named):
    fsh = named.get("filter_shape")
    return (_int_list(named, "stride", [1, 1]),
            _int_list(named, "padding", [0, 0]),
            _shape4(named, "input_shape"),
            [int(_scalar(x)) for x in fsh] if fsh is not None else None,
            int(_scalar(named.get("groups", 1))))


def _nhwc_flags(h):
    """The layout pass's annotations (hops/layout.py): take / give the
    raw 4-D NHWC tensor in place of the flattened boundary form."""
    return (bool(h.params.get("nhwc_in")), bool(h.params.get("nhwc_out")))


def _bi_from_nhwc(ev, pos, named, h):
    """The write-boundary conversion hops/layout.py inserts: a raw
    (N, H, W, C) tensor to the flattened (N, C*H*W) form."""
    from systemml_tpu_torch.ops import dnn

    return dnn.from_nhwc(pos[0], "write_boundary")


def _bi_conv(fn_name: str):
    def fn(ev, pos, named, h):
        from systemml_tpu_torch.ops import dnn

        stride, padding, ish, fsh, groups = _conv_params(named)
        if fn_name == "conv2d":
            nin, nout = _nhwc_flags(h)
            return dnn.conv2d(pos[0], pos[1], ish, fsh, stride, padding,
                              groups, nhwc_in=nin, nhwc_out=nout)
        return getattr(dnn, fn_name)(pos[0], pos[1], ish, fsh, stride,
                                     padding, groups)

    return fn


def _bi_pool(kind: str, backward: bool = False):
    def fn(ev, pos, named, h):
        from systemml_tpu_torch.ops import dnn

        args = (_shape4(named, "input_shape"),
                _int_list(named, "pool_size", [1, 1]),
                _int_list(named, "stride", [1, 1]),
                _int_list(named, "padding", [0, 0]))
        if backward:
            f = (dnn.max_pool_backward if kind == "max"
                 else dnn.avg_pool_backward)
            return f(pos[0], pos[1], *args)
        f = dnn.max_pool if kind == "max" else dnn.avg_pool
        nin, nout = _nhwc_flags(h)
        return f(pos[0], *args, nhwc_in=nin, nhwc_out=nout)

    return fn


def _bi_bias(name: str):
    def fn(ev, pos, named, h):
        from systemml_tpu_torch.ops import dnn

        nin, nout = _nhwc_flags(h)
        b = _mat(pos[1])
        return getattr(dnn, name)(pos[0], b, int(b.shape[0]),
                                  nhwc_in=nin, nhwc_out=nout)

    return fn


def _truthy(v) -> bool:
    v = _scalar(v)
    return v.upper() == "TRUE" if isinstance(v, str) else bool(v)


def _bi_lstm(ev, pos, named, h):
    from systemml_tpu_torch.ops import dnn

    x, w, b, out0, c0 = pos[:5]
    rs = _truthy(pos[5] if len(pos) > 5
                 else named.get("return_sequences", True))
    return dnn.lstm(x, w, b, out0, c0, rs)


def _bi_batch_norm2d(ev, pos, named, h):
    from systemml_tpu_torch.ops import dnn

    x, gamma, beta, ema_mean, ema_var = pos[:5]
    mode = _scalar(named.get("mode", pos[5] if len(pos) > 5 else "train"))
    eps = float(_scalar(named.get("epsilon",
                                  pos[6] if len(pos) > 6 else 1e-5)))
    mom = float(_scalar(named.get("momentum",
                                  pos[7] if len(pos) > 7 else 0.9)))
    return dnn.batch_norm2d(x, gamma, beta, ema_mean, ema_var,
                            _shape4(named, "input_shape"), mode, eps, mom)


_BUILTINS.update({
    # internal, not parseable from DML: hops/layout.py's write-boundary
    # conversion of a chain intermediate that is also a symbol write
    "__from_nhwc": _bi_from_nhwc,
    "conv2d": _bi_conv("conv2d"),
    "conv2d_backward_filter": _bi_conv("conv2d_backward_filter"),
    "conv2d_backward_data": _bi_conv("conv2d_backward_data"),
    "max_pool": _bi_pool("max"), "avg_pool": _bi_pool("avg"),
    "max_pool_backward": _bi_pool("max", True),
    "avg_pool_backward": _bi_pool("avg", True),
    "bias_add": _bi_bias("bias_add"),
    "bias_multiply": _bi_bias("bias_multiply"),
    "lstm": _bi_lstm, "batch_norm2d": _bi_batch_norm2d,
})

