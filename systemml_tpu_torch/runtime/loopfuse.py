"""Fused loop regions: a DML while/for nest run as one CUDA graph.

Port of systemml_tpu/runtime/loopfuse.py: `FusedLoop` (:580-1840 there),
the executor of the regions that compiler/lower.plan_loop_regions plans,
and `_trace_while`, `_trace_if` and `_trace_for` (:340-480), which lower
a nest's inner loops and ifs inside its region. Where the JAX package
traces a nest into one lax.while_loop, the port captures it into one CUDA
graph with its predicates kept on the card: a `while` becomes a
conditional WHILE node, an `if` whose predicate is a device value two IF
nodes (the else branch tests pred == 0), an `if` over host values only is
resolved at capture (the JAX package's static `if`), and a `for` a WHILE
node over a device counter (codegen/loop_graph.py, csrc/loop_graph.cu).
A loop then costs one host sync for its entry predicate, one graph launch
and one sync at its exit, which reads the trip counter, the body
counters and the host-kind scalars the loop carries.

Per entry of a region (`FusedLoop.run_while` / `run_for`):

1. refuse before anything runs, with a classified reason (`REASONS`):
   the plan refused it, a carried string the plan did not drop, a
   `print` inside an inner loop, also in a function called there (or
   more prints an iteration than the print ring holds, or a print beside
   a recursive call), a builtin
   that reads the host (removeEmpty, table without dims, an inverse t,
   chisq or F distribution; a seq or sample whose bound is a device
   value refuses in the peel, "device bound"), a loop-varying name
   feeding a shape or a slice bound whose extent is not static, a
   carried sparse
   matrix ("sparse carried"), or a loop-invariant sparse matrix without a
   device view ("sparse view": runtime/sparse.loop_device_view found
   neither form viable, or the views of the entry, counted by their
   device storage, pass cap / 8 of the budget; the JAX package's
   loopfuse.py:734-765). Each loop-invariant SparseMatrix is read
   through its view (dense or ELL, cached on the matrix, so a re-entry
   finds the same addresses), installed before the peel and taken out at
   exit: inside the region only views, never a CSR, so no cuSPARSE call
   and no host read of a CSR's size is captured. The refusal emits
   a `loop_fallback` event, counts in `loop_regions_refused` and latches;
   the loop then runs eagerly with the same kernels, and each inner loop
   runs as a region of its own, as the JAX package's inner FusedLoops do
   when the outer one falls back;
2. turn each carried host number (and each int invariant the plan may
   pass as a value, `traced_ints`) into a 0-d tensor of its kind: int64,
   bool, or the value dtype; the predicate is then a device value;
3. evaluate the entry predicate once: false runs no iteration and binds
   nothing (the reference's semantics; the JAX package's zero seeding is
   only needed because it skips this sync);
4. peel the first iteration eagerly, with those value kinds: it builds
   and loads every kernel the body launches, the reduce scratch, cuBLAS's
   workspace, and shows what a capture could not do (a host read of a
   device value, a nested loop reading a name before binding it, a print
   of a matrix, a compressed op computed on the host): either
   refuses the region, as does a carried value whose shape, dtype (of a
   matrix) or kind changed in the peel ("shape change"; a 0-d scalar takes
   the body's dtype, as the JAX package's _promote_init widens it, in an
   inner loop too);
5. copy each carried value into a static buffer and capture the rest of
   the loop: the body runs through the ordinary block machinery with the
   run installed (compiler/lower.region_scope), each iteration ends by
   copying the new values into the static buffers and setting the node's
   condition from the predicate;
6. launch once and sync once at exit; each carried value leaves as a
   copy of its buffer, a host-kind scalar as the Python type it had.

Prints and unseeded draws stay in the graph. A `print` writes a record
(its format's id and its scalar leaves) into the region's `PrintRing` on
the card; the loop's predicate is ANDed with the ring's room, and the
exit's read brings the records back, which the host prints in order with
the eager path's formatting; a loop that stopped for room is launched
again from its static buffers (a drain, `record["drains"]`). An unseeded
`rand` takes fold_in(base, n) from the region's `RandStream`, n a device
counter loaded from the host's stream at entry and handed back at exit:
a loop draws the same keys as a region and eagerly.

The instantiated graph is cached per region on the shapes, dtypes and
kinds of its reads, the values of its host invariants, and the address
of each invariant tensor it reads (a capture bakes addresses in); ints
the plan passes as values, and one-element invariant tensors, go into
static buffers, so a re-entry with another `maxi` reuses the graph and
skips the peel. On the CPU the same steps run, and the plain arm runs the
rest of the loop in Python over the same static buffers, reading the
predicate each iteration: the tests check the state handling the graph
depends on. The arm is chosen by the configured device, never by a
failure: an error during a capture or a launch raises.

Launch counts stay right under capture: each body (a WHILE body, an IF
branch) gets a device execution counter, the change of every counter
(kernel launches, the run's statistics) during each body's capture is
recorded, and after the exit sync each body's count is scaled by its
executions.

Semantic deviation (as the JAX package's, loopfuse.py:34-39 there): a
name first assigned inside an inner loop, read after it, holds zeros when
that loop runs no iteration in a later pass of the outer one.
"""

from __future__ import annotations

import sys
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from systemml_tpu_torch.compiler.lower import (NotLoopFusable,
                                               _SHAPE_POSITIONS,
                                               _collect_rw, _collect_rw_seq,
                                               _live_after, _plan_one_region,
                                               region_scope)
from systemml_tpu_torch.hops.hop import postorder
from systemml_tpu_torch.runtime import sparse as sp

# the classified reasons a region is refused at entry or after its peel
# (a plan's refusal keeps the plan's own text)
REASONS = ("carried string", "print in inner loop", "print matrix",
           "print ring", "static_names", "shape change", "host read",
           "unbound read", "fractional for", "slice bound", "sparse view",
           "sparse carried", "removeEmpty", "table without dims",
           "host distribution", "device bound", "compressed host op")
# bodies with a device execution counter per region graph
MAX_SCOPES = 1024
# nesting of conditional nodes (loops and ifs, through function calls)
# per region: one capture stream per level
MAX_DEPTH = 8
# cached but unused device bytes above which a capture first returns them
# to the driver (the peel's temporaries; ALS-CG's run to gigabytes), so
# that the graph's pool can take them
RELEASE_BYTES = 1 << 30
# entries a region keeps (each graph holds its pool): an inner region
# re-entered with new invariant tensors each time (l2-svm's line search
# reads the outer pass's Xd) makes a new one per entry
CACHE_CAP = 4
# print records a region's ring holds: a loop whose next top-level
# iteration might not fit stops, the host formats the records, and the
# same graph goes on from its static buffers
RING_RECORDS = 1024

_ABSENT = object()


# --------------------------------------------------------------------------
# counters: what a captured body adds at each of its executions
# --------------------------------------------------------------------------

def launch_counters() -> Dict[str, Any]:
    """Every hand-written kernel's wrapper, by name: each carries
    `.launches`."""
    from systemml_tpu_torch.codegen import kernels, loop_graph
    from systemml_tpu_torch.compress import device as cla_dev

    return {"mmchain": kernels.mmchain_kernel,
            "spoof_cell": kernels.cell_kernel,
            "spoof_row": kernels.row_kernel,
            "spoof_multiagg": kernels.multiagg_kernel,
            "spoof_outer": kernels.outer_kernel,
            "cla_chain": cla_dev.chain_kernel,
            "set_cond": loop_graph.set_cond}


def _snapshot(stats) -> Dict[tuple, int]:
    d: Dict[tuple, int] = {("k", n): f.launches
                           for n, f in launch_counters().items()}
    for fam, lab in (("e", stats.estim_counts), ("f", stats.fcall_counts),
                     ("o", stats.op_count)):
        for k, v in lab.items():
            d[(fam, k)] = v
    d[("b",)] = stats.eager_blocks
    return d


def _delta(after: Dict[tuple, int], before: Dict[tuple, int]
           ) -> Dict[tuple, int]:
    out = {}
    for k in set(after) | set(before):
        v = after.get(k, 0) - before.get(k, 0)
        if v:
            out[k] = v
    return out


def _apply(stats, delta: Dict[tuple, int], times: int) -> None:
    """Adds `delta` x `times` to the counters it names."""
    if not times:
        return
    ks = launch_counters()
    for key, v in delta.items():
        n = v * times
        if key[0] == "k":
            ks[key[1]].launches += n
        elif key[0] == "e":
            stats.estim_counts.inc(key[1], n)
        elif key[0] == "f":
            stats.fcall_counts.inc(key[1], n)
        elif key[0] == "o":
            stats.op_count.inc(key[1], n)
        else:
            stats._eager_total.inc(n)


def kernel_launches(delta: Dict[tuple, int]) -> Dict[str, int]:
    return {k[1]: v for k, v in delta.items() if k[0] == "k"}


# --------------------------------------------------------------------------
# the run of one region body: its first iteration and plain arm ("plain")
# or its capture ("capture")
# --------------------------------------------------------------------------

class RegionRun:
    """State of one run of a region's body, installed with
    compiler/lower.region_scope while it runs."""

    def __init__(self, mode: str, skip=frozenset(), varying=frozenset(),
                 stats=None):
        self.mode = mode
        self.skip = frozenset(skip)        # dead string accumulators
        self.varying = frozenset(varying)  # names the nest writes
        self.stats = stats
        # the first reason a capture could not run this body (plain mode)
        self.refusal: Optional[str] = None
        # id(loop block) -> {carried name: (shape, dtype)} at its exit
        self.observed: Dict[int, Dict[str, Tuple]] = {}
        # the region's print ring and unseeded-rand stream, where its body
        # prints or draws
        self.ring: Optional["PrintRing"] = None
        self.stream: Optional["RandStream"] = None
        # capture only
        self.streams: List[torch.cuda.Stream] = []
        self.depth = 0
        self.counters: Optional[torch.Tensor] = None
        self.scopes: List[Tuple[int, Dict[tuple, int]]] = []
        self._open: List[list] = []
        self._top_incl: Dict[tuple, int] = {}
        # buffers first made inside a conditional body: zero-filled before
        # each launch (a name the first iteration never bound)
        self.zero_init: List[torch.Tensor] = []

    def note_sync(self, what: str) -> None:
        """A host read of a device value: an error inside a capture, a
        refusal reason before one."""
        self.fault(f"host read: {what}")

    def fault(self, reason: str) -> None:
        if self.mode == "capture":
            raise NotLoopFusable(reason)
        if self.refusal is None:
            self.refusal = reason

    def stream_key(self):
        """The key of an unseeded rand() in the body: the next of the
        region's device stream (the scan gives a region a stream where
        any rand's seed is not a literal other than -1)."""
        return self.stream.next_key()

    def check_spoof_numbers(self, hop, args) -> None:
        """Inside a capture, a host number a fused plan's launch passes is
        frozen into the graph: it must come from an invariant."""
        if self.mode != "capture":
            return
        for c, v in zip(hop.inputs, args):
            if c.op == "tread" and c.name in self.varying \
                    and not isinstance(v, torch.Tensor):
                raise NotLoopFusable(f"a fused plan takes the loop-varying "
                                     f"{c.name!r} as a host number")

    # ---- per-body counters (capture) -----------------------------------

    def scope_begin(self) -> None:
        idx = len(self.scopes) + len(self._open)
        if idx >= MAX_SCOPES:
            raise NotLoopFusable(f"more than {MAX_SCOPES} bodies in a region")
        self.counters[idx].add_(1)
        self._open.append([idx, _snapshot(self.stats), {}])

    def scope_end(self) -> None:
        idx, snap0, kids = self._open.pop()
        incl = _delta(_snapshot(self.stats), snap0)
        self.scopes.append((idx, _delta(incl, kids)))
        parent = self._open[-1][2] if self._open else self._top_incl
        for k, v in incl.items():
            parent[k] = parent.get(k, 0) + v


# --------------------------------------------------------------------------
# values
# --------------------------------------------------------------------------

def _is_number(v) -> bool:
    return isinstance(v, (bool, int, float, np.generic))


def device_scalar(v, dev) -> torch.Tensor:
    """A host number as a 0-d tensor of its kind: bool, int64, or the
    value dtype for a double."""
    from systemml_tpu_torch.utils.config import default_dtype

    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, bool):
        return torch.full((), v, dtype=torch.bool, device=dev)
    if isinstance(v, int):
        return torch.full((), v, dtype=torch.int64, device=dev)
    return torch.full((), float(v), dtype=default_dtype(dev), device=dev)


def _fresh(v, name: str, dev) -> torch.Tensor:
    """A new buffer holding v (a tensor or a host number)."""
    if isinstance(v, torch.Tensor):
        out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        out.copy_(v)
        return out
    if _is_number(v):
        return device_scalar(v, dev)
    raise NotLoopFusable(f"carried string: {name!r} holds a "
                         f"{type(v).__name__}")


def _store(buf: torch.Tensor, v, name: str) -> None:
    """Writes a new value of `name` into its buffer. A 0-d scalar may
    change dtype within its kind's widening (int into int or double,
    anything numeric into a double); a matrix must keep shape and dtype."""
    if not isinstance(buf, torch.Tensor):     # a refused peel's raw value
        raise NotLoopFusable(f"shape change: {name!r}")
    if isinstance(v, torch.Tensor):
        if v.shape != buf.shape:
            if v.numel() == 1 and buf.numel() == 1:
                v = v.reshape(buf.shape)
            else:
                raise NotLoopFusable(f"shape change: {name!r} from "
                                     f"{tuple(buf.shape)} to {tuple(v.shape)}")
        if v.dtype != buf.dtype and not (buf.ndim == 0 and (
                buf.is_floating_point() or (buf.dtype == torch.int64 and (
                    v.dtype == torch.bool or not v.is_floating_point())))):
            raise NotLoopFusable(f"shape change: {name!r} from {buf.dtype} "
                                 f"to {v.dtype}")
        buf.copy_(v)
        return
    if _is_number(v) and buf.ndim == 0:
        if isinstance(v, np.generic):
            v = v.item()
        ok = (buf.is_floating_point() or (buf.dtype == torch.int64
                                          and not isinstance(v, float))
              or (buf.dtype == torch.bool and isinstance(v, bool)))
        if not ok:
            raise NotLoopFusable(f"shape change: {name!r} from {buf.dtype} "
                                 f"to {type(v).__name__}")
        buf.fill_(v)
        return
    raise NotLoopFusable(f"carried string: {name!r} holds a "
                         f"{type(v).__name__}")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _writeback(buffers: Dict[str, torch.Tensor], env: Dict[str, Any],
               names: Sequence[str], dev, run: "RegionRun" = None) -> None:
    """Copies each name's new value into its buffer and binds the name to
    it. A new value that shares memory with a buffer being overwritten
    (`a = b` beside `b = ...`) is copied first. In a first iteration
    (`run` in plain mode) a value no buffer can hold refuses the region
    and is bound as it is, so that the iteration ends as it would
    eagerly."""
    new = {n: env[n] for n in names if n in env}
    over = [n for n in new if n in buffers and new[n] is not buffers[n]]
    hit = {_storage(buffers[n]) for n in over}
    for n in over:
        v = new[n]
        if isinstance(v, torch.Tensor) and _storage(v) in hit:
            new[n] = v.clone()
    for n in new:
        try:
            if n not in buffers:
                buffers[n] = _fresh(new[n], n, dev)  # plain: first binding
            elif n in over:
                _store(buffers[n], new[n], n)
        except NotLoopFusable as e:
            if run is None or run.mode != "plain":
                raise
            if _widens(buffers[n], new[n]):
                buffers[n] = _fresh(new[n], n, dev)
            else:
                run.fault(str(e))
                buffers[n] = new[n]
        env[n] = buffers[n]


def _widens(buf, v) -> bool:
    """Whether a 0-d int or bool buffer meets a double (an inner loop's
    `step = 0` that its body makes a double): the buffer widens, as the
    JAX package's _promote_init widens a loop's init."""
    return (isinstance(buf, torch.Tensor) and buf.ndim == 0
            and not buf.is_floating_point()
            and (isinstance(v, float) or (isinstance(v, torch.Tensor)
                                          and v.numel() == 1
                                          and v.is_floating_point())))


def _truth(v) -> bool:
    if isinstance(v, torch.Tensor):
        return bool(v.reshape(()).item() != 0)
    return bool(v)


def _device_pred(v, dev) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.reshape(())
    return torch.full((), bool(v), dtype=torch.bool, device=dev)


def _run_blocks(blocks, ec) -> None:
    for b in blocks:
        b.execute(ec)


def _region_device(ec):
    from systemml_tpu_torch.utils.config import get_config

    dev = torch.device(get_config().device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# --------------------------------------------------------------------------
# prints and unseeded rand streams on the device
# --------------------------------------------------------------------------

class PrintRing:
    """The print records of a region, on the device. A print in the body
    (compiler/lower._region_print) writes one row: its format's id, then
    each scalar leaf as int64 (a double's bits, an int, a boolean), at
    the device counter `n`, which it advances. The loop's predicate is
    ANDed with the ring's room (`room`: n + bound <= capacity, `bound`
    the prints one top-level iteration may write), so the ring never
    overflows: a loop that stops for room leaves `more` (its own
    predicate) true, and the host formats the records (`drain`, with
    _to_display_str, in order) and launches the same graph again."""

    def __init__(self, dev, width: int, bound: int):
        self.cap = RING_RECORDS
        self.bound = bound
        self.width = width
        self.rows = torch.zeros((self.cap, 1 + width), dtype=torch.int64,
                                device=dev)
        self.n = torch.zeros((), dtype=torch.int64, device=dev)
        self.more = torch.zeros((), dtype=torch.bool, device=dev)
        self.formats: List[tuple] = []
        self._ids: Dict[tuple, int] = {}
        self.reads = 0

    def write(self, segs: tuple, vals: Sequence[torch.Tensor]) -> None:
        """One record: segs the print's parts, ("t", text) or ("v", kind)
        for each of `vals` (0-d tensors; kind b, i or f)."""
        pid = self._ids.get(segs)
        if pid is None:
            pid = self._ids[segs] = len(self.formats)
            self.formats.append(segs)
        dev = self.rows.device
        cols = [torch.full((1,), pid, dtype=torch.int64, device=dev)]
        for (_, kind), v in zip([x for x in segs if x[0] == "v"], vals):
            cols.append(v.to(torch.float64).reshape(1).view(torch.int64)
                        if kind == "f" else v.to(torch.int64).reshape(1))
        if len(vals) < self.width:
            cols.append(torch.zeros(self.width - len(vals),
                                    dtype=torch.int64, device=dev))
        # room is checked before each iteration: the clamp only keeps an
        # index in bounds, and drain() raises on n past the capacity
        at = torch.clamp(self.n, max=self.cap - 1).reshape(1)
        self.rows.index_copy_(0, at, torch.cat(cols).reshape(1, -1))
        self.n.add_(1)

    def room(self, pred, dev) -> torch.Tensor:
        """The loop's predicate ANDed with the room for one more
        iteration's prints; the predicate itself is kept in `more`."""
        p = _device_pred(pred, dev)
        if p.dtype != torch.bool:
            p = p != 0
        self.more.copy_(p)
        return torch.logical_and(p, self.n + self.bound <= self.cap)

    def stopped_for_room(self, n: int, more: bool) -> bool:
        return more and n + self.bound > self.cap

    def drain(self, n: int, rows: Optional[np.ndarray], printer) -> None:
        """Prints the n records (rows read with them, or read here) and
        empties the ring."""
        if n > self.cap:
            raise RuntimeError(f"print ring: {n} records in a ring of "
                               f"{self.cap}")
        if n:
            if rows is None:
                rows = self.rows[:n].cpu().numpy()
            for r in rows[:n]:
                printer(self._line(r))
            self.n.zero_()

    def drain_to(self, printer) -> None:
        """The records so far, now, in one read counted in `reads` (a
        refused first iteration)."""
        vals = torch.cat([self.n.reshape(1),
                          self.rows.reshape(-1)]).cpu().numpy()
        self.reads += 1
        self.drain(int(vals[0]), vals[1:].reshape(self.rows.shape), printer)

    def _line(self, row) -> str:
        from systemml_tpu_torch.compiler.lower import _to_display_str

        out, j = [], 1
        for kind, x in self.formats[int(row[0])]:
            if kind == "t":
                out.append(x)
                continue
            w = int(row[j])
            j += 1
            out.append(_to_display_str(
                float(np.array(w, dtype=np.int64).view(np.float64))
                if x == "f" else bool(w) if x == "b" else w))
        return "".join(out)


class RandStream:
    """The keys of a region's unseeded rand() calls: fold_in(base, n) for
    a device counter n, loaded at each entry from the host's stream
    (ops/datagen.stream_key) and handed back at exit, so that a loop draws
    as a region the same keys it draws eagerly."""

    def __init__(self, dev):
        self.key = tuple(torch.zeros((), dtype=torch.int64, device=dev)
                         for _ in range(2))
        self.n = torch.zeros((), dtype=torch.int64, device=dev)

    def load(self) -> None:
        from systemml_tpu_torch.ops import datagen

        base, n = datagen.stream_key()
        for b, v in zip(self.key, base):
            b.fill_(v)
        self.n.fill_(n)

    def next_key(self):
        from systemml_tpu_torch.ops import datagen

        k = datagen.fold_in(self.key, self.n)
        self.n.add_(1)
        return k

    @staticmethod
    def close(n: int) -> None:
        from systemml_tpu_torch.ops import datagen

        datagen.set_stream_next(n)


# --------------------------------------------------------------------------
# nodes: a loop or an if inside a running region
# --------------------------------------------------------------------------

def _drive_while(run: RegionRun, pred_fn: Callable, body_fn: Callable,
                 dev) -> None:
    """The loop `while pred_fn(): body_fn()`: run (plain) or captured as a
    WHILE node whose body ends with the predicate's test."""
    if run.mode == "plain":
        while _truth(pred_fn()):
            body_fn()
        return
    from systemml_tpu_torch.codegen import loop_graph as lg

    if run.depth + 1 >= len(run.streams):
        raise NotLoopFusable(f"conditional nodes nested deeper than "
                             f"{MAX_DEPTH - 1}")
    cur, nxt = run.streams[run.depth], run.streams[run.depth + 1]
    h = lg.begin_node(cur.cuda_stream, nxt.cuda_stream, lg.WHILE,
                      _device_pred(pred_fn(), dev))
    run.depth += 1
    try:
        with torch.cuda.stream(nxt):
            run.scope_begin()
            body_fn()
            lg.end_node(nxt.cuda_stream, lg.WHILE, h,
                        _device_pred(pred_fn(), dev))
            run.scope_end()
    finally:
        run.depth -= 1


def _drive_if(run: RegionRun, pred, branches: Sequence[Callable], dev) -> None:
    """branches[0] if pred else branches[1]: run (plain) or captured as two
    IF nodes, the second testing pred == 0."""
    if run.mode == "plain":
        branches[0 if _truth(pred) else 1]()
        return
    from systemml_tpu_torch.codegen import loop_graph as lg

    if run.depth + 1 >= len(run.streams):
        raise NotLoopFusable(f"conditional nodes nested deeper than "
                             f"{MAX_DEPTH - 1}")
    p = _device_pred(pred, dev)
    if p.dtype != torch.bool:
        p = p != 0
    cur, nxt = run.streams[run.depth], run.streams[run.depth + 1]
    for negate, fn in ((False, branches[0]), (True, branches[1])):
        h = lg.begin_node(cur.cuda_stream, nxt.cuda_stream, lg.IF, p,
                          negate=negate)
        run.depth += 1
        try:
            with torch.cuda.stream(nxt):
                run.scope_begin()
                fn()
                lg.end_node(nxt.cuda_stream, lg.IF, h)
                run.scope_end()
        finally:
            run.depth -= 1


def _inner_buffers(run: RegionRun, loop, ec, carried, reads, dev):
    """Buffers of an inner loop's carried names: a copy of each bound
    value; for a name the loop binds first and that is read after it, a
    zero-filled buffer of the shape it had at this loop's exit in the
    first iteration (plain mode: made at its first binding instead)."""
    env = ec.vars
    missing = [n for n in carried if n not in env]
    if set(missing) & reads:
        run.fault(f"unbound read: a loop reads "
                  f"{sorted(set(missing) & reads)} before binding them")
        return None
    la = _live_after(loop)
    seen = run.observed.get(id(loop), {})
    buffers = {n: _fresh(env[n], n, dev) for n in carried if n in env}
    for n, b in buffers.items():
        # a 0-d int the first iteration widened to a double
        if n in seen and seen[n][0] == () and b.ndim == 0 \
                and seen[n][1].is_floating_point \
                and not b.is_floating_point():
            buffers[n] = b.to(seen[n][1])
    for n in missing:
        if n in la and n in seen:
            shape, dtype = seen[n]
            buffers[n] = torch.zeros(shape, dtype=dtype, device=dev)
    # any other is made at its first binding (in a capture: inside the
    # body, and zero-filled before each launch; _zero_init_new)
    return buffers


def _zero_init_new(run: RegionRun, buffers, before) -> None:
    if run.mode == "capture":
        run.zero_init.extend(b for n, b in buffers.items() if n not in before)


def _observe(run: RegionRun, loop, buffers) -> None:
    seen = run.observed.setdefault(id(loop), {})
    for n, b in buffers.items():
        seen[n] = (tuple(b.shape), b.dtype)


def exec_while(loop, ec, run: RegionRun) -> None:
    """A `while` inside a running region (the JAX package's _trace_while):
    its carried names in buffers of their own, its test on the device."""
    dev = _region_device(ec)
    pred_reads = set(loop.pred.block.hops.reads)
    reads, writes = _collect_rw(loop.body, keep=pred_reads | _live_after(loop))
    carried = sorted(writes - run.skip)
    buffers = _inner_buffers(run, loop, ec, carried, reads | pred_reads, dev)
    if buffers is None:                   # plain mode, refused: run it
        while _truth(loop.pred.eval_device(ec)):
            _run_blocks(loop.body, ec)
        return
    env = ec.vars
    env.update(buffers)
    saved = dict(env)

    def body():
        _run_blocks(loop.body, ec)
        _writeback(buffers, env, carried, dev, run)

    before = set(buffers)
    _drive_while(run, lambda: loop.pred.eval_device(ec), body, dev)
    _zero_init_new(run, buffers, before)
    env.clear()
    env.update(saved)
    env.update(buffers)
    _observe(run, loop, buffers)


def _bounds(loop, ec):
    fv = loop.from_h.eval_device(ec)
    tv = loop.to_h.eval_device(ec)
    iv = loop.incr_h.eval_device(ec) if loop.incr_h is not None else None
    return fv, tv, iv


def exec_for(loop, ec, run: RegionRun) -> None:
    """A `for` inside a running region (the JAX package's _trace_for): a
    WHILE node over a device counter K, the variable start + K * step."""
    dev = _region_device(ec)
    fv, tv, iv = _bounds(loop, ec)
    env = ec.vars
    if not any(isinstance(v, torch.Tensor) for v in (fv, tv, iv)):
        if iv is None:
            iv = 1 if tv >= fv else -1
        if not (float(iv) == int(iv) and float(fv) == int(fv)
                and float(tv) == int(tv)):
            run.fault("fractional for")
            for i in loop._range(ec):
                env[loop.var] = i
                _run_blocks(loop.body, ec)
            return
        fv, tv, iv = int(fv), int(tv), int(iv)
        n = len(range(fv, tv + (1 if iv > 0 else -1), iv))
        if n == 0:
            return
        start = torch.full((), fv, dtype=torch.int64, device=dev)
        step = torch.full((), iv, dtype=torch.int64, device=dev)
        count = torch.full((), n, dtype=torch.int64, device=dev)
    else:
        # device bounds: integral by DML's for semantics here
        f, t = (device_scalar(v, dev) if not isinstance(v, torch.Tensor)
                else v.reshape(()) for v in (fv, tv))
        f, t = f.to(torch.int64), t.to(torch.int64)
        step = (torch.where(t >= f, 1, -1) if iv is None else (
            device_scalar(iv, dev) if not isinstance(iv, torch.Tensor)
            else iv.reshape(()))).to(torch.int64)
        start = f
        count = torch.clamp(torch.div(t - f, step, rounding_mode="floor") + 1,
                            min=0)
    reads, writes = _collect_rw(loop.body, keep=_live_after(loop))
    carried = sorted((writes - run.skip) - {loop.var})
    buffers = _inner_buffers(run, loop, ec, carried, reads - {loop.var}, dev)
    if buffers is None:
        for i in loop._range(ec):
            env[loop.var] = i
            _run_blocks(loop.body, ec)
        return
    k = torch.zeros((), dtype=torch.int64, device=dev)
    var = start.clone()
    env.update(buffers)
    saved = dict(env)

    def body():
        var.copy_(start + k * step)
        env[loop.var] = var
        _run_blocks(loop.body, ec)
        k.add_(1)
        _writeback(buffers, env, carried, dev, run)

    before = set(buffers)
    _drive_while(run, lambda: k < count, body, dev)
    _zero_init_new(run, buffers, before)
    env.clear()
    env.update(saved)
    env.update(buffers)
    env[loop.var] = var
    _observe(run, loop, buffers)


def exec_if(blk, ec, run: RegionRun, pred) -> None:
    """An `if` whose predicate is a device value, inside a running region
    (the JAX package's _trace_if): the names either branch binds go
    through merge buffers, so that what follows reads one address."""
    dev = _region_device(ec)
    _, iw = _collect_rw(blk.if_body)
    _, ew = _collect_rw(blk.else_body)
    carried = sorted((iw | ew) - run.skip)
    env = ec.vars
    # a name unbound before the if gets its buffer at its first binding;
    # one bound by one branch only keeps, when the other runs, what it
    # held (zeros before its first binding, as the JAX package's seeds)
    buffers = {n: _fresh(env[n], n, dev) for n in carried if n in env}
    before = set(buffers)
    saved = dict(env)

    def branch(body):
        def fn():
            env.clear()
            env.update(saved)
            _run_blocks(body, ec)
            _writeback(buffers, env, carried, dev, run)
        return fn

    _drive_if(run, pred, (branch(blk.if_body), branch(blk.else_body)), dev)
    _zero_init_new(run, buffers, before)
    env.clear()
    env.update(saved)
    env.update(buffers)


# --------------------------------------------------------------------------
# capture streams and graph entries
# --------------------------------------------------------------------------

_streams: Dict[int, List[torch.cuda.Stream]] = {}
_live_graphs: "weakref.WeakSet" = weakref.WeakSet()


def capture_streams(dev) -> List[torch.cuda.Stream]:
    """MAX_DEPTH side streams of `dev`, one per nesting level of a
    capture, made once: each has run a cuBLAS product (its handle and
    workspace exist outside any graph's pool) and has its spoof reduce
    scratch (codegen/kernels._reduce_scratch), so that a capture
    allocates neither."""
    from systemml_tpu_torch.codegen import kernels

    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    hit = _streams.get(dev.index)
    if hit is None:
        hit = []
        with torch.cuda.device(dev):
            a = torch.ones(16, 16, device=dev)
            for _ in range(MAX_DEPTH):
                s = torch.cuda.Stream(dev)
                s.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(s):
                    torch.mm(a, a)
                    torch.matmul(a.T, a[:, :1])
                    torch.mm(a.double(), a.double())
                    kernels._reduce_scratch(dev, s.cuda_stream)
                hit.append(s)
            torch.cuda.synchronize(dev)
        _streams[dev.index] = hit
    return hit


def live_graphs() -> int:
    """Region graphs alive in this process (each dies with its Program)."""
    return len(_live_graphs)


class _Entry:
    """One instantiated region (or, on the CPU, its static buffers):
    the buffers of its carried names and of its invariants passed as
    values, and for a graph its executable, pool and body counters."""

    def __init__(self, buffers, inv_buffers, peel_kinds):
        self.buffers: Dict[str, torch.Tensor] = buffers
        self.inv_buffers: Dict[str, torch.Tensor] = inv_buffers
        self.peel_kinds: Dict[str, type] = peel_kinds
        self.graph = self.exec = None
        self.pool = None
        self.counters: Optional[torch.Tensor] = None
        self.scopes: List[Tuple[int, Dict[tuple, int]]] = []
        self.root: Dict[tuple, int] = {}
        self.zero_init: List[torch.Tensor] = []
        self.nodes = 0
        self.launched = False
        # the host-kind scalars the last launch's exit read, by name
        self.host: Optional[Dict[str, float]] = None

    def __del__(self):
        if (self.exec is not None or self.graph is not None) \
                and not sys.is_finalizing():
            from systemml_tpu_torch.codegen import loop_graph as lg

            g, x = self.graph, self.exec
            self.graph = self.exec = None
            lg.destroy(g, x)


# --------------------------------------------------------------------------
# FusedLoop: one planned region's executor
# --------------------------------------------------------------------------

class _Scan:
    """What the refusal scan reads from a loop nest, once per loop."""

    def __init__(self, loop, kind: str):
        from systemml_tpu_torch.compiler.lower import _static_shape_names

        # the print records one top-level iteration may write (both
        # branches of an if counted), the value leaves of the widest
        # print, whether a print sits inside an inner loop, and whether a
        # rand may take the region's stream (no seed, or one not a
        # literal)
        self.prints = self.width = 0
        self.print_inner = self.rand = self.recursive = False
        # builtins whose output shape or value needs a host read
        # (_host_op), by their classified reason
        self.host_ops: Set[str] = set()
        self.bounds: Set[str] = set()
        self.writes: Set[str] = set()
        # the functions the walk is inside (a recursion guard)
        self._seen: Set[int] = set()
        self._vary: Dict[int, bool] = {}
        _, self.writes, _ = _collect_rw_seq(loop.body)
        if kind == "for":
            self.writes |= {loop.var}
        self._walk(loop.body, top=True, inner=False)
        self.shape_names = _static_shape_names(loop.body, sizing_only=True)

    def _mark(self, h) -> None:
        for x in postorder([h]):
            if x.op == "tread":
                self.bounds.add(x.name)

    def _varies(self, h) -> bool:
        """Whether a bound's value changes in the loop: it reads a name
        the nest writes, other than through its shape (a region keeps
        every carried shape)."""
        hit = self._vary.get(h.id)
        if hit is None:
            hit = self._vary[h.id] = (
                False if h.op in ("nrow", "ncol", "length")
                else h.name in self.writes if h.op == "tread"
                else any(self._varies(c) for c in h.inputs))
        return hit

    def _base(self, h):
        """The loop-varying term of an affine bound, b(+)/b(-) with a
        loop-invariant side peeled (the hop form of compiler/lower.
        Evaluator._affine); None for a loop-invariant bound."""
        if not self._varies(h):
            return None
        if h.op in ("b(+)", "b(-)"):
            x, y = h.inputs
            if not self._varies(y):
                return self._base(x)
            if h.op == "b(+)" and not self._varies(x):
                return self._base(y)
        return ("tread", h.name) if h.op == "tread" else h.id

    def _slice(self, h) -> None:
        """Marks the names of a slice's bounds unless each dimension's
        extent is static: lo and hi one varying term apart by an
        invariant (the minibatch X[beg:beg+bs-1,]), which the evaluator
        slices at a device offset."""
        first = 1 if h.op == "idx" else 2
        for d in range(2):
            pair = h.inputs[first + 2 * d:first + 2 * d + 2]
            if len(pair) == 2 and self._base(pair[0]) != self._base(pair[1]):
                for c in pair:
                    self._mark(c)

    def _print(self, sink, inner: bool) -> None:
        if inner:
            self.print_inner = True
            return
        self.prints += 1
        leaves = []
        stack = list(sink.inputs[:1])
        while stack:
            x = stack.pop()
            if x.op == "b(+)" and x.dt == "string":
                stack.extend(x.inputs)
            elif not (x.op == "lit" and isinstance(x.value, str)):
                leaves.append(x)
        self.width = max(self.width, len(leaves))

    def _hops(self, roots, b, top: bool, inner: bool) -> None:
        for h in postorder(roots):
            if h.op in ("call:rand", "call:Rand"):
                argn = h.params.get("argnames") or []
                seed = [c for n, c in zip(argn, h.inputs) if n == "seed"]
                if not seed or seed[0].op != "lit" or seed[0].value == -1:
                    self.rand = True
            elif h.op.startswith("call:"):
                reason = _host_op(h)
                if reason is not None:
                    self.host_ops.add(reason)
            elif top and h.op in _SHAPE_POSITIONS:
                self._slice(h)
            elif h.op == "fcall" and b is not None:
                fb = b.program.resolve_function(
                    b.file_id, h.params.get("namespace"), h.params.get("name"))
                if fb is None:
                    continue
                # each call walks its function, a print there counting
                # as one of the caller's (inside an inner loop only if
                # the call is); a recursive call repeats a body as often
                # as the data says, so no print of the region is bounded
                if id(fb) in self._seen:
                    self.recursive = True
                    continue
                self._seen.add(id(fb))
                self._walk(fb.blocks, top=False, inner=inner)
                self._seen.discard(id(fb))

    def _walk(self, blocks, top: bool, inner: bool) -> None:
        from systemml_tpu_torch.runtime import program as P

        for b in blocks:
            if isinstance(b, P.BasicBlock):
                for sink in b.hops.sinks:
                    if sink.op == "call:print":
                        self._print(sink, inner)
                self._hops(b.hops.roots(), b, top, inner)
                continue
            for p in P._predicates(b):
                self._hops(p.block.hops.roots(), None, top, inner)
            if isinstance(b, P.IfBlock):
                self._walk(b.if_body, top, inner)
                self._walk(b.else_body, top, inner)
            elif isinstance(b, (P.WhileBlock, P.ForBlock)):
                self._walk(b.body, top, True)


_HOST_INV = {"qt", "qf", "qchisq"}


def _host_op(h) -> Optional[str]:
    """The refusal reason of a builtin call that reads the host: removeEmpty
    (its shape is the data's), table without both dims (it reads the ids'
    maxima), an inverse t, chisq or F distribution (scipy on the host),
    and invcdf whose dist is not a literal that stays on the device."""
    name = h.op[5:]
    argn = h.params.get("argnames") or [None] * len(h.inputs)
    named = {n: c for n, c in zip(argn, h.inputs) if n is not None}
    npos = sum(1 for n in argn if n is None)
    if name == "removeEmpty":
        return "removeEmpty"
    if name == "table" and npos < 4 and not (
            "odim1" in named and "odim2" in named):
        return "table without dims"
    if name in _HOST_INV:
        return "host distribution"
    if name in ("invcdf", "icdf"):
        d = named.get("dist")
        if d is not None and not (d.op == "lit"
                                  and d.value in ("normal", "exp")):
            return "host distribution"
    return None


class FusedLoop:
    """The executor of one While/For block's region. The plan comes from
    compile_program (compiler/lower.plan_loop_regions); a loop planned
    inside a parent region (an `inlined` marker) reaches this only when
    the parent was refused, and derives its plan at its first entry, as
    the JAX package's FusedLoop does for plan-less loops. Holds no
    reference to its block (the block holds it), so that a dropped
    Program frees its graphs without the cyclic collector."""

    def __init__(self, loop, kind: str):
        region = getattr(loop, "_region", None)
        self.kind = kind
        self.region = None if (region is None or region.inlined) else region
        self.refused: Optional[str] = None
        self._scan: Optional[_Scan] = None
        self._cache: Dict[tuple, _Entry] = {}
        # the print ring and the rand stream, per device (a graph bakes
        # their addresses in); those of the running entry
        self._rings: Dict[str, PrintRing] = {}
        self._streams: Dict[str, RandStream] = {}
        self._ring: Optional[PrintRing] = None
        self._stream: Optional[RandStream] = None
        # what chip_smoke.py and the tests read; drains: the launches
        # after one that stopped for the print ring's room
        self.record = {"entries": 0, "captures": 0, "launches": 0,
                       "host_syncs": 0, "static_reads": 0, "trips": [],
                       "drains": 0, "refused": None}

    # ---- plan and refusal -------------------------------------------------

    def plan(self, loop):
        if self.region is None:
            r = _plan_one_region(loop, self.kind)
            c = list(r.carried)
            r.label = "{}[{}{}]".format(self.kind, ",".join(c[:3]),
                                        ",..." if len(c) > 3 else "")
            self.region = r
        return self.region

    def _refuse(self, ec, site: str, reason: str, label: str,
                counted: bool = True) -> None:
        from systemml_tpu_torch.obs import trace as obs

        self.refused = reason
        self.record["refused"] = reason
        obs.instant("loop_fallback", obs.CAT_RESIL, site=site,
                    kind="unfusable", permanent=True, region=label,
                    reason=reason)
        if counted:
            ec.stats.count_estim("loop_regions_refused")

    def _entry_refusal(self, loop, ec, plan) -> Optional[str]:
        """The first classified reason this entry cannot be captured: the
        body's own (a print the ring cannot bound, a builtin that reads
        the host, static_names) before the data's (carried string, sparse
        carried). A compressed op that reads the host refuses in the
        peel, by its name."""
        if self._scan is None:
            self._scan = _Scan(loop, self.kind)
        sc = self._scan
        if sc.print_inner:
            return "print in inner loop"
        if sc.prints and sc.recursive:
            return "print ring: a print beside a recursive call"
        if sc.prints > RING_RECORDS:
            return (f"print ring: {sc.prints} prints an iteration, "
                    f"{RING_RECORDS} records a ring")
        for r in REASONS:
            if r in sc.host_ops:
                return r
        if sc.writes & (sc.shape_names | sc.bounds):
            return "static_names"
        env = ec.vars
        if any(isinstance(env.get(n), str) for n in plan.carried):
            return "carried string"
        if any(sp.is_sparse(env.get(n)) or sp.is_ell(env.get(n))
               for n in plan.carried):
            return "sparse carried"
        return None

    # ---- entry ------------------------------------------------------------

    def run_while(self, loop, ec) -> bool:
        return self._run(loop, ec, "while")

    def run_for(self, loop, ec) -> bool:
        return self._run(loop, ec, "for")

    def _run(self, loop, ec, kind: str) -> bool:
        """Runs the loop as a region; False when it is refused (now or
        before), and the caller runs it eagerly."""
        if self.refused is not None:
            return False
        plan = self.plan(loop)
        label = plan.label
        if plan.refused is not None:
            self._refuse(ec, f"{kind}.region", plan.refused, label,
                         counted=False)
            return False
        iters = None
        if kind == "for":
            iters = list(loop._range(ec))
            if not iters:
                return True
            if len(iters) <= 2 or not all(
                    isinstance(i, int) and not isinstance(i, bool)
                    for i in iters):
                return False      # not worth a graph, as the JAX package
        reason = self._entry_refusal(loop, ec, plan)
        views = {}
        if reason is None:
            views, reason = self._views(ec, plan)
        if reason is not None:
            self._refuse(ec, f"{kind}.entry", reason, label)
            return False
        dev = _region_device(ec)
        if dev.type == "cuda":
            from systemml_tpu_torch.codegen import loop_graph as lg

            lg.check_versions()
        env = ec.vars
        sparse = {n: env[n] for n in views}
        env.update(views)
        try:
            return self._enter(loop, ec, plan, kind, iters, dev)
        finally:
            for n, sm in sparse.items():
                if env.get(n) is views[n]:
                    env[n] = sm

    def _views(self, ec, plan):
        """({name: device view} of the loop-invariant sparse reads, the
        refusal reason or None), the views budgeted together at cap / 8
        by their device storage (a transposed dense view shares its
        parent's and adds none)."""
        env = ec.vars
        views = {}
        storages = {}
        for n in sorted((set(plan.reads) | set(plan.pred_reads))
                        - set(plan.carried)):
            v = env.get(n)
            if not sp.is_sparse(v):
                continue
            dv = sp.loop_device_view(v)
            if dv is None:
                return {}, "sparse view"
            for t in ((dv.idx, dv.val) if sp.is_ell(dv) else (dv,)):
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
            if sum(storages.values()) > sp.device_budget() / 8:
                return {}, "sparse view"
            views[n] = dv
        self.record["views"] = {n: "ell" if sp.is_ell(dv) else "dense"
                                for n, dv in views.items()}
        return views, None

    def _key(self, env, plan, carried, traced, kind, iters) -> tuple:
        parts = []
        for n in sorted(set(plan.reads) | set(plan.pred_reads)
                        | set(carried)):
            v = env.get(n, _ABSENT)
            if v is _ABSENT:
                parts.append((n, "absent"))
            elif isinstance(v, torch.Tensor):
                if n in carried or v.numel() == 1:
                    parts.append((n, "s", tuple(v.shape), v.dtype))
                else:
                    parts.append((n, "t", tuple(v.shape), v.stride(), v.dtype,
                                  v.data_ptr()))
            elif _is_number(v):
                if n in carried or n in traced:
                    parts.append((n, "n", type(v)))
                else:
                    parts.append((n, "v", type(v), v))
            elif isinstance(v, str):
                parts.append((n, "v", str, v))
            elif sp.is_ell(v):
                # an ELL view signs by its leaves: another width or
                # another tensor is another graph
                parts.append((n, "e", v.shape,
                              tuple(v.idx.shape), v.idx.data_ptr(),
                              v.val.dtype, v.val.data_ptr()))
            else:
                parts.append((n, "o", type(v).__name__, id(v)))
        return (kind, tuple(parts))

    def _enter(self, loop, ec, plan, kind, iters, dev) -> bool:
        env = ec.vars
        stats = ec.stats
        carried = [n for n in plan.carried if n != getattr(loop, "var", None)]
        # an invariant that sizes something in the body (MultiLogReg's
        # k = max(Y) - 1 under matrix(0, cols=k)) is a host number inside
        # the region: read once here, and part of the key, as the JAX
        # package's _env_of fetches it
        statics = {}
        for n in plan.static_names:
            v = env.get(n)
            if n not in carried and isinstance(v, torch.Tensor) \
                    and v.numel() == 1:
                statics[n] = v
                x = v.item()
                env[n] = x if v.is_floating_point() or v.dtype == torch.bool \
                    else int(x)
        if statics:
            self.record["host_syncs"] += 1
            self.record["static_reads"] += 1
        traced = {n for n in plan.traced_ints
                  if isinstance(env.get(n), int)
                  and not isinstance(env.get(n), bool)}
        inv_small = {n for n in set(plan.reads) | set(plan.pred_reads)
                     if n not in carried and isinstance(env.get(n), torch.Tensor)
                     and env[n].numel() == 1}
        key = self._key(env, plan, set(carried), traced, kind, iters)
        pre_kinds = {n: type(env[n]) for n in carried
                     if n in env and _is_number(env[n])}
        originals = {n: env[n] for n in set(carried) | traced | inv_small
                     if n in env}
        originals.update(statics)
        for n in set(carried) | traced:
            if n in env and _is_number(env[n]):
                env[n] = device_scalar(env[n], dev)
        self.record["entries"] += 1
        # step 3: the entry test, one sync
        if kind == "while":
            if not _truth(loop.pred.eval_device(ec)):
                self.record["host_syncs"] += 1
                self.record["trips"].append(0)
                env.update({n: v for n, v in originals.items()
                            if n in pre_kinds or n in traced
                            or n in statics})
                # an entry counts whatever its trips, as the JAX
                # package's region dispatch does
                stats.count_region(plan.label)
                return True
            self.record["host_syncs"] += 1
        self._io(dev)
        entry = self._cache.get(key)
        peeled = 0
        if entry is None:
            # step 4: the first iteration, eagerly, with the region's kinds
            run = self._run_state("plain", plan, stats)
            pre = {n: _sig(env[n]) for n in carried if n in env}
            if kind == "for":
                env[loop.var] = device_scalar(iters[0], dev)
            with region_scope(run):
                _run_blocks(loop.body, ec)
            peeled = 1
            reason = run.refusal or _shape_change(pre, env, carried)
            if reason is not None:
                self._refuse(ec, f"{kind}.peel", reason, plan.label)
                self._io_refused(ec)
                _host_kinds_back(env, carried, originals)
                if kind == "for":
                    for i in iters[1:]:
                        env[loop.var] = i
                        _run_blocks(loop.body, ec)
                    env[loop.var] = iters[-1]
                else:
                    while loop.pred.eval_bool(ec):
                        _run_blocks(loop.body, ec)
                return True
            names = [n for n in carried if n in env]
            peel_kinds = {n: type(env[n]) for n in names
                          if _is_number(env[n])}
            buffers = {n: _fresh(env[n], n, dev) for n in names}
            inv_buffers = {n: _fresh(env[n], n, dev)
                           for n in traced | inv_small}
            entry = _Entry(buffers, inv_buffers, peel_kinds)
            if kind == "for":
                for nm, v in (("start", iters[0]), ("step", 1),
                              ("count", len(iters)), ("k", 1)):
                    entry.inv_buffers[f"\0{nm}"] = device_scalar(v, dev)
                entry.inv_buffers["\0step"].fill_(
                    iters[1] - iters[0] if len(iters) > 1 else 1)
            if dev.type == "cuda":
                self._capture(loop, ec, plan, kind, entry, run, dev)
                self.record["captures"] += 1
            if len(self._cache) >= CACHE_CAP:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = entry
        else:
            _load(entry, env, carried, traced | inv_small, kind, iters)
        launches0 = self.record["launches"]
        trips = peeled + self._loop(loop, ec, plan, kind, entry, dev)
        self.record["trips"].append(trips)
        _exit(entry, env, pre_kinds, originals,
              traced | inv_small | set(statics))
        if kind == "for":
            env[loop.var] = iters[-1]
        stats.count_region(plan.label)
        from systemml_tpu_torch.obs import trace as obs

        if obs.recording():
            obs.instant("region_dispatch", obs.CAT_RUNTIME, region=plan.label,
                        kind=kind, pred="device", carried=len(carried),
                        outer_iters=trips, captured=dev.type == "cuda",
                        graph_launches=self.record["launches"] - launches0)
        return True

    def _io(self, dev) -> None:
        """The entry's print ring (emptied) and rand stream (loaded from
        the host's), where the body prints or draws."""
        sc, d = self._scan, str(dev)
        self._ring = self._stream = None
        if sc.prints:
            ring = self._rings.get(d)
            if ring is None:
                ring = self._rings[d] = PrintRing(dev, sc.width, sc.prints)
            ring.n.zero_()
            self._ring = ring
        if sc.rand:
            st = self._streams.get(d)
            if st is None:
                st = self._streams[d] = RandStream(dev)
            st.load()
            self._stream = st

    def _io_refused(self, ec) -> None:
        """After a refused first iteration: what the ring holds is printed
        and the host's rand stream goes on after the iteration's draws, a
        host read each (the ring's also where the peel drained it)."""
        ring, stream = self._ring, self._stream
        if ring is not None:
            ring.drain_to(ec.printer)
            self.record["host_syncs"] += ring.reads
            ring.reads = 0
        if stream is not None:
            RandStream.close(int(stream.n))
            self.record["host_syncs"] += 1

    def _run_state(self, mode: str, plan, stats) -> RegionRun:
        run = RegionRun(mode, plan.drop, self._scan.writes, stats)
        run.ring, run.stream = self._ring, self._stream
        return run

    # ---- the loop after the entry: plain arm or one graph launch ---------

    def _loop(self, loop, ec, plan, kind, entry, dev) -> int:
        """Runs the loop's remaining iterations over the entry's buffers
        and returns how many ran: one graph launch (or the plain arm),
        and again after each stop for the print ring's room, once the
        host has printed its records."""
        env = ec.vars
        saved = {n: env[n] for n in env}
        ring = self._ring
        stream = self._stream
        trips = 0
        first = True
        while True:
            if dev.type == "cuda":
                t, n_stream, rows = self._launch(entry, ec, dev, first)
            else:
                run = self._run_state("plain", plan, ec.stats)
                pred_fn, body_fn, count = self._closures(loop, ec, kind,
                                                         entry, dev)
                with region_scope(run):
                    _drive_while(run, pred_fn, body_fn, dev)
                # the CPU's tensors: read without a device sync
                t = count()
                n_stream = None if stream is None else int(stream.n)
                rows = None if ring is None else (int(ring.n),
                                                  bool(ring.more), None)
            trips += t
            first = False
            if ring is None:
                break
            n, more, recs = rows
            ring.drain(n, recs, ec.printer)
            if not ring.stopped_for_room(n, more):
                break
            self.record["drains"] += 1
        env.clear()
        env.update(saved)
        # the ring is drained: the launch's one read brought its records;
        # the host's rand stream goes on after the region's draws
        if stream is not None:
            RandStream.close(n_stream)
        return trips

    def _closures(self, loop, ec, kind, entry, dev):
        """(pred_fn, body_fn, trips so far) of the loop over the entry's
        buffers, which it installs in env."""
        env = ec.vars
        env.update(entry.buffers)
        env.update({n: b for n, b in entry.inv_buffers.items()
                    if not n.startswith("\0")})
        names = list(entry.buffers)
        done = [0]
        if kind == "while":
            def pred_fn():
                return loop.pred.eval_device(ec)
        else:
            k = entry.inv_buffers["\0k"]
            n = entry.inv_buffers["\0count"]
            start = entry.inv_buffers["\0start"]
            step = entry.inv_buffers["\0step"]
            var = entry.inv_buffers.setdefault(
                "\0var", torch.zeros((), dtype=torch.int64, device=dev))

            def pred_fn():
                return k < n

        ring = self._ring
        if ring is not None:
            loop_pred = pred_fn

            def pred_fn():
                return ring.room(loop_pred(), dev)

        def body_fn():
            if kind == "for":
                var.copy_(start + k * step)
                env[loop.var] = var
            _run_blocks(loop.body, ec)
            if kind == "for":
                k.add_(1)
            _writeback(entry.buffers, env, names, dev)
            done[0] += 1

        return pred_fn, body_fn, (lambda: done[0])

    def _capture(self, loop, ec, plan, kind, entry, peel_run, dev) -> None:
        """Captures the rest of the loop over the entry's buffers into one
        graph (step 5) and instantiates it."""
        from systemml_tpu_torch.codegen import loop_graph as lg

        env = ec.vars
        stats = ec.stats
        streams = capture_streams(dev)
        if torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(
                dev) > RELEASE_BYTES:
            torch.cuda.empty_cache()      # the peel's cached blocks
        entry.pool = torch.cuda.MemPool()
        entry.counters = torch.zeros(MAX_SCOPES, dtype=torch.int64,
                                     device=dev)
        run = self._run_state("capture", plan, stats)
        run.streams, run.counters = streams, entry.counters
        run.observed = peel_run.observed
        saved = {n: env[n] for n in env}
        root0 = _snapshot(stats)
        s0 = streams[0]
        s0.wait_stream(torch.cuda.current_stream(dev))
        graph = None
        try:
            with torch.cuda.device(dev), torch.cuda.stream(s0), \
                    torch.cuda.use_mem_pool(entry.pool, dev), \
                    region_scope(run):
                pred_fn, body_fn, _ = self._closures(loop, ec, kind, entry,
                                                     dev)
                lg.capture_begin(s0.cuda_stream)
                _drive_while(run, pred_fn, body_fn, dev)
                graph = lg.capture_end(s0.cuda_stream)
        except BaseException:
            for i in range(len(streams) - 1, -1, -1):
                lg.abort(streams[i].cuda_stream, destroy_graph=i == 0)
            raise
        finally:
            env.clear()
            env.update(saved)
        entry.graph = graph
        entry.nodes = lg.num_nodes(graph)
        entry.exec = lg.instantiate(graph)
        entry.scopes = run.scopes
        entry.zero_init = run.zero_init
        entry.root = _delta(_delta(_snapshot(stats), root0), run._top_incl)
        _live_graphs.add(entry)

    def _launch(self, entry: _Entry, ec, dev, first_of_entry: bool):
        """One graph launch and its one sync: reads the body counters, the
        host-kind scalars, the rand stream's counter and the print ring,
        and scales each body's counts by its executions. Returns (trips
        the graph ran, the stream's counter or None, (records, the loop's
        own predicate, the records' rows) or None)."""
        from systemml_tpu_torch.codegen import loop_graph as lg

        n = len(entry.scopes)
        entry.counters[:n].zero_()
        if first_of_entry:
            # a relaunch after a drain goes on from the buffers
            for b in entry.zero_init:
                b.zero_()
        lg.launch(entry.exec, torch.cuda.current_stream(dev).cuda_stream)
        self.record["launches"] += 1
        host = [(nm, b) for nm, b in entry.buffers.items() if b.ndim == 0]
        ring, stream = self._ring, self._stream
        # one int64 read: the doubles as their bits
        parts = [entry.counters[:n]] + [
            b.reshape(1).to(torch.float64).view(torch.int64)
            for _, b in host]
        if stream is not None:
            parts.append(stream.n.reshape(1))
        if ring is not None:
            parts += [ring.n.reshape(1), ring.more.reshape(1).to(torch.int64),
                      ring.rows.reshape(-1)]
        vals = torch.cat(parts).cpu().numpy()
        self.record["host_syncs"] += 1
        execs = [int(v) for v in vals[:n]]
        at = n + len(host)
        entry.host = dict(zip([nm for nm, _ in host],
                              vals[n:at].view(np.float64).tolist()))
        n_stream = rows = None
        if stream is not None:
            n_stream = int(vals[at])
            at += 1
        if ring is not None:
            rows = (int(vals[at]), bool(vals[at + 1]),
                    vals[at + 2:].reshape(ring.rows.shape))
        # the capture counted the root once and each body once
        first = not entry.launched
        entry.launched = True
        if not first:
            _apply(ec.stats, entry.root, 1)
        for idx, delta in entry.scopes:
            _apply(ec.stats, delta, execs[idx] - (1 if first else 0))
        self.record["nodes"] = entry.nodes
        self.record["bodies"] = [
            {"executions": execs[idx], "launches": kernel_launches(delta)}
            for idx, delta in sorted(entry.scopes)]
        top = [idx for idx, _ in entry.scopes if idx == 0]
        return (execs[0] if top else 0), n_stream, rows


def _sig(v) -> tuple:
    if isinstance(v, torch.Tensor):
        return ("t", tuple(v.shape), v.dtype)
    if isinstance(v, str):
        return ("s",)
    return ("n", type(v))


def _shape_change(pre: Dict[str, tuple], env, carried) -> Optional[str]:
    """The classified reason when a carried value changed in the first
    iteration beyond what a static buffer holds: its shape, a matrix's
    dtype, or its kind (a scalar turned matrix or string)."""
    for n in carried:
        if n not in env:
            continue
        v = env[n]
        if isinstance(v, str) or not (isinstance(v, torch.Tensor)
                                      or _is_number(v)):
            return "carried string"
        p = pre.get(n)
        if p is None:
            continue
        s = _sig(v)
        if p[0] == "t" and s[0] == "t":
            if p[1] != s[1] and not (len(p[1]) + len(s[1]) <= 2
                                     and np.prod(p[1]) == np.prod(s[1]) == 1):
                return "shape change"
            if len(s[1]) > 0 and p[2] != s[2]:
                return "shape change"
        elif s[0] == "t" and len(s[1]) > 0:
            return "shape change"
    return None


def _host_kinds_back(env, carried, originals) -> None:
    """After a refusal in the peel: each carried 0-d tensor that was a
    host number before the loop, and each 0-d int or bool tensor the
    region made, is a host number again for the eager loop."""
    for n in carried:
        v = env.get(n)
        if not (isinstance(v, torch.Tensor) and v.ndim == 0):
            continue
        if n in originals and _is_number(originals[n]):
            env[n] = type(originals[n])(v.item())
        elif v.dtype == torch.bool:
            env[n] = bool(v.item())
        elif not v.is_floating_point():
            env[n] = int(v.item())
    for n, v in originals.items():
        if n not in carried:
            env[n] = v


def _load(entry: _Entry, env, carried, invariants, kind, iters) -> None:
    """A cache hit: the loop's values before its first iteration into the
    entry's buffers (a name unbound before the loop is written before it
    is read, so its buffer's old value is never seen)."""
    for n, b in entry.buffers.items():
        if n in env:
            _store(b, env[n], n)
    for n in invariants:
        if n in env:
            _store(entry.inv_buffers[n], env[n], n)
    if kind == "for":
        entry.inv_buffers["\0start"].fill_(iters[0])
        entry.inv_buffers["\0step"].fill_(
            iters[1] - iters[0] if len(iters) > 1 else 1)
        entry.inv_buffers["\0count"].fill_(len(iters))
        entry.inv_buffers["\0k"].fill_(0)


def _exit(entry: _Entry, env, pre_kinds, originals, invariants) -> None:
    """Binds each carried name after the loop: a host-kind scalar as the
    Python type it had before the loop (or after its first iteration, for
    a name the loop binds first), any other value as a copy of its
    buffer (the graph writes the buffer again at its next launch)."""
    host = entry.host
    for n, b in entry.buffers.items():
        if (n in pre_kinds or n in entry.peel_kinds) and b.ndim == 0:
            # the buffer's dtype, not the first kind: an int the body
            # turned into a double leaves as a double
            x = host[n] if host is not None and n in host else b.item()
            env[n] = bool(x) if b.dtype == torch.bool else (
                float(x) if b.is_floating_point() else int(round(x)))
        else:
            env[n] = b.clone()
    entry.host = None
    for n in invariants:
        if n in originals:
            env[n] = originals[n]


def region_report(program) -> List[dict]:
    """Per planned region of a program's blocks (functions included): its
    label, plan state and what its FusedLoop recorded."""
    from systemml_tpu_torch.runtime import program as P

    out = []

    def walk(blocks):
        for b in blocks:
            if isinstance(b, (P.WhileBlock, P.ForBlock)):
                r = getattr(b, "_region", None)
                fl = getattr(b, "_fused_loop", None)
                if r is not None and (not r.inlined or fl is not None):
                    rec = dict(fl.record) if fl is not None else {}
                    out.append({"label": (fl.region.label if fl is not None
                                          and fl.region is not None
                                          else r.label),
                                "planned_refused": r.refused,
                                "inlined": r.inlined, **rec})
                walk(b.body)
            elif isinstance(b, P.IfBlock):
                walk(b.if_body)
                walk(b.else_body)

    walk(program.blocks)
    for fb in program.functions.values():
        walk(fb.blocks)
    return out
