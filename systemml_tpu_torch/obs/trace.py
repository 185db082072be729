# Copy of systemml_tpu/obs/trace.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""Event bus + spans: the flight recorder every layer reports into.

Design contract (what the instrumentation sites rely on):

- **Near-zero cost when off.** ``span()``/``instant()`` first check the
  process-global recorder slot; with no recorder installed they return a
  shared no-op object / return immediately. Hot paths (per-block
  execute, pool admit) stay un-taxed.
- **Thread- and context-safe.** Events append under a lock; span
  parent/child nesting is tracked in a ``contextvars.ContextVar`` so
  concurrent parfor workers (each thread runs its own context) and
  nested ``stats_scope``-style regions never corrupt each other's
  stacks. The recorder itself is process-global on purpose: worker
  threads spawned by ThreadPoolExecutor do not inherit the caller's
  context, and the reference's Statistics singleton has the same
  whole-process scope.
- **Bounded.** A ring buffer (capacity from config ``trace_max_events``,
  default 1M events) keeps the most RECENT events: overflow evicts the
  oldest event and counts it in ``dropped_events``, so a long serving
  run can leave ``-trace`` on without unbounded growth and a crash
  still has the tail of the story. Exporters annotate the truncation.

Spans are "complete" events (wall-clock start + duration, Chrome-trace
``ph=X``); instants are point events (``ph=i``). Nesting in the Chrome
viewer comes from time containment per thread; the explicit ``parent``
id is additionally recorded for JSONL causality analysis.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

# stable category names (Chrome-trace `cat`): exporters, summaries and
# tests key on these
CAT_COMPILE = "compile"    # parse/validate/HOP build/rewrites/IPA/lower/XLA
CAT_RUNTIME = "runtime"    # program-block entry/exit, dispatch, transfers
CAT_POOL = "pool"          # buffer-pool admit/evict/spill/restore/donate
CAT_MESH = "mesh"          # dist-op dispatch + collective kind/bytes
CAT_REWRITE = "rewrite"    # per-rule fired instants (rw_*)
CAT_PARFOR = "parfor"      # parfor planning + task dispatch
CAT_RESIL = "resil"        # fault/retry/requeue/degrade decisions (resil/)
CAT_SERVING = "serving"    # bucketed dispatch + micro-batch flushes (api/serving.py)
CAT_CODEGEN = "codegen"    # kernel-backend selection/fallback (codegen/backend.py)
CAT_ANALYSIS = "analysis"  # lifetime-pass verdicts + donation sanitizer (analysis/)
CAT_FLEET = "fleet"        # fleet identity/steps/clock probes (obs/fleet.py)


class TraceEvent:
    """One event. ``ph`` is 'X' (complete span) or 'i' (instant);
    timestamps are perf_counter_ns (monotonic, ns)."""

    __slots__ = ("id", "name", "cat", "ph", "ts", "dur", "tid", "parent",
                 "args")

    def __init__(self, id: int, name: str, cat: str, ph: str, ts: int,
                 dur: int, tid: int, parent: Optional[int],
                 args: Optional[Dict[str, Any]]):
        self.id = id
        self.name = name
        self.cat = cat
        self.ph = ph
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.parent = parent
        self.args = args

    def __repr__(self):
        return (f"<TraceEvent {self.cat}:{self.name} ph={self.ph} "
                f"dur={self.dur / 1e6:.3f}ms>")


class FlightRecorder:
    """Thread-safe append-only event log with optional live listeners
    (the "bus" half: a listener sees every event as it lands, so live
    consumers — progress UIs, watchdogs — can subscribe without
    polling the log)."""

    def __init__(self, max_events: Optional[int] = None):
        if max_events is None:
            from systemml_tpu_torch.utils.config import get_config

            max_events = int(getattr(get_config(), "trace_max_events",
                                     1_000_000))
        self.max_events = max_events
        self.dropped = 0
        self._events: Deque[TraceEvent] = collections.deque(
            maxlen=max_events)
        self._lock = threading.Lock()
        self._listeners: List[Callable[[TraceEvent], None]] = []
        self._ids = itertools.count(1)

    @property
    def dropped_events(self) -> int:
        """Events evicted from the ring (the honest-truncation counter
        exporters annotate)."""
        return self.dropped

    # ---- bus -------------------------------------------------------------

    def subscribe(self, fn: Callable[[TraceEvent], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def emit(self, ev: TraceEvent) -> None:
        with self._lock:
            # ring semantics: at capacity the deque evicts the OLDEST
            # event on append — count the eviction so no truncation is
            # ever silent
            if len(self._events) == self.max_events:
                self.dropped += 1
            self._events.append(ev)
            listeners = tuple(self._listeners)
        for fn in listeners:
            try:
                fn(ev)
            except Exception:
                pass  # a broken listener must not break the run

    # ---- access ----------------------------------------------------------

    def events(self) -> List[TraceEvent]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def next_id(self) -> int:
        return next(self._ids)


# --------------------------------------------------------------------------
# process-global recorder slot + per-context span stack
# --------------------------------------------------------------------------

_active: Optional[FlightRecorder] = None
_install_lock = threading.Lock()
# (span_id, ...) stack of the current context; threads start empty
_stack: contextvars.ContextVar[Tuple[int, ...]] = \
    contextvars.ContextVar("obs_span_stack", default=())


def active() -> Optional[FlightRecorder]:
    return _active


def recording() -> bool:
    return _active is not None


def install(rec: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install `rec` as the process-global recorder; returns the previous
    one (pass it back to restore)."""
    global _active
    with _install_lock:
        prev = _active
        _active = rec
        return prev


def begin_exclusive(rec: FlightRecorder) -> bool:
    """Install `rec` only when no recorder is active; False otherwise.

    The per-run trace hooks (CLI -trace, MLContext.set_trace,
    PreparedScript.set_trace) use this pair instead of install/restore:
    with a process-global slot, interleaved install/restore from
    concurrent traced runs could cross-restore a finished run's recorder
    and leave it (and its event backlog) installed forever. First traced
    run wins; overlapping ones skip with a warning."""
    global _active
    with _install_lock:
        if _active is not None:
            return False
        _active = rec
        return True


def end_exclusive(rec: FlightRecorder) -> None:
    """Release the slot iff `rec` still owns it."""
    global _active
    with _install_lock:
        if _active is rec:
            _active = None


@contextlib.contextmanager
def session(recorder: Optional[FlightRecorder] = None):
    """Record everything inside the block; yields the recorder.

        with obs.session() as rec:
            run()
        obs.write(rec, "/tmp/t.json")
    """
    rec = recorder or FlightRecorder()
    prev = install(rec)
    try:
        yield rec
    finally:
        install(prev)


# --------------------------------------------------------------------------
# span / instant API
# --------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op span: returned when no recorder is installed so call
    sites can unconditionally `with span(...) as sp: sp.set(...)`."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_rec", "name", "cat", "args", "_t0", "_id", "_tok")

    def __init__(self, rec: FlightRecorder, name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **attrs) -> "_Span":
        """Attach/extend structured attributes (usable mid-span: values
        often only become known after planning)."""
        if self.args is None:
            self.args = attrs
        else:
            self.args.update(attrs)
        return self

    def __enter__(self):
        self._id = self._rec.next_id()
        stack = _stack.get()
        self._tok = _stack.set(stack + (self._id,))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter_ns() - self._t0
        stack = _stack.get()
        parent = stack[-2] if len(stack) >= 2 else None
        try:
            _stack.reset(self._tok)
        except ValueError:
            pass  # crossed a context boundary (generator finalizer etc.)
        if exc_type is not None:
            # an aborted span must not read as a successful run (e.g. a
            # fused-block attempt that raised _NotFusable before the
            # eager retry): mark it so summaries/timelines can tell
            self.set(error=exc_type.__name__)
        self._rec.emit(TraceEvent(
            self._id, self.name, self.cat, "X", self._t0, dur,
            threading.get_ident(), parent, self.args))
        return False


def span(name: str, cat: str = CAT_RUNTIME, /, **attrs):
    """Context manager recording a complete span. No-op (shared
    singleton) when no recorder is installed. `name`/`cat` are
    positional-only so attrs may freely use those keys."""
    rec = _active
    if rec is None:
        return _NULL_SPAN
    return _Span(rec, name, cat, attrs or None)


def instant(name: str, cat: str = CAT_RUNTIME, /, **attrs) -> None:
    """Record a point event (no duration). `name`/`cat` are
    positional-only so attrs may freely use those keys."""
    rec = _active
    if rec is None:
        return
    stack = _stack.get()
    rec.emit(TraceEvent(
        rec.next_id(), name, cat, "i", time.perf_counter_ns(), 0,
        threading.get_ident(), stack[-1] if stack else None,
        attrs or None))
