# Copy of systemml_tpu/resil/faults.py for the PyTorch port,
# with its imports pointed at systemml_tpu_torch; torch.cuda.OutOfMemoryError
# (the card's allocation failure) classifies as a transient OOM.
"""Fault taxonomy: transient vs fatal classification for recovery sites.

Reference analog: Spark's TaskSetManager distinguishes fetch/executor
failures (retried) from exception failures (job abort); the runtime's
recovery sites previously collapsed that distinction into blanket
``except Exception:`` host-fallbacks that also swallowed real bugs.

Two polarities, because recovery sites come in two shapes:

- ``classify(exc)`` answers "is this worth RETRYING?" for supervised
  sites (parfor tasks, remote jobs, fused dispatch). Only recognized
  transient kinds — OOM/RESOURCE_EXHAUSTED, worker death, deadline
  expiry, preemption — come back retryable; everything else is FATAL
  (a TypeError does not get better on attempt 2).
- ``fallback_allowed(exc)`` answers "may this be swallowed into a
  host/eager FALLBACK?" for fusion guards (loopfuse, fused-block
  lowering). There the default is yes — trace failures are the normal
  mechanism — and only definite programming errors (NameError,
  DML validation/runtime errors, import/syntax errors) must surface.

Classification is name/message based (``type(exc).__mro__`` names +
marker scan) rather than isinstance-based so jaxlib's XlaRuntimeError
and the DML error types never need importing here (no import cycles,
no hard jaxlib dependency at module load).
"""

from __future__ import annotations

from typing import Optional

# fault kinds (stable strings: trace events, worker replies and tests
# key on these)
OOM = "oom"            # RESOURCE_EXHAUSTED / HBM or host allocation failure
WORKER = "worker"      # remote worker process died (EOF, broken pipe)
DEADLINE = "deadline"  # per-job deadline expired (hung worker)
PREEMPT = "preempt"    # TPU preemption / coordinator unavailable
FATAL = "fatal"        # DML/validation/programming error: never retried

TRANSIENT = frozenset({OOM, WORKER, DEADLINE, PREEMPT})

# kinds that mean DEVICES ARE GONE (elastic mesh-shrink is the right
# recovery). OOM is transient but the chips are alive — shrinking on it
# would retire healthy devices and make the next attempt's shards
# LARGER; it keeps the retry/spill/degrade policies instead.
DEVICE_LOSS = frozenset({WORKER, DEADLINE, PREEMPT})


class FaultError(RuntimeError):
    """Base for runtime-raised faults that carry their own kind."""

    fault_kind = FATAL


class InjectedResourceExhausted(FaultError):
    """Synthetic RESOURCE_EXHAUSTED from the fault-injection registry
    (message mimics the real XlaRuntimeError so marker-based consumers
    classify it identically)."""

    fault_kind = OOM


class WorkerDiedError(FaultError):
    """A remote parfor worker / multi-host peer process died mid-job.
    `dead_ranks` optionally names the dead peer process ids (multi-host
    liveness handshakes know exactly who died); recovery uses them to
    re-form a shared survivor mesh instead of shrinking locally."""

    fault_kind = WORKER

    def __init__(self, msg: str, dead_ranks: tuple = ()):
        super().__init__(msg)
        self.dead_ranks = tuple(int(r) for r in dead_ranks)


class DeadlineExpired(FaultError):
    """A supervised operation exceeded its wall-clock deadline."""

    fault_kind = DEADLINE


class RemoteJobError(FaultError):
    """A remote worker replied ERR with a transient-classified cause;
    carries the worker-side kind so the coordinator retries correctly."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.fault_kind = kind


class InjectedKill(BaseException):
    """Simulated SIGKILL (checkpoint mid-save tests): BaseException on
    purpose, so ``except Exception`` recovery guards cannot absorb it —
    only crash-atomicity cleanup (``except BaseException`` + re-raise)
    sees it, exactly like a real kill tests the commit protocol."""


_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "resource_exhausted",
    "Resource exhausted", "out of memory", "Out of memory",
    "OUT_OF_MEMORY", "failed to allocate", "Failed to allocate",
    "Allocation failure", "allocation failure",
)
# coordination-plane unavailability: the signature of a collective
# whose rendezvous reached for a dead/shut-down coordination service.
# The ONE source both classification (PREEMPT, below) and the
# detached-compile reattach routing (multihost.needs_reattach) match
# against — a message variant added here updates both in lockstep.
COORDINATION_MARKERS = (
    "coordination service", "coordination_service",
    "CoordinationService", "Gloo context initialization",
)
_PREEMPT_MARKERS = (
    "preempt", "Preempt", "PREEMPT", "UNAVAILABLE",
    *COORDINATION_MARKERS,
    "Connection reset by peer", "connection reset by peer",
)
_WORKER_TYPE_NAMES = frozenset({
    "BrokenPipeError", "ConnectionResetError", "ConnectionError",
    "EOFError",
})
_DEADLINE_TYPE_NAMES = frozenset({"TimeoutError"})
# torch.cuda.OutOfMemoryError: the caching allocator could not get memory
_OOM_TYPE_NAMES = frozenset({"OutOfMemoryError"})
# programming-error types a fusion fallback must never swallow
_FALLBACK_FATAL_NAMES = frozenset({
    "NameError", "UnboundLocalError", "SyntaxError", "ImportError",
    "ModuleNotFoundError", "DMLValidationError", "DMLRuntimeError",
})
# explicit fallback SIGNALS: these outrank the fatal list (lower.py's
# NotTraceableError subclasses DMLValidationError for historical catch
# sites but means "re-run eagerly", not "user error")
_FALLBACK_SIGNAL_NAMES = frozenset({
    "NotTraceableError", "NotLoopFusable", "_NotFusable",
})


def classify(exc: BaseException) -> str:
    """Map an exception to a fault kind; unrecognized -> FATAL (retry
    sites must never spin on a programming error)."""
    kind = getattr(exc, "fault_kind", None)
    if kind in TRANSIENT or kind == FATAL:
        return kind
    if isinstance(exc, MemoryError):
        return OOM
    names = {c.__name__ for c in type(exc).__mro__}
    if names & _OOM_TYPE_NAMES:
        return OOM
    if names & _WORKER_TYPE_NAMES:
        return WORKER
    if names & _DEADLINE_TYPE_NAMES:
        return DEADLINE
    try:
        msg = str(exc)
    except Exception:  # except-ok: unprintable exception classifies fatal
        return FATAL
    if any(m in msg for m in _OOM_MARKERS):
        return OOM
    if any(m in msg for m in _PREEMPT_MARKERS):
        return PREEMPT
    return FATAL


def is_transient(exc: BaseException) -> bool:
    return classify(exc) in TRANSIENT


def fallback_allowed(exc: BaseException) -> bool:
    """May `exc` be swallowed into a host/eager fallback? True for trace
    and compile failures (the normal degradation mechanism), False for
    definite programming errors that must surface."""
    names = {c.__name__ for c in type(exc).__mro__}
    if names & _FALLBACK_SIGNAL_NAMES:
        return True
    return not (names & _FALLBACK_FATAL_NAMES)


# --------------------------------------------------------------------------
# CAT_RESIL event emitters (no-ops when no flight recorder is installed)
# --------------------------------------------------------------------------

def emit(name: str, /, **attrs) -> None:
    """CAT_RESIL instant: retry/requeue/degrade/loop_fallback decisions
    all report through here so `-trace` output shows exactly what
    failed, what was retried, and what was degraded. Every decision
    also lands in the ambient Statistics' resilience counters so plain
    `-stats` (no recorder installed) shows recovery activity too."""
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_resil(name)
    from systemml_tpu_torch.obs import trace as obs

    if obs.recording():
        obs.instant(name, obs.CAT_RESIL, **attrs)


def emit_fault(site: str, kind: str, exc: BaseException) -> None:
    """CAT_RESIL `fault` instant for one classified failure at a site;
    counted per-kind in Statistics (`fault[oom]=2`) for `-stats`."""
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_resil(f"fault[{kind}]")
    from systemml_tpu_torch.obs import trace as obs

    if obs.recording():
        try:
            detail = f"{type(exc).__name__}: {str(exc)[:200]}"
        except Exception:  # except-ok: diagnostics must never mask the fault
            detail = type(exc).__name__
        obs.instant("fault", obs.CAT_RESIL, site=site, kind=kind,
                    error=detail)


# --------------------------------------------------------------------------
# remote-worker reply classification
# --------------------------------------------------------------------------

REPLY_KIND_PREFIX = "ERR kind="


def reply_for(exc: BaseException) -> str:
    """Worker-side: one-line ERR reply carrying the classified kind, so
    the coordinator retries transient failures without having to parse
    arbitrary reprs."""
    msg = repr(exc).replace("\n", " ")[:500]
    return f"{REPLY_KIND_PREFIX}{classify(exc)} {msg}"


def classify_reply(line: str) -> str:
    """Coordinator-side: fault kind of a worker ERR reply. Prefers the
    explicit `ERR kind=<k>` tag; legacy/foreign replies fall back to the
    marker scan."""
    if line.startswith(REPLY_KIND_PREFIX):
        kind = line[len(REPLY_KIND_PREFIX):].split(" ", 1)[0]
        if kind in TRANSIENT or kind == FATAL:
            return kind
    if any(m in line for m in _OOM_MARKERS):
        return OOM
    if any(m in line for m in _PREEMPT_MARKERS):
        return PREEMPT
    return FATAL
