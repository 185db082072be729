# Copy of systemml_tpu/fleet/admission.py for the PyTorch port: the same
# code, with its imports pointed at systemml_tpu_torch.
"""Overload protection for the serving fleet: admission, budgets,
circuit breaking.

The crash-fault work made the fleet survive replica DEATH:
any process can be SIGKILLed mid-stream with zero failed requests.
This module covers the axis that arc never touched — OVERLOAD. The
failure mode is structural, not accidental: every pre-overload
mechanism *adds* load exactly when the fleet is saturated (redispatch
retries the failed request, hedging duplicates the slow one, the
MicroBatcher queues without bound), and a request with 5 ms of
deadline left is scored as eagerly as a fresh one. Under 2x offered
load that feedback loop collapses goodput to ~0 even though every
replica is healthy.

Three small, independently testable pieces (docs/fleet_serving.md,
"Overload & degradation"):

- ``AdmissionGate`` — per-replica bounded-inflight gate consulted
  BEFORE any scoring work. Rejects (HTTP 429 + Retry-After, distinct
  from the 503 pause-gate and 400 caller-bug taxonomy) when
  the inflight bound is hit, when the request arrived with its
  deadline already expired, or when the PREDICTED wait — queue depth
  x measured per-request service time from the existing latency
  histogram (TVM-style measured thresholds over hand-set constants,
  arXiv:1802.04799) — exceeds the request's remaining deadline.
- ``RetryBudget`` — a token bucket the router's redispatches and
  hedges draw from, refilled as a FRACTION of recent successes. Under
  brownout (few successes) the bucket drains and retries degrade to
  fail-fast ``AdmissionRejectedError`` at the caller instead of
  amplifying the overload; hedges are simply skipped.
- ``CircuitBreaker`` — per-replica consecutive-TRANSIENT-failure
  breaker with half-open probes. Replaces quarantine-until-epoch-bump
  for 5xx/timeout runs: a replica that answered (even with an error)
  is alive, so it gets probed back after ``reset_s`` instead of
  being excluded until the next routing epoch. Connection-level death
  (nothing answered) still quarantines immediately — that is the
  crash-fault path and its semantics are unchanged.

Every decision emits a named-reason metric/event
(``fleet_admission_rejects_total{reason=}``,
``fleet_retry_budget_exhausted_total``, the circuit-state gauge, the
``overload_events_total`` -stats family) wired into the obs/fleet
vocabulary so the metrics lint covers them like any storyline event.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from systemml_tpu_torch.resil import faults

# The deadline-propagation header: remaining budget in MILLISECONDS,
# stamped by ``http_transport`` on every hop and read by
# ``_ScoreHandler`` so hedged/redispatched attempts inherit the
# REDUCED deadline and replicas refuse dead-on-arrival work.
DEADLINE_HEADER = "X-SMTPU-Deadline-Ms"

# Named rejection reasons (the ONLY values the admission reject metric
# and overload events may carry — tests and the metrics lint key on
# these):
REASON_EXPIRED = "expired"              # dead on arrival (remaining <= 0)
REASON_INFLIGHT = "inflight"            # bounded-inflight gate full
REASON_PREDICTED_WAIT = "predicted_wait"  # queue depth x service time
#                                           exceeds remaining deadline
REASON_BUDGET = "budget"                # retry budget exhausted (router)
REASON_QUEUE_FULL = "queue_full"        # MicroBatcher row bound hit

ADMISSION_REASONS = (REASON_EXPIRED, REASON_INFLIGHT,
                     REASON_PREDICTED_WAIT, REASON_BUDGET,
                     REASON_QUEUE_FULL)

# circuit-breaker states, with the numeric encoding the state gauge
# exports (closed=0 so an all-healthy fleet gauges to 0)
CIRCUIT_CLOSED = "closed"
CIRCUIT_OPEN = "open"
CIRCUIT_HALF_OPEN = "half_open"
CIRCUIT_STATE_CODES = {CIRCUIT_CLOSED: 0, CIRCUIT_OPEN: 1,
                       CIRCUIT_HALF_OPEN: 2}


def emit_overload(name: str, /, **attrs) -> None:
    """CAT_FLEET instant for one overload decision (an admission
    reject, a budget denial, a breaker transition, a queue shed),
    mirroring ``faults.emit``: the event lands in the flight recorder
    (merged fleet timelines + the fleet-trace CLI's overload summary)
    AND in the ambient Statistics' overload counters so plain
    ``-stats`` shows shedding activity with no recorder installed.
    Event names must be declared in ``obs/fleet.OVERLOAD_EVENTS`` —
    the metrics lint enforces it like any storyline event. A
    ``reason=`` attribute is folded into the counter label
    (``fleet_admission_reject[expired]=3``) so every refusal stays
    attributable by NAME."""
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        reason = attrs.get("reason")
        st.count_overload(f"{name}[{reason}]" if reason else name)
    from systemml_tpu_torch.obs import trace as obs_trace

    if obs_trace.recording():
        obs_trace.instant(name, obs_trace.CAT_FLEET, **attrs)


class AdmissionRejectedError(faults.FaultError):
    """The fleet refused a request BEFORE scoring it (HTTP 429).

    Not a dead replica (the endpoint answered) and not a caller bug
    (the request was well-formed) — the fleet is shedding load it
    cannot serve within the deadline. FATAL-classified on purpose:
    supervised retry sites must NOT auto-retry a shed request (that
    is the retry storm admission control exists to kill); the caller
    backs off for ``retry_after_s`` and decides.
    """

    fault_kind = faults.FATAL

    def __init__(self, msg: str, reason: str = REASON_INFLIGHT,
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


class QueueFullError(AdmissionRejectedError):
    """The MicroBatcher's bounded pending-row queue is full: the
    enqueue is refused immediately (backpressure at the door) instead
    of queueing work that will miss its deadline anyway."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg, reason=REASON_QUEUE_FULL,
                         retry_after_s=retry_after_s)


class AdmissionGate:
    """Bounded-inflight + predicted-wait admission for one replica.

    ``try_admit`` is consulted at the TOP of the request path — before
    json parsing of payload semantics, before the pause gate, before
    any scoring work — and answers either ``None`` (admitted; the
    caller MUST pair it with ``release()``) or a named rejection
    reason from ``ADMISSION_REASONS``.

    The predicted wait is ``queue depth x measured per-request service
    time``: the service-time estimate comes from the same latency
    histogram the router's hedge delay reads (median; conservative
    ``service_floor_s`` below ``min_samples`` observations, mirroring
    the hedge-floor fallback), so admission thresholds track the
    OBSERVED service distribution rather than a hand-set constant.
    """

    def __init__(self, inflight_max: int, slack: float = 1.0,
                 service_time_s: Optional[Callable[[], float]] = None,
                 service_floor_s: float = 0.005):
        self.inflight_max = int(inflight_max)
        self.slack = float(slack)
        self._service_time_s = service_time_s
        self.service_floor_s = float(service_floor_s)
        self._inflight = 0
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.inflight_max > 0

    @property
    def depth(self) -> int:
        return self._inflight

    def service_time_s(self) -> float:
        """Best current per-request service-time estimate (seconds);
        never NaN/0 — the floor covers empty/low-sample histograms."""
        est = 0.0
        if self._service_time_s is not None:
            try:
                est = float(self._service_time_s())
            except Exception:  # except-ok: estimate must not break admission
                est = 0.0
        if not (est > 0.0):  # NaN fails this comparison too
            est = self.service_floor_s
        return max(est, self.service_floor_s)

    def predicted_wait_s(self) -> float:
        """Expected queueing delay for a request admitted NOW."""
        return self._inflight * self.service_time_s()

    def retry_after_s(self) -> float:
        """Suggested client backoff: the time for the current queue to
        drain — what the 429's Retry-After header advertises."""
        return max(1, self._inflight) * self.service_time_s()

    def try_admit(self, remaining_s: Optional[float] = None
                  ) -> Optional[str]:
        """Admit (returns ``None``; pair with ``release()``) or answer
        a named rejection reason. ``remaining_s`` is the request's
        remaining deadline budget, if it propagated one."""
        if not self.enabled:
            with self._lock:
                self._inflight += 1
            return None
        if remaining_s is not None and remaining_s <= 0.0:
            return REASON_EXPIRED
        with self._lock:
            if self._inflight >= self.inflight_max:
                return REASON_INFLIGHT
            if (remaining_s is not None
                    and self._inflight * self.service_time_s()
                    > remaining_s * self.slack):
                return REASON_PREDICTED_WAIT
            self._inflight += 1
        return None

    def release(self) -> None:
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1


class RetryBudget:
    """Token bucket for redispatches and hedges, refilled as a
    fraction of successes.

    Starts full at ``cap``. Every retry-shaped action (a failover
    redispatch, a straggler hedge, a 429 re-route) spends one token;
    every SUCCESSFUL request refunds ``ratio`` tokens (capped). The
    invariant: sustained retry rate <= ratio x success rate, so
    retries can never outnumber the work the fleet is actually
    completing — during brownout the bucket drains and ``try_spend``
    answers False, degrading retries to fail-fast at the caller.

    ``cap <= 0`` disables budgeting (every spend granted) — the
    pre-overload unbounded-retry behavior, kept for the OFF benchmark
    arm.
    """

    def __init__(self, cap: float, ratio: float = 0.2):
        self.cap = float(cap)
        self.ratio = float(ratio)
        self._tokens = self.cap
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.cap > 0

    @property
    def tokens(self) -> float:
        return self._tokens if self.enabled else float("inf")

    def try_spend(self, n: float = 1.0) -> bool:
        if not self.enabled:
            return True
        with self._lock:
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def note_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)


class CircuitBreaker:
    """Per-replica consecutive-failure breaker with half-open probes.

    State machine: CLOSED (healthy) -- ``threshold`` consecutive
    transient failures --> OPEN (requests routed elsewhere) -- after
    ``reset_s`` --> HALF_OPEN (exactly ONE probe request allowed
    through) -- probe success --> CLOSED / probe failure --> OPEN
    again (timer restarts).

    This is the TRANSIENT-failure path only: HTTP 5xx and timeouts,
    where the replica answered and is therefore alive. Connection-
    level death never reaches a breaker — the router quarantines it
    immediately via the routing-epoch bump, unchanged.

    ``threshold <= 0`` disables the breaker (always allows, records
    nothing) for the OFF benchmark arm.
    """

    def __init__(self, threshold: int, reset_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = int(threshold)
        self.reset_s = float(reset_s)
        self._clock = clock
        self._state = CIRCUIT_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def state_code(self) -> int:
        return CIRCUIT_STATE_CODES[self.state]

    def _maybe_half_open(self) -> None:
        if (self._state == CIRCUIT_OPEN
                and self._clock() - self._opened_at >= self.reset_s):
            # request-scoped: every caller already holds self._lock
            self._state = CIRCUIT_HALF_OPEN

    def allow(self) -> bool:
        """May a request be routed to this replica right now? In
        HALF_OPEN exactly one caller wins the probe slot; the rest are
        routed elsewhere until the probe resolves."""
        if not self.enabled:
            return True
        with self._lock:
            self._maybe_half_open()
            if self._state == CIRCUIT_CLOSED:
                return True
            if self._state == CIRCUIT_HALF_OPEN and self._failures >= 0:
                # grant the single probe slot: mark it taken by moving
                # failures to a sentinel; resolved by record_*
                self._failures = -1
                return True
            return False

    def record_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._failures = 0
            self._state = CIRCUIT_CLOSED

    def record_failure(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            if self._state == CIRCUIT_HALF_OPEN:
                # the probe failed: re-open, restart the timer
                self._state = CIRCUIT_OPEN
                self._opened_at = self._clock()
                self._failures = 0
                return
            self._failures = max(0, self._failures) + 1
            if self._failures >= self.threshold:
                self._state = CIRCUIT_OPEN
                self._opened_at = self._clock()
                self._failures = 0
