# Port of systemml_tpu/fleet/router.py, with its imports pointed at
# systemml_tpu_torch, and two repairs of races the reference has: one
# death is one epoch bump however many requests were in flight on
# the dead replica (Router._note_dead), and a replica killed while
# writing its answer is a dead replica to http_transport.
"""Request router for the serving fleet: least-outstanding balancing,
straggler-aware hedging, and failover as an EPOCH BUMP.

The router is the client-facing half of the fleet: it holds an epoch-versioned ``RoutingTable`` of
live replica targets keyed by (original rank, program generation) and
dispatches each request to the least-outstanding live replica serving
the generation the traffic split picks. Three behaviors define it:

- **hedging** — when the primary dispatch has been outstanding longer
  than a MEASURED quantile of the observed latency distribution
  (``Histogram.quantile``; the TVM posture of preferring observed
  distributions over hand-set constants) AND the primary is the rank
  the ``obs/fleet.py`` straggler report names, a duplicate fires to
  the least-outstanding other replica; first response wins and the
  loser is marked cancelled and counted.
- **failover** — a transport failure is a ROUTING event, never a
  client error: the failed replica leaves the table, the epoch bumps
  (CAT_RESIL ``fleet_route_epoch``), and the request redispatches to
  a survivor. A reform (the JAX package's elastic recovery; the port's
  waits for ROADMAP queue 1, item 12) would surface here the same way:
  the post-reform table is just the next epoch.
- **rolling updates** — the table carries per-generation traffic
  weights; ``gen_for`` deterministically splits request sequence
  numbers so a g→g+1 shift is reproducible and every response stays
  attributable to exactly one generation (fleet/rollout.py drives the
  schedule).

Transport is pluggable: ``callable(address, request) -> response``
raising ``ReplicaDeadError`` (or any DEVICE_LOSS-classified error)
when the TARGET is gone, and ``ReplicaRequestError`` when the target
answered that the REQUEST is bad — the router redispatches the
former and propagates the latter (a deterministic scoring failure
would fail identically on every replica; redispatching it would
quarantine the whole healthy fleet one epoch bump at a time).
``http_transport`` provides the stdlib urllib implementation matching
``fleet/replica.ReplicaEndpoint``.

Overload protection (fleet/admission.py) threads through every one of
those behaviors: redispatches and hedges spend from a ``RetryBudget``
refilled by successes (brownout degrades retries to fail-fast 429 at
the caller instead of amplifying the overload), TRANSIENT failures
(5xx / timeouts — the replica answered, so it is alive) feed
per-replica ``CircuitBreaker``s with half-open probes instead of the
quarantine-until-epoch-bump hammer, a replica's 429 shed re-routes
under the same budget, and a transport that accepts ``remaining_s``
gets the request's remaining deadline on every attempt — hedged and
redispatched attempts inherit the REDUCED budget, and the socket
timeout is capped at it so a hung replica drains its dispatch thread
at the deadline, not at the full transport timeout.
"""

from __future__ import annotations

import inspect
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from systemml_tpu_torch.fleet import admission
from systemml_tpu_torch.fleet.admission import (AdmissionRejectedError,
                                          CircuitBreaker, RetryBudget)
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.obs.metrics import MetricsRegistry
from systemml_tpu_torch.obs.trace import CAT_FLEET
from systemml_tpu_torch.resil import faults, inject


class ReplicaDeadError(RuntimeError):
    """Transport verdict: the dispatch target is gone (connection
    refused/reset, drained listener, injected worker death). The
    router never surfaces this to a client — it quarantines the
    replica, bumps the routing epoch and redispatches.

    ``transient=True`` marks the SOFTER verdict: the replica ANSWERED
    (HTTP 5xx) or merely ran out the clock (socket timeout) — it is
    alive, so instead of the immediate quarantine it feeds the rank's
    circuit breaker and only a run of consecutive failures excludes
    it (with half-open probes to let it back). Connection-level death
    keeps ``transient=False`` and the immediate quarantine."""

    def __init__(self, msg: str, rank: Optional[int] = None,
                 transient: bool = False):
        super().__init__(msg)
        self.rank = rank
        self.transient = bool(transient)

    fault_kind = faults.WORKER


class ReplicaRequestError(RuntimeError):
    """Transport verdict: the replica is alive and REJECTED this
    request (HTTP 4xx from the scoring handler — a deterministic
    scoring failure). It propagates to the caller untouched: the same
    request would fail identically on every replica, so redispatching
    it would only quarantine healthy targets one by one."""

    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = int(status)

    fault_kind = faults.FATAL


class RequestTimeoutError(RuntimeError):
    """The caller's deadline expired while a dispatch was still in
    flight. A timeout is a CLIENT verdict, not a death certificate —
    the replica may merely be slow — so the router neither quarantines
    the target nor bumps the epoch; liveness stays the registry TTL's
    job."""


class NoLiveReplicasError(RuntimeError):
    """The redispatch budget ran out with no live replica left to try:
    the FLEET is gone (or partitioned away), not one replica — the one
    failure mode the zero-failed-requests contract cannot absorb."""


class RoutingTable:
    """Epoch-versioned live-replica view shared by every request
    thread. Keys are (original rank, program generation) — original
    rank is the stable identity across reforms (obs/fleet.py), program
    generation is the rolling-update axis. Every mutation happens
    under the table lock; a membership change is an EPOCH BUMP, which
    is the only failover signal a client-visible path ever sees."""

    def __init__(self):
        self._lock = threading.Lock()
        # (orig_rank, prog_gen) -> opaque transport address
        self._targets: Dict[Tuple[int, int], Any] = {}
        # prog_gen -> percent of traffic routed to it (rolling updates)
        self._weights: Dict[int, int] = {}
        self.epoch = 0

    # ---- membership ------------------------------------------------------

    def install(self, targets: Dict[Tuple[int, int], Any]) -> None:
        """Replace the whole table (initial build / registry refresh)."""
        with self._lock:
            self._targets = {(int(r), int(g)): a
                             for (r, g), a in targets.items()}

    def add(self, rank: int, prog_gen: int, address: Any) -> None:
        with self._lock:
            self._targets[(int(rank), int(prog_gen))] = address

    def discard_generation(self, prog_gen: int) -> None:
        """Drop a retired program generation's targets and weight."""
        g = int(prog_gen)
        with self._lock:
            self._targets = {k: v for k, v in self._targets.items()
                             if k[1] != g}
            self._weights.pop(g, None)

    def route_epoch_bump(self, dead_ranks=(), reason: str = "failover"
                         ) -> int:
        """A reform or a quarantine becomes a new routing-table epoch —
        the dead ranks leave every generation, the epoch increments,
        and the CAT_RESIL ``fleet_route_epoch`` event lands in the
        failover storyline. Clients never see an error; in-flight
        requests against the old epoch redispatch against the new."""
        dead = {int(r) for r in dead_ranks}
        with self._lock:
            if dead:
                self._targets = {k: v for k, v in self._targets.items()
                                 if k[0] not in dead}
            self.epoch += 1
            epoch = self.epoch
        faults.emit("fleet_route_epoch", epoch=epoch,
                    dead=sorted(dead), reason=reason)
        return epoch

    # ---- views -----------------------------------------------------------

    def live_ranks(self) -> List[int]:
        with self._lock:
            return sorted({r for r, _ in self._targets})

    def generations(self) -> List[int]:
        with self._lock:
            return sorted({g for _, g in self._targets})

    def targets_for(self, prog_gen: int) -> Dict[int, Any]:
        g = int(prog_gen)
        with self._lock:
            return {r: a for (r, gg), a in self._targets.items()
                    if gg == g}

    # ---- rolling-update traffic split ------------------------------------

    def set_weight(self, prog_gen: int, percent: int) -> None:
        with self._lock:
            self._weights[int(prog_gen)] = max(0, min(100, int(percent)))

    def weight(self, prog_gen: int) -> int:
        with self._lock:
            return self._weights.get(int(prog_gen), 0)

    def gen_for(self, seq: int) -> int:
        """Deterministic per-request generation pick: the lowest live
        generation unless a higher one's weight claims this sequence
        slot (``seq % 100 < weight``). Counter-based, not random — a
        rollout's traffic split is exactly reproducible."""
        with self._lock:
            gens = sorted({g for _, g in self._targets})
            if not gens:
                return 0
            pick = gens[0]
            for g in gens[1:]:
                w = self._weights.get(g, 0)
                if w >= 100 or (int(seq) % 100) < w:
                    pick = g
            return pick


class _Dispatch:
    """One in-flight attempt. Completion and cancellation are arbitrated
    under the REQUEST's condition variable (first-response-wins), so
    the loser's late result is discarded without racing the winner."""

    def __init__(self, cv: threading.Condition):
        self._cv = cv
        self.done = False
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.cancelled = False

    def complete(self, result: Any = None,
                 error: Optional[BaseException] = None) -> None:
        with self._cv:
            self.result = result
            self.error = error
            self.done = True
            self._cv.notify_all()

    def cancel(self) -> None:
        with self._cv:
            self.cancelled = True


class Router:
    """Routes scoring requests across the live replica set.

    ``transport`` is ``callable(address, request) -> response``;
    ``straggler_report`` is the ``obs/fleet.fleet_report`` dict (or a
    zero-arg callable returning the freshest one) whose
    ``slowest_rank`` names the hedge target. All knobs default from
    config (``fleet_hedge_quantile`` / ``fleet_hedge_min_samples`` /
    ``fleet_hedge_floor_s`` / ``fleet_max_redispatch``).

    ``on_replica_dead(rank)`` lets the fleet member substitute the
    full reform/reattach state machine for the default quarantine —
    when it returns, the table must reflect the post-recovery epoch."""

    def __init__(self, table: RoutingTable,
                 transport: Callable[[Any, Any], Any], *,
                 registry: Optional[MetricsRegistry] = None,
                 straggler_report: Any = None,
                 hedge_quantile: Optional[float] = None,
                 hedge_min_samples: Optional[int] = None,
                 hedge_floor_s: Optional[float] = None,
                 max_redispatch: Optional[int] = None,
                 retry_budget_cap: Optional[float] = None,
                 retry_budget_ratio: Optional[float] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 on_replica_dead: Optional[Callable[[int], Any]] = None):
        from systemml_tpu_torch.utils.config import get_config

        cfg = get_config()
        self.table = table
        self._transport = transport
        # an extended transport accepts the request's remaining
        # deadline (``remaining_s=``); detected by SIGNATURE so every
        # pre-existing 2-arg transport keeps working unchanged
        self._transport_takes_deadline = _accepts_remaining_s(transport)
        self._report = straggler_report
        self._on_replica_dead = on_replica_dead
        self.hedge_quantile = float(
            cfg.fleet_hedge_quantile if hedge_quantile is None
            else hedge_quantile)
        self.hedge_min_samples = int(
            cfg.fleet_hedge_min_samples if hedge_min_samples is None
            else hedge_min_samples)
        self.hedge_floor_s = float(
            cfg.fleet_hedge_floor_s if hedge_floor_s is None
            else hedge_floor_s)
        self.max_redispatch = int(
            cfg.fleet_max_redispatch if max_redispatch is None
            else max_redispatch)
        self.budget = RetryBudget(
            float(cfg.fleet_retry_budget_cap if retry_budget_cap is None
                  else retry_budget_cap),
            float(cfg.fleet_retry_budget_ratio
                  if retry_budget_ratio is None else retry_budget_ratio))
        self.breaker_threshold = int(
            cfg.fleet_breaker_threshold if breaker_threshold is None
            else breaker_threshold)
        self.breaker_reset_s = float(
            cfg.fleet_breaker_reset_s if breaker_reset_s is None
            else breaker_reset_s)
        self._breakers: Dict[int, CircuitBreaker] = {}
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._m_requests = self.registry.counter(
            "fleet_requests_total", "requests routed to completion")
        self._m_failed = self.registry.counter(
            "fleet_failed_requests_total", "requests the fleet could "
            "not serve (redispatch budget exhausted)")
        self._m_latency = self.registry.histogram(
            "fleet_request_seconds", "end-to-end routed-request "
            "latency (hedges and redispatches included)", unit="s")
        self._m_hedges = self.registry.counter(
            "fleet_hedges_total", "hedged duplicates launched")
        self._m_hedge_wins = self.registry.counter(
            "fleet_hedge_wins_total", "requests won by the hedge")
        self._m_hedge_cancelled = self.registry.counter(
            "fleet_hedges_cancelled_total", "duplicate dispatches "
            "cancelled after first response won")
        self._m_hedge_abandoned = self.registry.counter(
            "fleet_hedges_abandoned_total", "hedge launches abandoned "
            "at the fleet.hedge site (primary still served)")
        self._m_redispatch = self.registry.counter(
            "fleet_redispatch_total", "failover redispatches to a "
            "surviving replica")
        self._m_timeouts = self.registry.counter(
            "fleet_request_timeouts_total", "requests whose caller "
            "deadline expired with the dispatch still in flight (the "
            "slow replica is NOT quarantined)")
        self._m_budget_exhausted = self.registry.counter(
            "fleet_retry_budget_exhausted_total", "retry/hedge budget "
            "spends denied: redispatches degraded to fail-fast 429, "
            "hedges skipped (brownout)")
        self._m_shed_retries = self.registry.counter(
            "fleet_shed_retries_total", "requests re-routed to another "
            "replica after a 429 admission shed (budget-gated)")
        self._m_breaker_open = self.registry.counter(
            "fleet_breaker_open_total", "circuit-breaker transitions "
            "into OPEN (a run of consecutive transient failures)")
        self.registry.gauge(
            "fleet_retry_budget_tokens", "retry/hedge tokens currently "
            "available", fn=lambda: round(self.budget.tokens, 3))
        self.registry.gauge(
            "fleet_breakers_open_current", "replicas whose circuit is "
            "currently open or half-open",
            fn=lambda: sum(
                1 for b in list(self._breakers.values())
                if b.state != admission.CIRCUIT_CLOSED))
        self.registry.gauge(
            "fleet_route_epoch_current", "current routing-table epoch",
            fn=lambda: self.table.epoch)
        self._lock = threading.Lock()
        # serializes _note_dead's check and bump: the requests in flight
        # on a replica that dies all fail at once, and one death must be
        # one epoch (a check and a bump under separate locks let two
        # failing requests both see the rank live and bump twice)
        self._quarantine_lock = threading.Lock()
        self._outstanding: Dict[int, int] = {}
        self._gen_inflight: Dict[int, int] = {}
        self._seq = 0

    # ---- introspection ---------------------------------------------------

    def outstanding(self, rank: int) -> int:
        with self._lock:
            return self._outstanding.get(int(rank), 0)

    def inflight_for_gen(self, prog_gen: int) -> int:
        with self._lock:
            return self._gen_inflight.get(int(prog_gen), 0)

    @property
    def redispatch_count(self) -> int:
        return int(self._m_redispatch.value)

    def p99_s(self) -> float:
        """Observed p99 routed-request latency (NaN before traffic)."""
        return self._m_latency.quantile(0.99)

    # ---- hedging policy --------------------------------------------------

    def select_hedge_rank(self, report: Any = None) -> Optional[int]:  # elastic-ok: pure hedge-target selection; the launch site in _dispatch_hedged emits fleet_hedge
        """The rank whose in-flight requests deserve a hedge: exactly
        the rank the straggler report names (``slowest_rank``,
        obs/fleet.fleet_report). None when there is no report, when
        the report names no rank, when the named rank is not live, or
        with fewer than two live replicas — a hedge needs somewhere
        else to go."""
        rep = report
        if rep is None:
            rep = self._report() if callable(self._report) else self._report
        live = self.table.live_ranks()
        if len(live) < 2 or not rep:
            return None
        slow = rep.get("slowest_rank")
        if slow is None:
            return None
        slow = int(slow)
        return slow if slow in live else None

    def hedge_delay_s(self) -> float:  # elastic-ok: measured-quantile math, no recovery side effects
        """How long the primary may be outstanding before a hedge
        fires: the configured quantile of the OBSERVED latency
        histogram once enough samples exist, floored at
        ``fleet_hedge_floor_s`` (which also covers the cold start)."""
        if self._m_latency.count >= self.hedge_min_samples:
            q = self._m_latency.quantile(self.hedge_quantile)
            if q == q:  # not NaN
                return max(self.hedge_floor_s, q)
        return self.hedge_floor_s

    # ---- dispatch --------------------------------------------------------

    def submit(self, request: Any, timeout_s: float = 30.0) -> Any:
        """Route one request to completion. A dead replica is absorbed
        (epoch bump + redispatch, up to ``fleet_max_redispatch``
        times); only a fleet-wide outage surfaces, as
        ``NoLiveReplicasError``. Fatal scoring errors (bad request,
        programming error — ``ReplicaRequestError``) propagate — they
        would fail identically on every replica. Deadline expiry with
        the dispatch still in flight raises ``RequestTimeoutError``
        WITHOUT quarantining the slow-but-alive replica."""
        t0 = time.perf_counter()
        deadline = t0 + float(timeout_s)
        with self._lock:
            self._seq += 1
            seq = self._seq
        redispatches = 0
        shed_ranks: set = set()
        last_shed: Optional[AdmissionRejectedError] = None
        while True:
            prog_gen = self.table.gen_for(seq)
            rank, addr = self._pick(prog_gen, exclude=shed_ranks)
            if rank is None:
                # the picked generation retired mid-request: any live
                # generation still serves (newest first)
                for g in reversed(self.table.generations()):
                    rank, addr = self._pick(g, exclude=shed_ranks)
                    if rank is not None:
                        prog_gen = g
                        break
            if rank is None:
                if last_shed is not None:
                    # every live replica shed this request: the fleet
                    # is overloaded, not gone — the 429 (with its
                    # Retry-After) is the answer, not an outage
                    raise last_shed
                self._m_failed.inc()
                raise NoLiveReplicasError(
                    f"no live replicas (epoch {self.table.epoch})")
            try:
                out = self._dispatch_hedged(rank, addr, prog_gen,
                                            request, deadline)
            except RequestTimeoutError:
                # a client-side deadline is NOT replica death: no
                # _note_dead, no epoch bump — the registry TTL decides
                # liveness, the caller decides patience
                self._m_timeouts.inc()
                raise
            except AdmissionRejectedError as e:
                # the replica shed the request (429): it is alive and
                # overloaded. One budget-gated try at ANOTHER replica;
                # brownout or a fleet-wide shed fails fast with the 429
                last_shed = e
                shed_ranks.add(rank)
                if (time.perf_counter() > deadline
                        or not self._budget_spend("shed_retry")):
                    raise
                self._m_shed_retries.inc()
                continue
            except ReplicaDeadError as e:
                dead = rank if e.rank is None else e.rank
                if getattr(e, "transient", False):
                    # the replica ANSWERED (5xx) or timed out: alive,
                    # so no quarantine — its circuit breaker decides
                    # when a run of failures excludes it
                    self._breaker_failure(dead)
                else:
                    self._note_dead(dead)
                redispatches += 1
                self._m_redispatch.inc()
                if (redispatches > self.max_redispatch
                        or time.perf_counter() > deadline):
                    self._m_failed.inc()
                    raise NoLiveReplicasError(
                        f"redispatch budget exhausted after "
                        f"{redispatches} attempt(s), last dead replica "
                        f"r{dead} (epoch {self.table.epoch})") from e
                if not self._budget_spend("redispatch"):
                    raise AdmissionRejectedError(
                        f"retry budget exhausted after {redispatches} "
                        f"redispatch(es); replica r{dead} failed and "
                        f"the fleet is browning out",
                        reason=admission.REASON_BUDGET,
                        retry_after_s=self.hedge_floor_s) from e
                continue
            self.budget.note_success()
            self._m_requests.inc()
            self._m_latency.observe(time.perf_counter() - t0)
            return out

    def _pick(self, prog_gen: int, exclude=()
              ) -> Tuple[Optional[int], Any]:
        """Least-outstanding live replica serving ``prog_gen`` whose
        circuit admits traffic; ties break on the lowest rank
        (deterministic). A HALF_OPEN breaker grants its single probe
        slot here, so exactly one request tests a recovering replica."""
        targets = self.table.targets_for(prog_gen)
        with self._lock:
            cands = sorted((self._outstanding.get(r, 0), r)
                           for r in targets if r not in exclude)
        for _, rank in cands:
            br = self._breakers.get(rank)
            if br is None or br.allow():
                return rank, targets[rank]
        return None, None

    def breaker_state(self, rank: int) -> str:
        """Circuit state for one replica (CLOSED when never tripped)."""
        br = self._breakers.get(int(rank))
        return admission.CIRCUIT_CLOSED if br is None else br.state

    def _breaker_for(self, rank: int) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(int(rank))
            if br is None:
                br = CircuitBreaker(self.breaker_threshold,
                                    self.breaker_reset_s)
                self._breakers[int(rank)] = br
            return br

    def _breaker_failure(self, rank: int) -> None:
        br = self._breaker_for(rank)
        was = br.state
        br.record_failure()
        if (br.state == admission.CIRCUIT_OPEN
                and was != admission.CIRCUIT_OPEN):
            self._m_breaker_open.inc()
            admission.emit_overload("fleet_breaker_open", rank=int(rank),
                                    threshold=self.breaker_threshold)

    def _breaker_success(self, rank: int) -> None:
        br = self._breakers.get(int(rank))
        if br is None:
            return
        reopened = br.state != admission.CIRCUIT_CLOSED
        br.record_success()
        if reopened:
            admission.emit_overload("fleet_breaker_close", rank=int(rank))

    def _budget_spend(self, action: str) -> bool:
        """Spend one retry/hedge token; a denial is counted and emitted
        with the ACTION that wanted it (redispatch / hedge /
        shed_retry) so brownout decisions are attributable."""
        ok = False
        try:
            inject.check("router.budget")
            ok = self.budget.try_spend()
        except Exception:  # except-ok: an injected fault at router.budget MEANS "the budget denied this spend" — it exercises exactly the fail-fast path below
            ok = False
        if not ok:
            self._m_budget_exhausted.inc()
            admission.emit_overload("fleet_budget_exhausted",
                                    action=action,
                                    tokens=round(self.budget.tokens, 3))
        return ok

    def _note_dead(self, rank: int) -> None:
        """A transport failure is a routing event: hand the rank to the
        fleet member's recovery hook (the reform state machine) when
        one is installed, else quarantine it with an epoch bump. Either
        way the table the NEXT attempt reads is a fresh epoch."""
        if self._on_replica_dead is not None:
            self._on_replica_dead(int(rank))
            return
        with self._quarantine_lock:
            if int(rank) in self.table.live_ranks():
                self.table.route_epoch_bump([int(rank)],
                                            reason="transport")

    def _dispatch_hedged(self, rank: int, addr: Any, prog_gen: int,
                         request: Any, deadline: float) -> Any:
        """Primary dispatch plus the straggler-aware hedge. The hedge
        fires only when (a) the primary is still outstanding after
        ``hedge_delay_s()``, (b) the primary IS the straggler the
        report names, and (c) another live replica serves the same
        generation. First response wins; the loser is marked cancelled
        and counted (``fleet_hedges_cancelled_total``)."""
        cv = threading.Condition()
        primary = _Dispatch(cv)
        self._begin(rank, prog_gen)
        self._spawn(primary, rank, addr, prog_gen, request, deadline)
        hedge: Optional[_Dispatch] = None
        h_rank: Optional[int] = None
        with cv:
            cv.wait_for(lambda: primary.done,
                        timeout=min(self.hedge_delay_s(),
                                    max(0.0, deadline - time.perf_counter())))
        if not primary.done and rank == self.select_hedge_rank():
            h_rank, h_addr = self._pick(prog_gen, exclude=(rank,))
            # a hedge is EXTRA load: it spends from the same budget as
            # redispatches, so brownout silently skips it (the primary
            # still serves) instead of doubling a saturated fleet
            if h_rank is not None and self._budget_spend("hedge"):
                try:
                    inject.check("fleet.hedge")
                except Exception as e:  # except-ok: an (injected) transient at the hedge site abandons THIS hedge only; the primary still serves the request
                    if faults.classify(e) not in faults.TRANSIENT:
                        raise
                    self._m_hedge_abandoned.inc()
                    h_rank = None
                else:
                    obs.instant("fleet_hedge", CAT_FLEET, primary=rank,
                                hedge=h_rank, gen=prog_gen,
                                delay_s=round(self.hedge_delay_s(), 6))
                    self._m_hedges.inc()
                    hedge = _Dispatch(cv)
                    self._begin(h_rank, prog_gen)
                    self._spawn(hedge, h_rank, h_addr, prog_gen,
                                request, deadline)

        def _decided() -> bool:
            if primary.done and primary.error is None:
                return True
            if hedge is not None and hedge.done and hedge.error is None:
                return True
            return primary.done and (hedge is None or hedge.done)

        with cv:
            decided = cv.wait_for(
                _decided, timeout=max(0.0, deadline - time.perf_counter()))
        if not decided:
            raise RequestTimeoutError(
                f"request deadline expired with replica r{rank} still "
                f"in flight")
        if primary.done and primary.error is None:
            winner, loser = primary, hedge
            self._breaker_success(rank)
        elif hedge is not None and hedge.done and hedge.error is None:
            winner, loser = hedge, primary
            self._m_hedge_wins.inc()
            if h_rank is not None:
                self._breaker_success(h_rank)
        else:
            err = primary.error if primary.error is not None else \
                (hedge.error if hedge is not None else None)
            if isinstance(err, ReplicaDeadError):
                # keep the transient verdict: a 5xx/timeout must feed
                # the breaker upstream, not the quarantine path
                raise ReplicaDeadError(
                    str(err), rank=rank,
                    transient=err.transient) from err
            if err is not None and faults.classify(err) in \
                    faults.DEVICE_LOSS:
                raise ReplicaDeadError(
                    f"replica r{rank} failed: {err}", rank=rank) from err
            raise err if err is not None else ReplicaDeadError(
                f"replica r{rank} vanished", rank=rank)
        if loser is not None and not loser.done:
            loser.cancel()
            self._m_hedge_cancelled.inc()
        if winner is hedge and primary.done and primary.error is not None:
            # the hedge saved the request, but the primary DIED — leave
            # it in the table and every later request pays a failed
            # dispatch before routing around it. A TRANSIENT failure
            # (it answered 5xx / timed out) feeds its breaker instead.
            perr = primary.error
            if getattr(perr, "transient", False):
                self._breaker_failure(rank)
            elif isinstance(perr, ReplicaDeadError) or \
                    faults.classify(perr) in faults.DEVICE_LOSS:
                self._note_dead(rank)
        return winner.result

    def _begin(self, rank: int, prog_gen: int) -> None:
        with self._lock:
            self._outstanding[rank] = self._outstanding.get(rank, 0) + 1
            self._gen_inflight[prog_gen] = \
                self._gen_inflight.get(prog_gen, 0) + 1

    def _end(self, rank: int, prog_gen: int) -> None:
        with self._lock:
            self._outstanding[rank] = \
                max(0, self._outstanding.get(rank, 0) - 1)
            self._gen_inflight[prog_gen] = \
                max(0, self._gen_inflight.get(prog_gen, 0) - 1)

    def _spawn(self, d: _Dispatch, rank: int, addr: Any, prog_gen: int,
               request: Any, deadline: Optional[float] = None) -> None:
        def _run():
            try:
                inject.check("fleet.route")
                if self._transport_takes_deadline and deadline is not None:
                    out = self._transport(
                        addr, request,
                        remaining_s=max(0.0,
                                        deadline - time.perf_counter()))
                else:
                    out = self._transport(addr, request)
                d.complete(result=out)
            except BaseException as e:  # except-ok: the dispatch thread's verdict travels to the request thread via the _Dispatch; raising here would kill a daemon thread silently
                d.complete(error=e)
            finally:
                self._end(rank, prog_gen)

        t = threading.Thread(target=_run, daemon=True,
                             name=f"smtpu-fleet-dispatch-r{rank}")
        t.start()


def _accepts_remaining_s(transport: Callable) -> bool:
    """Does this transport accept the deadline-propagation keyword
    (``remaining_s``)? Signature-based so legacy 2-arg transports (and
    anything uninspectable) keep the pre-deadline call shape."""
    try:
        params = inspect.signature(transport).parameters
    except (TypeError, ValueError):
        return False
    if "remaining_s" in params:
        return True
    return any(p.kind == inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def http_transport(timeout_s: float = 30.0
                   ) -> Callable[[str, Any], Any]:
    """Stdlib transport for ``Router``: addresses are
    ``http://host:port/score`` URLs (fleet/replica.ReplicaEndpoint),
    requests/responses are JSON. Connection-level failures surface as
    ``ReplicaDeadError`` — from the router's seat they are the same
    routing fact as a dead process. That includes a replica killed
    while it wrote its answer: the headers arrived and the body did
    not (``http.client.IncompleteRead``, an ``HTTPException`` and no
    ``OSError``), which must reach the router as a death, never as a
    client error. A 5xx (a paused-out replica) is
    the SOFTER ``ReplicaDeadError(transient=True)``: the process
    answered, so it feeds the rank's circuit breaker rather than the
    immediate quarantine. A 429 means the replica SHED the request
    before scoring it (``AdmissionRejectedError``, carrying the
    server's Retry-After), and a remaining 4xx is the opposite fact —
    the replica is alive and rejected THIS request
    (``ReplicaRequestError``), propagated instead of redispatching
    across (and quarantining) the healthy fleet.

    When the router passes ``remaining_s`` (deadline propagation),
    two things happen: the remaining budget rides the
    ``X-SMTPU-Deadline-Ms`` header so the replica can refuse
    dead-on-arrival work, and the SOCKET timeout is capped at the
    remaining deadline so a hung replica drains this dispatch thread
    at the deadline (surfaced as ``RequestTimeoutError``) instead of
    holding it for the full transport timeout."""
    import http.client
    import urllib.error
    import urllib.request

    def _send(addr: str, request: Any,
              remaining_s: Optional[float] = None) -> Any:
        data = json.dumps(request).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        timeout = float(timeout_s)
        deadline_capped = False
        if remaining_s is not None:
            headers[admission.DEADLINE_HEADER] = str(
                int(max(0.0, remaining_s) * 1000.0))
            if remaining_s < timeout:
                timeout = max(0.001, remaining_s)
                deadline_capped = True
        req = urllib.request.Request(str(addr), data=data,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            # HTTPError subclasses URLError: catch it FIRST so an
            # error status keeps its semantics instead of collapsing
            # into connection-level death
            try:
                raw = e.read().decode("utf-8", "replace")
            except OSError:
                raw = ""
            try:
                parsed = json.loads(raw)
                detail = parsed.get("error", raw) \
                    if isinstance(parsed, dict) else raw
            except ValueError:
                parsed = None
                detail = raw  # send_error HTML (503) or empty
            detail = detail[:200]
            if e.code == 429:
                try:
                    retry_after = float(e.headers.get("Retry-After", 0))
                except (TypeError, ValueError):
                    retry_after = 0.0
                reason = (parsed.get("reason",
                                     admission.REASON_INFLIGHT)
                          if isinstance(parsed, dict)
                          else admission.REASON_INFLIGHT)
                raise AdmissionRejectedError(
                    f"replica at {addr} shed the request (429 "
                    f"{reason}): {detail}", reason=reason,
                    retry_after_s=retry_after) from e
            if e.code >= 500:
                raise ReplicaDeadError(
                    f"replica at {addr} answered {e.code}: "
                    f"{detail}", transient=True) from e
            raise ReplicaRequestError(
                f"replica at {addr} rejected the request "
                f"({e.code}): {detail}", status=e.code) from e
        except (urllib.error.URLError, ConnectionError, OSError,
                http.client.HTTPException) as e:
            cause = getattr(e, "reason", e)
            if isinstance(e, TimeoutError) \
                    or isinstance(cause, TimeoutError) \
                    or "timed out" in str(e):
                if deadline_capped:
                    # the REQUEST's deadline fired, not the transport's
                    # patience: a client verdict, never a death
                    raise RequestTimeoutError(
                        f"request deadline expired in transport to "
                        f"{addr}") from e
                raise ReplicaDeadError(
                    f"transport to {addr} timed out after {timeout:.3f}"
                    f"s", transient=True) from e
            raise ReplicaDeadError(
                f"transport to {addr} failed: {e}") from e

    return _send
