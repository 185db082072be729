"""The serving fleet of the port (systemml_tpu_torch/fleet/{replica,router,
rollout,admission}.py) against the JAX package's (systemml_tpu/fleet/) on
the CPU: the analogues of tests/test_fleet_serving.py.

Each routing-table, router, hedge, injection, admission, breaker, budget
and rollout case is one scenario run through both packages with the same
fake transports: the epochs, the picks, the generation splits, the
counters and the events each package emits (flight-recorder instants
and the ambient Statistics' counters) must be equal. Cases whose outcome
depends on thread timing run in each package and hold the same
invariants. A `Replica` of each package serves a softmax scorer
(`ScoringService`, device "cpu", fp64) over real HTTP, generations 0 and
1, and the port's answers equal the JAX package's at 1e-9.

Then one three-process fleet on the CPU (the JAX package's `fleetserve3`
scenario of tests/multihost_worker.py:1095, without the mesh reform):
three replica processes each serve the scorer, this process routes 6
clients through a `Router` over `http_transport`, the last replica
SIGKILLs itself mid-stream, and a rolling g0 -> g1 update runs under the
same load. No request fails, every answer carries its rank and
generation and is within 1e-9 of that generation's softmax and more
than 1e-3 from the other's, the death is one routing-epoch bump, and the
merged shards give both storylines through `python -m
systemml_tpu_torch.obs.fleet_trace`. It runs under a time limit of its
own and kills its children in a `finally`.

Four repairs of the port against the reference are held here: one
replica death is one epoch bump however many requests were in flight on
it, a reply cut after its headers is a dead replica (not a client error),
a 429 on a large request still reaches the router as a 429, and threads
that write one replica's registry row at once do not collide on its
temporary file.

Waiting, and named in ROADMAP: the tests of `FleetMember` (item 12; here
only that constructing one raises), `detach_at_healthy_point` and
`scheduled_port` (item 12), and the lints
(`test_shared_state_lint_covers_fleet_files`,
`test_elastic_lint_vocabulary_names_fleet_sites`,
`test_check_metrics_covers_fleet_event_emitters`: item 11b).
"""

import http.server
import importlib
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    """The fleet's modules of one package, by the JAX package's names."""

    def __init__(self, root):
        imp = importlib.import_module
        self.name = root
        fleet = imp(f"{root}.fleet")
        for n in fleet.__all__:
            setattr(self, n, getattr(fleet, n))
        self.admission = imp(f"{root}.fleet.admission")
        self.obs_fleet = imp(f"{root}.obs.fleet")
        self.T = imp(f"{root}.obs.trace")
        self.MetricsRegistry = imp(f"{root}.obs.metrics").MetricsRegistry
        self.faults = imp(f"{root}.resil.faults")
        self.inject = imp(f"{root}.resil.inject")
        stats = imp(f"{root}.utils.stats")
        self.Statistics = stats.Statistics
        self.stats_scope = stats.stats_scope
        self.config = imp(f"{root}.utils.config")


JAX, PORT = Pkg("systemml_tpu"), Pkg("systemml_tpu_torch")
BOTH = [JAX, PORT]
# event arguments that read a clock or the host
_CLOCKED = ("delay_s", "pid", "port", "wall_ns")


@pytest.fixture(autouse=True)
def _clean_fleet_state():
    for p in BOTH:
        p.obs_fleet.clear_identity()
        p.inject.reset()
    yield
    for p in BOTH:
        p.inject.reset()
        p.obs_fleet.clear_identity()


def _observe(p, scenario):
    """Runs `scenario(p)` under a fresh recorder and Statistics; returns
    its result, the events it emitted and the counters it bumped."""
    rec = p.T.FlightRecorder()
    st = p.Statistics()
    prev = p.T.install(rec)
    try:
        with p.stats_scope(st):
            out = scenario(p)
    finally:
        p.T.install(prev)
    events = [(e.name, e.cat, {k: v for k, v in (e.args or {}).items()
                               if k not in _CLOCKED})
              for e in rec.events()]
    return {"out": out, "events": events,
            "resil": dict(st.resil_counts.items()),
            "overload": dict(st.overload_counts.items())}


def _same(scenario):
    """The scenario's observation in both packages, asserted equal."""
    j, t = _observe(JAX, scenario), _observe(PORT, scenario)
    assert t == j
    return t


def _table(p, targets):
    t = p.RoutingTable()
    t.install(targets)
    return t


def _echo(addr, request):
    return {"served_by": addr, "request": request}


def _count(router, name):
    return router.registry.get(name).value


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the scenario reports what was raised
        return {"type": type(e).__name__,
                **{k: getattr(e, k) for k in ("reason", "retry_after_s",
                                              "status", "rank",
                                              "transient")
                   if hasattr(e, k)}}
    return None


# --------------------------------------------------------------------------
# routing table: membership, epoch bumps, deterministic traffic split
# --------------------------------------------------------------------------

def test_routing_table_membership_views():
    def sc(p):
        t = _table(p, {(0, 0): "a0", (1, 0): "a1"})
        out = [t.live_ranks(), t.generations()]
        t.add(1, 1, "a1g1")
        out += [t.generations(), t.targets_for(1)]
        t.set_weight(1, 50)
        t.discard_generation(1)
        out += [t.generations(), t.weight(1)]
        return out

    obs = _same(sc)
    assert obs["out"] == [[0, 1], [0], [0, 1], {1: "a1g1"}, [0], 0]


def test_route_epoch_bump_removes_dead_and_emits():
    def sc(p):
        t = _table(p, {(0, 0): "a0", (1, 0): "a1", (1, 1): "a1g1"})
        return [t.route_epoch_bump([1], reason="test"), t.live_ranks(),
                t.epoch]

    obs = _same(sc)
    assert obs["out"] == [1, [0], 1]
    assert obs["resil"] == {"fleet_route_epoch": 1}
    assert obs["events"] == [("fleet_route_epoch", "resil",
                              {"epoch": 1, "dead": [1], "reason": "test"})]


@pytest.mark.parametrize("weight", [0, 25, 50, 100, 250, -5])
def test_gen_for_deterministic_weighted_split(weight):
    def sc(p):
        t = _table(p, {(0, 0): "g0", (0, 1): "g1"})
        t.set_weight(1, weight)
        return [t.weight(1), [t.gen_for(s) for s in range(200)],
                p.RoutingTable().gen_for(7)]

    obs = _same(sc)
    w, picks, empty = obs["out"]
    assert w == max(0, min(100, weight))
    assert picks.count(1) == 2 * w
    assert empty == 0


# --------------------------------------------------------------------------
# router: balancing, failover redispatch, exhaustion
# --------------------------------------------------------------------------

def test_router_picks_least_outstanding_lowest_rank_tiebreak():
    def sc(p):
        router = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}), _echo,
                          registry=p.MetricsRegistry())
        first = router.submit({"q": 1})["served_by"]
        router._begin(0, 0)
        try:
            second = router.submit({"q": 2})["served_by"]
        finally:
            router._end(0, 0)
        return [first, second, _count(router, "fleet_requests_total")]

    assert _same(sc)["out"] == ["r0", "r1", 2]


def test_router_failover_is_epoch_bump_not_client_error():
    def sc(p):
        def transport(addr, request):
            if addr == "r0":
                raise p.ReplicaDeadError("connection refused")
            return {"served_by": addr}

        router = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}),
                          transport, registry=p.MetricsRegistry())
        out = router.submit({"q": 1})["served_by"]
        return [out, router.redispatch_count, router.table.epoch,
                router.table.live_ranks(),
                _count(router, "fleet_failed_requests_total")]

    obs = _same(sc)
    assert obs["out"] == ["r1", 1, 1, [1], 0]
    assert obs["resil"] == {"fleet_route_epoch": 1}


def test_router_fleet_wide_outage_surfaces_no_live_replicas():
    def sc(p):
        def transport(addr, request):
            raise p.ReplicaDeadError("gone")

        router = p.Router(_table(p, {(0, 0): "r0"}), transport,
                          registry=p.MetricsRegistry())
        err = _raised(lambda: router.submit({"q": 1}, timeout_s=5.0))
        return [err, _count(router, "fleet_failed_requests_total")]

    assert _same(sc)["out"] == [{"type": "NoLiveReplicasError"}, 1]


@pytest.mark.parametrize("kind", ["fatal", "request_error"])
def test_router_fatal_errors_propagate_without_quarantine(kind):
    def sc(p):
        def transport(addr, request):
            if kind == "fatal":
                raise ValueError("bad request payload")
            raise p.ReplicaRequestError("422: payload shape", status=422)

        table = _table(p, {(0, 0): "r0", (1, 0): "r1"})
        router = p.Router(table, transport, registry=p.MetricsRegistry())
        err = _raised(lambda: router.submit({"q": 1}))
        ok = p.Router(table, _echo, registry=p.MetricsRegistry())
        return [err, router.redispatch_count, table.epoch,
                table.live_ranks(), ok.submit({"q": 2})["served_by"]]

    obs = _same(sc)
    want = ({"type": "ValueError"} if kind == "fatal"
            else {"type": "ReplicaRequestError", "status": 422})
    assert obs["out"] == [want, 0, 0, [0, 1], "r0"]


def test_router_deadline_expiry_is_a_timeout_not_a_death():
    def sc(p):
        release = threading.Event()

        def transport(addr, request):
            release.wait(5.0)
            return {"served_by": addr}

        table = _table(p, {(0, 0): "slow"})
        router = p.Router(table, transport, registry=p.MetricsRegistry())
        try:
            err = _raised(lambda: router.submit({"q": 1}, timeout_s=0.1))
        finally:
            release.set()
        return [err, table.epoch, table.live_ranks(),
                _count(router, "fleet_request_timeouts_total"),
                _count(router, "fleet_redispatch_total")]

    assert _same(sc)["out"] == [{"type": "RequestTimeoutError"}, 0, [0],
                                1, 0]


def test_router_on_replica_dead_hook_replaces_quarantine():
    def sc(p):
        seen = []

        def transport(addr, request):
            if addr == "r0" and not seen:
                raise p.ReplicaDeadError("first attempt dies")
            return {"served_by": addr}

        table = _table(p, {(0, 0): "r0", (1, 0): "r1"})

        def on_dead(rank):
            seen.append(rank)
            table.route_epoch_bump([rank], reason="reform")

        router = p.Router(table, transport, registry=p.MetricsRegistry(),
                          on_replica_dead=on_dead)
        return [router.submit({"q": 1})["served_by"], seen]

    obs = _same(sc)
    assert obs["out"] == ["r1", [0]]
    assert obs["events"][0][2]["reason"] == "reform"


# --------------------------------------------------------------------------
# hedging: target selection, measured delay, first response wins
# --------------------------------------------------------------------------

def test_select_hedge_rank_and_its_degenerate_cases():
    def sc(p):
        two = _table(p, {(0, 0): "r0", (1, 0): "r1"})
        router = p.Router(two, _echo, registry=p.MetricsRegistry())
        single = p.Router(_table(p, {(0, 0): "r0"}), _echo,
                          registry=p.MetricsRegistry())
        called = p.Router(two, _echo, registry=p.MetricsRegistry(),
                          straggler_report=lambda: {"slowest_rank": 1})
        fixed = p.Router(two, _echo, registry=p.MetricsRegistry(),
                         straggler_report={"slowest_rank": 0})
        return [router.select_hedge_rank({"slowest_rank": 1}),
                router.select_hedge_rank({"slowest_rank": 0}),
                router.select_hedge_rank(None), router.select_hedge_rank({}),
                router.select_hedge_rank({"slowest_rank": None}),
                router.select_hedge_rank({"slowest_rank": 5}),
                single.select_hedge_rank({"slowest_rank": 0}),
                called.select_hedge_rank(), fixed.select_hedge_rank()]

    assert _same(sc)["out"] == [1, 0, None, None, None, None, None, 1, 0]


def test_hedge_delay_is_floor_then_measured_quantile():
    def sc(p):
        reg = p.MetricsRegistry
        router = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}), _echo,
                          registry=reg(), hedge_floor_s=0.05,
                          hedge_min_samples=10, hedge_quantile=0.95)
        out = [router.hedge_delay_s()]
        for _ in range(20):
            router._m_latency.observe(0.2)
        out.append(router.hedge_delay_s())
        fast = p.Router(_table(p, {(0, 0): "r0"}), _echo, registry=reg(),
                        hedge_floor_s=0.05, hedge_min_samples=10)
        for _ in range(20):
            fast._m_latency.observe(0.001)
        out.append(fast.hedge_delay_s())
        empty = p.Router(_table(p, {(0, 0): "r0"}), _echo, registry=reg(),
                         hedge_min_samples=0, hedge_floor_s=0.025)
        out.append(empty.hedge_delay_s())
        out.append(math.isnan(empty.p99_s()))
        empty.submit({"q": 1})
        out.append(empty.p99_s() >= 0.0)
        return out

    out = _same(sc)["out"]
    assert out[0] == 0.05 and out[1] >= 0.1 and out[2] == 0.05
    assert out[3] == 0.025 and out[4] and out[5]


@pytest.mark.parametrize("case", ["straggler_wins", "dying_primary",
                                  "not_the_straggler", "injected_abandon"])
def test_hedging_over_timed_transports(case):
    def sc(p):
        def transport(addr, request):
            if case == "dying_primary":
                if addr == "slow":
                    time.sleep(0.05)
                    raise p.ReplicaDeadError("primary died mid-hedge")
                time.sleep(0.15)
            elif addr == "slow":
                time.sleep(0.25 if case != "not_the_straggler" else 0.1)
            return {"served_by": addr}

        if case == "injected_abandon":
            p.inject.arm("fleet.hedge:deadline:1")
        table = _table(p, {(0, 0): "slow", (1, 0): "fast"})
        slowest = 1 if case == "not_the_straggler" else 0
        router = p.Router(table, transport, registry=p.MetricsRegistry(),
                          straggler_report={"slowest_rank": slowest},
                          hedge_floor_s=0.02, hedge_min_samples=10 ** 6)
        served = router.submit({"q": 1}, timeout_s=10.0)["served_by"]
        return [served, table.live_ranks(), table.epoch] + [
            _count(router, n) for n in (
                "fleet_hedges_total", "fleet_hedge_wins_total",
                "fleet_hedges_cancelled_total",
                "fleet_hedges_abandoned_total",
                "fleet_failed_requests_total")]

    obs = _same(sc)
    want = {"straggler_wins": ["fast", [0, 1], 0, 1, 1, 1, 0, 0],
            "dying_primary": ["fast", [1], 1, 1, 1, 0, 0, 0],
            "not_the_straggler": ["slow", [0, 1], 0, 0, 0, 0, 0, 0],
            "injected_abandon": ["slow", [0, 1], 0, 0, 0, 0, 1, 0]}[case]
    assert obs["out"] == want


def test_hedge_wait_is_capped_at_the_deadline_when_both_hang():
    def sc(p):
        hang = threading.Event()

        def transport(addr, request):
            hang.wait(20.0)
            return {"served_by": addr}

        router = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}),
                          transport, registry=p.MetricsRegistry(),
                          straggler_report={"slowest_rank": 0},
                          hedge_min_samples=0, hedge_floor_s=0.01)
        t0 = time.perf_counter()
        try:
            err = _raised(lambda: router.submit({"x": 1}, timeout_s=0.3))
            fast = time.perf_counter() - t0 < 5.0
        finally:
            hang.set()
        return [err, fast, _count(router, "fleet_hedges_total"),
                _count(router, "fleet_request_timeouts_total"),
                router.table.live_ranks()]

    assert _same(sc)["out"] == [{"type": "RequestTimeoutError"}, True, 1, 1,
                                [0, 1]]


# --------------------------------------------------------------------------
# injection sites
# --------------------------------------------------------------------------

def test_fleet_sites_registered_with_their_default_kinds():
    for site, kind in (("fleet.route", "worker"), ("fleet.hedge", "deadline"),
                       ("fleet.rollout", "preempt"), ("fleet.admit", "error"),
                       ("router.budget", "error")):
        assert PORT.inject.SITES[site] == JAX.inject.SITES[site] == kind
        assert site in PORT.config.PORTED_FAULT_SITES
        PORT.config.check_fault_sites(f"{site}:{kind}:1")
    with pytest.raises(NotImplementedError, match="item 12"):
        PORT.config.check_fault_sites("collective.allreduce:worker:1")


def test_injected_route_death_absorbed_by_redispatch():
    def sc(p):
        p.inject.arm("fleet.route:worker:1")
        router = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}), _echo,
                          registry=p.MetricsRegistry())
        return [router.submit({"q": 1}, timeout_s=10.0)["served_by"],
                router.redispatch_count, router.table.epoch,
                _count(router, "fleet_failed_requests_total")]

    assert _same(sc)["out"] == ["r1", 1, 1, 0]


@pytest.mark.parametrize("kind", ["preempt", "error"])
def test_injected_rollout_fault(kind):
    def sc(p):
        p.inject.arm(f"fleet.rollout:{kind}:1")
        router = p.Router(_table(p, {(0, 0): "g0", (0, 1): "g1"}), _echo,
                          registry=p.MetricsRegistry())
        ru = p.RollingUpdate(router, 0, 1, weights=(50, 100))
        err = _raised(lambda: ru.run(drain_timeout_s=5.0))
        return [err, router.table.generations(), ru.shift_attempts,
                router.submit({"q": 1})["served_by"]]

    obs = _same(sc)
    if kind == "preempt":
        # a transient retries the same idempotent shift
        assert obs["out"] == [None, [1], 3, "g1"]
        assert obs["resil"]["fault[preempt]"] == 1
        assert obs["resil"]["rollout_shift"] == 2
        assert obs["resil"]["rollout_done"] == 1
    else:
        # a fatal one stalls the split: both generations still serve
        assert obs["out"] == [{"type": "NameError"}, [0, 1], 1, "g0"]


# --------------------------------------------------------------------------
# rolling updates
# --------------------------------------------------------------------------

def test_rolling_update_shifts_drains_retires_and_emits():
    def sc(p):
        router = p.Router(_table(p, {(0, 0): "g0", (0, 1): "g1",
                                     (1, 0): "g0b", (1, 1): "g1b"}), _echo,
                          registry=p.MetricsRegistry())
        retired = []
        ru = p.RollingUpdate(router, 0, 1, weights=(25, 50, 75, 100))
        ru.run(retire=retired.append, drain_timeout_s=5.0)
        return [retired, router.table.generations(), ru.reworked,
                router.submit({"q": 1})["served_by"]]

    obs = _same(sc)
    assert obs["out"] == [[0], [1], 0, "g1"]
    assert obs["resil"] == {"rollout_start": 1, "rollout_shift": 4,
                            "rollout_drain": 1, "rollout_done": 1}
    assert [n for n, _, _ in obs["events"]] == [
        "rollout_start"] + ["rollout_shift"] * 4 + ["rollout_drain",
                                                    "rollout_done"]


def test_drain_rollout_times_out_on_stuck_inflight():
    def sc(p):
        router = p.Router(_table(p, {(0, 0): "g0", (0, 1): "g1"}), _echo,
                          registry=p.MetricsRegistry())
        ru = p.RollingUpdate(router, 0, 1)
        router._begin(0, 0)
        try:
            err = _raised(lambda: ru.drain_rollout(timeout_s=0.05,
                                                   poll_s=0.01))
        finally:
            router._end(0, 0)
        return [err, ru.drain_rollout(timeout_s=1.0)]

    assert _same(sc)["out"] == [{"type": "TimeoutError"}, 0]


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.name)
def test_rolling_update_under_concurrent_load_bounded_rework(p):
    def transport(addr, request):
        time.sleep(0.002)
        return {"gen": 0 if addr.startswith("g0") else 1}

    router = p.Router(_table(p, {(0, 0): "g0", (1, 0): "g0b",
                                 (0, 1): "g1", (1, 1): "g1b"}), transport,
                      registry=p.MetricsRegistry())
    stop = threading.Event()
    counts = {0: 0, 1: 0}
    failures = []
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            try:
                g = router.submit({"q": 1}, timeout_s=10.0)["gen"]
                with lock:
                    counts[g] += 1
            except Exception as e:  # asserted empty below
                failures.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        p.RollingUpdate(router, 0, 1).run(drain_timeout_s=10.0)
        time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
    assert not failures, failures
    assert counts[0] > 0 and counts[1] > 0
    assert router.table.generations() == [1]
    assert _count(router, "fleet_failed_requests_total") == 0


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.name)
def test_route_epoch_bump_racing_rollout_loses_no_answers(p):
    def transport(addr, request):
        time.sleep(0.001)
        return {"served_by": addr, "i": request["i"]}

    table = _table(p, {(0, 0): "r0g0", (1, 0): "r1g0", (2, 0): "r2g0",
                       (0, 1): "r0g1", (1, 1): "r1g1"})
    router = p.Router(table, transport, registry=p.MetricsRegistry())
    stop = threading.Event()
    results, failures = [], []
    rlock = threading.Lock()

    def client(base):
        i = base
        while not stop.is_set():
            i += 1
            try:
                out = router.submit({"i": i}, timeout_s=5.0)
            except Exception as e:  # the race must lose nothing
                failures.append(e)
                return
            with rlock:
                results.append((out["served_by"], out["i"]))

    threads = [threading.Thread(target=client, args=(k * 1_000_000,),
                                daemon=True) for k in range(4)]
    for t in threads:
        t.start()

    def bump():
        time.sleep(0.02)
        table.route_epoch_bump([2], reason="death-mid-rollout")

    bt = threading.Thread(target=bump, daemon=True)
    try:
        bt.start()
        p.RollingUpdate(router, 0, 1, weights=(50, 100)).run(
            drain_timeout_s=10.0)
        bt.join(timeout=5.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
    assert not failures, failures[:3]
    ids = [i for _, i in results]
    assert len(ids) == len(set(ids))
    assert table.generations() == [1] and 2 not in table.live_ranks()
    for i in range(10):
        assert router.submit({"i": -1 - i})["served_by"] in ("r0g1", "r1g1")


def test_one_death_is_one_epoch_however_many_requests_were_in_flight():
    """Eight requests in flight on replica 0 fail together; the port's
    router bumps the epoch once. (The JAX package's check of the rank's
    liveness and its bump take separate locks, so two failures can both
    see the rank live and bump twice.)"""
    p = PORT
    gate = threading.Barrier(8, timeout=10.0)

    def transport(addr, request):
        if addr == "r0":
            gate.wait()
            raise p.ReplicaDeadError("connection reset")
        return {"served_by": addr}

    table = _table(p, {(0, 0): "r0", (1, 0): "r1", (2, 0): "r2"})
    router = p.Router(table, transport, registry=p.MetricsRegistry())
    live = table.live_ranks

    def slow_live_ranks():
        ranks = live()
        time.sleep(0.01)     # widen the window between check and bump
        return ranks

    table.live_ranks = slow_live_ranks
    for _ in range(8):       # r1 and r2 busy: every request picks r0
        router._begin(1, 0)
        router._begin(2, 0)
    outs = []
    ts = [threading.Thread(target=lambda: outs.append(
        router.submit({"q": 1}, timeout_s=10.0)["served_by"]))
        for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=20.0)
    assert len(outs) == 8 and "r0" not in outs
    assert table.epoch == 1 and table.live_ranks() == [1, 2]
    assert router.redispatch_count == 8


# --------------------------------------------------------------------------
# admission, retry budget, circuit breaker
# --------------------------------------------------------------------------

def test_admission_gate_bounds_expiry_prediction_and_floor():
    def sc(p):
        a = p.admission
        gate = a.AdmissionGate(inflight_max=2)
        out = [gate.try_admit(), gate.try_admit(), gate.depth,
               gate.try_admit(), gate.depth]
        gate.release()
        out.append(gate.try_admit())
        for _ in range(5):
            gate.release()
        out.append(gate.depth)
        g = a.AdmissionGate(inflight_max=10, service_time_s=lambda: 0.1)
        out += [g.try_admit(remaining_s=0.0), g.try_admit(remaining_s=-1.0)]
        out += [g.try_admit(remaining_s=10.0) for _ in range(3)]
        out += [g.try_admit(remaining_s=0.2), g.try_admit(remaining_s=1.0),
                round(g.retry_after_s(), 9)]
        for bad in (lambda: float("nan"), lambda: 0.0, None,
                    lambda: (_ for _ in ()).throw(RuntimeError("boom"))):
            b = a.AdmissionGate(inflight_max=4, service_time_s=bad)
            out.append((b.service_time_s() >= b.service_floor_s,
                        b.retry_after_s() > 0.0))
        off = a.AdmissionGate(inflight_max=0)
        out += [off.enabled, [off.try_admit(remaining_s=-1.0)
                              for _ in range(3)], off.depth]
        return out

    out = _same(sc)["out"]
    assert out[:7] == [None, None, 2, "inflight", 2, None, 0]
    assert out[7:14] == ["expired", "expired", None, None, None,
                         "predicted_wait", None]
    assert out[14] == pytest.approx(0.4)


def test_retry_budget_and_circuit_breaker():
    def sc(p):
        a = p.admission
        budget = a.RetryBudget(cap=2.0, ratio=0.5)
        out = [budget.try_spend(), budget.try_spend(), budget.try_spend()]
        for _ in range(10):
            budget.note_success()
        out += [budget.tokens, budget.try_spend()]
        off = a.RetryBudget(cap=0.0)
        out += [off.tokens, all(off.try_spend() for _ in range(100))]
        clk = [0.0]
        br = a.CircuitBreaker(threshold=2, reset_s=1.0, clock=lambda: clk[0])
        trail = [br.state, br.allow()]
        br.record_failure()
        trail.append(br.state)
        br.record_failure()
        trail += [br.state, br.allow()]
        clk[0] = 1.0
        trail += [br.state, br.allow(), br.allow()]
        br.record_failure()
        trail.append(br.state)
        clk[0] = 2.0
        trail.append(br.allow())
        br.record_success()
        trail += [br.state, br.state_code]
        run = a.CircuitBreaker(threshold=3)
        for f in (1, 1, 0, 1, 1):
            run.record_failure() if f else run.record_success()
        trail.append(run.state)
        return out + trail

    out = _same(sc)["out"]
    assert out[:5] == [True, True, False, 2.0, True]
    assert out[7:] == ["closed", True, "closed", "open", False, "half_open",
                       True, False, "open", True, "closed", 0, "closed"]


def test_single_shed_reroutes_and_fleet_wide_shed_is_the_429():
    def sc(p):
        a = p.admission

        def one_full(addr, request):
            if addr == "r0":
                raise a.AdmissionRejectedError(
                    "r0 is full", reason=a.REASON_INFLIGHT,
                    retry_after_s=0.5)
            return {"served_by": addr}

        def all_full(addr, request):
            raise a.AdmissionRejectedError(
                f"{addr} full", reason=a.REASON_PREDICTED_WAIT,
                retry_after_s=0.25)

        r1 = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}), one_full,
                      registry=p.MetricsRegistry())
        r2 = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}), all_full,
                      registry=p.MetricsRegistry())
        return [r1.submit({"x": 1}, timeout_s=5.0)["served_by"],
                _count(r1, "fleet_shed_retries_total"), r1.redispatch_count,
                r1.table.live_ranks(),
                _raised(lambda: r2.submit({"x": 1}, timeout_s=5.0)),
                r2.table.live_ranks(),
                _count(r2, "fleet_failed_requests_total")]

    assert _same(sc)["out"] == [
        "r1", 1, 0, [0, 1],
        {"type": "AdmissionRejectedError", "reason": "predicted_wait",
         "retry_after_s": 0.25}, [0, 1], 0]


@pytest.mark.parametrize("how", ["drained", "injected"])
def test_brownout_degrades_redispatch_to_fail_fast_429(how):
    def sc(p):
        def transport(addr, request):
            raise p.ReplicaDeadError(f"{addr} answered 503", transient=True)

        kw = ({"retry_budget_cap": 1, "retry_budget_ratio": 0.0}
              if how == "drained" else {})
        router = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}),
                          transport, registry=p.MetricsRegistry(),
                          breaker_threshold=0, **kw)
        if how == "injected":
            p.inject.arm("router.budget:error:1")
        err = _raised(lambda: router.submit({"x": 1}, timeout_s=5.0))
        return [err["type"], err["reason"], err["retry_after_s"] > 0,
                _count(router, "fleet_retry_budget_exhausted_total"),
                router.budget.tokens]

    obs = _same(sc)
    assert obs["out"][:4] == ["AdmissionRejectedError", "budget", True, 1]
    assert obs["overload"] == {"fleet_budget_exhausted": 1}


def test_transient_failures_feed_the_breaker_not_quarantine():
    def sc(p):
        fail = {"on": True}

        def transport(addr, request):
            if fail["on"] and addr == "r0":
                raise p.ReplicaDeadError("503 from r0", transient=True)
            return {"served_by": addr}

        table = _table(p, {(0, 0): "r0", (1, 0): "r1"})
        router = p.Router(table, transport, registry=p.MetricsRegistry(),
                          breaker_threshold=2, breaker_reset_s=0.2)
        for _ in range(8):
            router.submit({"x": 1}, timeout_s=5.0)
            if router.breaker_state(0) == "open":
                break
        out = [router.breaker_state(0), table.epoch, table.live_ranks(),
               [router.submit({"x": 1}, timeout_s=5.0)["served_by"]
                for _ in range(4)]]
        fail["on"] = False
        time.sleep(0.25)
        for _ in range(4):
            router.submit({"x": 1}, timeout_s=5.0)
        return out + [router.breaker_state(0),
                      _count(router, "fleet_breakers_open_current"),
                      _count(router, "fleet_breaker_open_total")]

    obs = _same(sc)
    assert obs["out"] == ["open", 0, [0, 1], ["r1"] * 4, "closed", 0, 1]
    assert obs["overload"] == {"fleet_breaker_open": 1,
                               "fleet_breaker_close": 1}


def test_deadline_propagates_and_shrinks_across_redispatch():
    def sc(p):
        seen = []

        def transport(addr, request, remaining_s=None):
            seen.append((addr, remaining_s))
            if len(seen) == 1:
                time.sleep(0.05)
                raise p.ReplicaDeadError("first attempt died")
            return {"served_by": addr}

        router = p.Router(_table(p, {(0, 0): "r0", (1, 0): "r1"}),
                          transport, registry=p.MetricsRegistry())
        served = router.submit({"x": 1}, timeout_s=5.0)["served_by"]
        first, second = seen[0][1], seen[1][1]
        return [served, len(seen), 0.0 < first <= 5.0, second < first,
                router.redispatch_count]

    assert _same(sc)["out"] == ["r1", 2, True, True, 1]


def test_router_and_replica_export_the_same_metric_names(tmp_path):
    names = {}
    for p in BOTH:
        reg = p.MetricsRegistry()
        p.Router(p.RoutingTable(), _echo, registry=reg)
        rep = p.Replica(lambda g: (lambda payload: {"ok": True}),
                        fleet_dir=str(tmp_path / p.name))
        names[p.name] = (sorted(reg.to_dict()),
                         sorted(rep.registry.to_dict()),
                         reg.get("fleet_route_epoch_current").value,
                         rep.registry.get("fleet_admission_inflight").value)
    assert names["systemml_tpu_torch"] == names["systemml_tpu"]
    assert "fleet_retry_budget_tokens" in names["systemml_tpu"][0]


# --------------------------------------------------------------------------
# the replica: HTTP endpoints, registry liveness, pause gate
# --------------------------------------------------------------------------

def _sum_factory(prog_gen):
    def _score(payload):
        return {"y": float(sum(payload["x"])) + 10.0 * prog_gen}
    return _score


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.name)
def test_replica_serves_generations_over_real_http(tmp_path, p):
    replica = p.Replica(_sum_factory, fleet_dir=str(tmp_path))
    try:
        replica.serve(0, port=0)
        replica.serve(1, port=0)
        replica.register(step=0)
        reg = p.read_registry(str(tmp_path))
        assert list(reg) == [0]
        send = p.http_transport(timeout_s=10.0)
        assert send(reg[0].url(0), {"x": [1.0, 2.0, 3.0]}) == \
            {"rank": 0, "prog_gen": 0, "outputs": {"y": 6.0}}
        assert send(reg[0].url(1), {"x": [1.0, 2.0, 3.0]}) == \
            {"rank": 0, "prog_gen": 1, "outputs": {"y": 16.0}}
        assert reg[0].url(7) is None
        url0 = reg[0].url(0)
    finally:
        replica.close()
    assert p.read_registry(str(tmp_path)) == {}
    with pytest.raises(p.ReplicaDeadError):
        send(url0, {"x": [1.0]})


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.name)
def test_replica_failures_answer_400_and_503(tmp_path, p):
    def bad_factory(prog_gen):
        def _score(payload):
            raise ValueError("scorer exploded")
        return _score

    bad = p.Replica(bad_factory, fleet_dir=str(tmp_path / "bad"))
    good = p.Replica(_sum_factory, fleet_dir=str(tmp_path / "good"))
    try:
        ep = bad.serve(0, port=0)
        with pytest.raises(p.ReplicaRequestError) as ei:
            p.http_transport(timeout_s=10.0)(ep.url, {"x": [1.0]})
        assert ei.value.status == 400
        assert "scorer exploded" in str(ei.value)
        ep2 = good.serve(0, port=0)
        with good._lock:
            good._scorers.pop(0)   # a stale table's retired generation
        with pytest.raises(p.ReplicaDeadError) as ed:
            p.http_transport(timeout_s=10.0)(ep2.url, {"x": [1.0]})
        assert ed.value.transient
    finally:
        bad.close()
        good.close()
    assert p.faults.classify(p.ReplicaUnavailableError("paused")) \
        in p.faults.TRANSIENT


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.name)
def test_replica_retire_pause_heartbeat_and_registry(tmp_path, p):
    replica = p.Replica(_sum_factory, fleet_dir=str(tmp_path))
    try:
        replica.serve(0, port=0)
        replica.serve(1, port=0)
        replica.register()
        st = p.Statistics()
        with p.stats_scope(st):
            replica.retire_generation(0)
        assert st.resil_counts.get("rollout_retire") == 1
        assert sorted(replica.endpoints()) == [1]
        assert p.read_registry(str(tmp_path))[0].url(0) is None
        replica.pause()
        out = {}
        t = threading.Thread(target=lambda: out.__setitem__(
            "resp", replica.score(1, {"x": [2.0]})), daemon=True)
        t.start()
        time.sleep(0.1)
        assert "resp" not in out
        replica.resume()
        t.join(timeout=10.0)
        assert out["resp"]["outputs"] == {"y": 12.0}
        first = p.read_registry(str(tmp_path))[0].wall_ns
        replica.start_heartbeat(interval_s=0.05)
        time.sleep(0.2)
        assert p.read_registry(str(tmp_path))[0].wall_ns > first
    finally:
        replica.close()
    with pytest.raises(ValueError):
        p.Replica(_sum_factory, fleet_dir="")
    live = p.ReplicaInfo("run-t", 0, 0, 0, pid=1, host="127.0.0.1",
                         endpoints={"0": 7001}, wall_ns=time.time_ns())
    stale = p.ReplicaInfo("run-t", 1, 1, 0, pid=2, host="127.0.0.1",
                          endpoints={"0": 7002},
                          wall_ns=time.time_ns() - int(60e9))
    for info in (live, stale):
        with open(p.registry_path(str(tmp_path), info.orig_rank), "w") as f:
            json.dump(info.to_dict(), f)
    with open(p.registry_path(str(tmp_path), 2), "w") as f:
        f.write('{"run_id": "run-t", "orig')
    assert list(p.read_registry(str(tmp_path), ttl_s=5.0)) == [0]
    assert p.ReplicaInfo.from_dict(live.to_dict()).to_dict() == \
        JAX.ReplicaInfo.from_dict(live.to_dict()).to_dict()
    assert p.read_registry(str(tmp_path / "nope")) == {}


def test_port_registry_row_survives_concurrent_heartbeats(tmp_path):
    # the heartbeat thread and the caller's heartbeat() write the same
    # row; the reference shares one temporary file between them, so one
    # thread's os.replace can find the file already moved
    replica = PORT.Replica(_sum_factory, fleet_dir=str(tmp_path))
    errors = []

    def beat():
        try:
            for step in range(200):
                replica.heartbeat(step)
        except Exception as e:  # noqa: BLE001 - the test reports it
            errors.append(repr(e))

    try:
        replica.serve(0, port=0)
        threads = [threading.Thread(target=beat) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert errors == []
        assert PORT.read_registry(str(tmp_path))[0].url(0) is not None
        assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []
    finally:
        replica.close()


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.name)
def test_replica_sheds_429_with_retry_after_when_inflight_full(tmp_path, p):
    release = threading.Event()

    def slow_factory(prog_gen):
        def _score(payload):
            release.wait(10.0)
            return {"y": 1.0}
        return _score

    replica = p.Replica(slow_factory, fleet_dir=str(tmp_path))
    try:
        replica.gate.inflight_max = 1
        ep = replica.serve(0, port=0)
        send = p.http_transport(timeout_s=10.0)
        t = threading.Thread(target=lambda: send(ep.url, {"x": [1.0]}),
                             daemon=True)
        t.start()
        deadline = time.time() + 5.0
        while replica.gate.depth < 1 and time.time() < deadline:
            time.sleep(0.005)
        with pytest.raises(p.AdmissionRejectedError) as ei:
            send(ep.url, {"x": [2.0]}, remaining_s=5.0)
        assert ei.value.reason == "inflight"
        assert ei.value.retry_after_s > 0.0
        assert replica._m_admission_rejects["inflight"] == 1
        release.set()
        t.join(timeout=10.0)
        assert replica.gate.depth == 0
    finally:
        release.set()
        replica.close()


@pytest.mark.parametrize("p", BOTH, ids=lambda p: p.name)
def test_replica_refuses_dead_on_arrival_and_injected_admission(tmp_path, p):
    import urllib.error
    import urllib.request

    replica = p.Replica(_sum_factory, fleet_dir=str(tmp_path))
    try:
        ep = replica.serve(0, port=0)
        req = urllib.request.Request(
            ep.url, data=json.dumps({"x": [1.0]}).encode("utf-8"),
            headers={"Content-Type": "application/json",
                     p.DEADLINE_HEADER: "0"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10.0)
        assert ei.value.code == 429
        assert json.loads(ei.value.read())["reason"] == "expired"
        send = p.http_transport(timeout_s=10.0)
        p.inject.arm("fleet.admit:error:1")
        with pytest.raises(p.AdmissionRejectedError):
            send(ep.url, {"x": [1.0]})
        assert send(ep.url, {"x": [1.0, 2.0]})["outputs"] == {"y": 3.0}
        assert replica.gate.depth == 0
    finally:
        replica.close()


def test_a_429_on_a_large_request_reaches_the_router_as_a_429(tmp_path):
    """A shed request of 64 x 1,000 floats (1.3 MB of JSON, more than the
    socket buffers hold): the port's replica reads the body before its
    429, so the router sees the shed and not a dead replica. (The JAX
    package's handler answers with the body unread, and the connection
    reset that follows loses most such 429s.)"""
    p = PORT
    replica = p.Replica(_sum_factory, fleet_dir=str(tmp_path))
    try:
        ep = replica.serve(0, port=0)
        send = p.http_transport(timeout_s=10.0)
        big = {"x": [[0.123456789] * 1000 for _ in range(64)]}
        for _ in range(10):
            p.inject.arm("fleet.admit:error:1")
            with pytest.raises(p.AdmissionRejectedError):
                send(ep.url, big)
        assert send(ep.url, {"x": [1.0, 2.0]})["outputs"] == {"y": 3.0}
    finally:
        replica.close()


def test_a_reply_cut_after_its_headers_is_a_dead_replica():
    """A replica SIGKILLed while it writes its answer leaves the headers
    and no body: http_transport raises ReplicaDeadError (the router
    redispatches), never http.client.IncompleteRead (a client error)."""
    class Cut(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", "1000")
            self.end_headers()
            self.wfile.write(b'{"rank": 0, "prog')
            self.wfile.flush()
            self.connection.shutdown(2)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Cut)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/score"
        with pytest.raises(PORT.ReplicaDeadError) as ei:
            PORT.http_transport(timeout_s=10.0)(url, {"x": [1.0]})
        assert not ei.value.transient
        router = PORT.Router(_table(PORT, {(0, 0): url, (1, 0): "ok"}),
                             lambda a, r, remaining_s=None: (
                                 PORT.http_transport(10.0)(a, r) if a == url
                                 else {"served_by": a}),
                             registry=PORT.MetricsRegistry())
        assert router.submit({"x": [1.0]})["served_by"] == "ok"
        assert router.table.epoch == 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_fleet_member_waits_for_item_12(tmp_path):
    replica = PORT.Replica(_sum_factory, fleet_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 12"):
        PORT.FleetMember(replica, lambda step: None)
    import systemml_tpu.fleet as jf
    import systemml_tpu_torch.fleet as pf

    assert pf.__all__ == jf.__all__ and "FleetMember" in pf.__all__


# --------------------------------------------------------------------------
# a replica serving the softmax scorer, in both packages
# --------------------------------------------------------------------------

SOFTMAX = ("Z = X %*% W + b\nE = exp(Z - rowMaxs(Z))\n"
           "yhat = E / rowSums(E)")
F, C = 20, 10


def _weights(g):
    rng = np.random.default_rng(100 + g)
    return (rng.standard_normal((F, C)) / math.sqrt(F),
            rng.standard_normal((1, C)))


def _softmax(x, g):
    w, b = _weights(g)
    z = x @ w + b
    e = np.exp(z - z.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


def _service(p, g):
    meta = {"X": {"shape": (None, F)}, "W": {"shape": (F, C)},
            "b": {"shape": (1, C)}}
    names = dict(input_names=["X", "W", "b"], output_names=["yhat"],
                 input_meta=meta)
    w, b = _weights(g)
    if p is PORT:
        from systemml_tpu_torch.api.jmlc import Connection
        from systemml_tpu_torch.api.serving import ScoringService
        from systemml_tpu_torch.utils.config import DMLConfig

        cfg = DMLConfig(device="cpu")
        cfg.optlevel = 3
        ps = Connection(cfg).prepare_script(SOFTMAX, **names)
    else:
        from systemml_tpu.api.jmlc import Connection
        from systemml_tpu.api.serving import ScoringService
        from systemml_tpu.utils.config import DMLConfig, set_config

        jc = DMLConfig()
        jc.exec_mode = "SINGLE_NODE"
        jc.optlevel = 3
        set_config(jc)
        ps = Connection().prepare_script(SOFTMAX, **names)
    svc = ScoringService(ps, constants={"W": w, "b": b}, ladder=(1, 8),
                         validate="force")
    svc.warmup(F)
    return svc


def _scorer_factory(p):
    services = {g: _service(p, g) for g in (0, 1)}

    def factory(g):
        svc = services[g]

        def score(payload):
            y = svc.score(np.asarray(payload["x"], dtype=np.float64))["yhat"]
            return {"yhat": np.asarray(y, dtype=np.float64).tolist()}
        return score
    return factory


def test_replica_answers_equal_the_jax_package_s_scoring_service(tmp_path):
    x = np.random.default_rng(5).standard_normal((40, F))
    requests = [(0, 1), (1, 3), (4, 8), (12, 5), (17, 8), (25, 2)]
    answers = {}
    for p in BOTH:
        os.makedirs(tmp_path / p.name)
        replica = p.Replica(_scorer_factory(p),
                            fleet_dir=str(tmp_path / p.name))
        try:
            for g in (0, 1):
                replica.serve(g, port=0)
            replica.register()
            reg = p.read_registry(str(tmp_path / p.name))
            table = p.RoutingTable()
            table.install({(0, g): reg[0].url(g) for g in (0, 1)})
            router = p.Router(table, p.http_transport(timeout_s=30.0),
                              registry=p.MetricsRegistry())
            got = []
            for i, (r0, n) in enumerate(requests):
                table.set_weight(1, 100 if i % 2 else 0)
                resp = router.submit({"x": x[r0:r0 + n].tolist()},
                                     timeout_s=30.0)
                got.append((resp["rank"], resp["prog_gen"],
                            np.asarray(resp["outputs"]["yhat"])))
            answers[p.name] = got
        finally:
            replica.close()
    for (pr, pg, py), (jr, jg, jy), (r0, n), i in zip(
            answers["systemml_tpu_torch"], answers["systemml_tpu"],
            requests, range(len(requests))):
        assert (pr, pg) == (jr, jg) == (0, i % 2)
        assert py.shape == (n, C)
        assert np.linalg.norm(py - jy) <= 1e-9 * np.linalg.norm(jy)
        ref = _softmax(x[r0:r0 + n], pg)
        other = _softmax(x[r0:r0 + n], 1 - pg)
        assert np.linalg.norm(py - ref) <= 1e-9 * np.linalg.norm(ref)
        assert np.linalg.norm(py - other) > 1e-3 * np.linalg.norm(other)


# --------------------------------------------------------------------------
# three replica processes on the CPU: a SIGKILL and a rolling update
# --------------------------------------------------------------------------

def _logged_router(p):
    """p.Router that logs each pick with the epoch the table had when
    the pick began (read before the targets, so a pick that read a
    bumped epoch read the bumped targets too)."""
    class Logged(p.Router):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.picks = []

        def _pick(self, prog_gen, exclude=()):
            epoch = self.table.epoch
            rank, addr = super()._pick(prog_gen, exclude)
            if rank is not None:
                self.picks.append((epoch, rank))
            return rank, addr
    return Logged


NPROC, CLIENTS, KILL_AFTER = 3, 6, 40
FLEET_LIMIT_S = 240.0

_REPLICA = r'''
import json, os, signal, sys, threading, time
import numpy as np

rank, shared = int(sys.argv[1]), sys.argv[2]
spec = json.load(open(os.path.join(shared, "fleet.json")))
fleet_dir = os.path.join(shared, "fleet")

from systemml_tpu_torch import fleet as fleet_pkg
from systemml_tpu_torch.api.jmlc import Connection
from systemml_tpu_torch.api.serving import ScoringService
from systemml_tpu_torch.obs import fleet as obs_fleet
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.utils.config import DMLConfig, set_config

cfg = DMLConfig(device="cpu")
cfg.optlevel = 3
set_config(cfg)
obs_fleet.set_identity(obs_fleet.derive_run_id(shared, spec["nproc"] + 1),
                       rank, rank, 0, spec["nproc"] + 1)
rec = obs.FlightRecorder()
obs.install(rec)
writer = obs_fleet.attach_shard(rec, fleet_dir)
F, C = spec["features"], spec["classes"]
meta = {"X": {"shape": (None, F)}, "W": {"shape": (F, C)},
        "b": {"shape": (1, C)}}
services = {}


def build(g):
    rng = np.random.default_rng(spec["seed"] + g)
    w = rng.standard_normal((F, C)) / np.sqrt(F)
    b = rng.standard_normal((1, C))
    ps = Connection(cfg).prepare_script(
        spec["src"], input_names=["X", "W", "b"], output_names=["yhat"],
        input_meta=meta)
    svc = ScoringService(ps, constants={"W": w, "b": b},
                         ladder=spec["ladder"], validate="force")
    svc.warmup(F)
    services[g] = svc


answered = [0]
lock = threading.Lock()


def factory(g):
    svc = services[g]

    def score(payload):
        y = svc.score(np.asarray(payload["x"], dtype=np.float64))["yhat"]
        out = {"yhat": y.tolist()}
        if rank == spec["nproc"] - 1:
            with lock:
                answered[0] += 1
                n = answered[0]
            if n == spec["kill_after"]:
                with open(os.path.join(shared, "dying"), "w") as f:
                    f.write(str(time.time_ns()))
                os.kill(os.getpid(), signal.SIGKILL)
        return out
    return score


build(0)
replica = fleet_pkg.Replica(factory, fleet_dir=fleet_dir)
replica.serve(0, port=0)
replica.register(0)
replica.start_heartbeat(spec["heartbeat_s"])


def marker(name):
    return os.path.exists(os.path.join(shared, name))


served_g1 = retired = False
while not marker("phase_done"):
    if not served_g1 and marker("rollout_go"):
        build(1)
        replica.serve(1, port=0)
        replica.heartbeat()
        open(os.path.join(shared, f"g1_ready_{rank}"), "w").close()
        served_g1 = True
    if not retired and marker("retire_g0"):
        replica.retire_generation(0)
        open(os.path.join(shared, f"retired_{rank}"), "w").close()
        retired = True
    time.sleep(0.02)
replica.close()
writer.close()
obs_fleet.write_metrics_snapshot(fleet_dir, services[0]._ps.stats, extra={
    "served": {str(g): s.registry.get("requests_total").value
               for g, s in services.items()}})
print("REPLICA_OK", rank, flush=True)
'''


def test_three_replica_processes_survive_a_sigkill_and_a_rolling_update(
        tmp_path):
    p = PORT
    shared = str(tmp_path)
    fleet_dir = os.path.join(shared, "fleet")
    os.makedirs(fleet_dir)
    spec = {"nproc": NPROC, "features": F,
            "classes": C, "seed": 200, "src": SOFTMAX, "ladder": [1, 8],
            "kill_after": KILL_AFTER, "heartbeat_s": 0.2}
    with open(os.path.join(shared, "fleet.json"), "w") as f:
        json.dump(spec, f)
    victim = NPROC - 1
    x = np.random.default_rng(7).standard_normal((200, F))
    weights = {}
    for g in (0, 1):
        rng = np.random.default_rng(spec["seed"] + g)
        weights[g] = (rng.standard_normal((F, C)) / np.sqrt(F),
                      rng.standard_normal((1, C)))

    def softmax(rows, g):
        z = rows @ weights[g][0] + weights[g][1]
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    env = dict(os.environ, PYTHONPATH=REPO)
    procs, logs = [], []
    t_limit = time.monotonic() + FLEET_LIMIT_S

    def left():
        if time.monotonic() >= t_limit:
            tails = "".join(
                f"\n--- replica {r}:\n" + open(os.path.join(
                    shared, f"replica_{r}.log")).read()[-1500:]
                for r in range(len(procs)))
            raise AssertionError("the fleet ran past its limit" + tails)
        return t_limit - time.monotonic()

    run_id = p.obs_fleet.derive_run_id(shared, NPROC + 1)
    p.obs_fleet.set_identity(run_id, NPROC, NPROC, 0, NPROC + 1)
    rec = p.T.FlightRecorder()
    prev = p.T.install(rec)
    writer = p.obs_fleet.attach_shard(rec, fleet_dir)
    stop = threading.Event()
    clients = []
    try:
        for r in range(NPROC):
            logs.append(open(os.path.join(shared, f"replica_{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _REPLICA, str(r), shared], env=env,
                cwd=REPO, stdout=logs[-1], stderr=subprocess.STDOUT))
        while len(p.read_registry(fleet_dir, note_clocks=False)) < NPROC:
            assert all(pr.poll() is None for pr in procs), "a replica died"
            left()
            time.sleep(0.05)
        # one host: the lanes share a clock, and a registry row's age is
        # no clock probe (it would shift the router's lane by up to a
        # heartbeat)
        reg = p.read_registry(fleet_dir, note_clocks=False)
        table = p.RoutingTable()
        table.install({(q, 0): info.url(0) for q, info in reg.items()})
        router = _logged_router(p)(
            table, p.http_transport(timeout_s=60.0),
                          straggler_report=lambda: {"slowest_rank": 1},
                          hedge_floor_s=0.010, hedge_min_samples=8)
        lock = threading.Lock()
        counts, failures, worst = {}, [], [0.0, math.inf]

        def client(c):
            rng = np.random.default_rng(1000 + c)
            while not stop.is_set():
                n = int(np.exp(rng.uniform(0.0, math.log(8))))
                r0 = int(rng.integers(0, len(x) - n + 1))
                try:
                    resp = router.submit({"x": x[r0:r0 + n].tolist()},
                                         timeout_s=60.0)
                    g, rank = resp["prog_gen"], resp["rank"]
                    y = np.asarray(resp["outputs"]["yhat"])
                    ref, other = softmax(x[r0:r0 + n], g), \
                        softmax(x[r0:r0 + n], 1 - g)
                    err = np.linalg.norm(y - ref) / np.linalg.norm(ref)
                    gap = np.linalg.norm(y - other) / np.linalg.norm(other)
                    with lock:
                        counts[g] = counts.get(g, 0) + 1
                        worst[0] = max(worst[0], err)
                        worst[1] = min(worst[1], gap)
                        assert rank in range(NPROC)
                except Exception as e:  # asserted empty below
                    with lock:
                        failures.append(repr(e))

        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(CLIENTS)]
        for t in clients:
            t.start()
        # the victim dies mid-stream; the router's dispatches to it fail
        # and one epoch bump takes it out of the table
        while victim in table.live_ranks():
            assert not failures, failures[:3]
            left()
            time.sleep(0.05)
        assert procs[victim].wait(timeout=left()) == -signal.SIGKILL
        # the rolling update g0 -> g1, under the same load
        open(os.path.join(shared, "rollout_go"), "w").close()
        survivors = [q for q in range(NPROC) if q != victim]
        while not all(os.path.exists(os.path.join(shared, f"g1_ready_{q}"))
                      for q in survivors):
            left()
            time.sleep(0.05)
        for q, info in p.read_registry(fleet_dir,
                                       note_clocks=False).items():
            if q in survivors and info.url(1):
                table.add(q, 1, info.url(1))

        def retire(from_gen):
            open(os.path.join(shared, "retire_g0"), "w").close()
            while not all(os.path.exists(os.path.join(shared,
                                                      f"retired_{q}"))
                          for q in survivors):
                left()
                time.sleep(0.02)

        p.RollingUpdate(router, 0, 1).run(retire=retire,
                                          drain_timeout_s=left())
        time.sleep(0.3)
        stop.set()
        for t in clients:
            t.join(timeout=left())
        open(os.path.join(shared, "phase_done"), "w").close()
        for q in survivors:
            assert procs[q].wait(timeout=left()) == 0
    finally:
        stop.set()
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait(timeout=30)
        for log in logs:
            log.close()
        writer.close()
        p.T.install(prev)
        p.obs_fleet.clear_identity()

    logs = {r: open(os.path.join(shared, f"replica_{r}.log")).read()
            for r in range(NPROC)}
    assert not failures, failures[:3]
    assert counts.get(0, 0) > 0 and counts.get(1, 0) > 0, counts
    assert worst[0] <= 1e-9 and worst[1] > 1e-3, worst
    # no pick of the dead replica once the table read the bumped epoch
    assert (1, victim) not in {(min(e, 1), r) for e, r in router.picks}
    assert _count(router, "fleet_failed_requests_total") == 0
    assert router.redispatch_count >= 1
    bumps = [e.args for e in rec.events() if e.name == "fleet_route_epoch"]
    assert bumps == [{"epoch": 1, "dead": [victim], "reason": "transport"}]
    assert table.generations() == [1]
    for q in survivors:
        assert f"REPLICA_OK {q}" in logs[q], logs[q][-2000:]
    # the merged shards: the rollout from g0 to g1 and the epoch bump
    merged = p.obs_fleet.merge_dir(fleet_dir)
    assert sorted(merged.shards) == [0, 1, 2, 3]
    rollout = [s["name"] for s in p.obs_fleet.rollout_storyline(merged)]
    # each survivor loads g1 before the router's update starts; the
    # update's retirement waits for both replicas to retire g0
    assert rollout[:2] == ["rollout_load"] * 2
    assert rollout[2] == "rollout_start" and rollout[-1] == "rollout_done"
    assert rollout.count("rollout_shift") == 4
    assert rollout.count("rollout_retire") == 2
    story = p.obs_fleet.failover_storyline(merged)
    assert [s["name"] for s in story] == ["fleet_route_epoch"]
    roll = p.obs_fleet.rollup_metrics(
        p.obs_fleet.load_metrics_snapshots(fleet_dir))
    assert sorted(roll["ranks"]) == survivors and roll["run_id"] == run_id
    assert merged.run_id == run_id
    r = subprocess.run([sys.executable, "-m",
                        "systemml_tpu_torch.obs.fleet_trace", fleet_dir],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "Failover storyline (1 events)" in r.stdout
    assert "Rollout storyline" in r.stdout and "g0→g1" in r.stdout
