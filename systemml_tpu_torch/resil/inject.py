# Copy of systemml_tpu/resil/inject.py for the PyTorch port,
# with its imports pointed at systemml_tpu_torch.
"""Deterministic fault-injection registry.

Every recovery path must be testable on CPU — preemption and OOM are
the normal failure modes on TPU pods, and a recovery path that only
runs when real hardware fails is a recovery path that has never run.
Named sites call ``check()``/``fire()`` at the exact point a real
fault would surface; armed injections synthesize the fault on the
n-th arrival.

Sites (see docs/resilience.md for the full reference):

- ``parfor.task``       — start of one local parfor task attempt
- ``parfor.chunk``      — per completed chunk inside a LONG task group
- ``remote.job``        — coordinator, just before shipping a job
- ``dispatch.fused``    — fused-block XLA dispatch (program.py)
- ``bufferpool.admit``  — pool rebalance during symbol-table admit
- ``checkpoint.save``   — between snapshot data write and pointer commit
- ``collective.allreduce`` — sharded collective dispatch (elastic/)
- ``checkpoint.snapshot``  — elastic sharded-snapshot staging commit
- ``mesh.rebuild``         — mesh-shrink rebuild over surviving devices

Kinds: ``oom`` (RESOURCE_EXHAUSTED, transient), ``error`` (NameError,
fatal), ``worker``/``deadline``/``preempt`` (transient), ``kill``
(remote.job: SIGKILL the worker; checkpoint.save: simulated
mid-save process death), ``hang`` (remote.job only: SIGSTOP the
worker so the deadline reader trips).

Arming, two channels that compose:

- ``SMTPU_FAULT=site:kind[:nth[:count]][,...]`` environment variable —
  process-global, re-read on every check so tests can monkeypatch it;
- config ``fault_injection`` (same syntax) — applied by
  ``Program.execute`` at run entry via ``arm()``, which RESETS the
  counters, so every execution of a prepared script sees the same
  deterministic schedule. Unit tests that never go through
  Program.execute call ``arm()``/``reset()`` directly.

``nth``/``count`` semantics: the injection fires on arrivals
``nth .. nth+count-1`` at that site (both default 1). Disarmed checks
cost a module-flag test plus one environ lookup.

Registered sites carry a DEFAULT fault kind (the failure mode that
site exists to model), enabling the short ``site:N`` spec — fire the
default kind on the Nth arrival (``-fault collective.allreduce:3``).
The shorthand only resolves for registered sites; a numeric kind on
an unknown site is an error naming the registry.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from systemml_tpu_torch.resil import faults

_lock = threading.Lock()

# site registry: every named injection point in the runtime, with the
# default fault kind the `site:N` shorthand arms (docs/resilience.md
# keeps the user-facing table in sync — tests assert the two agree)
SITES = {
    "parfor.task": "oom",
    "parfor.chunk": "worker",
    "remote.job": "kill",
    "dispatch.fused": "oom",
    "bufferpool.admit": "oom",
    "checkpoint.save": "kill",
    "collective.allreduce": "preempt",
    "checkpoint.snapshot": "error",
    "mesh.rebuild": "preempt",
    # survivor re-initialization: fires at the top of
    # multihost.reinit_distributed (a reform can itself be preempted;
    # recovery falls back to the local-domain shrink)
    "multihost.reinit": "preempt",
    # mesh re-form decision point in ElasticRunner._recover, before the
    # survivors tear down the old job
    "mesh.reform": "preempt",
    # reattach-on-demand: lockstep re-join of the CURRENT membership
    # while detached (multihost.reattach_coordination) — a transient
    # here makes the runner skip ONE step boundary and retry at the
    # next, never kill the job
    "multihost.reattach": "preempt",
    # lockstep fused-region reform decision point: a region dispatch
    # failure NAMING dead peers re-forms the shared survivor mesh and
    # re-traces on it (loopfuse._region_device_loss ->
    # recover.reform_shared_mesh); an injected loss here falls back to
    # the local-domain shrink
    "region.reform": "preempt",
    # fused-region dispatch (runtime/loopfuse): a DEVICE_LOSS here
    # triggers shrink + re-trace instead of the eager fallback
    "dispatch.region": "preempt",
    # between-chunk window of a chunked fused region: the intra-region
    # checkpoint just committed; a loss here must resume from it
    "region.chunk_ckpt": "preempt",
    # deliberate hazard seeder, not a fault: an armed injection makes
    # the fused-loop donation planner SKIP its must-copy-first
    # protective copies (runtime/loopfuse._donation_plan), seeding a
    # real use-after-donate for the donation sanitizer to catch
    # (analysis/sanitizer.py; tests/test_analysis.py)
    "analysis.donation_copy": "skip",
    # serving-fleet router dispatch (fleet/router.py): fires as a
    # request is handed to the picked replica — an injected worker
    # death makes the router quarantine that replica, bump the routing
    # epoch and redispatch; the client never sees a failure
    "fleet.route": "worker",
    # hedge launch point: a transient here abandons ONE hedge (the
    # primary dispatch still serves the request) — hedging is an
    # optimization, never a correctness dependency
    "fleet.hedge": "deadline",
    # rolling-update weight-shift commit (fleet/rollout.py): a
    # transient preemption retries the SAME shift step; the weight
    # schedule is idempotent so rework stays bounded
    "fleet.rollout": "preempt",
    # replica admission decision (fleet/admission.AdmissionGate via
    # replica._ScoreHandler): an injected error here forces a 429 shed
    # for the probed request — exercises the client's Retry-After
    # backoff and the router's budget-gated re-route without real
    # overload
    "fleet.admit": "error",
    # router retry-budget spend point (fleet/router.py): an injected
    # error empties the check, forcing the brownout fail-fast path
    # (redispatch degrades to AdmissionRejectedError at the caller,
    # hedges are skipped) — proves budget exhaustion is survivable
    "router.budget": "error",
}


class _Injection:
    __slots__ = ("site", "kind", "nth", "count", "calls")

    def __init__(self, site: str, kind: str, nth: int = 1, count: int = 1):
        self.site = site
        self.kind = kind
        self.nth = max(1, nth)
        self.count = max(1, count)
        self.calls = 0

    def __repr__(self):
        return (f"<_Injection {self.site}:{self.kind}:{self.nth}"
                f":{self.count} calls={self.calls}>")


def _parse(spec: str) -> List[_Injection]:
    out: List[_Injection] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 2:
            raise ValueError(
                f"bad fault-injection spec {part!r} "
                f"(want site:kind[:nth[:count]] or site:N)")
        site, kind = bits[0], bits[1]
        if kind.isdigit():
            # `site:N` shorthand: the registered default kind, Nth hit
            if site not in SITES:
                raise ValueError(
                    f"fault spec {part!r}: the site:N shorthand needs a "
                    f"registered site with a default kind; known sites: "
                    f"{', '.join(sorted(SITES))}")
            out.append(_Injection(site, SITES[site], int(kind),
                                  int(bits[2]) if len(bits) > 2 else 1))
            continue
        nth = int(bits[2]) if len(bits) > 2 else 1
        count = int(bits[3]) if len(bits) > 3 else 1
        out.append(_Injection(site, kind, nth, count))
    return out


_env_spec: str = ""
_env_armed: List[_Injection] = []
_cfg_armed: List[_Injection] = []


def arm(spec: str) -> None:
    """(Re)arm the config channel; resets its counters. Called by
    Program.execute with ``cfg.fault_injection`` at every run entry."""
    global _cfg_armed
    with _lock:
        _cfg_armed = _parse(spec)


def reset() -> None:
    """Disarm everything (both channels' parsed state; the env var
    itself is the caller's to clear)."""
    global _cfg_armed, _env_armed, _env_spec
    with _lock:
        _cfg_armed = []
        _env_armed = []
        _env_spec = ""


def _sync_env_locked() -> None:
    global _env_spec, _env_armed
    spec = os.environ.get("SMTPU_FAULT", "")
    if spec != _env_spec:
        _env_spec = spec
        _env_armed = _parse(spec)


def fire(site: str) -> Optional[str]:
    """Count one arrival at `site`; return the armed kind when this
    arrival is scheduled to fail, else None. Sites with special fault
    mechanics (remote.job kill/hang) branch on the returned kind;
    everything else uses check()."""
    if not _cfg_armed and not _env_armed \
            and not os.environ.get("SMTPU_FAULT"):
        return None
    with _lock:
        _sync_env_locked()
        for inj in _env_armed + _cfg_armed:
            if inj.site != site:
                continue
            inj.calls += 1
            if inj.nth <= inj.calls < inj.nth + inj.count:
                faults.emit("fault_injected", site=site, kind=inj.kind,
                            n=inj.calls)
                return inj.kind
    return None


def check(site: str) -> None:
    """fire() + raise the synthesized exception for the armed kind."""
    kind = fire(site)
    if kind is not None:
        raise_kind(site, kind)


def raise_kind(site: str, kind: str) -> None:
    if kind == "oom":
        raise faults.InjectedResourceExhausted(
            f"RESOURCE_EXHAUSTED: injected out of memory at {site}")
    if kind == "error":
        raise NameError(f"injected fatal fault at {site}")
    if kind == "worker":
        raise faults.WorkerDiedError(f"injected worker death at {site}")
    if kind == "deadline":
        raise faults.DeadlineExpired(f"injected deadline expiry at {site}")
    if kind == "preempt":
        raise faults.RemoteJobError(
            faults.PREEMPT, f"injected preemption at {site}")
    if kind == "kill":
        raise faults.InjectedKill(f"injected SIGKILL at {site}")
    raise ValueError(f"fault kind {kind!r} is not raiseable at {site} "
                     f"(site-specific kinds like 'hang' need fire())")
