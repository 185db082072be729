# Port of systemml_tpu/fleet/rollout.py: the same code, with its imports
# pointed at systemml_tpu_torch.
"""Rolling generation updates: serve g and g+1 side by side, shift
traffic by weight, retire g once its in-flight drains.

The update never stops the fleet: every replica loads program
generation g+1 on the port its caller passes (``Replica.serve(g + 1,
port=...)``; 0 takes an ephemeral one), the routing table's traffic
split walks a weight schedule (deterministic ``seq % 100`` split, so
the shift is exactly reproducible), and generation g retires only
after the router observes zero in-flight requests against it.

Rework is BOUNDED: the only requests that can run twice are the ones
in flight against g at the moment of a shift that then redispatch —
never the queued backlog, never g+1 traffic. ``drain_rollout``
measures the bound (redispatch delta vs. entry in-flight) and stamps
it into the ``rollout_drain`` event the fleet_rollout storyline lane
renders (``python -m systemml_tpu_torch.obs.fleet_trace``).

Every stage emits CAT_RESIL rollout events (rollout_start / load /
shift / drain / retire / done) and the weight-shift site is an
injection point (``fleet.rollout``, resil/inject.py): a transient
fault during a shift retries the SAME idempotent weight write; a
fatal one aborts the update with both generations still serving —
an aborted rollout is a stalled split, never an outage.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

from systemml_tpu_torch.resil import faults, inject


class RollingUpdate:
    """Drives one g → g+1 traffic shift over a ``Router``'s table.

    The caller has already started generation ``to_gen`` endpoints on
    every replica and installed their targets in the routing table at
    weight 0 — this class only moves TRAFFIC, the one resource whose
    movement must be observable, bounded and reversible."""

    def __init__(self, router, from_gen: int, to_gen: int,
                 weights: Sequence[int] = (25, 50, 75, 100)):
        self.router = router
        self.table = router.table
        self.from_gen = int(from_gen)
        self.to_gen = int(to_gen)
        self.weights = tuple(int(w) for w in weights)
        self._lock = threading.Lock()
        self.reworked = 0
        self.shift_attempts = 0

    def run(self, retire: Optional[Callable[[int], None]] = None,
            drain_timeout_s: float = 30.0,
            poll_s: float = 0.01) -> None:
        """The whole update: shift through the weight schedule, drain
        the old generation's in-flight, retire it. ``retire(from_gen)``
        is the replica-side callback (close g's endpoints —
        ``Replica.retire_generation`` emits ``rollout_retire``)."""
        faults.emit("rollout_start", from_gen=self.from_gen,
                    to_gen=self.to_gen, targets=list(self.weights))
        for w in self.weights:
            self.shift_rollout_weight(w)
        self.drain_rollout(timeout_s=drain_timeout_s, poll_s=poll_s)
        if retire is not None:
            retire(self.from_gen)
        self.table.discard_generation(self.from_gen)
        with self._lock:
            reworked, attempts = self.reworked, self.shift_attempts
        faults.emit("rollout_done", from_gen=self.from_gen,
                    to_gen=self.to_gen, reworked=reworked,
                    attempts=attempts)

    def shift_rollout_weight(self, weight: int) -> None:
        """Move the split: route ``weight`` percent of new requests to
        ``to_gen``. The write is idempotent, so the injection site can
        retry a transient fault by simply re-running the SAME shift;
        a fatal fault aborts with the split wherever it last landed
        (both generations still serve — no outage)."""
        for attempt in range(1, 9):
            with self._lock:
                self.shift_attempts += 1
            try:
                inject.check("fleet.rollout")
            except Exception as e:  # except-ok: transient faults retry the idempotent shift; fatal ones re-raise below
                kind = faults.classify(e)
                if kind not in faults.TRANSIENT:
                    raise
                faults.emit_fault("fleet.rollout", kind, e)
                continue
            self.table.set_weight(self.to_gen, int(weight))
            faults.emit("rollout_shift", from_gen=self.from_gen,
                        to_gen=self.to_gen, weight=int(weight),
                        attempt=attempt)
            return
        raise RuntimeError(
            f"rollout weight shift to {int(weight)}% did not survive "
            f"8 attempts (persistent transient faults at fleet.rollout)")

    def drain_rollout(self, timeout_s: float = 30.0,
                      poll_s: float = 0.01) -> int:
        """Wait for the old generation's in-flight to reach zero and
        measure the rework bound: redispatches that happened during the
        drain are exactly the requests that can have run twice. Returns
        the entry in-flight count (the bound itself)."""
        entry_inflight = self.router.inflight_for_gen(self.from_gen)
        entry_redispatch = self.router.redispatch_count
        deadline = time.monotonic() + float(timeout_s)
        while self.router.inflight_for_gen(self.from_gen) > 0:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"generation {self.from_gen} still has "
                    f"{self.router.inflight_for_gen(self.from_gen)} "
                    f"request(s) in flight after {timeout_s:.1f}s drain")
            time.sleep(poll_s)
        reworked = self.router.redispatch_count - entry_redispatch
        with self._lock:
            self.reworked += reworked
        faults.emit("rollout_drain", from_gen=self.from_gen,
                    to_gen=self.to_gen, in_flight=entry_inflight,
                    reworked=reworked)
        return entry_inflight
