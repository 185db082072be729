# Copy of systemml_tpu/resil/policy.py for the PyTorch port,
# with its imports pointed at systemml_tpu_torch.
"""Retry policy engine: exponential backoff + deterministic jitter.

Reference analog: Spark's task retry budget (spark.task.maxFailures)
with the scheduler's backoff; here the policy is per-site and comes
from utils/config (resil_* knobs) so tests can shrink the waits to
microseconds and production can widen them per deployment.

Jitter is DETERMINISTIC (hash of site+attempt, not a PRNG): the same
failure sequence always waits the same total time, so fault-injection
tests are reproducible and paired A/B benches stay comparable — while
different sites still decorrelate their retry storms.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional

from systemml_tpu_torch.resil import faults


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.5  # fraction of the raw backoff, in [-j, +j]

    def backoff_s(self, site: str, attempt: int) -> float:
        """Wait before attempt `attempt + 1` (attempts count from 1)."""
        raw = min(self.backoff_base_s * (2 ** (attempt - 1)),
                  self.backoff_max_s)
        if not self.jitter:
            return raw
        h = int(hashlib.md5(f"{site}:{attempt}".encode()).hexdigest()[:8],
                16)
        frac = (h / 0xFFFFFFFF) * 2.0 - 1.0  # [-1, 1], site-stable
        return max(0.0, raw * (1.0 + self.jitter * frac))


def policy_from_config(cfg=None) -> RetryPolicy:
    from systemml_tpu_torch.utils.config import get_config

    cfg = cfg or get_config()
    return RetryPolicy(
        max_attempts=max(1, int(cfg.resil_max_attempts)),
        backoff_base_s=float(cfg.resil_backoff_base_s),
        backoff_max_s=float(cfg.resil_backoff_max_s),
        jitter=float(cfg.resil_backoff_jitter))


def run_with_retry(site: str, fn: Callable[[int], object],
                   policy: Optional[RetryPolicy] = None, *,
                   enabled: bool = True,
                   on_transient: Optional[Callable] = None):
    """Supervised execution of `fn(attempt)`: transient-classified
    failures retry with backoff up to the policy's attempt budget;
    fatal ones (and budget exhaustion) re-raise. `on_transient(exc,
    kind, attempt)` runs before each retry — sites use it to exclude a
    failing device, retire a dead worker, or discard partial results
    (exactly-once: the next attempt must start from a clean slate)."""
    pol = policy or policy_from_config()
    attempt = 1
    while True:
        try:
            return fn(attempt)
        except Exception as e:
            kind = faults.classify(e)
            if (not enabled or kind == faults.FATAL
                    or attempt >= pol.max_attempts):
                raise
            faults.emit_fault(site, kind, e)
            if on_transient is not None:
                on_transient(e, kind, attempt)
            delay = pol.backoff_s(site, attempt)
            faults.emit("retry", site=site, attempt=attempt,
                        backoff_ms=round(delay * 1e3, 3))
            if delay > 0:
                time.sleep(delay)
            attempt += 1
