# Copy of systemml_tpu/resil/__init__.py for the PyTorch port,
# with its imports pointed at systemml_tpu_torch.
"""Resilience subsystem: fault taxonomy, retry policy, fault injection.

The reference gets task-level fault tolerance for free from Spark
(executors retry failed parfor tasks, RemoteParForSpark.runJob survives
worker loss); a TPU-native runtime has to build it: preemption and HBM
exhaustion are the *normal* failure modes on TPU pods (see
runtime/checkpoint.py), and a long-running declarative runtime must
recover mid-program, not restart.

- ``resil.faults``  — the taxonomy: classify exceptions into transient
  (OOM, worker death, deadline expiry, preemption) vs fatal
  (DML/validation/programming errors), plus the CAT_RESIL event
  emitters every recovery decision reports through.
- ``resil.policy``  — retry engine: exponential backoff with
  deterministic jitter, per-site attempt budgets from utils/config.
- ``resil.inject``  — deterministic fault-injection registry: named
  sites (parfor.task, remote.job, dispatch.fused, bufferpool.admit,
  checkpoint.save) armed via config ``fault_injection`` or
  ``SMTPU_FAULT=site:kind:nth``, so every recovery path is testable on
  CPU.

Supervised-execution wiring lives at the sites themselves:
runtime/parfor.py (local task retry with device exclusion),
runtime/remote.py (job deadlines, worker retirement + requeue),
runtime/program.py (fused-dispatch OOM degradation chain),
runtime/bufferpool.py (admit-time spill recovery), and
runtime/loopfuse.py (taxonomy-routed fusion fallbacks).
"""

from systemml_tpu_torch.resil.faults import (  # noqa: F401
    DEADLINE, FATAL, OOM, PREEMPT, TRANSIENT, WORKER,
    DeadlineExpired, FaultError, InjectedKill, InjectedResourceExhausted,
    RemoteJobError, WorkerDiedError, classify, classify_reply, emit,
    emit_fault, fallback_allowed, is_transient,
)
from systemml_tpu_torch.resil.policy import (  # noqa: F401
    RetryPolicy, policy_from_config, run_with_retry,
)
from systemml_tpu_torch.resil import inject  # noqa: F401
