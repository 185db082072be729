# Port of systemml_tpu/fleet/__init__.py: the same exports, over the port's
# modules; FleetMember is the stub that raises, naming item 12.
"""Fleet serving subsystem: replicated scoring with failover routing
and rolling generation updates.

Four pieces:

- ``fleet.admission`` — overload protection: the per-replica
  admission gate (429 + Retry-After before scoring), the retry/hedge
  token budget refilled by successes, and the per-replica circuit
  breakers with half-open probes.
- ``fleet.replica`` — one scoring process's seat in the fleet:
  per-generation HTTP endpoints around a scorer factory, liveness
  registration under the fleet identity of ``obs/fleet.py``, and the
  pause gate. ``FleetMember``, which reforms a shared device mesh
  around a death, waits for ROADMAP queue 1, item 12.
- ``fleet.router`` — the client seat: epoch-versioned routing table,
  least-outstanding balancing, straggler-aware hedged requests (hedge
  target from the ``obs/fleet.py`` straggler report, delay from the
  measured latency quantile), and failover-as-epoch-bump redispatch.
- ``fleet.rollout`` — rolling g → g+1 updates with a deterministic
  traffic split, drained retirement and a measured rework bound.

The invariant the subsystem exists for: a replica death or a program
update is OBSERVABLE (CAT_RESIL/CAT_FLEET events, fleet_rollout
storyline lane) and NEVER a client error — requests re-home, they do
not fail.
"""

from systemml_tpu_torch.fleet.admission import (DEADLINE_HEADER,
                                                AdmissionGate,
                                                AdmissionRejectedError,
                                                CircuitBreaker,
                                                QueueFullError,
                                                RetryBudget)
from systemml_tpu_torch.fleet.replica import (FleetMember, Replica,
                                              ReplicaEndpoint, ReplicaInfo,
                                              ReplicaUnavailableError,
                                              read_registry, registry_path)
from systemml_tpu_torch.fleet.rollout import RollingUpdate
from systemml_tpu_torch.fleet.router import (NoLiveReplicasError,
                                             ReplicaDeadError,
                                             ReplicaRequestError,
                                             RequestTimeoutError, Router,
                                             RoutingTable, http_transport)

__all__ = [
    "AdmissionGate", "AdmissionRejectedError", "CircuitBreaker",
    "DEADLINE_HEADER", "QueueFullError", "RetryBudget",
    "FleetMember", "Replica", "ReplicaEndpoint", "ReplicaInfo",
    "ReplicaUnavailableError", "read_registry", "registry_path",
    "RollingUpdate", "NoLiveReplicasError", "ReplicaDeadError",
    "ReplicaRequestError", "RequestTimeoutError", "Router",
    "RoutingTable", "http_transport",
]
