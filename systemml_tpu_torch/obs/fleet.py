# Port of systemml_tpu/obs/fleet.py: FleetIdentity, identity() and
# clear_identity() (lines 160-233) are copied, for obs/export.chrome_trace
# to stamp. The rest of the module (run ids, per-rank trace shards, the
# fleet merge, storylines, metrics rollups) waits for ROADMAP queue 1,
# item 13 (fleet): those names raise NotImplementedError saying so.
"""Fleet observability: the run/rank identity of this process.

Every process of a multi-process run carries a ``FleetIdentity``: a
stable ``run_id``, its ORIGINAL first-join rank, its CURRENT rank, the
reform generation and the job size. A single-process export from a fleet
member stays attributable after the fact (``export.chrome_trace`` stamps
it). Nothing in the port sets an identity yet: the fleet (item 13) does.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class FleetIdentity:
    """Who this process is within the run: stable ``run_id`` (identical
    on every rank), ORIGINAL first-join rank (stable across reforms —
    the lane identity), CURRENT rank (renumbered by reforms), reform
    ``generation`` and current job size."""

    __slots__ = ("run_id", "orig_rank", "rank", "generation", "nproc")

    def __init__(self, run_id: str, orig_rank: int, rank: int,
                 generation: int = 0, nproc: int = 1):
        self.run_id = str(run_id)
        self.orig_rank = int(orig_rank)
        self.rank = int(rank)
        self.generation = int(generation)
        self.nproc = int(nproc)

    def to_dict(self) -> Dict[str, Any]:
        return {"run_id": self.run_id, "orig_rank": self.orig_rank,
                "rank": self.rank, "generation": self.generation,
                "nproc": self.nproc}

    def __repr__(self):
        return (f"<FleetIdentity run={self.run_id} orig={self.orig_rank} "
                f"rank={self.rank} gen={self.generation}>")


_identity: Optional[FleetIdentity] = None
_identity_lock = threading.Lock()


def identity() -> Optional[FleetIdentity]:
    return _identity


def clear_identity() -> None:
    """Test hook: drop the process identity."""
    global _identity
    with _identity_lock:
        _identity = None


# the rest of systemml_tpu/obs/fleet.py, which the fleet brings
_WAITING = frozenset({
    "derive_run_id", "set_identity", "identity_labels", "FleetShardWriter",
    "shard_path", "attach_shard", "handshake_payload", "note_peer_ready",
    "note_step", "Shard", "FleetTrace", "estimate_offsets", "merge_dir",
    "chrome_fleet_trace", "failover_storyline", "rollout_storyline",
    "render_rollout_storyline", "storyline_generations", "render_storyline",
    "overload_summary", "render_overload_summary", "fleet_report",
    "render_fleet_report", "write_metrics_snapshot",
    "load_metrics_snapshots", "rollup_metrics", "render_fleet_stats"})


def __getattr__(name: str):
    if name in _WAITING:
        raise NotImplementedError(
            f"obs.fleet.{name} waits for ROADMAP queue 1, fleet (item 13)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
