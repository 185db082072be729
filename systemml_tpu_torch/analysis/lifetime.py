"""Buffer-lifetime classification of a loop region's carried names.

Port of `classify_region_carried` (systemml_tpu/analysis/lifetime.py:
134-143), the one part of that module the region planner
(compiler/lower.plan_loop_regions) reads; the donation sites, verdicts
and sanitizer around it wait with the buffer pool.
"""

from __future__ import annotations

from typing import Dict, Sequence, Set


def classify_region_carried(carried: Sequence[str],
                            live_after: Set[str]) -> Dict[str, str]:
    """The liveness half of a LoopRegion's donation plan: carried names
    not read after the loop are "dead" (their buffers can always alias
    into the loop output once the runtime alias check clears); "live"
    names outlive the region and key the caller-visible result. The
    SINGLE home of this classification — compiler/lower.py consumes it
    when planning regions."""
    return {n: ("live" if n in live_after else "dead") for n in carried}
