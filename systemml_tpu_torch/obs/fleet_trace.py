# Port of scripts/fleet_trace.py as a module of the package: the same
# argument parsing, sections and JSON object, over the port's obs/fleet.
"""Merge per-rank fleet trace shards into one timeline.

Each process of a fleet streams its flight-recorder events into
``<obs_fleet_dir>/shard_r<orig>.jsonl`` (obs/fleet.attach_shard).
This command merges them into ONE clock-aligned Chrome/Perfetto trace
with one lane per ORIGINAL rank (lanes survive reform renumbering),
a synthetic "failover storyline" lane carrying the causally-ordered
CAT_RESIL chain (a serving router's ``fleet_route_epoch`` among it), a
``fleet_rollout`` lane narrating rolling g→g+1 serving updates
(rollout_start -> rollout_load -> rollout_shift -> rollout_drain ->
rollout_retire -> rollout_done), the overload summary (every shed and
refusal by named reason), and prints the straggler report: slowest rank
per step window, fleet wall split compute / exposed-DCN /
straggler-wait.

Timestamp alignment uses the clock-offset estimates piggybacked on the
liveness handshake or the replica registry scan (bidirectional
``clock_probe`` samples, NTP-style); shards from ranks that died
mid-write (SIGKILL) are tolerated — at most one torn tail line per
shard, counted in the output.

Usage:
    python -m systemml_tpu_torch.obs.fleet_trace <fleet_dir>
        [--out merged.json] [--window N] [--json]

``--json`` prints the machine-readable object ({storyline, rollout,
overload, report, ranks, clock_offsets_ns, torn_lines}) instead of the
text views.
"""

from __future__ import annotations

import argparse
import json
import sys

from systemml_tpu_torch.obs import fleet


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fleet_dir", help="directory holding "
                                      "shard_r*.jsonl trace shards")
    ap.add_argument("--out", metavar="FILE",
                    help="write the merged Chrome/Perfetto trace JSON")
    ap.add_argument("--window", type=int, default=5,
                    help="straggler-report step-window size (default 5)")
    ap.add_argument("--json", dest="json_out", action="store_true",
                    help="print the machine-readable merge object")
    ns = ap.parse_args(argv)
    try:
        merged = fleet.merge_dir(ns.fleet_dir)
    except (OSError, ValueError) as e:
        print(f"fleet_trace: {e}", file=sys.stderr)
        return 1
    story = fleet.failover_storyline(merged)
    rollout = fleet.rollout_storyline(merged)
    overload = fleet.overload_summary(merged)
    report = fleet.fleet_report(merged, window=ns.window)
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump(fleet.chrome_fleet_trace(merged), f)
    if ns.json_out:
        print(json.dumps({
            "run_id": merged.run_id,
            "ranks": sorted(merged.shards),
            "generations": fleet.storyline_generations(story),
            "events": len(merged.events),
            "clock_offsets_ns": merged.offsets,
            "torn_lines": merged.torn_lines,
            "stale_shards": merged.stale_shards,
            "unreadable_shards": merged.unreadable_shards,
            "storyline": story,
            "rollout": rollout,
            "overload": overload,
            "report": report,
        }))
    else:
        print(f"fleet_trace: run {merged.run_id}, "
              f"{len(merged.shards)} rank shard(s), "
              f"{len(merged.events)} events"
              + (f", {merged.torn_lines} torn line(s) tolerated"
                 if merged.torn_lines else ""))
        for s in merged.stale_shards:
            print(f"  stale shard excluded (run {s['run_id']}): "
                  f"{s['path']}")
        for u in merged.unreadable_shards:
            print(f"  unreadable shard skipped: {u['path']} "
                  f"({u['error']})")
        print("clock offsets (ns, vs lowest rank): " + ", ".join(
            f"r{r}={o}" for r, o in sorted(merged.offsets.items())))
        print(fleet.render_storyline(story))
        if rollout:
            print(fleet.render_rollout_storyline(rollout))
        if overload.get("total"):
            print(fleet.render_overload_summary(overload))
        print(fleet.render_fleet_report(report))
        if ns.out:
            print(f"merged Chrome trace written to {ns.out} "
                  f"(load in chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
