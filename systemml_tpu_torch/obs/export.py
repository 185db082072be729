# Copy of systemml_tpu/obs/export.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch. The mesh and fleet summaries read
# events that the port does not emit yet (items 12 and 13), and print nothing.
"""Exporters for the flight-recorder event stream.

Two formats plus a text summary, all rendered from the SAME events —
the design point the subsystem exists for: heavy hitters, rewrite-fired
tallies, pool pressure and collective traffic are *views* over one
stream, not separately maintained counters that can drift apart.

- Chrome-trace JSON (``chrome_trace`` / ``write_chrome_trace``): loads
  in ``chrome://tracing`` and https://ui.perfetto.dev; spans nest by
  time containment per thread.
- Compact JSONL (``write_jsonl``): one event per line with raw ns
  timestamps and explicit parent ids, for programmatic analysis.
- ``render_summary``: the Statistics.display analog, computed from the
  stream (top spans by total time, rewrite rules fired, pool events,
  mesh dispatches with collective bytes).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, List

from systemml_tpu_torch.obs.trace import (
    CAT_ANALYSIS, CAT_CODEGEN, CAT_COMPILE, CAT_FLEET, CAT_MESH, CAT_PARFOR,
    CAT_POOL, CAT_RESIL, CAT_REWRITE, CAT_RUNTIME, CAT_SERVING,
    FlightRecorder)


def chrome_trace(recorder: FlightRecorder) -> Dict[str, Any]:
    """Trace-event JSON object (Chrome/Perfetto 'traceEvents' format;
    timestamps in microseconds relative to the first event)."""
    evs = recorder.events()
    t0 = min((e.ts for e in evs), default=0)
    pid = os.getpid()
    out: List[Dict[str, Any]] = []
    for e in evs:
        d: Dict[str, Any] = {
            "name": e.name, "cat": e.cat, "pid": pid, "tid": e.tid,
            "ts": (e.ts - t0) / 1e3,
        }
        if e.ph == "X":
            d["ph"] = "X"
            d["dur"] = e.dur / 1e3
        else:
            d["ph"] = "i"
            d["s"] = "t"  # thread-scoped instant
        if e.args:
            d["args"] = _jsonable(e.args)
        out.append(d)
    meta: Dict[str, Any] = {"displayTimeUnit": "ms",
                            "traceEvents": out}
    if recorder.dropped:
        meta.setdefault("otherData", {})["dropped_events"] = \
            recorder.dropped
    from systemml_tpu_torch.obs import fleet

    ident = fleet.identity()
    if ident is not None:
        # run/rank identity stamp (obs/fleet.py): a single-process
        # export from a fleet member stays attributable after the fact
        meta.setdefault("otherData", {})["fleet"] = ident.to_dict()
    return meta


def write_chrome_trace(recorder: FlightRecorder, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(recorder), f)


def write_jsonl(recorder: FlightRecorder, path: str) -> None:
    """Compact event log: one JSON object per line, raw ns timestamps,
    explicit parent ids (causality survives thread interleaving). A
    truncated recording (ring-buffer eviction) leads with one meta line
    so consumers cannot mistake the tail for the whole run."""
    with open(path, "w") as f:
        if recorder.dropped:
            f.write(json.dumps({
                "meta": "truncated",
                "dropped_events": recorder.dropped,
                "note": "ring buffer evicted the oldest events; this "
                        "file holds only the most recent "
                        f"{recorder.max_events}",
            }) + "\n")
        for e in recorder.events():
            f.write(json.dumps({
                "id": e.id, "name": e.name, "cat": e.cat, "ph": e.ph,
                "ts_ns": e.ts, "dur_ns": e.dur, "tid": e.tid,
                "parent": e.parent, "args": _jsonable(e.args) or {},
            }) + "\n")


def write(recorder: FlightRecorder, path: str) -> None:
    """Extension-dispatched export: ``*.jsonl`` writes the compact event
    log, anything else the Chrome-trace JSON."""
    if path.endswith(".jsonl"):
        write_jsonl(recorder, path)
    else:
        write_chrome_trace(recorder, path)


def _jsonable(args):
    if not args:
        return None
    out = {}
    for k, v in args.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            try:
                out[k] = str(v)
            except Exception:
                out[k] = f"<unprintable {type(v).__name__}>"
    return out


def dispatch_stats(recorder: FlightRecorder) -> Dict[str, Any]:
    """The dispatch-budget view over one recorded run: how
    many device dispatches, recompiles, eager-mode blocks and host
    transfers happened, plus the layout profile (materialized
    transposes + bytes, annotated NHWC chain edges) — the per-phase
    decomposition bench.py attaches to the resnet A/B verdict and the
    regression the dispatch-budget test pins on CPU.

    compile_s vs dispatch_s split spans by name: `recompile` spans are
    trace+XLA-compile wall time, `dispatch` spans are device execution
    (async-submission time unless stats ran fine-grained)."""
    evs = recorder.events()
    out: Dict[str, Any] = {
        "dispatches": 0, "recompiles": 0, "eager_blocks": 0,
        "host_transfers": 0, "host_transfer_values": 0,
        "compile_s": 0.0, "dispatch_s": 0.0,
        "layout_transposes": 0, "layout_transpose_bytes": 0,
        "nhwc_chain_edges": 0, "donated_states": 0,
        # serving tier (api/serving.py): bucketed-dispatch cache
        # behavior + micro-batch coalescing — the "0 recompiles after
        # bucket warmup" acceptance reads recompiles next to these
        "bucket_hits": 0, "bucket_misses": 0, "bucket_pad_rows": 0,
        "microbatch_flushes": 0, "microbatched_requests": 0,
        # loop-region view (compiler/lower.plan_loop_regions + the
        # runtime/loopfuse.py region executor): host_pred_syncs counts
        # HOST evaluations of device predicates (the per-outer-iteration
        # round-trip whole-region compilation removes — a fused region
        # keeps its convergence predicate in the carried state, so a
        # steady-state algorithm run shows 0 here); region_dispatches
        # totals the one-dispatch region executions; `loop_regions`
        # below decomposes both per region label
        "host_pred_syncs": 0, "region_dispatches": 0,
        # overlapped DCN collectives (parallel/overlap.py): per-bucket
        # cross-host payload accounting (`dcn_bucket` instants) and the
        # measured exposed-communication wait vs the whole comm window
        # (`exposed_comm` instants) — overlap_fraction is the share of
        # the window hidden behind compute (None until a window ran)
        "dcn_buckets": 0, "dcn_bucket_bytes": 0,
        "exposed_comm_s": 0.0, "comm_window_s": 0.0, "comm_windows": 0,
        "overlap_fraction": None,
    }
    if recorder.dropped:
        # honest truncation: a ring-evicted recording undercounts —
        # consumers (bench profiles, budget tests) must be able to tell
        out["trace_dropped_events"] = recorder.dropped
    regions: Dict[str, Dict[str, Any]] = {}
    for e in evs:
        a = e.args or {}
        if e.name == "dispatch" and e.ph == "X":
            out["dispatches"] += 1
            out["dispatch_s"] += e.dur / 1e9
        elif e.name == "recompile" and e.ph == "X":
            out["recompiles"] += 1
            out["compile_s"] += e.dur / 1e9
        elif e.name == "block" and a.get("mode") == "eager":
            out["eager_blocks"] += 1
        elif e.name == "host_transfer" and e.ph == "X":
            out["host_transfers"] += 1
            out["host_transfer_values"] += int(a.get("values", 0) or 0)
        elif e.name == "layout_transpose":
            out["layout_transposes"] += 1
            out["layout_transpose_bytes"] += int(a.get("bytes", 0) or 0)
        elif e.name == "layout_chain":
            out["nhwc_chain_edges"] += int(a.get("edges", 0) or 0)
        elif e.name == "pool_donate":
            out["donated_states"] += int(a.get("n", 0) or 0)
        elif e.name == "bucket_dispatch":
            if a.get("hit"):
                out["bucket_hits"] += 1
            else:
                out["bucket_misses"] += 1
            out["bucket_pad_rows"] += int(a.get("pad_rows", 0) or 0)
        elif e.name == "microbatch_flush":
            out["microbatch_flushes"] += 1
            out["microbatched_requests"] += int(a.get("requests", 0) or 0)
        elif e.name == "dcn_bucket":
            out["dcn_buckets"] += 1
            out["dcn_bucket_bytes"] += int(a.get("bytes", 0) or 0)
        elif e.name == "exposed_comm":
            out["exposed_comm_s"] += int(a.get("exposed_ns", 0) or 0) / 1e9
            out["comm_window_s"] += int(a.get("window_ns", 0) or 0) / 1e9
            out["comm_windows"] += 1
        elif e.name == "pred_host_sync":
            out["host_pred_syncs"] += 1
        elif e.name == "region_dispatch":
            out["region_dispatches"] += 1
            label = str(a.get("region") or "?")
            r = regions.setdefault(label, {
                "dispatches": 0, "outer_iters": 0, "carried": 0,
                "donated": 0, "donated_bytes": 0, "copied": 0,
                "copied_bytes": 0, "kind": a.get("kind"),
                "pred": a.get("pred"),
            })
            r["dispatches"] += 1
            oi = a.get("outer_iters")
            if oi is not None:
                r["outer_iters"] += int(oi)
            r["carried"] = int(a.get("carried", 0) or 0)
            for k in ("donated", "donated_bytes", "copied", "copied_bytes"):
                r[k] += int(a.get(k, 0) or 0)
    if regions:
        out["loop_regions"] = regions
    if out["comm_window_s"] > 0:
        out["overlap_fraction"] = round(
            1.0 - out["exposed_comm_s"] / out["comm_window_s"], 6)
    return out


def _summary_compile(evs) -> List[str]:
    """CAT_COMPILE: total compile wall + the dynamic-recompile signal."""
    recompiles = [e for e in evs if e.ph == "X" and e.name == "recompile"]
    if not recompiles:
        return []
    total = sum(e.dur for e in recompiles) / 1e9
    return [f"Recompiles: {len(recompiles)} ({total:.3f}s XLA "
            "trace+compile)"]


def _summary_runtime(evs) -> List[str]:
    """CAT_RUNTIME: dispatch/transfer/sync traffic (the counts
    dispatch_stats exposes as data, one line for humans)."""
    n = defaultdict(int)
    for e in evs:
        if e.cat != CAT_RUNTIME:
            continue
        if e.name in ("dispatch", "host_transfer", "pred_host_sync",
                      "region_dispatch"):
            n[e.name] += 1
        elif e.name == "block" and (e.args or {}).get("mode") == "eager":
            n["eager_block"] += 1
    if not n:
        return []
    return ["Runtime: " + ", ".join(f"{k}={n[k]}" for k in sorted(n))]


def _summary_pool(evs) -> List[str]:
    pool: Dict[str, int] = defaultdict(int)
    for e in evs:
        if e.cat == CAT_POOL and e.ph != "X":
            pool[e.name] += 1
    if not pool:
        return []
    return ["Buffer pool events: " + ", ".join(
        f"{k}={v}" for k, v in sorted(pool.items()))]


def _summary_rewrite(evs) -> List[str]:
    rewrites: Dict[str, int] = defaultdict(int)
    for e in evs:
        if e.cat == CAT_REWRITE and e.ph != "X":
            rewrites[e.name] += 1
    if not rewrites:
        return []
    # grouped headline first (total + distinct rules — the same
    # one-line shape Statistics.display uses), then the full
    # per-rule tally the trace view exists for
    return [f"Rewrites fired: {sum(rewrites.values())} total, "
            f"{len(rewrites)} rules: " + ", ".join(
                f"{k}={v}" for k, v in sorted(rewrites.items()))]


def _summary_resil(evs) -> List[str]:
    resil: Dict[str, int] = defaultdict(int)
    for e in evs:
        if e.cat == CAT_RESIL and e.ph != "X":
            # keyed name+site: "fault@remote.job=2" localizes the storm
            site = (e.args or {}).get("site")
            resil[f"{e.name}@{site}" if site else e.name] += 1
    if not resil:
        return []
    return ["Resilience events: " + ", ".join(
        f"{k}={v}" for k, v in sorted(resil.items()))]


def _summary_mesh(evs) -> List[str]:
    mesh_count: Dict[str, int] = defaultdict(int)
    mesh_bytes: Dict[str, int] = defaultdict(int)
    buckets = bucket_bytes = windows = 0
    exposed_ns = window_ns = 0
    for e in evs:
        if e.cat != CAT_MESH or e.ph == "X":
            continue
        a = e.args or {}
        if e.name == "dist_op":
            # only the dist_op instants: the evaluator's paired
            # mesh_dispatch (method pick) event would double-count the
            # same dispatch under the same op key
            op = a.get("op") or e.name
            mesh_count[str(op)] += 1
            mesh_bytes[str(op)] += int(a.get("bytes", 0) or 0)
        elif e.name == "dcn_bucket":
            buckets += 1
            bucket_bytes += int(a.get("bytes", 0) or 0)
        elif e.name == "exposed_comm":
            windows += 1
            exposed_ns += int(a.get("exposed_ns", 0) or 0)
            window_ns += int(a.get("window_ns", 0) or 0)
    lines = []
    if mesh_count:
        lines.append("Mesh dispatches (op=count/bytes): " + ", ".join(
            f"{k}={mesh_count[k]}/{mesh_bytes[k]}"
            for k in sorted(mesh_count)))
    if buckets or windows:
        frac = (f", overlap {100.0 * (1.0 - exposed_ns / window_ns):.1f}%"
                if window_ns > 0 else "")
        lines.append(
            f"DCN overlap: {buckets} buckets/{bucket_bytes} bytes, "
            f"exposed_comm {exposed_ns / 1e9:.4f}s over {windows} "
            f"windows{frac}")
    return lines


def _summary_parfor(evs) -> List[str]:
    """CAT_PARFOR: loops executed + tasks dispatched (per mode)."""
    loops = tasks = 0
    modes: Dict[str, int] = defaultdict(int)
    for e in evs:
        if e.cat != CAT_PARFOR:
            continue
        if e.name == "parfor":
            loops += 1
            m = (e.args or {}).get("mode")
            if m:
                modes[str(m)] += 1
        elif e.name == "parfor_task":
            tasks += 1
    if not loops and not tasks:
        return []
    mode_s = ("" if not modes else " (" + ", ".join(
        f"{k}={v}" for k, v in sorted(modes.items())) + ")")
    return [f"Parfor: {loops} loops, {tasks} tasks{mode_s}"]


def _summary_serving(evs) -> List[str]:
    """CAT_SERVING: bucket hit/miss + pad volume + micro-batch flushes
    (the event-stream view of the srv_* counter family)."""
    hits = misses = pad = flushes = coalesced = 0
    for e in evs:
        if e.cat != CAT_SERVING:
            continue
        a = e.args or {}
        if e.name == "bucket_dispatch":
            if a.get("hit"):
                hits += 1
            else:
                misses += 1
            pad += int(a.get("pad_rows", 0) or 0)
        elif e.name == "microbatch_flush":
            flushes += 1
            coalesced += int(a.get("requests", 0) or 0)
    if not (hits or misses or flushes):
        return []
    return [f"Serving: bucket hits/misses={hits}/{misses}, "
            f"pad_rows={pad}, microbatch flushes={flushes} "
            f"({coalesced} requests coalesced)"]


def _summary_codegen(evs) -> List[str]:
    """CAT_CODEGEN: kernel selections per source + runtime fallbacks
    (the event-stream view of the kb_* counter family)."""
    sel: Dict[str, int] = defaultdict(int)
    falls = 0
    for e in evs:
        if e.cat != CAT_CODEGEN:
            continue
        if e.name == "kernel_select":
            sel[str((e.args or {}).get("source") or "?")] += 1
        elif e.name == "kernel_fallback":
            falls += 1
    if not sel and not falls:
        return []
    return ["Kernel backend: selects " + ", ".join(
        f"{k}={v}" for k, v in sorted(sel.items()))
        + f"; fallbacks={falls}"]


def _summary_analysis(evs) -> List[str]:
    """CAT_ANALYSIS: donation-sanitizer verdict events (the event-stream
    view of the donation_events_total counter family)."""
    sites = set()
    verdicts: Dict[str, int] = defaultdict(int)
    poisoned = 0
    mismatches = 0
    for e in evs:
        if e.cat != CAT_ANALYSIS:
            continue
        a = e.args or {}
        if e.name == "donation_verdicts":
            sites.add(str(a.get("site") or "?"))
            for k in ("proven_dead", "must_copy", "refused"):
                verdicts[k] += int(a.get(k, 0) or 0)
            if a.get("mismatches"):
                mismatches += len(str(a["mismatches"]).split(","))
        elif e.name == "donation_poisoned":
            poisoned += 1
    if not sites and not poisoned:
        return []
    return ["Donation safety: " + ", ".join(
        f"{k}={v}" for k, v in sorted(verdicts.items()))
        + f" across {len(sites)} site(s); poisoned={poisoned}, "
          f"static/runtime mismatches={mismatches}"]


def _summary_fleet(evs) -> List[str]:
    """CAT_FLEET: per-step heartbeats + clock-alignment probes (the
    single-process view; the cross-rank merge lives in obs/fleet.py)."""
    steps = probes = announces = 0
    step_ns = 0
    gens = set()
    for e in evs:
        if e.cat != CAT_FLEET:
            continue
        a = e.args or {}
        if e.name == "fleet_step":
            steps += 1
            step_ns += int(a.get("dur_ns", 0) or 0)
            gens.add(int(a.get("gen", 0) or 0))
        elif e.name == "clock_probe":
            probes += 1
        elif e.name == "clock_announce":
            announces += 1
    if not (steps or probes or announces):
        return []
    gen_s = ("gen " + "/".join(str(g) for g in sorted(gens))
             if gens else "gen -")
    return [f"Fleet: {steps} steps ({step_ns / 1e9:.4f}s, {gen_s}), "
            f"{announces} clock announces, {probes} probes"]


# one summary renderer per trace category — scripts/check_metrics.py
# enforces that every CAT_* constant in obs/trace.py has an entry here,
# so a new event category cannot ship without a human-readable view
CATEGORY_SUMMARIES = {
    CAT_REWRITE: _summary_rewrite,
    CAT_POOL: _summary_pool,
    CAT_RESIL: _summary_resil,
    CAT_MESH: _summary_mesh,
    CAT_COMPILE: _summary_compile,
    CAT_RUNTIME: _summary_runtime,
    CAT_PARFOR: _summary_parfor,
    CAT_SERVING: _summary_serving,
    CAT_CODEGEN: _summary_codegen,
    CAT_ANALYSIS: _summary_analysis,
    CAT_FLEET: _summary_fleet,
}


def render_summary(recorder: FlightRecorder, top: int = 10) -> str:
    """Heavy-hitter + per-category summary from the event stream
    (reference: Statistics.display / maintainCPHeavyHitters, rendered
    here as a pure view over the recorded events). Each trace category
    renders through its CATEGORY_SUMMARIES entry."""
    evs = recorder.events()
    span_time: Dict[str, float] = defaultdict(float)
    span_count: Dict[str, int] = defaultdict(int)
    for e in evs:
        if e.ph == "X":
            key = f"{e.cat}:{e.name}"
            span_time[key] += e.dur / 1e9
            span_count[key] += 1
    lines = [f"Flight recorder: {len(evs)} events"
             + (f" ({recorder.dropped} dropped — ring buffer kept the "
                f"most recent {recorder.max_events})"
                if recorder.dropped else "")]
    hh = sorted(span_time.items(), key=lambda kv: -kv[1])[:top]
    if hh:
        lines.append(f"Heavy hitter spans (top {len(hh)}):")
        lines.append("  #  Span\tTime(s)\tCount")
        for i, (k, t) in enumerate(hh, 1):
            lines.append(f"  {i}  {k}\t{t:.3f}\t{span_count[k]}")
    for renderer in CATEGORY_SUMMARIES.values():
        lines.extend(renderer(evs))
    return "\n".join(lines)
