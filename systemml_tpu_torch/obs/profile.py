# Port of systemml_tpu/obs/profile.py: the modes, the per-site sampler,
# ProfileReport and profile_report are the JAX package's, with the
# roofline join through the port's hops/cost.HwProfile.detect(). What
# differs is the fence (maybe_fence): `block_until_ready` becomes a CUDA
# event recorded on the current stream after the launch and synchronized
# inside the open span, never a device-wide synchronize (parfor lanes and
# serving threads launch on streams of their own); the jit-tracer test
# (`has_tracer`) becomes "the current stream is capturing a CUDA graph",
# where no fence is ever taken (a sync inside a capture invalidates it).
# The collective rows have nothing to join until the mesh (ROADMAP queue
# 1, item 12): the `collective` bucket stays and reads 0.
"""Device-time profiler: attribute wall time to where it actually goes.

The flight recorder's ``dispatch`` spans measure ASYNC SUBMISSION by
default — on the card a region's graph or a block's launches "take"
microseconds while the device grinds on, and the wait surfaces later in
whichever span happens to read a result. So the recorder alone cannot
answer "where did the time go". This module adds the reference's
``-stats`` fine-grained discipline (GPUStatistics per-phase timers,
Statistics heavy hitters) as an opt-in profiling layer:

- **Fences.** Under ``profile_mode=full`` every dispatch site (a block
  run through the whole-block compile, ``runtime/blockcompile.py``; a
  loop region's graph launch, ``runtime/loopfuse.py``; a hand kernel's
  launch, ``codegen/backend.run``) waits for its OUTPUTS inside the
  already-open dispatch span: a CUDA event recorded on the current
  stream after the launch, and synchronized, so the span's duration
  becomes device execution time. ``profile_mode=sample`` fences every
  ``profile_sample_every``-th dispatch per site — bounded sync cost,
  unchanged dispatch counts. ``profile_mode=off`` (default) adds no
  fence, no span and no event on the hot path. Fences also require an
  installed recorder — without one there is nothing to attribute — and
  none is taken while the current stream captures a CUDA graph.
- **Attribution.** ``profile_report(recorder)`` folds the event stream
  into named buckets — ``compile`` / ``device`` / ``host_sync`` /
  ``transfer`` / ``collective`` / ``host`` (everything else) — using
  EXCLUSIVE span time (a span's duration minus its children's), so
  nesting never double-counts. Per-region and per-kernel-key rows carry
  dispatch counts and device seconds; kernel rows join the variant's
  analytic time (``hops/cost.HwProfile.detect()``: the H100's roofline on
  the card), which each ``kernel_launch`` span carries, into an
  achieved-vs-roofline fraction.

Surfaced via the CLI ``-profile`` flag (next to ``-trace``) and
programmatically::

    with obs.session() as rec:      # cfg.profile_mode = "full"
        prog.execute()
    rep = obs.profile_report(rec)
    print(rep.text());  json.dumps(rep.to_dict())
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

from systemml_tpu_torch.obs import trace as _trace

PROFILE_MODES = ("off", "sample", "full")

# the five named attribution buckets (+ "host" for everything else)
BUCKETS = ("compile", "device", "host_sync", "transfer", "collective",
           "host")

_site_lock = threading.Lock()
_site_counts: Dict[str, int] = {}


def _mode() -> str:
    from systemml_tpu_torch.utils.config import get_config

    return getattr(get_config(), "profile_mode", "off")


def enabled() -> bool:
    """True when dispatch sites should profile: a recorder is installed
    AND profile_mode is not off. Sites gate extra spans/fences on this,
    so the off-mode hot path stays exactly as before."""
    return _trace._active is not None and _mode() != "off"


def reset_sampling() -> None:
    """Zero the per-site sampling counters (tests / a fresh profiling
    session that wants the deterministic fence-first behavior)."""
    with _site_lock:
        _site_counts.clear()


def _take(site: str) -> bool:
    """Sampling decision for `site` under sample mode: fence the first
    dispatch, then every Nth (per-site counters, so a chatty site does
    not starve a quiet one)."""
    from systemml_tpu_torch.utils.config import get_config

    every = max(1, int(getattr(get_config(), "profile_sample_every", 8)))
    with _site_lock:
        c = _site_counts.get(site, 0)
        _site_counts[site] = c + 1
    return c % every == 0


def capturing() -> bool:
    """True while the current stream captures a CUDA graph: a launch there
    is recorded into the graph, not run, and a sync would invalidate the
    capture."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _cuda_devices(value, acc=None) -> set:
    """The CUDA devices that `value` (a tensor, a sparse or compressed
    matrix, or a dict/list/tuple of them) has data on."""
    acc = set() if acc is None else acc
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            acc.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, acc)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, acc)
    else:
        data = getattr(value, "data", None)  # SparseMatrix, EllMatrix
        if isinstance(data, torch.Tensor) and data.is_cuda:
            acc.add(data.device)
    return acc


def fence(value) -> None:
    """Wait until the work the current stream holds up to now, which made
    `value`, is done: an event recorded on each of `value`'s devices'
    current streams and synchronized. Other streams run on. A value on
    the CPU waits for nothing."""
    for dev in _cuda_devices(value):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def fence_due(site: str = "dispatch") -> bool:
    """Whether the dispatch at `site` is fenced: profiling is enabled
    (recorder + mode), the sampler takes this dispatch, the current
    stream is not capturing a CUDA graph and torch's sync debug mode is
    off."""
    if _trace._active is None:
        return False
    mode = _mode()
    if mode == "off":
        return False
    if mode == "sample" and not _take(site):
        return False
    # a capture records, it does not run; under torch's sync debug mode a
    # run is being watched for its own synchronizing calls (the block
    # compile's watched run), which a fence would add to
    return not capturing() and not (torch.cuda.is_available()
                                     and torch.cuda.get_sync_debug_mode())


def fenced(sp, value: Any) -> None:
    """The fence on a dispatch's OUTPUTS, inside the still-open span `sp`:
    after it returns, the span's duration covers device execution, and
    the span is marked ``fenced=True`` with the pure wait time in
    ``fence_wait_ns``."""
    t0 = time.perf_counter_ns()
    fence(value)
    sp.set(fenced=True, fence_wait_ns=time.perf_counter_ns() - t0)


def maybe_fence(sp, value: Any, site: str = "dispatch") -> None:
    """Donation-safe device fence on a dispatch's OUTPUTS (`fenced`) when
    `fence_due(site)`."""
    if fence_due(site):
        fenced(sp, value)


def host_read(v, kind: str, **attrs):
    """v.item(): a host read of a device value, in a ``host_sync`` span
    while profiling (the host_sync bucket), where the wait for the work
    that made v lands."""
    if not enabled():
        return v.item()
    with _trace.span("host_sync", _trace.CAT_RUNTIME, kind=kind, **attrs):
        return v.item()


# --------------------------------------------------------------------------
# attribution report
# --------------------------------------------------------------------------


def _bucket_of(e) -> str:
    if e.cat == _trace.CAT_COMPILE:
        return "compile"
    if e.name in ("dispatch", "kernel_launch"):
        return "device"
    if e.name in ("host_sync",):
        return "host_sync"
    if e.name == "host_transfer":
        return "transfer"
    if e.name == "dist_op_exec":
        return "collective"
    return "host"


class ProfileReport:
    """Folded attribution over one recorded run. ``buckets`` are
    exclusive seconds per named bucket; ``wall_s`` is the total duration
    of root spans (per-thread roots summed); ``coverage`` is the
    fraction of wall attributed to the five NAMED buckets (the
    acceptance bar), with the remainder in ``host``."""

    def __init__(self, wall_s: float, buckets: Dict[str, float],
                 regions: Dict[str, Dict[str, Any]],
                 kernels: Dict[str, Dict[str, Any]],
                 collectives: Dict[str, Dict[str, Any]],
                 fenced_dispatches: int, total_dispatches: int,
                 dropped_events: int, mode: str,
                 exposed: Optional[Dict[str, Any]] = None):
        self.wall_s = wall_s
        self.buckets = buckets
        self.regions = regions
        self.kernels = kernels
        self.collectives = collectives
        self.fenced_dispatches = fenced_dispatches
        self.total_dispatches = total_dispatches
        self.dropped_events = dropped_events
        self.mode = mode
        # exposed-communication windows (the mesh's `exposed_comm`
        # instants): none until item 12 brings the mesh
        self.exposed = exposed or {"exposed_s": 0.0, "window_s": 0.0,
                                   "bytes": 0, "windows": 0,
                                   "overlap_fraction": None}

    @property
    def attributed_s(self) -> float:
        return sum(self.buckets.values())

    @property
    def coverage(self) -> float:
        """Fraction of wall time in the five NAMED buckets (host
        excluded — the residual Python/evaluator overhead)."""
        named = sum(v for k, v in self.buckets.items() if k != "host")
        return named / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def accounted(self) -> float:
        """Fraction of wall time attributed to ANY bucket (host
        included); < 1.0 means time passed outside every span."""
        return (self.attributed_s / self.wall_s if self.wall_s > 0
                else 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "wall_s": self.wall_s,
            "buckets_s": dict(self.buckets),
            "coverage_named": round(self.coverage, 6),
            "coverage_total": round(self.accounted, 6),
            "regions": self.regions,
            "kernels": self.kernels,
            "collectives": self.collectives,
            "fenced_dispatches": self.fenced_dispatches,
            "total_dispatches": self.total_dispatches,
            "dropped_events": self.dropped_events,
            "profile_mode": self.mode,
            "exposed_comm": dict(self.exposed),
        }

    def text(self, top: int = 10) -> str:
        lines = [f"Profile report (mode={self.mode}): "
                 f"wall={self.wall_s:.3f}s, "
                 f"named-bucket coverage {100 * self.coverage:.1f}%"]
        if self.dropped_events:
            lines.append(f"  [truncated trace: {self.dropped_events} "
                         f"events dropped — attribution is partial]")
        lines.append("  Bucket\tTime(s)\tShare")
        for k in BUCKETS:
            v = self.buckets.get(k, 0.0)
            share = v / self.wall_s if self.wall_s > 0 else 0.0
            lines.append(f"  {k}\t{v:.4f}\t{100 * share:.1f}%")
        if self.total_dispatches:
            lines.append(
                f"Dispatches: {self.total_dispatches} "
                f"({self.fenced_dispatches} fenced"
                + ("" if self.fenced_dispatches >= self.total_dispatches
                   else "; unfenced spans measure async submission only")
                + ")")
        if self.regions:
            rows = sorted(self.regions.items(),
                          key=lambda kv: -kv[1]["device_s"])[:top]
            lines.append(f"Top regions/blocks (top {len(rows)}):")
            lines.append("  #  Label\tDevice(s)\tDispatches\tFenced")
            for i, (k, r) in enumerate(rows, 1):
                lines.append(f"  {i}  {k}\t{r['device_s']:.4f}\t"
                             f"{r['count']}\t{r['fenced']}")
        if self.kernels:
            rows = sorted(self.kernels.items(),
                          key=lambda kv: -kv[1]["device_s"])[:top]
            lines.append(f"Top kernels (top {len(rows)}):")
            lines.append("  #  Kernel\tDevice(s)\tCount\tRoofline")
            for i, (k, r) in enumerate(rows, 1):
                rf = r.get("roofline_frac")
                lines.append(
                    f"  {i}  {k}\t{r['device_s']:.4f}\t{r['count']}\t"
                    + (f"{100 * rf:.0f}%" if rf is not None else "-"))
        return "\n".join(lines)


def profile_report(recorder: _trace.FlightRecorder) -> ProfileReport:
    """Fold a recorded run into the attribution report. Works on any
    recording; device buckets are only trustworthy where dispatches
    were fenced (profile_mode sample/full during the run)."""
    evs = recorder.events()
    spans = [e for e in evs if e.ph == "X"]
    by_id = {e.id: e for e in spans}
    child_dur: Dict[int, int] = {}
    for e in spans:
        if e.parent is not None and e.parent in by_id:
            child_dur[e.parent] = child_dur.get(e.parent, 0) + e.dur
    buckets: Dict[str, float] = {k: 0.0 for k in BUCKETS}
    wall_ns = 0
    regions: Dict[str, Dict[str, Any]] = {}
    kernels: Dict[str, Dict[str, Any]] = {}
    kernel_costs: Dict[Tuple[str, str], Optional[float]] = {}
    fenced = total_disp = 0
    for e in evs:
        if e.ph != "X":
            if e.name == "kernel_select":
                a = e.args or {}
                costs = a.get("costs") or {}
                if isinstance(costs, dict):
                    kernel_costs[(str(a.get("op")), str(a.get("choice")))] \
                        = costs.get(a.get("choice"))
            continue
        a = e.args or {}
        excl = max(0, e.dur - child_dur.get(e.id, 0))
        buckets[_bucket_of(e)] += excl / 1e9
        if e.parent is None:
            wall_ns += e.dur
        if e.name == "dispatch":
            total_disp += 1
            if a.get("fenced"):
                fenced += 1
            label = str(a.get("region") or a.get("block") or "?")
            r = regions.setdefault(label, {"count": 0, "device_s": 0.0,
                                           "fenced": 0})
            r["count"] += 1
            r["device_s"] += e.dur / 1e9
            r["fenced"] += 1 if a.get("fenced") else 0
        elif e.name == "kernel_launch":
            key = f"{a.get('op')}.{a.get('variant')}"
            r = kernels.setdefault(key, {"count": 0, "device_s": 0.0,
                                         "fenced": 0,
                                         "op": str(a.get("op")),
                                         "variant": str(a.get("variant"))})
            r["count"] += 1
            r["device_s"] += e.dur / 1e9
            r["fenced"] += 1 if a.get("fenced") else 0
            m = a.get("modeled_s")
            if m is not None and m == m:
                r["_modeled"] = r.get("_modeled", 0.0) + float(m)
                r["_modeled_n"] = r.get("_modeled_n", 0) + 1
    # the roofline join: kernel rows against the variant's analytic time
    # (hops/cost.HwProfile.detect()), which each launch carries, else the
    # one the kernel backend recorded when it selected the variant
    for key, r in kernels.items():
        total, n = r.pop("_modeled", None), r.pop("_modeled_n", 0)
        modeled = (total / n if total is not None and n == r["count"]
                   else kernel_costs.get((r["op"], r["variant"])))
        # NaN modeled cost = the selector's structural/no-model path:
        # no roofline claim (min(1.0, NaN) would read as a false 100%)
        if (modeled is not None and modeled == modeled
                and r["device_s"] > 0 and r["count"]):
            r["modeled_s"] = float(modeled)
            r["roofline_frac"] = min(
                1.0, float(modeled) / (r["device_s"] / r["count"]))
    return ProfileReport(
        wall_s=wall_ns / 1e9, buckets=buckets, regions=regions,
        kernels=kernels, collectives={},
        fenced_dispatches=fenced, total_dispatches=total_disp,
        dropped_events=recorder.dropped, mode=_mode())
