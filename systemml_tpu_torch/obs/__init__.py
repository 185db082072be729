# Port of systemml_tpu/obs/__init__.py: the same re-exports and
# traced_run, over the port's modules.
"""Observability subsystem: events, metrics, and device-time profiling.

Two layers over one instrumented stack (reference analogs:
utils/Statistics.java heavy-hitter tables, GPUStatistics per-phase
timers, and the Explain plan dumps):

- ``obs.trace``   — the event bus (layer 1): thread/context-safe span +
  instant API with structured attributes; ring-buffered recorder
  (config ``trace_max_events``); every subsystem reports into it.
- ``obs.metrics`` — the typed registry (layer 2): counters, gauges,
  histograms, labeled families with group metadata; Statistics and the
  serving tier render `-stats`, ``to_dict()`` and Prometheus text from
  it.
- ``obs.profile`` — device-time profiler on top of the bus: opt-in
  dispatch fences as CUDA events (``profile_mode=off|sample|full``) and
  ``profile_report`` attribution (compile/device/host-sync/transfer/
  collective buckets, per-region + per-kernel roofline rows; CLI
  ``-profile``).
- ``obs.export``  — Chrome-trace/Perfetto JSON and compact JSONL
  exporters, plus per-category summaries rendered from the same
  stream.
- ``obs.fleet``   — fleet observability for multi-process runs: run/
  rank identity, per-rank JSONL trace shards with clock-offset
  alignment, the merged Chrome timeline + failover and rollout
  storylines (``python -m systemml_tpu_torch.obs.fleet_trace``), fleet
  metrics rollup and straggler attribution.
- ``obs.ab``      — in-session interleaved A/B benchmarking with
  confidence intervals.

Convenience re-exports cover the common "record this run" shape::

    from systemml_tpu_torch import obs
    with obs.session() as rec:
        ml.execute(script)
    obs.write(rec, "run.json")        # chrome trace (load in Perfetto)
"""

import contextlib

from systemml_tpu_torch.obs.trace import (  # noqa: F401
    CAT_CODEGEN, CAT_COMPILE, CAT_FLEET, CAT_MESH, CAT_PARFOR, CAT_POOL,
    CAT_RESIL, CAT_REWRITE, CAT_RUNTIME, CAT_SERVING, FlightRecorder,
    active, begin_exclusive, end_exclusive, install, instant, recording,
    session, span,
)
from systemml_tpu_torch.obs.export import (  # noqa: F401
    chrome_trace, dispatch_stats, render_summary, write,
    write_chrome_trace, write_jsonl,
)
from systemml_tpu_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, LabeledCounter, MetricsRegistry,
)
from systemml_tpu_torch.obs.profile import (  # noqa: F401
    ProfileReport, profile_report,
)


@contextlib.contextmanager
def traced_run(path):
    """Record exactly one run into a fresh recorder and write it to
    `path` on exit — the shared implementation behind the CLI ``-trace``
    flag, ``MLContext.set_trace`` and ``PreparedScript.set_trace``.

    Yields the recorder, or None when `path` is falsy or another trace
    is already active (first traced run wins; overlapping ones warn and
    skip — the recorder slot is process-global). The teardown releases
    the slot BEFORE writing and never raises: a failed write warns
    instead of clobbering an in-flight exception."""
    rec = None
    if path:
        rec = FlightRecorder()
        if not begin_exclusive(rec):
            import warnings

            warnings.warn("another trace is already active; this run "
                          "will not be traced", RuntimeWarning,
                          stacklevel=3)
            rec = None
    try:
        yield rec
    finally:
        if rec is not None:
            end_exclusive(rec)
            try:
                write(rec, path)
            except Exception as e:
                # broad on purpose: the never-raises contract above must
                # hold for serialization errors too, not just OSError
                import warnings

                warnings.warn(f"could not write trace {path!r}: {e}",
                              RuntimeWarning, stacklevel=3)
