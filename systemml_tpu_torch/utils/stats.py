"""Execution statistics: timers, counters, heavy hitters.

Port of systemml_tpu/utils/stats.py, trimmed to the counters that the
port's runtime touches: run time, executed blocks, function calls,
per-op heavy hitters, the optimizer/rewrite event families that the
copied HOP passes (hops/rewrite.py, hoist.py, ipa.py) and the spoof
fusion pass (codegen/) report, the fused loop regions
(`loop_regions`, `loop_regions_refused`, `region_counts`) and the sparse
plane (the `spx_*` quaternary paths in their "Sparse exec" line; the
`spmm_*`, `spgemm_*`, `sp_tsmm_*`, `sddmm` and `sparse_densify` decisions
among the optimizer decisions). Every family lives in a run-scoped
``MetricsRegistry`` (obs/metrics.py), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Optional

# the Statistics of the currently executing Program: deep layers (the
# rewrite passes) report here without threading the object through
# every signature
_current: contextvars.ContextVar[Optional["Statistics"]] = \
    contextvars.ContextVar("stats_current", default=None)


def current() -> Optional["Statistics"]:
    return _current.get()


@contextlib.contextmanager
def stats_scope(st: Optional["Statistics"]):
    """Install `st` as the ambient Statistics for the block (compile-time
    rewrite counters), restoring the previous one on exit."""
    tok = _current.set(st)
    try:
        yield st
    finally:
        _current.reset(tok)


# the estim_counts label groups: prefix -> display group
ESTIM_GROUPS = (
    ("rw_", "rewrites"),          # per-rule rewrite fires
    # spoof fusion (optlevel >= 3): spoof_candidates, spoof_selected,
    # spoof_nofuse_by_cost and spoof_structural_fallback from plan
    # selection (codegen/memo.py); spoof_compile_errors, blocks whose
    # selection failed and run unfused (runtime/program.py);
    # spoof_plain_by_layout, kernel wrapper calls whose leaf layout the
    # kernels refuse, which run the plain version (codegen/kernels.py)
    ("spoof_", "spoof"),
    # sparse execution paths: spx_<op>_<path>, one per weighted
    # quaternary op run (exploit_ell, exploit_csr, densify, dense; ops/
    # mult.py)
    ("spx_", "sparse_exec"),
    # the DNN ops (ops/dnn.py): conv algorithm picks (dnn_algo_*), layers
    # by kind (dnn_conv[...], dnn_pool[...]), materialized layout
    # transposes and their bytes, the layout pass's NHWC edges and its
    # failures (dnn_layout_errors, hops/layout.py)
    ("dnn_", "dnn"),
    # the kernel backend (codegen/backend.py): selection sources
    # (select_analytic / select_structural / select_cache /
    # select_measured), per-family picks (pick_<op>.<variant>), calls a
    # kernel refused by shape, dtype or layout (fallback), keys met in a
    # graph capture that kept their analytic choice (capture_unmeasured)
    # and the tuner's search counts
    ("kb_", "kernel_backend"),
)


class Statistics:
    def __init__(self):
        self._lock = threading.Lock()
        # fine-grained mode synchronises the device after each timed op
        # so that op_time reflects execution, not the asynchronous launch
        self.fine_grained = False
        self.reset()

    def reset(self):
        from systemml_tpu_torch.obs.metrics import MetricsRegistry

        reg = self.registry = MetricsRegistry()
        self.run_start = 0.0
        self.run_time = 0.0
        # host seconds of parse and compile, where an entry point
        # records them (api/cli.py)
        self.compile_time = 0.0
        self._active_runs = 0
        reg.gauge("run_seconds", "total execution wall time (union of "
                  "overlapping runs)", unit="s", fn=lambda: self.run_time)
        self._eager_total = reg.counter(
            "eager_blocks_total", "program blocks executed eagerly")
        # the whole-block compile (runtime/blockcompile.py): blocks run
        # through a keyed plan, the plans built, the CUDA graphs captured
        # and replayed, and the eager blocks by reason
        self._fused_total = reg.counter(
            "fused_blocks_total", "program blocks run through a block plan")
        self._compile_total = reg.counter(
            "compiles_total", "block plans built (one per new key)")
        self.eager_reasons = reg.labeled(
            "eager_block_reasons_total", "eager blocks by reason")
        self.block_graph_counts = reg.labeled(
            "block_graph_total", "block CUDA graphs: captures, replays, "
            "and the keys that ran without one by reason")
        # buffer pool (runtime/bufferpool.py): evict, restore, disk_spill,
        # disk_restore, stale_recopy, graph_invalidate
        self.pool_counts = reg.labeled(
            "bufferpool_events_total", "buffer-pool residency events")
        self.fcall_counts = reg.labeled(
            "fcall_total", "DML function invocations")
        self.op_time = reg.labeled(
            "op_seconds", "per-instruction wall time (heavy hitters)",
            unit="s", value_type=float)
        self.op_count = reg.labeled(
            "op_total", "per-instruction execution count")
        self.estim_counts = reg.labeled(
            "optimizer_events_total",
            "optimizer decisions + rw_ rewrite fires",
            groups=ESTIM_GROUPS)
        # fused-loop-region dispatches per region label (the compiler-
        # planned while/for nests of compiler/lower.plan_loop_regions,
        # each a CUDA graph launch on the card): `display()` shows how
        # many one-launch region executions served each loop
        self.region_counts = reg.labeled(
            "region_dispatch_total", "fused-loop-region dispatches")
        # parfor (runtime/parfor.py): the dependency test's verdicts
        # (lang/parfor_deps.py), the device-mode runs, and the task
        # retries and faults (resil/)
        self.dep_check_counts = reg.labeled(
            "dep_check_result", "parfor dependency-test verdicts")
        self.mesh_op_count = reg.labeled(
            "mesh_op_total", "parfor device-mode runs")
        self.resil_counts = reg.labeled(
            "resil_events_total", "fault/retry decisions")

    def merge(self, other: "Statistics") -> None:
        """Adds `other`'s counters to this one's (a parfor worker's
        Statistics into its caller's)."""
        from systemml_tpu_torch.obs.metrics import Counter, LabeledCounter

        with self._lock:
            for name, m in other.registry.metrics().items():
                mine = self.registry.get(name)
                if isinstance(m, LabeledCounter):
                    for k, v in m.items():
                        mine.inc(k, v)
                elif isinstance(m, Counter) and m.value:
                    mine.inc(m.value)

    @property
    def eager_blocks(self) -> int:
        return self._eager_total.value

    def start_run(self):
        with self._lock:
            self._active_runs += 1
            if self._active_runs == 1:
                self.run_start = time.perf_counter()

    def end_run(self):
        with self._lock:
            self._active_runs = max(0, self._active_runs - 1)
            if self._active_runs == 0:
                self.run_time += time.perf_counter() - self.run_start

    @property
    def fused_blocks(self) -> int:
        return self._fused_total.value

    @property
    def compile_count(self) -> int:
        return self._compile_total.value

    def count_block(self, fused: bool = False, reason: str = None):
        if fused:
            self._fused_total.inc()
            return
        self._eager_total.inc()
        if reason is not None:
            self.eager_reasons.inc(reason)

    def count_compile(self):
        self._compile_total.inc()

    def count_pool(self, kind: str):
        self.pool_counts.inc(kind)

    def count_block_graph(self, kind: str):
        self.block_graph_counts.inc(kind)

    def count_fcall(self, name: str):
        self.fcall_counts.inc(name)

    def count_estim(self, kind: str, n: int = 1):
        self.estim_counts.inc(kind, n)

    def count_region(self, label: str, n: int = 1):
        self.region_counts.inc(label, n)

    def count_mesh_op(self, method: str):
        self.mesh_op_count.inc(method)

    def count_resil(self, kind: str, n: int = 1):
        self.resil_counts.inc(kind, n)

    def time_op(self, op: str, seconds: float):
        with self._lock:
            self.op_time.inc(op, seconds)
            self.op_count.inc(op)

    def heavy_hitters(self, n: int = 10):
        return sorted(self.op_time.items(), key=lambda kv: -kv[1])[:n]

    def display(self, max_heavy_hitters: int = 10) -> str:
        lines = [
            "SystemML-TPU (PyTorch port) Statistics:",
            f"Total execution time:\t\t{self.run_time:.3f} sec.",
            f"Parse and compile time:\t\t{self.compile_time:.3f} sec.",
            f"Executed blocks (fused/eager):\t{self.fused_blocks}/"
            f"{self.eager_blocks}.",
        ]
        if self.compile_count or self.eager_reasons:
            lines.append(
                f"Block compile: plans={self.compile_count}"
                + "".join(f", {k}={v}" for k, v in
                          sorted(self.block_graph_counts.items()))
                + ("; eager by reason: " + ", ".join(
                    f"{k}={v}" for k, v in
                    sorted(self.eager_reasons.items()))
                   if self.eager_reasons else ""))
        if self.pool_counts:
            lines.append("Buffer pool: " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.pool_counts.items())))
        hh = self.heavy_hitters(max_heavy_hitters)
        if hh:
            lines.append(f"Heavy hitter instructions (top {len(hh)}):")
            lines.append("  #  Instruction\tTime(s)\tCount")
            for i, (op, t) in enumerate(hh, 1):
                lines.append(f"  {i}  {op}\t{t:.3f}\t{self.op_count[op]}")
        g = self.estim_counts.grouped()
        rw, spoof, spx, dnn, kb, opt = (g["rewrites"], g["spoof"],
                                        g["sparse_exec"], g["dnn"],
                                        g["kernel_backend"], g[""])
        if rw:
            top = sorted(rw.items(), key=lambda kv: (-kv[1], kv[0]))[:8]
            suffix = ", ..." if len(rw) > len(top) else ""
            lines.append(
                f"Rewrites fired:\t\t{sum(rw.values())} "
                f"({len(rw)} rules; top: "
                + ", ".join(f"{k}={v}" for k, v in top) + suffix + ")")
        if spoof:
            lines.append("Spoof fusion: " + ", ".join(
                f"{k}={v}" for k, v in sorted(spoof.items())))
        if kb:
            # how each hand kernel's arm was chosen, next to how it ran
            lines.append("Kernel backend (event=count): " + ", ".join(
                f"{k}={v}" for k, v in sorted(kb.items())))
        if spx:
            # which arm each weighted quaternary op ran: the sampled one
            # (exploit_ell / exploit_csr) or the (m, n) product (densify /
            # dense), as the JAX package's "Sparse exec" line
            lines.append("Sparse exec (op_path=count): " + ", ".join(
                f"{k}={v}" for k, v in sorted(spx.items())))
        if dnn:
            # the DNN profile (systemml_tpu/utils/stats.py:344-365),
            # counted per op run: algorithm and layout picks per layer
            # geometry, transposes with their bytes, NHWC chain edges
            tb = dnn.pop("transpose_bytes", 0)
            tn = dnn.pop("transposes", 0)
            edges = dnn.pop("nhwc_edges", 0)
            errs = dnn.pop("layout_errors", 0)
            layers = {k: v for k, v in dnn.items()
                      if k.startswith(("conv[", "pool["))}
            algos = {k: v for k, v in dnn.items() if k.startswith("algo_")}
            lines.append(
                f"DNN hot path:\t\ttransposes={tn} ({tb / 1e6:.2f} MB), "
                f"nhwc_edges={edges}, layout_errors={errs}")
            if algos:
                lines.append("  conv algorithms: " + ", ".join(
                    f"{k[5:]}={v}" for k, v in sorted(algos.items())))
            if layers:
                lines.append("  layers (op[algo,layout,kernel,geom]=count):")
                for k, v in sorted(layers.items()):
                    lines.append(f"    {k}={v}")
        if opt:
            lines.append("Optimizer decisions: " + ", ".join(
                f"{k}={v}" for k, v in sorted(opt.items())))
        if self.region_counts:
            # fused-loop regions (whole while/for nests launched as one
            # CUDA graph): region label = carried names; compare against
            # "Executed blocks" to see how much of the run lived inside
            # regions (systemml_tpu/utils/stats.py:382-393)
            planned = self.estim_counts.get("loop_regions", 0)
            refused = self.estim_counts.get("loop_regions_refused", 0)
            lines.append(
                f"Loop regions (planned={planned}, refused={refused}; "
                "region=dispatches): " + ", ".join(
                    f"{k}={v}"
                    for k, v in sorted(self.region_counts.items())))
        launches = _kernel_launches()
        if launches:
            # the hand-written kernels' launch counters (codegen/,
            # compress/device.py): process-wide, as the wrappers count
            lines.append("Kernel launches (this process): " + ", ".join(
                f"{k}={v}" for k, v in sorted(launches.items())))
        if self.dep_check_counts:
            lines.append("Parfor dep checks (verdict=count): " + ", ".join(
                f"{k}={v}"
                for k, v in sorted(self.dep_check_counts.items())))
        if self.resil_counts:
            lines.append("Resilience events: " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.resil_counts.items())))
        if self.fcall_counts:
            top = sorted(self.fcall_counts.items(), key=lambda kv: -kv[1])[:5]
            lines.append("Function calls: " +
                         ", ".join(f"{k}={v}" for k, v in top))
        return "\n".join(lines)


def _kernel_launches() -> dict:
    from systemml_tpu_torch.runtime.loopfuse import launch_counters

    return {k: f.launches for k, f in launch_counters().items()
            if f.launches}
