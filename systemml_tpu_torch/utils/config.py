"""Configuration system of the PyTorch port.

Port of systemml_tpu/utils/config.py. The DMLConfig fields are copied
unchanged, so a JSON config file reads the same in both packages; the
port adds `device`. What differs is what the dtype and precision
policies resolve to: torch dtypes on an explicit device instead of jax
dtypes on the default backend.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
import os
import threading
from typing import Any, Optional

class UnknownConfigKeyError(KeyError):
    """A config key that names no knob.

    Subclasses ``KeyError`` so pre-existing ``except KeyError`` callers
    keep working, but carries the nearest valid knob name so a typo'd
    ``fleet_max_redispach`` points at ``fleet_max_redispatch`` instead
    of being silently ignored or failing with a bare name.
    """

    def __init__(self, key: str, suggestion: Optional[str] = None):
        self.key = key
        self.suggestion = suggestion
        msg = f"unknown config key: {key}"
        if suggestion:
            msg += f" (did you mean {suggestion!r}?)"
        super().__init__(msg)

    def __str__(self) -> str:  # KeyError.__str__ repr-quotes; keep it readable
        return self.args[0]


@dataclasses.dataclass
class DMLConfig:
    # --- device (port only) -------------------------------------------------
    # where values live and kernels run: "cuda" (the default; an H100)
    # or "cpu" (tests, with each kernel's plain PyTorch version). There
    # is no silent fallback: "cuda" without a card raises at MLContext
    # construction (resolve_device).
    device: str = "cuda"

    # --- optimizer ---------------------------------------------------------
    # Optimization levels mirror the reference (hops/OptimizerUtils.java:250-257):
    # 0 = no rewrites, 1 = static rewrites only (memory-agnostic),
    # 2 = full static+dynamic rewrites (default), 3 = + fusion codegen,
    # 4 = + aggressive (fp32/bf16 matmul compute on TPU).
    optlevel: int = 2
    # fraction of HBM the planner may budget for a single operation's inputs
    # + output before it forces mesh sharding (reference MEM_UTIL_FACTOR=0.7,
    # hops/OptimizerUtils.java:72)
    mem_util_factor: float = 0.7
    # logical block size used for sharding-granularity decisions; the
    # reference blocks matrices at 1000x1000 (hops/OptimizerUtils.java:75).
    # On TPU this is only a planning granularity - arrays are contiguous and
    # sharded via jax.sharding, never physically tiled on host.
    blocksize: int = 1000

    # --- numerics ----------------------------------------------------------
    # DML semantics in the reference are fp64 (api/DMLScript.java:174,
    # conf/DMLConfig.java:94 'sysml.floating.point.precision'). TPU MXU is
    # bf16/fp32, so the default value dtype is fp64 on CPU and fp32 on TPU,
    # with matmul accumulation always in at-least-fp32 ("highest" precision).
    # "bfloat16" is a MIXED-precision policy, not a storage dtype: master
    # weights and default values stay fp32 (default_dtype), while the
    # FLOP-dominant ops (matmult family, conv2d family, lstm) cast their
    # operands to bf16 and accumulate in fp32 on the MXU
    # (docs/performance.md). "double" emulates fp64 via double-float
    # pairs on TPU (ops/doublefloat.py).
    floating_point_precision: str = "auto"  # auto | double | single | bfloat16
    # lax dot/conv precision: HIGHEST keeps fp32 accumulation on MXU
    matmul_precision: str = "highest"
    # internal conv/pool data layout: NHWC is the TPU-native layout (the
    # XLA TPU backend would otherwise insert transposes around every
    # NCHW conv); "auto" = NHWC on accelerator backends, NCHW on CPU.
    # The hop-level layout pass (hops/layout.py) cancels the boundary
    # transposes between chained conv/bias/relu/pool ops.
    conv_layout: str = "auto"  # auto | nhwc | nchw
    # conv lowering algorithm: "auto" picks im2col vs native lax.conv
    # per (kernel, geometry) by cost (ops/dnn.conv_algo; cached decision
    # shared by forward and backward so a layer never mixes algorithms)
    conv_algorithm: str = "auto"  # auto | conv | im2col

    # --- execution ---------------------------------------------------------
    # exec mode: AUTO picks single-device vs mesh per-op by memory estimate
    # (the reference's CP-vs-SPARK decision, hops/Hop.java:741); SINGLE_NODE
    # forces one device; MESH forces sharded execution.
    exec_mode: str = "AUTO"  # AUTO | SINGLE_NODE | MESH
    # number of parallel workers for parfor LOCAL mode (0 = #devices or cpu count)
    parfor_par: int = 0
    # enable operator fusion within statement blocks (whole-block jit);
    # the reference's codegen/Spoof analog (hops/codegen/SpoofCompiler.java)
    codegen_enabled: bool = True
    # hand-kernel usage (codegen/backend.use_kernel; the name is the
    # reference's): auto = the hand kernels on the card, always = the
    # kernel variants also on the CPU (their wrappers run the plain
    # versions there), never = the plain or library arms
    pallas_mode: str = "auto"
    # generated-kernel backend tuning (codegen/backend.py + tune.py):
    # off = analytic cost model only; online = measure short-listed
    # variants in-process (paired obs/ab) on first touch of each kernel
    # key; cached = online + persist verdicts to codegen_tune_cache so
    # later processes dispatch with zero re-measurement
    codegen_tune_mode: str = "off"  # off | online | cached
    # interleaved trials per measured pair (obs/ab.interleave)
    codegen_tune_trials: int = 3
    # how many variants (analytic winner first) enter the measured
    # tournament per kernel key
    codegen_tune_shortlist: int = 2
    # on-disk tuning-cache path (JSON, keyed by kernel key + device
    # name, codegen/tune.py); empty string disables persistence
    codegen_tune_cache: str = "~/.cache/systemml_tpu_torch/tune.json"
    # learned kernel cost model (codegen/costmodel.py): ridge regression
    # over accumulated measured records short-lists the swept schedule
    # space for the measured tournament; "off" = analytic ranking only
    codegen_cost_model: str = "ridge"  # ridge | off
    # minimum measured records for an op family before the learned model
    # may rank its candidates; below it selection falls back to analytic
    # ranking (named kernel_fallback reason=cold_model event)
    codegen_cost_model_min_records: int = 8
    # donate the carried-state buffers of fused while/for loops
    # (runtime/loopfuse.py): an epoch's weight updates then alias
    # in-place across iterations instead of allocating a fresh copy of
    # every parameter + optimizer-state tensor per loop entry.
    # "auto" donates on accelerator backends only — XLA:CPU performs no
    # input/output aliasing, so donation there is a per-compile
    # UserWarning plus defensive host copies for zero benefit;
    # "always" forces it (tests), "never" disables.
    loopfuse_donate: str = "auto"  # auto | always | never
    # runtime donation sanitizer (analysis/sanitizer.py): off = zero
    # dispatch-path work (default); check = validate the buffer-
    # lifetime pass verdicts at every donation-site dispatch (one
    # CAT_ANALYSIS trace event per site + the "Donation safety"
    # `-stats` line, static-vs-runtime mismatches counted); poison =
    # check + swap stale symbol-table references to donated buffers
    # for guard proxies that raise a diagnostic naming the donation
    # site and the offending consumer on ANY access (turns a deleted-
    # array crash into a named use-after-donate error)
    donation_sanitizer: str = "off"  # off | check | poison
    # fused-block XLA compile budget in seconds (0 disables the guard).
    # Some op combinations explode the TPU compiler superlinearly
    # (measured: a 2x chained-5x5-conv forward takes 62s and the full
    # fwd+bwd step >10min on v5e, while each op alone compiles in
    # seconds). Past the budget the block permanently falls back to
    # per-piece execution, whose small plans compile in seconds total —
    # the abandoned compile finishes in its thread and still lands in
    # the persistent cache for future runs.
    compile_timeout_s: float = 240.0
    # compressed linear algebra injection (reference:
    # 'sysml.compressed.linalg' conf/DMLConfig.java + hops/rewrite/
    # RewriteCompressedReblock.java): auto = sample-estimate large
    # loop-invariant matmult inputs and compress when the ratio clears
    # cla_min_ratio; true = compress every candidate; false = never
    cla: str = "auto"  # auto | true | false
    # opt-in Kahan-compensated full sums for cancellation-heavy fp32
    # reductions (ops/agg.kahan_sum; reference analog: the KahanPlus
    # accumulators of LibMatrixAgg, here applied across chunk partials
    # because TPU has no fp64 ALUs to widen into)
    compensated_sum: bool = False
    # minimum estimated compression ratio for auto injection — compressed
    # eager dispatch must beat the dense fused loop, so demand a real win
    cla_min_ratio: float = 4.0
    # sparsity threshold below which matrices are represented sparse
    # (reference MatrixBlock.SPARSITY_TURN_POINT=0.4, matrix/data/MatrixBlock.java:101)
    sparsity_turn_point: float = 0.4
    ultra_sparsity_turn_point: float = 0.00004

    # --- resilience (systemml_tpu/resil) -----------------------------------
    # supervised execution: classify-and-retry transient faults (OOM /
    # RESOURCE_EXHAUSTED, worker death, deadline expiry, preemption) at
    # the parfor/remote/dispatch recovery sites. Fatal-classified errors
    # (DML/validation/programming bugs) always raise immediately.
    resil_enabled: bool = True
    # per-site attempt budget (1 = no retries); the Spark analog is
    # spark.task.maxFailures on parfor task retry
    resil_max_attempts: int = 3
    # exponential backoff between attempts: base * 2^(attempt-1), capped
    # at max, +/- deterministic jitter (resil/policy.py)
    resil_backoff_base_s: float = 0.05
    resil_backoff_max_s: float = 2.0
    resil_backoff_jitter: float = 0.5
    # per-job wall-clock deadline for remote parfor workers: a worker
    # that does not reply in time is presumed hung, retired (SIGKILL)
    # and its task group requeued on a fresh worker. 0 disables (the
    # pre-resilience blocking-readline behavior). The clock starts when
    # the worker acknowledges the job: its start (process spawn, torch
    # import) and its wait for the job never count.
    # The deadline bounds a worker's WHOLE task group, so the default
    # is deliberately generous — it exists to catch wedged workers,
    # not to police slow-but-healthy ones; tune down per deployment.
    remote_deadline_s: float = 1800.0
    # deterministic fault injection: "site:kind[:nth[:count]],..."
    # (resil/inject.py; the SMTPU_FAULT env var arms independently)
    fault_injection: str = ""

    # --- elasticity (systemml_tpu/elastic) ---------------------------------
    # collective-level fault domain: a device-loss-classified failure of a
    # sharded op shrinks the mesh over the surviving devices, re-shards
    # and retries instead of failing the program (docs/elasticity.md)
    elastic_enabled: bool = True
    # split a single-host device set into N synthetic fault domains
    # (hierarchical dcn x dp mesh) — CPU-deterministic host-loss testing;
    # 0 = real topology only (process_index grouping on multi-host jobs)
    elastic_virtual_hosts: int = 0
    # how many times a run may shrink before the original failure
    # surfaces (each shrink loses one fault domain; two devices must
    # survive to shard anything)
    elastic_max_shrinks: int = 2
    # elastic checkpoint cadence (iterations) for runners that read it
    # from config; individual managers take an explicit `every`
    elastic_ckpt_every: int = 5
    # mid-task checkpoint granularity for LONG parfor groups: a group
    # with at least this many iterations checkpoints after every chunk
    # (a real per-chunk cost: result fetch + atomic file commit), so a
    # requeued group resumes instead of re-running from its start.
    # 0 disables chunk checkpointing; elastic_enabled=False disables it
    # along with the rest of the elastic layer. The default is sized so
    # only genuinely LONG groups pay it.
    elastic_parfor_chunk_iters: int = 16
    # intra-region checkpoints for fused loops: when set, FusedLoop
    # chunks every outermost region's trip count at elastic_ckpt_every
    # iterations and commits the carried state between chunks through a
    # ShardedCheckpointManager rooted in this directory — a mid-region
    # DEVICE_LOSS then resumes from the last chunk instead of losing
    # the whole loop's progress. Empty = off (single-dispatch regions,
    # the pre-elastic behavior; dispatch budgets unchanged).
    elastic_region_ckpt_dir: str = ""
    # multi-host coordination detach (parallel/multihost): after the
    # first completed step of an ElasticRunner loop on a multi-process
    # job, cleanly shut down the jax.distributed client in lockstep so
    # peer/coordinator death cannot fatally terminate survivors from
    # the C++ error-poller (docs/multiprocess.md, failure model). New
    # cross-process collective compiles fail while detached — the
    # first step must warm every executable the loop needs.
    elastic_detach_coordination: bool = True
    # reattach-on-demand budget: how many lockstep re-joins of the
    # unchanged membership (multihost.reattach_coordination) one runner
    # may perform — each is a full backend rebuild + snapshot restore,
    # so a loop whose executable set changes every few steps should fix
    # the workload, not loop through reattaches
    elastic_max_reattaches: int = 2

    # --- serving (api/serving.py) ------------------------------------------
    # bucket ladder for the shape-bucketed compile cache: a request's
    # leading (batch) dimension pads up to the nearest rung, so one
    # cached plan per rung (on the card, one block graph per rung)
    # serves every request size (beyond the top rung: next power-of-two
    # multiple — bounded shape count for unbounded requests). Tune to the
    # deployment's size mix: each rung is one compile + one resident
    # graph.
    serving_bucket_ladder: tuple = (1, 8, 64, 512)
    # micro-batching flush policy (api/serving.MicroBatcher): flush the
    # queued single-row requests when this many rows are waiting...
    serving_microbatch_max: int = 64
    # ...or when the OLDEST queued request has waited this long (µs) —
    # the latency bound a queued request pays for coalescing
    serving_microbatch_deadline_us: float = 2000.0
    # /metrics scrape endpoint (api/serving.MetricsEndpoint around
    # ScoringService.metrics_text): the port serve_metrics() binds
    # when called without an explicit port; 0 = an OS-assigned
    # ephemeral port (read it back from endpoint.port)
    serving_metrics_port: int = 0
    # ...and the address it binds on. The 127.0.0.1 default keeps a
    # single-process deployment private; fleet replicas that must be
    # scrapeable across hosts set "0.0.0.0" (or a specific interface).
    serving_metrics_host: str = "127.0.0.1"
    # bound on the MicroBatcher's pending-row queue: an enqueue that
    # would exceed it raises QueueFullError immediately (backpressure
    # at the door) instead of growing the queue without limit — an
    # unbounded queue under overload turns every request into a
    # deadline miss. 0 disables the bound (pre-overload behavior).
    serving_queue_rows_max: int = 4096

    # --- serving fleet (systemml_tpu/fleet) --------------------------------
    # replica liveness: registrations older than this many seconds of
    # heartbeat silence drop out of the router's live set. The age
    # compares the WRITER's wall clock against the READER's, so this
    # TTL must exceed worst-case inter-host clock skew PLUS the
    # heartbeat cadence — skew past the TTL marks live replicas dead
    # (the offline trace-merge clock offsets cannot help the hot path)
    fleet_liveness_ttl_s: float = 5.0
    # heartbeat cadence for each replica's registration refresh
    fleet_heartbeat_s: float = 0.5
    # hedged requests: fire a duplicate to another replica once the
    # primary has been outstanding longer than this quantile of the
    # OBSERVED request-latency distribution (TVM-style measured
    # thresholds over hand-set constants)...
    fleet_hedge_quantile: float = 0.95
    # ...but only after this many observations; below it (and as a
    # floor above it) the hedge delay is fleet_hedge_floor_s
    fleet_hedge_min_samples: int = 16
    fleet_hedge_floor_s: float = 0.050
    # failover redispatch budget per request: how many routing-epoch
    # bumps one request may ride through before the router gives up
    # (exhaustion means the fleet itself is gone, not one replica)
    fleet_max_redispatch: int = 8
    # pre-agreed per-rank serving ports for rolling updates: entry g-1
    # is the port program generation g binds on (generation-indexed,
    # mirroring distributed_reinit_ports — a retiring generation's
    # listener may still be draining, so ports are consumed once and
    # never reused). Empty = SMTPU_FLEET_PORTS env, else ephemeral.
    fleet_serving_ports: tuple = ()
    # --- overload protection (fleet/admission.py) --------------------
    # per-replica admission gate: maximum concurrently-admitted score
    # requests; request #N+1 is answered 429 + Retry-After BEFORE any
    # scoring work. 0 disables admission control entirely.
    fleet_admission_inflight_max: int = 32
    # admission also predicts the queue wait (queued depth x measured
    # per-request service time from the latency histogram) and rejects
    # when the prediction exceeds the request's remaining deadline
    # scaled by this slack factor (>1 admits optimistically, <1 sheds
    # conservatively)
    fleet_admission_slack: float = 1.0
    # retry/hedge token budget (fleet/admission.RetryBudget): the
    # bucket starts full at the cap; every redispatch or hedge spends
    # one token and every SUCCESS refunds fleet_retry_budget_ratio
    # tokens — under brownout (few successes) retries fail fast with
    # 429 at the caller instead of amplifying the overload. Cap 0
    # disables budgeting (pre-overload unbounded retries).
    fleet_retry_budget_cap: float = 16.0
    fleet_retry_budget_ratio: float = 0.2
    # per-replica circuit breaker (fleet/admission.CircuitBreaker):
    # this many CONSECUTIVE transient failures (5xx / timeouts — NOT
    # connection-level death, which still quarantines immediately)
    # open the circuit; after fleet_breaker_reset_s one half-open
    # probe request is let through — success closes, failure re-opens.
    # Threshold 0 disables the breaker.
    fleet_breaker_threshold: int = 3
    fleet_breaker_reset_s: float = 1.0

    # --- observability (systemml_tpu/obs) ----------------------------------
    # device-time profiling at the dispatch sites (obs/profile.py):
    # off = no fences, zero dispatch-path overhead (the default);
    # sample = fence every profile_sample_every-th dispatch per site —
    # device-time attribution at bounded sync cost, warm-path dispatch
    # count unchanged; full = fence every dispatch (exact attribution;
    # serializes the async dispatch pipeline — diagnosis runs only).
    # Fences only engage while a flight recorder is installed (-profile
    # / -trace / obs.session): without one there is nothing to
    # attribute, so the hot path stays untouched either way.
    profile_mode: str = "off"  # off | sample | full
    profile_sample_every: int = 8
    # flight-recorder ring-buffer capacity (events). The recorder keeps
    # the most RECENT trace_max_events events; older ones are evicted
    # and counted in dropped_events, so long serving runs can leave
    # -trace on without unbounded memory growth. Exporters annotate the
    # truncation.
    trace_max_events: int = 1_000_000
    # fleet observability (obs/fleet.py): a SHARED directory every
    # process of a multi-host job can write to. When set, each rank
    # streams its trace events into a per-rank JSONL shard
    # (shard_r<orig>.jsonl) and can drop its metrics snapshot next to
    # it; `scripts/fleet_trace.py <dir>` merges the shards into one
    # clock-aligned Chrome timeline with a failover storyline and a
    # straggler report, and rank 0's `-stats` appends the fleet rollup.
    # Empty = per-process observability only (the pre-fleet behavior).
    obs_fleet_dir: str = ""

    # --- services ----------------------------------------------------------
    stats: bool = False
    stats_max_heavy_hitters: int = 10
    explain: str = "none"  # none | hops | runtime | recompile
    scratch_dir: str = "scratch_space"
    # persistent XLA compilation cache (reference analog: the Spoof plan
    # cache persists compiled classes per JVM, SpoofCompiler.java:162 —
    # here the cache survives PROCESSES, so a re-run of a compiled-once
    # script skips XLA entirely). Empty string disables.
    xla_cache_dir: str = "~/.cache/systemml_tpu/xla"

    # --- distribution ------------------------------------------------------
    # mesh axis sizes for MESH exec; empty = use all local devices on one axis
    mesh_shape: Optional[dict] = None  # e.g. {"dp": 4, "tp": 2}
    # multi-host SPMD (jax.distributed multi-controller; reference analog:
    # connecting to the Spark cluster manager). Set coordinator to
    # "host:port" on every process to join one job; one sharded op then
    # spans hosts with collectives over DCN (parallel/multihost.py)
    distributed_coordinator: Optional[str] = None
    distributed_num_processes: int = 1
    distributed_process_id: int = 0
    # pre-agreed coordinator ports for survivor re-initialization after
    # a peer dies (multihost.reinit_distributed): one entry per reform
    # generation, identical on every process. Empty = SMTPU_REINIT_PORTS
    # env, else old coordinator port + generation. Needed because the
    # old port can die with the old coordinator, and survivors cannot
    # negotiate a new one through the service being replaced.
    distributed_reinit_ports: tuple = ()
    # one host per ORIGINAL process rank (multi-machine jobs): after a
    # coordinator death the elected survivor must BIND the new
    # coordination service on ITS OWN machine — the old coordinator
    # address is a dead host. Empty = reuse the old coordinator's host
    # (correct on the single-machine fixture, or when the incumbent
    # survives and is re-elected).
    distributed_peer_hosts: tuple = ()
    # barrier timeout (seconds) for every jax.distributed.initialize a
    # join/re-join performs: a re-init whose peer died MID-BARRIER must
    # raise (so the second-death reform state machine can re-elect over
    # the still-surviving set) instead of blocking on jax's 300 s
    # default. Env SMTPU_INIT_TIMEOUT_S overrides (the test fixture
    # shortens it).
    distributed_init_timeout_s: int = 60
    # overlapped DCN collectives (parallel/overlap.py): "bucketed"
    # splits every psum over a hierarchical ("dcn", inner) mesh axis
    # into the intra-host reduction followed by per-bucket cross-host
    # psums that XLA's scheduler can run behind neighboring compute;
    # "off" keeps the monolithic whole-payload collective (today's
    # synchronous barrier). Flat (single-axis) meshes are unaffected
    # either way.
    comm_overlap: str = "bucketed"  # off | bucketed
    # max bytes per cross-host bucket; 0 = auto from the DCN-bandwidth
    # vs launch-overhead split (hops/cost.default_comm_bucket_bytes)
    comm_bucket_bytes: int = 0
    # override the detected per-device memory capacity (bytes) used by the
    # AUTO exec-type decision and the buffer pool; None = HwProfile.detect().
    # Lets tests force mesh/eviction decisions with small synthetic budgets.
    mem_budget_bytes: Optional[float] = None

    # --- buffer pool (reference: caching/CacheableData.java + LazyWriteBuffer
    # + gpu/context/GPUMemoryManager.java) --------------------------------
    # manage symbol-table matrices' device residency with LRU spill
    # device -> host -> disk when the device budget is exceeded
    bufferpool_enabled: bool = True
    # device-resident budget in bytes; None = mem_util_factor * detected HBM
    # (or mem_budget_bytes when set)
    bufferpool_budget_bytes: Optional[float] = None
    # host-RAM budget for evicted copies before spilling to scratch_dir;
    # None = 4x the device budget
    bufferpool_host_budget_bytes: Optional[float] = None
    # arrays smaller than this bypass the pool (tracking overhead dominates)
    bufferpool_min_bytes: int = 65536
    # live-variable analysis: delete symbol-table entries after their last
    # use (reference: LiveVariableAnalysis + rmvar insertion,
    # parser/DMLTranslator.java:167) — frees pool handles eagerly
    liveness_enabled: bool = True
    # dedicated validate pass before HOP construction (reference:
    # DMLTranslator.validateParseTree, parser/DMLTranslator.java:108)
    validate_enabled: bool = True
    # AUTO exec-mode: distribute an op that FITS locally when the cost
    # model predicts at least this speedup (cost.mesh_speedup_estimate);
    # <= 0 keeps the memory-threshold-only rule
    mesh_speedup_threshold: float = 1.5

    def copy(self) -> "DMLConfig":
        return dataclasses.replace(self)

    def set(self, key: str, value: Any) -> None:
        key = key.replace("sysml.", "").replace(".", "_")
        if not hasattr(self, key):
            known = [f.name for f in dataclasses.fields(self)]
            close = difflib.get_close_matches(key, known, n=1, cutoff=0.6)
            raise UnknownConfigKeyError(key, close[0] if close else None)
        setattr(self, key, value)

    @staticmethod
    def from_file(path: str) -> "DMLConfig":
        with open(path) as f:
            d = json.load(f)
        cfg = DMLConfig()
        for k, v in d.items():
            cfg.set(k, v)
        return cfg


# The fields the port reads or checks. Every other field is copied only so
# that config files parse: set to anything but its default it raises
# (check_ported), since it would change nothing here.
PORTED_FIELDS = frozenset({
    "device", "optlevel", "exec_mode", "codegen_enabled", "cla",
    "cla_min_ratio", "blocksize", "floating_point_precision",
    "matmul_precision", "compensated_sum", "sparsity_turn_point",
    "ultra_sparsity_turn_point", "mem_budget_bytes",
    "trace_max_events", "stats_max_heavy_hitters",
    # the profiler (obs/profile.py)
    "profile_mode", "profile_sample_every",
    "liveness_enabled", "validate_enabled",
    # the DNN ops (ops/dnn.py)
    "conv_layout", "conv_algorithm",
    # the buffer pool and the whole-block compile
    # (runtime/bufferpool.py, runtime/blockcompile.py)
    "bufferpool_enabled", "bufferpool_budget_bytes",
    "bufferpool_host_budget_bytes", "bufferpool_min_bytes",
    "mem_util_factor", "loopfuse_donate", "compile_timeout_s",
    # the CLI (api/cli.py)
    "stats", "explain", "scratch_dir",
    # parfor (runtime/parfor.py) and its task retries (resil/)
    "parfor_par", "resil_enabled", "resil_max_attempts",
    "resil_backoff_base_s", "resil_backoff_max_s", "resil_backoff_jitter",
    "fault_injection",
    # the kernel backend and its tuner (codegen/{backend,tune,costmodel}.py)
    "pallas_mode", "codegen_tune_mode", "codegen_tune_trials",
    "codegen_tune_shortlist", "codegen_tune_cache", "codegen_cost_model",
    "codegen_cost_model_min_records",
    # remote parfor (runtime/remote.py)
    "remote_deadline_s",
    # the serving tier (api/serving.py)
    "serving_bucket_ladder", "serving_microbatch_max",
    "serving_microbatch_deadline_us", "serving_metrics_port",
    "serving_metrics_host", "serving_queue_rows_max",
    # the serving fleet (fleet/{replica,router,admission}.py) and its
    # trace directory (obs/fleet.py)
    "fleet_liveness_ttl_s", "fleet_heartbeat_s", "fleet_hedge_quantile",
    "fleet_hedge_min_samples", "fleet_hedge_floor_s",
    "fleet_max_redispatch", "fleet_admission_inflight_max",
    "fleet_admission_slack", "fleet_retry_budget_cap",
    "fleet_retry_budget_ratio", "fleet_breaker_threshold",
    "fleet_breaker_reset_s", "obs_fleet_dir"})

# fields that have no meaning in the port: set to anything but their
# default they raise with the reason
_MEANINGLESS = {
    "xla_cache_dir": "the port compiles no XLA: its kernels are built by "
                     "nvcc into systemml_tpu_torch/_build/",
}

# field-name prefix -> the ROADMAP queue-1 item that brings it
_WAITING = (
    (("donation_sanitizer",),
     "observability and static analysis, its static analysis (item 11b)"),
    # fleet_serving_ports is the port schedule of the JAX package's
    # multihost.scheduled_port, which comes with the multi-process runtime
    (("elastic_", "mesh_", "distributed_", "comm_", "fleet_serving_ports"),
     "distributed and elastic (item 12)"),
)


def check_ported(cfg: DMLConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item that brings it,
    for a setting the port would ignore: a field outside PORTED_FIELDS
    that differs from its default."""
    for f in dataclasses.fields(cfg):
        if f.name in PORTED_FIELDS:
            continue
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        if getattr(cfg, f.name) == default:
            continue
        if f.name in _MEANINGLESS:
            raise NotImplementedError(
                f"config {f.name}={getattr(cfg, f.name)!r}: "
                f"{_MEANINGLESS[f.name]}")
        item = next((item for prefixes, item in _WAITING
                     if f.name.startswith(prefixes)), None)
        raise NotImplementedError(
            f"config {f.name}={getattr(cfg, f.name)!r}: the port does not "
            f"read it yet" + (f"; it waits for ROADMAP queue 1, {item}"
                              if item else ""))


# the fault-injection sites the port runs (resil/inject.py): a parfor
# task, a remote parfor job (runtime/remote.py), and the serving fleet's
# dispatch, hedge, rollout shift, admission and retry-budget spend
# (fleet/{router,rollout,replica}.py); the others belong to the mesh
PORTED_FAULT_SITES = frozenset({"parfor.task", "remote.job", "fleet.route",
                                "fleet.hedge", "fleet.rollout",
                                "fleet.admit", "router.budget"})


def check_fault_sites(spec: str) -> None:
    """Raise NotImplementedError for a fault-injection spec
    ("site:kind[:nth[:count]],...") that arms a site the port does not
    run, so that no armed fault is silently ignored."""
    for part in (spec or "").split(","):
        site = part.strip().split(":")[0]
        if site and site not in PORTED_FAULT_SITES:
            raise NotImplementedError(
                f"fault injection at site {site!r} waits for ROADMAP "
                f"queue 1, distributed and elastic (item 12); the port "
                f"injects at {', '.join(sorted(PORTED_FAULT_SITES))}")


_local = threading.local()
_global_config = DMLConfig()


def get_config() -> DMLConfig:
    return getattr(_local, "config", _global_config)


def set_config(cfg: DMLConfig) -> None:
    _local.config = cfg


def resolve_device(cfg: Optional[DMLConfig] = None):
    """The torch.device of `cfg` (default: the active config). Raises
    when the config asks for CUDA and no card is visible: the port never
    carries on on the CPU behind the caller's back."""
    import torch

    name = (cfg or get_config()).device
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"DMLConfig.device={name!r} but torch.cuda.is_available() is "
            f"False; set device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda | cpu)")
    return dev


def default_dtype(device=None):
    """The value dtype of the configured precision policy on `device`
    (default: the configured device) (systemml_tpu/utils/config.py:472-493):

    - "double": native torch.float64 (no double-float pairs),
    - "single": torch.float32,
    - "auto": fp64 on the CPU (as the JAX package under x64) and fp32 on
      the card (as on the TPU),
    - "bfloat16": fp32, the master weights' dtype of the mixed policy
      (mixed_bf16_enabled: only the matmult and conv families compute
      from bf16 operands)."""
    import torch

    cfg = get_config()
    prec = cfg.floating_point_precision
    if prec == "double":
        return torch.float64
    if prec in ("single", "bfloat16"):
        return torch.float32
    if prec != "auto":
        check_ported(cfg)
        raise ValueError(f"unknown floating_point_precision {prec!r}")
    dev = torch.device(cfg.device if device is None else device)
    return torch.float64 if dev.type == "cpu" else torch.float32


def apply_matmul_precision() -> None:
    """Install the matmul precision policy on torch's global switches.

    "highest" (the default) means true fp32 products: TF32 keeps about
    three decimal digits and would break the fp32 bar of 1e-3, so
    cuBLAS's TF32 path is switched OFF explicitly here rather than
    relying on torch's default. "high" and "default" allow TF32, the
    nearest counterpart of the TPU's reduced-precision MXU passes."""
    import torch

    tf32 = get_config().matmul_precision in ("high", "default")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    # cuDNN may otherwise pick a backward-filter algorithm that sums with
    # atomics, and a loop region's run would not repeat its eager run bit
    # for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def mixed_bf16_enabled() -> bool:
    """True under the "bfloat16" policy (systemml_tpu/utils/config.py
    :495-500): the matmult and conv families compute from bf16 operands
    with fp32 accumulation and an fp32 result; storage stays fp32."""
    return get_config().floating_point_precision == "bfloat16"


def bf16_operands(*xs):
    """The operands of a matmult- or conv-family op under the active
    policy. Under "bfloat16" each floating operand is rounded to bf16
    and carried back in its own dtype: the product of two bf16 values is
    exact in fp32, so an fp32 product of the rounded operands is the
    JAX package's bf16 x bf16 -> fp32 (preferred_element_type) result up
    to the order of the fp32 sums, and it keeps fp32 (TF32 is exact on
    bf16-rounded operands). Otherwise the operands are returned as
    they are."""
    import torch

    if not mixed_bf16_enabled():
        return xs
    return tuple(x.to(torch.bfloat16).to(x.dtype)
                 if isinstance(x, torch.Tensor) and x.is_floating_point()
                 and x.dtype != torch.bfloat16 else x for x in xs)
