"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --bench LABEL
    python3 chip_smoke.py --phases
    python3 chip_smoke.py --breadth

The second form times only the spoof kernels K2, K3 and K5, the spoof
wrappers' host time, K6 and LinearRegCG-cla (see `bench`); copied into a
checkout of an earlier tree it runs there too, so two trees compare
within one chip call. The third shows where K6's time goes (see
`phases`). The fourth runs only the algorithm-breadth paths and the
datagen check (phase 3's `[breadth]` and `[datagen]` lines).

Drives the port's paths through systemml_tpu_torch.api.mlcontext.MLContext
on the card, on one X of 2,000,000 x 1,000 fp32 (scripts/perftest scale
L) made on the card from a seeded generator, and holds every kernel of
those paths against its plain PyTorch version. Every path runs its loops
as fused regions (runtime/loopfuse.py; codegen_enabled at its default):
each loop nest one CUDA graph with its predicates on the card
(conditional WHILE and IF nodes, csrc/loop_graph.cu), launched once per
loop entry, or refused for a classified reason and run eagerly:

- LinearRegCG at optlevel 2 (kernel K1, mmchain) and at optlevel 3;
- l2-svm (maxiter 15, labels +-1 from sign(X w + 0.1 noise)) and
  MultiLogReg (moi 10, 5 classes from the quintiles of X w + noise) at
  optlevel 3, where the spoof fusion pass runs their fused plans through
  kernels K2 (the cell template) and K4 (the row template), and at
  optlevel 2 beside them;
- LinearRegCG-cla: LinearRegCG with cla "auto" on a categorical X of
  2,458,285 x 68 fp32 (the Census shape of the CLA evaluation, Elgohary
  et al., VLDB 2016; synthetic: column j takes d_j values, d_j in 2..8,
  uniform codes, dictionary values drawn N(0, 1) and standardised per
  column), which compresses X at loop entry and runs each CG iteration's
  compressed mmchain through kernel K6; beside it the same script with
  cla "false", and l2-svm on the same X with both;
- ALS-CG-ml10m: scripts/algorithms/ALS-CG.dml (rank 10, reg 0.01, maxi
  5, mii 3, the arguments of scripts/perftest/run_perftest.py:216-218) on
  a dense fp32 ratings matrix of the MovieLens 10M shape (GroupLens
  ml-10M100K: 71,567 users x 10,681 movies, 10,000,054 ratings, 1.308%
  dense; synthetic: a Bernoulli pattern at that density, each rating a
  rank-10 product plus noise rounded to half stars in 0.5..5.0), at
  optlevel 3, where its loss check runs the outer-product template
  through kernel K5 and its CG reductions through K2, and at optlevel 2
  (the dense wdivmm arm); then a user's ratings summary (sum, min and max
  of the mean-centred observed ratings) on the same V, which runs the
  multi-aggregate template through kernel K3;
- the algorithm-breadth paths on the same X, with the arguments of
  scripts/perftest/run_perftest.py: LinearRegDS (reg 1e-3, y = X
  beta_true: tsmm and solve once, K2), GLM-poisson (y ~ Poisson(2)
  i.i.d.; dfam 1, vpow 1, link 1, lpow 0, moi 10, tol 1e-8, reg 1e-3)
  and GLM-probit (y ~ Bernoulli(pnorm(X w / sqrt(1000))); dfam 2, link
  3), each IRLS while loop a region (K2), and Kmeans (k 5, maxi 10, runs
  1, samp 50: the k-means++ init runs seq, rexpand, cumsum and seeded
  rand, its for loop refused for C's growing shape; the Lloyd while loop
  a region with rowIndexMax, rowMins and rexpand, K4 and K2);
- minibatch-sgd: the training body of scripts/nn/examples/
  mnist_softmax.dml inlined (MINIBATCH_SGD: batches X[beg:end,] with end
  = beg + bs - 1, a dropout mask drawn with seed 7 + i, 5 one-hot
  classes, bs 1,000, one epoch of 2,000 iterations), its for loop one
  graph whose slices start at a device offset and whose seed is a
  device value; its one fused plan at optlevel 3 a row plan (K4).

Phases:

0. environment: torch and CUDA versions (the runtime and driver that
   conditional graph nodes need: 12.4 or later), the card, its power
   limit;
1. build: the paths' programs are compiled at optlevel 3, each building
   its fused plans (one generated source per plan, csrc/spoof.cuh) as
   compile_program does on the card, while csrc/mmchain.cu and
   csrc/cla_chain.cu build beside them; then the kernel phase's other
   plans, one source per plan and Variant (its aggregates, scalar and
   aliased leaves: every order of AGG_ORDERS is a source); one nvcc per
   source, a program's together; nvcc seconds and ptxas report per source
   and kernel (registers, spills); ALS-CG and the ratings summary build
   theirs (K5's outer plan, K3's multi-aggregate plan, ALS-CG's cell
   plans);
2. each kernel against its plain version: mmchain at the main path's
   shapes and others (normwise relative error against the plain version
   in fp64 on the card, bar 1e-4: fp32 sums over up to 2e6 rows in
   another order); the spoof cell (elementwise and sum) and row (sum, min,
   max) kernels in fp32 and fp64 on l2-svm's 10-leaf plan at
   (2,000,000, 1), MultiLogReg's row plan at (2,000,000, 5), a ragged
   (100,003, 7) plan with (1, n), (m, 1), (1, 1), host-number and 0-d
   leaves, and a plan of every cell op with NaN into min and max, 0 into
   sign and x.5 into round (bars: 1e-5 normwise in fp32 against the
   plain version in fp64, 1e-12 in fp64, NaN at the same places); K6
   against chain_plain in fp64 on the card at the Census shape (68
   groups of up to 8 codes over 2,458,285 rows) and at a ragged
   (100,003, 7) block, every chain type, k = 1 and 4, fp32 and fp64
   (bars 1e-5 and 1e-12 normwise), at the Census shape in fp32 with NaN,
   +Inf and -Inf rows in w and y (NaN and +-Inf in the plain version's
   slots) and with every row of each group on one code, and two blocks
   that K6 refuses by layout (a dictionary of 9, an uncompressed column)
   taking the gather arm, counted, with no launch; K5 against outer_plain
   in fp64 on the
   card at ALS-CG-ml10m's shape (X its 0/1 pattern, rank 10, its loss
   plan) and at a ragged (100,003, 777, r = 3) X, fp32 and fp64 (bars
   1e-5 and 1e-12), with a plan of a host-number and a 0-d scalar leaf,
   and NaN in X; K3 against multiagg_plain likewise, on the ratings
   summary's plan over V and on the ragged and NaN plans above, every
   aggregate order of AGG_ORDERS (one of 10 aggregates); the port's rand() on the card against its rand() on
   the CPU, bit for bit, in fp32 and fp64. Every kernel runs twice: the
   two results must be bit-identical. set_cond, the loop-control kernel
   of csrc/loop_graph.cu, against its plain version: IF nodes and their
   negation on predicates of five dtypes with 0, 1, -2.5 and NaN, each
   flag against pred != 0 on the host;
2b. the region bridge on small scripts (BRIDGE: a zero-trip while, a
   while nested in a while, an if/else in a while, a for in a while, an
   inner loop that runs no iteration in some outer passes), fp64 through
   MLContext on the card and on the CPU (the region executor's plain
   arm), equal within 1e-12; and REENTRY compiled once and run with maxi
   5, 9 and 5: one capture, three graph launches, bit-identical results;
3. the paths, each with every launch counter set to 0 just before it and
   read just after, each followed by a `regions` line (the regions
   planned, captured and refused with their reasons, the graph launches
   and host syncs per loop entry, the trips, the kernel launches per body;
   it fails on a refusal other than Kmeans's init's "shape change", and
   on a region that is not one launch per entry and per print-ring drain,
   a sync per launch and one per while entry; those syncs are also
   counted by torch under sync debug mode "warn", in each region's
   launches, drains and exit and in each entry that met its cache, and
   a `[syncs]` line fails on any difference from the record); LinearRegCG
   at optlevel 2,
   MultiLogReg at 3, l2-svm at 3 and 2 (its 15 printed lines equal the
   eager run's, in order, one per outer iteration of its one region),
   minibatch-sgd at 3, LinearRegCG-cla, and ALS-CG-ml10m at 3, also with
   codegen_enabled False: the region's
   output bit-identical to the eager run's or within 1e-5 normwise, equal
   launch counts of every kernel, ms per iteration in the graph and the
   eager loop's, the busy share (the eager run's kernel time per loop
   period over the graph's ms per iteration), peak memory allocated and
   reserved; LinearRegCG at optlevel 2 (mmchain once per CG
   iteration, beta within 1e-3 of beta_true, peak allocated below twice
   X's bytes; timed without a profiler, a second unprofiled run, two
   runs under torch.profiler and one under cProfile), then LinearRegCG at
   optlevel 3, l2-svm and MultiLogReg at optlevels 3 and 2: the
   templates selected, the kernel launches (at optlevel 3 the cell
   kernel, and for MultiLogReg the row kernel, must launch; no plan may
   take the plain arm by layout and no block may fail to compile; every
   cell and multi-aggregate launch is counted on the flat or the general
   walk, and printed), the
   seconds per outer iteration without a profiler, the difference from
   the optlevel-2 run (bar 1e-3 normwise) and the peak memory; then
   LinearRegCG-cla at optlevel 2 with cla "auto" (X compressed once, K6
   once per CG iteration, cla_chain_plain_by_layout 0, beta within 1e-3
   of the cla "false" run's and of beta_true; its CG loop one graph, run
   again bit for bit and without regions) and "false", and l2-svm on
   the same X with both (w within 1e-3); the loop-entry compression
   (sample, host copy, compress()) is timed apart from the loops;
   ALS-CG-ml10m at optlevels 3 and 2 (at 3: the templates selected, K5
   once per outer iteration, K2 launching, no compile error, the plain
   arm by layout only for the two regularizer plans that the JAX
   package's kernel refuses too; L and R within 1e-3 normwise and the
   loss within 1e-3 of optlevel 2; ms per outer iteration without a
   profiler and the peak allocated memory), then the ratings summary at
   optlevels 3 (K3 once) and 2 (s, lo and hi within 1e-5 relative; s, a
   cancellation near 0, within 1e-6 x sum|Z|); the algorithm-breadth
   paths, each at optlevel 3 with regions and without, and at optlevel
   2 (a `[breadth]` line each: ms per outer iteration in the graph,
   eagerly and at optlevel 2, for LinearRegDS ms for the whole
   execution; K2 and K4 launches with regions and without, which must be
   equal; graph launches and host syncs per loop entry; refusals; peak
   allocated over the data; with regions against without bit-identical
   or within 1e-5 normwise, optlevel 3 within 1e-3 of optlevel 2):
   LinearRegDS's beta within 1e-3 of beta_true, GLM's deviance over its
   IRLS log (the eager run's) non-increasing within 1e-6 relative,
   Kmeans's WCSS non-increasing over its Lloyd iterations (the script's
   first, the rest replayed in fp64 from its first update, a run with
   maxi 1) and its last WCSS within 1e-5 of the replay's (its C_out
   beside the replay's, printed);
   then `[datagen]`: sample(2000000, 5, 7), sample(3000000, 10, TRUE, 7),
   a full permutation of 3,000,000 and seq(1, 2000000, 8000) on the
   card equal to the CPU's draw bit for bit, in fp32 and fp64; then
   `[minibatch]`: minibatch-sgd at optlevel 3 with regions and without
   and at 2 (ms per iteration, launches, host syncs; W with regions
   within 1e-5 of the eager run's or equal; every batch's mask equal to
   the CPU's draw bit for bit), the loop without its dropout
   draw, and one draw alone replayed as a graph;
4. times: each kernel and its plain version at the paths' shapes (CUDA
   events over back-to-back calls; for the spoof kernels, whose calls are
   shorter on the card than on the host, also the device time per call
   from torch.profiler, which K2's and K4's records give with the L2
   cache evicted before each call), the library call that computes the same
   function where there is one, and the least time the card could take
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s fp32, the H100
   SXM's published peaks); K2 also on the cell sum that ALS-CG-ml10m
   launched most, at its own inputs, and on the elementwise arm of the
   summary's plan over V, an (m, n > 1) plan; and the host time of one
   spoof wrapper call (row, cell sum, multi-aggregate);
   the compressed left mult t(X) %*% y at the Census-shaped block, its
   fixed-order segment sums against the bincount they replaced, and one
   group of 65,536 codes, 60% of the rows on one code (`[cla-left]`:
   times, layout bytes, build ms, agreement, repeats bit-identical);
   K6 at the path's own compressed X (CUDA events over back-to-back
   calls, as K1, K3 and K5; beside them the device time per call from
   torch.profiler and the wrapper's host time), on the same
   shape with every row on one code, its plain version, the whole
   compressed chain around it, the gather arm, and as its yardstick the
   two-pass torch.matmul on the dense X (no single torch call computes
   a compressed chain); K5 and K3 at ALS-CG-ml10m's shape against their
   plain versions and bounds, with yardsticks (no single torch call
   computes either): torch.matmul(U, V.T), the unfused route's first
   step, for K5, and the unfused sequence (the plain version) for K3.

The kernels line also has set_cond: its ms the control of a WHILE loop
per iteration inside one graph, its plain_ms the same loop driven from
the host. Prints a {"kernels": [...]} line before the last, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero; without a CUDA
card, or without the repository around it, it exits non-zero before any
result.
"""

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
M, K = 2_000_000, 1_000        # scripts/perftest/run_perftest.py scale L
KERNEL_BAR = 1e-4
SPOOF_BARS = {torch.float32: 1e-5, torch.float64: 1e-12}
# systemml_tpu_torch/codegen/csrc/<name>.cu
KERNEL_SOURCES = ("mmchain", "cla_chain", "loop_graph")
# the Census data of the CLA evaluation (UCI US Census 1990): rows, columns
CENSUS_N, CENSUS_M = 2_458_285, 68
CHAIN_BARS = {torch.float32: 1e-5, torch.float64: 1e-12}
# MovieLens 10M (GroupLens ml-10M100K): users, movies, ratings
ML10M_USERS, ML10M_MOVIES, ML10M_RATINGS = 71_567, 10_681, 10_000_054
# scripts/perftest/run_perftest.py:216-218
ALS_ARGS = {"rank": 10, "reg": 0.01, "maxi": 5, "mii": 3}
# a user's summary of mean-centred observed ratings: one multi-aggregate
# plan at optlevel 3
SUMMARY = ("mu = sum(V) / sum(V != 0)\nZ = (V != 0) * (V - mu)\n"
           "s = sum(Z)\nlo = min(Z)\nhi = max(Z)\n")
# the multi-aggregate's orders: repeats, and more than 8 aggregates (any
# number compiles in)
AGG_ORDERS = (("sum", "min", "max"), ("max", "sum"), ("min",),
              ("min", "min", "sum", "max", "sum", "max", "min", "sum"),
              ("max", "sum", "min") * 3 + ("sum",))
ROOT = os.path.dirname(os.path.abspath(__file__))
ALG = os.path.join(ROOT, "scripts", "algorithms")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def normwise(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm(got.double() - ref) / torch.linalg.norm(ref))


def time_ms(fns, reps: int = 20, warm: int = 3):
    """ms per call of each fn, by CUDA events over `reps` calls after
    `warm` calls, taken in turns (a, b, ..., b, a) and averaged."""
    for fn in fns:
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    acc = [0.0] * len(fns)
    for order in (range(len(fns)), reversed(range(len(fns)))):
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[i]()
            end.record()
            end.synchronize()
            acc[i] += start.elapsed_time(end) / reps / 2
    return acc


class PhaseTimer:
    """Windows of the program's execution, of its while loops, and of the
    set-up inside a loop: a compressed X's loop-entry compression and the
    first builds of its device forms (K6's layout, the mirror of the other
    compressed ops), and a sparse invariant's device views at a region's
    entry, on the host clock and in CUDA events, taken without
    a profiler: for the duration of a with-block it wraps Program.execute,
    WhileBlock.execute and _maybe_auto_compress of the port's runtime,
    chain_layout and device_mirror of compress/device.py (those two are
    cached: only a first call builds) and FusedLoop._views. `windows[label]` lists (host ms,
    device ms, host start, host end, start event, end event) in the order
    the windows close; `compressed` the compressed blocks the compression
    bound."""

    SETUP = ("compress", "layout", "mirror", "views")

    def __init__(self):
        from systemml_tpu_torch.compress import device as cla_dev
        from systemml_tpu_torch.runtime import loopfuse, program
        self._targets = {"execute": (program.Program, "execute"),
                         "loop": (program.WhileBlock, "execute"),
                         "for": (program.ForBlock, "execute"),
                         "compress": (program, "_maybe_auto_compress"),
                         "layout": (cla_dev, "chain_layout"),
                         "mirror": (cla_dev, "device_mirror"),
                         "views": (loopfuse.FusedLoop, "_views"),
                         "capture": (loopfuse.FusedLoop, "_capture"),
                         "launch": (loopfuse.FusedLoop, "_launch")}
        self.windows = {label: [] for label in self._targets}
        self.compressed = []
        self.program = None

    def __enter__(self):
        self._orig = {label: getattr(owner, attr)
                      for label, (owner, attr) in self._targets.items()}
        for label, (owner, attr) in self._targets.items():
            setattr(owner, attr, self._wrap(label, self._orig[label]))
        return self

    def __exit__(self, *exc):
        for label, (owner, attr) in self._targets.items():
            setattr(owner, attr, self._orig[label])
        torch.cuda.synchronize()
        self.windows = {label: [(1e3 * (t1 - t0), e0.elapsed_time(e1), t0,
                                 t1, e0, e1) for t0, t1, e0, e1 in ws]
                        for label, ws in self.windows.items()}

    def _wrap(self, label, orig):
        from systemml_tpu_torch.compress import is_compressed

        def execute(blk, *args, **kwargs):
            if label == "execute":
                self.program = blk
            if torch.cuda.is_current_stream_capturing():
                # a loop nested in a region being captured: no event may
                # enter a conditional node's body
                return orig(blk, *args, **kwargs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            try:
                return orig(blk, *args, **kwargs)
            finally:
                t1 = time.perf_counter()
                e1.record()
                self.windows[label].append((t0, t1, e0, e1))
                if label == "compress":
                    self.compressed += [
                        v for v in args[0].vars.values()
                        if is_compressed(v) and all(
                            v is not c for c in self.compressed)]
        return execute


def profile_main_path(ml, script, host_activity: bool,
                      kernel: str = "mmchain_partial", loop: str = "CG loop"):
    """One more run of the main path under torch.profiler, recording the
    device's activity, and the host's too when `host_activity`. Returns
    (and prints) the device's busy share of the run's wall time (parse and
    compile included), the CG loop's period (median time from one launch
    of `kernel`, the loop body's, to the next) and the busy share inside
    the loop, and device ms by kernel name. Says "not measured" when the
    profiler records no kernels."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    printer, ml.printer = ml.printer, (lambda s: None)
    what = "host and device" if host_activity else "device only"
    activities = [ProfilerActivity.CUDA]
    if host_activity:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        ml.execute(script)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ml.printer = printer
    ks = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if not ks:
        print(f"[profile {what}] the profiler recorded no kernels: device "
              f"busy share not measured")
        return {}
    by_name = {}
    for e in ks:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms}
    starts = [e.time_range.start for e in ks if kernel in e.name]
    if len(starts) >= 2:
        in_loop = sum(e.time_range.elapsed_us() for e in ks
                      if starts[0] <= e.time_range.start < starts[-1])
        out["cg_iteration_ms"] = statistics.median(
            (b - a) / 1e3 for a, b in zip(starts, starts[1:]))
        out["cg_loop_busy_share"] = in_loop / (starts[-1] - starts[0])
    print(f"[profile {what}] main path under torch.profiler: wall {wall_ms:.1f} ms "
          f"(parse and compile included), kernels {device_ms:.1f} ms, device "
          f"busy {100 * out['device_busy_share']:.1f}%")
    if "cg_iteration_ms" in out:
        print(f"[profile {what}] {loop}: {out['cg_iteration_ms']:.3f} ms per "
              f"iteration ({kernel} launch to launch), device busy "
              f"{100 * out['cg_loop_busy_share']:.1f}% inside the loop")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, n) in top:
        print(f"[profile {what}]   {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    out["top_kernels_ms"] = {name[:90]: ms for name, (ms, _) in top}
    if host_activity:
        ops = sorted(prof.key_averages(),
                     key=lambda e: -e.self_cpu_time_total)[:8]
        for e in ops:
            print(f"[profile {what}]   host {e.self_cpu_time_total / 1e3:8.3f}"
                  f" ms own  x{e.count:<4d} {e.key[:80]}")
        out["top_host_ops_ms"] = {e.key[:80]: e.self_cpu_time_total / 1e3
                                  for e in ops}
    return out


def host_profile(ml, script) -> dict:
    """One more run of the main path with cProfile on during the program's
    execution (parse and compile left out): the Python functions that take
    the host's time, by their own time. Prints and returns the top 12."""
    import cProfile
    import pstats

    from systemml_tpu_torch.runtime import program

    prof = cProfile.Profile()
    orig = program.Program.execute

    def execute(*args, **kwargs):
        prof.enable()
        try:
            return orig(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            prof.disable()

    printer, ml.printer = ml.printer, (lambda s: None)
    program.Program.execute = execute
    try:
        ml.execute(script)
    finally:
        program.Program.execute = orig
        ml.printer = printer
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:12]
    out = {}
    for (path, line, fn), (_, calls, own, cum, _) in rows:
        where = (os.path.relpath(path, ROOT) if path.startswith(ROOT)
                 else os.path.basename(path))
        name = f"{where}:{line} {fn}"
        print(f"[cprofile] {1e3 * own:8.3f} ms own {1e3 * cum:8.3f} ms "
              f"cumulative x{calls:<5d} {name[:90]}")
        out[name[:90]] = 1e3 * own
    return out


def phase_windows(timer: PhaseTimer, iters: int, label: str,
                  loop: str = "CG loop") -> dict:
    """An unprofiled run's execution split into the prologue before its
    outer loop, the loop (the longest while-loop window, less the set-up
    windows of a compressed X inside it: its compression at loop entry
    and the first builds of its device forms) and the epilogue after it,
    each on the host clock and in device time between CUDA events; and
    that set-up apart. Prints and returns them."""
    (ex_h, ex_d, ex_t0, ex_t1, ex_e0, ex_e1), = timer.windows["execute"]
    # a script without a while loop: its longest for loop, or its whole
    # execution, is the "loop"
    lp_h, lp_d, lp_t0, lp_t1, lp_e0, lp_e1 = max(
        timer.windows["loop"] or timer.windows["for"]
        or timer.windows["execute"])
    comp = [w for label in PhaseTimer.SETUP for w in timer.windows[label]
            if lp_t0 <= w[2] and w[3] <= lp_t1]
    comp_h, comp_d = sum(w[0] for w in comp), sum(w[1] for w in comp)
    lp_h, lp_d = lp_h - comp_h, lp_d - comp_d
    out = {"execute_host_ms": ex_h, "execute_device_window_ms": ex_d,
           "prologue_host_ms": 1e3 * (lp_t0 - ex_t0),
           "prologue_device_window_ms": ex_e0.elapsed_time(lp_e0),
           "loop_host_ms": lp_h, "loop_device_window_ms": lp_d,
           "compress_host_ms": comp_h, "compress_device_window_ms": comp_d,
           "epilogue_host_ms": 1e3 * (ex_t1 - lp_t1),
           "epilogue_device_window_ms": lp_e1.elapsed_time(ex_e1),
           "iteration_ms": lp_d / max(iters, 1),
           "iteration_host_ms": lp_h / max(iters, 1)}
    print(f"[windows] {label}, host clock / device window between "
          f"CUDA events: execution {ex_h:.3f} / {ex_d:.3f} ms = prologue "
          f"{out['prologue_host_ms']:.3f} / "
          f"{out['prologue_device_window_ms']:.3f} + loop-entry "
          f"compression and device layouts {comp_h:.3f} / {comp_d:.3f} + "
          f"{loop} {lp_h:.3f} / "
          f"{lp_d:.3f} + epilogue {out['epilogue_host_ms']:.3f} / "
          f"{out['epilogue_device_window_ms']:.3f}; {loop} "
          f"{out['iteration_ms']:.3f} ms per iteration over {iters}")
    return out


def device_ms(fn, reps: int = 50, cold: bool = False) -> float:
    """Device time per call of fn: the kernels the card ran for `reps`
    calls under torch.profiler (device activity only), summed, over
    `reps`. A call whose host time exceeds its device time leaves the card
    idle between calls; CUDA events around the calls would measure the
    host then, this measures the card. With `cold`, a 128 MB write before
    each call evicts the 50 MB L2 cache (inputs of tens of MB stay in it
    across back-to-back calls), and only the spoof kernels count. NaN
    when the profiler records no kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(32 * 2**20, device="cuda") if cold else None
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if cold:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (not cold or "spoof" in e.name))
    return us / 1e3 / reps if us else float("nan")


def _kernel_name(line: str) -> str:
    """A ptxas "Compiling entry function" line's kernel, shortened: its
    name in spoof.cuh (or the mangled symbol's head) and its dtype."""
    import re

    sym = line.split("'")[1] if "'" in line else line
    m = re.match(r"_ZN5spoof\d+([A-Za-z_]+?)I([fd])", sym)
    if m:
        return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}>"
    return sym[:60]


def print_build_reports(build, only: str = "") -> None:
    """Per source (those whose name starts with `only`), nvcc's seconds
    and ptxas's report by kernel: registers, spills, stack, shared
    memory."""
    for src, (secs, report) in sorted(build.build_reports.items()):
        if not src.startswith(only):
            continue
        rows, name = [], None
        for ln in report.splitlines():
            if "Compiling entry function" in ln:
                name = _kernel_name(ln)
            elif name and ("registers" in ln or "spill" in ln):
                rows.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
        print(f"[build] {src}: nvcc {secs:.1f} s, {len(rows)} ptxas lines")
        for row in rows:
            print(f"[build]   {row}")
    sys.stdout.flush()


# --------------------------------------------------------------------------
# the paths
# --------------------------------------------------------------------------

def make_data(dev):
    """X (M, K) fp32 and every script's targets, from one seeded
    generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=gen, device=dev)
    beta_true = torch.randn(K, 1, generator=gen, device=dev)
    w_svm = torch.randn(K, 1, generator=gen, device=dev)
    z = x @ w_svm + 0.1 * torch.randn(M, 1, generator=gen, device=dev)
    y_svm = torch.where(z >= 0, 1.0, -1.0)
    w_mlr = torch.randn(K, 1, generator=gen, device=dev)
    z = x @ w_mlr + torch.randn(M, 1, generator=gen, device=dev)
    ranks = torch.argsort(torch.argsort(z[:, 0]))
    y_mlr = (1 + (ranks * 5) // M).to(torch.float32).reshape(-1, 1)
    # GLM's targets: Poisson(2) counts, i.i.d.; and probit labels,
    # Bernoulli(pnorm(X w / sqrt(K)))
    y_pois = torch.poisson(torch.full((M, 1), 2.0, device=dev),
                           generator=gen)
    w_probit = torch.randn(K, 1, generator=gen, device=dev)
    p = torch.special.ndtr(x @ w_probit / math.sqrt(K))
    y_probit = (torch.rand(M, 1, generator=gen, device=dev) < p).to(
        torch.float32)
    return {"X": x, "beta_true": beta_true, "y": x @ beta_true,
            "Y_svm": y_svm, "Y_mlr": y_mlr, "y_pois": y_pois,
            "y_probit": y_probit,
            "Y_onehot": torch.nn.functional.one_hot(
                y_mlr[:, 0].long() - 1, 5).to(torch.float32)}


# name -> (script, inputs from make_data, args, output, what a line of its
# output says about its outer iterations, the loop's name); the last four
# are the algorithm-breadth paths, with scripts/perftest/run_perftest.py's
# arguments (regression1, regression2, clustering; Kmeans with verb 1, so
# that it prints its iterations)
PATHS = {
    "LinearRegCG": ("LinearRegCG.dml", {"X": "X", "y": "y"},
                    {"maxi": 20, "tol": 1e-9, "reg": 1e-6}, "beta",
                    "LinearRegCG: iterations = ", "CG loop"),
    "l2-svm": ("l2-svm.dml", {"X": "X", "Y": "Y_svm"}, {"maxiter": 15}, "w",
               "l2-svm: iter ", "outer loop"),
    "MultiLogReg": ("MultiLogReg.dml", {"X": "X", "Y_vec": "Y_mlr"},
                    {"moi": 10}, "B",
                    "MultiLogReg: Newton iterations = ", "Newton loop"),
    "LinearRegDS": ("LinearRegDS.dml", {"X": "X", "y": "y"}, {"reg": 1e-3},
                    "beta", None, "whole script"),
    "GLM-poisson": ("GLM.dml", {"X": "X", "y": "y_pois"},
                    {"dfam": 1, "vpow": 1.0, "link": 1, "lpow": 0.0,
                     "moi": 10, "tol": 1e-8, "reg": 1e-3}, "beta",
                    "GLM: IRLS iterations = ", "IRLS loop"),
    "GLM-probit": ("GLM.dml", {"X": "X", "y": "y_probit"},
                   {"dfam": 2, "link": 3, "moi": 10, "tol": 1e-8,
                    "reg": 1e-3}, "beta",
                   "GLM: IRLS iterations = ", "IRLS loop"),
    "Kmeans": ("Kmeans.dml", {"X": "X"},
               {"k": 5, "maxi": 10, "runs": 1, "verb": 1}, "C_out",
               "Kmeans run 1: WCSS = ", "Lloyd loop"),
    "minibatch-sgd": (None, {"X": "X", "Y": "Y_onehot"},
                      {"bs": 1000, "lr": 0.2}, "W",
                      "minibatch-sgd: iterations = ", "SGD loop"),
}
# the training body of scripts/nn/examples/mnist_softmax.dml (affine,
# softmax, cross-entropy and SGD of scripts/nn/layers/, inlined) with
# end = beg + bs - 1, and inverted dropout on each batch's rows
# (scripts/nn/layers/dropout.dml) from a seed that changes with i: the
# slices at a device offset, the loop-varying seed, one epoch; W starts
# at 0 (rand(pdf="normal") waits for queue 1 item 8)
# its one fused plan at optlevel 3, a row template (K4): dscores' row sum
MINIBATCH_ROW_PLAN = (
    "b(*)(b(/)(u(-)(b(/)(i0, b(+)(b(/)(u(exp)(b(-)(b(+)(i1, i2), i3)), "
    "i4), 1e-10))), 1000.0), b(/)(u(exp)(b(-)(b(+)(i5, i6), i7)), i8))")
MINIBATCH_SGD = """
bs = $bs
lr = $lr
N = nrow(X)
D = ncol(X)
K = ncol(Y)
W = matrix(0, rows=D, cols=K)
b = matrix(0, rows=1, cols=K)
iters = N %/% bs
masks = matrix(0, rows=iters, cols=bs)
for (i in 1:iters) {
  beg = (i-1)*bs + 1
  end = beg + bs - 1
  X_batch = X[beg:end,]
  Y_batch = Y[beg:end,]
  mask = rand(rows=bs, cols=1, min=1, max=1, sparsity=0.9, seed=7 + i)
  Xd = X_batch * mask / 0.9
  scores = Xd %*% W + b
  e = exp(scores - rowMaxs(scores))
  probs = e / rowSums(e)
  dprobs = -(Y_batch / (probs + 1e-10)) / bs
  dscores = probs * (dprobs - rowSums(dprobs * probs))
  dW = t(Xd) %*% dscores
  db = colSums(dscores)
  W = W - lr * dW
  b = b - lr * db
  masks[i, ] = t(mask)
}
print("minibatch-sgd: iterations = " + iters)
"""
# its dropout draw (a variant without it shows the draw's share)
MINIBATCH_MASK = ("mask = rand(rows=bs, cols=1, min=1, max=1, sparsity=0.9, "
                  "seed=7 + i)")
# the paths of PR 1-2, and the algorithm-breadth paths
DENSE_PATHS = ("LinearRegCG", "l2-svm", "MultiLogReg")
BREADTH_PATHS = ("LinearRegDS", "GLM-poisson", "GLM-probit", "Kmeans")
# each path's output shape, where it is not K rows
OUT_SHAPES = {"Kmeans": (5, K)}
# paths whose fused plans may take the plain arm by layout, and why: the
# JAX package's kernel refuses the same leaf layouts (its jnp arm)
PLAIN_BY_LAYOUT = {
    "Kmeans": "D = row_norms - 2 * (X %*% t(C)) + t(rowSums(C ^ 2)) is a "
              "row plan whose (m, 1) main leaf stands beside the (m, k) "
              "distances"}


def path_script(name, data, rows=None, args=None, extra=(), src=None):
    """The path's script with its inputs; `src` replaces an inline
    script's text (minibatch-sgd's)."""
    from systemml_tpu_torch.api.mlcontext import dml, dmlFromFile

    script, inputs, path_args, out, _, _ = PATHS[name]
    s = (dml(src or MINIBATCH_SGD) if script is None
         else dmlFromFile(os.path.join(ALG, script)))
    for k, v in inputs.items():
        s.input(k, data[v] if rows is None else data[v][:rows])
    for k, v in dict(path_args, **(args or {})).items():
        s.arg(k, v)
    return s.output(out, *extra)


def outer_iterations(name, lines) -> int:
    marker = PATHS[name][4]
    if marker is None:
        return 1          # no loop: the whole execution is one unit
    hits = [s for s in lines if s.startswith(marker)]
    if name == "l2-svm":
        return len(hits)
    if not hits:
        fail(f"{name} printed no iteration count")
    if name == "Kmeans":  # "Kmeans run 1: WCSS = w (n iters)"
        return int(hits[-1].rsplit("(", 1)[1].split()[0])
    return int(hits[-1].split(marker)[1].split(",")[0])


def config(optlevel: int, regions: bool = True):
    from systemml_tpu_torch.utils.config import DMLConfig

    cfg = DMLConfig()
    cfg.optlevel = optlevel
    cfg.codegen_enabled = regions
    return cfg


# the one reason each path's loop may be refused for, by its class (the
# text before any colon): Kmeans's k-means++ init loop grows C by a row
# each iteration (C = rbind(C, S[pick, ])), which is what makes the JAX
# package's own fused loop fall back; its Lloyd while loop is a region.
# The rest run whole: l2-svm's outer loop with its print (the device
# ring), LinearRegCG-cla's CG loop over the compressed X
REFUSAL = {"Kmeans": "shape change"}
# paths without a loop: no region to run
NO_LOOP = ("LinearRegDS",)
# paths whose fused plans at optlevel 3 are row plans only (K4, no K2)
ROW_ONLY = ("minibatch-sgd",)
# paths whose printed lines with regions must equal the eager run's
PRINTS = ("l2-svm",)


def region_report(timer: PhaseTimer, label: str, path: str,
                  regions: bool, may_refuse: str = None) -> dict:
    """What the region executor recorded in the run `timer` watched
    (runtime/loopfuse.region_report of the program it executed): the
    regions planned, captured and refused with their reasons, the graph
    launches and host syncs per loop entry, the trips, and the kernel
    launches per body of the last launch; the capture's host time and
    the launches' device windows. Prints one `regions` line, and fails
    when a region is refused for anything but REFUSAL[path], when a
    region that runs is not one launch and two host syncs per entry, or
    when a run without regions planned any. `may_refuse`: a reason a
    region of the path may be refused for, but need not be."""
    from systemml_tpu_torch.runtime import loopfuse

    rep = loopfuse.region_report(timer.program)
    if not regions:
        if rep:
            fail(f"{label}: codegen_enabled is False, yet {len(rep)} regions")
        return {}
    refused = {r["label"]: r.get("refused") or r["planned_refused"]
               for r in rep if r.get("refused") or r["planned_refused"]}
    want = REFUSAL.get(path)
    for lab, why in refused.items():
        if why.split(":")[0] != want and why != may_refuse:
            fail(f"{label}: region {lab} refused ({why!r}); the only reason "
                 f"this path may be refused for is {want!r}")
    if want is not None and not refused:
        fail(f"{label}: no region refused, {want!r} expected")
    ran = [r for r in rep if r.get("entries") and r["label"] not in refused]
    if path in NO_LOOP and rep:
        fail(f"{label}: {len(rep)} regions planned in a script without loops")
    if path not in REFUSAL and path not in NO_LOOP and not ran:
        fail(f"{label}: no region ran")
    if path == "Kmeans" and not ran:
        fail(f"{label}: the Lloyd while loop did not run as a region")
    for r in ran:
        # a launch per entry that ran an iteration, and one per drain of
        # the print ring; a sync per launch, and per while entry its test
        runs = [t for t in r["trips"] if t]
        tests = r["entries"] if r["label"].startswith("while") else 0
        if r["launches"] != len(runs) + r["drains"] or r["host_syncs"] - \
                r["static_reads"] != tests + r["launches"]:
            fail(f"{label}: region {r['label']}: {r['launches']} graph "
                 f"launches, {r['drains']} drains and {r['host_syncs']} "
                 f"host syncs in {r['entries']} entries")
    cap_ms = sum(w[0] for w in timer.windows["capture"])
    launch_ms = sum(w[1] for w in timer.windows["launch"])
    graph_trips = sum(sum(r["trips"]) - r["captures"] for r in ran)
    out = {"planned": sum(1 for r in rep if not r["inlined"]),
           "captured": sum(r.get("captures", 0) for r in rep),
           "refused": refused,
           "entries": sum(r.get("entries", 0) for r in rep),
           "graph_launches": sum(r.get("launches", 0) for r in rep),
           "drains": sum(r.get("drains", 0) for r in rep),
           "host_syncs": sum(r.get("host_syncs", 0) for r in rep),
           "capture_host_ms": cap_ms, "launch_device_ms": launch_ms,
           "graph_trips": graph_trips,
           "graph_iteration_ms": launch_ms / graph_trips if graph_trips
           else float("nan"),
           "regions": [{k: r.get(k) for k in ("label", "entries", "captures",
                                              "launches", "drains",
                                              "host_syncs", "static_reads",
                                              "trips", "bodies", "nodes",
                                              "views")}
                       for r in rep if r.get("entries")]}
    per = "; ".join(
        f"{r['label']}: {r['entries']} entries, "
        f"{r['launches'] / r['entries']:.2f} graph launches, "
        f"{r['drains'] / r['entries']:.2f} print-ring drains and "
        f"{r['host_syncs'] / r['entries']:.2f} host syncs per entry "
        f"({r['static_reads']} of them reads of shape invariants), trips "
        f"{r['trips'][:6]}{'...' if len(r['trips']) > 6 else ''}, kernel "
        f"launches per body {r.get('bodies')}"
        for r in out["regions"])
    print(f"[regions] {label}: planned {out['planned']}, captured "
          f"{out['captured']}, refused {refused or 'none'}; {per}; capture "
          f"{cap_ms:.1f} ms host; graph launches {launch_ms:.3f} ms device "
          f"over {graph_trips} iterations in graphs "
          f"({out['graph_iteration_ms']:.3f} ms per iteration)", flush=True)
    return out


class SyncAudit:
    """Holds the region executor's record["host_syncs"] to the
    synchronizing CUDA calls that torch reports under
    torch.cuda.set_sync_debug_mode("warn"), in two scopes of each region
    that runs: FusedLoop._loop (the launches, the print ring's drains,
    the exit), and a whole FusedLoop._enter that met its cache (no peel
    or capture, whose uploads of set-up data are synchronous copies).
    In each, the calls torch saw must equal the calls the record counted;
    a nested region's calls are its own. `finish` prints one `[syncs]`
    line and fails on any difference."""

    SYNC = "called a synchronizing CUDA operation"

    def __init__(self):
        from systemml_tpu_torch.runtime import loopfuse

        self.cls = loopfuse.FusedLoop
        self.orig = {m: getattr(self.cls, m) for m in ("_enter", "_loop")}
        self.stack = []
        self.calls = {m: 0 for m in self.orig}
        self.seen = {m: 0 for m in self.orig}
        self.bad = []
        for m, fn in self.orig.items():
            setattr(self.cls, m, self._wrap(m, fn))

    def _wrap(self, m, fn):
        import warnings

        audit = self

        def wrapped(fl, *args, **kwargs):
            rec = fl.record
            h0, c0 = rec["host_syncs"], rec["captures"]
            frame = {"fl": fl, "seen": 0}
            audit.stack.append(frame)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = fn(fl, *args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
                audit.stack.pop()
            for w in caught:
                if audit.SYNC in str(w.message):
                    frame["seen"] += 1
                else:
                    warnings.showwarning(w.message, w.category, w.filename,
                                         w.lineno)
            if audit.stack and audit.stack[-1]["fl"] is fl:
                audit.stack[-1]["seen"] += frame["seen"]
            counted = rec["host_syncs"] - h0
            if rec.get("refused") is None and (
                    m == "_loop" or rec["captures"] == c0):
                audit.calls[m] += 1
                audit.seen[m] += frame["seen"]
                if frame["seen"] != counted:
                    lab = getattr(getattr(fl, "region", None), "label", "?")
                    audit.bad.append(f"{m} of {lab}: torch saw "
                                     f"{frame['seen']} synchronizing calls, "
                                     f"the record counted {counted}")
            return out

        return wrapped

    def finish(self) -> dict:
        for m, fn in self.orig.items():
            setattr(self.cls, m, fn)
        print(f"[syncs] synchronizing CUDA calls (sync debug mode warn) in "
              f"{self.calls['_loop']} region loops (launches, drains, exit): "
              f"{self.seen['_loop']}; in {self.calls['_enter']} whole entries "
              f"that met their cache: {self.seen['_enter']}; differences "
              f"from the records' host_syncs: {self.bad or 'none'}",
              flush=True)
        if self.bad:
            fail(f"host_syncs miscounted: {self.bad[:3]}")
        return {"loops": self.calls["_loop"], "loop_syncs": self.seen["_loop"],
                "cached_entries": self.calls["_enter"],
                "cached_entry_syncs": self.seen["_enter"]}


def compare_eager(label: str, reg: dict, eag: dict, key: str = "out"):
    """A run with regions against the same run without: its output bit for
    bit, or within 1e-5 normwise (fp32; the sums under a capture may run in
    another order), and every kernel's launch count equal. Prints the ms
    per iteration of both, the region's busy share (the eager run's kernel
    time per loop period over the region's ms per iteration in its graph)
    and the peak memory."""
    a, b = reg[key], eag[key]
    same = bool(torch.equal(a, b))
    diff = float(torch.linalg.norm(a.double() - b.double())
                 / torch.linalg.norm(b.double()))
    la = {k: v for k, v in reg["launches"].items() if k != "set_cond"}
    lb = {k: v for k, v in eag["launches"].items() if k != "set_cond"}
    gi = reg["regions"].get("graph_iteration_ms", float("nan"))
    prof = eag.get("profile") or {}
    busy = (prof["cg_loop_busy_share"] * prof["cg_iteration_ms"] / gi
            if "cg_iteration_ms" in prof and gi == gi else float("nan"))
    out = {"bit_identical": same, "normwise": diff,
           "iteration_ms_regions": gi,
           "iteration_ms_regions_with_peel_and_capture":
               reg["windows"]["iteration_ms"],
           "iteration_ms_eager": eag["windows"]["iteration_ms"],
           "busy_share_regions": busy,
           "busy_share_eager": prof.get("cg_loop_busy_share"),
           "peak_allocated": (reg["peak_bytes"], eag["peak_bytes"]),
           "peak_reserved": (reg["peak_reserved"], eag["peak_reserved"])}
    print(f"[eager] {label}: with regions / without: bit-identical {same}, "
          f"normwise {diff:.3e} (bar 1e-5 where not bit-identical); ms per "
          f"iteration {gi:.3f} in the graph "
          f"({reg['windows']['iteration_ms']:.3f} with the peeled iteration "
          f"and the capture) / {eag['windows']['iteration_ms']:.3f}; busy "
          f"share {100 * busy:.1f}% / "
          f"{100 * (prof.get('cg_loop_busy_share') or float('nan')):.1f}%; "
          f"peak allocated {reg['peak_bytes'] / 1e9:.3f} / "
          f"{eag['peak_bytes'] / 1e9:.3f} GB, reserved "
          f"{reg['peak_reserved'] / 1e9:.3f} / "
          f"{eag['peak_reserved'] / 1e9:.3f} GB; launches {la} / {lb}",
          flush=True)
    if not same and not diff <= 1e-5:
        fail(f"{label}: with regions {diff} from without (bar 1e-5)")
    if la != lb:
        fail(f"{label}: kernel launches with regions {la}, without {lb}")
    if label.split()[0] in PRINTS:
        same_lines = reg["lines"] == eag["lines"]
        print(f"[eager] {label}: {len(reg['lines'])} lines printed with "
              f"regions (the print ring), {len(eag['lines'])} without, equal "
              f"in order {same_lines}", flush=True)
        if not same_lines:
            fail(f"{label}: the lines printed with regions differ from the "
                 f"eager run's")
        out["lines_equal"] = same_lines
    return out


def check_print_lines(label, run) -> None:
    """A region run of a path that prints once per outer iteration: one
    line per iteration of its outer region (the lines come through the
    print ring after each launch)."""
    top = [r for r in run["regions"]["regions"] if r["label"].endswith("@0")]
    trips = sum(sum(r["trips"]) for r in top)
    drains = sum(r["drains"] for r in top)
    print(f"[regions] {label}: {len(run['lines'])} lines printed over "
          f"{trips} iterations of the outer region, {drains} drains of "
          f"its print ring", flush=True)
    if len(top) != 1 or len(run["lines"]) != trips:
        fail(f"{label}: {len(run['lines'])} lines over {trips} iterations "
             f"of {len(top)} outer regions")


def minibatch_paths(data, dev, kernels) -> dict:
    """minibatch-sgd on the dense X: optlevel 3 with regions and without,
    optlevel 2 with regions. W with regions within 1e-5 normwise of the
    eager run (or equal), the launches equal; each run's per-iteration
    masks, all 2,000 as the script's `masks` rows, equal to the CPU's
    draw for the same seeds, bit for bit."""
    from systemml_tpu_torch.ops import datagen

    name = "minibatch-sgd"
    extra = ("masks",)
    runs = {"optlevel3": run_path(name, 3, data, dev, kernels, extra=extra),
            "optlevel3_eager": run_path(name, 3, data, dev, kernels,
                                        regions=False, extra=extra),
            "optlevel2": run_path(name, 2, data, dev, kernels, extra=extra)}
    out = {"versus_eager": compare_eager(f"{name} optlevel 3",
                                         runs["optlevel3"],
                                         runs["optlevel3_eager"])}
    bs = PATHS[name][2]["bs"]
    iters = M // bs
    masks = [datagen.rand(bs, 1, 1.0, 1.0, 0.9, seed=7 + i,
                          dtype=torch.float32, device="cpu")
             for i in range(1, iters + 1)]
    want = torch.cat(masks, 1).T
    for label, r in runs.items():
        got = r["extra"]["masks"].cpu()
        same = bool(torch.equal(got, want))
        a = r["out"].double()
        diff = float(torch.linalg.norm(a - runs["optlevel3_eager"]["out"]
                                       .double()) / torch.linalg.norm(a))
        print(f"[minibatch] {label}: {r['iterations']} iterations, "
              f"{r['windows']['iteration_ms']:.4f} ms per iteration; masks "
              f"(all {iters}, bit for bit) equal to the CPU's "
              f"draw {same}; |W - W eager optlevel 3| / |W| {diff:.3e}; "
              f"launches {r['launches']}; regions "
              f"{r['regions'].get('graph_launches')} graph launches, "
              f"{r['regions'].get('host_syncs')} host syncs", flush=True)
        if not same:
            fail(f"{name} {label}: the dropout masks differ from the CPU's")
        if r["iterations"] != iters:
            fail(f"{name} {label}: {r['iterations']} iterations, not {iters}")
        if not diff <= 1e-3:
            fail(f"{name} {label}: W is {diff} from the eager run's")
        out[label] = {k: v for k, v in r.items()
                      if k not in ("out", "lines", "extra")}
    # where the graph's time goes: the loop without its dropout draw, and
    # one draw (threefry as torch integer ops) replayed as a graph alone
    plain = run_path(name, 3, data, dev, kernels, src=MINIBATCH_SGD.replace(
        MINIBATCH_MASK, "mask = matrix(1, rows=bs, cols=1)"))
    seed = torch.full((), 7 + iters, dtype=torch.int64, device=dev)
    draw = lambda: datagen.rand(bs, 1, 1.0, 1.0, 0.9, seed=seed,
                                dtype=torch.float32, device=dev)
    draw()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mask = draw()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(mask.cpu(), masks[-1]):
        fail(f"{name}: a draw replayed as a graph differs from the CPU's")
    draw_graph_ms, draw_eager_ms = time_ms([graph.replay, draw])
    it = runs["optlevel3"]["regions"]["graph_iteration_ms"]
    it_plain = plain["regions"]["graph_iteration_ms"]
    print(f"[minibatch] where the graph's time goes: {it:.4f} ms per "
          f"iteration, {it_plain:.4f} without the dropout draw; one draw "
          f"of a ({bs}, 1) mask from a device seed {draw_graph_ms:.4f} ms "
          f"replayed as a graph alone, {draw_eager_ms:.4f} ms eagerly "
          f"(CUDA events over back-to-back calls)", flush=True)
    out["iteration_ms_without_draw"] = it_plain
    out["draw_graph_ms"], out["draw_eager_ms"] = draw_graph_ms, draw_eager_ms
    return out


def compile_paths(data):
    """The paths' programs at optlevel 3 on the card; compile_program
    builds each program's fused plans, one nvcc per source, all of a
    program's together."""
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.config import get_config, set_config

    old = get_config()
    set_config(config(3))
    try:
        progs = {}
        for name in PATHS:
            s = path_script(name, data)
            progs[name] = compile_program(
                s.parse(), clargs=s._args, outputs=s._outputs,
                input_names=list(s._inputs))
        return progs
    finally:
        set_config(old)


def reset_launches(kernels) -> None:
    from systemml_tpu_torch.compress import device as cla_dev

    from systemml_tpu_torch.codegen import loop_graph

    for k in (kernels.mmchain_kernel, kernels.cell_kernel,
              kernels.row_kernel, kernels.outer_kernel,
              kernels.multiagg_kernel, cla_dev.chain_kernel,
              loop_graph.set_cond):
        k.launches = 0


def read_launches(kernels) -> dict:
    from systemml_tpu_torch.compress import device as cla_dev

    from systemml_tpu_torch.codegen import loop_graph

    return {"mmchain": kernels.mmchain_kernel.launches,
            "spoof_cell": kernels.cell_kernel.launches,
            "spoof_row": kernels.row_kernel.launches,
            "spoof_outer": kernels.outer_kernel.launches,
            "spoof_multiagg": kernels.multiagg_kernel.launches,
            "cla_chain": cla_dev.chain_kernel.launches,
            "set_cond": loop_graph.set_cond.launches}


def run_path(name, optlevel, data, dev, kernels, regions=True,
             profile_kernel=None, args=None, extra=(), src=None):
    """One unprofiled run of a path through MLContext, after a warm-up on
    the first 8,192 rows; the launch counters are set to 0 just before it
    and read just after. `regions` False runs it with codegen_enabled
    False (every loop eager); with `profile_kernel`, once more under
    torch.profiler (its loop period from that kernel's launches). `args`
    override the path's arguments; `extra` names more outputs, returned
    under "extra"; `src` the text of an inline script's variant."""
    from systemml_tpu_torch.api.mlcontext import MLContext

    ml = MLContext(config(optlevel, regions))
    ml.printer = lambda s: None
    ml.execute(path_script(name, data, rows=8192, args=args, extra=extra,
                           src=src))
    lines = []
    ml.printer = lines.append
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        res = ml.execute(path_script(name, data, args=args, extra=extra,
                                     src=src))
        out = res.get_tensor(PATHS[name][3])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    iters = outer_iterations(name, lines)
    events = dict(ml._stats.estim_counts.items())
    tag = f"{name} optlevel {optlevel}" + ("" if regions else " eager")
    windows = phase_windows(timer, iters, tag, PATHS[name][5])
    reg = region_report(timer, tag, name, regions)
    for s in lines[-2:]:
        print(f"[script] {s}")
    print(f"[path] {name} optlevel {optlevel}: {iters} outer iterations, "
          f"{secs:.3f} s with parse and compile, {ml._stats.run_time:.3f} s "
          f"executing; {windows['iteration_ms']:.3f} ms per outer iteration "
          f"(device window; host {windows['iteration_host_ms']:.3f} ms); "
          f"launches {launches}; {walk_line(events)}; spoof_plain_by_layout "
          f"{events.get('spoof_plain_by_layout', 0)}, spoof_compile_errors "
          f"{events.get('spoof_compile_errors', 0)}; peak allocated "
          f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB over the data "
          f"already on the card), reserved {peak_reserved / 1e9:.2f} GB",
          flush=True)
    check_walks(f"{name} optlevel {optlevel}", events, launches)
    shape = OUT_SHAPES.get(name)
    if not bool(torch.isfinite(out).all()) or (
            tuple(out.shape) != shape if shape else out.shape[0] != K):
        fail(f"{name} optlevel {optlevel}: output of shape "
             f"{tuple(out.shape)} is not finite or not "
             f"{shape or f'{K} rows'}")
    if out.dtype != torch.float32 or out.device.type != "cuda":
        fail(f"{name}: output is {out.dtype} on {out.device}")
    if events.get("spoof_compile_errors", 0):
        fail(f"{name} optlevel {optlevel}: spoof_compile_errors "
             f"{events['spoof_compile_errors']}")
    if optlevel >= 3:
        if events.get("spoof_plain_by_layout", 0) and \
                name not in PLAIN_BY_LAYOUT:
            fail(f"{name}: {events['spoof_plain_by_layout']} fused plans "
                 f"took the plain arm by layout")
        if launches["spoof_cell"] < 1 and name not in ROW_ONLY:
            fail(f"{name} optlevel 3: the spoof cell kernel never launched")
        if name in ("MultiLogReg", "Kmeans") + ROW_ONLY and \
                launches["spoof_row"] < 1:
            fail(f"{name} optlevel 3: the spoof row kernel never launched")
    elif launches["spoof_cell"] or launches["spoof_row"]:
        fail(f"{name} optlevel {optlevel} launched spoof kernels")
    if launches["cla_chain"] or events.get("cla_auto_compressed", 0):
        fail(f"{name} optlevel {optlevel}: the dense X was compressed")
    result = {"out": out, "iterations": iters, "seconds": secs,
              "exec_seconds": ml._stats.run_time, "launches": launches,
              "peak_bytes": peak, "peak_reserved": peak_reserved,
              "peak_over_data": peak - base,
              "extra": {e: res.get(e) for e in extra},
              "windows": windows, "lines": lines, "regions": reg,
              "events": {k: v for k, v in events.items()
                         if k.startswith("spoof_")}}
    if profile_kernel:
        result["profile"] = profile_main_path(ml, path_script(name, data),
                                              False, kernel=profile_kernel,
                                              loop=PATHS[name][5])
    return result


# --------------------------------------------------------------------------
# the algorithm-breadth paths: LinearRegDS, GLM (poisson, probit), Kmeans
# --------------------------------------------------------------------------

def glm_deviances(log: str) -> list:
    """The deviances of GLM.dml's IRLS log, "OBJECTIVE,iter,deviance"."""
    return [float(ln.split(",")[2]) for ln in log.split("\n")
            if ln.startswith("OBJECTIVE,")]


def kmeans_replay(x, c1, iters: int):
    """Kmeans.dml's Lloyd iterations in plain torch in fp64, from the
    centroids c1: the distances by the gram trick, the first nearest
    centroid, the per-cluster means (an empty cluster keeps its centroid).
    Returns the centroids after `iters` updates and the WCSS (the sum of
    each row's least distance) before each update."""
    xd = x.double()
    row_norms = (xd * xd).sum(1, keepdim=True)
    c = c1.double()
    wcss = []
    for _ in range(iters):
        d = row_norms - 2 * (xd @ c.T) + (c * c).sum(1)[None, :]
        assign = torch.argmax(-d, dim=1)
        wcss.append(float(d.min(dim=1).values.sum()))
        a = torch.nn.functional.one_hot(assign, c.shape[0]).double()
        counts = a.sum(0)[:, None]
        c_new = (a.T @ xd) / counts.clamp(min=1)
        empty = (counts == 0).double()
        c = c_new * (1 - empty) + c * empty
        del d, a
    del xd
    return c, wcss


def _kmeans_wcss(lines) -> float:
    hit = [s for s in lines if s.startswith("Kmeans run 1: WCSS = ")][-1]
    return float(hit.split("= ")[1].split()[0])


def check_breadth_datagen(dev) -> dict:
    """seq and sample on the card against the CPU's draw, bit for bit, at
    the shapes Kmeans gives them (its k-means++ sample of 2,000,000 rows
    in steps of 8,000; its plain init's sample of 5 rows) and with
    replacement over 3,000,000 (three rounds of the sort shuffle)."""
    from systemml_tpu_torch.ops import datagen

    out = {}
    for label, fn, args in (
            ("sample(2000000, 5, 7)", datagen.sample, (2_000_000, 5, False, 7)),
            ("sample(3000000, 10, TRUE, 7)", datagen.sample,
             (3_000_000, 10, True, 7)),
            ("sample(3000000, 3000000, 7)", datagen.sample,
             (3_000_000, 3_000_000, False, 7)),
            ("seq(1, 2000000, 8000)", datagen.seq, (1, 2_000_000, 8000))):
        for dtype in (torch.float32, torch.float64):
            t0 = time.perf_counter()
            got = fn(*args, dtype=dtype, device=dev)
            torch.cuda.synchronize()
            card_ms = 1e3 * (time.perf_counter() - t0)
            ref = fn(*args, dtype=dtype, device="cpu")
            same = bool(torch.equal(got.cpu(), ref))
            out[f"{label} {str(dtype)[6:]}"] = {"bit_identical": same,
                                                "card_host_ms": card_ms}
            if not same:
                fail(f"{label} {dtype} on the card differs from the CPU's")
    print(f"[datagen] seq and sample on the card against the CPU, bit for "
          f"bit: {out}", flush=True)
    return out


def breadth_paths(data, dev, kernels) -> dict:
    """LinearRegDS, GLM-poisson, GLM-probit and Kmeans through MLContext on
    the card: each at optlevel 3 with regions, at optlevel 3 without
    (codegen_enabled False) and at optlevel 2; the with/without pair held
    to bit-identity or 1e-5 normwise with equal kernel launches, optlevel
    3 to optlevel 2 at 1e-3, and each path's own check (section 3 of the
    module docstring). Prints one `[breadth]` line per path."""
    beta_true = data["beta_true"].double()
    x = data["X"]
    out = {}
    for name in BREADTH_PATHS:
        extra = ("log_str",) if name.startswith("GLM") else ()
        r3 = run_path(name, 3, data, dev, kernels)
        eag = run_path(name, 3, data, dev, kernels, regions=False,
                       extra=extra)
        versus = compare_eager(f"{name} optlevel 3", r3, eag)
        r2 = run_path(name, 2, data, dev, kernels)
        a, b = r3["out"].double(), r2["out"].double()
        diff = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        if not diff <= 1e-3:
            fail(f"{name}: optlevel 3 is {diff} from optlevel 2 (bar 1e-3)")
        rec = {"diff_from_optlevel2": diff, "versus_eager": versus,
               **{k: {f: v for f, v in r.items()
                      if f not in ("out", "lines", "extra")}
                  for k, r in (("optlevel3", r3), ("eager", eag),
                               ("optlevel2", r2))}}
        check = ""
        if name == "LinearRegDS":
            rel = float(torch.linalg.norm(a - beta_true)
                        / torch.linalg.norm(beta_true))
            rec["beta_rel_err"] = rel
            check = f"|beta - beta_true| / |beta_true| = {rel:.3e} (bar 1e-3)"
            if not rel <= 1e-3:
                fail(f"LinearRegDS: beta is {rel} from beta_true")
        elif name.startswith("GLM"):
            dev_log = glm_deviances(eag["extra"]["log_str"])
            rec["deviances"] = dev_log
            rises = [(i, d0, d1) for i, (d0, d1) in
                     enumerate(zip(dev_log, dev_log[1:]), 2)
                     if d1 > d0 * (1 + 1e-6)]
            check = (f"deviance over the IRLS log {dev_log} (eager run): "
                     f"non-increasing within 1e-6 relative: {not rises}")
            if len(dev_log) != eag["iterations"] or rises:
                fail(f"{name}: deviance rises at iterations {rises}, or the "
                     f"log has {len(dev_log)} entries for "
                     f"{eag['iterations']} iterations")
        else:
            # the Lloyd iterations from the script's own first update (a
            # run with maxi 1), replayed in fp64: WCSS non-increasing, and
            # the script's last WCSS against the replay's. C_out is printed
            # beside the replay's, not held to it: on this X (Gaussian, no
            # clusters) many rows are near ties between centroids, and
            # fp32 and fp64 distances assign some of them differently
            one = run_path(name, 3, data, dev, kernels, args={"maxi": 1})
            iters = r3["iterations"]
            c_ref, wcss = kmeans_replay(x, one["out"], iters - 1)
            wcss = [_kmeans_wcss(one["lines"])] + wcss
            rises = [(i, w0, w1) for i, (w0, w1) in
                     enumerate(zip(wcss, wcss[1:]), 2) if w1 > w0 * (1 + 1e-9)]
            c_err = float(torch.linalg.norm(a - c_ref)
                          / torch.linalg.norm(c_ref))
            w_err = abs(_kmeans_wcss(r3["lines"]) - wcss[-1]) / wcss[-1]
            rec.update({"wcss": wcss, "c_out_vs_replay": c_err,
                        "last_wcss_vs_replay": w_err})
            check = (f"WCSS before each update {wcss} (the first the "
                     f"script's, the rest replayed in fp64 from its first "
                     f"update): non-increasing {not rises}; the script's "
                     f"last WCSS {w_err:.3e} from the replay's (bar 1e-5); "
                     f"C_out {c_err:.3e} from the replay's (near-tie "
                     f"assignments)")
            if rises or not w_err <= 1e-5:
                fail(f"Kmeans: WCSS rises at {rises}, or the last WCSS is "
                     f"{w_err} from the replayed iterations")
            del c_ref
        reg = r3["regions"]
        per_entry = ", ".join(
            f"{g['label']}: {g['launches'] / g['entries']:.2f} graph "
            f"launches, {g['host_syncs'] / g['entries']:.2f} host syncs per "
            f"entry" for g in reg.get("regions", []))
        unit = ("ms for the whole execution" if name in NO_LOOP
                else "ms per outer iteration")
        graph_ms = (r3["windows"]["iteration_ms"] if name in NO_LOOP
                    else versus["iteration_ms_regions"])
        print(f"[breadth] {name} ({M} x {K} fp32) optlevel 3, "
              f"{r3['iterations']} outer iterations: {unit} "
              f"{graph_ms:.3f} in the graph (with the peel and capture "
              f"{r3['windows']['iteration_ms']:.3f}) / "
              f"{eag['windows']['iteration_ms']:.3f} eager / "
              f"{r2['windows']['iteration_ms']:.3f} at optlevel 2; K2 "
              f"launches {r3['launches']['spoof_cell']} with regions, "
              f"{eag['launches']['spoof_cell']} without; K4 "
              f"{r3['launches']['spoof_row']} / {eag['launches']['spoof_row']}"
              f"; {per_entry or 'no region'}; refused "
              f"{reg.get('refused') or 'none'}; peak allocated over the data "
              f"{r3['peak_over_data'] / 1e9:.3f} GB with regions, "
              f"{eag['peak_over_data'] / 1e9:.3f} eager, "
              f"{r2['peak_over_data'] / 1e9:.3f} at optlevel 2 (X "
              f"{x.numel() * 4 / 1e9:.1f} GB); optlevel 3 vs 2 {diff:.3e}; "
              f"{check}", flush=True)
        rec["graph_ms"] = graph_ms
        out[name] = rec
        del r3, eag, r2, a, b
        torch.cuda.empty_cache()
    # where LinearRegDS's and GLM's time goes: the whole t(X) %*% X
    # (the JAX package forms it with one jnp matmul too; no hand kernel)
    tsmm_ms, = time_ms([lambda: torch.matmul(x.T, x)], reps=5, warm=1)
    flop = 2.0 * M * K * K
    out["tsmm_ms"] = tsmm_ms
    print(f"[times] t(X) %*% X ({M} x {K} fp32, TF32 off) by torch.matmul "
          f"on {nvidia_smi_line()}: {tsmm_ms:.3f} ms, "
          f"{flop / tsmm_ms / 1e9:.1f} TFLOP/s ({flop:.2e} FLOP; bound "
          f"{1e3 * flop / FP32_OPS_PER_S:.3f} ms at 67 TFLOP/s; a syrk would "
          f"compute one triangle, half the FLOP)", flush=True)
    return out


# --------------------------------------------------------------------------
# the region bridge (codegen/csrc/loop_graph.cu) on small scripts
# --------------------------------------------------------------------------

BRIDGE = {
    "zero-trip while": ("""
x = 5
i = 0
while (x < 0) {
  x = x - 1
  i = i + 1
}
""", ["x", "i"]),
    "nested while in while": ("""
outer = 0
total = matrix(0, rows=3, cols=2)
while (outer < 5) {
  inner = 0
  acc = 0.0
  while (inner < outer + 2) {
    acc = acc + inner + 1
    inner = inner + 1
  }
  total = total + acc * X
  outer = outer + 1
}
""", ["total", "outer"]),
    "if/else in while": ("""
i = 0
evens = 0
A = X
while (i < 10) {
  h = i - 2 * floor(i / 2)
  if (h == 0 & sum(A) > 0) {
    evens = evens + 1
    A = A * 1.5
  } else {
    A = A - 0.25
  }
  i = i + 1
}
""", ["evens", "A", "i"]),
    "for in while": ("""
i = 0
s = matrix(0, rows=3, cols=2)
while (i < 4) {
  for (j in 1:6) {
    s = s + j * X
  }
  i = i + 1
}
""", ["s", "j"]),
    "zero-trip inner loop": ("""
i = 0
s = 0
while (i < 4) {
  k = i
  while (k < 2) {
    s = s + 10
    k = k + 1
  }
  i = i + 1
}
""", ["s"]),
}
REENTRY = """
w = matrix(0, rows=ncol(X), cols=1)
i = 0
while (i < maxi) {
  w = w + 0.001 * (t(X) %*% (X %*% w + 1))
  i = i + 1
}
r = sum(w)
"""


def bridge_phase(dev) -> dict:
    """Each BRIDGE script through MLContext on the card (its loops one
    CUDA graph each, WHILE and IF nodes) and on the CPU (the region
    executor's plain arm), fp64 on both: the outputs equal within 1e-12
    relative; then REENTRY compiled once and run with maxi 5, 9 and 5 on
    one X: one capture, three graph launches, the first and last results
    bit-identical."""
    import numpy as np

    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.lang.parser import parse
    from systemml_tpu_torch.runtime import loopfuse
    from systemml_tpu_torch.runtime import program as P
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    x = np.arange(1.0, 7.0).reshape(3, 2) / 7.0
    out = {}
    for label, (src, outs) in BRIDGE.items():
        vals = {}
        for device in ("cuda", "cpu"):
            cfg = DMLConfig(device=device)
            cfg.floating_point_precision = "double"
            ml = MLContext(cfg)
            with PhaseTimer() as timer:
                res = ml.execute(dml(src).input("X", x).output(*outs))
            vals[device] = [np.asarray(res.get_matrix(o), dtype=np.float64)
                            if hasattr(res.get(o), "shape") and
                            res.get(o).ndim else
                            np.asarray(float(res.get_scalar(o)))
                            for o in outs]
            if device == "cuda":
                rep = loopfuse.region_report(timer.program)
        errs = [float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))
                for a, b in zip(vals["cuda"], vals["cpu"])]
        top = [r for r in rep if r.get("entries")]
        print(f"[bridge] {label}: card against the CPU's plain arm, max "
              f"relative difference {max(errs):.3e} (bar 1e-12); regions "
              f"{[(r['label'], r['trips'], r['launches'], r.get('nodes')) for r in top]}",
              flush=True)
        if not max(errs) <= 1e-12:
            fail(f"bridge {label}: card {vals['cuda']} against CPU "
                 f"{vals['cpu']}")
        if any(r.get("refused") for r in rep):
            fail(f"bridge {label}: a region was refused: {rep}")
        out[label] = {"max_rel_diff": max(errs), "regions": top}
    cfg = DMLConfig()
    cfg.floating_point_precision = "double"
    set_config(cfg)
    try:
        prog = P.compile_program(parse(REENTRY), input_names=["X", "maxi"],
                                 outputs=["r"])
        xt = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (4096, 16))).to(dev)
        rs = [prog.execute({"X": xt, "maxi": m}).vars["r"]
              for m in (5, 9, 5)]
    finally:
        set_config(DMLConfig())
    fl = [b for b in prog.blocks if isinstance(b, P.WhileBlock)][0]._fused_loop
    rec = fl.record
    print(f"[bridge] re-entry with another maxi: trips {rec['trips']}, "
          f"captures {rec['captures']}, graph launches {rec['launches']}; "
          f"r {[float(r) for r in rs]}", flush=True)
    if rec["captures"] != 1 or rec["launches"] != 3 or \
            rec["trips"] != [5, 9, 5] or not torch.equal(rs[0], rs[2]):
        fail(f"bridge re-entry: {rec}, r {rs}")
    out["re-entry"] = {k: rec[k] for k in ("trips", "captures", "launches")}
    del prog, fl
    return out


def check_set_cond(dev) -> dict:
    """set_cond (csrc/loop_graph.cu) against its plain version on a
    one-element predicate of every dtype it reads, with 0, 1, -2.5 (cast
    to the dtype) and NaN: an IF node whose body writes 1 into a flag, and
    one testing pred == 0, against pred != 0 on the host. Then its time,
    as a WHILE loop's control per iteration (k.add_(1), k < n, set_cond)
    in one graph of 20,000 iterations, against the same loop driven from
    the host (one .item() per test)."""
    from systemml_tpu_torch.codegen import loop_graph as lg
    from systemml_tpu_torch.runtime import loopfuse

    streams = loopfuse.capture_streams(dev)
    s0, s1 = streams[0], streams[1]
    flag = torch.zeros(2, dtype=torch.int32, device=dev)
    worst = 0.0
    cases = 0
    for dtype in (torch.bool, torch.float32, torch.float64, torch.int64,
                  torch.int32):
        values = (0, 1, -2.5, float("nan")) if dtype.is_floating_point \
            else ((0, 1) if dtype == torch.bool else (0, 1, -2))
        for v in values:
            pred = torch.full((), v, dtype=dtype, device=dev)
            pool = torch.cuda.MemPool()
            s0.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s0), torch.cuda.use_mem_pool(pool, dev):
                lg.capture_begin(s0.cuda_stream)
                for slot, neg in ((0, False), (1, True)):
                    h = lg.begin_node(s0.cuda_stream, s1.cuda_stream, lg.IF,
                                      pred, negate=neg)
                    with torch.cuda.stream(s1):
                        flag[slot].fill_(1)
                        lg.end_node(s1.cuda_stream, lg.IF, h)
                graph = lg.capture_end(s0.cuda_stream)
            ex = lg.instantiate(graph)
            flag.zero_()
            lg.launch(ex, torch.cuda.current_stream(dev).cuda_stream)
            got = flag.tolist()
            want = lg.set_cond_plain(pred)
            worst = max(worst, abs(got[0] - int(want)),
                        abs(got[1] - int(not want)))
            cases += 1
            lg.destroy(graph, ex)
            del pool
    n = 20_000
    k = torch.zeros((), dtype=torch.int64, device=dev)
    pool = torch.cuda.MemPool()
    s0.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s0), torch.cuda.use_mem_pool(pool, dev):
        lg.capture_begin(s0.cuda_stream)
        h = lg.begin_node(s0.cuda_stream, s1.cuda_stream, lg.WHILE, k < n)
        with torch.cuda.stream(s1):
            k.add_(1)
            lg.end_node(s1.cuda_stream, lg.WHILE, h, k < n)
        graph = lg.capture_end(s0.cuda_stream)
    ex = lg.instantiate(graph)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = []
    for _ in range(3):
        k.zero_()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        lg.launch(ex, stream)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    if int(k) != n:
        fail(f"set_cond: the WHILE loop ran {int(k)} times, not {n}")
    lg.destroy(graph, ex)
    del pool
    m = 2_000
    k.zero_()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    while bool((k < m).item()):
        k.add_(1)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1) / m
    ms = sorted(times)[1]
    print(f"[kernel] set_cond: {cases} predicates of 5 dtypes, IF and its "
          f"negation against pred != 0 on the host: max abs error {worst} "
          f"(bar 0); a WHILE loop's control per iteration {ms * 1e3:.2f} us "
          f"in one graph ({[round(t * 1e3, 2) for t in times]}), driven "
          f"from the host {plain_ms * 1e3:.2f} us", flush=True)
    if worst != 0:
        fail("set_cond disagrees with its plain version")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def templates_of(prog) -> list:
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    return [(h.params["template"], h.params.get("agg")
             or h.params.get("row_agg"), h.params["plan"].pretty())
            for h in iter_spoof_hops(prog)]


# --------------------------------------------------------------------------
# spoof kernels against their plain versions
# --------------------------------------------------------------------------

def _n(CNode, op, *kids):
    return CNode(op, list(kids))


def kernel_plans(progs):
    """(label, template, plan, leaf names) of the kernel phase: the
    paths' own plans (l2-svm's 10-leaf cell plan, MultiLogReg's row plan,
    last minibatch-sgd's row plan) and three made here."""
    from systemml_tpu_torch.codegen.cplan import CELL_BINARY, CELL_UNARY, CNode
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    cells = [h for h in iter_spoof_hops(progs["l2-svm"])
             if h.params["template"] == "cell"]
    svm = max(cells, key=lambda h: len(h.params["leaf_names"]))
    rows = [h for h in iter_spoof_hops(progs["MultiLogReg"])
            if h.params["template"] == "row"]
    if len(svm.params["leaf_names"]) != 10 or not rows:
        fail("l2-svm has no 10-leaf cell plan or MultiLogReg no row plan: "
             f"{templates_of(progs['l2-svm'])}, "
             f"{templates_of(progs['MultiLogReg'])}")
    row = rows[0]
    if row.params["plan"].pretty() != "u(exp)(b(-)(i0, i1))":
        fail(f"MultiLogReg's row plan is {row.params['plan'].pretty()}")
    sgd = list(iter_spoof_hops(progs["minibatch-sgd"]))
    if [h.params["plan"].pretty() for h in sgd] != [MINIBATCH_ROW_PLAN]:
        fail(f"minibatch-sgd's plans are "
             f"{templates_of(progs['minibatch-sgd'])}, not the one row "
             f"plan {MINIBATCH_ROW_PLAN}")
    i = lambda nm: CNode("in", name=nm)
    lit = lambda v: CNode("lit", value=v)
    n = lambda op, *kids: _n(CNode, op, *kids)
    # every layout: i0 (m, n), i1 (1, n), i2 (m, 1), i3 (1, 1), s a host
    # number, t a 0-d tensor
    ragged = n("b(+)", n("b(*)", n("b(min)", i("i0"), i("i1")),
                         n("b(-)", i("s"), i("i2"))),
               n("b(+)", n("b(^)", n("b(max)", i("i0"), i("t")), lit(2.0)),
                 n("b(*)", n("u(sigmoid)", i("i3")),
                   n("b(>)", i("i0"), n("u(abs)", i("i2"))))))
    # every op once: a sum of small terms
    e = i("i0")
    for op in sorted(CELL_UNARY):
        arg = n("b(*)", lit(0.5), i("i0"))
        if op in ("u(log)", "u(sqrt)"):
            arg = n("u(abs)", arg)
        e = n("b(+)", e, n("b(*)", lit(1e-3), n(op, arg)))
    for op in sorted(CELL_BINARY):
        rhs = lit(2.0) if op == "b(^)" else i("i1")
        e = n("b(+)", e, n("b(*)", lit(1e-3), n(op, i("i0"), rhs)))
    every = n("b(+)", e, n("b(^)", n("u(abs)", i("i2")), i("i3")))
    # the values every op is checked at: NaN into min and max, 0 into
    # sign, x.5 into round
    special = n("b(+)", n("b(+)", n("b(min)", i("i0"), i("i1")),
                          n("b(max)", i("i2"), i("i0"))),
                n("b(+)", n("u(round)", i("i0")), n("u(sign)", i("i2"))))
    return [("l2-svm cell", "cell", svm.params["plan"],
             list(svm.params["leaf_names"]), svm),
            ("MultiLogReg row", "row", row.params["plan"],
             list(row.params["leaf_names"]), row),
            ("ragged", None, ragged, ["i0", "i1", "s", "i2", "t", "i3"], None),
            ("every op", None, every, ["i0", "i1", "i2", "i3"], None),
            ("specials", None, special, ["i0", "i1", "i2"], None),
            ("minibatch-sgd row", "row", sgd[0].params["plan"],
             list(sgd[0].params["leaf_names"]), sgd[0])]


def kernel_env(label, hop, names, dtype, dev, gen):
    """Leaf values of a kernel-phase plan, made on the card."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev,
                                   dtype=dtype)
    if label == "l2-svm cell":
        # the leaves are the line search's Y, Xw, step_sz and Xd
        by_name = {"Y": torch.sign(r(M, 1)), "Xw": r(M, 1), "Xd": r(M, 1),
                   "step_sz": torch.tensor(0.05, device=dev)}
        env = {}
        for nm, h in zip(names, hop.inputs):
            if h.op != "tread" or h.name not in by_name:
                fail(f"l2-svm's plan reads {h.op} {h.name!r}")
            env[nm] = by_name[h.name]
        return env
    if label == "MultiLogReg row":
        z = r(M, 5)
        return {"i0": z, "i1": z.amax(dim=1, keepdim=True)}
    if label == "minibatch-sgd row":
        # dscores' row sum at a batch of 1,000: Y_batch, the scores'
        # product and bias, their row max, the exponentials' row sum
        bs = PATHS["minibatch-sgd"][2]["bs"]
        y = torch.nn.functional.one_hot(torch.randint(
            0, 5, (bs,), generator=gen, device=dev), 5).to(dtype)
        xw, bias = r(bs, 5), r(1, 5)
        mx = (xw + bias).amax(dim=1, keepdim=True)
        se = torch.exp(xw + bias - mx).sum(dim=1, keepdim=True)
        return {"i0": y, "i1": xw, "i2": bias, "i3": mx, "i4": se,
                "i5": xw, "i6": bias, "i7": mx, "i8": se}
    if label == "ragged":
        m, n = 100_003, 7
        return {"i0": r(m, n), "i1": r(1, n), "i2": r(m, 1), "i3": r(1, 1),
                "s": 0.25,
                "t": torch.tensor(-0.5, device=dev, dtype=torch.float64)}
    if label == "every op":
        m, n = 100_003, 7
        mag = lambda *shape: 0.5 + torch.rand(*shape, generator=gen,
                                              device=dev, dtype=dtype)
        return {"i0": torch.sign(r(m, n)) * mag(m, n),
                "i1": torch.sign(r(1, n)) * mag(1, n), "i2": mag(m, 1),
                "i3": torch.full((1, 1), 1.7, device=dev, dtype=dtype)}
    m, n = 100_003, 7
    i0 = torch.randint(-4, 4, (m, n), generator=gen, device=dev).to(dtype) + 0.5
    i0[::5, 1] = float("nan")
    i1 = r(1, n)
    i1[0, 2] = float("nan")
    i2 = torch.randint(-1, 2, (m, 1), generator=gen, device=dev).to(dtype)
    i2[3, 0] = float("nan")
    return {"i0": i0, "i1": i1, "i2": i2}


def kernel_phase_sources(progs, als_progs, dev, kernels) -> list:
    """(template, plan, Variant) of the sources that the kernel and time
    phases launch beyond the paths' own, each Variant derived from the
    values the plan is called with, as the wrappers derive it
    (kernels.env_variant): the kernel phase's plans through the cell and
    row templates and, but "every op", through every aggregate order of
    AGG_ORDERS; the summary's plan through every order and elementwise."""
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}

    def add(template, plan, env, aggs=()):
        v = kernels.env_variant(template, plan.input_names(), env, aggs)
        out[(template, plan.key(), v)] = (template, plan, v)

    for label, template, plan, names, hop in kernel_plans(progs):
        env = kernel_env(label, hop, names, torch.float32, dev, gen)
        for t in ((template,) if template else ("cell", "row")):
            add(t, plan, env)
        if template is None and label != "every op":
            for aggs in AGG_ORDERS:
                add("multiagg", plan, env, aggs)
        del env
    summ = _plan_of(als_progs["summary"], "multiagg")
    plan, names = summ.params["plan"], list(summ.params["leaf_names"])
    v = torch.ones(8, 8, device=dev)
    env = {names[0]: v, names[1]: v, names[2]: v.sum(), names[3]: v.sum()}
    for aggs in AGG_ORDERS:
        add("multiagg", plan, env, aggs)
    add("cell", plan, env)
    return list(out.values())


def walk_line(events) -> str:
    """The launches of the cell and multi-aggregate templates by walk."""
    return (f"walks flat {events.get('spoof_flat_walk', 0)} general "
            f"{events.get('spoof_general_walk', 0)}")


def check_walks(label, events, launches) -> None:
    """Every cell and multi-aggregate launch counted on one walk."""
    walked = (events.get("spoof_flat_walk", 0)
              + events.get("spoof_general_walk", 0))
    if walked != launches["spoof_cell"] + launches["spoof_multiagg"]:
        fail(f"{label}: {walked} launches counted by walk, "
             f"{launches['spoof_cell'] + launches['spoof_multiagg']} "
             f"launched")


class SpoofSpy:
    """For the duration of a with-block, counts the cell-template sums
    that the program runs by plan and main-leaf shape and keeps the last
    call of each (plan, leaf names, env, Variant): the time phase times
    the most launched at the path's own inputs."""

    def __enter__(self):
        from systemml_tpu_torch.codegen import compiler, kernels
        self._compiler = compiler
        self._orig = compiler.execute_spoof
        self.counts, self.last = {}, {}

        def spy(h, args):
            if h.params["template"] == "cell" and h.params.get("agg") == "sum":
                names = list(h.params["leaf_names"])
                env = dict(zip(names, args))
                mats = kernels._matrices(names, env)
                key = (h.params["plan"].key(),
                       tuple(env[mats[0]].shape) if mats else None)
                self.counts[key] = self.counts.get(key, 0) + 1
                self.last[key] = (h.params["plan"], names, env,
                                  compiler.hop_variant(h))
            return self._orig(h, args)

        compiler.execute_spoof = spy
        return self

    def __exit__(self, *exc):
        self._compiler.execute_spoof = self._orig

    def most_launched(self):
        """(launches, last call) of the plan and main-leaf shape launched
        most; of equals, the first launched."""
        key = max(self.counts, key=self.counts.get)
        return self.counts[key], self.last[key]



def check_spoof_kernels(progs, dev, kernels) -> dict:
    """Every kernel-phase plan through the cell kernel (elementwise and
    sum) and the row kernel (sum, min, max), in fp32 and fp64, twice,
    against the plain version in fp64 from the same inputs. Returns the
    max abs errors at the paths' own plans in fp32."""
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {"spoof_cell": 0.0, "spoof_row": 0.0}
    for label, template, plan, names, hop in kernel_plans(progs):
        arms = ([("cell", None), ("cell", "sum")] if template == "cell" else
                [("row", "sum"), ("row", "min"), ("row", "max")]
                if template == "row" else
                [("cell", None), ("cell", "sum"), ("row", "sum"),
                 ("row", "min"), ("row", "max")])
        for dtype in (torch.float32, torch.float64):
            env = kernel_env(label, hop, names, dtype, dev, gen)
            envd = {k: (v.double() if isinstance(v, torch.Tensor) else v)
                    for k, v in env.items()}
            for tmpl, agg in arms:
                wrap = kernels.cell_kernel if tmpl == "cell" else \
                    kernels.row_kernel
                plain = kernels.cell_plain if tmpl == "cell" else \
                    kernels.row_plain
                before = wrap.launches
                out = wrap(plan, names, agg, env)
                again = wrap(plan, names, agg, env)
                ref = plain(plan, names, agg, envd)
                torch.cuda.synchronize()
                nan_ok = bool(torch.equal(out.isnan(), ref.isnan()))
                same = bool(torch.equal(out.nan_to_num(0.0),
                                        again.nan_to_num(0.0)))
                ok = ~ref.isnan()
                diff = out.double()[ok] - ref[ok]
                den = float(torch.linalg.norm(ref[ok]))
                err = float(torch.linalg.norm(diff)) / den if den else \
                    float(torch.linalg.norm(diff))
                abs_err = float(diff.abs().max()) if diff.numel() else 0.0
                shape = tuple(env[names[0]].shape) if label != "l2-svm cell" \
                    else (M, 1)
                print(f"[kernel] spoof {tmpl} {agg or 'elementwise'} "
                      f"{label} {shape} {str(dtype)[6:]}: normwise "
                      f"{err:.3e} (bar {SPOOF_BARS[dtype]:g}), max abs "
                      f"{abs_err:.3e}, NaN at the same places {nan_ok}, "
                      f"repeat bit-identical {same}", flush=True)
                if wrap.launches != before + 2:
                    fail(f"spoof {tmpl} {label}: the kernel did not launch")
                if not (err <= SPOOF_BARS[dtype]) or not nan_ok or not same:
                    fail(f"spoof {tmpl} {agg} {label} {dtype}: normwise "
                         f"{err}, NaN places equal {nan_ok}, repeat "
                         f"identical {same}")
                if dtype == torch.float32 and template is not None:
                    key = "spoof_cell" if tmpl == "cell" else "spoof_row"
                    errs[key] = max(errs[key], abs_err)
            del env, envd
    torch.cuda.empty_cache()
    return errs


def plan_ops(plan) -> int:
    """Operations per element of a plan: its op nodes."""
    if plan.op in ("in", "lit"):
        return 0
    return 1 + sum(plan_ops(c) for c in plan.inputs)


def spoof_bound(plan, env, out_bytes, cells):
    """(bound ms, bound_by): the distinct leaf tensors read once and the
    output written once over 3.35 TB/s, against the plan's operations
    per element over 67 TFLOP/s."""
    seen = {}
    for v in env.values():
        if isinstance(v, torch.Tensor):
            seen[v.data_ptr()] = v.numel() * v.element_size()
    bytes_ms = 1e3 * (sum(seen.values()) + out_bytes) / HBM_BYTES_PER_S
    ops_ms = 1e3 * plan_ops(plan) * cells / FP32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


# --------------------------------------------------------------------------
# compressed LA: K6 against its plain version, and the LinearRegCG-cla path
# --------------------------------------------------------------------------

def make_census(dev):
    """The categorical X (CENSUS_N, CENSUS_M) fp32 and the scripts'
    targets, from one seeded generator on the card. Column j takes d_j
    values, d_j in 2..8, with uniform codes; its dictionary is drawn
    N(0, 1) and standardised (mean 0, variance 1 under uniform codes):
    with the raw draws, the columns' shared nonzero means and the
    near-constant columns leave t(X) X ill-conditioned, and 20 CG
    iterations stop far from the solution in either cla mode."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n, m = CENSUS_N, CENSUS_M
    x = torch.empty(n, m, device=dev)
    dims = torch.randint(2, 9, (m,), generator=gen, device=dev).tolist()
    for j, d in enumerate(dims):
        dct = torch.randn(d, generator=gen, device=dev)
        dct = (dct - dct.mean()) / dct.std(correction=0)
        x[:, j] = dct[torch.randint(0, d, (n,), generator=gen, device=dev)]
    beta_true = torch.randn(m, 1, generator=gen, device=dev)
    y = x @ beta_true + 0.01 * torch.randn(n, 1, generator=gen, device=dev)
    w_svm = torch.randn(m, 1, generator=gen, device=dev)
    z = x @ w_svm + 0.1 * torch.randn(n, 1, generator=gen, device=dev)
    return {"X": x, "y": y, "beta_true": beta_true,
            "Y_svm": torch.where(z >= 0, 1.0, -1.0), "dims": dims}


def chain_codes(dev, gen, n, groups, dmax):
    """(groups, n) uint8 codes in K6's layout; group 0 takes dmax values,
    the others 1..dmax."""
    from systemml_tpu_torch.compress import device as cla_dev

    ds = [dmax] + torch.randint(1, dmax + 1, (groups - 1,), generator=gen,
                                device=dev).tolist()
    return cla_dev.chain_codes(torch.stack(
        [torch.randint(0, d, (n,), generator=gen, device=dev)
         .to(torch.uint8) for d in ds]))


def _chain_case(label, codes, sv, w, ctype) -> None:
    """K6 twice against chain_plain in fp64 on the card: NaN and +-Inf in
    the same slots, the finite slots within the bar, repeats bit-identical
    (NaN compared by place)."""
    from systemml_tpu_torch.compress import device as cla_dev

    before = cla_dev.chain_kernel.launches
    out = cla_dev.chain_kernel(codes, sv, w, ctype)
    again = cla_dev.chain_kernel(codes, sv, w, ctype)
    ref = cla_dev.chain_plain(codes, sv.double(),
                              None if w is None else w.double(), ctype)
    torch.cuda.synchronize()
    places = all(bool(torch.equal(f(out), f(ref))) for f in
                 (torch.isnan, torch.isposinf, torch.isneginf))
    fin = torch.isfinite(ref)
    err = normwise(out[fin], ref[fin])
    # per slot: the worst relative error of the slots with |value| at
    # least 1e-3 of the largest (no slot's own rounding bound here; the
    # card test test_cla_chain_heavy_tailed_z holds each slot to its own)
    big = fin & (ref.abs() >= 1e-3 * ref[fin].abs().max())
    slot = float(((out[big] - ref[big]).abs() / ref[big].abs()).max()) \
        if bool(big.any()) else 0.0
    same = bool(torch.equal(out.nan_to_num(), again.nan_to_num())
                and torch.equal(out.isnan(), again.isnan()))
    bar = CHAIN_BARS[sv.dtype]
    print(f"[kernel] cla_chain {label}: {int(torch.isnan(ref).sum())} NaN "
          f"and {int(torch.isinf(ref).sum())} +-Inf slots of "
          f"{ref.numel()} in the plain version, same places {places}; "
          f"finite slots normwise {err:.3e} (bar {bar:g}), worst per slot "
          f"{slot:.3e} relative over the {int(big.sum())} slots of at least "
          f"1e-3 of the largest; repeat bit-identical {same}", flush=True)
    if cla_dev.chain_kernel.launches != before + 2:
        fail(f"cla_chain {label}: the kernel did not launch")
    if not (places and err <= bar and same):
        fail(f"cla_chain {label}: NaN/Inf places {places}, normwise {err}, "
             f"repeat identical {same}")


def check_chain_special(codes, dev, gen) -> None:
    """At the Census shape, fp32, k = 1: NaN, +Inf and -Inf rows in w and
    in y (a tile with one takes the kernel's fp64 branch), and every row
    of each group on one code (the integer atomics' worst case)."""
    from systemml_tpu_torch.compress import device as cla_dev

    groups, n = codes.shape
    sv = torch.randn(8, groups, 1, generator=gen, device=dev)
    w = torch.randn(n, 1, generator=gen, device=dev)
    for r, v in ((5, "nan"), (70_000, "inf"), (1_000_000, "inf"),
                 (1_000_001, "-inf"), (n - 1, "-inf")):
        w[r, 0] = float(v)
    for ctype in ("XtwXv", "XtXvy"):
        _chain_case(f"{ctype} codes ({groups}, {n}) fp32 k=1 with NaN, "
                    f"+Inf and -Inf rows in w/y", codes, sv, w, ctype)
    one = cla_dev.chain_codes(torch.full((groups, n), 3, dtype=torch.uint8,
                                         device=dev))
    _chain_case(f"XtXv codes ({groups}, {n}) fp32 k=1, every row on code 3",
                one, sv, None, "XtXv")
    # heavy-tailed z: w log-uniform over 12 decades, so each tile's scale
    # drops the low bits of its small z
    w = torch.exp(torch.empty(n, 1, device=dev).uniform_(
        -6 * math.log(10), 6 * math.log(10), generator=gen)) * torch.where(
        torch.rand(n, 1, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    _chain_case(f"XtwXv codes ({groups}, {n}) fp32 k=1, w log-uniform "
                f"over 12 decades", codes, sv, w, "XtwXv")


def check_chain_kernel(dev) -> float:
    """K6 against chain_plain in fp64 on the card, twice; then two blocks
    that K6 refuses by layout through the compressed mmchain. Returns the
    max abs error at the path's shape in fp32, k = 1, XtXv."""
    import numpy as np

    from systemml_tpu_torch.compress import compress
    from systemml_tpu_torch.compress import device as cla_dev
    from systemml_tpu_torch.ops import mult
    from systemml_tpu_torch.utils import stats

    gen = torch.Generator(device=dev).manual_seed(4)
    abs_err = None
    for n, groups, dmax in ((CENSUS_N, CENSUS_M, 8), (100_003, 7, 5)):
        codes = chain_codes(dev, gen, n, groups, dmax)
        for dtype in (torch.float32, torch.float64):
            for k in (1, 4):
                sv = torch.randn(dmax, groups, k, generator=gen, device=dev,
                                 dtype=dtype)
                for ctype, wc in (("XtXv", 0), ("XtwXv", 1), ("XtXvy", k)):
                    w = (torch.randn(n, wc, generator=gen, device=dev,
                                     dtype=dtype) if wc else None)
                    before = cla_dev.chain_kernel.launches
                    out = cla_dev.chain_kernel(codes, sv, w, ctype)
                    again = cla_dev.chain_kernel(codes, sv, w, ctype)
                    ref = cla_dev.chain_plain(
                        codes, sv.double(),
                        None if w is None else w.double(), ctype)
                    torch.cuda.synchronize()
                    err = normwise(out, ref)
                    err_abs = float((out - ref).abs().max())
                    same = bool(torch.equal(out, again))
                    print(f"[kernel] cla_chain {ctype} codes ({groups}, {n}) "
                          f"dmax {dmax} k={k} w=({n},{wc}) "
                          f"{str(dtype)[6:]}: normwise {err:.3e} (bar "
                          f"{CHAIN_BARS[dtype]:g}), max abs {err_abs:.3e}, "
                          f"repeat bit-identical {same}", flush=True)
                    if cla_dev.chain_kernel.launches != before + 2:
                        fail("cla_chain: the kernel did not launch")
                    if not err <= CHAIN_BARS[dtype] or not same:
                        fail(f"cla_chain {ctype} ({groups}, {n}) k={k} "
                             f"{dtype}: normwise {err}, repeat identical "
                             f"{same}")
                    if (n, dtype, k, ctype) == (CENSUS_N, torch.float32, 1,
                                                "XtXv"):
                        abs_err = err_abs
        if n == CENSUS_N:
            check_chain_special(codes, dev, gen)
        del codes
    # blocks that K6 refuses by layout take the gather arm, counted
    rng = np.random.default_rng(5)
    n = 100_003
    base = [rng.standard_normal(d)[rng.integers(0, d, n)] for d in (2, 5, 8)]
    for label, extra in (
            ("a dictionary of 9", rng.standard_normal(9)[
                rng.integers(0, 9, n)]),
            ("an uncompressed column", rng.standard_normal(n))):
        xh = np.column_stack(base + [extra]).astype(np.float32)
        c = compress(xh)
        v = torch.randn(4, 1, generator=gen, device=dev)
        st = stats.Statistics()
        before = cla_dev.chain_kernel.launches
        with stats.stats_scope(st):
            out = mult.mmchain(c, v)
        xd = torch.from_numpy(xh).to(dev).double()
        err = normwise(out, xd.T @ (xd @ v.double()))
        by_layout = st.estim_counts.get("cla_chain_plain_by_layout", 0)
        print(f"[kernel] cla_chain refused by layout, {label} ({n} x 4): "
              f"cla_chain_plain_by_layout {by_layout}, K6 launches "
              f"{cla_dev.chain_kernel.launches - before}, gather arm "
              f"normwise {err:.3e}", flush=True)
        if by_layout != 1 or cla_dev.chain_kernel.launches != before \
                or not err <= 1e-5:
            fail(f"the compressed mmchain on a block with {label} did not "
                 f"take the gather arm by layout")
    torch.cuda.empty_cache()
    return abs_err


def run_cla_path(name, cla, data, dev, kernels, regions: bool = True):
    """One unprofiled run at optlevel 2 with `cla` on the categorical X,
    after a warm-up on its first 200,000 rows (which compresses too, so
    that the compressed ops' first calls, their allocations and cuBLAS's
    choices for the table's shape, are not in the timed loop); the launch
    counters are set to 0 just before it and read just after. `regions`
    False runs it with codegen_enabled False; then LinearRegCG-cla runs
    once more under torch.profiler (its loop's busy share)."""
    from systemml_tpu_torch.api.mlcontext import MLContext

    cfg = config(2, regions)
    cfg.cla = cla
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    ml.execute(path_script(name, data, rows=200_000))
    lines = []
    ml.printer = lines.append
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)   # the data of every path
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        out = ml.execute(path_script(name, data)).get_tensor(PATHS[name][3])
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    iters = outer_iterations(name, lines)
    events = {k: v for k, v in ml._stats.estim_counts.items()
              if k.startswith(("cla_", "kb_pick_cla_"))}
    tag = f"{name}-cla cla={cla}" + ("" if regions else " eager")
    windows = phase_windows(timer, iters, tag, PATHS[name][5])
    reg = region_report(timer, tag, "LinearRegCG-cla" if (name, cla) == (
        "LinearRegCG", "auto") else name, regions)
    comp_s = sum(w[0] for w in timer.windows["compress"]) / 1e3
    layout_ms = windows["compress_host_ms"] - 1e3 * comp_s
    windows["compression_s"] = comp_s
    for s in lines[-1:]:
        print(f"[script] {s}")
    print(f"[cla] {tag} on ({CENSUS_N}, {CENSUS_M}) fp32: {iters} "
          f"outer iterations, {windows['iteration_ms']:.3f} ms per outer "
          f"iteration (device window; host "
          f"{windows['iteration_host_ms']:.3f} ms), loop-entry compression "
          f"{comp_s:.3f} s, device layouts in the loop {layout_ms:.3f} ms; "
          f"{secs:.3f} s in all; "
          f"launches {launches}; {events}; peak allocated "
          f"{peak / 1e9:.3f} GB, {(peak - base) / 1e9:.3f} GB over the "
          f"data allocated before the run (X "
          f"{CENSUS_N * CENSUS_M * 4 / 1e9:.3f} GB among it)", flush=True)
    if out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        fail(f"{name} cla={cla}: output {out.dtype} not finite fp32")
    compressed = events.get("cla_auto_compressed", 0)
    if compressed != (1 if cla == "auto" else 0):
        fail(f"{name} cla={cla}: cla_auto_compressed {compressed}")
    if events.get("cla_chain_plain_by_layout", 0):
        fail(f"{name} cla={cla}: the compressed mmchain took the gather arm "
             f"by layout")
    chain = iters if (name == "LinearRegCG" and cla == "auto") else 0
    if launches["cla_chain"] != chain or iters < 1:
        fail(f"{name} cla={cla}: K6 launched {launches['cla_chain']} times "
             f"in {iters} outer iterations")
    result = {"out": out, "iterations": iters, "seconds": secs,
              "exec_seconds": ml._stats.run_time, "launches": launches,
              "peak_bytes": peak, "peak_reserved": peak_reserved,
              "peak_over_data_bytes": peak - base, "lines": lines,
              "windows": windows, "events": events, "regions": reg,
              "compressed": timer.compressed}
    if name == "LinearRegCG" and cla == "auto" and not regions:
        # the CG loop's period and busy share, from K6's launches (one
        # cla_chain_reduce each)
        result["profile"] = profile_main_path(
            ml, path_script(name, data), False, kernel="cla_chain_reduce")
    return result


def cla_paths(dev, kernels) -> dict:
    """LinearRegCG-cla and l2-svm on the categorical X, each with cla
    "auto" and "false"; the outputs agree within 1e-3, and beta is within
    1e-3 of beta_true."""
    data = make_census(dev)
    print(f"[cla] categorical X ({CENSUS_N}, {CENSUS_M}) fp32, "
          f"{CENSUS_N * CENSUS_M * 4 / 1e9:.3f} GB dense; values per "
          f"column {data['dims']}", flush=True)
    out = {"data": data}
    for name in ("LinearRegCG", "l2-svm"):
        runs = {cla: run_cla_path(name, cla, data, dev, kernels)
                for cla in ("auto", "false")}
        if name == "LinearRegCG":
            # the CG loop as one graph against its eager run (K6's
            # launches equal, the busy share), and a repeat, bit for bit
            runs["auto-eager"] = run_cla_path(name, "auto", data, dev,
                                              kernels, regions=False)
            runs["auto-repeat"] = run_cla_path(name, "auto", data, dev,
                                               kernels)
            runs["auto"]["versus_eager"] = compare_eager(
                "LinearRegCG-cla", runs["auto"], runs["auto-eager"])
            same = bool(torch.equal(runs["auto"]["out"],
                                    runs["auto-repeat"]["out"]))
            print(f"[cla] LinearRegCG-cla: a repeat of the region run "
                  f"bit-identical {same}", flush=True)
            if not same:
                fail("LinearRegCG-cla: two runs of the region differ")
            runs["auto"]["repeat_bit_identical"] = same
        a, b = runs["auto"]["out"].double(), runs["false"]["out"].double()
        diff = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        print(f"[cla] {name}: |cla auto - cla false| / |cla false| = "
              f"{diff:.3e} (bar 1e-3); ms per outer iteration "
              f"{runs['auto']['windows']['iteration_ms']:.3f} / "
              f"{runs['false']['windows']['iteration_ms']:.3f}", flush=True)
        if not diff <= 1e-3:
            fail(f"{name}: cla auto is {diff} from cla false")
        if name == "LinearRegCG":
            bt = data["beta_true"].double()
            rel = float(torch.linalg.norm(a - bt) / torch.linalg.norm(bt))
            print(f"[cla] LinearRegCG-cla: |beta - beta_true| / "
                  f"|beta_true| = {rel:.3e} (bar 1e-3)", flush=True)
            if not rel <= 1e-3:
                fail(f"LinearRegCG-cla: beta is {rel} from beta_true")
            runs["auto"]["beta_true_rel_err"] = rel
        runs["auto"]["diff_from_cla_false"] = diff
        out[name] = runs
    return out


def time_chain_kernel(cla, dev, smi, max_abs_err) -> dict:
    """K6 at the path's own compressed X (the block LinearRegCG-cla bound
    at its loop entry), k = 1, fp32: the kernel, its plain version, the
    whole compressed chain around it (table, kernel, output assembly), the
    gather arm, and the two-pass torch.matmul on the dense X. Returns the
    kernel's record."""
    from systemml_tpu_torch.compress import device as cla_dev

    c = cla["LinearRegCG"]["auto"]["compressed"][0]
    lay = cla_dev.chain_layout(c)
    gen = torch.Generator(device=dev).manual_seed(6)
    v = torch.randn(CENSUS_M, 1, generator=gen, device=dev)
    sv = cla_dev.chain_table(lay, v)
    xc = cla["data"]["X"]
    one = cla_dev.chain_codes(torch.full_like(lay.codes, 3))
    kern = lambda: cla_dev.chain_kernel(lay.codes, sv)
    # 50 calls a reading, as the bench: the host launches a call in a
    # third of the kernel's time, so only the first call's launch is idle
    events_ms, one_events_ms = time_ms(
        [kern, lambda: cla_dev.chain_kernel(one, sv)], reps=50)
    plain_ms, call_ms, gather_ms, dense_ms = time_ms([
        lambda: cla_dev.chain_plain(lay.codes, sv),
        lambda: cla_dev.chain_mmchain(c, v),
        lambda: cla_dev.gather_mmchain(c, v, None, "XtXv"),
        lambda: torch.matmul(xc.T, torch.matmul(xc, v)),
    ], reps=10)
    # beside the events, the card's time per call alone (torch.profiler)
    kern_ms = device_ms(kern)
    one_ms = device_ms(lambda: cla_dev.chain_kernel(one, sv))
    call_dev_ms = device_ms(lambda: cla_dev.chain_mmchain(c, v))
    wrapper_us = host_us({"k6": kern}, reps=100, rounds=4)[0]["k6"]
    k = 1
    nbytes = (lay.codes.numel() + sv.numel() * sv.element_size()
              + 8 * lay.dmax * lay.groups * k)   # codes, table in; out
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2.0 * lay.groups * lay.n * k / FP32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[times] cla_chain XtXv codes ({lay.groups}, {lay.n}) dmax "
          f"{lay.dmax} k=1 fp32 on {smi}: kernel {events_ms:.4f} ms by CUDA "
          f"events over back-to-back calls, {kern_ms:.4f} ms device time "
          f"per call (torch.profiler), the wrapper's host time "
          f"{wrapper_us:.1f} us a call; every row on one code "
          f"{one_events_ms:.4f} ms ({one_ms:.4f} device time); plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
          f"{bytes_ms:.4f}, operations {ops_ms:.4f}); the whole compressed "
          f"chain (table, kernel, assembly) {call_ms:.4f} ms by events, "
          f"{call_dev_ms:.4f} ms device time, the gather "
          f"arm {gather_ms:.4f} ms; yardstick, the two-pass torch.matmul "
          f"on the dense X ({xc.numel() * 4 / 1e9:.3f} GB) {dense_ms:.4f} "
          f"ms (no single torch call computes a compressed chain)",
          flush=True)
    return {"name": "cla_chain", "route": "cuda",
            "source": "systemml_tpu_torch/codegen/csrc/cla_chain.cu",
            "replaces": "systemml_tpu/compress/device.py:525 "
                        "_chain_kernel_call",
            "launches": cla["LinearRegCG"]["auto"]["launches"]["cla_chain"],
            "max_abs_err": max_abs_err["cla_chain"], "ms": events_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "device_ms": kern_ms,
            "one_code_ms": one_events_ms, "one_code_device_ms": one_ms,
            "wrapper_host_us": wrapper_us, "chain_call_ms": call_ms,
            "chain_call_device_ms": call_dev_ms,
            "gather_arm_ms": gather_ms, "dense_two_pass_ms": dense_ms}


def _left_by_bincount(dc, yt):
    """The compressed left mult as it was summed before its fixed-order
    layout: torch.bincount of each group's codes weighted by yt's one row
    (float atomics; the call reads the largest code on the host)."""
    from systemml_tpu_torch.compress import device as cla_dev

    out = torch.zeros((1, dc.shape[1]), dtype=yt.dtype, device=yt.device)
    for g in dc.groups:
        if g.coded:
            sums = torch.bincount(g.index(), weights=yt[0],
                                  minlength=g.dict.shape[0]).reshape(1, -1)
            part = cla_dev._mm(sums.to(yt.dtype), g.dict)
        else:
            part = cla_dev._mm(yt, g.vals)
        out.index_copy_(1, g.cols_dev, part.to(out.dtype))
    return out


def time_left_mult(cla, dev, smi) -> dict:
    """The compressed left mult t(X) %*% y (k = 1, fp32) on the block
    LinearRegCG-cla bound: its fixed-order segment sums (compress/device
    Segments) against bincount, by CUDA events, the two within 1e-5
    normwise and a repeat bit-identical; and one group of 65,536 codes
    over as many rows as the block, 60% of them on one code: the layout's
    bytes and build time, its sums against bincount (fp64 within 1e-12 of
    the largest sum), and the peak memory a call adds."""
    from systemml_tpu_torch.compress import device as cla_dev

    c = cla["LinearRegCG"]["auto"]["compressed"][0]
    dc = cla_dev.device_mirror(c)
    gen = torch.Generator(device=dev).manual_seed(8)
    yt = torch.randn(1, CENSUS_N, generator=gen, device=dev)
    left = lambda: cla_dev._left(dc, yt)
    a, b = left(), _left_by_bincount(dc, yt)
    same = bool(torch.equal(a, left()))
    err = normwise(a, b)
    left_ms, bincount_ms = time_ms([left, lambda: _left_by_bincount(dc, yt)])
    coded = [g for g in dc.groups if g.coded]
    layout = sum(seg.nbytes() for seg, _ in dc.streams)
    code_bytes = sum(g.codes.numel() * g.codes.element_size() for g in coded)
    print(f"[cla-left] t(X) %*% y on the Census-shaped block ({CENSUS_N}, "
          f"{CENSUS_M}), {len(coded)} coded groups in {len(dc.streams)} "
          f"segment streams, fp32, on {smi}: "
          f"fixed-order segment sums {left_ms:.4f} ms, bincount "
          f"{bincount_ms:.4f} ms (CUDA events over back-to-back calls); "
          f"normwise {err:.3e} (bar 1e-5), a repeat bit-identical {same}; "
          f"layouts {layout / 1e6:.1f} MB beside {code_bytes / 1e6:.1f} MB "
          f"of codes", flush=True)
    if not err <= 1e-5 or not same:
        fail(f"compressed left mult: {err} from bincount, repeat same {same}")
    n, d = CENSUS_N, 65_536
    codes = torch.randint(0, d, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    codes[torch.rand(n, generator=gen, device=dev) < 0.6] = 123
    y = torch.randn(1, n, generator=gen, device=dev, dtype=torch.float64)
    ext = torch.cat([y, torch.zeros(1, 1, dtype=y.dtype, device=dev)], 1)
    seg = cla_dev.Segments([codes], [d])
    build_ms, sums_ms, count_ms = time_ms([
        lambda: cla_dev.Segments([codes], [d]), lambda: seg.sums(ext),
        lambda: torch.bincount(codes, weights=y[0], minlength=d)], reps=5)
    got = seg.sums(ext)
    ref = torch.bincount(codes, weights=y[0], minlength=d)
    diff = float((got[0] - ref).abs().max() / ref.abs().max())
    same_many = bool(torch.equal(got, seg.sums(ext)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    seg.sums(ext)
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"[cla-left] one group of {d} codes over {n} rows, 60% on one "
          f"code, fp64: layout {seg.nbytes() / 1e6:.2f} MB built in "
          f"{build_ms:.3f} ms; sums {sums_ms:.4f} ms against bincount "
          f"{count_ms:.4f} ms; max difference {diff:.3e} of the largest "
          f"sum (bar 1e-12); a repeat bit-identical {same_many}; a call's "
          f"peak {call_peak / 1e6:.1f} MB over its inputs", flush=True)
    if not diff <= 1e-12 or not same_many:
        fail(f"segment sums of {d} codes: {diff} from bincount, repeat "
             f"same {same_many}")
    return {"census_left_ms": left_ms, "census_bincount_ms": bincount_ms,
            "census_normwise": err, "census_layout_bytes": layout,
            "census_code_bytes": code_bytes, "many_codes_build_ms": build_ms,
            "many_codes_sums_ms": sums_ms, "many_codes_bincount_ms": count_ms,
            "many_codes_layout_bytes": seg.nbytes(),
            "many_codes_call_peak_bytes": call_peak,
            "many_codes_max_rel_diff": diff}


# --------------------------------------------------------------------------
# ALS-CG-ml10m and the ratings summary: K5 (outer) and K3 (multiagg)
# --------------------------------------------------------------------------

def make_ratings(dev):
    """V (ML10M_USERS, ML10M_MOVIES) fp32 of the MovieLens 10M shape, from
    one seeded generator on the card: a Bernoulli pattern at the published
    density; each rating a rank-10 product (mean 3.5, sd about 1.1) plus
    N(0, 0.5^2) noise, rounded to half stars and clipped to 0.5..5.0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    users, movies = ML10M_USERS, ML10M_MOVIES
    a = torch.randn(users, 10, generator=gen, device=dev)
    b = torch.randn(movies, 10, generator=gen, device=dev)
    v = torch.matmul(a, b.T).mul_(0.35).add_(3.5)
    v.add_(torch.randn(users, movies, generator=gen, device=dev), alpha=0.5)
    v.mul_(2.0).round_().div_(2.0).clamp_(0.5, 5.0)
    density = ML10M_RATINGS / (users * movies)
    v.mul_(torch.rand(users, movies, generator=gen, device=dev) < density)
    return v


def als_script(v):
    from systemml_tpu_torch.api.mlcontext import dmlFromFile

    s = dmlFromFile(os.path.join(ALG, "ALS-CG.dml")).input("V", v)
    for k, val in ALS_ARGS.items():
        s.arg(k, val)
    return s.output("L", "R")


def summary_script(v):
    from systemml_tpu_torch.api.mlcontext import dml

    return dml(SUMMARY).input("V", v).output("s", "lo", "hi")


def compile_als():
    """ALS-CG and the ratings summary at optlevel 3 on the card (inputs
    unbound: compile_program reads their names); each builds its plans."""
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.config import get_config, set_config

    old = get_config()
    set_config(config(3))
    try:
        progs = {}
        for name, s in (("ALS-CG", als_script(None)),
                        ("summary", summary_script(None))):
            progs[name] = compile_program(
                s.parse(), clargs=s._args, outputs=s._outputs,
                input_names=list(s._inputs))
        return progs
    finally:
        set_config(old)


def _plan_of(prog, template):
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    hops = [h for h in iter_spoof_hops(prog)
            if h.params["template"] == template]
    if len(hops) != 1:
        fail(f"expected one {template} plan, found {templates_of(prog)}")
    return hops[0]


def _scalar_outer_plan():
    """An outer plan with a host-number leaf a and a 0-d tensor leaf b:
    (X - a * UV) * exp(min(UV, b))."""
    from systemml_tpu_torch.codegen.cplan import CNode

    i = lambda nm: CNode("in", name=nm)
    n = lambda op, *kids: _n(CNode, op, *kids)
    return n("b(*)", n("b(-)", i("X"), n("b(*)", i("a"), i("UV"))),
             n("u(exp)", n("b(min)", i("UV"), i("b"))))


def _check_scalars(label, outs, agains, refs, bar, abs_errs, key,
                   scales=None):
    """outs/agains from the kernel, refs from the plain version in fp64,
    one per aggregate: each error relative to |ref| (to its scale, the sum
    of the summands' magnitudes, for a sum that may cancel to near 0)
    within bar, NaN where ref is NaN, bit-identical repeats. Prints one
    line with the largest error."""
    torch.cuda.synchronize()
    worst, worst_abs, ok, same = 0.0, 0.0, True, True
    for i, (out, again, ref) in enumerate(zip(outs, agains, refs)):
        o, a, r = float(out), float(again), float(ref)
        same &= (o == a) or (o != o and a != a)
        if r != r:
            ok &= o != o
            continue
        abs_err = abs(o - r)
        den = abs(r) if scales is None or scales[i] is None else scales[i]
        err = abs_err / den if den else abs_err
        ok &= err <= bar
        worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
    print(f"[kernel] {label}: largest relative error {worst:.3e} (bar "
          f"{bar:g}), abs {worst_abs:.3e}, NaN as the plain version and "
          f"within the bar {ok}, repeat bit-identical {same}", flush=True)
    if not ok or not same:
        fail(f"{label}: relative error {worst}, NaN places or bar {ok}, "
             f"repeat identical {same}")
    if key is not None:
        abs_errs[key] = max(abs_errs.get(key, 0.0), worst_abs)


def check_outer_kernel(als_hop, v32, dev, kernels, abs_errs) -> None:
    """K5 against outer_plain in fp64 on the card: at ALS-CG-ml10m's shape
    (X its 0/1 pattern, U and V rank 10, its loss plan) and at a ragged
    (100,003, 777, r = 3) X of ratings, fp32 and fp64, with the loss plan
    and a plan of a host-number and a 0-d scalar leaf, without and with
    NaN in X; each twice."""
    gen = torch.Generator(device=dev).manual_seed(7)
    loss_plan, scal_plan = als_hop.params["plan"], _scalar_outer_plan()
    for shape in ((ML10M_USERS, ML10M_MOVIES, 10), (100_003, 777, 3)):
        m, n, r = shape
        if m == ML10M_USERS:
            x32 = (v32 != 0).to(torch.float32)
        else:
            x32 = torch.randint(1, 11, (m, n), generator=gen,
                                device=dev).float().div_(2.0)
            x32.mul_(torch.rand(m, n, generator=gen, device=dev) < 0.3)
        u32 = torch.randn(m, r, generator=gen, device=dev) / math.sqrt(r)
        w32 = torch.randn(n, r, generator=gen, device=dev)
        for dtype in (torch.float32, torch.float64):
            x, u, w = x32.to(dtype), u32.to(dtype), w32.to(dtype)
            extra = {"a": 0.5, "b": torch.tensor(0.75, device=dev,
                                                 dtype=torch.float64)}
            for nan in (False, True):
                if nan:
                    keep = float(x[m // 2, n // 3])
                    x[m // 2, n // 3] = float("nan")
                for label, plan in (("ALS-CG loss", loss_plan),
                                    ("scalar leaves", scal_plan)):
                    before = kernels.outer_kernel.launches
                    out = kernels.outer_kernel(plan, x, u, w, extra)
                    again = kernels.outer_kernel(plan, x, u, w, extra)
                    ref = kernels.outer_plain(plan, x.double(), u.double(),
                                              w.double(), extra)
                    if kernels.outer_kernel.launches != before + 2:
                        fail(f"outer {label}: the kernel did not launch")
                    key = ("outer" if (m, dtype, nan, label) == (
                        ML10M_USERS, torch.float32, False, "ALS-CG loss")
                        else None)
                    _check_scalars(
                        f"outer {label} X ({m}, {n}) r={r} "
                        f"{str(dtype)[6:]}{' NaN in X' if nan else ''}",
                        [out], [again], [ref], SPOOF_BARS[dtype], abs_errs,
                        key)
                    del ref
                if nan:
                    x[m // 2, n // 3] = keep
            del x, u, w
            torch.cuda.empty_cache()
        del x32, u32, w32
    torch.cuda.empty_cache()


def check_multiagg_kernel(summary_hop, v32, progs, dev, kernels,
                          abs_errs) -> None:
    """K3 against multiagg_plain in fp64 on the card: the ratings
    summary's plan over V (fp32 and fp64, with and without a NaN in V)
    and the kernel phase's ragged (100,003, 7) plans of every layout and
    of NaN, every aggregate order of AGG_ORDERS; each twice."""
    plan = summary_hop.params["plan"]
    names = list(summary_hop.params["leaf_names"])
    if len(names) != 4:
        fail(f"the summary's plan has leaves {names}")
    gen = torch.Generator(device=dev).manual_seed(8)

    def cases():   # one at a time: V in fp64 alone is 6.1 GB
        for dtype in (torch.float32, torch.float64):
            vd = v32.to(dtype)
            env = {names[0]: vd, names[1]: vd, names[2]: vd.sum(),
                   names[3]: (vd != 0).sum().to(dtype)}
            yield (f"summary V ({ML10M_USERS}, {ML10M_MOVIES})", plan,
                   names, env, dtype, vd)
        for label, tmpl, rplan, rnames, hop in kernel_plans(progs)[2:]:
            if label == "every op" or tmpl is not None:
                continue
            for dtype in (torch.float32, torch.float64):
                yield (f"{label} (100003, 7)", rplan, rnames,
                       kernel_env(label, hop, rnames, dtype, dev, gen),
                       dtype, None)

    for label, cplan, cnames, env, dtype, poke in cases():
        envd = {k: (t.double() if isinstance(t, torch.Tensor) else t)
                for k, t in env.items()}
        for nan in ((False, True) if poke is not None else (False,)):
            if nan:
                keep = float(poke[123, 456])
                poke[123, 456] = float("nan")
                envd = {k: (t.double() if isinstance(t, torch.Tensor) else t)
                        for k, t in env.items()}
            # a sum's error is held against the sum of |value| (the
            # summary's sum cancels to near 0)
            scale = float(kernels._plain_value(cplan, cnames, envd).abs()
                          .nansum())
            for aggs in AGG_ORDERS:
                before = kernels.multiagg_kernel.launches
                out = kernels.multiagg_kernel(cplan, cnames, aggs, env)
                again = kernels.multiagg_kernel(cplan, cnames, aggs, env)
                ref = kernels.multiagg_plain(cplan, cnames, aggs, envd)
                if kernels.multiagg_kernel.launches != before + 2:
                    fail(f"multiagg {label}: the kernel did not launch")
                key = ("multiagg" if (poke is not None and dtype ==
                                      torch.float32 and not nan) else None)
                _check_scalars(
                    f"multiagg {label} {str(dtype)[6:]} "
                    f"{'NaN ' if nan else ''}aggs {list(aggs)}", out, again,
                    ref, SPOOF_BARS[dtype], abs_errs, key,
                    [scale if a == "sum" else None for a in aggs])
            if nan:
                poke[123, 456] = keep
        del env, envd, poke
        torch.cuda.empty_cache()


def check_rand(dev) -> None:
    """The port's rand() on the card against its rand() on the CPU, bit
    for bit, in fp32 and fp64: ALS-CG's factor draw at the path's shape
    and a ranged, sparse draw."""
    from systemml_tpu_torch.ops import datagen

    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.float64, torch.int64)):
        for rows, cols, lo, hi, sp, seed in (
                (ML10M_USERS, 10, 0.0, 1.0, 1.0, 1234),
                (1000, 1000, -2.5, 3.7, 0.3, 7)):
            a = datagen.rand(rows, cols, lo, hi, sp, seed=seed, dtype=dtype,
                             device=dev)
            b = datagen.rand(rows, cols, lo, hi, sp, seed=seed, dtype=dtype,
                             device="cpu")
            same = bool(torch.equal(a.cpu().view(bits), b.view(bits)))
            print(f"[kernel] rand ({rows}, {cols}) [{lo}, {hi}) sparsity {sp} "
                  f"seed {seed} {str(dtype)[6:]}: card equals CPU bit for bit "
                  f"{same}", flush=True)
            if not same:
                fail(f"rand {rows}x{cols} {dtype}: the card's draw differs "
                     f"from the CPU's")


_LOSS_MARK = "ALS-CG: iterations = "


def run_als(optlevel, v, dev, kernels, regions=True) -> dict:
    """One unprofiled run of ALS-CG-ml10m through MLContext, after a
    warm-up on the first 8,192 users; the launch counters are set to 0
    just before it and read just after. `regions` False: with
    codegen_enabled False."""
    from systemml_tpu_torch.api.mlcontext import MLContext

    ml = MLContext(config(optlevel, regions))
    ml.printer = lambda s: None
    ml.execute(als_script(v[:8192]))
    lines = []
    ml.printer = lines.append
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer, SpoofSpy() as spy:
        res = ml.execute(als_script(v))
        lo, ro = res.get_tensor("L"), res.get_tensor("R")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    hits = [s for s in lines if s.startswith(_LOSS_MARK)]
    if len(hits) != 1:
        fail(f"ALS-CG optlevel {optlevel} printed {lines}")
    iters = int(hits[0][len(_LOSS_MARK):].split(",")[0])
    loss = float(hits[0].split("loss = ")[1])
    events = dict(ml._stats.estim_counts.items())
    tag = f"ALS-CG-ml10m optlevel {optlevel}" + ("" if regions else " eager")
    windows = phase_windows(timer, iters, tag, "outer loop")
    reg = region_report(timer, tag, "ALS-CG", regions)
    print(f"[script] {hits[0]}")
    print(f"[als] ALS-CG-ml10m optlevel {optlevel}: {iters} outer "
          f"iterations, {secs:.3f} s with parse and compile, "
          f"{ml._stats.run_time:.3f} s executing; "
          f"{windows['iteration_ms']:.3f} ms per outer iteration (device "
          f"window; host {windows['iteration_host_ms']:.3f} ms); launches "
          f"{launches}; events { {k: c for k, c in events.items() if k.startswith(('spoof_', 'spx_', 'cla_'))} }; "
          f"peak allocated {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB "
          f"over the data allocated before the run, V "
          f"{v.numel() * 4 / 1e9:.3f} GB among it); {walk_line(events)}",
          flush=True)
    check_walks(f"ALS-CG optlevel {optlevel}", events, launches)
    for t, nm in ((lo, "L"), (ro, "R")):
        if t.dtype != torch.float32 or t.device != v.device \
                or not bool(torch.isfinite(t).all()) or t.shape[1] != 10:
            fail(f"ALS-CG optlevel {optlevel}: {nm} is {t.dtype} "
                 f"{tuple(t.shape)} on {t.device}, or not finite")
    if events.get("spoof_compile_errors", 0):
        fail(f"ALS-CG optlevel {optlevel}: spoof_compile_errors "
             f"{events['spoof_compile_errors']}")
    if launches["cla_chain"] or events.get("cla_auto_compressed", 0):
        fail(f"ALS-CG optlevel {optlevel}: a value was compressed")
    if optlevel >= 3:
        if launches["spoof_outer"] != iters or iters < 1:
            fail(f"ALS-CG optlevel 3: K5 launched {launches['spoof_outer']} "
                 f"times in {iters} outer iterations")
        if launches["spoof_cell"] < 1:
            fail("ALS-CG optlevel 3: the spoof cell kernel never launched")
        # sum((wrowL * L) * L) and sum((wrowR * R) * R): an (n, 1) main
        # leaf beside an (n, rank) leaf, a layout that the JAX package's
        # kernel refuses too (its _leaf_layout), run by the plain arm
        if events.get("spoof_plain_by_layout", 0) != 2 * iters:
            fail(f"ALS-CG optlevel 3: spoof_plain_by_layout "
                 f"{events.get('spoof_plain_by_layout', 0)}, not the two "
                 f"regularizer plans per outer iteration ({2 * iters})")
    else:
        if any(launches[k] for k in ("spoof_cell", "spoof_row",
                                     "spoof_outer", "spoof_multiagg")):
            fail(f"ALS-CG optlevel 2 launched spoof kernels: {launches}")
        if not events.get("spx_wdivmm_dense", 0):
            fail("ALS-CG optlevel 2 did not run the dense wdivmm arm")
    # device time by kernel and the device's busy share from one more run
    # under torch.profiler; at optlevel 3 also the outer loop's period (K5
    # launches once per outer iteration)
    profile = profile_main_path(ml, als_script(v), False, kernel="outer_sum",
                                loop="outer loop")
    return {"L": lo, "R": ro, "iterations": iters, "loss": loss,
            "LR": torch.cat([lo.flatten(), ro.flatten()]),
            "profile": profile,
            "cell_sums": spy.most_launched() if spy.counts else None,
            "seconds": secs, "exec_seconds": ml._stats.run_time,
            "launches": launches, "peak_bytes": peak,
            "peak_reserved": peak_reserved, "regions": reg,
            "peak_over_data_bytes": peak - base, "windows": windows,
            "events": {k: c for k, c in events.items()
                       if k.startswith(("spoof_", "spx_", "cla_"))}}


def run_summary(optlevel, v, kernels) -> dict:
    from systemml_tpu_torch.api.mlcontext import MLContext

    ml = MLContext(config(optlevel))
    ml.printer = lambda s: None
    ml.execute(summary_script(v[:8192]))
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    res = ml.execute(summary_script(v))
    vals = {k: float(res.get(k)) for k in ("s", "lo", "hi")}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    events = dict(ml._stats.estim_counts.items())
    print(f"[summary] ratings summary optlevel {optlevel}: {vals}, "
          f"{secs:.3f} s with parse and compile; launches {launches}; "
          f"{walk_line(events)}; spoof_plain_by_layout "
          f"{events.get('spoof_plain_by_layout', 0)}", flush=True)
    check_walks(f"summary optlevel {optlevel}", events, launches)
    want = 1 if optlevel >= 3 else 0
    if launches["spoof_multiagg"] != want:
        fail(f"summary optlevel {optlevel}: K3 launched "
             f"{launches['spoof_multiagg']} times, not {want}")
    if events.get("spoof_plain_by_layout", 0) or \
            events.get("spoof_compile_errors", 0):
        fail(f"summary optlevel {optlevel}: {events}")
    return {"values": vals, "seconds": secs, "launches": launches}


def als_paths(v, progs, dev, kernels) -> dict:
    """ALS-CG-ml10m at optlevels 3 and 2, then the ratings summary at 3
    and 2, on V."""
    for name in ("ALS-CG", "summary"):
        for t in templates_of(progs[name]):
            print(f"[plans] {name} optlevel 3: {t[0]} {t[1]}: {t[2]}")
    runs = {o: run_als(o, v, dev, kernels) for o in (3, 2)}
    eag = run_als(3, v, dev, kernels, regions=False)
    versus_eager = compare_eager("ALS-CG-ml10m optlevel 3", runs[3], eag,
                                 key="LR")
    del eag
    diffs = {}
    for nm in ("L", "R"):
        a, b = runs[3][nm].double(), runs[2][nm].double()
        diffs[nm] = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    loss_rel = abs(runs[3]["loss"] - runs[2]["loss"]) / abs(runs[2]["loss"])
    print(f"[als] ALS-CG-ml10m: |optlevel 3 - optlevel 2| / |optlevel 2|: L "
          f"{diffs['L']:.3e}, R {diffs['R']:.3e}, loss {loss_rel:.3e} (bars "
          f"1e-3); outer iterations {runs[3]['iterations']} / "
          f"{runs[2]['iterations']}; ms per outer iteration "
          f"{runs[3]['windows']['iteration_ms']:.3f} / "
          f"{runs[2]['windows']['iteration_ms']:.3f}", flush=True)
    if not (diffs["L"] <= 1e-3 and diffs["R"] <= 1e-3 and loss_rel <= 1e-3):
        fail(f"ALS-CG optlevel 3 is {diffs}, loss {loss_rel} from optlevel 2")
    summ = {o: run_summary(o, v, kernels) for o in (3, 2)}
    z_abs = float((v - v.sum(dtype=torch.float64) / (v != 0).sum())
                  .mul_(v != 0).abs().sum(dtype=torch.float64))
    s3, s2 = summ[3]["values"], summ[2]["values"]
    errs = {"s": abs(s3["s"] - s2["s"]) / z_abs,
            "lo": abs(s3["lo"] - s2["lo"]) / abs(s2["lo"]),
            "hi": abs(s3["hi"] - s2["hi"]) / abs(s2["hi"])}
    print(f"[summary] optlevel 3 against 2: s {errs['s']:.3e} of sum|Z| = "
          f"{z_abs:.6e} (bar 1e-6), lo {errs['lo']:.3e}, hi {errs['hi']:.3e} "
          f"relative (bars 1e-5)", flush=True)
    if not (errs["s"] <= 1e-6 and errs["lo"] <= 1e-5 and errs["hi"] <= 1e-5):
        fail(f"ratings summary optlevel 3 is {errs} from optlevel 2")
    out = {f"optlevel{o}": {k: val for k, val in r.items()
                            if k not in ("L", "R", "LR", "cell_sums")}
           for o, r in runs.items()}
    out["versus_eager"] = versus_eager
    out.update({"diff_from_optlevel2": diffs, "loss_rel_diff": loss_rel,
                "templates": templates_of(progs["ALS-CG"]),
                "summary": {f"optlevel{o}": r for o, r in summ.items()},
                "summary_errors": errs,
                "factors": (runs[3]["L"], runs[3]["R"]),
                "cell_sums": runs[3]["cell_sums"]})
    return out


# --------------------------------------------------------------------------
# the sparse plane's paths: ALS-CG over a CSR V (runtime/sparse.py)
# --------------------------------------------------------------------------

# the Netflix Prize ratings (Bennett and Lanning, KDD Cup 2007): users,
# movies, ratings; a dense fp32 V of that shape takes 34.13 GB
NETFLIX_USERS, NETFLIX_MOVIES, NETFLIX_RATINGS = 480_189, 17_770, 100_480_507
NETFLIX_DENSE_BYTES = NETFLIX_USERS * NETFLIX_MOVIES * 4
# the one reason a region over a sparse invariant may be refused for
SPARSE_REFUSAL = "sparse view"
SPARSE_EVENTS = ("spx_", "spmm_", "spgemm_", "sp_tsmm_", "sddmm",
                 "sparse_densify")


def make_netflix(dev):
    """V of the Netflix Prize shape as CSR on the card, from one seeded
    generator: cell keys drawn uniformly over users x movies, sorted, the
    distinct ones kept and topped up to NETFLIX_RATINGS; each rating as
    make_ratings' (a rank-10 product plus N(0, 0.5^2) noise, rounded to
    half stars in 0.5..5.0). No dense (users, movies) tensor is made.
    Returns the torch sparse CSR tensor and the seconds it took."""
    import warnings

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2)
    users, movies, n = NETFLIX_USERS, NETFLIX_MOVIES, NETFLIX_RATINGS
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    while keys.numel() < n:
        draw = torch.randint(users * movies, (n - keys.numel(),),
                             generator=gen, device=dev)
        keys = torch.unique(torch.cat([keys, draw]))   # sorted, distinct
    rows, cols = keys // movies, keys % movies
    del keys
    a = torch.randn(users, 10, generator=gen, device=dev)
    b = torch.randn(movies, 10, generator=gen, device=dev)
    vals = torch.zeros(n, device=dev)
    for i in range(10):
        vals.addcmul_(a[:, i][rows], b[:, i][cols])
    vals.mul_(0.35).add_(3.5)
    vals.add_(torch.randn(n, generator=gen, device=dev), alpha=0.5)
    vals.mul_(2.0).round_().div_(2.0).clamp_(0.5, 5.0)
    indptr = torch.searchsorted(rows, torch.arange(users + 1, device=dev))
    del rows, a, b
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        v = torch.sparse_csr_tensor(indptr, cols, vals, size=(users, movies),
                                    check_invariants=False)
    torch.cuda.synchronize()
    return v, time.perf_counter() - t0


def loss_fp64(v, lo, ro, reg):
    """ALS-CG's loss of (L, R) in one plain fp64 pass over V's stored
    cells: sum (v - l . r)^2 + reg (|L|^2 + |R|^2)."""
    crow, col, val = v.crow_indices(), v.col_indices(), v.values()
    rows = torch.repeat_interleave(
        torch.arange(v.shape[0], device=val.device), crow.diff(),
        output_size=val.numel())
    lf, rf = lo.double(), ro.double()
    pred = torch.zeros(val.numel(), dtype=torch.float64, device=val.device)
    for k in range(lf.shape[1]):
        pred.addcmul_(lf[:, k][rows], rf[:, k][col])
    d = val.double() - pred
    return float((d * d).sum() + reg * ((lf * lf).sum() + (rf * rf).sum()))


def run_sparse_als(label, v, optlevel, dev, kernels, regions=True,
                   profile=False) -> dict:
    """One unprofiled run of ALS-CG over the CSR tensor v through MLContext
    (bound as it is: its own tensors on the card), after a warm-up on its
    first 8,192 users; the launch counters and the densify counts are set
    to 0 just before it and read just after. With `profile`, once more
    under torch.profiler (the device's busy share)."""
    from systemml_tpu_torch.api.mlcontext import MLContext
    from systemml_tpu_torch.runtime import sparse as sp

    ml = MLContext(config(optlevel, regions))
    ml.printer = lambda s: None
    head = sp.SparseMatrix.from_csr_tensor(v).slice(0, 8192, 0, v.shape[1])
    ml.execute(als_script(head.to_csr_tensor()))
    del head
    lines = []
    ml.printer = lines.append
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sp.DENSIFY_COUNTS.clear()
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        res = ml.execute(als_script(v))
        lo, ro = res.get_tensor("L"), res.get_tensor("R")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    densify = {f"{m}x{n}": c for (m, n), c in sp.DENSIFY_COUNTS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    hits = [ln for ln in lines if ln.startswith(_LOSS_MARK)]
    if len(hits) != 1:
        fail(f"{label} optlevel {optlevel} printed {lines}")
    iters = int(hits[0][len(_LOSS_MARK):].split(",")[0])
    loss = float(hits[0].split("loss = ")[1])
    events = dict(ml._stats.estim_counts.items())
    tag = f"{label} optlevel {optlevel}" + ("" if regions else " eager")
    windows = phase_windows(timer, iters, tag, "outer loop")
    reg = region_report(timer, tag, label, regions, may_refuse=SPARSE_REFUSAL)
    views = {r["label"]: r["views"] for r in reg.get("regions", ())
             if r.get("views")}
    view_ms = sum(w[0] for w in timer.windows["views"])
    counters = {k: c for k, c in events.items() if k.startswith(SPARSE_EVENTS)}
    print(f"[script] {hits[0]}")
    print(f"[sparse] {tag}: {iters} outer iterations, {secs:.3f} s with "
          f"parse and compile, {ml._stats.run_time:.3f} s executing; "
          f"{windows['iteration_ms']:.3f} ms per outer iteration (device "
          f"window of the loop, its views' set-up left out; host "
          f"{windows['iteration_host_ms']:.3f} ms); in the graph "
          f"{reg.get('graph_iteration_ms', float('nan')):.3f} ms per "
          f"iteration; views {views or 'none'} built in {view_ms:.1f} ms "
          f"host; sparse counters {counters}; launches {launches}; spoof "
          f"{ {k: c for k, c in events.items() if k.startswith('spoof_')} }; "
          f"densifies by shape {densify or 'none'}; peak allocated "
          f"{peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB over the data "
          f"allocated before the run), reserved {peak_reserved / 1e9:.3f} GB",
          flush=True)
    for t, nm, rows in ((lo, "L", v.shape[0]), (ro, "R", v.shape[1])):
        if t.dtype != torch.float32 or t.device.type != "cuda" \
                or tuple(t.shape) != (rows, 10) \
                or not bool(torch.isfinite(t).all()):
            fail(f"{tag}: {nm} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                 f"or not finite")
    if events.get("spoof_compile_errors", 0):
        fail(f"{tag}: spoof_compile_errors {events['spoof_compile_errors']}")
    if launches["cla_chain"] or launches["mmchain"]:
        fail(f"{tag}: launched K6 or K1 ({launches}); neither is on ALS-CG's "
             f"path")
    out = {"L": lo, "R": ro, "iterations": iters, "loss": loss,
           "seconds": secs, "exec_seconds": ml._stats.run_time,
           "launches": launches, "peak_bytes": peak,
           "peak_reserved": peak_reserved, "peak_over_data_bytes": peak - base,
           "windows": windows, "regions": reg, "views": views,
           "views_host_ms": view_ms, "sparse_counters": counters,
           "densify": densify}
    if profile:
        # the timed run's graph and its pool go first
        del res, timer
        torch.cuda.empty_cache()
        out["profile"] = profile_main_path(ml, als_script(v), False,
                                           kernel="set_cond",
                                           loop="region (set_cond to set_cond)")
    return out


def _normwise_lr(a, b) -> dict:
    return {nm: float(torch.linalg.norm(a[nm].double() - b[nm].double())
                      / torch.linalg.norm(b[nm].double()))
            for nm in ("L", "R")}


def sparse_paths(ratings, als, dev, kernels) -> dict:
    """(a) ALS-CG-ml10m-sparse: the MovieLens-10M-shaped V of the dense
    path bound as a CSR tensor, at optlevel 3 with regions (the views the
    reference's rule gives: dense) and eagerly (codegen_enabled False:
    the CSR arms), each within 1e-3 of the dense-V run at optlevel 3;
    (b) ALS-CG-netflix: a Netflix-Prize-shaped V made as CSR on the card,
    at optlevel 3 with regions (ELL views, K2), optlevel 3 eagerly and
    optlevel 2 with regions, the three within 1e-3 of each other and each
    loss within 1e-3 of its recomputation in fp64; peak allocated below
    one dense V, no densify of a (users, movies) or (movies, users)
    matrix, K2 launched at optlevel 3."""
    out = {}
    torch.cuda.empty_cache()
    v = ratings.to_sparse_csr()
    dense = {"L": als["factors"][0], "R": als["factors"][1],
             "loss": als["optlevel3"]["loss"]}
    a = {"regions": run_sparse_als("ALS-CG-ml10m-sparse", v, 3, dev, kernels),
         "eager": run_sparse_als("ALS-CG-ml10m-sparse", v, 3, dev, kernels,
                                 regions=False)}
    for mode, r in a.items():
        d = _normwise_lr(r, dense)
        d["loss"] = abs(r["loss"] - dense["loss"]) / abs(dense["loss"])
        r["versus_dense_v"] = d
        print(f"[sparse] ALS-CG-ml10m-sparse optlevel 3 {mode} against the "
              f"dense-V run at optlevel 3: L {d['L']:.3e}, R {d['R']:.3e}, "
              f"loss {d['loss']:.3e} (bars 1e-3); views {r['views'] or 'none'}",
              flush=True)
        if not max(d.values()) <= 1e-3:
            fail(f"ALS-CG-ml10m-sparse {mode}: {d} from the dense-V run")
    del v
    out["ALS-CG-ml10m-sparse"] = a
    torch.cuda.empty_cache()
    v, csr_s = make_netflix(dev)
    nnz = v.values().numel()
    rows_k = int(v.crow_indices().diff().max())
    print(f"[netflix] V ({NETFLIX_USERS}, {NETFLIX_MOVIES}) fp32 as CSR on "
          f"the card: {nnz} ratings ({100 * nnz / (NETFLIX_USERS * NETFLIX_MOVIES):.4f}% "
          f"dense), mean rating {float(v.values().double().mean()):.4f}, "
          f"longest user row {rows_k}; made in {csr_s:.2f} s; a dense fp32 V "
          f"would take {NETFLIX_DENSE_BYTES / 1e9:.2f} GB", flush=True)
    if nnz != NETFLIX_RATINGS:
        fail(f"the Netflix-shaped V has {nnz} ratings, not {NETFLIX_RATINGS}")
    b = {"optlevel3": run_sparse_als("ALS-CG-netflix", v, 3, dev, kernels,
                                     profile=True),
         "optlevel3_eager": run_sparse_als("ALS-CG-netflix", v, 3, dev,
                                           kernels, regions=False),
         "optlevel2": run_sparse_als("ALS-CG-netflix", v, 2, dev, kernels)}
    ref = b["optlevel3"]
    shapes = {f"{NETFLIX_USERS}x{NETFLIX_MOVIES}",
              f"{NETFLIX_MOVIES}x{NETFLIX_USERS}"}
    for mode, r in b.items():
        d = _normwise_lr(r, ref) if r is not ref else {"L": 0.0, "R": 0.0}
        recomputed = loss_fp64(v, r["L"], r["R"], ALS_ARGS["reg"])
        d["loss_fp64"] = abs(r["loss"] - recomputed) / abs(recomputed)
        r["versus_optlevel3_regions"] = d
        r["loss_fp64"] = recomputed
        print(f"[netflix] {mode}: against optlevel 3 with regions L "
              f"{d['L']:.3e}, R {d['R']:.3e}; loss {r['loss']:.6e} against "
              f"{recomputed:.6e} recomputed in fp64 over the ratings, "
              f"{d['loss_fp64']:.3e} relative (bars 1e-3); peak allocated "
              f"{r['peak_bytes'] / 1e9:.3f} GB (one dense V "
              f"{NETFLIX_DENSE_BYTES / 1e9:.2f} GB); densifies {r['densify'] or 'none'}",
              flush=True)
        if not max(d.values()) <= 1e-3:
            fail(f"ALS-CG-netflix {mode}: {d}")
        if r["peak_bytes"] >= NETFLIX_DENSE_BYTES:
            fail(f"ALS-CG-netflix {mode}: peak allocated {r['peak_bytes']} B "
                 f">= one dense V")
        if shapes & set(r["densify"]):
            fail(f"ALS-CG-netflix {mode}: densified {r['densify']}")
    if b["optlevel3"]["launches"]["spoof_cell"] < 1:
        fail("ALS-CG-netflix optlevel 3: K2 never launched")
    if not b["optlevel3"]["views"] or any(
            set(vs.values()) != {"ell"} for vs in b["optlevel3"]["views"].values()):
        fail(f"ALS-CG-netflix optlevel 3: views {b['optlevel3']['views']}, "
             f"not ELL")
    b["csr_seconds"] = csr_s
    b["views_host_ms"] = {m: r["views_host_ms"] for m, r in b.items()
                          if isinstance(r, dict)}
    del v
    out["ALS-CG-netflix"] = b
    torch.cuda.empty_cache()
    return out


def time_outer_and_multiagg(als, v, progs, smi, abs_errs, kernels) -> list:
    """K5 and K3 at ALS-CG-ml10m's shape against their plain versions and
    bounds: K5 on the loss plan with X = V's 0/1 pattern and the optlevel-3
    run's L and R, K3 on the summary's plan over V. Returns their
    records."""
    loss_hop = _plan_of(progs["ALS-CG"], "outer")
    plan = loss_hop.params["plan"]
    lf, rf = als["factors"]
    x = (v != 0).to(torch.float32)
    m, n = x.shape
    r = lf.shape[1]
    kern_ms, plain_ms, mm_ms = time_ms([
        lambda: kernels.outer_kernel(plan, x, lf, rf, {}),
        lambda: kernels.outer_plain(plan, x, lf, rf, {}),
        lambda: torch.matmul(lf, rf.T),
    ], reps=10)
    nbytes = (x.numel() + lf.numel() + rf.numel()) * 4 + 4
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * (2.0 * r + plan_ops(plan)) * m * n / FP32_OPS_PER_S
    outer_bound = max(bytes_ms, ops_ms)
    print(f"[times] spoof_outer {plan.pretty()} X ({m}, {n}) r={r} fp32 on "
          f"{smi}: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{outer_bound:.4f} ms (bytes {bytes_ms:.4f}, operations "
          f"{ops_ms:.4f}); yardstick torch.matmul(U, V.T) alone (the "
          f"unfused route's first step) {mm_ms:.4f} ms; no single torch call "
          f"computes the outer template", flush=True)
    del x
    torch.cuda.empty_cache()
    hop = _plan_of(progs["summary"], "multiagg")
    mplan, names = hop.params["plan"], list(hop.params["leaf_names"])
    aggs = list(hop.params["aggs"])
    env = {names[0]: v, names[1]: v, names[2]: v.sum(),
           names[3]: (v != 0).sum().to(torch.float32)}
    magg_ms, mplain_ms = time_ms([
        lambda: kernels.multiagg_kernel(mplan, names, aggs, env),
        lambda: kernels.multiagg_plain(mplan, names, aggs, env),
    ], reps=10)
    mb_ms, mb_by = spoof_bound(mplan, env, 4 * len(aggs), m * n)
    print(f"[times] spoof_multiagg {mplan.pretty()} {aggs} over V ({m}, {n}) "
          f"fp32 on {smi}: kernel {magg_ms:.4f} ms, plain (the unfused torch "
          f"sequence, the yardstick) {mplain_ms:.4f} ms, bound {mb_ms:.4f} "
          f"ms ({mb_by}); no single torch call computes the multi-aggregate "
          f"template", flush=True)
    return [{
        "name": "spoof_outer", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/spoof.cuh",
        "replaces": "systemml_tpu/codegen/kernels.py:419 outer_sum_kernel",
        "launches": als["optlevel3"]["launches"]["spoof_outer"],
        "max_abs_err": abs_errs["outer"], "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": outer_bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "yardstick_matmul_ms": mm_ms,
        "plan": plan.pretty()}, {
        "name": "spoof_multiagg", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/spoof.cuh",
        "replaces": "systemml_tpu/codegen/kernels.py:242 multiagg_kernel",
        "launches": als["summary"]["optlevel3"]["launches"]["spoof_multiagg"],
        "max_abs_err": abs_errs["multiagg"], "ms": magg_ms,
        "plain_ms": mplain_ms, "bound_ms": mb_ms, "bound_by": mb_by,
        "library_ms": None, "yardstick_unfused_ms": mplain_ms,
        "plan": mplan.pretty(), "aggs": aggs}]


def time_cell_beyond_l2svm(als, v, als_progs, smi, kernels) -> dict:
    """K2 beyond l2-svm's plan, each against its plain version and bound:
    the cell sum that ALS-CG-ml10m's optlevel-3 run launched most, at its
    last call's own inputs (device time per call, torch.profiler), and the
    elementwise arm on an (m, n > 1) plan, the summary's over V (it writes
    3.058 GB: CUDA events). Prints each with its leaves' classes (which
    walk it takes)."""
    out = {}
    if als["cell_sums"] is not None:
        count, (plan, names, env, variant) = als["cell_sums"]
        main = env[kernels._matrices(names, env)[0]]
        fns = [lambda: kernels.cell_kernel(plan, names, "sum", env, variant),
               lambda: kernels.cell_plain(plan, names, "sum", env)]
        k_ms, p_ms = device_ms(fns[0]), device_ms(fns[1])
        cold_ms = device_ms(fns[0], cold=True)
        b_ms, b_by = spoof_bound(plan, env, main.element_size(),
                                 main.numel())
        classes = kernels.leaf_classes(plan, "cell", env, variant)
        print(f"[times] spoof_cell sum ALS-CG's most launched cell sum "
              f"({count} launches in its run) {plan.pretty()} over "
              f"{tuple(main.shape)} on {smi}: device time per call kernel "
              f"{cold_ms:.4f} ms with the L2 cache evicted before each call "
              f"({k_ms:.4f} ms warm), plain {p_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}); leaves {classes}", flush=True)
        out["als_cg_sum"] = {"plan": plan.pretty(), "launches": count,
                             "shape": list(main.shape), "ms": cold_ms,
                             "warm_l2_ms": k_ms,
                             "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "leaf_classes": classes}
    hop = _plan_of(als_progs["summary"], "multiagg")
    plan, names = hop.params["plan"], list(hop.params["leaf_names"])
    env = {names[0]: v, names[1]: v, names[2]: v.sum(),
           names[3]: (v != 0).sum().to(torch.float32)}
    k_ms, p_ms = time_ms([lambda: kernels.cell_kernel(plan, names, None, env),
                          lambda: kernels.cell_plain(plan, names, None, env)],
                         reps=5, warm=1)
    b_ms, b_by = spoof_bound(plan, env, v.numel() * v.element_size(),
                             v.numel())
    classes = kernels.leaf_classes(plan, "cell", env)
    print(f"[times] spoof_cell elementwise {plan.pretty()} over V "
          f"{tuple(v.shape)} fp32 on {smi}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); leaves {classes}",
          flush=True)
    out["map"] = {"plan": plan.pretty(), "shape": list(v.shape), "ms": k_ms,
                  "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "leaf_classes": classes}
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# --bench: the spoof kernels and wrappers of this tree, for parent/change
# pairs in one chip call
# --------------------------------------------------------------------------

def _bench_hops(script_text=None, path=None, inputs=(), args=None):
    """The spoof hops of a script compiled at optlevel 3 with a CPU config
    (no build: each wrapper builds its plan at its first call)."""
    from systemml_tpu_torch.api.mlcontext import dml, dmlFromFile
    from systemml_tpu_torch.runtime.program import (compile_program,
                                                    iter_spoof_hops)
    from systemml_tpu_torch.utils.config import (DMLConfig, get_config,
                                                 set_config)

    s = dmlFromFile(path) if path else dml(script_text)
    for k in inputs:
        s.input(k, None)
    for k, v in (args or {}).items():
        s.arg(k, v)
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = 3
    old = get_config()
    set_config(cfg)
    try:
        prog = compile_program(s.parse(), clargs=s._args,
                               outputs=s._outputs, input_names=list(inputs))
    finally:
        set_config(old)
    return list(iter_spoof_hops(prog))


def host_us(fns: dict, reps: int = 250, rounds: int = 8):
    """Host microseconds per call of each fn of `fns` (name -> fn): the
    median over `rounds` rounds of `reps` calls, the fns taken in turns
    within a round, so that a slow spell of the shared host falls on all
    of them. Returns (medians, every round's reading) by name."""
    import statistics

    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[k].append(1e6 * (time.perf_counter() - t0) / reps)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}, times


def _bench_summary_ms(v, runs: int = 7) -> float:
    """The ratings summary at optlevel 3 through MLContext, end to end
    (parse, compile, execution, the three values read back): the median
    of `runs` after one run that builds its plan."""
    import statistics

    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    cfg = DMLConfig()
    cfg.optlevel = 3
    ml = MLContext(cfg)
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ml.execute(dml(SUMMARY).input("V", v).output("s", "lo", "hi"))
        [float(res.get(k)) for k in ("s", "lo", "hi")]
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def bench(label: str) -> None:
    """Times the spoof kernels K2, K3 and K5 at the paths' shapes, the host
    time of the spoof wrappers, K6 and LinearRegCG-cla, and prints the card
    and one JSON line:

    - k3_summary_ms: the ratings summary's plan (sum, min, max) over a
      ratings matrix of the MovieLens 10M shape, CUDA events;
    - k2_map_ms: that plan written out elementwise over the same matrix;
    - k5_loss_ms: ALS-CG's loss plan (the outer template) on that
      matrix's 0/1 pattern at rank 10, CUDA events, and the ptxas report
      of its source;
    - summary_optlevel3_ms: the ratings summary through MLContext at
      optlevel 3, end to end (host clock, the median of 7);
    - k2_l2svm_device_ms: l2-svm's 10-leaf line-search plan summed over
      (2,000,000, 1), device time per call (torch.profiler); its 24 MB
      stay in the 50 MB L2 cache across calls, so k2_l2svm_cold_l2_ms
      evicts the cache before each call; k2_als_device_ms and
      k2_als_cold_l2_ms likewise for ALS-CG's CG-reduction plan (the cell
      plan with the most leaves) over (71,567, 10);
    - dispatch_us: host microseconds per wrapper call on tiny inputs (cell
      sum, multi-aggregate, row), where the launch and not the work
      counts; in a tree whose compiler fixes each spoof hop's Variant,
      also the cell sum called with it, as the paths call it (medians of
      host_us's rounds, each round in dispatch_us_rounds);
    - cla_cg_iter_ms: LinearRegCG-cla at optlevel 2, cla "auto", on the
      Census-shaped X, ms per CG iteration (run_cla_path's device window);
    - k6_chain_ms: K6 at that X's own compressed layout, k = 1, fp32,
      XtXv, CUDA events over back-to-back chain_kernel calls;
      k6_chain_device_ms the device time per call (torch.profiler) and
      k6_host_us the wrapper's host time per call.

    It uses only the wrappers' (plan, names, agg, env) signatures,
    compile_program, MLContext and compress/device.py's chain_layout,
    chain_table and chain_kernel, so a checkout of an earlier tree runs it
    too, this file copied in: two trees compare within one chip call."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.codegen import build, kernels
    from systemml_tpu_torch.codegen.cplan import CNode

    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"label": label, "card": smi}
    users, movies = ML10M_USERS, ML10M_MOVIES

    # K3, K2's elementwise arm and K5 over a ratings matrix
    (magg,) = [h for h in _bench_hops(SUMMARY, inputs=("V",))
               if h.params["template"] == "multiagg"]
    mplan, mnames = magg.params["plan"], list(magg.params["leaf_names"])
    aggs = list(magg.params["aggs"])
    v = torch.randint(1, 11, (users, movies), generator=gen, device=dev,
                      dtype=torch.int8).to(torch.float32).div_(2.0)
    v.mul_(torch.rand(users, movies, generator=gen, device=dev)
           < ML10M_RATINGS / (users * movies))
    env = {mnames[0]: v, mnames[1]: v, mnames[2]: v.sum(),
           mnames[3]: (v != 0).sum().to(torch.float32)}
    out["k3_summary_ms"] = time_ms(
        [lambda: kernels.multiagg_kernel(mplan, mnames, aggs, env)],
        reps=10)[0]
    out["k2_map_ms"] = time_ms(
        [lambda: kernels.cell_kernel(mplan, mnames, None, env)], reps=5)[0]
    out["summary_optlevel3_ms"] = _bench_summary_ms(v)
    del env
    torch.cuda.empty_cache()
    als_hops = _bench_hops(path=os.path.join(ALG, "ALS-CG.dml"),
                           inputs=("V",), args=ALS_ARGS)
    (loss,) = [h for h in als_hops if h.params["template"] == "outer"]
    x = (v != 0).to(torch.float32)
    del v
    lf = torch.rand(users, 10, generator=gen, device=dev)
    rf = torch.rand(movies, 10, generator=gen, device=dev)
    out["k5_loss_ms"] = time_ms([lambda: kernels.outer_kernel(
        loss.params["plan"], x, lf, rf, {})], reps=10)[0]
    print_build_reports(build, only="spoof_outer")
    del x, lf, rf
    torch.cuda.empty_cache()

    # K2: l2-svm's 10-leaf plan over (2e6, 1)
    cells = [h for h in _bench_hops(path=os.path.join(ALG, "l2-svm.dml"),
                                    inputs=("X", "Y"))
             if h.params["template"] == "cell"]
    svm = max(cells, key=lambda h: len(h.params["leaf_names"]))
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    by_var = {"Y": torch.sign(r(M, 1)), "Xw": r(M, 1), "Xd": r(M, 1),
              "step_sz": torch.tensor(0.05, device=dev)}
    snames = list(svm.params["leaf_names"])
    senv = {nm: by_var[h.name] for nm, h in zip(snames, svm.inputs)}
    splan = svm.params["plan"]
    fn = lambda: kernels.cell_kernel(splan, snames, "sum", senv)
    out["k2_l2svm_device_ms"] = device_ms(fn)
    out["k2_l2svm_cold_l2_ms"] = device_ms(fn, cold=True)

    # K2: ALS-CG's CG-reduction plan over (users, rank 10)
    als = max((h for h in als_hops if h.params["template"] == "cell"),
              key=lambda h: len(h.params["leaf_names"]))
    anames = list(als.params["leaf_names"])
    aenv = {}
    for nm, h in zip(anames, als.inputs):
        if h.op == "ua(sum,all)" or (h.op == "tread" and h.name == "rr"):
            aenv[nm] = r(users, 10).square().sum()
        elif h.op == "tread" and h.name == "reg":
            aenv[nm] = 0.01
        elif h.op == "tread" and h.name == "wrow":
            aenv[nm] = torch.ones(users, 1, device=dev)
        else:
            aenv[nm] = r(users, 10) / 10
    aplan = als.params["plan"]
    fn = lambda: kernels.cell_kernel(aplan, anames, "sum", aenv)
    out["k2_als_device_ms"] = device_ms(fn)
    out["k2_als_cold_l2_ms"] = device_ms(fn, cold=True)
    out["plans"] = {"k3": mplan.pretty(), "k5": loss.params["plan"].pretty(),
                    "k2_l2svm": splan.pretty(), "k2_als": aplan.pretty()}

    # the host time of one wrapper call; one slice per variable: a
    # variable named twice is one object, as on the paths
    small = {id(t): (t[:1024] if t.ndim == 2 else t) for t in senv.values()}
    tiny_svm = {nm: small[id(t)] for nm, t in senv.items()}
    tv = torch.rand(64, 64, device=dev)
    tiny_magg = {mnames[0]: tv, mnames[1]: tv, mnames[2]: tv.sum(),
                 mnames[3]: (tv != 0).sum().to(torch.float32)}
    row = CNode("u(exp)", [CNode("b(-)", [CNode("in", name="i0"),
                                          CNode("in", name="i1")])])
    tiny_row = {"i0": torch.randn(1024, 5, device=dev),
                "i1": torch.randn(1024, 1, device=dev)}
    fns = {"cell_sum": lambda: kernels.cell_kernel(
               splan, snames, "sum", tiny_svm),
           "multiagg": lambda: kernels.multiagg_kernel(
               mplan, mnames, aggs, tiny_magg),
           "row": lambda: kernels.row_kernel(row, ["i0", "i1"], "sum",
                                             tiny_row)}
    if "variant" in svm.params:   # a tree whose compiler fixes Variants
        fns["cell_sum_hop_variant"] = lambda: kernels.cell_kernel(
            splan, snames, "sum", tiny_svm, svm.params["variant"])
    out["dispatch_us"], out["dispatch_us_rounds"] = host_us(fns)
    del senv, aenv, tiny_svm, tiny_magg, tiny_row
    torch.cuda.empty_cache()

    # K6 and LinearRegCG-cla on the Census-shaped X (compressed at the
    # loop's entry, as the path does)
    from systemml_tpu_torch.compress import device as cla_dev

    data = make_census(dev)
    run = run_cla_path("LinearRegCG", "auto", data, dev, kernels,
                       profile=False)
    out["cla_cg_iter_ms"] = run["windows"]["iteration_ms"]
    out["cla_cg_iterations"] = run["iterations"]
    lay = cla_dev.chain_layout(run["compressed"][0])
    sv = cla_dev.chain_table(
        lay, torch.randn(CENSUS_M, 1, generator=gen, device=dev))
    fn = lambda: cla_dev.chain_kernel(lay.codes, sv)
    out["k6_chain_ms"] = time_ms([fn], reps=50)[0]
    out["k6_chain_device_ms"] = device_ms(fn)
    out["k6_host_us"] = host_us({"k6": fn}, reps=100, rounds=4)[0]["k6"]
    print(smi)
    print(json.dumps(out), flush=True)


# K6_PROBE of csrc/cla_chain.cu: the kernel, and three builds whose
# results are wrong
K6_PROBES = {"full": 0, "no_atomics": 1, "plain_stores": 2, "copies_only": 3}


def phases() -> None:
    """Where K6's time goes, at the Census shape (68 groups of 8 codes over
    2,458,285 rows, uniform codes, k = 1, fp32, XtXv): csrc/cla_chain.cu
    built with each K6_PROBE (full: the kernel; no_atomics: phase B's
    atomics left out, their addresses and values still computed;
    plain_stores: plain shared-memory stores in their place; copies_only:
    each tile's codes copied into shared memory and nothing else), by nvcc
    in parallel, each launched through its own library on the same inputs
    as compress/device.chain_kernel launches K6. Prints the card, ptxas's
    registers and spills of each k = 1 kernel, full's normwise error
    against chain_plain, and one JSON line per probe: ms per call by CUDA
    events over back-to-back launches (the probes in turns) and device ms
    per call (torch.profiler); beside them the wrapper chain_kernel."""
    import ctypes

    from systemml_tpu_torch.codegen import build
    from systemml_tpu_torch.compress import device as cla_dev

    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.CSRC, "cla_chain.cu")
    procs = {}
    for name, probe in K6_PROBES.items():
        lib = os.path.join(build.BUILD_DIR, f"libcla_chain_probe{probe}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, f"-DK6_PROBE={probe}", "-I",
             build.CSRC, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    ref_lib = cla_dev._chain_library()
    libs = {}
    for name, (lib, p) in procs.items():
        report, _ = p.communicate(timeout=build.NVCC_TIMEOUT_S)
        if p.returncode:
            fail(f"nvcc for K6_PROBE={K6_PROBES[name]}:\n{report[-3000:]}")
        lines = report.splitlines()
        at = [i for i, ln in enumerate(lines)
              if "cla_chain_f32ILi1E" in ln and "Compiling" in ln]
        regs = [ln.split(":", 1)[-1].strip() for ln in
                lines[at[0] + 1:at[0] + 5] if "registers" in ln
                or "spill" in ln] if at else []
        print(f"[phases] {name} ptxas k=1: {'; '.join(regs)}", flush=True)
        h = ctypes.CDLL(lib)
        h.smtorch_cla_chain.argtypes = ref_lib.smtorch_cla_chain.argtypes
        h.smtorch_cla_chain.restype = ref_lib.smtorch_cla_chain.restype
        libs[name] = h

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    codes = cla_dev.chain_codes(torch.randint(
        0, 8, (CENSUS_M, CENSUS_N), generator=gen, device=dev,
        dtype=torch.uint8))
    sv = torch.randn(8, CENSUS_M, 1, generator=gen, device=dev)
    tile = cla_dev.chain_kernel_plan(8, CENSUS_M, 1, torch.float32)[0]
    grid = min(-(-CENSUS_N // tile), torch.cuda.get_device_properties(
        dev).multi_processor_count)
    partial = torch.empty((grid, 8, CENSUS_M, 1), dtype=torch.float64,
                          device=dev)
    outs = {name: torch.empty((8, CENSUS_M, 1), dtype=torch.float64,
                              device=dev) for name in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(name):
        h, out = libs[name], outs[name]

        def fn():
            err = h.smtorch_cla_chain(
                codes.data_ptr(), codes.stride(0), sv.data_ptr(), None,
                partial.data_ptr(), out.data_ptr(),
                CENSUS_N, CENSUS_M, 8, 1, 0, 1, 0, grid, stream)
            if err:
                fail(f"K6 probe {name}: CUDA error {err}")
        return fn

    fns = {name: launcher(name) for name in libs}
    fns["wrapper"] = lambda: cla_dev.chain_kernel(codes, sv)
    fns["full"]()
    ref = cla_dev.chain_plain(codes, sv.double())
    err = normwise(outs["full"], ref)
    print(f"[phases] full: normwise {err:.3e} against chain_plain "
          f"(bar {CHAIN_BARS[torch.float32]:g})", flush=True)
    if not err <= CHAIN_BARS[torch.float32]:
        fail(f"K6 probe full: normwise {err}")
    names = list(fns)
    events = time_ms([fns[k] for k in names], reps=50)
    result = {k: {"ms": events[i], "device_ms": device_ms(fns[k])}
              for i, k in enumerate(names)}
    print(smi)
    print(json.dumps(result), flush=True)


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.api.mlcontext import MLContext
    from systemml_tpu_torch.codegen import build, kernels
    from systemml_tpu_torch.codegen.compiler import hop_variant, program_plans

    # ---- 0. environment ---------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name!r}, count {torch.cuda.device_count()}")
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # true fp32 references
    t_start = time.perf_counter()
    data = make_data(dev)
    x = data["X"]
    x_bytes = x.numel() * x.element_size()

    # ---- 1. build ---------------------------------------------------------
    # the named sources build beside the paths' compiles (nvcc for
    # mmchain.cu takes longer than for any plan)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        named = pool.submit(build.build_plans, (), KERNEL_SOURCES)
        progs = compile_paths(data)
        als_progs = compile_als()
        compile_s = time.perf_counter() - t0
        for pname, prog in list(progs.items()) + list(als_progs.items()):
            for t in templates_of(prog):
                print(f"[plans] {pname} optlevel 3: {t[0]} {t[1]}: {t[2]}")
        built = build.build_plans(kernel_phase_sources(
            progs, als_progs, dev, kernels)) + named.result()
    build_s = time.perf_counter() - t0
    n_path_plans = len({(t, p.key(), v) for prog in list(progs.values())
                        + list(als_progs.values())
                        for t, p, v in program_plans(prog)})
    print(f"[build] compiled the paths, building their {n_path_plans} "
          f"fused plan sources, in {compile_s:.1f} s; the named sources and the "
          f"kernel phase's other plans ({len(built)} libraries) were built "
          f"by {build_s:.1f} s; one nvcc per source, "
          f"{len(build.build_reports)} in all")
    print_build_reports(build)
    from systemml_tpu_torch.codegen import loop_graph
    rt, drv = loop_graph.versions()
    print(f"[env] CUDA runtime {rt // 1000}.{rt % 1000 // 10} (loop_graph.cu's "
          f"build), driver {drv // 1000}.{drv % 1000 // 10}: conditional graph "
          f"nodes need 12.4", flush=True)
    loop_graph.check_versions()
    nvcc_by_path = {}
    for pname, prog in list(progs.items()) + list(als_progs.items()):
        # a library built by an earlier run of this checkout has no report
        secs = [build.build_reports.get(build.plan_source(*tpv)[0],
                                        (0.0, ""))[0]
                for tpv in program_plans(prog)]
        nvcc_by_path[pname] = {"sources": len(secs), "sum_s": sum(secs),
                               "max_s": max(secs, default=0.0)}
        print(f"[build] {pname}: {len(secs)} generated sources, nvcc "
              f"{sum(secs):.1f} s in all, {max(secs, default=0.0):.1f} s "
              f"for the slowest (the wall time of its program's parallel "
              f"build on a host with a core per source)")

    # ---- 2. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    max_abs_err = {}
    # (m, k, c, width of the matrix X is a column slice of, first column)
    for m, k, c, width, col0 in ((M, K, 1, K, 0), (100_003, K, 4, K, 0),
                                 (4_097, 128, 8, 128, 0),
                                 (100_003, K, 4, 1_004, 4),
                                 (4_097, 128, 8, 130, 1)):
        xk = x[:, :k] if (m, k, width) == (M, K, K) else \
            torch.randn(m, width, generator=gen, device=dev)[:, col0:col0 + k]
        v = torch.randn(k, c, generator=gen, device=dev)
        wcols = {"XtXv": 0, "XtwXv": 1, "XtXvy": c}
        xd = xk.double()
        for ctype, wc in wcols.items():
            w = (torch.randn(m, wc, generator=gen, device=dev)
                 if wc else None)
            out = kernels.mmchain_kernel(xk, v, w, ctype)
            again = kernels.mmchain_kernel(xk, v, w, ctype)
            ref = kernels.mmchain_plain(xd, v.double(),
                                        None if w is None else w.double(),
                                        ctype)
            torch.cuda.synchronize()
            err = normwise(out, ref)
            abs_err = float((out.double() - ref).abs().max())
            same = bool(torch.equal(out, again))
            print(f"[kernel] mmchain {ctype} m={m} k={k} c={c} "
                  f"w=({m},{wc}) X[:, {col0}:{col0 + k}] of width {width}: "
                  f"normwise {err:.3e} (bar {KERNEL_BAR:g}), "
                  f"max abs {abs_err:.3e}, repeat bit-identical {same}",
                  flush=True)
            if not math.isfinite(err) or err > KERNEL_BAR:
                fail(f"mmchain {ctype} at ({m}, {k}, {c}), width {width}: "
                     f"normwise error {err} > {KERNEL_BAR}")
            if not same:
                fail(f"mmchain {ctype} at ({m}, {k}, {c}), width {width}: "
                     f"two launches differ")
            if (m, k, c) == (M, K, 1) and ctype == "XtXv":
                max_abs_err["mmchain"] = abs_err
        del xk, v, xd, w, out, again, ref
    torch.cuda.empty_cache()
    max_abs_err.update(check_spoof_kernels(progs, dev, kernels))
    max_abs_err["cla_chain"] = check_chain_kernel(dev)
    ratings = make_ratings(dev)
    n_ratings = int((ratings != 0).sum())
    print(f"[als] ratings V ({ML10M_USERS}, {ML10M_MOVIES}) fp32, "
          f"{ratings.numel() * 4 / 1e9:.3f} GB dense: {n_ratings} ratings "
          f"({100 * n_ratings / ratings.numel():.3f}% dense; MovieLens 10M "
          f"has {ML10M_RATINGS}), mean rating "
          f"{float(ratings.sum(dtype=torch.float64)) / n_ratings:.4f}",
          flush=True)
    check_outer_kernel(_plan_of(als_progs["ALS-CG"], "outer"), ratings, dev,
                       kernels, max_abs_err)
    check_multiagg_kernel(_plan_of(als_progs["summary"], "multiagg"),
                          ratings, progs, dev, kernels, max_abs_err)
    check_rand(dev)
    set_cond_rec = check_set_cond(dev)

    # ---- 2b. the region bridge on small scripts, card against CPU ---------
    bridge = bridge_phase(dev)

    # ---- 3. the paths -------------------------------------------------------
    audit = SyncAudit()
    # LinearRegCG at optlevel 2: the first slice's main path, K1
    lines = []

    def printer(s):
        lines.append(s)
        print(f"[script] {s}", flush=True)

    ml = MLContext()
    ml.printer = lambda s: None
    ml.execute(path_script("LinearRegCG", data, rows=8192))
    ml.printer = printer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        res = ml.execute(path_script("LinearRegCG", data))
        beta = res.get_tensor("beta")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    exec_secs = ml._stats.run_time
    peak = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    iters = outer_iterations("LinearRegCG", lines)
    beta_true = data["beta_true"]
    rel = float(torch.linalg.norm(beta.double() - beta_true.double())
                / torch.linalg.norm(beta_true.double()))
    print(f"[main] LinearRegCG {M} x {K} fp32 optlevel 2 on {beta.device}: "
          f"{iters} iterations, {secs:.3f} s total ({exec_secs:.3f} s "
          f"executing, the rest parse and compile), "
          f"{1e3 * exec_secs / max(iters, 1):.2f} ms of execution per CG "
          f"iteration (prologue and epilogue included)")
    print(f"[main] launches {launches}; |beta - beta_true| / |beta_true| = "
          f"{rel:.3e}; peak allocated {peak / 1e9:.2f} GB, X "
          f"{x_bytes / 1e9:.2f} GB", flush=True)
    if beta.shape != (K, 1) or not bool(torch.isfinite(beta).all()):
        fail(f"beta has shape {tuple(beta.shape)} or is not finite")
    if beta.dtype != torch.float32 or beta.device.type != "cuda":
        fail(f"beta is {beta.dtype} on {beta.device}, not fp32 on the card")
    if launches["mmchain"] != iters or iters < 1:
        fail(f"mmchain launched {launches['mmchain']} times in {iters} CG "
             f"iterations")
    if launches["spoof_cell"] or launches["spoof_row"]:
        fail("LinearRegCG at optlevel 2 launched spoof kernels")
    if not rel <= 1e-3:
        fail(f"beta is {rel} from beta_true (bar 1e-3)")
    if peak >= 2 * x_bytes:
        fail(f"peak device memory {peak} B >= 2 x X ({x_bytes} B): X was "
             f"copied")
    windows = {"first": phase_windows(timer, iters, "timed run")}
    main_regions = region_report(timer, "LinearRegCG optlevel 2 (main path)",
                                 "LinearRegCG", True)
    ml.printer = lambda s: None
    with PhaseTimer() as timer:
        ml.execute(path_script("LinearRegCG", data)).get_tensor("beta")
        torch.cuda.synchronize()
    ml.printer = printer
    windows["second"] = phase_windows(timer, iters, "second unprofiled run")
    main_path = {"iterations": iters, "seconds": secs,
                 "exec_seconds": exec_secs, "beta_rel_err": rel,
                 "peak_bytes": peak, "peak_reserved": peak_reserved,
                 "launches": launches, "windows": windows,
                 "regions": main_regions}
    del res
    main_path["profile"] = {
        "device_only": profile_main_path(
            ml, path_script("LinearRegCG", data), False),
        "host_and_device": profile_main_path(
            ml, path_script("LinearRegCG", data), True),
        "python_host_ms": host_profile(ml, path_script("LinearRegCG", data))}

    # this slice's paths: optlevel 3 (spoof fusion), then optlevel 2; each
    # runs its loops as regions (the default), and LinearRegCG at optlevel
    # 2 and MultiLogReg at 3 also without (codegen_enabled False)
    paths = {}
    eager_twins = {("LinearRegCG", 2): "mmchain_partial",
                   ("MultiLogReg", 3): "row_thread",
                   ("l2-svm", 3): None, ("l2-svm", 2): None}
    versus_eager = {}
    for pname in DENSE_PATHS:
        runs = {}
        for optlevel in (3, 2):
            if pname == "LinearRegCG" and optlevel == 2:
                runs[2] = {"out": beta, "iterations": iters,
                           "windows": windows["first"], "launches": launches,
                           "regions": main_regions, "peak_bytes": peak,
                           "peak_reserved": peak_reserved}
            else:
                runs[optlevel] = run_path(pname, optlevel, data, dev,
                                          kernels)
            if (pname, optlevel) in eager_twins:
                eag = run_path(pname, optlevel, data, dev, kernels,
                               regions=False,
                               profile_kernel=eager_twins[(pname, optlevel)])
                versus_eager[f"{pname} optlevel {optlevel}"] = compare_eager(
                    f"{pname} optlevel {optlevel}", runs[optlevel], eag)
                del eag
            if pname in PRINTS:
                check_print_lines(f"{pname} optlevel {optlevel}",
                                  runs[optlevel])
        a, b = runs[3]["out"].double(), runs[2]["out"].double()
        diff = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        print(f"[path] {pname}: |optlevel 3 - optlevel 2| / |optlevel 2| = "
              f"{diff:.3e} (bar 1e-3); outer iterations {runs[3]['iterations']}"
              f" / {runs[2]['iterations']}; ms per outer iteration "
              f"{runs[3]['windows']['iteration_ms']:.3f} / "
              f"{runs[2]['windows']['iteration_ms']:.3f}", flush=True)
        if not diff <= 1e-3:
            fail(f"{pname}: optlevel 3 is {diff} from optlevel 2")
        if pname == "LinearRegCG":
            r3 = float(torch.linalg.norm(a - beta_true.double())
                       / torch.linalg.norm(beta_true.double()))
            if not r3 <= 1e-3:
                fail(f"LinearRegCG optlevel 3: beta is {r3} from beta_true")
            if runs[3]["launches"]["mmchain"] != runs[3]["iterations"]:
                fail("LinearRegCG optlevel 3: mmchain did not launch once "
                     "per CG iteration")
        paths[pname] = {
            "diff_from_optlevel2": diff,
            "templates": templates_of(progs[pname]),
            **{f"optlevel{o}": {k: v for k, v in r.items()
                                if k not in ("out", "lines")}
               for o, r in runs.items()}}
        if pname == "LinearRegCG":
            paths[pname]["optlevel2"]["windows"] = windows
        del runs, a, b
    del beta
    torch.cuda.empty_cache()
    # the algorithm-breadth paths on the same X, and seq / sample on the
    # card against the CPU
    breadth = breadth_paths(data, dev, kernels)
    breadth_datagen = check_breadth_datagen(dev)
    torch.cuda.empty_cache()
    # this slice's path: minibatch SGD, slices at a device offset and a
    # loop-varying seed inside one graph
    minibatch = minibatch_paths(data, dev, kernels)
    torch.cuda.empty_cache()
    # this slice's path: LinearRegCG-cla (K6), and l2-svm on the same X
    cla = cla_paths(dev, kernels)
    torch.cuda.empty_cache()
    # this slice's paths: ALS-CG-ml10m (K5, K2) and the ratings summary (K3)
    als = als_paths(ratings, als_progs, dev, kernels)
    # the sparse plane: ALS-CG over a CSR V, MovieLens-10M- and
    # Netflix-shaped
    sparse = sparse_paths(ratings, als, dev, kernels)
    syncs = audit.finish()

    # ---- 4. times -----------------------------------------------------------
    v = torch.randn(K, 1, generator=gen, device=dev)
    kern_ms, plain_ms, lib_ms = time_ms([
        lambda: kernels.mmchain_kernel(x, v),
        lambda: kernels.mmchain_plain(x, v),
        lambda: torch.matmul(x.T, torch.matmul(x, v)),
    ])
    nbytes = x_bytes + 2 * v.numel() * v.element_size()  # X, v in; out
    bound_bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    bound_ops_ms = 1e3 * 4.0 * M * K / FP32_OPS_PER_S
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    print(f"[times] mmchain XtXv ({M}, {K}, 1) on {smi}: kernel "
          f"{kern_ms:.3f} ms, plain {plain_ms:.3f} ms, cuBLAS pair "
          f"{lib_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"(bytes {bound_bytes_ms:.3f}, operations {bound_ops_ms:.3f}); "
          f"{nbytes / kern_ms / 1e6:.1f} GB/s", flush=True)
    records = [{
        "name": "mmchain", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/mmchain.cu",
        "replaces": "systemml_tpu/codegen/kernels.py:347 mmchain_kernel",
        "launches": main_path["launches"]["mmchain"],
        "max_abs_err": max_abs_err["mmchain"],
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
        else "operations",
        "library_ms": lib_ms}]
    gen = torch.Generator(device=dev).manual_seed(3)
    by_path = {p: paths[p]["optlevel3"]["launches"] for p in paths}
    by_path.update({p: breadth[p]["optlevel3"]["launches"]
                    for p in BREADTH_PATHS})
    by_path["minibatch-sgd"] = minibatch["optlevel3"]["launches"]
    by_path["ALS-CG-ml10m"] = als["optlevel3"]["launches"]
    by_path["ALS-CG-ml10m-sparse"] = \
        sparse["ALS-CG-ml10m-sparse"]["regions"]["launches"]
    by_path["ALS-CG-netflix"] = sparse["ALS-CG-netflix"]["optlevel3"]["launches"]
    spoof_launches = {k: sum(c[k] for c in by_path.values())
                      for k in ("spoof_cell", "spoof_row")}
    replaces = {"spoof_cell": "systemml_tpu/codegen/kernels.py:124 "
                              "cell_kernel",
                "spoof_row": "systemml_tpu/codegen/kernels.py:199 "
                             "row_kernel"}
    for label, template, plan, names, hop in kernel_plans(progs)[:2]:
        env = kernel_env(label, hop, names, torch.float32, dev, gen)
        key = "spoof_cell" if template == "cell" else "spoof_row"
        if template == "cell":
            agg = "sum"
            fns = [lambda: kernels.cell_kernel(plan, names, agg, env),
                   lambda: kernels.cell_plain(plan, names, agg, env)]
            out_bytes, cells = 4, M
        else:
            agg = "sum"
            fns = [lambda: kernels.row_kernel(plan, names, agg, env),
                   lambda: kernels.row_plain(plan, names, agg, env)]
            out_bytes, cells = 4 * M, 5 * M
        call_ms, plain_call_ms = time_ms(fns, reps=50)
        k_ms, p_ms = device_ms(fns[0]), device_ms(fns[1])
        cold_ms = device_ms(fns[0], cold=True)
        b_ms, b_by = spoof_bound(plan, env, out_bytes, cells)
        print(f"[times] {key} {agg} {label} fp32 on {smi}: device time "
              f"per call (profiler) kernel {cold_ms:.4f} ms with the L2 "
              f"cache evicted before each call (the record's ms: the bound "
              f"counts bytes from device memory), {k_ms:.4f} ms with the "
              f"inputs left in L2 by the call before, plain (the "
              f"unfused torch sequence, L2 left as it is) {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms "
              f"({b_by}, bytes from device memory); back-to-back calls by "
              f"CUDA events (host-bound "
              f"where the call's host time is longer) kernel "
              f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; no single "
              f"torch call computes a fused plan", flush=True)
        records.append({
            "name": key, "route": "cuda",
            "source": "systemml_tpu_torch/codegen/csrc/spoof.cuh",
            "replaces": replaces[key], "launches": spoof_launches[key],
            "launches_by_path": {p: c[key] for p, c in by_path.items()},
            "max_abs_err": max_abs_err[key], "ms": cold_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "warm_l2_ms": k_ms, "call_ms": call_ms,
            "plain_call_ms": plain_call_ms, "plan": plan.pretty()})
        del env
    records[1].update(time_cell_beyond_l2svm(als, ratings, als_progs, smi,
                                             kernels))
    records.append(time_chain_kernel(cla, dev, smi, max_abs_err))
    left_mult = time_left_mult(cla, dev, smi)
    records.append({
        "name": "set_cond", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/loop_graph.cu",
        "replaces": "none: systemml_tpu/runtime/loopfuse.py:379 "
                    "_trace_while (lax.while_loop's cond, no pallas_call)",
        "launches": main_path["launches"]["set_cond"],
        "max_abs_err": set_cond_rec["max_abs_err"], "ms": set_cond_rec["ms"],
        "plain_ms": set_cond_rec["plain_ms"],
        # one predicate element read, nothing written
        "bound_ms": 1e3 * 1 / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": None,
        "note": "ms: a WHILE loop's control per iteration inside one graph "
                "(counter add, compare, set_cond); plain_ms: the same loop "
                "driven from the host"})
    records.extend(time_outer_and_multiagg(als, ratings, als_progs, smi,
                                           max_abs_err, kernels))
    records[-2]["launches_by_path"] = {p: c["spoof_outer"]
                                       for p, c in by_path.items()}
    # the host time of one spoof wrapper call (a tiny input: the launch,
    # not the work); hops/cost.py HwProfile.h100().dispatch_us
    _, _, svm_plan, svm_names, svm_hop = kernel_plans(progs)[0]
    # one slice per variable: a variable named twice is one object, as on
    # the paths
    svm_full = kernel_env("l2-svm cell", svm_hop, svm_names, torch.float32,
                          dev, gen)
    small = {id(t): (t[:1024] if t.ndim == 2 else t)
             for t in svm_full.values()}
    svm_env = {nm: small[id(t)] for nm, t in svm_full.items()}
    svm_variant = hop_variant(svm_hop)
    summ = _plan_of(als_progs["summary"], "multiagg")
    s_names = list(summ.params["leaf_names"])
    tv = torch.rand(64, 64, device=dev)
    s_env = {s_names[0]: tv, s_names[1]: tv, s_names[2]: tv.sum(),
             s_names[3]: (tv != 0).sum().to(torch.float32)}
    plan0, names0 = kernel_plans(progs)[1][2], ["i0", "i1"]
    tiny = {"i0": torch.randn(1024, 5, device=dev),
            "i1": torch.randn(1024, 1, device=dev)}
    dispatch_us, _ = host_us({
        "row": lambda: kernels.row_kernel(plan0, names0, "sum", tiny),
        "cell_sum": lambda: kernels.cell_kernel(svm_plan, svm_names, "sum",
                                                svm_env),
        "cell_sum_hop_variant": lambda: kernels.cell_kernel(
            svm_plan, svm_names, "sum", svm_env, svm_variant),
        "multiagg": lambda: kernels.multiagg_kernel(
            summ.params["plan"], s_names, summ.params["aggs"], s_env)})
    print(f"[dispatch] host time of one spoof wrapper call: row on (1024, "
          f"5) {dispatch_us['row']:.2f} us, cell sum of l2-svm's plan on "
          f"(1024, 1) {dispatch_us['cell_sum']:.2f} us (with the hop's "
          f"Variant, as the path calls it, "
          f"{dispatch_us['cell_sum_hop_variant']:.2f} us), multi-aggregate "
          f"of the summary's plan on (64, 64) {dispatch_us['multiagg']:.2f} "
          f"us; "
          f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    cla_summary = {
        name: {mode: {k: v for k, v in r.items()
                      if k not in ("out", "compressed", "lines")}
               for mode, r in cla[name].items()}
        for name in ("LinearRegCG", "l2-svm")}
    print(json.dumps({"kernels": records, "card": smi,
                      "versus_eager": versus_eager, "bridge": bridge,
                      "spoof_dispatch_us": dispatch_us, "main_path": main_path,
                      "paths": paths, "cla_paths": cla_summary,
                      "als_paths": {k: r for k, r in als.items()
                                    if k not in ("factors", "cell_sums")},
                      "sparse_paths": {
                          p: {m: ({k: x for k, x in r.items()
                                   if k not in ("L", "R")}
                                  if isinstance(r, dict) else r)
                              for m, r in runs.items()}
                          for p, runs in sparse.items()},
                      "breadth_paths": breadth,
                      "minibatch_sgd": minibatch,
                      "cla_left_mult": left_mult, "region_syncs": syncs,
                      "breadth_datagen": breadth_datagen,
                      "build_seconds": build_s,
                      "nvcc_by_path": nvcc_by_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def breadth_only() -> None:
    """The algorithm-breadth paths and the datagen check alone (no kernel
    phase): what `--breadth` runs."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    from systemml_tpu_torch.codegen import kernels

    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    data = make_data(dev)
    res = breadth_paths(data, dev, kernels)
    dg = check_breadth_datagen(dev)
    print(json.dumps({"breadth_paths": res, "breadth_datagen": dg,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--breadth"]:
        breadth_only()
    elif sys.argv[1:2] == ["--bench"]:
        bench(sys.argv[2] if len(sys.argv) > 2 else os.path.basename(ROOT))
    elif sys.argv[1:2] == ["--phases"]:
        phases()
    else:
        main()
