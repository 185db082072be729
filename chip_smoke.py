"""Chip smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, LinearRegCG through
systemml_tpu_torch.api.mlcontext.MLContext on the card at 2,000,000 x
1,000 fp32, and holds every kernel of that path against its plain
PyTorch version. Phases:

0. environment: torch and CUDA versions, the card, its power limit;
1. build: every kernel library of the path from
   systemml_tpu_torch/codegen/csrc/; build seconds and ptxas report;
2. each kernel against its plain version at the main path's shapes and
   others: normwise relative error against the plain version in fp64 on
   the card (bar 1e-4: fp32 sums over up to 2e6 rows in another order),
   and bit-identical output from two launches; X contiguous and as a
   column slice of a wider matrix, which the kernel reads in place;
3. the main path, with every launch counter set to 0 just before and read
   just after: each kernel of the path must have launched (mmchain once
   per CG iteration), beta must be within 1e-3 of beta_true, and the
   peak of allocated device memory below twice the bytes of X. The run
   is timed without a profiler: host clock and CUDA events around the
   program's execution and around its CG loop. Two more runs under
   torch.profiler (device activity only, then host and device) give the
   device's busy share and the profiler's own cost;
4. times with CUDA events: each kernel, its plain version, the library
   call that computes the same function, and the least time the card
   could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s fp32,
   the H100 SXM's published peaks).

Prints a {"kernels": [...]} line before the last, and as the last line
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

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
M, K = 2_000_000, 1_000        # scripts/perftest/run_perftest.py scale L
KERNEL_BAR = 1e-4
KERNEL_SOURCES = ("mmchain",)  # systemml_tpu_torch/codegen/csrc/<name>.cu
ROOT = os.path.dirname(os.path.abspath(__file__))


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
    """Windows of the program's execution and of its while loops, on the
    host clock and in CUDA events, taken without a profiler: for the
    duration of a with-block it wraps Program.execute and
    WhileBlock.execute of the port's runtime. `windows[label]` lists
    (host ms, device ms, host start, host end, start event, end event) in
    the order the windows close."""

    def __init__(self):
        from systemml_tpu_torch.runtime import program
        self._classes = {"execute": program.Program,
                         "loop": program.WhileBlock}
        self.windows = {label: [] for label in self._classes}

    def __enter__(self):
        self._orig = {label: cls.execute
                      for label, cls in self._classes.items()}
        for label, cls in self._classes.items():
            cls.execute = self._wrap(label, self._orig[label])
        return self

    def __exit__(self, *exc):
        for label, cls in self._classes.items():
            cls.execute = self._orig[label]
        torch.cuda.synchronize()
        self.windows = {label: [(1e3 * (t1 - t0), e0.elapsed_time(e1), t0,
                                 t1, e0, e1) for t0, t1, e0, e1 in ws]
                        for label, ws in self.windows.items()}

    def _wrap(self, label, orig):
        def execute(blk, *args, **kwargs):
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
        return execute


def profile_main_path(ml, script, host_activity: bool):
    """One more run of the main path under torch.profiler, recording the
    device's activity, and the host's too when `host_activity`. Returns
    (and prints) the device's busy share of the run's wall time (parse and
    compile included), the CG loop's period (median time from one mmchain
    launch to the next) and the busy share inside the loop, and device ms
    by kernel name. Says "not measured" when the profiler records no
    kernels."""
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
    starts = [e.time_range.start for e in ks if "mmchain_partial" in e.name]
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
        print(f"[profile {what}] CG loop: {out['cg_iteration_ms']:.3f} ms per "
              f"iteration (mmchain launch to launch), device busy "
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


def phase_windows(timer: PhaseTimer, iters: int, label: str) -> dict:
    """An unprofiled run's execution split into the prologue before the
    CG loop, the loop and the epilogue after it, each on the host clock
    and in device time between CUDA events. Prints and returns them."""
    (ex_h, ex_d, ex_t0, ex_t1, ex_e0, ex_e1), = timer.windows["execute"]
    lp_h, lp_d, lp_t0, lp_t1, lp_e0, lp_e1 = max(timer.windows["loop"])
    out = {"execute_host_ms": ex_h, "execute_device_window_ms": ex_d,
           "prologue_host_ms": 1e3 * (lp_t0 - ex_t0),
           "prologue_device_window_ms": ex_e0.elapsed_time(lp_e0),
           "loop_host_ms": lp_h, "loop_device_window_ms": lp_d,
           "epilogue_host_ms": 1e3 * (ex_t1 - lp_t1),
           "epilogue_device_window_ms": lp_e1.elapsed_time(ex_e1),
           "cg_iteration_ms": lp_d / max(iters, 1)}
    print(f"[windows] {label}, host clock / device window between "
          f"CUDA events: execution {ex_h:.3f} / {ex_d:.3f} ms = prologue "
          f"{out['prologue_host_ms']:.3f} / "
          f"{out['prologue_device_window_ms']:.3f} + CG loop {lp_h:.3f} / "
          f"{lp_d:.3f} + epilogue {out['epilogue_host_ms']:.3f} / "
          f"{out['epilogue_device_window_ms']:.3f}; CG loop "
          f"{out['cg_iteration_ms']:.3f} ms per iteration over {iters}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "systemml_tpu_torch")):
        fail("systemml_tpu_torch/ is not beside chip_smoke.py")
    from systemml_tpu_torch.api.mlcontext import MLContext, dmlFromFile
    from systemml_tpu_torch.codegen import build, kernels

    # ---- 0. environment ---------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name!r}, count {torch.cuda.device_count()}")
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # true fp32 references

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    for src in KERNEL_SOURCES:
        build.load(src)
    print(f"[build] {len(KERNEL_SOURCES)} libraries {list(KERNEL_SOURCES)} "
          f"in {time.perf_counter() - t0:.1f} s")
    for src, (secs, report) in build.build_reports.items():
        lines = [ln.strip() for ln in report.splitlines()
                 if "ptxas" in ln and ("registers" in ln or "spill" in ln
                                       or "Compiling" in ln or "smem" in ln)]
        print(f"[build] {src}.cu: nvcc {secs:.1f} s")
        for ln in lines:
            print(f"[build]   {ln}")
    sys.stdout.flush()

    # ---- 2. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    max_abs_err = 0.0
    # (m, k, c, width of the matrix X is a column slice of, first column)
    for m, k, c, width, col0 in ((M, K, 1, K, 0), (100_003, K, 4, K, 0),
                                 (4_097, 128, 8, 128, 0),
                                 (100_003, K, 4, 1_004, 4),
                                 (4_097, 128, 8, 130, 1)):
        x = torch.randn(m, width, generator=gen, device=dev)[:, col0:col0 + k]
        v = torch.randn(k, c, generator=gen, device=dev)
        wcols = {"XtXv": 0, "XtwXv": 1, "XtXvy": c}
        xd = x.double()
        for ctype, wc in wcols.items():
            w = (torch.randn(m, wc, generator=gen, device=dev)
                 if wc else None)
            out = kernels.mmchain_kernel(x, v, w, ctype)
            again = kernels.mmchain_kernel(x, v, w, ctype)
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
                     f"normwise error "
                     f"{err} > {KERNEL_BAR}")
            if not same:
                fail(f"mmchain {ctype} at ({m}, {k}, {c}), width {width}: two "
                     f"launches "
                     f"differ")
            if (m, k, c) == (M, K, 1) and ctype == "XtXv":
                max_abs_err = abs_err
        del x, v, xd, w, out, again, ref
    torch.cuda.empty_cache()

    # ---- 3. the main path -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=gen, device=dev)
    beta_true = torch.randn(K, 1, generator=gen, device=dev)
    y = x @ beta_true
    x_bytes = x.numel() * x.element_size()
    lines = []

    def printer(s):
        lines.append(s)
        print(f"[script] {s}", flush=True)

    def linregcg(xs, ys):
        return (dmlFromFile(os.path.join(ROOT, "scripts", "algorithms",
                                         "LinearRegCG.dml"))
                .input("X", xs).input("y", ys).arg("maxi", 20)
                .arg("tol", 1e-9).arg("reg", 1e-6).output("beta"))

    ml = MLContext()
    # warm-up on the first 8,192 rows: CUDA and cuBLAS initialisation and
    # the host's first compile stay out of the timed run
    ml.printer = lambda s: None
    ml.execute(linregcg(x[:8192], y[:8192]))
    ml.printer = printer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.mmchain_kernel.launches = 0
    t0 = time.perf_counter()
    with PhaseTimer() as timer:
        res = ml.execute(linregcg(x, y))
        beta = res.get_tensor("beta")
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"mmchain": kernels.mmchain_kernel.launches}
    exec_secs = ml._stats.run_time
    peak = torch.cuda.max_memory_allocated(dev)
    iters = next((int(s.split("iterations = ")[1].split(",")[0])
                  for s in lines if s.startswith("LinearRegCG: iterations")),
                 None)
    if iters is None:
        fail("the script printed no iteration count")
    rel = float(torch.linalg.norm(beta.double() - beta_true.double())
                / torch.linalg.norm(beta_true.double()))
    print(f"[main] LinearRegCG {M} x {K} fp32 on {beta.device}: {iters} "
          f"iterations, {secs:.3f} s total ({exec_secs:.3f} s executing, the "
          f"rest parse and compile), {1e3 * exec_secs / max(iters, 1):.2f} ms "
          f"of execution per CG iteration (prologue and epilogue included)")
    print(f"[main] launches {launches}; |beta - beta_true| / |beta_true| = "
          f"{rel:.3e}; peak allocated {peak / 1e9:.2f} GB, X {x_bytes / 1e9:.2f}"
          f" GB", flush=True)
    if beta.shape != (K, 1) or not bool(torch.isfinite(beta).all()):
        fail(f"beta has shape {tuple(beta.shape)} or is not finite")
    if beta.dtype != torch.float32 or beta.device.type != "cuda":
        fail(f"beta is {beta.dtype} on {beta.device}, not fp32 on the card")
    if launches["mmchain"] != iters or iters < 1:
        fail(f"mmchain launched {launches['mmchain']} times in {iters} CG "
             f"iterations")
    if not rel <= 1e-3:
        fail(f"beta is {rel} from beta_true (bar 1e-3)")
    if peak >= 2 * x_bytes:
        fail(f"peak device memory {peak} B >= 2 x X ({x_bytes} B): X was "
             f"copied")
    windows = {"first": phase_windows(timer, iters, "timed run")}
    # the same run again, unprofiled: what of the timed run's host time is
    # its first use of full-size buffers
    ml.printer = lambda s: None
    with PhaseTimer() as timer:
        ml.execute(linregcg(x, y)).get_tensor("beta")
        torch.cuda.synchronize()
    ml.printer = printer
    windows["second"] = phase_windows(timer, iters, "second unprofiled run")
    del res, beta
    profiled = {"device_only": profile_main_path(ml, linregcg(x, y), False),
                "host_and_device": profile_main_path(ml, linregcg(x, y),
                                                     True),
                "python_host_ms": host_profile(ml, linregcg(x, y))}
    del y

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
    record = {"kernels": [{
        "name": "mmchain", "route": "cuda",
        "source": "systemml_tpu_torch/codegen/csrc/mmchain.cu",
        "replaces": "systemml_tpu/codegen/kernels.py:347 mmchain_kernel",
        "launches": launches["mmchain"], "max_abs_err": max_abs_err,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
        else "operations",
        "library_ms": lib_ms}],
        "card": smi, "main_path": {
            "iterations": iters, "seconds": secs, "exec_seconds": exec_secs,
            "beta_rel_err": rel, "peak_bytes": peak, "windows": windows,
            "profile": profiled}}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
