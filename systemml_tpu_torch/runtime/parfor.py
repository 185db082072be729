"""parfor runtime: task-parallel loop execution with result merge.

Port of systemml_tpu/runtime/parfor.py (reference: ParForProgramBlock.java
:572 execute; LocalParWorker.java, threaded workers pulling tasks;
ResultMergeLocalMemory, which compares each worker's results against the
pre-loop matrix and merges the changed cells). Task partitioning follows
the reference's factoring scheme (TaskPartitionerFactoring.java).

What differs, in the port's idiom of explicit devices and streams:

- Workers. `k` worker threads (the `par` parameter, then
  `cfg.parfor_par`, then min(8, cpu count); on one card with neither
  set, one: runtime/parfor_opt.py) pull tasks in order. On the
  card each worker runs its tasks on a CUDA stream of its own (`lane`
  streams, made once per device and worker slot), entered with
  torch.cuda.stream: it first waits on the caller's stream, which made
  the inputs, and no worker launches on the legacy default stream. The
  caller's stream waits on an event from each worker before the merge,
  and each worker tensor the merge reads is recorded on the caller's
  stream (record_stream), so that the worker stream's allocator does not
  hand its memory out again before the merge has read it.
- Each worker binds the caller's config (utils/config is thread-local),
  a Statistics of its own, merged into the caller's after the loop (a
  loop region's capture in one worker then counts only that worker's
  ops, runtime/loopfuse.py), its worker lane (runtime/loopfuse.lane_scope:
  region entries, capture streams and the spoof reduce scratch are per
  lane) and, per iteration, the iteration's RNG sub-stream
  (ops/datagen.stream_scope).
- The loop pins the names its body reads for its whole run
  (runtime/bufferpool.pin_reads); those are resolved to live tensors once,
  in the caller, so that workers never touch the pool. Worker
  environments, and the frames of the functions they call, are plain
  dicts, as in the JAX package.
- The merge runs on the device, with no host copy of a result, with the
  JAX package's semantics (`_merge_results`): only 2-D matrices that
  existed before the loop, worker results in task order (a later task
  wins a cell two tasks change), a cell changed when it differs and is
  not NaN on both sides (-0.0 equals 0.0), a shape-changing update
  skipped, a worker's scalar writes discarded.
- A task failure that is not transient propagates out of execute_parfor
  and fails the run; there is no fallback to seq or to the CPU. A
  transient one (resil/faults.classify, a CUDA OOM included) retries
  through resil/policy.run_with_retry at the `parfor.task` site.
- Device mode: one draining worker per CUDA device (on one card, one
  worker), its inputs replicated there with `.to(device)`. Remote mode:
  worker processes on the caller's device (runtime/remote.py), their
  results read back onto it and merged here. The elastic mid-task chunk
  checkpoint of the JAX package waits for ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from systemml_tpu_torch.utils.config import get_config


def _degree_of_parallelism(pb, ec) -> int:
    if "par" in pb.params:
        return max(1, int(ec.eval_scalar(pb.params["par"])))
    cfg = get_config()
    if cfg.parfor_par > 0:
        return cfg.parfor_par
    return min(8, os.cpu_count() or 4)


def partition_tasks(iters: List, k: int, scheme: str = "factoring") -> List[List]:
    """Split iterations into tasks (reference: TaskPartitioner{Fixedsize,
    Naive,Static,Factoring}.java)."""
    n = len(iters)
    if n == 0:
        return []
    if scheme == "naive":
        return [[i] for i in iters]
    if scheme == "static":
        sz = max(1, (n + k - 1) // k)
        return [iters[i:i + sz] for i in range(0, n, sz)]
    # factoring: wave w has k tasks of size ceil(remaining / (2k))
    tasks, pos, remaining = [], 0, n
    while remaining > 0:
        size = max(1, (remaining + 2 * k - 1) // (2 * k))
        for _ in range(k):
            if pos >= n:
                break
            chunk = iters[pos:pos + size]
            pos += len(chunk)
            remaining -= len(chunk)
            if chunk:
                tasks.append(chunk)
    return tasks


def _body_read_names(blocks) -> set:
    """All variable names a block tree may read (over-approximate: includes
    names also written first). Used to pin shared inputs for the loop."""
    from systemml_tpu_torch.runtime import program as P

    names = set()
    for b in blocks:
        if isinstance(b, P.BasicBlock):
            names |= set(b.hops.reads)
        elif isinstance(b, P.IfBlock):
            names |= set(b.pred.block.hops.reads)
            names |= _body_read_names(b.if_body)
            names |= _body_read_names(b.else_body)
        elif isinstance(b, P.WhileBlock):
            names |= set(b.pred.block.hops.reads)
            names |= _body_read_names(b.body)
        elif isinstance(b, P.ForBlock):  # covers ParForBlock
            for pred in (b.from_h, b.to_h, b.incr_h):
                if pred is not None:
                    names |= set(pred.block.hops.reads)
            names |= _body_read_names(b.body)
    return names


# --------------------------------------------------------------------------
# worker lanes: one CUDA stream per (device, worker slot), made once
# --------------------------------------------------------------------------

_lane_streams: Dict[Tuple[int, int], torch.cuda.Stream] = {}
_lane_lock = threading.Lock()


def lane_stream(dev: torch.device, slot: int) -> "torch.cuda.Stream":
    """The CUDA stream of worker `slot` on `dev`: a non-blocking stream of
    its own (codegen/loop_graph.new_stream; never the legacy default
    stream, and no other lane's or capture's, as torch's pool of 32
    streams per device could give)."""
    from systemml_tpu_torch.codegen import loop_graph as lg

    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev.index, slot)
    with _lane_lock:
        s = _lane_streams.get(key)
        if s is None:
            s = _lane_streams[key] = lg.new_stream(dev)
        return s


_libs_ready = threading.Event()


def _init_libraries(dev: torch.device) -> None:
    """Loads torch's CUDA linear-algebra library in the caller's thread,
    once: its lazy load at a first call is not safe from several threads
    at once ("lazy wrapper should be called at most once")."""
    if not _libs_ready.is_set():
        with _lane_lock:
            if not _libs_ready.is_set():
                m = torch.eye(2, device=dev)
                torch.linalg.inv_ex(m)
                torch.linalg.cholesky_ex(m)
                torch.linalg.solve_ex(m, m)
                torch.linalg.qr(m)
                torch.linalg.eigh(m)
                torch.linalg.svd(m)
                _libs_ready.set()


class _Lane:
    """What one worker thread ran: its slot, device, stream, Statistics,
    its tasks' results by task index, and the event its stream recorded
    after its last task."""

    def __init__(self, slot: int, dev: torch.device, stats):
        self.slot = slot
        self.dev = dev
        self.stream = (lane_stream(dev, slot) if dev.type == "cuda"
                       else None)
        self.stats = stats
        self.done: Optional[torch.cuda.Event] = None
        self.tasks = 0


def execute_parfor(pb, ec):
    """Execute a ParForBlock: dependency check, plan, workers, merge."""
    from systemml_tpu_torch.lang.parfor_deps import check_parfor_dependencies
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.runtime import parfor_opt
    from systemml_tpu_torch.runtime.bufferpool import pin_reads, resolve

    iters = list(pb._range(ec))
    if not iters:
        return
    check = True
    if "check" in pb.params:
        check = bool(ec.eval_scalar(pb.params["check"]))
    if check and pb.body_stmts is not None:
        check_parfor_dependencies(pb.var, pb.body_stmts)

    k = _degree_of_parallelism(pb, ec)
    explicit_par = "par" in pb.params
    mode = "auto"
    if "mode" in pb.params:
        mode = str(ec.eval_scalar(pb.params["mode"])).lower()
    if explicit_par and k <= 1:
        mode = "seq"  # a deliberate par=1 always serializes
    body_reads = _body_read_names(pb.body)

    # cost-based plan (runtime/parfor_opt, the OptimizerRuleBased analog):
    # exec mode, k, task partitioner from the roofline model over the
    # body with concrete runtime dims
    plan = parfor_opt.optimize(pb, ec, iters, k, body_reads, mode,
                               explicit_k=explicit_par)
    mode, k = plan.mode, plan.k
    devs = parfor_opt.devices()
    if mode == "device":
        k = min(k, len(devs))
    pb.last_plan = plan  # surfaced by -explain runtime
    ec.stats.count_estim(f"parfor_{plan.mode}_{plan.partitioner}")

    opt_scheme = plan.partitioner
    if "taskpartitioner" in {p.lower() for p in pb.params}:
        opt_scheme = str(ec.eval_scalar(
            next(v for kk, v in pb.params.items()
                 if kk.lower() == "taskpartitioner"))).lower()
    tasks = partition_tasks(iters, k, opt_scheme)

    with pin_reads(ec.vars, body_reads), \
            obs.span("parfor", obs.CAT_PARFOR, mode=mode, k=k,
                     tasks=len(tasks), iters=len(iters),
                     partitioner=opt_scheme):
        # raw copy: names the body reads resolve here, once, to live
        # tensors (pinned, so the pool keeps them on the device); the
        # rest stay lazy handles no worker touches
        base = dict(ec.vars)
        for n in body_reads:
            if n in base:
                base[n] = resolve(base[n])
        run = _ParforRun(pb, ec, base, body_reads, devs, k)
        if mode == "remote":
            from systemml_tpu_torch.runtime import remote

            ec.stats.count_mesh_op("parfor_remote")
            worker_results = remote.run_remote(pb, ec, tasks, k, body_reads)
        elif mode == "device":
            # one worker per device, each draining its group of tasks in
            # turn: at most one task working set lives on a device at a
            # time (the budget assumption of parfor_opt's replica gate)
            ec.stats.count_mesh_op("parfor_device")
            groups: List[List[int]] = [[] for _ in range(min(k, len(devs)))]
            for i in range(len(tasks)):
                groups[i % len(groups)].append(i)
            used = [(g, d) for g, d in zip(groups, devs) if g]
            worker_results = run.workers(tasks, [[g] for g, _ in used],
                                         [d for _, d in used])
        elif k <= 1 or len(tasks) <= 1 or mode == "seq":
            worker_results = run.workers(tasks, [[list(range(len(tasks)))]],
                                         [run.home])
        else:
            worker_results = run.workers(
                tasks, [None] * min(k, len(tasks)),
                [run.home] * min(k, len(tasks)))
        merge_results(ec, base, worker_results, run.replica_ids(),
                      run.home)


class _ParforRun:
    """One execution of a parfor: its base environment, its per-device
    replicas, its retry policy, and the workers that run its tasks."""

    def __init__(self, pb, ec, base, body_reads, devs, k):
        from systemml_tpu_torch.resil import policy as rpolicy
        from systemml_tpu_torch.runtime.loopfuse import _region_device

        self.pb, self.ec, self.base = pb, ec, base
        self.body_reads = body_reads
        self.devs = devs
        self.k = k
        self.home = _region_device(ec)
        self.cfg = get_config()
        self.retry = rpolicy.policy_from_config(self.cfg)
        self._replicas: Dict[Tuple[str, str], Any] = {}
        self._rlock = threading.Lock()

    def replica_ids(self):
        return {id(v) for v in self._replicas.values()}

    # ---- environments ---------------------------------------------------

    def _env_for_device(self, dev) -> Dict[str, Any]:
        """A worker's environment: the base, with the tensors the body
        reads replicated on `dev` when it is not the caller's device (the
        reference: RemoteParForSpark broadcasts shared inputs once)."""
        if dev == self.home:
            return dict(self.base)
        env = {}
        for name, v in self.base.items():
            if name in self.body_reads and isinstance(v, torch.Tensor):
                key = (str(dev), name)
                with self._rlock:
                    pv = self._replicas.get(key)
                    if pv is None:
                        pv = self._replicas[key] = v.to(dev)
                env[name] = pv
            else:
                env[name] = v
        return env

    # ---- one task --------------------------------------------------------

    def _run_task_once(self, task: List, dev, lane: _Lane) -> Dict[str, Any]:
        from systemml_tpu_torch.obs import trace as obs
        from systemml_tpu_torch.ops import datagen
        from systemml_tpu_torch.resil import inject
        from systemml_tpu_torch.runtime.program import ExecutionContext

        pb, ec = self.pb, self.ec
        # named fault-injection site: one arrival per task ATTEMPT
        inject.check("parfor.task")
        local = ExecutionContext(ec.program, lane.stats, ec.printer,
                                 ec.file_id)
        local.skip_writes = ec.skip_writes
        local.vars = self._env_for_device(dev)
        with obs.span("parfor_task", obs.CAT_PARFOR, iters=len(task),
                      first=str(task[0]) if task else "", device=str(dev),
                      lane=lane.slot):
            for i in task:
                local.vars[pb.var] = i
                # the iteration's own RNG sub-stream, whichever worker,
                # stream or device runs it
                tok = datagen.stream_scope(
                    int(i) if float(i).is_integer()
                    else hash(i) & 0x7FFFFFFF)
                try:
                    for b in pb.body:
                        b.execute(local)
                finally:
                    datagen.reset_stream(tok)
        return local.vars

    def _run_task(self, task: List, dev, lane: _Lane) -> Dict[str, Any]:
        """Supervised task execution (the LocalParWorker analog of Spark's
        task retry): a transient failure re-runs the task up to the
        policy's attempts, in device mode on another device where one is
        left; a fatal one raises. Each attempt starts from a fresh copy
        of the base, so the merge sees only the attempt that returned."""
        from systemml_tpu_torch.obs import trace as obs
        from systemml_tpu_torch.resil import policy as rpolicy

        state = {"dev": dev, "tried": []}

        def attempt(n: int):
            return self._run_task_once(task, state["dev"], lane)

        def on_transient(exc, kind, n):
            cur = state["dev"]
            if len(self.devs) > 1 and cur != self.home:
                state["tried"].append(cur)
                left = [d for d in self.devs if d not in state["tried"]]
                if left:
                    state["dev"] = left[0]
            obs.instant("parfor_task_retry", obs.CAT_RESIL,
                        site="parfor.task", kind=kind, attempt=n,
                        first=str(task[0]) if task else "",
                        device=str(state["dev"]))

        return rpolicy.run_with_retry("parfor.task", attempt, self.retry,
                                      enabled=self.cfg.resil_enabled,
                                      on_transient=on_transient)

    # ---- workers ---------------------------------------------------------

    def workers(self, tasks: List[List], assigned: List[Optional[List]],
                devs: List) -> List[Dict[str, Any]]:
        """Runs `tasks` on one worker per entry of `assigned` (a fixed list
        of task indices it drains in turn, or None: it pulls the next task
        of the shared queue) on the device beside it, and returns the
        results in task order. Raises the first failure, by task order,
        after every worker has stopped."""
        from systemml_tpu_torch.runtime.loopfuse import lane_scope
        from systemml_tpu_torch.utils import stats as stats_mod
        from systemml_tpu_torch.utils.config import set_config
        from systemml_tpu_torch.utils.stats import Statistics

        ec = self.ec
        if any(torch.device(d).type == "cuda" for d in devs):
            _init_libraries(torch.device(devs[0]))
        results: List[Optional[Dict[str, Any]]] = [None] * len(tasks)
        errors: Dict[int, BaseException] = {}
        nxt = [0]
        qlock = threading.Lock()
        lanes = [_Lane(slot, torch.device(d), Statistics())
                 for slot, d in enumerate(devs)]
        ready = {}
        for d in {ln.dev for ln in lanes if ln.dev.type == "cuda"}:
            # the caller's stream made the inputs: workers wait on this
            ev = ready[d] = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))

        def take(own: Optional[List[int]]):
            with qlock:
                if errors:
                    return None
                if own is not None:
                    return own.pop(0) if own else None
                if nxt[0] >= len(tasks):
                    return None
                nxt[0] += 1
                return nxt[0] - 1

        def drain(lane: _Lane, own: Optional[List[int]]):
            set_config(self.cfg)
            with stats_mod.stats_scope(lane.stats), lane_scope(lane.slot):
                while True:
                    ti = take(own)
                    if ti is None:
                        return
                    try:
                        results[ti] = self._run_task(tasks[ti], lane.dev,
                                                     lane)
                        lane.tasks += 1
                    except BaseException as e:  # noqa: BLE001 — re-raised by the caller
                        with qlock:
                            errors[ti] = e
                        return

        def body(lane: _Lane, own: Optional[List[int]]):
            if lane.stream is None:
                drain(lane, own)
                return
            with torch.cuda.device(lane.dev), torch.cuda.stream(lane.stream):
                lane.stream.wait_event(ready[lane.dev])
                try:
                    drain(lane, own)
                finally:
                    lane.done = torch.cuda.Event()
                    lane.done.record(lane.stream)

        own_lists = [None if a is None else list(a[0]) for a in assigned]
        if len(lanes) == 1:
            # one worker: the caller's thread runs it (seq, par=1, one
            # device), on the worker stream all the same
            body(lanes[0], own_lists[0])
        else:
            threads = [threading.Thread(target=body, args=(ln, own),
                                        name=f"parfor-{ln.slot}",
                                        daemon=True)
                       for ln, own in zip(lanes, own_lists)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for ln in lanes:
            ec.stats.merge(ln.stats)
            if ln.done is not None:
                torch.cuda.current_stream(self.home).wait_event(ln.done)
        ec.stats.count_estim("parfor_lanes", len(lanes))
        if errors:
            raise errors[min(errors)]
        return results


def merge_results(ec, base: Dict[str, Any],
                  worker_results: List[Dict[str, Any]],
                  replica_ids=frozenset(), home=None) -> None:
    """Result merge (reference: ResultMergeLocalMemory.java): each
    worker's matrix against the pre-loop version, the changed cells
    taken, in task order; only pre-existing matrices are result
    variables, worker temps are discarded. Unmodified per-device input
    replicas (replica_ids) are recognized by identity and skipped. Runs
    on the caller's stream, on the device: each worker tensor it reads
    is recorded on that stream first."""
    from systemml_tpu_torch.runtime.bufferpool import resolve

    def unchanged(v, orig):
        return v is orig or v is None or id(v) in replica_ids

    caller = (torch.cuda.current_stream(home)
              if home is not None and home.type == "cuda" else None)
    for name, orig in base.items():
        if all(unchanged(wv.get(name), orig) for wv in worker_results):
            continue
        orig = resolve(orig)
        if not isinstance(orig, torch.Tensor) or orig.ndim != 2 \
                or orig.layout != torch.strided:
            continue
        merged = None
        for wv in worker_results:
            v = wv.get(name)
            if unchanged(v, base[name]):
                continue
            if not isinstance(v, torch.Tensor) or v.layout != torch.strided \
                    or tuple(v.shape) != tuple(orig.shape):
                continue  # shape-changing updates are not mergeable results
            if caller is not None and v.device.type == "cuda":
                v.record_stream(caller)
            v = v.to(orig.device)
            if merged is None:
                merged = orig.clone()
            # NaN-safe: NaN -> NaN is unchanged; -0.0 equals 0.0
            changed = (v != orig) & ~(torch.isnan(v) & torch.isnan(orig))
            merged = torch.where(changed, v.to(merged.dtype), merged)
        if merged is not None:
            ec.vars[name] = merged
