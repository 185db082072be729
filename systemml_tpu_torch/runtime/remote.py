# Port of systemml_tpu/runtime/remote.py, with its imports pointed at
# systemml_tpu_torch: source-level shipping through lang/unparse.py,
# inputs and results as binary blocks through io/binaryblock.py, the
# persistent worker pool and its line protocol, `shippable`, and the
# worker loop `_serve_loop`, run as `python -m
# systemml_tpu_torch.runtime.remote --serve`. What differs:
# - device: a worker runs on the coordinator's DMLConfig.device, shipped
#   in meta.json with the coordinator's other settings that the port
#   reads; this replaces SMTPU_REMOTE_PLATFORM and the reference's default
#   to the CPU (:181-197). On the card each worker is a process with a
#   CUDA context of its own on the same card. A worker asked for CUDA that
#   sees no card fails its job, naming the reason; it never runs on the
#   CPU instead. Workers are started by subprocess (fork and exec), never
#   by a fork of a process that has initialised CUDA;
# - deadline: the worker acknowledges a job ("ACK") as it reads it, and
#   the job's deadline runs from there; a worker that does not
#   acknowledge within the deadline is presumed hung. Its start (process
#   spawn, torch's import) is covered by the READY handshake alone;
# - the reply "OK" carries the worker's device name and pid (JSON), and
#   `last_run` keeps the coordinator's times (payload, spawns);
# - fd 1 of a worker is its stderr: stdout, the control channel, is a
#   duplicate taken before, so no print of the body or of a library
#   reaches it;
# - the mid-task chunk checkpoint (`elastic_parfor_chunk_iters`, the
#   `parfor.chunk` site) waits for ROADMAP queue 1, distributed and
#   elastic (item 12): a group runs as one job.
"""Remote parfor: program shipping + out-of-process workers.

Equivalent of the reference's remote parfor execution
(parfor/RemoteParForSpark.java runJob; ProgramConverter.java:699
serializeParForBody / :1257 parseParForBody — each Spark executor parses
the serialized program and runs the full interpreter per task, "a
mini-SystemML"). Here each worker is a process of its own, with its own
CUDA context on the card (or the CPU, as the coordinator runs).

Shipping is SOURCE-level (lang/unparse.py): the parfor body and every
function it can reach are printed back to canonical DML, inputs go to
binary-block files (native parallel IO), and the worker re-parses,
re-compiles and runs its iterations with the standard interpreter.
Results come back as binary-block files and merge through the standard
NaN-safe result merge (runtime/parfor.merge_results).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

_BODY = "body.dml"
_META = "meta.json"
_SCALARS = "scalars.json"

# the coordinator's times of its last run_remote: payload_s (writing the
# payload), spawned (workers started), ready_s (each new worker's start to
# READY), devices (each reply's device name), groups
last_run: Dict[str, Any] = {}
# workers started by this process
spawn_count = 0


# -------------------------------------------------------------------------
# coordinator side: serialize + spawn
# -------------------------------------------------------------------------

def _shipped_config() -> Dict[str, Any]:
    """The coordinator's settings that the port reads, for the workers:
    its device first. Fault injection is the coordinator's alone."""
    from systemml_tpu_torch.utils.config import PORTED_FIELDS, get_config

    cfg = get_config()
    out = {}
    for name in sorted(PORTED_FIELDS - {"fault_injection"}):
        v = getattr(cfg, name)
        if v is None or isinstance(v, (bool, int, float, str)):
            out[name] = v
    return out


def _host_value(v):
    """A torch tensor or Python value as the payload holds it: the
    resolved value, a MatrixObject's array."""
    from systemml_tpu_torch.runtime.bufferpool import resolve
    from systemml_tpu_torch.runtime.data import MatrixObject

    v = resolve(v)
    return v.array if isinstance(v, MatrixObject) else v


def serialize_parfor(pb, ec, body_reads, payload_dir: str) -> None:
    """Write the self-contained payload: body source (+ reachable
    functions, one file per source()d namespace), shared input variables,
    loop metadata."""
    from systemml_tpu_torch.io import binaryblock
    from systemml_tpu_torch.lang import unparse
    from systemml_tpu_torch.lang.validate import _assigned_names
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    os.makedirs(payload_dir, exist_ok=True)
    prog = ec.program
    fid = ec.file_id

    # functions grouped by owning file id
    by_file: Dict[int, List] = {}
    for (f, _name), fb in prog.functions.items():
        by_file.setdefault(f, []).append(fb.fn_def)

    lines: List[str] = []
    # namespaces visible from the parfor's file scope
    for alias, target in sorted(prog.alias_maps.get(fid, {}).items()):
        ns_file = f"ns_{target}.dml"
        with open(os.path.join(payload_dir, ns_file), "w") as f:
            f.write("\n".join(ln for fd in by_file.get(target, [])
                              for ln in unparse.stmt(fd)) + "\n")
        lines.append(f'source("{ns_file}") as {alias}')
    # unqualified functions: this file's own defs + the root file's
    seen = set()
    for f in (fid, 0):
        for fd in by_file.get(f, []):
            if fd.name not in seen and not fd.external:
                seen.add(fd.name)
                lines += unparse.stmt(fd)
    lines += unparse.body(pb.body_stmts)
    with open(os.path.join(payload_dir, _BODY), "w") as f:
        f.write("\n".join(lines) + "\n")

    scalars: Dict[str, Any] = {}
    matrices: List[str] = []
    for name in sorted(body_reads):
        if name not in ec.vars or name == pb.var:
            continue
        v = _host_value(ec.vars[name])
        if isinstance(v, SparseMatrix) or (
                isinstance(v, torch.Tensor) and v.ndim == 2):
            binaryblock.write(os.path.join(payload_dir, f"{name}.bb"), v)
            matrices.append(name)
        elif isinstance(v, torch.Tensor) and v.ndim == 0:
            # a 0-d device value -> a Python scalar, its kind kept
            item = v.item()
            scalars[name] = item if isinstance(item, (bool, int)) \
                else float(item)
        elif isinstance(v, (bool, int, float, str, np.integer, np.floating)):
            # int-ness kept: toString/print formatting and integer
            # semantics must match between local and remote modes
            scalars[name] = (v if isinstance(v, (bool, str))
                             else int(v) if isinstance(v, (int, np.integer))
                             else float(v))
    with open(os.path.join(payload_dir, _SCALARS), "w") as f:
        json.dump(scalars, f)
    # result candidates = pre-loop 2-D matrices THE BODY ASSIGNS (merge
    # semantics: only pre-existing variables are results)
    assigned = _assigned_names(pb.body_stmts)
    results = []
    for name, v in ec.vars.items():
        if name not in assigned:
            continue
        rv = _host_value(v)
        if isinstance(rv, SparseMatrix) or (
                isinstance(rv, torch.Tensor) and rv.ndim == 2):
            results.append(name)
    with open(os.path.join(payload_dir, _META), "w") as f:
        json.dump({"var": pb.var, "matrices": matrices,
                   "results": sorted(results),
                   "config": _shipped_config()}, f)


def shippable(pb, ec, body_reads) -> bool:
    """Remote shipping supports matrix (dense or CSR) and scalar inputs
    and AST-backed bodies; anything else (frames, lists, compressed or
    ELL matrices) runs locally."""
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    if pb.body_stmts is None:
        return False
    for name in body_reads:
        if name not in ec.vars:
            continue
        v = _host_value(ec.vars[name])
        if isinstance(v, (SparseMatrix, bool, int, float, str, np.integer,
                          np.floating)):
            continue
        if isinstance(v, torch.Tensor) and v.layout == torch.strided \
                and v.ndim in (0, 2):
            continue
        return False
    return True


# ---- persistent worker pool ---------------------------------------------
# Workers stay alive across parfor runs, serving jobs over a line
# protocol on stdin/stdout (the executor reuse of Spark keeping executors
# warm between jobs): a second remote parfor over a same-shaped body skips
# process start, torch's import and recompilation.

_pool: List = []          # idle workers (checkout/checkin semantics)
_pool_lock = threading.Lock()
_atexit_armed = [False]


def _worker_env():
    env = dict(os.environ)
    # fault injection is armed on the COORDINATOR only: a worker
    # inheriting SMTPU_FAULT would fire the same site schedule inside
    # its own dispatches
    env.pop("SMTPU_FAULT", None)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return env, repo_root


def _spawn_worker():
    global spawn_count
    env, repo_root = _worker_env()
    err_log = tempfile.NamedTemporaryFile(
        prefix="smtpu-torch-worker-", suffix=".log", delete=False)
    p = subprocess.Popen(
        [sys.executable, "-m", "systemml_tpu_torch.runtime.remote",
         "--serve"],
        env=env, cwd=repo_root, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=err_log, text=True, bufsize=1)
    err_log.close()
    p._smtpu_errlog = err_log.name
    p._smtpu_ready = False  # READY handshake pending (first job waits)
    p._smtpu_started = time.perf_counter()
    with _pool_lock:
        spawn_count += 1
    return p


def _checkout_workers(k: int) -> List:
    """Take k workers OUT of the idle pool (concurrent run_remote calls
    must never share a worker's pipes — replies would interleave)."""
    import atexit

    out: List = []
    with _pool_lock:
        if not _atexit_armed[0]:
            _atexit_armed[0] = True
            atexit.register(shutdown_pool)
        keep: List = []
        for p in _pool:
            if p.poll() is not None:
                _retire(p)
            elif len(out) < k:
                out.append(p)
            else:
                keep.append(p)
        _pool[:] = keep
    while len(out) < k:
        out.append(_spawn_worker())
    return out


def _checkin_workers(ws: List) -> None:
    with _pool_lock:
        for p in ws:
            if p.poll() is None:
                _pool.append(p)
            else:
                _retire(p)


def _retire(p) -> None:
    """SIGKILL, not SIGTERM: a HUNG worker may be SIGSTOPped, and an
    ordinary signal would queue undelivered on it; then reap it, bounded,
    and remove its log."""
    if p.poll() is None:
        p.stdin.close()
        p.kill()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
    if os.path.exists(p._smtpu_errlog):
        os.unlink(p._smtpu_errlog)


def shutdown_pool() -> None:
    """Terminate pooled workers and remove their logs (atexit; tests)."""
    with _pool_lock:
        ws = list(_pool)
        _pool.clear()
    for p in ws:
        _retire(p)


def _errlog_tail(p, off: int) -> str:
    """Last ~2KB of the worker's stderr log since `off` (this job's
    diagnostics only)."""
    try:
        with open(p._smtpu_errlog) as f:
            f.seek(off)
            return f.read()[-2000:]
    except OSError:
        return ""


def _read_reply(p, timeout_s: float):
    """One protocol line from the worker, or None when `timeout_s`
    expires. The reader thread (not a blocking readline on the caller)
    is what makes a HUNG worker survivable: the caller regains control
    at the deadline and retires the process; the orphaned reader sees
    EOF when the kill closes the pipe and exits on its own."""
    if not timeout_s or timeout_s <= 0:
        return p.stdout.readline()
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=1)
    t = threading.Thread(target=lambda: q.put(p.stdout.readline()),
                         daemon=True)
    t.start()
    try:
        return q.get(timeout=timeout_s)
    except queue.Empty:
        return None


# worker startup budget (process spawn + torch import); generous on
# purpose — it only bounds pathological never-starts
_READY_TIMEOUT_S = 180.0


def _await_ready(p, timeout_s: float, off: int) -> None:
    """First-contact handshake: the worker prints READY once its imports
    finish, so that no job deadline counts its start."""
    from systemml_tpu_torch.resil import faults

    if p._smtpu_ready:
        return
    line = _read_reply(p, timeout_s)
    if line is None:
        raise faults.DeadlineExpired(
            f"remote parfor worker not READY within {timeout_s:.0f}s\n"
            + _errlog_tail(p, off))
    if line.strip() != "READY":
        raise faults.WorkerDiedError(
            f"remote parfor worker died during startup "
            f"(got {line.strip()!r})\n" + _errlog_tail(p, off))
    p._smtpu_ready = True
    with _pool_lock:
        last_run.setdefault("ready_s", []).append(
            time.perf_counter() - p._smtpu_started)


def _worker_run_job(p, payload: str, task_file: str, tdir: str,
                    deadline_s: float = 0.0) -> dict:
    """Ship one job and wait for its reply under `deadline_s`, counted
    from the worker's ACK. Returns the reply's JSON (device, pid).
    Raises classified faults: WorkerDiedError (dead process / EOF /
    broken pipe — with the stderr log tail), DeadlineExpired (hung
    worker), RemoteJobError (worker-side transient, e.g. OOM),
    RuntimeError (worker-side fatal: DML/programming errors, and a card
    asked for that the worker cannot see; never retried)."""
    from systemml_tpu_torch.resil import faults, inject

    # record the stderr-log offset so a failure tail covers THIS job only
    try:
        off = os.path.getsize(p._smtpu_errlog)
    except OSError:
        off = 0
    kind = inject.fire("remote.job")
    if kind == "kill":
        # real worker death: the pipes close and the coordinator sees
        # either BrokenPipeError (write) or EOF (read) — both paths below
        p.kill()
        p.wait()
    elif kind == "hang":
        import signal

        # real hang: the process stops mid-protocol; only the deadline
        # reader can get the coordinator out
        os.kill(p.pid, signal.SIGSTOP)
    elif kind is not None:
        inject.raise_kind("remote.job", kind)
    _await_ready(p, _READY_TIMEOUT_S, off)
    try:
        p.stdin.write(f"{payload}\t{task_file}\t{tdir}\n")
        p.stdin.flush()
    except (BrokenPipeError, OSError) as e:
        # a dead worker's stdin raises BEFORE any reply could be read
        raise faults.WorkerDiedError(
            "remote parfor worker died (stdin closed)\n"
            + _errlog_tail(p, off)) from e
    line = _read_reply(p, deadline_s)
    if line is None:
        raise faults.DeadlineExpired(
            f"remote parfor worker did not acknowledge its job within the "
            f"{deadline_s:.1f}s deadline (presumed hung)\n"
            + _errlog_tail(p, off))
    if line.strip() == "ACK":
        line = _read_reply(p, deadline_s)
        if line is None:
            raise faults.DeadlineExpired(
                f"remote parfor worker exceeded the {deadline_s:.1f}s job "
                f"deadline (presumed hung)\n" + _errlog_tail(p, off))
    line = line.strip()
    if line == "OK" or line.startswith("OK "):
        return json.loads(line[3:] or "{}")
    tail = _errlog_tail(p, off)
    if not line:  # EOF: the process died mid-job
        raise faults.WorkerDiedError(f"remote parfor worker died\n{tail}")
    kind = faults.classify_reply(line)
    if kind in faults.TRANSIENT:
        raise faults.RemoteJobError(
            kind, f"remote parfor worker failed ({kind}): {line}\n{tail}")
    raise RuntimeError(f"remote parfor worker failed: {line}\n{tail}")


def _collect_results(tdir: str, device) -> Dict[str, Any]:
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    out: Dict[str, Any] = {}
    for fn in os.listdir(tdir):
        if not fn.endswith(".bb"):
            continue
        path = os.path.join(tdir, fn)
        out[fn[:-3]] = _read_matrix(path, device)
        if isinstance(out[fn[:-3]], SparseMatrix):
            out[fn[:-3]] = out[fn[:-3]].to_dense()
    return out


def _read_matrix(path: str, device):
    """A binary-block file on `device`: a dense tensor in the file's
    dtype, or a SparseMatrix."""
    from systemml_tpu_torch.io import binaryblock
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    hdr = binaryblock.read_header(path)
    if hdr["storage"] == "dense":
        return binaryblock.read_tensor(
            path, device, binaryblock._TORCH_DT[np.dtype(hdr["dtype"])])
    ip, ix, d, shape = binaryblock.read(path)
    return SparseMatrix(ip, ix, torch.as_tensor(d, device=device), shape)


def run_remote(pb, ec, tasks: List[List], k: int,
               body_reads) -> List[Dict[str, Any]]:
    """Dispatch the task list over the persistent worker pool; return
    per-worker result-variable dicts for the standard merge.

    Supervised: each task group runs under the retry policy — a dead or
    hung worker is retired (SIGKILL + log cleanup) and the WHOLE group
    requeued on a fresh worker. Exactly-once merge: every attempt gets
    its own output directory and only the attempt that replied OK is
    ever read, so a worker killed mid-save can never leak partial
    result files into the merge. Fatal-classified worker errors (DML /
    programming bugs) raise immediately; retries are for the failure
    modes that go away on a fresh process."""
    from concurrent.futures import ThreadPoolExecutor

    from systemml_tpu_torch.resil import faults
    from systemml_tpu_torch.resil import policy as rpolicy
    from systemml_tpu_torch.utils import stats as stats_mod
    from systemml_tpu_torch.utils.config import get_config

    cfg = get_config()
    pol = rpolicy.policy_from_config(cfg)
    deadline_s = float(cfg.remote_deadline_s or 0.0)
    enabled = bool(cfg.resil_enabled)
    home = torch.device(cfg.device)
    spawned0 = spawn_count
    with _pool_lock:
        last_run.clear()
        last_run["devices"] = []

    with tempfile.TemporaryDirectory(prefix="smtpu-torch-parfor-") as tmp:
        payload = os.path.join(tmp, "payload")
        t0 = time.perf_counter()
        serialize_parfor(pb, ec, body_reads, payload)
        last_run["payload_s"] = time.perf_counter() - t0
        groups: List[List] = [[] for _ in range(max(1, min(k, len(tasks))))]
        for i, t in enumerate(tasks):
            groups[i % len(groups)].append(t)
        groups = [g for g in groups if g]
        workers = _checkout_workers(len(groups))
        last_run["groups"] = len(groups)

        def run_group(wi_group):
            wi, group = wi_group
            iters = [i for task in group for i in task]

            def attempt(n: int):
                # fresh per-attempt output dir: discarded unless OK
                tdir = os.path.join(tmp, f"w{wi}a{n}")
                os.makedirs(tdir)
                task_file = os.path.join(tdir, "task.json")
                with open(task_file, "w") as f:
                    json.dump({"iters": [float(i) for i in iters],
                               "attempt": n}, f)
                info = _worker_run_job(workers[wi], payload, task_file,
                                       tdir, deadline_s=deadline_s)
                with _pool_lock:
                    last_run["devices"].append(info.get("device"))
                return _collect_results(tdir, home)

            def on_transient(exc, kind, n):
                # retire the dead/hung/poisoned worker and requeue the
                # group on a fresh one; the failed attempt's partial
                # output dir is never read (exactly-once)
                p = workers[wi]
                faults.emit("worker_retired", site="remote.job",
                            pid=p.pid, kind=kind)
                _retire(p)
                workers[wi] = _checkout_workers(1)[0]
                faults.emit("requeue", site="remote.job",
                            iters=len(iters), attempt=n + 1)

            try:
                # stats context re-bound for this executor thread so the
                # retry/requeue/worker_retired counters land in `-stats`
                with stats_mod.stats_scope(ec.stats):
                    return rpolicy.run_with_retry(
                        "remote.job", attempt, pol, enabled=enabled,
                        on_transient=on_transient)
            except Exception as e:
                if faults.classify(e) in faults.TRANSIENT:
                    # budget exhausted on a dead/hung worker: retire it
                    # NOW — a SIGSTOPped process still polls alive, and
                    # checking it back in would poison the idle pool
                    _retire(workers[wi])
                raise

        try:
            with ThreadPoolExecutor(max_workers=len(groups)) as ex:
                return list(ex.map(run_group, enumerate(groups)))
        finally:
            _checkin_workers(workers)
            last_run["spawned"] = spawn_count - spawned0


# -------------------------------------------------------------------------
# worker side
# -------------------------------------------------------------------------

def _worker_config(shipped: Dict[str, Any]):
    """The coordinator's settings, bound in this worker's thread, with
    its device checked: a card asked for and not seen raises."""
    from systemml_tpu_torch.utils.config import (DMLConfig,
                                                 apply_matmul_precision,
                                                 resolve_device, set_config)

    cfg = DMLConfig()
    for name, v in shipped.items():
        setattr(cfg, name, v)
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"remote parfor worker {os.getpid()} was asked for device "
            f"{cfg.device!r}, but torch.cuda.is_available() is False in "
            f"it: it does not run on the CPU instead")
    set_config(cfg)
    resolve_device(cfg)
    apply_matmul_precision()
    return dev


def _worker_main(payload_dir: str, task_file: str, out_dir: str) -> dict:
    """The mini-framework: re-parse, re-compile, run assigned iterations,
    export result matrices (RemoteParForSparkWorker analog). Returns the
    reply's JSON: the device it ran on and its pid."""
    from systemml_tpu_torch.io import binaryblock
    from systemml_tpu_torch.ops import datagen
    from systemml_tpu_torch.runtime.bufferpool import resolve
    from systemml_tpu_torch.runtime.data import MatrixObject
    from systemml_tpu_torch.runtime.program import ExecutionContext
    from systemml_tpu_torch.runtime.sparse import SparseMatrix
    from systemml_tpu_torch.utils import stats as stats_mod

    with open(os.path.join(payload_dir, _META)) as f:
        meta = json.load(f)
    with open(os.path.join(payload_dir, _SCALARS)) as f:
        scalars = json.load(f)
    with open(task_file) as f:
        tspec = json.load(f)
    dev = _worker_config(meta.get("config", {}))

    env: Dict[str, Any] = dict(scalars)
    for name in meta["matrices"]:
        env[name] = _read_matrix(os.path.join(payload_dir, f"{name}.bb"),
                                 dev)

    program = _cached_program(os.path.join(payload_dir, _BODY),
                              tuple(sorted(env)), meta["var"])
    ec = ExecutionContext(program)
    for name, v in env.items():
        ec.vars.bind_external(name, v)
    var = meta["var"]
    with stats_mod.stats_scope(program.stats):
        for i in tspec["iters"]:
            i = int(i) if float(i).is_integer() else i
            ec.vars[var] = i
            tok = datagen.stream_scope(
                int(i) if float(i).is_integer() else hash(i) & 0x7FFFFFFF)
            try:
                for b in program.blocks:
                    b.execute(ec)
            finally:
                datagen.reset_stream(tok)

    for name in meta["results"]:
        v = resolve(ec.vars.get(name))
        if isinstance(v, MatrixObject):
            v = v.array
        if isinstance(v, SparseMatrix) or (
                isinstance(v, torch.Tensor) and v.ndim == 2):
            binaryblock.write(os.path.join(out_dir, f"{name}.bb"), v)
    return {"device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "pid": os.getpid()}


_prog_cache: Dict = {}


def _cached_program(body_path: str, input_names, var: str):
    """Compiled-Program reuse across pool jobs, keyed by the whole
    shipped program's text (the body and its source()d ns_*.dml files)
    and the input names: a persistent worker re-running the same loop
    body skips re-parse and re-compile, and its plans stay built."""
    from systemml_tpu_torch.lang.parser import parse_file
    from systemml_tpu_torch.runtime.program import compile_program

    pdir = os.path.dirname(body_path)
    parts = []
    for fn in sorted(os.listdir(pdir)):
        if fn.endswith(".dml"):
            with open(os.path.join(pdir, fn)) as f:
                parts.append(f.read())
    key = ("\x00".join(parts), tuple(input_names), var)
    prog = _prog_cache.get(key)
    if prog is None:
        prog = compile_program(parse_file(body_path),
                               input_names=list(input_names) + [var])
        if len(_prog_cache) > 8:
            _prog_cache.clear()  # tiny bound; bodies rarely vary
        _prog_cache[key] = prog
    return prog


def _serve_loop() -> None:
    """Persistent worker: serve jobs from stdin until EOF. Protocol:
    'READY' once at startup, then per job line
    'payload_dir\\ttask_file\\tout_dir' the reply 'ACK' as the line is
    read (the job's deadline runs from it), then 'OK <json>' or
    'ERR kind=<fault-kind> <one-line reason>' — the kind tag is the
    worker-side fault taxonomy, so the coordinator retries a transient
    (e.g. OOM on this worker's card) and aborts on a fatal one without
    parsing arbitrary reprs. The control channel is a duplicate of fd 1
    taken at start; fd 1 and sys.stdout then point at stderr, so that
    whatever the body or a library prints never reaches the channel."""
    from systemml_tpu_torch.resil import faults

    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    print("READY", file=proto, flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        print("ACK", file=proto, flush=True)
        try:
            payload_dir, task_file, out_dir = line.split("\t")[:3]
            info = _worker_main(payload_dir, task_file, out_dir)
            print("OK " + json.dumps(info), file=proto, flush=True)
        except Exception as e:
            # classified reply (faults.classify inside reply_for): the
            # coordinator's retry decision rides on this tag
            print(faults.reply_for(e), file=proto, flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve"]:
        _serve_loop()
    else:
        print(_worker_main(sys.argv[1], sys.argv[2], sys.argv[3]))
