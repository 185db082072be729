"""Production scoring tier over prepared scripts.

Port of systemml_tpu/api/serving.py:44-714, with its thread-safety
contract in docs/serving.md. JMLC's prepare-once/score-many contract
(api/jmlc.py) makes repeated same-shape calls cheap; this module makes
heterogeneous concurrent traffic cheap:

- ``ScoringService``: shape-bucketed dispatch. A request whose leading
  (batch) dimension varies pads up to the nearest rung of a ladder
  (default 1/8/64/512), so one plan per rung serves every request size:
  on the card, one block graph per rung (runtime/blockcompile.py), which
  a request fills with a copy and one launch. Pad safety is proven, not
  assumed: the row-decomposition analysis
  (compiler/lower.analyze_rowwise_safety) must show every output either
  row-aligned with the batch input or independent of it; otherwise
  bucketing disables itself and requests run at exact shapes.
- ``MicroBatcher``: request coalescing. Concurrent small requests queue
  and flush as one padded dispatch (on size or deadline; deadline in
  us), so N concurrent users cost about one dispatch instead of N.
- ``MetricsEndpoint``: the /metrics scrape surface around the service's
  registry.

Every bucket hit or miss and every flush lands on the event bus
(CAT_SERVING) and in ``-stats`` (``srv_*`` counters, the "Serving"
line). Both classes are safe to call from any number of threads: the
seen-rung set and the queue each sit behind a lock of their own, and
the prepared script below them is held to the same contract
(api/jmlc.py).

A dense request's rows are padded on the script's device: a host array
is first copied to it as it is (its real rows only), then padded there
with ``torch.nn.functional.pad``; a scipy CSR, the port's
``SparseMatrix`` or a torch CSR tensor is padded as it is, and stays
sparse. The micro-batcher
concatenates tensors with ``torch.cat`` on their device and host arrays
with numpy, and hands each request its rows in the kind it came in.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from systemml_tpu_torch.api.jmlc import PreparedScript
from systemml_tpu_torch.utils.config import get_config


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder rung >= n; beyond the top rung, the next
    power-of-two multiple of it: unbounded request sizes still hit a
    bounded set of shapes."""
    if n < 1:
        raise ValueError(f"batch dimension must be >= 1, got {n}")
    for b in ladder:
        if n <= b:
            return int(b)
    b = int(ladder[-1])
    while b < n:
        b *= 2
    return b


def _is_sparse(x) -> bool:
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    if isinstance(x, SparseMatrix):
        return True
    if isinstance(x, torch.Tensor):
        return x.layout != torch.strided
    try:
        import scipy.sparse as ssp
    except ImportError:
        return False
    return ssp.issparse(x)


class ScoringService:
    """Concurrent scoring over one PreparedScript with a shape-bucketed
    plan cache.

    `constants` are the fixed non-batch bindings (model weights, bias,
    hyperparameter scalars), unwrapped once: their device copies are
    shared by every request. `batch_input` names the input whose leading
    dimension varies per request; when `prepared` carries prepare-time
    ``input_meta`` with a ``shape`` of ``(None, ...)`` for exactly one
    input, that input is picked automatically.

    ``validate``: "auto" (default) runs the row-decomposition proof and
    falls back to exact-shape execution when it refuses (the reason on
    ``.safety_reason``); "force" buckets regardless (the caller asserts
    row-decomposability that the analysis cannot see, e.g. a fused plan
    at optlevel 3); "off" never buckets. The ladder comes from the active
    config's ``serving_bucket_ladder`` unless given.
    """

    def __init__(self, prepared: PreparedScript,
                 batch_input: Optional[str] = None,
                 constants: Optional[Dict[str, Any]] = None,
                 ladder: Optional[Sequence[int]] = None,
                 validate: str = "auto"):
        from systemml_tpu_torch.obs.metrics import MetricsRegistry
        from systemml_tpu_torch.utils.stats import register_trace_dropped

        cfg = get_config()
        self._ps = prepared
        self._batch_input = batch_input or self._infer_batch_input(prepared)
        ladder = tuple(ladder if ladder is not None
                       else cfg.serving_bucket_ladder)
        if not ladder or any(int(b) < 1 for b in ladder):
            raise ValueError(f"invalid bucket ladder {ladder!r}")
        self._ladder = tuple(sorted({int(b) for b in ladder}))
        self._constants = {n: prepared._unwrap_cached(n, v)
                           for n, v in (constants or {}).items()}
        self._lock = threading.Lock()
        self._seen_buckets: set = set()
        # service-scoped metrics (obs/metrics.py): per-request latency,
        # bucket hits and misses and the live hit rate, scraped through
        # metrics() / metrics_text() / serve_metrics()
        self.registry = MetricsRegistry()
        self._m_latency = self.registry.histogram(
            "request_seconds", "per-request scoring latency", unit="s")
        self._m_requests = self.registry.counter(
            "requests_total", "scoring requests served")
        self._m_hits = self.registry.counter(
            "bucket_hits_total", "bucketed dispatches that hit a warm "
            "rung")
        self._m_misses = self.registry.counter(
            "bucket_misses_total", "bucketed dispatches that compiled a "
            "new rung")
        self._m_pad = self.registry.counter(
            "pad_rows_total", "rows of zero padding dispatched")
        self.registry.gauge(
            "bucket_hit_rate", "fraction of bucketed dispatches served "
            "by a warm rung",
            fn=lambda: (self._m_hits.value
                        / max(1, self._m_hits.value
                              + self._m_misses.value)))
        register_trace_dropped(self.registry)
        if validate not in ("auto", "force", "off"):
            raise ValueError(f"validate must be auto|force|off, "
                             f"got {validate!r}")
        self.safety_reason = ""
        # per-output rows/const classes of the proof: only rows-class
        # outputs are sliced back (exact un-padding, no shape guessing)
        self._out_classes: Dict[str, str] = {}
        # batchable: the stronger per-row property that coalescing needs
        # (MicroBatcher): a cumsum is pad-safe, but one user's rows must
        # never see another's running totals
        if validate == "off":
            self.bucketing_enabled = False
            self.batchable = False
            self.safety_reason = "disabled by caller (validate='off')"
        elif validate == "force":
            self.bucketing_enabled = True
            self.batchable = True
        else:
            proof = self._prove_rowwise_safe()
            self.bucketing_enabled = proof.safe
            self.batchable = proof.safe and proof.row_local
            self.safety_reason = proof.reason
            self._out_classes = dict(proof.out_classes)

    @staticmethod
    def _infer_batch_input(prepared: PreparedScript) -> str:
        varying = [n for n, m in prepared.input_meta.items()
                   if isinstance(m, dict)
                   and m.get("shape") and m["shape"][0] is None]
        if len(varying) == 1:
            return varying[0]
        raise ValueError(
            "batch_input not given and input_meta does not declare "
            "exactly one input with shape (None, ...): pass batch_input "
            "explicitly")

    def _prove_rowwise_safe(self):
        from systemml_tpu_torch.compiler.lower import (RowwiseSafety,
                                                       analyze_rowwise_safety)

        known: Dict[str, Tuple[int, int]] = {}
        for n, m in self._ps.input_meta.items():
            shp = m.get("shape") if isinstance(m, dict) else None
            if shp and len(shp) >= 1 and shp[0] is not None:
                known[n] = (int(shp[0]),
                            int(shp[1]) if len(shp) > 1 and shp[1] else -1)
        for n, v in self._constants.items():
            shp = getattr(v, "shape", None)
            if shp:
                known.setdefault(n, (int(shp[0]),
                                     int(shp[1]) if len(shp) > 1 else 1))
        try:
            return analyze_rowwise_safety(
                self._ps._program, self._batch_input,
                self._ps._output_names, known_dims=known)
        except Exception as e:  # except-ok: the analysis is advisory; refusal is the safe answer
            return RowwiseSafety(False, f"safety analysis failed: {e}",
                                 {}, False)

    # ---- dispatch --------------------------------------------------------

    def warmup(self, ncols: int, buckets: Optional[Sequence[int]] = None,
               dtype=None) -> List[int]:
        """Brings each rung (or each of `buckets`) to its cached form
        ahead of traffic, through the full dispatch path with a zero
        batch: its plan compiled (on the card, its fused kernels built)
        and, on the card, its block graph captured. A rung's first call
        compiles its plan and, on the card, runs it watched for
        synchronizing calls; the next captures its graph. So each rung is
        called until a call compiles nothing and runs no watched block
        (at most four calls). After warmup a request within the ladder
        makes no plan compile, no capture and no build. Returns the
        warmed rungs: none when bucketing is off, since live traffic then
        runs at exact shapes and rung-shaped plans would never be
        reused."""
        if not self.bucketing_enabled:
            return []
        warmed = []
        for b in (buckets if buckets is not None else self._ladder):
            x = np.zeros((int(b), int(ncols)), dtype=dtype or np.float32)
            for _ in range(4):
                st = self._ps.stats
                before = (st.compile_count,
                          st.block_graph_counts.get("watched", 0))
                self.score(x)
                st = self._ps.stats
                if (st.compile_count,
                        st.block_graph_counts.get("watched", 0)) == before:
                    break
            warmed.append(int(b))
        return warmed

    def score(self, x, extra: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """One scoring request: the rows of `x` are the request batch.
        Returns {output_name: value} with batched matrix outputs sliced
        back to the request's true row count. Thread-safe: any number of
        concurrent callers share the bucketed plan cache."""
        from systemml_tpu_torch.obs import trace as obs

        t0 = time.perf_counter()
        x = np.asarray(x) if not hasattr(x, "shape") else x
        if getattr(x, "ndim", 0) == 1:
            x = x.reshape(1, -1)
        n = int(x.shape[0])
        stats = self._ps.stats
        if self.bucketing_enabled:
            b = bucket_for(n, self._ladder)
            with self._lock:
                hit = b in self._seen_buckets
                self._seen_buckets.add(b)
            stats.count_estim(
                f"srv_bucket_{'hit' if hit else 'miss'}[{b}]")
            (self._m_hits if hit else self._m_misses).inc()
            obs.instant("bucket_dispatch", obs.CAT_SERVING, bucket=b,
                        rows=n, pad_rows=b - n, hit=hit)
            if b != n:
                stats.count_estim("srv_pad_rows", b - n)
                self._m_pad.inc(b - n)
                if not _is_sparse(x):
                    # the real rows go to the script's device, and the pad
                    # is made there: no pad bytes cross from the host
                    x = self._ps._unwrap(x)
                x = _pad_rows(x, b)
        else:
            b = n
            stats.count_estim("srv_exact_shape")
        inputs = dict(self._constants)
        # per-request values are new every request: unwrapped directly,
        # not through the identity cache, which could never hit and
        # would keep a weak entry per name; semi-constant extras belong
        # in `constants`
        if extra:
            inputs.update({k: self._ps._unwrap(v) for k, v in extra.items()})
        inputs[self._batch_input] = self._ps._unwrap(x)
        res = self._ps.execute(inputs, _unwrap=False)
        out: Dict[str, Any] = {}
        for name in self._ps._output_names:
            v = res.get(name)
            if b != n and self._padded_output(name, v, b):
                v = _head_rows(v, n)
            out[name] = v
        self._m_requests.inc()
        self._m_latency.observe(time.perf_counter() - t0)
        return out

    # ---- metrics ---------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Machine-readable snapshot of the service's metrics: the
        per-request latency histogram, request and bucket counters, the
        live hit rate and the micro-batch queue gauges (registered by an
        attached MicroBatcher). The JSON sibling of metrics_text()."""
        return self.registry.to_dict()

    def metrics_text(self, prefix: str = "smtpu_serving_") -> str:
        """Prometheus text exposition of the same registry (the body of
        the scrape endpoint). This is the single-process exposition: the
        JAX package adds the fleet identity's rank and generation labels
        on a multi-process job, which the port gains with its
        multi-process runtime (ROADMAP queue 1, distributed and
        elastic)."""
        return self.registry.prometheus_text(prefix=prefix)

    def serve_metrics(self, port: Optional[int] = None,
                      host: Optional[str] = None) -> "MetricsEndpoint":
        """Starts the /metrics HTTP scrape endpoint around
        ``metrics_text`` (config ``serving_metrics_port`` when `port` is
        None, 0 = ephemeral; config ``serving_metrics_host`` when `host`
        is None, default 127.0.0.1). Returns the running MetricsEndpoint:
        close it (or use it as a context manager) on shutdown."""
        return MetricsEndpoint(self, port=port, host=host)

    def _padded_output(self, name: str, v, b: int) -> bool:
        """Did bucketing pad this output? Exact when the analysis
        classified it (only rows-class outputs carry pad rows); the shape
        heuristic remains only for validate='force', which classifies
        nothing."""
        if self._out_classes:
            return (self._out_classes.get(name) == "rows"
                    and getattr(v, "ndim", 0) >= 1)
        return getattr(v, "ndim", 0) >= 1 and v.shape[0] == b


def _head_rows(v, n: int):
    """The first `n` rows of an output (a view for a tensor)."""
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    if isinstance(v, SparseMatrix):
        return v.slice(0, n, 0, v.shape[1])
    return v[:n]


def _pad_rows(x, b: int):
    """`x` with zero rows appended up to `b` rows, on its own device: a
    dense tensor by torch.nn.functional.pad there, a host array by numpy;
    a scipy CSR, a SparseMatrix and a torch sparse CSR tensor stay sparse
    (all-zero rows are free in CSR and keep the exploiting kernels'
    input sparse)."""
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    pad = b - int(x.shape[0])
    if isinstance(x, SparseMatrix):
        tail = x.indptr[-1:].expand(pad)
        return SparseMatrix(torch.cat([x.indptr, tail]), x.indices, x.data,
                            (b, x.shape[1]))
    if isinstance(x, torch.Tensor):
        if x.layout == torch.sparse_csr:
            crow = x.crow_indices()
            crow = torch.cat([crow, crow[-1:].expand(pad)])
            return torch.sparse_csr_tensor(crow, x.col_indices(), x.values(),
                                           (b,) + tuple(x.shape[1:]))
        if x.layout != torch.strided:
            return _pad_rows(x.to_sparse_csr(), b)
        return torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (0, pad))
    try:
        import scipy.sparse as ssp

        if ssp.issparse(x):
            z = ssp.csr_matrix((pad, x.shape[1]), dtype=x.dtype)
            return ssp.vstack([x, z], format="csr")
    except ImportError:
        pass
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), widths)


class MicroBatcher:
    """Coalesces concurrent score requests into one padded dispatch.

    ``score(x)`` enqueues the request and blocks until its rows come
    back. A daemon flusher thread drains the queue as one
    ``ScoringService.score`` call when either (a) ``max_batch`` rows are
    waiting or (b) the oldest queued request has waited ``deadline_us``
    microseconds: the bounded extra latency a request pays so that N
    concurrent users cost about one dispatch instead of N. Results
    unpack per request; a dispatch failure reaches every request in
    that flush.

    Overload: the pending queue is bounded (``queue_rows_max`` rows,
    config ``serving_queue_rows_max``; 0 disables): an enqueue past the
    bound is refused at once with ``QueueFullError``. A request may carry
    its remaining deadline (``score(x, deadline_s=...)``); requests whose
    deadline expires while queued are shed at flush time, their futures
    failing with ``AdmissionRejectedError(reason='expired')``.

    Requests are dense: tensors (concatenated with torch.cat on their
    device, each answer a tensor) or host arrays (concatenated with
    numpy, each answer a host array). Use as a context manager (or call
    ``close()``) to stop the flusher.
    """

    def __init__(self, service: ScoringService,
                 max_batch: Optional[int] = None,
                 deadline_us: Optional[float] = None,
                 output: Optional[str] = None,
                 queue_rows_max: Optional[int] = None):
        cfg = get_config()
        if not service.batchable:
            # coalescing needs the per-row proof, which is strictly
            # stronger than pad safety: a sum(X) output would mix every
            # queued user's rows into one answer, and a cumsum (pad-safe)
            # would leak one user's running totals into the next's
            raise ValueError(
                "script is not per-row decomposable — concurrent "
                "requests cannot be coalesced"
                + (f" ({service.safety_reason})"
                   if service.safety_reason else
                   " (row-order-dependent op, e.g. cumsum)"))
        self._service = service
        self._max = int(max_batch if max_batch is not None
                        else cfg.serving_microbatch_max)
        self._deadline_s = float(
            deadline_us if deadline_us is not None
            else cfg.serving_microbatch_deadline_us) / 1e6
        outs = service._ps._output_names
        self._output = output if output is not None else \
            (outs[0] if outs else None)
        if self._output not in outs:
            raise ValueError(f"output {self._output!r} not among "
                             f"prepared outputs {outs}")
        self._queue_rows_max = int(
            queue_rows_max if queue_rows_max is not None
            else cfg.serving_queue_rows_max)
        self._cv = threading.Condition()
        # (rows, nrows, future, enqueue time, expiry or None) per waiting
        # request; the expiry is an absolute monotonic deadline
        self._pending: List[Tuple[Any, int, Future, float,
                                  Optional[float]]] = []
        self._closed = False
        # the queue gauges on the service's registry, sampled at scrape
        # time; bind() so that a second batcher on the same service takes
        # them over from a closed predecessor
        service.registry.gauge(
            "microbatch_queue_rows", "rows waiting to be coalesced"
        ).bind(self._queue_depth)
        service.registry.gauge(
            "microbatch_queue_age_seconds", "age of the oldest queued "
            "request", unit="s").bind(self._queue_age)
        self._m_flushes = service.registry.counter(
            "microbatch_flushes_total", "coalesced dispatches")
        self._m_coalesced = service.registry.counter(
            "microbatched_requests_total", "requests served via a "
            "coalesced flush")
        self._m_shed = service.registry.counter(
            "microbatch_shed_total", "queued requests shed because "
            "their deadline expired before dispatch")
        self._m_queue_full = service.registry.counter(
            "microbatch_queue_full_total", "enqueues refused at the "
            "bounded pending-row queue")
        self._flusher = threading.Thread(
            target=self._run, name="smtpu-microbatch-flusher", daemon=True)
        self._flusher.start()

    # ---- client side -----------------------------------------------------

    def score(self, x, deadline_s: Optional[float] = None):
        """Scores one request (one or more rows); returns the rows of the
        designated output for this request. Blocks until the flush that
        carried it completes. ``deadline_s`` is the request's remaining
        budget: a request that arrives with none left is refused here,
        and one whose budget runs out while queued is shed at flush time
        instead of dispatched."""
        from systemml_tpu_torch.fleet import admission

        if _is_sparse(x):
            # the flush concatenates dense row batches; sparse requests
            # go through ScoringService.score, which pads them sparsely
            raise TypeError(
                "micro-batching coalesces dense row batches; "
                "score sparse requests via ScoringService.score")
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim == 1:
            x = x.reshape(1, -1)
        now = time.monotonic()
        if deadline_s is not None and float(deadline_s) <= 0.0:
            self._note_shed(1)
            raise admission.AdmissionRejectedError(
                "request arrived with its deadline already spent",
                reason=admission.REASON_EXPIRED,
                retry_after_s=self._deadline_s)
        expiry = None if deadline_s is None else now + float(deadline_s)
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if (self._queue_rows_max > 0
                    and self._queued_rows() + int(x.shape[0])
                    > self._queue_rows_max):
                self._note_queue_full()
                raise admission.QueueFullError(
                    f"micro-batch queue full "
                    f"({self._queued_rows()} rows waiting, bound "
                    f"{self._queue_rows_max}); backpressure at the "
                    f"door beats queueing work that will miss its "
                    f"deadline", retry_after_s=self._deadline_s)
            self._pending.append((x, int(x.shape[0]), fut, now, expiry))
            self._cv.notify_all()
        return fut.result()

    def _note_queue_full(self) -> None:
        from systemml_tpu_torch.fleet import admission

        self._service._ps.stats.count_estim("srv_microbatch_queue_full")
        self._m_queue_full.inc()
        admission.emit_overload("microbatch_queue_full",
                                reason=admission.REASON_QUEUE_FULL,
                                rows_max=self._queue_rows_max)

    def _note_shed(self, n: int) -> None:
        from systemml_tpu_torch.fleet import admission

        self._service._ps.stats.count_estim("srv_microbatch_shed", n)
        self._m_shed.inc(n)
        admission.emit_overload("microbatch_shed",
                                reason=admission.REASON_EXPIRED,
                                requests=n)

    # ---- flusher ---------------------------------------------------------

    def _queued_rows(self) -> int:
        return sum(n for _, n, _, _, _ in self._pending)

    def _queue_depth(self) -> int:
        with self._cv:
            return self._queued_rows()

    def _queue_age(self) -> float:
        with self._cv:
            if not self._pending:
                return 0.0
            return time.monotonic() - self._pending[0][3]

    def _run(self):
        from systemml_tpu_torch.obs import trace as obs

        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                # size or deadline: wait while under max_batch and the
                # oldest request is under the deadline, which runs from
                # its enqueue (a remainder kept back by a size-capped
                # flush does not wait a second full window)
                while (self._queued_rows() < self._max
                       and not self._closed):
                    left = self._deadline_s - (time.monotonic()
                                               - self._pending[0][3])
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                # shed expired work before dispatching it
                now = time.monotonic()
                live = [it for it in self._pending
                        if it[4] is None or now < it[4]]
                expired = [it for it in self._pending
                           if not (it[4] is None or now < it[4])]
                # drain at most max_batch rows (always at least one
                # request): rows that piled up during a flush must not
                # merge into one dispatch beyond the warmed ladder
                batch, kept, total = [], [], 0
                for item in live:
                    if batch and total + item[1] > self._max:
                        kept.append(item)
                    else:
                        batch.append(item)
                        total += item[1]
                self._pending = kept
            if expired:
                self._shed(expired)
            if not batch:
                continue
            cause = "size" if total >= self._max else "deadline"
            self._flush(batch, cause, obs)

    def _shed(self, expired) -> None:
        """Fails every expired request at once: its future raises
        ``AdmissionRejectedError(reason='expired')`` instead of waiting
        for a dispatch whose answer nobody will read."""
        from systemml_tpu_torch.fleet import admission

        self._note_shed(len(expired))
        for _, _, fut, _, _ in expired:
            if not fut.done():
                fut.set_exception(admission.AdmissionRejectedError(
                    "request deadline expired while queued for "
                    "micro-batching",
                    reason=admission.REASON_EXPIRED,
                    retry_after_s=self._deadline_s))

    def _flush(self, batch, cause: str, obs):
        # everything up to the per-request unpack stays inside the try:
        # a malformed request (a feature count that sinks the
        # concatenation) fails its flush's futures and does not kill the
        # flusher
        try:
            xs = [x for x, _, _, _, _ in batch]
            if all(isinstance(x, torch.Tensor) for x in xs):
                rows = torch.cat(xs, dim=0)
            else:
                rows = np.concatenate([x.cpu().numpy()
                                       if isinstance(x, torch.Tensor)
                                       else np.asarray(x) for x in xs],
                                      axis=0)
            stats = self._service._ps.stats
            stats.count_estim("srv_microbatch_flush")
            stats.count_estim(f"srv_microbatch_flush_{cause}")
            stats.count_estim("srv_microbatched_requests", len(batch))
            self._m_flushes.inc()
            self._m_coalesced.inc(len(batch))
            obs.instant("microbatch_flush", obs.CAT_SERVING,
                        requests=len(batch), rows=int(rows.shape[0]),
                        cause=cause)
            out = self._service.score(rows)[self._output]
            # a const-class designated output (e.g. a weight norm) is
            # batch-independent: every request gets the whole value. Only
            # under validate='force' (no classes) does the shape
            # heuristic row-slice
            classes = self._service._out_classes
            row_sliced = ((not classes
                           or classes.get(self._output) == "rows")
                          and getattr(out, "ndim", 0) >= 1)
            host = out
            if isinstance(out, torch.Tensor) \
                    and not any(isinstance(x, torch.Tensor) for x in xs):
                # host requests take host answers: one copy for the flush
                host = out.cpu().numpy()
            pieces = []
            i = 0
            for x, n, _, _, _ in batch:
                v = host if not isinstance(x, torch.Tensor) else out
                if row_sliced:
                    p = v[i:i + n]
                    i += n
                else:
                    p = v
                pieces.append(p)
        except BaseException as e:  # except-ok: the failure must reach every waiting request, not kill the flusher
            for _, _, fut, _, _ in batch:
                if not fut.done():
                    fut.set_exception(e)
            if not isinstance(e, Exception):
                raise
            return
        for piece, (_, _, fut, _, _) in zip(pieces, batch):
            if not fut.done():
                fut.set_result(piece)

    # ---- lifecycle -------------------------------------------------------

    def close(self, timeout: float = 5.0):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._flusher.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# --------------------------------------------------------------------------
# /metrics scrape endpoint
# --------------------------------------------------------------------------


class MetricsEndpoint:
    """Standard-library HTTP scrape surface around
    ``ScoringService.metrics_text``. GET /metrics returns the registry's
    text exposition with the content type ``text/plain; version=0.0.4``;
    every other path is 404. It binds 127.0.0.1 by default (a scrape
    surface, not an API gateway); config ``serving_metrics_host`` widens
    the bind. Each scrape is served on the ThreadingHTTPServer's own
    threads, so a slow scraper never blocks ``score()`` traffic.

    Port: the argument, else config ``serving_metrics_port``, else 0 (an
    ephemeral port; read it back from ``.port``). Host: the argument,
    else config ``serving_metrics_host``, else 127.0.0.1. Use as a
    context manager or call ``close()``."""

    CONTENT_TYPE = "text/plain; version=0.0.4"

    def __init__(self, service: "ScoringService",
                 port: Optional[int] = None,
                 host: Optional[str] = None):
        import http.server

        if port is None:
            port = int(getattr(get_config(), "serving_metrics_port", 0)
                       or 0)
        if host is None:
            host = str(getattr(get_config(), "serving_metrics_host", "")
                       or "127.0.0.1")
        endpoint = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):   # noqa: N802 (the stdlib handler's name)
                if self.path.rstrip("/") not in ("/metrics", ""):
                    self.send_error(404)
                    return
                try:
                    body = service.metrics_text().encode("utf-8")
                except Exception as e:  # except-ok: a scrape reports the failure as a 500 and keeps the server
                    self.send_error(500, explain=str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", endpoint.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # quiet: scrapes are periodic
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, int(port)),
                                                      Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="smtpu-serving-metrics")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self, timeout: float = 5.0) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=timeout)
        self._httpd.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
