"""The serving tier of the port (api/serving.py, fleet/admission.py, the
row-wise safety proof of compiler/lower.py) against the JAX package on
the CPU.

The cases are those of tests/test_serving.py:61-1020, run through both
packages on the same numpy-seeded inputs where both compute a value:

- `bucket_for` over a sweep of ladders and sizes;
- `analyze_rowwise_safety`'s verdict, reason, out classes and
  row-locality over that file's script corpus and the softmax scorer, at
  optlevels 2 and 3 (at 3 a fused plan taints the proof in both);
- `ScoringService.score`, bucketed and at the exact shape, at 1e-9 in
  fp64 and 1e-3 in fp32, also at optlevel 3 with validate "force";
- concurrent execute from 8 threads, bit-identical to serial, with the
  binding context request-scoped and the statistics' run windows
  balanced;
- the MicroBatcher: results equal to direct scoring, multi-row requests,
  an error reaching every future, the bounded queue, shedding, max_batch,
  the remainder's enqueue deadline, the refusal of a script that is not
  row-local, a const output returned whole, tensor requests;
- a sparse request padded to its rung (scipy, SparseMatrix, torch CSR);
- the /metrics endpoint and the "Serving" line of -stats.

The JAX package runs with exec_mode SINGLE_NODE (the conftest's 8-device
mesh would shard its ops), as tests/test_torch_models.py runs it.
"""

import gc
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

from systemml_tpu import obs as jobs
from systemml_tpu.api.jmlc import Connection as JConnection
from systemml_tpu.api.serving import ScoringService as JScoringService
from systemml_tpu.api.serving import bucket_for as jbucket_for
from systemml_tpu.compiler.lower import \
    analyze_rowwise_safety as janalyze
from systemml_tpu.utils.config import DMLConfig as JConfig
from systemml_tpu.utils.config import set_config as jset
from systemml_tpu_torch.api import serving
from systemml_tpu_torch.api.jmlc import Connection
from systemml_tpu_torch.api.serving import (MicroBatcher, ScoringService,
                                            _pad_rows, bucket_for)
from systemml_tpu_torch.compiler.lower import analyze_rowwise_safety
from systemml_tpu_torch.fleet.admission import (AdmissionRejectedError,
                                                QueueFullError)
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.runtime.sparse import SparseMatrix
from systemml_tpu_torch.utils.config import (DMLConfig, get_config,
                                             set_config)
from systemml_tpu_torch.utils.stats import Statistics

_SCORE_SRC = ("margin = X %*% W + b\n"
              "prob = 1 / (1 + exp(-margin))\n")
_META_6 = {"X": {"shape": (None, 6)}, "W": {"shape": (6, 1)},
           "b": {"shape": (1, 1)}}
# scripts/nn/layers/affine.dml and softmax.dml's forward, inlined: the
# scorer that chip_smoke.py's [serving] serves at 1,000 features
SOFTMAX = ("Z = X %*% W + b\nE = exp(Z - rowMaxs(Z))\n"
           "yhat = E / rowSums(E)")
_META_SOFTMAX = {"X": {"shape": (None, 20)}, "W": {"shape": (20, 10)},
                 "b": {"shape": (1, 10)}}
F64, F32 = 1e-9, 1e-3


@pytest.fixture
def rng():
    return np.random.default_rng(23)


@pytest.fixture(autouse=True)
def _cpu():
    jc = JConfig()
    jc.exec_mode = "SINGLE_NODE"
    jset(jc)
    set_config(DMLConfig(device="cpu"))
    yield
    set_config(DMLConfig())


def _cfg(optlevel=2, precision="auto"):
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = optlevel
    cfg.floating_point_precision = precision
    return cfg


def _jcfg(optlevel=2, precision="auto"):
    jc = JConfig()
    jc.exec_mode = "SINGLE_NODE"
    jc.optlevel = optlevel
    jc.floating_point_precision = precision
    jset(jc)
    return jc


def _prepare(src=_SCORE_SRC, inputs=("X", "W", "b"), outputs=("prob",),
             meta=_META_6, optlevel=2, precision="auto"):
    return Connection(_cfg(optlevel, precision)).prepare_script(
        src, input_names=list(inputs), output_names=list(outputs),
        input_meta=meta)


def _jprepare(src=_SCORE_SRC, inputs=("X", "W", "b"), outputs=("prob",),
              meta=_META_6, optlevel=2, precision="auto"):
    _jcfg(optlevel, precision)
    return JConnection().prepare_script(
        src, input_names=list(inputs), output_names=list(outputs),
        input_meta=meta)


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _softmax(z):
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))


def _run(n, fn, timeout=120.0):
    """fn(t) on n threads; each must finish within `timeout` and raise
    nothing."""
    errors = []

    def run(t):
        try:
            fn(t)
        except Exception as e:  # the test fails on it below
            errors.append(repr(e))

    ts = [threading.Thread(target=run, args=(t,)) for t in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts)
    assert errors == []


def _scorer_service(rng, ladder=(1, 8), **kw):
    ps = _prepare()
    w = rng.standard_normal((6, 1))
    b = np.zeros((1, 1))
    return ScoringService(ps, "X", constants={"W": w, "b": b},
                          ladder=ladder, **kw), w, b


# --------------------------------------------------------------------------
# bucket ladder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ladder", [(1, 8, 64), (1, 8, 64, 512), (4,),
                                    (3, 7), (64, 1, 8)])
def test_bucket_for_matches_the_jax_package(ladder):
    srt = tuple(sorted(ladder))
    for n in list(range(1, 200)) + [511, 512, 513, 700, 1000, 1024, 1025,
                                    4097, 100_000]:
        assert bucket_for(n, srt) == jbucket_for(n, srt), n
    assert bucket_for(1000, (1, 8, 64)) == 1024
    with pytest.raises(ValueError):
        bucket_for(0, srt)


# --------------------------------------------------------------------------
# the row-wise safety proof: the JAX package's verdicts and reasons
# --------------------------------------------------------------------------

# 17 body statements keep the function past the IPA inline budget, so
# the fcall reaches the analysis (tests/test_serving.py:_big_fn)
_BIG_BODY = "\n".join(f"  t{i} = A * {i + 1}" for i in range(16))


def _big_fn(last_stmt):
    return (f"f = function(matrix[double] A) return (matrix[double] B)"
            f" {{\n{_BIG_BODY}\n  {last_stmt}\n}}\nY = f(X)\n")


_X6 = {"X": {"shape": (None, 6)}}
CORPUS = {
    "colMeans": ("s = colMeans(X)\n", ["X"], ["s"], _X6),
    "nrow": ("n = nrow(X)\ny = X * n\n", ["X"], ["y"], _X6),
    "gram": ("G = t(X) %*% X\n", ["X"], ["G"], _X6),
    "sum": ("z = sum(X)\n", ["X"], ["z"], _X6),
    "rowwise_pipeline": ("h = sigmoid(X %*% W + b)\n"
                         "score = rowSums(h * h)\n", ["X", "W", "b"],
                         ["score"], _META_6),
    "bias_unproven": (_SCORE_SRC, ["X", "W", "b"], ["prob"], _X6),
    "sigmoid_scorer": (_SCORE_SRC, ["X", "W", "b"], ["prob"], _META_6),
    "cumsum": ("C = cumsum(X)\n", ["X"], ["C"], _X6),
    "const_and_rows": ("W2 = W * 2\nprob = sigmoid(X %*% W)\n",
                       ["X", "W"], ["W2", "prob"],
                       {"X": {"shape": (None, 6)}, "W": {"shape": (6, 1)}}),
    "loop": ("for (i in 1:2) {\n  X = X * 2\n}\nY = X\n", ["X"], ["Y"],
             _X6),
    "fn_elementwise": (_big_fn("B = t0 + t15"), ["X"], ["Y"], _X6),
    "fn_rowsums": (_big_fn("B = rowSums(t0 ^ 2)"), ["X"], ["Y"], _X6),
    "fn_cumsum": (_big_fn("B = cumsum(t0)"), ["X"], ["Y"], _X6),
    "fn_fullagg": (_big_fn("B = t0 / sum(A)"), ["X"], ["Y"], _X6),
    "fn_nrow": (_big_fn("B = t0 / nrow(A)"), ["X"], ["Y"], _X6),
    "fn_if": ("f = function(matrix[double] A) return (matrix[double] B) {\n"
              "  if (sum(A) > 0) { B = A } else { B = A * 2 }\n}\n"
              "Y = f(X)\n", ["X"], ["Y"], _X6),
    "softmax": (SOFTMAX, ["X", "W", "b"], ["yhat"], _META_SOFTMAX),
}


def _known(meta):
    return {n: (int(m["shape"][0]), int(m["shape"][1]))
            for n, m in meta.items() if m["shape"][0] is not None}


@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("name", sorted(CORPUS))
def test_rowwise_safety_equals_the_jax_package(name, optlevel):
    src, inputs, outs, meta = CORPUS[name]
    ps = _prepare(src, inputs, outs, meta, optlevel)
    jps = _jprepare(src, inputs, outs, meta, optlevel)
    got = analyze_rowwise_safety(ps._program, "X", outs,
                                 known_dims=_known(meta))
    ref = janalyze(jps._program, "X", outs, known_dims=_known(meta))
    assert (got.safe, got.reason, got.out_classes, got.row_local) == \
        (ref.safe, ref.reason, dict(ref.out_classes), ref.row_local)


def test_a_fused_plan_taints_the_proof_at_optlevel_3_in_both_packages():
    """The softmax scorer compiles to one row-template spoof hop at
    optlevel 3, and the analysis has no rule for it: both packages refuse
    "auto" with the same reason, and prove it at optlevel 2."""
    src, inputs, outs, meta = CORPUS["softmax"]
    rng = np.random.default_rng(4)
    w, b = rng.standard_normal((20, 10)), rng.standard_normal((1, 10))
    for optlevel in (2, 3):
        svc = ScoringService(_prepare(src, inputs, outs, meta, optlevel),
                             constants={"W": w, "b": b})
        jsvc = JScoringService(_jprepare(src, inputs, outs, meta, optlevel),
                               constants={"W": w, "b": b})
        assert (svc.bucketing_enabled, svc.batchable, svc.safety_reason,
                svc._out_classes) == (jsvc.bucketing_enabled,
                                      jsvc.batchable, jsvc.safety_reason,
                                      jsvc._out_classes)
        if optlevel == 2:
            assert svc.bucketing_enabled and svc.batchable
            assert svc._out_classes == {"yhat": "rows"}
        else:
            assert not svc.bucketing_enabled and not svc.batchable
            assert svc.safety_reason == (
                "output 'yhat' is not row-decomposable (spoof: row-mixing "
                "or unanalyzed op)")


# --------------------------------------------------------------------------
# ScoringService.score against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("precision,bar", [("auto", F64), ("single", F32)])
@pytest.mark.parametrize("validate", ["auto", "off"])
def test_score_matches_the_jax_package(rng, precision, bar, validate):
    w = rng.standard_normal((6, 1))
    b = rng.standard_normal((1, 1))
    svc = ScoringService(_prepare(precision=precision), "X",
                         constants={"W": w, "b": b}, ladder=(1, 8, 64),
                         validate=validate)
    jsvc = JScoringService(_jprepare(precision=precision), "X",
                           constants={"W": w, "b": b}, ladder=(1, 8, 64),
                           validate=validate)
    assert svc.bucketing_enabled == (validate == "auto")
    for n in (1, 3, 8, 20, 64, 100):
        x = rng.standard_normal((n, 6))
        got = svc.score(x)["prob"]
        ref = np.asarray(jsvc.score(x)["prob"])
        assert tuple(got.shape) == (n, 1) == ref.shape
        assert _rel(_np(got), ref) < bar
        assert _rel(_np(got), _sigmoid(x @ w + b)) < bar
    st = svc._ps.stats.estim_counts
    if validate == "auto":
        assert st.get("srv_bucket_miss[128]") == 1
        assert st.get("srv_pad_rows") == 5 + 44 + 28
    else:
        assert st.get("srv_exact_shape") == 6


@pytest.mark.parametrize("precision,bar", [("auto", F64), ("single", F32)])
def test_softmax_scorer_forced_at_optlevel_3_matches_the_jax_package(
        precision, bar):
    """The chip's served path on the CPU: optlevel 3 (one row plan, its
    plain version here), validate "force", bucketed."""
    src, inputs, outs, meta = CORPUS["softmax"]
    rng = np.random.default_rng(9)
    w, b = rng.standard_normal((20, 10)), rng.standard_normal((1, 10))
    svc = ScoringService(_prepare(src, inputs, outs, meta, 3, precision),
                         constants={"W": w, "b": b}, ladder=(1, 8, 64, 512),
                         validate="force")
    jsvc = JScoringService(_jprepare(src, inputs, outs, meta, 3, precision),
                           constants={"W": w, "b": b},
                           ladder=(1, 8, 64, 512), validate="force")
    assert svc.warmup(20) == [1, 8, 64, 512]
    compiles = svc._ps.stats.compile_count
    for n in (1, 5, 64, 300, 700):
        x = rng.standard_normal((n, 20))
        got = svc.score(x)["yhat"]
        assert tuple(got.shape) == (n, 10)
        assert _rel(_np(got), np.asarray(jsvc.score(x)["yhat"])) < bar
        assert _rel(_np(got), _softmax(x @ w + b)) < bar
    # one new rung (1,024) compiled after warmup, and nothing else
    assert svc._ps.stats.compile_count == compiles + 1
    assert "spoof" in {h.op for blk in svc._ps._program.blocks
                       for h in _ops(blk)}


def _ops(blk):
    from systemml_tpu_torch.hops.hop import postorder

    return postorder(list(blk.hops.writes.values()) + list(blk.hops.sinks))


def test_bucketed_scoring_matches_direct_and_caches(rng):
    ps = _prepare()
    w = rng.standard_normal((6, 1)).astype(np.float32)
    b = rng.standard_normal((1, 1)).astype(np.float32)
    svc = ScoringService(ps, "X", constants={"W": w, "b": b},
                         ladder=(1, 8, 64))
    assert svc.bucketing_enabled, svc.safety_reason
    svc.warmup(6)
    compiles = ps.stats.compile_count
    with obs.session() as rec:
        for n in (1, 2, 3, 7, 8, 20, 64):
            x = rng.standard_normal((n, 6)).astype(np.float32)
            out = _np(svc.score(x)["prob"])
            assert out.shape == (n, 1)
            np.testing.assert_allclose(out, _sigmoid(x @ w + b), rtol=2e-5,
                                       atol=1e-6)
    ev = [e for e in rec.events() if e.name == "bucket_dispatch"]
    assert len(ev) == 7 and all(e.cat == obs.CAT_SERVING for e in ev)
    assert all(e.args["hit"] for e in ev)
    assert sum(e.args["pad_rows"] for e in ev) == 6 + 5 + 1 + 44
    assert ps.stats.compile_count == compiles    # 0 compiles after warmup
    cnt = ps.stats.estim_counts
    assert cnt.get("srv_bucket_miss[8]") == 1   # warmup's compile
    assert cnt.get("srv_pad_rows", 0) > 0
    assert svc.registry.get("bucket_misses_total").value == 3
    assert svc.registry.get("bucket_hits_total").value == \
        sum(v for k, v in cnt.items() if k.startswith("srv_bucket_hit["))


def test_bucketing_infers_batch_input_from_meta(rng):
    svc = ScoringService(_prepare(), constants={
        "W": rng.standard_normal((6, 1)), "b": np.zeros((1, 1))},
        ladder=(1, 4))
    assert svc._batch_input == "X"
    ps = _prepare(meta={"X": {"shape": (None, 6)}, "W": {"shape": (None, 1)},
                        "b": {"shape": (1, 1)}})
    with pytest.raises(ValueError, match="batch_input"):
        ScoringService(ps)


def test_warmup_noop_when_bucketing_disabled():
    ps = _prepare("z = colSums(X)\n", ["X"], ["z"], _X6)
    svc = ScoringService(ps, "X")
    assert not svc.bucketing_enabled
    before = ps.stats.compile_count
    assert svc.warmup(6) == []
    assert ps.stats.compile_count == before


def test_const_output_not_truncated_by_bucket_coincidence(rng):
    w = rng.standard_normal((8, 1))
    ps = _prepare("prob = sigmoid(X %*% W)\nW2 = W * 2\n", ["X", "W"],
                  ["prob", "W2"], {"X": {"shape": (None, 8)},
                                   "W": {"shape": (8, 1)}})
    svc = ScoringService(ps, "X", constants={"W": w}, ladder=(1, 8))
    assert svc.bucketing_enabled, svc.safety_reason
    out = svc.score(rng.standard_normal((3, 8)))
    assert tuple(out["prob"].shape) == (3, 1)
    assert tuple(out["W2"].shape) == (8, 1)   # whole, not [:3]
    np.testing.assert_allclose(_np(out["W2"]), w * 2, rtol=1e-12)


def test_rowwise_fn_end_to_end_bucketing(rng):
    ps = _prepare(_big_fn("B = t0 + t15"), ["X"], ["Y"], _X6)
    svc = ScoringService(ps, "X", ladder=(4,))
    assert svc.bucketing_enabled, svc.safety_reason
    x = rng.standard_normal((3, 6))
    np.testing.assert_allclose(_np(svc.score(x)["Y"]), x * 1 + x * 16,
                               atol=1e-12)


# --------------------------------------------------------------------------
# _pad_rows: on the request's device, sparse stays sparse
# --------------------------------------------------------------------------

def test_pad_rows_keeps_the_kind_and_device_of_the_request(rng):
    x = rng.standard_normal((5, 3))
    t = torch.from_numpy(x)
    for v in (x, t):
        p = _pad_rows(v, 8)
        assert type(p) is type(v) and tuple(p.shape) == (8, 3)
        np.testing.assert_array_equal(_np(p)[:5], x)
        assert not _np(p)[5:].any()
    assert _pad_rows(t, 8).device == t.device
    dense = np.zeros((5, 4))
    dense[[0, 2, 4], [1, 3, 0]] = (1.0, -2.0, 0.5)
    for v in (ssp.csr_matrix(dense), SparseMatrix.from_scipy(
            ssp.csr_matrix(dense)), torch.from_numpy(dense).to_sparse_csr()):
        p = _pad_rows(v, 8)
        assert tuple(p.shape) == (8, 4)
        if isinstance(p, SparseMatrix):
            got = p.to_numpy()
        elif isinstance(p, torch.Tensor):
            assert p.layout == torch.sparse_csr
            got = p.to_dense().numpy()
        else:
            assert ssp.issparse(p)
            got = p.toarray()
        np.testing.assert_array_equal(got[:5], dense)
        assert not got[5:].any()


def test_sparse_request_pads_to_bucket(rng):
    """A sparse request whose row count is not a rung pads sparsely, and
    scores as the JAX package scores the same scipy request."""
    w = rng.standard_normal((6, 1))
    b = np.zeros((1, 1))
    svc = ScoringService(_prepare(), "X", constants={"W": w, "b": b},
                         ladder=(1, 8))
    jsvc = JScoringService(_jprepare(), "X", constants={"W": w, "b": b},
                           ladder=(1, 8))
    assert svc.bucketing_enabled, svc.safety_reason
    dense = np.zeros((5, 6))
    dense[[0, 2, 4], [1, 3, 5]] = (1.0, -2.0, 0.5)
    x = ssp.csr_matrix(dense)  # 5 rows -> the 8 rung
    ref = np.asarray(jsvc.score(x)["prob"])
    for v in (x, SparseMatrix.from_scipy(x),
              torch.from_numpy(dense).to_sparse_csr()):
        out = _np(svc.score(v)["prob"])
        assert out.shape == (5, 1)
        assert _rel(out, ref) < F64
        assert _rel(out, _sigmoid(dense @ w + b)) < F64
    assert svc._ps.stats.estim_counts.get("srv_pad_rows") == 9
    with MicroBatcher(svc, deadline_us=100) as mb:
        for v in (x, SparseMatrix.from_scipy(x)):
            with pytest.raises(TypeError, match="sparse"):
                mb.score(v)


# --------------------------------------------------------------------------
# concurrent execute: the thread-safety contract (docs/serving.md)
# --------------------------------------------------------------------------

def test_concurrent_execute_bit_identical_zero_recompiles(rng):
    ps = Connection(_cfg()).prepare_script(
        "Y = X %*% W\nZ = exp(Y) / rowSums(exp(Y))\n",
        input_names=["X", "W"], output_names=["Z"])
    w = rng.standard_normal((8, 4))
    xs = [rng.standard_normal((5, 8)) for _ in range(5)]
    serial = [_np(ps.set_matrix("X", x).set_matrix("W", w)
                  .execute_script().get("Z")) for x in xs]
    compiles = ps.stats.compile_count
    mismatches = []

    def worker(tid):
        for i, x in enumerate(xs):
            r = ps.set_matrix("X", x).set_matrix("W", w).execute_script()
            if not np.array_equal(_np(r.get("Z")), serial[i]):
                mismatches.append((tid, i))

    _run(8, worker)
    assert mismatches == []
    assert ps.stats.compile_count == compiles
    # the run windows balance: no run is left open, the clock stopped
    assert ps.stats._active_runs == 0 and ps.stats.run_time > 0


def test_unwrap_cache_identity_race_regression():
    """Threads binding different arrays to the same input name each
    execute with their own value."""
    ps = Connection(_cfg()).prepare_script("s = sum(X)\n",
                                           input_names=["X"],
                                           output_names=["s"])
    bad = []

    def worker(tid):
        x = np.full((4, 4), float(tid + 1))
        want = 16.0 * (tid + 1)
        for i in range(40):
            src = x.copy() if i % 2 else x    # new arrays and a held one
            got = float(ps.set_matrix("X", src).execute_script()
                        .get_scalar("s"))
            if got != pytest.approx(want):
                bad.append((tid, got, want))
            got = float(ps.execute({"X": src}).get_scalar("s"))
            if got != pytest.approx(want):
                bad.append((tid, got, want))

    _run(8, worker)
    assert bad == []
    assert ps.stats._active_runs == 0


def test_execute_script_keeps_bindings_on_failure():
    ps = Connection(_cfg()).prepare_script("s = sum(X + Y)\n",
                                           input_names=["X", "Y"],
                                           output_names=["s"])
    ps.set_matrix("X", np.ones((2, 2)))
    with pytest.raises(ValueError, match="unbound"):
        ps.execute_script()
    ps.set_matrix("Y", np.ones((2, 2)))  # X survives
    assert ps.execute_script().get_scalar("s") == pytest.approx(8.0)
    with pytest.raises(ValueError, match="unbound"):
        ps.execute_script()  # success cleared the bindings


def test_unwrap_cache_releases_dead_request_arrays():
    ps = Connection(_cfg()).prepare_script("s = sum(X)\n",
                                           input_names=["X"],
                                           output_names=["s"])
    # fp32 host arrays under the fp64 policy: each unwrap is a copy
    w = np.ones((4, 4), np.float32)  # caller-held, like model weights
    ps.execute({"X": w})
    assert ps._unwrap_cache["X"][0]() is w
    x = np.full((4, 4), 2.0, np.float32)  # a per-request batch
    ps.execute({"X": x})
    assert ps._unwrap_cache["X"][0]() is x
    del x
    gc.collect()
    assert "X" not in ps._unwrap_cache  # evicted with its owner
    ps.execute({"X": w})
    gc.collect()
    assert ps._unwrap_cache["X"][0]() is w


def test_unwrap_without_a_copy_does_not_pin_the_request():
    """On the CPU an fp64 host array is unwrapped without a copy: the
    tensor is over the array's memory, so an entry would keep the array
    alive for good. Nothing is cached, and the array dies with its
    owner."""
    import weakref

    ps = Connection(_cfg()).prepare_script("s = sum(X)\n",
                                           input_names=["X"],
                                           output_names=["s"])
    x = np.full((4, 4), 2.0)
    assert ps.execute({"X": x}).get_scalar("s") == pytest.approx(32.0)
    assert "X" not in ps._unwrap_cache
    ref = weakref.ref(x)
    del x
    gc.collect()
    assert ref() is None


def test_program_execute_balances_stats_across_fresh_stats_swap():
    """A fresh_stats() swap while a request is in flight ends the run on
    the Statistics that started it."""
    ps = Connection(_cfg()).prepare_script("s = sum(X)\n",
                                           input_names=["X"],
                                           output_names=["s"])
    prog = ps._program
    old_stats = prog.stats
    blk = prog.blocks[0]
    orig = blk.execute

    def swapping_execute(ec):
        prog.fresh_stats()
        return orig(ec)

    blk.execute = swapping_execute
    try:
        ps.execute({"X": np.ones((2, 2))})
    finally:
        del blk.execute
    new_stats = prog.stats
    assert new_stats is not old_stats
    assert old_stats._active_runs == 0
    assert old_stats.run_time > 0.0
    assert new_stats._active_runs == 0
    assert new_stats.run_time == 0.0


def test_request_scoped_execute_does_not_touch_fluent_bindings():
    ps = Connection(_cfg()).prepare_script("s = sum(X)\n",
                                           input_names=["X"],
                                           output_names=["s"])
    ps.set_matrix("X", np.ones((2, 2)))  # fluent, unfinished
    r = ps.execute({"X": np.full((2, 2), 3.0)})
    assert r.get_scalar("s") == pytest.approx(12.0)
    assert ps.execute_script().get_scalar("s") == pytest.approx(4.0)


def test_concurrent_scoring_service_from_8_threads(rng):
    """8 threads scoring mixed sizes through one service: every answer
    equal to the same rows scored alone, the rungs compiled once."""
    src, inputs, outs, meta = CORPUS["softmax"]
    w, b = rng.standard_normal((20, 10)), rng.standard_normal((1, 10))
    svc = ScoringService(_prepare(src, inputs, outs, meta),
                         constants={"W": w, "b": b}, ladder=(1, 8, 64))
    svc.warmup(20)
    compiles = svc._ps.stats.compile_count
    bad = []

    def worker(t):
        crng = np.random.default_rng(100 + t)
        for _ in range(10):
            x = crng.standard_normal((int(crng.integers(1, 65)), 20))
            got = _np(svc.score(x)["yhat"])
            if _rel(got, _softmax(x @ w + b)) > F64:
                bad.append(t)

    _run(8, worker)
    assert bad == []
    assert svc._ps.stats.compile_count == compiles
    assert svc.registry.get("requests_total").value == 80 + 6
    assert svc._ps.stats._active_runs == 0


def test_counters_hold_under_32_threads_and_a_short_switch_interval():
    """More threads than cores and a 1 us switch interval: every request
    counted once in the registry and the statistics, the bucket hits and
    misses summing to the requests, no run left open, every answer its
    own."""
    import sys

    svc, w, b = _scorer_service(np.random.default_rng(1), ladder=(1, 8, 64))
    svc.warmup(6)
    st = svc._ps.stats
    base = svc.registry.get("requests_total").value
    bad = []

    def worker(t):
        crng = np.random.default_rng(300 + t)
        for _ in range(12):
            x = crng.standard_normal((int(crng.integers(1, 65)), 6))
            if _rel(_np(svc.score(x)["prob"]), _sigmoid(x @ w + b)) > F64:
                bad.append(t)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run(32, worker, timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert bad == []
    assert svc.registry.get("requests_total").value - base == 32 * 12
    srv = st.estim_counts.grouped()["serving"]
    hits = sum(v for k, v in srv.items() if k.startswith("bucket_hit["))
    misses = sum(v for k, v in srv.items() if k.startswith("bucket_miss["))
    assert misses == 3 == svc.registry.get("bucket_misses_total").value
    assert hits == svc.registry.get("bucket_hits_total").value
    assert hits + misses == svc.registry.get("requests_total").value
    assert st._active_runs == 0


# --------------------------------------------------------------------------
# micro-batching
# --------------------------------------------------------------------------

def _clients(n, fn):
    """fn(t) of n threads released together, by thread."""
    barrier = threading.Barrier(n)
    out = {}

    def client(t):
        barrier.wait()
        out[t] = fn(t)

    _run(n, client)
    return out


def test_microbatch_results_match_direct(rng):
    ps = _prepare()
    w = rng.standard_normal((6, 1))
    b = rng.standard_normal((1, 1))
    svc = ScoringService(ps, "X", constants={"W": w, "b": b},
                         ladder=(1, 8, 64))
    svc.warmup(6)
    with MicroBatcher(svc, max_batch=8, deadline_us=200_000) as mb:
        def one(t):
            x = np.random.default_rng(500 + t).standard_normal((1, 6))
            return x, mb.score(x)

        results = _clients(8, one)
    for x, got in results.values():
        assert isinstance(got, np.ndarray)
        direct = _np(svc.score(x)["prob"])
        np.testing.assert_allclose(got, direct, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got, _sigmoid(x @ w + b), rtol=1e-12)
    cnt = ps.stats.estim_counts
    assert cnt.get("srv_microbatched_requests") == 8
    assert cnt.get("srv_microbatch_flush") < 8
    assert svc.registry.get("microbatch_flushes_total").value == \
        cnt.get("srv_microbatch_flush") == \
        cnt.get("srv_microbatch_flush_size", 0) \
        + cnt.get("srv_microbatch_flush_deadline", 0)


def test_microbatch_tensor_requests_concatenate_on_their_device(rng):
    svc, w, b = _scorer_service(rng, ladder=(1, 8, 64))
    with MicroBatcher(svc, max_batch=8, deadline_us=200_000) as mb:
        def one(t):
            x = torch.from_numpy(
                np.random.default_rng(600 + t).standard_normal((2, 6)))
            return x, mb.score(x)

        results = _clients(4, one)
    for x, got in results.values():
        assert isinstance(got, torch.Tensor) and got.device == x.device
        np.testing.assert_allclose(got.numpy(), _sigmoid(x.numpy() @ w + b),
                                   rtol=1e-12)


def test_microbatch_multirow_requests_unpack(rng):
    svc, w, b = _scorer_service(rng)
    with MicroBatcher(svc, max_batch=64, deadline_us=1000) as mb:
        for n in (1, 3, 5):
            x = rng.standard_normal((n, 6))
            out = mb.score(x)
            assert out.shape == (n, 1)
            np.testing.assert_allclose(out, _sigmoid(x @ w + b), rtol=1e-12)


def test_microbatch_error_propagates_and_flusher_survives(rng):
    svc, w, b = _scorer_service(rng)
    with MicroBatcher(svc, max_batch=4, deadline_us=1000) as mb:
        with pytest.raises(Exception):
            mb.score(np.ones((1, 4)))  # wrong ncol
        f1, f2 = Future(), Future()
        mb._flush([(np.ones((1, 6)), 1, f1, 0.0, None),
                   (np.ones((1, 4)), 1, f2, 0.0, None)], "size", obs)
        for f in (f1, f2):
            assert isinstance(f.exception(timeout=1), Exception)
        assert mb._flusher.is_alive()
        x = rng.standard_normal((1, 6))
        np.testing.assert_allclose(mb.score(x), _sigmoid(x @ w + b),
                                   rtol=1e-12)
    with pytest.raises(RuntimeError):
        mb.score(np.ones((1, 6)))  # closed


def test_microbatch_bounded_queue_refuses_at_the_door(rng):
    svc, _, _ = _scorer_service(rng)
    with MicroBatcher(svc, max_batch=64, deadline_us=200_000,
                      queue_rows_max=2) as mb:
        ghost: Future = Future()
        with mb._cv:
            mb._pending.append((np.ones((2, 6)), 2, ghost, time.monotonic(),
                                None))
        with pytest.raises(QueueFullError) as ei:
            mb.score(np.ones((1, 6)))
        assert ei.value.reason == "queue_full"
        assert ei.value.retry_after_s > 0
        assert svc.registry.get("microbatch_queue_full_total").value == 1
        assert svc._ps.stats.estim_counts.get(
            "srv_microbatch_queue_full") == 1
        with mb._cv:
            mb._pending.clear()


def test_microbatch_sheds_expired_requests_at_flush(rng):
    svc, w, b = _scorer_service(rng)
    with MicroBatcher(svc, max_batch=64, deadline_us=60_000) as mb:
        with pytest.raises(AdmissionRejectedError) as ei:
            mb.score(np.ones((1, 6)), deadline_s=0.0)
        assert ei.value.reason == "expired"
        errs = []

        def call():
            try:
                mb.score(np.ones((1, 6)), deadline_s=0.005)
            except AdmissionRejectedError as e:
                errs.append(e)

        th = threading.Thread(target=call)
        th.start()
        th.join(timeout=10.0)
        assert errs and errs[0].reason == "expired", errs
        assert svc.registry.get("microbatch_shed_total").value >= 2
        x = rng.standard_normal((1, 6))
        np.testing.assert_allclose(mb.score(x), _sigmoid(x @ w + b),
                                   rtol=1e-12)


def test_serving_request_path_has_no_unbounded_queue(rng):
    assert get_config().serving_queue_rows_max > 0
    svc, _, _ = _scorer_service(rng)
    with MicroBatcher(svc, max_batch=4, deadline_us=1000) as mb:
        assert mb._queue_rows_max == get_config().serving_queue_rows_max
        for name in ("microbatch_queue_rows", "microbatch_queue_age_seconds",
                     "microbatch_shed_total", "microbatch_queue_full_total"):
            assert svc.registry.get(name) is not None, name
        assert svc.registry.get("microbatch_queue_age_seconds").value == 0.0


def test_microbatch_flush_respects_max_batch(rng):
    svc, w, b = _scorer_service(rng, ladder=(1, 4, 8))
    svc.warmup(6)
    before = dict(svc._ps.stats.estim_counts.items())
    with MicroBatcher(svc, max_batch=4, deadline_us=100_000) as mb:
        def one(t):
            x = np.random.default_rng(900 + t).standard_normal((1, 6))
            return x, mb.score(x)

        outs = _clients(12, one)
    for x, got in outs.values():
        np.testing.assert_allclose(got, _sigmoid(x @ w + b), rtol=1e-12)
    cnt = svc._ps.stats.estim_counts
    assert cnt.get("srv_microbatch_flush", 0) \
        - before.get("srv_microbatch_flush", 0) >= 3
    for k, v in cnt.items():
        if k.startswith("srv_bucket_miss["):
            assert v == before.get(k, 0), (k, v)


def test_microbatch_refuses_non_row_local_scripts(rng):
    for src, outs in (("z = sum(X)\n", ["z"]), ("C = cumsum(X)\n", ["C"])):
        svc = ScoringService(_prepare(src, ["X"], outs, _X6), "X")
        with pytest.raises(ValueError, match="per-row"):
            MicroBatcher(svc, deadline_us=100)
    svc = ScoringService(_prepare("C = cumsum(X)\n", ["X"], ["C"], _X6),
                         "X", ladder=(1, 8))
    assert svc.bucketing_enabled and not svc.batchable
    x = rng.standard_normal((3, 6))
    np.testing.assert_allclose(_np(svc.score(x)["C"]), np.cumsum(x, axis=0),
                               rtol=1e-12)


def test_microbatch_refuses_the_fused_scorer_at_optlevel_3_unless_forced():
    src, inputs, outs, meta = CORPUS["softmax"]
    rng = np.random.default_rng(2)
    consts = {"W": rng.standard_normal((20, 10)),
              "b": rng.standard_normal((1, 10))}
    svc = ScoringService(_prepare(src, inputs, outs, meta, 3),
                         constants=consts)
    with pytest.raises(ValueError, match="spoof"):
        MicroBatcher(svc, deadline_us=100)
    svc = ScoringService(_prepare(src, inputs, outs, meta, 3),
                         constants=consts, validate="force", ladder=(1, 8))
    with MicroBatcher(svc, max_batch=8, deadline_us=100_000) as mb:
        def one(t):
            x = np.random.default_rng(40 + t).standard_normal((1, 20))
            return x, mb.score(x)

        for x, got in _clients(6, one).values():
            assert _rel(got, _softmax(x @ consts["W"] + consts["b"])) < F64


def test_microbatch_const_designated_output_returned_whole(rng):
    w = rng.standard_normal((6, 1))
    ps = _prepare("W2 = W * 2\nprob = sigmoid(X %*% W)\n", ["X", "W"],
                  ["W2", "prob"], {"X": {"shape": (None, 6)},
                                   "W": {"shape": (6, 1)}})
    svc = ScoringService(ps, "X", constants={"W": w}, ladder=(1, 8))
    assert svc.batchable, svc.safety_reason
    with MicroBatcher(svc, max_batch=8, deadline_us=20_000) as mb:
        got = _clients(4, lambda t: mb.score(
            np.random.default_rng(700 + t).standard_normal((1, 6))))
    for v in got.values():
        assert np.asarray(v).shape == (6, 1)  # whole, not out[i:i+1]
        np.testing.assert_allclose(v, w * 2, rtol=1e-12)
    with MicroBatcher(svc, max_batch=8, deadline_us=20_000,
                      output="prob") as mb:
        x = rng.standard_normal((1, 6))
        out = mb.score(x)
        assert out.shape == (1, 1)
        np.testing.assert_allclose(out, _sigmoid(x @ w), rtol=1e-12)


def test_microbatch_remainder_keeps_enqueue_deadline(rng):
    svc, _, _ = _scorer_service(rng)
    svc.warmup(6)
    real_score = svc.score

    def slow_score(x, extra=None):
        time.sleep(0.35)  # a dispatch slower than the deadline window
        return real_score(x, extra)

    svc.score = slow_score
    with MicroBatcher(svc, max_batch=2, deadline_us=0.3e6) as mb:
        def one(t):
            x = np.random.default_rng(800 + t).standard_normal((1, 6))
            t0 = time.monotonic()
            mb.score(x)
            return time.monotonic() - t0

        elapsed = _clients(3, one)   # the first flush takes 2, 1 kept back
    # the kept-back request: ~0.35 (flush 1) + ~0.35 (its own flush, at
    # once since its enqueue predates the deadline); restarting the
    # window would add 0.3 s more
    assert max(elapsed.values()) < 0.95, elapsed


# --------------------------------------------------------------------------
# metrics: -stats and /metrics
# --------------------------------------------------------------------------

def test_statistics_overlapping_runs():
    st = Statistics()
    st.start_run()
    st.start_run()   # an overlapping request
    st.end_run()
    assert st.run_time == 0.0  # one run still open: the clock runs
    st.end_run()
    assert st.run_time > 0.0
    st.end_run()     # an extra end does not go negative
    assert st._active_runs == 0


def test_stats_display_serving_line():
    st = Statistics()
    st.count_estim("srv_bucket_hit[8]", 3)
    st.count_estim("srv_microbatch_flush", 2)
    st.count_overload("microbatch_shed[expired]", 2)
    out = st.display()
    assert "Serving (event=count): bucket_hit[8]=3, microbatch_flush=2" \
        in out
    assert "Overload events: microbatch_shed[expired]=2" in out
    assert "Optimizer decisions" not in out
    assert st.registry.get("trace_dropped_events") is not None


def test_stats_line_after_traffic(rng):
    svc, _, _ = _scorer_service(rng)
    for n in (1, 3, 3):
        svc.score(rng.standard_normal((n, 6)))
    line = [ln for ln in svc._ps.stats.display().splitlines()
            if ln.startswith("Serving")]
    assert line == ["Serving (event=count): bucket_hit[8]=1, "
                    "bucket_miss[1]=1, bucket_miss[8]=1, pad_rows=10"]


class TestMetricsEndpoint:
    def _scrape(self, url):
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.read().decode("utf-8")

    def _svc(self, rng):
        return ScoringService(_prepare(), constants={
            "W": rng.standard_normal((6, 1)), "b": np.zeros((1, 1))})

    def test_scrape_serves_prometheus_text(self, rng):
        svc = self._svc(rng)
        svc.score(rng.standard_normal((3, 6)))
        with svc.serve_metrics(port=0) as ep:
            assert ep.port > 0
            status, ctype, body = self._scrape(ep.url)
        assert status == 200
        assert ctype == "text/plain; version=0.0.4"
        assert "smtpu_serving_requests_total 1" in body
        assert "# TYPE" in body and "# HELP" in body
        assert "trace_dropped_events" in body

    def test_scrape_reflects_traffic(self, rng):
        svc = self._svc(rng)

        def count(body):
            for ln in body.splitlines():
                if ln.startswith("smtpu_serving_requests_total"):
                    return float(ln.split()[-1])
            return None

        with svc.serve_metrics(port=0) as ep:
            _, _, before = self._scrape(ep.url)
            for _ in range(3):
                svc.score(rng.standard_normal((2, 6)))
            _, _, after = self._scrape(ep.url)
        assert count(after) == (count(before) or 0.0) + 3

    def test_non_metrics_path_404(self, rng):
        with self._svc(rng).serve_metrics(port=0) as ep:
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(f"http://127.0.0.1:{ep.port}/other",
                                       timeout=10)
            assert exc.value.code == 404

    def test_port_from_config(self, rng):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        get_config().serving_metrics_port = port
        with self._svc(rng).serve_metrics() as ep:
            assert ep.port == port
            assert self._scrape(ep.url)[0] == 200

    def test_default_bind_stays_loopback(self, rng):
        with self._svc(rng).serve_metrics(port=0) as ep:
            assert ep.host == "127.0.0.1"
            assert ep.url.startswith("http://127.0.0.1:")
            assert self._scrape(ep.url)[0] == 200

    def test_host_from_config_widens_bind(self, rng):
        set_config(DMLConfig(device="cpu", serving_metrics_host="0.0.0.0"))
        svc = self._svc(rng)
        with svc.serve_metrics(port=0) as ep:
            assert ep.host == "0.0.0.0"
            assert self._scrape(
                f"http://127.0.0.1:{ep.port}/metrics")[0] == 200
        with svc.serve_metrics(port=0, host="127.0.0.1") as ep:
            assert ep.host == "127.0.0.1"


def test_metrics_text_matches_the_jax_package_families(rng):
    """The same series names in both packages' expositions after the same
    traffic (the single-process exposition)."""
    w = rng.standard_normal((6, 1))
    consts = {"W": w, "b": np.zeros((1, 1))}
    svc = ScoringService(_prepare(), constants=consts, ladder=(1, 8))
    jsvc = JScoringService(_jprepare(), constants=consts, ladder=(1, 8))
    for n in (1, 3, 8):
        x = rng.standard_normal((n, 6))
        svc.score(x)
        jsvc.score(x)

    def series(text):
        return sorted({ln.split()[0].split("{")[0] for ln in
                       text.splitlines() if ln and not ln.startswith("#")})

    assert series(svc.metrics_text()) == series(jsvc.metrics_text())
    for name in ("requests_total", "bucket_hits_total",
                 "bucket_misses_total", "pad_rows_total"):
        assert svc.metrics()[name] == jsvc.metrics()[name], name


def test_bucket_events_match_the_jax_package(rng):
    w = rng.standard_normal((6, 1))
    consts = {"W": w, "b": np.zeros((1, 1))}
    svc = ScoringService(_prepare(), constants=consts, ladder=(1, 8, 64))
    jsvc = JScoringService(_jprepare(), constants=consts, ladder=(1, 8, 64))
    sizes = (1, 5, 8, 9, 64, 65)
    with obs.session() as rec:
        for n in sizes:
            svc.score(np.ones((n, 6)))
    jrec = jobs.FlightRecorder()
    prev = jobs.install(jrec)
    try:
        for n in sizes:
            jsvc.score(np.ones((n, 6)))
    finally:
        jobs.install(prev)

    def evs(events):
        return [(e.name, e.cat, dict(e.args)) for e in events
                if e.name == "bucket_dispatch"]

    assert evs(rec.events()) == evs(jrec.events())
    assert dict(svc._ps.stats.estim_counts.grouped()["serving"]) == \
        dict(jsvc._ps._program.stats.estim_counts.grouped()["serving"])


def test_serving_settings_are_ported():
    from systemml_tpu_torch.utils.config import PORTED_FIELDS, check_ported

    cfg = DMLConfig(device="cpu")
    for key, value in (("serving_bucket_ladder", (1, 16)),
                       ("serving_microbatch_max", 8),
                       ("serving_microbatch_deadline_us", 500.0),
                       ("serving_metrics_port", 9999),
                       ("serving_metrics_host", "0.0.0.0"),
                       ("serving_queue_rows_max", 0)):
        assert key in PORTED_FIELDS
        cfg.set(key, value)
    check_ported(cfg)
    assert serving.bucket_for(9, cfg.serving_bucket_ladder) == 16


# --------------------------------------------------------------------------
# prepare-time sparsity metadata takes the exploiting path
# --------------------------------------------------------------------------

_WSLOSS = ("U = rand(rows=nrow(X), cols=4, min=-1, max=1, seed=5)\n"
           "V = rand(rows=ncol(X), cols=4, min=-1, max=1, seed=6)\n"
           "z = sum((X - U %*% t(V))^2)\n")


def test_prepared_quaternary_with_sparsity_meta_exploits(rng):
    """The wsloss shape fires only under an estimated-sparse guard, so the
    prepare-time sparsity is what makes the sampled kernel run; the value
    equals the JAX package's."""
    x = np.where(rng.random((60, 50)) < 0.02,
                 rng.standard_normal((60, 50)), 0.0)
    meta = {"X": {"sparsity": 0.02, "shape": (None, 50)}}
    cfg = _cfg()
    cfg.codegen_enabled = False
    ps = Connection(cfg).prepare_script(_WSLOSS, input_names=["X"],
                                        output_names=["z"], input_meta=meta)
    assert {k for k in ps.stats.estim_counts if k.startswith("rw_q_")}
    z = ps.set_matrix("X", ssp.csr_matrix(x)).execute_script() \
        .get_scalar("z")
    assert any("_exploit_" in k for k in ps.stats.estim_counts
               if k.startswith("spx_"))
    jc = _jcfg()
    jc.codegen_enabled = False
    jps = JConnection().prepare_script(_WSLOSS, input_names=["X"],
                                       output_names=["z"], input_meta=meta)
    jz = float(np.asarray(jps.set_matrix("X", ssp.csr_matrix(x))
                          .execute_script().get("z")))
    assert abs(z - jz) <= F64 * abs(jz)


def test_prepared_without_meta_stays_dense():
    cfg = _cfg()
    cfg.codegen_enabled = False
    ps = Connection(cfg).prepare_script(_WSLOSS, input_names=["X"],
                                        output_names=["z"])
    assert not {k for k in ps.stats.estim_counts if k.startswith("rw_q_")}
