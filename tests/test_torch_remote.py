"""Remote parfor in the port (systemml_tpu_torch/runtime/remote.py): worker
processes, program shipping, binary-block payloads, the supervised job
protocol; tests/test_remote_parfor.py and tests/test_resil_remote.py of
the JAX package, through the port, on the CPU.

Bars: a remote run equals the port's seq run bit for bit, and the JAX
package's seq run at 1e-12 (fp64); under an injected worker kill or hang
the result stays bit-identical to the run without a fault. The module's
tests share one pool of workers (each worker a `python -m
systemml_tpu_torch.runtime.remote --serve` process on the CPU, as the
coordinator's config says); the hung-worker case asserts recovery under
a per-test limit of 120 s, far above its 10 s deadline, and no wall
time.
"""

import json
import os
import threading

import numpy as np
import pytest

from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.resil import faults, inject
from systemml_tpu_torch.runtime import remote
from systemml_tpu_torch.utils.config import DMLConfig

BODY = """
R = matrix(0, rows=8, cols=3)
parfor (i in 1:8, mode=$mode, par=2) {
  x = as.scalar(X[i, 1])
  R[i, 1] = x * 2
  R[i, 2] = x ^ 2
  R[i, 3] = sum(X[i, ])
}
"""


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _clean_registry():
    inject.reset()
    yield
    inject.reset()


def teardown_module():
    remote.shutdown_pool()


def _cfg(**over):
    cfg = DMLConfig(device="cpu")
    cfg.resil_backoff_base_s = 0.01
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _run(src, inputs=None, outputs=("R",), args=None, base_dir=None, **cfg):
    ml = MLContext(_cfg(**cfg))
    s = dml(src)
    if base_dir:
        s.base_dir = base_dir
    for k, v in (inputs or {}).items():
        s.input(k, v)
    for k, v in (args or {}).items():
        s.arg(k, v)
    with obs.session() as rec:
        res = ml.execute(s.output(*outputs))
    return res, ml, [e for e in rec.events() if e.cat == obs.CAT_RESIL]


def _body(x, mode, **cfg):
    res, ml, evs = _run(BODY, {"X": x}, args={"mode": mode}, **cfg)
    return np.asarray(res.get_matrix("R")), ml, evs


def test_remote_matches_seq_and_the_jax_package(rng):
    from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
    from systemml_tpu.api.mlcontext import dml as jax_dml

    x = rng.normal(size=(8, 3))
    seq, _, _ = _body(x, "seq")
    got, ml, _ = _body(x, "remote")
    assert np.array_equal(got, seq)
    assert ml._stats.mesh_op_count.get("parfor_remote", 0) == 1
    assert remote.last_run["groups"] == 2
    assert remote.last_run["devices"] == ["cpu", "cpu"]
    ref = JaxMLContext().execute(jax_dml(BODY).input("X", x).arg(
        "mode", "seq").output("R")).get_matrix("R")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-12, atol=0)


def test_remote_with_function_and_namespace(tmp_path, rng):
    lib = tmp_path / "lib.dml"
    lib.write_text("""
scale2 = function(matrix[double] v, double s) return (matrix[double] o) {
  o = v * s
}
""")
    src = f"""
source("{lib}") as lib
twice = function(double v) return (double o) {{ o = 2 * v }}
R = matrix(0, rows=4, cols=2)
parfor (i in 1:4, mode="remote", par=2) {{
  R[i, 1] = twice(as.scalar(X[i, 1]))
  R[i, 2] = sum(lib::scale2(X[i, ], 3))
}}
"""
    x = rng.normal(size=(4, 2))
    res, ml, _ = _run(src, {"X": x}, base_dir=str(tmp_path))
    expect = np.stack([2 * x[:, 0], 3 * x.sum(axis=1)], axis=1)
    np.testing.assert_allclose(res.get_matrix("R"), expect, rtol=1e-12)
    assert ml._stats.mesh_op_count.get("parfor_remote", 0) == 1


def test_remote_scalars_preserve_int_and_the_payload_reparses(tmp_path, rng,
                                                              monkeypatch):
    """Integer scalars arrive at workers as ints (print/toString
    formatting and integer semantics as local); the payload is a
    self-contained re-parsable program, its inputs and the coordinator's
    device."""
    from systemml_tpu_torch.lang.parser import parse_file

    captured = {}
    orig = remote.serialize_parfor

    def spy(pb, ec, body_reads, payload_dir):
        orig(pb, ec, body_reads, payload_dir)
        captured["files"] = sorted(os.listdir(payload_dir))
        for name in ("scalars.json", "meta.json"):
            with open(os.path.join(payload_dir, name)) as f:
                captured[name] = json.load(f)
        with open(os.path.join(payload_dir, "body.dml")) as f:
            captured["body"] = f.read()

    monkeypatch.setattr(remote, "serialize_parfor", spy)
    src = """
n = 7
f = 2.5
R = matrix(0, rows=4, cols=1)
parfor (i in 1:4, mode="remote") {
  R[i, 1] = sum(X) * i + n + f
}
"""
    x = rng.normal(size=(8, 3))
    res, _, _ = _run(src, {"X": x})
    np.testing.assert_allclose(res.get_matrix("R").ravel(),
                               x.sum() * np.arange(1, 5) + 9.5, rtol=1e-12)
    assert captured["scalars.json"] == {"n": 7, "f": 2.5}
    assert isinstance(captured["scalars.json"]["n"], int)
    assert {"body.dml", "X.bb", "meta.json"} <= set(captured["files"])
    meta = captured["meta.json"]
    assert meta["config"]["device"] == "cpu" and meta["results"] == ["R"]
    p = tmp_path / "body.dml"
    p.write_text(captured["body"])
    parse_file(str(p))


def test_body_print_does_not_desync_protocol(rng):
    """stdout is the pool's control channel: a DML print() in the body
    goes to the worker's stderr, and the same workers answer again."""
    src = """
R = matrix(0, rows=4, cols=1)
parfor (i in 1:4, mode="remote", par=2) {
  print("worker says " + i)
  R[i, 1] = sum(X) + i
}
"""
    x = rng.normal(size=(4, 2))
    r1, _, _ = _run(src, {"X": x})
    np.testing.assert_allclose(r1.get_matrix("R").ravel(),
                               x.sum() + np.arange(1, 5), rtol=1e-12)
    r2, _, _ = _run(src, {"X": x})
    assert np.array_equal(r2.get_matrix("R"), r1.get_matrix("R"))


def test_worker_pool_persists_across_runs(rng):
    """A second run reuses the pool's workers: the same pids, no spawn."""
    x = rng.normal(size=(8, 3))
    first, _, _ = _body(x, "remote")
    pids = sorted(p.pid for p in remote._pool if p.poll() is None)
    assert len(pids) >= 2
    spawned = remote.spawn_count
    second, _, _ = _body(x, "remote")
    assert remote.spawn_count == spawned
    assert remote.last_run["spawned"] == 0
    assert sorted(p.pid for p in remote._pool if p.poll() is None) == pids
    assert np.array_equal(first, second)


def test_remote_unshippable_falls_back_local(rng):
    """A frame input cannot ship: the loop runs locally, counted."""
    from systemml_tpu_torch.lang.ast import ValueType
    from systemml_tpu_torch.runtime.data import FrameObject

    src = """
R = matrix(0, rows=3, cols=1)
parfor (i in 1:3, mode="remote") {
  R[i, 1] = i * as.scalar(X[1, 1]) + 0 * nrow(F)
}
"""
    x = rng.normal(size=(2, 2))
    fr = FrameObject([np.array(["p", "q"], dtype=object)],
                     [ValueType.STRING], ["a"])
    res, ml, _ = _run(src, {"X": x, "F": fr})
    np.testing.assert_allclose(
        res.get_matrix("R"), np.arange(1, 4).reshape(-1, 1) * x[0, 0],
        rtol=1e-12)
    assert ml._stats.mesh_op_count.get("parfor_remote", 0) == 0
    assert ml._stats.estim_counts.get("parfor_remote_unshippable", 0) == 1


def test_a_worker_asked_for_a_card_it_cannot_see_fails_its_job(tmp_path,
                                                               rng):
    """A job whose shipped device is "cuda" on a machine without a card
    fails, naming the reason, and is not retried: it never runs on the
    CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        remote._worker_config({"device": "cuda"})
    # through the protocol: a pool worker, a payload whose device is cuda
    seen = {}
    orig = remote.serialize_parfor

    def to_cuda(pb, ec, body_reads, payload_dir):
        orig(pb, ec, body_reads, payload_dir)
        path = os.path.join(payload_dir, "meta.json")
        with open(path) as f:
            meta = json.load(f)
        meta["config"]["device"] = "cuda"
        with open(path, "w") as f:
            json.dump(meta, f)
        seen["done"] = True

    x = rng.normal(size=(8, 3))
    remote.serialize_parfor = to_cuda
    try:
        with pytest.raises(RuntimeError, match="does not run on the CPU"):
            _body(x, "remote")
    finally:
        remote.serialize_parfor = orig
    assert seen["done"]


# ---- the supervised job: tests/test_resil_remote.py through the port ----

def test_worker_killed_mid_job_requeues_bit_identical(rng):
    x = rng.normal(size=(8, 3))
    base, _, _ = _body(x, "remote")   # no-fault run (warms the pool)
    got, ml, evs = _body(x, "remote", fault_injection="remote.job:kill:1")
    assert np.array_equal(base, got), "result differs after worker kill"
    assert ml._stats.mesh_op_count.get("parfor_remote", 0) == 1
    names = [e.name for e in evs]
    assert "worker_retired" in names and "requeue" in names, names
    fault = next(e for e in evs if e.name == "fault")
    assert fault.args["site"] == "remote.job"
    assert fault.args["kind"] == faults.WORKER
    assert "worker died" in fault.args["error"]


def test_worker_hung_mid_job_deadline_retires_bit_identical(rng):
    """SIGSTOP one worker: it never acknowledges its job, and the
    deadline reader retires it; the group requeues on a fresh worker,
    whose start the deadline does not count. Recovery is asserted, not
    a wall time; the scenario runs under a limit of 120 s."""
    x = rng.normal(size=(8, 3))
    base, _, _ = _body(x, "remote")
    out = {}

    def scenario():
        out["run"] = _body(x, "remote", fault_injection="remote.job:hang:1",
                           remote_deadline_s=10.0)

    t = threading.Thread(target=scenario, daemon=True)
    t.start()
    t.join(timeout=120.0)
    assert "run" in out, "the hung worker's group did not recover in 120 s"
    got, _, evs = out["run"]
    assert np.array_equal(base, got), "result differs after worker hang"
    names = [e.name for e in evs]
    assert "worker_retired" in names and "requeue" in names, names
    fault = next(e for e in evs if e.name == "fault")
    assert fault.args["kind"] == faults.DEADLINE
    assert "deadline" in fault.args["error"]


def test_exactly_once_partial_results_discarded(rng, monkeypatch):
    """A worker dying MID-SAVE leaves partial results in its attempt's
    directory; the requeued attempt merges ONLY its own output."""
    from systemml_tpu_torch.io import binaryblock

    x = rng.normal(size=(8, 3))
    base, _, _ = _body(x, "remote")
    orig = remote._worker_run_job
    state = {"n": 0}

    def dies_after_partial_save(p, payload, task_file, tdir, **kw):
        state["n"] += 1
        if state["n"] == 1:
            binaryblock.write(os.path.join(tdir, "R.bb"),
                              np.full((8, 3), 777.0))
            raise faults.WorkerDiedError("simulated mid-save death")
        return orig(p, payload, task_file, tdir, **kw)

    monkeypatch.setattr(remote, "_worker_run_job", dies_after_partial_save)
    got, _, evs = _body(x, "remote")
    assert not (got == 777.0).any(), "partial results leaked into merge"
    assert np.array_equal(base, got)
    assert "requeue" in [e.name for e in evs]


def test_fatal_at_job_site_raises_without_requeue(rng):
    x = rng.normal(size=(8, 3))
    with pytest.raises(NameError, match="injected fatal"):
        _body(x, "remote", fault_injection="remote.job:error:1")


def test_attempt_budget_exhaustion_raises_transient(rng):
    x = rng.normal(size=(8, 3))
    with pytest.raises(faults.WorkerDiedError):
        _body(x, "remote", fault_injection="remote.job:kill:1:99",
              resil_max_attempts=2)
    # the pool keeps no dead worker: a later run gets live ones
    got, _, _ = _body(x, "remote")
    seq, _, _ = _body(x, "seq")
    assert np.array_equal(got, seq)
