"""Parfor through the port on the CPU, held to the JAX package.

The reference's own parfor tests, run through the port's
MLContext(device="cpu") on the same numpy-seeded inputs as through the
JAX package's, in fp64:

- tests/test_parfor_consistency.py: random dependency-free bodies as a
  plain `for` and as `parfor` in seq, local and device modes, every result
  equal to the `for` run's bit for bit, and to the JAX package's in the
  same mode at 1e-15 (its `x * x - y` is one fused multiply-add, the
  port's two roundings); the dependency check's rejection;
- tests/test_parfor_opt.py: the one-device counterparts (AUTO picks
  local, as systemml_tpu/runtime/parfor_opt.py does with one device), the
  partitioner and explicit modes;
- tests/test_parfor_device.py: device mode equals seq on one device;
- the four `parfor.task` cases of tests/test_resil.py;
- seeded rand() in a parfor body bit-identical to the JAX package for par
  1, 2 and 8, in every mode;
- mode="remote" and fault injection at another site raise, naming their
  ROADMAP items;
- ALS-DS, StepGLM, Univar-Stats with categorical columns and
  random-forest through both MLContexts, at 1e-9.
"""

import contextlib
import io

import numpy as np
import pytest

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.resil import faults, inject
from systemml_tpu_torch.utils.config import DMLConfig
from tests.test_torch_breadth_scripts import rel, run_script

_N = 8  # iterations / stripes


@pytest.fixture(autouse=True)
def _clean_registry():
    inject.reset()
    yield
    inject.reset()


def _run(src, inputs, outs, port=True, cfg=None, matrices=()):
    """(scalars, matrices) of one run through the port or the JAX
    package (one device, pallas_mode "never")."""
    if port:
        ml = MLContext(cfg or DMLConfig(device="cpu"))
        s = dml(src)
    else:
        jc = cfg or JaxConfig()
        jc.exec_mode = "SINGLE_NODE"
        jc.pallas_mode = "never"
        ml = JaxMLContext(jc)
        s = jax_dml(src)
    for k, v in inputs.items():
        s.input(k, v)
    with contextlib.redirect_stdout(io.StringIO()):
        res = ml.execute(s.output(*outs, *matrices))
    return ([float(res.get_scalar(o)) for o in outs],
            [np.asarray(res.get_matrix(m)) for m in matrices],
            getattr(ml, "_stats", None))


# --------------------------------------------------------------------------
# tests/test_parfor_consistency.py
# --------------------------------------------------------------------------

class _BodyGen:
    """Random dependency-free parfor bodies: R[i,] = f(X[i,], Y[i,], i)
    (tests/test_parfor_consistency.py)."""

    _ROW_FNS = [
        "{x} * 2 + {y}",
        "abs({x}) + abs({y})",
        "({x} + {y}) * (i / {n})",
        "{x} * {x} - {y}",
        "max({x}, {y}) + min({x}, {y})",
        "({x} - {y}) / (abs({y}) + 1.5)",
        "{x} + sum({y}) / ncol(X)",
    ]

    def __init__(self, rng):
        self.rng = rng

    def body(self):
        f = self.rng.choice(self._ROW_FNS)
        expr = f.format(x="X[i,]", y="Y[i,]", n=_N)
        lines = [f"R[i,] = {expr}"]
        if self.rng.random() < 0.5:  # second result variable
            g = self.rng.choice(self._ROW_FNS)
            lines.append(
                "S[i,] = " + g.format(x="Y[i,]", y="X[i,]", n=_N))
        return "\n  ".join(lines), len(lines) > 1


def _script(loop_head, body, two):
    outs = "\nzr = sum(abs(R))" + ("\nzs = sum(abs(S))" if two else "")
    return (f"R = matrix(0, rows={_N}, cols=ncol(X))\n"
            f"S = matrix(0, rows={_N}, cols=ncol(X))\n"
            f"{loop_head} {{\n  {body}\n}}" + outs)


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("mode", ["seq", "local", "device"])
def test_parfor_matches_sequential_and_jax(seed, mode):
    rng = np.random.default_rng(seed)
    body, two = _BodyGen(rng).body()
    X = rng.standard_normal((_N, 6))
    Y = rng.standard_normal((_N, 6))
    outs = ("zr", "zs") if two else ("zr",)
    mats = ("R", "S")
    loop = _script(f"for (i in 1:{_N})", body, two)
    par = _script(f'parfor (i in 1:{_N}, mode="{mode}", par=4)', body, two)
    seq_s, seq_m, _ = _run(loop, {"X": X, "Y": Y}, outs, matrices=mats)
    par_s, par_m, st = _run(par, {"X": X, "Y": Y}, outs, matrices=mats)
    jax_s, jax_m, _ = _run(par, {"X": X, "Y": Y}, outs, port=False,
                           matrices=mats)
    jax_loop_s, jax_loop_m, _ = _run(loop, {"X": X, "Y": Y}, outs,
                                     port=False, matrices=mats)
    # the port's parfor equals its for loop bit for bit, as the JAX
    # package's does its own
    assert seq_s == par_s, body
    assert jax_s == jax_loop_s, body
    for a, b, c, d in zip(par_m, seq_m, jax_m, jax_loop_m):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)
        # and the JAX package's to the last bit or one rounding: XLA
        # contracts `x * x - y` into a fused multiply-add, the port
        # rounds the product (their for loops differ alike)
        assert rel(a, c) <= 1e-15, body
    assert rel(par_s, jax_s) <= 1e-15, body
    assert any(k.startswith(f"parfor_{mode}_")
               for k in st.estim_counts), dict(st.estim_counts)


def test_parfor_rejects_loop_carried_dependency():
    from systemml_tpu_torch.lang.parfor_deps import ParForDependencyError

    src = _script(f"parfor (i in 2:{_N})", "R[i,] = R[i-1,] + X[i,]", False)
    X = np.ones((_N, 6))
    with pytest.raises(ParForDependencyError,
                       match="read-write dependency on 'R'"):
        _run(src, {"X": X, "Y": X}, ("zr",))


def test_merge_semantics():
    """The merge's rules: a later task wins a cell two tasks change,
    -0.0 equals 0.0 and NaN -> NaN is no change, a shape-changing update
    and a scalar write are discarded, a new matrix stays a worker temp."""
    src = """
R = matrix(0, rows=4, cols=2)
R[1, 2] = 0 / 0
Q = matrix(1, rows=2, cols=2)
s = 5
parfor (i in 1:4, par=4, taskpartitioner="naive", check=0) {
  R[1, 1] = i
  R[i, 2] = R[i, 2] * 1
  R[2, 2] = -0.0
  Q = matrix(i, rows=3, cols=3)
  s = i
  T = R
}
t = exists(T)
"""
    for port in (True, False):
        sc, (r, q), _ = _run(src, {}, ("s",), port=port, matrices=("R", "Q"))
        assert sc == [5.0]
        assert r[0, 0] == 4.0 and np.isnan(r[0, 1])
        assert r[1, 1] == 0.0 and not np.signbit(r[1, 1])
        np.testing.assert_array_equal(q, np.ones((2, 2)))


# --------------------------------------------------------------------------
# tests/test_parfor_opt.py: one device
# --------------------------------------------------------------------------

def _parfor_keys(stats):
    return {k for k in stats.estim_counts if k.startswith("parfor_")
            and k != "parfor_lanes"}


HEAVY = """
R = matrix(0, rows=8, cols=1)
parfor (i in 1:8{mode}) {{
  S = (X * i) %*% X
  R[i, 1] = sum(S)
}}
"""


def test_tiny_body_stays_local():
    src = """
R = matrix(0, rows=8, cols=1)
parfor (i in 1:8) {
  R[i, 1] = i * 2 + 1
}
"""
    _, (r,), st = _run(src, {}, (), matrices=("R",))
    np.testing.assert_array_equal(r[:, 0], np.arange(1, 9) * 2 + 1)
    assert _parfor_keys(st) == {"parfor_local_static"}


@pytest.mark.parametrize("budget", [None, 1e6])
def test_heavy_body_on_one_device_picks_local(budget):
    """AUTO with one device picks local, whatever the body's cost and the
    replica budget (systemml_tpu/runtime/parfor_opt.py:185-187)."""
    x = np.random.default_rng(3).standard_normal((96, 96))
    cfg = DMLConfig(device="cpu")
    if budget:
        cfg.mem_budget_bytes = budget
    _, (r,), st = _run(HEAVY.format(mode=""), {"X": x}, (), cfg=cfg,
                       matrices=("R",))
    _, (rj,), _ = _run(HEAVY.format(mode=""), {"X": x}, (), port=False,
                       matrices=("R",))
    assert rel(r, rj) <= 1e-9
    assert _parfor_keys(st) == {"parfor_local_static"}


@pytest.mark.parametrize("par,k", [("", 1), (", par=4", 4)])
def test_one_card_without_par_takes_one_worker(monkeypatch, par, k):
    """The optimizer, shown one CUDA device, plans one worker unless the
    script sets par (runtime/parfor_opt.py: eight lanes on one card ran
    slower than one); the run itself stays on the CPU, equal to the JAX
    package's."""
    import torch

    from systemml_tpu_torch.runtime import parfor_opt

    real, plans = parfor_opt.optimize, []

    def on_one_card(*args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(parfor_opt, "devices",
                      lambda: [torch.device("cuda", 0)])
            plans.append(real(*args, **kwargs))
        return plans[-1]

    monkeypatch.setattr(parfor_opt, "optimize", on_one_card)
    src = HEAVY.format(mode=par)
    x = np.random.default_rng(6).standard_normal((32, 32))
    _, (r,), _ = _run(src, {"X": x}, (), matrices=("R",))
    _, (rj,), _ = _run(src, {"X": x}, (), port=False, matrices=("R",))
    assert rel(r, rj) <= 1e-9
    assert [(p.mode, p.k) for p in plans] == [("local", k)]


def test_partitioner_static_for_uniform_factoring_for_branchy():
    x = np.random.default_rng(4).standard_normal((64, 8))
    uniform = """
R = matrix(0, rows=8, cols=1)
parfor (i in 1:8) {
  R[i, 1] = sum(X) * i
}
"""
    branchy = """
R = matrix(0, rows=8, cols=1)
parfor (i in 1:8) {
  if (i > 4) {
    R[i, 1] = sum(X) * i
  } else {
    R[i, 1] = i
  }
}
"""
    for src, part in ((uniform, "static"), (branchy, "factoring")):
        _, (r,), st = _run(src, {"X": x}, (), matrices=("R",))
        _, (rj,), _ = _run(src, {"X": x}, (), port=False, matrices=("R",))
        assert rel(r, rj) <= 1e-9
        assert _parfor_keys(st) == {f"parfor_local_{part}"}


@pytest.mark.parametrize("mode", ["seq", "local", "device"])
def test_explicit_mode_respected(mode):
    x = np.random.default_rng(5).standard_normal((48, 48))
    src = HEAVY.format(mode=f', mode="{mode}"')
    _, (r,), st = _run(src, {"X": x}, (), matrices=("R",))
    _, (rj,), _ = _run(src, {"X": x}, (), port=False, matrices=("R",))
    assert rel(r, rj) <= 1e-9
    assert _parfor_keys(st) == {f"parfor_{mode}_static"}
    assert st.mesh_op_count.get("parfor_device", 0) == (mode == "device")


@pytest.mark.parametrize("scheme", ["naive", "static", "factoring"])
def test_partition_tasks_as_jax(scheme):
    from systemml_tpu.runtime.parfor import partition_tasks as jax_part
    from systemml_tpu_torch.runtime.parfor import partition_tasks

    for n in (1, 7, 8, 33):
        for k in (1, 3, 8):
            iters = list(range(1, n + 1))
            assert partition_tasks(iters, k, scheme) == \
                jax_part(iters, k, scheme)


def test_explain_runtime_shows_plan():
    from systemml_tpu_torch.api.cli import main

    out = io.StringIO()
    import json
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cfgp = os.path.join(d, "cpu.json")
        with open(cfgp, "w") as f:
            json.dump({"device": "cpu"}, f)
        with contextlib.redirect_stdout(out):
            main(["-s", "R = matrix(0, rows=4, cols=1)\n"
                  "parfor (i in 1:4, par=2) {\n  R[i, 1] = i\n}\n"
                  "print(sum(R))", "-explain", "runtime", "-config", cfgp])
    text = out.getvalue()
    assert "10" in text
    assert "PARFOR (i) [mode=local k=2 partitioner=static" in text


# --------------------------------------------------------------------------
# tests/test_parfor_device.py: seq equals device mode on one device
# --------------------------------------------------------------------------

DEVICE_SCRIPT = """
R = matrix(0, rows=8, cols=1)
parfor (i in 1:8, mode={mode}) {{
  S = (X + i) %*% W
  R[i, 1] = sum(S * S)
}}
out = sum(R)
"""


def test_device_mode_matches_seq():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 32))
    w = rng.standard_normal((32, 16))
    ins = {"X": x, "W": w}
    _, (r_seq,), _ = _run(DEVICE_SCRIPT.format(mode='"seq"'), ins, (),
                          matrices=("R",))
    _, (r_dev,), st = _run(DEVICE_SCRIPT.format(mode='"device"'), ins, (),
                           matrices=("R",))
    _, (r_jax,), _ = _run(DEVICE_SCRIPT.format(mode='"device"'), ins, (),
                          port=False, matrices=("R",))
    np.testing.assert_array_equal(r_dev, r_seq)
    assert rel(r_dev, r_jax) <= 1e-9
    assert st.mesh_op_count.get("parfor_device", 0) == 1


def test_model_averaging_parfor():
    """mnist_lenet_distrib_sgd-style: independent model updates on row
    blocks, averaged on merge; device mode equals seq and the JAX
    package."""
    tpl = """
G = matrix(0, rows=ncol(X), cols=4)
parfor (b in 1:4, mode={mode}) {{
  beg = (b-1) * 16 + 1
  Xb = X[beg:(beg+15), ]
  yb = y[beg:(beg+15), ]
  g = t(Xb) %*% (Xb %*% w0 - yb)
  G[, b] = g
}}
w1 = w0 - 0.01 * rowMeans(G)
"""
    rng = np.random.default_rng(3)
    ins = {"X": rng.standard_normal((64, 8)),
           "y": rng.standard_normal((64, 1)),
           "w0": rng.standard_normal((8, 1))}
    _, (dev,), _ = _run(tpl.format(mode='"device"'), ins, (),
                        matrices=("w1",))
    _, (seq,), _ = _run(tpl.format(mode='"seq"'), ins, (), matrices=("w1",))
    _, (jx,), _ = _run(tpl.format(mode='"seq"'), ins, (), port=False,
                       matrices=("w1",))
    np.testing.assert_array_equal(dev, seq)
    assert rel(dev, jx) <= 1e-9


# --------------------------------------------------------------------------
# tests/test_resil.py:187-235, the parfor.task cases
# --------------------------------------------------------------------------

PARFOR_SRC = """
R = matrix(0, rows=6, cols=2)
parfor (i in 1:6, par=2) {
  x = as.scalar(X[i, 1])
  R[i, 1] = x * 2
  R[i, 2] = x ^ 2
}
"""


def run_traced(src, inputs=None, outputs=(), **cfg_over):
    cfg = DMLConfig(device="cpu")
    cfg.resil_backoff_base_s = 1e-4
    for k, v in cfg_over.items():
        setattr(cfg, k, v)
    ml = MLContext(cfg)
    s = dml(src)
    for k, v in (inputs or {}).items():
        s.input(k, v)
    with obs.session() as rec:
        res = ml.execute(s.output(*outputs))
    return res, rec


def _resil_events(rec):
    return [e for e in rec.events() if e.cat == obs.CAT_RESIL]


class TestParforRetry:
    def test_transient_retries_to_identical_result(self):
        x = np.random.default_rng(7).normal(size=(6, 2))
        base, _ = run_traced(PARFOR_SRC, {"X": x}, ("R",))
        got, rec = run_traced(PARFOR_SRC, {"X": x}, ("R",),
                              fault_injection="parfor.task:oom:1")
        assert np.array_equal(base.get_matrix("R"), got.get_matrix("R"))
        evs = _resil_events(rec)
        retries = [e for e in evs if e.name == "retry"
                   and e.args.get("site") == "parfor.task"]
        assert retries, [e.name for e in evs]
        assert any(e.name == "fault" and e.args.get("kind") == faults.OOM
                   for e in evs)

    def test_fatal_raises_immediately(self):
        x = np.random.default_rng(7).normal(size=(6, 2))
        with pytest.raises(NameError, match="injected fatal"):
            run_traced(PARFOR_SRC, {"X": x}, ("R",),
                       fault_injection="parfor.task:error:1")

    def test_attempt_budget_exhaustion(self):
        x = np.random.default_rng(7).normal(size=(6, 2))
        with pytest.raises(Exception, match="RESOURCE_EXHAUSTED"):
            run_traced(PARFOR_SRC, {"X": x}, ("R",),
                       fault_injection="parfor.task:oom:1:99",
                       resil_max_attempts=2)

    def test_resil_disabled_fails_fast(self):
        x = np.random.default_rng(7).normal(size=(6, 2))
        with pytest.raises(Exception, match="RESOURCE_EXHAUSTED"):
            run_traced(PARFOR_SRC, {"X": x}, ("R",),
                       fault_injection="parfor.task:oom:1",
                       resil_enabled=False)


def test_torch_oom_is_transient():
    import torch

    assert faults.classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == faults.OOM


def test_worker_error_fails_the_run():
    """A task's error that is not transient leaves execute_parfor: the
    run fails, with no fallback to seq."""
    src = """
R = matrix(0, rows=4, cols=1)
parfor (i in 1:4, par=4) {
  if (i == 3) {
    stop("task three fails")
  }
  R[i, 1] = i
}
"""
    with pytest.raises(Exception, match="task three fails"):
        _run(src, {}, ())


# --------------------------------------------------------------------------
# seeded rand() in the body; the items that wait
# --------------------------------------------------------------------------

RAND_SRC = """
R = matrix(0, rows=12, cols=10)
parfor (i in 1:12, par={par}, mode="{mode}") {{
  A = rand(rows=1, cols=5)
  B = rand(rows=1, cols=5, min=-1, max=1)
  R[i,] = cbind(A, B)
}}
"""


@pytest.mark.parametrize("mode", ["local", "seq", "device"])
@pytest.mark.parametrize("par", [1, 2, 8])
def test_parfor_rand_bit_identical_to_jax(par, mode):
    from systemml_tpu.ops import datagen as jax_datagen
    from systemml_tpu_torch.ops import datagen

    src = RAND_SRC.format(par=par, mode=mode)
    try:
        datagen.set_global_seed(11)
        jax_datagen.set_global_seed(11)
        _, (r,), _ = _run(src, {}, (), matrices=("R",))
        _, (rj,), _ = _run(src, {}, (), port=False, matrices=("R",))
    finally:
        datagen.set_global_seed(None)
        jax_datagen.set_global_seed(None)
    np.testing.assert_array_equal(r, rj)
    assert len({tuple(row) for row in r}) == 12


def test_remote_mode_and_other_fault_sites_raise():
    with pytest.raises(NotImplementedError, match="remote parfor.*9b"):
        _run('R = matrix(0, rows=2, cols=1)\n'
             'parfor (i in 1:2, mode="remote") {\n  R[i, 1] = i\n}', {}, ())
    cfg = DMLConfig(device="cpu")
    cfg.fault_injection = "dispatch.fused:oom:1"
    with pytest.raises(NotImplementedError,
                       match="distributed and elastic.*item 12"):
        _run("x = 1", {}, (), cfg=cfg)


# --------------------------------------------------------------------------
# the four parfor scripts through both MLContexts
# --------------------------------------------------------------------------

def _script_cases():
    rng = np.random.default_rng(9)
    n, m = 80, 5
    x = rng.standard_normal((n, m))
    w = np.array([[1.5], [-2.0], [0.0], [0.0], [0.0]])
    y = (rng.random((n, 1)) < 1 / (1 + np.exp(-(x @ w)))).astype(float)
    codes = np.column_stack([rng.integers(1, 4, n), rng.integers(1, 6, n),
                             rng.integers(1, 3, n)]).astype(float)
    xu = np.column_stack([rng.standard_normal(n), codes,
                          rng.standard_normal(n)])
    v = rng.random((20, 15)) * (rng.random((20, 15)) < 0.5)
    xr = np.ceil(rng.random((60, 4)) * 3)
    yr = 1.0 + (xr[:, :1] > 1.5) + (xr[:, 1:2] > 2.5)
    return {
        "StepGLM": ("StepGLM.dml", {"X": x, "y": y}, None, ["B", "sel_order"]),
        "Univar-Stats": ("Univar-Stats.dml",
                         {"X": xu, "K": np.array([[1.0, 2, 2, 2, 1]])},
                         None, ["stats"]),
        "ALS-DS": ("ALS-DS.dml", {"V": v}, {"rank": 3, "maxi": 4},
                   ["L", "R"]),
        "random-forest": ("random-forest.dml", {"X": xr, "Y": yr},
                          {"num_trees": 4, "depth": 3, "bins": 3},
                          ["M"]),
    }


SCRIPT_CASES = _script_cases()


@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("name", sorted(SCRIPT_CASES))
def test_parfor_script_matches_jax(name, optlevel):
    script, inputs, args, outs = SCRIPT_CASES[name]
    got, st, _ = run_script(script, inputs, args, outs, optlevel)
    ref, _, _ = run_script(script, inputs, args, outs, optlevel, port=False)
    for o in outs:
        assert rel(got[o], ref[o]) <= 1e-9, o
    assert any(k.startswith("parfor_") for k in st.estim_counts)
