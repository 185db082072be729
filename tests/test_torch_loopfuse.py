"""Fused loop regions of the port (systemml_tpu_torch/runtime/loopfuse.py)
against the JAX package's (systemml_tpu/runtime/loopfuse.py), on the CPU.

The same DML runs through the JAX package's MLContext and the port's
MLContext(device="cpu"), on numpy-seeded inputs, with `codegen_enabled`
at its default (loop regions on). Compared:

- every LoopRegion field of the two planners (compiler/lower.
  plan_loop_regions), exactly;
- the results, at fp64 1e-9 relative, and against the port with regions
  off (codegen_enabled False) likewise;
- the "Loop regions (planned=..., refused=...; ...)" line of each run's
  statistics, exactly, where both fuse; where the port refuses a region
  at runtime (a shape change, a builtin that reads the host), a test of
  its own asserts the port's reason;
- the lines a region prints (through its device print ring, drained
  after each launch) against the port's eager run's, line for line.

The cases are those of tests/test_loopfuse.py, tests/test_loopfuse_
nested.py and tests/test_loop_regions.py (TestRegionPlanner,
TestFusedEagerEquivalence::test_multilogreg, TestRegionCacheReuse) that
the port's builtins run, and LinearRegCG, MultiLogReg and ALS-CG at a few
rows. On the CPU the region executor runs its plain arm: the peel, the
static buffers, the copy-back, the merge buffers of an if, the cache and
the refusals, the state handling a CUDA graph depends on (the card's
tests are in tests/test_torch_gpu.py).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.lang.parser import parse as jax_parse
from systemml_tpu.runtime import program as JP
from systemml_tpu.runtime.program import compile_program as jax_compile
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu.utils.config import set_config as jax_set_config
from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.lang.parser import parse
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.runtime import loopfuse
from systemml_tpu_torch.runtime import program as P
from systemml_tpu_torch.runtime.program import compile_program
from systemml_tpu_torch.utils.config import DMLConfig, set_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALG = os.path.join(ROOT, "scripts", "algorithms")
BAR = 1e-9
FIELDS = ("label", "carried", "reads", "pred_reads", "drop", "static_names",
          "traced_ints", "pred_mode", "depth", "inner_loops", "donation",
          "refused", "inlined")


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def _script(ctor, src, inputs, outputs, args, from_file):
    s = ctor(os.path.join(ALG, src) if from_file else src)
    for k, v in (inputs or {}).items():
        s.input(k, v)
    for k, v in (args or {}).items():
        s.arg(k, v)
    return s.output(*outputs)


def _port(src, inputs=None, outputs=(), args=None, codegen=True,
          from_file=False, optlevel=2):
    cfg = DMLConfig(device="cpu")
    cfg.codegen_enabled = codegen
    cfg.optlevel = optlevel
    ml = MLContext(cfg)
    lines = []
    ml.printer = lines.append
    with obs.session() as rec:
        res = ml.execute(_script(dmlFromFile if from_file else dml, src,
                                 inputs, outputs, args, from_file))
    events = [e.args for e in rec._events if e.name == "loop_fallback"]
    return res, ml._stats, lines, events


def _jax(src, inputs=None, outputs=(), args=None, from_file=False,
         optlevel=2):
    cfg = JaxConfig()
    cfg.optlevel = optlevel
    cfg.exec_mode = "SINGLE_NODE"
    ml = JaxMLContext(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        res = ml.execute(_script(jax_dml_file if from_file else jax_dml, src,
                                 inputs, outputs, args, from_file))
    return res, ml._stats


def _value(res, name):
    v = res.get(name)
    if hasattr(v, "shape") and np.asarray(v).size > 1 or isinstance(
            v, torch.Tensor):
        return np.asarray(res.get_matrix(name), dtype=np.float64)
    return np.asarray(float(np.asarray(res.get_scalar(name))))


def _close(a, b, bar=BAR):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
    assert float(np.max(np.abs(a - b), initial=0.0)) <= bar * scale, (a, b)


def _regions_line(stats):
    return [ln for ln in stats.display().split("\n")
            if ln.startswith("Loop regions")]


def _plans(prog, P_mod):
    """Every loop block's LoopRegion in walk order (functions after the
    main program, each by name)."""
    out = []

    def walk(blocks):
        for b in blocks:
            if isinstance(b, (P_mod.WhileBlock, P_mod.ForBlock)):
                r = getattr(b, "_region", None)
                if r is not None:
                    out.append(r)
                walk(b.body)
            elif isinstance(b, P_mod.IfBlock):
                walk(b.if_body)
                walk(b.else_body)

    walk(prog.blocks)
    for key in sorted(prog.functions, key=lambda k: (k[0], k[1])):
        walk(prog.functions[key].blocks)
    return out


def _field(r, f):
    v = getattr(r, f)
    if f in ("carried",):
        return tuple(v)
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    return v


def _assert_same_plans(src, input_names=(), outputs=None, from_file=False,
                       clargs=None):
    text = open(os.path.join(ALG, src)).read() if from_file else src
    jax_set_config(JaxConfig())
    jprog = jax_compile(jax_parse(text), clargs=clargs,
                        outputs=outputs, input_names=list(input_names))
    set_config(DMLConfig(device="cpu"))
    try:
        pprog = compile_program(parse(text), clargs=clargs, outputs=outputs,
                                input_names=list(input_names))
    finally:
        set_config(DMLConfig())
    jr, pr = _plans(jprog, JP), _plans(pprog, P)
    assert len(jr) == len(pr) > 0
    for a, b in zip(jr, pr):
        for f in FIELDS:
            assert _field(a, f) == _field(b, f), (f, _field(a, f),
                                                  _field(b, f))
    return pprog


# --------------------------------------------------------------------------
# the scripts (tests/test_loopfuse.py, tests/test_loopfuse_nested.py)
# --------------------------------------------------------------------------

NESTED_WHILE = """
outer = 0
total = 0.0
while (outer < 5) {
  inner = 0
  acc = 0.0
  while (inner < outer + 2) {
    acc = acc + inner + 1
    inner = inner + 1
  }
  total = total + acc
  outer = outer + 1
}
"""

CG = """
beta = matrix(0, rows=8, cols=1)
r = -(t(X) %*% y)
p = -r
norm_r2 = sum(r^2)
i = 0
while (i < 20 & norm_r2 > 1e-12) {
  q = t(X) %*% (X %*% p) + 1e-6 * p
  alpha = norm_r2 / as.scalar(t(p) %*% q)
  beta = beta + alpha * p
  r = r + alpha * q
  old = norm_r2
  norm_r2 = sum(r^2)
  p = -r + (norm_r2 / old) * p
  i = i + 1
}
"""

NEWTON_CG = """
m = ncol(X)
B = matrix(0, rows=m, cols=1)
G = t(X) %*% (X %*% B - y)
gnorm = sqrt(sum(G^2))
outer_i = 0
while (outer_i < 3 & gnorm > 0.000001) {
  D = matrix(0, rows=m, cols=1)
  r = G
  p = -r
  rr = sum(r^2)
  rr0 = rr
  inner_i = 0
  while (inner_i < 20 & rr > 0.0001 * rr0) {
    Hp = t(X) %*% (X %*% p)
    pHp = sum(p * Hp)
    if (pHp <= 0) {
      inner_i = 20
    } else {
      alpha = rr / pHp
      D = D + alpha * p
      r = r + alpha * Hp
      rr_new = sum(r^2)
      p = -r + (rr_new / rr) * p
      rr = rr_new
      inner_i = inner_i + 1
    }
  }
  B = B + D
  G = t(X) %*% (X %*% B - y)
  gnorm = sqrt(sum(G^2))
  outer_i = outer_i + 1
}
"""


def _xy(n=40, m=8):
    rng = np.random.default_rng(17)
    x = rng.random((n, m))
    return {"X": x, "y": x @ rng.random((m, 1))}


def _x(n=8, m=8):
    return {"X": np.random.default_rng(17).random((n, m))}


# name -> (source, inputs, outputs)
CASES = {
    "while_scalar": ("""
i = 0
x = 1.0
while (x < 1000) {
  x = x * 2
  i = i + 1
}
""", None, ["x", "i"]),
    "cg_as_scalar": (CG, _xy(64, 8), ["beta", "i"]),
    "for_matrix": ("""
acc = matrix(0, rows=4, cols=4)
for (i in 1:50) {
  acc = acc + i
}
s = sum(acc)
""", None, ["s"]),
    "for_var_after": ("z = 0\nfor (i in 1:7) { z = z + i }\n", None,
                      ["z", "i"]),
    "zero_trip": ("x = 5\nwhile (x < 0) { x = x - 1 }\n", None, ["x"]),
    "locals_kept": ("""
x = 2
A = matrix(1, rows=2, cols=2)
while (x > 0) {
  L = A + x
  x = x - sum(L)
}
B = sum(L)
""", None, ["B"]),
    "for_in_for": ("""
total = 0
for (outer in 1:3) {
  acc = 0
  for (i in 1:100) {
    acc = acc + i
  }
  total = total + acc
}
""", None, ["total"]),
    "for_cached": ("s = 0\nfor (i in 1:100) { s = s + i * 2 }\nt2 = 0\n",
                   None, ["s"]),
    "int_seed_accumulator": ("""
s = 0
for (i in 1:50) {
  s = s + sum(X) / i
}
""", {"X": np.arange(12.0).reshape(3, 4)}, ["s"]),
    "nested_while": (NESTED_WHILE, None, ["total", "outer"]),
    "device_if": ("""
i = 0
evens = 0
odds = 0
x = 1.0
while (i < 10) {
  h = i - 2 * floor(i / 2)
  if (h == 0) {
    evens = evens + 1
    x = x * 1.5
  } else {
    odds = odds + 1
  }
  i = i + 1
}
""", None, ["evens", "odds", "x"]),
    "static_if": ("""
link = 2
i = 0
s = 0.0
while (i < 8) {
  if (link == 2) {
    s = s + 2
  } else {
    s = s + 100
  }
  i = i + 1
}
""", None, ["s"]),
    "newton_cg": (NEWTON_CG, _xy(), ["B", "gnorm"]),
    "for_in_while": ("""
i = 0
s = 0
while (i < 4) {
  for (j in 1:6) {
    s = s + j
  }
  i = i + 1
}
""", None, ["s", "j"]),
    "while_in_for": ("""
s = 0.0
for (i in 1:5) {
  k = 0
  while (k < i) {
    s = s + 1
    k = k + 1
  }
}
""", None, ["s"]),
    "zero_trip_inner": ("""
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
""", None, ["s"]),
    "matrix_through_if": ("""
A = X
i = 0
while (i < 6) {
  if (sum(A) > 0) {
    A = A - 0.01 * A
  } else {
    A = A + 0.01
  }
  i = i + 1
}
s = sum(A)
""", _x(), ["s"]),
    "double_write": ("""
x = 0
acc = 0
i = 0
while (i <= 3) {
  if (i >= 1) {
    x = 10
    j = 0
    while (j <= 2) { j = j + 1 }
    x = 20
  }
  acc = acc + x
  i = i + 1
}
""", None, ["acc"]),
    "pure_function_loop": ("""
geo = function(double q, int n) return (double s) {
  s = 0.0
  k = 0
  t = 1.0
  while (k < n) {
    s = s + t
    t = t * q
    k = k + 1
  }
}
i = 0
total = 0.0
while (i < 4) {
  total = total + geo(0.5, 10)
  i = i + 1
}
""", None, ["total"]),
    # prints, unseeded rand and minibatch slices (refused by the port's
    # regions before they had a print ring, a device rand stream and
    # slices at a device offset)
    "print": ("""
x = 1.0
while (x < 10) {
  x = x + 1
  print("step " + x)
}
""", None, ["x"]),
    "print_nested": ("""
i = 0
x = 1.0
while (i < 5) {
  x = x * 2
  print("step " + i + " x=" + x)
  i = i + 1
}
""", None, ["x"]),
    # a print in a function the body calls twice: two records an
    # iteration, the loop at top level
    "print_in_function": ("""
report = function(Double x, Integer i) return (Double y) {
  print("i=" + i + " x=" + x)
  y = x + 1
}
i = 0
x = 1.0
while (i < 4) {
  x = report(x, i)
  x = report(x * 2, i)
  i = i + 1
}
""", None, ["x"]),
    "unseeded_rand": ("""
i = 0
s = 0.0
while (i < 4) {
  R = rand(rows=3, cols=3)
  s = s + sum(R >= 0)
  i = i + 1
}
""", None, ["s"]),
    "minibatch_slice": ("""
acc = matrix(0, rows=1, cols=ncol(X))
bs = 8
for (i in 1:4) {
  beg = (i-1)*bs + 1
  Xb = X[beg:(beg+bs-1),]
  acc = acc + colSums(Xb) * i
}
""", {"X": np.random.default_rng(17).normal(size=(32, 6))}, ["acc"]),
    "minibatch_left_index": ("""
R = matrix(0, rows=nrow(X), cols=ncol(X))
bs = 8
for (i in 1:4) {
  beg = (i-1)*bs + 1
  endb = beg + bs - 1
  R[beg:endb,] = X[beg:endb,] * i
}
""", {"X": np.random.default_rng(17).normal(size=(32, 5))}, ["R"]),
}


# the JAX package falls back from these regions at runtime (its outer
# trace meets a name one branch binds first) and runs their inner loops as
# regions of their own; the port runs them as one region
JAX_FALLS_BACK = {"double_write": "while[acc,i,j,...]@0=1"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_region_matches_jax_package(case):
    src, inputs, outs = CASES[case]
    _assert_same_plans(src, input_names=list(inputs or ()), outputs=outs)
    pres, pst, plines, fallbacks = _port(src, inputs, outs)
    jres, jst = _jax(src, inputs, outs)
    eres, _, elines, _ = _port(src, inputs, outs, codegen=False)
    for o in outs:
        _close(_value(pres, o), _value(jres, o))
        _close(_value(pres, o), _value(eres, o))
    assert not fallbacks
    assert plines == elines
    if case in JAX_FALLS_BACK:
        assert _regions_line(pst)[0].endswith(JAX_FALLS_BACK[case])
        assert _regions_line(pst)[0] != _regions_line(jst)[0]
    else:
        assert _regions_line(pst) == _regions_line(jst)


@pytest.mark.parametrize("case", ["for_var_after", "nested_while",
                                  "while_scalar", "device_if"])
def test_host_kinds_leave_as_they_came(case):
    """A carried int stays an int through its 0-d int64 buffer (so that
    print("... " + i) shows 6, not 6.0)."""
    src, inputs, outs = CASES[case]
    pres, _, _, _ = _port(src, inputs, outs)
    eres, _, _, _ = _port(src, inputs, outs, codegen=False)
    for o in outs:
        assert type(pres.get(o)) is type(eres.get(o)), o


def test_zero_trip_binds_nothing():
    """A loop whose entry predicate is false binds none of its locals: a
    later read fails, as in the reference (the JAX package drops its zero
    seeds likewise)."""
    src = """
x = 5
A = matrix(1, rows=2, cols=2)
while (x < 0) {
  L = A + x
  x = x - sum(L)
}
B = L + 1
"""
    with pytest.raises(Exception):
        _port(src, outputs=["B"])


def test_zero_trip_inner_loop_local_holds_zeros():
    """A name first bound inside an inner loop and read after it holds
    zeros when that loop runs no iteration in a later outer pass: the
    JAX package's documented deviation (its loopfuse.py:34-39), which the
    port's zero-filled inner buffers share."""
    src = """
i = 0
s = 0
while (i < 3) {
  k = i
  while (k < 1) {
    t = k + 5
    k = k + 1
  }
  s = s + t
  i = i + 1
}
"""
    pres, _, _, _ = _port(src, outputs=["s"])
    jres, _ = _jax(src, outputs=["s"])
    _close(_value(pres, "s"), _value(jres, "s"))


# --------------------------------------------------------------------------
# what the port's regions refuse, each by its reason
# --------------------------------------------------------------------------

REFUSED = {
    # name -> (source, inputs, outputs, reason)
    "shape_change": ("""
A = matrix(1, rows=3, cols=1)
B = matrix(2, rows=3, cols=1)
for (i in 1:4) {
  A = cbind(A, B * i)
}
nc = ncol(A)
""", None, ["nc", "A"], "shape change"),
    # prints the ring cannot take: a matrix, a print inside an inner loop
    "print_matrix": ("""
A = matrix(1, rows=2, cols=2)
i = 0
while (i < 3) {
  A = A * 2
  print(A)
  i = i + 1
}
""", None, ["A"], "print matrix: a print of a matrix"),
    "print_in_inner_loop": ("""
i = 0
s = 0
while (i < 3) {
  j = 0
  while (j < 2) {
    print("i " + i + " j " + j)
    j = j + 1
  }
  s = s + i
  i = i + 1
}
""", None, ["s"], "print in inner loop"),
    "print_in_function_in_inner_loop": ("""
report = function(Integer i, Integer j) return (Integer k) {
  print("i " + i + " j " + j)
  k = i + j
}
i = 0
s = 0
while (i < 3) {
  j = 0
  while (j < 2) {
    k = report(i, j)
    j = j + 1
  }
  s = s + i + k
  i = i + 1
}
""", None, ["s"], "print in inner loop"),
    # the breadth builtins that read the host: refused before the peel
    "removeEmpty": ("""
s = 0.0
i = 0
while (i < 4) {
  Z = removeEmpty(target=X * (X > i / 4), margin="rows")
  s = s + sum(Z) + nrow(Z)
  i = i + 1
}
""", {"X": np.random.default_rng(17).random((12, 3))}, ["s"],
                    "removeEmpty"),
    "table_without_dims": ("""
s = 0.0
i = 0
while (i < 4) {
  T = table(ceil(X[, 1] * 3) + i, ceil(X[, 2] * 2))
  s = s + sum(T * T) + ncol(T)
  i = i + 1
}
""", {"X": np.random.default_rng(17).random((20, 2))}, ["s"],
                           "table without dims"),
    "host_distribution": ("""
s = 0.0
i = 0
while (i < 4) {
  s = s + qt(0.9 - i / 10, 5) + pnorm(s / 10)
  i = i + 1
}
""", None, ["s"], "host distribution"),
    "device_bound": ("""
s = 0.0
i = 0
while (i < 4) {
  v = seq(1, as.scalar(colSums(X > 0.5)))
  s = s + sum(v) * i
  i = i + 1
}
""", {"X": np.random.default_rng(17).random((20, 1))}, ["s"],
                     "device bound: seq"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_with_reason_result_matches(case):
    src, inputs, outs, reason = REFUSED[case]
    _assert_same_plans(src, input_names=list(inputs or ()), outputs=outs)
    pres, pst, plines, fallbacks = _port(src, inputs, outs)
    jres, _ = _jax(src, inputs, outs)
    eres, _, elines, _ = _port(src, inputs, outs, codegen=False)
    for o in outs:
        _close(_value(pres, o), _value(jres, o))
        _close(_value(pres, o), _value(eres, o))
    assert plines == elines
    assert [f["reason"] for f in fallbacks] == [reason]
    assert pst.estim_counts.get("loop_regions_refused", 0) == 1


def test_glm_plans_match_and_its_builtins_wait():
    """GLM: the two planners agree, and the port runs the script (its
    builtins, solve and the distributions, are ported): the IRLS loop is
    one region, its result within 1e-9 of the JAX package's and of the
    port's eager run."""
    clargs = {"moi": 6, "tol": 0.0, "dfam": 1, "vpow": 0.0, "link": 1,
              "lpow": 0.0}
    _assert_same_plans("GLM.dml", from_file=True,
                       input_names=["X", "y"], outputs=["beta"],
                       clargs=clargs)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((64, 4))
    yv = np.abs(x @ rng.standard_normal((4, 1))) + 0.1
    pres, pst, plines, fallbacks = _port("GLM.dml", {"X": x, "y": yv},
                                         ["beta"], clargs, from_file=True)
    eres, _, elines, _ = _port("GLM.dml", {"X": x, "y": yv}, ["beta"],
                               clargs, codegen=False, from_file=True)
    jres, _ = _jax("GLM.dml", {"X": x, "y": yv}, ["beta"], clargs,
                   from_file=True)
    _close(_value(pres, "beta"), _value(jres, "beta"))
    _close(_value(pres, "beta"), _value(eres, "beta"))
    assert fallbacks == [] and len(plines) == len(elines)
    assert _regions_line(pst) == [
        "Loop regions (planned=1, refused=0; region=dispatches): "
        "while[beta,converged,deviance_old,...]@0=1"]


def test_kmeans_plans_match_and_its_loop_is_a_region():
    """Kmeans: the two planners agree, and the port runs its while loop
    (rowIndexMax, rowMins, rexpand of the cluster ids) as a region; the
    centroids within 1e-9 of the JAX package's and of the port's eager
    run. The outer for over the runs is refused in its peel: sample()'s
    seed, seed + run, is a device value there ("device bound"); each run
    after the peeled first one enters the while's own region."""
    rng = np.random.default_rng(17)
    x = np.concatenate([rng.standard_normal((20, 3)) + c
                        for c in (0.0, 5.0, -5.0)])
    args = {"k": 3, "runs": 3, "maxi": 8, "samp": 0}
    _assert_same_plans("Kmeans.dml", from_file=True, input_names=["X"],
                       outputs=["C_out"], clargs=args)
    pres, pst, _, fallbacks = _port("Kmeans.dml", {"X": x}, ["C_out"], args,
                                    from_file=True)
    eres, _, _, _ = _port("Kmeans.dml", {"X": x}, ["C_out"], args,
                          codegen=False, from_file=True)
    jres, _ = _jax("Kmeans.dml", {"X": x}, ["C_out"], args, from_file=True)
    _close(_value(pres, "C_out"), _value(jres, "C_out"))
    _close(_value(pres, "C_out"), _value(eres, "C_out"))
    assert [f["reason"] for f in fallbacks] == ["device bound: sample"]
    assert _regions_line(pst) == [
        "Loop regions (planned=1, refused=1; region=dispatches): "
        "while[C,delta,iter,...]=2"]


def test_line_search_outer_refused_inner_regions():
    """l2-svm: the outer loop prints, which refused it before the print
    ring; now the whole nest, the line search inside, is one region
    entered once, its lines those of the eager run in order."""
    rng = np.random.default_rng(17)
    x = rng.random((30, 4))
    y = np.sign(x @ rng.random((4, 1)) - 1.0)
    y[y == 0] = 1.0
    args = {"maxiter": 10}
    pres, pst, plines, fallbacks = _port("l2-svm.dml", {"X": x, "Y": y},
                                         ["w"], args, from_file=True)
    eres, _, elines, _ = _port("l2-svm.dml", {"X": x, "Y": y}, ["w"], args,
                               codegen=False, from_file=True)
    jres, jst = _jax("l2-svm.dml", {"X": x, "Y": y}, ["w"], args,
                     from_file=True)
    _close(_value(pres, "w"), _value(eres, "w"))
    _close(_value(pres, "w"), _value(jres, "w"))
    assert plines == elines and len(elines) >= 3
    assert all(ln.startswith("l2-svm: iter ") for ln in elines)
    assert fallbacks == []
    assert [k[-2:] for k in pst.region_counts] == ["@0"]
    assert sum(pst.region_counts.values()) == 1
    assert _regions_line(pst) == _regions_line(jst)


# --------------------------------------------------------------------------
# tests/test_loop_regions.py: TestRegionPlanner
# --------------------------------------------------------------------------

PLANNER_NESTED = """
w = matrix(0, rows=8, cols=1)
outer = 0
while (outer < 5) {
  g = t(X) %*% (X %*% w) + w
  p = -g
  rr = sum(g^2)
  inner = 0
  while (inner < 3) {
    q = t(X) %*% (X %*% p)
    alpha = rr / as.scalar(t(p) %*% q)
    w = w + alpha * p
    rr_new = sum((g + alpha * q)^2)
    p = -g + (rr_new / rr) * p
    inner = inner + 1
  }
  outer = outer + 1
}
s = sum(w)
"""

LOG_ACC = """
log_str = ""
s = 0.0
i = 0
while (i < 3) {
  s = s + i
  log_str = log_str + "OBJECTIVE," + i + "," + s + "\\n"
  i = i + 1
}
fileLog = ifdef($Log, "")
if (fileLog != "") {
  write(log_str, $Log)
}
print(s)
"""


def test_planner_nested_while_one_outer_region():
    prog = _assert_same_plans(PLANNER_NESTED, input_names=["X"],
                              outputs=["s"])
    loops = [b for b in prog.blocks if isinstance(b, P.WhileBlock)]
    assert len(loops) == 1
    region = loops[0]._region
    assert region.refused is None and region.kind == "while"
    assert region.pred_mode == "device"
    assert region.depth == 2 and region.inner_loops == 1
    assert "w" in region.carried and "X" in region.reads
    inner = [b for b in loops[0].body if isinstance(b, P.WhileBlock)]
    assert inner and inner[0]._region.inlined
    assert inner[0]._region_parent is region
    assert region.donation["w"] == "live"


@pytest.mark.parametrize("outputs", [(), None])
def test_planner_dead_string_accumulator(outputs):
    """With no declared outputs (the CLI) the log accumulator is dropped;
    with every top-level write exit-live it rides the carried set."""
    prog = _assert_same_plans(LOG_ACC, outputs=outputs)
    region = [b for b in prog.blocks if isinstance(b, P.WhileBlock)][0]._region
    if outputs == ():
        assert "log_str" in region.drop and "log_str" not in region.carried
    else:
        assert "log_str" in region.carried


def test_dropped_string_accumulator_runs_in_region():
    """A dropped accumulator is not evaluated inside the region (its
    concatenation would read device scalars on the host)."""
    src = LOG_ACC.replace("print(s)\n", "")
    cfg = DMLConfig(device="cpu")
    set_config(cfg)
    try:
        prog = compile_program(parse(src), outputs=())
        ec = prog.execute()
    finally:
        set_config(DMLConfig())
    assert ec.vars["s"] == 3.0
    fl = [b for b in prog.blocks if isinstance(b, P.WhileBlock)][0]._fused_loop
    assert fl.refused is None and fl.record["trips"] == [3]


def test_region_counts_surface_in_stats():
    x = np.random.default_rng(17).standard_normal((32, 8))
    src = """
s = 0.0
i = 0
while (i < 4) {
  s = s + sum(X) / 100
  i = i + 1
}
"""
    _, st, _, _ = _port(src, {"X": x}, ["s"])
    _, jst = _jax(src, {"X": x}, ["s"])
    assert st.estim_counts.get("loop_regions", 0) == 1
    assert sum(st.region_counts.values()) == 1
    assert "Loop regions" in st.display()
    assert _regions_line(st) == _regions_line(jst)


# --------------------------------------------------------------------------
# tests/test_loop_regions.py: TestRegionCacheReuse
# --------------------------------------------------------------------------

CACHE_LOOP = """
w = matrix(0, rows=ncol(X), cols=1)
i = 0
while (i < maxiter) {
  w = w + 0.001 * (t(X) %*% (X %*% w + 1))
  i = i + 1
}
r = sum(w)
"""


def test_reentry_with_another_maxiter_reuses_the_entry():
    """One compiled program run three times: the X of the first run, a new
    X, another maxiter, then the first inputs again. The loop's entry is
    cached on the address of X and passes maxiter as a value: the third
    run hits the first run's entry and skips its peel, bit for bit."""
    rng = np.random.default_rng(17)
    set_config(DMLConfig(device="cpu"))
    try:
        prog = compile_program(parse(CACHE_LOOP),
                               input_names=["X", "maxiter"],
                               outputs=["r"])
        x = torch.from_numpy(rng.standard_normal((20, 4)))
        r5 = prog.execute({"X": x, "maxiter": 5}).vars["r"]
        prog.execute({"X": torch.from_numpy(rng.standard_normal((20, 4))),
                      "maxiter": 9})
        ec = prog.execute({"X": x, "maxiter": 5})
    finally:
        set_config(DMLConfig())
    fl = [b for b in prog.blocks if isinstance(b, P.WhileBlock)][0]._fused_loop
    assert len(fl._cache) == 2           # two X addresses, one per entry
    assert fl.record["trips"] == [5, 9, 5]
    assert torch.equal(ec.vars["r"], r5)
    ref, _, _, _ = _port(CACHE_LOOP, {"X": x.numpy(), "maxiter": 5}, ["r"],
                         codegen=False)
    _close(float(r5), _value(ref, "r"))


def test_planner_marks_value_position_ints_traced():
    prog = _assert_same_plans(CACHE_LOOP, input_names=["X", "maxiter"])
    region = next(r for r in _plans(prog, P) if r.refused is None)
    assert "maxiter" in region.traced_ints


def test_shape_feeding_ints_stay_static():
    src = """
acc = 0
i = 0
while (i < maxiter) {
  Z = matrix(1, rows=k, cols=k)
  acc = acc + sum(Z) + i
  i = i + 1
}
"""
    prog = _assert_same_plans(src, input_names=["maxiter", "k"])
    region = _plans(prog, P)[0]
    assert "maxiter" in region.traced_ints and "k" not in region.traced_ints
    res, _, _, fallbacks = _port(src, {"maxiter": 3, "k": 2}, ["acc"])
    assert not fallbacks
    assert res.get_scalar("acc") == 3 * 4 + 3


def test_slice_bound_ints_refused_as_static_names():
    """The minibatch pattern plans as a region in both packages and, with
    its slice at a device offset (static extent), runs as one in the
    port; a loop-varying name that sizes a matrix is still refused as
    static_names, and a slice bound without a static extent (mnist_
    softmax's `end = min(N, beg + bs - 1)`) as "slice bound"."""
    src = """
acc = matrix(0, rows=1, cols=ncol(X))
i = 0
while (i < maxiter) {
  beg = i * bs + 1
  B = X[beg:beg+bs-1,]
  acc = acc + colSums(B)
  i = i + 1
}
r = sum(acc)
"""
    prog = _assert_same_plans(src, input_names=["X", "maxiter", "bs"])
    assert _plans(prog, P)[0].refused is None
    x = np.random.default_rng(17).standard_normal((12, 4))
    res, st, _, fallbacks = _port(src, {"X": x, "maxiter": 3, "bs": 4},
                                  ["r"])
    assert abs(float(res.get_scalar("r")) - x.sum()) < 1e-9
    assert fallbacks == [] and sum(st.region_counts.values()) == 1
    sized = src.replace("B = X[beg:beg+bs-1,]",
                        "B = matrix(1, rows=i + 1, cols=ncol(X))")
    res, _, _, fallbacks = _port(sized, {"X": x, "maxiter": 3, "bs": 4},
                                 ["r"])
    assert float(res.get_scalar("r")) == 6 * 4
    assert [f["reason"] for f in fallbacks] == ["static_names"]
    clipped = src.replace("B = X[beg:beg+bs-1,]",
                          "B = X[beg:min(nrow(X), beg+bs-1),]")
    res, _, _, fallbacks = _port(clipped, {"X": x, "maxiter": 3, "bs": 4},
                                 ["r"])
    assert abs(float(res.get_scalar("r")) - x.sum()) < 1e-9
    assert [f["reason"] for f in fallbacks] == ["static_names"]
    # a device bound the scan cannot see (a loop invariant held on the
    # device): refused in the first iteration
    dev_bound = src.replace("acc = matrix", "top = sum(X[, 1] > -1000)\n"
                            "acc = matrix").replace(
        "B = X[beg:beg+bs-1,]", "B = X[1:top,] * (i == 0)")
    res, _, _, fallbacks = _port(dev_bound, {"X": x, "maxiter": 3, "bs": 4},
                                 ["r"])
    assert abs(float(res.get_scalar("r")) - x.sum()) < 1e-9
    assert [f["reason"].split(":")[0] for f in fallbacks] == ["slice bound"]


# --------------------------------------------------------------------------
# the algorithms at a few rows
# --------------------------------------------------------------------------

def _alg_data(seed=17, n=120, m=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m))
    z = x @ rng.standard_normal((m, 1)) + 0.1 * rng.standard_normal((n, 1))
    labels = 1.0 + (np.argsort(np.argsort(z[:, 0])) * 3) // n
    v = np.where(rng.random((40, 30)) < 0.3,
                 np.round(rng.random((40, 30)) * 9) / 2 + 0.5, 0.0)
    return {"lin": {"X": x, "y": x @ rng.standard_normal((m, 1))},
            "mlr": {"X": x, "Y_vec": labels.reshape(-1, 1)},
            "als": {"V": v}}


ALGS = {
    "LinearRegCG": ("LinearRegCG.dml", "lin",
                    {"maxi": 20, "tol": 1e-9, "reg": 1e-6}, "beta"),
    "MultiLogReg": ("MultiLogReg.dml", "mlr", {"moi": 10}, "B"),
    "ALS-CG": ("ALS-CG.dml", "als",
               {"rank": 3, "reg": 0.01, "maxi": 5, "mii": 3}, "L"),
}


@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("name", sorted(ALGS))
def test_algorithm_in_one_region(name, optlevel):
    script, key, args, out = ALGS[name]
    data = _alg_data()[key]
    pres, pst, plines, fallbacks = _port(script, data, [out], args,
                                         from_file=True, optlevel=optlevel)
    eres, _, elines, _ = _port(script, data, [out], args, codegen=False,
                               from_file=True, optlevel=optlevel)
    jres, _ = _jax(script, data, [out], args, from_file=True,
                   optlevel=optlevel)
    _close(_value(pres, out), _value(eres, out))
    _close(_value(pres, out), _value(jres, out), 1e-8)
    assert plines == elines
    assert not fallbacks
    assert pst.estim_counts.get("loop_regions_refused", 0) == 0
    # the outer loop is one region entered once
    assert sum(v for k, v in pst.region_counts.items()
               if k.endswith("@0")) == 1


def test_multilogreg_matches_jax_package_fused():
    """tests/test_loop_regions.py::TestFusedEagerEquivalence::
    test_multilogreg, on the port."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((256, 16))
    y = 1.0 + (rng.random((256, 1)) < 0.5)
    args = {"moi": 6, "mii": 4, "tol": 0.0, "reg": 1e-3}
    pres, pst, _, fallbacks = _port("MultiLogReg.dml", {"X": x, "Y_vec": y},
                                    ["B"], args, from_file=True)
    jres, _ = _jax("MultiLogReg.dml", {"X": x, "Y_vec": y}, ["B"], args,
                   from_file=True)
    eres, _, _, _ = _port("MultiLogReg.dml", {"X": x, "Y_vec": y}, ["B"],
                          args, codegen=False, from_file=True)
    _close(_value(pres, "B"), _value(jres, "B"))
    _close(_value(pres, "B"), _value(eres, "B"))
    assert not fallbacks and sum(pst.region_counts.values()) >= 1


@pytest.mark.parametrize("name", sorted(ALGS))
def test_algorithm_plans_match(name):
    script, key, args, out = ALGS[name]
    _assert_same_plans(script, from_file=True,
                       input_names=list(_alg_data()[key]), outputs=[out],
                       clargs=args)


def _cla_run(src, inputs, outputs, args=None, codegen=True,
             from_file=True):
    cfg = DMLConfig(device="cpu")
    cfg.cla = "true"
    cfg.codegen_enabled = codegen
    ml = MLContext(cfg)
    lines = []
    ml.printer = lines.append
    with obs.session() as rec:
        r = ml.execute(_script(dmlFromFile if from_file else dml, src,
                               inputs, outputs, args, from_file))
    fall = [e.args for e in rec._events if e.name == "loop_fallback"]
    return r, ml._stats, lines, fall


def test_compressed_operand_refused():
    """A compressed X read in a region: its left mult, right mult and
    mmchain read nothing on the host, so LinearRegCG with cla "true" runs
    its CG loop as one region, equal to its eager run; an op on X that
    the host computes (its decompression, for a product by a device
    scalar) refuses the region
    in its first iteration, by that op's name."""
    rng = np.random.default_rng(17)
    x = rng.integers(0, 3, (300, 4)).astype(float)
    y = x @ rng.standard_normal((4, 1))
    args = {"maxi": 20, "tol": 1e-9, "reg": 1e-6}
    pres, pst, _, fallbacks = _cla_run("LinearRegCG.dml", {"X": x, "y": y},
                                       ["beta"], args)
    eres, _, _, _ = _cla_run("LinearRegCG.dml", {"X": x, "y": y}, ["beta"],
                             args, codegen=False)
    _close(_value(pres, "beta"), _value(eres, "beta"))
    assert fallbacks == [] and pst.estim_counts["cla_auto_compressed"] == 1
    assert sum(pst.region_counts.values()) == 1
    src = """
Xc = compress(X)
v = matrix(1, rows=ncol(X), cols=1)
s = 0.0
i = 0
while (i < 4) {
  q = Xc %*% v
  s = s + sum(q * q) + sum(colSums(Xc * i))
  v = v * 0.5
  i = i + 1
}
"""
    pres, _, _, fallbacks = _cla_run(src, {"X": x}, ["s"], from_file=False)
    eres, _, _, _ = _cla_run(src, {"X": x}, ["s"], codegen=False,
                             from_file=False)
    _close(_value(pres, "s"), _value(eres, "s"))
    assert [f["reason"] for f in fallbacks] == [
        "compressed host op: decompress"]


# --------------------------------------------------------------------------
# the region executor's own parts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op,a,b", [
    ("+", 7, 3), ("-", 7, 3), ("*", 7, 3), ("/", 7, 2), ("^", 2, 10),
    ("%%", -7, 3), ("%/%", -7, 3), ("min", 7, 3), ("max", 7, 3),
    ("<", 7, 3), ("==", 3, 3), ("&", True, False), ("|", True, False),
    ("+", 7, 0.5), ("*", True, 3)])
def test_int_scalar_semantics_inside_a_region(op, a, b):
    """DML's scalar semantics on 0-d int64 and bool tensors inside a
    region equal the host path's (hops/rewrite._apply_scalar_binary)."""
    from systemml_tpu_torch.compiler.lower import (_region_binary,
                                                   region_scope)
    from systemml_tpu_torch.hops.rewrite import _apply_scalar_binary

    set_config(DMLConfig(device="cpu"))
    try:
        with region_scope(loopfuse.RegionRun("plain")):
            got = _region_binary(op, loopfuse.device_scalar(a, "cpu"), b)
    finally:
        set_config(DMLConfig())
    want = _apply_scalar_binary(op, a, b)
    assert got.ndim == 0
    if isinstance(want, bool):
        assert got.dtype == torch.bool and bool(got) == want
    elif isinstance(want, int):
        assert got.dtype == torch.int64 and int(got) == want
    else:
        assert got.is_floating_point() and float(got) == want


def test_writeback_copies_a_value_aliasing_an_overwritten_buffer():
    """`a = b; b = c` in one body: a's new value is b's buffer, which the
    same write-back overwrites; it is copied first."""
    bufs = {"a": torch.zeros(2), "b": torch.ones(2)}
    env = {"a": bufs["b"], "b": torch.full((2,), 5.0)}
    loopfuse._writeback(bufs, env, ["a", "b"], "cpu")
    assert bufs["a"].tolist() == [1.0, 1.0]
    assert bufs["b"].tolist() == [5.0, 5.0]
    assert env["a"] is bufs["a"] and env["b"] is bufs["b"]


@pytest.mark.parametrize("buf,val,ok", [
    (torch.zeros(()), 3, True), (torch.zeros((), dtype=torch.int64), 3, True),
    (torch.zeros((), dtype=torch.int64), 2.5, False),
    (torch.zeros((), dtype=torch.bool), True, True),
    (torch.zeros((), dtype=torch.bool), 1, False),
    (torch.zeros(2, 1), torch.ones(2, 1), True),
    (torch.zeros(2, 1), torch.ones(3, 1), False),
    (torch.zeros(2, 1, dtype=torch.float64), torch.ones(2, 1), False),
    (torch.zeros(()), torch.ones((), dtype=torch.float32), True),
])
def test_static_buffer_takes_only_what_it_can_hold(buf, val, ok):
    if ok:
        loopfuse._store(buf, val, "v")
        assert float(buf.reshape(-1)[0]) == float(
            val if not isinstance(val, torch.Tensor) else val.reshape(-1)[0])
    else:
        with pytest.raises(Exception, match="shape change"):
            loopfuse._store(buf, val, "v")


def test_launch_accounting_scales_each_body():
    """The counter deltas a body added at its one capture, scaled by its
    executions (the graph arm's accounting, here on Statistics alone)."""
    from systemml_tpu_torch.utils.stats import Statistics

    st = Statistics()
    st.count_estim("spoof_flat_walk", 2)
    before = loopfuse._snapshot(st)
    st.count_estim("spoof_flat_walk", 3)
    st.count_block()
    delta = loopfuse._delta(loopfuse._snapshot(st), before)
    assert delta == {("e", "spoof_flat_walk"): 3, ("b",): 1}
    loopfuse._apply(st, delta, 4)
    assert st.estim_counts["spoof_flat_walk"] == 2 + 3 * 5
    assert st.eager_blocks == 5


# --------------------------------------------------------------------------
# prints through the ring, rand streams on the device, slices at a device
# offset: tests/test_loopfuse.py:182-292 (TestMinibatchLoopFusion) and
# tests/test_loopfuse_nested.py:145,259, ported, and the port's own
# --------------------------------------------------------------------------

def _one_region(st, fallbacks):
    assert fallbacks == []
    assert sum(st.region_counts.values()) == 1


def test_dynamic_slice_loop_fuses_and_matches():
    src, inputs, outs = CASES["minibatch_slice"]
    res, st, _, fallbacks = _port(src, inputs, outs)
    _one_region(st, fallbacks)
    x = inputs["X"]
    expect = sum(x[i * 8:(i + 1) * 8].sum(0) * (i + 1) for i in range(4))
    _close(_value(res, "acc").ravel(), expect)


def test_dynamic_left_index_loop():
    src, inputs, outs = CASES["minibatch_left_index"]
    res, st, _, fallbacks = _port(src, inputs, outs)
    _one_region(st, fallbacks)
    x = inputs["X"]
    expect = np.concatenate([x[i * 8:(i + 1) * 8] * (i + 1)
                             for i in range(4)])
    _close(_value(res, "R"), expect)


def test_training_loop_fuses_with_pure_fns():
    """A minibatch SGD loop calling a pure function is one region, equal to
    the JAX package's fused loop and to the port's eager run."""
    rng = np.random.default_rng(17)
    inputs = {"X": rng.normal(size=(32, 4)), "Y": rng.normal(size=(32, 1))}
    src = """
f = function(matrix[double] A, matrix[double] W)
    return (matrix[double] o) { o = A %*% W }
W = matrix(0.1, rows=ncol(X), cols=1)
bs = 8
iters = floor(nrow(X) / bs)
for (i in 1:iters) {
  beg = (i-1)*bs + 1
  Xb = X[beg:(beg+bs-1),]
  Yb = Y[beg:(beg+bs-1),]
  pred = f(Xb, W)
  g = t(Xb) %*% (pred - Yb) / bs
  W = W - 0.1 * g
}
"""
    pres, st, _, fallbacks = _port(src, inputs, ["W"])
    _one_region(st, fallbacks)
    jres, jst = _jax(src, inputs, ["W"])
    eres, _, _, _ = _port(src, inputs, ["W"], codegen=False)
    _close(_value(pres, "W"), _value(jres, "W"))
    _close(_value(pres, "W"), _value(eres, "W"))
    assert _regions_line(st) == _regions_line(jst)


def _seeded(seed, fn):
    from systemml_tpu.ops import datagen as jax_datagen
    from systemml_tpu_torch.ops import datagen

    datagen.set_global_seed(seed)
    jax_datagen.set_global_seed(seed)
    try:
        return fn()
    finally:
        datagen.set_global_seed(None)
        jax_datagen.set_global_seed(None)


RAND_ORDER = """
S = matrix(0, rows=2, cols=2)
for (i in 1:4) {
  A = rand(rows=2, cols=2)
  C = rand(rows=2, cols=2)
  B = rand(rows=2, cols=2)
  S = S + A * i + 10 * B - C
}
"""


def test_rand_order_reproducible_across_paths():
    """The same global seed gives the same draws whether the loop runs as a
    region or eagerly (the JAX package's test draws pdf "normal", which
    waits for queue 1 item 8; here uniform), iteration after iteration,
    and the JAX package's eager draws."""
    pres, st, _, fallbacks = _seeded(11, lambda: _port(RAND_ORDER,
                                                       outputs=["S", "B"]))
    _one_region(st, fallbacks)
    eres, _, _, _ = _seeded(11, lambda: _port(RAND_ORDER, outputs=["S", "B"],
                                              codegen=False))
    jcfg = JaxConfig()
    jcfg.exec_mode = "SINGLE_NODE"
    jcfg.codegen_enabled = False
    jres = _seeded(11, lambda: JaxMLContext(jcfg).execute(
        jax_dml(RAND_ORDER).output("S", "B")))
    for o in ("S", "B"):
        assert np.array_equal(_value(pres, o), _value(eres, o))
        assert np.array_equal(_value(pres, o), _value(jres, o))


def test_unseeded_rand_draws_per_iteration_unlike_jax_fused_loop():
    """Under a global seed an unseeded rand in a region draws a new key per
    iteration from the device stream, the keys the eager loop (and the
    JAX package's eager loop) draws. The JAX package's fused loop takes
    its key once, at trace time, and repeats one matrix: A = 10 R there
    (ROADMAP queue 3, a reference defect the port does not copy)."""
    src = """
A = matrix(0, rows=3, cols=3)
i = 0
while (i < 4) {
  R = rand(rows=3, cols=3)
  A = A + R * (i + 1)
  i = i + 1
}
"""
    pres, st, _, fallbacks = _seeded(11, lambda: _port(src, outputs=["A",
                                                                     "R"]))
    _one_region(st, fallbacks)
    eres, _, _, _ = _seeded(11, lambda: _port(src, outputs=["A", "R"],
                                              codegen=False))
    jcfg = JaxConfig()
    jcfg.exec_mode = "SINGLE_NODE"
    jcfg.codegen_enabled = False
    jres = _seeded(11, lambda: JaxMLContext(jcfg).execute(
        jax_dml(src).output("A", "R")))
    jfused, _ = _seeded(11, lambda: _jax(src, outputs=["A", "R"]))
    for o in ("A", "R"):
        assert np.array_equal(_value(pres, o), _value(eres, o))
        assert np.array_equal(_value(pres, o), _value(jres, o))
    _close(_value(jfused, "A"), 10 * _value(jfused, "R"))
    assert not np.allclose(_value(pres, "A"), 10 * _value(pres, "R"))


def test_loop_varying_seed_bit_identical_to_jax_eager():
    """rand(seed=42 + i) in a for region: each iteration's key derived on
    the device from the loop variable; the draws, written at a device
    offset, equal the JAX package's eager draws bit for bit."""
    src = """
D = matrix(0, rows=20, cols=3)
for (i in 1:5) {
  beg = (i-1)*4 + 1
  D[beg:(beg+3),] = rand(rows=4, cols=3, min=-1, max=2, sparsity=0.7,
                         seed=42 + i)
}
"""
    pres, st, _, fallbacks = _port(src, outputs=["D"])
    _one_region(st, fallbacks)
    eres, _, _, _ = _port(src, outputs=["D"], codegen=False)
    jcfg = JaxConfig()
    jcfg.exec_mode = "SINGLE_NODE"
    jcfg.codegen_enabled = False
    jres = JaxMLContext(jcfg).execute(jax_dml(src).output("D"))
    d = _value(pres, "D")
    assert np.array_equal(d, _value(eres, "D"))
    assert np.array_equal(d, _value(jres, "D"))
    assert len({d[r].tobytes() for r in range(0, 20, 4)}) == 5


def test_dynamic_slice_start_clamps():
    """A slice at a device offset whose start would pass the end clamps as
    lax.dynamic_slice does (ROADMAP queue 3, mirrored on purpose): the
    region equals the JAX package's fused loop. Eagerly both packages cut
    the slice short at the end instead, and agree."""
    x = np.random.default_rng(17).normal(size=(32, 3))
    src = """
acc = matrix(0, rows=1, cols=ncol(X))
for (i in 1:4) {
  beg = i * 10
  Xb = X[beg:(beg+7),]
  acc = acc + colSums(Xb) * i
}
"""
    pres, st, _, fallbacks = _port(src, {"X": x}, ["acc"])
    _one_region(st, fallbacks)
    jres, _ = _jax(src, {"X": x}, ["acc"])
    _close(_value(pres, "acc"), _value(jres, "acc"))
    expect = sum(x[min(b - 1, 24):min(b - 1, 24) + 8].sum(0) * i
                 for i, b in ((i, i * 10) for i in range(1, 5)))
    _close(_value(pres, "acc").ravel(), expect)
    eres, _, _, _ = _port(src, {"X": x}, ["acc"], codegen=False)
    jcfg = JaxConfig()
    jcfg.exec_mode = "SINGLE_NODE"
    jcfg.codegen_enabled = False
    jeager = JaxMLContext(jcfg).execute(
        jax_dml(src).input("X", x).output("acc"))
    _close(_value(eres, "acc"), _value(jeager, "acc"))
    assert not np.allclose(_value(eres, "acc"), _value(pres, "acc"))


LINE_SEARCH = """
n = nrow(X)
m = ncol(X)
reg = 1.0
w = matrix(0, rows=m, cols=1)
Xw = matrix(0, rows=n, cols=1)
g_old = t(X) %*% Y
s = g_old
iter = 0
continue = 1
while (continue == 1 & iter < 10) {
  step_sz = 0
  Xd = X %*% s
  wd = reg * sum(w * s)
  dd = reg * sum(s * s)
  cont_ls = 1
  inner = 0
  while (cont_ls == 1 & inner < 100) {
    tmp_Xw = Xw + step_sz * Xd
    out = 1 - Y * tmp_Xw
    sv = (out > 0)
    out = out * sv
    g = wd + step_sz * dd - sum(out * Y * Xd)
    h = dd + sum(Xd * sv * Xd)
    step_sz = step_sz - g / h
    if (g * g / h < 0.0000000001) {
      cont_ls = 0
    }
    inner = inner + 1
  }
  w = w + step_sz * s
  Xw = Xw + step_sz * Xd
  out = 1 - Y * Xw
  sv = (out > 0)
  out = sv * out
  obj = 0.5 * sum(out * out) + reg / 2 * sum(w * w)
  g_new = t(X) %*% (out * Y) - reg * w
  print("iter " + iter + ", obj = " + obj)
  tmp = sum(s * g_old)
  if (step_sz * tmp < 0.000000001 * obj) {
    continue = 0
  }
  be = sum(g_new * g_new) / sum(g_old * g_old)
  s = be * s + g_new
  g_old = g_new
  iter = iter + 1
}
"""


def test_line_search_pattern():
    """l2-svm's shape (outer CG, inner line search, a print): one region,
    w and obj equal to the JAX package's fused loop, the lines equal to
    the eager run's."""
    rng = np.random.default_rng(17)
    x = np.asarray(rng.random((30, 4)))
    y = np.sign(x @ rng.random((4, 1)) - 1.0)
    y[y == 0] = 1.0
    pres, st, plines, fallbacks = _port(LINE_SEARCH, {"X": x, "Y": y},
                                        ["w", "obj"])
    _one_region(st, fallbacks)
    jres, jst = _jax(LINE_SEARCH, {"X": x, "Y": y}, ["w", "obj"])
    eres, _, elines, _ = _port(LINE_SEARCH, {"X": x, "Y": y}, ["w", "obj"],
                               codegen=False)
    for o in ("w", "obj"):
        _close(_value(pres, o), _value(jres, o))
        _close(_value(pres, o), _value(eres, o))
    assert plines == elines and len(plines) >= 2
    assert _regions_line(st) == _regions_line(jst)


def test_print_inside_fused_loop_result_correct():
    src, _, outs = CASES["print_nested"]
    res, st, lines, fallbacks = _port(src, outputs=outs)
    _one_region(st, fallbacks)
    assert float(res.get_scalar("x")) == 32.0
    assert lines == [f"step {i} x={2.0 ** (i + 1)}" for i in range(5)]


def test_print_ring_drains_and_keeps_order(monkeypatch):
    """A ring of 3 records under a loop of 11 iterations that prints one
    or two lines each: the loop stops whenever the next iteration might
    not fit, the host prints the records, and the loop goes on; every
    line comes out once, in the eager run's order."""
    monkeypatch.setattr(loopfuse, "RING_RECORDS", 3)
    src = """
i = 0
x = 0.5
b = TRUE
while (i < 11) {
  x = x * 1.5
  print("i=" + i + " x=" + x + " b=" + b)
  if (i - 2 * floor(i / 2) == 0) {
    print("even " + i)
  }
  b = !b
  i = i + 1
}
"""
    set_config(DMLConfig(device="cpu"))
    try:
        prog = compile_program(parse(src), outputs=["x"])
        lines = []
        prog.execute(printer=lines.append)
    finally:
        set_config(DMLConfig())
    _, _, elines, _ = _port(src, outputs=["x"], codegen=False)
    assert lines == elines and len(lines) == 17
    fl = [b for b in prog.blocks if isinstance(b, P.WhileBlock)][0]._fused_loop
    assert fl.refused is None and fl.record["trips"] == [11]
    assert fl.record["drains"] >= 4


def test_refused_print_counts_its_ring_reads():
    """A print of a matrix refuses the region in its first iteration: the
    ring's records so far are read and printed before that line, and
    read again when the refusal closes the entry; the record counts both
    reads beside the entry test, and the lines equal the eager run's."""
    src, _, outs, reason = REFUSED["print_matrix"]
    set_config(DMLConfig(device="cpu"))
    try:
        prog = compile_program(parse(src), outputs=outs)
        lines = []
        prog.execute(printer=lines.append)
    finally:
        set_config(DMLConfig())
    _, _, elines, _ = _port(src, outputs=outs, codegen=False)
    assert lines == elines
    fl = [b for b in prog.blocks if isinstance(b, P.WhileBlock)][0]._fused_loop
    assert fl.refused == reason
    assert fl.record["host_syncs"] == 3


@pytest.mark.parametrize("script,args,out", [
    ("LinearRegCG.dml", {"maxi": 20, "tol": 1e-9, "reg": 1e-6}, "beta"),
    ("l2-svm.dml", {"maxiter": 10}, "w")])
def test_cla_script_runs_as_a_region(script, args, out):
    """LinearRegCG and l2-svm on a compressed categorical X of 400 rows:
    the loop is one region (its left mult, right mult and mmchain on the
    compressed X read nothing on the host), equal to the JAX package's
    run with cla "true" and to the port's eager run, l2-svm's lines
    included."""
    rng = np.random.default_rng(17)
    x = rng.integers(0, 4, (400, 5)).astype(float)
    beta = rng.standard_normal((5, 1))
    y = x @ beta if out == "beta" else np.where(x @ beta > np.median(
        x @ beta), 1.0, -1.0)
    inputs = {"X": x, "y" if out == "beta" else "Y": y}
    pres, pst, plines, fallbacks = _cla_run(script, inputs, [out], args)
    eres, _, elines, _ = _cla_run(script, inputs, [out], args,
                                  codegen=False)
    jcfg = JaxConfig()
    jcfg.exec_mode = "SINGLE_NODE"
    jcfg.cla = "true"
    with contextlib.redirect_stdout(io.StringIO()):
        jres = JaxMLContext(jcfg).execute(_script(
            jax_dml_file, script, inputs, [out], args, True))
    _one_region(pst, fallbacks)
    assert pst.estim_counts["cla_auto_compressed"] == 1
    _close(_value(pres, out), _value(eres, out))
    _close(_value(pres, out), _value(jres, out))
    assert plines == elines


def test_kmeans_init_refused_for_the_jax_package_reason():
    """Kmeans's k-means++ init (samp > 0): rand(seed=seed + 1000 * run +
    j) takes its key on the device now, and the loop is refused in its
    first iteration for C = rbind(C, S[pick, ]), a shape change, which
    is what makes the JAX package's fused loop fall back (a TypeError,
    its cond's branches of unequal shapes); the centroids equal."""
    from systemml_tpu.obs import trace as jax_obs

    rng = np.random.default_rng(17)
    x = np.concatenate([rng.standard_normal((20, 3)) + c
                        for c in (0.0, 5.0, -5.0)])
    args = {"k": 5, "runs": 1, "maxi": 8, "samp": 5}
    pres, _, _, fallbacks = _port("Kmeans.dml", {"X": x}, ["C_out"], args,
                                  from_file=True)
    with jax_obs.session() as rec:
        jres, _ = _jax("Kmeans.dml", {"X": x}, ["C_out"], args,
                       from_file=True)
    _close(_value(pres, "C_out"), _value(jres, "C_out"))
    assert [f["reason"].split(":")[0] for f in fallbacks] == ["shape change"]
    assert {e.args["error"] for e in rec._events
            if e.name == "loop_fallback"} == {"TypeError"}
