"""Automatic compression and the slice as a whole, through the JAX
package's MLContext and the port's MLContext(device="cpu") on the same
numpy-seeded inputs:

- the non-mesh cases of tests/test_cla_auto.py (its `_run_loop`, with
  blocksize 200) and tests/test_cla_consistency.py: results agree, and so
  do the counters cla_candidates, cla_auto_compressed and
  cla_rejected_by_estimate, and the variant picks kb_pick_cla_*;
- scripts/algorithms/LinearRegCG.dml on a categorical X (4,000 x 12,
  column j taking 2..8 values) with cla "auto" at optlevels 2 and 3:
  beta and the printed statistics lines agree, X is compressed once, and
  the compressed mmchain runs once per CG iteration; with cla "false"
  and "true" likewise; l2-svm on the same X (right and left mult).

The JAX package runs with exec_mode SINGLE_NODE (tests/conftest.py's
virtual 8-device CPU mesh would otherwise take its mesh branches, which
the port does not have yet) and with its kernel-choice memo cleared before
each run, as the port's (codegen/backend.reset_process_state), so that the
kb_pick counts are those of one fresh process each.

Bars: relative 1e-9 in fp64, 1e-3 in fp32 (the reference's CP and GPU
bars). LinearRegCG's categorical X is drawn from a seed (43) on which
the JAX package's own fused and eager runs agree at 2e-12: a truncated
CG (tol 1e-4) amplifies rounding, and on other seeds of the same
distribution those two runs of the JAX package differ by up to 1e-7
(seed 46, icpt 1), as its runs and the port's dense path do, so no
port could meet 1e-9 there.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.codegen import backend as jax_backend
from systemml_tpu.compress import device as jax_dev
from systemml_tpu.lang.parser import parse as jax_parse
from systemml_tpu.runtime import program as jax_program
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu.utils.config import set_config as jax_set_config
from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.codegen import backend as port_backend
from systemml_tpu_torch.compress import device as cla_dev
from systemml_tpu_torch.lang.parser import parse
from systemml_tpu_torch.runtime import program
from systemml_tpu_torch.utils import config as port_config
from systemml_tpu_torch.utils.config import DMLConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALG = os.path.join(ROOT, "scripts", "algorithms")
COUNTERS = ("cla_candidates", "cla_auto_compressed",
            "cla_rejected_by_estimate", "cla_rejected_after_compress")
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?|NaN|-?Infinity")


def _counts(st):
    return {k: v for k, v in st.estim_counts.items()
            if k in COUNTERS or k.startswith("kb_pick_cla_")}


def _configs(cla="auto", blocksize=None, optlevel=2, single=False):
    jc, pc = JaxConfig(), DMLConfig(device="cpu")
    jc.exec_mode = "SINGLE_NODE"
    for c in (jc, pc):
        c.cla = cla
        c.optlevel = optlevel
        if blocksize is not None:
            c.blocksize = blocksize
        if single:
            c.floating_point_precision = "single"
    return jc, pc


def _execute(ctx, script, inputs, args, outputs, dtype):
    for k, v in inputs.items():
        script.input(k, v.astype(dtype))
    for k, v in args.items():
        script.arg(k, v)
    script.output(*outputs)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ctx.execute(script)
    return res, out.getvalue(), ctx._stats


def _both(src, inputs, outputs, cla="auto", blocksize=None, optlevel=2,
          args=None, single=False):
    """(JAX package, port) runs of `src` (DML text, or a script under
    scripts/algorithms), each (results, printed text, Statistics)."""
    jc, pc = _configs(cla, blocksize, optlevel, single)
    dtype = np.float32 if single else np.float64
    if src.endswith(".dml"):
        js, ps = (jax_dml_file(os.path.join(ALG, src)),
                  dmlFromFile(os.path.join(ALG, src)))
    else:
        js, ps = jax_dml(src), dml(src)
    jax_backend.reset_process_state()
    port_backend.reset_process_state()
    rj = _execute(JaxMLContext(jc), js, inputs, args or {}, outputs, dtype)
    rp = _execute(MLContext(pc), ps, inputs, args or {}, outputs, dtype)
    return rj, rp


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    den = np.linalg.norm(ref)
    return np.linalg.norm(got - ref) / (den if den else 1.0)


# ---- tests/test_cla_auto.py, the non-mesh cases ----------------------------

LOOP = """
w = matrix(0, rows=ncol(X), cols=1)
for (i in 1:4) {
  g = t(X) %*% (X %*% w - y)
  w = w - 0.0000001 * g
}
"""


def _oracle(X, y, iters=4):
    w0 = np.zeros((X.shape[1], 1))
    for _ in range(iters):
        w0 = w0 - 1e-7 * (X.T @ (X @ w0 - y))
    return w0


def _floor5(rng, n, m):
    return np.floor(rng.random((n, m)) * 5.0)


# name -> (X maker, blocksize, cla, cla_auto_compressed expected)
RUN_LOOP = {
    "injects_on_categorical": (lambda r: _floor5(r, 2000, 40), 200, "auto",
                               1),
    "rejects_random_data": (lambda r: r.random((2000, 40)), 200, "auto", 0),
    "disabled_by_config": (lambda r: _floor5(r, 2000, 40), 200, "false", 0),
    "skips_small_matrices": (lambda r: _floor5(r, 500, 20), None, "auto", 0),
}


@pytest.mark.parametrize("case", sorted(RUN_LOOP))
def test_run_loop_matches_jax(case):
    make, blocksize, cla, compressed = RUN_LOOP[case]
    rng = np.random.default_rng(7)
    X = make(rng)
    y = rng.random((X.shape[0], 1))
    (rj, _, sj), (rp, _, sp) = _both(LOOP, {"X": X, "y": y}, ("w",), cla,
                                     blocksize)
    wj, wp = rj.get_matrix("w"), rp.get_matrix("w")
    assert _rel(wp, wj) <= 1e-9
    assert _rel(wp, _oracle(X, y)) <= 1e-9
    assert _counts(sp) == _counts(sj)
    assert _counts(sp).get("cla_auto_compressed", 0) == compressed
    if case == "rejects_random_data":
        assert _counts(sp)["cla_rejected_by_estimate"] >= 1
    if case != "disabled_by_config":
        assert _counts(sp).get("cla_candidates", 0) >= 1


def _loops(prog, cls):
    return [b for b in prog.blocks if isinstance(b, cls)]


def test_candidate_disqualified_by_cellwise_use():
    src = """
w = matrix(0, rows=ncol(X), cols=1)
for (i in 1:3) {
  g = t(X) %*% (X %*% w)
  h2 = X + 1
  w = w - 0.0000001 * g + 0 * sum(h2)
}
"""
    jax_set_config(JaxConfig())
    jp = jax_program.compile_program(jax_parse(src), input_names=("X",))
    pp = program.compile_program(parse(src), input_names=("X",))
    jl, pl = _loops(jp, jax_program.ForBlock), _loops(pp, program.ForBlock)
    assert pl and len(pl) == len(jl)
    assert getattr(pl[0], "cla_candidates", None) == \
        getattr(jl[0], "cla_candidates", None)
    assert "X" not in (getattr(pl[0], "cla_candidates", None) or [])


def test_nested_loop_var_not_char_split():
    src = """
t = X
acc = matrix(0, rows=ncol(X), cols=1)
for (i in 1:3) {
  for (it in 1:2) {
    acc = acc + t(t) %*% (t %*% acc + 0.001)
  }
}
"""
    jax_set_config(JaxConfig())
    jp = jax_program.compile_program(jax_parse(src), input_names=("X",))
    pp = program.compile_program(parse(src), input_names=("X",))
    inner = [b for b in _loops(pp, program.ForBlock)[0].body
             if isinstance(b, program.ForBlock)]
    jinner = [b for b in _loops(jp, jax_program.ForBlock)[0].body
              if isinstance(b, jax_program.ForBlock)]
    assert inner[0].cla_candidates == jinner[0].cla_candidates
    assert "t" in inner[0].cla_candidates


def test_compressed_transpose_matmult():
    """t(X) %*% Y with X compressed is one left mult, no decompressing
    transpose."""
    rng = np.random.default_rng(7)
    X = np.floor(rng.random((3000, 8)) * 5.0)
    X[:, 7] = rng.random(3000)
    Y = rng.random((3000, 3))
    (rj, _, sj), (rp, _, sp) = _both("C = compress(X)\nB = t(C) %*% Y\n",
                                     {"X": X, "Y": Y}, ("B",))
    assert _rel(rp.get_matrix("B"), rj.get_matrix("B")) <= 1e-9
    assert _rel(rp.get_matrix("B"), X.T @ Y) <= 1e-9
    assert _counts(sp) == _counts(sj) == {"kb_pick_cla_left.coded": 1}


def test_compress_builtins_and_output():
    rng = np.random.default_rng(13)
    X = np.column_stack([rng.choice([0.0, 1.0, 2.0], 300),
                         rng.choice([10.0, 20.0], 300), rng.random(300)])
    src = ("C = compress(X)\nC2 = compress(C * 2)\ns = sum(C2)\n"
           "k = nnz(C)\nD = decompress(C)\n")
    (rj, _, _), (rp, _, _) = _both(src, {"X": X}, ("s", "k", "D", "C"))
    assert rp.get_scalar("s") == pytest.approx(2 * X.sum(), rel=1e-12)
    assert rp.get_scalar("s") == pytest.approx(rj.get_scalar("s"), rel=1e-12)
    assert rp.get_scalar("k") == rj.get_scalar("k") == np.count_nonzero(X)
    np.testing.assert_array_equal(rp.get_matrix("D"), X)
    np.testing.assert_array_equal(rp.get_matrix("C"), X)


# ---- tests/test_cla_consistency.py ------------------------------------------

BODIES = [
    # gradient-descent shape: mmchain XtXvy
    """
w = matrix(0, rows=ncol(X), cols=1)
for (i in 1:4) {
  g = t(X) %*% (X %*% w - y)
  w = w - 0.000001 * g
}
z = sum(abs(w))
""",
    # power-iteration shape: mmchain XtXv with normalization
    """
v = matrix(1, rows=ncol(X), cols=1)
for (i in 1:3) {
  v = t(X) %*% (X %*% v)
  v = v / max(abs(v))
}
z = sum(v)
""",
    # right-mult + aggregate shape
    """
acc = 0
for (i in 1:3) {
  p = X %*% (y[1:ncol(X), 1] + i)
  acc = acc + sum(abs(p))
}
z = acc
""",
    # tsmm-in-loop shape
    """
G = matrix(0, rows=ncol(X), cols=ncol(X))
for (i in 1:3) {
  G = G + t(X) %*% X
}
z = sum(G) + sum(abs(G[1, ]))
""",
]


def _cat_matrix(rng, rows, cols):
    cols_data = []
    for _ in range(cols):
        k = int(rng.integers(2, 7))
        vals = np.round(rng.standard_normal(k) * 3, 2)
        cols_data.append(rng.choice(vals, size=rows))
    return np.column_stack(cols_data)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("bi", range(len(BODIES)))
def test_compressed_matches_uncompressed_and_jax(seed, bi):
    rng = np.random.default_rng(seed * 31 + bi)
    rows = int(rng.integers(40, 200))
    cols = int(rng.integers(4, 12))
    X = _cat_matrix(rng, rows, cols)
    y = rng.standard_normal((rows, 1))
    inputs = {"X": X, "y": y}
    (pj, _, _), (pp, _, _) = _both(BODIES[bi], inputs, ("z",), "false")
    (cj, _, sj), (cp, _, sp) = _both(BODIES[bi], inputs, ("z",), "true")
    z_plain, z_cla = float(pp.get_scalar("z")), float(cp.get_scalar("z"))
    assert z_plain == pytest.approx(float(pj.get_scalar("z")), rel=1e-9)
    assert z_cla == pytest.approx(float(cj.get_scalar("z")), rel=1e-9)
    assert z_cla == pytest.approx(z_plain, rel=1e-6)
    assert _counts(sp) == _counts(sj)
    assert (sp.estim_counts.get("cla_auto_compressed", 0) >= 1
            or sp.estim_counts.get("hoisted_invariants", 0) >= 1)


# ---- the slice as a whole -------------------------------------------------

def _categorical(seed, n=4000, m=12):
    """Column j takes d_j values, d_j in 2..8, uniform codes, N(0, 1)
    dictionary values; y = X beta + 0.3 noise + 2, whose residual mean
    stays far from 0 (near 0 the printed AVG_RES_Y is a cancellation,
    and rounding differences reach it at 1e-9 in either package)."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(m):
        d = int(rng.integers(2, 9))
        cols.append(rng.standard_normal(d)[rng.integers(0, d, n)])
    x = np.column_stack(cols)
    y = (x @ rng.standard_normal((m, 1))
         + 0.3 * rng.standard_normal((n, 1)) + 2.0)
    return x, y


def _numbers(text):
    """The iteration line and the statistics lines, as (label, numbers)."""
    out = []
    for line in text.splitlines():
        if line.startswith("LinearRegCG:") or re.match(r"^[A-Z0-9_]+,", line):
            out.append((_NUM.sub("#", line),
                        [float(v.replace("Infinity", "inf"))
                         for v in _NUM.findall(line)]))
    return out


def _same_numbers(nj, np_, y):
    """Every printed number at relative 1e-9; AVG_RES_Y, the mean of the
    residual, which fitting an intercept drives to about 1e-6 of y's
    scale by cancellation, at absolute 1e-9 x mean |y| (the error that
    beta at 1e-9 leaves in a prediction)."""
    for (lab, vj), (_, vp) in zip(nj, np_):
        atol = 1e-9 * float(np.mean(np.abs(y))) \
            if lab.startswith("AVG_RES_Y") else 0.0
        np.testing.assert_allclose(vp, vj, rtol=1e-9, atol=atol,
                                   err_msg=lab)


def _spy_mmchain(monkeypatch):
    """Counts of the compressed mmchain calls in each package."""
    calls = {"jax": 0, "port": 0}

    def spy(mod, key):
        orig = mod.mmchain

        def f(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, "mmchain", f)

    spy(jax_dev, "jax")
    spy(cla_dev, "port")
    return calls


LINREG = {"maxi": 20, "tol": 1e-4, "reg": 1e-6}


@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("icpt", [0, 1])
def test_linregcg_cla_auto_matches_jax(monkeypatch, optlevel, icpt):
    calls = _spy_mmchain(monkeypatch)
    x, y = _categorical(43)
    (rj, tj, sj), (rp, tp, sp) = _both(
        "LinearRegCG.dml", {"X": x, "y": y}, ("beta",), "auto", 200,
        optlevel, dict(LINREG, icpt=icpt))
    assert _rel(rp.get_matrix("beta"), rj.get_matrix("beta")) <= 1e-9
    nj, np_ = _numbers(tj), _numbers(tp)
    assert [lab for lab, _ in np_] == [lab for lab, _ in nj]
    assert len(nj) >= 10
    _same_numbers(nj, np_, y)
    iters = int(np_[0][1][0])
    assert iters >= 3
    assert _counts(sp) == _counts(sj)
    assert sp.estim_counts["cla_auto_compressed"] == 1
    assert calls["port"] == calls["jax"] == iters


@pytest.mark.parametrize("cla,compressed", [("false", 0), ("true", 1)])
def test_linregcg_cla_modes_match_jax(monkeypatch, cla, compressed):
    calls = _spy_mmchain(monkeypatch)
    x, y = _categorical(43)
    (rj, tj, sj), (rp, tp, sp) = _both(
        "LinearRegCG.dml", {"X": x, "y": y}, ("beta",), cla, None, 2,
        dict(LINREG, icpt=0))
    assert _rel(rp.get_matrix("beta"), rj.get_matrix("beta")) <= 1e-9
    _same_numbers(_numbers(tj), _numbers(tp), y)
    assert _counts(sp) == _counts(sj)
    assert sp.estim_counts.get("cla_auto_compressed", 0) == compressed
    iters = int(_numbers(tp)[0][1][0])
    assert calls["port"] == calls["jax"] == (iters if compressed else 0)


def test_linregcg_cla_fp32_matches_jax():
    x, y = _categorical(44)
    (rj, _, sj), (rp, _, sp) = _both(
        "LinearRegCG.dml", {"X": x, "y": y}, ("beta",), "auto", 200, 2,
        dict(LINREG, icpt=0), single=True)
    bp, bj = rp.get_matrix("beta"), rj.get_matrix("beta")
    assert bp.dtype == np.float32 and bj.dtype == np.float32
    assert _rel(bp, bj) <= 1e-3
    assert sp.estim_counts["cla_auto_compressed"] == 1
    assert _counts(sp) == _counts(sj)


def test_l2svm_cla_auto_matches_jax():
    x, y = _categorical(45)
    labels = np.where(y >= np.median(y), 1.0, -1.0)
    (rj, _, sj), (rp, _, sp) = _both(
        "l2-svm.dml", {"X": x, "Y": labels}, ("w",), "auto", 200, 2,
        {"maxiter": 15})
    assert _rel(rp.get_matrix("w"), rj.get_matrix("w")) <= 1e-9
    assert sp.estim_counts["cla_auto_compressed"] == 1
    assert _counts(sp) == _counts(sj)
    assert "kb_pick_cla_left.coded" in _counts(sp)
    assert "kb_pick_cla_right.coded" in _counts(sp)


def test_port_config_reads_cla_settings():
    """cla_min_ratio and blocksize are read now: set, they do not raise."""
    cfg = DMLConfig(device="cpu")
    cfg.cla_min_ratio = 2.0
    cfg.blocksize = 500
    port_config.check_ported(cfg)
