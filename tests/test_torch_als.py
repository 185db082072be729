"""The ALS-CG slice of the port against the JAX package, on the CPU.

(a) Modules, same numpy-seeded inputs through both packages:
    - the dense arm of wdivmm (ops/mult.py) against the JAX package's
      mult.wdivmm on a dense carrier, every left/mult setting, at
      relative 1e-12 (the same three products; another summation order);
    - outer_plain (codegen/kernels.py, what outer_kernel runs on a CPU X)
      against the JAX package's Pallas outer_sum_kernel in interpret mode
      (plans without array scalars: its kernel closes over its scalars)
      and against its jnp arm _outer_jnp (0-d scalar leaves among them);
    - multiagg_plain against the jnp arm _magg_jnp, with NaN and 0-d
      scalar leaves (its Pallas multiagg_kernel refuses 0-d scalars), and
      against its Pallas multiagg_kernel in interpret mode without them;
    bars: relative 1e-9 in fp64 and 1e-6 in fp32, NaN at the same places.
(b) The slice: scripts/algorithms/ALS-CG.dml through both packages'
    MLContext on a 300 x 200 V at density 0.5 (half-star ratings), rank
    4, maxi 3, mii 3, with reg L2 and wL2, at optlevels 2 (the dense
    wdivmm arm) and 3 (the outer template, K5's plain version, and cell
    plans): L and R at relative 1e-9 in fp64 and 1e-3 in fp32, the same
    printed iteration count and the loss at the same bars. At optlevel 3
    the port evaluates the outer plan once per outer iteration, and
    selects the JAX package's spoof plans.
(c) A user's ratings summary (mean-centred observed ratings: sum, min,
    max) at optlevel 3, where both packages select one multi-aggregate
    plan with two 0-d scalar leaves: min and max at relative 1e-9, the sum
    (a cancellation near 0) at absolute 1e-9 x sum|Z|.

The JAX package runs with exec_mode SINGLE_NODE: tests/conftest.py's
virtual 8-device CPU mesh would otherwise take its mesh quaternary ops,
which the port does not have yet.
"""

import contextlib
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.codegen import compiler as jax_compiler
from systemml_tpu.codegen import kernels as jax_kernels
from systemml_tpu.codegen.cplan import CNode as JaxCNode
from systemml_tpu.hops.hop import postorder as jax_postorder
from systemml_tpu.lang.parser import parse_file as jax_parse_file
from systemml_tpu.ops import mult as jax_mult
from systemml_tpu.runtime import program as jax_program
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu.utils.config import set_config as jax_set_config
from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.codegen import kernels
from systemml_tpu_torch.codegen.cplan import CNode
from systemml_tpu_torch.hops.hop import postorder as port_postorder
from systemml_tpu_torch.lang.parser import parse_file
from systemml_tpu_torch.ops import mult
from systemml_tpu_torch.runtime import program as port_program
from systemml_tpu_torch.utils.config import DMLConfig
from systemml_tpu_torch.utils.config import set_config as port_set_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALS = os.path.join(ROOT, "scripts", "algorithms", "ALS-CG.dml")
# a user's summary of mean-centred observed ratings
SUMMARY = """
mu = sum(V) / sum(V != 0)
Z = (V != 0) * (V - mu)
s = sum(Z)
lo = min(Z)
hi = max(Z)
"""
BARS = {np.float64: 1e-9, np.float32: 1e-3}
_LOSS = re.compile(r"ALS-CG: iterations = (\d+), loss = (\S+)")


def _ratings(seed=0, m=300, n=200, density=0.5):
    """Half-star ratings 0.5..5.0 on a Bernoulli pattern, 0 elsewhere."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(0.5, 5.0, (m, n)) * 2) / 2
    return np.where(rng.random((m, n)) < density, v, 0.0)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)


# --------------------------------------------------------------------------
# (a) modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("mult_w,eps", [(False, 0.0), (False, 0.1),
                                        (True, 0.0)])
def test_wdivmm_dense_arm_matches_jax(left, mult_w, eps):
    rng = np.random.default_rng(3)
    x = _ratings(4, 37, 23)
    u = rng.uniform(0.2, 1.0, (37, 5))
    v = rng.uniform(0.2, 1.0, (23, 5))
    ref = np.asarray(jax_mult.wdivmm(jnp.asarray(x), jnp.asarray(u),
                                     jnp.asarray(v), left, mult_w, eps))
    got = mult.wdivmm(torch.from_numpy(x), torch.from_numpy(u),
                      torch.from_numpy(v), left, mult_w, eps).numpy()
    assert got.shape == ref.shape == ((23, 5) if left else (37, 5))
    assert _rel(got, ref) < 1e-12


def _node(cls, spec):
    op = spec[0]
    if op == "in":
        return cls("in", name=spec[1])
    if op == "lit":
        return cls("lit", value=spec[1])
    return cls(op, [_node(cls, s) for s in spec[1:]])


def _in(n):
    return ("in", n)


def _lit(v):
    return ("lit", v)


# ALS-CG's loss plan sum((X * UV)^2), and plans over X, UV and scalars
OUTER_PLANS = {
    "als_loss": ("b(^)", ("b(*)", _in("X"), _in("UV")), _lit(2.0)),
    "wsloss": ("b(*)", _in("X"), ("b(^)", ("b(-)", _in("X"), _in("UV")),
                                  _lit(2.0))),
    "scalars": ("b(*)", ("b(-)", _in("X"), ("b(*)", _in("a"), _in("UV"))),
                ("u(exp)", ("b(min)", _in("UV"), _in("b")))),
}


def _outer_inputs(m, n, r, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _ratings(seed, m, n).astype(dtype)
    u = rng.standard_normal((m, r)).astype(dtype)
    v = rng.standard_normal((n, r)).astype(dtype)
    return x, u, v


# module bars: fp32 holds 1e-6 (per-element ulp differences and another
# summation order over a few thousand cells)
MODULE_BARS = {np.float64: 1e-9, np.float32: 1e-6}


def _close(got, ref, bar):
    got, ref = float(got), float(ref)
    if np.isnan(ref):
        assert np.isnan(got)
        return
    assert abs(got - ref) <= bar * abs(ref)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["als_loss", "wsloss"])
@pytest.mark.parametrize("m,n,r", [(37, 23, 4), (70, 9, 1), (5, 40, 33)])
def test_outer_plain_matches_jax_pallas_kernel(dtype, case, m, n, r):
    """Ragged m (the JAX kernel pads its row tiles), ranks 1 to 33. The
    JAX kernel forms UV in fp32 (HIGHEST) whatever X's dtype, so it is
    held at the fp32 bar; its jnp arm, in X's dtype, at the dtype's."""
    x, u, v = _outer_inputs(m, n, r, dtype, seed=m + r)
    spec = OUTER_PLANS[case]
    ref = jax_kernels.outer_sum_kernel(_node(JaxCNode, spec), jnp.asarray(x),
                                       jnp.asarray(u), jnp.asarray(v), {})
    got = kernels.outer_plain(_node(CNode, spec), torch.from_numpy(x),
                              torch.from_numpy(u), torch.from_numpy(v), {})
    wrapped = kernels.outer_kernel(_node(CNode, spec), torch.from_numpy(x),
                                   torch.from_numpy(u), torch.from_numpy(v),
                                   {})
    jnp_ref = jax_compiler._outer_jnp({}, _node(JaxCNode, spec),
                                      jnp.asarray(x), jnp.asarray(u),
                                      jnp.asarray(v), {})
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == ()
    _close(got, ref, MODULE_BARS[np.float32])
    _close(got, jnp_ref, MODULE_BARS[dtype])
    assert torch.equal(got, wrapped)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_outer_plain_matches_jax_jnp_arm_with_scalars(dtype):
    """A host number and a 0-d array scalar beside X and UV, and NaN in
    X: the JAX package's jnp arm is the oracle (its Pallas kernel closes
    over array scalars)."""
    x, u, v = _outer_inputs(41, 17, 3, dtype, seed=8)
    spec = OUTER_PLANS["scalars"]
    for nan in (False, True):
        if nan:
            x = x.copy()
            x[5, 3] = np.nan
        jextra = {"a": 0.5, "b": jnp.asarray(0.75, dtype=dtype)}
        pextra = {"a": 0.5, "b": torch.tensor(0.75, dtype=torch.from_numpy(
            x).dtype)}
        ref = jax_compiler._outer_jnp({}, _node(JaxCNode, spec),
                                      jnp.asarray(x), jnp.asarray(u),
                                      jnp.asarray(v), jextra)
        got = kernels.outer_kernel(_node(CNode, spec), torch.from_numpy(x),
                                   torch.from_numpy(u), torch.from_numpy(v),
                                   pextra)
        _close(got, ref, MODULE_BARS[dtype])
    with pytest.raises(ValueError):
        kernels.outer_plain(_node(CNode, spec), torch.from_numpy(x),
                            torch.from_numpy(u), torch.from_numpy(v.T), pextra)


MAGG_PLANS = {
    # the ratings summary's plan: (V != 0) * (V - s1 / s2)
    "summary": (("b(*)", ("b(!=)", _in("i0"), _lit(0.0)),
                 ("b(-)", _in("i1"), ("b(/)", _in("i2"), _in("i3")))),
                ["i0", "i1", "i2", "i3"]),
    "square": (("b(*)", _in("i0"), _in("i0")), ["i0"]),
    "layouts": (("b(+)", ("b(*)", _in("i0"), _in("i1")), _in("i2")),
                ["i0", "i1", "i2"]),
}
AGG_ORDERS = [["sum", "min", "max"], ["max", "sum"], ["min"],
              ["min", "min", "sum", "max", "sum"]]


def _magg_leaves(case, dtype, seed, nan):
    rng = np.random.default_rng(seed)
    m, n = 43, 11
    if case == "summary":
        v = _ratings(seed, m, n)
        vals = {"i0": v, "i1": v, "i2": np.asarray(v.sum()),
                "i3": np.asarray(float((v != 0).sum()))}
    elif case == "square":
        vals = {"i0": rng.standard_normal((m, n))}
    else:
        vals = {"i0": rng.standard_normal((m, n)),
                "i1": rng.standard_normal((1, n)),
                "i2": rng.standard_normal((m, 1))}
    if nan:
        vals["i0"][7, 2] = np.nan
    return {k: v.astype(dtype) for k, v in vals.items()}


def _env(vals, to):
    return {k: to(v) for k, v in vals.items()}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(MAGG_PLANS))
@pytest.mark.parametrize("nan", [False, True])
def test_multiagg_plain_matches_jax(dtype, case, nan):
    spec, names = MAGG_PLANS[case]
    vals = _magg_leaves(case, dtype, seed=len(case), nan=nan)
    jplan, pplan = _node(JaxCNode, spec), _node(CNode, spec)
    pallas_ok = all(v.ndim == 2 for v in vals.values())
    for aggs in AGG_ORDERS:
        refs = [jax_compiler._magg_jnp({}, jplan, names, aggs,
                                       _env(vals, jnp.asarray))]
        if pallas_ok:
            refs.append(jax_kernels.multiagg_kernel(
                jplan, names, aggs, _env(vals, jnp.asarray)))
        got = kernels.multiagg_plain(pplan, names, aggs,
                                     _env(vals, torch.from_numpy))
        wrapped = kernels.multiagg_kernel(pplan, names, aggs,
                                          _env(vals, torch.from_numpy))
        assert len(got) == len(aggs)
        for ref in refs:
            for g, r in zip(got, ref):
                assert g.shape == () and g.dtype == torch.from_numpy(
                    vals["i0"]).dtype
                _close(g, r, MODULE_BARS[dtype])
        assert all(torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))
                   for g, w in zip(got, wrapped))


def test_multiagg_empty_and_unknown_aggregates():
    plan = _node(CNode, ("b(*)", _in("i0"), _lit(2.0)))
    env = {"i0": torch.ones(0, 4, dtype=torch.float64)}
    (s,) = kernels.multiagg_kernel(plan, ["i0"], ["sum"], env)
    assert float(s) == 0.0
    with pytest.raises(ValueError):
        jax_compiler._magg_jnp({}, _node(JaxCNode, ("b(*)", _in("i0"),
                                                    _lit(2.0))),
                               ["i0"], ["min"], {"i0": jnp.ones((0, 4))})
    with pytest.raises(ValueError):
        kernels.multiagg_kernel(plan, ["i0"], ["sum", "min"], env)
    with pytest.raises(ValueError):
        kernels.multiagg_kernel(plan, ["i0"], ["prod"],
                                {"i0": torch.ones(3, 4)})


# --------------------------------------------------------------------------
# (b) ALS-CG through both packages
# --------------------------------------------------------------------------

def _jax_cfg(optlevel, prec):
    cfg = JaxConfig()
    cfg.optlevel = optlevel
    cfg.floating_point_precision = prec
    cfg.exec_mode = "SINGLE_NODE"
    return cfg


def _port_cfg(optlevel, prec):
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = optlevel
    cfg.floating_point_precision = prec
    return cfg


def _als(ml, script, v, reg, outputs=("L", "R")):
    s = script.input("V", v).arg("rank", 4).arg("maxi", 3).arg("mii", 3)
    s.arg("reg", reg)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ml.execute(s.output(*outputs))
    lines = out.getvalue().splitlines()
    hits = [_LOSS.match(ln) for ln in lines if _LOSS.match(ln)]
    assert len(hits) == 1, lines
    return res, int(hits[0].group(1)), float(hits[0].group(2))


@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("prec,ndt", [("double", np.float64),
                                      ("single", np.float32)])
@pytest.mark.parametrize("reg", ["L2", "wL2"])
def test_als_cg_matches_jax(optlevel, prec, ndt, reg):
    v = _ratings(0).astype(ndt)
    rj, itj, lossj = _als(JaxMLContext(_jax_cfg(optlevel, prec)),
                          jax_dml_file(ALS), v, reg)
    rp, itp, lossp = _als(MLContext(_port_cfg(optlevel, prec)),
                          dmlFromFile(ALS), v, reg)
    assert itp == itj == 3
    for out in ("L", "R"):
        a, b = rp.get_matrix(out), rj.get_matrix(out)
        assert a.dtype == ndt and a.shape == b.shape
        assert _rel(a, b) < BARS[ndt], out
    assert abs(lossp - lossj) < BARS[ndt] * abs(lossj)


def test_optlevel3_runs_outer_plan_once_per_iteration(monkeypatch):
    """At optlevel 3 the loss check's sum((W * (L %*% t(R)))^2) is the
    outer template, b(^)(b(*)(X, UV), 2.0): its kernel wrapper runs once
    per outer iteration, the wdivmm capture stays off (codegen owns the
    products), and the result equals optlevel 2's at 1e-9. pallas_mode
    "always" makes the kernel backend take the kernel variant on the CPU
    (its wrapper runs the plain version there); "auto" takes the plain
    arm there, as the JAX package's jnp arm."""
    calls = []
    outer = kernels.outer_kernel
    monkeypatch.setattr(kernels, "outer_kernel", lambda plan, *a, **kw: (
        calls.append(plan.pretty()) or outer(plan, *a, **kw)))
    v = _ratings(1)
    runs = {}
    for optlevel in (3, 2):
        cfg = _port_cfg(optlevel, "double")
        cfg.pallas_mode = "always"
        ml = MLContext(cfg)
        runs[optlevel] = _als(ml, dmlFromFile(ALS), v, "L2")
        if optlevel == 3:
            assert calls == ["b(^)(b(*)(X, UV), 2.0)"] * runs[3][1]
            assert "spx_wdivmm_dense" not in ml._stats.estim_counts
        else:
            assert ml._stats.estim_counts["spx_wdivmm_dense"] > 0
    assert len(calls) == runs[3][1] == 3
    for out in ("L", "R"):
        assert _rel(runs[3][0].get_matrix(out),
                    runs[2][0].get_matrix(out)) < 1e-9


def _spoof_desc(h):
    p = h.params
    return (p["template"], p["plan"].pretty(), p.get("agg"),
            p.get("row_agg"), tuple(p.get("aggs") or ()),
            tuple(p.get("scalar_names") or ()), len(h.inputs))


def _program_spoofs(prog, postorder, iter_blocks):
    out = []
    for bb in iter_blocks(prog):
        out.extend(_spoof_desc(h) for h in postorder(bb.hops.roots())
                   if h.op == "spoof")
    return sorted(out, key=repr)


def test_als_cg_plans_match_jax():
    """ALS-CG compiled at optlevel 3 by both packages, as MLContext
    compiles it: the same spoof hops (one outer plan, the cell plans)."""
    args = {"rank": 4, "maxi": 3, "mii": 3}
    jcfg = JaxConfig()
    jcfg.optlevel = 3
    jax_set_config(jcfg)
    jprog = jax_program.compile_program(jax_parse_file(ALS), dict(args),
                                        ["L", "R"], ["V"])
    pcfg = _port_cfg(3, "auto")
    port_set_config(pcfg)
    try:
        pprog = port_program.compile_program(parse_file(ALS), dict(args),
                                             ["L", "R"], ["V"])
    finally:
        port_set_config(DMLConfig())
    jd = _program_spoofs(jprog, jax_postorder, jax_program.iter_basic_blocks)
    pd = _program_spoofs(pprog, port_postorder,
                         port_program.iter_basic_blocks)
    assert pd == jd
    assert [d[0] for d in pd].count("outer") == 1
    assert pprog.stats.estim_counts["spoof_compile_errors"] == 0


# --------------------------------------------------------------------------
# (c) the ratings summary: the multi-aggregate template
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prec,ndt", [("double", np.float64),
                                      ("single", np.float32)])
def test_ratings_summary_matches_jax(monkeypatch, prec, ndt):
    calls = []
    magg = kernels.multiagg_kernel
    monkeypatch.setattr(kernels, "multiagg_kernel", lambda plan, names, aggs,
                        env, *variant, **kw: calls.append((
                            plan.pretty(), list(aggs), len(names))) or magg(
                            plan, names, aggs, env, *variant, **kw))
    v = _ratings(2).astype(ndt)
    rj = JaxMLContext(_jax_cfg(3, prec)).execute(
        jax_dml(SUMMARY).input("V", v).output("s", "lo", "hi"))
    # the kernel variant on the CPU (its wrapper runs the plain version)
    cfg = _port_cfg(3, prec)
    cfg.pallas_mode = "always"
    rp = MLContext(cfg).execute(
        dml(SUMMARY).input("V", v).output("s", "lo", "hi"))
    # V enters twice (i0, i1: its reads in the two factors) beside the
    # two 0-d sums
    assert calls == [("b(*)(b(!=)(i0, 0.0), b(-)(i1, b(/)(i2, i3)))",
                      ["sum", "min", "max"], 4)]
    z = (v != 0) * (v - v.sum(dtype=np.float64) / (v != 0).sum())
    for k in ("lo", "hi"):
        a, b = float(rp.get(k)), float(rj.get(k))
        assert abs(a - b) <= BARS[ndt] * abs(b)
    assert abs(float(rp.get("s")) - float(rj.get("s"))) <= \
        BARS[ndt] * np.abs(z).sum()


# --------------------------------------------------------------------------
# (d) a repaired fault: each block's intermediates die with the block
# --------------------------------------------------------------------------

def test_block_intermediates_are_freed_without_the_cycle_collector(
        monkeypatch):
    """Every matmult went through a recursive closure that held the
    block's evaluator in a reference cycle, so its cache (every
    intermediate of the block: ALS-CG's (m, n) products) lived until the
    cyclic collector ran; at ALS-CG-ml10m's shape on the card that
    exhausted 80 GB. With the collector off, the product below must die
    when the block ends."""
    import gc
    import weakref

    from systemml_tpu_torch.compiler import lower

    refs = []
    orig = lower.Evaluator._eval

    def spy(self, h):
        v = orig(self, h)
        if h.op == "ba+*":
            refs.append(weakref.ref(v))
        return v

    monkeypatch.setattr(lower.Evaluator, "_eval", spy)
    rng = np.random.default_rng(4)
    src = "P = W * (A %*% t(B))\ns = sum(P)\nQ = A %*% t(B) %*% B"
    gc.disable()
    try:
        res = MLContext(DMLConfig(device="cpu")).execute(
            dml(src).input("W", rng.random((60, 40)))
            .input("A", rng.random((60, 5))).input("B", rng.random((40, 5)))
            .output("s", "Q"))
        assert len(refs) >= 2
        assert all(r() is None for r in refs[:-1])
        assert res.get_matrix("Q").shape == (60, 5)
    finally:
        gc.enable()
