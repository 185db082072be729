"""Spoof fusion in the port (systemml_tpu_torch/codegen/) against the JAX
package, on the CPU.

(a) Plan parity: the same DML compiled by both packages at optlevel 3
    selects the same spoof hops (template, plan, aggregate, leaf count and
    shapes) and counts the same memo-table events. The snippets are those
    of the JAX package's tests/test_codegen.py; the scripts LinearRegCG,
    l2-svm and MultiLogReg are compiled whole, as MLContext compiles them
    (their inputs' dims unknown, so selection is structural).
(b) Kernel parity: the port's cell_plain/row_plain (what its wrappers run
    on a CPU tensor) against the JAX package's Pallas cell_kernel/
    row_kernel in interpret mode, with scalar leaves as Python floats, and
    against its jnp arm (_cell_jnp/_row_jnp) for 0-d array scalars, which
    its Pallas kernels refuse ("captures constants"). Bars: normwise
    relative error < 1e-9 in fp64 and < 1e-6 in fp32 (per-element ulp
    differences of the two libraries' exp/tan/pow and another summation
    order), NaN at the same places.
(c) A leaf layout the JAX kernels refuse takes the plain arm and counts
    spoof_plain_by_layout.
    Empty main leaves give what the JAX package's jnp arm gives, and
    raise where it raises (a row min or max of no columns).
(d) emit_cuda writes every op, and never fminf/fmaxf (which drop NaN);
    its text grows linearly with the plan's nodes; an nvcc that runs past
    the build's time limit is killed with its children and raises.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from systemml_tpu.codegen import compiler as jax_compiler
from systemml_tpu.codegen import kernels as jax_kernels
from systemml_tpu.codegen.cplan import CNode as JaxCNode
from systemml_tpu.hops.builder import HopBuilder as JaxHopBuilder
from systemml_tpu.hops.ipa import propagate_sizes as jax_propagate_sizes
from systemml_tpu.hops.rewrite import rewrite_block as jax_rewrite_block
from systemml_tpu.lang.parser import parse as jax_parse
from systemml_tpu.lang.parser import parse_file as jax_parse_file
from systemml_tpu.runtime import program as jax_program
from systemml_tpu.utils import config as jax_config
from systemml_tpu.utils import stats as jax_stats
from systemml_tpu_torch.codegen import build, kernels
from systemml_tpu_torch.codegen.compiler import compile_spoof
from systemml_tpu_torch.codegen.cplan import (CELL_BINARY, CELL_UNARY,
                                              CUDA_BINARY, CUDA_UNARY, CNode,
                                              emit_cuda)
from systemml_tpu_torch.hops.builder import HopBuilder
from systemml_tpu_torch.hops.ipa import propagate_sizes
from systemml_tpu_torch.hops.rewrite import rewrite_block
from systemml_tpu_torch.lang.parser import parse, parse_file
from systemml_tpu_torch.runtime import program as port_program
from systemml_tpu_torch.utils import config as port_config
from systemml_tpu_torch.utils import stats as port_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALG = os.path.join(ROOT, "scripts", "algorithms")
COUNTERS = ("spoof_candidates", "spoof_selected", "spoof_nofuse_by_cost",
            "spoof_structural_fallback", "kb_nan_cost")


@pytest.fixture
def port_cpu():
    """The port's active config: the CPU (its hardware profile is then the
    JAX package's CPU profile) at optlevel 3."""
    old = port_config.get_config()
    cfg = port_config.DMLConfig(device="cpu")
    cfg.optlevel = 3
    port_config.set_config(cfg)
    yield cfg
    port_config.set_config(old)


# --------------------------------------------------------------------------
# (a) plan parity
# --------------------------------------------------------------------------

def _spoof_desc(h):
    p = h.params
    return (p["template"], p["plan"].pretty(), p.get("agg"),
            p.get("row_agg"), tuple(p.get("aggs") or ()),
            tuple((c.rows, c.cols, c.dt) for c in h.inputs))


def _block_spoofs(blk):
    from systemml_tpu_torch.hops.hop import postorder as port_postorder

    return [_spoof_desc(h) for h in port_postorder(blk.roots())
            if h.op == "spoof"]


def _counts(st):
    return {k: v for k, v in st.estim_counts.items() if k in COUNTERS}


SNIPPETS = [
    ("s = sum(X * Y + 1)", None, False),
    ("s = sum(X)", None, False),
    ("r = rowSums(exp(X - m))", None, False),
    ("a = sum(X * X)\nb = min(X * X)\nc = max(X * X)", None, True),
    ("l = sum((X - U %*% t(V)) ^ 2)", None, False),
    ("W = U %*% t(V)\ns = sum((X - W)^2)",
     {"U": (2048, 2048), "V": (2048, 2048), "X": (2048, 2048)}, False),
    ("s = sum((X - U %*% t(V))^2)",
     {"U": (2048, 64), "V": (2048, 64), "X": (2048, 2048)}, False),
    ("t = exp(X)\nr = rowSums((t - m) * 2)",
     {"X": (1024, 1024), "m": (1024, 1024)}, False),
    ("t = X * Y\ns = sum(t * t)", {"X": (1024, 1024), "Y": (1024, 1024)},
     False),
    ("t = X * Y\ns = sum(t * t)\nm2 = min(t * t)",
     {"X": (1024, 1024), "Y": (1024, 1024)}, True),
    ("m = rowMaxs(X)\nr = rowSums(exp(X - m))\n", None, False),
    ("W = U %*% t(V)\ns = sum((X - W)^2)\nr = rowSums((W - 0.5) * 2)",
     {"U": (64, 8), "V": (48, 8), "X": (64, 48)}, False),
    ("s1 = sum(X^2 - X + 1)\nr = rowSums(abs(X - 0.5))\nmn = min(X * 2)\n"
     "mx = max(X * 2)", None, True),
]


@pytest.mark.parametrize("src,dims,rewrite", SNIPPETS)
def test_snippet_plans_match_jax(port_cpu, src, dims, rewrite):
    jblk = JaxHopBuilder().build_block(list(jax_parse(src).statements))
    pblk = HopBuilder().build_block(list(parse(src).statements))
    if rewrite:
        jax_rewrite_block(jblk, optlevel=2)
        rewrite_block(pblk, optlevel=2)
    if dims:
        jax_propagate_sizes(jblk.roots(), dims)
        propagate_sizes(pblk.roots(), dims)
    jst, pst = jax_stats.Statistics(), port_stats.Statistics()
    with jax_stats.stats_scope(jst):
        nj = jax_compiler.compile_spoof(jblk)
    with port_stats.stats_scope(pst):
        np_ = compile_spoof(pblk)
    assert np_ == nj
    from systemml_tpu.hops.hop import postorder as jax_postorder

    jax_desc = [_spoof_desc(h) for h in jax_postorder(jblk.roots())
                if h.op == "spoof"]
    assert _block_spoofs(pblk) == jax_desc
    assert _counts(pst) == _counts(jst)


def _walk_spoofs(prog, program_mod, postorder):
    """Spoof hop descriptors of a compiled program of either package, in
    one order: each body's predicates, then its blocks, recursively."""
    out = []

    def block_spoofs(bb):
        out.extend(_spoof_desc(h) for h in postorder(bb.hops.roots())
                   if h.op == "spoof")

    def walk(blocks):
        for b in blocks:
            if isinstance(b, program_mod.IfBlock):
                block_spoofs(b.pred.block)
                walk(b.if_body)
                walk(b.else_body)
            elif isinstance(b, program_mod.WhileBlock):
                block_spoofs(b.pred.block)
                walk(b.body)
            elif isinstance(b, program_mod.ForBlock):
                for p in (b.from_h, b.to_h, b.incr_h):
                    if p is not None:
                        block_spoofs(p.block)
                walk(b.body)
            elif isinstance(b, program_mod.BasicBlock):
                block_spoofs(b)

    walk(prog.blocks)
    for key in sorted(prog.functions):
        walk(prog.functions[key].blocks)
    return out


SCRIPTS = [
    ("LinearRegCG.dml", {"maxi": 20}, ["X", "y"], ["beta"], 3),
    ("l2-svm.dml", {"maxiter": 15}, ["X", "Y"], ["w"], 3),
    ("MultiLogReg.dml", {"moi": 10}, ["X", "Y_vec"], ["B"], 5),
]


@pytest.mark.parametrize("script,args,inputs,outputs,n_spoof", SCRIPTS)
def test_script_plans_match_jax(port_cpu, script, args, inputs, outputs,
                                n_spoof):
    from systemml_tpu.hops.hop import postorder as jax_postorder
    from systemml_tpu_torch.hops.hop import postorder as port_postorder

    path = os.path.join(ALG, script)
    jcfg = jax_config.DMLConfig()
    jcfg.optlevel = 3
    jax_config.set_config(jcfg)
    jprog = jax_program.compile_program(jax_parse_file(path), dict(args),
                                        outputs, inputs)
    pprog = port_program.compile_program(parse_file(path), dict(args),
                                         outputs, inputs)
    jax_desc = _walk_spoofs(jprog, jax_program, jax_postorder)
    port_desc = _walk_spoofs(pprog, port_program, port_postorder)
    assert port_desc == jax_desc and len(jax_desc) >= n_spoof
    templates = {d[0] for d in port_desc}
    assert templates == ({"cell", "row"} if script == "MultiLogReg.dml"
                         else {"cell"})
    assert _counts(pprog.stats) == _counts(jprog.stats)
    assert pprog.stats.estim_counts["spoof_compile_errors"] == 0
    # the port's own walker finds the same hops
    assert len(list(port_program.iter_spoof_hops(pprog))) == len(port_desc)


# --------------------------------------------------------------------------
# (b) kernel parity
# --------------------------------------------------------------------------

def _node(cls, spec):
    """A plan of either package from a nested tuple spec."""
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


def _all_ops_plan():
    """Every op of CELL_UNARY and CELL_BINARY once, as a sum of small
    terms over i0 (m, n), i1 (1, n), i2 (m, 1), i3 (1, 1) and s (a
    scalar); log and sqrt read abs(.)."""
    e = _in("i0")
    for op in sorted(CELL_UNARY):
        arg = ("b(*)", _lit(0.5), _in("i0"))
        if op in ("u(log)", "u(sqrt)"):
            arg = ("u(abs)", arg)
        e = ("b(+)", e, ("b(*)", _lit(1e-3), (op, arg)))
    for op in sorted(CELL_BINARY):
        rhs = _lit(2.0) if op == "b(^)" else _in("i1")
        e = ("b(+)", e, ("b(*)", _lit(1e-3), (op, _in("i0"), rhs)))
    e = ("b(+)", e, ("b(^)", ("u(abs)", _in("i2")), _in("i3")))
    return ("b(*)", e, ("b(-)", _in("s"), _in("i2")))


PLANS = {
    "all_ops": (_all_ops_plan(), ["i0", "i1", "i2", "i3", "s"]),
    # NaN in both operands of min and max
    "nan_minmax": (("b(+)", ("b(min)", _in("i0"), _in("i1")),
                    ("b(max)", _in("i2"), _in("i0"))), ["i0", "i1", "i2"]),
    # round at x.5 (floor(v + 0.5), not to even) and sign of 0
    "round_sign": (("b(+)", ("u(round)", _in("i0")), ("u(sign)", _in("i1"))),
                   ["i0", "i1"]),
    # MultiLogReg's row plan: rowSums(exp(Z - rowMaxs(Z)))
    "softmax_row": (("u(exp)", ("b(-)", _in("i0"), _in("i1"))),
                    ["i0", "i1"]),
}


def _leaves(case, m, n, dtype, seed):
    rng = np.random.default_rng(seed)
    sgn = lambda shape: np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    mag = lambda shape: rng.uniform(0.5, 1.5, shape)
    if case == "all_ops":
        vals = {"i0": sgn((m, n)) * mag((m, n)), "i1": sgn((1, n)) * mag((1, n)),
                "i2": mag((m, 1)), "i3": np.array([[1.7]]), "s": 0.3}
    elif case == "nan_minmax":
        vals = {"i0": rng.standard_normal((m, n)),
                "i1": rng.standard_normal((1, n)),
                "i2": rng.standard_normal((m, 1))}
        vals["i0"][::5, 1] = np.nan
        vals["i1"][0, 2] = np.nan
        vals["i2"][3, 0] = np.nan
    elif case == "round_sign":
        vals = {"i0": rng.integers(-4, 4, (m, n)) + 0.5,
                "i1": rng.integers(-1, 2, (m, n)).astype(np.float64)}
    else:
        z = rng.standard_normal((m, n))
        vals = {"i0": z, "i1": z.max(axis=1, keepdims=True)}
    return {k: (v.astype(dtype) if isinstance(v, np.ndarray) else v)
            for k, v in vals.items()}


def _close(got, ref, dtype):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    g, r = got[~nan], ref[~nan]
    bar = 1e-9 if dtype == np.float64 else 1e-6
    denom = max(np.linalg.norm(r), np.finfo(np.float64).tiny)
    assert np.linalg.norm(g - r) / denom < bar


def _port_env(vals):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in vals.items()}


def _jax_env(vals):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in vals.items()}


ARMS = [("cell", None), ("cell", "sum"), ("row", "sum"), ("row", "min"),
        ("row", "max")]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_plain_matches_jax_pallas_kernels(case, dtype):
    """Ragged m (37 rows: the JAX kernel's row tile is 32), Python-float
    scalars, (m, 1), (1, n) and (1, 1) leaves."""
    spec, names = PLANS[case]
    vals = _leaves(case, 37, 9, dtype, seed=len(case))
    jplan, pplan = _node(JaxCNode, spec), _node(CNode, spec)
    for template, agg in ARMS:
        if template == "cell":
            ref = jax_kernels.cell_kernel(jplan, names, agg, _jax_env(vals))
            got = kernels.cell_plain(pplan, names, agg, _port_env(vals))
            wrapped = kernels.cell_kernel(pplan, names, agg, _port_env(vals))
        else:
            ref = jax_kernels.row_kernel(jplan, names, agg, _jax_env(vals))
            got = kernels.row_plain(pplan, names, agg, _port_env(vals))
            wrapped = kernels.row_kernel(pplan, names, agg, _port_env(vals))
        assert got.dtype == torch.from_numpy(vals["i0"]).dtype
        _close(got.numpy(), np.asarray(ref), dtype)
        assert torch.equal(got.nan_to_num(7.0), wrapped.nan_to_num(7.0))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_matches_jax_jnp_arm_with_array_scalars(dtype):
    """0-d array scalar leaves (the port's sums are 0-d tensors): the JAX
    package's Pallas kernels refuse them, so its jnp arm is the oracle."""
    spec = ("b(*)", ("b(-)", _in("i0"), _in("s")),
            ("b(+)", _in("i1"), ("b(*)", _in("t"), _in("i2"))))
    names = ["i0", "s", "i1", "t", "i2"]
    rng = np.random.default_rng(5)
    vals = {"i0": rng.standard_normal((41, 6)).astype(dtype),
            "s": np.asarray(0.3, dtype=dtype),
            "i1": rng.standard_normal((41, 1)).astype(dtype),
            "t": np.asarray(-1.25, dtype=dtype),
            "i2": rng.standard_normal((1, 6)).astype(dtype)}
    jplan, pplan = _node(JaxCNode, spec), _node(CNode, spec)
    for template, agg in ARMS:
        if template == "cell":
            ref = jax_compiler._cell_jnp({}, jplan, names, agg, _jax_env(vals))
            got = kernels.cell_kernel(pplan, names, agg, _port_env(vals))
        else:
            ref = jax_compiler._row_jnp({}, jplan, names, agg, _jax_env(vals))
            got = kernels.row_kernel(pplan, names, agg, _port_env(vals))
        _close(got.numpy(), np.asarray(ref), dtype)


# --------------------------------------------------------------------------
# (c) layouts the JAX kernels refuse
# --------------------------------------------------------------------------

@pytest.mark.parametrize("template", ["cell", "row"])
def test_refused_layout_takes_plain_arm_and_counts(template):
    """Kmeans' shape: an (m, 1) main leaf beside an (m, k) leaf. The JAX
    package's kernel raises PallasUnsupported and it runs its jnp arm; the
    port's wrapper takes its plain arm before any launch and counts it."""
    spec = ("b(^)", ("b(-)", _in("i0"), _in("i1")), _lit(2.0))
    names = ["i0", "i1"]
    rng = np.random.default_rng(9)
    vals = {"i0": rng.standard_normal((30, 1)),
            "i1": rng.standard_normal((30, 4))}
    jplan, pplan = _node(JaxCNode, spec), _node(CNode, spec)
    run = jax_kernels.cell_kernel if template == "cell" else \
        jax_kernels.row_kernel
    agg = "sum"
    with pytest.raises(jax_kernels.PallasUnsupported):
        run(jplan, names, agg, _jax_env(vals))
    jnp_arm = (jax_compiler._cell_jnp if template == "cell"
               else jax_compiler._row_jnp)
    ref = jnp_arm({}, jplan, names, agg, _jax_env(vals))
    st = port_stats.Statistics()
    wrapper = kernels.cell_kernel if template == "cell" else \
        kernels.row_kernel
    before = wrapper.launches
    with port_stats.stats_scope(st):
        got = wrapper(pplan, names, agg, _port_env(vals))
    _close(got.numpy(), np.asarray(ref), np.float64)
    assert st.estim_counts["spoof_plain_by_layout"] == 1
    assert wrapper.launches == before
    assert not kernels.spoof_layout_ok(names, _port_env(vals))


@pytest.mark.parametrize("shape", [(0, 7), (5, 0), (0, 1)])
@pytest.mark.parametrize("template,agg", [("cell", None), ("cell", "sum"),
                                          ("row", "sum"), ("row", "min"),
                                          ("row", "max")])
def test_empty_main_leaf_matches_jax_jnp_arm(shape, template, agg):
    spec = ("b(-)", ("u(exp)", _in("i0")), _in("i1"))
    names = ["i0", "i1"]
    vals = {"i0": np.ones(shape), "i1": np.full((1, shape[1]), 0.5)}
    jnp_arm = (jax_compiler._cell_jnp if template == "cell"
               else jax_compiler._row_jnp)
    wrapper = kernels.cell_kernel if template == "cell" else \
        kernels.row_kernel
    try:
        ref = np.asarray(jnp_arm({}, _node(JaxCNode, spec), names, agg,
                                 _jax_env(vals)))
    except ValueError:
        with pytest.raises(ValueError):
            wrapper(_node(CNode, spec), names, agg, _port_env(vals))
        return
    got = wrapper(_node(CNode, spec), names, agg, _port_env(vals)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_layout_check_mirrors_leaf_layout():
    """Every (main, leaf) shape pair the JAX package's _leaf_layout takes,
    and no other, passes spoof_layout_ok."""
    m, n = 16, 5
    shapes = [(m, n), (m, 1), (1, n), (1, 1), (m, 3), (3, n), (2, 1)]
    for main in [(m, n), (m, 1), (1, 1)]:
        for other in shapes:
            env = {"a": np.ones(main), "b": np.ones(other)}
            try:
                jax_kernels._leaf_layout(["a", "b"], _jax_env(env), 8)
                ok = True
            except jax_kernels.PallasUnsupported:
                ok = False
            assert kernels.spoof_layout_ok(["a", "b"], _port_env(env)) == ok


# --------------------------------------------------------------------------
# (d) the CUDA expression
# --------------------------------------------------------------------------

def test_emit_cuda_writes_every_op_and_keeps_nan():
    spec = _all_ops_plan()
    spec = ("b(+)", spec, ("b(^)", _in("i0"), _lit(3.0)))
    expr = emit_cuda(_node(CNode, spec))
    for op in CELL_BINARY | CELL_UNARY:
        fn = CUDA_BINARY.get(op) or CUDA_UNARY[op]
        assert f"{fn}(" in expr, op
    assert "op_sq(" in expr  # b(^) with a literal 2
    assert "op_pow(" in expr  # and with another exponent
    for dropped in ("fminf", "fmaxf", "fmin(", "fmax("):
        assert dropped not in expr
    with open(build.SPOOF_HEADER) as f:  # its code, not its comments
        header = "\n".join(ln.split("//")[0] for ln in f)
    for dropped in ("fminf", "fmaxf", "fmin(", "fmax("):
        assert dropped not in header
    for fn in set(CUDA_BINARY.values()) | set(CUDA_UNARY.values()):
        assert f" {fn}(" in header, fn
    # leaf reads are numbered in the order of input_names
    plan = _node(CNode, ("b(-)", _in("b"), ("b(*)", _in("a"), _in("b"))))
    assert emit_cuda(plan) == "op_sub(LEAF(0), op_mul(LEAF(1), LEAF(0)))"
    assert emit_cuda(_node(CNode, ("b(+)", _in("x"), _lit(float("nan"))))) \
        == "op_add(LEAF(0), T(CUDART_NAN))"


def test_emit_cuda_is_linear_in_plan_nodes():
    """Each operand is emitted once: the source of a plan of every op 16
    times is about 16 times that of every op once, so nvcc's input stays
    proportional to the plan (no operand text copied per use)."""
    from systemml_tpu_torch.codegen.nvcc_scaling import every_op_plan

    one, many = emit_cuda(every_op_plan(1)), emit_cuda(every_op_plan(16))
    assert len(one) * 15 < len(many) < len(one) * 17
    # one read per leaf use: the first term, then 42 per round of ops
    assert many.count("LEAF(") - 1 == (one.count("LEAF(") - 1) * 16


def test_nvcc_past_its_limit_is_killed_and_raises(tmp_path, monkeypatch):
    """A hung compiler (a stand-in that starts a child and waits) is
    killed with its child at NVCC_TIMEOUT_S, and the build raises."""
    import time

    pidfile = tmp_path / "child.pid"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\nsleep 60 &\necho $! > {pidfile}\nwait\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "NVCC_TIMEOUT_S", 1.0)
    plan = _node(CNode, ("u(exp)", _in("i0")))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="ran past its limit"):
        build.build_plans([("cell", plan)])
    assert time.perf_counter() - t0 < 30
    pid = int(pidfile.read_text())
    for _ in range(100):   # gone, or a zombie waiting for its reaper
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break
        except FileNotFoundError:
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"nvcc's child {pid} still runs")
    assert not list((tmp_path / "_build").glob("*.so*"))


def test_plan_source_is_keyed_by_its_text():
    a = _node(CNode, ("u(exp)", ("b(-)", _in("i0"), _in("i1"))))
    b = _node(CNode, ("u(exp)", ("b(-)", _in("i0"), _in("i1"))))
    c = _node(CNode, ("u(exp)", ("b(+)", _in("i0"), _in("i1"))))
    na, ta = build.plan_source("row", a)
    assert build.plan_source("row", b) == (na, ta)
    assert build.plan_source("row", c)[0] != na
    assert build.plan_source("cell", a)[0] != na
    assert na.startswith("spoof_row-") and "SPOOF_ROW_LAUNCHER(Plan)" in ta
    assert "op_exp(op_sub(LEAF(0), LEAF(1)))" in ta
    with pytest.raises(ValueError):
        build.plan_source("nope", a)
