"""The spoof reduction walk's host side, on the CPU: what the generated
source of a plan is specialised for, and which walk a launch takes.

(a) Scalar-only subtrees hoisted (cplan.hoist) evaluate, under the plain
    evaluator `emit`, bit for bit as the unhoisted plan: the summary's
    plan, l2-svm's 10-leaf plan, and the "ragged" and "every op" plans of
    the kernel phase of chip_smoke.py, in fp32 and fp64.
(b) The paths at optlevel 3 (l2-svm, MultiLogReg, LinearRegCG, ALS-CG,
    the ratings summary): every spoof hop's Variant derived from its hops
    (compiler.assign_variants) equals the one derived from the values it
    runs on (kernels.env_variant), and the flat walk is taken exactly when
    every cell leaf has the main leaf's shape.
(c) The leaf classifier on every layout of the "ragged" plan: a
    misaligned slice, a column of a wider matrix, the same tensor twice.
(d) plan_source's names follow the aggregates' order, the scalar set and
    the aliases.
"""

import os

import numpy as np
import pytest
import torch

from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.codegen import build, compiler, kernels
from systemml_tpu_torch.codegen.cplan import (CELL_BINARY, CELL_UNARY,
                                              HOIST_PREFIX, CNode, emit,
                                              hoist)
from systemml_tpu_torch.utils.config import DMLConfig

ALG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "algorithms")
SUMMARY = ("mu = sum(V) / sum(V != 0)\nZ = (V != 0) * (V - mu)\n"
           "s = sum(Z)\nlo = min(Z)\nhi = max(Z)\n")


def _n(op, *kids):
    return CNode(op, list(kids))


def _in(name):
    return CNode("in", name=name)


def _lit(v):
    return CNode("lit", value=v)


def _cfg():
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = 3
    return cfg


# the ratings summary's plan: (V != 0) * (V - sum(V) / sum(V != 0))
SUMMARY_PLAN = _n("b(*)", _n("b(!=)", _in("i0"), _lit(0.0)),
                  _n("b(-)", _in("i1"), _n("b(/)", _in("i2"), _in("i3"))))
# every layout: i0 (m, n), i1 (1, n), i2 (m, 1), i3 (1, 1), s a host
# number, t a 0-d tensor
RAGGED = _n("b(+)", _n("b(*)", _n("b(min)", _in("i0"), _in("i1")),
                       _n("b(-)", _in("s"), _in("i2"))),
            _n("b(+)", _n("b(^)", _n("b(max)", _in("i0"), _in("t")),
                          _lit(2.0)),
               _n("b(*)", _n("u(sigmoid)", _in("i3")),
                  _n("b(>)", _in("i0"), _n("u(abs)", _in("i2"))))))
RAGGED_NAMES = ["i0", "i1", "s", "i2", "t", "i3"]


def _every_op():
    e = _in("i0")
    for op in sorted(CELL_UNARY):
        arg = _n("b(*)", _lit(0.5), _in("i0"))
        if op in ("u(log)", "u(sqrt)"):
            arg = _n("u(abs)", arg)
        e = _n("b(+)", e, _n("b(*)", _lit(1e-3), _n(op, arg)))
    for op in sorted(CELL_BINARY):
        rhs = _lit(2.0) if op == "b(^)" else _in("i1")
        e = _n("b(+)", e, _n("b(*)", _lit(1e-3), _n(op, _in("i0"), rhs)))
    return _n("b(+)", e, _n("b(^)", _n("u(abs)", _in("i2")), _in("i3")))


def _l2svm_plan():
    """l2-svm's 10-leaf line-search plan and its leaves' variables, as
    the port selects it at optlevel 3."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 6)).astype(np.float32)
    y = np.where(x @ rng.standard_normal((6, 1)) >= 0, 1.0, -1.0)
    ml = MLContext(_cfg())
    ml.printer = lambda s: None
    hops = []
    orig = compiler.execute_spoof

    def spy(h, args):
        hops.append(h)
        return orig(h, args)

    compiler.execute_spoof = spy
    try:
        ml.execute(dmlFromFile(os.path.join(ALG, "l2-svm.dml"))
                   .input("X", x).input("Y", y.astype(np.float32))
                   .arg("maxiter", 2).output("w"))
    finally:
        compiler.execute_spoof = orig
    h = max(hops, key=lambda h: len(h.params.get("leaf_names", ())))
    return h.params["plan"], [i.name for i in h.inputs]


# --------------------------------------------------------------------------
# (a) hoisting keeps the bits
# --------------------------------------------------------------------------

def _bits(t):
    t = t.contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _hoisted_env_cases(dtype):
    rng = np.random.default_rng(5)
    m, n = 257, 7
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    v = t(rng.integers(0, 11, (m, n)) / 2.0 * (rng.random((m, n)) < 0.3))
    yield "summary", SUMMARY_PLAN, ["i2", "i3"], {
        "i0": v, "i1": v, "i2": v.sum(), "i3": (v != 0).sum().to(dtype)}
    plan, variables = _l2svm_plan()
    vals = {"Y": t(np.sign(rng.standard_normal((m, 1))) + 0.0),
            "Xw": t(rng.standard_normal((m, 1))),
            "Xd": t(rng.standard_normal((m, 1))),
            "step_sz": torch.tensor(0.05, dtype=dtype)}
    names = plan.input_names()
    yield "l2-svm", plan, [nm for nm, var in zip(names, variables)
                           if var == "step_sz"], {
        nm: vals[var] for nm, var in zip(names, variables)}
    yield "ragged", RAGGED, ["s", "t"], {
        "i0": t(rng.standard_normal((m, n))),
        "i1": t(rng.standard_normal((1, n))),
        "i2": t(rng.standard_normal((m, 1))),
        "i3": t(rng.standard_normal((1, 1))),
        "s": torch.tensor(0.25, dtype=dtype),
        "t": torch.tensor(-0.5, dtype=dtype)}
    mag = lambda *shape: 0.5 + rng.random(shape)
    yield "every op", _every_op(), ["i3"], {
        "i0": t(np.sign(rng.standard_normal((m, n))) * mag(m, n)),
        "i1": t(np.sign(rng.standard_normal((1, n))) * mag(1, n)),
        "i2": t(mag(m, 1)), "i3": torch.tensor(1.7, dtype=dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hoisted_plan_evaluates_bit_for_bit(dtype):
    seen = set()
    for label, plan, scalars, env in _hoisted_env_cases(dtype):
        cell, subs = hoist(plan, scalars)
        assert subs, label
        assert not set(scalars) & set(cell.input_names()), label
        full = dict(env)
        for k, sub in enumerate(subs):
            assert set(sub.input_names()) <= set(scalars)
            full[f"{HOIST_PREFIX}{k}"] = emit(sub, env)
        want, got = emit(plan, env), emit(cell, full)
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want)), label
        seen.add(label)
    assert seen == {"summary", "l2-svm", "ragged", "every op"}


def test_hoist_takes_maximal_scalar_subtrees_once():
    # (s / c) twice, literal-only subtrees stay, a bare scalar leaf is one
    plan = _n("b(+)", _n("b(*)", _in("x"), _n("b(/)", _in("s"), _in("c"))),
              _n("b(-)", _n("b(/)", _in("s"), _in("c")),
                 _n("b(*)", _in("u"), _n("b(+)", _lit(1.0), _lit(2.0)))))
    cell, subs = hoist(plan, {"s", "c", "u"})
    assert [s.pretty() for s in subs] == ["b(/)(s, c)",
                                          "b(-)(b(/)(s, c), b(*)(u, "
                                          "b(+)(1.0, 2.0)))"]
    assert cell.pretty() == "b(+)(b(*)(x, _h0), _h1)"
    cell, subs = hoist(plan, set())
    assert subs == [] and cell.pretty() == plan.pretty()
    with pytest.raises(ValueError):
        hoist(_n("u(exp)", _in("_h0")), {"_h0"})


# --------------------------------------------------------------------------
# (b) the paths: hop-derived Variants equal env-derived ones
# --------------------------------------------------------------------------

def _path_runs(name):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((400, 12)).astype(np.float32)
    z = x @ rng.standard_normal((12, 1)).astype(np.float32)
    v = ((rng.random((150, 90)) < 0.1)
         * rng.integers(1, 11, (150, 90)) / 2.0).astype(np.float32)
    if name == "l2-svm":
        return (dmlFromFile(os.path.join(ALG, "l2-svm.dml")).input("X", x)
                .input("Y", np.where(z >= 0, 1.0, -1.0).astype(np.float32))
                .arg("maxiter", 3).output("w"))
    if name == "MultiLogReg":
        y = 1.0 + (np.argsort(np.argsort(z[:, 0])) * 5) // len(z)
        return (dmlFromFile(os.path.join(ALG, "MultiLogReg.dml"))
                .input("X", x).input("Y_vec", y.reshape(-1, 1)
                                     .astype(np.float32))
                .arg("moi", 2).output("B"))
    if name == "LinearRegCG":
        return (dmlFromFile(os.path.join(ALG, "LinearRegCG.dml"))
                .input("X", x).input("y", z).arg("maxi", 3).output("beta"))
    if name == "ALS-CG":
        return (dmlFromFile(os.path.join(ALG, "ALS-CG.dml")).input("V", v)
                .arg("rank", 10).arg("maxi", 2).arg("mii", 3)
                .output("L", "R"))
    return dml(SUMMARY).input("V", v).output("s", "lo", "hi")


@pytest.mark.parametrize("name", ["l2-svm", "MultiLogReg", "LinearRegCG",
                                  "ALS-CG", "summary"])
def test_path_variants_from_hops_equal_those_from_values(name):
    calls = []
    orig = compiler.execute_spoof

    def spy(h, args):
        t = h.params["template"]
        if t == "outer":
            sca = h.params["scalar_names"]
            env = dict(zip(sca, args[1:1 + len(sca)]))
            env.update(X=args[0], UV=0.0)
        else:
            env = dict(zip(h.params["leaf_names"], args))
        calls.append((h, t, env))
        return orig(h, args)

    compiler.execute_spoof = spy
    try:
        ml = MLContext(_cfg())
        ml.printer = lambda s: None
        ml.execute(_path_runs(name))
    finally:
        compiler.execute_spoof = orig
    assert calls
    walks = set()
    for h, t, env in calls:
        assert "variant" in h.params   # set by assign_variants
        hv = compiler.hop_variant(h)
        order = h.params["plan"].input_names()
        assert hv == kernels.env_variant(t, order, env, hv.aggs), \
            h.params["plan"].pretty()
        if t in ("cell", "multiagg") and kernels.spoof_layout_ok(order, env):
            classes = kernels.leaf_classes(h.params["plan"], t, env, hv)
            main = env[kernels._matrices(order, env)[0]]
            same_shape = all(env[nm].shape == main.shape
                             for nm in order if nm not in hv.scalars)
            assert ("general" not in classes.values()) == same_shape
            walks.add("flat" if same_shape else "general")
    want = {"MultiLogReg": {"flat", "general"}, "ALS-CG": {"general"}}
    assert walks == want.get(name, {"flat"})


def test_scalar_inference_is_sound_for_inputs_and_loops():
    """A program input read before any write is no scalar whatever its
    writes; a loop-carried variable first written with a literal is."""
    src = ("Y = 3 - 2 * Y\nacc = 0\ni = 0\nwhile (i < 2) {\n"
           "  acc = acc + sum(Y * Y + 1)\n  s = sum((Y - acc) ^ 2)\n"
           "  i = i + 1\n}\n")
    y = np.arange(12, dtype=np.float32).reshape(6, 2)
    calls = []
    orig = compiler.execute_spoof

    def spy(h, args):
        calls.append((compiler.hop_variant(h),
                      dict(zip(h.params["leaf_names"], args))))
        return orig(h, args)

    compiler.execute_spoof = spy
    try:
        MLContext(_cfg()).execute(dml(src).input("Y", y).output("acc"))
    finally:
        compiler.execute_spoof = orig
    assert calls
    for variant, env in calls:
        for nm, val in env.items():
            assert (nm in variant.scalars) == kernels.is_scalar_value(val)


# --------------------------------------------------------------------------
# (c) the leaf classifier
# --------------------------------------------------------------------------

def _ragged_env(m=101, n=7, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype)
    return {"i0": r(m, n), "i1": r(1, n), "i2": r(m, 1), "i3": r(1, 1),
            "s": 0.25, "t": torch.tensor(-0.5, dtype=torch.float64)}


def test_leaf_classes_of_every_layout():
    env = _ragged_env()
    variant = kernels.env_variant("cell", RAGGED.input_names(), env)
    assert variant.scalars == {"s", "t"} and variant.aliases == ()
    assert kernels.leaf_classes(RAGGED, "cell", env) == {
        "i0": "flat", "i1": "general", "s": "uniform", "i2": "general",
        "t": "uniform", "i3": "general"}


def test_launch_preparation_is_memoised_on_the_leaves_signature():
    """_prepare keeps a plan's prepared arguments per signature of its
    leaves: the same tensors again reuse them (a host number written
    anew), another tensor, shape or stride does not, and a leaf cast to
    the main leaf's dtype is never kept."""
    plan = _n("b(+)", _n("b(*)", _in("a"), _in("b")),
              _n("b(*)", _in("s"), _in("c")))
    m, n = 101, 8
    a, c = torch.randn(m, n), torch.randn(m, n)
    env = {"a": a, "b": a, "s": 0.5, "c": c}
    first = kernels._prepare(plan, "cell", env, a, None)
    variant, (ptrs, rs, cs, scal), classes, _ = first
    assert classes == ["flat", "alias", "uniform", "flat"]
    assert variant == kernels.env_variant("cell", plan.input_names(), env)
    assert scal[2] == 0.5
    memo = plan.__dict__["_spoof_prepared"]
    assert len(memo) == 1
    env["s"] = 2.0
    again = kernels._prepare(plan, "cell", env, a, None)
    assert again[0] is variant and again[1][0] is ptrs
    assert again[2] == classes and again[1][3][2] == 2.0 and len(memo) == 1
    # another tensor, a view of another stride: new entries, new classes
    env2 = dict(env, b=torch.randn(m, n))
    assert kernels._prepare(plan, "cell", env2, a, None)[2] == \
        ["flat", "flat", "uniform", "flat"]
    wide = torch.randn(m, n + 4)
    env3 = dict(env, c=wide[:, :n])
    assert kernels._prepare(plan, "cell", env3, a, None)[2] == \
        ["flat", "alias", "uniform", "general"]
    assert len(memo) == 3
    # a leaf of another dtype is cast each call: not kept
    env4 = dict(env, c=c.double())
    got = kernels._prepare(plan, "cell", env4, a, None)
    assert got[2] == ["flat", "alias", "uniform", "flat"] and got[3]
    assert len(memo) == 3
    # each answer is what the unmemoised classification gives
    for e in (env, env2, env3, env4):
        assert kernels._prepare(plan, "cell", e, a, None)[2] == \
            list(kernels.leaf_classes(plan, "cell", e).values())


def test_flat_needs_every_cell_leaf_aligned_contiguous_and_full():
    plan = _n("b(+)", _n("b(*)", _in("a"), _in("b")), _in("c"))
    m, n = 101, 7
    base = torch.randn(m + 1, n)
    wide = torch.randn(m, n + 3)
    ok = torch.randn(m, n)
    assert ok.data_ptr() % 16 == 0
    cases = [
        ({"a": ok, "b": torch.randn(m, n), "c": 2.0},
         {"a": "flat", "b": "flat", "c": "uniform"}),
        # X[1:] of a (m + 1, 7) fp32 matrix starts 28 bytes in
        ({"a": ok, "b": base[1:], "c": 2.0},
         {"a": "flat", "b": "general", "c": "uniform"}),
        # a column block of a wider matrix: rows apart by 10, not 7
        ({"a": ok, "b": wide[:, 2:2 + n], "c": 2.0},
         {"a": "flat", "b": "general", "c": "uniform"}),
        # the same tensor twice: an alias, read once
        ({"a": ok, "b": ok, "c": ok},
         {"a": "flat", "b": "alias", "c": "alias"}),
    ]
    for env, want in cases:
        assert kernels.leaf_classes(plan, "cell", env) == want
    # a one-column main leaf and a column of a wider matrix beside it
    col = {"a": torch.randn(m, 1), "b": wide[:, 4:5], "c": 1.0}
    assert kernels.leaf_classes(plan, "cell", col)["b"] == "general"
    # a source built for aliases, run on distinct tensors: general
    v = kernels.env_variant("cell", plan.input_names(),
                            {"a": ok, "b": ok, "c": ok})
    assert v.aliases == (("b", "a"), ("c", "a"))
    got = kernels.leaf_classes(plan, "cell",
                               {"a": ok, "b": ok.clone(), "c": ok}, v)
    assert got == {"a": "flat", "b": "general", "c": "alias"}
    # a scalar of the source must hold one value
    s = build.Variant(scalars=frozenset({"c"}))
    with pytest.raises(ValueError):
        kernels.leaf_classes(plan, "cell", {"a": ok, "b": ok, "c": ok}, s)


# --------------------------------------------------------------------------
# (d) the source's name
# --------------------------------------------------------------------------

def test_plan_source_names_follow_aggregates_scalars_and_aliases():
    V = build.Variant
    sc = frozenset({"i2", "i3"})
    al = (("i1", "i0"),)
    name = lambda t, v: build.plan_source(t, SUMMARY_PLAN, v)[0]
    base = name("multiagg", V(("sum", "min", "max"), sc, al))
    assert base == name("multiagg", V(("sum", "min", "max"), sc, al))
    others = [V(("max", "sum", "min"), sc, al), V(("sum", "min"), sc, al),
              V(("sum", "min", "max", "sum"), sc, al),
              V(("sum", "min", "max"), frozenset({"i2"}), al),
              V(("sum", "min", "max"), sc, ())]
    names = {name("multiagg", v) for v in others}
    assert base not in names and len(names) == len(others)
    assert name("cell", V((), sc, al)) != name("cell", V((), sc, ()))
    assert name("cell", V((), sc)) != name("cell", V())
    text = build.plan_source("multiagg", SUMMARY_PLAN,
                             V(("min", "sum"), sc, al))[1]
    assert "SPOOF_MULTIAGG_LAUNCHER(Plan, spoof::kMin, spoof::kSum)" in text
    assert "h[0] = op_div(LEAF(2), LEAF(3));" in text
    assert "op_sub(LEAF(1), HOISTED(0))" in text
    assert "i == 1 ? 0 :" in text   # i1 aliases i0
    many = ("max", "sum", "min") * 4   # any number of aggregates
    text = build.plan_source("multiagg", SUMMARY_PLAN, V(many, sc, al))[1]
    assert "SPOOF_MULTIAGG_LAUNCHER(Plan, " + ", ".join(
        "spoof::k" + a.capitalize() for a in many) + ")" in text
    with pytest.raises(ValueError):   # a multi-aggregate needs aggregates
        build.plan_source("multiagg", SUMMARY_PLAN, V())
    with pytest.raises(ValueError):   # and only it takes them
        build.plan_source("cell", SUMMARY_PLAN, V(("sum",)))
    with pytest.raises(ValueError):   # an alias of a later leaf
        build.plan_source("cell", SUMMARY_PLAN, V((), sc, (("i0", "i1"),)))
