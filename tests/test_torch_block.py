"""The whole-block compile (runtime/blockcompile.py) and superblocks,
against the JAX package on the CPU.

tests/test_superblock.py's cases through both packages' MLContext; a
block's plan keyed as the JAX package's _execute_fused keys it (a new
shape or a new value of a scalar that sizes something compiles again,
another value of any other scalar does not); the eager blocks counted by
reason (a sparse or compressed read, a list, a restore); the fusion that
XLA makes in the JAX package and the port's spoof selection makes only
with run-time dims: Kmeans's `rowSums(X ^ 2)` a row plan, `X ^ 2` never
formed; which blocks a CUDA graph may hold; and LinearRegCG, Kmeans and
GLM at optlevel 3 through the block compile at 1e-9 against the JAX
package.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import scipy.sparse
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.api.mlcontext import dmlFromFile as jax_file
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.hops.hop import postorder
from systemml_tpu_torch.lang.parser import parse
from systemml_tpu_torch.runtime import blockcompile
from systemml_tpu_torch.runtime import program as P
from systemml_tpu_torch.utils import config as port_config
from systemml_tpu_torch.utils.config import DMLConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALG = os.path.join(ROOT, "scripts", "algorithms")


def _cfg(optlevel=2):
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = optlevel
    return cfg


def _jcfg(optlevel=2):
    cfg = JaxConfig()
    cfg.optlevel = optlevel
    cfg.pallas_mode = "never"
    cfg.exec_mode = "SINGLE_NODE"
    return cfg


def _run(ctx, script, outs, inputs=None, args=None):
    for k, v in (inputs or {}).items():
        script.input(k, v)
    for k, v in (args or {}).items():
        script.arg(k, v)
    script.output(*outs)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = ctx.execute(script)
    return res, buf.getvalue()


def _value(res, name):
    v = res.get(name)
    if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0:
        return np.asarray(res.get_matrix(name), np.float64)
    return float(np.asarray(v))


def _compile(src, clargs=None, outputs=None, inputs=()):
    old = port_config.get_config()
    port_config.set_config(_cfg())
    try:
        return P.compile_program(parse(src), clargs=clargs or {},
                                 outputs=outputs, input_names=inputs)
    finally:
        port_config.set_config(old)


# ---- tests/test_superblock.py's cases, through both packages -------------

PRUNED = """
icpt = ifdef($icpt, 0)
a = sum(X)
if (icpt == 1) {
  X = cbind(X, matrix(1, rows=nrow(X), cols=1))
}
b = a * 2
fileB = ifdef($B, "")
c = b + 1
if (fileB != "") {
  write(X, $B)
}
d = c * c
"""


def test_pruned_guards_collapse_to_one_block():
    prog = _compile(PRUNED, inputs=("X",))
    assert len(prog.blocks) == 1 and isinstance(prog.blocks[0], P.BasicBlock)
    rp, _ = _run(MLContext(_cfg()), dml(PRUNED), ["d"],
                 {"X": np.ones((3, 3))})
    rj, _ = _run(JaxMLContext(_jcfg()), jax_dml(PRUNED), ["d"],
                 {"X": np.ones((3, 3))})
    assert _value(rp, "d") == _value(rj, "d") == ((9 * 2) + 1) ** 2


@pytest.mark.parametrize("optlevel", [2, 3])
def test_merge_preserves_read_before_write(optlevel):
    src = "a = 2\nb = a * 10\na = a + b\nc = a + b\n"
    rp, _ = _run(MLContext(_cfg(optlevel)), dml(src), ["a", "b", "c"])
    rj, _ = _run(JaxMLContext(_jcfg(optlevel)), jax_dml(src), ["a", "b", "c"])
    for n, want in (("a", 22), ("b", 20), ("c", 42)):
        assert _value(rp, n) == _value(rj, n) == want


def test_merge_across_loop_boundary_keeps_loops():
    src = ("s = 0.0\ni = 0\nwhile (i < 3) {\n  s = s + i\n  i = i + 1\n}\n"
           "t = s * 2\nu = t + 1\n")
    kinds = [type(b).__name__ for b in _compile(src).blocks]
    assert kinds.count("WhileBlock") == 1 and kinds.count("BasicBlock") == 2
    rp, _ = _run(MLContext(_cfg()), dml(src), ["u"])
    rj, _ = _run(JaxMLContext(_jcfg()), jax_dml(src), ["u"])
    assert _value(rp, "u") == _value(rj, "u") == 7.0


def test_merged_stats_block_prints_in_order():
    src = 'a = 1\nb = a + 1\nprint("a=" + a)\nc = b * 3\nprint("c=" + c)\n'
    rp, tp = _run(MLContext(_cfg()), dml(src), ["c"])
    rj, tj = _run(JaxMLContext(_jcfg()), jax_dml(src), ["c"])
    assert tp == tj == "a=1\nc=6\n"


def test_shape_scalar_from_prior_block():
    src = """
m = ncol(X)
fileB = ifdef($B, "")
if (fileB != "") {
  write(X, $B)
}
beta = matrix(0, rows=m, cols=1)
r = t(X) %*% y
s = sum(beta) + sum(r)
"""
    x = np.random.default_rng(3).random((20, 5))
    y = x @ np.ones((5, 1))
    rp, _ = _run(MLContext(_cfg(3)), dml(src), ["s"], {"X": x, "y": y})
    rj, _ = _run(JaxMLContext(_jcfg(3)), jax_dml(src), ["s"],
                 {"X": x, "y": y})
    np.testing.assert_allclose(_value(rp, "s"), _value(rj, "s"), rtol=1e-12)
    np.testing.assert_allclose(_value(rp, "s"), float((x.T @ y).sum()),
                               rtol=1e-9)


# ---- keys, plans, eager reasons -------------------------------------------

def test_analysis_matches_jax():
    """The copied block analysis gives the JAX package's partition."""
    from systemml_tpu.compiler.lower import analyze_block as jax_analyze
    from systemml_tpu.lang.parser import parse as jax_parse
    from systemml_tpu.runtime.program import compile_program as jax_compile
    from systemml_tpu_torch.compiler.lower import analyze_block

    src = ('k = ncol(X)\nM = matrix(0, rows=k, cols=2)\ns = sum(X)\n'
           'print("s=" + s)\nname = "a" + s\nY = X[1:k, ]\n')
    pb = _compile(src, inputs=("X",)).blocks[0]
    from systemml_tpu.utils import config as jcfg_mod

    saved = jcfg_mod.get_config()
    jcfg_mod.set_config(_jcfg())
    try:
        jb = jax_compile(jax_parse(src), input_names=("X",)).blocks[0]
    finally:
        jcfg_mod.set_config(saved)
    a, b = analyze_block(pb.hops), jax_analyze(jb.hops)
    assert a.jittable == b.jittable
    assert set(a.static_scalars) == set(b.static_scalars)
    assert set(a.fused_writes) == set(b.fused_writes)
    assert set(a.host_writes) == set(b.host_writes)
    assert a.fused_reads == b.fused_reads
    assert a.host_read_names == b.host_read_names


def _body_block(src, inputs=("X",), outputs=("s",)):
    prog = _compile(src, inputs=inputs, outputs=outputs)
    return prog, [b for b in P.iter_basic_blocks(prog)]


def test_key_by_shape_and_static_value():
    """A new shape compiles again; so does a new value of a scalar that
    sizes something (k); another value of any other scalar does not."""
    src = "M = matrix(1, rows=k, cols=2)\ns = sum(X) * a + sum(M)"
    prog = _compile(src, inputs=("X", "k", "a"), outputs=["s"])
    old = port_config.get_config()
    port_config.set_config(_cfg())
    try:
        for x, k, a in ((np.ones((4, 3)), 2, 1.5), (np.ones((4, 3)), 2, 2.5),
                        (np.ones((5, 3)), 2, 1.5), (np.ones((4, 3)), 3, 1.5)):
            ec = prog.execute(inputs={"X": torch.from_numpy(x), "k": k,
                                      "a": a})
            assert float(ec.vars["s"]) == x.sum() * a + 2 * k
    finally:
        port_config.set_config(old)
    assert prog.stats.compile_count == 3
    assert prog.stats.fused_blocks == 4


@pytest.mark.parametrize("kind", ["sparse", "compressed", "list"])
def test_eager_blocks_by_reason(kind):
    x = np.random.default_rng(4).random((300, 20))
    x[x < 0.95] = 0.0
    src = {"sparse": "s = sum(X * 2)",
           "compressed": "C = compress(X)\nfor (i in 1:1) { d = 0 }\n"
                         "s = sum(C %*% matrix(1, rows=ncol(C), cols=1))",
           "list": "L = list(X, 2)\nfor (i in 1:1) { d = 0 }\n"
                   "s = sum(as.matrix(L[1]))"}[kind]
    inp = scipy.sparse.csr_matrix(x) if kind == "sparse" else np.round(x)
    ml = MLContext(_cfg())
    rp, _ = _run(ml, dml(src), ["s"], {"X": inp})
    rj, _ = _run(JaxMLContext(_jcfg()), jax_dml(src), ["s"], {"X": inp})
    np.testing.assert_allclose(_value(rp, "s"), _value(rj, "s"), rtol=1e-9)
    assert ml._stats.eager_reasons[kind] >= 1


def test_restore_block_is_eager(tmp_path):
    ckpt = str(tmp_path / "c")
    ml = MLContext(_cfg())
    _run(ml, dml("W = matrix(3, rows=2, cols=2)\ncheckpoint($C)"), [],
         args={"C": ckpt})
    src = ("if (checkpointExists($C)) {\n  restore($C)\n} else {\n"
           "  W = matrix(0, rows=1, cols=1)\n}\ns = sum(W)")
    ml = MLContext(_cfg())
    rp, _ = _run(ml, dml(src).arg("C", ckpt), ["s"])
    assert _value(rp, "s") == 12.0
    assert ml._stats.eager_reasons["restore"] == 1


def test_graph_refusals_by_reason():
    prog, blocks = _body_block(
        'print("x")\ns = sum(X)', outputs=("s",))
    assert blockcompile._graph_refusal(blocks[0]) == "host op call:print"
    prog, blocks = _body_block('s = sum(X)\nname = "n" + s',
                               outputs=("s", "name"))
    assert blockcompile._graph_refusal(blocks[0]) == "host write"
    prog, blocks = _body_block("s = sum(X %*% t(X))", outputs=("s",))
    assert blockcompile._graph_refusal(blocks[0]) is None


@pytest.mark.parametrize("src,reason", [
    ("R = rand(rows=3, cols=2) * 2", "rand"),
    ("R = rand(rows=3, cols=2, seed=-1) * 2", "rand"),
    ("R = rand(rows=3, cols=2, seed=sd) * 2", "rand"),
    ("R = rand(rows=3, cols=2, seed=7) * 2", None),
    ("R = rand(rows=3, cols=2, seed=7)", "one op"),
    ("R = X %*% X", "one op")])
def test_graph_refusal_of_a_rand_from_the_host_stream_or_one_op(src,
                                                                reason):
    """A rand() whose key may come from the host's stream (no seed, -1,
    or a seed that is not a literal) keeps its block out of a graph,
    which would freeze the key of the capture; a block of one op keeps
    none either (one launch with or without it)."""
    prog, blocks = _body_block(src, inputs=("sd", "X"), outputs=("R",))
    assert blockcompile._graph_refusal(blocks[0]) == reason


def test_unseeded_rand_draws_anew_at_each_jmlc_call():
    """Four calls of a prepared unseeded rand() give four draws, equal
    bit for bit to four MLContext runs under the same global seed."""
    from systemml_tpu_torch.api.jmlc import Connection
    from systemml_tpu_torch.ops import datagen

    src = "R = rand(rows=100, cols=1)"
    ps = Connection(_cfg()).prepare_script(src, input_names=[],
                                           output_names=["R"])
    got, ref = [], []
    datagen.set_global_seed(11)
    try:
        got = [ps.execute({}).get_tensor("R").clone() for _ in range(4)]
        datagen.set_global_seed(11)
        ml = MLContext(_cfg())
        ref = [ml.execute(dml(src).output("R")).get_tensor("R")
               for _ in range(4)]
    finally:
        datagen.set_global_seed(None)
    assert all(not torch.equal(a, b) for i, a in enumerate(got)
               for b in got[i + 1:])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _spoof_templates(prog):
    out = []
    for bb in P.iter_basic_blocks(prog):
        for plan in bb._plans.values():
            for h in postorder(plan.hops.roots()):
                if h.op == "spoof":
                    out.append((h.params["template"],
                                h.params["plan"].pretty()))
    return out


def test_row_sums_of_square_is_a_row_plan_only_in_the_block_compile():
    """`rowSums(X ^ 2)` is one cellwise op under a row aggregate: the
    compile-time selection (MIN_FUSED_OPS 2, both packages) leaves it,
    and the block compile, with X's run-time dims, makes it a row plan,
    as XLA fuses it in the JAX package's whole-block jit."""
    src = "R = rowSums(X ^ 2)"
    x = np.random.default_rng(5).standard_normal((64, 9))
    progs = []
    orig = P.compile_program

    def keep(*a, **k):
        progs.append(orig(*a, **k))
        return progs[-1]

    import systemml_tpu_torch.api.mlcontext as M

    M.compile_program = keep
    try:
        rp, _ = _run(MLContext(_cfg(3)), dml(src), ["R"], {"X": x})
    finally:
        M.compile_program = orig
    compile_time = [h.op for bb in P.iter_basic_blocks(progs[0])
                    for h in postorder(bb.hops.roots())]
    assert "spoof" not in compile_time
    assert [t for t, _ in _spoof_templates(progs[0])] == ["row"]
    rj, _ = _run(JaxMLContext(_jcfg(3)), jax_dml(src), ["R"], {"X": x})
    np.testing.assert_allclose(_value(rp, "R"), _value(rj, "R"), rtol=1e-12)
    # a column vector's square is left unfused: no temporary worth it
    rp, _ = _run(MLContext(_cfg(3)), dml("s = sum(y ^ 2)"), ["s"],
                 {"y": x[:, :1]})
    np.testing.assert_allclose(_value(rp, "s"), float((x[:, 0] ** 2).sum()),
                               rtol=1e-12)


def test_no_block_plans_below_optlevel_3():
    """Below optlevel 3 the block compile selects no plan: the block runs
    its own hops, and no spoof kernel launches at optlevel 2."""
    x = np.random.default_rng(5).standard_normal((64, 9))
    ml = MLContext(_cfg(2))
    rp, _ = _run(ml, dml("R = rowSums(X ^ 2)"), ["R"], {"X": x})
    np.testing.assert_allclose(_value(rp, "R"),
                               (x ** 2).sum(1, keepdims=True), rtol=1e-12)
    assert ml._stats.fused_blocks >= 1
    assert ml._stats.estim_counts.get("block_spoof_plans", 0) == 0


@pytest.mark.parametrize("optlevel", [2, 3])
def test_kmeans_through_the_block_compile_matches_jax(optlevel):
    x = np.random.default_rng(6).standard_normal((300, 8))
    args = {"k": 3, "maxi": 6, "runs": 1, "seed": 7}
    ml = MLContext(_cfg(optlevel))
    rp, tp = _run(ml, dmlFromFile(os.path.join(ALG, "Kmeans.dml")),
                  ["C_out"], {"X": x}, args)
    rj, tj = _run(JaxMLContext(_jcfg(optlevel)),
                  jax_file(os.path.join(ALG, "Kmeans.dml")), ["C_out"],
                  {"X": x}, args)
    np.testing.assert_allclose(_value(rp, "C_out"), _value(rj, "C_out"),
                               rtol=1e-9, atol=1e-12)
    assert tp == tj
    assert ml._stats.fused_blocks >= 1
    if optlevel == 3:
        assert ml._stats.estim_counts["block_spoof_plans"] >= 1


@pytest.mark.parametrize("name,args", [
    ("LinearRegCG.dml", {"maxi": 20, "tol": 1e-9, "reg": 1e-6}),
    ("GLM.dml", {"dfam": 1, "vpow": 1, "link": 1, "lpow": 0, "moi": 5,
                 "tol": 1e-8, "reg": 1e-3})])
def test_algorithms_through_the_block_compile_match_jax(name, args):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((200, 6))
    y = (x @ rng.standard_normal((6, 1)) if name.startswith("Linear")
         else rng.poisson(2.0, (200, 1)).astype(np.float64))
    out = "beta"
    src = os.path.join(ALG, name)
    rp, _ = _run(MLContext(_cfg(3)), dmlFromFile(src), [out],
                 {"X": x, "y": y}, args)
    rj, _ = _run(JaxMLContext(_jcfg(3)), jax_file(src), [out],
                 {"X": x, "y": y}, args)
    np.testing.assert_allclose(_value(rp, out), _value(rj, out), rtol=1e-9,
                               atol=1e-12)


def test_codegen_off_blocks_still_compile():
    """The block compile runs whatever codegen_enabled says (it means
    the loop regions in the port): with regions and without, the blocks
    outside loops run through the same plans."""
    src = "R = rowSums(X ^ 2)\ns = 0\nfor (i in 1:3) { s = s + sum(R) * i }"
    x = np.random.default_rng(8).standard_normal((40, 5))
    got = []
    for regions in (True, False):
        cfg = _cfg(3)
        cfg.codegen_enabled = regions
        ml = MLContext(cfg)
        rp, _ = _run(ml, dml(src), ["s"], {"X": x})
        got.append((_value(rp, "s"), ml._stats.fused_blocks,
                    ml._stats.estim_counts["block_spoof_plans"]))
    assert got[0][0] == got[1][0]
    assert got[0][2] == got[1][2] == 1
