"""The weighted quaternary ops of the port (systemml_tpu_torch/ops/mult.py,
runtime/sparse.q_*, hops/cost.quaternary_exploit, compiler/lower.
_quaternary) against the JAX package's, on the CPU.

The non-mesh cases of tests/test_quaternary.py, each through both
packages on the same numpy-seeded inputs (the JAX package at exec_mode
SINGLE_NODE), at relative 1e-9 in fp64:

1. capture: all five patterns (wsloss, wsigmoid, wdivmm, wcemm, wumm)
   become their q(...) hop at optlevel 2 in both compilers, and no
   matmult hop is left in the port's plan (checked on the hops; the JAX
   package's explain text waits for ROADMAP queue 1, CLI and io/);
2. equivalence: each pattern from DML on a dense X and on a CSR X, the
   port against the JAX package and against its own dense run, and the
   same path counter (spx_<op>_dense against spx_<op>_exploit_csr);
3. the kernels on CSR and ELL carriers against the JAX package's, every
   wsloss variant, wdivmm left and right, wsigmoid, wcemm, wumm;
4. the decision: quaternary_exploit's turn points against the JAX
   package's, a near-dense CSR carrier densifying, the "Sparse exec"
   stats line and the sparse_exec events, the negotiation with spoof at
   optlevel 3 (a dense tensor binding has no compile-time sparsity);
5. ALS-CG firing wdivmm on a CSR V, against the JAX package and the dense
   run.

Waiting, with their ROADMAP items: the four mesh cases (tests/
test_quaternary.py:308, :323, :364, :413; distributed and elastic) and
the densify lint (:485; observability and static analysis).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.hops import cost as jax_cost
from systemml_tpu.hops.hop import postorder as jax_postorder
from systemml_tpu.lang.parser import parse as jax_parse
from systemml_tpu.ops import mult as jax_mult
from systemml_tpu.runtime import program as JP
from systemml_tpu.runtime import sparse as jsp
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu.utils.config import set_config as jax_set_config
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.hops import cost
from systemml_tpu_torch.hops.hop import postorder
from systemml_tpu_torch.lang.parser import parse
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.ops import mult
from systemml_tpu_torch.runtime import program as P
from systemml_tpu_torch.runtime import sparse as sp
from systemml_tpu_torch.utils import stats as stats_mod
from systemml_tpu_torch.utils.config import DMLConfig, set_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR = 1e-9


@pytest.fixture(autouse=True)
def _port_config():
    set_config(DMLConfig(device="cpu"))
    yield
    set_config(DMLConfig())


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _sprand(rng, m, n, density, lo=-2.0, hi=2.0):
    a = lo + (hi - lo) * rng.random((m, n))
    return np.where(rng.random((m, n)) < density, a, 0.0)


_FACTORS = (
    "U = rand(rows=nrow(X), cols=4, min=-1, max=1, seed=5)\n"
    "V = rand(rows=ncol(X), cols=4, min=-1, max=1, seed=6)\n")
_PATTERNS = {
    "wsloss_post_nz": "z = sum((X != 0) * (X - U %*% t(V))^2)",
    "wsloss_post": ("W = X != 0\n"
                    "z = sum(W * (X - U %*% t(V))^2)"),
    "wsloss_none": "z = sum((X - U %*% t(V))^2)",
    "wsloss_pre": ("W = X != 0\n"
                   "z = sum((X - W * (U %*% t(V)))^2)"),
    "wsigmoid": "z = sum(abs(X * sigmoid(U %*% t(V))))",
    "wsigmoid_minus_log": "z = sum(abs(X * log(sigmoid(-(U %*% t(V))))))",
    "wdivmm_right_mult": "z = sum(abs((X * (U %*% t(V))) %*% V))",
    "wdivmm_left_div": "z = sum(abs(t(X / (U %*% t(V) + 7)) %*% U))",
    "wcemm": ("Up = rand(rows=nrow(X), cols=4, min=0.5, max=1.5, seed=7)\n"
              "Vp = rand(rows=ncol(X), cols=4, min=0.5, max=1.5, seed=8)\n"
              "z = sum(X * log(Up %*% t(Vp) + 2))"),
    "wumm": "z = sum(abs(X * exp(U %*% t(V))))",
}
_HOP_OF = {
    "wsloss_post_nz": "q(wsloss)", "wsloss_post": "q(wsloss)",
    "wsloss_none": "q(wsloss)", "wsloss_pre": "q(wsloss)",
    "wsigmoid": "q(wsigmoid)", "wsigmoid_minus_log": "q(wsigmoid)",
    "wdivmm_right_mult": "q(wdivmm)", "wdivmm_left_div": "q(wdivmm)",
    "wcemm": "q(wcemm)", "wumm": "q(wumm)",
}


def _jax_cfg(optlevel=2, codegen=False):
    cfg = JaxConfig(optlevel=optlevel, codegen_enabled=codegen)
    cfg.exec_mode = "SINGLE_NODE"
    return cfg


def _port_cfg(optlevel=2, codegen=False):
    cfg = DMLConfig(device="cpu")
    cfg.optlevel, cfg.codegen_enabled = optlevel, codegen
    return cfg


def _run_jax(src, x, optlevel=2, codegen=False):
    ml = JaxMLContext(_jax_cfg(optlevel, codegen))
    res = ml.execute(jax_dml(src).input("X", x).output("z"))
    return float(np.asarray(res.get("z"))), ml._stats


def _run_port(src, x, optlevel=2, codegen=False):
    ml = MLContext(_port_cfg(optlevel, codegen))
    res = ml.execute(dml(src).input("X", x).output("z"))
    return float(res.get_scalar("z")), ml._stats


def _ops(prog, iter_blocks, post):
    return [h.op for bb in iter_blocks(prog)
            for h in post(bb.hops.roots())]


# --------------------------------------------------------------------------
# 1. capture
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_PATTERNS))
def test_pattern_fires_and_product_is_gone(name):
    src = ("X = rand(rows=24, cols=18, min=-2, max=2, sparsity=0.1, "
           "seed=1)\n" + _FACTORS + _PATTERNS[name] + "\n")
    jax_set_config(_jax_cfg())
    jprog = JP.compile_program(jax_parse(src), outputs=["z"])
    set_config(_port_cfg())
    pprog = P.compile_program(parse(src), outputs=["z"])
    jops = _ops(jprog, JP.iter_basic_blocks, jax_postorder)
    pops = _ops(pprog, P.iter_basic_blocks, postorder)
    assert _HOP_OF[name] in pops and _HOP_OF[name] in jops
    assert "ba+*" not in pops and "ba+*" not in jops
    assert sorted(pops) == sorted(jops)
    fired = {k for k in pprog.stats.estim_counts if k.startswith("rw_q_")}
    assert fired == {k for k in jprog.stats.estim_counts
                     if k.startswith("rw_q_")} and fired


def test_all_five_families_have_fired_coverage():
    assert {_HOP_OF[n] for n in _PATTERNS} == {
        "q(wsloss)", "q(wsigmoid)", "q(wdivmm)", "q(wcemm)", "q(wumm)"}


# --------------------------------------------------------------------------
# 2. dense-vs-exploiting equivalence from DML, both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_PATTERNS))
@pytest.mark.parametrize("density", [0.01, 0.3])
def test_exploiting_matches_dense_and_jax(name, density, rng):
    x = _sprand(rng, 50, 40, density)
    src = _FACTORS + _PATTERNS[name] + "\n"
    zd, st_d = _run_port(src, x)
    zs, st_s = _run_port(src, ssp.csr_matrix(x))
    zjd, jst_d = _run_jax(src, x)
    zjs, jst_s = _run_jax(src, ssp.csr_matrix(x))
    assert zs == pytest.approx(zd, rel=1e-6, abs=1e-9), name
    assert zd == pytest.approx(zjd, rel=BAR, abs=1e-12)
    assert zs == pytest.approx(zjs, rel=BAR, abs=1e-12)
    for pst, jst in ((st_d, jst_d), (st_s, jst_s)):
        assert ({k for k in pst.estim_counts if k.startswith("spx_")}
                == {k for k in jst.estim_counts if k.startswith("spx_")})
    assert any(k.endswith("_dense") for k in st_d.estim_counts
               if k.startswith("spx_"))
    assert any("_exploit_" in k for k in st_s.estim_counts
               if k.startswith("spx_"))


# --------------------------------------------------------------------------
# 3. the kernels on CSR and ELL carriers
# --------------------------------------------------------------------------

def _carriers(x):
    jx, px = jsp.SparseMatrix.from_dense(x), sp.SparseMatrix.from_dense(x)
    je = jsp.EllMatrix(*jx.to_ell_device(), jx.shape)
    pe = sp.EllMatrix(*px.to_ell_device(), px.shape)
    return [(jx, px), (je, pe)]


def _val(v):
    if isinstance(v, (jsp.SparseMatrix, sp.SparseMatrix)):
        return v.to_numpy()
    if isinstance(v, (jsp.EllMatrix, sp.EllMatrix)):
        d = v.to_dense()
        return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same(got, ref, bar=BAR):
    g, r = _val(got), _val(ref)
    assert g.shape == r.shape
    nr = np.linalg.norm(r)
    assert np.linalg.norm(g - r) <= bar * (nr if nr else 1.0)


@pytest.mark.parametrize("density", [0.01, 0.3])
def test_wsloss_variants_kernel_level(density, rng):
    m, n, k = 40, 30, 3
    x = _sprand(rng, m, n, density)
    w = np.abs(_sprand(rng, m, n, density))
    u = rng.standard_normal((m, k))
    v = rng.standard_normal((n, k))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    uv = u @ v.T
    oracle = {"NONE": ((x - uv) ** 2).sum(),
              "POST_NZ": ((x != 0) * (x - uv) ** 2).sum()}
    for post in ("NONE", "POST_NZ"):
        for jc, pc in _carriers(x):
            got = mult.wsloss(pc, tu, tv, None, post)
            _same(got, jax_mult.wsloss(jc, ju, jv, None, post))
            assert float(got) == pytest.approx(oracle[post], rel=1e-9)
    jw, pw = jsp.SparseMatrix.from_dense(w), sp.SparseMatrix.from_dense(w)
    for post in ("POST", "PRE"):
        _same(mult.wsloss(torch.from_numpy(x), tu, tv, pw, post),
              jax_mult.wsloss(jnp.asarray(x), ju, jv, jw, post))
        # W's ELL view, and an X on W's pattern
        je = jsp.EllMatrix(*jw.to_ell_device(), jw.shape)
        pe = sp.EllMatrix(*pw.to_ell_device(), pw.shape)
        _same(mult.wsloss(torch.from_numpy(x), tu, tv, pe, post),
              jax_mult.wsloss(jnp.asarray(x), ju, jv, je, post))
        xs = pw.with_values(torch.from_numpy(
            rng.standard_normal(pw.nnz)))
        jxs = jsp.SparseMatrix(jw.indptr, jw.indices, xs.data.numpy(),
                               jw.shape)
        _same(mult.wsloss(xs, tu, tv, pw, post),
              jax_mult.wsloss(jxs, ju, jv, jw, post))


@pytest.mark.parametrize("density", [0.01, 0.3])
def test_wdivmm_and_unary_family_kernel_level(density, rng):
    m, n, k = 40, 30, 3
    x = _sprand(rng, m, n, density)
    u = rng.standard_normal((m, k))
    v = rng.standard_normal((n, k))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    for jc, pc in _carriers(x):
        for left, mw, eps in ((False, True, 0.0), (True, False, 0.5),
                              (True, True, 0.0), (False, False, 0.25)):
            _same(mult.wdivmm(pc, tu, tv, left, mw, eps),
                  jax_mult.wdivmm(jc, ju, jv, left, mw, eps))
        for flags in ("", "log", "minus", "minus log"):
            _same(mult.wsigmoid(pc, tu, tv, flags),
                  jax_mult.wsigmoid(jc, ju, jv, flags))
        _same(mult.wcemm(pc, tu.abs(), tv.abs(), eps=1.0),
              jax_mult.wcemm(jc, jnp.abs(ju), jnp.abs(jv), eps=1.0))
        for op, uop in (("*", "exp"), ("/", "exp"), ("*", "abs"),
                        ("*", "sqrt")):
            _same(mult.wumm(pc, tu.abs() if uop == "sqrt" else tu,
                            tv.abs() if uop == "sqrt" else tv, op, uop=uop),
                  jax_mult.wumm(jc, jnp.abs(ju) if uop == "sqrt" else ju,
                                jnp.abs(jv) if uop == "sqrt" else jv, op,
                                uop=uop))


def test_wsloss_post_dense_single_residual(rng):
    x, u, v = (rng.standard_normal((6, 5)), rng.standard_normal((6, 2)),
               rng.standard_normal((5, 2)))
    w = np.abs(rng.standard_normal((6, 5)))
    got = mult.wsloss(torch.from_numpy(x), torch.from_numpy(u),
                      torch.from_numpy(v), torch.from_numpy(w), "POST")
    ref = jax_mult.wsloss(jnp.asarray(x), jnp.asarray(u), jnp.asarray(v),
                          jnp.asarray(w), "POST")
    assert float(got) == pytest.approx(float(ref), rel=1e-12)
    assert float(got) == pytest.approx((w * (x - u @ v.T) ** 2).sum(),
                                       rel=1e-10)


def test_wumm_legacy_callable(rng):
    x, u, v = (rng.standard_normal((6, 5)), rng.standard_normal((6, 2)),
               rng.standard_normal((5, 2)))
    got = mult.wumm(torch.from_numpy(x), torch.from_numpy(u),
                    torch.from_numpy(v), "*", fn=torch.exp)
    ref = jax_mult.wumm(jnp.asarray(x), jnp.asarray(u), jnp.asarray(v),
                        "*", fn=jnp.exp)
    _same(got, ref)


# --------------------------------------------------------------------------
# 4. the decision layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("density,budget", [(1e-4, 64e9), (0.9, 64e9),
                                            (0.05, 1e6), (0.9, 1e6)])
def test_quaternary_exploit_turn_points(density, budget):
    m, n, k = 20000, 10000, 16
    got = cost.quaternary_exploit(m, n, k, nnz=m * n * density,
                                  hw=cost.HwProfile.cpu(),
                                  budget_bytes=budget)
    ref = jax_cost.quaternary_exploit(m, n, k, nnz=m * n * density,
                                      hw=jax_cost.HwProfile.cpu(),
                                      budget_bytes=budget)
    assert got == ref
    assert got == {(1e-4, 64e9): (True, "cheaper"),
                   (0.9, 64e9): (False, "dense_wins"),
                   (0.05, 1e6): (True, "infeasible"),
                   (0.9, 1e6): (False, "dense_wins")}[(density, budget)]


def test_quaternary_exploit_on_the_card_profile():
    """On the card the decision reads the H100's profile: the ALS-CG
    carriers of the two chip paths (MovieLens-10M- and Netflix-shaped,
    rank 10) sample, the first as cheaper, the second because its dense
    product passes a quarter of the 80 GB."""
    h100 = cost.HwProfile.h100()
    assert cost.quaternary_exploit(71567, 10681, 10, 10_000_054,
                                   hw=h100) == (True, "cheaper")
    assert cost.quaternary_exploit(480189, 17770, 10, 100_480_507,
                                   hw=h100) == (True, "infeasible")


def test_near_dense_csr_densifies(rng):
    x = _sprand(rng, 30, 20, 0.95)
    u = rng.standard_normal((30, 3))
    v = rng.standard_normal((20, 3))
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st):
        got = mult.wsloss(sp.SparseMatrix.from_dense(x), torch.from_numpy(u),
                          torch.from_numpy(v), None, "POST_NZ")
    ref = jax_mult.wsloss(jsp.SparseMatrix.from_dense(x), jnp.asarray(u),
                          jnp.asarray(v), None, "POST_NZ")
    assert float(got) == pytest.approx(float(ref), rel=BAR)
    assert st.estim_counts.get("spx_wsloss_densify", 0) == 1


def test_sparse_exec_stats_line_and_obs_events(rng):
    x = _sprand(rng, 40, 30, 0.05)
    src = _FACTORS + _PATTERNS["wdivmm_right_mult"] + "\n"
    ml = MLContext(_port_cfg())
    with obs.session() as rec:
        ml.execute(dml(src).input("X", ssp.csr_matrix(x)).output("z"))
    assert "Sparse exec (op_path=count): wdivmm_exploit_csr=1" in \
        ml._stats.display()
    evs = [e for e in rec.events() if e.name == "sparse_exec"]
    assert evs and evs[0].args.get("path") == "exploit_csr"


def test_negotiation_defers_unknown_sparsity_to_spoof(rng):
    """At optlevel 3 with codegen on, a carrier of unknown sparsity (a
    dense tensor binding: counting it would be a host read) keeps the raw
    pattern for spoof's outer template; at optlevel 2 the quaternary
    rewrite takes it; a known-sparse binding wins it at optlevel 3, as in
    the JAX package."""
    xd = _sprand(rng, 24, 18, 0.1)
    src = _FACTORS + _PATTERNS["wsloss_post_nz"] + "\n"
    x = torch.from_numpy(xd)
    _, st2 = _run_port(src, x, optlevel=2, codegen=False)
    assert st2.estim_counts.get("rw_q_wsloss", 0) >= 1
    z3, st3 = _run_port(src, x, optlevel=3, codegen=True)
    assert st3.estim_counts.get("rw_q_wsloss", 0) == 0
    zj3, jst3 = _run_jax(src, jnp.asarray(xd), optlevel=3, codegen=True)
    assert jst3.estim_counts.get("rw_q_wsloss", 0) == 0
    assert z3 == pytest.approx(zj3, rel=BAR)
    _, st3s = _run_port(src, ssp.csr_matrix(xd), optlevel=3, codegen=True)
    assert st3s.estim_counts.get("rw_q_wsloss", 0) >= 1


# --------------------------------------------------------------------------
# 5. ALS-CG fires wdivmm on a CSR V
# --------------------------------------------------------------------------

def test_als_cg_fires_wdivmm_and_matches_dense_and_jax(rng):
    src = open(os.path.join(ROOT, "scripts", "algorithms",
                            "ALS-CG.dml")).read()
    V = np.where(rng.random((120, 80)) < 0.05,
                 1.0 + 4.0 * rng.random((120, 80)), 0.0)

    def run(ml, script, xin):
        s = (script(src).input("V", xin).output("L", "R")
             .input("$rank", 3).input("$maxi", 2).input("$check", 1)
             .input("$mii", 2))
        return np.asarray(ml.execute(s).get_matrix("L")), ml._stats

    L_sp, st_sp = run(MLContext(_port_cfg()), dml, ssp.csr_matrix(V))
    L_d, _ = run(MLContext(_port_cfg()), dml, V)
    L_j, _ = run(JaxMLContext(_jax_cfg()), jax_dml, ssp.csr_matrix(V))
    assert st_sp.estim_counts.get("rw_q_wdivmm", 0) >= 1
    assert any(k.startswith("spx_wdivmm_exploit")
               for k in st_sp.estim_counts), st_sp.estim_counts
    np.testing.assert_allclose(L_sp, L_d, rtol=1e-5, atol=1e-8)
    assert np.linalg.norm(L_sp - L_j) <= BAR * np.linalg.norm(L_j)


# --------------------------------------------------------------------------
# the cumulative-aggregate tranche of tests/test_quaternary.py (structural)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    "X = rand(rows=16, cols=8, seed=1)\nz = sum(cumsum(X))\n",
    "E = rand(rows=5, cols=4, sparsity=0.0, seed=1)\n"
    "z = sum(abs(cummax(E)))\n"])
def test_cumagg_folds_out_of_the_plan(src):
    prog = P.compile_program(parse(src), outputs=["z"])
    assert not any(op.startswith("cum(")
                   for op in _ops(prog, P.iter_basic_blocks, postorder))
