"""The sparse plane of the port (systemml_tpu_torch/runtime/sparse.py and
its branches in ops/, api/, compiler/, codegen/ and runtime/loopfuse.py)
against the JAX package's, on the CPU.

The same numpy- and scipy-seeded inputs go through the JAX package and the
port (`device="cpu"`); the JAX package runs with exec_mode SINGLE_NODE
(tests/conftest.py's virtual 8-device mesh would take its mesh arms,
which the port does not have yet). Bars: relative 1e-9 in fp64 (the
default on the CPU) and 1e-3 in fp32.

Cases:
(a) those of tests/test_sparse.py, each through both packages: the CSR
    representation and its conversions, the products (spmm on its three
    arms, gemm_sp, spgemm on both, sp_tsmm), the ELL spmv, the aggregates
    with their implicit zeros, sddmm on CSR, ELL and dense, and the DML
    scripts over a bound scipy matrix. Its two io cases (text and
    MatrixMarket round trips) wait for ROADMAP queue 1, CLI and io/;
(b) those of tests/test_sparse_consistency.py: ten DML programs across
    the sparse op surface at three densities, each through both packages
    on a SparseMatrix and on its dense form, a loop over a sparse
    invariant, and concat across formats (its double-float operand waits
    for ROADMAP queue 1, algorithm breadth and precision policies);
(c) those of tests/test_sparse_fused.py: the ELL view's mm, tmm,
    mul_dense, sums and the dense tsmm, and ALS with a sparse invariant in
    a loop region, its dense view and its ELL view (by
    ultra_sparsity_turn_point), against the eager run and the JAX package
    (its pytree-in-jit case is the port's loop-region capture, a card
    test in tests/test_torch_gpu.py);
(d) the slice: scripts/algorithms/ALS-CG.dml on a sparse V through both
    packages at optlevel 2 with regions and without, on the ELL arm
    (forced by ultra_sparsity_turn_point and by mem_budget_bytes), and the
    port at optlevel 3 against the JAX package at optlevel 2 (the JAX
    package's outer template raises NameError on a sparse X at optlevel
    3, ROADMAP queue 3): L, R and the printed loss at 1e-9, and no
    densify of V's shape on an ELL or CSR run;
(e) binding: a scipy matrix, a SparseMatrix and a torch sparse CSR tensor.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.ops import agg as jax_agg
from systemml_tpu.ops import reorg as jax_reorg
from systemml_tpu.runtime import sparse as jsp
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu.utils.config import get_config as jax_get_config
from systemml_tpu.utils.config import set_config as jax_set_config
from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.api.mlcontext import _unwrap_input
from systemml_tpu_torch.ops import agg, mult, reorg
from systemml_tpu_torch.runtime import loopfuse
from systemml_tpu_torch.runtime import program as P
from systemml_tpu_torch.runtime import sparse as sp
from systemml_tpu_torch.utils import stats as stats_mod
from systemml_tpu_torch.utils.config import DMLConfig, get_config, set_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALS = os.path.join(ROOT, "scripts", "algorithms", "ALS-CG.dml")


@pytest.fixture(autouse=True)
def _port_config():
    set_config(DMLConfig(device="cpu"))
    yield
    set_config(DMLConfig())


def _sprand(rng, m, n, density):
    a = rng.random((m, n))
    return np.where(rng.random((m, n)) < density, a, 0.0)


def _np(v):
    if isinstance(v, (sp.SparseMatrix, sp.EllMatrix)):
        return v.to_dense().numpy() if sp.is_ell(v) else v.to_numpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (jsp.SparseMatrix,)):
        return v.to_numpy()
    if isinstance(v, jsp.EllMatrix):
        return np.asarray(v.to_dense())
    return np.asarray(v)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / (nb if nb else 1.0)


def _close(got, ref, bar=1e-9):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape or g.size == r.size == 1, (g.shape, r.shape)
    assert _rel(g.reshape(r.shape), r) <= bar


def _pair(a):
    """The same matrix in both packages' SparseMatrix."""
    return jsp.SparseMatrix.from_dense(a), sp.SparseMatrix.from_dense(a)


@contextlib.contextmanager
def _stats():
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st):
        yield st


@contextlib.contextmanager
def _jax_stats():
    from systemml_tpu.utils import stats as jstats

    st = jstats.Statistics()
    tok = jstats.set_current(st)
    try:
        yield st
    finally:
        jstats.reset_current(tok)


# --------------------------------------------------------------------------
# (a) tests/test_sparse.py through both packages
# --------------------------------------------------------------------------

@pytest.fixture
def rng():
    return np.random.default_rng(5)


def test_roundtrip_dense(rng):
    a = _sprand(rng, 30, 20, 0.1)
    j, p = _pair(a)
    assert p.shape == j.shape == (30, 20)
    assert p.nnz == j.nnz == np.count_nonzero(a)
    np.testing.assert_array_equal(p.to_numpy(), j.to_numpy())
    np.testing.assert_array_equal(p.to_dense().numpy(), a)
    assert p.to_dense() is p.to_dense()     # the cached mirror


def test_from_coo_duplicates_summed():
    args = ([0, 0, 1], [0, 0, 2], [1.0, 2.0, 5.0], (3, 4))
    j, p = jsp.SparseMatrix.from_coo(*args), sp.SparseMatrix.from_coo(*args)
    assert p.nnz == j.nnz == 2
    np.testing.assert_array_equal(p.to_numpy(), j.to_numpy())


def test_maybe_sparsify_turn_point(rng):
    dense = rng.random((10, 10))
    assert not sp.is_sparse(sp.maybe_sparsify(torch.from_numpy(dense)))
    assert not jsp.is_sparse(jsp.maybe_sparsify(dense))
    a = _sprand(rng, 50, 50, 0.05)
    got = sp.maybe_sparsify(torch.from_numpy(a))
    assert sp.is_sparse(got) and jsp.is_sparse(jsp.maybe_sparsify(a))
    np.testing.assert_array_equal(sp.ensure_dense(got).numpy(), a)


def test_ultra_sparse_flag():
    args = ([0], [0], [1.0], (10000, 10000))
    assert sp.SparseMatrix.from_coo(*args).is_ultra_sparse()
    assert jsp.SparseMatrix.from_coo(*args).is_ultra_sparse()


def test_spmm_matches_jax(rng):
    a = _sprand(rng, 40, 30, 0.08)
    b = rng.random((30, 25))
    j, p = _pair(a)
    _close(sp.spmm(p, torch.from_numpy(b)), jsp.spmm(j, b))


def test_gemm_sp_matches_jax(rng):
    a = rng.random((20, 40))
    b = _sprand(rng, 40, 35, 0.07)
    j, p = _pair(b)
    _close(sp.gemm_sp(torch.from_numpy(a), p), jsp.gemm_sp(a, j))


def test_spgemm_sparse_output(rng):
    a = _sprand(rng, 60, 50, 0.02)
    b = _sprand(rng, 50, 55, 0.02)
    cfg = get_config().copy()
    cfg.mem_budget_bytes = 1e4
    set_config(cfg)
    jcfg = jax_get_config().copy()
    jcfg.mem_budget_bytes = 1e4
    jax_set_config(jcfg)
    (ja, pa), (jb, pb) = _pair(a), _pair(b)
    with _stats() as st:
        got = sp.spgemm(pa, pb)
    ref = jsp.spgemm(ja, jb)
    assert sp.is_sparse(got) and jsp.is_sparse(ref)
    assert st.estim_counts.get("spgemm_sparse") == 1
    _close(got, ref)


def test_spgemm_small_runs_dense(rng):
    a = _sprand(rng, 60, 50, 0.02)
    b = _sprand(rng, 50, 55, 0.02)
    (ja, pa), (jb, pb) = _pair(a), _pair(b)
    with _stats() as st:
        got = sp.spgemm(pa, pb)
    assert isinstance(got, torch.Tensor)
    assert st.estim_counts.get("spgemm_dense_mxu") == 1
    _close(got, jsp.spgemm(ja, jb))


@pytest.mark.parametrize("budget", [None, 1e3])
def test_sp_tsmm(rng, budget):
    """Both arms: the dense one within the budget, the CSR one past it."""
    cfg = get_config().copy()
    cfg.mem_budget_bytes = budget
    set_config(cfg)
    jcfg = jax_get_config().copy()
    jcfg.mem_budget_bytes = budget
    jax_set_config(jcfg)
    a = _sprand(rng, 50, 8, 0.1)
    j, p = _pair(a)
    for left in (True, False):
        with _stats() as st:
            got = sp.sp_tsmm(p, left=left)
        arm = "sp_tsmm_host" if budget else "sp_tsmm_dense_mxu"
        assert st.estim_counts.get(arm) == 1
        _close(got, jsp.sp_tsmm(j, left=left))


def test_ell_spmv(rng):
    a = _sprand(rng, 33, 21, 0.15)
    v = rng.random((21, 1))
    j, p = _pair(a)
    idx, val = p.to_ell(pad_to=8)
    jidx, jval = j.to_ell(pad_to=8)
    assert idx.shape[1] % 8 == 0 and tuple(idx.shape) == jidx.shape
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(val.numpy(), jval)
    _close(sp.ell_spmv(idx, val, torch.from_numpy(v)),
           jsp.ell_spmv(jidx, jval, v))


def test_value_map_and_aggregates(rng):
    a = _sprand(rng, 25, 15, 0.2)
    j, p = _pair(a)
    _close(p.scale(2.5), j.scale(2.5))
    _close(p.sum(), j.sum())
    _close(p.row_sums(), j.row_sums())
    _close(p.col_sums(), j.col_sums())
    for which in ("min", "max"):
        assert float(p.minmax(which)) == j.minmax(which)
    _close(p.transpose(), j.transpose())
    _close(p.slice(2, 10, 1, 7), j.slice(2, 10, 1, 7))
    # a second transpose of the pattern reuses its permutation
    assert p.scale(3.0).transpose().indices is p.transpose().indices


def test_minmax_all_negative_includes_zero():
    args = ([0, 1], [0, 1], [-3.0, -1.0], (5, 5))
    j, p = jsp.SparseMatrix.from_coo(*args), sp.SparseMatrix.from_coo(*args)
    assert float(p.minmax("max")) == j.minmax("max") == 0.0
    assert float(p.minmax("min")) == j.minmax("min") == -3.0


def _jax_cfg(**kw):
    cfg = JaxConfig()
    cfg.exec_mode = "SINGLE_NODE"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _port_cfg(**kw):
    cfg = DMLConfig(device="cpu")
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _both(src, inputs, outputs, **kw):
    """The script through both packages: ({name: numpy} port, jax, port
    MLContext)."""
    js, ps = jax_dml(src), dml(src)
    for k, v in inputs.items():
        js.input(k, v)
        ps.input(k, v)
    jr = JaxMLContext(_jax_cfg(**kw)).execute(js.output(*outputs))
    ml = MLContext(_port_cfg(**kw))
    pr = ml.execute(ps.output(*outputs))
    out = {}
    for o in outputs:
        out[o] = (np.asarray(pr.get_matrix(o), np.float64),
                  np.asarray(jr.get_matrix(o), np.float64))
    return out, ml


def test_dml_sparse_input_linear_algebra(rng):
    X = ssp.csr_matrix(_sprand(rng, 80, 30, 0.05))
    w = rng.random((30, 1))
    out, _ = _both("yhat = X %*% w\nss = sum(X)\ncs = colSums(X)\n"
                   "Xt = t(X)\nG = Xt %*% X\n", {"X": X, "w": w},
                   ("yhat", "ss", "cs", "Xt", "G"))
    for name, (p, j) in out.items():
        assert _rel(p.reshape(j.shape), j) < 1e-9, name


def test_dml_sparse_scalar_ops_stay_sparse(rng):
    X = ssp.csr_matrix(_sprand(rng, 40, 40, 0.05))
    out, ml = _both("Y = X * 3\nZ = abs(Y)\ns = sum(Z)", {"X": X},
                    ("Y", "Z", "s"))
    for name, (p, j) in out.items():
        assert _rel(p.reshape(j.shape), j) < 1e-9, name
    assert "sparse_densify" not in ml._stats.estim_counts


def test_sparse_sparse_elementwise_and_masks(rng):
    """Two CSR matrices of other patterns: + and - (the union), * (the
    intersection), and the masks X != 0 and X > 0, each staying sparse."""
    a = _sprand(rng, 40, 30, 0.1) - 0.3 * (rng.random((40, 30)) < 0.05)
    b = _sprand(rng, 40, 30, 0.1)
    src = ("P = X + Y\nM = X - Y\nT = X * Y\nN = X != 0\nG = X > 0\n"
           "s = sum(P) + sum(M) + sum(T)")
    out, ml = _both(src, {"X": ssp.csr_matrix(a), "Y": ssp.csr_matrix(b)},
                    ("P", "M", "T", "N", "G", "s"))
    for name, (p, j) in out.items():
        assert _rel(p.reshape(j.shape), j) < 1e-12, name
    assert "sparse_densify" not in ml._stats.estim_counts


def test_nnz_and_scalar_extraction_sparse(rng):
    X = ssp.csr_matrix(_sprand(rng, 50, 40, 0.05))
    out, _ = _both("n = nnz(X)\ns = as.scalar(X[1, 1])\nS = X[1:30, 1:30]\n"
                   "B = X[1:50, 2:40]", {"X": X}, ("n", "s", "S", "B"))
    for name, (p, j) in out.items():
        assert _rel(p.reshape(j.shape), j) < 1e-9, name


def test_unwrap_dense_scipy_input_densifies(rng):
    dense_ish = ssp.csr_matrix(rng.random((20, 20)))
    assert not jsp.is_sparse(__import__(
        "systemml_tpu.api.mlcontext",
        fromlist=["_unwrap_input"])._unwrap_input(dense_ish))
    got = _unwrap_input(dense_ish, torch.device("cpu"))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), dense_ish.toarray())


def _spmm_arm(sm_j, sm_p, b):
    with _jax_stats() as jst:
        ref = jsp.spmm(sm_j, b)
    with _stats() as st:
        got = sp.spmm(sm_p, torch.from_numpy(b))
    _close(got, ref)
    return ({k for k in st.estim_counts if k.startswith("spmm_")},
            {k for k in jst.estim_counts if k.startswith("spmm_")})


def test_ultra_sparse_spmm_takes_ell_path():
    rs = np.random.RandomState(5)
    S = ssp.random(5000, 800, density=1e-5, random_state=rs, format="csr")
    S.data[:] = rs.standard_normal(S.nnz)
    j, p = jsp.SparseMatrix.from_scipy(S), sp.SparseMatrix.from_scipy(S)
    assert p.is_ultra_sparse() and p.ell_viable()
    for b in (rs.standard_normal((800, 4)), rs.standard_normal((800, 1))):
        arms = _spmm_arm(j, p, b)
        assert arms == ({"spmm_ell"}, {"spmm_ell"})


def test_ultra_sparse_heavy_row_falls_back_to_csr():
    rs = np.random.RandomState(6)
    S = ssp.random(20000, 800, density=1e-5, random_state=rs, format="lil")
    S[0, :400] = rs.standard_normal(400)
    S = S.tocsr()
    j, p = jsp.SparseMatrix.from_scipy(S), sp.SparseMatrix.from_scipy(S)
    assert p.is_ultra_sparse() and not p.ell_viable()
    assert _spmm_arm(j, p, rs.standard_normal((800, 4))) == (
        {"spmm_bcoo"}, {"spmm_bcoo"})


def test_spmm_large_small_output_arm():
    """nnz >= 1e6 with an output of <= 1e7 cells and no CSR tensor yet:
    the JAX package's host arm, a transient CSR product in the port; once
    the matrix has its CSR tensor, the cached one."""
    rs = np.random.RandomState(7)
    S = ssp.random(2000, 1000, density=0.5, random_state=rs, format="csr")
    j, p = jsp.SparseMatrix.from_scipy(S), sp.SparseMatrix.from_scipy(S)
    cfg = get_config().copy()
    cfg.sparsity_turn_point = 0.6
    set_config(cfg)
    jcfg = jax_get_config().copy()
    jcfg.sparsity_turn_point = 0.6
    jax_set_config(jcfg)
    b = rs.standard_normal((1000, 3))
    assert _spmm_arm(j, p, b) == ({"spmm_host_small_out"},
                                  {"spmm_host_small_out"})
    assert p._csr is None
    p.to_csr_tensor()
    assert _spmm_arm(j, p, b)[0] == {"spmm_bcoo"}


def test_sparse_minmax_mean_implicit_zeros_all_positive():
    args = ([0, 1, 2], [1, 2, 0], [2.0, 5.0, 3.0], (4, 4))
    j, p = jsp.SparseMatrix.from_coo(*args), sp.SparseMatrix.from_coo(*args)
    for op in ("min", "max", "mean", "sum", "sumsq", "nnz"):
        assert float(agg.agg(op, p, "all")) == pytest.approx(
            float(jax_agg.agg(op, j, "all")), rel=1e-12), op
    assert float(agg.agg("min", p, "all")) == 0.0


def test_sparse_minmax_mean_implicit_zeros_all_negative():
    args = ([0, 3], [0, 3], [-4.0, -0.5], (4, 4))
    j, p = jsp.SparseMatrix.from_coo(*args), sp.SparseMatrix.from_coo(*args)
    for op in ("min", "max", "mean"):
        assert float(agg.agg(op, p, "all")) == pytest.approx(
            float(jax_agg.agg(op, j, "all")), rel=1e-12), op
    assert float(agg.agg("max", p, "all")) == 0.0
    for d in ("row", "col"):
        _close(agg.agg("sum", p, d), jax_agg.agg("sum", j, d))
        _close(agg.agg("max", p, d), jax_agg.agg("max", j, d))


def test_sparse_minmax_fully_dense_stored_no_phantom_zero():
    j, p = _pair(np.full((3, 3), 2.0))
    assert p.nnz == 9
    assert float(p.minmax("min")) == j.minmax("min") == 2.0
    assert float(p.minmax("max")) == j.minmax("max") == 2.0


def test_sparse_aggregates_from_dml_with_implicit_zeros():
    X = ssp.csr_matrix(([1.5, 2.5], ([0, 2], [1, 3])), shape=(5, 6))
    out, _ = _both("a = min(X)\nb = max(X)\nc = mean(X)", {"X": X},
                   ("a", "b", "c"))
    for name, (p, j) in out.items():
        assert p.item() == pytest.approx(j.item(), rel=1e-12), name
    assert out["a"][0].item() == 0.0


def test_ell_viable_boundary_cases():
    cases = [np.zeros((10, 10)), np.zeros((0, 5))]
    uniform = np.zeros((64, 64))
    uniform[:, 0] = 1.0
    heavy = np.zeros((2000, 600))
    heavy[0, :512] = 1.0
    heavy[1:, 0] = 1.0
    cases += [uniform, heavy]
    for a in cases:
        j, p = _pair(a)
        assert p.ell_viable() == j.ell_viable()
        assert p.ell_viable(max_blowup=600.0) == j.ell_viable(
            max_blowup=600.0)
    assert not sp.SparseMatrix.from_dense(heavy).ell_viable()
    assert sp.SparseMatrix.from_dense(heavy).ell_viable(max_blowup=600.0)


def test_to_ell_round_trip_and_device_mirror(rng):
    a = np.where(rng.random((37, 23)) < 0.2, rng.standard_normal((37, 23)),
                 0.0)
    j, p = _pair(a)
    idx, val = p.to_ell(pad_to=8)
    np.testing.assert_array_equal(idx.numpy(), j.to_ell(pad_to=8)[0])
    d1, d2 = p.to_ell_device(), p.to_ell_device()
    assert d1[0] is d2[0] and d1[1] is d2[1]
    e = sp.EllMatrix(d1[0], d1[1], p.shape)
    np.testing.assert_array_equal(e.to_dense().numpy(), a)
    # a value map shares the pattern's slot grid: one index tensor
    w = p.value_map(lambda d: (d != 0).to(d.dtype))
    assert w.to_ell_device()[0] is d1[0]
    np.testing.assert_array_equal(e.to_csr().to_numpy(), a)


@pytest.mark.parametrize("density", [0.2, 1e-5])
def test_sddmm_matches_jax(density, rng):
    m, n, d = (60, 50, 4) if density > 1e-3 else (4000, 700, 4)
    x = np.where(rng.random((m, n)) < density,
                 rng.standard_normal((m, n)), 0.0)
    a = rng.standard_normal((m, d))
    b = rng.standard_normal((d, n))
    j, p = _pair(x)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = sp.sddmm(p, ta, tb)
    assert sp.is_sparse(got)
    _close(got, jsp.sddmm(j, a, b))
    if p.ell_viable():
        e = sp.EllMatrix(*p.to_ell_device(), p.shape)
        je = jsp.EllMatrix(*j.to_ell_device(), j.shape)
        got_e = sp.sddmm(e, ta, tb)
        assert sp.is_ell(got_e)
        _close(got_e, jsp.sddmm(je, jnp.asarray(a), jnp.asarray(b)))
    _close(sp.sddmm(torch.from_numpy(x), ta, tb),
           jsp.sddmm(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))


# --------------------------------------------------------------------------
# (b) tests/test_sparse_consistency.py through both packages
# --------------------------------------------------------------------------

_PROGRAMS = [
    "z = sum(S %*% t(D))",
    "z = sum(t(S) %*% D)",
    "z = sum(S * 2 + 0)",
    "z = sum(abs(S)) + sum(S * S)",
    "z = sum(rowSums(S)) + sum(colSums(S) ^ 2)",
    "z = sum(S[1:20, 1:15])",
    "z = sum((S != 0) * D[1:nrow(S), 1:ncol(S)])",
    "z = sum(S %*% t(S[1:nrow(S), 1:ncol(S)]))",
    "z = sum(t(D) %*% S)",
    "z = sum(max(S, 0)) - sum(min(S, 0))",
]


@pytest.mark.parametrize("density", [0.3, 0.01, 0.0005])
@pytest.mark.parametrize("pi", range(len(_PROGRAMS)))
def test_sparse_dense_equivalence(density, pi):
    rng = np.random.default_rng(pi * 17 + int(density * 10000))
    m = ssp.random(40, 30, density=density, format="csr", random_state=7,
                   dtype=np.float64)
    m.data = m.data - 0.5
    D = rng.standard_normal((40, 30))
    src = _PROGRAMS[pi]
    zs = {}
    for label, s_in in (("sparse", None), ("dense", m.toarray())):
        js = jax_dml(src).input("D", D).input(
            "S", jsp.SparseMatrix.from_scipy(m) if s_in is None else s_in)
        ps = dml(src).input("D", D).input(
            "S", sp.SparseMatrix.from_scipy(m) if s_in is None else s_in)
        zj = float(JaxMLContext(_jax_cfg()).execute(
            js.output("z")).get_scalar("z"))
        zp = float(MLContext(_port_cfg()).execute(
            ps.output("z")).get_scalar("z"))
        assert zp == pytest.approx(zj, rel=1e-9, abs=1e-12), (label, src)
        zs[label] = zp
    assert zs["sparse"] == pytest.approx(zs["dense"], rel=1e-9, abs=1e-9)


LOOP_SRC = """
acc = matrix(0, rows=ncol(S), cols=1)
v = matrix(1, rows=ncol(S), cols=1) / ncol(S)
for (i in 1:5) {
  v = t(S) %*% (S %*% v)
  n = sqrt(sum(v ^ 2))
  v = v / n
  acc = acc + v
}
z = sum(acc)
"""


def test_sparse_dense_equivalence_in_loop():
    m = ssp.random(60, 25, density=0.01, format="csr", random_state=3,
                   dtype=np.float64)
    m.data = 1.0 + m.data
    zj = float(JaxMLContext(_jax_cfg()).execute(
        jax_dml(LOOP_SRC).input("S", jsp.SparseMatrix.from_scipy(m))
        .output("z")).get_scalar("z"))
    for s_in in (sp.SparseMatrix.from_scipy(m), m.toarray()):
        zp = float(MLContext(_port_cfg()).execute(
            dml(LOOP_SRC).input("S", s_in).output("z")).get_scalar("z"))
        assert zp == pytest.approx(zj, rel=1e-9)


def test_concat_mixed_formats():
    S = np.eye(3)
    D = np.ones((3, 2))
    js, ps = _pair(S)
    for fn, jfn, args, jargs in (
            (reorg.cbind, jax_reorg.cbind, (ps, torch.from_numpy(D)),
             (js, jnp.asarray(D))),
            (reorg.rbind, jax_reorg.rbind, (ps, ps), (js, js))):
        np.testing.assert_array_equal(_np(fn(*args)), _np(jfn(*jargs)))


# --------------------------------------------------------------------------
# (c) tests/test_sparse_fused.py through both packages
# --------------------------------------------------------------------------

@pytest.fixture
def sp_data():
    d = np.random.default_rng(7).random((40, 12))
    d[d < 0.8] = 0.0
    return d


def _ells(a):
    j, p = _pair(a)
    return (jsp.EllMatrix(*j.to_ell_device(), j.shape),
            sp.EllMatrix(*p.to_ell_device(), p.shape))


def test_ell_matmult_and_tmm(sp_data):
    rng = np.random.default_rng(8)
    je, pe = _ells(sp_data)
    b = rng.random((12, 3))
    u = rng.random((40, 3))
    _close(pe.mm(torch.from_numpy(b)), je.mm(jnp.asarray(b)))
    _close(pe.tmm(torch.from_numpy(u)), je.tmm(jnp.asarray(u)))
    _close(pe.to_dense(), je.to_dense())


def test_ell_mul_dense_and_sum(sp_data):
    d = np.random.default_rng(9).random((40, 12))
    je, pe = _ells(sp_data)
    _close(pe.mul_dense(torch.from_numpy(d)), je.mul_dense(jnp.asarray(d)))
    _close(pe.sum(), je.sum())
    _close(pe.row_sums(), je.row_sums())


def test_ell_ops_in_a_loop_region(sp_data):
    """The port's counterpart of the JAX package's EllMatrix-in-jit case:
    ELL ops inside a loop region's body (the plain arm on the CPU; the
    capture is a card test)."""
    src = ("acc = 0\nfor (i in 1:4) {\n  acc = acc + sum(S %*% B) + i\n}\n")
    m = ssp.csr_matrix(sp_data)
    B = np.random.default_rng(10).random((12, 2))
    outs = {}
    for ultra in (1e-12, 0.5):
        cfg = _port_cfg(ultra_sparsity_turn_point=ultra)
        ml = MLContext(cfg)
        prog_src = dml(src).input("S", m).input("B", B).output("acc")
        outs[ultra] = float(ml.execute(prog_src).get_scalar("acc"))
    assert outs[0.5] == pytest.approx(outs[1e-12], rel=1e-12)
    assert outs[0.5] == pytest.approx(4 * (sp_data @ B).sum() + 10,
                                      rel=1e-12)


def test_sp_tsmm_densify_by_cost(sp_data):
    j, p = _pair(sp_data)
    _close(sp.sp_tsmm(p, left=True), jsp.sp_tsmm(j, left=True))


ALS_SRC = """
rank = ifdef($rank, 4)
reg = ifdef($reg, 0.01)
n = nrow(V)
m = ncol(V)
W = (V != 0)
L = 0.1 * rand(rows=n, cols=rank, seed=7)
R = 0.1 * rand(rows=m, cols=rank, seed=8)
iter = 0
while (iter < 3) {
  G = -((W * (V - L %*% t(R))) %*% R) + reg * L
  P = -G
  rr = sum(G ^ 2)
  k = 0
  while (k < 2 & rr > 0.0000000001) {
    HP = (W * (P %*% t(R))) %*% R + reg * P
    alpha = rr / sum(P * HP)
    L = L + alpha * P
    G = G + alpha * HP
    rr_new = sum(G ^ 2)
    P = -G + (rr_new / rr) * P
    rr = rr_new
    k = k + 1
  }
  iter = iter + 1
}
loss = sum((W * (V - L %*% t(R))) ^ 2)
"""


def _fused_als(v_in, codegen, **kw):
    ml = MLContext(_port_cfg(codegen_enabled=codegen, **kw))
    s = dml(ALS_SRC).input("V", v_in).arg("rank", 4).arg("reg", 0.01)
    r = ml.execute(s.output("loss", "L"))
    return float(r.get_scalar("loss")), r.get_matrix("L"), ml


def _jax_fused_als(v_in, **kw):
    s = jax_dml(ALS_SRC).input("V", v_in).arg("rank", 4).arg("reg", 0.01)
    r = JaxMLContext(_jax_cfg(**kw)).execute(s.output("loss", "L"))
    return float(r.get_scalar("loss")), np.asarray(r.get_matrix("L"))


@pytest.mark.parametrize("m,density,kw,view", [
    (300, 0.01, {}, "dense"),
    (4000, 0.001, {"ultra_sparsity_turn_point": 0.002}, "ell")])
def test_als_fused_matches_eager_and_jax(m, density, kw, view,
                                         monkeypatch):
    """(V - L %*% t(R)) densifies V inside the body here, in both
    packages (an ELL minus a dense matrix has no sparse form); ALS-CG.dml
    is written so that nothing does (the slice's tests below)."""
    progs = []
    run = P.Program.execute
    monkeypatch.setattr(P.Program, "execute", lambda self, *a, **k: (
        progs.append(self), run(self, *a, **k))[1])
    mat = ssp.random(m, 60 if view == "dense" else 50, density=density,
                     format="csr", random_state=3 if view == "dense" else 5,
                     dtype=np.float64)
    mat.data = 1.0 + mat.data
    loss_f, L_f, ml = _fused_als(sp.SparseMatrix.from_scipy(mat), True, **kw)
    loss_h, L_h, _ = _fused_als(sp.SparseMatrix.from_scipy(mat), False, **kw)
    loss_j, L_j = _jax_fused_als(jsp.SparseMatrix.from_scipy(mat), **kw)
    assert loss_f == pytest.approx(loss_h, rel=1e-9)
    assert loss_f == pytest.approx(loss_j, rel=1e-9)
    assert _rel(L_f, L_h) < 1e-9 and _rel(L_f, L_j) < 1e-9
    assert ml._stats.region_counts, "the sparse loop ran as a region"
    recs = [r for r in loopfuse.region_report(progs[0]) if r.get("views")]
    assert recs and recs[0]["views"] == {"V": view, "W": view}


# --------------------------------------------------------------------------
# (d) the slice: ALS-CG.dml on a sparse V through both packages
# --------------------------------------------------------------------------

def _ratings_csr(seed=3, m=400, n=150, density=0.03):
    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(0.5, 5.0, (m, n)) * 2) / 2
    return ssp.csr_matrix(np.where(rng.random((m, n)) < density, v, 0.0))


def _run_als(ml, script, v):
    s = script.input("V", v).arg("rank", 10).arg("maxi", 3).arg("mii", 3)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ml.execute(s.output("L", "R"))
    line = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("ALS-CG: iterations")]
    assert len(line) == 1
    return res.get_matrix("L"), res.get_matrix("R"), \
        float(line[0].rsplit("=", 1)[1])


_JAX_ALS = {}


def _jax_als(v_key, v, **kw):
    key = (v_key, tuple(sorted(kw.items())))
    if key not in _JAX_ALS:
        _JAX_ALS[key] = _run_als(JaxMLContext(_jax_cfg(optlevel=2, **kw)),
                                 jax_dml_file(ALS), v)
    return _JAX_ALS[key]


ALS_CASES = [
    # (port optlevel, regions, extra config, expected views)
    (2, True, {}, "dense"),
    (2, False, {}, None),
    (2, True, {"ultra_sparsity_turn_point": 0.05}, "ell"),
    (2, True, {"mem_budget_bytes": 4e6}, "ell"),
    (3, True, {}, "dense"),
    (3, False, {}, None),
    (3, True, {"mem_budget_bytes": 4e6}, "ell"),
    (3, True, {"ultra_sparsity_turn_point": 0.05}, "ell"),
]


@pytest.mark.parametrize("optlevel,regions,kw,views", ALS_CASES)
def test_als_cg_sparse_v_matches_jax(optlevel, regions, kw, views,
                                     monkeypatch):
    progs, products = [], []
    run = P.Program.execute
    monkeypatch.setattr(P.Program, "execute", lambda self, *a, **k: (
        progs.append(self), run(self, *a, **k))[1])
    mm = mult.matmult
    monkeypatch.setattr(mult, "matmult", lambda a, b: (
        lambda r: (products.append(tuple(r.shape)), r)[1])(mm(a, b)))
    V = _ratings_csr()
    jL, jR, jloss = _jax_als("r3", V, codegen_enabled=regions, **kw)
    sp.DENSIFY_COUNTS.clear()
    ml = MLContext(_port_cfg(optlevel=optlevel, codegen_enabled=regions,
                             **kw))
    script = dmlFromFile(ALS)
    pL, pR, ploss = _run_als(ml, script, V)
    assert _rel(pL, jL) < 1e-9 and _rel(pR, jR) < 1e-9
    assert ploss == pytest.approx(jloss, rel=1e-9)
    dens = dict(sp.DENSIFY_COUNTS)
    shapes = {V.shape, V.shape[::-1]}
    if views == "dense":
        assert set(dens) <= shapes and dens
    else:
        # nothing of V's shape is densified, and no (users, movies)
        # product is formed: not even by the loss check, which reads
        # L %*% t(R) twice
        assert not (set(dens) & shapes), dens
        assert not (set(products) & shapes), products
    recs = [r for r in loopfuse.region_report(progs[-1]) if r.get("views")]
    if views is None:
        assert not ml._stats.region_counts
    else:
        assert recs and all(set(r["views"].values()) == {views}
                            for r in recs)
        assert not ml._stats.estim_counts.get("loop_regions_refused")
    spx = {k for k in ml._stats.estim_counts if k.startswith("spx_")}
    if optlevel == 2 and views != "dense":
        assert spx == {"spx_wdivmm_exploit_ell" if views
                       else "spx_wdivmm_exploit_csr"}


def test_als_cg_fp32_sparse_v_matches_jax():
    V = _ratings_csr(seed=4)
    kw = {"floating_point_precision": "single"}
    jL, jR, jloss = _run_als(JaxMLContext(_jax_cfg(optlevel=2, **kw)),
                             jax_dml_file(ALS), V.astype(np.float32))
    for optlevel in (2, 3):
        pL, pR, ploss = _run_als(
            MLContext(_port_cfg(optlevel=optlevel, **kw)), dmlFromFile(ALS),
            V.astype(np.float32))
        assert pL.dtype == np.float32
        assert _rel(pL, jL) < 1e-3 and _rel(pR, jR) < 1e-3
        assert ploss == pytest.approx(jloss, rel=1e-3)


# --------------------------------------------------------------------------
# (e) binding
# --------------------------------------------------------------------------

def test_binds_scipy_sparsematrix_and_torch_csr(rng):
    a = _sprand(rng, 30, 20, 0.1)
    src = "s = sum(X)\nY = X * 2\nr = rowSums(X)"
    ref = {"s": a.sum(), "Y": a * 2, "r": a.sum(1, keepdims=True)}
    t = torch.from_numpy(a).to_sparse_csr()
    for bound in (ssp.csr_matrix(a), sp.SparseMatrix.from_dense(a), t,
                  torch.from_numpy(a).to_sparse()):
        ml = MLContext(_port_cfg())
        r = ml.execute(dml(src).input("X", bound).output("s", "Y", "r"))
        assert sp.is_sparse(r.get("Y"))
        assert r.get_tensor("Y").layout == torch.sparse_csr
        for k, v in ref.items():
            np.testing.assert_allclose(r.get_matrix(k).reshape(np.shape(v)),
                                       v, rtol=1e-12)
    # a torch CSR tensor binds its own tensors: no copy
    got = _unwrap_input(t, torch.device("cpu"))
    assert got.data.data_ptr() == t.values().data_ptr()


def test_input_sparsity_seeds_the_quaternary_rewrite(rng):
    """A bound sparse V is sparse at compile time: ALS's half-step
    W * (A %*% t(B)) %*% B becomes q(wdivmm) at optlevel 2, as in the JAX
    package, for each of the three sparse bindings."""
    a = _ratings_csr().toarray()
    for bound in (ssp.csr_matrix(a), sp.SparseMatrix.from_dense(a),
                  torch.from_numpy(a).to_sparse_csr()):
        ml = MLContext(_port_cfg(optlevel=2, codegen_enabled=False))
        _run_als(ml, dmlFromFile(ALS), bound)
        assert ml._stats.estim_counts.get("rw_q_wdivmm", 0) >= 1
