"""The port's algorithm-breadth ops against the JAX package's, on the CPU.

The same numpy-seeded inputs go through systemml_tpu/ops/{agg,datagen,
linalg,param,reorg}.py and their counterparts in systemml_tpu_torch/ops/.
Bars: relative 1e-9 in fp64, 1e-3 in fp32 (the reference's cross-backend
bars, BASELINE.md); seq and sample bit for bit (compared as bytes), at 1,
2 and 3 rounds of jax.random.permutation's sort shuffle (n = 1,000,
5,000 and 3,000,000) and with replacement; index results exactly.
Eigenvectors and singular vectors are unique only up to each column's
sign: they are compared through the products that cancel it, and after
fixing each column's sign. The cases are those of tests/test_ops.py
(TestAgg, TestReorg, TestLinalg, TestDatagen, TestParam, the column order
statistics, interQuantile), tests/test_runtime.py (eigen, qr and solve in
a script, table/order/removeEmpty, cdf) and tests/test_numerics_
validation.py (the compensated sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.ops import agg as jagg
from systemml_tpu.ops import datagen as jdatagen
from systemml_tpu.ops import linalg as jlinalg
from systemml_tpu.ops import param as jparam
from systemml_tpu.ops import reorg as jreorg
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.ops import agg, datagen, linalg, param, reorg
from systemml_tpu_torch.utils.config import DMLConfig

DTYPES = [(np.float64, torch.float64, 1e-9), (np.float32, torch.float32, 1e-3)]


def _t(a, tdt=torch.float64):
    return torch.from_numpy(np.array(a, dtype=np.float64)).to(tdt)


def _j(a, ndt=np.float64):
    return jnp.asarray(np.asarray(a, dtype=ndt))


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _close(got, ref, bar):
    got = np.asarray(_np(got), np.float64)
    ref = np.asarray(_np(ref), np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    same_nan = np.isnan(got) == np.isnan(ref)
    assert same_nan.all()
    g, r = np.nan_to_num(got), np.nan_to_num(ref)
    scale = max(1.0, float(np.max(np.abs(r), initial=0.0)))
    assert float(np.max(np.abs(g - r), initial=0.0)) <= bar * scale, (got, ref)


def _same_bits(got, ref):
    got, ref = np.atleast_1d(_np(got)), np.atleast_1d(_np(ref))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))


def _mat(rng, n=7, m=5):
    return rng.standard_normal((n, m))


# --------------------------------------------------------------------------
# aggregates (systemml_tpu/ops/agg.py:89-295)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["indexmax", "indexmin"])
@pytest.mark.parametrize("direction", ["row", "col"])
@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_index_aggregates_ties_and_nan(op, direction, ndt, tdt, bar):
    """1-based, in x's dtype; the first index wins a tie, and a NaN
    counts as the extreme, as jnp.argmax / argmin."""
    x = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, np.nan, 9.0, np.nan],
                  [-1.0, -1.0, -1.0, -1.0], [4.0, 4.0, -2.0, -2.0]])
    got = agg.agg(op, _t(x, tdt), direction)
    ref = jagg.agg(op, _j(x, ndt), direction)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("op", ["cumsum", "cumprod", "cummin", "cummax"])
@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_cumulative_aggregates(op, ndt, tdt, bar):
    rng = np.random.default_rng(3)
    x = 0.5 + rng.random((40, 6))
    x[7, 2] = np.nan
    _close(agg.cumagg(op, _t(x, tdt)), jagg.cumagg(op, _j(x, ndt)), bar)


@pytest.mark.parametrize("n", [1, 3, 64, 1001])
def test_cumsumprod(n):
    rng = np.random.default_rng(n)
    x = np.column_stack([rng.standard_normal(n), 0.9 * rng.random(n)])
    _close(agg.cumsumprod(_t(x)), jagg.cumsumprod(_j(x)), 1e-9)
    exp = [1.0, 2.0 + 0.5 * 1.0, 3.0 + 0.5 * 2.5]
    got = agg.cumsumprod(_t([[1.0, 0.5], [2.0, 0.5], [3.0, 0.5]]))
    np.testing.assert_allclose(_np(got).ravel(), exp)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_moment_and_cov(k, weighted):
    rng = np.random.default_rng(k)
    v, u = rng.standard_normal((50, 1)), rng.standard_normal((50, 1))
    w = 1.0 + rng.random((50, 1)) if weighted else None
    tw = None if w is None else _t(w)
    jw = None if w is None else _j(w)
    _close(agg.moment(_t(v), k, tw), jagg.moment(_j(v), k, jw), 1e-9)
    _close(agg.cov(_t(v), _t(u), tw), jagg.cov(_j(v), _j(u), jw), 1e-9)


@pytest.mark.parametrize("fn", ["count", "sum", "mean", "variance", "sd",
                                "centralmoment3"])
@pytest.mark.parametrize("weighted", [False, True])
def test_grouped_aggregate(fn, weighted):
    rng = np.random.default_rng(11)
    t = rng.standard_normal((300, 1))
    g = rng.integers(1, 6, (300, 1)).astype(float)
    g[:5] = 4.0
    w = rng.random((300, 1)) if weighted else None
    got = agg.aggregate_grouped(_t(t), _t(g), fn, 6,
                                None if w is None else _t(w))
    ref = jagg.aggregate_grouped(_j(t), _j(g), fn, 6,
                                 None if w is None else _j(w))
    _close(got, ref, 1e-9)


def test_segment_sum_drops_and_wraps_as_jnp():
    """Indices as jnp's .at[].add: a negative one counts from the end,
    one past the end is dropped."""
    idx = torch.tensor([0, 2, 2, -1, 7, 3, 0])
    vals = _t([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    ref = jnp.zeros(4).at[jnp.asarray(idx.numpy())].add(
        jnp.asarray(vals.numpy()))
    _close(agg.segment_sum(idx, vals, 4), ref, 0.0)
    cref = jnp.zeros(4).at[jnp.asarray(idx.numpy())].add(1.0)
    _close(agg.segment_count(idx, 4, torch.float64), cref, 0.0)


def test_kahan_sum_matches_jax_on_cancellation():
    """The compensated full sum folds as the JAX package's: the same fold
    order, so fp32 gives its bits; and it beats the plain sum."""
    rng = np.random.default_rng(0)
    x = rng.random(1 << 18).astype(np.float32)
    big = np.float32(3e7)
    arr = np.concatenate([[big], x, [-big]]).astype(np.float32)
    exact = x.astype(np.float64).sum()
    comp = agg.kahan_sum(torch.from_numpy(arr))
    _same_bits(comp, jagg.kahan_sum(jnp.asarray(arr)))
    plain = float(torch.sum(torch.from_numpy(arr)))
    assert abs(float(comp) - exact) / exact < 1e-6
    assert abs(float(comp) - exact) <= abs(plain - exact)


@pytest.mark.parametrize("axis", [0, 1])
def test_kahan_axis_sums_match_jax(axis):
    rng = np.random.default_rng(2)
    x = rng.random((1 << 12, 3)).astype(np.float32)
    x[0, :], x[1, :] = 3e7, -3e7
    if axis == 1:
        x = np.ascontiguousarray(x.T)
    _same_bits(agg.kahan_sum_axis(torch.from_numpy(x), axis),
               jagg.kahan_sum_axis(jnp.asarray(x), axis))


@pytest.mark.parametrize("direction,out", [("all", "s"), ("row", "r"),
                                           ("col", "c")])
def test_compensated_sum_config_reaches_dml(direction, out):
    """compensated_sum through MLContext: sum, rowSums and colSums."""
    rng = np.random.default_rng(1)
    x = rng.random((500, 40))
    src = "s = sum(X)\nr = rowSums(X)\nc = colSums(X)"
    cfg = DMLConfig(device="cpu")
    cfg.compensated_sum = True
    got = MLContext(cfg).execute(dml(src).input("X", x).output(out))
    jcfg = JaxConfig()
    jcfg.compensated_sum = True
    ref = JaxMLContext(jcfg).execute(jax_dml(src).input("X", x).output(out))
    _close(np.asarray(got.get_matrix(out) if direction != "all"
                      else got.get_scalar(out)),
           np.asarray(ref.get(out)), 1e-12)


# --------------------------------------------------------------------------
# seq and sample (systemml_tpu/ops/datagen.py:117-141): bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ndt,tdt", [(np.float64, torch.float64),
                                     (np.float32, torch.float32)])
@pytest.mark.parametrize("args", [(1, 5, None), (5, 1, None), (1, 10, 3),
                                  (3.5, -7.25, -0.3), (0, 1, 0.1),
                                  (1, 1000, 3.7), (1, 0, 1),
                                  (1, 2000000, 8000), (0.1, 1e5, 0.7)])
def test_seq_bit_identical(args, ndt, tdt):
    _same_bits(datagen.seq(*args, dtype=tdt, device="cpu"),
               jdatagen.seq(*args, dtype=ndt))


@pytest.mark.parametrize("n,size", [(1000, 10), (1000, 1000), (1626, 1626),
                                    (1627, 50), (5000, 5000),
                                    (3_000_000, 10)])
@pytest.mark.parametrize("replace", [False, True])
def test_sample_bit_identical(n, size, replace):
    """Without replacement: 1 shuffle round up to n = 1,626, then 2, and
    3 at n = 3,000,000; with replacement, randint's 64-bit words."""
    for seed in (7, 2 ** 31 - 1):
        _same_bits(datagen.sample(n, size, replace, seed,
                                  dtype=torch.float64, device="cpu"),
                   jdatagen.sample(n, size, replace, seed, dtype=np.float64))


@pytest.mark.parametrize("src", [
    "x = sample(2000, 7, 11)", "x = sample(2000, 7, TRUE, 11)",
    "x = sample(2000, 7, FALSE, 11)", "x = sample(30, 40, 1, 5)",
    "x = seq(2, 11, 3)", "x = seq(10, 1)"])
def test_seq_and_sample_through_dml(src):
    """The builtins' argument dispatch (a third argument that is not 0/1
    is a seed) as the JAX package's."""
    got = MLContext(DMLConfig(device="cpu")).execute(
        dml(src).output("x")).get_matrix("x")
    ref = JaxMLContext().execute(jax_dml(src).output("x")).get_matrix("x")
    _same_bits(got, np.asarray(ref))


# --------------------------------------------------------------------------
# linear algebra (systemml_tpu/ops/linalg.py:15-74)
# --------------------------------------------------------------------------

def _sign_fixed(v):
    """Each column's sign chosen so its largest-magnitude entry is > 0."""
    v = np.asarray(v, np.float64)
    i = np.argmax(np.abs(v), axis=0)
    return v * np.sign(v[i, np.arange(v.shape[1])])


@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_solve_square_and_least_squares(ndt, tdt, bar):
    rng = np.random.default_rng(4)
    a = _mat(rng, 6, 6) + 6 * np.eye(6)
    b = rng.standard_normal((6, 2))
    _close(linalg.solve(_t(a, tdt), _t(b, tdt)),
           jlinalg.solve(_j(a, ndt), _j(b, ndt)), bar)
    a, b = _mat(rng, 12, 4), rng.standard_normal((12, 1))
    _close(linalg.solve(_t(a, tdt), _t(b, tdt)),
           jlinalg.solve(_j(a, ndt), _j(b, ndt)), bar)


@pytest.mark.parametrize("shape", [(2000, 50), (50, 50)])
def test_graph_safe_solve_matches_the_jax_package(shape):
    """The route a loop region on the card solves by (fp64 inverse, then
    refinement; ops/linalg._solve_graph_safe), here on the CPU: on an
    fp64 A of condition number 1e6 it stays within 1e-10 of the JAX
    package's LU and QR least squares, where the normal equations alone
    lose about six digits."""
    n, m = shape
    rng = np.random.default_rng(6)
    u, _ = np.linalg.qr(rng.standard_normal((n, m)))
    v, _ = np.linalg.qr(rng.standard_normal((m, m)))
    a = (u * np.logspace(0, -6, m)) @ v.T
    # consistent (b in A's range): with a residual, the answer's own
    # sensitivity at this condition number is about 1e-10 (numpy's lstsq
    # is that far from the exact one), which no method could meet
    b = a @ rng.standard_normal((m, 1))
    ref = np.asarray(jlinalg.solve(_j(a, np.float64), _j(b, np.float64)))
    got = _np(linalg._solve_graph_safe(_t(a), _t(b)))
    assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)


def test_singular_solve_gives_nonfinite_not_an_error():
    """No host check of the factorization (solve_ex, inv_ex, cholesky_ex
    with check_errors=False): a singular A gives Inf/NaN, as jnp.linalg."""
    a = np.ones((3, 3))
    b = np.ones((3, 1))
    got = _np(linalg.solve(_t(a), _t(b)))
    assert not np.isfinite(got).all()
    assert not np.isfinite(_np(linalg.inverse(_t(a)))).all()
    assert np.isnan(_np(linalg.cholesky(_t(-np.eye(3))))).all()


@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_inverse_cholesky_det_trace(ndt, tdt, bar):
    rng = np.random.default_rng(5)
    x = _mat(rng, 5, 5)
    s = x @ x.T + 5 * np.eye(5)
    _close(linalg.inverse(_t(s, tdt)), jlinalg.inverse(_j(s, ndt)), bar)
    _close(linalg.cholesky(_t(s, tdt)), jlinalg.cholesky(_j(s, ndt)), bar)
    _close(linalg.det(_t(x, tdt)), jlinalg.det(_j(x, ndt)), bar)
    _close(linalg.trace(_t(x, tdt)), jlinalg.trace(_j(x, ndt)), bar)


@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_qr_lu(ndt, tdt, bar):
    rng = np.random.default_rng(6)
    x = _mat(rng, 7, 4)
    q, r = linalg.qr(_t(x, tdt))
    jq, jr = jlinalg.qr(_j(x, ndt))
    # Householder QR: the same signs in both (LAPACK geqrf)
    _close(q, jq, bar)
    _close(r, jr, bar)
    x = _mat(rng, 5, 5)
    for got, ref in zip(linalg.lu(_t(x, tdt)), jlinalg.lu(_j(x, ndt))):
        _close(got, ref, bar)


@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_eigen_and_svd_up_to_sign(ndt, tdt, bar):
    rng = np.random.default_rng(7)
    x = _mat(rng, 6, 6)
    s = x @ x.T
    w, v = linalg.eigen(_t(s, tdt))
    jw, jv = jlinalg.eigen(_j(s, ndt))
    _close(w, jw, bar)                 # ascending, as eigh
    _close(_sign_fixed(_np(v)), _sign_fixed(jv), bar * 10)
    _close(_np(v) @ np.diag(_np(w).ravel()) @ _np(v).T, s, bar * 10)
    x = _mat(rng, 8, 4)
    u, sv, vv = linalg.svd(_t(x, tdt))
    ju, js, jvv = jlinalg.svd(_j(x, ndt))
    _close(sv, js, bar)
    _close(_sign_fixed(_np(vv)), _sign_fixed(jvv), bar * 10)
    _close(_np(u) @ _np(sv) @ _np(vv).T, x, bar * 10)


def test_linalg_builtins_in_a_script():
    """eigen, qr, solve, inv, det, trace, cholesky, lu and svd through
    MLContext against the JAX package's (vectors through sign-free
    products)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 4))
    s = x @ x.T + 4 * np.eye(4)
    b = rng.standard_normal((4, 1))
    src = """
[w, V] = eigen(S)
E = V %*% diag(w) %*% t(V)
[Q, R] = qr(S)
x = solve(S, b)
Si = inv(S)
d = det(S)
tr = trace(S)
L = cholesky(S)
[P, Lo, U] = lu(S)
[Us, Ss, Vs] = svd(S)
Sv = Us %*% Ss %*% t(Vs)
"""
    outs = ["w", "E", "Q", "R", "x", "Si", "d", "tr", "L", "P", "Lo", "U",
            "Sv"]
    got = MLContext(DMLConfig(device="cpu")).execute(
        dml(src).input("S", s).input("b", b).output(*outs))
    ref = JaxMLContext().execute(
        jax_dml(src).input("S", s).input("b", b).output(*outs))
    for o in outs:
        g = got.get(o)
        if isinstance(g, torch.Tensor) and g.numel() > 1:
            _close(got.get_matrix(o), ref.get_matrix(o), 1e-9)
        else:
            _close(got.get_scalar(o), np.asarray(ref.get(o)), 1e-9)


# --------------------------------------------------------------------------
# parameterized builtins (systemml_tpu/ops/param.py:24-220)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["counts", "dims", "weighted", "scalar_b",
                                  "scalar_w"])
@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_table(case, ndt, tdt, bar):
    rng = np.random.default_rng(9)
    i = rng.integers(0, 6, 200).astype(float)
    j = rng.integers(1, 5, 200).astype(float) + 0.4   # truncated
    w = rng.standard_normal(200)
    args = {"counts": ((i, j), {}), "dims": ((i, j), {"dim1": 4, "dim2": 7}),
            "weighted": ((i, j, w), {}),
            "scalar_b": ((i, 3.0), {}), "scalar_w": ((i, j, 2.5), {})}[case]
    tin = [_t(a, tdt) if isinstance(a, np.ndarray) else a for a in args[0]]
    jin = [_j(a, ndt) if isinstance(a, np.ndarray) else a for a in args[0]]
    _close(param.table(*tin, **args[1]), jparam.table(*jin, **args[1]), bar)


def test_weighted_table_repeats_bit_for_bit():
    rng = np.random.default_rng(10)
    i = _t(rng.integers(1, 4, 5000))
    j = _t(rng.integers(1, 4, 5000))
    w = _t(rng.standard_normal(5000), torch.float32)
    a = param.table(i, j, w, 3, 3)
    b = param.table(i, j, w, 3, 3)
    assert torch.equal(a, b)


@pytest.mark.parametrize("margin", ["rows", "cols"])
@pytest.mark.parametrize("select", [False, True])
def test_remove_empty(margin, select):
    x = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [2.0, 0.0, 3.0],
                  [np.nan, 0.0, 0.0]])
    sel = np.array([[1.0], [0.0], [1.0], [0.0]]) if margin == "rows" \
        else np.array([[0.0, 1.0, 1.0]])
    got = param.remove_empty(_t(x), margin, _t(sel) if select else None)
    ref = jparam.remove_empty(_j(x), margin, _j(sel) if select else None)
    _close(got, ref, 0.0)
    z = np.zeros((3, 2))
    for er in (True, False):
        _close(param.remove_empty(_t(z), margin, None, er),
               jparam.remove_empty(_j(z), margin, None, er), 0.0)


@pytest.mark.parametrize("pattern,repl", [(np.nan, 0.0), (2.0, -1.0),
                                          (0.0, np.nan)])
def test_replace(pattern, repl):
    x = np.array([[1.0, np.nan, 2.0], [0.0, 2.0, np.nan]])
    _close(param.replace(_t(x), pattern, repl),
           jparam.replace(_j(x), pattern, repl), 0.0)


@pytest.mark.parametrize("op", ["+", "*", "<", "==", "max", "^"])
def test_outer(op):
    rng = np.random.default_rng(12)
    u, v = rng.standard_normal((5, 1)), rng.standard_normal((1, 4))
    _close(param.outer(_t(u), _t(v), op), jparam.outer(_j(u), _j(v), op),
           1e-9)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_quantile_median(p, weighted, ndt, tdt, bar):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((101, 1))
    w = rng.random((101, 1)) if weighted else None
    _close(param.quantile(_t(x, tdt), p, None if w is None else _t(w, tdt)),
           jparam.quantile(_j(x, ndt), p, None if w is None else _j(w, ndt)),
           bar)
    ps = np.array([[0.1], [0.5], [0.9]])
    _close(param.quantile(_t(x, tdt), _t(ps, tdt)),
           jparam.quantile(_j(x, ndt), _j(ps, ndt)), bar)
    _close(param.median(_t(x, tdt)), jparam.median(_j(x, ndt)), bar)


@pytest.mark.parametrize("n", [1, 4, 31, 40, 101])
def test_iqm_col_medians_col_iqms(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 5))
    _close(param.iqm(_t(x[:, :1])), jparam.iqm(_j(x[:, :1])), 1e-9)
    _close(param.col_medians(_t(x)), jparam.col_medians(_j(x)), 1e-9)
    _close(param.col_iqms(_t(x)), jparam.col_iqms(_j(x)), 1e-9)


@pytest.mark.parametrize("dist,kw", [
    ("normal", {}), ("normal", {"mean": 1.5, "sd": 2.0}),
    ("exp", {"rate": 2.0}), ("chisq", {"df": 4.0}), ("chisq", {"df": 0.7}),
    ("t", {"df": 5.0}), ("t", {"df": 0.7}), ("t", {"df": 300.0}),
    ("f", {"df1": 3.0, "df2": 7.0}), ("f", {"df1": 100.0, "df2": 2.0})])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_cdf(dist, kw, lower, ndt, tdt, bar):
    x = np.array([[-3.0, -1.5, -0.2, 0.0], [0.3, 1.0, 2.0, 5.0],
                  [30.0, np.nan, 1e-3, 7.5]])
    _close(param.cdf(_t(x, tdt), dist, lower_tail=lower, **kw),
           jparam.cdf(_j(x, ndt), dist, lower_tail=lower, **kw), bar)


@pytest.mark.parametrize("lo,hi", [(0.05, 5.0), (0.5, 50.0), (5.0, 500.0)])
def test_betainc_against_jax(lo, hi):
    """The regularized incomplete beta (the continued fraction behind
    pt and pf) against jax.scipy.special.betainc, fp64 at 1e-9, with the
    edges: x at 0 and 1, a NaN, an x outside [0, 1]."""
    from jax.scipy.special import betainc as jbetainc

    rng = np.random.default_rng(int(hi))
    a, b = rng.uniform(lo, hi, 400), rng.uniform(lo, hi, 400)
    x = rng.uniform(0, 1, 400)
    x[:4] = [0.0, 1.0, np.nan, 1.5]
    ref = np.asarray(jbetainc(a, b, x))
    got = _np(param.betainc(_t(a), _t(b), _t(x)))
    ok = np.isfinite(ref) & (np.abs(ref) > 1e-300)
    assert (np.isnan(got) == np.isnan(ref)).all()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-9, atol=0)
    np.testing.assert_array_equal(got[:2], ref[:2])


@pytest.mark.parametrize("dist,kw", [
    ("normal", {"mean": 1.0, "sd": 2.0}), ("exp", {"rate": 3.0}),
    ("t", {"df": 10.0}), ("chisq", {"df": 3.0}),
    ("f", {"df1": 2.0, "df2": 9.0})])
@pytest.mark.parametrize("ndt,tdt,bar", DTYPES)
def test_invcdf(dist, kw, ndt, tdt, bar):
    p = np.array([[0.01, 0.3], [0.5, 0.975]])
    _close(param.invcdf(_t(p, tdt), dist, **kw),
           jparam.invcdf(_j(p, ndt), dist, **kw), bar)


# --------------------------------------------------------------------------
# reorganisation (systemml_tpu/ops/reorg.py:87-99, 198-215)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("by", [1, 2])
@pytest.mark.parametrize("decreasing", [False, True])
@pytest.mark.parametrize("index_return", [False, True])
def test_order_stable_with_ties_and_nan(by, decreasing, index_return):
    """Ties keep their order whichever the direction (decreasing is the
    stable sort of -key, not the reverse), NaN goes last."""
    x = np.array([[3.0, 1.0], [1.0, 2.0], [np.nan, 2.0], [3.0, 0.0],
                  [1.0, np.nan], [2.0, 2.0], [-0.0, 5.0], [0.0, 5.0]])
    got = reorg.sort_matrix(_t(x), by, decreasing, index_return)
    ref = jreorg.sort_matrix(_j(x), by, decreasing, index_return)
    _same_bits(got, np.asarray(ref))


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("diag_val", [False, True])
@pytest.mark.parametrize("values", [False, True])
def test_triangles(upper, diag_val, values):
    x = np.random.default_rng(14).standard_normal((4, 6))
    f, jf = ((reorg.upper_tri, jreorg.upper_tri) if upper
             else (reorg.lower_tri, jreorg.lower_tri))
    _close(f(_t(x), diag_val, values), jf(_j(x), diag_val, values), 0.0)


# --------------------------------------------------------------------------
# the builtins through MLContext (systemml_tpu/compiler/lower.py)
# --------------------------------------------------------------------------

SCRIPTS = {
    "table_order_removeEmpty": ("""
v = matrix("1 2 2 3", rows=4, cols=1)
T = table(v, v)
T2 = table(v, v, 2.0)
T3 = table(v, v, 3, 4)
M = matrix("3 1 2 9 0 5", rows=3, cols=2)
S = order(target=M, by=1)
I = order(target=M, by=2, decreasing=TRUE, index.return=TRUE)
E = removeEmpty(target=matrix("1 0 0 0 2 0", rows=3, cols=2), margin="rows")
F = removeEmpty(target=matrix("1 0 0 0 2 0", rows=3, cols=2), margin="cols")
""", None, ["T", "T2", "T3", "S", "I", "E", "F"]),
    "distributions": ("""
p1 = cdf(target=1.96, dist="normal")
p2 = pnorm(X, 1.0, 2.0)
p3 = pt(X, 5)
p4 = pf(abs(X), 3, 7, lower.tail=FALSE)
p5 = pchisq(abs(X), 4)
p6 = pexp(abs(X), 2)
q1 = qnorm(0.9)
q2 = qt(0.95, 10)
q3 = qchisq(0.5, 3)
q4 = qf(0.9, 2, 9)
q5 = qexp(0.4, 3)
q6 = icdf(target=0.3, dist="t", df=4)
q7 = invcdf(target=0.7, dist="normal", mean=1, sd=3)
""", {"X": "x"}, ["p1", "p2", "p3", "p4", "p5", "p6", "q1", "q2", "q3", "q4",
                  "q5", "q6", "q7"]),
    "order_statistics": ("""
q = quantile(X[, 1], 0.3)
qs = quantile(X[, 1], P)
qw = quantile(X[, 1], X[, 2] ^ 2, 0.6)
m = median(X[, 2])
iq = interQuartileMean(X[, 3])
CM = colMedians(X)
CI = colIQMs(X)
V = interQuantile(X[, 1], 0.25)
VW = interQuantile(X[, 1], abs(X[, 2]), 0.25)
""", {"X": "x", "P": "p"}, ["q", "qs", "qw", "m", "iq", "CM", "CI", "V",
                            "VW"]),
    "moments_and_groups": ("""
m2 = moment(X[, 1], 2)
m3 = centralMoment(X[, 1], 3)
mw = moment(X[, 1], abs(X[, 2]), 4)
c = cov(X[, 1], X[, 2])
cw = cov(X[, 1], X[, 2], abs(X[, 3]))
G = ceil(abs(X[, 4]) * 2) + 1
A = aggregate(target=X[, 1], groups=G, fn="mean")
B = aggregate(target=X[, 1], groups=G, fn="sum", ngroups=8)
C = cumsum(X)
D = cumprod(abs(X) + 0.5)
Mn = cummin(X)
Mx = cummax(X)
R = rowIndexMax(X)
Q = rowIndexMin(X)
""", {"X": "x"}, ["m2", "m3", "mw", "c", "cw", "A", "B", "C", "D", "Mn",
                  "Mx", "R", "Q"]),
    "cells_and_lists": ("""
A = ppred(X, 0.2, ">")
B = xor(X > 0, X > 0.5)
C = bitwAnd(K, 6)
D = bitwOr(K, 6)
E = bitwXor(K, 6)
F = bitwShiftL(K, 2)
G = bitwShiftR(K, 1)
H = outer(X[, 1], t(X[, 2]), "*")
Lo = lower.tri(target=Y, diag=TRUE, values=TRUE)
Up = upper.tri(target=Y)
Rp = replace(target=X, pattern=0.5, replacement=-1)
S = seq(1, 10, 2)
Z = cumsumprod(cbind(X[, 1], abs(X[, 2]) / 4))
l = list(a=3, b=X[1, ])
v = as.scalar(l["a"]) + sum(as.matrix(l["b"]))
""", {"X": "x", "K": "k", "Y": "y"}, ["A", "B", "C", "D", "E", "F", "G", "H",
                                      "Lo", "Up", "Rp", "S", "Z", "v"]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_builtins_through_mlcontext(name):
    src, ins, outs = SCRIPTS[name]
    rng = np.random.default_rng(15)
    data = {"x": np.round(rng.standard_normal((30, 4)), 1),
            "p": np.array([[0.1], [0.5], [0.9]]),
            "k": rng.integers(0, 40, (5, 3)).astype(float),
            "y": rng.standard_normal((4, 4))}
    got_s, ref_s = dml(src), jax_dml(src)
    for k, v in (ins or {}).items():
        got_s.input(k, data[v])
        ref_s.input(k, data[v])
    got = MLContext(DMLConfig(device="cpu")).execute(got_s.output(*outs))
    ref = JaxMLContext().execute(ref_s.output(*outs))
    for o in outs:
        g = got.get(o)
        if isinstance(g, torch.Tensor) and g.ndim == 2:
            _close(got.get_matrix(o), ref.get_matrix(o), 1e-9)
        else:
            _close(np.asarray(got.get_scalar(o), np.float64),
                   np.asarray(ref.get(o), np.float64), 1e-9)
