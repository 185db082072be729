"""The five faults of ROADMAP queue 3, each against the JAX package on the
CPU, through both packages' MLContext on the same numpy-made inputs.

1. A scalar accumulator set to an int that a loop's first iteration makes
   a double kept the int kind when the loop's region was refused after
   its peel: iteration 1's fraction was lost (runtime/loopfuse
   `_host_kinds_back`).
2. `log(x, base)` of a region's 0-d int64 computed in fp32
   (ops/cellwise `log_base`).
3. `as.integer` of a negative non-integer host scalar floored; the host
   arm truncates and the device arm floors, as the reference.
4. `gamma`, `lgamma`, `digamma` and `trigamma` raised.
5. `ifelse` of host scalars gave a double where the JAX package keeps an
   int.

Bar: fp64 relative 1e-9, or the printed text where that is what the
fault breaks.
"""

import contextlib
import io

import numpy as np
import pytest
import scipy.sparse

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.compress.block import compress as port_compress
from systemml_tpu_torch.utils.config import DMLConfig

X6 = np.round(np.random.default_rng(2).standard_normal((6, 3)), 3)
P75 = np.abs(np.round(np.random.default_rng(3).standard_normal((7, 5)),
                      2)) + 0.5


def _port_cfg(optlevel, codegen=True):
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = optlevel
    cfg.codegen_enabled = codegen
    return cfg


def _jax_cfg(optlevel):
    cfg = JaxConfig()
    cfg.optlevel = optlevel
    cfg.pallas_mode = "never"
    cfg.exec_mode = "SINGLE_NODE"
    return cfg


def _run(ctx, script, inputs, out):
    for k, v in inputs.items():
        script.input(k, v)
    if out:
        script.output(out)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = ctx.execute(script)
    return res, buf.getvalue()


def _both(src, inputs=None, out="s", optlevel=2, codegen=True):
    inputs = inputs or {}
    rp, tp = _run(MLContext(_port_cfg(optlevel, codegen)), dml(src),
                  inputs, out)
    rj, tj = _run(JaxMLContext(_jax_cfg(optlevel)), jax_dml(src), inputs,
                  out)
    return rp, tp, rj, tj


def _value(res, name):
    v = res.get(name)
    if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0:
        return np.asarray(res.get_matrix(name), np.float64)
    return float(np.asarray(v))


ACCUMULATORS = {
    "pnorm": ("s = 0; for (i in 1:3) { c = pnorm(target=0.5, mean=0, "
              "sd=i); s = s + c }", {}),
    "pnorm4": ("s = 0; for (i in 1:4) { c = pnorm(target=0.5, mean=0, "
               "sd=i); s = s + c }", {}),
    "moment": ("s = 0; for (i in 1:3) { c = moment(X[,1], i + 1); "
               "s = s + c }", {"X": X6}),
    "cdf": ('s = 0; for (i in 1:3) { c = sum(cdf(target=X[,1], '
            'dist="normal", mean=0, sd=i)); s = s + c }', {"X": X6}),
}


@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("case", sorted(ACCUMULATORS))
def test_fault1_int_accumulator_keeps_first_fraction(case, optlevel):
    src, inputs = ACCUMULATORS[case]
    rp, _, rj, _ = _both(src, inputs, optlevel=optlevel)
    got, ref = _value(rp, "s"), _value(rj, "s")
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    # and the port agrees with itself without regions
    rq, _, _, _ = _both(src, inputs, optlevel=optlevel, codegen=False)
    np.testing.assert_allclose(_value(rq, "s"), ref, rtol=1e-9)


def test_fault1_expected_value():
    rp, _, _, _ = _both(ACCUMULATORS["pnorm"][0])
    np.testing.assert_allclose(_value(rp, "s"), 1.8563526195678406,
                               rtol=1e-12)


@pytest.mark.parametrize("case", sorted(ACCUMULATORS))
def test_fault1_double_accumulator_unchanged(case):
    src, inputs = ACCUMULATORS[case]
    src = src.replace("s = 0;", "s = 0.0;")
    rp, _, rj, _ = _both(src, inputs)
    np.testing.assert_allclose(_value(rp, "s"), _value(rj, "s"), rtol=1e-9)


def test_fault1_int_accumulator_stays_int():
    """An accumulator that stays an int in the first iteration leaves as an
    int, as before."""
    src = "s = 0; for (i in 1:4) { s = s + i }; print(s)"
    _, tp, _, tj = _both(src, out=None)
    assert tp == tj == "10\n"


REGION_SCALARS = {
    "log2": "s = 0; for (i in 1:4) { c = log(i + 1, 2); s = s + c }",
    "log10": "s = 0; for (i in 1:4) { c = log(i, 10); s = s + c }",
    "log": "s = 0; for (i in 1:4) { c = log(i); s = s + c }",
    "sqrt": "s = 0; for (i in 1:4) { c = sqrt(i); s = s + c }",
    "exp": "s = 0; for (i in 1:4) { c = exp(i / 4); s = s + c }",
    "pnorm_i": "s = 0; for (i in 1:4) { c = pnorm(target=i/4); s = s + c }",
    "minmax": "s = 0; for (i in 1:4) { c = min(i, 2.5) + max(i, 1.5); "
              "s = s + c }",
    "lgamma_i": "s = 0; for (i in 1:4) { c = lgamma(i + 0.5); s = s + c }",
}


@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("case", sorted(REGION_SCALARS))
def test_fault2_region_int_builtins_compute_in_fp64(case, optlevel):
    rp, _, rj, _ = _both(REGION_SCALARS[case], optlevel=optlevel)
    np.testing.assert_allclose(_value(rp, "s"), _value(rj, "s"), rtol=1e-9)


def test_fault2_expected_value():
    rp, _, _, _ = _both(REGION_SCALARS["log2"])
    np.testing.assert_allclose(_value(rp, "s"), 6.906890595608518,
                               rtol=1e-12)


@pytest.mark.parametrize("src", [
    "r = as.integer(-3.7); print(r)",
    "print(as.integer(-2.5))",
    "r = as.integer(3.7); print(r)",
    "x = -3.7; r = as.integer(x) * 2; print(r)",
])
def test_fault3_as_integer_host_truncates(src):
    _, tp, _, tj = _both(src, out=None)
    assert tp == tj


def test_fault3_as_integer_value():
    rp, tp, rj, _ = _both("s = as.integer(-3.7)")
    assert rp.get("s") == -3 == int(np.asarray(rj.get("s")))


def test_fault3_region_floors_in_both():
    src = "s = 0; for (i in 1:3) { x = -3.7 * i; s = s + as.integer(x) }"
    rp, _, rj, _ = _both(src)
    assert _value(rp, "s") == _value(rj, "s") == -24


@pytest.mark.parametrize("op", ["gamma", "lgamma", "digamma", "trigamma"])
@pytest.mark.parametrize("optlevel", [2, 3])
def test_fault4_gamma_family_dense(op, optlevel):
    rp, _, rj, _ = _both(f"R = {op}(P)", {"P": P75}, out="R",
                         optlevel=optlevel)
    np.testing.assert_allclose(_value(rp, "R"), _value(rj, "R"), rtol=1e-9)


@pytest.mark.parametrize("op", ["gamma", "lgamma", "digamma", "trigamma"])
def test_fault4_gamma_family_scalar_and_region(op):
    src = f"s = 0; for (i in 1:4) {{ c = {op}(i + 0.25); s = s + c }}"
    rp, _, rj, _ = _both(src)
    np.testing.assert_allclose(_value(rp, "s"), _value(rj, "s"), rtol=1e-9)


@pytest.mark.parametrize("op", ["lgamma", "digamma"])
def test_fault4_gamma_family_sparse_and_compressed(op):
    from systemml_tpu_torch.ops import cellwise
    from systemml_tpu_torch.runtime.sparse import SparseMatrix
    from systemml_tpu_torch.utils import config as port_config
    import torch

    old = port_config.get_config()
    port_config.set_config(DMLConfig(device="cpu"))
    try:
        dense = P75.copy()
        dense[dense < 1.0] = 0.0
        want = cellwise.unary_op(op, torch.from_numpy(dense)).numpy()
        sm = SparseMatrix.from_scipy(scipy.sparse.csr_matrix(dense),
                                     device="cpu")
        got = cellwise.unary_op(op, sm)
        got = got.to_numpy() if hasattr(got, "to_numpy") else got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12)
        rounded = np.round(P75, 0)
        cb = port_compress(torch.from_numpy(rounded))
        gotc = cellwise.unary_op(op, cb).decompress()
        wantc = cellwise.unary_op(op, torch.from_numpy(rounded)).numpy()
        np.testing.assert_allclose(np.asarray(gotc), wantc, rtol=1e-12)
    finally:
        port_config.set_config(old)
    rp, _, rj, _ = _both(f"R = {op}(P)", {"P": scipy.sparse.csr_matrix(
        np.where(P75 < 1.0, 0.0, P75))}, out="R")
    np.testing.assert_allclose(_value(rp, "R"), _value(rj, "R"), rtol=1e-9)


@pytest.mark.parametrize("src", [
    "print(ifelse(TRUE, 1, 2))",
    "print(ifelse(FALSE, 1, 2))",
    "print(ifelse(TRUE, 1, 2.5))",
    "x = 3; print(ifelse(x > 2, x, 0))",
    "print(ifelse(1, TRUE, FALSE))",
])
def test_fault5_ifelse_of_scalars_keeps_the_kind(src):
    _, tp, _, tj = _both(src, out=None)
    assert tp == tj


def test_fault5_ifelse_in_region():
    src = "s = 0; for (i in 1:4) { s = s + ifelse(i > 2, i, 0) }; print(s)"
    _, tp, _, tj = _both(src, out=None)
    assert tp == tj == "7\n"
