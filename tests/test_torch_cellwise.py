"""Elementwise ops of the port against the JAX package where IEEE special
values meet DML semantics: `sign` of NaN and `%/%` by a zero divisor, on
the same numpy-made inputs, through both packages' MLContext (the eager
path at optlevel 2, the fusion pass at optlevel 3), in fp64 and fp32;
and `sign` of a compressed operand, whose dictionaries map through the
same table (cellwise.unary_op).

Bar: the same NaN and +-Inf places as the JAX package, and the finite
values at relative 1e-9 in fp64 and 1e-6 in fp32 (one rounding of a
sum of at most 24 values of +-1).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.compress import colgroup as jax_cg
from systemml_tpu.compress.block import CompressedMatrixBlock as JaxBlock
from systemml_tpu.ops import cellwise as jax_cellwise
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.compress import colgroup as cg
from systemml_tpu_torch.compress.block import CompressedMatrixBlock
from systemml_tpu_torch.ops import cellwise
from systemml_tpu_torch.utils import config as port_config
from systemml_tpu_torch.utils.config import DMLConfig

ROW = np.array([[0.0, 5.0, -5.0, np.nan, 2.0]])
TOL = {np.float64: 1e-9, np.float32: 1e-6}


def _nan_block():
    """(6, 4) from default_rng(1) with one NaN."""
    x = np.random.default_rng(1).standard_normal((6, 4))
    x[2, 1] = np.nan
    return x


CASES = {
    "sign": ("R = sign(X)", {"X": ROW}),
    "sum_sign": ("R = sum(sign(X))", {"X": _nan_block()}),
    "sign_times": ("R = sign(X) * 2 + X", {"X": _nan_block()}),
    "intdiv_matrix": ("R = X %/% Z", {"X": ROW, "Z": np.zeros((1, 5))}),
    "intdiv_zero": ("R = X %/% 0", {"X": ROW}),
    "intdiv_left": ("R = 7 %/% Z", {"Z": np.zeros((1, 5))}),
    "intdiv_mixed": ("R = X %/% Z",
                     {"X": ROW, "Z": np.array([[0.0, 2.0, 0.0, 3.0, -3.0]])}),
    "intdiv_sum": ("R = sum(X %/% Z)",
                   {"X": ROW, "Z": np.array([[1.0, 2.0, 0.0, 3.0, -3.0]])}),
    "mod_zero": ("R = X %% Z", {"X": ROW, "Z": np.zeros((1, 5))}),
}


def _run(ctx, script, inputs, dtype):
    for k, v in inputs.items():
        script.input(k, v.astype(dtype))
    script.output("R")
    with contextlib.redirect_stdout(io.StringIO()):
        res = ctx.execute(script)
    return np.asarray(res.get_matrix("R"), dtype=np.float64)


def _port(src, inputs, optlevel, dtype):
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = optlevel
    if dtype == np.float32:
        cfg.floating_point_precision = "single"
    return _run(MLContext(cfg), dml(src), inputs, dtype)


def _jax(src, inputs, optlevel, dtype):
    cfg = JaxConfig()
    cfg.optlevel = optlevel
    cfg.pallas_mode = "never"
    cfg.exec_mode = "SINGLE_NODE"   # the conftest's 8-device mesh stays out
    if dtype == np.float32:
        cfg.floating_point_precision = "single"
    return _run(JaxMLContext(cfg), jax_dml(src), inputs, dtype)


def _same(got, ref, tol):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("optlevel", [2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_special_values_match_jax(case, optlevel, dtype):
    src, inputs = CASES[case]
    ref = _jax(src, inputs, optlevel, dtype)
    got = _port(src, inputs, optlevel, dtype)
    _same(got, ref, TOL[dtype])


@pytest.mark.parametrize("case", ["sign", "intdiv_matrix", "intdiv_zero",
                                  "intdiv_left"])
def test_expected_values(case):
    """The JAX package's values, written out: NaN stays NaN under sign, and
    a zero divisor gives NaN under %/%."""
    want = {"sign": [[0.0, 1.0, -1.0, np.nan, 1.0]],
            "intdiv_matrix": [[np.nan] * 5], "intdiv_zero": [[np.nan] * 5],
            "intdiv_left": [[np.nan] * 5]}[case]
    src, inputs = CASES[case]
    _same(_port(src, inputs, 2, np.float64), np.array(want), 0.0)


@pytest.fixture
def port_cpu():
    old = port_config.get_config()
    port_config.set_config(DMLConfig(device="cpu"))
    yield
    port_config.set_config(old)


@pytest.mark.parametrize("op", ["sign", "abs", "round"])
def test_compressed_unary_with_nan_matches_jax(port_cpu, op):
    """A DDC group whose dictionary holds NaN, Inf and 0: unary_op maps the
    dictionary through the dense table, as the JAX package does."""
    rng = np.random.default_rng(3)
    dct = np.array([[np.nan, 1.5], [-2.0, 0.0], [np.inf, -np.inf],
                    [0.0, -0.5]])
    codes = rng.integers(0, 4, 50)
    cp = CompressedMatrixBlock([cg.ColGroupDDC([0, 1], dct, codes)], (50, 2))
    cj = JaxBlock([jax_cg.ColGroupDDC([0, 1], dct, codes)], (50, 2))
    got = cellwise.unary_op(op, cp)
    ref = jax_cellwise.unary_op(op, cj)
    assert type(got).__name__ == "CompressedMatrixBlock"
    _same(np.asarray(got.decompress(), np.float64),
          np.asarray(ref.decompress(), np.float64), 1e-12)


def test_dense_ops_directly(port_cpu):
    """cellwise.binary_op and unary_op on tensors and host numbers."""
    x = torch.from_numpy(ROW)
    z = torch.zeros(1, 5, dtype=torch.float64)
    for a, b in ((x, z), (x, 0), (7, z), (x, 0.0)):
        got = cellwise.binary_op("%/%", a, b).numpy()
        ref = np.asarray(jax_cellwise.binary_op(
            "%/%", a.numpy() if isinstance(a, torch.Tensor) else a,
            b.numpy() if isinstance(b, torch.Tensor) else b))
        _same(got, np.broadcast_to(ref, got.shape), 0.0)
    # floor semantics stay elsewhere: -5 %/% 3 = -2, 5 %/% -3 = -2
    got = cellwise.binary_op("%/%", torch.tensor([[-5.0, 5.0]]),
                             torch.tensor([[3.0, -3.0]]))
    assert got.tolist() == [[-2.0, -2.0]]
    got = cellwise.unary_op("sign", torch.from_numpy(ROW)).numpy()
    _same(got, np.asarray(jax_cellwise.unary_op("sign", ROW)), 0.0)
