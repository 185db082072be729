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

And the masked multiply (ROADMAP queue 3, the fault the re-anchor at
`f473a2c` found): a dense product by a relational or logical hop of the
same block is `where(mask, other, +0)` in the JAX package (XLA's
simplifier inside the jitted block), so a masked cell is +0 whatever the
other operand holds; every other product, and the sparse arms, keep the
IEEE product (scipy's drops a zero product).

Bar: fp64 relative 1e-9, or the printed text where that is what the
fault breaks; for the masked multiply also the NaN pattern and the sign
of zero, exactly.
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


# --------------------------------------------------------------------------
# the masked multiply
# --------------------------------------------------------------------------

# NaN, -Inf and Inf at masked and unmasked cells; negative cells whose
# IEEE product by 0 is -0
MASK_X = (np.array([[2.0, np.nan], [-np.inf, np.inf]]),
          np.array([[2.0, -2.5], [-0.5, 1.0]]))
RELU_DML = "scripts/nn/layers/relu.dml"

# forms that the JAX package computes as where(mask, other, +0)
MASKED = {
    "direct": "Z = X * (X > 0)",
    "direct_reversed": "Z = (X > 0) * X",
    "assigned_earlier": "M = X > 0\nZ = X * M",
    "and": "Z = X * ((X > 0) & (X < 10))",
    "or": "Z = X * ((X > 0) | (X > 10))",
    "not": "Z = X * (!(X <= 0))",
    "xor": "Z = X * xor(X > 0, X > 10)",
    "ppred": 'Z = X * ppred(X, 0, ">")',
    "as_matrix": "Z = X * as.matrix(X > 0)",
    "eq": "Z = (X == 2) * X",
    "ne": "Z = X * (X != -0.5)",
    "lt": "Z = X * (X < 0)",
    "le": "Z = X * (X <= 1)",
    "ge": "Z = X * (X >= 1)",
    "then_times_2": "Z = X * (X > 0) * 2",
    "nan_scalar": "s = 0/0\nZ = s * (X > 0)",
    "sum": "Z = matrix(sum(X * (X > 0)), rows=1, cols=1)",
    "function": ("f = function(matrix[double] A) return (matrix[double] B)"
                 " { B = A * (A > 0) }\nZ = f(X)"),
    "for": "Z = X\nfor (i in 1:2) { Z = X * (X > 0) }",
    "while": "Z = X\ni = 0\nwhile (i < 2) { Z = X * (X > 0)\n i = i + 1 }",
    "while_carried": ("Z = X\ni = 0\nwhile (i < 2) { Z = Z * (Z > 0)\n"
                      " i = i + 1 }"),
    "if_body": "Z = X\nif (nrow(X) > 0) { Z = X * (X > 0) }",
    "relu_backward": (f'source("{RELU_DML}") as relu\n'
                      "Z = relu::backward(X, X)"),
}

# forms that both packages compute as the IEEE product
KEEP_IEEE = {
    "input_mask": "Z = X * M",
    "scalar_comparison": "s = -1\nZ = X * (s > 0)",
    "scalar_comparison_of_a_cell": "s = as.scalar(X[1,1])\nZ = X * (s < 0)",
    "mask_across_an_if": "M = X\nif (nrow(X) > 0) { M = X > 0 }\nZ = X * M",
    "mask_before_a_loop": ("M = X > 0\ni = 0\nZ = X\nwhile (i < 2) "
                           "{ Z = X * M\n i = i + 1 }"),
    "scalar_times_mask_first": "Z = 2 * (X > 0) * X",
    "mask_times_scalar": "Z = X * ((X > 0) * 2)",
    "broadcast_row_mask": "Z = X * (X[1,] > 0)",
    "transposed_mask": "Z = X * t(X > 0)",
}


def _same_cells(got, ref):
    """Equal at 1e-9 relative, with the NaN pattern and the sign bit of
    every other cell (a zero's among them) exactly equal."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.signbit(got[~nan]),
                                  np.signbit(ref[~nan]))
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def _masked_case(src, optlevel):
    for x in MASK_X:
        inputs = {"X": x}
        if "M" in src.split("=")[1].split():
            inputs["M"] = (x > 0).astype(np.float64)
        rp, _, rj, _ = _both(src, inputs, out="Z", optlevel=optlevel)
        _same_cells(_value(rp, "Z"), _value(rj, "Z"))
    return rp, rj


@pytest.mark.parametrize("optlevel", [0, 2, 3])
@pytest.mark.parametrize("form", sorted(MASKED))
def test_masked_multiply_gives_plus_zero_as_the_jax_package(form, optlevel):
    _masked_case(MASKED[form], optlevel)


@pytest.mark.parametrize("optlevel", [0, 2, 3])
@pytest.mark.parametrize("form", sorted(KEEP_IEEE))
def test_masked_multiply_keeps_the_ieee_product(form, optlevel):
    _masked_case(KEEP_IEEE[form], optlevel)


def test_masked_multiply_expected_values():
    rp, rj = _masked_case(MASKED["direct"], 2)
    z = _value(rp, "Z")
    _same_cells(z, [[2.0, 0.0], [0.0, 1.0]])
    src = "Z = sign(1 / (X * (X > 0)))"
    rp, _, rj, _ = _both(src, {"X": MASK_X[1]}, out="Z")
    _same_cells(_value(rp, "Z"), [[1.0, 1.0], [1.0, 1.0]])
    rp, _, _, _ = _both(KEEP_IEEE["input_mask"], {
        "X": MASK_X[0], "M": (MASK_X[0] > 0).astype(np.float64)}, out="Z")
    _same_cells(_value(rp, "Z"), [[2.0, np.nan], [np.nan, np.inf]])


def test_masked_multiply_decided_at_the_hop():
    from systemml_tpu_torch.hops.builder import HopBuilder
    from systemml_tpu_torch.hops.hop import mask_operand
    from systemml_tpu_torch.lang.parser import parse

    src = ("X = rand(rows=3, cols=3)\ns = 2\nA = X * (X > 0)\n"
           "B = (X > 0) * X\nC = X * (s > 0)\nD = 2 * (X > 0) * X\n"
           "E = X * xor(X > 0, X > 1)\nF = X * Y\n")
    blk = HopBuilder().build_block(list(parse(src).statements))
    got = {name: mask_operand(h) for name, h in blk.writes.items()
           if h.op == "b(*)"}
    assert got == {"A": 1, "B": 0, "C": None, "D": None, "E": 1, "F": None}


# the 6 x 5 CSR of ROADMAP queue 3: NaN, -3, Inf and 2, and -Inf
CSR_CELLS = {(0, 1): np.nan, (1, 3): -3.0, (2, 0): np.inf, (3, 4): 2.0,
             (4, 2): -np.inf, (5, 1): -3.0, (5, 4): np.nan}


def _csr65():
    d = np.zeros((6, 5))
    for (i, j), v in CSR_CELLS.items():
        d[i, j] = v
    return scipy.sparse.csr_matrix(d)


def _stored(m):
    """(row, col) -> value of a sparse result's stored cells."""
    c = m.to_scipy().tocoo()
    return {(int(i), int(j)): float(v)
            for i, j, v in zip(c.row, c.col, c.data)}


def _same_stored(got, ref):
    assert sorted(got) == sorted(ref)
    keys = sorted(ref)
    _same_cells([got[k] for k in keys], [ref[k] for k in keys])


@pytest.mark.parametrize("mask_src", ["gt0", "gt1", "ne0"])
def test_masked_multiply_sparse_arm_drops_zero_products(mask_src):
    import torch

    from systemml_tpu.ops import cellwise as jax_cellwise
    from systemml_tpu.runtime import sparse as jax_sparse
    from systemml_tpu_torch.ops import cellwise
    from systemml_tpu_torch.runtime import sparse

    op, v = {"gt0": (">", 0), "gt1": (">", 1), "ne0": ("!=", 0)}[mask_src]
    s = _csr65()
    js = jax_sparse.SparseMatrix.from_scipy(s)
    ps = sparse.SparseMatrix.from_scipy(s, device="cpu",
                                        dtype=torch.float64)
    ref = jax_cellwise.binary_op("*", js, jax_cellwise.binary_op(op, js, v))
    got = cellwise.binary_op("*", ps, cellwise.binary_op(op, ps, v))
    assert sparse.is_sparse(got) and jax_sparse.is_sparse(ref)
    _same_stored(_stored(got), _stored(ref))
    if mask_src == "gt0":
        # the masked -3 and -Inf cells: no -0 stored, the NaN cells stay
        assert (1, 3) not in _stored(got)
        assert np.isnan(_stored(got)[(0, 1)])
        # the dense mirror derived from the operands' says the same
        d = got.to_dense().numpy()
        assert not np.signbit(d[1, 3]) and not np.signbit(d[5, 1])


@pytest.mark.parametrize("optlevel", [0, 2, 3])
@pytest.mark.parametrize("src", ["Z = X * (X > 0)", "M = X > 0\nZ = M * X",
                                 "Z = X * (X != 0)", "Z = X * (X > 1)"])
def test_masked_multiply_sparse_input(src, optlevel):
    rp, _, rj, _ = _both(src, {"X": _csr65()}, out="Z", optlevel=optlevel)
    _same_stored(_stored(rp.get("Z")), _stored(rj.get("Z")))
