"""The port's mmchain (systemml_tpu_torch/codegen/kernels.py) against the
JAX package's, on the CPU.

- fp32: the JAX package's Pallas `mmchain_kernel`, run in interpret mode
  as tests/test_codegen.py runs it (pallas_mode "always"), against the
  port's `mmchain_plain`. Bar: normwise relative error <= 1e-5 (the same
  products, summed in another order).
- fp64: the Pallas kernel forms its products with preferred_element_type
  float32, so in fp64 it is not a 1e-9 reference. The JAX package's
  fp64 mmchain is its family's two-pass arm (systemml_tpu/ops/mult.py
  mmchain, which keeps the kernel to fp32); the port's `mmchain_plain`
  and its `ops.mult.mmchain` dispatch are held to it at 1e-9.

Inputs come from a numpy seed. m = 1,037 is a multiple of no tile.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from systemml_tpu.codegen import kernels as jk
from systemml_tpu.ops import mult as jmult
from systemml_tpu.utils.config import DMLConfig, get_config, set_config
from systemml_tpu_torch.codegen import kernels as pk
from systemml_tpu_torch.ops import mult as pmult

M, K = 1037, 128
FP32_BAR = 1e-5
FP64_BAR = 1e-9

# (ctype, c, columns of w/y)
CASES = [("XtXv", 1, 0), ("XtXv", 4, 0),
         ("XtwXv", 1, 1), ("XtwXv", 4, 1), ("XtwXv", 4, 4),
         ("XtXvy", 1, 1), ("XtXvy", 4, 1), ("XtXvy", 4, 4)]


def _inputs(seed, c, wc, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(dtype)
    v = rng.standard_normal((K, c)).astype(dtype)
    w = rng.standard_normal((M, wc)).astype(dtype) if wc else None
    return x, v, w


def _normwise(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _with_pallas(fn):
    cfg = DMLConfig()
    cfg.pallas_mode = "always"
    old = get_config()
    set_config(cfg)
    try:
        return fn()
    finally:
        set_config(old)


@pytest.mark.parametrize("ctype,c,wc", CASES)
def test_fp32_plain_matches_pallas_kernel(ctype, c, wc):
    x, v, w = _inputs(3, c, wc, np.float32)
    ref = _with_pallas(lambda: jk.mmchain_kernel(
        jnp.asarray(x), jnp.asarray(v),
        None if w is None else jnp.asarray(w), ctype))
    got = pk.mmchain_plain(_t(x), _t(v), _t(w), ctype)
    assert got.shape == (K, c) and got.dtype == torch.float32
    assert _normwise(got.numpy(), np.asarray(ref)) <= FP32_BAR


@pytest.mark.parametrize("ctype,c,wc", CASES)
def test_fp64_plain_and_dispatch_match_jax_mmchain(ctype, c, wc):
    x, v, w = _inputs(5, c, wc, np.float64)
    ref = np.asarray(jmult.mmchain(jnp.asarray(x), jnp.asarray(v),
                                   None if w is None else jnp.asarray(w),
                                   ctype))
    plain = pk.mmchain_plain(_t(x), _t(v), _t(w), ctype)
    # the wrapper on a CPU tensor, and the ops-level dispatch
    wrapped = pk.mmchain_kernel(_t(x), _t(v), _t(w), ctype)
    dispatched = pmult.mmchain(_t(x), _t(v), _t(w), ctype)
    for got in (plain, wrapped, dispatched):
        assert got.shape == ref.shape and got.dtype == torch.float64
        assert _normwise(got.numpy(), ref) <= FP64_BAR


def test_vector_v_and_cpu_wrapper_does_not_count_launches():
    x, v, w = _inputs(7, 1, 1, np.float32)
    before = pk.mmchain_kernel.launches
    out = pk.mmchain_kernel(_t(x), _t(v[:, 0]), _t(w), "XtwXv")
    assert out.shape == (K, 1)
    assert pk.mmchain_kernel.launches == before
    ref = pk.mmchain_plain(_t(x), _t(v), _t(w), "XtwXv")
    assert torch.equal(out, ref)


def test_support_predicate_is_shape_and_dtype_only():
    assert pk.mmchain_supported(2_000_000, 1000, 1, torch.float32)
    assert pk.mmchain_supported(4097, 128, 8, torch.float32)
    assert not pk.mmchain_supported(4097, 127, 1, torch.float32)
    assert pk.mmchain_supported(4097, 2049, 1, torch.float32)
    assert not pk.mmchain_supported(4097, 1000, 9, torch.float32)
    assert not pk.mmchain_supported(4097, 1000, 1, torch.float64)


def test_row_stride_reads_slices_in_place_and_refuses_transposes():
    x = torch.zeros(40, 300, dtype=torch.float32)
    assert pk.mmchain_row_stride(x) == 300
    assert pk.mmchain_row_stride(x[:, :200]) == 300     # column slice
    assert pk.mmchain_row_stride(x[5:, 1:131]) == 300   # row and column
    assert pk.mmchain_row_stride(x[7:8]) == 300         # one row: its k
    assert pk.mmchain_row_stride(x.T.contiguous().T) is None  # t() view
    assert pk.mmchain_row_stride(x[:, ::2]) is None
    assert pk.mmchain_row_stride(
        torch.zeros(1, 300).expand(40, 300)) is None    # rows overlap
