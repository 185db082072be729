"""Seeded rand() in the port (systemml_tpu_torch/ops/datagen.py) against
the JAX package's (systemml_tpu/ops/datagen.py), on the CPU.

Bar: bit-identical values (compared as bytes), in fp32 and fp64, for
seeds 0, 1234 and 2**31 - 1, odd shapes, min/max and sparsity 0.3: the
port writes jax.random's threefry2x32 and its uniform bitcast in torch
integer ops, and the one rounding of XLA's contracted
`floats * (max - min) + min` as an emulated FMA. A seed of -1 (or none)
draws a fresh stream per call; with a global seed those streams are
fold_in(PRNGKey(seed), n), as in the JAX package.
"""

import numpy as np
import pytest
import torch

from systemml_tpu.ops import datagen as jax_datagen
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.ops import datagen
from systemml_tpu_torch.utils.config import DMLConfig

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _jax(rows, cols, lo, hi, sp, seed, ndt):
    return np.asarray(jax_datagen.rand(rows, cols, lo, hi, sp, seed=seed,
                                       dtype=ndt))


def _port(rows, cols, lo, hi, sp, seed, tdt):
    return datagen.rand(rows, cols, lo, hi, sp, seed=seed, dtype=tdt,
                        device="cpu").numpy()


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("ndt,tdt", DTYPES)
@pytest.mark.parametrize("seed", [0, 1234, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (1000, 10)])
@pytest.mark.parametrize("lo,hi,sp", [(0.0, 1.0, 1.0), (-2.5, 3.7, 1.0),
                                      (0.1, 0.9, 0.3), (1.0, 1.0, 0.9),
                                      (-0.3, -0.3, 0.5)])
def test_rand_bit_identical_to_jax(ndt, tdt, seed, shape, lo, hi, sp):
    _same_bits(_port(*shape, lo, hi, sp, seed, tdt),
               _jax(*shape, lo, hi, sp, seed, ndt))


@pytest.mark.parametrize("ndt,tdt", DTYPES)
@pytest.mark.parametrize("seed", [0, 1234, 2 ** 31 - 1])
@pytest.mark.parametrize("lo,hi,sp", [(-2.5, 3.7, 1.0), (0.1, 0.9, 0.3),
                                      (1.0, 1.0, 0.9)])
def test_rand_device_seed_bit_identical_to_jax(ndt, tdt, seed, lo, hi, sp):
    """A seed held as a 0-d int64 tensor (a loop region's) derives the key
    with tensor ops, and draws the host seed's bits."""
    got = datagen.rand(7, 3, lo, hi, sp, seed=torch.tensor(seed), dtype=tdt,
                       device="cpu").numpy()
    _same_bits(got, _jax(7, 3, lo, hi, sp, seed, ndt))


@pytest.mark.parametrize("ndt,tdt", DTYPES)
def test_rand_one_rounding_at_scale(ndt, tdt):
    """200,000 draws over wide and narrow ranges: every value's scaling
    is rounded once, as XLA's contracted multiply-add on the CPU."""
    for lo, hi, sp in ((-1e3, 7.25, 1.0), (1e-5, 3e-5, 0.7)):
        _same_bits(_port(400, 500, lo, hi, sp, 99, tdt),
                   _jax(400, 500, lo, hi, sp, 99, ndt))


def test_key_split_and_fold_in_match_jax():
    import jax

    for seed in (0, 42, 2 ** 31 - 1):
        key = jax.random.PRNGKey(seed)
        assert datagen.prng_key(seed) == tuple(int(w) for w in key)
        k1, k2 = jax.random.split(key)
        assert datagen.split(datagen.prng_key(seed)) == (
            tuple(int(w) for w in k1), tuple(int(w) for w in k2))
        folded = jax.random.fold_in(key, 7)
        assert datagen.fold_in(datagen.prng_key(seed), 7) == tuple(
            int(w) for w in folded)


def test_unseeded_streams():
    """seed -1 (and no seed) draws a fresh stream per call; a global seed
    makes the sequence of unseeded calls reproducible and equal to the
    JAX package's."""
    a = datagen.rand(20, 20, seed=-1, device="cpu")
    b = datagen.rand(20, 20, seed=-1, device="cpu")
    assert not torch.equal(a, b)
    try:
        jax_datagen.set_global_seed(5)
        datagen.set_global_seed(5)
        for _ in range(2):
            _same_bits(datagen.rand(9, 4, device="cpu",
                                    dtype=torch.float64).numpy(),
                       np.asarray(jax_datagen.rand(9, 4, dtype=np.float64)))
    finally:
        jax_datagen.set_global_seed(None)
        datagen.set_global_seed(None)


def test_rand_builtin_through_mlcontext():
    """rand() in a DML script, as ALS-CG draws its factors, in the
    configured dtype on the configured device."""
    src = "A = rand(rows=13, cols=5, min=-1, max=2, sparsity=0.5, seed=3)"
    for prec, ndt in (("double", np.float64), ("single", np.float32)):
        cfg = DMLConfig(device="cpu")
        cfg.floating_point_precision = prec
        got = MLContext(cfg).execute(dml(src).output("A")).get_matrix("A")
        _same_bits(got, _jax(13, 5, -1.0, 2.0, 0.5, 3, ndt))


@pytest.mark.parametrize("pdf", ["normal", "poisson"])
def test_other_pdfs_wait_by_name(pdf):
    """The normal pdf came with DNN and models (item 8) and no longer
    waits: it draws the JAX package's values; poisson waits for item 8b,
    by name."""
    if pdf == "normal":
        _same_bits(datagen.rand(3, 3, pdf=pdf, seed=1, dtype=torch.float32,
                                device="cpu").numpy(),
                   np.asarray(jax_datagen.rand(3, 3, pdf=pdf, seed=1,
                                               dtype=np.float32)))
        return
    with pytest.raises(NotImplementedError, match="item 8b"):
        datagen.rand(3, 3, pdf=pdf, seed=1, device="cpu")


# ---- pdf="normal": sqrt(2) * erf_inv(uniform), XLA's erf_inv ------------

# fp64: XLA on the CPU takes log from libm inside erf_inv; the port's
# double-double log (ops/datagen._log64) is one ulp off it for 0.1-0.4%
# of arguments, which moves 54-74 of a million normal draws by at most 3
# ulp (measured over seeds 7, 42 and 123456789). The bound held here:
F64_MAX_ULP = 4
F64_MAX_SHARE = 2e-4


def _ulps(a, b):
    it = np.int32 if a.dtype == np.float32 else np.int64
    return np.abs(a.view(it).astype(np.int64) - b.view(it).astype(np.int64))


def _jax_normal(rows, cols, seed, ndt, sp=1.0):
    return np.asarray(jax_datagen.rand(rows, cols, sparsity=sp, pdf="normal",
                                       seed=seed, dtype=ndt))


@pytest.mark.parametrize("seed", [0, 7, 1234, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (400, 500)])
def test_normal_fp32_bit_identical_to_jax(seed, shape):
    got = datagen.rand(*shape, pdf="normal", seed=seed, dtype=torch.float32,
                       device="cpu").numpy()
    _same_bits(got, _jax_normal(*shape, seed, np.float32))


@pytest.mark.parametrize("seed", [0, 7, 1234, 2 ** 31 - 1])
def test_normal_fp64_within_the_stated_ulp_bound(seed):
    got = datagen.rand(500, 400, pdf="normal", seed=seed,
                       dtype=torch.float64, device="cpu").numpy()
    d = _ulps(got, _jax_normal(500, 400, seed, np.float64))
    assert d.max() <= F64_MAX_ULP, (d.max(), (d > 0).mean())
    assert (d > 0).mean() <= F64_MAX_SHARE, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("ndt,tdt", DTYPES)
def test_normal_with_a_device_seed_and_sparsity(ndt, tdt):
    """A 0-d tensor seed (a loop region's) draws the host seed's bits;
    sparsity drops the same cells as the JAX package's draw."""
    host = datagen.rand(60, 50, sparsity=0.4, pdf="normal", seed=11,
                        dtype=tdt, device="cpu")
    dev = datagen.rand(60, 50, sparsity=0.4, pdf="normal",
                       seed=torch.tensor(11), dtype=tdt, device="cpu")
    assert torch.equal(host.view(torch.int8), dev.view(torch.int8))
    ref = _jax_normal(60, 50, 11, ndt, sp=0.4)
    assert np.array_equal(host.numpy() == 0, ref == 0)
    assert _ulps(host.numpy(), ref).max() <= (0 if ndt == np.float32
                                              else F64_MAX_ULP)


def test_erf_inv_pieces_match_xla():
    """The pieces of XLA's erf_inv on the CPU: its fp32 log (Cephes) and
    log1p, bit for bit; the correctly rounded sqrt; +-1 maps to +-inf."""
    import jax
    from jax import lax

    x = np.random.default_rng(0).uniform(1e-3, 1.0, 100_000).astype(
        np.float32)
    _same_bits(datagen._log32(torch.from_numpy(x)).numpy(),
               np.asarray(jax.jit(lax.log)(x)))
    arg = -(x * x)
    _same_bits(datagen._log1p(torch.from_numpy(arg)).numpy(),
               np.asarray(jax.jit(lax.log1p)(arg)))
    for dt in (np.float32, np.float64):
        w = np.random.default_rng(1).uniform(0.5, 60, 100_000).astype(dt)
        _same_bits(datagen._sqrt(torch.from_numpy(w)).numpy(), np.sqrt(w))
    e = datagen.erf_inv(torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float64))
    assert e.tolist() == [float("-inf"), float("inf"), 0.0]


def test_normal_through_mlcontext_and_unseeded_streams():
    """rand(pdf="normal") in a DML script, seeded, and unseeded under a
    global seed (the layers' init), as the JAX package draws it."""
    from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
    from systemml_tpu.api.mlcontext import dml as jax_dml

    src = ('A = rand(rows=13, cols=5, pdf="normal", seed=3)\n'
           'B = rand(rows=4, cols=6, pdf="normal")')
    cfg = DMLConfig(device="cpu")
    cfg.floating_point_precision = "single"
    try:
        jax_datagen.set_global_seed(5)
        datagen.set_global_seed(5)
        got = MLContext(cfg).execute(dml(src).output("A", "B"))
        from systemml_tpu.utils.config import DMLConfig as JConfig

        jcfg = JConfig()
        jcfg.floating_point_precision = "single"
        ref = JaxMLContext(jcfg).execute(jax_dml(src).output("A", "B"))
    finally:
        jax_datagen.set_global_seed(None)
        datagen.set_global_seed(None)
    for name in ("A", "B"):
        _same_bits(got.get_matrix(name), np.asarray(ref.get_matrix(name)))


@pytest.mark.parametrize("src", ["x = seq(1, 5)", "x = sample(10, 3, 7)"])
def test_seq_and_sample_wait_by_name(src):
    """seq() and sample() through the port's MLContext give the JAX
    package's column bit for bit (tests/test_torch_breadth_ops.py holds
    them at 1, 2 and 3 shuffle rounds)."""
    from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
    from systemml_tpu.api.mlcontext import dml as jax_dml

    got = MLContext(DMLConfig(device="cpu")).execute(
        dml(src).output("x")).get_matrix("x")
    ref = JaxMLContext().execute(jax_dml(src).output("x")).get_matrix("x")
    _same_bits(got, np.asarray(ref))
