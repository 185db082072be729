"""The slice as a whole: scripts/algorithms/l2-svm.dml and
MultiLogReg.dml (and LinearRegCG.dml) at optlevel 3 through the port's
MLContext(device="cpu"), on numpy-seeded inputs.

- Against the JAX package at optlevel 3 with pallas_mode "never": the
  same spoof plans (tests/test_torch_spoof.py holds them equal), run by
  its jnp arm, which also keeps clear of its Pallas kernels' refusal of
  0-d array scalar leaves. Bars: relative 1e-9 in fp64 (the "auto" policy
  on the CPU), 1e-3 in fp32 ("single"), as the reference's cross-backend
  bars (BASELINE.md).
- Against the port at optlevel 2 (no fusion): relative 1e-9 in fp64.
- rexpand against the JAX package's ops/param.py:75.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.ops import param as jax_param
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.ops import param
from systemml_tpu_torch.utils.config import DMLConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALG = os.path.join(ROOT, "scripts", "algorithms")


def _features(seed, n, m):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m))
    z = x @ rng.standard_normal((m, 1)) + 0.1 * rng.standard_normal((n, 1))
    return x, z


def _svm_data(seed, n=400, m=24):
    x, z = _features(seed, n, m)
    return {"X": x, "Y": np.where(z >= 0, 1.0, -1.0)}


def _mlr_data(seed, n=400, m=24, k=5):
    """k classes from the quantiles of X w + noise, labels 1..k."""
    x, z = _features(seed, n, m)
    labels = 1.0 + (np.argsort(np.argsort(z[:, 0])) * k) // n
    return {"X": x, "Y_vec": labels.reshape(-1, 1)}


CASES = {
    "l2svm": ("l2-svm.dml", _svm_data, {"maxiter": 15}, "w"),
    "multilogreg": ("MultiLogReg.dml", _mlr_data, {"moi": 10}, "B"),
}


def _run(ctx, script, data, args, out, dtype):
    for k, v in data.items():
        script.input(k, v.astype(dtype))
    for k, v in args.items():
        script.arg(k, v)
    script.output(out)
    with contextlib.redirect_stdout(io.StringIO()):
        res = ctx.execute(script)
    return res


def _port(name, data, optlevel, single=False):
    script, _, args, out = CASES[name]
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = optlevel
    if single:
        cfg.floating_point_precision = "single"
    ml = MLContext(cfg)
    res = _run(ml, dmlFromFile(os.path.join(ALG, script)), data, args, out,
               np.float32 if single else np.float64)
    return res.get_matrix(out), ml._stats


def _jax(name, data, single=False):
    script, _, args, out = CASES[name]
    cfg = JaxConfig()
    cfg.optlevel = 3
    cfg.pallas_mode = "never"
    # one device: the test session's virtual 8-device CPU mesh stays out
    cfg.exec_mode = "SINGLE_NODE"
    if single:
        cfg.floating_point_precision = "single"
    res = _run(JaxMLContext(cfg), jax_dml_file(os.path.join(ALG, script)),
               data, args, out, np.float32 if single else np.float64)
    return res.get_matrix(out)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_optlevel3_fp64_matches_jax(name):
    data = CASES[name][1](11)
    ref = _jax(name, data)
    got, stats = _port(name, data, 3)
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    # the fused plans ran, and none of them took the plain arm by layout
    assert stats.op_count["spoof"] > 0
    assert stats.estim_counts["spoof_selected"] >= 3
    assert stats.estim_counts["spoof_plain_by_layout"] == 0
    assert stats.estim_counts["spoof_compile_errors"] == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_optlevel3_fp32_matches_jax(name):
    data = CASES[name][1](21)
    ref = _jax(name, data, single=True)
    got, stats = _port(name, data, 3, single=True)
    # (the JAX package's MultiLogReg returns B in fp64 under x64: its
    # matrix(0, ...) start; the port keeps the policy's fp32)
    assert got.dtype == np.float32
    assert _rel(got, ref) <= 1e-3
    assert stats.op_count["spoof"] > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_optlevel3_matches_optlevel2(name):
    data = CASES[name][1](31)
    fused, s3 = _port(name, data, 3)
    plain, s2 = _port(name, data, 2)
    np.testing.assert_allclose(fused, plain, rtol=1e-9, atol=1e-12)
    assert s3.op_count["spoof"] > 0 and s2.op_count["spoof"] == 0


def test_linregcg_optlevel3_matches_jax():
    rng = np.random.default_rng(41)
    x = rng.standard_normal((300, 20))
    y = x @ rng.standard_normal((20, 1)) + 0.3 * rng.standard_normal((300, 1))
    args = {"icpt": 0, "tol": 1e-4, "reg": 1e-6, "maxi": 0}
    path = os.path.join(ALG, "LinearRegCG.dml")
    jcfg = JaxConfig()
    jcfg.optlevel = 3
    jcfg.pallas_mode = "never"
    pcfg = DMLConfig(device="cpu")
    pcfg.optlevel = 3
    outs = []
    for ctx, script in ((JaxMLContext(jcfg), jax_dml_file(path)),
                        (MLContext(pcfg), dmlFromFile(path))):
        script.input("X", x).input("y", y)
        for k, v in args.items():
            script.arg(k, v)
        with contextlib.redirect_stdout(io.StringIO()):
            outs.append(ctx.execute(script.output("beta")).get_matrix("beta"))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-9, atol=0)


@pytest.mark.parametrize("direction", ["cols", "rows"])
@pytest.mark.parametrize("cast", [True, False])
def test_rexpand_matches_jax(direction, cast):
    """Ids 1..max, ids outside it (0, max + 1, negative) and ids at x.5
    (rounded half to even by both)."""
    ids = np.array([[1.0], [3.0], [2.5], [3.5], [0.0], [5.0], [-1.0], [4.0],
                    [1.49], [4.6]])
    ref = np.asarray(jax_param.rexpand(jnp.asarray(ids), 4, direction, cast))
    got = param.rexpand(torch.from_numpy(ids), 4, direction, cast)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)


def test_rexpand_through_dml():
    ids = np.array([[2.0], [1.0], [3.0], [3.0]])
    res = MLContext(device="cpu").execute(
        dml('Y = rexpand(target=v, max=3, dir="cols")\n'
            'Z = rexpand(target=v, max=4, dir="rows")')
        .input("v", ids).output("Y", "Z"))
    np.testing.assert_array_equal(res.get_matrix("Y"), np.eye(3)[[1, 0, 2, 2]])
    np.testing.assert_array_equal(res.get_matrix("Z"),
                                  np.eye(4)[[1, 0, 2, 2]].T)
