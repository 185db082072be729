"""The slice as a whole: scripts/algorithms/LinearRegCG.dml through the JAX
package's MLContext and the port's MLContext(device="cpu"), on the same
numpy-seeded inputs.

Bars (the reference's cross-backend bars, BASELINE.md):
- fp64 (the "auto" policy on the CPU): beta at relative 1e-9, the same
  iteration count, and every number of the printed statistics lines at
  relative 1e-9;
- fp32 ("single"), with the JAX package running its Pallas mmchain kernel
  in interpret mode inside its fused CG loop: beta at relative 1e-3.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.codegen.backend import force_variant
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.runtime.data import from_reference
from systemml_tpu_torch.utils.config import DMLConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "algorithms", "LinearRegCG.dml")
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?|NaN|-?Infinity")


def _data(seed, n, m, dtype=np.float64):
    """Well-conditioned X (standard normal) and a noisy y with an offset.
    The CG stops at tol 1e-4, well before m iterations, so beta and the
    statistics are those of a truncated CG. On an ill-conditioned X a
    truncated CG amplifies rounding differences: there the JAX package's
    own fused and eager runs differ at 1e-4, so no port could meet 1e-9."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m))
    y = (x @ rng.standard_normal((m, 1)) + 0.3 * rng.standard_normal((n, 1))
         + 2.0)
    return x.astype(dtype), y.astype(dtype)


def _run(ctx, script, x, y, args, outputs=("beta",)):
    script.input("X", x).input("y", y)
    for k, v in args.items():
        script.arg(k, v)
    script.output(*outputs)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ctx.execute(script)
    return res, out.getvalue()


def _run_jax(x, y, args, cfg=None, outputs=("beta",)):
    return _run(JaxMLContext(cfg or JaxConfig()), jax_dml_file(SCRIPT),
                x, y, args, outputs)


def _run_port(x, y, args, cfg=None, outputs=("beta",)):
    return _run(MLContext(cfg or DMLConfig(device="cpu")), dmlFromFile(SCRIPT),
                x, y, args, outputs)


def _numbers(text):
    """The iteration line and the statistics lines, as (label, numbers)."""
    out = []
    for line in text.splitlines():
        if line.startswith("LinearRegCG:") or re.match(r"^[A-Z0-9_]+,", line):
            label = _NUM.sub("#", line)
            out.append((label, [float(v.replace("Infinity", "inf"))
                                for v in _NUM.findall(line)]))
    return out


@pytest.mark.parametrize("icpt", [0, 1, 2])
def test_fp64_matches_jax(icpt):
    x, y = _data(11 + icpt, 200, 20)
    args = {"icpt": icpt, "tol": 1e-4, "reg": 1e-6, "maxi": 0}
    rj, tj = _run_jax(x, y, args)
    rp, tp = _run_port(x, y, args)
    bj, bp = rj.get_matrix("beta"), rp.get_matrix("beta")
    assert bp.dtype == np.float64 and bp.shape == bj.shape
    np.testing.assert_allclose(bp, bj, rtol=1e-9, atol=0)
    nj, np_ = _numbers(tj), _numbers(tp)
    assert [lab for lab, _ in np_] == [lab for lab, _ in nj] and len(nj) >= 10
    it_j, it_p = nj[0][1][0], np_[0][1][0]
    assert it_p == it_j and 1 <= it_j < x.shape[1] + (icpt > 0)
    for (lab, vj), (_, vp) in zip(nj, np_):
        np.testing.assert_allclose(vp, vj, rtol=1e-9, atol=0, err_msg=lab)


def test_fp32_matches_jax_pallas_kernel(monkeypatch):
    from systemml_tpu.codegen import kernels as jax_kernels

    traced = []
    kernel = jax_kernels.mmchain_kernel
    monkeypatch.setattr(jax_kernels, "mmchain_kernel",
                        lambda *a, **k: traced.append(1) or kernel(*a, **k))
    x, y = _data(21, 1024, 128, np.float32)
    args = {"icpt": 0, "tol": 1e-6, "reg": 1e-6, "maxi": 30}
    jcfg = JaxConfig()
    jcfg.floating_point_precision = "single"
    jcfg.pallas_mode = "always"
    # one device: the test session's virtual 8-device CPU mesh would
    # otherwise take the JAX package's distributed mmchain
    jcfg.exec_mode = "SINGLE_NODE"
    # without the forced variant the analytic cost picks the two-pass arm
    # at this size; with it the JAX package runs the Pallas kernel
    with force_variant("mmchain", "pallas_single_pass"):
        rj, _ = _run_jax(x, y, args, jcfg)
    assert traced, "the JAX package did not reach its Pallas mmchain kernel"
    pcfg = DMLConfig(device="cpu")
    pcfg.floating_point_precision = "single"
    rp, tp = _run_port(x, y, args, pcfg)
    bj, bp = rj.get_matrix("beta"), rp.get_matrix("beta")
    assert bp.dtype == np.float32 and bj.dtype == np.float32
    err = np.linalg.norm(bp.astype(np.float64) - bj) / np.linalg.norm(bj)
    assert err <= 1e-3
    assert "LinearRegCG: iterations = " in tp


def test_carry_beta_from_jax_into_port():
    x, y = _data(31, 150, 12)
    rj, _ = _run_jax(x, y, {"tol": 1e-6, "maxi": 0}, outputs=("beta", "pred"))
    values = from_reference({"X": x, "beta": rj.get_matrix("beta")}, "cpu")
    assert values["beta"].array.dtype.is_floating_point
    script = dml("pred = X %*% beta").output("pred")
    for name, value in values.items():
        script.input(name, value)
    rp = MLContext(device="cpu").execute(script)
    np.testing.assert_allclose(rp.get_matrix("pred"), rj.get_matrix("pred"),
                               rtol=1e-9, atol=0)


@pytest.mark.parametrize("key,value,item", [
    # settings of static analysis (item 11b) and of the multi-process
    # runtime (item 12) wait; the port's fleet (item 13a) reads its own
    ("donation_sanitizer", "check", "observability and static analysis"),
    ("xla_cache_dir", "/tmp/x", "compiles no XLA"),
    ("mesh_shape", {"dp": 4}, "distributed and elastic"),
    # the port schedule of the multi-process runtime's scheduled_port
    ("fleet_serving_ports", (7101, 7102), "distributed and elastic"),
])
def test_setting_the_port_does_not_read_raises(key, value, item):
    """A setting the port would ignore raises, naming its ROADMAP item,
    instead of running with no effect."""
    cfg = DMLConfig(device="cpu")
    cfg.set(key, value)
    with pytest.raises(NotImplementedError, match=item):
        MLContext(cfg).execute(dml("x = 1"))


@pytest.mark.parametrize("key,value", [
    # the fleet's settings (fleet/, obs/fleet.py) now run
    ("fleet_heartbeat_s", 2.0),
    ("obs_fleet_dir", "fleet"),
    ("fleet_admission_inflight_max", 2),
    # and its fault-injection sites are accepted
    ("fault_injection", "fleet.route:worker:1"),
    ("fault_injection", "fleet.admit:error:1,router.budget:error:2"),
])
def test_fleet_settings_and_fault_sites_run(key, value):
    cfg = DMLConfig(device="cpu")
    cfg.set(key, value)
    res = MLContext(cfg).execute(dml("x = 1 + 2").output("x"))
    assert res.get_scalar("x") == 3
