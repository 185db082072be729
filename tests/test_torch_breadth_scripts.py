"""The slice as a whole: LinearRegDS and GLM through the port's
MLContext(device="cpu") against the JAX package's MLContext, on
numpy-seeded inputs, at optlevels 2 and 3.

- LinearRegDS (tsmm and solve) with icpt 0, 1 and 2, in fp64 (bar 1e-9
  relative) and fp32 ("single", bar 1e-3); under the `double` policy
  (native fp64 in the port) against numpy's solve of the normal
  equations at 1e-9, as tests/test_doublefloat.py's df run.
- GLM (the IRLS loop, solve, and pnorm/qnorm for probit) for the
  gaussian, poisson, binomial-logit, probit and cloglog cases, each with
  icpt 0, 1 and 2 at optlevel 3 and icpt 1 at optlevel 2, against the
  JAX package at the same optlevel (pallas_mode "never": its jnp arms of
  the same fused plans), bar 1e-9; the IRLS loop runs as one region in
  the port, and the port at optlevel 3 agrees with its optlevel 2 run.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dmlFromFile
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.utils.config import DMLConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALG = os.path.join(ROOT, "scripts", "algorithms")


def run_script(script, inputs, args, outputs, optlevel, port=True,
               precision=None, dtype=np.float64):
    """One run of scripts/algorithms/<script> through the port (device
    "cpu") or the JAX package (one device, pallas_mode "never"). Returns
    {output: float64 array}, the session's stats (port only) and the
    loop_fallback events."""
    if port:
        cfg = DMLConfig(device="cpu")
        ctx, ctor = MLContext, dmlFromFile
    else:
        cfg = JaxConfig()
        cfg.exec_mode = "SINGLE_NODE"
        cfg.pallas_mode = "never"
        ctx, ctor = JaxMLContext, jax_dml_file
    cfg.optlevel = optlevel
    if precision:
        cfg.floating_point_precision = precision
    s = ctor(os.path.join(ALG, script))
    for k, v in inputs.items():
        s.input(k, np.asarray(v, dtype=dtype))
    for k, v in (args or {}).items():
        s.arg(k, v)
    s.output(*outputs)
    ml = ctx(cfg)
    with obs.session() as rec, contextlib.redirect_stdout(io.StringIO()):
        res = ml.execute(s)
    out = {}
    for o in outputs:
        v = res.get(o)
        out[o] = np.asarray(res.get_matrix(o) if getattr(v, "ndim", 0) == 2
                            else res.get_scalar(o), dtype=np.float64)
    events = [e.args for e in rec._events if e.name == "loop_fallback"]
    return out, getattr(ml, "_stats", None), events


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(1.0, float(np.max(np.abs(b), initial=0.0))))


def _regression(seed, n=160, m=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m))
    x[:, 0] = 3.0 + 2.0 * x[:, 0]       # a shifted, scaled column (icpt 2)
    b = rng.standard_normal((m, 1))
    return x, x @ b + 0.1 * rng.standard_normal((n, 1)), b


# --------------------------------------------------------------------------
# LinearRegDS
# --------------------------------------------------------------------------

@pytest.mark.parametrize("icpt", [0, 1, 2])
@pytest.mark.parametrize("optlevel", [2, 3])
def test_linregds_matches_jax(icpt, optlevel):
    x, y, _ = _regression(icpt + 10 * optlevel)
    args = {"reg": 1e-3, "icpt": icpt}
    got, _, _ = run_script("LinearRegDS.dml", {"X": x, "y": y}, args,
                           ["beta"], optlevel)
    ref, _, _ = run_script("LinearRegDS.dml", {"X": x, "y": y}, args,
                           ["beta"], optlevel, port=False)
    assert rel(got["beta"], ref["beta"]) <= 1e-9


@pytest.mark.parametrize("icpt", [0, 2])
def test_linregds_fp32_matches_jax(icpt):
    x, y, _ = _regression(40 + icpt)
    args = {"reg": 1e-3, "icpt": icpt}
    got, _, _ = run_script("LinearRegDS.dml", {"X": x, "y": y}, args,
                           ["beta"], 3, precision="single", dtype=np.float32)
    ref, _, _ = run_script("LinearRegDS.dml", {"X": x, "y": y}, args,
                           ["beta"], 3, port=False, precision="single",
                           dtype=np.float32)
    assert rel(got["beta"], ref["beta"]) <= 1e-3


def test_linregds_double_policy_end_to_end():
    """Under the `double` policy the port runs native fp64: LinearRegDS's
    beta within 1e-9 of numpy's solve of the regularized normal
    equations (tests/test_doublefloat.py::test_linregds_df_end_to_end's
    bar, there through double-float pairs)."""
    rng = np.random.default_rng(0)
    n, m, reg = 3000, 30, 1e-3
    x = rng.standard_normal((n, m))
    y = x @ rng.standard_normal((m, 1)) + 0.01 * rng.standard_normal((n, 1))
    got, _, _ = run_script("LinearRegDS.dml", {"X": x, "y": y},
                           {"reg": reg, "icpt": 0}, ["beta"], 2,
                           precision="double")
    exp = np.linalg.solve(x.T @ x + reg * np.eye(m), x.T @ y)
    assert np.linalg.norm(got["beta"] - exp) / np.linalg.norm(exp) < 1e-9


# --------------------------------------------------------------------------
# GLM
# --------------------------------------------------------------------------

def _glm_data(family, seed, n=200, m=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m))
    eta = x @ (0.4 * rng.standard_normal((m, 1)))
    if family == "gaussian":
        return x, eta + 0.2 * rng.standard_normal((n, 1))
    if family == "poisson":
        return x, rng.poisson(np.exp(eta)).astype(float)
    p = {"logit": 1 / (1 + np.exp(-eta)),
         "probit": 0.5 * (1 + np.vectorize(__import__("math").erf)(
             eta / np.sqrt(2))),
         "cloglog": 1 - np.exp(-np.exp(eta))}[family]
    return x, (rng.random((n, 1)) < p).astype(float)


GLM_ARGS = {
    "gaussian": {"dfam": 1, "vpow": 0.0, "link": 1, "lpow": 1.0},
    "poisson": {"dfam": 1, "vpow": 1.0, "link": 1, "lpow": 0.0},
    "logit": {"dfam": 2, "link": 2},
    "probit": {"dfam": 2, "link": 3},
    "cloglog": {"dfam": 2, "link": 4},
}


def _glm(family, icpt, optlevel, port=True):
    x, y = _glm_data(family, 7 * icpt + len(family))
    args = dict(GLM_ARGS[family], icpt=icpt, moi=15, tol=1e-10, reg=1e-3)
    return run_script("GLM.dml", {"X": x, "y": y}, args, ["beta"], optlevel,
                      port=port)


@pytest.mark.parametrize("family", sorted(GLM_ARGS))
@pytest.mark.parametrize("icpt", [0, 1, 2])
def test_glm_optlevel3_matches_jax(family, icpt):
    got, stats, events = _glm(family, icpt, 3)
    ref, _, _ = _glm(family, icpt, 3, port=False)
    assert rel(got["beta"], ref["beta"]) <= 1e-9
    # the IRLS loop ran as one region, with no refusal
    assert events == []
    regions = [ln for ln in stats.display().split("\n")
               if ln.startswith("Loop regions")]
    assert regions and "refused=0" in regions[0], regions
    assert stats.estim_counts.get("spoof_compile_errors", 0) == 0


@pytest.mark.parametrize("family", sorted(GLM_ARGS))
def test_glm_optlevel2_matches_jax_and_optlevel3(family):
    got, _, _ = _glm(family, 1, 2)
    ref, _, _ = _glm(family, 1, 2, port=False)
    assert rel(got["beta"], ref["beta"]) <= 1e-9
    fused, _, _ = _glm(family, 1, 3)
    assert rel(fused["beta"], got["beta"]) <= 1e-9
