"""The port stands alone: systemml_tpu_torch and chip_smoke.py import
neither jax nor the JAX package (systemml_tpu).

1. In a subprocess where a sys.meta_path finder refuses `jax`, `jax.*`,
   `systemml_tpu` and `systemml_tpu.*` (and nothing else, so
   `systemml_tpu_torch` imports), the port runs a 50 x 4 LinearRegCG on
   the CPU, l2-svm at optlevel 3 (spoof fusion), LinearRegCG on a
   compressed X (cla "true"), a seeded rand() and ALS-CG at optlevel 3
   (the outer template) and 2 (wdivmm); afterwards neither package is in
   sys.modules.
   The CLI, JMLC, the lazy matrix DSL, PyDML, the native IO library, the
   buffer pool and the block compile run the same way: LinearRegCG.dml
   from `cli.main` over a binary-block X read by the native arm, under a
   pool budget that evicts. Parfor (StepGLM.dml with a task retried after
   an injected OOM, seeded rand() in a parfor body), frames and frame IO,
   and transformencode run the same way. So do the kernel backend and its
   tuner (LinearRegCG at optlevel 3 tuned online, then served from the
   disk cache with no measurement), the cost model, obs/ab, the poisson
   draw and remote parfor's coordinator. So does the serving tier: the
   row-wise safety proof at optlevels 2 and 3, a ScoringService's warmup
   and bucketed scoring, a MicroBatcher's flush, fleet/admission's
   refusal at the bounded queue, a /metrics scrape and the "Serving"
   line of -stats. So does the serving fleet: a Replica over the scorer,
   the Router over http_transport, a rolling update, the trace shards,
   their merge, `python -m systemml_tpu_torch.obs.fleet_trace`'s main and
   the metrics rollup.
2. No source file of the port (Python, CUDA, the host C++), and not
   chip_smoke.py, names them in an import or a dotted module path.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r'''
import importlib.abc
import sys

BLOCKED = ("jax", "systemml_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Refuse())

import numpy as np

from systemml_tpu_torch.api.mlcontext import MLContext, dmlFromFile

rng = np.random.default_rng(0)
x = rng.standard_normal((50, 4))
beta_true = rng.standard_normal((4, 1))
res = MLContext(device="cpu").execute(
    dmlFromFile("scripts/algorithms/LinearRegCG.dml").input("X", x)
    .input("y", x @ beta_true).arg("tol", 1e-12).arg("reg", 0.0)
    .output("beta"))
assert np.allclose(res.get_matrix("beta"), beta_true, rtol=1e-8)
# spoof fusion at optlevel 3 (plan selection, the cell kernel's plain arm)
from systemml_tpu_torch.utils.config import DMLConfig
cfg = DMLConfig(device="cpu")
cfg.optlevel = 3
ml = MLContext(cfg)
ml.printer = lambda s: None
res = ml.execute(
    dmlFromFile("scripts/algorithms/l2-svm.dml").input("X", x)
    .input("Y", np.sign(x @ beta_true)).arg("maxiter", 3).output("w"))
assert np.isfinite(res.get_matrix("w")).all()
assert ml._stats.op_count["spoof"] > 0
# compressed LA: LinearRegCG compresses its categorical X at loop entry
cfg = DMLConfig(device="cpu")
cfg.cla = "true"
ml = MLContext(cfg)
ml.printer = lambda s: None
xc = np.floor(rng.random((200, 4)) * 3)
res = ml.execute(
    dmlFromFile("scripts/algorithms/LinearRegCG.dml").input("X", xc)
    .input("y", xc @ beta_true).arg("tol", 1e-12).arg("reg", 0.0)
    .output("beta"))
assert ml._stats.estim_counts["cla_auto_compressed"] == 1
assert np.allclose(res.get_matrix("beta"), beta_true, rtol=1e-6)
# seeded rand() (threefry in torch) and ALS-CG, which draws its factors
# with it, at optlevel 3 (the outer template) and 2 (wdivmm)
from systemml_tpu_torch.api.mlcontext import dml
from systemml_tpu_torch.ops import datagen
a = datagen.rand(5, 3, seed=7, device="cpu")
got = MLContext(device="cpu").execute(
    dml("A = rand(rows=5, cols=3, seed=7)").output("A")).get_matrix("A")
assert np.array_equal(a.numpy(), got)
v = np.where(rng.random((60, 40)) < 0.5,
             np.round(rng.uniform(0.5, 5.0, (60, 40)) * 2) / 2, 0.0)
ls = []
for optlevel in (3, 2):
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = optlevel
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    ls.append(ml.execute(
        dmlFromFile("scripts/algorithms/ALS-CG.dml").input("V", v)
        .arg("rank", 3).arg("maxi", 2).arg("mii", 2).output("L"))
        .get_matrix("L"))
assert np.allclose(ls[0], ls[1], rtol=1e-9)
# the DNN slice: a tiny Caffe2DML fit (the conv, pool and normal-draw
# paths, its training loop as a region), predict, the mllearn and
# Keras2DML surfaces, attention and the layout pass
from systemml_tpu_torch.models import (Caffe2DML, Keras2DML,
                                       LinearRegression, zoo)
from systemml_tpu_torch.models import dmlgen, proto
from systemml_tpu_torch.hops import layout
from systemml_tpu_torch.ops import dnn
from systemml_tpu_torch.parallel import ring
from systemml_tpu_torch.utils.config import set_config
import torch
set_config(DMLConfig(device="cpu"))
xs = rng.standard_normal((32, 64))
ys = np.arange(32) % 10
clf = Caffe2DML(zoo.tiny_convnet(), epochs=1, batch_size=16, seed=1).fit(
    xs, ys)
assert all(np.isfinite(v.numpy()).all() for v in clf.params.values())
assert clf.predict_proba(xs[:4]).shape == (4, 10)
assert np.allclose(LinearRegression().fit(x, x @ beta_true).coef_.ravel()[
    :4], beta_true.ravel(), rtol=1e-6)
q = torch.from_numpy(rng.standard_normal((5, 3)))
assert ring.attention(q, q, q, causal=True).shape == (5, 3)
assert datagen.rand(4, 4, pdf="normal", seed=3, device="cpu").shape == (4, 4)
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("ISOLATED_OK")
'''


# the entry points of the CLI and io/ slice, and the buffer pool and the
# block compile under them
_CHILD_ENTRY = _CHILD.split("import numpy as np")[0] + r'''
import contextlib
import io
import json
import os
import tempfile

import numpy as np
import torch

from systemml_tpu_torch import native
from systemml_tpu_torch.api import cli, defmatrix, jmlc, udf
from systemml_tpu_torch.io import binaryblock, matrixio
from systemml_tpu_torch.lang import pydml
from systemml_tpu_torch.runtime import (blockcompile, bufferpool,
                                        checkpoint)
from systemml_tpu_torch.runtime.data import MatrixObject
from systemml_tpu_torch.utils import config, debugger, explain

d = tempfile.mkdtemp()
cfg_path = os.path.join(d, "cpu.json")
with open(cfg_path, "w") as f:
    json.dump({"device": "cpu", "optlevel": 3,
               "bufferpool_budget_bytes": 8000,
               "bufferpool_min_bytes": 1024}, f)
config.set_config(config.DMLConfig(device="cpu"))
rng = np.random.default_rng(0)
x = rng.standard_normal((300, 6))
beta_true = rng.standard_normal((6, 1))
matrixio.write_matrix(MatrixObject(torch.from_numpy(x)),
                      os.path.join(d, "X.bb"), "binary_block")
matrixio.write_matrix(MatrixObject(torch.from_numpy(x @ beta_true)),
                      os.path.join(d, "y.csv"), "csv")
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert cli.main(["-f", "scripts/algorithms/LinearRegCG.dml", "-stats",
                     "-config", cfg_path, "-nvargs",
                     "X=" + os.path.join(d, "X.bb"),
                     "Y=" + os.path.join(d, "y.csv"),
                     "B=" + os.path.join(d, "B"), "fmt=binary",
                     "tol=1e-12", "reg=0"]) == 0
assert "io_read_native=2" in buf.getvalue(), buf.getvalue()
assert "Buffer pool:" in buf.getvalue()
assert np.allclose(np.load(os.path.join(d, "B")), beta_true, rtol=1e-8)
ps = jmlc.Connection(device="cpu").prepare_script(
    "s = sum(X %*% W)", input_names=["X", "W"], output_names=["s"])
for _ in range(2):
    assert np.isclose(float(ps.execute({"X": x, "W": beta_true})
                            .get_scalar("s")), (x @ beta_true).sum())
assert np.allclose(defmatrix.matrix(x).sum(axis=0).toNumPy(),
                   x.sum(axis=0).reshape(1, -1))
assert pydml.parse_pydml("y = 2 ** 3\n").statements
print("ISOLATED_OK")
'''


# parfor (its plan, workers, merge, retries and rand sub-streams), frames
# and frame IO, and the transform builtins
_CHILD_PARFOR = _CHILD.split("import numpy as np")[0] + r'''
import json
import os
import tempfile

import numpy as np

from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.io import matrixio
from systemml_tpu_torch.lang.ast import ValueType
from systemml_tpu_torch.ops import datagen
from systemml_tpu_torch.runtime import parfor, parfor_opt, transform
from systemml_tpu_torch.runtime.data import FrameObject
from systemml_tpu_torch.utils.config import DMLConfig

rng = np.random.default_rng(0)
x = rng.standard_normal((60, 4))
y = (x[:, :1] > 0).astype(float)
cfg = DMLConfig(device="cpu")
cfg.fault_injection = "parfor.task:oom:1"
cfg.resil_backoff_base_s = 1e-4
ml = MLContext(cfg)
ml.printer = lambda s: None
res = ml.execute(dmlFromFile("scripts/algorithms/StepGLM.dml")
                 .input("X", x).input("y", y).output("B"))
assert np.isfinite(res.get_matrix("B")).all()
assert ml._stats.resil_counts["retry"] == 1
datagen.set_global_seed(3)
r = MLContext(device="cpu").execute(dml(
    "R = matrix(0, rows=6, cols=2)\n"
    "parfor (i in 1:6, par=3) {\n  R[i,] = rand(rows=1, cols=2)\n}")
    .output("R")).get_matrix("R")
datagen.set_global_seed(None)
assert len({tuple(row) for row in r}) == 6
d = tempfile.mkdtemp()
fr = FrameObject([np.array(["a", "b", "a"], dtype=object),
                  np.array([1.0, 2.0, 3.0])],
                 [ValueType.STRING, ValueType.DOUBLE], ["c", "v"])
matrixio.write_frame(fr, os.path.join(d, "f.csv"), ",", True, "csv")
src = ('F = read("' + os.path.join(d, "f.csv") + '", data_type="frame", '
       'format="csv", header=TRUE)\n'
       '[X, M] = transformencode(target=F, spec="{\\"recode\\": [\\"c\\"]}")\n'
       'G = rbind(F, F[1:1, ])\n')
res = MLContext(device="cpu").execute(dml(src).output("X", "M", "G"))
assert res.get_matrix("X").tolist() == [[1, 1], [2, 2], [1, 3]]
assert res.get("G").num_rows == 4
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("ISOLATED_OK")
'''


# the kernel backend with its tuner (online, then cached from disk), the
# cost model, the paired A/B harness, the poisson draw and remote parfor
# (its coordinator; the workers are processes of the port's own module)
_CHILD_BACKEND = _CHILD.split("import numpy as np")[0] + r'''
import os
import tempfile

import numpy as np

from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
from systemml_tpu_torch.codegen import backend, costmodel, tune
from systemml_tpu_torch.hops.cost import kernel_feature_row
from systemml_tpu_torch.obs import ab
from systemml_tpu_torch.ops import datagen
from systemml_tpu_torch.runtime import remote
from systemml_tpu_torch.utils.config import DMLConfig

rng = np.random.default_rng(0)
x = rng.standard_normal((200, 4))
beta_true = rng.standard_normal((4, 1))
cfg = DMLConfig(device="cpu")
cfg.optlevel = 3
cfg.pallas_mode = "always"
cfg.codegen_tune_mode = "cached"
cfg.codegen_tune_cache = os.path.join(tempfile.mkdtemp(), "tune.json")
cfg.codegen_tune_trials = 2
betas = []
for run in range(2):
    backend.reset_process_state()
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    betas.append(ml.execute(
        dmlFromFile("scripts/algorithms/LinearRegCG.dml").input("X", x)
        .input("y", x @ beta_true).arg("tol", 1e-12).arg("reg", 0.0)
        .output("beta")).get_matrix("beta"))
    if run == 0:
        assert tune.measurement_count() > 0
assert tune.measurement_count() == 0
assert np.array_equal(betas[0], betas[1])
assert np.allclose(betas[0], beta_true, rtol=1e-8)
assert len(kernel_feature_row((10, 10))) == 4
assert ab.compare_samples([1.0, 1.1, 1.0], [2.0, 2.1, 2.0],
                          higher_is_better=False).verdict == ab.VERDICT_A
p = datagen.rand(30, 20, pdf="poisson", lambda_=12.0, seed=5, device="cpu")
assert float(p.min()) >= 0 and float(p.sum()) > 0
src = ("R = matrix(0, rows=4, cols=1)\n"
       "parfor (i in 1:4, mode=\"remote\", par=2) {\n"
       "  R[i, 1] = sum(X) * i\n}")
r = MLContext(device="cpu").execute(dml(src).input("X", x).output("R"))
assert np.allclose(r.get_matrix("R").ravel(), x.sum() * np.arange(1, 5))
assert remote.last_run["devices"] == ["cpu", "cpu"]
remote.shutdown_pool()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("ISOLATED_OK")
'''


# the serving tier: the row-wise proof, bucketed scoring, the micro-batcher,
# admission's bounded queue, /metrics and the -stats line
_CHILD_SERVING = _CHILD.split("import numpy as np")[0] + r'''
import threading
import urllib.request

import numpy as np

from systemml_tpu_torch.api.jmlc import Connection
from systemml_tpu_torch.api.serving import MicroBatcher, ScoringService
from systemml_tpu_torch.compiler.lower import analyze_rowwise_safety
from systemml_tpu_torch.fleet.admission import QueueFullError
from systemml_tpu_torch.utils.config import DMLConfig, set_config

set_config(DMLConfig(device="cpu"))
src = ("Z = X %*% W + b\nE = exp(Z - rowMaxs(Z))\n"
       "yhat = E / rowSums(E)")
meta = {"X": {"shape": (None, 6)}, "W": {"shape": (6, 3)},
        "b": {"shape": (1, 3)}}
rng = np.random.default_rng(0)
consts = {"W": rng.standard_normal((6, 3)), "b": rng.standard_normal((1, 3))}
svcs = {}
for optlevel in (2, 3):
    cfg = DMLConfig(device="cpu")
    cfg.optlevel = optlevel
    ps = Connection(cfg).prepare_script(
        src, input_names=["X", "W", "b"], output_names=["yhat"],
        input_meta=meta)
    proof = analyze_rowwise_safety(ps._program, "X", ["yhat"],
                                   known_dims={"W": (6, 3), "b": (1, 3)})
    assert proof.safe == (optlevel == 2), proof
    svcs[optlevel] = ScoringService(
        ps, constants=consts, ladder=(1, 8),
        validate="auto" if optlevel == 2 else "force")
svc = svcs[3]
assert svc.warmup(6) == [1, 8]
x = rng.standard_normal((5, 6))
z = x @ consts["W"] + consts["b"]
ref = np.exp(z - z.max(1, keepdims=True))
ref /= ref.sum(1, keepdims=True)
assert np.allclose(svc.score(x)["yhat"].numpy(), ref, rtol=1e-12)
with MicroBatcher(svcs[2], max_batch=4, deadline_us=50_000,
                  queue_rows_max=64) as mb:
    outs = {}
    ts = [threading.Thread(target=lambda t=t: outs.__setitem__(
        t, mb.score(x[t:t + 1]))) for t in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(np.allclose(outs[t], ref[t:t + 1], rtol=1e-12)
               for t in range(4))
    try:
        mb.score(np.zeros((65, 6)))
        raise AssertionError("the bounded queue took 65 rows")
    except QueueFullError:
        pass
with svc.serve_metrics(port=0) as ep:
    with urllib.request.urlopen(ep.url, timeout=10) as resp:
        body = resp.read().decode()
assert "smtpu_serving_requests_total 5" in body, body
assert "Serving (event=count)" in svcs[2]._ps.stats.display()
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("ISOLATED_OK")
'''


# the serving fleet: a replica over the scorer, the router, a rolling
# update, the trace shards, the merge and its command, the metrics rollup
_CHILD_FLEET = _CHILD.split("import numpy as np")[0] + r'''
import os
import subprocess
import tempfile

import numpy as np

from systemml_tpu_torch import fleet
from systemml_tpu_torch.api.jmlc import Connection
from systemml_tpu_torch.api.serving import ScoringService
from systemml_tpu_torch.obs import fleet as obs_fleet
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.utils.config import DMLConfig, set_config
from systemml_tpu_torch.utils.stats import Statistics

cfg = DMLConfig(device="cpu")
cfg.optlevel = 3
set_config(cfg)
d = tempfile.mkdtemp()
obs_fleet.set_identity("run-iso", 0, 0, 0, 1)
rec = obs.FlightRecorder()
obs.install(rec)
writer = obs_fleet.attach_shard(rec, d)
src = ("Z = X %*% W + b\nE = exp(Z - rowMaxs(Z))\n"
       "yhat = E / rowSums(E)")
meta = {"X": {"shape": (None, 6)}, "W": {"shape": (6, 3)},
        "b": {"shape": (1, 3)}}
rng = np.random.default_rng(0)


def factory(g):
    ps = Connection(cfg).prepare_script(
        src, input_names=["X", "W", "b"], output_names=["yhat"],
        input_meta=meta)
    svc = ScoringService(ps, constants={"W": rng.standard_normal((6, 3)),
                                        "b": rng.standard_normal((1, 3))},
                         ladder=(1, 8), validate="force")
    svc.warmup(6)
    return lambda payload: {"yhat": svc.score(
        np.asarray(payload["x"]))["yhat"].tolist()}


replica = fleet.Replica(factory, fleet_dir=d)
replica.serve(0, port=0)
replica.serve(1, port=0)
replica.register()
reg = fleet.read_registry(d)
table = fleet.RoutingTable()
table.install({(0, g): reg[0].url(g) for g in (0, 1)})
router = fleet.Router(table, fleet.http_transport(timeout_s=30.0))
x = rng.standard_normal((3, 6)).tolist()
assert router.submit({"x": x})["prog_gen"] == 0
fleet.RollingUpdate(router, 0, 1, weights=(100,)).run(
    retire=replica.retire_generation)
out = router.submit({"x": x})
assert out["prog_gen"] == 1 and len(out["outputs"]["yhat"]) == 3
replica.close()
writer.close()
obs_fleet.write_metrics_snapshot(d, Statistics())
merged = obs_fleet.merge_dir(d)
names = [s["name"] for s in obs_fleet.rollout_storyline(merged)]
assert names[-1] == "rollout_done", names
assert obs_fleet.rollup_metrics(obs_fleet.load_metrics_snapshots(d))
from systemml_tpu_torch.obs import fleet_trace
assert fleet_trace.main([d, "--json"]) == 0
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("ISOLATED_OK")
'''


def test_serving_fleet_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _CHILD_FLEET], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


def test_serving_tier_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _CHILD_SERVING], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


def test_backend_tuner_poisson_remote_run_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _CHILD_BACKEND], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


def test_parfor_frames_transform_run_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _CHILD_PARFOR], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


def test_entry_points_run_with_jax_and_jax_package_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _CHILD_ENTRY], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


def test_port_runs_with_jax_and_jax_package_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b)|systemml_tpu\.", re.MULTILINE)


def test_sources_name_neither_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "systemml_tpu_torch")):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    hits = []
    for path in files:
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)!r}")
    assert len(files) > 20
    assert not hits, hits
