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
   and transformencode run the same way.
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
