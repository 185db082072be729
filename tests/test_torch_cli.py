"""The port's entry points beside the JAX package's, on the CPU: the CLI
(api/cli.py, `python -m systemml_tpu_torch`), JMLC (api/jmlc.py), the
lazy matrix DSL (api/defmatrix.py), PyDML (lang/pydml.py), Python UDFs
(api/udf.py), `-explain` (utils/explain.py) and `-debug`
(utils/debugger.py).

The cases of tests/test_cli.py, test_defmatrix.py and test_pydml.py, and
the JMLC case of test_runtime.py, each run through both packages on the
same numpy-made inputs where the JAX package has the counterpart; the
CLI runs with a config file that sets `"device": "cpu"` (the port's
entry points run on the card otherwise, and raise without one).

Bars: printed lines equal; fp64 relative 1e-9 (1e-12 where both sides
compute the same ops in the same order).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from systemml_tpu.api import cli as jax_cli
from systemml_tpu.api import defmatrix as jdm
from systemml_tpu.api.jmlc import Connection as JaxConnection
from systemml_tpu.lang.pydml import parse_pydml as jax_parse_pydml
from systemml_tpu_torch.api import cli
from systemml_tpu_torch.api import defmatrix as dm
from systemml_tpu_torch.api.jmlc import Connection
from systemml_tpu_torch.lang.parser import parse
from systemml_tpu_torch.lang.pydml import parse_pydml
from systemml_tpu_torch.utils import config as port_config
from systemml_tpu_torch.utils.config import DMLConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu_json(tmp_path):
    p = tmp_path / "cpu.json"
    p.write_text(json.dumps({"device": "cpu"}))
    return str(p)


@pytest.fixture
def port_cpu():
    old = port_config.get_config()
    port_config.set_config(DMLConfig(device="cpu"))
    yield
    port_config.set_config(old)


def _both(argv, cpu_json):
    """stdout of the port's CLI (on the CPU) and of the JAX package's."""
    outs = []
    for main, extra in ((cli.main, ["-config", cpu_json]),
                        (jax_cli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue())
    return outs


# ---- tests/test_cli.py -----------------------------------------------------

def test_parse_script_args_positional_and_named():
    bound = cli.parse_script_args(["a", "b"], ["X=foo", "k=3", "t=TRUE"])
    assert bound == jax_cli.parse_script_args(["a", "b"],
                                              ["X=foo", "k=3", "t=TRUE"])
    assert bound == {"1": "a", "2": "b", "X": "foo", "k": 3, "t": True}


def test_parse_script_args_bad_nvargs():
    with pytest.raises(SystemExit):
        cli.parse_script_args(None, ["noequals"])


@pytest.mark.parametrize("src", [
    'print("hello " + (41 + 1))',
    "print(ifelse(TRUE, 1, 2))",
    "x = as.integer(-3.7)\nprint(x)",
])
def test_cli_inline_script_matches_jax(cpu_json, src):
    p, j = _both(["-s", src], cpu_json)
    assert p == j


def test_cli_inline_matrix_script_matches_jax(cpu_json):
    p, j = _both(["-s", "X = rand(rows=5, cols=3, seed=4)\n"
                  "print(sum(X %*% t(X)))"], cpu_json)
    np.testing.assert_allclose(float(p), float(j), rtol=1e-12)


def test_cli_file_with_nvargs_and_args(tmp_path, cpu_json):
    f = tmp_path / "t.dml"
    f.write_text('x = $n * 2\nprint("got " + x + " first=" + $1)\n')
    p, j = _both(["-f", str(f), "-nvargs", "n=21", "-args", "7"], cpu_json)
    assert p == j == "got 42 first=7\n"


def test_cli_stats_flag(cpu_json, capsys):
    assert cli.main(["-s", "X = rand(rows=8, cols=4, seed=1)\n"
                     "print(sum(X %*% t(X)))", "-stats", "-config",
                     cpu_json]) == 0
    out = capsys.readouterr().out
    assert "Statistics" in out and "Heavy hitter" in out
    assert "Executed blocks (fused/eager):\t1/0." in out


def test_cli_explain_hops_and_runtime(cpu_json, capsys):
    assert cli.main(["-s", "X = rand(rows=4, cols=4, seed=1)\n"
                     "while (sum(X) < 100) { X = X * 2 }\nprint(sum(X))",
                     "-explain", "-config", cpu_json]) == 0
    out = capsys.readouterr().out
    assert "MAIN PROGRAM" in out and "GENERIC block [fused]" in out
    assert "WHILE [region: X]" in out
    assert cli.main(["-s", "print(1)", "-explain", "runtime", "-config",
                     cpu_json]) == 0
    assert "call:print" not in capsys.readouterr().out


def test_cli_seed_reproducible_and_as_jax(cpu_json):
    src = "X = rand(rows=4, cols=4)\nprint(sum(X))"
    a = _both(["-s", src, "-seed", "7"], cpu_json)
    b = _both(["-s", src, "-seed", "7"], cpu_json)
    assert a == b and a[0] == a[1]


def test_cli_requires_source():
    with pytest.raises(SystemExit):
        cli.main(["-stats"])


@pytest.mark.parametrize("flag,item", [(["-fault", "x:oom"], "distributed")])
def test_cli_waiting_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["-s", "print(1)"] + flag)


def test_cli_mesh_raises(cpu_json):
    with pytest.raises(NotImplementedError, match="distributed"):
        cli.main(["-s", "print(1)", "-exec", "mesh", "-config", cpu_json])


def test_cli_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-s", "print(1)"])


def test_cli_trace_writes_events(tmp_path, cpu_json):
    tr = tmp_path / "t.jsonl"
    assert cli.main(["-s", "X = rand(rows=4, cols=4, seed=1)\ns = sum(X)",
                     "-trace", str(tr), "-config", cpu_json]) == 0
    names = {json.loads(line)["name"] for line in tr.read_text().splitlines()}
    assert {"parse", "compile", "program_execute", "block"} <= names


def test_module_entry_point(cpu_json):
    r = subprocess.run(
        [sys.executable, "-m", "systemml_tpu_torch", "-s", "print(1 + 1)",
         "-config", cpu_json], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout == "2\n"


def test_linregcg_file_io_through_the_cli(tmp_path, cpu_json):
    """LinearRegCG.dml run by the CLI over a binary-block X and a csv y,
    beta written with fmt=binary, against the JAX package's CLI on the
    same files."""
    from systemml_tpu.io import matrixio as jio
    from systemml_tpu.runtime.data import MatrixObject as JaxMatrix

    rng = np.random.default_rng(13)
    x = rng.standard_normal((300, 12))
    beta = rng.standard_normal((12, 1))
    jio.write_matrix(JaxMatrix(x), str(tmp_path / "X.bb"), "binary_block")
    jio.write_matrix(JaxMatrix(x @ beta), str(tmp_path / "y.csv"), "csv")
    outs = {}
    for tag, main, extra in (("p", cli.main, ["-config", cpu_json]),
                             ("j", jax_cli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["-f", os.path.join(REPO, "scripts", "algorithms",
                                            "LinearRegCG.dml"),
                         "-nvargs", f"X={tmp_path}/X.bb",
                         f"Y={tmp_path}/y.csv", f"B={tmp_path}/B{tag}",
                         "fmt=binary", "maxi=20", "tol=1e-9", "reg=1e-6"]
                        + extra) == 0
        outs[tag] = (np.load(str(tmp_path / f"B{tag}")), buf.getvalue())
    bp, bj = outs["p"][0], outs["j"][0]
    np.testing.assert_allclose(bp, bj, rtol=1e-9, atol=1e-12)
    assert np.linalg.norm(bp - beta) / np.linalg.norm(beta) < 1e-6
    assert outs["p"][1].split(",")[0] == outs["j"][1].split(",")[0]


def test_debugger_scripted_session(port_cpu):
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.debugger import DMLDebugger

    prog = compile_program(parse("x = 1 + 1\nM = matrix(2, rows=2, cols=2)"
                                 "\nfor (i in 1:1) { d = 0 }\ny = x * 3\n"))
    stdin = io.StringIO("list\nstep\np x\nwhatis M\ninfo\nc\n")
    stdout = io.StringIO()
    DMLDebugger(prog, stdin=stdin, stdout=stdout).run()
    out = stdout.getvalue()
    assert "GENERIC" in out and "program finished" in out
    assert "M: matrix (2, 2) float64" in out


# ---- JMLC: test_runtime.py's case, and rebinding -------------------------

def test_prepared_script_rebind_matches_jax():
    rng = np.random.default_rng(14)
    src = "Y = X %*% W\ns = sum(Y)"
    ps = Connection(device="cpu").prepare_script(
        src, input_names=["X", "W"], output_names=["s", "Y"])
    pj = JaxConnection().prepare_script(src, input_names=["X", "W"],
                                        output_names=["s"])
    for _ in range(3):
        x, w = rng.standard_normal((4, 3)), rng.standard_normal((3, 2))
        ps.set_matrix("X", x).set_matrix("W", w)
        pj.set_matrix("X", x).set_matrix("W", w)
        got = ps.execute_script().get_scalar("s")
        np.testing.assert_allclose(got, float(pj.execute_script()
                                              .get_scalar("s")), rtol=1e-12)
        np.testing.assert_allclose(got, (x @ w).sum(), rtol=1e-10)
    # one plan per block, reused by every call of the same shapes
    assert ps.stats.compile_count == 1
    assert ps.stats.fused_blocks == 3


def test_jmlc_writes_are_skipped_and_prints_silent(tmp_path, capsys):
    ps = Connection(device="cpu").prepare_script(
        'write(X, $F)\nprint("hi")\ns = sum(X)', input_names=["X"],
        output_names=["s"], args={"F": str(tmp_path / "out.csv")})
    assert ps.execute({"X": np.ones((3, 3))}).get_scalar("s") == 9.0
    assert not (tmp_path / "out.csv").exists()
    assert capsys.readouterr().out == ""


def test_jmlc_unbound_input_raises():
    ps = Connection(device="cpu").prepare_script(
        "s = sum(X)", input_names=["X"], output_names=["s"])
    with pytest.raises(ValueError, match="unbound"):
        ps.execute_script()


def test_jmlc_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Connection()


# ---- defmatrix: test_defmatrix.py's cases against the JAX package ----------

def _pair(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(6, 4)), rng.normal(size=(6, 4))


OPS = {
    "add": lambda m, a, b: m.matrix(a) + m.matrix(b),
    "mul_div_pow": lambda m, a, b: (m.matrix(a) * m.matrix(b)) / (
        m.matrix(b) ** 2 + 1),
    "scalars": lambda m, a, b: 1 - (3 * m.matrix(a) + 2) / 2.0,
    "neg": lambda m, a, b: -m.matrix(a),
    "mmchain": lambda m, a, b: m.matrix(a).T @ (m.matrix(a) @ m.matrix(
        b[:4, :1])),
    "aggs": lambda m, a, b: m.cbind(m.matrix(a).sum(axis=0).T,
                                    m.matrix(a).mean(axis=0).T),
    "full_sum": lambda m, a, b: m.matrix(a).sum() + m.matrix(b).max(),
    "unaries": lambda m, a, b: m.matrix(a).abs().sqrt() + m.matrix(
        b).exp().log(),
    "index": lambda m, a, b: m.matrix(a)[1:4, 0:2],
    "compare": lambda m, a, b: m.matrix(a) > m.matrix(b),
    "solve": lambda m, a, b: m.solve(
        m.matrix(a[:4] @ a[:4].T + 4 * np.eye(4)), m.matrix(b[:4, :1])),
    "rbind": lambda m, a, b: m.rbind(m.matrix(a), m.matrix(b)),
    "ndarray": lambda m, a, b: m.matrix(a) + b,
    "eq": lambda m, a, b: m.matrix(a) == m.matrix(a),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_defmatrix_matches_jax(port_cpu, case):
    a, b = _pair(15)
    got = OPS[case](dm, a, b)
    assert not got.evaluated
    ref = OPS[case](jdm, a, b).toNumPy()
    np.testing.assert_allclose(got.toNumPy(), ref, rtol=1e-12, atol=1e-14)
    assert got.evaluated


def test_defmatrix_constructors_and_multi_output(port_cpu):
    f = dm.full((2, 3), 1.5)
    s = dm.seq(1, 5)
    r = dm.rand(4, 3, seed=3)
    outs = dm.eval(f, s, r)
    np.testing.assert_array_equal(outs[0], np.full((2, 3), 1.5))
    np.testing.assert_array_equal(outs[1].ravel(), np.arange(1, 6))
    np.testing.assert_array_equal(outs[2], jdm.rand(4, 3, seed=3).toNumPy())


def test_defmatrix_negative_index_rejected():
    a, _ = _pair()
    with pytest.raises(ValueError):
        dm.matrix(a)[-1, 0]


# ---- PyDML: test_pydml.py's cases -------------------------------------------

def _norm(x):
    """Structural form, source positions stripped, of either package's
    AST."""
    import dataclasses

    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _norm(getattr(x, f.name))
                 for f in dataclasses.fields(x) if f.name != "pos"})
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


PYDML = {
    "linreg": ("X = rand(rows=100, cols=10, seed=1)\n"
               "y = dot(X, full(1, rows=10, cols=1))\nr = -(dot(transpose(X), y))\n"
               "n = sum(r ** 2)\ni = 0\n"
               "while i < 20 and n > 0.0000000001:\n    n = n / 2\n    i = i + 1\n"
               "print('done ' + i)\n",
               "X = rand(rows=100, cols=10, seed=1)\n"
               "y = X %*% matrix(1, rows=10, cols=1)\nr = -(t(X) %*% y)\n"
               "n = sum(r ^ 2)\ni = 0\n"
               "while (i < 20 & n > 0.0000000001) {\n  n = n / 2\n  i = i + 1\n}\n"
               'print("done " + i)\n'),
    "range": ("for i in range(5, 0, -1):\n    x = i\n", None),
    "def": ("def f(k: int) -> (x: int):\n    x = k\nz = f(1)\n", None),
    "strings": ('x = "a # b"  # comment\ny = "café"\n', None),
}


@pytest.mark.parametrize("case", sorted(PYDML))
def test_pydml_parses_as_jax_and_as_dml(case):
    src, dml_src = PYDML[case]
    p = parse_pydml(src)
    j = jax_parse_pydml(src)
    assert _norm(p.statements) == _norm(j.statements)
    if dml_src is not None:
        assert _norm(p.statements) == _norm(parse(dml_src).statements)


def test_pydml_python_flag_matches_jax(tmp_path, cpu_json):
    f = tmp_path / "t.pydml"
    f.write_text("X = rand(rows=20, cols=5, seed=7)\n"
                 "G = dot(transpose(X), X)\ntot = 0.0\n"
                 "for i in range(5):\n    tot = tot + G[i, i]\n"
                 "print('v=' + (2 ** 3) + ' trace=' + tot)\n")
    p, j = _both(["-f", str(f), "-python"], cpu_json)
    assert p.split(" trace=")[0] == j.split(" trace=")[0] == "v=8"
    np.testing.assert_allclose(float(p.split("=")[-1]),
                               float(j.split("=")[-1]), rtol=1e-9)


# ---- Python UDFs and external functions ------------------------------------

def test_udf_builtin_and_external_function(port_cpu):
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.api.udf import register_udf, unregister_udf

    register_udf("myscale", lambda X, k: X * k)
    register_udf("splitq", lambda X: (X[:2], X[2:]), n_outputs=2)
    # an externalFunction dispatches by its DML name
    register_udf("ext", lambda A, k: A * k)
    try:
        src = """
ext = externalFunction(matrix[double] A, double k) return (matrix[double] B)
    implemented in (classname="myscale")
Y = myscale(X, 2.5)
[P, Q] = splitq(X)
Z = ext(X, 2)
s = sum(Y) + sum(P) * 10 + sum(Q) * 100 + sum(Z) * 1000
"""
        x = np.arange(12.0).reshape(4, 3)
        r = MLContext(DMLConfig(device="cpu")).execute(
            dml(src).input("X", x).output("s"))
        want = (x.sum() * 2.5 + x[:2].sum() * 10 + x[2:].sum() * 100
                + x.sum() * 2 * 1000)
        assert float(r.get_scalar("s")) == want
    finally:
        for n in ("myscale", "splitq", "ext"):
            unregister_udf(n)


def test_external_function_without_udf_raises(port_cpu):
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.hops.builder import DMLValidationError

    src = ("nope = externalFunction(double a) return (double b)\n"
           '    implemented in (classname="nope")\nb = nope(1)\n')
    with pytest.raises(DMLValidationError, match="no Python UDF"):
        MLContext(DMLConfig(device="cpu")).execute(dml(src).output("b"))


def test_mlcontext_reads_stats_and_explain_settings(capsys):
    """The `stats` and `explain` settings are read: MLContext prints the
    compiled plan and the statistics, as the CLI's flags do."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml

    cfg = DMLConfig(device="cpu")
    cfg.stats = True
    cfg.explain = "runtime"
    MLContext(cfg).execute(dml("x = 1 + 2\nprint(x)"))
    out = capsys.readouterr().out
    assert "MAIN PROGRAM" in out and "GENERIC block [fused]" in out
    assert "3\n" in out and "Statistics" in out
