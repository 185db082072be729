"""The port's IO against the JAX package's, on the CPU.

io/matrixio.py and io/binaryblock.py of both packages: every matrix
format written by one reads back in the other, dense and sparse, with
the same .mtd metadata; the native library's readers and writers
(systemml_tpu_torch/native, its own copy of the C++ sources) against
the pure-Python ones, byte for byte; the arm each read and write took,
counted; the read/write/checkpoint/restore/checkpointExists builtins
through both packages' MLContext; and LinearRegCG.dml reading X and y
from files and writing beta, as test_algorithms.py's file IO case.

Bars: values bit-identical where a file carries them (binary, binary
block, %.17g text), fp64 1e-9 for script results.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import scipy.sparse
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.io import binaryblock as jax_bb
from systemml_tpu.io import matrixio as jax_io
from systemml_tpu.runtime.data import MatrixObject as JaxMatrix
from systemml_tpu.runtime.sparse import SparseMatrix as JaxSparse
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.io import binaryblock, matrixio
from systemml_tpu_torch.runtime.data import MatrixObject
from systemml_tpu_torch.runtime.sparse import SparseMatrix
from systemml_tpu_torch.utils import config as port_config
from systemml_tpu_torch.utils.config import DMLConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = [("csv", ".csv"), ("text", ".ijv"), ("mm", ".mtx"),
           ("binary", ".npy"), ("binary_block", ".bb")]


@pytest.fixture
def port_cpu():
    old = port_config.get_config()
    port_config.set_config(DMLConfig(device="cpu"))
    yield
    port_config.set_config(old)


def _arr(seed=0, shape=(7, 5)):
    a = np.random.default_rng(seed).normal(size=shape)
    a[a < 0] = 0
    return a


def _sprand(seed, m, n, d):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    a[rng.random((m, n)) > d] = 0.0
    return a


@pytest.mark.parametrize("fmt,ext", FORMATS)
def test_port_writes_jax_reads(tmp_path, port_cpu, fmt, ext):
    arr = _arr(1)
    p = str(tmp_path / f"m{ext}")
    matrixio.write_matrix(MatrixObject(torch.from_numpy(arr)), p, fmt)
    back = jax_io.read_matrix(p).to_numpy()
    np.testing.assert_array_equal(np.asarray(back), arr)
    assert matrixio.read_metadata(p) == jax_io.read_metadata(p)
    meta = matrixio.read_metadata(p)
    assert (meta["rows"], meta["cols"], meta["nnz"]) == (
        7, 5, int(np.count_nonzero(arr)))


@pytest.mark.parametrize("fmt,ext", FORMATS)
def test_jax_writes_port_reads(tmp_path, port_cpu, fmt, ext):
    arr = _arr(2)
    p = str(tmp_path / f"m{ext}")
    jax_io.write_matrix(JaxMatrix(arr), p, fmt)
    back = matrixio.read_matrix(p).to_numpy()
    np.testing.assert_array_equal(back, arr)


@pytest.mark.parametrize("fmt", ["text", "mm", "binary_block"])
def test_sparse_roundtrip_stays_sparse(tmp_path, port_cpu, fmt):
    """test_sparse.py's io cases: a sparse matrix written from CSR reads
    back sparse below the turn point, in both packages."""
    a = _sprand(3, 30, 20, 0.08)
    p = str(tmp_path / ("m.mtx" if fmt == "mm" else "m.dat"))
    matrixio.write_matrix(MatrixObject(SparseMatrix.from_dense(
        torch.from_numpy(a))), p, fmt=fmt)
    back = matrixio.read_matrix(p, fmt=fmt, rows=30, cols=20)
    assert back.is_sparse()
    np.testing.assert_array_equal(back.to_numpy(), a)
    jback = jax_io.read_matrix(p, fmt=fmt, rows=30, cols=20)
    assert jback.is_sparse()
    np.testing.assert_array_equal(np.asarray(jback.to_numpy()), a)


def test_jax_sparse_binary_block_reads_in_port(tmp_path, port_cpu):
    a = _sprand(4, 40, 30, 0.05)
    p = str(tmp_path / "m.bb")
    jax_io.write_matrix(JaxMatrix(JaxSparse.from_dense(a)), p,
                        "binary_block")
    back = matrixio.read_matrix(p)
    assert back.is_sparse()
    np.testing.assert_array_equal(back.to_numpy(), a)


def test_csv_header_and_sep(tmp_path, port_cpu):
    arr = np.random.default_rng(5).normal(size=(3, 2))
    p = str(tmp_path / "m.csv")
    matrixio.write_matrix(MatrixObject(torch.from_numpy(arr)), p, "csv",
                          sep=";")
    m2 = matrixio.read_matrix(p, fmt="csv", sep=";")
    np.testing.assert_array_equal(m2.to_numpy(), arr)
    with open(p) as f:
        body = f.read()
    hp = str(tmp_path / "h.csv")
    with open(hp, "w") as f:
        f.write("a;b\n" + body)
    got = matrixio.read_matrix(hp, fmt="csv", sep=";", header=True)
    want = jax_io.read_matrix(hp, fmt="csv", sep=";", header=True)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.to_numpy()))


def test_textcell_with_dims_from_mtd(tmp_path, port_cpu):
    p = str(tmp_path / "m.ijv")
    with open(p, "w") as f:
        f.write("1 1 5.0\n3 2 7.0\n")
    matrixio.write_metadata(p, {"format": "text", "rows": 4, "cols": 3})
    m = matrixio.read_matrix(p)
    assert (m.num_rows, m.num_cols) == (4, 3)
    assert float(m.to_numpy()[2, 1]) == 7.0


@pytest.mark.parametrize("shape,bs,dtype", [
    ((2_500, 37), 1024, np.float64), ((1_100, 2_100), 1024, np.float32),
    ((5, 3), 0, np.float64), ((3_000, 1), 1024, np.float32)])
def test_native_binary_block_equals_python(tmp_path, monkeypatch, shape, bs,
                                           dtype):
    """The native tiled writer and the pure-Python one give the same
    bytes; each reads the other's file; the JAX package's reader too."""
    arr = np.random.default_rng(6).standard_normal(shape).astype(dtype)
    pn, pp = str(tmp_path / "n.bb"), str(tmp_path / "p.bb")
    binaryblock.ARM_COUNTS.clear()
    binaryblock.write(pn, arr, bs)
    monkeypatch.setenv("SMTPU_NATIVE", "0")
    binaryblock.write(pp, arr, bs)
    with open(pn, "rb") as f1, open(pp, "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(binaryblock.read(pn), arr)
    monkeypatch.setenv("SMTPU_NATIVE", "1")
    np.testing.assert_array_equal(binaryblock.read(pp), arr)
    np.testing.assert_array_equal(jax_bb.read(pn), arr)
    assert binaryblock.ARM_COUNTS == {("write", "native"): 1,
                                      ("write", "python"): 1,
                                      ("read", "python"): 1,
                                      ("read", "native"): 1}


def test_native_csr_binary_block_equals_python(tmp_path, monkeypatch,
                                               port_cpu):
    a = _sprand(7, 300, 40, 0.03)
    sm = SparseMatrix.from_dense(torch.from_numpy(a))
    pn, pp = str(tmp_path / "n.bb"), str(tmp_path / "p.bb")
    binaryblock.write(pn, sm)
    monkeypatch.setenv("SMTPU_NATIVE", "0")
    binaryblock.write(pp, sm)
    with open(pn, "rb") as f1, open(pp, "rb") as f2:
        assert f1.read() == f2.read()
    ip, ix, d, shape = binaryblock.read(pn)
    got = scipy.sparse.csr_matrix((d, ix, ip), shape=shape).toarray()
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("fmt", ["csv", "text"])
def test_native_text_parsers_equal_python(tmp_path, monkeypatch, port_cpu,
                                          fmt):
    arr = _sprand(8, 60, 9, 0.5)
    p = str(tmp_path / "m.dat")
    matrixio.write_matrix(MatrixObject(torch.from_numpy(arr)), p, fmt)
    binaryblock.ARM_COUNTS.clear()
    native = matrixio.read_matrix(p, fmt=fmt).to_numpy()
    monkeypatch.setenv("SMTPU_NATIVE", "0")
    plain = matrixio.read_matrix(p, fmt=fmt).to_numpy()
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(native, arr)
    assert binaryblock.ARM_COUNTS == {("read", "native"): 1,
                                      ("read", "python"): 1}


def test_read_tensor_lands_in_the_value_dtype(tmp_path, port_cpu):
    arr = np.random.default_rng(9).standard_normal((50, 4)).astype(np.float32)
    p = str(tmp_path / "x.bb")
    binaryblock.write(p, arr)
    t = binaryblock.read_tensor(p, "cpu", torch.float64)
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(t.numpy(), arr.astype(np.float64))


def _run(ctx, script, out=(), inputs=None):
    for k, v in (inputs or {}).items():
        script.input(k, v)
    if out:
        script.output(*out)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = ctx.execute(script)
    return res, buf.getvalue()


def _jax_ctx():
    cfg = JaxConfig()
    cfg.pallas_mode = "never"
    cfg.exec_mode = "SINGLE_NODE"
    return JaxMLContext(cfg)


@pytest.mark.parametrize("fmt", ["csv", "text", "binary", "binary_block"])
def test_read_write_builtins_match_jax(tmp_path, fmt):
    """write() in DML, then read() back, in each package; each package
    reads the other's file."""
    x = np.random.default_rng(10).standard_normal((20, 6))
    pp, pj = str(tmp_path / "p.dat"), str(tmp_path / "j.dat")
    src = 'write(X * 2, $F, format="{}")'.format(fmt)
    _run(MLContext(DMLConfig(device="cpu")), dml(src).arg("F", pp),
         inputs={"X": x})
    _run(_jax_ctx(), jax_dml(src).arg("F", pj), inputs={"X": x})
    rd = "Y = read($F); s = sum(Y)"
    rp, _ = _run(MLContext(DMLConfig(device="cpu")), dml(rd).arg("F", pj),
                 out=("Y", "s"))
    rj, _ = _run(_jax_ctx(), jax_dml(rd).arg("F", pp), out=("Y", "s"))
    np.testing.assert_allclose(rp.get_matrix("Y"), 2 * x, rtol=1e-15)
    np.testing.assert_allclose(np.asarray(rj.get_matrix("Y")), 2 * x,
                               rtol=1e-15)
    np.testing.assert_allclose(float(rp.get_scalar("s")),
                               float(np.asarray(rj.get("s"))), rtol=1e-9)


def test_write_scalar_and_read_scalar(tmp_path):
    p = str(tmp_path / "s.txt")
    src = "write(7 / 2, $F)"
    _run(MLContext(DMLConfig(device="cpu")), dml(src).arg("F", p))
    with open(p) as f:
        port_text = f.read()
    _run(_jax_ctx(), jax_dml(src).arg("F", p))
    with open(p) as f:
        assert f.read() == port_text == "3.5\n"
    rp, _ = _run(MLContext(DMLConfig(device="cpu")),
                 dml('v = read($F, data_type="scalar")').arg("F", p),
                 out=("v",))
    assert rp.get("v") == 3.5


def test_checkpoint_restore_roundtrip_with_jax(tmp_path):
    """A snapshot the port writes restores in the JAX package and the
    other way round (the same pointer-file protocol)."""
    x = np.random.default_rng(11).standard_normal((8, 3))
    save = ('i = 3; W = X * 2; name = "w"; checkpoint($C)\n'
            'e = checkpointExists($C)')
    load = ('if (checkpointExists($C)) {\n  restore($C)\n} else {\n'
            '  W = matrix(0, rows=1, cols=1); i = 0; name = ""\n}\n'
            't = sum(W) + i\nprint(name)')
    cp, cj = str(tmp_path / "p.ckpt"), str(tmp_path / "j.ckpt")
    rp, _ = _run(MLContext(DMLConfig(device="cpu")),
                 dml(save).arg("C", cp), out=("e",), inputs={"X": x})
    _run(_jax_ctx(), jax_dml(save).arg("C", cj), inputs={"X": x})
    assert rp.get("e") is True
    rp, tp = _run(MLContext(DMLConfig(device="cpu")),
                  dml(load).arg("C", cj), out=("t",))
    rj, tj = _run(_jax_ctx(), jax_dml(load).arg("C", cp), out=("t",))
    want = 2 * x.sum() + 3
    np.testing.assert_allclose(float(rp.get_scalar("t")), want, rtol=1e-12)
    np.testing.assert_allclose(float(np.asarray(rj.get("t"))), want,
                               rtol=1e-12)
    assert tp == tj == "w\n"


def test_checkpoint_exists_false(tmp_path):
    rp, _ = _run(MLContext(DMLConfig(device="cpu")),
                 dml("e = checkpointExists($C)").arg(
                     "C", str(tmp_path / "none")), out=("e",))
    assert rp.get("e") is False


@pytest.mark.parametrize("fmt", ["csv", "binary_block"])
def test_linregcg_file_io_roundtrip(tmp_path, fmt):
    """test_algorithms.py::TestLinearRegCG::test_file_io_roundtrip through
    both packages: X and y from files, beta written, read back; each
    package's beta within 1e-9 of the other's."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((50, 4))
    y = x @ rng.standard_normal((4, 1))
    ext = ".csv" if fmt == "csv" else ".bb"
    jax_io.write_matrix(JaxMatrix(x), str(tmp_path / f"X{ext}"), fmt)
    jax_io.write_matrix(JaxMatrix(y), str(tmp_path / "y.csv"), "csv")
    src = os.path.join(ROOT, "scripts", "algorithms", "LinearRegCG.dml")
    from systemml_tpu.api.mlcontext import dmlFromFile as jax_file
    from systemml_tpu_torch.api.mlcontext import dmlFromFile

    betas = []
    for ctx, mk, tag in ((MLContext(DMLConfig(device="cpu")), dmlFromFile,
                          "p"), (_jax_ctx(), jax_file, "j")):
        s = mk(src)
        for k, v in {"X": str(tmp_path / f"X{ext}"),
                     "Y": str(tmp_path / "y.csv"),
                     "B": str(tmp_path / f"beta_{tag}.csv"),
                     "maxi": 50}.items():
            s.arg(k, v)
        _run(ctx, s)
        betas.append(jax_io.read_matrix(
            str(tmp_path / f"beta_{tag}.csv")).to_numpy())
    bp, bj = (np.asarray(b) for b in betas)
    assert bp.shape == (4, 1)
    np.testing.assert_allclose(x @ bp, y, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bp, bj, rtol=1e-9, atol=1e-12)


def test_frames_wait(tmp_path, port_cpu):
    """Frame IO came with the parfor, transform and frames slice: a frame
    the port writes as csv with a header reads back in the JAX package,
    and the other way round, with the same columns, schema and names."""
    from systemml_tpu.lang.ast import ValueType as JaxVT
    from systemml_tpu.runtime.data import FrameObject as JaxFrame
    from systemml_tpu_torch.lang.ast import ValueType
    from systemml_tpu_torch.runtime.data import FrameObject

    cols = [np.array(["a", "b,c", "d"], dtype=object),
            np.array([1.5, -2.0, 3.0])]
    fr = FrameObject([c.copy() for c in cols],
                     [ValueType.STRING, ValueType.DOUBLE], ["s", "v"])
    jf = JaxFrame([c.copy() for c in cols], [JaxVT.STRING, JaxVT.DOUBLE],
                  ["s", "v"])
    matrixio.write_frame(fr, str(tmp_path / "p.csv"), ",", True, "csv")
    jax_io.write_frame(jf, str(tmp_path / "j.csv"), ",", True, "csv")
    for got in (jax_io.read_frame(str(tmp_path / "p.csv")),
                matrixio.read_frame(str(tmp_path / "j.csv"))):
        assert [list(c) for c in got.columns] == [list(c) for c in cols]
        assert [t.name for t in got.schema] == ["STRING", "DOUBLE"]
        assert list(got.colnames) == ["s", "v"]
