"""Frames through the port on the CPU, held to the JAX package.

tests/test_frame_ops.py's cases (right and left indexing, cbind, rbind,
nrow/ncol, map with a lambda and a UDF, the schema and mixing errors),
each run through the port's MLContext(device="cpu") and the JAX package's
on the same frames, with the same results (frames are host columns in
both); frame IO (csv with and without a header, text cell, the npz
container) written by the port and read by both, and the other way
round; frames bound through JMLC; as.matrix of a numeric frame.
"""

import numpy as np
import pytest

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.io import matrixio as jax_io
from systemml_tpu.lang.ast import ValueType as JaxVT
from systemml_tpu.runtime.data import FrameObject as JaxFrame
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.io import matrixio
from systemml_tpu_torch.lang.ast import ValueType
from systemml_tpu_torch.runtime.data import FrameObject
from systemml_tpu_torch.utils.config import DMLConfig


def _cols():
    return ([np.array(["a", "b", "c", "d"], dtype=object),
             np.array([1.0, 2.0, 3.0, 4.0]),
             np.array(["x", "y", "z", "w"], dtype=object)],
            ["STRING", "DOUBLE", "STRING"], ["s1", "v", "s2"])


def _frames(cols=None, schema=None, names=None):
    """The same frame in both packages."""
    if cols is None:
        cols, schema, names = _cols()
    port = FrameObject([c.copy() for c in cols],
                       [ValueType[s] for s in schema], names)
    ref = JaxFrame([c.copy() for c in cols], [JaxVT[s] for s in schema],
                   names)
    return port, ref


def _run(src, inputs, outputs):
    """{output: value} through each package: frames as (columns, schema
    names, colnames), matrices as numpy arrays, scalars as floats."""
    out = []
    for port in (True, False):
        if port:
            ml, s = MLContext(DMLConfig(device="cpu")), dml(src)
        else:
            cfg = JaxConfig()
            cfg.exec_mode = "SINGLE_NODE"
            ml, s = JaxMLContext(cfg), jax_dml(src)
        for k, v in inputs.items():
            s.input(k, v[0] if port and isinstance(v, tuple) else
                    v[1] if isinstance(v, tuple) else v)
        res = ml.execute(s.output(*outputs))
        got = {}
        for o in outputs:
            v = res.get(o)
            if hasattr(v, "columns"):
                got[o] = ([list(c) for c in v.columns],
                          [t.name for t in v.schema], list(v.colnames))
            elif hasattr(v, "shape") and len(v.shape) == 2:
                got[o] = np.asarray(res.get_matrix(o))
            else:
                got[o] = float(res.get_scalar(o))
        out.append(got)
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_right_index_slice():
    p, j = _run("G = F[2:3, 1:2]\n", {"F": _frames()}, ["G"])
    _same(p, j)
    cols, schema, names = p["G"]
    assert cols[0] == ["b", "c"] and cols[1] == [2.0, 3.0]
    assert schema == ["STRING", "DOUBLE"] and names == ["s1", "v"]


def test_left_index():
    patch = _frames([np.array(["B", "C"], dtype=object)], ["STRING"], ["s1"])
    p, j = _run("F[2:3, 1:1] = G\nout = F\n",
                {"F": _frames(), "G": patch}, ["out"])
    _same(p, j)
    assert p["out"][0][0] == ["a", "B", "C", "d"]
    assert p["out"][0][1] == [1.0, 2.0, 3.0, 4.0]


@pytest.mark.parametrize("src,patch,match", [
    ("F[2:3, 1:1] = G\nout = F\n",
     ([np.array(["B"], dtype=object)], ["STRING"], ["s1"]), "mismatch"),
    ("F[2:3, 1:1] = G\nout = F\n",
     ([np.array([9.0, 8.0])], ["DOUBLE"], ["v"]), "schema"),
    ("out = rbind(F, G)\n",
     ([np.array([1.0, 2.0, 3.0, 4.0]), np.array([1.0, 2.0, 3.0, 4.0]),
       np.array(["x", "y", "z", "w"], dtype=object)],
      ["DOUBLE", "DOUBLE", "STRING"], None), "schema"),
])
def test_frame_errors_as_jax(src, patch, match):
    for port in (True, False):
        f, g = _frames(), _frames(*patch)
        if port:
            ml, s = MLContext(DMLConfig(device="cpu")), dml(src)
            s.input("F", f[0]).input("G", g[0])
        else:
            ml, s = JaxMLContext(JaxConfig()), jax_dml(src)
            s.input("F", f[1]).input("G", g[1])
        with pytest.raises(Exception, match=match):
            ml.execute(s.output("out"))


def test_mixed_frame_matrix_cbind_is_loud():
    with pytest.raises(Exception, match="cannot mix frame and matrix"):
        MLContext(DMLConfig(device="cpu")).execute(
            dml("out = cbind(F, X)\n").input("F", _frames()[0])
            .input("X", np.ones((4, 1))).output("out"))


def test_cbind_rbind_nrow_ncol():
    f2 = _frames([np.array([10.0, 20.0, 30.0, 40.0])], ["DOUBLE"], ["v2"])
    p, j = _run("out = cbind(F, G)\nr = rbind(F, F)\na = nrow(F)\n"
                "b = ncol(F)\n", {"F": _frames(), "G": f2},
                ["out", "r", "a", "b"])
    _same(p, j)
    assert p["out"][2][-1] == "v2" and len(p["r"][0][0]) == 8
    assert (p["a"], p["b"]) == (4.0, 3.0)


def test_map_lambda_and_udf():
    from systemml_tpu.api.udf import register_udf as jax_register
    from systemml_tpu.api.udf import unregister_udf as jax_unregister
    from systemml_tpu_torch.api.udf import register_udf, unregister_udf

    register_udf("shout", lambda v: str(v).upper())
    jax_register("shout", lambda v: str(v).upper())
    try:
        p, j = _run('out = map(F, "x -> str(x) + \\"!\\"")\n'
                    'up = map(F, "shout")\nn = map(F, "x -> len(str(x))")\n',
                    {"F": _frames()}, ["out", "up", "n"])
    finally:
        unregister_udf("shout")
        jax_unregister("shout")
    _same(p, j)
    assert p["out"][0][0] == ["a!", "b!", "c!", "d!"]
    assert p["up"][0][0] == ["A", "B", "C", "D"]
    assert all(isinstance(v, str) for v in p["n"][0][0])


def test_map_bad_spec_is_loud():
    with pytest.raises(Exception, match="map"):
        MLContext(DMLConfig(device="cpu")).execute(
            dml('out = map(F, "nosuchthing")\n').input("F", _frames()[0])
            .output("out"))


def test_as_matrix_of_a_numeric_frame():
    f, _ = _frames([np.array([1.0, 2.0]), np.array(["3", "4.5"],
                                                   dtype=object)],
                   ["DOUBLE", "STRING"], ["a", "b"])
    res = MLContext(DMLConfig(device="cpu")).execute(
        dml("X = as.matrix(F)\ns = sum(X)\n").input("F", f).output("X", "s"))
    np.testing.assert_array_equal(res.get_matrix("X"), [[1, 3], [2, 4.5]])
    assert res.get_scalar("s") == 10.5


# --------------------------------------------------------------------------
# frame IO, held to the JAX package's readers and writers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,header", [("csv", True), ("csv", False),
                                        ("text", False), ("binary", False)])
def test_frame_io_round_trip_as_jax(tmp_path, fmt, header):
    port, ref = _frames()
    for writer, reader in ((matrixio.write_frame, jax_io.read_frame),
                           (jax_io.write_frame, matrixio.read_frame)):
        path = str(tmp_path / f"f-{fmt}-{writer.__module__}.dat")
        writer(port if writer is matrixio.write_frame else ref, path,
               ",", header, fmt)
        a = matrixio.read_frame(path)
        b = jax_io.read_frame(path)
        c = reader(path)
        for x in (a, b, c):
            assert [list(col) for col in x.columns] == \
                [list(col) for col in a.columns]
            assert [s.name for s in x.schema] == [s.name for s in a.schema]
            assert list(x.colnames) == list(a.colnames)
        assert [list(col) for col in a.columns] == \
            [list(col) for col in port.columns]


def test_read_and_write_frame_in_dml(tmp_path):
    port, _ = _frames()
    src = tmp_path / "in.csv"
    matrixio.write_frame(port, str(src), ",", True, "csv")
    out = tmp_path / "out.csv"
    MLContext(DMLConfig(device="cpu")).execute(dml(
        f'F = read("{src}", data_type="frame", format="csv", header=TRUE)\n'
        f'G = F[1:2, ]\nwrite(G, "{out}", format="csv")\n'))
    g = jax_io.read_frame(str(out))
    assert [list(c) for c in g.columns] == [["a", "b"], [1.0, 2.0],
                                            ["x", "y"]]


def test_frames_through_jmlc():
    from systemml_tpu_torch.api.jmlc import Connection

    ps = Connection(device="cpu").prepare_script(
        "G = rbind(F, F)\nn = nrow(G)\n", input_names=["F"],
        output_names=["G", "n"])
    res = ps.execute({"F": _frames()[0]})
    assert int(res.get("n")) == 8
    assert list(res.get("G").columns[0]) == ["a", "b", "c", "d"] * 2
