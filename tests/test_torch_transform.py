"""Transform through the port on the CPU, held to the JAX package.

- tests/test_transform.py's encoder cases (recode, dummycode, bin,
  impute, omit, the encode/decode round trip) through the port's
  runtime/transform.py and the JAX package's on the same frames: equal
  matrices and meta frames (the recode-map cells with the `·` separator);
- tests/test_transform_consistency.py's fuzzed frames and specs
  (parametrised over its seeds): encode, apply and decode equal to the
  JAX package's, apply equal to encode, decode restoring the columns;
- the transform* builtins in DML through the port's JMLC and MLContext
  against the JAX package's, the encoded matrix on the configured device;
- scripts/algorithms/transform.dml, then apply-transform.dml, through
  `python -m systemml_tpu_torch` (api/cli.main) and the JAX package's
  CLI over one csv frame with a header: X, the meta frame and apply's X
  equal.
"""

import json
import os

import numpy as np
import pytest

from systemml_tpu.lang.ast import ValueType as JaxVT
from systemml_tpu.runtime.data import FrameObject as JaxFrame
from systemml_tpu.runtime.transform import TransformDecoder as JaxDecoder
from systemml_tpu.runtime.transform import TransformEncoder as JaxEncoder
from systemml_tpu_torch.lang.ast import ValueType
from systemml_tpu_torch.runtime.data import FrameObject
from systemml_tpu_torch.runtime.transform import (TransformDecoder,
                                                  TransformEncoder)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALG = os.path.join(ROOT, "scripts", "algorithms")


def _both(cols, schema, names):
    return (FrameObject([c.copy() for c in cols],
                        [ValueType[s] for s in schema], list(names)),
            JaxFrame([c.copy() for c in cols], [JaxVT[s] for s in schema],
                     list(names)))


def _frame():
    return _both([np.array(["a", "b", "a", "c", "b", "a"], dtype=object),
                  np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
                  np.array([10.0, 20.0, 10.0, 30.0, 20.0, 10.0])],
                 ["STRING", "DOUBLE", "DOUBLE"], ["cat", "num", "grp"])


def _cols(fr):
    return [list(c) for c in fr.columns]


def _encode_both(spec, frames):
    p, j = frames
    ep, ej = TransformEncoder(spec, p.colnames), JaxEncoder(spec, j.colnames)
    (xp, mp), (xj, mj) = ep.encode(p), ej.encode(j)
    np.testing.assert_array_equal(np.asarray(xp), np.asarray(xj))
    assert _cols(mp) == _cols(mj) and list(mp.colnames) == list(mj.colnames)
    return ep, ej, xp, mp, mj


@pytest.mark.parametrize("spec", [
    {"recode": ["cat"]},
    {"dummycode": [1]},
    {"bin": [{"id": 2, "method": "equi-width", "numbins": 5}]},
    {"recode": ["cat"], "dummycode": ["grp"]},
])
def test_encoders_as_jax(spec):
    fr = _frame()
    ep, ej, xp, mp, mj = _encode_both(spec, fr)
    np.testing.assert_array_equal(ep.apply(fr[0]), ej.apply(fr[1]))
    cm = ep.colmap() if "dummycode" in spec else None
    if cm is not None:
        np.testing.assert_array_equal(cm, ej.colmap())
    # apply through an encoder loaded from the meta frame
    e2 = TransformEncoder(spec, fr[0].colnames)
    e2.load_meta(mp)
    np.testing.assert_array_equal(e2.apply(fr[0]), xp)


def test_recode_meta_cells():
    _, _, xp, mp, _ = _encode_both({"recode": ["cat"]}, _frame())
    np.testing.assert_allclose(xp[:, 0], [1, 2, 1, 3, 2, 1])
    assert "a·1" in list(mp.columns[0])


def test_impute_mean_and_mode():
    fr = _both([np.array([1.0, np.nan, 3.0, np.nan]),
                np.array(["x", "", "x", "y"], dtype=object)],
               ["DOUBLE", "STRING"], ["v", "s"])
    spec = {"impute": [{"id": 1, "method": "global_mean"},
                       {"id": 2, "method": "global_mode"}],
            "recode": [2]}
    _, _, x, _, _ = _encode_both(spec, fr)
    np.testing.assert_allclose(x[:, 0], [1, 2, 3, 2])
    assert x[1, 1] == x[0, 1]


def test_omit():
    fr = _both([np.array([1.0, np.nan, 3.0]), np.array([4.0, 5.0, 6.0])],
               ["DOUBLE", "DOUBLE"], ["a", "b"])
    _, _, x, _, _ = _encode_both({"omit": [1]}, fr)
    assert x.shape == (2, 2)


def test_encode_decode_roundtrip_as_jax():
    spec = {"recode": ["cat"], "dummycode": ["grp"]}
    fr = _frame()
    _, _, x, mp, mj = _encode_both(spec, fr)
    dp = TransformDecoder(spec, fr[0].colnames, mp).decode(x)
    dj = JaxDecoder(spec, fr[1].colnames, mj).decode(x)
    assert _cols(dp) == _cols(dj)
    assert list(dp.columns[0]) == list(fr[0].columns[0])


# --------------------------------------------------------------------------
# tests/test_transform_consistency.py
# --------------------------------------------------------------------------

_CATS = np.array(["red", "green", "blue", "teal", "pink"], dtype=object)


def _random_frame(rng, rows):
    cols, schema, names = [], [], []
    order = rng.permutation(4)
    for j in order:
        if j < 2:
            cols.append(rng.choice(_CATS[: int(rng.integers(2, 6))],
                                   size=rows).astype(object))
            schema.append("STRING")
            names.append(f"c{j}")
        else:
            cols.append(rng.standard_normal(rows) * 10)
            schema.append("DOUBLE")
            names.append(f"n{j}")
    return _both(cols, schema, names)


def _random_spec(rng, fr):
    cats = [n for n, s in zip(fr.colnames, fr.schema)
            if s == ValueType.STRING]
    nums = [n for n in fr.colnames if n not in cats]
    spec = {}
    kind = rng.choice(["recode", "dummycode", "mixed"])
    if kind == "recode":
        spec["recode"] = cats
    elif kind == "dummycode":
        spec["dummycode"] = cats
    else:
        spec["recode"] = cats[:1]
        spec["dummycode"] = cats[1:]
    if rng.random() < 0.5:
        spec["bin"] = [{"id": nums[0], "method": "equi-width",
                        "numbins": int(rng.integers(2, 6))}]
    return spec


@pytest.mark.parametrize("seed", range(15))
def test_encode_apply_decode_consistency(seed):
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(8, 40))
    fr = _random_frame(rng, rows)
    spec = _random_spec(rng, fr[0])
    ep, ej, x, mp, mj = _encode_both(spec, fr)
    assert x.shape[0] == rows and np.isfinite(np.asarray(x, float)).all()
    np.testing.assert_array_equal(ep.apply(fr[0]), x)
    dp = TransformDecoder(spec, fr[0].colnames, mp).decode(np.asarray(x))
    dj = JaxDecoder(spec, fr[1].colnames, mj).decode(np.asarray(x))
    assert _cols(dp) == _cols(dj)
    binned = {b["id"] for b in spec.get("bin", [])}
    for name, col, col2 in zip(fr[0].colnames, fr[0].columns, dp.columns):
        if name in binned:
            continue
        if col.dtype == object:
            assert list(col2) == list(col)
        else:
            np.testing.assert_allclose(np.asarray(col2, float), col,
                                       rtol=1e-12)


@pytest.mark.parametrize("seed", range(5))
def test_apply_on_unseen_frame_as_jax(seed):
    rng = np.random.default_rng(100 + seed)
    fit_p, fit_j = _random_frame(rng, 30)
    spec = {"recode": [n for n, s in zip(fit_p.colnames, fit_p.schema)
                       if s == ValueType.STRING]}
    ep, ej, _, mp, mj = _encode_both(spec, (fit_p, fit_j))
    cols, schema = [], []
    for n, s in zip(fit_p.colnames, fit_p.schema):
        src = fit_p.columns[fit_p.colnames.index(n)]
        if s == ValueType.STRING:
            seen = np.array(sorted(set(src)), dtype=object)
            cols.append(rng.choice(seen, size=12).astype(object))
            schema.append("STRING")
        else:
            cols.append(rng.standard_normal(12) * 10)
            schema.append("DOUBLE")
    new_p, new_j = _both(cols, schema, fit_p.colnames)
    a = ep.apply(new_p)
    np.testing.assert_array_equal(a, ej.apply(new_j))
    e2 = TransformEncoder(spec, fit_p.colnames)
    e2.load_meta(mp)
    np.testing.assert_array_equal(e2.apply(new_p), a)


# --------------------------------------------------------------------------
# the builtins in DML, and the two scripts
# --------------------------------------------------------------------------

def _people(tmp_path):
    csv = tmp_path / "people.csv"
    csv.write_text("city,age\nSJ,30\nSF,40\nSJ,50\nNY,20\n")
    (tmp_path / "people.csv.mtd").write_text(json.dumps(
        {"data_type": "frame", "format": "csv", "header": True}))
    spec = json.dumps({"recode": ["city"]})
    return f'''
F = read("{csv}", data_type="frame", format="csv", header=TRUE)
jspec = "{spec.replace(chr(34), chr(92) + chr(34))}"
[X, M] = transformencode(target=F, spec=jspec)
means = colMeans(X)
X2 = transformapply(target=F, spec=jspec, meta=M)
d = sum(abs(X - X2))
F2 = transformdecode(target=X, spec=jspec, meta=M)
C = transformcolmap(target=M, spec=jspec)
'''


def test_transform_builtins_through_jmlc_as_jax(tmp_path):
    from systemml_tpu.api.jmlc import Connection as JaxConnection
    from systemml_tpu_torch.api.jmlc import Connection

    script = _people(tmp_path)
    outs = ["X", "means", "d", "F2", "C"]
    rp = Connection(device="cpu").prepare_script(
        script, input_names=[], output_names=outs).execute_script()
    rj = JaxConnection().prepare_script(
        script, input_names=[], output_names=outs).execute_script()
    x = rp.get("X")
    assert x.device.type == "cpu" and x.shape == (4, 2)
    for o in ("X", "means", "C"):
        np.testing.assert_array_equal(np.asarray(rp.get(o)),
                                      np.asarray(rj.get(o)))
    assert float(rp.get("d")) == 0.0
    assert list(rp.get("F2").columns[0]) == ["SJ", "SF", "SJ", "NY"]
    assert _cols(rp.get("F2")) == _cols(rj.get("F2"))


def _census_like(tmp_path, rows=120, cols=6, seed=3):
    rng = np.random.default_rng(seed)
    names = [f"c{j}" for j in range(cols)]
    data = [[f"v{int(rng.integers(1, 3 + j))}" for j in range(cols)]
            for _ in range(rows)]
    path = tmp_path / "data.csv"
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for r in data:
            f.write(",".join(r) + "\n")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"recode": names,
                                "dummycode": names[:2]}))
    return str(path), str(spec)


def test_transform_scripts_through_the_cli_as_jax(tmp_path):
    """transform.dml then apply-transform.dml by each package's CLI over
    one csv frame with a header: the encoded X, the meta frame and
    apply's X equal."""
    from systemml_tpu.api import cli as jax_cli
    from systemml_tpu.io import matrixio as jax_io
    from systemml_tpu_torch.api import cli

    data, spec = _census_like(tmp_path)
    cfg = tmp_path / "cpu.json"
    cfg.write_text(json.dumps({"device": "cpu"}))
    got = {}
    for tag, main, extra in (("port", cli.main, ["-config", str(cfg)]),
                             ("jax", jax_cli.main, [])):
        out = tmp_path / tag
        os.makedirs(out)
        main(["-f", os.path.join(ALG, "transform.dml"), "-nvargs",
              f"DATA={data}", f"TFSPEC={spec}", f"OUTPUT={out}/X.csv",
              f"TFMTD={out}/meta"] + extra)
        main(["-f", os.path.join(ALG, "apply-transform.dml"), "-nvargs",
              f"DATA={data}", f"TFSPEC={spec}", f"TFMTD={out}/meta",
              f"OUTPUT={out}/Xa.csv"] + extra)
        got[tag] = (jax_io.read_matrix(f"{out}/X.csv").to_numpy(),
                    jax_io.read_matrix(f"{out}/Xa.csv").to_numpy(),
                    _cols(jax_io.read_frame(f"{out}/meta/tfmtd")))
    xp, xap, mp = got["port"]
    xj, xaj, mj = got["jax"]
    # four recoded columns and 2 + 3 dummy columns
    assert xp.shape == (120, 4 + 2 + 3)
    np.testing.assert_array_equal(xp, xap)
    np.testing.assert_array_equal(xp, xj)
    np.testing.assert_array_equal(xap, xaj)
    assert mp == mj


def test_transform_scripts_through_mlcontext_as_jax(tmp_path):
    """The same two scripts through each package's MLContext, X and the
    meta frame M as outputs; apply-transform reads the meta frame that
    transform.dml wrote."""
    from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
    from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
    from systemml_tpu.utils.config import DMLConfig as JaxConfig
    from systemml_tpu_torch.api.mlcontext import MLContext, dmlFromFile
    from systemml_tpu_torch.utils.config import DMLConfig

    data, spec = _census_like(tmp_path, rows=50, cols=4, seed=5)
    got = []
    for ctx, ctor in ((MLContext(DMLConfig(device="cpu")), dmlFromFile),
                      (JaxMLContext(JaxConfig()), jax_dml_file)):
        meta = tmp_path / f"meta{len(got)}"
        enc = ctx.execute(ctor(os.path.join(ALG, "transform.dml"))
                          .arg("DATA", data).arg("TFSPEC", spec)
                          .arg("TFMTD", str(meta)).output("X", "M"))
        app = ctx.execute(ctor(os.path.join(ALG, "apply-transform.dml"))
                          .arg("DATA", data).arg("TFSPEC", spec)
                          .arg("TFMTD", str(meta)).output("X"))
        got.append((np.asarray(enc.get_matrix("X")),
                    _cols(enc.get("M")),
                    np.asarray(app.get_matrix("X"))))
    (xp, mp, ap), (xj, mj, aj) = got
    np.testing.assert_array_equal(xp, xj)
    np.testing.assert_array_equal(ap, aj)
    np.testing.assert_array_equal(xp, ap)
    assert mp == mj
