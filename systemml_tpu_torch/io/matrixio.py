"""Matrix IO: csv, textcell (ijv), MatrixMarket, binary (.npy) and binary
block, with JSON .mtd metadata sidecars.

Port of systemml_tpu/io/matrixio.py, with jnp replaced by torch on the
configured device. A read of a cell format or of a CSR binary block lands
in a SparseMatrix below `sparsity_turn_point`, dense above it, as in the
JAX package. A dense binary block on the card reads into pinned host
memory and reaches the device in one copy (io/binaryblock.read_tensor);
a write from the card comes back in one copy. The csv and ijv parsers
are the native library's (native/__init__.py), the Python ones their
plain versions under SMTPU_NATIVE=0; every read counts its arm.

Frames (`read_frame`, `write_frame`: csv with and without a header, text
cell, and an npz container) are host columns, read and written as in the
JAX package (systemml_tpu/io/matrixio.py:203-299).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from systemml_tpu_torch.lang.ast import ValueType
from systemml_tpu_torch.runtime.data import FrameObject, MatrixObject
from systemml_tpu_torch.utils.config import default_dtype, get_config


def _device():
    return torch.device(get_config().device)


def read_metadata(path: str) -> dict:
    mtd = path + ".mtd"
    if os.path.exists(mtd):
        with open(mtd) as f:
            return json.load(f)
    return {}


def write_metadata(path: str, meta: dict):
    with open(path + ".mtd", "w") as f:
        json.dump(meta, f, indent=2)
        f.write("\n")


def _infer_format(path: str, meta: dict) -> str:
    if "format" in meta:
        return meta["format"]
    ext = os.path.splitext(path)[1].lower()
    return {".csv": "csv", ".mtx": "mm", ".npy": "binary", ".txt": "text",
            ".ijv": "text", ".bb": "binary_block"}.get(ext, "csv")


_BB_FORMATS = ("binary_block", "binaryblock", "bb")
_CELL_FORMATS = ("text", "textcell", "ijv")
_MM_FORMATS = ("mm", "matrixmarket", "mtx")


def read_matrix(path: str, fmt: Optional[str] = None,
                rows: Optional[int] = None, cols: Optional[int] = None,
                header: bool = False, sep: str = ",") -> MatrixObject:
    from systemml_tpu_torch.io import binaryblock
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    meta = read_metadata(path)
    fmt = fmt or _infer_format(path, meta)
    rows = rows or meta.get("rows")
    cols = cols or meta.get("cols")
    header = meta.get("header", header)
    sep = meta.get("sep", sep)
    dev = _device()
    dt = default_dtype(dev)
    if fmt == "binary":
        arr = np.load(path) if os.path.exists(path) else np.load(path + ".npy")
    elif fmt in _BB_FORMATS:
        got = binaryblock.read_tensor(path, dev, dt)
        if isinstance(got, tuple):  # CSR on disk stays sparse in memory
            ip, ix, d, shape = got
            return _sparse_or_dense(SparseMatrix(
                ip, ix, torch.from_numpy(d).to(dt).to(dev), shape), dt)
        return MatrixObject(got)
    elif fmt == "csv":
        arr = _read_csv_cells(path, sep, header)
    elif fmt in _CELL_FORMATS:
        # cell formats load straight into CSR and stay sparse below the
        # turn point (reference: ReaderTextCell -> sparse MatrixBlock)
        from systemml_tpu_torch import native

        if native.enabled():
            with open(path, "rb") as f:
                ri, ci, vals = native.parse_ijv(f.read())
            binaryblock.count_arm("read", "native")
        else:
            ijv = np.loadtxt(path, ndmin=2)
            ri = ijv[:, 0].astype(np.int64)
            ci = ijv[:, 1].astype(np.int64)
            vals = ijv[:, 2]
            binaryblock.count_arm("read", "python")
        r = int(rows or (ri.max() if len(ri) else 0))
        c = int(cols or (ci.max() if len(ci) else 0))
        sm = SparseMatrix.from_coo(
            torch.from_numpy(ri - 1).to(dev), torch.from_numpy(ci - 1).to(dev),
            torch.from_numpy(vals).to(dt).to(dev), (r, c))
        return _sparse_or_dense(sm, dt)
    elif fmt in _MM_FORMATS:
        from scipy.io import mmread

        m = mmread(path)
        if hasattr(m, "tocsr"):
            return _sparse_or_dense(SparseMatrix.from_scipy(
                m.tocsr(), device=dev, dtype=dt), dt)
        arr = np.asarray(m)
    else:
        raise ValueError(f"unknown matrix format {fmt!r}")
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return MatrixObject(torch.from_numpy(np.ascontiguousarray(arr)).to(
        dev).to(dt))


def _read_csv_cells(path: str, sep: str, header: bool) -> np.ndarray:
    """The native chunk-parallel parser (the ReaderTextCSVParallel analog);
    np.loadtxt is its plain version."""
    from systemml_tpu_torch import native
    from systemml_tpu_torch.io import binaryblock

    if not native.enabled():
        binaryblock.count_arm("read", "python")
        return np.loadtxt(path, delimiter=sep, skiprows=1 if header else 0,
                          ndmin=2)
    with open(path, "rb") as f:
        raw = f.read()
    body = raw
    if header:
        nl = raw.find(b"\n")
        body = raw[nl + 1:] if nl >= 0 else b""
    binaryblock.count_arm("read", "native")
    first = body.split(b"\n", 1)[0]
    if not first:
        return np.zeros((0, 0))
    return native.parse_csv(body, sep, first.count(sep.encode()) + 1)


def _sparse_or_dense(sm, dt) -> MatrixObject:
    """Format decision at read time (reference:
    MatrixBlock.evalSparseFormatInMemory, matrix/data/MatrixBlock.java:1001)."""
    if sm.sparsity() < get_config().sparsity_turn_point:
        return MatrixObject(sm)
    return MatrixObject(sm.to_dense().to(dt))


def write_matrix(m: MatrixObject, path: str, fmt: Optional[str] = None,
                 sep: str = ",", header: bool = False):
    fmt = fmt or _infer_format(path, {})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if fmt in _BB_FORMATS:
        from systemml_tpu_torch.io import binaryblock

        binaryblock.write(path, m.array)
        write_metadata(path, {"data_type": "matrix", "format": "binary_block",
                              "rows": m.num_rows, "cols": m.num_cols,
                              "nnz": m.nnz()})
        return
    if m.is_sparse() and fmt in _CELL_FORMATS + _MM_FORMATS:
        # written straight from CSR, never densified
        sm = m.array
        if fmt in _CELL_FORMATS:
            coo = sm.to_scipy().tocoo()
            with open(path, "w") as f:
                for i, j, v in zip(coo.row, coo.col, coo.data):
                    f.write(f"{i+1} {j+1} {v:.17g}\n")
        else:
            from scipy.io import mmwrite

            mmwrite(path, sm.to_scipy())
        write_metadata(path, {"data_type": "matrix", "format": fmt,
                              "rows": m.num_rows, "cols": m.num_cols,
                              "nnz": m.nnz()})
        return
    arr = m.to_numpy()
    if fmt == "binary":
        with open(path, "wb") as f:  # exactly `path` (np.save appends .npy)
            np.save(f, arr)
    elif fmt == "csv":
        np.savetxt(path, arr, delimiter=sep, fmt="%.17g")
    elif fmt in _CELL_FORMATS:
        with open(path, "w") as f:
            nz = np.nonzero(arr)
            for i, j in zip(*nz):
                f.write(f"{i+1} {j+1} {arr[i, j]:.17g}\n")
    elif fmt in _MM_FORMATS:
        from scipy.io import mmwrite
        from scipy.sparse import coo_matrix

        mmwrite(path, coo_matrix(arr))
    else:
        raise ValueError(f"unknown matrix format {fmt!r}")
    write_metadata(path, {"data_type": "matrix", "format": fmt,
                          "rows": m.num_rows, "cols": m.num_cols,
                          "nnz": int(np.count_nonzero(arr))})


_VT = {"double": ValueType.DOUBLE, "int": ValueType.INT,
       "string": ValueType.STRING, "boolean": ValueType.BOOLEAN}


def read_frame(path: str, fmt: Optional[str] = None, header: bool = False,
               sep: str = ",") -> FrameObject:
    meta = read_metadata(path)
    fmt = fmt or _infer_format(path, meta)
    header = meta.get("header", header)
    sep = meta.get("sep", sep)
    if fmt == "binary":
        # npz container (reference: FrameReaderBinaryBlock)
        with np.load(path, allow_pickle=True) as z:
            cols = [z[f"c{j}"] for j in range(int(z["ncol"]))]
            schema = [ValueType(s) for s in z["schema"].tolist()]
            names = [str(n) for n in z["names"].tolist()]
        return FrameObject(list(cols), schema, names)
    if fmt in ("text", "textcell", "ijv"):
        # "row col value" cells, strings unquoted (FrameReaderTextCell);
        # declared dims in the .mtd take precedence over observed cells
        nrow = int(meta.get("rows", 0))
        ncol = int(meta.get("cols", 0))
        cells = []
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split(" ", 2)
                if len(parts) == 3:
                    i, j, v = int(parts[0]), int(parts[1]), parts[2]
                    cells.append((i, j, v))
                    nrow = max(nrow, i)
                    ncol = max(ncol, j)
        body = [["" for _ in range(ncol)] for _ in range(nrow)]
        for i, j, v in cells:
            body[i - 1][j - 1] = v
        names = None
    elif fmt == "csv":
        import csv as _csv

        with open(path) as f:
            rows = list(_csv.reader(f, delimiter=sep))
        names = rows[0] if header else None
        body = rows[1:] if header else rows
    else:
        raise ValueError(f"frame format {fmt!r} not supported")
    ncol = len(body[0]) if body else 0
    cols, schema = [], []
    schema_spec = meta.get("schema")
    for j in range(ncol):
        vals = [r[j] for r in body]
        vt = _VT.get(schema_spec[j], ValueType.STRING) if schema_spec else None
        if vt is None:
            try:
                fv = [float(v) for v in vals]
                vt = ValueType.DOUBLE
                cols.append(np.array(fv))
            except ValueError:
                vt = ValueType.STRING
                cols.append(np.array(vals, dtype=object))
        else:
            cols.append(np.array([float(v) for v in vals]) if vt in
                        (ValueType.DOUBLE, ValueType.INT)
                        else np.array(vals, dtype=object))
        schema.append(vt)
    return FrameObject(cols, schema, names)


def write_frame(fr: FrameObject, path: str, sep: str = ",", header: bool = True,
                fmt: str = "csv"):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if fmt == "binary":
        arrays = {f"c{j}": np.asarray(c) for j, c in enumerate(fr.columns)}
        arrays["ncol"] = np.array(fr.num_cols)
        arrays["schema"] = np.array([vt.value for vt in fr.schema])
        arrays["names"] = np.array(fr.colnames)
        with open(path, "wb") as f:
            np.savez(f, **arrays)
    elif fmt in ("text", "textcell", "ijv"):
        with open(path, "w") as f:
            for j, c in enumerate(fr.columns):
                for i in range(fr.num_rows):
                    v = str(c[i]).replace("\n", " ")  # cells must stay one line
                    f.write(f"{i+1} {j+1} {v}\n")
    elif fmt == "csv":
        import csv as _csv

        with open(path, "w", newline="") as f:
            w = _csv.writer(f, delimiter=sep)
            if header:
                w.writerow(fr.colnames)
            for i in range(fr.num_rows):
                w.writerow([c[i] for c in fr.columns])
    else:
        raise ValueError(f"unknown frame format {fmt!r}")
    write_metadata(path, {"data_type": "frame", "format": fmt,
                          "rows": fr.num_rows, "cols": fr.num_cols,
                          "header": header,
                          "schema": [vt.value for vt in fr.schema]})
