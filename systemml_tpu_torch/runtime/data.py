"""Runtime data objects: the symbol-table value types.

Port of systemml_tpu/runtime/data.py over torch.Tensor. A MatrixObject
holds a 2-D tensor on the device the config names (the card, or the CPU
when the caller asks for it), or a runtime.sparse.SparseMatrix (CSR on
its device) with its nnz; numpy appears only at host boundaries. A
FrameObject holds typed numpy columns on the host.

`from_reference` carries values from the JAX package into the port, the
way the tests feed both packages from one seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from systemml_tpu_torch.lang.ast import DataType, ValueType


class Data:
    data_type: DataType = DataType.UNKNOWN


class ScalarObject(Data):
    data_type = DataType.SCALAR

    __slots__ = ("value", "value_type")

    def __init__(self, value, value_type: Optional[ValueType] = None):
        if value_type is None:
            if isinstance(value, bool):
                value_type = ValueType.BOOLEAN
            elif isinstance(value, (int, np.integer)):
                value_type = ValueType.INT
            elif isinstance(value, str):
                value_type = ValueType.STRING
            else:
                value_type = ValueType.DOUBLE
        self.value = value
        self.value_type = value_type

    def __repr__(self):
        return f"Scalar({self.value!r})"


class MatrixObject(Data):
    """A 2-D matrix backed by a dense torch.Tensor (a 1-D tensor becomes
    a column) or a SparseMatrix. `nnz` may be given with a dense tensor;
    otherwise it is counted at first ask (a host read on the card)."""

    data_type = DataType.MATRIX

    __slots__ = ("array", "_nnz")

    def __init__(self, array, nnz: Optional[int] = None):
        from systemml_tpu_torch.runtime.sparse import SparseMatrix

        if isinstance(array, SparseMatrix):
            self.array = array
            self._nnz = array.nnz
            return
        if not isinstance(array, torch.Tensor):
            raise TypeError(f"MatrixObject holds a torch.Tensor or a "
                            f"SparseMatrix, not {type(array).__name__}")
        if array.ndim == 1:
            array = array.reshape(-1, 1)
        self.array = array
        self._nnz = nnz

    @property
    def shape(self):
        return tuple(self.array.shape)

    @property
    def num_rows(self) -> int:
        return int(self.array.shape[0])

    @property
    def num_cols(self) -> int:
        return int(self.array.shape[1])

    def to_numpy(self) -> np.ndarray:
        if self.is_sparse():
            return self.array.to_numpy()
        return self.array.detach().cpu().numpy()

    def is_sparse(self) -> bool:
        from systemml_tpu_torch.runtime.sparse import SparseMatrix

        return isinstance(self.array, SparseMatrix)

    def nnz(self) -> int:
        if self._nnz is None:
            self._nnz = int(torch.count_nonzero(self.array))
        return self._nnz

    def sparsity(self) -> float:
        n = self.num_rows * self.num_cols
        return self.nnz() / n if n else 1.0

    def __repr__(self):
        return (f"Matrix({self.num_rows}x{self.num_cols}, "
                f"dtype={self.array.dtype}, device={self.array.device})")


class FrameObject(Data):
    """Column-typed table (reference: FrameBlock,
    runtime/matrix/data/FrameBlock.java:48 — typed _schema/_coldata).
    Columns are numpy arrays (object dtype for strings), on the host:
    a frame is strings and typed cells, and what goes to the device is
    the matrix that transformencode or as.matrix makes of it (port of
    systemml_tpu/runtime/data.py:113-218)."""

    data_type = DataType.FRAME

    __slots__ = ("columns", "schema", "colnames")

    def __init__(self, columns: List[np.ndarray], schema: List[ValueType],
                 colnames: Optional[List[str]] = None):
        self.columns = columns
        self.schema = schema
        self.colnames = colnames or [f"C{i+1}" for i in range(len(columns))]

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    def to_numpy(self) -> np.ndarray:
        return np.column_stack(self.columns) if self.columns else np.zeros((0, 0))

    def __repr__(self):
        return f"Frame({self.num_rows}x{self.num_cols})"

    # ---- op surface (reference: FrameBlock.java:48 slice/append/
    # leftIndexingOperations/map + the frame instruction family) -------

    def slice(self, rl: int, ru: int, cl: int, cu: int) -> "FrameObject":
        """F[rl:ru, cl:cu] (1-based inclusive): typed columns preserved."""
        cols = [self.columns[j][rl - 1:ru].copy()
                for j in range(cl - 1, cu)]
        return FrameObject(cols, self.schema[cl - 1:cu],
                           self.colnames[cl - 1:cu])

    def left_index(self, other: "FrameObject", rl: int, ru: int,
                   cl: int, cu: int) -> "FrameObject":
        """Copy-on-write F[rl:ru, cl:cu] = G (reference:
        FrameBlock.leftIndexingOperations — which also enforces schema
        compatibility of the written region)."""
        if (other.num_rows, other.num_cols) != (ru - rl + 1, cu - cl + 1):
            raise ValueError(
                f"frame left-index shape mismatch: source "
                f"{other.num_rows}x{other.num_cols} vs range "
                f"{ru - rl + 1}x{cu - cl + 1}")
        tgt_schema = self.schema[cl - 1:cu]
        if other.schema != tgt_schema:
            raise ValueError(
                f"frame left-index schema mismatch: source "
                f"{[s.value for s in other.schema]} vs target "
                f"{[s.value for s in tgt_schema]}")
        cols = [c.copy() for c in self.columns]
        for j in range(cl - 1, cu):
            cols[j][rl - 1:ru] = other.columns[j - (cl - 1)]
        return FrameObject(cols, list(self.schema), list(self.colnames))

    def cbind(self, other: "FrameObject") -> "FrameObject":
        if self.num_rows != other.num_rows:
            raise ValueError("frame cbind: row counts differ")
        return FrameObject(self.columns + other.columns,
                           self.schema + other.schema,
                           self.colnames + other.colnames)

    def rbind(self, other: "FrameObject") -> "FrameObject":
        if self.num_cols != other.num_cols:
            raise ValueError("frame rbind: column counts differ")
        if self.schema != other.schema:
            raise ValueError(
                f"frame rbind schema mismatch: "
                f"{[s.value for s in self.schema]} vs "
                f"{[s.value for s in other.schema]}")
        cols = [np.concatenate([a, b])
                for a, b in zip(self.columns, other.columns)]
        return FrameObject(cols, list(self.schema), list(self.colnames))

    def map_cells(self, fn) -> "FrameObject":
        """Apply a per-cell callable over every column (reference: the
        frame map operation); results stringify — String.valueOf
        semantics — so the STRING schema matches the data."""
        cols = [np.array([str(fn(v)) for v in c], dtype=object)
                for c in self.columns]
        return FrameObject(cols, [ValueType.STRING] * len(cols),
                           list(self.colnames))


class ListObject(Data):
    """Ordered, optionally named value list (reference: ListObject,
    runtime/instructions/cp/ListObject.java)."""

    data_type = DataType.LIST

    __slots__ = ("items", "names")

    def __init__(self, items: List[Data], names: Optional[List[str]] = None):
        self.items = items
        self.names = names

    def get(self, key) -> Data:
        if isinstance(key, str):
            if not self.names:
                raise KeyError(f"unnamed list has no entry {key!r}")
            return self.items[self.names.index(key)]
        return self.items[int(key) - 1]  # 1-based

    def __len__(self):
        return len(self.items)

    def __repr__(self):
        return f"List(n={len(self.items)})"


def to_data(v: Any) -> Data:
    """A runtime value (host scalar, tensor, SparseMatrix, list) as a Data
    object, as list() stores its items."""
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    if isinstance(v, Data):
        return v
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, (bool, int, float, str)):
        return ScalarObject(v)
    if isinstance(v, torch.Tensor) and v.ndim == 0:
        return ScalarObject(v)
    if isinstance(v, (torch.Tensor, SparseMatrix)):
        return MatrixObject(v)
    if isinstance(v, (list, tuple)):
        return ListObject([to_data(x) for x in v])
    raise TypeError(f"cannot wrap {type(v).__name__} as Data")


def from_reference(values: Dict[str, Any], device,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Data]:
    """The JAX package's values, given as numpy arrays or Python scalars
    (its inputs, or what its MLResults return from get_matrix and
    get_scalar), as the port's data objects on `device`.

    Floating matrices take `dtype`, or the port's value dtype for
    `device` under the active config's precision policy when `dtype` is
    None (utils/config.default_dtype); a 1-D array becomes a column.
    Scalars stay host values."""
    from systemml_tpu_torch.utils.config import default_dtype

    device = torch.device(device)
    if dtype is None:
        dtype = default_dtype(device)
    out: Dict[str, Data] = {}
    for name, v in values.items():
        if isinstance(v, np.generic):
            v = v.item()
        if isinstance(v, (bool, int, float, str)):
            out[name] = ScalarObject(v)
            continue
        a = np.asarray(v)
        if a.ndim == 0:
            out[name] = ScalarObject(a.item())
            continue
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
        if t.is_floating_point():
            t = t.to(dtype)
        out[name] = MatrixObject(t.to(device))
    return out
