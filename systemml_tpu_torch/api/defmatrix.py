"""Lazy NumPy-like matrix API that builds DML under the hood.

TPU-native equivalent of the reference's Python matrix class
(src/main/python/systemml/defmatrix.py:343 — lazy DML AST building,
evaluation on demand at :453-476, numpy interop, set_lazy at :91): every
operator on a `matrix` appends to a deferred expression DAG; nothing
executes until a value is needed (`eval`/`toNumPy`/print), at which point
the accumulated DAG is emitted as ONE DML script and run through
MLContext — so the whole chain compiles as a single program and the HOP
optimizer (mmchain reassociation, CSE, fusion) sees it end to end. That
whole-program view is the point of laziness here: `t(X) @ (X @ v)`
written in Python still lowers to the fused mmchain kernel.

    from systemml_tpu_torch.api.defmatrix import matrix, eval as mt_eval
    X = matrix(np_array)
    w = (X.transpose() @ (X @ v)) / X.nrow()
    w.toNumPy()          # triggers one compiled execution

Supported surface (parity with defmatrix.py): + - * / ^ @(dot),
right-side variants, comparisons, unary -, abs/exp/log/sqrt/sin/cos/tan/
sign/round/floor/ceil, sum/mean/max/min/var/sd (full or axis), nrow/ncol,
transpose, solve, cbind/rbind, 2-D slicing (read), `full`/`seq`/`rand`
constructors, and `eval()` for explicit multi-output evaluation.

Port of systemml_tpu/api/defmatrix.py: an evaluation runs through the
port's MLContext under the active config (utils/config.get_config), so
on the card by default; `set_config(DMLConfig(device="cpu"))` runs it on
the CPU. Results come back as numpy arrays.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_lock = threading.Lock()
_counter = [0]


def _fresh_name() -> str:
    with _lock:
        _counter[0] += 1
        return f"mVar{_counter[0]}"


class matrix:
    """A lazily evaluated DML matrix expression node."""

    # numpy should defer binary ops to us (np_array + matrix)
    __array_priority__ = 100.0

    def __init__(self, data=None, *, op: Optional[str] = None,
                 parents: Sequence["matrix"] = (), scalars: Dict = None):
        self.name = _fresh_name()
        self._data: Optional[np.ndarray] = None
        self._op = op
        self._parents = list(parents)
        self._scalars = scalars or {}
        if data is not None:
            arr = np.asarray(data, dtype=np.float64)
            if arr.ndim == 1:
                arr = arr.reshape(-1, 1)
            if arr.ndim != 2:
                raise ValueError("matrix() takes 2-D (or 1-D column) data")
            self._data = arr

    # ---- state ----------------------------------------------------------

    @property
    def evaluated(self) -> bool:
        return self._data is not None

    def _dml_expr(self) -> str:
        """This node's defining DML expression (parents referenced by
        variable name)."""
        p = [x.name for x in self._parents]
        s = self._scalars
        tpl = _OP_DML[self._op]
        return tpl.format(*p, **s)

    # ---- evaluation -----------------------------------------------------

    def eval(self) -> np.ndarray:
        """Force evaluation: emit the pending DAG as one DML script, run
        it, cache the result (reference: defmatrix.eval :453)."""
        if self._data is not None:
            return self._data
        _eval_nodes([self])
        return self._data

    def toNumPy(self) -> np.ndarray:
        return np.asarray(self.eval())

    def to_numpy(self) -> np.ndarray:  # pep8 alias
        return self.toNumPy()

    def asScalar(self) -> float:
        v = self.toNumPy()
        if v.size != 1:
            raise ValueError(f"matrix is {v.shape}, not 1x1")
        return float(v.reshape(())[()])

    def nrow(self) -> int:
        return int(self.toNumPy().shape[0])

    def ncol(self) -> int:
        return int(self.toNumPy().shape[1])

    @property
    def shape(self):
        return self.toNumPy().shape

    def __repr__(self):
        if self.evaluated:
            return f"matrix({self._data!r})"
        return (f"matrix(<lazy {self._op}>)  # call .eval() or .toNumPy() "
                f"to materialize")

    # ---- operator surface -----------------------------------------------

    def _bin(self, op: str, other, swap=False) -> "matrix":
        if isinstance(other, np.ndarray):
            other = matrix(other)  # array operand: lazy leaf
        if isinstance(other, matrix):
            a, b = (other, self) if swap else (self, other)
            return matrix(op=op, parents=[a, b])
        v = _fmt_scalar(other)
        tpl_op = op + ("_rs" if swap else "_s")
        return matrix(op=tpl_op, parents=[self], scalars={"v": v})

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, swap=True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, swap=True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, swap=True)
    def __truediv__(self, o): return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, swap=True)
    def __pow__(self, o): return self._bin("pow", o)
    def __matmul__(self, o): return self._bin("mm", _as_matrix(o))
    def __rmatmul__(self, o): return self._bin("mm", _as_matrix(o), swap=True)
    def dot(self, o): return self._bin("mm", _as_matrix(o))
    def __neg__(self): return matrix(op="neg", parents=[self])
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __eq__(self, o): return self._bin("eq", o)
    def __ne__(self, o): return self._bin("ne", o)
    # == is elementwise (numpy semantics); identity-based hashing stays
    __hash__ = object.__hash__

    def __getitem__(self, idx):
        if not isinstance(idx, tuple) or len(idx) != 2:
            raise TypeError("matrix indexing is 2-D: m[rows, cols]")
        r, c = (_slice_dml(i) for i in idx)
        return matrix(op="index", parents=[self], scalars={"r": r, "c": c})

    def transpose(self) -> "matrix":
        return matrix(op="t", parents=[self])

    @property
    def T(self) -> "matrix":
        return self.transpose()

    def _agg(self, fn: str, axis: Optional[int]) -> "matrix":
        if axis is None:
            return matrix(op="agg", parents=[self], scalars={"fn": fn})
        row_fns = {"sum": "rowSums", "mean": "rowMeans", "max": "rowMaxs",
                   "min": "rowMins", "var": "rowVars", "sd": "rowSds"}
        col_fns = {"sum": "colSums", "mean": "colMeans", "max": "colMaxs",
                   "min": "colMins", "var": "colVars", "sd": "colSds"}
        fn2 = (row_fns if axis == 1 else col_fns)[fn]
        return matrix(op="aggm", parents=[self], scalars={"fn": fn2})

    def sum(self, axis=None): return self._agg("sum", axis)
    def mean(self, axis=None): return self._agg("mean", axis)
    def max(self, axis=None): return self._agg("max", axis)
    def min(self, axis=None): return self._agg("min", axis)
    def var(self, axis=None): return self._agg("var", axis)
    def sd(self, axis=None): return self._agg("sd", axis)

    def abs(self): return _unary(self, "abs")
    def exp(self): return _unary(self, "exp")
    def log(self): return _unary(self, "log")
    def sqrt(self): return _unary(self, "sqrt")
    def sign(self): return _unary(self, "sign")
    def round(self): return _unary(self, "round")
    def floor(self): return _unary(self, "floor")
    def ceil(self): return _unary(self, "ceil")
    def sin(self): return _unary(self, "sin")
    def cos(self): return _unary(self, "cos")
    def tan(self): return _unary(self, "tan")


# DML templates per lazy op ({0}, {1} = parent names)
_OP_DML = {
    "add": "{0} + {1}", "sub": "{0} - {1}", "mul": "{0} * {1}",
    "div": "{0} / {1}", "pow": "{0} ^ {1}", "mm": "{0} %*% {1}",
    "lt": "{0} < {1}", "le": "{0} <= {1}", "gt": "{0} > {1}",
    "ge": "{0} >= {1}", "eq": "{0} == {1}", "ne": "{0} != {1}",
    "add_s": "{0} + {v}", "sub_s": "{0} - {v}", "mul_s": "{0} * {v}",
    "div_s": "{0} / {v}", "pow_s": "{0} ^ {v}",
    "lt_s": "{0} < {v}", "le_s": "{0} <= {v}", "gt_s": "{0} > {v}",
    "ge_s": "{0} >= {v}", "eq_s": "{0} == {v}", "ne_s": "{0} != {v}",
    "add_rs": "{v} + {0}", "sub_rs": "{v} - {0}", "mul_rs": "{v} * {0}",
    "div_rs": "{v} / {0}",
    "neg": "-{0}", "t": "t({0})",
    "agg": "as.matrix({fn}({0}))",
    "aggm": "{fn}({0})",
    "un": "{fn}({0})",
    "index": "{0}[{r}, {c}]",
    "solve": "solve({0}, {1})",
    "cbind": "cbind({0}, {1})", "rbind": "rbind({0}, {1})",
    "full": "matrix({v}, rows={r}, cols={c})",
    "seq": "as.matrix(seq({a}, {b}, {s}))",
    "rand": 'rand(rows={r}, cols={c}, min={lo}, max={hi}, sparsity={sp}'
            ', seed={seed})',
}


def _unary(m: matrix, fn: str) -> matrix:
    return matrix(op="un", parents=[m], scalars={"fn": fn})


def _as_matrix(o) -> matrix:
    return o if isinstance(o, matrix) else matrix(o)


def _fmt_scalar(v) -> str:
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    raise TypeError(f"unsupported scalar operand {type(v).__name__}")


def _slice_dml(i) -> str:
    """Python 0-based index/slice -> DML 1-based inclusive range.
    Negative (end-relative) indices are rejected: the matrix is lazy, so
    its extent is unknown at expression-build time."""
    def conv(v, stop=False):
        v = int(v)
        if v < 0:
            raise ValueError(
                f"negative index {v} unsupported on lazy matrices "
                f"(the extent is unknown until evaluation)")
        return str(v if stop else v + 1)

    if isinstance(i, slice):
        if i.step not in (None, 1):
            raise ValueError("matrix slicing does not support a step")
        lo = "" if i.start is None else conv(i.start)
        hi = "" if i.stop is None else conv(i.stop, stop=True)
        return f"{lo}:{hi}" if (lo or hi) else ""
    return conv(i)


# ---- constructors --------------------------------------------------------

def full(shape, fill: float = 0.0) -> matrix:
    r, c = int(shape[0]), int(shape[1])
    return matrix(op="full", scalars={"v": _fmt_scalar(float(fill)),
                                      "r": r, "c": c})


def seq(start, stop=None, step: float = 1.0) -> matrix:
    if stop is None:
        start, stop = 1, start
    return matrix(op="seq", scalars={"a": _fmt_scalar(start),
                                     "b": _fmt_scalar(stop),
                                     "s": _fmt_scalar(step)})


def rand(rows: int, cols: int, min: float = 0.0, max: float = 1.0,
         sparsity: float = 1.0, seed: int = -1) -> matrix:
    return matrix(op="rand", scalars={"r": int(rows), "c": int(cols),
                                      "lo": _fmt_scalar(float(min)),
                                      "hi": _fmt_scalar(float(max)),
                                      "sp": _fmt_scalar(float(sparsity)),
                                      "seed": int(seed)})


def solve(a: matrix, b: matrix) -> matrix:
    return matrix(op="solve", parents=[_as_matrix(a), _as_matrix(b)])


def cbind(a: matrix, b: matrix) -> matrix:
    return matrix(op="cbind", parents=[_as_matrix(a), _as_matrix(b)])


def rbind(a: matrix, b: matrix) -> matrix:
    return matrix(op="rbind", parents=[_as_matrix(a), _as_matrix(b)])


def eval(*nodes: matrix) -> List[np.ndarray]:
    """Evaluate several lazy matrices in ONE compiled script (reference:
    defmatrix.eval's multi-output path)."""
    pending = [n for n in nodes if not n.evaluated]
    if pending:
        _eval_nodes(pending)
    return [n._data for n in nodes]


# ---- script emission -----------------------------------------------------

def _eval_nodes(targets: List[matrix]) -> None:
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import get_config

    # topological order over the union DAG
    order: List[matrix] = []
    seen: Dict[int, bool] = {}

    def visit(n: matrix):
        if id(n) in seen:
            return
        seen[id(n)] = True
        if not n.evaluated:
            for p in n._parents:
                visit(p)
        order.append(n)

    for t in targets:
        visit(t)

    lines: List[str] = []
    script = dml("")  # placeholder; source set below
    for n in order:
        if n.evaluated:
            script.input(n.name, n._data)  # leaf: bind in memory
        else:
            lines.append(f"{n.name} = {n._dml_expr()}")
    script.source = "\n".join(lines) + "\n"
    out_names = [t.name for t in targets]
    res = MLContext(get_config().copy()).execute(script.output(*out_names))
    for t in targets:
        v = res.get_matrix(t.name)
        t._data = np.asarray(v, dtype=np.float64).reshape(
            v.shape if v.ndim == 2 else (-1, 1))
        t._parents = []  # release the upstream DAG
        t._scalars = {}
