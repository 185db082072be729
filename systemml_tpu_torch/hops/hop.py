# Copy of systemml_tpu/hops/hop.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch. New: `mask_operand`, the one place
# that decides which `b(*)` hops multiply by a mask.
"""HOP (high-level operator) IR.

TPU-native equivalent of the reference's Hop DAG (hops/Hop.java and its
subclasses AggBinaryOp/AggUnaryOp/BinaryOp/UnaryOp/ReorgOp/IndexingOp/
DataOp/DataGenOp/TernaryOp/ParameterizedBuiltinOp/...). One DAG per basic
block; leaves are variable reads (TRead) and literals; roots are variable
writes (TWrite) and side-effecting sinks (print/write).

Opcode taxonomy follows the reference's instruction spellings where they
exist (`ba+*` matmult, `ua+` full sum, `uar+` row sum, `r'` transpose, ...)
so Explain output reads like the reference's `-explain hops`.

Each Hop carries optional dims annotations (rows/cols, -1 = unknown) used
by the memory estimator and exec-type selection (reference:
Hop.computeMemEstimate hops/Hop.java:605, findExecTypeByMemEstimate :741).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_ids = itertools.count(1)


@dataclass
class Hop:
    op: str
    inputs: List["Hop"] = field(default_factory=list)
    # static params: builtin name, direction, named-arg literals, ...
    params: Dict[str, Any] = field(default_factory=dict)
    value: Any = None          # literal value (op == 'lit')
    name: Optional[str] = None  # variable name (op in ('tread','twrite'))
    id: int = field(default_factory=lambda: next(_ids))
    # annotations
    rows: int = -1
    cols: int = -1
    # worst-case nnz upper bound (-1 = unknown), propagated by
    # hops/ipa._infer_nnz from datagen literals + hops/estim worst-case
    # formulas; nnz == 0 proves the value is all zeros, enabling the
    # empty-* rewrite family (reference: Hop.refreshSizeInformation's nnz
    # half, hops/Hop.java — setNnz feeding isEmpty(true) rewrite guards)
    nnz: int = -1
    # EXPECTED sparsity in [0,1] (-1 = unknown), propagated by
    # hops/ipa alongside the worst-case nnz bound. Deliberately a
    # separate field: nnz carries PROOF semantics (nnz == 0 licenses the
    # empty-* folds), est_sp carries ESTIMATE semantics (a rand(
    # sparsity=0.01) literal whose worst case is dense) — it only gates
    # profitability decisions (the quaternary rewrite guards), never
    # value-changing folds (reference: DataGenOp seeding
    # OptimizerUtils.getSparsity estimates vs isEmpty(true) proofs)
    est_sp: float = -1.0
    dt: str = "matrix"          # 'matrix' | 'scalar' | 'frame' | 'list' | 'string'
    exec_type: Optional[str] = None  # 'XLA' | 'HOST' | 'MESH' (None = undecided)

    def __hash__(self):
        return self.id

    def __eq__(self, other):
        return self is other

    @property
    def is_literal(self) -> bool:
        return self.op == "lit"

    @property
    def is_scalar(self) -> bool:
        return self.dt == "scalar"

    @property
    def is_matrix(self) -> bool:
        return self.dt == "matrix"

    def dims_known(self) -> bool:
        return self.rows >= 0 and self.cols >= 0

    def cells(self) -> int:
        return self.rows * self.cols if self.dims_known() else -1

    def pretty(self, indent: int = 0, seen=None) -> str:
        seen = seen if seen is not None else set()
        pad = "  " * indent
        label = self.op
        if self.op == "lit":
            label = f"lit[{self.value!r}]"
        elif self.name:
            label = f"{self.op}[{self.name}]"
        dims = f" ({self.rows}x{self.cols})" if self.is_matrix else ""
        # output memory estimate + exec-type + matmult method — the
        # reference's per-hop annotations (Explain.java:108 prints
        # [mem estimates] and the LOP ExecType per line)
        mem = ""
        if self.is_matrix and self.dims_known():
            mem = f" [{_fmt_bytes(self.cells() * 8)}]"
        # one combined physical tag, e.g. [MESH zipmm] (reference: the
        # ExecType + operator name per line, Explain.java:456)
        et = ""
        if self.exec_type:
            method = self.params.get("mm_method")
            et = (f" [{self.exec_type} {method}]" if method
                  else f" [{self.exec_type}]")
        if self.id in seen:
            return f"{pad}({self.id}) ^{label}\n"
        seen.add(self.id)
        out = f"{pad}({self.id}) {label}{dims}{mem}{et}\n"
        for c in self.inputs:
            out += c.pretty(indent + 1, seen)
        return out


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}GB"


def lit(v) -> Hop:
    """Literal hop (reference: LiteralOp)."""
    dt = "string" if isinstance(v, str) else "scalar"
    return Hop("lit", value=v, dt=dt, rows=0, cols=0)


def tread(name: str, dt: str = "matrix") -> Hop:
    return Hop("tread", name=name, dt=dt)


def twrite(name: str, src: Hop) -> Hop:
    return Hop("twrite", inputs=[src], name=name, dt=src.dt,
               rows=src.rows, cols=src.cols)


def postorder(roots: List[Hop]) -> List[Hop]:
    """Deterministic post-order over the DAG (each hop once)."""
    seen: Dict[int, Hop] = {}
    order: List[Hop] = []

    def visit(h: Hop):
        if h.id in seen:
            return
        seen[h.id] = h
        for c in h.inputs:
            visit(c)
        order.append(h)

    for r in roots:
        visit(r)
    return order


def replace_input(parent: Hop, old: Hop, new: Hop):
    parent.inputs = [new if c is old else c for c in parent.inputs]


def rewire(roots: List[Hop], old: Hop, new: Hop) -> List[Hop]:
    """Replace every occurrence of `old` with `new` across the DAG."""
    for h in postorder(roots):
        if old in h.inputs:
            replace_input(h, old, new)
    return [new if r is old else r for r in roots]


# relational and logical hops: a matrix of 0/1 whose product the JAX
# package's jitted block computes as a select (XLA's algebraic simplifier
# rewrites multiply(A, convert(pred)) to select(pred, A, 0))
_MASK_OPS = frozenset({"b(==)", "b(!=)", "b(<)", "b(<=)", "b(>)", "b(>=)",
                       "b(&)", "b(|)", "u(!)", "call:xor", "call:ppred"})


def _is_mask(h: Hop) -> bool:
    if h.dt != "matrix":
        return False  # a scalar comparison keeps the IEEE product
    if h.op == "call:as.matrix" and len(h.inputs) == 1:
        return _is_mask(h.inputs[0])  # as.matrix of a matrix is itself
    if h.op.startswith("call:") and not any(c.dt == "matrix"
                                            for c in h.inputs):
        return False  # xor of two scalars
    return h.op in _MASK_OPS


def mask_operand(h: Hop) -> Optional[int]:
    """The position (0 or 1) of the operand of a `b(*)` hop that is a
    relational or logical hop of the same block, or None. Such a product
    is `where(mask, other, +0)`: +0 at a masked cell whatever the other
    operand holds (NaN, Inf, a negative number), as in the JAX package.
    Every other product is the IEEE product: a mask read from another
    block or given as an input, a scalar comparison, and a mask that is
    broadcast (a row or column vector against a matrix; the dense arm
    also checks the shapes it meets, `ops.cellwise.mask_mul`)."""
    if h.op != "b(*)" or len(h.inputs) != 2:
        return None
    for i, x in enumerate(h.inputs):
        if _is_mask(x) and not (x.dims_known() and h.dims_known() and (
                x.rows, x.cols) != (h.rows, h.cols)):
            return i
    return None
