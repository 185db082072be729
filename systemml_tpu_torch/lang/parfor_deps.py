# Copy of systemml_tpu/lang/parfor_deps.py for the PyTorch port,
# with its imports pointed at systemml_tpu_torch.
"""parfor loop-carried dependency analysis (static race detection).

TPU-native equivalent of the reference's ParForStatementBlock.validate
(parser/ParForStatementBlock.java:176, candidate collection + GCD/Banerjee
style testing at :249-306): before a parfor executes, prove that no two
iterations write the same cell (write-write) and no iteration reads cells
another iteration writes (read-write). Index expressions are normalized to
linear forms a*i + b in the loop variable; non-linear or unprovable cases
are conservatively rejected — `check=0` opts out, exactly like the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from systemml_tpu_torch.lang import ast as A


class ParForDependencyError(Exception):
    pass


@dataclass
class Linear:
    """a*i + b; a/b None = unknown (non-linear)."""

    a: Optional[float]
    b: Optional[float]

    @property
    def known(self) -> bool:
        return self.a is not None and self.b is not None


UNKNOWN = Linear(None, None)


def linear_form(e: Optional[A.Expr], ivar: str) -> Linear:
    """Normalize an index expression to a*ivar + b where possible."""
    if e is None:
        return UNKNOWN
    if isinstance(e, A.IntLiteral) or isinstance(e, A.FloatLiteral):
        return Linear(0.0, float(e.value))
    if isinstance(e, A.Identifier):
        if e.name == ivar:
            return Linear(1.0, 0.0)
        return UNKNOWN  # loop-invariant symbol: unknown offset
    if isinstance(e, A.UnaryOp) and e.op == "-":
        f = linear_form(e.operand, ivar)
        if f.known:
            return Linear(-f.a, -f.b)
        return UNKNOWN
    if isinstance(e, A.BinaryOp):
        l = linear_form(e.left, ivar)
        r = linear_form(e.right, ivar)
        if e.op == "+" and l.known and r.known:
            return Linear(l.a + r.a, l.b + r.b)
        if e.op == "-" and l.known and r.known:
            return Linear(l.a - r.a, l.b - r.b)
        if e.op == "*":
            if l.known and l.a == 0 and r.known:
                return Linear(r.a * l.b, r.b * l.b)
            if r.known and r.a == 0 and l.known:
                return Linear(l.a * r.b, l.b * r.b)
    return UNKNOWN


@dataclass
class Access:
    var: str
    is_write: bool
    row: Linear
    row_hi: Linear   # == row for single index
    col: Linear
    col_hi: Linear
    whole: bool = False  # unindexed matrix access


def _collect(stmts: List[A.Stmt], ivar: str, writes: List[Access],
             reads: List[Access], scalar_first_use: Dict[str, str],
             assigned: Set[str], scalar_writes: Set[str]):
    """Walk statements in order collecting indexed accesses and
    scalar read-before-write facts."""

    import dataclasses

    def _children(e: A.Expr):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, A.Expr):
                yield v
            elif isinstance(v, list):
                for item in v:
                    if isinstance(item, A.Expr):
                        yield item
                    elif isinstance(item, tuple):
                        for x in item:
                            if isinstance(x, A.Expr):
                                yield x

    def expr_reads(e: A.Expr):
        if isinstance(e, A.Indexed) and isinstance(e.target, A.Identifier):
            if e.target.name != ivar:
                reads.append(Access(
                    e.target.name, False,
                    linear_form(e.row_lower, ivar),
                    linear_form(e.row_upper, ivar) if e.row_upper else
                    (linear_form(e.row_lower, ivar) if e.row_single else UNKNOWN),
                    linear_form(e.col_lower, ivar),
                    linear_form(e.col_upper, ivar) if e.col_upper else
                    (linear_form(e.col_lower, ivar) if e.col_single else UNKNOWN)))
            for b in (e.row_lower, e.row_upper, e.col_lower, e.col_upper):
                if b is not None:
                    expr_reads(b)
            return
        if isinstance(e, A.Identifier):
            if e.name != ivar:
                # possible whole-matrix or scalar read
                if e.name not in assigned:
                    scalar_first_use.setdefault(e.name, "read")
                reads.append(Access(e.name, False, UNKNOWN, UNKNOWN,
                                    UNKNOWN, UNKNOWN, whole=True))
            return
        for c in _children(e):
            expr_reads(c)

    for s in stmts:
        if isinstance(s, A.Assignment):
            expr_reads(s.source)
            if s.accumulate and isinstance(s.target, A.Identifier):
                # x += e reads x first
                if s.target.name not in assigned:
                    scalar_first_use.setdefault(s.target.name, "read")
            if isinstance(s.target, A.Indexed) and isinstance(s.target.target, A.Identifier):
                t = s.target
                writes.append(Access(
                    t.target.name, True,
                    linear_form(t.row_lower, ivar),
                    linear_form(t.row_upper, ivar) if t.row_upper else
                    (linear_form(t.row_lower, ivar) if t.row_single else UNKNOWN),
                    linear_form(t.col_lower, ivar),
                    linear_form(t.col_upper, ivar) if t.col_upper else
                    (linear_form(t.col_lower, ivar) if t.col_single else UNKNOWN)))
                for be in (t.row_lower, t.row_upper, t.col_lower, t.col_upper):
                    if be is not None:
                        expr_reads(be)
            elif isinstance(s.target, A.Identifier):
                scalar_first_use.setdefault(s.target.name, "write")
                assigned.add(s.target.name)
                scalar_writes.add(s.target.name)
        elif isinstance(s, A.IfdefAssignment):
            if isinstance(s.target, A.Identifier):
                assigned.add(s.target.name)
        elif isinstance(s, A.MultiAssignment):
            expr_reads(s.call)
            for t in s.targets:
                if isinstance(t, A.Identifier):
                    scalar_first_use.setdefault(t.name, "write")
                    assigned.add(t.name)
                    scalar_writes.add(t.name)
        elif isinstance(s, A.ExprStatement):
            expr_reads(s.expr)
        elif isinstance(s, A.IfStatement):
            expr_reads(s.predicate)
            _collect(s.if_body, ivar, writes, reads, scalar_first_use, set(assigned), scalar_writes)
            _collect(s.else_body, ivar, writes, reads, scalar_first_use, set(assigned), scalar_writes)
        elif isinstance(s, A.WhileStatement):
            expr_reads(s.predicate)
            _collect(s.body, ivar, writes, reads, scalar_first_use, set(assigned), scalar_writes)
        elif isinstance(s, A.ForStatement):  # includes nested ParFor
            expr_reads(s.from_expr)
            expr_reads(s.to_expr)
            if s.incr_expr:
                expr_reads(s.incr_expr)
            _collect(s.body, ivar, writes, reads, scalar_first_use, set(assigned), scalar_writes)


def _ranges_carry_dep(lo1: Linear, hi1: Linear, lo2: Linear, hi2: Linear) -> bool:
    """Can [lo1(i),hi1(i)] of iteration i intersect [lo2(j),hi2(j)] of a
    different iteration j? Conservative: True unless provably disjoint."""
    if not (lo1.known and hi1.known and lo2.known and hi2.known):
        return True
    a = lo1.a
    # same linear coefficient and constant width
    if lo2.a == a and hi1.a == a and hi2.a == a:
        if a == 0:
            return True  # same cells every iteration
        width1 = hi1.b - lo1.b
        width2 = hi2.b - lo2.b
        # stride |a| per iteration; disjoint if windows can't overlap for
        # |i-j| >= 1  (GCD-style test with unit distance)
        max_width = max(width1, width2)
        lo_delta = abs(lo1.b - lo2.b)
        return not (abs(a) * 1 > max_width + lo_delta)
    # differing coefficients, single-cell accesses: the classical GCD
    # test (reference: ParForStatementBlock's Banerjee/GCD testing,
    # parser/ParForStatementBlock.java:249-306). a1*i + b1 == a2*j + b2
    # has an integer solution only when gcd(a1, a2) divides (b2 - b1);
    # if it does not, the accesses can never touch the same cell — for
    # ANY pair (i, j), the self-pair i == j included, so this is safe
    # for both the write-write and read-write queries
    if lo1 is hi1 or (hi1.a == lo1.a and hi1.b == lo1.b):
        if lo2 is hi2 or (hi2.a == lo2.a and hi2.b == lo2.b):
            a1, b1, a2, b2 = lo1.a, lo1.b, lo2.a, lo2.b
            if (a1 != a2 and float(a1).is_integer()
                    and float(a2).is_integer()
                    and float(b1).is_integer()
                    and float(b2).is_integer()):
                import math

                g = math.gcd(int(abs(a1)), int(abs(a2)))
                if g > 0 and int(b2 - b1) % g != 0:
                    return False
    return True


# --------------------------------------------------------------------------
# Affine array-index test catalog
# --------------------------------------------------------------------------
# One row per canonical GCD/Banerjee-style decision: two affine accesses
# (a*i + b, constant window width w) of the same matrix across
# iterations, and whether the analysis must report a possible carried
# dependency. The catalog is DATA — tests/test_analysis.py replays every
# row through `_ranges_carry_dep`, and the table doubles as the
# documented contract of the dependence test (docs/static_analysis.md).
# Fields: (name, (a1, b1, w1), (a2, b2, w2), carries).
AFFINE_CATALOG = (
    # -- positive accepts (provably disjoint -> parallelizable) --------
    ("unit_stride_disjoint_cells", (1, 0, 0), (1, 0, 0), False),
    ("strided_windows_no_overlap", (4, 0, 3), (4, 0, 3), False),
    ("offset_within_stride",       (2, 0, 0), (2, 1, 0), False),
    ("gcd_parity_split",           (2, 0, 0), (4, 1, 0), False),
    ("gcd_coprime_offset",         (4, 0, 0), (2, 1, 0), False),
    ("gcd_even_vs_odd_mixed_coef", (6, 0, 0), (4, 1, 0), False),
    # -- refusals (overlap possible or unprovable) ---------------------
    ("same_cell_every_iter",       (0, 5, 0), (0, 5, 0), True),
    ("unit_stride_shifted_read",   (1, 0, 0), (1, 1, 0), True),
    ("window_wider_than_stride",   (2, 0, 3), (2, 0, 3), True),
    ("gcd_divides_offset",         (4, 0, 0), (2, 2, 0), True),
    ("mixed_coef_same_parity",     (3, 0, 0), (6, 3, 0), True),
)


def _replay_catalog_row(row) -> bool:
    """Evaluate one AFFINE_CATALOG row through the dependence test
    (`carries` result). Shared by tests and docs examples."""
    _, (a1, b1, w1), (a2, b2, w2), _ = row
    lo1, hi1 = Linear(float(a1), float(b1)), Linear(float(a1),
                                                    float(b1 + w1))
    lo2, hi2 = Linear(float(a2), float(b2)), Linear(float(a2),
                                                    float(b2 + w2))
    return _ranges_carry_dep(lo1, hi1, lo2, hi2)


def _count_verdict(kind: str) -> None:
    """Surface dep-check verdicts in the metrics registry (the
    `dep_check_result` counter family, utils/stats.py)."""
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        dc = getattr(st, "dep_check_counts", None)
        if dc is not None:
            dc.inc(kind)


def check_parfor_dependencies(ivar: str, body: List[A.Stmt]):
    """Raise ParForDependencyError when a loop-carried dependency cannot be
    ruled out (reference: ParForStatementBlock LanguageException)."""
    writes: List[Access] = []
    reads: List[Access] = []
    scalar_first_use: Dict[str, str] = {}
    scalar_writes: Set[str] = set()
    _collect(body, ivar, writes, reads, scalar_first_use, set(), scalar_writes)

    # scalar accumulation across iterations: x read before any write
    # AND written somewhere -> carried dependency (x = x + ...)
    written_names = {w.var for w in writes} | scalar_writes
    for name, first in scalar_first_use.items():
        if first == "read" and name in scalar_writes:
            _count_verdict("reject_scalar_carried")
            raise ParForDependencyError(
                f"parfor: loop-carried dependency on scalar '{name}' "
                f"(read before write across iterations); use check=0 to override")

    by_var: Dict[str, List[Access]] = {}
    for w in writes:
        by_var.setdefault(w.var, []).append(w)
    for var, ws in by_var.items():
        # write-write: every pair of writes (incl. self at different i)
        for w1 in ws:
            for w2 in ws:
                row_dep = _ranges_carry_dep(w1.row, w1.row_hi, w2.row, w2.row_hi)
                col_dep = _ranges_carry_dep(w1.col, w1.col_hi, w2.col, w2.col_hi)
                if row_dep and col_dep:
                    _count_verdict("reject_write_write")
                    raise ParForDependencyError(
                        f"parfor: possible write-write dependency on '{var}' "
                        f"across iterations; use check=0 to override")
        # read-write: every read of the var against EVERY write of it —
        # a read disjoint from the first write can still alias a later
        # one (A[4i,]=..; A[2i+1,]=..; read A[2i+3,] races the second
        # write at i=j+1, which a ws[0]-only comparison never tests)
        for r in reads:
            if r.var != var:
                continue
            if r.whole:
                _count_verdict("reject_whole_read")
                raise ParForDependencyError(
                    f"parfor: matrix '{var}' is both updated and read "
                    f"unindexed across iterations; use check=0 to override")
            for w in ws:
                row_dep = _ranges_carry_dep(w.row, w.row_hi, r.row, r.row_hi)
                col_dep = _ranges_carry_dep(w.col, w.col_hi, r.col, r.col_hi)
                if row_dep and col_dep:
                    _count_verdict("reject_read_write")
                    raise ParForDependencyError(
                        f"parfor: possible read-write dependency on "
                        f"'{var}'; use check=0 to override")
    _count_verdict("accept")
