# Copy of systemml_tpu/lang/ast.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""DML abstract syntax tree.

Node inventory mirrors the reference's statement/expression classes
(reference: parser/DMLProgram.java, parser/Statement.java subclasses,
parser/Expression.java) but as plain Python dataclasses. The parse tree is
built directly by the recursive-descent parser (lang/parser.py); there is no
separate ANTLR parse-tree layer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple


class DataType(Enum):
    MATRIX = "matrix"
    FRAME = "frame"
    SCALAR = "scalar"
    LIST = "list"
    UNKNOWN = "unknown"


class ValueType(Enum):
    DOUBLE = "double"
    INT = "int"
    BOOLEAN = "boolean"
    STRING = "string"
    UNKNOWN = "unknown"


@dataclass
class SourcePos:
    line: int = 0
    col: int = 0

    def __str__(self):
        return f"line {self.line}:{self.col}"


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------

@dataclass
class Expr:
    pos: SourcePos = field(default_factory=SourcePos, kw_only=True)


@dataclass
class IntLiteral(Expr):
    value: int


@dataclass
class FloatLiteral(Expr):
    value: float


@dataclass
class StringLiteral(Expr):
    value: str


@dataclass
class BoolLiteral(Expr):
    value: bool


@dataclass
class Identifier(Expr):
    name: str


@dataclass
class CommandLineArg(Expr):
    """$name or $1 (reference: Dml.g4 COMMANDLINE_*_ID)."""

    name: str


@dataclass
class Indexed(Expr):
    """X[rl:ru, cl:cu] with any part optional (1-based inclusive).

    `row_single`/`col_single` mark `X[i, j]` (no colon) so left-indexing and
    shape inference can distinguish a scalar slice from a 1-row range.
    """

    target: Expr
    row_lower: Optional[Expr] = None
    row_upper: Optional[Expr] = None
    col_lower: Optional[Expr] = None
    col_upper: Optional[Expr] = None
    row_single: bool = False
    col_single: bool = False
    ndims: int = 2  # X[i] on a list uses 1


@dataclass
class BinaryOp(Expr):
    """Arithmetic / relational / boolean binary op; op is the DML spelling
    ('+','-','*','/','^','%%','%/%','%*%','==','!=','<','<=','>','>=','&','|')."""

    op: str
    left: Expr
    right: Expr


@dataclass
class UnaryOp(Expr):
    op: str  # '-', '+', '!'
    operand: Expr


@dataclass
class FunctionCall(Expr):
    """Builtin or user function call. args are (name|None, expr) pairs to
    support parameterized builtins like rand(rows=.., cols=..)."""

    name: str
    args: List[Tuple[Optional[str], Expr]]
    namespace: Optional[str] = None


@dataclass
class ExprList(Expr):
    """[a, b, c] literal (reference: MultiIdExpression) — list construction."""

    items: List[Expr]


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------

@dataclass
class Stmt:
    pos: SourcePos = field(default_factory=SourcePos, kw_only=True)


@dataclass
class Assignment(Stmt):
    target: Expr  # Identifier or Indexed (left-indexing)
    source: Expr
    accumulate: bool = False  # '+=' (reference: AccumulatorAssignmentStatement)


@dataclass
class IfdefAssignment(Stmt):
    """x = ifdef($arg, default)  (reference: IfdefAssignmentStatement)."""

    target: Expr
    arg: Expr
    default: Expr


@dataclass
class MultiAssignment(Stmt):
    targets: List[Expr]
    call: FunctionCall


@dataclass
class ExprStatement(Stmt):
    """Bare function call statement: print(...), write(...), stop(...)."""

    expr: FunctionCall


@dataclass
class IfStatement(Stmt):
    predicate: Expr
    if_body: List[Stmt] = field(default_factory=list)
    else_body: List[Stmt] = field(default_factory=list)


@dataclass
class WhileStatement(Stmt):
    predicate: Expr
    body: List[Stmt] = field(default_factory=list)


@dataclass
class ForStatement(Stmt):
    var: str
    from_expr: Expr = None
    to_expr: Expr = None
    incr_expr: Optional[Expr] = None
    body: List[Stmt] = field(default_factory=list)
    params: Dict[str, Expr] = field(default_factory=dict)


@dataclass
class ParForStatement(ForStatement):
    """parfor(i in a:b, check=.., par=.., mode=..) — params per reference
    ParForStatementBlock (opt-out check=0, degree par=k, mode, opt)."""


@dataclass
class TypedArg:
    data_type: DataType
    value_type: ValueType
    name: str
    default: Optional[Expr] = None


@dataclass
class FunctionDef(Stmt):
    name: str
    inputs: List[TypedArg] = field(default_factory=list)
    outputs: List[TypedArg] = field(default_factory=list)
    body: List[Stmt] = field(default_factory=list)
    # externalFunction ... implemented in (...) — parsed for grammar parity
    # but rejected when called (JVM UDF mechanism; our UDF framework
    # registers Python callables instead)
    external: bool = False


@dataclass
class ImportStatement(Stmt):
    """source("path") as ns"""

    path: str = ""
    namespace: str = ""


@dataclass
class PathStatement(Stmt):
    path: str = ""


# --------------------------------------------------------------------------
# Program
# --------------------------------------------------------------------------

DEFAULT_NAMESPACE = ".defaultNS"


@dataclass
class DMLProgram:
    """A parsed program: top-level statements plus functions keyed by
    (namespace, name) (reference: parser/DMLProgram.java)."""

    statements: List[Stmt] = field(default_factory=list)
    functions: Dict[Tuple[str, str], FunctionDef] = field(default_factory=dict)
    imports: Dict[str, "DMLProgram"] = field(default_factory=dict)

    def get_function(self, name: str, namespace: Optional[str] = None) -> Optional[FunctionDef]:
        ns = namespace or DEFAULT_NAMESPACE
        fn = self.functions.get((ns, name))
        if fn is None and ns != DEFAULT_NAMESPACE and ns in self.imports:
            fn = self.imports[ns].functions.get((DEFAULT_NAMESPACE, name))
        return fn


def walk_expr(e: Expr):
    """Yield e and all sub-expressions."""
    yield e
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            yield from walk_expr(v)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, Expr):
                    yield from walk_expr(item)
                elif isinstance(item, tuple):
                    for x in item:
                        if isinstance(x, Expr):
                            yield from walk_expr(x)


def walk_stmts(stmts: List[Stmt]):
    """Yield every statement in a body, recursively."""
    for s in stmts:
        yield s
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            if isinstance(v, list) and v and isinstance(v[0], Stmt):
                yield from walk_stmts(v)
