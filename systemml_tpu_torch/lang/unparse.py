# Copy of systemml_tpu/lang/unparse.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""AST -> DML source (unparser).

The serialization half of program shipping: where the reference flattens
runtime ProgramBlocks + instruction strings for remote parfor workers
(parfor/ProgramConverter.serializeParForBody, ProgramConverter.java:699,
re-parsed by the worker at :1257), this build serializes at the LANGUAGE
level — the AST prints back to canonical DML, the worker re-parses and
re-compiles it for its own devices. Source-level shipping is the natural
choice here because compilation is cheap (a jit trace) and the remote
end may face different device counts/shapes than the coordinator.

Guarantee (tested): parse(unparse(parse(src))) produces an identical
AST for the whole reference script corpus.
"""

from __future__ import annotations

from typing import List, Optional

from systemml_tpu_torch.lang import ast as A

# binding strength for parenthesization (mirror of the parser's
# precedence ladder, lang/parser.py)
_PREC = {
    "||": 1, "|": 1, "&&": 2, "&": 2,
    "==": 4, "!=": 4, "<": 4, "<=": 4, ">": 4, ">=": 4,
    "+": 5, "-": 5,
    "*": 6, "/": 6,
    "%%": 7, "%/%": 7,
    "%*%": 8,
    "^": 10,
}
_RIGHT_ASSOC = {"^"}
# '!' lives at the parser's not-level (between '&&' and comparisons,
# lang/parser.py:_not_expr); unary sign binds just below %*%.
_UNARY_PREC = 9
_NOT_PREC = 3


def expr(e: A.Expr, parent_prec: int = 0) -> str:
    if isinstance(e, A.IntLiteral):
        return str(e.value)
    if isinstance(e, A.FloatLiteral):
        return repr(e.value)
    if isinstance(e, A.StringLiteral):
        return '"' + e.value.replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n").replace("\t", "\\t") + '"'
    if isinstance(e, A.BoolLiteral):
        return "TRUE" if e.value else "FALSE"
    if isinstance(e, A.Identifier):
        return e.name
    if isinstance(e, A.CommandLineArg):
        return f"${e.name}"
    if isinstance(e, A.Indexed):
        return _indexed(e)
    if isinstance(e, A.BinaryOp):
        p = _PREC[e.op]
        lp, rp = (p + 1, p) if e.op in _RIGHT_ASSOC else (p, p + 1)
        s = f"{expr(e.left, lp)} {e.op} {expr(e.right, rp)}"
        return f"({s})" if p < parent_prec else s
    if isinstance(e, A.UnaryOp):
        p = _NOT_PREC if e.op == "!" else _UNARY_PREC
        s = f"{e.op}{expr(e.operand, p)}"
        return f"({s})" if p < parent_prec else s
    if isinstance(e, A.FunctionCall):
        ns = f"{e.namespace}::" if e.namespace else ""
        args = ", ".join(f"{n}={expr(v)}" if n else expr(v)
                         for n, v in e.args)
        return f"{ns}{e.name}({args})"
    if isinstance(e, A.ExprList):
        return "[" + ", ".join(expr(x) for x in e.items) + "]"
    raise TypeError(f"cannot unparse expression {type(e).__name__}")


def _indexed(e: A.Indexed) -> str:
    t = expr(e.target, 9)
    if e.ndims == 1:
        return f"{t}[{expr(e.row_lower)}]"

    def part(lo, hi, single):
        if single:
            return expr(lo)
        lo_s = expr(lo) if lo is not None else ""
        hi_s = expr(hi) if hi is not None else ""
        if lo is not None and hi is not None and lo is hi:
            return lo_s  # degenerate range printed once
        return f"{lo_s}:{hi_s}" if (lo_s or hi_s) else ""

    r = part(e.row_lower, e.row_upper, e.row_single)
    c = part(e.col_lower, e.col_upper, e.col_single)
    return f"{t}[{r}, {c}]"


def _typed_arg(a: A.TypedArg) -> str:
    if a.data_type == A.DataType.SCALAR:
        ty = a.value_type.value
    elif a.data_type == A.DataType.MATRIX:
        ty = f"matrix[{a.value_type.value}]"
    elif a.data_type == A.DataType.FRAME:
        ty = f"frame[{a.value_type.value}]"
    else:
        ty = a.data_type.value
    s = f"{ty} {a.name}"
    if a.default is not None:
        s += f" = {expr(a.default)}"
    return s


def stmt(s: A.Stmt, indent: int = 0) -> List[str]:
    pad = "  " * indent
    if isinstance(s, A.IfdefAssignment):
        return [f"{pad}{expr(s.target)} = ifdef({expr(s.arg)}, "
                f"{expr(s.default)})"]
    if isinstance(s, A.Assignment):
        op = "+=" if s.accumulate else "="
        return [f"{pad}{expr(s.target)} {op} {expr(s.source)}"]
    if isinstance(s, A.MultiAssignment):
        ts = ", ".join(expr(t) for t in s.targets)
        return [f"{pad}[{ts}] = {expr(s.call)}"]
    if isinstance(s, A.ExprStatement):
        return [f"{pad}{expr(s.expr)}"]
    if isinstance(s, A.IfStatement):
        out = [f"{pad}if ({expr(s.predicate)}) {{"]
        out += body(s.if_body, indent + 1)
        if s.else_body:
            out.append(f"{pad}}} else {{")
            out += body(s.else_body, indent + 1)
        out.append(f"{pad}}}")
        return out
    if isinstance(s, A.WhileStatement):
        out = [f"{pad}while ({expr(s.predicate)}) {{"]
        out += body(s.body, indent + 1)
        out.append(f"{pad}}}")
        return out
    if isinstance(s, (A.ParForStatement, A.ForStatement)):
        kw = "parfor" if isinstance(s, A.ParForStatement) else "for"
        rng = f"{expr(s.from_expr)}:{expr(s.to_expr)}"
        if s.incr_expr is not None:
            rng = f"seq({expr(s.from_expr)}, {expr(s.to_expr)}, " \
                  f"{expr(s.incr_expr)})"
        extra = "".join(f", {k}={expr(v)}" for k, v in s.params.items())
        out = [f"{pad}{kw} ({s.var} in {rng}{extra}) {{"]
        out += body(s.body, indent + 1)
        out.append(f"{pad}}}")
        return out
    if isinstance(s, A.FunctionDef):
        ins = ", ".join(_typed_arg(a) for a in s.inputs)
        outs = ", ".join(_typed_arg(a) for a in s.outputs)
        if s.external:
            # bodyless; the implemented-in clause is not retained by the
            # AST (the Python UDF registry replaces the JVM class lookup)
            return [f"{pad}{s.name} = externalFunction({ins}) "
                    f"return ({outs}) implemented in (classname=\"udf\")"]
        out = [f"{pad}{s.name} = function({ins}) return ({outs}) {{"]
        out += body(s.body, indent + 1)
        out.append(f"{pad}}}")
        return out
    if isinstance(s, A.ImportStatement):
        return [f'{pad}source("{s.path}") as {s.namespace}']
    if isinstance(s, A.PathStatement):
        return [f'{pad}setwd("{s.path}")']
    raise TypeError(f"cannot unparse statement {type(s).__name__}")


def body(stmts: List[A.Stmt], indent: int = 0) -> List[str]:
    out: List[str] = []
    for s in stmts:
        out += stmt(s, indent)
    return out


def unparse(stmts: List[A.Stmt]) -> str:
    return "\n".join(body(stmts)) + "\n"


def unparse_program(prog: A.DMLProgram,
                    namespace: Optional[str] = None) -> str:
    """Whole program: function definitions first, then statements (the
    shape serializeParForBody ships — functions + body)."""
    lines: List[str] = []
    for (ns, _), fd in prog.functions.items():
        if ns == A.DEFAULT_NAMESPACE or namespace == ns:
            lines += stmt(fd)
            lines.append("")
    lines += body(prog.statements)
    return "\n".join(lines) + "\n"
