"""Copied from systemml_tpu/lang/pydml.py for the PyTorch port (it
imports no framework), its imports re-pointed.

PyDML front-end: Python-like syntax producing the SAME AST as DML.

TPU-native equivalent of the reference's PyDML grammar
(parser/pydml/Pydml.g4 + PydmlSyntacticValidator): indentation-delimited
blocks, `def` functions, Python operators and 0-based indexing, all
normalized at parse time onto the shared lang/ast.py node inventory so
every downstream stage (hops, rewrites, runtime) is front-end agnostic —
exactly the reference's CommonSyntacticValidator design, where both
grammars target one Expression/Statement hierarchy.

Surface differences handled here (reference: Pydml.g4):
  blocks        indentation (INDENT/DEDENT), `:` headers
  operators     ** -> ^, % -> %%, // -> %/%, and/or/not -> &,|,!
  booleans      True/False -> TRUE/FALSE
  matmult       dot(A, B) -> A %*% B
  indexing      0-based, exclusive slice ends -> 1-based inclusive
  loops         for i in range(a, b[, s]): iterates a .. b-1 (Python
                semantics); parfor likewise
  functions     def f(X: matrix[float], k: int = 3) -> (Y: matrix[float]):
  builtins      full -> matrix, transpose -> t, float/int casts ->
                as.double/as.integer (everything else passes through)
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from systemml_tpu_torch.lang import ast as A
from systemml_tpu_torch.lang.parser import DMLSyntaxError

# --------------------------------------------------------------------------
# tokenizer (indentation-aware)
# --------------------------------------------------------------------------

_TOKEN = re.compile(r"""
    (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<clarg>\$[A-Za-z0-9_]+)
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<op>\*\*|//|->|<=|>=|==|!=|\+=|[-+*/%<>=!(),:\[\]{}.])
""", re.VERBOSE)


class Tok:
    __slots__ = ("kind", "value", "line", "col")

    def __init__(self, kind, value, line, col):
        self.kind, self.value, self.line, self.col = kind, value, line, col

    def __repr__(self):
        return f"Tok({self.kind},{self.value!r})"


def _strip_comment(raw: str) -> str:
    """Drop a '#' comment, but only outside string literals."""
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote:
            if c == "\\":
                i += 2
                continue
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#":
            return raw[:i]
        i += 1
    return raw


def _tokenize(src: str, name: str) -> List[Tok]:
    toks: List[Tok] = []
    indents = [0]
    paren_depth = 0
    for ln, raw in enumerate(src.split("\n"), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if paren_depth == 0:
            ind = len(line) - len(line.lstrip(" "))
            if ind > indents[-1]:
                indents.append(ind)
                toks.append(Tok("INDENT", ind, ln, 0))
            while ind < indents[-1]:
                indents.pop()
                toks.append(Tok("DEDENT", ind, ln, 0))
            if ind != indents[-1]:
                raise DMLSyntaxError("inconsistent indentation",
                                     A.SourcePos(ln, 0), name)
        pos = len(line) - len(line.lstrip(" "))
        while pos < len(line):
            if line[pos] == " ":
                pos += 1
                continue
            m = _TOKEN.match(line, pos)
            if not m:
                raise DMLSyntaxError(f"unexpected character {line[pos]!r}",
                                     A.SourcePos(ln, pos), name)
            pos = m.end()
            for kind in ("num", "name", "clarg", "str", "op"):
                v = m.group(kind)
                if v is not None:
                    if kind == "op" and v in "([{":
                        paren_depth += 1
                    elif kind == "op" and v in ")]}":
                        paren_depth -= 1
                    toks.append(Tok(kind, v, ln, m.start()))
                    break
        if paren_depth == 0:
            toks.append(Tok("NEWLINE", "\n", ln, len(line)))
    while len(indents) > 1:
        indents.pop()
        toks.append(Tok("DEDENT", 0, 0, 0))
    toks.append(Tok("EOF", "", 0, 0))
    return toks


# --------------------------------------------------------------------------
# parser
# --------------------------------------------------------------------------

_TYPE_MAP = {
    "matrix": (A.DataType.MATRIX, A.ValueType.DOUBLE),
    "frame": (A.DataType.FRAME, A.ValueType.STRING),
    "list": (A.DataType.LIST, A.ValueType.UNKNOWN),
    "float": (A.DataType.SCALAR, A.ValueType.DOUBLE),
    "int": (A.DataType.SCALAR, A.ValueType.INT),
    "bool": (A.DataType.SCALAR, A.ValueType.BOOLEAN),
    "str": (A.DataType.SCALAR, A.ValueType.STRING),
}

_FN_MAP = {"full": "matrix", "transpose": "t",
           "float": "as.double", "int": "as.integer", "bool": "as.logical",
           "str": "as.character"}

_CMP = {"<", "<=", ">", ">=", "==", "!="}


class PyDMLParser:
    def __init__(self, src: str, name: str = "<pydml>"):
        self.name = name
        self.toks = _tokenize(src, name)
        self.i = 0

    # ---- token helpers ---------------------------------------------------

    def peek(self, k=0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i = min(self.i + 1, len(self.toks) - 1)
        return t

    def at(self, kind, value=None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def expect(self, kind, value=None) -> Tok:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise DMLSyntaxError(
                f"expected {value or kind}, got {t.value!r}",
                A.SourcePos(t.line, t.col), self.name)
        return t

    def _pos(self) -> A.SourcePos:
        t = self.peek()
        return A.SourcePos(t.line, t.col)

    # ---- program ---------------------------------------------------------

    def parse_program(self) -> A.DMLProgram:
        prog = A.DMLProgram()
        while not self.at("EOF"):
            s = self.statement()
            if isinstance(s, A.FunctionDef):
                key = (A.DEFAULT_NAMESPACE, s.name)
                if key in prog.functions:
                    raise DMLSyntaxError(
                        f"function {s.name!r} already defined", s.pos,
                        self.name)
                # functions live ONLY in prog.functions, matching the DML
                # parser's AST shape (same-AST parity contract)
                prog.functions[key] = s
            elif s is not None:
                prog.statements.append(s)
        return prog

    # ---- blocks ----------------------------------------------------------

    def block(self) -> List[A.Stmt]:
        """':' NEWLINE INDENT stmts DEDENT"""
        self.expect("op", ":")
        self.expect("NEWLINE")
        self.expect("INDENT")
        out = []
        while not self.at("DEDENT") and not self.at("EOF"):
            s = self.statement()
            if s is not None:
                out.append(s)
        if self.at("DEDENT"):
            self.next()
        return out

    # ---- statements ------------------------------------------------------

    def statement(self) -> Optional[A.Stmt]:
        t = self.peek()
        if t.kind == "NEWLINE":
            self.next()
            return None
        pos = self._pos()
        if t.kind == "name":
            if t.value == "def":
                return self.function_def()
            if t.value == "if":
                return self.if_stmt()
            if t.value == "while":
                self.next()
                pred = self.expr()
                body = self.block()
                return A.WhileStatement(predicate=pred, body=body, pos=pos)
            if t.value in ("for", "parfor"):
                return self.for_stmt(t.value)
        return self.simple_stmt()

    def simple_stmt(self) -> A.Stmt:
        pos = self._pos()
        # multi-assignment: [a, b] = f(...)
        if self.at("op", "["):
            save = self.i
            try:
                targets = self._bracket_targets()
                self.expect("op", "=")
                call = self.expr()
                self._end_line()
                if not isinstance(call, A.FunctionCall):
                    raise DMLSyntaxError("multi-assignment needs a call",
                                         pos, self.name)
                return A.MultiAssignment(targets=targets, call=call, pos=pos)
            except DMLSyntaxError:
                self.i = save
        e = self.expr()
        if self.at("op", "=") or self.at("op", "+="):
            acc = self.next().value == "+="
            src = self.expr()
            self._end_line()
            if (not acc and isinstance(src, A.FunctionCall)
                    and src.name == "ifdef" and len(src.args) == 2):
                return A.IfdefAssignment(target=e, arg=src.args[0][1],
                                         default=src.args[1][1], pos=pos)
            return A.Assignment(target=e, source=src, accumulate=acc, pos=pos)
        self._end_line()
        if isinstance(e, A.FunctionCall):
            return A.ExprStatement(expr=e, pos=pos)
        raise DMLSyntaxError("expression statement must be a call", pos,
                             self.name)

    def _end_line(self):
        if self.at("NEWLINE"):
            self.next()

    def _bracket_targets(self) -> List[A.Expr]:
        self.expect("op", "[")
        out = [A.Identifier(name=self.expect("name").value)]
        while self.at("op", ","):
            self.next()
            out.append(A.Identifier(name=self.expect("name").value))
        self.expect("op", "]")
        return out

    def if_stmt(self, keyword: str = "if") -> A.IfStatement:
        """`if`/`elif` chains: each elif becomes a nested IfStatement in
        the else branch, exactly how the DML parser nests `else { if }`."""
        pos = self._pos()
        self.expect("name", keyword)
        pred = self.expr()
        body = self.block()
        els: List[A.Stmt] = []
        if self.at("name", "elif"):
            els = [self.if_stmt("elif")]
        elif self.at("name", "else"):
            self.next()
            els = self.block()
        return A.IfStatement(predicate=pred, if_body=body, else_body=els,
                             pos=pos)

    def for_stmt(self, kw: str) -> A.ForStatement:
        pos = self._pos()
        self.expect("name", kw)
        var = self.expect("name").value
        self.expect("name", "in")
        self.expect("name", "range")
        self.expect("op", "(")
        a = self.expr()
        b = None
        step = None
        if self.at("op", ","):
            self.next()
            b = self.expr()
        if self.at("op", ","):
            self.next()
            step = self.expr()
        self.expect("op", ")")
        # parfor params follow the range: `parfor i in range(n), check=0:`
        params = {}
        while self.at("op", ","):
            self.next()
            pname = self.expect("name").value
            self.expect("op", "=")
            params[pname] = self.expr()
        if b is None:
            a, b = A.IntLiteral(value=0), a     # range(n) = 0..n-1
        # python-exclusive end -> DML-inclusive bound, direction-aware:
        # range(a,b,+s) iterates a..b-1, range(a,b,-s) iterates a..b+1
        sign = 1
        if step is not None:
            if isinstance(step, A.UnaryOp) and step.op == "-" \
                    and isinstance(step.operand, A.IntLiteral):
                sign = -1
            elif isinstance(step, A.IntLiteral):
                sign = 1 if step.value >= 0 else -1
            else:
                raise DMLSyntaxError(
                    "range() step must be an integer literal (its sign "
                    "decides the inclusive loop bound)", pos, self.name)
        to = _plus_one(b) if sign < 0 else _minus_one(b)
        if step is None:
            # explicit +1: DML's auto-increment picks -1 when to < from,
            # which would turn an EMPTY python range into a downward loop
            step = A.IntLiteral(value=1)
        body = self.block()
        cls = A.ParForStatement if kw == "parfor" else A.ForStatement
        return cls(var=var, from_expr=a, to_expr=to, incr_expr=step,
                   body=body, params=params, pos=pos)

    def function_def(self) -> A.FunctionDef:
        pos = self._pos()
        self.expect("name", "def")
        name = self.expect("name").value
        self.expect("op", "(")
        inputs = []
        while not self.at("op", ")"):
            inputs.append(self._typed_arg())
            if self.at("op", ","):
                self.next()
        self.expect("op", ")")
        outputs = []
        if self.at("op", "->"):
            self.next()
            self.expect("op", "(")
            while not self.at("op", ")"):
                outputs.append(self._typed_arg())
                if self.at("op", ","):
                    self.next()
            self.expect("op", ")")
        body = self.block()
        return A.FunctionDef(name=name, inputs=inputs, outputs=outputs,
                             body=body, pos=pos)

    def _typed_arg(self) -> A.TypedArg:
        nm = self.expect("name").value
        dt, vt = A.DataType.MATRIX, A.ValueType.DOUBLE
        if self.at("op", ":"):
            self.next()
            tname = self.expect("name").value
            if tname not in _TYPE_MAP:
                raise DMLSyntaxError(f"unknown type {tname!r}", self._pos(),
                                     self.name)
            dt, vt = _TYPE_MAP[tname]
            if self.at("op", "["):   # matrix[float] element type annotation
                self.next()
                self.expect("name")
                self.expect("op", "]")
        default = None
        if self.at("op", "="):
            self.next()
            default = self.expr()
        return A.TypedArg(data_type=dt, value_type=vt, name=nm,
                          default=default)

    # ---- expressions (precedence climbing) -------------------------------

    def expr(self) -> A.Expr:
        return self.or_expr()

    def or_expr(self) -> A.Expr:
        e = self.and_expr()
        while self.at("name", "or"):
            pos = self._pos()
            self.next()
            e = A.BinaryOp(op="|", left=e, right=self.and_expr(), pos=pos)
        return e

    def and_expr(self) -> A.Expr:
        e = self.not_expr()
        while self.at("name", "and"):
            pos = self._pos()
            self.next()
            e = A.BinaryOp(op="&", left=e, right=self.not_expr(), pos=pos)
        return e

    def not_expr(self) -> A.Expr:
        if self.at("name", "not"):
            pos = self._pos()
            self.next()
            return A.UnaryOp(op="!", operand=self.not_expr(), pos=pos)
        return self.cmp_expr()

    def cmp_expr(self) -> A.Expr:
        e = self.add_expr()
        if self.peek().kind == "op" and self.peek().value in _CMP:
            pos = self._pos()
            op = self.next().value
            e = A.BinaryOp(op=op, left=e, right=self.add_expr(), pos=pos)
            if self.peek().kind == "op" and self.peek().value in _CMP:
                # a < b < c would parse left-associatively — the OPPOSITE
                # of python's chained semantics; reject loudly
                raise DMLSyntaxError(
                    "chained comparisons are not supported; write "
                    "'a < b and b < c'", self._pos(), self.name)
        return e

    def add_expr(self) -> A.Expr:
        e = self.mul_expr()
        while self.peek().kind == "op" and self.peek().value in ("+", "-"):
            pos = self._pos()
            op = self.next().value
            e = A.BinaryOp(op=op, left=e, right=self.mul_expr(), pos=pos)
        return e

    def mul_expr(self) -> A.Expr:
        e = self.unary()
        while self.peek().kind == "op" and self.peek().value in (
                "*", "/", "%", "//"):
            pos = self._pos()
            op = self.next().value
            op = {"%": "%%", "//": "%/%"}.get(op, op)
            e = A.BinaryOp(op=op, left=e, right=self.unary(), pos=pos)
        return e

    def unary(self) -> A.Expr:
        if self.peek().kind == "op" and self.peek().value in ("-", "+"):
            pos = self._pos()
            op = self.next().value
            return A.UnaryOp(op=op, operand=self.unary(), pos=pos)
        return self.power()

    def power(self) -> A.Expr:
        e = self.postfix()
        if self.at("op", "**"):
            pos = self._pos()
            self.next()
            return A.BinaryOp(op="^", left=e, right=self.unary(), pos=pos)
        return e

    def postfix(self) -> A.Expr:
        e = self.atom()
        while True:
            if self.at("op", "("):
                e = self._call(e)
            elif self.at("op", "["):
                e = self._index(e)
            else:
                return e

    def _call(self, fn: A.Expr) -> A.Expr:
        if not isinstance(fn, A.Identifier):
            raise DMLSyntaxError("cannot call this expression", self._pos(),
                                 self.name)
        pos = self._pos()
        self.expect("op", "(")
        args: List[Tuple[Optional[str], A.Expr]] = []
        while not self.at("op", ")"):
            nm = None
            if (self.peek().kind == "name" and self.peek(1).kind == "op"
                    and self.peek(1).value == "="):
                nm = self.next().value
                self.next()
            args.append((nm, self.expr()))
            if self.at("op", ","):
                self.next()
        self.expect("op", ")")
        name = fn.name
        if name == "dot":           # dot(A, B) -> A %*% B
            if len(args) != 2:
                raise DMLSyntaxError("dot() takes two arguments", pos,
                                     self.name)
            return A.BinaryOp(op="%*%", left=args[0][1], right=args[1][1],
                              pos=pos)
        name = _FN_MAP.get(name, name)
        return A.FunctionCall(name=name, args=args, pos=pos)

    def _index(self, target: A.Expr) -> A.Expr:
        """0-based, end-exclusive python indexing -> 1-based inclusive."""
        pos = self._pos()
        self.expect("op", "[")
        rl = ru = cl = cu = None
        rs = cs = False
        rl, ru, rs = self._one_dim()
        if self.at("op", ","):
            self.next()
            cl, cu, cs = self._one_dim()
        else:
            cl, cu, cs = None, None, False
        self.expect("op", "]")
        return A.Indexed(target=target, row_lower=rl, row_upper=ru,
                         col_lower=cl, col_upper=cu, row_single=rs,
                         col_single=cs, pos=pos)

    def _one_dim(self):
        """Parse one index dimension; returns (lower, upper, single)."""
        if self.at("op", ",") or self.at("op", "]"):
            return None, None, False
        lo = None
        if not self.at("op", ":"):
            lo = self.expr()
            self._reject_negative_index(lo)
        if self.at("op", ":"):
            self.next()
            hi = None
            if not (self.at("op", ",") or self.at("op", "]")):
                hi = self.expr()   # exclusive end == inclusive 1-based end
                self._reject_negative_index(hi)
            return (_plus_one(lo) if lo is not None else None), hi, False
        return _plus_one(lo), None, True

    def _reject_negative_index(self, e: A.Expr):
        """python's from-the-end negative indices have no DML analog; a
        silent +1 shift would read the wrong element."""
        neg = (isinstance(e, A.IntLiteral) and e.value < 0) or \
            (isinstance(e, A.UnaryOp) and e.op == "-"
             and isinstance(e.operand, A.IntLiteral))
        if neg:
            raise DMLSyntaxError(
                "negative (from-the-end) indices are not supported; use "
                "nrow()/ncol() arithmetic", self._pos(), self.name)

    def atom(self) -> A.Expr:
        t = self.peek()
        pos = self._pos()
        if t.kind == "num":
            self.next()
            if "." in t.value or "e" in t.value or "E" in t.value:
                return A.FloatLiteral(value=float(t.value), pos=pos)
            return A.IntLiteral(value=int(t.value), pos=pos)
        if t.kind == "str":
            self.next()
            return A.StringLiteral(value=_unescape(t.value[1:-1]), pos=pos)
        if t.kind == "clarg":
            self.next()
            return A.CommandLineArg(name=t.value[1:], pos=pos)
        if t.kind == "name":
            self.next()
            if t.value == "True":
                return A.BoolLiteral(value=True, pos=pos)
            if t.value == "False":
                return A.BoolLiteral(value=False, pos=pos)
            return A.Identifier(name=t.value, pos=pos)
        if t.kind == "op" and t.value == "(":
            self.next()
            e = self.expr()
            self.expect("op", ")")
            return e
        raise DMLSyntaxError(f"unexpected token {t.value!r}", pos, self.name)


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "'": "'", "\\": "\\"}


def _unescape(s: str) -> str:
    """Backslash escapes without the unicode_escape mojibake (utf-8 text
    must survive untouched)."""
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            out.append(_ESCAPES.get(s[i + 1], "\\" + s[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _plus_one(e: A.Expr) -> A.Expr:
    """0-based -> 1-based: fold literals so PyDML spellings produce the
    same AST as the natural DML spelling."""
    if isinstance(e, A.IntLiteral):
        return A.IntLiteral(value=e.value + 1, pos=e.pos)
    return A.BinaryOp(op="+", left=e, right=A.IntLiteral(value=1), pos=e.pos)


def _minus_one(e: A.Expr) -> A.Expr:
    if isinstance(e, A.IntLiteral):
        return A.IntLiteral(value=e.value - 1, pos=e.pos)
    return A.BinaryOp(op="-", left=e, right=A.IntLiteral(value=1), pos=e.pos)


# --------------------------------------------------------------------------
# public API (mirrors lang/parser.py)
# --------------------------------------------------------------------------

def parse_pydml(src: str, name: str = "<pydml>") -> A.DMLProgram:
    return PyDMLParser(src, name).parse_program()


def parse_pydml_file(path: str) -> A.DMLProgram:
    with open(path) as f:
        return parse_pydml(f.read(), name=path)
