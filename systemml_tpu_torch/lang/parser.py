# Copy of systemml_tpu/lang/parser.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""DML recursive-descent parser.

Implements the reference grammar (parser/dml/Dml.g4) directly, including its
operator-precedence ordering (Dml.g4:123-176; tightest to loosest):

    ^ (right-assoc)  >  unary +/-  >  %*%  >  %% %/%  >  * /  >  + -
    >  relational  >  !  >  & &&  >  | ||

and the statement surface (Dml.g4:46-105): source/setwd, (multi-)assignment
with `=`/`<-`/`+=`, ifdef-assignment, if/while/for/parfor, and function
definitions with typed inputs/outputs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from systemml_tpu_torch.lang import ast as A
from systemml_tpu_torch.lang.lexer import (
    CLARG, DOUBLE, EOF, ID, INT, KEYWORD, OP, STRING,
    DMLSyntaxError, Token, tokenize,
)

VALUE_TYPE_NAMES = {
    "int": A.ValueType.INT, "integer": A.ValueType.INT,
    "Int": A.ValueType.INT, "Integer": A.ValueType.INT,
    "double": A.ValueType.DOUBLE, "Double": A.ValueType.DOUBLE,
    "string": A.ValueType.STRING, "String": A.ValueType.STRING,
    "boolean": A.ValueType.BOOLEAN, "Boolean": A.ValueType.BOOLEAN,
    "unknown": A.ValueType.UNKNOWN, "Unknown": A.ValueType.UNKNOWN,
}

DATA_TYPE_NAMES = {
    "matrix": A.DataType.MATRIX, "Matrix": A.DataType.MATRIX,
    "frame": A.DataType.FRAME, "Frame": A.DataType.FRAME,
    "list": A.DataType.LIST, "List": A.DataType.LIST,
}


class Parser:
    def __init__(self, source: str, source_name: str = "<script>"):
        self.toks = tokenize(source, source_name)
        self.k = 0
        self.name = source_name

    # ---- token helpers ----------------------------------------------------

    def _peek(self, off: int = 0) -> Token:
        j = min(self.k + off, len(self.toks) - 1)
        return self.toks[j]

    def _at(self, kind: str, text: Optional[str] = None, off: int = 0) -> bool:
        t = self._peek(off)
        return t.kind == kind and (text is None or t.text == text)

    def _accept(self, kind: str, text: Optional[str] = None) -> Optional[Token]:
        if self._at(kind, text):
            t = self.toks[self.k]
            self.k += 1
            return t
        return None

    def _expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self._accept(kind, text)
        if t is None:
            got = self._peek()
            want = text or kind
            raise DMLSyntaxError(
                f"expected {want!r} but found {got.text or got.kind!r}",
                got.pos, self.name)
        return t

    def _skip_semis(self):
        while self._accept(OP, ";"):
            pass

    # ---- program ----------------------------------------------------------

    def parse_program(self) -> A.DMLProgram:
        prog = A.DMLProgram()
        while not self._at(EOF):
            self._skip_semis()
            if self._at(EOF):
                break
            if self._is_function_def():
                fn = self._function_def()
                key = (A.DEFAULT_NAMESPACE, fn.name)
                if key in prog.functions:
                    # reference: 'Function Name Conflict' (DmlPreprocessor)
                    raise DMLSyntaxError(
                        f"function {fn.name!r} is already defined", fn.pos, self.name)
                prog.functions[key] = fn
            else:
                prog.statements.append(self._statement())
            self._skip_semis()
        return prog

    def _is_function_def(self) -> bool:
        return (self._at(ID) and
                (self._at(OP, "=", 1) or self._at(OP, "<-", 1)) and
                (self._at(KEYWORD, "function", 2) or self._at(KEYWORD, "externalFunction", 2)))

    # ---- statements -------------------------------------------------------

    def _statement(self) -> A.Stmt:
        t = self._peek()
        if t.kind == KEYWORD:
            if t.text == "source":
                return self._import_stmt()
            if t.text == "setwd":
                return self._setwd_stmt()
            if t.text == "if":
                return self._if_stmt()
            if t.text == "while":
                return self._while_stmt()
            if t.text in ("for", "parfor"):
                return self._for_stmt()
        if t.kind == OP and t.text == "[":
            return self._multi_assignment()
        if t.kind in (ID, CLARG):
            return self._assignment_or_call()
        raise DMLSyntaxError(f"unexpected token {t.text or t.kind!r}", t.pos, self.name)

    def _import_stmt(self) -> A.ImportStatement:
        pos = self._expect(KEYWORD, "source").pos
        self._expect(OP, "(")
        path = self._expect(STRING).value
        self._expect(OP, ")")
        self._expect(KEYWORD, "as")
        ns = self._expect(ID).text
        return A.ImportStatement(path=path, namespace=ns, pos=pos)

    def _setwd_stmt(self) -> A.PathStatement:
        pos = self._expect(KEYWORD, "setwd").pos
        self._expect(OP, "(")
        path = self._expect(STRING).value
        self._expect(OP, ")")
        return A.PathStatement(path=path, pos=pos)

    def _block_body(self) -> List[A.Stmt]:
        body: List[A.Stmt] = []
        if self._accept(OP, "{"):
            self._skip_semis()
            while not self._accept(OP, "}"):
                body.append(self._statement())
                self._skip_semis()
        else:
            body.append(self._statement())
            self._skip_semis()
        return body

    def _if_stmt(self) -> A.IfStatement:
        pos = self._expect(KEYWORD, "if").pos
        self._expect(OP, "(")
        pred = self.parse_expression()
        self._expect(OP, ")")
        if_body = self._block_body()
        else_body: List[A.Stmt] = []
        if self._accept(KEYWORD, "else"):
            else_body = self._block_body()
        return A.IfStatement(predicate=pred, if_body=if_body, else_body=else_body, pos=pos)

    def _while_stmt(self) -> A.WhileStatement:
        pos = self._expect(KEYWORD, "while").pos
        self._expect(OP, "(")
        pred = self.parse_expression()
        self._expect(OP, ")")
        body = self._block_body()
        return A.WhileStatement(predicate=pred, body=body, pos=pos)

    def _for_stmt(self) -> A.ForStatement:
        kw = self.toks[self.k]
        self.k += 1
        is_parfor = kw.text == "parfor"
        self._expect(OP, "(")
        var = self._expect(ID).text
        self._expect(KEYWORD, "in")
        from_e, to_e, incr_e = self._iterable_predicate()
        params: Dict[str, A.Expr] = {}
        while self._accept(OP, ","):
            pname = self._expect(ID).text
            self._expect(OP, "=")
            params[pname] = self.parse_expression()
        self._expect(OP, ")")
        body = self._block_body()
        cls = A.ParForStatement if is_parfor else A.ForStatement
        return cls(var=var, from_expr=from_e, to_expr=to_e, incr_expr=incr_e,
                   body=body, params=params, pos=kw.pos)

    def _iterable_predicate(self) -> Tuple[A.Expr, A.Expr, Optional[A.Expr]]:
        """from:to | seq(from, to[, incr])  (Dml.g4:85-92)"""
        e = self.parse_expression()
        if self._accept(OP, ":"):
            return e, self.parse_expression(), None
        if isinstance(e, A.FunctionCall) and e.name == "seq" and e.namespace is None:
            args = [v for (n, v) in e.args if n is None]
            if len(args) in (2, 3):
                return args[0], args[1], (args[2] if len(args) == 3 else None)
        raise DMLSyntaxError("expected iterable predicate 'from:to' or 'seq(from,to,incr)'",
                             e.pos, self.name)

    def _multi_assignment(self) -> A.MultiAssignment:
        pos = self._expect(OP, "[").pos
        targets = [self._data_identifier()]
        while self._accept(OP, ","):
            targets.append(self._data_identifier())
        self._expect(OP, "]")
        if not (self._accept(OP, "=") or self._accept(OP, "<-")):
            raise DMLSyntaxError("expected '=' in multi-assignment", pos, self.name)
        call = self.parse_expression()
        if not isinstance(call, A.FunctionCall):
            raise DMLSyntaxError("multi-assignment source must be a function call",
                                 pos, self.name)
        return A.MultiAssignment(targets=targets, call=call, pos=pos)

    def _assignment_or_call(self) -> A.Stmt:
        pos = self._peek().pos
        # bare call statement: ID '(' with no assignment operator following
        target = self._data_identifier()
        if isinstance(target, A.Identifier) and self._at(OP, "("):
            call = self._call_tail(target.name, pos)
            return A.ExprStatement(expr=call, pos=pos)
        op = self._accept(OP, "=") or self._accept(OP, "<-") or self._accept(OP, "+=")
        if op is None:
            got = self._peek()
            raise DMLSyntaxError("expected assignment operator", got.pos, self.name)
        if self._at(KEYWORD, "ifdef"):
            self._expect(KEYWORD, "ifdef")
            self._expect(OP, "(")
            arg = self.parse_expression()
            self._expect(OP, ",")
            default = self.parse_expression()
            self._expect(OP, ")")
            return A.IfdefAssignment(target=target, arg=arg, default=default, pos=pos)
        source = self.parse_expression()
        return A.Assignment(target=target, source=source,
                            accumulate=(op.text == "+="), pos=pos)

    def _function_def(self) -> A.FunctionDef:
        name_tok = self._expect(ID)
        if not (self._accept(OP, "=") or self._accept(OP, "<-")):
            raise DMLSyntaxError("expected '=' in function definition",
                                 name_tok.pos, self.name)
        external = self._accept(KEYWORD, "externalFunction")
        if not external:
            self._expect(KEYWORD, "function")
        self._expect(OP, "(")
        inputs: List[A.TypedArg] = []
        while not self._at(OP, ")"):
            inputs.append(self._typed_arg())
            if not self._accept(OP, ","):
                break
        self._expect(OP, ")")
        outputs: List[A.TypedArg] = []
        if self._accept(KEYWORD, "return"):
            self._expect(OP, "(")
            while not self._at(OP, ")"):
                outputs.append(self._typed_arg())
                if not self._accept(OP, ","):
                    break
            self._expect(OP, ")")
        if external:
            # externalFunction ... implemented in (classname=...) — parsed but
            # rejected at validation (Java UDF mechanism is JVM-specific;
            # our UDF framework registers Python callables instead).
            self._expect(KEYWORD, "implemented")
            self._expect(KEYWORD, "in")
            self._expect(OP, "(")
            while not self._at(OP, ")"):
                self._expect(ID)
                self._expect(OP, "=")
                self._expect(STRING)
                if not self._accept(OP, ","):
                    break
            self._expect(OP, ")")
            return A.FunctionDef(name=name_tok.text, inputs=inputs, outputs=outputs,
                                 body=[], external=True, pos=name_tok.pos)
        self._expect(OP, "{")
        body: List[A.Stmt] = []
        self._skip_semis()
        while not self._accept(OP, "}"):
            body.append(self._statement())
            self._skip_semis()
        return A.FunctionDef(name=name_tok.text, inputs=inputs, outputs=outputs,
                             body=body, pos=name_tok.pos)

    def _typed_arg(self) -> A.TypedArg:
        t = self._expect(ID)
        if t.text in VALUE_TYPE_NAMES and not self._at(OP, "["):
            dt, vt = A.DataType.SCALAR, VALUE_TYPE_NAMES[t.text]
        else:
            if t.text not in DATA_TYPE_NAMES:
                raise DMLSyntaxError(f"unknown type {t.text!r}", t.pos, self.name)
            dt = DATA_TYPE_NAMES[t.text]
            self._expect(OP, "[")
            vt_tok = self._expect(ID)
            if vt_tok.text not in VALUE_TYPE_NAMES:
                raise DMLSyntaxError(f"unknown value type {vt_tok.text!r}",
                                     vt_tok.pos, self.name)
            vt = VALUE_TYPE_NAMES[vt_tok.text]
            self._expect(OP, "]")
        name = self._expect(ID).text
        default = None
        if self._accept(OP, "="):  # default value (extension; callers may omit)
            default = self.parse_expression()
        return A.TypedArg(data_type=dt, value_type=vt, name=name, default=default)

    # ---- data identifiers -------------------------------------------------

    def _data_identifier(self) -> A.Expr:
        t = self._peek()
        if t.kind == CLARG:
            self.k += 1
            return A.CommandLineArg(name=t.text, pos=t.pos)
        name_tok = self._expect(ID)
        ident = A.Identifier(name=name_tok.text, pos=name_tok.pos)
        if self._at(OP, "[") and not self._peek().nl_before:
            return self._index_tail(ident)
        return ident

    def _index_tail(self, target: A.Expr) -> A.Indexed:
        pos = self._expect(OP, "[").pos
        rl = ru = cl = cu = None
        row_single = col_single = False
        ndims = 2
        if not self._at(OP, "]") and not self._at(OP, ","):
            rl = self.parse_expression()
            if self._accept(OP, ":"):
                ru = self.parse_expression()
            else:
                row_single = True
        if self._accept(OP, ","):
            if not self._at(OP, "]"):
                cl = self.parse_expression()
                if self._accept(OP, ":"):
                    cu = self.parse_expression()
                else:
                    col_single = True
        else:
            ndims = 1
        self._expect(OP, "]")
        return A.Indexed(target=target, row_lower=rl, row_upper=ru,
                         col_lower=cl, col_upper=cu, row_single=row_single,
                         col_single=col_single, ndims=ndims, pos=pos)

    # ---- expressions ------------------------------------------------------

    def parse_expression(self) -> A.Expr:
        return self._or_expr()

    def _or_expr(self) -> A.Expr:
        left = self._and_expr()
        while self._at(OP, "|") or self._at(OP, "||"):
            tok = self.toks[self.k]
            self.k += 1
            right = self._and_expr()
            left = A.BinaryOp(op="|", left=left, right=right, pos=tok.pos)
        return left

    def _and_expr(self) -> A.Expr:
        left = self._not_expr()
        while self._at(OP, "&") or self._at(OP, "&&"):
            tok = self.toks[self.k]
            self.k += 1
            right = self._not_expr()
            left = A.BinaryOp(op="&", left=left, right=right, pos=tok.pos)
        return left

    def _not_expr(self) -> A.Expr:
        if self._at(OP, "!"):
            tok = self.toks[self.k]
            self.k += 1
            return A.UnaryOp(op="!", operand=self._not_expr(), pos=tok.pos)
        return self._relational_expr()

    _REL_OPS = (">", ">=", "<", "<=", "==", "!=")

    def _relational_expr(self) -> A.Expr:
        left = self._addsub_expr()
        while self._peek().kind == OP and self._peek().text in self._REL_OPS:
            tok = self.toks[self.k]
            self.k += 1
            right = self._addsub_expr()
            left = A.BinaryOp(op=tok.text, left=left, right=right, pos=tok.pos)
        return left

    def _addsub_expr(self) -> A.Expr:
        left = self._muldiv_expr()
        while self._at(OP, "+") or self._at(OP, "-"):
            tok = self.toks[self.k]
            self.k += 1
            right = self._muldiv_expr()
            left = A.BinaryOp(op=tok.text, left=left, right=right, pos=tok.pos)
        return left

    def _muldiv_expr(self) -> A.Expr:
        left = self._modintdiv_expr()
        while self._at(OP, "*") or self._at(OP, "/"):
            tok = self.toks[self.k]
            self.k += 1
            right = self._modintdiv_expr()
            left = A.BinaryOp(op=tok.text, left=left, right=right, pos=tok.pos)
        return left

    def _modintdiv_expr(self) -> A.Expr:
        left = self._matmul_expr()
        while self._at(OP, "%%") or self._at(OP, "%/%"):
            tok = self.toks[self.k]
            self.k += 1
            right = self._matmul_expr()
            left = A.BinaryOp(op=tok.text, left=left, right=right, pos=tok.pos)
        return left

    def _matmul_expr(self) -> A.Expr:
        left = self._unary_expr()
        while self._at(OP, "%*%"):
            tok = self.toks[self.k]
            self.k += 1
            right = self._unary_expr()
            left = A.BinaryOp(op="%*%", left=left, right=right, pos=tok.pos)
        return left

    def _unary_expr(self) -> A.Expr:
        if self._at(OP, "-") or self._at(OP, "+"):
            tok = self.toks[self.k]
            self.k += 1
            operand = self._unary_expr()
            if tok.text == "+":
                return operand
            return A.UnaryOp(op="-", operand=operand, pos=tok.pos)
        return self._power_expr()

    def _power_expr(self) -> A.Expr:
        base = self._primary_expr()
        if self._at(OP, "^"):
            tok = self.toks[self.k]
            self.k += 1
            # right-assoc; allow unary sign on the exponent (2^-3)
            right = self._unary_expr()
            return A.BinaryOp(op="^", left=base, right=right, pos=tok.pos)
        return base

    def _primary_expr(self) -> A.Expr:
        t = self._peek()
        if t.kind == INT:
            self.k += 1
            return A.IntLiteral(value=t.value, pos=t.pos)
        if t.kind == DOUBLE:
            self.k += 1
            return A.FloatLiteral(value=t.value, pos=t.pos)
        if t.kind == STRING:
            self.k += 1
            return A.StringLiteral(value=t.value, pos=t.pos)
        if t.kind == KEYWORD and t.text in ("TRUE", "FALSE"):
            self.k += 1
            return A.BoolLiteral(value=(t.text == "TRUE"), pos=t.pos)
        if t.kind == CLARG:
            self.k += 1
            return A.CommandLineArg(name=t.text, pos=t.pos)
        if t.kind == OP and t.text == "(":
            self.k += 1
            e = self.parse_expression()
            self._expect(OP, ")")
            # NOTE: no index-tail here — the grammar roots indexing at a bare
            # ID only (Dml.g4:117); consuming '[' after ')' would swallow a
            # following '[a,b] = f()' multi-assignment statement.
            return e
        if t.kind == OP and t.text == "[":
            self.k += 1
            items = [self.parse_expression()]
            while self._accept(OP, ","):
                items.append(self.parse_expression())
            self._expect(OP, "]")
            return A.ExprList(items=items, pos=t.pos)
        if t.kind == ID:
            self.k += 1
            if self._at(OP, "("):
                return self._call_tail(t.text, t.pos)
            ident = A.Identifier(name=t.text, pos=t.pos)
            # '[' on a NEW line starts a multi-assignment statement, not an
            # index (see Token.nl_before)
            if self._at(OP, "[") and not self._peek().nl_before:
                return self._index_tail(ident)
            return ident
        raise DMLSyntaxError(f"unexpected token {t.text or t.kind!r} in expression",
                             t.pos, self.name)

    def _call_tail(self, name: str, pos) -> A.FunctionCall:
        namespace = None
        if "::" in name:
            namespace, name = name.split("::", 1)
        self._expect(OP, "(")
        args: List[Tuple[Optional[str], A.Expr]] = []
        while not self._at(OP, ")"):
            pname = None
            if (self._at(ID) and self._at(OP, "=", 1)):
                pname = self._expect(ID).text
                self._expect(OP, "=")
            args.append((pname, self.parse_expression()))
            if not self._accept(OP, ","):
                break
        self._expect(OP, ")")
        return A.FunctionCall(name=name, args=args, namespace=namespace, pos=pos)


def parse(source: str, source_name: str = "<script>") -> A.DMLProgram:
    """Parse DML source text into a DMLProgram (imports unresolved)."""
    return Parser(source, source_name).parse_program()


def parse_file(path: str, _seen: Optional[dict] = None,
               root_dir: Optional[str] = None) -> A.DMLProgram:
    """Parse a DML file and recursively resolve source(...) imports relative
    to the importing file's directory, falling back to the root script's
    directory (reference: parser/ParserWrapper.java + ImportStatement
    handling in DmlSyntacticValidator; the fallback matches the reference's
    convention of script-library paths like "nn/layers/affine.dml" being
    resolved against the scripts root from any importing file)."""
    path = os.path.abspath(path)
    _seen = _seen if _seen is not None else {}
    if path in _seen:
        return _seen[path]
    with open(path) as f:
        src = f.read()
    prog = parse(src, source_name=path)
    _seen[path] = prog
    resolve_imports(prog, os.path.dirname(path), _seen,
                    root_dir if root_dir is not None else os.path.dirname(path))
    return prog


def resolve_imports(prog: A.DMLProgram, base_dir: str,
                    _seen: Optional[dict] = None,
                    root_dir: Optional[str] = None):
    """Load each `source(path) as ns` target into prog.imports[ns]."""
    root_dir = root_dir if root_dir is not None else base_dir
    for stmt in list(prog.statements):
        if isinstance(stmt, A.ImportStatement):
            p = stmt.path
            if not p.endswith(".dml"):
                p = p + ".dml"
            if not os.path.isabs(p):
                # resolution order: importing file's dir, the root script's
                # dir, then ancestors of the importing file's dir — so
                # scripts-root-relative paths like "nn/layers/affine.dml"
                # work from any file under the scripts tree, matching the
                # reference's convention.
                cands = [os.path.join(base_dir, p), os.path.join(root_dir, p)]
                anc = base_dir
                for _ in range(6):
                    anc = os.path.dirname(anc)
                    if not anc or anc == os.path.sep:
                        break
                    cands.append(os.path.join(anc, p))
                p = next((c for c in cands if os.path.exists(c)), cands[0])
            sub = parse_file(p, _seen, root_dir)
            prev = prog.imports.get(stmt.namespace)
            if prev is not None and prev is not sub:
                # reference: 'Namespace Conflict' (CommonSyntacticValidator)
                raise DMLSyntaxError(
                    f"namespace {stmt.namespace!r} is bound to multiple files",
                    stmt.pos)
            prog.imports[stmt.namespace] = sub
    # nested imports of imported files are resolved by parse_file recursion
