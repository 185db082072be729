# Copy of systemml_tpu/lang/validate.py for the PyTorch port: the same code,
# with its imports pointed at systemml_tpu_torch, and without the Python-UDF
# lookup (UDFs wait); its builtin names include the port's waiting ones.
"""Dedicated validation pass: scope, function, and arity checking with
source positions, run BEFORE HOP construction.

TPU-native equivalent of the reference's validate phase
(parser/StatementBlock.validate + DMLTranslator.validateParseTree,
parser/DMLTranslator.java:108): user errors — undefined variables,
unknown functions, wrong arities, bad assignment targets — surface as
one pass of positioned DMLValidationErrors instead of failing later
inside hop evaluation with no line information.

Scope rules are deliberately permissive where DML programs are dynamic
(matching reference behavior validated against the 600-script corpus):
a variable assigned in EITHER branch of an `if` counts as defined after
it, loop bodies see names assigned anywhere in the same body (defined by
a previous iteration), and `$param` reads are legal without a binding
(the runtime's ifdef contract governs those).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from systemml_tpu_torch.lang import ast as A


class ValidationMessage:
    def __init__(self, pos: A.SourcePos, msg: str):
        self.pos = pos
        self.msg = msg

    def __str__(self):
        return f"{self.pos}: {self.msg}"


def _builtin_names() -> Set[str]:
    """The full builtin surface, collected from the lowering registry and
    the builder's first-class tables so this pass never drifts from what
    actually executes."""
    from systemml_tpu_torch.compiler import lower
    from systemml_tpu_torch.hops import builder

    names = set(lower._BUILTINS)
    names |= set(builder._AGG1) | set(builder._UNARY) | set(builder._CUM)
    names |= {"t", "rev", "diag", "nrow", "ncol", "length", "cbind",
              "rbind", "append", "exists", "min", "max", "log", "ifdef",
              "attention", "seq", "eval"}
    names |= set(builder._SCALAR_BUILTINS)
    return names


def validate_program(prog: A.DMLProgram,
                     input_names: Sequence[str] = (),
                     raise_on_error: bool = True
                     ) -> List[ValidationMessage]:
    v = _Validator(prog)
    for fd in prog.functions.values():
        v.check_function(fd)
    v.check_body(prog.statements,
                 set(input_names) | {"TRUE", "FALSE", "NaN",
                                     "Inf", "pi"})
    if v.errors and raise_on_error:
        from systemml_tpu_torch.hops.builder import DMLValidationError

        head = "\n".join(str(e) for e in v.errors[:10])
        more = f"\n... and {len(v.errors) - 10} more" \
            if len(v.errors) > 10 else ""
        raise DMLValidationError(
            f"{len(v.errors)} validation error(s):\n{head}{more}")
    return v.errors


class _Validator:
    def __init__(self, prog: A.DMLProgram):
        self.prog = prog
        self.errors: List[ValidationMessage] = []
        self.builtins = _builtin_names()
        # user functions by (namespace-or-None, name)
        self.fn_names: Set[str] = {name for (_ns, name) in prog.functions}
        self.namespaces: Set[str] = set(prog.imports)

    def err(self, pos: A.SourcePos, msg: str):
        self.errors.append(ValidationMessage(pos, msg))

    # ---- statements ------------------------------------------------------

    def check_function(self, fd: A.FunctionDef):
        if fd.external:
            return  # dispatches to the Python UDF registry at runtime
        defined = {a.name for a in fd.inputs}
        defined |= {"TRUE", "FALSE", "NaN", "Inf", "pi"}
        out = self.check_body(fd.body, defined)
        for o in fd.outputs:
            if o.name not in out:
                self.err(fd.pos, f"function {fd.name!r} never assigns "
                                 f"output {o.name!r}")

    def check_body(self, stmts: List[A.Stmt],
                   defined: Set[str]) -> Set[str]:
        defined = set(defined)
        for s in stmts:
            self.check_stmt(s, defined)
        return defined

    def check_stmt(self, s: A.Stmt, defined: Set[str]):
        if isinstance(s, A.IfdefAssignment):
            if not isinstance(s.arg, A.CommandLineArg):
                self.err(s.pos, "ifdef() requires a $-parameter")
            self.check_expr(s.default, defined)
            self._define_target(s.target, defined, s.pos)
        elif isinstance(s, A.Assignment):
            self.check_expr(s.source, defined)
            if isinstance(s.target, A.Indexed):
                # left-indexing reads the target first
                self.check_expr(s.target, defined)
            elif s.accumulate and isinstance(s.target, A.Identifier) \
                    and s.target.name not in defined:
                self.err(s.pos, f"'{s.target.name} += ...' reads "
                                f"{s.target.name!r} before assignment")
            self._define_target(s.target, defined, s.pos)
        elif isinstance(s, A.MultiAssignment):
            self.check_expr(s.call, defined)
            fd = self._resolve_fn(s.call)
            if fd is not None and len(fd.outputs) != len(s.targets):
                self.err(s.pos, f"[{len(s.targets)} targets] = "
                                f"{s.call.name}(...) but the function "
                                f"declares {len(fd.outputs)} outputs")
            for t in s.targets:
                self._define_target(t, defined, s.pos)
        elif isinstance(s, A.ExprStatement):
            self.check_expr(s.expr, defined)
        elif isinstance(s, A.IfStatement):
            self.check_expr(s.predicate, defined)
            d1 = self.check_body(s.if_body, defined)
            d2 = self.check_body(s.else_body, defined)
            defined |= d1 | d2  # either branch may define (reference scope)
        elif isinstance(s, A.WhileStatement):
            self.check_expr(s.predicate, defined)
            # names assigned anywhere in the body may flow from a previous
            # iteration; seed them before checking reads
            defined |= self.check_body(
                s.body, defined | _assigned_names(s.body))
        elif isinstance(s, A.ParForStatement):
            self._check_loop(s, defined)
        elif isinstance(s, A.ForStatement):
            self._check_loop(s, defined)
        elif isinstance(s, (A.ImportStatement, A.PathStatement,
                            A.FunctionDef)):
            pass

    def _check_loop(self, s: A.ForStatement, defined: Set[str]):
        for e in (s.from_expr, s.to_expr, s.incr_expr):
            if e is not None:
                self.check_expr(e, defined)
        for pv in s.params.values():
            self.check_expr(pv, defined)
        defined.add(s.var)
        defined |= self.check_body(s.body,
                                   defined | _assigned_names(s.body))

    def _define_target(self, t: A.Expr, defined: Set[str],
                       pos: A.SourcePos):
        if isinstance(t, A.Identifier):
            defined.add(t.name)
        elif isinstance(t, A.Indexed):
            if isinstance(t.target, A.Identifier):
                defined.add(t.target.name)
            else:
                self.err(pos, "left-indexing target must be a variable")
        else:
            self.err(pos, "invalid assignment target")

    # ---- expressions -----------------------------------------------------

    def check_expr(self, e: A.Expr, defined: Set[str]):
        if isinstance(e, A.Identifier):
            if e.name not in defined:
                self.err(e.pos, f"undefined variable {e.name!r}")
        elif isinstance(e, A.FunctionCall):
            self._check_call(e, defined)
        elif isinstance(e, A.Indexed):
            self.check_expr(e.target, defined)
            for part in (e.row_lower, e.row_upper, e.col_lower,
                         e.col_upper):
                if part is not None:
                    self.check_expr(part, defined)
        elif isinstance(e, A.BinaryOp):
            self.check_expr(e.left, defined)
            self.check_expr(e.right, defined)
        elif isinstance(e, A.UnaryOp):
            self.check_expr(e.operand, defined)
        elif isinstance(e, A.ExprList):
            for item in e.items:
                self.check_expr(item, defined)
        # literals / $args: nothing to check ($ bindings are runtime ifdef)

    def _resolve_fn(self, call: A.FunctionCall) -> Optional[A.FunctionDef]:
        return self.prog.get_function(call.name, call.namespace)

    def _check_call(self, e: A.FunctionCall, defined: Set[str]):
        for _n, arg in e.args:
            self.check_expr(arg, defined)
        if e.namespace is not None:
            if e.namespace not in self.namespaces:
                self.err(e.pos, f"unknown namespace {e.namespace!r} "
                                f"(missing source(...) as {e.namespace})")
                return
            fd = self._resolve_fn(e)
            if fd is None:
                self.err(e.pos, f"function {e.namespace}::{e.name} "
                                f"not found")
            else:
                self._check_arity(e, fd)
            return
        fd = self._resolve_fn(e)
        if fd is not None:
            self._check_arity(e, fd)
            return
        if e.name not in self.builtins and e.name not in self.fn_names:
            # registered Python UDFs are callable by bare name
            from systemml_tpu_torch.api.udf import lookup_udf

            if lookup_udf(e.name) is None:
                self.err(e.pos, f"unknown function {e.name!r}")

    def _check_arity(self, e: A.FunctionCall, fd: A.FunctionDef):
        if fd.external:
            return
        declared = {a.name for a in fd.inputs}
        required = [a.name for a in fd.inputs if a.default is None]
        n_pos = sum(1 for n, _ in e.args if n is None)
        if n_pos > len(fd.inputs):
            self.err(e.pos, f"{fd.name}() takes at most {len(fd.inputs)} "
                            f"arguments ({n_pos} given)")
            return
        named = [n for n, _ in e.args if n is not None]
        for n in named:
            if n not in declared:
                self.err(e.pos, f"{fd.name}() has no parameter {n!r}")
        covered = set([a.name for a in fd.inputs[:n_pos]]) | set(named)
        for r in required:
            if r not in covered:
                self.err(e.pos, f"{fd.name}() missing required "
                                f"argument {r!r}")


def _assigned_names(stmts: List[A.Stmt]) -> Set[str]:
    """Every name any statement in this body (recursively) assigns."""
    out: Set[str] = set()
    for s in A.walk_stmts(stmts):
        targets: List[A.Expr] = []
        if isinstance(s, (A.Assignment, A.IfdefAssignment)):
            targets = [s.target]
        elif isinstance(s, A.MultiAssignment):
            targets = list(s.targets)
        elif isinstance(s, A.ForStatement):
            out.add(s.var)
        for t in targets:
            if isinstance(t, A.Identifier):
                out.add(t.name)
            elif isinstance(t, A.Indexed) and \
                    isinstance(t.target, A.Identifier):
                out.add(t.target.name)
    return out
