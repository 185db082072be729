# Copy of systemml_tpu/hops/builder.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""AST -> HOP DAG construction.

TPU-native equivalent of the reference's DMLTranslator.constructHops
(parser/DMLTranslator.java:235: one DAG per statement block, treads for
live-ins, twrites for updated variables) plus the builtin-to-HOP mapping in
Expression/BuiltinFunctionExpression.

Rewrite-relevant ops get first-class opcodes (b(+), ba+*, ua(sum,all),
reorg(t), idx, ...); the long tail of builtins becomes generic `call:NAME`
hops whose evaluation lives in compiler/lower.py's builtin table.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from systemml_tpu_torch.lang import ast as A
from systemml_tpu_torch.hops.hop import Hop, lit, tread

# full aggregates and their row/col variants -> (op, direction)
_AGG1 = {
    "sum": ("sum", "all"), "mean": ("mean", "all"), "avg": ("mean", "all"),
    "min": ("min", "all"), "max": ("max", "all"), "prod": ("prod", "all"),
    "var": ("var", "all"), "sd": ("sd", "all"),
    "rowSums": ("sum", "row"), "rowMeans": ("mean", "row"),
    "rowMins": ("min", "row"), "rowMaxs": ("max", "row"),
    "rowVars": ("var", "row"), "rowSds": ("sd", "row"),
    "rowProds": ("prod", "row"),
    "colSums": ("sum", "col"), "colMeans": ("mean", "col"),
    "colMins": ("min", "col"), "colMaxs": ("max", "col"),
    "colVars": ("var", "col"), "colSds": ("sd", "col"),
    "colProds": ("prod", "col"),
    "rowIndexMax": ("indexmax", "row"), "rowIndexMin": ("indexmin", "row"),
}

_UNARY = {
    "abs", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "sqrt", "exp", "floor", "ceiling", "ceil", "round", "sign",
    "sigmoid", "sprop", "gamma", "lgamma", "digamma", "trigamma",
    "isNA", "isNaN", "isInf",
}

_CUM = {"cumsum", "cumprod", "cummin", "cummax"}

# builtin constants (reference: parser/BuiltinConstant.java)
import math as _math  # noqa: E402

_CONSTANTS = {"pi": _math.pi, "Inf": float("inf"), "NaN": float("nan")}


class BlockHops:
    """The compiled form of one basic block."""

    def __init__(self):
        self.writes: Dict[str, Hop] = {}   # var -> value hop
        self.sinks: List[Hop] = []         # ordered side effects
        self.reads: Set[str] = set()       # live-in variable names

    def roots(self) -> List[Hop]:
        return list(self.writes.values()) + self.sinks


class HopBuilder:
    """Builds HOP DAGs for basic blocks (runs of straight-line statements).

    `clargs` maps $-names to literal values; ifdef / $X references resolve
    at build time (the reference does the same literal replacement during
    validation + recompilation, hops/recompile/LiteralReplacement.java).
    """

    def __init__(self, clargs: Optional[Dict[str, object]] = None,
                 user_functions: Optional[Set[Tuple[Optional[str], str]]] = None):
        self.clargs = clargs or {}
        self.user_functions = user_functions or set()
        # cross-block scalar constants, maintained by ProgramCompiler
        # (invalidated at control-flow joins / loop back edges)
        self.consts: Dict[str, object] = {}

    # ---- public ----------------------------------------------------------

    def build_block(self, stmts: List[A.Stmt]) -> BlockHops:
        blk = BlockHops()
        env: Dict[str, Hop] = {}
        for s in stmts:
            self._stmt(s, env, blk)
        blk.writes = {k: v for k, v in env.items()}
        return blk

    def build_predicate(self, e: A.Expr) -> Tuple[Hop, Set[str]]:
        blk = BlockHops()
        env: Dict[str, Hop] = {}
        h = self._expr(e, env, blk)
        return h, blk.reads

    # ---- statements ------------------------------------------------------

    def _stmt(self, s: A.Stmt, env: Dict[str, Hop], blk: BlockHops):
        if isinstance(s, A.Assignment):
            src = self._expr(s.source, env, blk)
            if isinstance(s.target, A.Identifier):
                if s.accumulate:
                    cur = self._var(s.target.name, env, blk)
                    src = Hop("b(+)", [cur, src], {"op": "+"})
                env[s.target.name] = src
            elif isinstance(s.target, A.Indexed):
                env[self._target_name(s.target)] = self._left_index(
                    s.target, src, env, blk, accumulate=s.accumulate)
            else:
                raise DMLValidationError(f"invalid assignment target at {s.pos}")
        elif isinstance(s, A.IfdefAssignment):
            if not isinstance(s.arg, A.CommandLineArg):
                raise DMLValidationError(f"ifdef() requires a $-parameter at {s.pos}")
            if s.arg.name in self.clargs:
                val = self.clargs[s.arg.name]
                src = lit(val)
            else:
                src = self._expr(s.default, env, blk)
            env[self._target_name(s.target)] = src
        elif isinstance(s, A.MultiAssignment):
            call = self._expr(s.call, env, blk)
            call.params["n_outputs"] = len(s.targets)
            for i, t in enumerate(s.targets):
                pick = Hop("pick", [call], {"index": i})
                env[self._target_name(t)] = pick
        elif isinstance(s, A.ExprStatement):
            h = self._expr(s.expr, env, blk)
            blk.sinks.append(h)
        else:
            raise DMLValidationError(
                f"control-flow statement inside basic block at {s.pos}")

    def _target_name(self, t: A.Expr) -> str:
        if isinstance(t, A.Identifier):
            return t.name
        if isinstance(t, A.Indexed) and isinstance(t.target, A.Identifier):
            return t.target.name
        raise DMLValidationError("invalid assignment target")

    def _left_index(self, t: A.Indexed, src: Hop, env, blk,
                    accumulate: bool = False) -> Hop:
        x = self._var(t.target.name, env, blk)
        rl, ru, cl, cu = self._bounds(t, x, env, blk)
        if accumulate:
            cur = Hop("idx", [x, rl, ru, cl, cu])
            src = Hop("b(+)", [cur, src], {"op": "+"})
        return Hop("lidx", [x, src, rl, ru, cl, cu], dt="matrix")

    def _bounds(self, t: A.Indexed, x: Hop, env, blk):
        rl = self._expr(t.row_lower, env, blk) if t.row_lower else lit(1)
        if t.row_single:
            ru = rl
        elif t.row_upper is not None:
            ru = self._expr(t.row_upper, env, blk)
        else:
            ru = Hop("nrow", [x], dt="scalar")
        cl = self._expr(t.col_lower, env, blk) if t.col_lower else lit(1)
        if t.col_single:
            cu = cl
        elif t.col_upper is not None:
            cu = self._expr(t.col_upper, env, blk)
        else:
            cu = Hop("ncol", [x], dt="scalar")
        return rl, ru, cl, cu

    # ---- expressions -----------------------------------------------------

    def _var(self, name: str, env: Dict[str, Hop], blk: BlockHops) -> Hop:
        if name not in env:
            if name in _CONSTANTS:
                # parse-time builtin-constant substitution (reference:
                # BuiltinConstant.java pi/Inf/NaN, substituted at
                # CommonSyntacticValidator.java:337)
                return lit(_CONSTANTS[name])
            if name in self.consts:
                # cross-block scalar constant propagation: the compiler
                # records literal-valued writes (icpt = ifdef($icpt, 0))
                # and substitutes them into later blocks AND predicates,
                # which is what lets clarg-driven branches fold away
                # (reference: hops/recompile/LiteralReplacement.java +
                # RewriteRemoveUnnecessaryBranches)
                return lit(self.consts[name])
            blk.reads.add(name)
            env[name] = tread(name)
        return env[name]

    def _expr(self, e: A.Expr, env: Dict[str, Hop], blk: BlockHops) -> Hop:
        if isinstance(e, A.IntLiteral):
            return lit(e.value)
        if isinstance(e, A.FloatLiteral):
            return lit(e.value)
        if isinstance(e, A.StringLiteral):
            return lit(e.value)
        if isinstance(e, A.BoolLiteral):
            return lit(e.value)
        if isinstance(e, A.CommandLineArg):
            if e.name not in self.clargs:
                # unbound $-arg: error only if actually evaluated (it may sit
                # in a branch guarded by ifdef checks, the common pattern)
                return Hop("clarg_unbound", [], {"name": e.name}, dt="scalar")
            return lit(self.clargs[e.name])
        if isinstance(e, A.Identifier):
            return self._var(e.name, env, blk)
        if isinstance(e, A.UnaryOp):
            x = self._expr(e.operand, env, blk)
            if e.op == "-":
                return Hop("u(-)", [x], {"op": "-"}, dt=x.dt)
            return Hop("u(!)", [x], {"op": "!"}, dt=x.dt)
        if isinstance(e, A.BinaryOp):
            left = self._expr(e.left, env, blk)
            right = self._expr(e.right, env, blk)
            if e.op == "%*%":
                return Hop("ba+*", [left, right], dt="matrix")
            dt = "matrix" if (left.dt == "matrix" or right.dt == "matrix") else left.dt
            if e.op == "+" and (left.dt == "string" or right.dt == "string"):
                dt = "string"
            return Hop(f"b({e.op})", [left, right], {"op": e.op}, dt=dt)
        if isinstance(e, A.Indexed):
            if not isinstance(e.target, A.Identifier):
                raise DMLValidationError(f"indexing requires a variable at {e.pos}")
            x = self._var(e.target.name, env, blk)
            if e.ndims == 1:  # list indexing X[i]
                i = self._expr(e.row_lower, env, blk)
                return Hop("call:listidx", [x, i])
            rl, ru, cl, cu = self._bounds(e, x, env, blk)
            scalar_out = e.row_single and e.col_single
            return Hop("idx", [x, rl, ru, cl, cu],
                       {"scalar_safe": scalar_out}, dt="matrix")
        if isinstance(e, A.ExprList):
            items = [self._expr(x, env, blk) for x in e.items]
            return Hop("elist", items, dt="list")
        if isinstance(e, A.FunctionCall):
            return self._call(e, env, blk)
        raise DMLValidationError(f"unsupported expression {type(e).__name__} at {e.pos}")

    def _call(self, e: A.FunctionCall, env, blk) -> Hop:
        name = e.name
        # user-defined function?
        key = (e.namespace, name)
        if e.namespace is not None or key in self.user_functions or \
                (None, name) in self.user_functions:
            args = []
            argnames = []
            for pname, pe in e.args:
                args.append(self._expr(pe, env, blk))
                argnames.append(pname)
            return Hop("fcall", args,
                       {"name": name, "namespace": e.namespace,
                        "argnames": argnames}, dt="unknown")
        # rewrite-relevant builtins get first-class ops
        pos_args = [pe for (pn, pe) in e.args if pn is None]
        if name in _AGG1 and len(pos_args) == len(e.args) == 1:
            op, d = _AGG1[name]
            x = self._expr(pos_args[0], env, blk)
            return Hop(f"ua({op},{d})", [x], {"aop": op, "dir": d},
                       dt="scalar" if d == "all" else "matrix")
        if name in ("min", "max") and len(e.args) >= 2:
            xs = [self._expr(pe, env, blk) for pe in pos_args]
            h = xs[0]
            for x in xs[1:]:
                h = Hop(f"b({name})", [h, x], {"op": name},
                        dt="matrix" if (h.dt == "matrix" or x.dt == "matrix") else "scalar")
            return h
        if name in _UNARY and len(e.args) == 1:
            x = self._expr(pos_args[0], env, blk)
            return Hop(f"u({name})", [x], {"op": name}, dt=x.dt)
        if name == "log":
            x = self._expr(pos_args[0], env, blk)
            if len(pos_args) == 1:
                return Hop("u(log)", [x], {"op": "log"}, dt=x.dt)
            b = self._expr(pos_args[1], env, blk)
            return Hop("call:log", [x, b], {"argnames": [None, None]}, dt=x.dt)
        if name in _CUM and len(e.args) == 1:
            x = self._expr(pos_args[0], env, blk)
            return Hop(f"cum({name})", [x], {"op": name}, dt="matrix")
        if name == "t" and len(e.args) == 1:
            return Hop("reorg(t)", [self._expr(pos_args[0], env, blk)], dt="matrix")
        if name == "rev" and len(e.args) == 1:
            return Hop("reorg(rev)", [self._expr(pos_args[0], env, blk)], dt="matrix")
        if name == "diag" and len(e.args) == 1:
            return Hop("reorg(diag)", [self._expr(pos_args[0], env, blk)], dt="matrix")
        if name == "exists" and len(e.args) == 1 and \
                isinstance(pos_args[0], (A.Identifier, A.StringLiteral)):
            vname = pos_args[0].name if isinstance(pos_args[0], A.Identifier) \
                else pos_args[0].value
            if vname in env:  # assigned earlier in this very block
                return lit(True)
            return Hop("exists_var", [], {"name": vname}, dt="scalar")
        if name in ("nrow", "ncol", "length") and len(e.args) == 1:
            return Hop(name, [self._expr(pos_args[0], env, blk)], dt="scalar")
        if name in ("cbind", "append", "rbind"):
            xs = [self._expr(pe, env, blk) for pe in pos_args]
            return Hop("rbind" if name == "rbind" else "cbind", xs, dt="matrix")
        if name == "attention" and len(pos_args) == 3:
            # scaled dot-product attention over [T, d] matrices — the
            # long-context op family (parallel/ring.py); `causal` must be
            # a literal so the mask shape is trace-static
            qkv = [self._expr(pe, env, blk) for pe in pos_args]
            causal = False
            for pn, pe in e.args:
                if pn == "causal":
                    if not isinstance(pe, A.BoolLiteral):
                        raise DMLValidationError(
                            f"attention(causal=...) must be a TRUE/FALSE "
                            f"literal at {e.pos}")
                    causal = pe.value
                elif pn is not None:
                    # silently dropping a typo'd arg (casual=, scale=)
                    # would change results with no warning
                    raise DMLValidationError(
                        f"attention() has no parameter {pn!r} at {e.pos}")
            return Hop("attention", qkv, {"causal": causal}, dt="matrix")
        if name == "checkpoint":
            # snapshot builtin: implicitly depends on EVERY in-block write
            # so far — wiring them as inputs makes the dataflow order the
            # snapshot after the updates it must capture. Any signature
            # other than one positional path is rejected loudly: a silent
            # generic fallthrough would snapshot STALE pre-block values
            if len(pos_args) != 1 or len(e.args) != 1:
                raise DMLValidationError(
                    f"checkpoint() takes exactly one positional path "
                    f"argument at {e.pos}")
            path_h = self._expr(pos_args[0], env, blk)
            var_names = sorted(env)
            return Hop("call:checkpoint",
                       [path_h] + [env[n] for n in var_names],
                       {"argnames": [None] * (1 + len(var_names)),
                        "var_names": var_names}, dt="none")
        # generic builtin: call:NAME with flattened args + names
        args, argnames = [], []
        for pname, pe in e.args:
            args.append(self._expr(pe, env, blk))
            argnames.append(pname)
        dt = _builtin_result_dt(name)
        return Hop(f"call:{name}", args, {"argnames": argnames}, dt=dt)


_SCALAR_BUILTINS = {
    "as.scalar", "castAsScalar", "as.double", "as.integer", "as.logical",
    "exists", "moment", "cov", "median", "iqm", "trace", "det", "toString",
    "nnz", "sumSq", "checkpointExists",
}


def _builtin_result_dt(name: str) -> str:
    if name in _SCALAR_BUILTINS:
        return "scalar" if name != "toString" else "string"
    if name in ("print", "stop", "assert", "write", "checkpoint", "restore"):
        return "none"
    return "matrix"


class DMLValidationError(Exception):
    pass
