# Copy of systemml_tpu/hops/ipa.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""Inter-procedural analysis (IPA).

TPU-native equivalent of the reference's IPA pass pipeline
(hops/ipa/InterProceduralAnalysis.java:82, FunctionCallGraph.java,
IPAPassInlineFunctions, IPAPassRemoveUnusedFunctions,
IPAPassPropagateReplaceLiterals). Differences by design:

- Passes run at the AST level before HOP construction, because the payoff
  on TPU is different: inlining a leaf function into a basic block lets the
  whole block trace into ONE fused XLA executable (the per-block plan cache
  in runtime/program.py), where the reference inlined mainly to propagate
  sizes into function bodies.
- Size propagation runs at the HOP level (`propagate_sizes`) and feeds the
  memory estimator / exec-type selection (reference:
  Hop.refreshSizeInformation + computeMemEstimate, hops/Hop.java:605).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Set, Tuple

from systemml_tpu_torch.lang import ast as A
from systemml_tpu_torch.hops.hop import Hop

FnKey = Tuple[str, str]  # (namespace, name) within one DMLProgram

_inline_ids = itertools.count(1)

# body-statement budget for inlining (reference inlines "small" functions,
# IPAPassInlineFunctions checks a HOP-count threshold)
INLINE_MAX_STMTS = 16


# --------------------------------------------------------------------------
# Call graph (reference: hops/ipa/FunctionCallGraph.java)
# --------------------------------------------------------------------------

def _programs(prog: A.DMLProgram, seen=None) -> List[A.DMLProgram]:
    seen = seen if seen is not None else set()
    if id(prog) in seen:
        return []
    seen.add(id(prog))
    out = [prog]
    for sub in prog.imports.values():
        out += _programs(sub, seen)
    return out


def _user_fn_names(prog: A.DMLProgram) -> Set[str]:
    return {name for (_ns, name) in prog.functions.keys()}


def _calls_in(stmts: List[A.Stmt], prog: A.DMLProgram):
    """Yield (namespace, name) for every call to a user function within
    `stmts`, resolved against `prog` (the defining file)."""
    local = _user_fn_names(prog)
    for s in A.walk_stmts(stmts):
        for e in _stmt_exprs(s):
            for sub in A.walk_expr(e):
                if isinstance(sub, A.FunctionCall):
                    if sub.namespace is not None:
                        yield (sub.namespace, sub.name)
                    elif sub.name in local:
                        yield (None, sub.name)
                    elif sub.name == "eval":
                        yield ("__eval__", "*")


def _stmt_exprs(s: A.Stmt) -> List[A.Expr]:
    out = []
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if isinstance(v, A.Expr):
            out.append(v)
        elif isinstance(v, list):
            out += [x for x in v if isinstance(x, A.Expr)]
        elif isinstance(v, dict):
            out += [x for x in v.values() if isinstance(x, A.Expr)]
    return out


class FunctionCallGraph:
    """Reachability over (program, fn) nodes starting from main."""

    def __init__(self, prog: A.DMLProgram):
        self.prog = prog
        self.uses_eval = False
        self.reachable: Set[Tuple[int, str]] = set()  # (id(program), fname)
        self._visit_body(prog, prog.statements)

    def _visit_body(self, prog: A.DMLProgram, stmts: List[A.Stmt]):
        for ns, name in _calls_in(stmts, prog):
            if ns == "__eval__":
                self.uses_eval = True
                continue
            target_prog, fd = _resolve(prog, ns, name)
            if fd is None:
                continue
            key = (id(target_prog), name)
            if key in self.reachable:
                continue
            self.reachable.add(key)
            self._visit_body(target_prog, fd.body)


def _resolve(prog: A.DMLProgram, ns: Optional[str], name: str):
    if ns is None:
        for (fns, fname), fd in prog.functions.items():
            if fname == name:
                return prog, fd
        return prog, None
    sub = prog.imports.get(ns)
    if sub is not None:
        for (fns, fname), fd in sub.functions.items():
            if fname == name:
                return sub, fd
    # namespace-qualified function in the same file
    for (fns, fname), fd in prog.functions.items():
        if fname == name and fns == ns:
            return prog, fd
    return prog, None


# --------------------------------------------------------------------------
# Pass: remove unused functions (reference: IPAPassRemoveUnusedFunctions)
# --------------------------------------------------------------------------

def remove_unused_functions(prog: A.DMLProgram) -> int:
    g = FunctionCallGraph(prog)
    if g.uses_eval:
        return 0  # eval() can name any function at runtime; keep all
    removed = 0
    for p in _programs(prog):
        dead = [k for k in p.functions
                if (id(p), k[1]) not in g.reachable]
        for k in dead:
            del p.functions[k]
            removed += 1
    return removed


# --------------------------------------------------------------------------
# Pass: inline leaf functions (reference: IPAPassInlineFunctions)
# --------------------------------------------------------------------------

def _is_inlinable(fd: A.FunctionDef, defining: A.DMLProgram) -> bool:
    if fd.external or len(fd.body) > INLINE_MAX_STMTS:
        return False
    # non-literal defaults would capture caller variables when inlined; the
    # runtime rejects them (program.py _literal_of), so inlining must too
    for p in fd.inputs:
        if p.default is not None and not _is_literal_expr(p.default):
            return False
    local = _user_fn_names(defining)
    for s in fd.body:
        if not isinstance(s, (A.Assignment, A.MultiAssignment,
                              A.IfdefAssignment, A.ExprStatement)):
            return False  # control flow → stays a FunctionBlocks call
        if isinstance(s, A.Assignment) and not isinstance(
                s.target, (A.Identifier, A.Indexed)):
            return False
        for e in _stmt_exprs(s):
            for sub in A.walk_expr(e):
                # leaf functions only: a nested user call would need
                # namespace re-resolution at the caller site
                if isinstance(sub, A.FunctionCall) and (
                        sub.namespace is not None or sub.name in local):
                    return False
    return True


def _is_literal_expr(e: A.Expr) -> bool:
    if isinstance(e, (A.IntLiteral, A.FloatLiteral, A.StringLiteral,
                      A.BoolLiteral)):
        return True
    return isinstance(e, A.UnaryOp) and e.op == "-" and \
        _is_literal_expr(e.operand)


def _rename_expr(e: A.Expr, ren: Dict[str, str]) -> A.Expr:
    if isinstance(e, A.Identifier):
        return dataclasses.replace(e, name=ren.get(e.name, e.name))
    kw = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            kw[f.name] = _rename_expr(v, ren)
        elif isinstance(v, list):
            nv = []
            for item in v:
                if isinstance(item, A.Expr):
                    nv.append(_rename_expr(item, ren))
                elif isinstance(item, tuple) and len(item) == 2 and \
                        isinstance(item[1], A.Expr):
                    nv.append((item[0], _rename_expr(item[1], ren)))
                else:
                    nv.append(item)
            kw[f.name] = nv
    return dataclasses.replace(e, **kw)


def _rename_stmt(s: A.Stmt, ren: Dict[str, str]) -> A.Stmt:
    kw = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if isinstance(v, A.Expr):
            kw[f.name] = _rename_expr(v, ren)
        elif isinstance(v, list) and v and isinstance(v[0], A.Expr):
            kw[f.name] = [_rename_expr(x, ren) for x in v]
    return dataclasses.replace(s, **kw)


def _assigned_names(body: List[A.Stmt]) -> Set[str]:
    out = set()
    for s in body:
        if isinstance(s, (A.Assignment, A.IfdefAssignment)):
            t = s.target
            if isinstance(t, A.Identifier):
                out.add(t.name)
            elif isinstance(t, A.Indexed) and isinstance(t.target, A.Identifier):
                out.add(t.target.name)
        elif isinstance(s, A.MultiAssignment):
            for t in s.targets:
                if isinstance(t, A.Identifier):
                    out.add(t.name)
    return out


def _inline_call(call: A.FunctionCall, targets: List[str],
                 fd: A.FunctionDef) -> Optional[List[A.Stmt]]:
    """Expand `t1,... = f(args)` into arg bindings + renamed body +
    output bindings. Returns None if the site doesn't match the signature."""
    if len(targets) != len(fd.outputs) and not (
            len(targets) == 1 and len(fd.outputs) >= 1):
        return None
    prefix = f"__ipa{next(_inline_ids)}_"
    ren = {p.name: prefix + p.name for p in fd.inputs}
    for n in _assigned_names(fd.body):
        ren.setdefault(n, prefix + n)

    # bind arguments (positional then named, then defaults)
    bound: Dict[str, A.Expr] = {}
    input_names = [p.name for p in fd.inputs]
    pos_i = 0
    for pname, pe in call.args:
        if pname is None:
            if pos_i >= len(input_names):
                return None
            bound[input_names[pos_i]] = pe
            pos_i += 1
        elif pname in input_names:
            bound[pname] = pe
        else:
            return None
    stmts: List[A.Stmt] = []
    for p in fd.inputs:
        if p.name in bound:
            src = bound[p.name]
        elif p.default is not None:
            src = p.default
        else:
            return None
        stmts.append(A.Assignment(target=A.Identifier(ren[p.name]), source=src))
    for s in fd.body:
        stmts.append(_rename_stmt(s, ren))
    for tname, out in zip(targets, fd.outputs):
        stmts.append(A.Assignment(target=A.Identifier(tname),
                                  source=A.Identifier(ren.get(out.name,
                                                              out.name))))
    return stmts


def inline_functions(prog: A.DMLProgram) -> int:
    """Inline statement-level calls `x = f(...)` / `[a,b] = f(...)` to
    inlinable leaf functions, across all files. Returns #sites inlined."""
    inlined = 0
    for p in _programs(prog):
        bodies = [p.statements] + [fd.body for fd in p.functions.values()]
        for body in bodies:
            inlined += _inline_in_body(body, p)
    return inlined


def _inline_in_body(body: List[A.Stmt], prog: A.DMLProgram) -> int:
    local = _user_fn_names(prog)
    count = 0
    i = 0
    while i < len(body):
        s = body[i]
        expansion = None
        call = None
        targets = None
        if isinstance(s, A.Assignment) and isinstance(s.source, A.FunctionCall) \
                and isinstance(s.target, A.Identifier) and not s.accumulate:
            call = s.source
            targets = [s.target.name]
        elif isinstance(s, A.MultiAssignment) and all(
                isinstance(t, A.Identifier) for t in s.targets):
            call = s.call
            targets = [t.name for t in s.targets]
        if call is not None and (call.namespace is not None
                                 or call.name in local):
            target_prog, fd = _resolve(prog, call.namespace, call.name)
            if fd is not None and _is_inlinable(fd, target_prog):
                expansion = _inline_call(call, targets, fd)
        if expansion is not None:
            body[i:i + 1] = expansion
            i += len(expansion)
            count += 1
        else:
            # recurse into nested control-flow bodies
            for f in dataclasses.fields(s):
                v = getattr(s, f.name)
                if isinstance(v, list) and v and isinstance(v[0], A.Stmt):
                    count += _inline_in_body(v, prog)
            i += 1
    return count


def run_ipa(prog: A.DMLProgram, optlevel: Optional[int] = None) -> Dict[str, int]:
    """The IPA pipeline (reference: InterProceduralAnalysis.analyzeProgram).
    Mutates `prog`. Order matters: inline first so functions that become
    unreferenced get removed."""
    from systemml_tpu_torch.utils.config import get_config

    if optlevel is None:
        optlevel = get_config().optlevel
    if optlevel <= 0:
        return {"inlined": 0, "removed": 0}
    from systemml_tpu_torch.obs import trace as obs

    with obs.span("ipa", obs.CAT_COMPILE) as sp:
        inlined = inline_functions(prog)
        removed = remove_unused_functions(prog)
        sp.set(inlined=inlined, removed=removed)
    return {"inlined": inlined, "removed": removed}


# --------------------------------------------------------------------------
# HOP-level size propagation (reference: Hop.refreshSizeInformation;
# feeds computeMemEstimate hops/Hop.java:605)
# --------------------------------------------------------------------------

def propagate_sizes(roots: List[Hop], var_dims: Dict[str, Tuple[int, int]],
                    var_nnz: Optional[Dict[str, int]] = None,
                    var_sp: Optional[Dict[str, float]] = None):
    """Forward shape inference over a HOP DAG. `var_dims` maps live-in
    variable names to (rows, cols); unknown stays -1. Mutates hop.rows/cols
    (and hop.nnz worst-case bounds / hop.est_sp expected-sparsity
    estimates, seeded from `var_nnz` / `var_sp`) in place and returns
    dims of every twrite."""
    from systemml_tpu_torch.hops.hop import postorder

    nnzs = var_nnz if var_nnz is not None else {}
    sps = var_sp if var_sp is not None else {}
    out: Dict[str, Tuple[int, int]] = {}
    for h in postorder(roots):
        _infer(h, var_dims)
        _infer_nnz(h, nnzs)
        _infer_est_sp(h, sps)
        if h.op == "twrite" and h.name:
            out[h.name] = (h.rows, h.cols)
    return out


def _lit_int(h: Hop) -> int:
    if h.is_literal and isinstance(h.value, (int, float)) \
            and not isinstance(h.value, bool) and float(h.value).is_integer():
        return int(h.value)
    return -1


def _named_arg(h: Hop, name: str, pos: Optional[int] = None) -> Optional[Hop]:
    names = h.params.get("argnames") or [None] * len(h.inputs)
    for n, c in zip(names, h.inputs):
        if n == name:
            return c
    unnamed = [c for n, c in zip(names, h.inputs) if n is None]
    if pos is not None and pos < len(unnamed):
        return unnamed[pos]
    return None


def _infer(h: Hop, var_dims: Dict[str, Tuple[int, int]]):
    op = h.op
    ins = h.inputs
    if op == "tread":
        if h.name in var_dims:
            h.rows, h.cols = var_dims[h.name]
    elif op == "twrite" and ins:
        h.rows, h.cols = ins[0].rows, ins[0].cols
    elif op == "lit":
        h.rows = h.cols = 0
    elif op == "ba+*":
        h.rows, h.cols = ins[0].rows, ins[1].cols
    elif op == "tsmm":
        n = ins[0].cols if h.params.get("left") else ins[0].rows
        h.rows = h.cols = n
    elif op == "mmchain":
        h.rows, h.cols = ins[0].cols, ins[1].cols
    elif op == "attention":
        h.rows, h.cols = ins[0].rows, ins[2].cols
    elif op.startswith("b(") or op.startswith("u(") or op.startswith("cum("):
        def bcast(dims):
            # broadcast result dim: a known >1 dim wins; otherwise ANY
            # unknown makes the result unknown (max() would let an
            # unknown -1 lose to a known 1, claiming a vector shape for
            # e.g. `scores - rowMaxs(scores)`)
            dims = list(dims)
            big = [d for d in dims if d > 1]
            if big:
                return max(big)
            if any(d < 0 for d in dims):
                return -1
            return 1 if dims else -1

        rows = bcast(c.rows for c in ins if c.is_matrix)
        cols = bcast(c.cols for c in ins if c.is_matrix)
        if h.is_matrix:
            h.rows, h.cols = rows, cols
        else:
            h.rows = h.cols = 0
    elif op.startswith("ua("):
        d = h.params.get("dir")
        if d == "all":
            h.rows = h.cols = 0
        elif d == "row":
            h.rows, h.cols = ins[0].rows, 1
        elif d == "col":
            h.rows, h.cols = 1, ins[0].cols
    elif op == "reorg(t)":
        h.rows, h.cols = ins[0].cols, ins[0].rows
    elif op == "reorg(rev)":
        h.rows, h.cols = ins[0].rows, ins[0].cols
    elif op == "reorg(diag)":
        if ins[0].cols == 1:      # vector -> diag matrix
            h.rows = h.cols = ins[0].rows
        elif ins[0].dims_known():  # matrix -> diag column
            h.rows, h.cols = min(ins[0].rows, ins[0].cols), 1
    elif op == "cbind":
        h.rows = ins[0].rows
        cs = [c.cols for c in ins]
        h.cols = sum(cs) if all(c >= 0 for c in cs) else -1
    elif op == "rbind":
        h.cols = ins[0].cols
        rs = [c.rows for c in ins]
        h.rows = sum(rs) if all(r >= 0 for r in rs) else -1
    elif op == "idx":
        rl, ru, cl, cu = (_lit_int(c) for c in ins[1:5])
        if ins[1] is ins[2]:
            h.rows = 1
        elif rl > 0 and ru > 0:
            h.rows = ru - rl + 1
        elif rl == 1 and ins[2].op == "nrow" and ins[2].inputs[0] is ins[0]:
            h.rows = ins[0].rows
        if ins[3] is ins[4]:
            h.cols = 1
        elif cl > 0 and cu > 0:
            h.cols = cu - cl + 1
        elif cl == 1 and ins[4].op == "ncol" and ins[4].inputs[0] is ins[0]:
            h.cols = ins[0].cols
    elif op == "lidx":
        h.rows, h.cols = ins[0].rows, ins[0].cols
    elif op in ("nrow", "ncol", "length"):
        h.rows = h.cols = 0
    elif op == "call:rand":
        r = _named_arg(h, "rows", 0)
        c = _named_arg(h, "cols", 1)
        h.rows = _lit_int(r) if r is not None else -1
        h.cols = _lit_int(c) if c is not None else -1
    elif op == "call:matrix":
        r = _named_arg(h, "rows", 1)
        c = _named_arg(h, "cols", 2)
        h.rows = _lit_int(r) if r is not None else -1
        h.cols = _lit_int(c) if c is not None else -1
    elif op == "call:seq":
        args = [_lit_int(c) for c in ins[:3]]
        if len(args) >= 2 and args[0] != -1 and args[1] != -1:
            incr = args[2] if len(args) > 2 and args[2] != -1 else (
                1 if args[1] >= args[0] else -1)
            if incr != 0:
                h.rows = abs((args[1] - args[0]) // incr) + 1
                h.cols = 1
    elif op.startswith("q("):
        # weighted quaternary family over X (m x n), U (m x k), V (n x k)
        # (hops/rewrite.py quaternary tranche; reference: the Hop dims of
        # lops/Weighted*.java): wsloss/wcemm are full reductions;
        # wsigmoid/wumm keep X's shape; wdivmm is (n,k) left / (m,k) right
        if op in ("q(wsloss)", "q(wcemm)"):
            h.rows = h.cols = 0
        elif op in ("q(wsigmoid)", "q(wumm)") and ins:
            h.rows, h.cols = ins[0].rows, ins[0].cols
        elif op == "q(wdivmm)" and len(ins) >= 3:
            k = ins[1].cols if ins[1].cols >= 0 else ins[2].cols
            h.rows = ins[0].cols if h.params.get("left") else ins[0].rows
            h.cols = k
    # everything else keeps rows/cols = -1 (unknown)


# elementwise unary ops that map 0 -> 0 exactly (an all-zero input stays
# all-zero); exp/log/cos break the property and stay unknown
ZERO_PRESERVING_UNARY = frozenset({
    "-", "abs", "sqrt", "sign", "sin", "tan", "floor", "ceil",
    "ceiling", "round",
})


def _lit_num(h: Optional[Hop]) -> Optional[float]:
    if h is not None and h.op == "lit" and isinstance(
            h.value, (int, float)) and not isinstance(h.value, bool):
        return float(h.value)
    return None


def _infer_nnz(h: Hop, var_nnz: Dict[str, int]) -> None:
    """Worst-case nnz upper bound (-1 = unknown), the Hop.nnz half of
    size propagation. Uses the same no-cancellation SPARSE semantics as
    the reference's worst-case estimator and the existing X*0s
    elimination (a provably-zero cell never resurrects; 0*NaN counts as
    0, matching sparse kernels that never touch absent cells), so
    nnz == 0 proves all-zeros and licenses the empty-* rewrite family
    (hops/rewrite.py _known_empty). Seeded at datagen leaves (constant
    fills, rand min/max/sparsity literals) and composed with
    hops/estim.py worst-case formulas."""
    from systemml_tpu_torch.hops import estim

    op = h.op
    ins = h.inputs
    if not h.is_matrix:
        h.nnz = -1
        return
    cells = h.cells()

    def expanded(c: Hop) -> int:
        # operand nnz scaled to the output shape: zeros broadcast to
        # zeros; a nonzero operand expands by the broadcast factor
        if c.nnz == 0:
            return 0
        if c.nnz < 0 or not c.dims_known() or cells < 0:
            return -1
        fr = h.rows if c.rows == 1 and h.rows > 1 else 1
        fc = h.cols if c.cols == 1 and h.cols > 1 else 1
        return min(c.nnz * fr * fc, cells)

    nnz = -1
    if op == "tread":
        nnz = var_nnz.get(h.name, -1)
    elif op == "twrite" and ins:
        nnz = ins[0].nnz
    elif op == "call:matrix":
        v = _lit_num(_named_arg(h, "data", 0))
        if v is not None:
            nnz = 0 if v == 0.0 else cells  # cells may be -1 (unknown)
    elif op == "call:rand":
        # only PROVABLY empty fills count: sparsity=0 (the bernoulli
        # mask of p=0 applies under every pdf and keeps nothing), or
        # min=max=0 under the UNIFORM pdf only (ops/datagen.rand
        # ignores min/max for normal/poisson draws); any 0<s<1 mask is
        # a random draw whose worst case is dense
        sp = _lit_num(_named_arg(h, "sparsity"))
        mn = _lit_num(_named_arg(h, "min"))
        mx = _lit_num(_named_arg(h, "max"))
        pdf = _named_arg(h, "pdf")
        uniform = pdf is None or (pdf.op == "lit"
                                  and pdf.value == "uniform")
        if sp == 0.0 or (uniform and mn == 0.0 and mx == 0.0):
            nnz = 0
        else:
            nnz = cells
    elif op == "b(*)":
        ms = [expanded(c) for c in ins if c.is_matrix]
        if len(ms) == 2:
            nnz = estim.worst_case_ew_nnz("mult", ms[0], ms[1], cells)
        elif len(ms) == 1:
            nnz = ms[0]  # scalar scaling keeps the zero pattern
    elif op in ("b(+)", "b(-)", "b(min)", "b(max)"):
        ms = [expanded(c) for c in ins if c.is_matrix]
        if len(ms) == 2:
            nnz = estim.worst_case_ew_nnz("plus", ms[0], ms[1], cells)
        # matrix (+-) nonzero scalar densifies: stays unknown
    elif op == "ba+*" and len(ins) == 2:
        nnz = estim.worst_case_mm_nnz(ins[0].rows, ins[0].nnz,
                                      ins[1].cols, ins[1].nnz)
    elif op == "tsmm" and ins:
        x = ins[0]
        nnz = estim.worst_case_mm_nnz(h.rows, x.nnz, h.cols, x.nnz)
    elif op == "mmchain" and ins:
        nnz = 0 if ins[0].nnz == 0 else -1
    elif op.startswith("u("):
        if ins and h.params.get("op") in ZERO_PRESERVING_UNARY:
            nnz = ins[0].nnz
    elif op.startswith("cum("):
        nnz = 0 if ins and ins[0].nnz == 0 else -1
    elif op in ("reorg(t)", "reorg(rev)") and ins:
        nnz = ins[0].nnz
    elif op == "reorg(diag)" and ins:
        n0 = ins[0].nnz
        nnz = min(n0, cells) if n0 >= 0 and cells >= 0 else n0
    elif op in ("cbind", "rbind"):
        ns = [c.nnz for c in ins]
        nnz = sum(ns) if ns and all(n >= 0 for n in ns) else -1
    elif op == "idx" and ins:
        n0 = ins[0].nnz
        if n0 == 0:
            nnz = 0
        elif n0 >= 0 and cells >= 0:
            nnz = min(n0, cells)
    elif op.startswith("ua("):
        # row/col aggregates of an all-zero input stay all-zero for the
        # value-preserving aggregation ops
        if ins and ins[0].nnz == 0 and h.params.get("aop") in (
                "sum", "min", "max", "mean"):
            nnz = 0
    elif op in ("q(wsigmoid)", "q(wumm)") and ins:
        # X-masked outputs keep X's zero pattern
        nnz = ins[0].nnz
    h.nnz = nnz


def _infer_est_sp(h: Hop, var_sp: Dict[str, float]) -> None:
    """EXPECTED sparsity (Hop.est_sp, -1 = unknown) — the estimate half
    next to the worst-case nnz proof. Seeded from rand() sparsity
    literals (the reference seeds DataGenOp nnz the same way,
    DataGenOp.java computeSizeInformation) and composed with the
    hops/estim basic formulas. Consumers: the quaternary rewrite guards
    and exec-path costing — PROFITABILITY only, never value-changing
    folds (those key on nnz == 0 proofs)."""
    op = h.op
    ins = h.inputs
    if not h.is_matrix:
        h.est_sp = -1.0
        return
    if h.nnz == 0:
        h.est_sp = 0.0   # a proof is also an estimate
        return
    sp = -1.0
    msp = [c.est_sp for c in ins if c.is_matrix]
    if op == "tread":
        sp = var_sp.get(h.name, -1.0)
    elif op == "twrite" and ins:
        sp = ins[0].est_sp
    elif op == "call:rand":
        s = _lit_num(_named_arg(h, "sparsity"))
        sp = s if s is not None else 1.0
    elif op == "call:matrix":
        v = _lit_num(_named_arg(h, "data", 0))
        if v is not None:
            sp = 0.0 if v == 0.0 else 1.0
    elif op == "b(*)":
        if len(msp) == 2:
            # intersection upper bound (min, not the independence
            # product: W * V with W = (V != 0) is fully correlated)
            known = [s for s in msp if s >= 0]
            sp = min(known) if known else -1.0
        elif len(msp) == 1:
            sp = msp[0]   # scalar scaling keeps the zero pattern
    elif op in ("b(+)", "b(-)", "b(min)", "b(max)") and len(msp) == 2:
        if all(s >= 0 for s in msp):
            sp = min(1.0, msp[0] + msp[1])   # union bound
    elif op in ("b(!=)", "b(>)", "b(<)") and len(ins) == 2:
        # comparison against literal 0: the output pattern is (at most)
        # the matrix operand's nonzero pattern
        for a, b in ((ins[0], ins[1]), (ins[1], ins[0])):
            if a.is_matrix and b.is_literal and b.value == 0:
                sp = a.est_sp
    elif op == "ba+*" and len(ins) == 2:
        from systemml_tpu_torch.hops import estim

        if all(s >= 0 for s in msp) and ins[0].cols >= 0:
            sp = estim.EstimatorBasicAvg().estim(
                estim.MetaSpec(max(ins[0].rows, 1), max(ins[0].cols, 1),
                               msp[0]),
                estim.MetaSpec(max(ins[1].rows, 1), max(ins[1].cols, 1),
                               msp[1]), "mm")
    elif op.startswith("u(") and ins:
        if h.params.get("op") in ZERO_PRESERVING_UNARY:
            sp = ins[0].est_sp
    elif op in ("reorg(t)", "reorg(rev)", "idx") and ins:
        sp = ins[0].est_sp
    elif op in ("q(wsigmoid)", "q(wumm)") and ins:
        sp = ins[0].est_sp
    h.est_sp = sp


def memory_estimate(h: Hop, bytes_per_cell: int = 8) -> int:
    """Worst-case dense output memory of one hop in bytes (reference:
    OptimizerUtils.estimateSizeExactSparsity; sparsity-aware refinement
    lives in hops/estim.py)."""
    n = h.cells()
    return n * bytes_per_cell if n >= 0 else -1


def propagate_program_sizes(program,
                            input_dims: Optional[Dict[str, Tuple[int, int]]] = None,
                            input_sps: Optional[Dict[str, float]] = None):
    """Program-wide forward size propagation: thread (rows, cols) facts
    across statement blocks and control flow (reference: the size/type
    propagation DMLTranslator runs per statement block plus the
    cross-block statistics updates of dynamic recompilation,
    hops/recompile/Recompiler.java). If/else merges keep only dims both
    branches agree on; loops merge the entry state with one abstract
    body pass (a var whose dims change inside the loop becomes unknown)
    and then re-annotate the body under the merged — stable — state.

    Runs at compile time so `-explain hops` shows real dims and
    annotate_exec_types / the mesh-shape optimizer (parallel/
    resource_opt) can plan from them."""
    from systemml_tpu_torch.runtime.program import (BasicBlock, ForBlock,
                                              IfBlock, WhileBlock)

    def merge(dst, d1, d2, bottom):
        for k in set(d1) | set(d2):
            v1, v2 = d1.get(k), d2.get(k)
            dst[k] = v1 if (v1 == v2 and v1 is not None) else bottom

    def prop(blocks, dims, nnzs, sps):
        for b in blocks:
            if isinstance(b, BasicBlock):
                roots = list(b.hops.writes.values()) + list(b.hops.sinks)
                propagate_sizes(roots, dims, nnzs, sps)
                # thread written dims (and worst-case nnz / expected
                # sparsity) to the next block (writes map name -> value
                # hop directly; there are no twrite wrappers at block
                # roots)
                for name, h in b.hops.writes.items():
                    dims[name] = (h.rows, h.cols)
                    nnzs[name] = h.nnz
                    sps[name] = h.est_sp
            elif isinstance(b, IfBlock):
                d1, d2 = dict(dims), dict(dims)
                n1, n2 = dict(nnzs), dict(nnzs)
                s1, s2 = dict(sps), dict(sps)
                prop(b.if_body, d1, n1, s1)
                prop(b.else_body, d2, n2, s2)
                merge(dims, d1, d2, (-1, -1))
                merge(nnzs, n1, n2, -1)
                merge(sps, s1, s2, -1.0)
            elif isinstance(b, (WhileBlock, ForBlock)):
                # widen to a fixpoint: a var whose dims change only
                # TRANSITIVELY (A = B; B = cbind(B, z)) needs a second
                # pass to become unknown; both lattices have height 2
                # (known -> unknown), so this terminates fast — the
                # iteration cap is pure defensiveness
                merged, mnnz, msp = dict(dims), dict(nnzs), dict(sps)
                for _ in range(8):
                    d1, n1, s1 = dict(merged), dict(mnnz), dict(msp)
                    prop(b.body, d1, n1, s1)
                    nxt: Dict = {}
                    nxtn: Dict = {}
                    nxts: Dict = {}
                    merge(nxt, merged, d1, (-1, -1))
                    merge(nxtn, mnnz, n1, -1)
                    merge(nxts, msp, s1, -1.0)
                    if nxt == merged and nxtn == mnnz and nxts == msp:
                        break
                    merged, mnnz, msp = nxt, nxtn, nxts
                prop(b.body, dict(merged), dict(mnnz), dict(msp))
                dims.clear()
                dims.update(merged)
                nnzs.clear()
                nnzs.update(mnnz)
                sps.clear()
                sps.update(msp)

    dims = dict(input_dims or {})
    # expected-sparsity seeds for caller-bound inputs (MLContext knows
    # the nnz of a scipy/numpy binding at compile time — the analog of
    # the reference reading nnz from a MatrixObject's metadata)
    prop(program.blocks, dims, {}, dict(input_sps or {}))
    return dims
