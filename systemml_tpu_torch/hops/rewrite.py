# Copy of systemml_tpu/hops/rewrite.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""HOP rewrites: constant folding, algebraic simplification, CSE.

TPU-native equivalent of the reference's ProgramRewriter pipeline
(hops/rewrite/: RewriteConstantFolding, RewriteCommonSubexpression-
Elimination, RewriteAlgebraicSimplificationStatic/Dynamic,
RewriteMatrixMultChainOptimization). The full rule catalog — name,
reference citation, static/dynamic tranche, guards — lives in
``docs/rewrites.md``; every rule reports a per-fire ``rw_<name>``
counter (``-stats``) and CAT_REWRITE instant (``-trace``), and
``scripts/rewrite_coverage.py`` proves each declared rule fires.

Differences from the reference by design:

- ``rewrite_block`` is a bounded FIXPOINT driver, not a fixed pass
  list: rules enabled by other rules (a dynamic empty-fold freeing a
  consumer-count guard, trace_transpose exposing trace_matmult) fire on
  the next pass, with consumer counts recomputed per pass.
- Whole-block XLA fusion (compiler/lower.py FUSED mode) subsumes many of
  the reference's fusion-ish rewrites (binary-to-ternary, fused mult-add):
  XLA fuses elementwise chains into matmul epilogues automatically.
- Matrix-mult-chain reassociation runs at *trace time* with exact runtime
  shapes (compiler/lower.py Evaluator._reassoc_matmult: chain flattening
  over single-consumer ba+* nodes + the classic O(k^3) DP) rather than
  statically over estimated dims — shape-specialized plans make the DP
  exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from systemml_tpu_torch.hops.builder import BlockHops
from systemml_tpu_torch.hops.hop import Hop, lit, postorder
# unary ops that map 0 -> 0 exactly (shared with the Hop.nnz propagation)
from systemml_tpu_torch.hops.ipa import ZERO_PRESERVING_UNARY as \
    _ZERO_PRESERVING_UNARY


# bound on static-simplification passes per rewrite_block call. Chains
# that need composition converge in 2-3 passes (the last pass applies
# nothing and exits); the cap turns a hypothetical rule cycle into a
# harmless early stop instead of a hang.
MAX_FIXPOINT_PASSES = 5


def rewrite_block(blk: BlockHops, optlevel: Optional[int] = None):
    from systemml_tpu_torch.utils.config import get_config

    if optlevel is None:
        optlevel = get_config().optlevel
    if optlevel <= 0:
        return blk
    from systemml_tpu_torch.obs import trace as obs

    with obs.span("rewrite_block", obs.CAT_COMPILE) as sp:
        # bounded fixpoint (reference: ProgramRewriter runs its pass
        # list once per recompile, but rule composition there leans on
        # repeated recompilation — here one compile must compose them):
        # a pass-1 rewrite can expose a pass-2 pattern (trace_transpose
        # -> trace_matmult) or free a consumer-count guard, so passes
        # repeat — with _count_consumers recomputed EVERY pass — until
        # a pass applies nothing.
        total = 0
        passes = 0
        for _ in range(MAX_FIXPOINT_PASSES):
            passes += 1
            n = _rewrite_pass(blk)
            total += n
            if n == 0:
                break
        sp.set(passes=passes, applied=total)
    # NOTE: operator-fusion codegen (SpoofCompiler) no longer runs here —
    # it moved to the end of program compilation, after program-wide size
    # propagation, so cost-based plan selection sees concrete dims
    # (reference: codegen during recompile has dims the same way).
    return blk


def _rewrite_pass(blk: BlockHops) -> int:
    """One fold + simplify + CSE sweep; returns #simplifications applied."""
    applied = [0]

    def counting(h: Hop) -> Optional[Hop]:
        out = _simplify(h)
        if out is not None:
            applied[0] += 1
        return out

    _transform(blk, _fold_constants)
    # consumer counts are a per-pass snapshot: pass N-1 rewrites add and
    # remove consumers, so stale counts would let sharing guards both
    # mis-fire and silently miss (ISSUE 3 satellite)
    _count_consumers(blk)
    try:
        _transform(blk, counting)
    finally:
        _CONSUMERS.clear()
        _SLICE_CONSUMERS.clear()
    _cse(blk)
    return applied[0]


# --------------------------------------------------------------------------
# generic bottom-up transformer
# --------------------------------------------------------------------------

def _transform(blk: BlockHops, rule):
    """Apply `rule(hop) -> hop|None` bottom-up across the block DAG."""
    memo: Dict[int, Hop] = {}

    def visit(h: Hop) -> Hop:
        if h.id in memo:
            return memo[h.id]
        h.inputs = [visit(c) for c in h.inputs]
        out = rule(h) or h
        if out is not h:
            # a replacement node inherits the original's consumers (they
            # all rewire onto it), so it must inherit the consumer-count
            # snapshot too — otherwise a mid-pass created hop defaults
            # to single-consumer and the sharing guards open up on it.
            # When out was one of h's own inputs (identity collapses like
            # X*1 -> X), h dies with it: the h->out edge and h's own
            # slice-consumer entry come OFF before the inheritance.
            out_was_input = any(c is out for c in h.inputs)
            if h.id in _CONSUMERS:
                base = _CONSUMERS.get(out.id, 0)
                if out_was_input:
                    base = max(0, base - 1)
                _CONSUMERS[out.id] = base + _CONSUMERS[h.id]
            if out_was_input and out.id in _SLICE_CONSUMERS:
                _SLICE_CONSUMERS[out.id] = [
                    c for c in _SLICE_CONSUMERS[out.id] if c is not h]
            if h.id in _SLICE_CONSUMERS:
                _SLICE_CONSUMERS.setdefault(out.id, []).extend(
                    _SLICE_CONSUMERS[h.id])
        memo[h.id] = out
        return out

    blk.writes = {k: visit(v) for k, v in blk.writes.items()}
    blk.sinks = [visit(s) for s in blk.sinks]


# --------------------------------------------------------------------------
# constant folding (reference: RewriteConstantFolding)
# --------------------------------------------------------------------------

def _fold_constants(h: Hop) -> Optional[Hop]:
    if h.op.startswith("b(") and all(c.is_literal for c in h.inputs) \
            and all(not isinstance(c.value, str) for c in h.inputs):
        a, b = h.inputs[0].value, h.inputs[1].value
        try:
            return lit(_apply_scalar_binary(h.params["op"], a, b))
        except (ValueError, ZeroDivisionError):
            return None
    if h.op in ("b(==)", "b(!=)") and all(c.is_literal for c in h.inputs) \
            and any(isinstance(c.value, str) for c in h.inputs):
        # string-literal (in)equality — including MIXED type (a numeric
        # $reg compared against the "L2" penalty-type spelling is
        # statically unequal): the `if (fileLog != "")` output guards and
        # `if (reg == "wL2")` typing guards fold once clargs substitute,
        # enabling branch removal (RewriteRemoveUnnecessaryBranches)
        eq = h.inputs[0].value == h.inputs[1].value
        return lit(eq if h.op == "b(==)" else not eq)
    if h.op == "b(+)" and all(c.is_literal for c in h.inputs) and \
            any(isinstance(c.value, str) for c in h.inputs):
        from systemml_tpu_torch.compiler.lower import _to_display_str

        return lit(_to_display_str(h.inputs[0].value) +
                   _to_display_str(h.inputs[1].value))
    if h.op.startswith("u(") and len(h.inputs) == 1 and h.inputs[0].is_literal \
            and not isinstance(h.inputs[0].value, str):
        v = h.inputs[0].value
        o = h.params["op"]
        if o == "-":
            return lit(-v)
        if o == "!":
            return lit(not bool(v))
        import math

        fns = {"abs": abs, "sqrt": math.sqrt, "exp": math.exp, "log": math.log,
               "floor": math.floor, "ceil": math.ceil, "ceiling": math.ceil,
               "round": lambda x: math.floor(x + 0.5), "sin": math.sin,
               "cos": math.cos, "tan": math.tan}
        if o in fns:
            try:
                return lit(fns[o](v))
            except ValueError:
                return None
    return None


def _apply_scalar_binary(op: str, a, b):
    import math

    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if b == 0:
            return math.inf if a > 0 else (-math.inf if a < 0 else math.nan)
        return a / b
    if op == "^":
        return a ** b
    if op == "%%":
        return a - b * math.floor(a / b) if b != 0 else math.nan
    if op == "%/%":
        return math.floor(a / b) if b != 0 else math.nan
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "&":
        return bool(a) and bool(b)
    if op == "|":
        return bool(a) or bool(b)
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    raise ValueError(op)


# --------------------------------------------------------------------------
# algebraic simplification (reference: RewriteAlgebraicSimplificationStatic)
# --------------------------------------------------------------------------

def _is_lit(h: Hop, v) -> bool:
    """Numeric-literal equality (bools/strings excluded). The single
    literal predicate — static and dynamic tranches share it."""
    return h.is_literal and isinstance(h.value, (int, float)) \
        and not isinstance(h.value, bool) and float(h.value) == float(v)


def _is_num_lit(h: Hop) -> bool:
    return h.is_literal and isinstance(h.value, (int, float)) \
        and not isinstance(h.value, bool)


# consumer counts for the current _simplify pass: rules that would
# DUPLICATE work when their matched subtree is shared (a second consumer
# keeps the original alive, and post-rewrite CSE cannot merge the two
# syntactically different forms) must check _single_consumer. Reference:
# the rewrite catalog's parents.size()==1 guards.
_CONSUMERS: Dict[int, int] = {}
# of those consumers, the literal-bounds idx hops (candidates for the
# slice-pushdown family): a concat shared ONLY by slices that will all
# actually push down dies afterwards, so rewriting them is safe
_SLICE_CONSUMERS: Dict[int, List[Hop]] = {}


def _count_consumers(blk: BlockHops, roots_as_consumers: bool = True) -> None:
    _CONSUMERS.clear()
    _SLICE_CONSUMERS.clear()
    roots = list(blk.writes.values()) + list(blk.sinks)
    if roots_as_consumers:
        # a transient write / sink is a consumer too: P = t(X)%*%Y written
        # out plus Z = t(P) must NOT look single-consumer, or
        # transpose_matmult_chain duplicates the matmult (ADVICE r5 #1;
        # reference: parents include transient writes)
        for r in roots:
            _CONSUMERS[r.id] = _CONSUMERS.get(r.id, 0) + 1
    for h in postorder(roots):
        is_lit_idx = (h.op == "idx" and len(h.inputs) == 5
                      and all(_is_num_lit(b) for b in h.inputs[1:]))
        for c in h.inputs:
            _CONSUMERS[c.id] = _CONSUMERS.get(c.id, 0) + 1
            if is_lit_idx and c is h.inputs[0]:
                _SLICE_CONSUMERS.setdefault(c.id, []).append(h)


def _single_consumer(h: Hop) -> bool:
    # unknown (direct _simplify use in unit tests) counts as single
    return _CONSUMERS.get(h.id, 1) <= 1


def _would_push(x: Hop, idx_hop: Hop) -> bool:
    """Mirrors the slice_of_slice / slice_of_cbind / slice_of_rbind
    preconditions: will the pushdown rules actually rewrite `idx_hop`
    (a literal-bounds slice of x)? A slice that straddles a concat seam
    or falls out of range keeps x alive, so it must not count toward
    'every consumer pushes down'."""
    rl, ru, cl, cu = (int(b.value) for b in idx_hop.inputs[1:])
    if x.op == "idx" and len(x.inputs) == 5 and all(
            _is_num_lit(b) for b in x.inputs[1:]):
        return x.dims_known() and 1 <= rl <= ru <= x.rows \
            and 1 <= cl <= cu <= x.cols
    if x.op in ("cbind", "rbind") and len(x.inputs) == 2 \
            and 1 <= rl <= ru and 1 <= cl <= cu:
        a = x.inputs[0]
        if x.op == "cbind":
            return a.dims_known() and a.cols > 0 \
                and (cu <= a.cols or cl > a.cols)
        return a.dims_known() and a.rows > 0 \
            and (ru <= a.rows or rl > a.rows)
    return False


def _pushdown_safe(h: Hop) -> bool:
    """Guard for the indexing/cbind pushdown rules (ADVICE r5 #2): a
    shared subtree may only be re-expressed when every consumer is a
    slice that will itself push down — then ALL of them rewrite and the
    shared node dies, so no work survives in two syntactic forms for
    CSE to miss. A subtree kept alive by any non-slice (or non-pushable
    slice) consumer stays as-is."""
    n = _CONSUMERS.get(h.id, 1)
    if n <= 1:
        return True
    cons = _SLICE_CONSUMERS.get(h.id, ())
    return len(cons) >= n and all(_would_push(h, c) for c in cons)


def _fire(name: str) -> None:
    """Per-rule fired counter, surfaced by `-stats` as rw_<name>
    (reference: Statistics.incrementHOPRewrites + the rewrite trace of
    -explain recompile_hops). Also lands on the flight-recorder event
    bus (cat=rewrite) so trace summaries render the same tally."""
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_estim("rw_" + name)
    from systemml_tpu_torch.obs import trace as obs

    if obs.recording():
        obs.instant("rw_" + name, obs.CAT_REWRITE)


def _simplify(h: Hop) -> Optional[Hop]:
    op = h.op
    # X*1 / 1*X / X/1 / X+0 / 0+X / X-0 / X^1
    # (reference: simplifyConstantBinaryOperation identities)
    if op == "b(*)":
        if _is_lit(h.inputs[1], 1):
            _fire("mult_one")
            return h.inputs[0]
        if _is_lit(h.inputs[0], 1):
            _fire("mult_one")
            return h.inputs[1]
    if op == "b(/)" and _is_lit(h.inputs[1], 1):
        _fire("div_one")
        return h.inputs[0]
    if op == "b(+)":
        if _is_lit(h.inputs[1], 0) and h.inputs[0].dt != "string":
            _fire("plus_zero")
            return h.inputs[0]
        if _is_lit(h.inputs[0], 0) and h.inputs[1].dt != "string":
            _fire("plus_zero")
            return h.inputs[1]
    if op == "b(-)" and _is_lit(h.inputs[1], 0):
        _fire("minus_zero")
        return h.inputs[0]
    if op == "b(^)" and _is_lit(h.inputs[1], 1):
        _fire("pow_one")
        return h.inputs[0]
    # --X -> X
    if op == "u(-)" and h.inputs[0].op == "u(-)":
        _fire("neg_neg")
        return h.inputs[0].inputs[0]
    # t(t(X)) -> X  (reference: RewriteAlgebraicSimplificationStatic
    # removeUnnecessaryTranspose)
    if op == "reorg(t)" and h.inputs[0].op == "reorg(t)":
        _fire("transpose_transpose")
        return h.inputs[0].inputs[0]
    # sum(t(X)) -> sum(X); other full aggregates likewise (reference:
    # pushdownUnaryAggTransposeOperation — dir=all case)
    if op.startswith("ua(") and h.params.get("dir") == "all" \
            and h.inputs[0].op == "reorg(t)":
        _fire("agg_transpose")
        h.inputs = [h.inputs[0].inputs[0]]
        return h
    # aggregate-over-matmult family (reference:
    # RewriteAlgebraicSimplificationDynamic simplifySumMatrixMult):
    #   sum(X %*% Y)     -> sum(t(colSums(X)) * rowSums(Y))  (no m x n product)
    #   rowSums(X %*% Y) -> X %*% rowSums(Y)
    #   colSums(X %*% Y) -> colSums(X) %*% Y
    # _single_consumer: a product kept alive by another consumer is paid
    # for anyway — re-expressing one aggregate path would then ADD the
    # partial-sum work instead of deleting the O(n^3) product
    if op == "ua(sum,all)" and h.inputs[0].op == "ba+*" \
            and _single_consumer(h.inputs[0]):
        _fire("sum_matmult")
        x, y = h.inputs[0].inputs
        cx = Hop("ua(sum,col)", [x], {"aop": "sum", "dir": "col"},
                 dt="matrix")
        ry = Hop("ua(sum,row)", [y], {"aop": "sum", "dir": "row"},
                 dt="matrix")
        prod = Hop("b(*)", [Hop("reorg(t)", [cx], dt="matrix"), ry],
                   {"op": "*"}, dt="matrix")
        return Hop("ua(sum,all)", [prod], {"aop": "sum", "dir": "all"},
                   dt="scalar")
    if op == "ua(sum,row)" and h.inputs[0].op == "ba+*" \
            and _single_consumer(h.inputs[0]):
        _fire("rowsums_matmult")
        x, y = h.inputs[0].inputs
        ry = Hop("ua(sum,row)", [y], {"aop": "sum", "dir": "row"},
                 dt="matrix")
        return Hop("ba+*", [x, ry], dt="matrix")
    if op == "ua(sum,col)" and h.inputs[0].op == "ba+*" \
            and _single_consumer(h.inputs[0]):
        _fire("colsums_matmult")
        x, y = h.inputs[0].inputs
        cx = Hop("ua(sum,col)", [x], {"aop": "sum", "dir": "col"},
                 dt="matrix")
        return Hop("ba+*", [cx, y], dt="matrix")
    # ua(sum)(u(-)(X)) -> -sum(X): keep matmult-visible structure simple
    # tsmm: t(X)%*%X  or  X%*%t(X)  (reference: MMTSJ / tsmm lop)
    if op == "ba+*":
        l, r = h.inputs
        if l.op == "reorg(t)" and l.inputs[0] is r:
            _fire("tsmm")
            return Hop("tsmm", [r], {"left": True}, dt="matrix")
        if r.op == "reorg(t)" and r.inputs[0] is l:
            _fire("tsmm")
            return Hop("tsmm", [l], {"left": False}, dt="matrix")
        # mmchain XtXv: t(X) %*% (X %*% v)   (reference: MapMultChain)
        if l.op == "reorg(t)":
            x = l.inputs[0]
            if r.op == "ba+*" and r.inputs[0] is x and _is_vector_shaped(r.inputs[1]):
                _fire("mmchain_xtxv")
                return Hop("mmchain", [x, r.inputs[1]], {"ctype": "XtXv"},
                           dt="matrix")
            # XtwXv: t(X) %*% (w * (X %*% v))
            if r.op == "b(*)":
                a, b = r.inputs
                for w, xv in ((a, b), (b, a)):
                    if xv.op == "ba+*" and xv.inputs[0] is x and \
                            _is_vector_shaped(xv.inputs[1]):
                        _fire("mmchain_xtwxv")
                        return Hop("mmchain", [x, xv.inputs[1], w],
                                   {"ctype": "XtwXv"}, dt="matrix")
            # XtXvy: t(X) %*% ((X %*% v) - y)
            if r.op == "b(-)" and r.inputs[0].op == "ba+*" and \
                    r.inputs[0].inputs[0] is x and \
                    _is_vector_shaped(r.inputs[0].inputs[1]):
                _fire("mmchain_xtxvy")
                return Hop("mmchain", [x, r.inputs[0].inputs[1], r.inputs[1]],
                           {"ctype": "XtXvy"}, dt="matrix")
        # t(X) %*% t(Y) -> t(Y %*% X): two transposes become one
        # (reference: simplifyTransposeAggBinBinaryChains) — operands
        # must die with the rewrite, hence the consumer guards
        if l.op == "reorg(t)" and r.op == "reorg(t)" \
                and _single_consumer(l) and _single_consumer(r):
            _fire("transpose_both_matmult")
            mm = Hop("ba+*", [r.inputs[0], l.inputs[0]], dt="matrix")
            mm.rows, mm.cols = h.cols, h.rows
            out = Hop("reorg(t)", [mm], dt="matrix")
            out.rows, out.cols = h.rows, h.cols
            return out
        # order-of-binary reordering (reference:
        # simplifyBushyBinaryOperation / the scalar half of
        # reorderMinusMatrixMult): (s*X) %*% Y -> s * (X %*% Y), so the
        # trace-time matmult-chain DP in compiler/lower.py sees clean
        # ba+* operands and the scalar scales the SMALLEST product
        for i in (0, 1):
            m = h.inputs[i]
            if m.op == "b(*)" and len(m.inputs) == 2 \
                    and _single_consumer(m):
                for s, x in ((m.inputs[0], m.inputs[1]),
                             (m.inputs[1], m.inputs[0])):
                    if s.is_scalar and x.is_matrix:
                        _fire("scalar_matmult_hoist")
                        other = h.inputs[1 - i]
                        mm = Hop("ba+*",
                                 [x, other] if i == 0 else [other, x],
                                 dt="matrix")
                        mm.rows, mm.cols = h.rows, h.cols
                        out = Hop("b(*)", [s, mm], {"op": "*"},
                                  dt="matrix")
                        out.rows, out.cols = h.rows, h.cols
                        return out
    # trace(A%*%B) -> sum(A * t(B)) (reference: simplifyTraceMatrixMult):
    # the O(n^3) product collapses to O(n^2) elementwise work. Guarded:
    # a product another consumer materializes anyway must stay shared.
    if op == "call:trace" and h.inputs and h.inputs[0].op == "ba+*" \
            and _single_consumer(h.inputs[0]):
        _fire("trace_matmult")
        a, b = h.inputs[0].inputs
        return Hop("ua(sum,all)",
                   [Hop("b(*)", [a, Hop("reorg(t)", [b], dt="matrix")],
                        {"op": "*"}, dt="matrix")],
                   {"aop": "sum", "dir": "all"}, dt="scalar")
    # trace(t(X)) -> trace(X): the diagonal is transpose-invariant
    # (reference: the trace cases of removeUnnecessaryTranspose)
    if op == "call:trace" and h.inputs and h.inputs[0].op == "reorg(t)":
        _fire("trace_transpose")
        h.inputs = [h.inputs[0].inputs[0]]
        return h

    # ---- round-5 tranche (reference:
    # RewriteAlgebraicSimplificationStatic.java:1 catalog) ----------------
    ins = h.inputs
    # binary-to-unary (simplifyBinaryToUnaryOperation): X+X -> 2*X,
    # X*X -> X^2 (same hop node, i.e. provably the same value)
    if op == "b(+)" and len(ins) == 2 and ins[0] is ins[1] \
            and ins[0].dt != "string":
        _fire("plus_self_to_scale")
        return Hop("b(*)", [lit(2), ins[0]], {"op": "*"}, dt=h.dt)
    if op == "b(*)" and len(ins) == 2 and ins[0] is ins[1]:
        _fire("mult_self_to_square")
        return Hop("b(^)", [ins[0], lit(2)], {"op": "^"}, dt=h.dt)
    # 0-X -> -X ; X*(-1) / (-1)*X -> -X
    if op == "b(-)" and _is_lit(ins[0], 0):
        _fire("zero_minus_to_neg")
        return Hop("u(-)", [ins[1]], {"op": "-"}, dt=ins[1].dt)
    if op == "b(*)":
        if _is_lit(ins[1], -1):
            _fire("mult_negone_to_neg")
            return Hop("u(-)", [ins[0]], {"op": "-"}, dt=ins[0].dt)
        if _is_lit(ins[0], -1):
            _fire("mult_negone_to_neg")
            return Hop("u(-)", [ins[1]], {"op": "-"}, dt=ins[1].dt)
    # X / c -> X * (1/c) when the reciprocal is EXACT (c a power of two):
    # multiplies are cheaper and fuse into more patterns, and the
    # exactness guard keeps results bit-identical
    # (simplifyBinaryDivToMult)
    if op == "b(/)" and _is_num_lit(ins[1]) and ins[1].value != 0:
        import math

        mant, _ = math.frexp(abs(float(ins[1].value)))
        if mant == 0.5 and math.isfinite(1.0 / float(ins[1].value)):
            # (denormal powers of two overflow on reciprocal)
            _fire("div_to_mult")
            return Hop("b(*)", [ins[0], lit(1.0 / ins[1].value)],
                       {"op": "*"}, dt=h.dt)
    # unary chains: log(exp(X)) -> X; abs(abs(X)) -> abs(X);
    # abs(-X) -> abs(X); sqrt(X^2) -> abs(X)
    if op == "u(log)" and ins[0].op == "u(exp)":
        _fire("log_exp_cancel")
        return ins[0].inputs[0]
    if op == "u(abs)" and ins[0].op == "u(abs)":
        _fire("abs_abs")
        return ins[0]
    if op == "u(abs)" and ins[0].op == "u(-)":
        _fire("abs_neg")
        h.inputs = [ins[0].inputs[0]]
        return h
    if op == "u(sqrt)" and ins[0].op == "b(^)" \
            and _is_lit(ins[0].inputs[1], 2):
        _fire("sqrt_square_to_abs")
        return Hop("u(abs)", [ins[0].inputs[0]], {"op": "abs"},
                   dt=ins[0].inputs[0].dt)
    # abs(X)^even -> X^even (an even power erases the sign exactly:
    # pow(|x|, 2k) == pow(x, 2k) bit-for-bit under IEEE)
    if op == "b(^)" and _is_num_lit(ins[1]) and ins[0].op == "u(abs)":
        e = float(ins[1].value)
        if e == int(e) and int(e) % 2 == 0 and e > 0:
            _fire("abs_pow_even")
            h.inputs = [ins[0].inputs[0], ins[1]]
            return h
    # abs(X^even) -> X^even (an even power is already non-negative; NaN
    # passes through abs unchanged)
    if op == "u(abs)" and ins[0].op == "b(^)" \
            and _is_num_lit(ins[0].inputs[1]):
        e = float(ins[0].inputs[1].value)
        if e == int(e) and int(e) % 2 == 0 and e > 0:
            _fire("abs_square")
            return ins[0]
    # f(f(X)) -> f(X) for idempotent unaries (floor/ceil/round/sign —
    # a second application is exactly the identity on the first's range)
    if op.startswith("u(") and len(ins) == 1 and ins[0].op == op \
            and h.params.get("op") in ("floor", "ceil", "ceiling",
                                       "round", "sign"):
        _fire("idempotent_unary")
        return ins[0]
    # rev(rev(X)) -> X (removeUnnecessaryReorg)
    if op == "reorg(rev)" and ins[0].op == "reorg(rev)":
        _fire("rev_rev")
        return ins[0].inputs[0]
    # (X != 0) * X -> X: multiplying by one's own nonzero mask is the
    # identity (zeros stay zero, nonzeros multiply by 1)
    if op == "b(*)" and len(ins) == 2:
        for a, b in ((ins[0], ins[1]), (ins[1], ins[0])):
            if (a.op == "b(!=)" and _is_lit(a.inputs[1], 0)
                    and a.inputs[0] is b):
                _fire("self_mask_mult")
                return b
    # scalar-literal chain folding: (X + a) + b -> X + (a+b);
    # (X * a) * b -> X * (a*b) (reference: the canonicalization half of
    # simplifyDistributiveBinaryOperation)
    for chain_op in ("b(+)", "b(*)"):
        if op == chain_op and _is_num_lit(ins[1]) \
                and ins[0].op == chain_op \
                and _is_num_lit(ins[0].inputs[1]) \
                and ins[0].inputs[0].dt != "string":
            a = ins[0].inputs[1].value
            b = ins[1].value
            _fire("scalar_chain_fold")
            return Hop(chain_op, [ins[0].inputs[0],
                                  lit(a + b if chain_op == "b(+)"
                                      else a * b)],
                       {"op": h.params["op"]}, dt=h.dt)
    # (X^a)^b -> X^(a*b) for positive-integer exponents (safe: no
    # even-root sign loss)
    if op == "b(^)" and _is_num_lit(ins[1]) and ins[0].op == "b(^)" \
            and _is_num_lit(ins[0].inputs[1]):
        a, b = ins[0].inputs[1].value, ins[1].value
        if a == int(a) and b == int(b) and a > 0 and b > 0:
            _fire("pow_pow_fold")
            return Hop("b(^)", [ins[0].inputs[0], lit(int(a * b))],
                       {"op": "^"}, dt=h.dt)
    # nested scalar-literal min/max folding: min(min(X, a), b) ->
    # min(X, min(a, b)) (fuseMinMax)
    for mm in ("b(min)", "b(max)"):
        if op == mm and _is_num_lit(ins[1]) and ins[0].op == mm \
                and _is_num_lit(ins[0].inputs[1]):
            a, b = ins[0].inputs[1].value, ins[1].value
            _fire("minmax_chain_fold")
            return Hop(mm, [ins[0].inputs[0],
                            lit(min(a, b) if mm == "b(min)" else max(a, b))],
                       {"op": h.params["op"]}, dt=h.dt)
    # min(X, X) / max(X, X) -> X (same node; min(NaN,NaN)=NaN so this is
    # exact for every input)
    if op in ("b(min)", "b(max)") and len(ins) == 2 and ins[0] is ins[1]:
        _fire("minmax_self")
        return ins[0]
    # distributive factoring (reference:
    # simplifyDistributiveBinaryOperation): X*Y + X*Z -> X*(Y+Z), the
    # common factor matched by NODE IDENTITY (provably the same value).
    # Both products must die with the rewrite (the factored form and a
    # surviving original are two spellings CSE already ran too early to
    # merge), hence the consumer guards.
    if op == "b(+)" and len(ins) == 2 and ins[0] is not ins[1] \
            and ins[0].op == "b(*)" and ins[1].op == "b(*)" \
            and _single_consumer(ins[0]) and _single_consumer(ins[1]):
        l, r = ins
        for li in (0, 1):
            for ri in (0, 1):
                if l.inputs[li] is r.inputs[ri]:
                    x = l.inputs[li]
                    y, z = l.inputs[1 - li], r.inputs[1 - ri]
                    _fire("distributive_factor")
                    inner = Hop("b(+)", [y, z], {"op": "+"},
                                dt="matrix" if (y.is_matrix or z.is_matrix)
                                else "scalar")
                    return Hop("b(*)", [x, inner], {"op": "*"}, dt=h.dt)
    # X + X*Y -> X*(1+Y) (the second distributive shape of the same
    # reference rule; one multiply instead of multiply-plus-add)
    if op == "b(+)" and len(ins) == 2:
        for xi in (0, 1):
            x, m = ins[xi], ins[1 - xi]
            if m.op == "b(*)" and len(m.inputs) == 2 and m is not x \
                    and x.dt != "string" and _single_consumer(m) \
                    and (m.inputs[0] is x or m.inputs[1] is x):
                y = m.inputs[1] if m.inputs[0] is x else m.inputs[0]
                _fire("plus_self_mult_factor")
                inner = Hop("b(+)", [lit(1), y], {"op": "+"},
                            dt="matrix" if y.is_matrix else "scalar")
                return Hop("b(*)", [x, inner], {"op": "*"}, dt=h.dt)
    # aggregate pushdowns (simplifySumScalarMult / pushdownUnaryAggTranspose):
    # sum(s*X) -> s*sum(X); sum(-X) -> -sum(X);
    # sum(rowSums(X)) / sum(colSums(X)) -> sum(X);
    # rowSums(t(X)) -> t(colSums(X)); colSums(t(X)) -> t(rowSums(X))
    if op == "ua(sum,all)":
        inner = ins[0]
        if inner.op == "b(*)":
            for s, x in ((inner.inputs[0], inner.inputs[1]),
                         (inner.inputs[1], inner.inputs[0])):
                if _is_num_lit(s):
                    _fire("sum_scalar_mult")
                    return Hop("b(*)", [s, Hop("ua(sum,all)", [x],
                                               {"aop": "sum", "dir": "all"},
                                               dt="scalar")],
                               {"op": "*"}, dt="scalar")
        if inner.op == "u(-)":
            _fire("sum_neg")
            return Hop("u(-)", [Hop("ua(sum,all)", [inner.inputs[0]],
                                    {"aop": "sum", "dir": "all"},
                                    dt="scalar")],
                       {"op": "-"}, dt="scalar")
        if inner.op in ("ua(sum,row)", "ua(sum,col)"):
            _fire("sum_of_partial_sums")
            h.inputs = [inner.inputs[0]]
            return h
    # !(A == B) -> A != B and !(A != B) -> A == B (reference:
    # simplifyNotOverComparisons). Deliberately restricted to the
    # equality pair: ordered comparisons are NOT NaN-involutive
    # (!(NaN > x) is true but NaN <= x is false), and this catalog only
    # takes value-identical rewrites (see the sum-distribution removal
    # note below).
    if op == "u(!)" and ins and ins[0].op in ("b(==)", "b(!=)") \
            and _single_consumer(ins[0]):
        # _single_consumer: a SHARED comparison would stay alive for its
        # other consumer while this path re-expresses it negated — two
        # syntactic forms CSE already ran too early to merge (ADVICE r5 #2)
        inner = ins[0]
        _fire("not_over_cmp")
        neg = "!=" if inner.params.get("op") == "==" else "=="
        return Hop(f"b({neg})", list(inner.inputs), {"op": neg}, dt=h.dt)
    # t(t(X) %*% Y) -> t(Y) %*% X and t(X %*% t(Y)) -> Y %*% t(X)
    # (reference: simplifyTransposedAppend/...AggBinBinaryChains family):
    # moves the transpose off the m x n product onto an existing operand,
    # cancelling with the inner transpose
    if op == "reorg(t)" and ins and ins[0].op == "ba+*" \
            and _single_consumer(ins[0]):
        a, b = ins[0].inputs

        def t_of(x: Hop) -> Hop:  # collapse t(t(Z)) -> Z inline: the
            # bottom-up pass won't revisit nodes a rule creates
            if x.op == "reorg(t)":
                return x.inputs[0]
            return Hop("reorg(t)", [x], dt="matrix")

        if a.op == "reorg(t)":
            _fire("transpose_matmult_chain")
            return Hop("ba+*", [t_of(b), a.inputs[0]], dt="matrix")
        if b.op == "reorg(t)":
            _fire("transpose_matmult_chain")
            return Hop("ba+*", [b.inputs[0], t_of(a)], dt="matrix")
    if op == "ua(sum,row)" and ins[0].op == "reorg(t)":
        _fire("rowsums_transpose")
        return Hop("reorg(t)", [Hop("ua(sum,col)", [ins[0].inputs[0]],
                                    {"aop": "sum", "dir": "col"},
                                    dt="matrix")], dt="matrix")
    if op == "ua(sum,col)" and ins[0].op == "reorg(t)":
        _fire("colsums_transpose")
        return Hop("reorg(t)", [Hop("ua(sum,row)", [ins[0].inputs[0]],
                                    {"aop": "sum", "dir": "row"},
                                    dt="matrix")], dt="matrix")
    return None


def _is_vector_shaped(h: Hop) -> bool:
    """Heuristic: mmchain requires v to be a column vector. Without static
    dims we accept hops that are structurally vector-producing; the
    evaluator's mmchain handles any (k,c) RHS correctly anyway, so this
    only gates which spelling is used."""
    return True


# --------------------------------------------------------------------------
# common subexpression elimination (reference: RewriteCSE)
# --------------------------------------------------------------------------

def _cse(blk: BlockHops):
    canon: Dict[Tuple, Hop] = {}

    def key_of(h: Hop, child_keys: List[int]) -> Optional[Tuple]:
        if h.op == "lit":
            return ("lit", type(h.value).__name__, h.value)
        if h.op == "tread":
            return ("tread", h.name)
        # side-effecting / stateful ops are never merged
        if h.op in ("fcall", "call:rand", "call:sample", "call:time",
                    "call:read", "call:write", "call:print", "call:stop",
                    "call:assert"):
            return None
        items = tuple(sorted(h.params.items(),
                             key=lambda kv: kv[0])) if h.params else ()
        try:
            hash(items)
        except TypeError:
            return None
        return (h.op, items, tuple(child_keys))

    keys: Dict[int, Optional[Tuple]] = {}

    def visit(h: Hop) -> Hop:
        if h.id in keys:
            k = keys[h.id]
            return canon[k] if k is not None and k in canon else h
        h.inputs = [visit(c) for c in h.inputs]
        child_keys = []
        ok = True
        for c in h.inputs:
            ck = keys.get(c.id)
            if ck is None:
                ok = False
                break
            child_keys.append(ck)
        k = key_of(h, child_keys) if ok else None
        keys[h.id] = k
        if k is not None:
            if k in canon:
                return canon[k]
            canon[k] = h
        return h

    blk.writes = {n: visit(v) for n, v in blk.writes.items()}
    blk.sinks = [visit(s) for s in blk.sinks]


# --------------------------------------------------------------------------
# dynamic (size-conditional) rewrites — run AFTER program-wide size
# propagation (reference: RewriteAlgebraicSimplificationDynamic.java,
# applied during dynamic recompilation once dims are known)
# --------------------------------------------------------------------------

def rewrite_block_dynamic(blk: BlockHops) -> int:
    """Size-conditional simplifications over a DAG whose hops carry
    propagated dims. Returns the number of rewrites applied."""
    applied = [0]

    def rule(h: Hop) -> Optional[Hop]:
        out = _simplify_dynamic(h)
        if out is not None:
            applied[0] += 1
        return out

    # edge-only consumer counts (roots_as_consumers=False): a written-out
    # hop is materialized regardless, and the pushdown rules REDIRECT the
    # slice rather than duplicate the written value's computation — the
    # sharing notion that matters here is other in-DAG consumers
    _count_consumers(blk, roots_as_consumers=False)
    try:
        _transform(blk, rule)
    finally:
        _CONSUMERS.clear()
        _SLICE_CONSUMERS.clear()
    return applied[0]


# --------------------------------------------------------------------------
# weighted quaternary capture (reference: the Weighted* pattern rewrites
# of RewriteAlgebraicSimplificationDynamic.java — simplifyWeightedSquared
# Loss/Sigmoid/DivMM/CrossEntropy/UnaryMM). Each rule folds a
# sum/product shape over U %*% t(V) into ONE q(*) hop whose runtime
# samples the product at the pattern carrier's nonzero cells
# (ops/mult.py + runtime/sparse.py) instead of materializing the m x n
# product. Guards (ISSUE 5): the product and every intermediate must die
# with the rewrite (_single_consumer), and _q_guard asks the sparsity
# estimator — fire when the carrier is estimated sparse; when sparsity
# is unknown, only nonzero-safe patterns fire, and only while spoof's
# costed outer-product template is not in play (codegen at optlevel>=3
# owns the dense-or-unknown shapes: negotiation, not a fight).
# --------------------------------------------------------------------------

# unaries safe to sample inside wumm (zero cells of X mask the result;
# log is deliberately ABSENT so the wcemm sum-capture one level up sees
# its pattern first — the bottom-up transform would otherwise swallow
# X * log(UV) before the sum is visited)
_WUMM_OPS = frozenset({"exp", "abs", "sqrt", "sign", "floor", "ceil",
                       "ceiling", "round"})


def _est_sparsity(h: Hop) -> float:
    """Best sparsity estimate for a hop: the propagated expectation
    (Hop.est_sp, hops/ipa) or the worst-case nnz bound as fallback."""
    if h.est_sp >= 0:
        return h.est_sp
    if h.nnz >= 0 and h.dims_known() and h.cells() > 0:
        return h.nnz / h.cells()
    return -1.0


def _q_guard(carrier: Hop, nonzero_safe: bool) -> bool:
    from systemml_tpu_torch.utils.config import get_config

    cfg = get_config()
    est = _est_sparsity(carrier)
    turn = getattr(cfg, "sparsity_turn_point", 0.4)
    if 0.0 <= est < turn:
        return True
    if est >= turn:
        return False   # estimated dense: keep the MXU/spoof path
    return nonzero_safe and not (cfg.codegen_enabled and cfg.optlevel >= 3)


def _match_uvt(h: Hop):
    """U %*% t(V) with the PRODUCT dying with the rewrite -> (U, V),
    else None. Only the m x n product needs the single-consumer guard —
    the t(V) reorg is O(n*k) factor work and may stay alive for another
    consumer (the ALS loop body CSE-shares one t(R) between the two
    half-step products) without duplicating anything expensive."""
    if h is not None and h.op == "ba+*" and len(h.inputs) == 2 \
            and h.inputs[1].op == "reorg(t)" \
            and h.inputs[1].inputs[0].is_matrix \
            and _single_consumer(h):
        return h.inputs[0], h.inputs[1].inputs[0]
    return None


def _peel_eps(h: Hop):
    """P + eps -> (eps, P); bare P -> (0.0, P)."""
    if h.op == "b(+)" and len(h.inputs) == 2 and _single_consumer(h):
        for pi in (0, 1):
            if _is_num_lit(h.inputs[1 - pi]):
                return float(h.inputs[1 - pi].value), h.inputs[pi]
    return 0.0, h


def _is_sq(h: Hop) -> bool:
    return h.op == "b(^)" and len(h.inputs) == 2 and _is_lit(h.inputs[1], 2)


def _match_wsloss(inner: Hop) -> Optional[Hop]:
    """The four wsloss shapes under ua(sum,all) (reference:
    WeightedSquaredLoss.WeightsType)."""
    def q(x, u, v, w, post):
        ins = [x, u, v] + ([w] if w is not None else [])
        return Hop("q(wsloss)", ins, {"post": post}, dt="scalar")

    # NONE / PRE: sum((X - UV)^2) / sum((X - W*UV)^2); the subtraction
    # is sign-symmetric under the square, so both orientations match
    if _is_sq(inner) and inner.inputs[0].op == "b(-)" \
            and _single_consumer(inner.inputs[0]):
        d = inner.inputs[0]
        for xi in (0, 1):
            x, p = d.inputs[xi], d.inputs[1 - xi]
            uv = _match_uvt(p)
            if uv is not None and x.is_matrix:
                if _q_guard(x, False):   # NONE: needs an est-sparse X
                    _fire("q_wsloss")
                    return q(x, uv[0], uv[1], None, "NONE")
                return None
            if p.op == "b(*)" and len(p.inputs) == 2 \
                    and _single_consumer(p):
                for wi in (0, 1):
                    w, p2 = p.inputs[wi], p.inputs[1 - wi]
                    uv = _match_uvt(p2)
                    if uv is not None and x.is_matrix and w.is_matrix:
                        if _q_guard(w, False):   # PRE: est-sparse W
                            _fire("q_wsloss")
                            return q(x, uv[0], uv[1], w, "PRE")
                        return None
    # POST / POST_NZ: sum(W * (X - UV)^2)
    if inner.op == "b(*)" and len(inner.inputs) == 2:
        for wi in (0, 1):
            w, sq = inner.inputs[wi], inner.inputs[1 - wi]
            if not (_is_sq(sq) and _single_consumer(sq)
                    and sq.inputs[0].op == "b(-)"
                    and _single_consumer(sq.inputs[0])):
                continue
            d = sq.inputs[0]
            for xi in (0, 1):
                x, p = d.inputs[xi], d.inputs[1 - xi]
                uv = _match_uvt(p)
                if uv is None or not x.is_matrix:
                    continue
                if w.op == "b(!=)" and len(w.inputs) == 2 \
                        and w.inputs[0] is x and _is_lit(w.inputs[1], 0) \
                        and _single_consumer(w):
                    if _q_guard(x, True):   # POST_NZ: nonzero-safe in X
                        _fire("q_wsloss")
                        return q(x, uv[0], uv[1], None, "POST_NZ")
                    return None
                if w.is_matrix and _q_guard(w, True):  # POST: safe in W
                    _fire("q_wsloss")
                    return q(x, uv[0], uv[1], w, "POST")
                return None
    return None


def _match_w2(w2: Hop):
    """X * (U t(V))  or  X / (U t(V) [+ eps]) -> (x, u, v, mult, eps)."""
    if not _single_consumer(w2):
        return None
    if w2.op == "b(*)" and len(w2.inputs) == 2:
        for xi in (0, 1):
            x, p = w2.inputs[xi], w2.inputs[1 - xi]
            uv = _match_uvt(p)
            if uv is not None and x.is_matrix:
                return x, uv[0], uv[1], True, 0.0
    if w2.op == "b(/)" and len(w2.inputs) == 2:
        x = w2.inputs[0]
        eps, p = _peel_eps(w2.inputs[1])
        uv = _match_uvt(p)
        if uv is not None and x.is_matrix:
            return x, uv[0], uv[1], False, eps
    return None


def _try_quaternary(h: Hop) -> Optional[Hop]:
    op = h.op
    ins = h.inputs
    if op == "ua(sum,all)" and ins:
        inner = ins[0]
        if not _single_consumer(inner):
            return None
        # wcemm: sum(X * log(U t(V) [+ eps]))
        if inner.op == "b(*)" and len(inner.inputs) == 2:
            for xi in (0, 1):
                x, lg = inner.inputs[xi], inner.inputs[1 - xi]
                if lg.op == "u(log)" and lg.inputs \
                        and _single_consumer(lg) and x.is_matrix:
                    eps, p = _peel_eps(lg.inputs[0])
                    uv = _match_uvt(p)
                    if uv is not None and _q_guard(x, True):
                        _fire("q_wcemm")
                        out = Hop("q(wcemm)", [x, uv[0], uv[1]],
                                  {"eps": eps}, dt="scalar")
                        out.rows = out.cols = 0
                        return out
        return _match_wsloss(inner)
    # wsigmoid: X * sigmoid(±(U t(V))) [under log]
    if op == "b(*)" and len(ins) == 2:
        for xi in (0, 1):
            x, s = ins[xi], ins[1 - xi]
            if not x.is_matrix:
                continue
            flags = []
            if s.op == "u(log)" and s.inputs \
                    and s.inputs[0].op == "u(sigmoid)" \
                    and _single_consumer(s) \
                    and _single_consumer(s.inputs[0]):
                flags.append("log")
                s = s.inputs[0]
            if s.op != "u(sigmoid)" or not s.inputs \
                    or not _single_consumer(s):
                continue
            inner = s.inputs[0]
            if inner.op == "u(-)" and inner.inputs \
                    and _single_consumer(inner):
                flags.append("minus")
                inner = inner.inputs[0]
            uv = _match_uvt(inner)
            if uv is not None and _q_guard(x, True):
                _fire("q_wsigmoid")
                out = Hop("q(wsigmoid)", [x, uv[0], uv[1]],
                          {"flags": " ".join(flags)}, dt="matrix")
                out.rows, out.cols = h.rows, h.cols
                return out
    # wumm: X * fn(U t(V)) / X / fn(U t(V)) for sampled-safe unaries
    if op in ("b(*)", "b(/)") and len(ins) == 2:
        cands = ((0, 1),) if op == "b(/)" else ((0, 1), (1, 0))
        for xi, fi in cands:
            x, f = ins[xi], ins[fi]
            if not x.is_matrix or not f.op.startswith("u(") \
                    or f.params.get("op") not in _WUMM_OPS \
                    or not f.inputs or not _single_consumer(f):
                continue
            uv = _match_uvt(f.inputs[0])
            if uv is not None and _q_guard(x, True):
                _fire("q_wumm")
                out = Hop("q(wumm)", [x, uv[0], uv[1]],
                          {"op": "*" if op == "b(*)" else "/",
                           "uop": f.params["op"]}, dt="matrix")
                out.rows, out.cols = h.rows, h.cols
                return out
    # wdivmm right: (X ⊙ UV) %*% V ; left: t(X ⊙ UV) %*% U — the same
    # factor closes the product (the ALS half-step shape)
    if op == "ba+*" and len(ins) == 2:
        m = _match_w2(ins[0])
        if m is not None and ins[1] is m[2] and _q_guard(m[0], True):
            x, u, v, mult, eps = m
            _fire("q_wdivmm")
            out = Hop("q(wdivmm)", [x, u, v],
                      {"left": False, "mult": mult, "eps": eps},
                      dt="matrix")
            out.rows, out.cols = h.rows, h.cols
            return out
        if ins[0].op == "reorg(t)" and ins[0].inputs \
                and _single_consumer(ins[0]):
            m = _match_w2(ins[0].inputs[0])
            if m is not None and ins[1] is m[1] and _q_guard(m[0], True):
                x, u, v, mult, eps = m
                _fire("q_wdivmm")
                out = Hop("q(wdivmm)", [x, u, v],
                          {"left": True, "mult": mult, "eps": eps},
                          dt="matrix")
                out.rows, out.cols = h.rows, h.cols
                return out
    return None


def _simplify_dynamic(h: Hop) -> Optional[Hop]:
    ins = h.inputs
    q = _try_quaternary(h)
    if q is not None:
        return q
    # ---- cumulative-aggregate mini-tranche (ROADMAP gap; reference:
    # the cumsum cases of RewriteAlgebraicSimplificationStatic/Dynamic)
    if h.op.startswith("cum(") and ins:
        # cumagg over a provably-empty matrix is all-zeros (holds for
        # cumsum/cumprod/cummin/cummax alike: every prefix over zeros
        # is zero)
        if _known_empty(ins[0]) and h.dims_known() and h.cells() > 0:
            _fire("empty_cumagg")
            return _zeros(h.rows, h.cols)
        # cumaggs run down columns: a single-row matrix is a fixpoint
        if ins[0].rows == 1:
            _fire("cumagg_one_row")
            return ins[0]
    # sum(cumsum(X)) / colSums(cumsum(X)): fold the scan away —
    # sum_i cumsum(X)[i,j] = sum_i (n-i+1) * X[i,j], so the aggregate
    # becomes a row-weighted sum with a seq(n,1) weight vector
    if h.op in ("ua(sum,all)", "ua(sum,col)") and ins \
            and ins[0].op == "cum(cumsum)" and _single_consumer(ins[0]) \
            and ins[0].inputs and ins[0].inputs[0].rows > 0:
        x = ins[0].inputs[0]
        _fire("sum_cumsum")
        seq = Hop("call:seq", [lit(x.rows), lit(1), lit(-1)],
                  {"argnames": [None, None, None]}, dt="matrix")
        seq.rows, seq.cols = x.rows, 1
        prod = Hop("b(*)", [x, seq], {"op": "*"}, dt="matrix")
        prod.rows, prod.cols = x.rows, x.cols
        h.inputs = [prod]
        return h
    # X[1:nrow(X), 1:ncol(X)] -> X (remove unnecessary indexing;
    # ref: RewriteAlgebraicSimplificationDynamic removeUnnecessaryIndexing)
    if h.op == "idx" and len(ins) >= 5:
        x = ins[0]
        if (x.dims_known() and h.dims_known()
                and (h.rows, h.cols) == (x.rows, x.cols)
                and _lit_eq(ins[1], 1) and _lit_eq(ins[3], 1)):
            _fire("remove_unnecessary_indexing")
            return x
    # ---- indexing simplifications (reference:
    # RewriteAlgebraicSimplificationDynamic, RewriteIndexingVectorization
    # family). All require literal bounds; 1-based inclusive semantics.
    if h.op == "idx" and len(ins) == 5 and all(
            _is_num_lit(b) for b in ins[1:]):
        x = ins[0]
        rl, ru, cl, cu = (int(b.value) for b in ins[1:])
        # X[a:b,c:d][e:f,g:h] -> X[a+e-1:a+f-1, c+g-1:c+h-1]: one gather
        # instead of two chained slices. _would_push is the SHARED
        # firing predicate (same one _pushdown_safe applies to every
        # consumer): literal inner bounds, dims known, bounds in range —
        # in-range so the fold doesn't swallow a range error
        if x.op == "idx" and _would_push(x, h) and _pushdown_safe(x):
            irl, _, icl, _ = (int(b.value) for b in x.inputs[1:])
            _fire("slice_of_slice")
            out = Hop("idx", [x.inputs[0], lit(irl + rl - 1),
                              lit(irl + ru - 1), lit(icl + cl - 1),
                              lit(icl + cu - 1)], dict(h.params),
                      dt=h.dt)
            out.rows, out.cols = h.rows, h.cols
            return out
        # matrix(v,...)[a:b,c:d] -> matrix(v, b-a+1, d-c+1) — only when
        # the source dims are known AND the bounds are in range (the
        # fold must not swallow an out-of-range error)
        v = _const_datagen(x)
        if v is not None and x.dims_known() \
                and 1 <= rl <= ru <= x.rows and 1 <= cl <= cu <= x.cols:
            _fire("slice_const_datagen")
            out = Hop("call:matrix", [lit(v),
                                      lit(ru - rl + 1), lit(cu - cl + 1)],
                      {"argnames": [None, "rows", "cols"]}, dt="matrix")
            out.rows, out.cols = ru - rl + 1, cu - cl + 1
            return out
        # cbind(A,B)[, cols within one side] -> slice that side only;
        # rbind likewise for row ranges (the concat never materializes).
        # _would_push is the SHARED firing predicate with _pushdown_safe:
        # positive bounds (non-positive literals hit the runtime's clamp
        # semantics, which re-anchoring on the narrower side would
        # change — review-caught), dims of the first part known, and the
        # range entirely on one side of the seam.
        if x.op in ("cbind", "rbind") and _would_push(x, h) \
                and _pushdown_safe(x):
            a, b = x.inputs
            if x.op == "cbind":
                _fire("slice_of_cbind")
                if cu <= a.cols:
                    out = Hop("idx", [a, lit(rl), lit(ru), lit(cl),
                                      lit(cu)], dict(h.params), dt=h.dt)
                else:  # _would_push guarantees cl > a.cols here
                    out = Hop("idx", [b, lit(rl), lit(ru),
                                      lit(cl - a.cols), lit(cu - a.cols)],
                              dict(h.params), dt=h.dt)
            else:
                _fire("slice_of_rbind")
                if ru <= a.rows:
                    out = Hop("idx", [a, lit(rl), lit(ru), lit(cl),
                                      lit(cu)], dict(h.params), dt=h.dt)
                else:  # _would_push guarantees rl > a.rows here
                    out = Hop("idx", [b, lit(rl - a.rows),
                                      lit(ru - a.rows), lit(cl), lit(cu)],
                              dict(h.params), dt=h.dt)
            out.rows, out.cols = h.rows, h.cols
            return out
    # rowSums of a single-column matrix / colSums of a single-row matrix
    # is the identity (ref: simplifyUnnecessaryAggregate)
    if h.op == "ua(sum,row)" and ins and ins[0].cols == 1:
        _fire("rowsums_of_vector")
        return ins[0]
    if h.op == "ua(sum,col)" and ins and ins[0].rows == 1:
        _fire("colsums_of_vector")
        return ins[0]
    # t(X) of a 1x1 is X (ref: simplifyUnnecessaryReorg on scalars-as-1x1)
    if h.op == "reorg(t)" and ins and (ins[0].rows, ins[0].cols) == (1, 1):
        _fire("transpose_1x1")
        return ins[0]

    # ---- round-5 tranche (reference:
    # RewriteAlgebraicSimplificationDynamic.java:1) ------------------------
    # X %*% diag(v) -> X * t(v) (column scaling, no k x k product) and
    # diag(v) %*% X -> v * X (row scaling) — only when v is a column
    # VECTOR (reorg(diag) doubles as diagonal extraction on matrices)
    if h.op == "ba+*" and len(ins) == 2:
        a, b = ins
        if (b.op == "reorg(diag)" and b.inputs
                and b.inputs[0].cols == 1 and b.inputs[0].rows > 1):
            _fire("mm_diag_right_to_colscale")
            v = b.inputs[0]
            tv = Hop("reorg(t)", [v], dt="matrix")
            tv.rows, tv.cols = 1, v.rows
            out = Hop("b(*)", [a, tv], {"op": "*"}, dt="matrix")
            # carry the known dims: later exec-type/spoof passes run
            # AFTER this rewrite with no re-propagation
            out.rows, out.cols = h.rows, h.cols
            return out
        if (a.op == "reorg(diag)" and a.inputs
                and a.inputs[0].cols == 1 and a.inputs[0].rows > 1):
            _fire("mm_diag_left_to_rowscale")
            out = Hop("b(*)", [a.inputs[0], b], {"op": "*"}, dt="matrix")
            out.rows, out.cols = h.rows, h.cols
            return out
    # X^0 -> matrix(1, dims) (NaN^0 == 1 under IEEE pow, so dropping X
    # is value-identical; ref: simplifyConstantBinary)
    if h.op == "b(^)" and len(ins) == 2 and _lit_eq(ins[1], 0) \
            and ins[0].dims_known() and ins[0].cells() > 1:
        _fire("pow_zero_to_ones")
        out = Hop("call:matrix", [lit(1.0), lit(ins[0].rows),
                                  lit(ins[0].cols)],
                  {"argnames": [None, "rows", "cols"]}, dt="matrix")
        out.rows, out.cols = ins[0].rows, ins[0].cols
        return out
    # NOTE deliberately absent: sum(X±Y) -> sum(X)±sum(Y). It is
    # numerically UNSAFE — a residual-style sum(P - Y) of near-equal
    # large values cancels elementwise but catastrophically loses the
    # answer when two ~1e9 fp32 sums subtract (review-confirmed: 97.66
    # -> 0.0) — and it is a pessimization anyway (two reductions for
    # one fused subtract+reduce).
    # mean(X) -> sum(X) / cells once dims are known: sum participates in
    # the aggregate-over-matmult fusions, mean does not
    if h.op == "ua(mean,all)" and ins and ins[0].dims_known() \
            and ins[0].cells() > 0:
        _fire("mean_to_sum")
        return Hop("b(/)", [Hop("ua(sum,all)", [ins[0]],
                                {"aop": "sum", "dir": "all"}, dt="scalar"),
                            lit(float(ins[0].cells()))],
                   {"op": "/"}, dt="scalar")

    # ---- constant/empty-matrix propagation (reference:
    # simplifyEmptyBinaryOperation / simplifyEmptyMatrixMult /
    # simplifyScalarMatrixMult, RewriteAlgebraicSimplificationDynamic).
    # "Empty" = provably all-zero: a constant-0 datagen OR a worst-case
    # nnz bound of 0 propagated by hops/ipa (rand(sparsity=0) feeding a
    # pipeline of zero-preserving ops). The identity-elimination rules
    # require the constant operand's dims to EQUAL the output's (no
    # broadcasting folded away by mistake); the zero-folds below them
    # construct the output shape explicitly, so broadcasts are safe.
    if h.op in ("b(+)", "b(-)", "b(*)", "b(/)") and len(ins) == 2 \
            and h.dims_known():
        a, b = ins
        ca, cb = _const_datagen(a), _const_datagen(b)
        same_a = a.dims_known() and (a.rows, a.cols) == (h.rows, h.cols)
        same_b = b.dims_known() and (b.rows, b.cols) == (h.rows, h.cols)
        # X + 0s -> X ; 0s + X -> X ; X - 0s -> X ; 0s - X -> -X
        if h.op == "b(+)":
            if _known_empty(b) and same_a:
                _fire("plus_zero_matrix")
                return a
            if _known_empty(a) and same_b:
                _fire("plus_zero_matrix")
                return b
        if h.op == "b(-)":
            if _known_empty(b) and same_a:
                _fire("minus_zero_matrix")
                return a
            if _known_empty(a) and same_b:
                _fire("minus_zero_matrix")
                out = Hop("u(-)", [b], {"op": "-"}, dt="matrix")
                out.rows, out.cols = h.rows, h.cols
                return out
        # X * 1s -> X ; 1s * X -> X ; X / 1s -> X
        if h.op == "b(*)":
            if cb == 1 and same_a:
                _fire("mult_ones_matrix")
                return a
            if ca == 1 and same_b:
                _fire("mult_ones_matrix")
                return b
            # X * 0s -> 0s. Matches the reference's sparse semantics
            # (sparse kernels never touch — and hence zero out — cells
            # whose second operand is an absent zero, so 0 * NaN is 0
            # there); value-identical for all finite data.
            if cb == 0 and same_b:
                _fire("mult_zero_matrix")
                return b
            if ca == 0 and same_a:
                _fire("mult_zero_matrix")
                return a
            # broadcast/derived-empty generalization: an all-zero
            # operand of ANY shape zeroes the whole (known-dims) output
            if _known_empty(a) or _known_empty(b):
                _fire("empty_cellwise_mult")
                return _zeros(h.rows, h.cols)
        if h.op == "b(/)" and cb == 1 and same_a:
            _fire("mult_ones_matrix")
            return a
    if h.op == "ba+*" and len(ins) == 2 and h.dims_known():
        a, b = ins
        # (0s) %*% X -> 0s ; X %*% (0s) -> 0s (simplifyEmptyMatrixMult;
        # same sparse-semantics note as X * 0s above)
        if _known_empty(a) or _known_empty(b):
            _fire("matmult_zero_matrix")
            return _zeros(h.rows, h.cols)
        # 1x1 %*% B -> as.scalar * B ; A %*% 1x1 likewise
        # (simplifyScalarMatrixMult): a scalar broadcast multiply
        # instead of a degenerate k=1 MXU dispatch
        for m, other in ((a, b), (b, a)):
            if m.dims_known() and (m.rows, m.cols) == (1, 1):
                _fire("scalar_matmult")
                s = Hop("call:as.scalar", [m], {"argnames": [None]},
                        dt="scalar")
                out = Hop("b(*)", [s, other], {"op": "*"}, dt="matrix")
                out.rows, out.cols = h.rows, h.cols
                return out

    # ---- empty-aggregate family (reference: simplifyEmptyAggregate /
    # simplifyEmptyUnaryOperation / simplifyEmptyReorgOperation,
    # RewriteAlgebraicSimplificationDynamic) — the expensive subtree
    # computing a provably-all-zero value folds to a literal/0-datagen
    # at compile time, backed by the worst-case-nnz propagation.
    if h.op.startswith("ua(") and ins and _known_empty(ins[0]) \
            and ins[0].dims_known() and ins[0].cells() > 0 \
            and h.params.get("aop") in ("sum", "min", "max", "mean"):
        d = h.params.get("dir")
        _fire("empty_aggregate")
        if d == "all":
            return lit(0.0)
        if d == "row":
            return _zeros(ins[0].rows, 1)
        return _zeros(1, ins[0].cols)
    if h.op == "call:trace" and ins and _known_empty(ins[0]) \
            and ins[0].dims_known() and ins[0].cells() > 0:
        _fire("empty_aggregate")
        return lit(0.0)
    # zero-preserving unary over an empty matrix is empty
    if h.op.startswith("u(") and ins and h.is_matrix and h.dims_known() \
            and h.cells() > 0 and _known_empty(ins[0]) \
            and h.params.get("op") in _ZERO_PRESERVING_UNARY:
        _fire("empty_unary")
        return _zeros(h.rows, h.cols)
    # reorg of an empty matrix is an empty matrix of the output shape
    if h.op in ("reorg(t)", "reorg(rev)", "reorg(diag)") and ins \
            and h.dims_known() and h.cells() > 0 and _known_empty(ins[0]):
        _fire("empty_reorg")
        return _zeros(h.rows, h.cols)
    # a provably-empty cbind/rbind ARM folds to a 0-datagen literal, so
    # whatever expensive subtree computed it dies (the concat itself
    # stays — its shape contribution is still needed)
    if h.op in ("cbind", "rbind") and len(ins) == 2:
        changed = False
        new_ins = []
        for c in ins:
            if _known_empty(c) and c.dims_known() and c.cells() > 0 \
                    and c.op != "call:matrix":
                _fire("empty_concat_arm")
                new_ins.append(_zeros(c.rows, c.cols))
                changed = True
            else:
                new_ins.append(c)
        if changed:
            h.inputs = new_ins
            return h
    return None


def _known_empty(h: Hop) -> bool:
    """Provably all-zero: a worst-case nnz bound of 0 (hops/ipa
    propagation from datagen literals + hops/estim formulas) or a
    constant-0 datagen. The empty-* rule family keys on this."""
    return (h.is_matrix and h.nnz == 0) or _const_datagen(h) == 0


def _zeros(rows: int, cols: int) -> Hop:
    """A constant-0 datagen of known dims (reference:
    HopRewriteUtils.createDataGenOpByVal with value 0). nnz seeds to 0
    so parents can fold in the same bottom-up pass."""
    out = Hop("call:matrix", [lit(0.0), lit(rows), lit(cols)],
              {"argnames": [None, "rows", "cols"]}, dt="matrix")
    out.rows, out.cols = rows, cols
    out.nnz = 0
    return out


def _const_datagen(h: Hop):
    """The fill value when `h` is a constant matrix(v, r, c) datagen
    (reference: HopRewriteUtils.isDataGenOpWithConstantValue), else None.
    The fill argument is resolved by NAME (named args keep source order,
    so inputs[0] may be the rows literal: matrix(rows=1, cols=5, data=7))."""
    if h.op != "call:matrix":
        return None
    from systemml_tpu_torch.hops.ipa import _named_arg

    v = _named_arg(h, "data", 0)
    if v is not None and v.op == "lit" and not isinstance(v.value, str):
        return v.value
    return None


_lit_eq = _is_lit  # legacy alias (dynamic rules predate the merge)
