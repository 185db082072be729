# Copy of systemml_tpu/hops/hoist.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""Loop-invariant code motion at the HOP level.

TPU-native equivalent of the reference's loop-invariant hoisting
(hops/rewrite/RewriteForLoopVectorization.java's sibling concern; the
reference hoists via RewriteCommonSubexpressionElimination across
recompiles plus the parfor optimizer's EXPENSIVE-op relocation). Here a
maximal pure subtree whose leaves are all loop-invariant variables (or
literals) and whose root is an expensive op (matmult family, solves) is
computed ONCE in a synthetic basic block inserted before the loop; the
body reads the precomputed temp.

Speculation safety: the pre-loop block evaluates code the program would
only have run INSIDE the loop — a zero-trip loop must not surface
errors from it (a guarded `if (...) X = ...` above a dead loop is valid
DML). The pre-block therefore executes under a catch-all; on failure the
hoist temps bind to a FailedHoist sentinel carrying the original
exception, which re-raises at first actual READ (bufferpool.resolve) —
i.e. only if the loop really runs, preserving the unhoisted program's
error behavior.

Why hoisting still matters with whole-loop fusion: XLA hoists
loop-invariant code inside ONE fused while_loop, but a body that does
not fuse (host syncs, strings, compressed values) re-executes every hop
per iteration — there the classic t(X)%*%X-inside-the-loop pattern
costs a full matmult per iteration. Hoisting at the HOP level makes
both paths cheap.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Set, Tuple

from systemml_tpu_torch.hops.hop import Hop, postorder, tread

# subtree roots worth a hoisted temp: expensive compute only. A bare
# transpose is NOT here — it is a copy XLA folds into dot_general for
# free, and materializing it pre-loop would double the operand's
# footprint for the out-of-HBM streaming paths.
HOIST_ROOTS = ("ba+*", "tsmm", "mmchain", "call:solve", "call:inv",
               "call:cholesky")

# ops that may appear INSIDE a hoisted subtree (pure, deterministic)
_PURE_PREFIXES = ("b(", "u(", "ua(", "cum(")
_PURE_OPS = {"ba+*", "tsmm", "mmchain", "reorg(t)", "reorg(rev)",
             "reorg(diag)", "cbind", "rbind", "idx", "nrow", "ncol",
             "length", "lit", "tread", "call:solve", "call:inv",
             "call:cholesky"}

_hoist_ids = itertools.count(1)


class FailedHoist:
    """Sentinel bound to hoist temps when the speculative pre-block
    failed; re-raises the original error at first actual read."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def hoist_program(program) -> int:
    """Hoist loop-invariant expensive subtrees across the program.
    Returns the number of hoisted temps created."""
    from systemml_tpu_torch.runtime.program import (ForBlock, IfBlock, WhileBlock)

    count = 0

    def walk(blocks: List) -> List:
        nonlocal count
        out: List = []
        for b in blocks:
            if isinstance(b, IfBlock):
                b.if_body = walk(b.if_body)
                b.else_body = walk(b.else_body)
                out.append(b)
            elif isinstance(b, (WhileBlock, ForBlock)):
                # covers ParForBlock too (a ForBlock subclass); parfor
                # bodies re-plan per worker, the pure pre-loop temps stay
                # valid either way
                pre, n = _hoist_loop(b, program)
                count += n
                b.body = walk(b.body)
                out.extend(pre + [b])
            else:
                out.append(b)
        return out

    program.blocks = walk(program.blocks)
    for fb in program.functions.values():
        fb.blocks = walk(fb.blocks)
    walk = None  # breaks the closure's cycle through itself and `program`
    return count


def _loop_invariants(loop) -> Set[str]:
    """Variables read in the body and never truly written there (shared
    semantics with compress/rewrite._loop_candidates: pass-through
    identity writes carry loop state, they are not assignments)."""
    from systemml_tpu_torch.runtime.program import (BasicBlock, ForBlock,
                                              IfBlock, WhileBlock)

    reads: Set[str] = set()
    writes: Set[str] = set()

    def collect(blocks):
        for b in blocks:
            if isinstance(b, BasicBlock):
                reads.update(b.hops.reads)
                for name, h in b.hops.writes.items():
                    if not (h.op == "tread" and h.name == name):
                        writes.add(name)
            elif isinstance(b, IfBlock):
                collect(b.if_body)
                collect(b.else_body)
            elif isinstance(b, (WhileBlock, ForBlock)):
                v = getattr(b, "var", None)
                if v:
                    writes.add(v)
                collect(b.body)

    collect(loop.body)
    v = getattr(loop, "var", None)
    if v:
        writes.add(v)
    return reads - writes


def _hoist_loop(loop, program) -> Tuple[List, int]:
    """Hoist from one loop's DIRECT basic blocks. Returns (pre-blocks,
    n_hoisted)."""
    from systemml_tpu_torch.hops.builder import BlockHops
    from systemml_tpu_torch.runtime.program import BasicBlock

    invariant = _loop_invariants(loop)
    if not invariant:
        return [], 0
    hoisted: Dict[Tuple, str] = {}       # structural key -> temp name
    pre = BlockHops()
    n = 0

    def key_of(h: Hop) -> Tuple:
        if h.op == "lit":
            return ("lit", repr(h.value))
        if h.op == "tread":
            return ("tread", h.name)
        # repr-keyed params: always hashable, structural enough
        return (h.op, tuple(sorted((k, repr(v))
                                   for k, v in h.params.items())),
                tuple(key_of(c) for c in h.inputs))

    def invariant_subtree(h: Hop) -> bool:
        for c in postorder([h]):
            if c.op == "tread":
                if c.name not in invariant:
                    return False
            elif not (c.op in _PURE_OPS
                      or any(c.op.startswith(p) for p in _PURE_PREFIXES)):
                return False
        return True

    def register(c: Hop) -> Optional[str]:
        """Record subtree `c` as a hoisted temp if eligible; returns the
        temp name (shared across structurally identical subtrees)."""
        nonlocal n
        if not (c.op in HOIST_ROOTS and c.dt == "matrix"
                and invariant_subtree(c)):
            return None
        k = key_of(c)
        name = hoisted.get(k)
        if name is None:
            name = f"__hoist{next(_hoist_ids)}"
            hoisted[k] = name
            pre.writes[name] = c
            for leaf in postorder([c]):
                if leaf.op == "tread":
                    pre.reads.add(leaf.name)
            n += 1
        return name

    def rewrite(h: Hop, seen: Dict[int, bool]):
        """Post-order: replace MAXIMAL hoistable subtrees with treads."""
        for i, c in enumerate(h.inputs):
            if c.id in seen:
                continue
            name = register(c)
            if name is not None:
                h.inputs[i] = tread(name)
            else:
                seen[c.id] = True
                rewrite(c, seen)

    def visit_block(bb: BasicBlock):
        blk = bb.hops
        seen: Dict[int, bool] = {}
        # a write whose WHOLE value is hoistable becomes an alias of the
        # temp (the binding stays in the loop, the compute does not)
        for wname, wh in list(blk.writes.items()):
            tname = register(wh)
            if tname is not None:
                blk.writes[wname] = tread(tname)
        for root in blk.roots():
            rewrite(root, seen)
        # reads must track the REWRITTEN DAG exactly: keeping stale names
        # would pin the original operands (liveness/parfor read sets)
        # through the loop and defeat the memory win
        blk.reads = {h.name for h in postorder(blk.roots())
                     if h.op == "tread" and h.name}

    for b in loop.body:
        if isinstance(b, BasicBlock):
            visit_block(b)
    if not hoisted:
        return [], 0
    pre_block = _hoist_block_cls()(pre, program,
                                   getattr(loop, "file_id", 0))
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_estim("hoisted_invariants", n)
    return [pre_block], n


_HOIST_BLOCK_CLS = None


def _hoist_block_cls():
    """Lazily built to avoid an import cycle with runtime.program."""
    global _HOIST_BLOCK_CLS
    if _HOIST_BLOCK_CLS is None:
        from systemml_tpu_torch.runtime.program import BasicBlock

        class HoistBlock(BasicBlock):
            """Speculative pre-loop block: failures bind FailedHoist
            sentinels instead of raising (see module docstring)."""

            def execute(self, ec):
                try:
                    super().execute(ec)
                except Exception as e:
                    for name in self.hops.writes:
                        ec.vars[name] = FailedHoist(e)

        _HOIST_BLOCK_CLS = HoistBlock
    return _HOIST_BLOCK_CLS
