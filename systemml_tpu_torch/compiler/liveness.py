# Copy of systemml_tpu/compiler/liveness.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""Live-variable analysis over the ProgramBlock tree.

TPU-native equivalent of the reference's LiveVariableAnalysis +
rmvar-instruction insertion (parser/DMLTranslator.java:167,
parser/LiveVariableAnalysis.java; the runtime effect of rmvar is
VariableCPInstruction RMVAR freeing CacheableData). Here the backward
dataflow annotates each BasicBlock with `kill_after` — names whose last
use is that block — and the interpreter deletes them from the symbol
table right after the block runs, which drops their buffer-pool handles
(rmvar-first freeing) so HBM is released as early as possible.

Exit-live contract: callers that know the program's requested outputs
(MLContext/JMLC) pass them as `exit_live`; without them every top-level
write stays live to program end (outputs are read from the final symbol
table), while function bodies still get tight liveness from their
declared outputs.
"""

from __future__ import annotations

from typing import List, Optional, Set


def _hops_reads(hops) -> Set[str]:
    """Reads of a BlockHops INCLUDING exists(X) probes, which touch the
    symbol table without a tread (killing the var early would flip the
    probe's answer). Used for basic blocks AND predicates."""
    from systemml_tpu_torch.hops.hop import postorder

    reads = set(hops.reads)
    roots = list(hops.writes.values()) + list(hops.sinks)
    for h in postorder(roots):
        if h.op == "exists_var":
            reads.add(h.params["name"])
    return reads


def _block_rw(b) -> tuple:
    return _hops_reads(b.hops), set(b.hops.writes)


def annotate_program(program, exit_live: Optional[Set[str]] = None) -> None:
    """Annotate every BasicBlock in `program` (main chain + functions)."""
    from systemml_tpu_torch.runtime.program import BasicBlock

    if exit_live is None:
        # conservative: every top-level write may be read by the caller
        exit_live = set()
        for b in _walk_basic(program.blocks):
            exit_live |= set(b.hops.writes)
    _annotate_blocks(program.blocks, set(exit_live))
    for fb in program.functions.values():
        fn_exit = {o.name for o in fb.fn_def.outputs}
        _annotate_blocks(fb.blocks, fn_exit)


def _walk_basic(blocks):
    from systemml_tpu_torch.runtime import program as P

    for b in blocks:
        if isinstance(b, P.BasicBlock):
            yield b
        elif isinstance(b, P.IfBlock):
            yield from _walk_basic(b.if_body)
            yield from _walk_basic(b.else_body)
        elif isinstance(b, P.ForBlock):  # covers ParForBlock
            yield from _walk_basic(b.body)
        elif isinstance(b, P.WhileBlock):
            yield from _walk_basic(b.body)


def _annotate_blocks(blocks: List, live_out: Set[str]) -> Set[str]:
    """Backward pass; returns live-in of the sequence. Sets `kill_after`
    on BasicBlocks (creating the attribute)."""
    from systemml_tpu_torch.runtime import program as P

    known = (P.BasicBlock, P.IfBlock, P.WhileBlock, P.ForBlock)
    if any(not isinstance(b, known) for b in blocks):
        # unknown block type: its reads are unknowable, so no killing is
        # safe anywhere in this sequence — everything stays live
        for bb in _walk_basic(blocks):
            bb.kill_after = set()
            live_out = live_out | set(bb.hops.writes) | _hops_reads(bb.hops)
        return set(live_out)
    live = set(live_out)
    for b in reversed(blocks):
        if isinstance(b, P.BasicBlock):
            reads, writes = _block_rw(b)
            dead = (reads | writes) - live
            b.kill_after = dead
            live = (live - writes) | reads
        elif isinstance(b, P.IfBlock):
            pred_reads = _hops_reads(b.pred.block.hops)
            li_if = _annotate_blocks(b.if_body, live)
            li_else = _annotate_blocks(b.else_body, live)
            live = li_if | li_else | pred_reads | _partial_kill_guard(b, live)
        elif isinstance(b, P.WhileBlock):
            live = _annotate_loop(b, [b.pred], b.body, live)
        elif isinstance(b, P.ForBlock):  # covers ParForBlock
            preds = [p for p in (b.from_h, b.to_h, b.incr_h)
                     if p is not None]
            live = _annotate_loop(b, preds, b.body, live)
    return live


def _partial_kill_guard(b, live) -> Set[str]:
    """Writes that only SOME branch performs must stay live into the if:
    the other branch leaves the pre-if value, which may be read later."""
    from systemml_tpu_torch.runtime import program as P

    writes_if = set()
    writes_else = set()
    for bb in _walk_basic(b.if_body):
        writes_if |= set(bb.hops.writes)
    for bb in _walk_basic(b.else_body):
        writes_else |= set(bb.hops.writes)
    partial = writes_if ^ writes_else
    return partial & live


def _annotate_loop(loop, preds, body, live_after: Set[str]) -> Set[str]:
    """Loop body executes 0..n times with a back edge: anything read at
    the loop head (body live-in or predicate) is live at the END of the
    body too. Two-pass fixpoint (sets grow monotonically and the second
    pass is stable for reducible single-loop structure)."""
    pred_reads = set()
    for p in preds:
        pred_reads |= _hops_reads(p.block.hops)
    # names live AFTER the loop exits — loopfuse uses this to drop
    # zero-iteration seed values without a device sync (a dead seed can
    # be popped unconditionally; only a live-out seed needs the trip
    # count to decide)
    loop.live_after = set(live_after)
    li1 = _annotate_blocks(body, set(live_after) | pred_reads)
    exit_live = set(live_after) | pred_reads | li1
    li2 = _annotate_blocks(body, exit_live)
    return li2 | pred_reads | live_after
