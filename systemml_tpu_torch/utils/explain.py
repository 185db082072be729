"""Plan explanation (reference: utils/Explain.java:84-108 — `-explain
[hops|runtime]` prints annotated program/HOP plans).

Port of systemml_tpu/utils/explain.py. A basic block shows whether the
whole-block compile plans it ("fused") or the analysis leaves it eager;
a loop shows its region plan or its refusal; a parfor its last run's
plan (mode, k, partitioner; runtime/parfor_opt.py)."""

from __future__ import annotations

from systemml_tpu_torch.runtime.program import (BasicBlock, ForBlock,
                                                IfBlock, ParForBlock, Program,
                                                WhileBlock)


def explain_program(prog: Program, mode: str = "hops") -> str:
    lines = ["PROGRAM", f"--FUNCTIONS ({len(prog.functions)})"]
    for (fid, name), fb in prog.functions.items():
        lines.append(f"----FUNCTION {name} [file {fid}, "
                     f"{len(fb.fn_def.inputs)} in, {len(fb.fn_def.outputs)} out]")
        for b in fb.blocks:
            lines.append(_explain_block(b, 3, mode))
    lines.append("--MAIN PROGRAM")
    for b in prog.blocks:
        lines.append(_explain_block(b, 2, mode))
    return "\n".join(l for l in lines if l)


def _explain_block(b, depth: int, mode: str) -> str:
    pad = "--" * depth
    if isinstance(b, BasicBlock):
        fused = b.analysis().jittable
        head = f"{pad}GENERIC block [{'fused' if fused else 'eager'}]"
        if mode == "hops":
            body = "".join(h.pretty(depth) for h in b.hops.roots())
            return head + "\n" + body.rstrip("\n")
        return head
    if isinstance(b, IfBlock):
        out = [f"{pad}IF"]
        out += [_explain_block(c, depth + 1, mode) for c in b.if_body]
        if b.else_body:
            out.append(f"{pad}ELSE")
            out += [_explain_block(c, depth + 1, mode) for c in b.else_body]
        return "\n".join(out)
    if isinstance(b, ParForBlock):
        plan = getattr(b, "last_plan", None)
        extra = f" [{plan.describe()}]" if plan is not None else ""
        out = [f"{pad}PARFOR ({b.var}){extra}"]
        out += [_explain_block(c, depth + 1, mode) for c in b.body]
        return "\n".join(out)
    if isinstance(b, ForBlock):
        out = [f"{pad}FOR ({b.var}){_cla_tag(b)}{_region_tag(b)}"]
        out += [_explain_block(c, depth + 1, mode) for c in b.body]
        return "\n".join(out)
    if isinstance(b, WhileBlock):
        out = [f"{pad}WHILE{_cla_tag(b)}{_region_tag(b)}"]
        out += [_explain_block(c, depth + 1, mode) for c in b.body]
        return "\n".join(out)
    return f"{pad}{type(b).__name__}"


def _cla_tag(b) -> str:
    """Compressed-reblock plan visibility: loops whose invariants are
    auto-compression candidates carry a [cla: ...] tag (reference: the
    injected compress op visible in `-explain` after
    RewriteCompressedReblock)."""
    cands = getattr(b, "cla_candidates", None)
    return f" [cla: {', '.join(cands)}]" if cands else ""


def _region_tag(b) -> str:
    """The loop's region plan (compiler/lower.plan_loop_regions): its
    carried names, or the reason it was refused."""
    r = getattr(b, "_region", None)
    if r is None:
        return ""
    if r.refused is not None:
        return f" [region refused: {r.refused}]"
    return f" [region: {', '.join(sorted(r.carried))}]"
