"""nvcc time of a generated spoof source against the size of its plan.

    python -m systemml_tpu_torch.codegen.nvcc_scaling [REPS ...]

For each count r (default 1 4 16) it builds one cell and one row source
of a plan that applies every op of CELL_UNARY and CELL_BINARY r times,
as a chain of sums 29 r terms deep over up to 64 leaves (spoof.cuh's
kMaxLeaves), one nvcc at a time under build.NVCC_TIMEOUT_S, and prints
one JSON line per source: its plan's nodes, the bytes of its text, the
nvcc seconds (null when the build failed, with the error) and ptxas's
register counts. Needs nvcc, not a card.
"""

from __future__ import annotations

import json
import re
import sys
import time

from systemml_tpu_torch.codegen import build
from systemml_tpu_torch.codegen.cplan import CELL_BINARY, CELL_UNARY, CNode

MAX_LEAVES = 64


def _n(op, *kids):
    return CNode(op, list(kids))


def _leaf(k: int) -> CNode:
    return CNode("in", name=f"i{k % MAX_LEAVES}")


def every_op_plan(reps: int) -> CNode:
    """Every cell op `reps` times, each term on the next leaves."""
    e, k = _leaf(0), 1
    for _ in range(reps):
        for op in sorted(CELL_UNARY):
            arg = _n("b(*)", CNode("lit", value=0.5), _leaf(k))
            e = _n("b(+)", e, _n(op, arg))
            k += 1
        for op in sorted(CELL_BINARY):
            e = _n("b(+)", e, _n(op, _leaf(k), _leaf(k + 1)))
            k += 2
    return e


def _nodes(n: CNode) -> int:
    return 1 + sum(_nodes(c) for c in n.inputs)


def main(argv) -> int:
    reps = [int(a) for a in argv] or [1, 4, 16]
    for r in reps:
        plan = every_op_plan(r)
        for template in ("cell", "row"):
            name, text = build.plan_source(template, plan)
            t0 = time.perf_counter()
            err = None
            try:
                build.build_plans([(template, plan)])
            except RuntimeError as e:
                err = str(e).splitlines()[0]
            wall = time.perf_counter() - t0
            secs, report = build.build_reports.get(name, (None, ""))
            print(json.dumps({
                "reps": r, "template": template, "nodes": _nodes(plan),
                "leaves": len(plan.input_names()), "source_bytes": len(text),
                "nvcc_s": secs, "wall_s": round(wall, 3), "error": err,
                "registers": sorted({int(x) for x in re.findall(
                    r"Used (\d+) registers", report)}),
                "nvcc_timeout_s": build.NVCC_TIMEOUT_S}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
