"""Parameterized builtins.

Port of systemml_tpu/ops/param.py, the part that the port's scripts
reach: `rexpand` (line 75 there). The rest of that module (removeEmpty,
replace, outer, order statistics, table, ...) waits for ROADMAP queue 1,
algorithm breadth.
"""

from __future__ import annotations

import torch


def rexpand(target, max_v: int, direction: str = "cols", cast: bool = True,
            ignore: bool = True):
    """rexpand: one-hot expansion of a 1-based id vector into max columns
    (or rows) (reference: ParameterizedBuiltin REXPAND, used by dummycode).
    Ids are rounded half to even when `cast` (jnp.round, torch.round);
    ids outside 1..max give all-zero rows, whatever `ignore` says, as in
    the JAX package."""
    v = target.reshape(-1)
    idx = (torch.round(v) if cast else v).to(torch.int64) - 1
    m = int(max_v)
    cols = torch.arange(m, device=v.device)
    # an id outside 0..m-1 matches no column: its row stays zero
    eye = (idx[:, None] == cols[None, :]).to(v.dtype)
    return eye if direction == "cols" else eye.T
