"""Cellwise (elementwise) matrix/scalar operations.

Port of systemml_tpu/ops/cellwise.py, dense branches. DML semantics as
there:
- booleans materialize as 0.0/1.0 in the value dtype,
- `/` is true division (inf/nan propagate as in R),
- `%%` / `%/%` follow R semantics (sign of divisor; intdiv = floor),
- broadcasting covers matrix-scalar, matrix-rowvector, matrix-colvector.
Compressed, double-float and sparse operands wait (ROADMAP queue 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from systemml_tpu_torch.utils.config import default_dtype, get_config


def _device():
    return torch.device(get_config().device)


def as_tensor(x, like=None):
    """A python scalar as a 0-d tensor of `like`'s dtype and device (the
    value dtype on the configured device when `like` is not a tensor)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(like, torch.Tensor):
        dtype = like.dtype if like.is_floating_point() else default_dtype()
        return torch.tensor(float(x), dtype=dtype, device=like.device)
    return torch.tensor(float(x), dtype=default_dtype(), device=_device())


def _operands(a, b):
    a, b = (v.item() if isinstance(v, np.generic) else v for v in (a, b))
    for v in (a, b):
        if not isinstance(v, (torch.Tensor, bool, int, float)):
            raise NotImplementedError(
                f"cellwise op on {type(v).__name__}: only dense tensors and "
                f"scalars are ported (ROADMAP queue 1: sparse plane, "
                f"compressed LA)")
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = as_tensor(a)
    if isinstance(a, bool):
        a = float(a)
    if isinstance(b, bool):
        b = float(b)
    return a, b


def _result_dtype(a, b):
    for x in (a, b):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.dtype
    return default_dtype()


def _bool(mask, a, b):
    """Relational/logical results materialize as 0/1 in the value dtype."""
    return mask.to(_result_dtype(a, b))


def _truthy(x):
    if isinstance(x, torch.Tensor):
        return x != 0
    return bool(x)


def _logical(fn, a, b):
    ta, tb = _truthy(a), _truthy(b)
    if not isinstance(ta, torch.Tensor):
        ta = torch.tensor(ta, device=tb.device)
    if not isinstance(tb, torch.Tensor):
        tb = torch.tensor(tb, device=ta.device)
    return _bool(fn(ta, tb), a, b)


_ARITH = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "^": lambda a, b: a ** b,
    # torch's % and // on tensors are remainder and floor division: R's
    # %% (sign of the divisor) and %/% (floor)
    "%%": lambda a, b: a % b, "%/%": lambda a, b: a // b,
}
_REL = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
}


def binary_op(op: str, a, b):
    """Dispatch a DML binary operator to torch. a/b: tensor or python
    scalar; a scalar pair is lifted to a tensor (the evaluator computes
    host scalar pairs itself before it gets here)."""
    a, b = _operands(a, b)
    if op in _ARITH:
        return _ARITH[op](a, b)
    if op in _REL:
        return _bool(_REL[op](a, b), a, b)
    if op == "&":
        return _logical(torch.logical_and, a, b)
    if op == "|":
        return _logical(torch.logical_or, a, b)
    if op == "xor":
        return _logical(torch.logical_xor, a, b)
    if op in ("min", "max"):
        fn = torch.minimum if op == "min" else torch.maximum
        return fn(as_tensor(a, b), as_tensor(b, a))
    if op.startswith("bitw"):
        raise NotImplementedError(
            f"{op} waits for ROADMAP queue 1, algorithm breadth")
    raise ValueError(f"unknown binary op {op!r}")


def _round_half_up(x):
    # DML round = Math.round = half-up; torch.round is banker's rounding
    return torch.floor(x + 0.5)


def _not(x):
    return torch.eq(x, 0).to(x.dtype if x.is_floating_point()
                             else default_dtype())


def _neg(x):
    # booleans are 0/1 under arithmetic
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return torch.neg(x)


_UNARY = {
    "abs": torch.abs, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "floor": torch.floor, "ceiling": torch.ceil, "ceil": torch.ceil,
    "round": _round_half_up, "sign": torch.sign,
    "sigmoid": torch.sigmoid, "!": _not, "-": _neg,
    "sprop": lambda v: v * (1.0 - v),  # sample proportion x*(1-x)
    "isNA": lambda v: torch.isnan(v).to(v.dtype),
    "isNaN": lambda v: torch.isnan(v).to(v.dtype),
    "isInf": lambda v: torch.isinf(v).to(v.dtype),
}


def unary_op(op: str, x):
    """Dispatch a DML unary builtin (abs/sin/.../sigmoid) to torch."""
    if isinstance(x, (bool, int, float)):
        x = as_tensor(x)
    if not isinstance(x, torch.Tensor):
        raise NotImplementedError(
            f"unary {op} on {type(x).__name__}: only dense tensors are "
            f"ported (ROADMAP queue 1: sparse plane, compressed LA)")
    fn = _UNARY.get(op)
    if fn is None:
        raise NotImplementedError(
            f"unary {op!r} waits for ROADMAP queue 1, algorithm "
            f"breadth")
    return fn(x)


def log_base(x, base):
    return torch.log(x) / math.log(base)
