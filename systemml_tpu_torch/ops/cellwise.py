"""Cellwise (elementwise) matrix/scalar operations.

Port of systemml_tpu/ops/cellwise.py, dense branches. DML semantics as
there:
- booleans materialize as 0.0/1.0 in the value dtype,
- `/` is true division (inf/nan propagate as in R),
- `%%` / `%/%` follow R semantics (sign of divisor; intdiv = floor),
- broadcasting covers matrix-scalar, matrix-rowvector, matrix-colvector.
A compressed operand with a host scalar maps its dictionaries only for
* / + - ^ min max (and a scalar on the left for * + -), and a compressed
operand of a unary op likewise; any other op on it decompresses, as in
the JAX package. A sparse operand (runtime/sparse.py) stays sparse where
the op preserves zeros, as there: a scalar * / ^ + - that keeps zeros,
`X != 0` and `X > 0` (ALS's W = (V != 0)), sparse + - * sparse, sparse *
dense (the pattern kept), and the zero-preserving unary ops; any other
op densifies it. An ELL view (a loop region's) takes the same
zero-preserving scalar ops and ELL * dense on its values, all sync-free.
The bitw ops take the values truncated to int64, as the JAX package's
under x64. Double-float operands wait (ROADMAP queue 1, precision
policies).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from systemml_tpu_torch.compress import is_compressed
from systemml_tpu_torch.runtime import sparse as sp
from systemml_tpu_torch.utils.config import default_dtype, get_config


def _device():
    return torch.device(get_config().device)


def as_tensor(x, like=None):
    """A python scalar as a 0-d tensor of `like`'s dtype and device (the
    value dtype on the configured device when `like` is not a tensor).
    Filled on the device (torch.full), never copied from the host: no
    synchronisation, and a captured CUDA graph may hold it."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(like, torch.Tensor):
        dtype = like.dtype if like.is_floating_point() else default_dtype()
        return torch.full((), float(x), dtype=dtype, device=like.device)
    return torch.full((), float(x), dtype=default_dtype(), device=_device())


def _operands(a, b):
    a, b = (v.item() if isinstance(v, np.generic) else v for v in (a, b))
    for v in (a, b):
        if not isinstance(v, (torch.Tensor, bool, int, float)):
            raise NotImplementedError(
                f"cellwise op on {type(v).__name__}: only dense tensors, "
                f"sparse and compressed matrices and scalars are ported")
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
        ta = torch.full((), ta, device=tb.device)
    if not isinstance(tb, torch.Tensor):
        tb = torch.full((), tb, device=ta.device)
    return _bool(fn(ta, tb), a, b)


def _floor_div(a, b):
    """a %/% b: torch's floor division, NaN where the divisor is 0 (as
    jnp.floor_divide and the port's scalar path; torch gives +-Inf)."""
    q = a // b
    if not (isinstance(q, torch.Tensor) and q.is_floating_point()):
        return q
    zero = b == 0 if isinstance(b, torch.Tensor) else torch.full(
        (), b == 0, device=q.device)
    return torch.where(zero, torch.full((), math.nan, dtype=q.dtype,
                                        device=q.device), q)


_ARITH = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "^": lambda a, b: a ** b,
    # torch's % and // on tensors are remainder and floor division: R's
    # %% (sign of the divisor) and %/% (floor)
    "%%": lambda a, b: a % b, "%/%": _floor_div,
}
_REL = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
}


def _binary_compressed(op: str, a, b):
    """Compressed scalar ops run on dictionaries only (reference:
    CompressedMatrixBlock.scalarOperations). None -> caller decompresses."""
    scalar = lambda v: isinstance(v, (int, float, bool))
    if is_compressed(a) and scalar(b):
        bf = float(b)
        if op in ("*", "/", "+", "-", "^", "min", "max"):
            fns = {"*": lambda d: d * bf, "/": lambda d: d / bf,
                   "+": lambda d: d + bf, "-": lambda d: d - bf,
                   "^": lambda d: d ** bf,
                   "min": lambda d: np.minimum(d, bf),
                   "max": lambda d: np.maximum(d, bf)}
            return a.value_map(fns[op])
    if scalar(a) and is_compressed(b):
        af = float(a)
        if op in ("*", "+"):
            return b.value_map(lambda d: d * af if op == "*" else d + af)
        if op == "-":
            return b.value_map(lambda d: af - d)
    return None


def _scalar(v) -> bool:
    return isinstance(v, (int, float, bool))


def _binary_ell(op: str, a, b):
    """Zero-preserving binary ops on an ELL view (runtime/sparse.EllMatrix),
    which run inside loop regions: no host read. None -> the caller
    densifies."""
    if sp.is_ell(a) and _scalar(b):
        bf = float(b)
        if op == "*":
            return a.value_map(lambda d: d * bf)
        if op == "/" and bf != 0:
            return a.value_map(lambda d: d * (1.0 / bf))
        if op == "^" and bf > 0:
            return a.value_map(lambda d: d ** bf)
        if op in ("+", "-") and bf == 0:
            return a
        return None
    if _scalar(a) and sp.is_ell(b):
        if op == "*":
            af = float(a)
            return b.value_map(lambda d: d * af)
        return None
    # ell * dense of the same shape: only the stored cells of the dense
    # side are read (ALS's W * (V - A %*% t(B)) stays sparse)
    if op == "*" and sp.is_ell(a) and isinstance(b, torch.Tensor) \
            and tuple(b.shape) == a.shape:
        return a.mul_dense(b)
    if op == "*" and sp.is_ell(b) and isinstance(a, torch.Tensor) \
            and tuple(a.shape) == b.shape:
        return b.mul_dense(a)
    return None


def _same_pattern(a, b) -> bool:
    return a.indptr is b.indptr and a.indices is b.indices


def _binary_sparse(op: str, a, b):
    """Sparse-preserving binary ops (reference: MatrixBlock's sparse-safe
    scalar and binary operations). None -> the caller densifies."""
    if sp.is_sparse(a) and _scalar(b):
        bf = float(b)
        if op == "*":
            return a.scale(bf)
        if op == "/" and bf != 0:
            return a.scale(1.0 / bf)
        if op == "^" and bf > 0:
            return a.value_map(lambda d: d ** bf)
        if op in ("+", "-") and bf == 0:
            return a
        if op == "!=" and bf == 0:
            # the (V != 0) rating mask: zero-preserving, V's pattern
            return a.value_map(lambda d: (d != 0).to(d.dtype))
        if op == ">" and bf == 0:
            return a.value_map(lambda d: (d > 0).to(d.dtype))
        return None
    if _scalar(a) and sp.is_sparse(b):
        af = float(a)
        if op == "*":
            return b.scale(af)
        if op == "+" and af == 0:
            return b
        return None
    if sp.is_sparse(a) and sp.is_sparse(b) and a.shape == b.shape:
        if op == "*" and _same_pattern(a, b):
            # W * V with W = (V != 0): one pattern, the values multiplied
            out = _drop_zeros(a.with_values(a.data * b.data))
            out._from = ("mul2", a, b)
            return out
        if op in ("+", "-", "*"):
            out = _sparse_sparse(op, a, b)
            if op == "*":
                out = _drop_zeros(out)
                out._from = ("mul2", a, b)
            return out
    # sparse * dense keeps the sparse pattern
    if op == "*" and sp.is_sparse(a) and isinstance(b, torch.Tensor) \
            and tuple(b.shape) == a.shape:
        return a.with_values(a.data * b[a.rows(), a.indices])
    if op == "*" and sp.is_sparse(b) and isinstance(a, torch.Tensor) \
            and tuple(a.shape) == b.shape:
        return b.with_values(a[b.rows(), b.indices] * b.data)
    return None


def mask_mul(m, x):
    """m * x where m is a 0/1 mask: x where m is set, +0 elsewhere,
    whatever x holds there (NaN, Inf, a negative number). A mask that is
    broadcast against x keeps the IEEE product, as in the JAX package."""
    m, x = as_tensor(m, x), as_tensor(x, m)
    if m.dim() and tuple(m.shape) != tuple(torch.broadcast_shapes(
            m.shape, x.shape)):
        return m * x
    dt = _result_dtype(m, x)
    return torch.where(m != 0, x.to(dt), torch.zeros((), dtype=dt,
                                                     device=x.device))


def _drop_zeros(m):
    """`m` without its stored zeros, as scipy's sparse product stores none
    (a -0 among them; NaN stays)."""
    keep = m.data != 0
    if bool(keep.all()):
        return m
    return sp.SparseMatrix.from_coo(m.rows()[keep], m.indices[keep],
                                    m.data[keep], m.shape)


def _sparse_sparse(op: str, a, b):
    """a + b, a - b (the union of the patterns) or a * b (the
    intersection) of two CSR matrices of one shape, as scipy's."""
    n = a.shape[1]
    ka = a.rows() * n + a.indices
    kb = b.rows() * n + b.indices
    dt = torch.promote_types(a.dtype, b.dtype)
    if op == "*":
        pos = torch.searchsorted(kb, ka).clamp(max=max(kb.numel() - 1, 0))
        hit = kb[pos] == ka if kb.numel() else torch.zeros_like(ka, dtype=bool)
        keys = ka[hit]
        vals = a.data[hit].to(dt) * b.data[pos[hit]].to(dt)
    else:
        keys = torch.cat([ka, kb])
        vals = torch.cat([a.data.to(dt),
                          b.data.to(dt) if op == "+" else -b.data.to(dt)])
    return sp.SparseMatrix.from_coo(keys // n, keys % n, vals, a.shape)


def binary_op(op: str, a, b, mask: Optional[int] = None):
    """Dispatch a DML binary operator to torch. a/b: tensor or python
    scalar; a scalar pair is lifted to a tensor (the evaluator computes
    host scalar pairs itself before it gets here). `mask` is the position
    of a `*`'s mask operand (`hops.hop.mask_operand`): the dense product
    is then `where(mask, other, +0)`. The sparse and compressed arms keep
    their own products."""
    if is_compressed(a) or is_compressed(b):
        r = _binary_compressed(op, a, b)
        if r is not None:
            return r
        a = a.to_dense() if is_compressed(a) else a
        b = b.to_dense() if is_compressed(b) else b
    if sp.is_ell(a) or sp.is_ell(b):
        r = _binary_ell(op, a, b)
        if r is not None:
            return r
        a, b = sp.ensure_dense(a), sp.ensure_dense(b)
    if sp.is_sparse(a) or sp.is_sparse(b):
        r = _binary_sparse(op, a, b)
        if r is not None:
            return r
        a, b = sp.ensure_dense(a), sp.ensure_dense(b)
    a, b = _operands(a, b)
    if op == "*" and mask is not None:
        return mask_mul(*((a, b) if mask == 0 else (b, a)))
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
    if op in _BITW:
        ai = as_tensor(a, b).to(torch.int64)
        bi = as_tensor(b, a).to(torch.int64)
        return _BITW[op](ai, bi).to(_result_dtype(a, b))
    raise ValueError(f"unknown binary op {op!r}")


# bitwAnd and its kin on the values truncated to int64, as the JAX
# package's _bitw under x64
_BITW = {
    "bitwAnd": torch.bitwise_and, "bitwOr": torch.bitwise_or,
    "bitwXor": torch.bitwise_xor, "bitwShiftL": torch.bitwise_left_shift,
    "bitwShiftR": torch.bitwise_right_shift,
}


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


def _pole(v):
    return (v <= 0) & (v == torch.floor(v))


_UNARY = {
    "abs": torch.abs, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "floor": torch.floor, "ceiling": torch.ceil, "ceil": torch.ceil,
    "round": _round_half_up,
    # torch.sign(NaN) is 0; jnp.sign(NaN) is NaN
    "sign": lambda v: torch.where(torch.isnan(v), v, torch.sign(v)),
    "sigmoid": torch.sigmoid, "!": _not, "-": _neg,
    "sprop": lambda v: v * (1.0 - v),  # sample proportion x*(1-x)
    # reference: Builtin GAMMA/LGAMMA/DIGAMMA/TRIGAMMA
    "gamma": lambda v: torch.exp(torch.lgamma(v)),
    "lgamma": torch.lgamma,
    # at 0 and the negative integers (the poles) jax.scipy gives NaN for
    # digamma and +Inf for trigamma; torch gives -Inf and a finite value
    "digamma": lambda v: torch.where(_pole(v), torch.nan,
                                     torch.special.digamma(v)),
    "trigamma": lambda v: torch.where(_pole(v), torch.inf,
                                      torch.special.polygamma(1, v)),
    "isNA": lambda v: torch.isnan(v).to(v.dtype),
    "isNaN": lambda v: torch.isnan(v).to(v.dtype),
    "isInf": lambda v: torch.isinf(v).to(v.dtype),
}


# f(0) == 0: safe on a sparse matrix's stored values alone (reference: the
# "sparse-safe" flags of the Builtin function objects)
_ZERO_PRESERVING = {"abs", "sin", "tan", "sinh", "tanh", "sqrt", "sign",
                    "floor", "ceil", "ceiling", "round", "-", "sprop",
                    "asin", "atan"}


def unary_op(op: str, x):
    """Dispatch a DML unary builtin (abs/sin/.../sigmoid) to torch."""
    if is_compressed(x):
        # any elementwise fn maps over dictionaries (zero need not be
        # preserved: dictionaries hold explicit values)
        return x.value_map(
            lambda d: unary_op(op, torch.from_numpy(d)).numpy())
    if sp.is_ell(x) or sp.is_sparse(x):
        if op in _ZERO_PRESERVING:
            return x.value_map(lambda d: unary_op(op, d))
        x = x.to_dense()
    if isinstance(x, (bool, int, float)):
        x = as_tensor(x)
    if not isinstance(x, torch.Tensor):
        raise NotImplementedError(
            f"unary {op} on {type(x).__name__}: only dense tensors, sparse "
            f"and compressed matrices are ported")
    fn = _UNARY.get(op)
    if fn is None:
        raise NotImplementedError(
            f"unary {op!r} waits for ROADMAP queue 1, algorithm "
            f"breadth")
    return fn(x)


def log_base(x, base):
    if isinstance(x, torch.Tensor) and not x.is_floating_point():
        # torch.log of an int tensor is float32: a DML int (a region's
        # 0-d int64) takes the value dtype, as the host path does
        x = x.to(default_dtype(x.device))
    return torch.log(x) / math.log(base)
