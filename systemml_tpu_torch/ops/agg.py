"""Aggregations: full, row-wise and column-wise.

Port of systemml_tpu/ops/agg.py, dense, sparse and compressed branches.
DML shape conventions as there: full aggregates return scalars (0-d
tensors; a compressed operand's full sum, min, max and mean are host
floats, as in the JAX package), rowX returns (n,1), colX returns (1,m).
A sparse operand aggregates its stored values in O(nnz) on its device
(sum, min and max with its implicit zeros, mean, nnz, sumsq, row and
column sums); an ELL view (a loop region's) its full and row sums; any
other aggregate densifies, as in the JAX package.
Kahan-compensated sums (`compensated_sum`, off by default), cumulative
and statistical aggregates wait (ROADMAP queue 1, algorithm breadth).
"""

from __future__ import annotations

import torch

from systemml_tpu_torch.compress import is_compressed
from systemml_tpu_torch.runtime import sparse as sp
from systemml_tpu_torch.utils.config import default_dtype, get_config


def _keep(direction: str, r):
    if direction == "all":
        return r
    return r.reshape(-1, 1) if direction == "row" else r.reshape(1, -1)


def _reduce(fn, x, direction: str):
    if direction == "all":
        return fn(x)
    return _keep(direction, fn(x, dim=1 if direction == "row" else 0))


def _minmax(fn):
    def f(x, dim=None):
        return fn(x) if dim is None else fn(x, dim=dim).values
    return f


_AGGS = {
    "sum": torch.sum,
    "mean": torch.mean,
    "min": _minmax(torch.min),
    "max": _minmax(torch.max),
    "prod": lambda x, dim=None: torch.prod(x) if dim is None
    else torch.prod(x, dim=dim),
    "var": lambda x, dim=None: torch.var(x, dim=dim, correction=1),
    "sd": lambda x, dim=None: torch.std(x, dim=dim, correction=1),
    "sumsq": lambda x, dim=None: torch.sum(x * x, dim=dim),
}


def _agg_compressed(op: str, x, direction: str):
    """Aggregates over dictionaries + counts, no decompression (reference:
    CompressedMatrixBlock.aggregateUnaryOperations). None -> the caller
    decompresses."""
    if direction == "all":
        if op == "sum":
            return x.sum()
        if op in ("min", "max"):
            return x.minmax(op)
        if op == "mean":
            return x.sum() / (x.shape[0] * x.shape[1])
        return None
    if direction == "col":
        if op == "sum":
            return _keep("col", _device_vector(x.col_sums()))
        if op in ("min", "max"):
            return _keep("col", _device_vector(x.col_minmax(op)))
    return None


def _agg_sparse(op: str, x, direction: str):
    """O(nnz) aggregates of a CSR matrix (reference: LibMatrixAgg's sparse
    paths). None -> the caller densifies."""
    if direction == "all":
        if op == "sum":
            return x.sum()
        if op in ("min", "max"):
            return x.minmax(op)
        if op == "nnz":
            return float(x.nnz)
        if op == "sumsq":
            return (x.data.double() ** 2).sum().to(x.dtype)
        if op == "mean":
            return x.sum() / (x.shape[0] * x.shape[1])
        return None
    if op == "sum":
        return _keep(direction, x.row_sums() if direction == "row"
                     else x.col_sums())
    return None


def _device_vector(v):
    return torch.as_tensor(v, dtype=default_dtype(),
                           device=get_config().device)


def agg(op: str, x, direction: str = "all"):
    if is_compressed(x):
        r = _agg_compressed(op, x, direction)
        if r is not None:
            return r
        x = x.to_dense()  # no compressed form of this aggregate
    if sp.is_ell(x):
        if op == "sum" and direction == "all":
            return x.sum()
        if op == "sum" and direction == "row":
            return x.row_sums()
        x = x.to_dense()  # min, max, col-wise: pad slots would leak zeros
    if sp.is_sparse(x):
        r = _agg_sparse(op, x, direction)
        if r is not None:
            return r
        x = x.to_dense()  # no O(nnz) form of this aggregate
    if not isinstance(x, torch.Tensor) or x.layout != torch.strided:
        raise NotImplementedError(
            f"aggregate {op} on {type(x).__name__}: only dense, sparse "
            f"and compressed operands are ported")
    if op == "sum" and get_config().compensated_sum:
        raise NotImplementedError(
            "compensated_sum waits for ROADMAP queue 1, algorithm "
            "breadth")
    fn = _AGGS.get(op)
    if fn is None:
        raise NotImplementedError(
            f"aggregate {op!r} waits for ROADMAP queue 1, algorithm "
            f"breadth")
    return _reduce(fn, x, direction)
