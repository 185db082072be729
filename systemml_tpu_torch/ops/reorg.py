"""Reorganization: transpose, concatenation, reshape, indexing.

Port of systemml_tpu/ops/reorg.py. `transpose` returns the transposed
VIEW of a dense matrix, never a copy: matmult and tsmm hand the view to
cuBLAS as a transposed operand, so `t(X) %*% y` over an 8 GB X costs no
second X. A sparse matrix transposes and slices in CSR (a small slice
densifies, as in the JAX package); an ELL view transposes through its
dense form; every other op, and a concat with any sparse or compressed
operand, densifies. Indexing with device bounds (the fused-loop
minibatch path, which a loop region refuses for now) waits (ROADMAP
queue 1: fused loop regions' follow-ups). A compressed operand is
decompressed first, as in the JAX package.
"""

from __future__ import annotations

import torch

from systemml_tpu_torch.compress import is_compressed
from systemml_tpu_torch.runtime import sparse as sp


def _dense(x):
    x = sp.ensure_dense(x)
    if not isinstance(x, torch.Tensor) or x.layout != torch.strided:
        raise NotImplementedError(
            f"reorg on {type(x).__name__}: only dense, sparse and "
            f"compressed matrices are ported")
    return x


def transpose(x):
    if sp.is_sparse(x):
        return x.transpose()
    return _dense(x).T   # an ELL view: no cheap transpose of its rows


def rev(x):
    """Reverse row order (reference: LibMatrixReorg.rev)."""
    return torch.flip(_dense(x), dims=(0,))


def diag(x):
    """Vector (n,1) -> diagonal matrix; matrix -> main diagonal as (n,1)
    (reference: ReorgOp DIAG, LibMatrixReorg.diag)."""
    x = _dense(x)
    if x.shape[1] == 1:
        return torch.diag(x.reshape(-1))
    return torch.diagonal(x).reshape(-1, 1)


def reshape(x, rows: int, cols: int, byrow: bool = True):
    """matrix(X, rows, cols, byrow) (reference: ReorgOp RESHAPE).
    byrow=True reads/fills row-major (DML default), False column-major."""
    x = _dense(x)
    if byrow:
        return x.reshape(rows, cols)
    return x.T.reshape(-1).reshape(cols, rows).T


def _concat(xs, dim):
    xs = [_dense(x) for x in xs]
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return torch.cat([x.to(dtype) for x in xs], dim=dim)


def cbind(*xs):
    return _concat([x if x.ndim == 2 else x.reshape(-1, 1) for x in xs], 1)


def rbind(*xs):
    return _concat(xs, 0)


def right_index(x, rl, ru, cl, cu):
    """X[rl:ru, cl:cu] with 1-based inclusive static bounds (a view). A
    sparse X slices in CSR; a slice of at most 4096 cells densifies
    (scalar extraction, per-row loops: CSR bookkeeping costs more than the
    cells), as in the JAX package."""
    if sp.is_sparse(x):
        out = x.slice(rl - 1, ru, cl - 1, cu)
        if out.shape[0] * out.shape[1] <= 4096:
            return out.to_dense()
        return out
    return _dense(x)[rl - 1:ru, cl - 1:cu]


def left_index(x, y, rl, ru, cl, cu):
    """X[rl:ru, cl:cu] = Y, copy-on-write like the reference's
    LeftIndexingOp. A scalar y broadcasts over the whole range; a genuine
    matrix must have the range's shape."""
    out = _dense(x).clone()
    if isinstance(y, torch.Tensor) and y.ndim > 0:
        y = y.reshape(ru - rl + 1, cu - cl + 1)
    out[rl - 1:ru, cl - 1:cu] = y
    return out


def sort_matrix(x, by: int = 1, decreasing: bool = False,
                index_return: bool = False):
    """order(target=X, by=col, decreasing, index.return) (reference:
    ReorgOp SORT): a stable sort of the rows on one column; NaN goes
    last. Decreasing is the stable ascending sort of -key, which keeps
    ties in their order (not the reverse of the ascending one).
    index.return gives the 1-based row indices as a column."""
    x = _dense(x)
    key = x[:, by - 1]
    idx = torch.sort(-key if decreasing else key, stable=True).indices
    if index_return:
        return (idx + 1).to(x.dtype).reshape(-1, 1)
    return x[idx, :]


def _tri(x, upper: bool, diag_val: bool, values: bool):
    x = _dense(x)
    r = torch.arange(x.shape[0], device=x.device).reshape(-1, 1)
    c = torch.arange(x.shape[1], device=x.device).reshape(1, -1)
    if upper:
        mask = (c >= r) if diag_val else (c > r)
    else:
        mask = (c <= r) if diag_val else (c < r)
    src = x if values else torch.ones_like(x)
    return torch.where(mask, src, torch.zeros_like(src))


def lower_tri(x, diag_val: bool = True, values: bool = True):
    """lower.tri(target=X, diag=, values=) (reference: ParameterizedBuiltin
    LOWER_TRI): the cells below (and on, with diag) the diagonal, their
    values or 1."""
    return _tri(x, False, diag_val, values)


def upper_tri(x, diag_val: bool = True, values: bool = True):
    return _tri(x, True, diag_val, values)
