"""Aggregations: full, row-wise, column-wise, cumulative, statistical.

Port of systemml_tpu/ops/agg.py, dense, sparse and compressed branches.
DML shape conventions as there: full aggregates return scalars (0-d
tensors; a compressed operand's full sum, min, max and mean are host
floats, as in the JAX package), rowX returns (n,1), colX returns (1,m).
A sparse operand aggregates its stored values in O(nnz) on its device
(sum, min and max with its implicit zeros, mean, nnz, sumsq, row and
column sums); an ELL view (a loop region's) its full and row sums; any
other aggregate densifies, as in the JAX package. `compensated_sum`
folds pairwise with TwoSum (kahan_sum), in the JAX package's fold order.
Grouped sums are deterministic on the card (segment_sum): no float
atomics, so a repeat gives the same bits.
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
        if direction == "all":
            return kahan_sum(x)
        return _keep(direction, kahan_sum_axis(
            x, 1 if direction == "row" else 0))
    if op in ("indexmax", "indexmin"):
        # 1-based, in x's dtype; the first index wins a tie and a NaN
        # counts as the extreme, as jnp.argmax / argmin
        fn = torch.argmax if op == "indexmax" else torch.argmin
        return _keep(direction, (fn(x, dim=1 if direction == "row" else 0)
                                 + 1).to(x.dtype))
    if op == "nnz":
        return _reduce(lambda v, dim=None: torch.sum(
            (v != 0).to(v.dtype), dim=dim), x, direction)
    fn = _AGGS.get(op)
    if fn is None:
        raise ValueError(f"unknown aggregate {op!r}")
    return _reduce(fn, x, direction)


def cumagg(op: str, x):
    """Column-wise cumulative aggregate (reference: UnaryCP ucum*). On the
    card cumsum is a parallel scan: fp32 sums differ from the CPU's
    sequential order in the last bits."""
    x = sp.ensure_dense(x.to_dense() if is_compressed(x) else x)
    if op == "cumsum":
        return torch.cumsum(x, dim=0)
    if op == "cumprod":
        return torch.cumprod(x, dim=0)
    if op == "cummin":
        return torch.cummin(x, dim=0).values
    if op == "cummax":
        return torch.cummax(x, dim=0).values
    raise ValueError(f"unknown cumulative aggregate {op!r}")


def cumsumprod(x):
    """cumsumprod(cbind(a, b)): Y[i] = a[i] + b[i] * Y[i-1], Y[0] = a[0]
    (reference: udf/lib/CumSumProd.java). The JAX package scans it in
    order; here the affine maps y -> a + b y compose in log2(n) doubling
    steps, so a long column is not n launches. The sums associate
    differently: agreement is to rounding, not bit for bit."""
    a, b = x[:, 0].clone(), x[:, 1].clone()
    a[0] = a[0] + b[0] * 0.0   # Y[-1] = 0
    b[0] = 0.0
    d = 1
    n = a.shape[0]
    while d < n:
        # (a, b)[i] after (a, b)[i-d]: a[i] + b[i] a[i-d], b[i] b[i-d]
        a2 = a.clone()
        b2 = b.clone()
        a2[d:] = a[d:] + b[d:] * a[:-d]
        b2[d:] = b[d:] * b[:-d]
        a, b = a2, b2
        d *= 2
    return a.reshape(-1, 1)


def moment(x, k, weights=None):
    """Central moment of a column vector (reference: CM function object);
    k = 2 is the unbiased variance, as the reference's CM."""
    v = x.reshape(-1)
    k = int(k)
    if weights is None:
        mu = torch.mean(v)
        if k == 2:
            return torch.sum((v - mu) ** 2) / (v.shape[0] - 1)
        return torch.mean((v - mu) ** k)
    w = weights.reshape(-1)
    wsum = torch.sum(w)
    mu = torch.sum(v * w) / wsum
    if k == 2:
        return torch.sum(w * (v - mu) ** 2) / (wsum - 1)
    return torch.sum(w * (v - mu) ** k) / wsum


def cov(x, y, weights=None):
    """Covariance of two column vectors (reference: COV function object)."""
    v1, v2 = x.reshape(-1), y.reshape(-1)
    if weights is None:
        mu1, mu2 = torch.mean(v1), torch.mean(v2)
        return torch.sum((v1 - mu1) * (v2 - mu2)) / (v1.shape[0] - 1)
    w = weights.reshape(-1)
    wsum = torch.sum(w)
    mu1 = torch.sum(v1 * w) / wsum
    mu2 = torch.sum(v2 * w) / wsum
    return torch.sum(w * (v1 - mu1) * (v2 - mu2)) / (wsum - 1)


def segment_sum(idx, vals, n: int):
    """out[j] = sum of vals[i] over idx[i] == j, with no float atomics: a
    stable sort by idx, a segmented doubling scan (log2(len) passes, each
    a fixed order), and one store per segment's last element. The same
    inputs give the same bits on every run; no host read, so a captured
    region may run it. Indices as jnp's .at[].add: a negative one counts
    from the end, one out of range is dropped."""
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    order = torch.argsort(idx, stable=True)
    key = idx[order]
    v = vals[order]
    m = key.shape[0]
    d = 1
    while d < m:
        same = key[d:] == key[:-d]
        v2 = v.clone()
        v2[d:] = v[d:] + torch.where(same, v[:-d], torch.zeros_like(v[:-d]))
        v = v2
        d *= 2
    last = torch.ones(m, dtype=torch.bool, device=key.device)
    last[:-1] = key[1:] != key[:-1]
    # every other element (and the dropped ones) writes a spare slot
    slot = torch.where(last, key, torch.full_like(key, n))
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    out.scatter_(0, slot, v)
    return out[:n]


def segment_count(idx, n: int, dtype):
    """How often each of 0..n-1 occurs in idx (indices as segment_sum's),
    counted in int64 (integer atomics: exact and deterministic), in
    `dtype`."""
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    c = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    c.index_add_(0, idx, torch.ones_like(idx))
    return c[:n].to(dtype)


def aggregate_grouped(target, groups, fn: str, ngroups: int, weights=None):
    """groupedAggregate (reference: ParameterizedBuiltin GROUPEDAGG):
    per-group count, sum, mean, variance, sd and central moments over a
    column vector, groups 1-based ids."""
    t = target.reshape(-1)
    g = groups.reshape(-1).to(torch.int64) - 1
    n = int(ngroups)
    if weights is not None:
        t = t * weights.reshape(-1)
    count = segment_count(g, n, t.dtype)
    if fn == "count":
        return count.reshape(-1, 1)
    s = segment_sum(g, t, n)
    if fn == "sum":
        return s.reshape(-1, 1)
    mean = s / torch.clamp(count, min=1)
    if fn == "mean":
        return mean.reshape(-1, 1)
    dev = t - mean[g.clamp(-n, n - 1)]   # jnp's gather clamps
    m2 = segment_sum(g, dev * dev, n)
    if fn in ("variance", "var"):
        return (m2 / torch.clamp(count - 1, min=1)).reshape(-1, 1)
    if fn == "sd":
        return torch.sqrt(m2 / torch.clamp(count - 1, min=1)).reshape(-1, 1)
    if fn.startswith("centralmoment"):
        mk = segment_sum(g, dev ** int(fn[-1]), n)
        return (mk / torch.clamp(count, min=1)).reshape(-1, 1)
    raise ValueError(f"unknown grouped aggregate {fn!r}")


def _fold(x, comp):
    """One pairwise TwoSum fold along dim 0: the halves' sums, and the
    compensation of both halves plus the fold's exact rounding error."""
    m = x.shape[0]
    if m % 2:
        pad = x.new_zeros((1,) + tuple(x.shape[1:]))
        x = torch.cat([x, pad])
        comp = torch.cat([comp, pad])
        m += 1
    a, b = x[: m // 2], x[m // 2:]
    s = a + b
    bv = s - a
    err = (a - (s - bv)) + (b - bv)
    return s, comp[: m // 2] + comp[m // 2:] + err


def kahan_sum(x):
    """Compensated full sum (the `compensated_sum` mode): log2(n) pairwise
    TwoSum folds, the rounding errors carried in a parallel compensation
    array, in the JAX package's fold order."""
    flat = x.reshape(-1)
    if flat.shape[0] == 0:
        return torch.zeros((), dtype=flat.dtype, device=flat.device)
    comp = torch.zeros_like(flat)
    while flat.shape[0] > 1:
        flat, comp = _fold(flat, comp)
    return flat[0] + comp[0]


def kahan_sum_axis(x, axis: int):
    """Compensated row (axis 1) or column (axis 0) sums: the same folds
    along one axis."""
    if axis == 1:
        return kahan_sum_axis(x.T, 0)
    comp = torch.zeros_like(x)
    while x.shape[0] > 1:
        x, comp = _fold(x, comp)
    return x[0] + comp[0]
