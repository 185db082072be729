"""Parameterized builtins: table (ctable), removeEmpty, replace, rexpand,
outer, quantile/median/IQM, cdf/invcdf.

Port of systemml_tpu/ops/param.py:24-220. Semantics as there, each on
the operand's device:
- `table` adds without float atomics (agg.segment_sum / segment_count),
  so a weighted table repeats bit for bit on the card; counts are exact
  integers. Without dims it reads max(A) and max(B) on the host.
- `remove_empty`'s output shape is the data's: it reads the mask's count
  on the host (a boolean index), as the JAX package's numpy path does.
- `cdf` for t and F evaluates the regularized incomplete beta (`betainc`)
  as XLA's Lentz continued fraction in torch ops; `invcdf` for t, chisq
  and F goes through scipy on the host, as the JAX package (every use in
  the scripts is on scalars).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from systemml_tpu_torch.compiler.lower import current_region
from systemml_tpu_torch.ops import agg
from systemml_tpu_torch.runtime import sparse as sp
from systemml_tpu_torch.utils.config import default_dtype, get_config


def _vec(v, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A matrix as a flat tensor; a host scalar as a one-element one."""
    if isinstance(v, torch.Tensor):
        return sp.ensure_dense(v).reshape(-1)
    dev = like.device if like is not None else torch.device(
        get_config().device)
    return torch.full((1,), float(v), dtype=default_dtype(dev), device=dev)


def table(i, j, w=1.0, dim1: Optional[int] = None,
          dim2: Optional[int] = None):
    """table(A, B[, W][, odim1, odim2]): the contingency table of 1-based
    category vectors (reference: ctable, LibMatrixBincell). Pairs with an
    id <= 0 or past the dims are skipped. A scalar B (or W) applies to
    every row, as jnp.full_like there."""
    iv = _vec(i)
    jv = _vec(j, iv)
    n = max(iv.shape[0], jv.shape[0])
    iv, jv = iv.expand(n), jv.expand(n)
    if dim1 is None:
        dim1 = int(torch.max(iv).item())
    if dim2 is None:
        dim2 = int(torch.max(jv).item())
    d1, d2 = int(dim1), int(dim2)
    ii = iv.to(torch.int64) - 1
    jj = jv.to(torch.int64) - 1
    valid = (ii >= 0) & (jj >= 0) & (ii < d1) & (jj < d2)
    # the dropped pairs go to index d1 * d2, past the table
    lin = torch.where(valid, ii * d2 + jj, torch.full_like(ii, d1 * d2))
    if isinstance(w, torch.Tensor) and w.numel() > 1:
        wv = sp.ensure_dense(w).reshape(-1)
        out = agg.segment_sum(
            lin, torch.where(valid, wv, torch.zeros_like(wv)), d1 * d2)
    else:
        dtype = (iv.dtype if iv.is_floating_point()
                 else default_dtype(iv.device))
        c = agg.segment_count(lin, d1 * d2, dtype)
        wt = w.reshape(()).to(dtype) if isinstance(w, torch.Tensor) \
            else torch.full((), float(w), dtype=dtype, device=iv.device)
        out = torch.where(c > 0, c * wt, torch.zeros_like(c))
    return out.reshape(d1, d2)


def remove_empty(target, margin: str = "rows", select=None,
                 empty_return: bool = True):
    """removeEmpty(target, margin, select): drops the all-zero rows (or
    columns), or those `select` marks 0. The output's shape is the data's:
    a host read of the kept count."""
    x = sp.ensure_dense(target)
    axis = 1 if margin == "rows" else 0
    if select is not None:
        mask = sp.ensure_dense(select).reshape(-1) != 0
    else:
        mask = torch.abs(x).sum(dim=axis) != 0
    out = x[mask, :] if margin == "rows" else x[:, mask]
    if out.numel() == 0 and empty_return:
        shape = (1, x.shape[1]) if margin == "rows" else (x.shape[0], 1)
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return out


def replace(target, pattern: float, replacement: float):
    """replace(target, pattern, replacement), a NaN pattern included
    (reference: ParameterizedBuiltin REPLACE)."""
    x = sp.ensure_dense(target)
    hit = torch.isnan(x) if math.isnan(pattern) else x == pattern
    return torch.where(hit, torch.full((), replacement, dtype=x.dtype,
                                       device=x.device), x)


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
    # one scatter into the output, no (n, m) comparison mask beside it (a
    # 250 x 2,000,000 selector is 2 GB in fp32 and its mask another 0.5);
    # an id outside 0..m-1 writes a 0 into column 0: its row stays zero
    valid = (idx >= 0) & (idx < m)
    eye = torch.zeros(v.shape[0], m, dtype=v.dtype, device=v.device)
    eye.scatter_(1, torch.where(valid, idx, 0).reshape(-1, 1),
                 valid.to(v.dtype).reshape(-1, 1))
    return eye if direction == "cols" else eye.T


def outer(u, v, op: str):
    """outer(U, V, "op"): op over all pairs (reference: Expression OUTER)."""
    from systemml_tpu_torch.ops.cellwise import binary_op

    return binary_op(op, sp.ensure_dense(u).reshape(-1, 1),
                     sp.ensure_dense(v).reshape(1, -1))


# ---- order statistics ----------------------------------------------------

def quantile(x, p, weights=None):
    """quantile(X, p) and median: type-1 (inverse ECDF) picks, as the
    reference's sort and pickValue. A p of more than one cell gives a
    column, else a 0-d tensor."""
    xv = _vec(x)
    n = xv.shape[0]
    if weights is not None:
        order = torch.argsort(xv, stable=True)
        v = xv[order]
        cw = torch.cumsum(_vec(weights, xv)[order], dim=0)

        def pick(pp):
            idx = torch.searchsorted(cw, (pp * cw[-1]).reshape(-1),
                                     side="left")
            return v[idx.clamp(0, n - 1)]
    else:
        v = torch.sort(xv).values

        def pick(pp):
            idx = torch.ceil(pp * n).to(torch.int64) - 1
            return v[idx.clamp(0, n - 1)]

    if isinstance(p, torch.Tensor) and p.numel() > 1:
        return pick(p.reshape(-1)).reshape(-1, 1)
    pt = p.reshape(()) if isinstance(p, torch.Tensor) else torch.full(
        (), float(p), dtype=torch.float64, device=xv.device)
    return pick(pt).reshape(())


def median(x, weights=None):
    return quantile(x, 0.5, weights)


def _iqm_weights(n: int, dtype, device) -> torch.Tensor:
    """Weights of the sorted values in the interquartile mean: 1 inside
    (Q1, Q3], fractional at the two boundaries."""
    q1, q3 = 0.25 * n, 0.75 * n
    i1, i3 = int(math.floor(q1)), int(math.floor(q3))
    idx = torch.arange(n, device=device)
    w = ((idx >= i1) & (idx < i3)).to(dtype)
    w[i1] -= q1 - i1
    if i3 < n:
        w[i3] += q3 - i3
    return w


def iqm(x, weights=None):
    """interQuartileMean (reference: PickByCount IQM). Weights are taken
    and ignored, as in the JAX package."""
    v = torch.sort(_vec(x)).values
    n = v.shape[0]
    w = _iqm_weights(n, v.dtype, v.device)
    return torch.sum(v * w) / (0.5 * n)


def col_medians(x):
    """Per-column type-1 medians in one sort."""
    v = torch.sort(sp.ensure_dense(x), dim=0).values
    i = max(0, int(math.ceil(0.5 * v.shape[0])) - 1)
    return v[i:i + 1, :]


def col_iqms(x):
    """Per-column interquartile means in one sort."""
    v = torch.sort(sp.ensure_dense(x), dim=0).values
    n = v.shape[0]
    w = _iqm_weights(n, v.dtype, v.device)
    return (w[:, None] * v).sum(dim=0, keepdim=True) / (0.5 * n)


# ---- probability distributions ------------------------------------------

def _lentz(a, b, x, iters: int, small: float):
    """The continued fraction of I_x(a, b) (dlmf 8.17.E23) by the Lentz,
    Thompson and Barnett algorithm, as XLA's: every element steps until
    all have converged (|delta - 1| < eps / 2) or `iters` steps ran. A
    0-d device flag freezes the state once all converged, so the result
    does not depend on where the loop stops; outside a loop region the
    flag is read every 16 steps to stop early."""
    one = torch.ones_like(x)
    small_t = torch.full_like(x, small)
    h = small_t.clone()               # the 0th denominator, 0, as `small`
    c, d = h.clone(), torch.zeros_like(x)
    active = torch.ones((), dtype=torch.bool, device=x.device)
    region = current_region() is not None
    for it in range(1, iters):
        m = float((it - 1) // 2)
        if it == 1:
            num = one
        elif it % 2 == 0:
            num = (-(a + b) * x / (a + 1.0) if m == 0 else
                   -(a + m) * (a + b + m) * x
                   / ((a + 2.0 * m) * (a + 2.0 * m + 1.0)))
        else:
            num = m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))
        c2 = 1.0 + num / c
        c2 = torch.where(torch.abs(c2) < small, small_t, c2)
        d2 = 1.0 + num * d
        d2 = torch.where(torch.abs(d2) < small, small_t, d2)
        d2 = 1.0 / d2
        delta = c2 * d2
        h = torch.where(active, h * delta, h)
        c = torch.where(active, c2, c)
        d = torch.where(active, d2, d)
        active = active & torch.any(torch.abs(delta - 1.0) >= small)
        if not region and it % 16 == 0 and not bool(active):
            break
    return h


def betainc(a, b, x):
    """The regularized incomplete beta I_x(a, b) in x's dtype, as
    jax.scipy.special.betainc (XLA's RegularizedIncompleteBeta): the
    continued fraction on the side where it converges fast (dlmf
    8.17.E4), 200 steps at most in fp32, 600 in fp64."""
    x = x if x.is_floating_point() else x.to(default_dtype(x.device))
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device).expand_as(x)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device).expand_as(x)
    fi = torch.finfo(x.dtype)
    fast = x < (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(fast, a, b), torch.where(fast, b, a)
    xx = torch.where(fast, x, 1.0 - x)
    cf = _lentz(aa, bb, xx, 200 if x.dtype == torch.float32 else 600,
                fi.eps / 2)
    lb_small = torch.lgamma(bb) - torch.lgamma(aa + bb)
    lb = torch.lgamma(aa) + lb_small
    factor = torch.where(
        aa < fi.tiny * 2, torch.exp(torch.log1p(-xx) * bb - lb_small),
        torch.exp(torch.log(xx) * aa + torch.log1p(-xx) * bb - lb) / aa)
    r = cf * factor
    r = torch.where(fast, r, 1.0 - r)
    inf = float("inf")
    a_zero = (a == 0) | (b == inf)
    b_zero = (b == 0) | (a == inf)
    zero, one = torch.zeros_like(r), torch.ones_like(r)
    r = torch.where((b_zero & (x != 1)) | (a_zero & (x == 0)), zero, r)
    r = torch.where((a_zero & (x != 0)) | (b_zero & (x == 1)), one, r)
    nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero) \
        | torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    return torch.where(nan, torch.full_like(r, float("nan")), r)


def _value(x) -> torch.Tensor:
    """A cellwise distribution argument as a floating tensor: a matrix
    keeps its dtype, a host scalar becomes a 0-d tensor."""
    if isinstance(x, torch.Tensor):
        x = sp.ensure_dense(x)
        return x if x.is_floating_point() else x.to(default_dtype(x.device))
    dev = torch.device(get_config().device)
    return torch.full((), float(x), dtype=default_dtype(dev), device=dev)


def cdf(x, dist: str = "normal", mean: float = 0.0, sd: float = 1.0,
        df: float = 1.0, df1: float = 1.0, df2: float = 1.0,
        rate: float = 1.0, lower_tail: bool = True):
    """The cumulative distribution, cellwise (reference: Expression CDF;
    builtins pnorm, pt, pf, pchisq, pexp)."""
    x = _value(x)
    if dist == "normal":
        p = torch.special.ndtr((x - mean) / sd)
    elif dist == "exp":
        p = torch.where(x < 0, torch.zeros_like(x),
                        1.0 - torch.exp(-rate * x))
    elif dist == "chisq":
        p = torch.special.gammainc(
            torch.full_like(x, df / 2.0), torch.clamp(x, min=0) / 2.0)
    elif dist == "t":
        ib = betainc(df / 2.0, 0.5, df / (df + x * x))
        p = torch.where(x > 0, 1.0 - 0.5 * ib, 0.5 * ib)
    elif dist == "f":
        xx = torch.clamp(x, min=0)
        p = betainc(df1 / 2.0, df2 / 2.0, df1 * xx / (df1 * xx + df2))
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return p if lower_tail else 1.0 - p


def invcdf(p, dist: str = "normal", mean: float = 0.0, sd: float = 1.0,
           df: float = 1.0, df1: float = 1.0, df2: float = 1.0,
           rate: float = 1.0):
    """The inverse distribution (qnorm, qt, qf, qchisq, qexp): normal and
    exp on the device; t, chisq and F through scipy on the host, as the
    JAX package (loop regions refuse a body that calls them)."""
    p = _value(p)
    if dist == "normal":
        return mean + sd * torch.special.ndtri(p)
    if dist == "exp":
        return -torch.log1p(-p) / rate
    import scipy.stats as ss

    ppf = {"t": lambda v: ss.t.ppf(v, df),
           "chisq": lambda v: ss.chi2.ppf(v, df),
           "f": lambda v: ss.f.ppf(v, df1, df2)}.get(dist)
    if ppf is None:
        raise ValueError(f"unknown distribution {dist!r}")
    host = np.asarray(ppf(p.detach().cpu().numpy().astype(np.float64)))
    return torch.as_tensor(host, device=p.device).to(p.dtype)
