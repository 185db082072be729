"""Dense linear algebra: solve, inverse, cholesky, QR, LU, eigen, SVD, det.

Port of systemml_tpu/ops/linalg.py:15-74 (reference: LibCommonsMath;
the JAX package leaves these to XLA's LAPACK-style calls, here they are
torch.linalg's, cuSOLVER on the card). Semantics as the JAX package's,
including its odd ones: qr returns the economical Q (not Householder
vectors), eigen is the symmetric eigh with ascending eigenvalues, svd's
S is a diagonal matrix.

No solver here synchronises: solve, inverse and cholesky go through the
`_ex` forms with check_errors=False, so a singular or indefinite matrix
gives Inf/NaN (as jnp.linalg; cholesky's NaN from `info` on the device)
instead of a host check of `info` and a raise, and a captured loop region
may run them.
"""

from __future__ import annotations

import torch

from systemml_tpu_torch.runtime import sparse as sp


def _dense(a):
    return sp.ensure_dense(a)


def solve(a, b):
    """solve(A, b): a square A by LU (jnp.linalg.solve), a tall one by
    least squares through QR and a triangular solve, as the JAX package."""
    a, b = _dense(a), _dense(b)
    if b.ndim != 2:
        b = b.reshape(-1, 1)
    if a.shape[0] == a.shape[1]:
        return torch.linalg.solve_ex(a, b, check_errors=False).result
    q, r = torch.linalg.qr(a)
    return torch.linalg.solve_triangular(r, q.T @ b, upper=True)


def inverse(a):
    return torch.linalg.inv_ex(_dense(a), check_errors=False).inverse


def cholesky(a):
    """The lower-triangular L (the reference returns L); NaN where A is
    not positive definite, as jnp.linalg.cholesky (the factor's `info`
    read on the device, not the host)."""
    r = torch.linalg.cholesky_ex(_dense(a), check_errors=False)
    return torch.where(r.info == 0, r.L, torch.full_like(r.L, float("nan")))


def qr(a):
    """[Q, R] = qr(X), economical, as the JAX package (the reference
    returns Householder vectors in place of Q)."""
    return tuple(torch.linalg.qr(_dense(a)))


def lu(a):
    """[P, L, U] = lu(X) with X = P %*% L %*% U (jax.scipy.linalg.lu)."""
    p, l, u = torch.linalg.lu(_dense(a))
    return p, l, u


def eigen(a):
    """[values, vectors] = eigen(X) of a symmetric X: eigenvalues
    ascending as a column, vectors unique up to each column's sign."""
    w, v = torch.linalg.eigh(_dense(a))
    return w.reshape(-1, 1), v


def svd(a):
    """[U, S, V] = svd(X) with S diagonal (reference:
    LibCommonsMath.computeSvd)."""
    u, s, vt = torch.linalg.svd(_dense(a), full_matrices=False)
    return u, torch.diag(s), vt.T


def det(a):
    return torch.linalg.det(_dense(a))


def trace(a):
    return torch.trace(_dense(a))
