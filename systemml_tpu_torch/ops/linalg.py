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

import contextlib
import contextvars

import torch

from systemml_tpu_torch.runtime import sparse as sp


def _dense(a):
    return sp.ensure_dense(a)


def solve(a, b):
    """solve(A, b): a square A by LU (jnp.linalg.solve), a tall one by
    least squares through QR and a triangular solve, as the JAX package;
    inside a loop region on the card, by `_solve_graph_safe`."""
    a, b = _dense(a), _dense(b)
    if b.ndim != 2:
        b = b.reshape(-1, 1)
    if a.is_cuda and _GRAPH_SAFE.get():
        return _solve_graph_safe(a, b)
    if a.shape[0] == a.shape[1]:
        return torch.linalg.solve_ex(a, b, check_errors=False).result
    q, r = torch.linalg.qr(a)
    return torch.linalg.solve_triangular(r, q.T @ b, upper=True)


# set by a loop region on the card (runtime/loopfuse.py) for its peel and
# its capture, so that every iteration of the region solves alike
_GRAPH_SAFE: contextvars.ContextVar = contextvars.ContextVar(
    "graph_safe_solve", default=False)
# refinement steps of _solve_graph_safe: each multiplies the error of the
# normal equations by about cond(A)^2 * eps
REFINE_STEPS = 3


@contextlib.contextmanager
def graph_safe():
    """solve() inside the block takes the route a CUDA graph captures."""
    tok = _GRAPH_SAFE.set(True)
    try:
        yield
    finally:
        _GRAPH_SAFE.reset(tok)


def _solve_graph_safe(a, b):
    """solve(A, b) with no call that allocates inside a capture: captured,
    cuSOLVER's LU solve (orders 12 to 128, and from 700 in fp32), its
    fp32 inverse (from order 700) and its QR make stream-ordered
    allocations, graph memory nodes that a region's conditional body
    refuses; its fp64 inverse made none at orders 1 to 1,000 (NVIDIA
    H100, CUDA 12.8 and 12.9). So in fp64: M the inverse of A (square)
    or of t(A) A (tall), x = M t(A) b, then REFINE_STEPS steps of
    iterative refinement, x += M t(A) (b - A x), which bring the tall
    answer from the normal equations' cond(A)^2 to least squares'
    accuracy; the result cast back."""
    ad, bd = a.double(), b.double()
    tall = a.shape[0] != a.shape[1]
    m = torch.linalg.inv_ex(ad.T @ ad if tall else ad,
                            check_errors=False).inverse

    def step(r):
        return m @ (ad.T @ r if tall else r)

    x = step(bd)
    for _ in range(REFINE_STEPS):
        x = x + step(bd - ad @ x)
    return x.to(torch.promote_types(a.dtype, b.dtype))


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
