"""Matrix multiplication family.

Port of systemml_tpu/ops/mult.py, dense and compressed branches. Dense
`matmult` and `tsmm` are torch.matmul (the JAX package leaves them to
XLA; here cuBLAS runs them, in true fp32 under the "highest" policy,
utils/config.py). Dense mmchain dispatches between the hand kernel
(codegen/kernels.py) and the two-pass arm by shape and dtype, before any
launch. A compressed operand (compress/) takes the compressed ops of
compress/device.py: right and left mult, left tsmm, and mmchain, which
runs kernel K6 on the card. Of the weighted quaternary ops, `wdivmm`
on a dense carrier is ported (ALS-CG's half-steps); sparse and
double-float operands, pmm, the sparse carriers of wdivmm and the other
four quaternary kinds wait (ROADMAP queue 1: sparse plane).
"""

from __future__ import annotations

import torch

from systemml_tpu_torch.codegen import kernels
from systemml_tpu_torch.compress import device as cla_dev
from systemml_tpu_torch.compress import is_compressed


def _dense(*xs) -> None:
    for x in xs:
        if x is not None and not isinstance(x, torch.Tensor):
            raise NotImplementedError(
                f"matrix multiply on {type(x).__name__}: only dense and "
                f"compressed operands are ported (sparse operands wait for "
                f"ROADMAP queue 1, sparse plane)")
        if x is not None and x.layout != torch.strided:
            raise NotImplementedError(
                "sparse tensors wait for ROADMAP queue 1, sparse plane")


def _dense_value(x):
    """The other side of a compressed product, dense (a compressed one is
    decompressed, as the JAX package's ensure_dense does)."""
    return x.to_dense() if is_compressed(x) else x


def matmult(a, b):
    """A %*% B (reference: LibMatrixMult.matrixMult). A compressed A takes
    the compressed right mult, a compressed B the left mult A @ X."""
    if is_compressed(a):
        return cla_dev.right_mult(a, _dense_value(b))
    if is_compressed(b):
        return cla_dev.left_mult(b, _dense_value(a))
    _dense(a, b)
    return torch.matmul(a, b)


def tsmm(x, left: bool = True):
    """t(X)%*%X (left) or X%*%t(X) (right), reference MMTSJ. cuBLAS takes
    the transposed view without a copy. A compressed X takes the
    compressed tsmm when left; right has no compressed form and
    decompresses."""
    if is_compressed(x):
        if left:
            return cla_dev.tsmm(x)
        x = x.to_dense()
    _dense(x)
    return torch.matmul(x.T, x) if left else torch.matmul(x, x.T)


def mmchain(x, v, w=None, ctype: str = "XtXv", precise: bool = True):
    """Fused matrix-multiply chains (reference: MapMultChain lop,
    LibMatrixMult.matrixMultChain): XtXv = t(X)%*%(X%*%v),
    XtwXv = t(X)%*%(w*(X%*%v)), XtXvy = t(X)%*%((X%*%v)-y).

    The choice keeps the JAX family's support predicate (fp32, k >= 128,
    c <= 8) plus the kernel's own k <= 2048, and is made from shape and
    dtype alone: a CUDA tensor that meets it takes the single-pass hand
    kernel; everything else takes the two-pass arm, two torch.matmul
    calls (the JAX package's jnp_two_pass). On the CPU the two are the
    same arithmetic. The kernel reads a row or column slice of a wider X
    in place; an X of another layout (a transposed view from t()) is
    laid out row-major first, as the JAX package's transpose
    materialises it. `precise` is accepted and changes nothing: the
    kernel always computes in true fp32. The kernel backend's registry,
    cost model and tuner wait (ROADMAP queue 1, kernel backend and tuner).
    A compressed X takes compress/device.mmchain (K6 on the card)."""
    if is_compressed(x):
        return cla_dev.mmchain(x, v, w, ctype)
    _dense(x, v, w)
    m, k = x.shape
    c = v.shape[1] if v.ndim == 2 else 1
    if x.device.type == "cuda" and kernels.mmchain_supported(m, k, c,
                                                             x.dtype):
        if kernels.mmchain_row_stride(x) is None:
            x = x.contiguous()
        return kernels.mmchain_kernel(x, v, w, ctype, precise=precise)
    return kernels.mmchain_plain(x, v, w, ctype)


def wdivmm(x, u, v, left: bool, mult: bool = False, eps: float = 0.0):
    """Weighted divide matrix-mult (reference: WeightedDivMM), the dense
    arm of the JAX package's q_wdivmm family (systemml_tpu/ops/mult.py:
    487-519): with W = X * (U %*% t(V)) (mult) or X / (U %*% t(V) + eps),
    returns t(W) %*% U (left) or W %*% V. The (m, n) product and W are
    built, as there, by torch.matmul in true fp32 under the "highest"
    policy. A sparse carrier (the exploit arm, sampled on X's pattern)
    waits for the sparse plane; counts spx_wdivmm_dense."""
    _dense(x, u, v)
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_estim("spx_wdivmm_dense")
    uv = torch.matmul(u, v.T)
    w = x * uv if mult else x / (uv + eps)
    return torch.matmul(w.T, u) if left else torch.matmul(w, v)
