"""Matrix multiplication family.

Port of systemml_tpu/ops/mult.py, dense branches. `matmult` and `tsmm`
are torch.matmul (the JAX package leaves them to XLA; here cuBLAS runs
them, in true fp32 under the "highest" policy, utils/config.py). mmchain
dispatches between the hand kernel (codegen/kernels.py) and the two-pass
arm by shape and dtype, before any launch. Sparse, compressed and
double-float operands, pmm and the weighted quaternary ops wait (ROADMAP
queue 1: sparse plane, compressed LA).
"""

from __future__ import annotations

import torch

from systemml_tpu_torch.codegen import kernels


def _dense(*xs) -> None:
    for x in xs:
        if x is not None and not isinstance(x, torch.Tensor):
            raise NotImplementedError(
                f"matrix multiply on {type(x).__name__}: only dense tensors "
                f"are ported (sparse and compressed operands wait for "
                f"ROADMAP queue 1, sparse plane and compressed LA)")
        if x is not None and x.layout != torch.strided:
            raise NotImplementedError(
                "sparse tensors wait for ROADMAP queue 1, sparse plane")


def matmult(a, b):
    """A %*% B (reference: LibMatrixMult.matrixMult)."""
    _dense(a, b)
    return torch.matmul(a, b)


def tsmm(x, left: bool = True):
    """t(X)%*%X (left) or X%*%t(X) (right), reference MMTSJ. cuBLAS takes
    the transposed view without a copy."""
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
    cost model and tuner wait (ROADMAP queue 1, kernel backend and tuner)."""
    _dense(x, v, w)
    m, k = x.shape
    c = v.shape[1] if v.ndim == 2 else 1
    if x.device.type == "cuda" and kernels.mmchain_supported(m, k, c,
                                                             x.dtype):
        if kernels.mmchain_row_stride(x) is None:
            x = x.contiguous()
        return kernels.mmchain_kernel(x, v, w, ctype, precise=precise)
    return kernels.mmchain_plain(x, v, w, ctype)
