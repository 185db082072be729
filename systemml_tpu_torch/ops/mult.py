"""Matrix multiplication family.

Port of systemml_tpu/ops/mult.py. Dense `matmult` and `tsmm` are
torch.matmul (the JAX package leaves them to XLA; here cuBLAS runs them,
in true fp32 under the "highest" policy, utils/config.py). Under the
"bfloat16" mixed policy the dense products take their operands rounded
to bf16 and compute in fp32 (`_mm`, utils/config.bf16_operands), and
so does mmchain. Dense mmchain dispatches between the hand kernel
(codegen/kernels.py) and the two-pass arm by shape and dtype, before any
launch, under every policy. A compressed operand
(compress/) takes the compressed ops of compress/device.py: right and
left mult, left tsmm, and mmchain, which runs kernel K6 on the card. A
sparse operand (runtime/sparse.py) takes the sparse products: CSR through
torch.sparse (cuSPARSE on the card), or the ELL gathers of a loop
region's view.

The five weighted quaternary ops (wsloss, wsigmoid, wdivmm, wcemm, wumm)
each choose between their sampled arm (runtime/sparse.q_*: U %*% t(V) at
the carrier's stored cells) and their dense arm (the (m, n) product
formed) by the JAX package's decision, taken inline here: an ELL carrier
always samples, a CSR carrier as hops/cost.quaternary_exploit decides, a
dense carrier takes the dense arm. Each run counts `spx_<op>_<path>`
(exploit_ell, exploit_csr, densify, dense) and emits a `sparse_exec`
event. The kernel backend's registry, cost model and measured tuner wait
(ROADMAP queue 1, kernel backend and tuner), and so do double-float
operands and pmm.
"""

from __future__ import annotations

import torch

from systemml_tpu_torch.codegen import kernels
from systemml_tpu_torch.compress import device as cla_dev
from systemml_tpu_torch.compress import is_compressed
from systemml_tpu_torch.runtime import sparse as sp
from systemml_tpu_torch.utils.config import bf16_operands, mixed_bf16_enabled


def _mm(a, b):
    """A dense product under the active precision policy."""
    return torch.matmul(*bf16_operands(a, b))


def matmult(a, b):
    """A %*% B (reference: LibMatrixMult.matrixMult; the sparse arms are
    runtime/sparse.py's). A compressed A takes the compressed right mult,
    a compressed B the left mult A @ X."""
    if is_compressed(a):
        return cla_dev.right_mult(a, sp.ensure_dense(b))
    if is_compressed(b):
        return cla_dev.left_mult(b, sp.ensure_dense(a))
    if sp.is_ell(a):
        return a.mm(sp.ensure_dense(b))   # the gather matmult
    if sp.is_ell(b):
        b = b.to_dense()   # no sparse-rhs gather kernel
    if sp.is_sparse(a):
        return sp.spmm(a, b)
    if sp.is_sparse(b):
        return sp.gemm_sp(a, b)
    return _mm(a, b)


def tsmm(x, left: bool = True):
    """t(X)%*%X (left) or X%*%t(X) (right), reference MMTSJ. cuBLAS takes
    the transposed view without a copy. A compressed X takes the
    compressed tsmm when left; right has no compressed form and
    decompresses. An ELL view needs its dense form as the right operand:
    within cap / 16 of the budget it is built; past it the loop region is
    refused ("sparse view") and the product runs on the view's CSR."""
    if is_compressed(x):
        if left:
            return cla_dev.tsmm(x)
        x = x.to_dense()
    if sp.is_ell(x):
        if x.shape[0] * x.shape[1] * x.val.element_size() \
                > sp.device_budget() / 16:
            from systemml_tpu_torch.compiler.lower import region_refuse

            region_refuse("sparse view: tsmm over an ELL view above its "
                          "dense budget")
            return sp.sp_tsmm(x.to_csr(), left)
        if left:
            return x.tmm(x.to_dense())
        x = x.to_dense()
    if sp.is_sparse(x):
        return sp.sp_tsmm(x, left)
    return _mm(x.T, x) if left else _mm(x, x.T)


def mmchain(x, v, w=None, ctype: str = "XtXv", precise: bool = True):
    """Fused matrix-multiply chains (reference: MapMultChain lop,
    LibMatrixMult.matrixMultChain): XtXv = t(X)%*%(X%*%v),
    XtwXv = t(X)%*%(w*(X%*%v)), XtXvy = t(X)%*%((X%*%v)-y).

    The choice keeps the JAX family's support predicate (fp32, k >= 128,
    c <= 8) plus the kernel's own k <= 2048, and is made from shape and
    dtype alone: a CUDA tensor that meets it takes the single-pass hand
    kernel; everything else takes the two-pass arm, two torch.matmul
    calls (the JAX package's jnp_two_pass). On the CPU the two are the
    same arithmetic. Under the "bfloat16" policy X and v are rounded to
    bf16 first and the same choice follows: the kernel reads the rounded
    X in fp32; the two-pass arm rounds X v again for its second product,
    as the JAX package's does. The kernel reads a row or column slice of a wider X
    in place; an X of another layout (a transposed view from t()) is
    laid out row-major first, as the JAX package's transpose
    materialises it. `precise` is accepted and changes nothing: the
    kernel always computes in true fp32. The kernel backend's registry,
    cost model and tuner wait (ROADMAP queue 1, kernel backend and tuner).
    A compressed X takes compress/device.mmchain (K6 on the card). An
    ELL X runs the single-pass sparse chain (gather forward, scatter-add
    back); a CSR X the two-pass chain, X's product and its transpose's
    through the sparse matmult (the JAX package forms both over dense
    mirrors); K1 takes dense X only."""
    if is_compressed(x):
        return cla_dev.mmchain(x, v, w, ctype)
    v = sp.ensure_dense(v)
    w = sp.ensure_dense(w) if w is not None else None
    if sp.is_ell(x) or sp.is_sparse(x):
        xv = matmult(x, v)
        if ctype == "XtwXv":
            xv = w * xv
        elif ctype == "XtXvy":
            xv = xv - w
        return x.tmm(xv) if sp.is_ell(x) else matmult(x.transpose(), xv)
    m, k = x.shape
    c = v.shape[1] if v.ndim == 2 else 1
    x, v = bf16_operands(x, v)
    if x.device.type == "cuda" and kernels.mmchain_supported(m, k, c,
                                                             x.dtype):
        if kernels.mmchain_row_stride(x) is None:
            x = x.contiguous()
        return kernels.mmchain_kernel(x, v, w, ctype, precise=precise)
    if mixed_bf16_enabled():
        xv = _mm(x, v)
        xv = w * xv if ctype == "XtwXv" else (xv - w if ctype == "XtXvy"
                                              else xv)
        return _mm(x.T, xv)
    return kernels.mmchain_plain(x, v, w, ctype)


# --------------------------------------------------------------------------
# weighted quaternary ops (reference: lops/Weighted*.java,
# LibMatrixMult.matrixMultW*), used by matrix factorization
# --------------------------------------------------------------------------

def _q_stats(op: str, path: str, reason: str) -> None:
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_estim(f"spx_{op}_{path}")
    if obs.recording():
        obs.instant("sparse_exec", obs.CAT_RUNTIME, op=op, path=path,
                    reason=reason)


def _q_carrier(pattern) -> str:
    if sp.is_ell(pattern):
        return "ell"
    if sp.is_sparse(pattern):
        return "csr"
    return "dense"


def _q_decision(pattern, u) -> tuple:
    """(exploit?, reason, carrier) as the JAX package's _q_dispatch and
    _q_analytic take it: an ELL mirror exists because the dense form was
    judged not worth holding, so it always samples; a CSR carrier asks
    hops/cost.quaternary_exploit; a dense carrier keeps the dense arm."""
    carrier = _q_carrier(pattern)
    if carrier == "ell":
        return True, "ell_mirror", carrier
    if carrier == "csr":
        from systemml_tpu_torch.hops.cost import quaternary_exploit

        m, n = int(pattern.shape[0]), int(pattern.shape[1])
        k = max(int(u.shape[1]), 1)
        return quaternary_exploit(m, n, k, float(pattern.nnz)) + (carrier,)
    return False, "dense_input", carrier


def _q_path(carrier: str, exploit: bool) -> str:
    if exploit:
        return "exploit_ell" if carrier == "ell" else "exploit_csr"
    return "dense" if carrier == "dense" else "densify"


def _q_run(op: str, pattern, u, exploit_fn, dense_fn):
    exploit, reason, carrier = _q_decision(pattern, u)
    _q_stats(op, _q_path(carrier, exploit), reason)
    return exploit_fn() if exploit else dense_fn()


def _q_factors(u, v):
    # U and V are the small dense factors by contract (m x k, n x k)
    return sp.ensure_dense(u), sp.ensure_dense(v)


def wsloss(x, u, v, w=None, post: str = "NONE"):
    """Weighted squared loss: sum(W * (X - U%*%t(V))^2) and its variants
    (reference: WeightedSquaredLoss lop / matrixMultWSLoss)."""
    u, v = _q_factors(u, v)
    pattern = w if post in ("POST", "PRE") else x

    def dense():
        xd = sp.ensure_dense(x)
        wd = sp.ensure_dense(w) if w is not None else None
        uv = torch.matmul(u, v.T)
        if post == "POST":          # sum(W * (X - U %*% t(V))^2)
            d = xd - uv
            return torch.sum(wd * d * d)
        if post == "POST_NZ":       # the nonzeros of X as weights
            d = torch.where(xd != 0, xd - uv, torch.zeros(
                (), dtype=uv.dtype, device=uv.device))
            return torch.sum(d * d)
        if post == "PRE":           # sum((X - W * (U %*% t(V)))^2)
            d = xd - wd * uv
            return torch.sum(d * d)
        d = xd - uv                 # NONE: sum((X - U %*% t(V))^2)
        return torch.sum(d * d)

    return _q_run("wsloss", pattern, u,
                  lambda: sp.q_wsloss(x, u, v, w=w, post=post), dense)


def wsigmoid(x, u, v, flags: str = ""):
    """X * sigmoid(U %*% t(V)) and its minus and log variants (reference:
    WeightedSigmoid lop / matrixMultWSigmoid)."""
    u, v = _q_factors(u, v)

    def dense():
        uv = torch.matmul(u, v.T)
        if "minus" in flags:
            uv = -uv
        s = torch.sigmoid(uv)
        if "log" in flags:
            s = torch.log(s)
        return sp.ensure_dense(x) * s

    return _q_run("wsigmoid", x, u, lambda: sp.q_wsigmoid(x, u, v, flags),
                  dense)


def wdivmm(x, u, v, left: bool, mult: bool = False, eps: float = 0.0):
    """Weighted divide matrix-mult (reference: WeightedDivMM): with
    W = X * (U %*% t(V)) (mult) or X / (U %*% t(V) + eps), returns
    t(W) %*% U (left) or W %*% V. The dense arm builds the (m, n) product
    and W by torch.matmul, in true fp32 under the "highest" policy; the
    sampled arm (ALS-CG's half-steps on a sparse W) never does."""
    u, v = _q_factors(u, v)

    def dense():
        xd = sp.ensure_dense(x)
        uv = torch.matmul(u, v.T)
        wd = xd * uv if mult else xd / (uv + eps)
        return torch.matmul(wd.T, u) if left else torch.matmul(wd, v)

    return _q_run("wdivmm", x, u,
                  lambda: sp.q_wdivmm(x, u, v, left, mult_w=mult, eps=eps),
                  dense)


def wcemm(x, u, v, eps: float = 0.0):
    """Weighted cross-entropy: sum(X * log(U%*%t(V) + eps)) (reference:
    WeightedCrossEntropy lop / matrixMultWCeMM)."""
    u, v = _q_factors(u, v)

    def dense():
        uv = torch.matmul(u, v.T)
        return torch.sum(sp.ensure_dense(x) * torch.log(uv + eps))

    return _q_run("wcemm", x, u, lambda: sp.q_wcemm(x, u, v, eps), dense)


def wumm(x, u, v, op: str = "*", fn=None, uop: str = None):
    """Weighted unary mm: X op fn(U%*%t(V)) (reference: WeightedUnaryMM
    lop / matrixMultWuMM). `uop` names the unary (the HOP rewrite's
    spelling); `fn`, a Python callable, is the legacy form for direct
    callers and always takes the dense arm, uncounted, as in the JAX
    package."""
    from systemml_tpu_torch.ops import cellwise

    u, v = _q_factors(u, v)
    if uop is None:
        uv = torch.matmul(u, v.T)
        if fn is not None:
            uv = fn(uv)
        xd = sp.ensure_dense(x)
        return xd * uv if op == "*" else xd / uv

    def dense():
        uv = cellwise.unary_op(uop, torch.matmul(u, v.T))
        xd = sp.ensure_dense(x)
        return xd * uv if op == "*" else xd / uv

    return _q_run("wumm", x, u,
                  lambda: sp.q_wumm(x, u, v, uop=uop, div=(op == "/")),
                  dense)
