"""Matrix multiplication family.

Port of systemml_tpu/ops/mult.py. Dense `matmult` and `tsmm` are
torch.matmul (the JAX package leaves them to XLA; here cuBLAS runs them,
in true fp32 under the "highest" policy, utils/config.py). Under the
"bfloat16" mixed policy the dense products take their operands rounded
to bf16 and compute in fp32 (`_mm`, utils/config.bf16_operands), and
so does mmchain. A compressed operand (compress/) takes the compressed
ops of compress/device.py: right and left mult, left tsmm, and mmchain,
which runs kernel K6 on the card. A sparse operand (runtime/sparse.py)
takes the sparse products: CSR through torch.sparse (cuSPARSE on the
card), or the ELL gathers of a loop region's view.

Dense mmchain and the five weighted quaternary ops (wsloss, wsigmoid,
wdivmm, wcemm, wumm) dispatch through the kernel backend
(codegen/backend.py), as in the JAX package:

- the `mmchain` family: the template "kernel" is the hand kernel K1
  (codegen/kernels.mmchain_kernel), swept over the blocks per SM of its
  grid (a run-time launch parameter); the fallback "two_pass" is two
  torch.matmul calls (the JAX package's jnp_two_pass);
- the `q_*` families: "exploit" (runtime/sparse.q_*: U %*% t(V) at the
  carrier's stored cells) against "dense" (the (m, n) product formed),
  chosen by the JAX package's decision: an ELL carrier always samples, a
  CSR carrier as hops/cost.quaternary_exploit decides, a dense carrier
  takes the dense arm. Each run counts `spx_<op>_<path>` (exploit_ell,
  exploit_csr, densify, dense) and emits a `sparse_exec` event.

Double-float operands have no counterpart: "double" is native fp64 here
(ROADMAP, port decisions); pmm waits.
"""

from __future__ import annotations

import torch

from systemml_tpu_torch.codegen import backend as kbackend
from systemml_tpu_torch.codegen import kernels
from systemml_tpu_torch.compress import device as cla_dev
from systemml_tpu_torch.compress import is_compressed
from systemml_tpu_torch.hops.cost import quaternary_exploit
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

    Dense chains dispatch through the kernel backend (the `mmchain`
    family below): the hand kernel K1 (one pass over X) or two
    torch.matmul calls. K1 takes the JAX family's shapes (fp32, k >= 128,
    c <= 8) and its own k <= 2048; another call of the kernel variant
    runs the two-pass arm, counted as a fallback. Under the "bfloat16"
    policy X and v are rounded to bf16 first and the same dispatch
    follows: the kernel reads the rounded X in fp32; the two-pass arm
    rounds X v again for its second product, as the JAX package's does.
    The kernel reads a row or column slice of a wider X in place; an X
    of another layout (a transposed view from t()) is laid out row-major
    first, as the JAX package's transpose materialises it. `precise` is
    part of the key and changes nothing: the kernel always computes in
    true fp32. A compressed X takes compress/device.mmchain (K6 on the
    card). An ELL X runs the single-pass sparse chain (gather forward,
    scatter-add back); a CSR X the two-pass chain, X's product and its
    transpose's through the sparse matmult (the JAX package forms both
    over dense mirrors); K1 takes dense X only."""
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
    return kbackend.dispatch(
        "mmchain", (x, v, w), shape=(m, k, c), dtype=x.dtype,
        config={"ctype": ctype, "precise": precise},
        backend=x.device.type)


# ---- mmchain variants (kernel backend) -----------------------------------
#
# Costs: X read once by K1 against twice by the two products. On the card
# K1 is one launch against cuBLAS's two, so it wins wherever it takes the
# shape. On the CPU the JAX package's calibration is kept (its Pallas
# kernel's fixed cost, a crossover near 2^23 cells), so that both packages
# choose alike there.

_MMCHAIN_CPU_OVERHEAD_S = 44e-6


def _mmchain_kernel_ok(ctx) -> bool:
    m, k, c = ctx["shape"]
    return (kbackend.use_kernel(ctx["backend"]) and ctx["dtype"] == "float32"
            and k >= kernels.MMCHAIN_MIN_K and c <= kernels.MMCHAIN_MAX_C)


def _mmchain_kernel_accepts(ctx, x, v, w) -> bool:
    m, k, c = ctx["shape"]
    return kernels.mmchain_supported(m, k, c, x.dtype)


def _mmchain_cost_kernel(ctx) -> float:
    from systemml_tpu_torch.hops.cost import HwProfile

    hw = HwProfile.detect()
    m, k, c = ctx["shape"]
    fixed = (hw.dispatch_us * 1e-6 if ctx["backend"] == "cuda"
             else _MMCHAIN_CPU_OVERHEAD_S)
    return 4.0 * m * k / hw.hbm_bw + fixed


def _mmchain_cost_two_pass(ctx) -> float:
    from systemml_tpu_torch.hops.cost import HwProfile

    hw = HwProfile.detect()
    m, k, c = ctx["shape"]
    launches = 2 if ctx["backend"] == "cuda" else 1
    return 2.0 * 4.0 * m * k / hw.hbm_bw + launches * hw.dispatch_us * 1e-6


_mmchain_fam = kbackend.family("mmchain")


def _mmchain_sweep():
    """K1's grid: the empty point keeps its own (as many blocks per SM
    as are resident, codegen/kernels._mmchain_grid); the others cap the
    blocks per SM, each a run-time launch parameter of the one build."""
    return [{}] + [{"bps": b} for b in (1, 2, 4)]


@_mmchain_fam.template("kernel", _mmchain_sweep, cost=_mmchain_cost_kernel,
                       supported=_mmchain_kernel_ok,
                       accepts=_mmchain_kernel_accepts, fallback="two_pass")
def _mmchain_kernel(ctx, x, v, w):
    if x.device.type == "cuda" and kernels.mmchain_row_stride(x) is None:
        x = x.contiguous()
    return kernels.mmchain_kernel(
        x, v, w, ctx["config"]["ctype"], precise=ctx["config"]["precise"],
        blocks_per_sm=(ctx.get("sched") or {}).get("bps"))


@_mmchain_fam.variant("two_pass", cost=_mmchain_cost_two_pass,
                      is_fallback=True)
def _mmchain_two_pass(ctx, x, v, w):
    ctype = ctx["config"]["ctype"]
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


def _q_analytic(ctx, cands):
    """The family's analytic selector: the JAX package's
    quaternary_exploit decision (its budget-infeasibility escape
    included), as the compile-time costing takes it."""
    exploit, _reason = ctx["decision"]
    name = "exploit" if exploit else "dense"
    return name if name in cands else cands[0]


def _q_cost_exploit(ctx) -> float:
    from systemml_tpu_torch.hops.cost import (QUATERNARY_GATHER_OVERHEAD,
                                              HwProfile, OpCost)

    if ctx["carrier"] == "dense":
        return float("nan")
    hw = HwProfile.detect()
    bc = hw.bytes_per_cell
    m, n, k = ctx["mnk"]
    nnz = float(ctx["nnz"])
    return OpCost(QUATERNARY_GATHER_OVERHEAD * 2.0 * nnz * k,
                  (m * float(k) + n * float(k))
                  * bc + nnz * (bc + 4)).time(hw)


def _q_cost_dense(ctx) -> float:
    from systemml_tpu_torch.hops.cost import HwProfile, OpCost

    hw = HwProfile.detect()
    bc = hw.bytes_per_cell
    m, n, k = ctx["mnk"]
    return OpCost(2.0 * m * float(n) * k,
                  (m * float(k) + n * float(k)
                   + m * float(n)) * bc).time(hw)


def _q_exploit_ok(ctx) -> bool:
    return ctx["carrier"] in ("ell", "csr")


def _q_dense_ok(ctx) -> bool:
    # an ELL mirror exists because the dense form was judged not worth
    # holding: never densify it; and where quaternary_exploit declared the
    # dense product beyond the budget, the dense arm is off the table
    if ctx["carrier"] == "ell":
        return False
    return ctx["decision"][1] != "infeasible"


def _q_dispatch(op: str, pattern, u, args: tuple, static: dict):
    """Classify the carrier, take the JAX package's decision for the
    analytic arm, and dispatch family `q_<op>` (key: op, shape bucket
    (m, n, k), the carrier's sparsity decade, the static flags)."""
    carrier = _q_carrier(pattern)
    m, n = int(pattern.shape[0]), int(pattern.shape[1])
    k = max(int(u.shape[1]), 1)
    if carrier == "csr":
        nnz = float(pattern.nnz)
        decision = quaternary_exploit(m, n, k, nnz)
        dt = pattern.data.dtype
    elif carrier == "ell":
        nnz = float(pattern.idx.shape[0] * pattern.idx.shape[1])
        decision = (True, "ell_mirror")
        dt = pattern.val.dtype
    else:
        nnz = float(m) * n
        decision = (False, "dense_input")
        dt = pattern.dtype
    sp_frac = nnz / max(1.0, float(m) * n) if carrier != "dense" else None
    # memo_extra: the per-call turn-point verdict, finer than the key's
    # buckets, so that bucket-mates on either side of the turn point
    # never share a memoised choice
    ctx = {"carrier": carrier, "mnk": (m, n, k), "nnz": nnz,
           "decision": decision, "memo_extra": decision, "op": op}
    return kbackend.dispatch(
        f"q_{op}", args, shape=(m, n, k), dtype=dt, sparsity=sp_frac,
        config=static, ctx=ctx, backend=u.device.type)


def _q_path(ctx, dense_arm: bool) -> str:
    if dense_arm:
        return "dense" if ctx["carrier"] == "dense" else "densify"
    return "exploit_ell" if ctx["carrier"] == "ell" else "exploit_csr"


def _q_family(op: str, exploit_fn, dense_fn) -> None:
    """Registers family q_<op>: "exploit" runs `exploit_fn`, "dense"
    (its fallback) `dense_fn`, each counting its path."""
    fam = kbackend.family(f"q_{op}", analytic=_q_analytic)

    @fam.variant("exploit", cost=_q_cost_exploit, supported=_q_exploit_ok,
                 fallback="dense")
    def _exploit(ctx, *args):
        _q_stats(op, _q_path(ctx, False), ctx["decision"][1])
        return exploit_fn(*args)

    @fam.variant("dense", cost=_q_cost_dense, supported=_q_dense_ok,
                 is_fallback=True)
    def _dense(ctx, *args):
        _q_stats(op, _q_path(ctx, True), ctx["decision"][1])
        return dense_fn(*args)


def _q_factors(u, v):
    # U and V are the small dense factors by contract (m x k, n x k)
    return sp.ensure_dense(u), sp.ensure_dense(v)


def wsloss(x, u, v, w=None, post: str = "NONE"):
    """Weighted squared loss: sum(W * (X - U%*%t(V))^2) and its variants
    (reference: WeightedSquaredLoss lop / matrixMultWSLoss)."""
    u, v = _q_factors(u, v)
    pattern = w if post in ("POST", "PRE") else x
    return _q_dispatch("wsloss", pattern, u, (x, u, v, w, post),
                       {"post": post})


def _wsloss_dense(x, u, v, w, post):
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


_q_family("wsloss", lambda x, u, v, w, post: sp.q_wsloss(x, u, v, w=w,
                                                         post=post),
          _wsloss_dense)


def wsigmoid(x, u, v, flags: str = ""):
    """X * sigmoid(U %*% t(V)) and its minus and log variants (reference:
    WeightedSigmoid lop / matrixMultWSigmoid)."""
    u, v = _q_factors(u, v)
    return _q_dispatch("wsigmoid", x, u, (x, u, v, flags), {"flags": flags})


def _wsigmoid_dense(x, u, v, flags):
    uv = torch.matmul(u, v.T)
    if "minus" in flags:
        uv = -uv
    s = torch.sigmoid(uv)
    if "log" in flags:
        s = torch.log(s)
    return sp.ensure_dense(x) * s


_q_family("wsigmoid", sp.q_wsigmoid, _wsigmoid_dense)


def wdivmm(x, u, v, left: bool, mult: bool = False, eps: float = 0.0):
    """Weighted divide matrix-mult (reference: WeightedDivMM): with
    W = X * (U %*% t(V)) (mult) or X / (U %*% t(V) + eps), returns
    t(W) %*% U (left) or W %*% V. The dense arm builds the (m, n) product
    and W by torch.matmul, in true fp32 under the "highest" policy; the
    sampled arm (ALS-CG's half-steps on a sparse W) never does."""
    u, v = _q_factors(u, v)
    return _q_dispatch("wdivmm", x, u, (x, u, v, left, mult, eps),
                       {"left": left, "mult": mult, "eps": eps})


def _wdivmm_dense(x, u, v, left, mult, eps):
    xd = sp.ensure_dense(x)
    uv = torch.matmul(u, v.T)
    wd = xd * uv if mult else xd / (uv + eps)
    return torch.matmul(wd.T, u) if left else torch.matmul(wd, v)


_q_family("wdivmm", lambda x, u, v, left, mult, eps: sp.q_wdivmm(
    x, u, v, left, mult_w=mult, eps=eps), _wdivmm_dense)


def wcemm(x, u, v, eps: float = 0.0):
    """Weighted cross-entropy: sum(X * log(U%*%t(V) + eps)) (reference:
    WeightedCrossEntropy lop / matrixMultWCeMM)."""
    u, v = _q_factors(u, v)
    return _q_dispatch("wcemm", x, u, (x, u, v, eps), {"eps": eps})


def _wcemm_dense(x, u, v, eps):
    uv = torch.matmul(u, v.T)
    return torch.sum(sp.ensure_dense(x) * torch.log(uv + eps))


_q_family("wcemm", sp.q_wcemm, _wcemm_dense)


def wumm(x, u, v, op: str = "*", fn=None, uop: str = None):
    """Weighted unary mm: X op fn(U%*%t(V)) (reference: WeightedUnaryMM
    lop / matrixMultWuMM). `uop` names the unary (the HOP rewrite's
    spelling); `fn`, a Python callable, is the legacy form for direct
    callers and always takes the dense arm, uncounted and not
    dispatched (a callable has no stable kernel key), as in the JAX
    package."""
    u, v = _q_factors(u, v)
    if uop is None:
        uv = torch.matmul(u, v.T)
        if fn is not None:
            uv = fn(uv)
        xd = sp.ensure_dense(x)
        return xd * uv if op == "*" else xd / uv
    return _q_dispatch("wumm", x, u, (x, u, v, op, uop),
                       {"op": op, "uop": uop})


def _wumm_dense(x, u, v, op, uop):
    from systemml_tpu_torch.ops import cellwise

    uv = cellwise.unary_op(uop, torch.matmul(u, v.T))
    xd = sp.ensure_dense(x)
    return xd * uv if op == "*" else xd / uv


_q_family("wumm", lambda x, u, v, op, uop: sp.q_wumm(x, u, v, uop=uop,
                                                     div=(op == "/")),
          _wumm_dense)
