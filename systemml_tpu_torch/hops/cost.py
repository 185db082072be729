# Port of systemml_tpu/hops/cost.py: HwProfile and OpCost (lines 23-63),
# op_cost (line 104; codegen/memo.py costs matmult leaves with it),
# quaternary_exploit (line 179, the decision of ops/mult.py's weighted
# quaternary ops), estimate_dag_cost (line 231, the parfor optimizer's
# body cost, runtime/parfor_opt.py) and kernel_feature_row (line 66, the
# kernel cost model's roofline features, codegen/costmodel.py), with the
# imports pointed at systemml_tpu_torch. What differs: HwProfile gains
# h100(), and detect() chooses by the active config's device instead of
# the JAX backend. The collective costs wait for their callers (ROADMAP
# queue 1: distributed).
"""Static time-cost estimator for HOP plans.

TPU-native equivalent of the reference's hops/cost/ package
(CostEstimatorStaticRuntime.java, CostEstimationWrapper.java — static
per-instruction IO + compute time used by the parfor optimizer and the
resource optimizer). The hardware model is a roofline: an op costs
max(flops/peak, bytes/bandwidth) plus a fixed dispatch latency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from systemml_tpu_torch.hops.hop import Hop, postorder


@dataclass
class HwProfile:
    """Per-device hardware profile. The defaults are those of the JAX
    package's TPU v5e profile and are not used by the port: `h100()` is
    the card's, `cpu()` the host profile the CPU runs use (the same
    numbers as the JAX package's, so that on the CPU both packages
    select the same fusion plans)."""

    peak_flops: float = 197e12      # bf16 MXU
    peak_flops_f32: float = 98e12
    hbm_bw: float = 819e9           # bytes/s
    hbm_bytes: float = 16e9
    ici_bw: float = 180e9           # per-link, bytes/s (v5e 4x ICI)
    dcn_bw: float = 25e9
    dispatch_us: float = 3.0        # per-executable launch overhead
    bytes_per_cell: int = 4         # fp32 on device

    @staticmethod
    def cpu() -> "HwProfile":
        return HwProfile(peak_flops=200e9, peak_flops_f32=200e9,
                         hbm_bw=40e9, hbm_bytes=32e9, ici_bw=10e9,
                         dcn_bw=2e9, dispatch_us=1.0, bytes_per_cell=8)

    @staticmethod
    def h100() -> "HwProfile":
        """NVIDIA H100 SXM (data sheet): 3.35 TB/s HBM3, 67 TFLOP/s fp32
        outside the tensor cores, 989 TFLOP/s bf16 dense, 80 GB, NVLink
        450 GB/s each way. dispatch_us is the host time of one spoof
        kernel wrapper call on a tiny input, 31.85 and 54.28 us in two
        runs of chip_smoke.py on an NVIDIA H100 80GB HBM3 at its 700 W
        limit (PERF.md)."""
        return HwProfile(peak_flops=989e12, peak_flops_f32=67e12,
                         hbm_bw=3.35e12, hbm_bytes=80e9, ici_bw=450e9,
                         dcn_bw=25e9, dispatch_us=32.0, bytes_per_cell=4)

    @staticmethod
    def detect() -> "HwProfile":
        from systemml_tpu_torch.utils.config import get_config

        return (HwProfile.cpu() if get_config().device == "cpu"
                else HwProfile.h100())


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0  # HBM traffic: inputs read + output written
    dtype: str = "f32"  # matmuls costed at bf16 rate when config allows

    def time(self, hw: HwProfile) -> float:
        rate = hw.peak_flops if self.dtype == "bf16" else hw.peak_flops_f32
        return max(self.flops / rate, self.bytes / hw.hbm_bw)


def kernel_feature_row(shape, dtype_bytes: int = 4,
                       sparsity: Optional[float] = None,
                       hw: Optional[HwProfile] = None) -> list:
    """Hand-engineered roofline features for the learned kernel cost
    model (codegen/costmodel.py): log-scale cell/byte/nnz volumes and
    the modeled memory + dispatch times of touching the carrier once.
    Log scale because kernel wall time spans ~6 decades across the
    shape buckets and the model regresses log time."""
    import math

    hw = hw or HwProfile.detect()
    cells = 1.0
    for d in shape:
        cells *= max(1, int(d))
    frac = (float(sparsity)
            if sparsity is not None and 0.0 <= float(sparsity) <= 1.0
            else 1.0)
    byts = cells * max(1, int(dtype_bytes))
    return [
        math.log10(cells + 1.0),
        math.log10(cells * frac + 1.0),             # nnz volume
        math.log10(byts / hw.hbm_bw + 1e-12),       # one-pass memory time
        math.log10(hw.dispatch_us * 1e-6 + 1e-12),  # launch overhead floor
    ]


def _cells(h: Hop) -> float:
    c = h.cells()
    return float(c) if c >= 0 else float("nan")


def _mm_dtype() -> str:
    from systemml_tpu_torch.utils.config import get_config

    return ("bf16" if get_config().floating_point_precision == "bfloat16"
            else "f32")


def op_cost(h: Hop, hw: HwProfile) -> OpCost:
    """FLOPs + HBM bytes of one hop, given propagated dims (hops/ipa.py
    propagate_sizes). Unknown dims yield NaN costs that poison the total —
    callers fall back to dynamic decisions then (the reference returns
    DEFAULT estimates instead; NaN is more honest for planning)."""
    bc = hw.bytes_per_cell
    op = h.op
    ins = h.inputs
    out = _cells(h)
    in_cells = sum(_cells(c) for c in ins if c.is_matrix)
    if op == "ba+*":
        m, k, n = ins[0].rows, ins[0].cols, ins[1].cols
        if min(m, k, n) < 0:
            return OpCost(float("nan"), float("nan"))
        return OpCost(2.0 * m * k * n, (m * k + k * n + m * n) * bc,
                      _mm_dtype())
    if op == "tsmm":
        m, k = ins[0].rows, ins[0].cols
        if min(m, k) < 0:
            return OpCost(float("nan"), float("nan"))
        n = k if h.params.get("left") else m
        return OpCost(1.0 * m * k * max(n, 1),  # symmetric half
                      (m * k + n * n) * bc)
    if op == "mmchain":
        m, k = ins[0].rows, ins[0].cols
        if min(m, k) < 0:
            return OpCost(float("nan"), float("nan"))
        return OpCost(4.0 * m * k, (m * k) * bc)  # X read once when fused
    if op.startswith("q("):
        # weighted quaternary over X (m x n), U (m x k), V (n x k): the
        # exploiting kernel samples U@t(V) at the PATTERN CARRIER's
        # nonzeros — nnz*k MACs — while the dense referent pays the full
        # m*n*k product. The carrier is W for wsloss POST/PRE (the
        # runtime keys its dispatch on the same operand, ops/mult.py),
        # X otherwise. Cost the EXPECTED path: est_sp scales the
        # sampled work; unknown sparsity costs dense (honest worst case).
        m, n = ins[0].rows, ins[0].cols
        k = ins[1].cols if len(ins) > 1 else -1
        if min(m, n, k) < 0:
            return OpCost(float("nan"), float("nan"))
        carrier = ins[3] if (op == "q(wsloss)"
                             and h.params.get("post") in ("POST", "PRE")
                             and len(ins) > 3) else ins[0]
        sp = carrier.est_sp if carrier.est_sp >= 0 else 1.0
        nnz = sp * m * n
        if quaternary_exploit(m, n, k, nnz, hw)[0]:
            return OpCost(QUATERNARY_GATHER_OVERHEAD * 2.0 * nnz * k,
                          (m * k + n * k) * bc + nnz * (bc + 4))
        return OpCost(2.0 * m * k * n, (m * k + n * k + m * n) * bc,
                      _mm_dtype())
    if op.startswith("ua(") or op.startswith("cum("):
        return OpCost(in_cells, (in_cells + out) * bc)
    if op.startswith("b(") or op.startswith("u("):
        return OpCost(max(in_cells, out), (in_cells + out) * bc)
    if op in ("reorg(t)", "reorg(rev)", "cbind", "rbind", "idx", "lidx"):
        return OpCost(0.0, (in_cells + out) * bc)
    if op == "call:rand":
        return OpCost(10.0 * out, out * bc)
    if op in ("lit", "tread", "twrite", "nrow", "ncol", "length"):
        return OpCost(0.0, 0.0)
    # generic builtin: assume bandwidth-bound single pass
    if out == out:  # not NaN
        return OpCost(in_cells, (in_cells + out) * bc)
    return OpCost(float("nan"), float("nan"))


# gather/scatter kernels retire far fewer MACs/cycle than the matrix
# unit: the JAX package's factor over the dense matmult FLOP rate, which
# the memo table's outer-product costing reads; kept so that plan
# selection stays the same
QUATERNARY_GATHER_OVERHEAD = 16.0


def quaternary_exploit(m: int, n: int, k: int, nnz: float,
                       hw: Optional[HwProfile] = None,
                       budget_bytes: Optional[float] = None
                       ) -> Tuple[bool, str]:
    """The dense-or-sampled decision of the weighted quaternary ops
    (reference: LibMatrixMult.matrixMultW*'s sparse-or-dense split), as the
    JAX package takes it. Returns (exploit?, reason): exploit when the
    dense (m, n) product takes more than a quarter of the budget and the
    sampled arm is the smaller ("infeasible"), or when the sampled arm's
    roofline time (nnz * k gathers at QUATERNARY_GATHER_OVERHEAD) beats the
    dense product's ("cheaper"); "dense_wins" otherwise. The budget is
    mem_budget_bytes or the device's (HwProfile.detect(): the H100's on
    the card)."""
    hw = hw or HwProfile.detect()
    bc = hw.bytes_per_cell
    if budget_bytes is None:
        from systemml_tpu_torch.utils.config import get_config

        budget_bytes = get_config().mem_budget_bytes or hw.hbm_bytes
    dense = OpCost(2.0 * m * float(n) * k,
                   (m * float(k) + n * float(k) + m * float(n)) * bc)
    exploit = OpCost(QUATERNARY_GATHER_OVERHEAD * 2.0 * float(nnz) * k,
                     (m * float(k) + n * float(k)
                      + float(nnz) * (bc + 4)))
    if float(m) * n * bc > budget_bytes / 4.0:
        # the dense product busts the budget; the sampled arm is the way
        # out only when it is the smaller one
        if exploit.bytes < dense.bytes:
            return True, "infeasible"
        return False, "dense_wins"
    if exploit.time(hw) < dense.time(hw):
        return True, "cheaper"
    return False, "dense_wins"


@dataclass
class PlanCost:
    time_s: float
    flops: float
    bytes: float
    per_op: List[Tuple[str, float]]

    @property
    def known(self) -> bool:
        return self.time_s == self.time_s  # not NaN


def estimate_dag_cost(roots: List[Hop], hw: Optional[HwProfile] = None,
                      fused: bool = True) -> PlanCost:
    """Cost of one HOP DAG execution (reference:
    CostEstimationWrapper.getTimeEstimate). `fused=True` models whole-block
    XLA compilation: one dispatch total and intermediate elementwise
    results staying in registers/VMEM — elementwise bytes between producer
    and consumer in the same block are not charged."""
    hw = hw or HwProfile.detect()
    total_f, total_b, t = 0.0, 0.0, 0.0
    per_op: List[Tuple[str, float]] = []
    order = postorder(roots)
    n_dispatch = 1 if fused else sum(
        1 for h in order if h.op not in ("lit", "tread", "twrite"))
    for h in order:
        c = op_cost(h, hw)
        if fused and (h.op.startswith("b(") or h.op.startswith("u(")):
            # fused elementwise: compute stays, traffic melts into neighbors
            c = OpCost(c.flops, 0.0)
        total_f += c.flops
        total_b += c.bytes
        ot = c.time(hw)
        t += ot
        if ot > 0 or ot != ot:
            per_op.append((h.op, ot))
    t += n_dispatch * hw.dispatch_us * 1e-6
    return PlanCost(t, total_f, total_b, per_op)
