# Port of systemml_tpu/hops/cost.py: HwProfile and OpCost (lines 23-63),
# and of op_cost (line 104) the matmult branches that spoof plan selection
# reads (codegen/memo.py costs matmult leaves with it), with the imports
# pointed at systemml_tpu_torch. What differs: HwProfile gains h100(),
# detect() chooses by the active config's device instead of the JAX
# backend, and op_cost gives NaN (unknown) for the ops no caller costs
# yet. quaternary_exploit (line 185 there) is the decision of ops/mult.py's
# weighted quaternary ops. kernel_feature_row, the other op branches and
# the DAG and collective costs wait for their callers (ROADMAP queue 1:
# kernel backend, distributed).
"""Static time-cost estimator for HOP plans.

TPU-native equivalent of the reference's hops/cost/ package
(CostEstimatorStaticRuntime.java, CostEstimationWrapper.java — static
per-instruction IO + compute time used by the parfor optimizer and the
resource optimizer). The hardware model is a roofline: an op costs
max(flops/peak, bytes/bandwidth) plus a fixed dispatch latency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from systemml_tpu_torch.hops.hop import Hop


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


def _mm_dtype() -> str:
    from systemml_tpu_torch.utils.config import get_config

    return ("bf16" if get_config().floating_point_precision == "bfloat16"
            else "f32")


def op_cost(h: Hop, hw: HwProfile) -> OpCost:
    """FLOPs + HBM bytes of one matmult hop (ba+*, tsmm, mmchain), given
    propagated dims (hops/ipa.py propagate_sizes). Unknown dims, and any
    other op, yield NaN costs that poison the total: callers fall back to
    structural decisions then."""
    bc = hw.bytes_per_cell
    op = h.op
    ins = h.inputs
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
