# Copy of systemml_tpu/hops/estim.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""Sparsity estimators for matrix expressions.

TPU-native equivalent of the reference's hops/estim/ package
(SparsityEstimator.java:27 base; EstimatorBasicAvg, EstimatorBasicWorst,
EstimatorBitsetMM, EstimatorDensityMap, EstimatorMatrixHistogram:35 — the
MNC row/col-nnz histogram estimator). Estimates drive the densify-vs-stay-
sparse decision and memory estimates for mesh-vs-single-device selection:
XLA is dense-first, so a good matmult output-sparsity estimate is what
tells the planner when densification is affordable (SURVEY §7 hard part
"Sparsity on TPU").

All estimators accept either numpy arrays or (rows, cols, sparsity)
metadata triples; structure-aware estimators additionally accept their own
summary type (DensityMap / MatrixHistogram) so summaries can be propagated
through expression chains without materializing intermediates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np


@dataclass
class MetaSpec:
    rows: int
    cols: int
    sparsity: float  # nnz / (rows*cols)

    @property
    def nnz(self) -> float:
        return self.sparsity * self.rows * self.cols


MatrixLike = Union[np.ndarray, MetaSpec]


def _meta(x: MatrixLike) -> MetaSpec:
    if isinstance(x, MetaSpec):
        return x
    arr = np.asarray(x)
    nnz = int(np.count_nonzero(arr))
    return MetaSpec(arr.shape[0], arr.shape[1],
                    nnz / max(1, arr.size))


def sparsity_of(x: MatrixLike) -> float:
    return _meta(x).sparsity


# --------------------------------------------------------------------------
# Metadata-only estimators
# --------------------------------------------------------------------------

class SparsityEstimator:
    """Base interface (reference: hops/estim/SparsityEstimator.java:27).
    estim(A, B, op) -> output sparsity in [0,1]; op in
    {'mm','mult','plus','rbind','cbind'} (reference OpCode enum)."""

    def estim(self, A: MatrixLike, B: Optional[MatrixLike] = None,
              op: str = "mm") -> float:
        raise NotImplementedError

    # shared elementwise metadata formulas (reference: estimIntern of the
    # basic estimators; OptimizerUtils.getBinaryOpSparsity)
    def _elementwise(self, a: MetaSpec, b: MetaSpec, op: str) -> float:
        if op == "mult":       # nonzero iff both nonzero (independence)
            return a.sparsity * b.sparsity
        if op == "plus":       # nonzero if either (minus cancellation ~0)
            return a.sparsity + b.sparsity - a.sparsity * b.sparsity
        if op == "rbind":
            tot = (a.rows + b.rows) * a.cols
            return (a.nnz + b.nnz) / max(1, tot)
        if op == "cbind":
            tot = a.rows * (a.cols + b.cols)
            return (a.nnz + b.nnz) / max(1, tot)
        raise ValueError(f"unknown op {op!r}")


class EstimatorBasicAvg(SparsityEstimator):
    """Average-case: each output cell of C=A@B is nonzero unless all k
    products vanish -> sp = 1-(1-spA*spB)^k (reference:
    EstimatorBasicAvg.java, OptimizerUtils.getMatMultSparsity avg case)."""

    def estim(self, A, B=None, op="mm"):
        a = _meta(A)
        if op != "mm":
            return self._elementwise(a, _meta(B), op)
        b = _meta(B)
        k = a.cols
        return float(1.0 - (1.0 - a.sparsity * b.sparsity) ** k)


class EstimatorBasicWorst(SparsityEstimator):
    """Worst-case upper bound: assumes no cancellation and maximal overlap —
    nnz(C) <= min(nnz(A)*cB, nnz(B)*rA, rA*cB) (reference:
    EstimatorBasicWorst.java)."""

    def estim(self, A, B=None, op="mm"):
        a = _meta(A)
        if op != "mm":
            b = _meta(B)
            if op == "mult":
                return min(a.sparsity, b.sparsity)
            if op == "plus":
                return min(1.0, a.sparsity + b.sparsity)
            return self._elementwise(a, b, op)
        b = _meta(B)
        out_cells = max(1, a.rows * b.cols)
        nnz_ub = min(a.nnz * b.cols, b.nnz * a.rows, out_cells)
        return float(nnz_ub / out_cells)


# --------------------------------------------------------------------------
# Structure-aware estimators
# --------------------------------------------------------------------------

class EstimatorBitsetMM(SparsityEstimator):
    """Exact: boolean matrix product of the nonzero patterns (reference:
    EstimatorBitsetMM.java — bitset row vectors OR-ed per scalar product).
    O(m*n*k) like the product itself, so only worth it for repeated reuse
    of the same operands (e.g. loop-invariant chains)."""

    def estim(self, A, B=None, op="mm"):
        pa = np.asarray(A) != 0
        if op == "mult":
            return float(np.count_nonzero(pa & (np.asarray(B) != 0)) / pa.size)
        if op == "plus":
            return float(np.count_nonzero(pa | (np.asarray(B) != 0)) / pa.size)
        if op != "mm":
            return self._elementwise(_meta(A), _meta(B), op)
        pb = np.asarray(B) != 0
        pc = pa.astype(np.float32) @ pb.astype(np.float32) > 0
        return float(np.count_nonzero(pc) / pc.size)

    def pattern(self, A, B):
        """Exact output nonzero pattern (used by tests and the compressed
        planner)."""
        pa = (np.asarray(A) != 0).astype(np.float32)
        pb = (np.asarray(B) != 0).astype(np.float32)
        return (pa @ pb) > 0


@dataclass
class DensityMap:
    """Per-block density summary (reference: EstimatorDensityMap.java —
    density maps at blocksize granularity, mm via block-level avg-case)."""

    dens: np.ndarray  # (nbr, nbc) block densities in [0,1]
    rows: int
    cols: int
    blocksize: int

    @staticmethod
    def of(A: np.ndarray, blocksize: int = 256) -> "DensityMap":
        A = np.asarray(A)
        m, n = A.shape
        bs = blocksize
        nbr = (m + bs - 1) // bs
        nbc = (n + bs - 1) // bs
        # vectorized per-block nonzero counts via reduceat on both axes
        p = (A != 0).astype(np.int64)
        rstops = np.arange(0, m, bs)
        cstops = np.arange(0, n, bs)
        counts = np.add.reduceat(np.add.reduceat(p, rstops, axis=0),
                                 cstops, axis=1)
        rext = np.minimum(bs, m - rstops)[:, None]
        cext = np.minimum(bs, n - cstops)[None, :]
        d = counts / np.maximum(1, rext * cext)
        assert d.shape == (nbr, nbc)
        return DensityMap(d, m, n, bs)


class EstimatorDensityMap(SparsityEstimator):
    def __init__(self, blocksize: int = 256):
        self.blocksize = blocksize

    def estim(self, A, B=None, op="mm"):
        if op != "mm":
            return EstimatorBasicAvg().estim(_meta(A), _meta(B), op)
        da = A if isinstance(A, DensityMap) else DensityMap.of(A, self.blocksize)
        db = B if isinstance(B, DensityMap) else DensityMap.of(B, self.blocksize)
        if da.blocksize != db.blocksize:
            raise ValueError(
                f"DensityMap blocksize mismatch: {da.blocksize} vs "
                f"{db.blocksize}; rebuild one summary at a common blocksize")
        bs = da.blocksize
        # block-level avg-case composition: output block density is the
        # no-cancellation union over the k block products
        out = np.ones((da.dens.shape[0], db.dens.shape[1]))
        for kb in range(da.dens.shape[1]):
            k_inner = min(bs, da.cols - kb * bs)
            # per-block avg-case mm sparsity for this k-slab
            s = 1.0 - (1.0 - np.outer(da.dens[:, kb], db.dens[kb, :])) ** k_inner
            out *= (1.0 - s)
        dens = 1.0 - out
        # weight edge blocks by true extent
        total, nnz = 0.0, 0.0
        for i in range(dens.shape[0]):
            ri = min(bs, da.rows - i * bs)
            for j in range(dens.shape[1]):
                cj = min(bs, db.cols - j * bs)
                total += ri * cj
                nnz += dens[i, j] * ri * cj
        return float(nnz / max(1.0, total))


@dataclass
class MatrixHistogram:
    """MNC summary: row-nnz and col-nnz histograms (reference:
    EstimatorMatrixHistogram.java:35 — "Matrix Non-zero Count" sketch)."""

    row_nnz: np.ndarray  # (m,) nnz per row
    col_nnz: np.ndarray  # (n,) nnz per column

    @staticmethod
    def of(A: np.ndarray) -> "MatrixHistogram":
        p = np.asarray(A) != 0
        return MatrixHistogram(p.sum(axis=1), p.sum(axis=0))

    @property
    def rows(self) -> int:
        return len(self.row_nnz)

    @property
    def cols(self) -> int:
        return len(self.col_nnz)


class EstimatorMatrixHistogram(SparsityEstimator):
    """MNC estimator. For C=A@B with histograms hA, hB:
    expected nnz of output row i = n * (1 - prod_{j: a_ij != 0}
    (1 - rowB_nnz[j]/n)) — products over the actual sparse row pattern,
    approximated through the column histogram when only summaries exist.
    Exact for the common special cases (fully-dense inner dim, diagonal)."""

    def estim(self, A, B=None, op="mm"):
        if op != "mm":
            return EstimatorBasicAvg().estim(_meta(A), _meta(B), op)
        if isinstance(A, MatrixHistogram) or isinstance(B, MatrixHistogram):
            return self._estim_meta(
                A if isinstance(A, MatrixHistogram) else MatrixHistogram.of(A),
                B if isinstance(B, MatrixHistogram) else MatrixHistogram.of(B))
        return self._estim_exactrows(np.asarray(A), np.asarray(B))

    def _estim_exactrows(self, A: np.ndarray, B: np.ndarray) -> float:
        n = B.shape[1]
        if n == 0 or A.shape[0] == 0:
            return 0.0
        rB = (B != 0).sum(axis=1) / n            # P(b_jk != 0)
        # log-domain product over each row's nonzero pattern
        with np.errstate(divide="ignore"):
            logs = np.log1p(-np.minimum(rB, 1.0 - 1e-12))
        rowlog = (A != 0).astype(np.float64) @ logs
        nnz = float(np.sum(n * (1.0 - np.exp(rowlog))))
        return nnz / (A.shape[0] * n)

    def _estim_meta(self, hA: MatrixHistogram, hB: MatrixHistogram) -> float:
        n = hB.cols
        if n == 0 or hA.rows == 0:
            return 0.0
        rB = np.minimum(hB.row_nnz / n, 1.0 - 1e-12)
        # expected log-survival of one output cell given a_ij nonzero with
        # probability colA_nnz[j]/m — composes the two histograms
        mean_log = float(np.mean(np.log1p(-rB))) if len(rB) else 0.0
        # each row i of A has row_nnz[i] nonzeros hitting "average" columns
        nnz = float(np.sum(n * (1.0 - np.exp(hA.row_nnz * mean_log))))
        return nnz / (hA.rows * n)


# --------------------------------------------------------------------------
# Compile-time worst-case nnz bounds (feed Hop.nnz propagation, hops/ipa)
# --------------------------------------------------------------------------

def worst_case_mm_nnz(rows_a: int, nnz_a: int, cols_b: int,
                      nnz_b: int) -> int:
    """Worst-case nnz(A@B) under no-cancellation sparse semantics
    (reference: EstimatorBasicWorst.java): each nonzero of A touches at
    most cols_b output cells, each of B at most rows_a, capped at the
    dense output. -1 means unknown; an empty operand proves an empty
    product regardless of the other side."""
    if nnz_a == 0 or nnz_b == 0:
        return 0
    cands = []
    if nnz_a >= 0 and cols_b >= 0:
        cands.append(nnz_a * cols_b)
    if nnz_b >= 0 and rows_a >= 0:
        cands.append(nnz_b * rows_a)
    if rows_a >= 0 and cols_b >= 0:
        cands.append(rows_a * cols_b)
    return min(cands) if cands else -1


def worst_case_ew_nnz(op: str, nnz_a: int, nnz_b: int, cells: int) -> int:
    """Worst-case nnz of an elementwise combination whose operands are
    already expanded to the output shape (broadcast scaling happens at
    the caller). 'mult' intersects (min of the sides), 'plus' unions
    (sum, capped at the dense output) — the same formulas as
    EstimatorBasicWorst.estimIntern, on counts instead of sparsities.
    -1 means unknown on either side of the bound."""
    if op == "mult":
        if nnz_a == 0 or nnz_b == 0:
            return 0
        known = [n for n in (nnz_a, nnz_b) if n >= 0]
        if not known:
            return -1
        n = min(known)
        return min(n, cells) if cells >= 0 else n
    if op == "plus":
        # union bound: output cell nonzero requires a nonzero on at
        # least one side (holds for +, -, min, max)
        if nnz_a == 0 and nnz_b == 0:
            return 0
        if nnz_a < 0 or nnz_b < 0:
            return -1
        n = nnz_a + nnz_b
        return min(n, cells) if cells >= 0 else n
    raise ValueError(f"unknown op {op!r}")


def estimate_mm_sparsity(A: MatrixLike, B: MatrixLike,
                         estimator: Optional[SparsityEstimator] = None) -> float:
    """Planner entry point: default avg-case metadata estimate (reference:
    OptimizerUtils.getMatMultSparsity call sites in AggBinaryOp)."""
    return (estimator or EstimatorBasicAvg()).estim(A, B, "mm")
