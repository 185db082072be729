# Copy of systemml_tpu/compress/block.py for the PyTorch port: the same
# code, with its imports pointed at systemml_tpu_torch. What differs:
# `to_dense` returns a torch tensor in the block's dtype on the configured
# device; `decompress` keeps its float64 numpy result.
"""Compressed matrix block + compression planner.

TPU-native equivalent of the reference's CompressedMatrixBlock
(runtime/compress/CompressedMatrixBlock.java:102, compress(k) at :228) and
its planning stack (sample-based size estimation in compress/estim/,
column co-coding, per-group encoding choice OLE/RLE/DDC/uncompressed).

Ops execute directly on the compressed form (matmult, tsmm, unary agg,
scalar ops) exactly like the reference; the TPU mapping is that DDC
matmults become gathers over tiny dictionary products (MXU does the
(d x g) work, the VPU does the gather), so compressed compute beats dense
whenever distinct-count << rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from systemml_tpu_torch.compress.colgroup import (ColGroup, ColGroupDDC,
                                                  ColGroupOLE, ColGroupRLE,
                                                  ColGroupUncompressed)

# a column compresses if its estimated compressed size is below this
# fraction of dense (reference: CompressedMatrixBlock.MIN_COMPRESSION_RATIO
# semantics — compression must pay for itself)
MIN_RATIO = 0.8
# max distinct fraction for a column to be considered compressible
MAX_DISTINCT_FRAC = 0.4
SAMPLE_ROWS = 4096


class CompressedMatrixBlock:
    def __init__(self, groups: List[ColGroup], shape: Tuple[int, int]):
        self.groups = groups
        self.shape = (int(shape[0]), int(shape[1]))

    # ---- metadata --------------------------------------------------------

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        for g in self.groups:
            return g.dictionary().dtype if not isinstance(
                g, ColGroupUncompressed) else g.values().dtype
        return np.float64

    def compressed_bytes(self) -> int:
        return sum(g.compressed_bytes() for g in self.groups)

    def compression_ratio(self) -> float:
        dense = self.shape[0] * self.shape[1] * 8
        return dense / max(1, self.compressed_bytes())

    def __repr__(self):
        kinds = ",".join(type(g).__name__.replace("ColGroup", "")
                         for g in self.groups)
        return (f"CompressedMatrix({self.shape[0]}x{self.shape[1]}, "
                f"groups=[{kinds}], ratio={self.compression_ratio():.1f}x)")

    # ---- decompress ------------------------------------------------------

    def decompress(self) -> np.ndarray:
        out = np.zeros(self.shape)
        for g in self.groups:
            g.decompress_into(out)
        return out

    def to_dense(self):
        """The dense form as a torch tensor in the block's dtype on the
        configured device."""
        import torch

        from systemml_tpu_torch.utils.config import get_config

        return torch.from_numpy(self.decompress().astype(self.dtype)).to(
            get_config().device)

    def to_numpy(self) -> np.ndarray:
        return self.decompress()

    # ---- compressed ops --------------------------------------------------

    def right_mult(self, w) -> np.ndarray:
        """X @ W without decompression."""
        w = np.asarray(w)
        if w.ndim == 1:
            w = w.reshape(-1, 1)
        out = np.zeros((self.shape[0], w.shape[1]))
        for g in self.groups:
            out += g.right_mult(w)
        return out

    def left_mult(self, yt) -> np.ndarray:
        """Y^T @ X: Y^T is (k, n)."""
        yt = np.asarray(yt)
        out = np.zeros((yt.shape[0], self.shape[1]))
        for g in self.groups:
            out[:, g.cols] = g.left_mult(yt)
        return out

    def tsmm(self) -> np.ndarray:
        """t(X) @ X on the compressed form: value groups combine through
        joint code histograms (reference:
        CompressedMatrixBlock.transposeSelfMatrixMultOperations)."""
        n_c = self.shape[1]
        out = np.zeros((n_c, n_c))
        for i, gi in enumerate(self.groups):
            for j, gj in enumerate(self.groups):
                if j < i:
                    continue
                blk = self._tsmm_pair(gi, gj)
                out[np.ix_(gi.cols, gj.cols)] = blk
                if j > i:
                    out[np.ix_(gj.cols, gi.cols)] = blk.T
        return out

    def _tsmm_pair(self, gi: ColGroup, gj: ColGroup) -> np.ndarray:
        ui = isinstance(gi, ColGroupUncompressed)
        uj = isinstance(gj, ColGroupUncompressed)
        if not ui and not uj:
            di, dj = gi.dictionary(), gj.dictionary()
            if gi is gj:
                cnt = gi.value_counts().astype(np.float64)
                return di.T @ (cnt[:, None] * di)
            ci, cj = gi.codes(), gj.codes()
            joint = np.zeros((di.shape[0], dj.shape[0]))
            np.add.at(joint, (ci, cj), 1.0)
            return di.T @ joint @ dj
        vi = gi.values() if ui else gi.dictionary()[gi.codes()]
        vj = gj.values() if uj else gj.dictionary()[gj.codes()]
        return vi.T @ vj

    def col_sums(self) -> np.ndarray:
        out = np.zeros(self.shape[1])
        for g in self.groups:
            out[g.cols] = g.col_sums()
        return out

    def sum(self) -> float:
        return float(self.col_sums().sum())

    def col_minmax(self, which: str) -> np.ndarray:
        out = np.zeros(self.shape[1])
        for g in self.groups:
            out[g.cols] = g.col_minmax(which)
        return out

    def minmax(self, which: str) -> float:
        v = self.col_minmax(which)
        return float(v.min() if which == "min" else v.max())

    def value_map(self, fn) -> "CompressedMatrixBlock":
        """Scalar/unary op on dictionaries only — O(total distinct)."""
        return CompressedMatrixBlock([g.value_map(fn) for g in self.groups],
                                     self.shape)

    def scale(self, s: float) -> "CompressedMatrixBlock":
        return self.value_map(lambda d: d * s)


def is_compressed(v) -> bool:
    return isinstance(v, CompressedMatrixBlock)


# --------------------------------------------------------------------------
# compression planner (reference: CompressedMatrixBlock.compress(k):228 +
# compress/estim/CompressedSizeEstimatorSample)
# --------------------------------------------------------------------------

def _estimate_col(col: np.ndarray, sample_idx) -> Tuple[float, int]:
    """(estimated compressed fraction of dense, estimated #distinct)."""
    s = col[sample_idx]
    d = len(np.unique(s))
    n = len(col)
    frac_distinct = d / max(1, len(s))
    est_distinct = int(frac_distinct * n) if frac_distinct > 0.1 else d
    # DDC cost model: dict + 1-4B codes vs 8B dense
    code_bytes = 1 if est_distinct <= 256 else (2 if est_distinct <= 65536 else 4)
    est_bytes = est_distinct * 8 + n * code_bytes
    return est_bytes / (n * 8), est_distinct


def _col_codes(col: np.ndarray):
    """(dict, codes) for one column without sorting the full column:
    candidate dictionary from a sorted pass over distinct sample values,
    codes via searchsorted, full-unique fallback only when the sample
    missed values (reference analog: BitmapEncoder extractBitmap, but
    vectorized instead of per-row hashing)."""
    cand = np.unique(col[:: max(1, len(col) // (4 * SAMPLE_ROWS))])
    codes = np.searchsorted(cand, col)
    codes = np.clip(codes, 0, len(cand) - 1)
    if np.array_equal(cand[codes], col):
        return cand, codes.astype(np.int64)
    cand, codes = np.unique(col, return_inverse=True)
    return cand, codes.reshape(-1).astype(np.int64)


def _cocode(cols: List[int], col_codes, col_dicts,
            sample_idx) -> List[List[int]]:
    """Greedy column co-coding (reference: PlanningCoCoder): merge column
    pairs while the joint distinct count stays far below the product —
    i.e. the columns are correlated enough that one shared code pays off.
    Works on precomputed integer codes so every distinct-count is a cheap
    int unique, never a float axis=0 sort."""
    groups = [[c] for c in cols]
    # per-group sample codes + SAMPLE cardinality, maintained across
    # merges — comparing a sample joint count against full-column
    # cardinalities would bias the correlation test toward merging
    # high-cardinality columns whose sample underestimates them
    scode = {tuple([c]): col_codes[c][sample_idx] for c in cols}
    card = {tuple([c]): len(np.unique(col_codes[c][sample_idx]))
            for c in cols}
    changed = True
    while changed and len(groups) > 1:
        changed = False
        best = None
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                gi, gj = groups[i], groups[j]
                if len(gi) + len(gj) > 4:
                    continue
                di, dj = card[tuple(gi)], card[tuple(gj)]
                if di * dj > (1 << 30):
                    continue
                joint = len(np.unique(scode[tuple(gi)] * dj
                                      + scode[tuple(gj)]))
                # correlation test: joint distinct-count far below the
                # independence expectation di*dj means one shared code
                # array pays for itself (saves a full per-row code array);
                # cap the joint dictionary so compressed compute stays
                # dictionary-dominated (reference: PlanningCoCoder group
                # size/cardinality bounds)
                if joint <= 0.5 * di * dj and joint <= 256:
                    gain = di * dj - joint
                    if best is None or gain > best[0]:
                        best = (gain, i, j)
        if best is not None:
            _, i, j = best
            gi, gj = groups[i], groups[j]
            di, dj = card[tuple(gi)], card[tuple(gj)]
            merged = gi + gj
            mcode = scode[tuple(gi)] * dj + scode[tuple(gj)]
            uniq, inv = np.unique(mcode, return_inverse=True)
            groups[i] = merged
            del groups[j]
            scode[tuple(merged)] = inv
            card[tuple(merged)] = len(uniq)
            changed = True
    return groups


def compress(X, k: Optional[int] = None) -> CompressedMatrixBlock:
    """Compress a dense matrix into column groups (reference:
    CompressedMatrixBlock.compress(k) — k was the thread count; host
    numpy vectorizes instead). Falls back to ColGroupUncompressed for
    incompressible columns; chooses RLE when runs are long, OLE when a
    dominant (sparse-like) default value exists, else DDC."""
    X = np.asarray(X)
    n, m = X.shape
    rng = np.random.default_rng(42)
    sample_idx = (np.arange(n) if n <= SAMPLE_ROWS
                  else np.sort(rng.choice(n, SAMPLE_ROWS, replace=False)))

    compressible, dense_cols = [], []
    for c in range(m):
        frac, d = _estimate_col(X[:, c], sample_idx)
        if frac < MIN_RATIO and d <= MAX_DISTINCT_FRAC * n:
            compressible.append(c)
        else:
            dense_cols.append(c)

    # one (dict, codes) pass per compressible column, reused by both the
    # co-coding planner and the group encoders
    col_dicts, col_codes = {}, {}
    for c in compressible:
        col_dicts[c], col_codes[c] = _col_codes(X[:, c])

    groups: List[ColGroup] = []
    for gcols in _cocode(compressible, col_codes, col_dicts, sample_idx):
        if len(gcols) == 1:
            c = gcols[0]
            dict_vals = col_dicts[c].reshape(-1, 1)
            codes = col_codes[c]
        else:
            # mixed-radix combine of per-column int codes: the joint
            # dictionary comes from first-occurrence rows, never a float
            # axis=0 sort over the full matrix. The radix product uses
            # FULL dictionary sizes (the co-coding test used sample
            # counts), so guard int64 overflow with exact Python ints
            # and fall back to the float row-sort when it would wrap.
            radix = 1
            for c in gcols:
                radix *= len(col_dicts[c])
            if radix < (1 << 62):
                combined = np.zeros(n, dtype=np.int64)
                for c in gcols:
                    combined = combined * len(col_dicts[c]) + col_codes[c]
                uniq, first, codes = np.unique(
                    combined, return_index=True, return_inverse=True)
                codes = codes.reshape(-1)
                dict_vals = X[np.ix_(first, gcols)]
            else:
                dict_vals, codes = np.unique(
                    X[:, gcols], axis=0, return_inverse=True)
                codes = codes.reshape(-1)
        groups.append(_choose_encoding(gcols, dict_vals, codes, n))
    if dense_cols:
        groups.append(ColGroupUncompressed(dense_cols, X[:, dense_cols]))
    return CompressedMatrixBlock(groups, (n, m))


def _choose_encoding(gcols, dict_vals, codes, n) -> ColGroup:
    n_runs = int(np.count_nonzero(np.diff(codes))) + 1
    counts = np.bincount(codes, minlength=dict_vals.shape[0])
    dominant = int(counts.argmax())
    d = dict_vals.shape[0]
    code_bytes = 1 if d <= 256 else (2 if d <= 65536 else 4)
    ddc_bytes = n * code_bytes
    rle_bytes = n_runs * 12
    ole_bytes = int((n - counts[dominant]) * 4)
    best = min(("ddc", ddc_bytes), ("rle", rle_bytes), ("ole", ole_bytes),
               key=lambda kv: kv[1])[0]
    if best == "rle":
        return ColGroupRLE.from_codes(gcols, dict_vals, codes)
    if best == "ole" and np.all(dict_vals[dominant] == 0):
        return ColGroupOLE.from_codes(gcols, dict_vals, codes,
                                      default_idx=dominant)
    return ColGroupDDC(gcols, dict_vals, codes)
