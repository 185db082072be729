# Copy of systemml_tpu/compress/colgroup.py for the PyTorch port: the same
# code. It imports only numpy; the groups, dictionaries and codes it builds
# are the host form, which compress/device.py mirrors onto the device.
"""Compressed column groups.

TPU-native equivalent of the reference's CLA column groups
(runtime/compress/ColGroupDDC1/2.java, ColGroupOLE.java:42,
ColGroupRLE.java, ColGroupUncompressed.java; dictionary extraction via
BitmapEncoder.java). Each group owns a set of columns, a dictionary of
distinct value-tuples, and an encoding of which dictionary entry each row
uses:

- DDC  (dense dictionary coding): per-row code array. On TPU the code
  array is THE useful form — `dict[codes]` is one gather, and
  `X_G @ W = gather(dict @ W, codes)` turns an (n x g) matmul into a
  (d x g) matmul plus a gather, the same trick the reference uses to
  skip decompression (ColGroupDDC.rightMultByVector) but mapped onto
  XLA's gather/one-hot machinery.
- OLE  (offset-list encoding): per-distinct-value row-offset lists.
- RLE  (run-length encoding): per-distinct-value [start,len] runs.
- Uncompressed: dense fallback for incompressible columns.

OLE/RLE store better than DDC for clustered data; for compute they
convert to codes on demand (reference analog: the per-group op kernels).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ColGroup:
    """Base: `cols` are the owned column indices in the source matrix."""

    cols: np.ndarray

    @property
    def num_cols(self) -> int:
        return len(self.cols)

    def num_rows(self) -> int:
        raise NotImplementedError

    def codes(self) -> np.ndarray:
        """Per-row dictionary index (decoding to DDC form)."""
        raise NotImplementedError

    def dictionary(self) -> np.ndarray:
        """(n_distinct, num_cols) distinct value-tuples."""
        raise NotImplementedError

    def decompress_into(self, out: np.ndarray):
        out[:, self.cols] = self.dictionary()[self.codes()]

    # ---- compressed compute (no decompression) --------------------------

    def right_mult(self, w: np.ndarray) -> np.ndarray:
        """X_G @ w_G -> (n, k): small dict matmul + gather."""
        small = self.dictionary() @ w[self.cols, :]   # (d, k)
        return small[self.codes()]

    def left_mult(self, yt: np.ndarray) -> np.ndarray:
        """y^T @ X_G -> (k, num_cols): segment-sum y rows by code, then one
        small matmul (reference: ColGroupValue.leftMultByMatrix)."""
        c = self.codes()
        d = self.dictionary().shape[0]
        k = yt.shape[0]
        sums = np.zeros((k, d), dtype=yt.dtype)
        for i in range(k):
            np.add.at(sums[i], c, yt[i])
        return sums @ self.dictionary()

    def value_counts(self) -> np.ndarray:
        return np.bincount(self.codes(),
                           minlength=self.dictionary().shape[0])

    def col_sums(self) -> np.ndarray:
        return self.value_counts() @ self.dictionary()

    def col_minmax(self, which: str) -> np.ndarray:
        d = self.dictionary()
        return d.min(axis=0) if which == "min" else d.max(axis=0)

    def value_map(self, fn) -> "ColGroup":
        """Scalar op applied to the dictionary ONLY — O(distinct) instead
        of O(n) (the core CLA compute win, reference:
        CompressedMatrixBlock.scalarOperations)."""
        raise NotImplementedError

    def compressed_bytes(self) -> int:
        raise NotImplementedError


class ColGroupDDC(ColGroup):
    """reference: ColGroupDDC1/DDC2 (1-/2-byte codes); here code width is
    chosen automatically (uint8/uint16/int32)."""

    def __init__(self, cols, dict_vals: np.ndarray, codes: np.ndarray):
        self.cols = np.asarray(cols, dtype=np.int64)
        self._dict = np.asarray(dict_vals)
        d = self._dict.shape[0]
        dt = np.uint8 if d <= 256 else (np.uint16 if d <= 65536 else np.int32)
        self._codes = codes.astype(dt)

    def num_rows(self) -> int:
        return len(self._codes)

    def codes(self) -> np.ndarray:
        return self._codes

    def dictionary(self) -> np.ndarray:
        return self._dict

    def value_map(self, fn) -> "ColGroupDDC":
        return ColGroupDDC(self.cols, fn(self._dict), self._codes)

    def compressed_bytes(self) -> int:
        return self._dict.nbytes + self._codes.nbytes


class ColGroupOLE(ColGroup):
    """reference: ColGroupOLE.java:42 — per-distinct-value offset lists."""

    def __init__(self, cols, dict_vals: np.ndarray,
                 offset_lists: List[np.ndarray], n_rows: int,
                 default_idx: Optional[int] = None):
        self.cols = np.asarray(cols, dtype=np.int64)
        self._dict = np.asarray(dict_vals)
        self._offsets = [np.asarray(o, dtype=np.int32) for o in offset_lists]
        self._n = n_rows
        # rows in no offset list take the default entry (all-zeros tuple)
        self._default = default_idx

    @staticmethod
    def from_codes(cols, dict_vals, codes, default_idx=None) -> "ColGroupOLE":
        lists = [np.flatnonzero(codes == v)
                 for v in range(dict_vals.shape[0])]
        if default_idx is not None:
            lists[default_idx] = np.empty(0, dtype=np.int64)
        return ColGroupOLE(cols, dict_vals, lists, len(codes), default_idx)

    def num_rows(self) -> int:
        return self._n

    def codes(self) -> np.ndarray:
        c = np.full(self._n, self._default if self._default is not None else 0,
                    dtype=np.int32)
        for v, off in enumerate(self._offsets):
            c[off] = v
        return c

    def dictionary(self) -> np.ndarray:
        return self._dict

    def value_map(self, fn) -> "ColGroupOLE":
        return ColGroupOLE(self.cols, fn(self._dict), self._offsets,
                           self._n, self._default)

    def value_counts(self) -> np.ndarray:
        counts = np.array([len(o) for o in self._offsets], dtype=np.int64)
        if self._default is not None:
            counts[self._default] = self._n - counts.sum()
        return counts

    def compressed_bytes(self) -> int:
        return self._dict.nbytes + sum(o.nbytes for o in self._offsets)


class ColGroupRLE(ColGroup):
    """reference: ColGroupRLE.java — per-value [start,len] runs."""

    def __init__(self, cols, dict_vals: np.ndarray,
                 starts: np.ndarray, lengths: np.ndarray,
                 run_values: np.ndarray, n_rows: int):
        self.cols = np.asarray(cols, dtype=np.int64)
        self._dict = np.asarray(dict_vals)
        self._starts = np.asarray(starts, dtype=np.int64)
        self._lens = np.asarray(lengths, dtype=np.int64)
        self._run_vals = np.asarray(run_values, dtype=np.int32)
        self._n = n_rows

    @staticmethod
    def from_codes(cols, dict_vals, codes) -> "ColGroupRLE":
        n = len(codes)
        if n == 0:
            return ColGroupRLE(cols, dict_vals, [], [], [], 0)
        change = np.flatnonzero(np.diff(codes)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [n]])
        return ColGroupRLE(cols, dict_vals, starts, ends - starts,
                           codes[starts], n)

    def num_rows(self) -> int:
        return self._n

    def codes(self) -> np.ndarray:
        return np.repeat(self._run_vals, self._lens).astype(np.int32)

    def dictionary(self) -> np.ndarray:
        return self._dict

    def value_map(self, fn) -> "ColGroupRLE":
        return ColGroupRLE(self.cols, fn(self._dict), self._starts,
                           self._lens, self._run_vals, self._n)

    def value_counts(self) -> np.ndarray:
        counts = np.zeros(self._dict.shape[0], dtype=np.int64)
        np.add.at(counts, self._run_vals, self._lens)
        return counts

    def num_runs(self) -> int:
        return len(self._starts)

    def compressed_bytes(self) -> int:
        return self._dict.nbytes + self._starts.nbytes + \
            self._lens.nbytes + self._run_vals.nbytes


class ColGroupUncompressed(ColGroup):
    """Dense fallback (reference: ColGroupUncompressed.java)."""

    def __init__(self, cols, values: np.ndarray):
        self.cols = np.asarray(cols, dtype=np.int64)
        self._vals = np.asarray(values)  # (n, num_cols)

    def num_rows(self) -> int:
        return self._vals.shape[0]

    def decompress_into(self, out: np.ndarray):
        out[:, self.cols] = self._vals

    def right_mult(self, w: np.ndarray) -> np.ndarray:
        return self._vals @ w[self.cols, :]

    def left_mult(self, yt: np.ndarray) -> np.ndarray:
        return yt @ self._vals

    def col_sums(self) -> np.ndarray:
        return self._vals.sum(axis=0)

    def col_minmax(self, which: str) -> np.ndarray:
        return self._vals.min(axis=0) if which == "min" \
            else self._vals.max(axis=0)

    def value_map(self, fn) -> "ColGroupUncompressed":
        return ColGroupUncompressed(self.cols, fn(self._vals))

    def values(self) -> np.ndarray:
        return self._vals

    def compressed_bytes(self) -> int:
        return self._vals.nbytes
