# Copy of systemml_tpu/runtime/transform.py for the PyTorch port,
# with its imports pointed at systemml_tpu_torch.
"""Feature transform encode/apply/decode on frames.

TPU-native equivalent of the reference's runtime/transform package
(encode/Encoder*.java via EncoderFactory.createEncoder
runtime/transform/encode/EncoderFactory.java:39, decode/Decoder*.java,
meta/TfMetaUtils.java). The JSON spec surface is the same: "recode",
"dummycode", "bin" ({"id","method","numbins"}), "impute"
({"id","method","value"}), "omit", with either column ids or names
("ids": false). Any dummycode column is implicitly recoded first, exactly
as the factory does (EncoderFactory.java:59).

Encoding runs host-side on numpy columns (it is inherently string/
dictionary work), producing a dense fp matrix that then enters the XLA
data path; recode maps live in a meta FrameBlock whose cells use the
reference's "token{sep}code" serialization (TfUtils constructRecodeMapEntry)
so metadata round-trips through frame IO.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from systemml_tpu_torch.lang.ast import ValueType
from systemml_tpu_torch.runtime.data import FrameObject

SEP = "·"  # Lop.DATATYPE_PREFIX, the reference's recode-map separator


class TransformError(ValueError):
    pass


def _col_ids(spec: dict, key: str, colnames: Sequence[str]) -> List[int]:
    """Resolve a spec id list (ints or names) to 1-based column ids."""
    raw = spec.get(key, [])
    out = []
    for v in raw:
        if isinstance(v, dict):  # {"id": k} / {"name": s} entries
            v = v.get("id", v.get("name"))
        if isinstance(v, str):
            if v not in colnames:
                raise TransformError(f"unknown column name {v!r} in spec[{key}]")
            out.append(list(colnames).index(v) + 1)
        else:
            out.append(int(v))
    return out


def _obj_list(spec: dict, key: str, colnames: Sequence[str]) -> List[dict]:
    """Resolve a spec list of objects, normalizing 'id' to 1-based int."""
    out = []
    for o in spec.get(key, []):
        o = dict(o)
        v = o.get("id", o.get("name"))
        if isinstance(v, str):
            if v not in colnames:
                raise TransformError(f"unknown column name {v!r} in spec[{key}]")
            v = list(colnames).index(v) + 1
        o["id"] = int(v)
        out.append(o)
    return out


def _is_missing(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind in "fc":
        return np.isnan(col.astype(float))
    s = col.astype(str)
    return (s == "") | (s == "nan") | (s == "NA")


def _numeric(col: np.ndarray) -> np.ndarray:
    try:
        return col.astype(float)
    except (ValueError, TypeError):
        out = np.full(len(col), np.nan)
        for i, v in enumerate(col):
            try:
                out[i] = float(v)
            except (ValueError, TypeError):
                pass
        return out


class TransformSpec:
    """Parsed transform specification bound to a frame's column names."""

    def __init__(self, spec: str | dict, colnames: Sequence[str]):
        if isinstance(spec, str):
            spec = json.loads(spec)
        self.spec = spec
        self.colnames = list(colnames)
        self.dummycode = _col_ids(spec, "dummycode", colnames)
        # dummycode requires recode (EncoderFactory.java:59)
        self.recode = sorted(set(_col_ids(spec, "recode", colnames))
                             | set(self.dummycode))
        self.bin = _obj_list(spec, "bin", colnames)
        self.bin_ids = [o["id"] for o in self.bin]
        self.impute = _obj_list(spec, "impute", colnames)
        self.omit = _col_ids(spec, "omit", colnames)
        overlap = set(self.recode) & set(self.bin_ids)
        if overlap:
            raise TransformError(f"columns {sorted(overlap)} both recoded and binned")


class TransformEncoder:
    """Composite encoder: omit -> impute -> recode/bin -> dummycode
    (reference: EncoderComposite over EncoderOmit/MVImpute/Recode/Bin/
    Dummycode/PassThrough)."""

    def __init__(self, spec: str | dict, colnames: Sequence[str]):
        self.ts = TransformSpec(spec, colnames)
        self.rcmaps: Dict[int, Dict[str, int]] = {}     # col id -> token->code
        self.bins: Dict[int, np.ndarray] = {}           # col id -> bin edges
        self.imputes: Dict[int, float | str] = {}       # col id -> fill value

    # ---- fit + encode ----------------------------------------------------

    def encode(self, frame: FrameObject) -> Tuple[np.ndarray, FrameObject]:
        """Fit on `frame` and encode it. Returns (matrix, meta_frame)."""
        cols = [np.asarray(c) for c in frame.columns]
        ts = self.ts
        # 1. omit rows with missing values in omit columns
        if ts.omit:
            keep = np.ones(len(cols[0]), dtype=bool)
            for cid in ts.omit:
                keep &= ~_is_missing(cols[cid - 1])
            cols = [c[keep] for c in cols]
        # 2. impute
        for o in ts.impute:
            cid, method = o["id"], o.get("method", "global_mean")
            col = cols[cid - 1]
            miss = _is_missing(col)
            if method == "constant":
                fill = o.get("value", 0)
            elif method == "global_mode":
                vals, counts = np.unique(col[~miss].astype(str), return_counts=True)
                fill = vals[np.argmax(counts)] if len(vals) else ""
            else:  # global_mean
                num = _numeric(col)
                fill = float(np.nanmean(np.where(miss, np.nan, num)))
            self.imputes[cid] = fill
            if miss.any():
                col = col.copy().astype(object) if col.dtype.kind not in "fc" else col.copy()
                col[miss] = fill
                cols[cid - 1] = np.asarray(col)
        # 3. fit recode dictionaries (sorted distinct tokens -> 1-based codes)
        for cid in ts.recode:
            tokens = np.unique(cols[cid - 1].astype(str))
            self.rcmaps[cid] = {t: i + 1 for i, t in enumerate(tokens)}
        # 4. fit bins (equi-width over observed range)
        for o in ts.bin:
            cid = o["id"]
            nbins = int(o.get("numbins", 10))
            num = _numeric(cols[cid - 1])
            lo, hi = np.nanmin(num), np.nanmax(num)
            self.bins[cid] = np.linspace(lo, hi, nbins + 1)
        return self._apply(cols), self.meta_frame()

    # ---- apply with fitted/loaded metadata -------------------------------

    def apply(self, frame: FrameObject) -> np.ndarray:
        cols = [np.asarray(c) for c in frame.columns]
        ts = self.ts
        if ts.omit:
            keep = np.ones(len(cols[0]), dtype=bool)
            for cid in ts.omit:
                keep &= ~_is_missing(cols[cid - 1])
            cols = [c[keep] for c in cols]
        for cid, fill in self.imputes.items():
            col = cols[cid - 1]
            miss = _is_missing(col)
            if miss.any():
                col = col.copy().astype(object) if col.dtype.kind not in "fc" else col.copy()
                col[miss] = fill
                cols[cid - 1] = np.asarray(col)
        return self._apply(cols)

    def _apply(self, cols: List[np.ndarray]) -> np.ndarray:
        ts = self.ts
        ncol = len(cols)
        nrow = len(cols[0]) if cols else 0
        out_cols: List[np.ndarray] = []
        for cid in range(1, ncol + 1):
            col = cols[cid - 1]
            if cid in self.rcmaps:
                rc = self.rcmaps[cid]
                codes = np.array([rc.get(str(v), np.nan) for v in col.astype(str)],
                                 dtype=float)
                if cid in ts.dummycode:
                    k = len(rc)
                    dc = np.zeros((nrow, k))
                    valid = ~np.isnan(codes)
                    dc[np.nonzero(valid)[0], codes[valid].astype(int) - 1] = 1.0
                    out_cols.extend(dc.T)
                else:
                    out_cols.append(codes)
            elif cid in self.bins:
                edges = self.bins[cid]
                num = _numeric(col)
                # bin id = max(1, ceil((v-min)/width)) as in the reference's
                # EncoderBin -> right-closed bins via digitize(right=True)
                codes = np.digitize(num, edges[1:-1], right=True) + 1.0
                out_cols.append(codes)
            else:  # pass-through
                out_cols.append(_numeric(col))
        return np.column_stack(out_cols) if out_cols else np.zeros((nrow, 0))

    # ---- metadata (meta frame) -------------------------------------------

    def meta_frame(self) -> FrameObject:
        """Serialize fitted maps as a FrameBlock: recode columns hold
        'token{SEP}code' rows, bin columns hold 'lower{SEP}upper' rows,
        impute columns carry the fill value in row 1 when no map exists."""
        ncol = len(self.ts.colnames)
        nrows = max([len(m) for m in self.rcmaps.values()]
                    + [len(e) - 1 for e in self.bins.values()] + [1])
        columns = []
        for cid in range(1, ncol + 1):
            col = np.full(nrows, "", dtype=object)
            if cid in self.rcmaps:
                for i, (tok, code) in enumerate(sorted(self.rcmaps[cid].items(),
                                                       key=lambda kv: kv[1])):
                    col[i] = f"{tok}{SEP}{code}"
            elif cid in self.bins:
                e = self.bins[cid]
                for i in range(len(e) - 1):
                    col[i] = f"{e[i]}{SEP}{e[i + 1]}"
            elif cid in self.imputes:
                col[0] = str(self.imputes[cid])
            columns.append(col)
        return FrameObject(columns, [ValueType.STRING] * ncol,
                           list(self.ts.colnames))

    def load_meta(self, meta: FrameObject):
        """Inverse of meta_frame (reference: Encoder.initMetaData via
        TfMetaUtils.readTransformMetaDataFromFrame)."""
        ts = self.ts
        for cid in range(1, len(ts.colnames) + 1):
            col = np.asarray(meta.columns[cid - 1]).astype(str)
            entries = [v for v in col if v not in ("", "nan")]
            if cid in ts.recode:
                rc = {}
                for v in entries:
                    tok, code = v.rsplit(SEP, 1)
                    rc[tok] = int(float(code))
                self.rcmaps[cid] = rc
            elif cid in ts.bin_ids:
                lows = [float(v.split(SEP)[0]) for v in entries]
                highs = [float(v.split(SEP)[1]) for v in entries]
                self.bins[cid] = np.array(lows + [highs[-1]])
            elif entries and cid in [o["id"] for o in ts.impute]:
                try:
                    self.imputes[cid] = float(entries[0])
                except ValueError:
                    self.imputes[cid] = entries[0]

    # ---- column mapping (reference: TRANSFORMCOLMAP) ---------------------

    def colmap(self) -> np.ndarray:
        """(ncol, 3) matrix [input col id, out start, out end] (1-based)."""
        ts = self.ts
        rows = []
        pos = 1
        for cid in range(1, len(ts.colnames) + 1):
            width = len(self.rcmaps.get(cid, {})) if cid in ts.dummycode else 1
            rows.append([cid, pos, pos + width - 1])
            pos += width
        return np.array(rows, dtype=float)


class TransformDecoder:
    """Inverts dummycode -> recode -> pass-through (reference:
    decode/DecoderFactory.java: DecoderDummycode/DecoderRecode/
    DecoderPassThrough composite)."""

    def __init__(self, spec: str | dict, colnames: Sequence[str],
                 meta: FrameObject):
        self.enc = TransformEncoder(spec, colnames)
        self.enc.load_meta(meta)

    def decode(self, X: np.ndarray) -> FrameObject:
        ts = self.enc.ts
        X = np.asarray(X)
        cols: List[np.ndarray] = []
        schema: List[ValueType] = []
        pos = 0
        for cid in range(1, len(ts.colnames) + 1):
            if cid in ts.dummycode:
                k = len(self.enc.rcmaps[cid])
                block = X[:, pos:pos + k]
                codes = np.argmax(block, axis=1) + 1
                pos += k
            elif cid in self.enc.rcmaps:
                codes = X[:, pos].astype(int)
                pos += 1
            else:
                cols.append(X[:, pos].copy())
                schema.append(ValueType.DOUBLE)
                pos += 1
                continue
            inv = {code: tok for tok, code in self.enc.rcmaps[cid].items()}
            cols.append(np.array([inv.get(int(c), "") for c in codes], dtype=object))
            schema.append(ValueType.STRING)
        return FrameObject(cols, schema, list(ts.colnames))
