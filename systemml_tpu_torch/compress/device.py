"""Device-side compressed linear algebra.

Port of systemml_tpu/compress/device.py. A compressed block's device
mirror keeps each group's codes as a narrow (uint8/uint16) tensor and its
dictionary on the device, built once per block and cached on it. The ops:

- right mult  X @ W  = gather(dict @ W[cols], codes), summed over groups;
- left mult  Y^T @ X = segment sums of Y^T's rows by code times the
  dictionary, the sums in a fixed order over the rows sorted by code
  (sorted once with the mirror, the coded groups sharing streams:
  `Segments`), with no float atomic, no host read, and O(n + d) bytes a
  group;
- tsmm  t(X) @ X from per-group code counts and joint code histograms;
- mmchain  t(X) %*% (w? * (X %*% v) -? y): kernel K6 (csrc/cla_chain.cu;
  v's columns 8 a launch) when the block is all coded with at most 8
  dictionary rows per group and the operands lie on the card, else the
  right mult feeding the left mult (the JAX package's gather_segment arm).
  K6 streams the codes into shared memory asynchronously, sums xv in fp32
  and adds z into exact int32 histograms, scaled per tile, that it flushes
  to fp64: repeats are bit-identical.

The JAX package leaves the first three to XLA (its left mult is
`jax.ops.segment_sum`); here they are torch ops (gather, `index_select`,
`sum`, `torch.matmul`). The left mult and the gather arm are bit-identical
run to run and read nothing on the host, so a loop region captures them;
tsmm counts codes with `bincount` (a host read: a region refuses it).

Each op is a family of the kernel backend (codegen/backend.py), as in
the JAX package: cla_right, cla_left and cla_tsmm choose between the
coded arm and decompress_dense, cla_mmchain between K6 ("tpu_chain") and
the gather arm, by the JAX package's analytic costs (`_cla_cost_*`) read
against hops/cost.HwProfile of the configured device, or by measurement
when tuning is on. A choice is made once per kernel key (op, device,
dtype, power-of-two shape bucket, group layout) and process, and counted
then in the stats as kb_pick_<family>.<arm>, under the JAX package's
names. A compressed
mmchain that K6 cannot take by its layout or shape (an uncompressed
group, a dictionary of more than 8 rows, or a block's table, codes and
histograms past the kernel's shared memory, chain_smem_bytes) counts
cla_chain_plain_by_layout and takes the gather arm, decided before any
launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from systemml_tpu_torch.codegen import backend as kbackend
from systemml_tpu_torch.codegen import counts
from systemml_tpu_torch.compress.block import CompressedMatrixBlock
from systemml_tpu_torch.compress.colgroup import ColGroupUncompressed
from systemml_tpu_torch.utils import stats as stats_mod
from systemml_tpu_torch.utils.config import get_config


# positions a chunk of a code-sorted stream holds, and the most rows a
# stream takes from its groups (Segments; a group alone may pass it)
SEGMENT_CHUNK = 1024
SEGMENT_STREAM = 1 << 25


def _row_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along dimension 1 of a 2-D x, in fp64 and a
    fixed order: torch scans two rows or more a row per block; a single
    row would take CUB's device-wide scan, whose float sums depend on
    timing, so it is scanned beside a row of zeros."""
    if x.shape[0] > 1:
        return torch.cumsum(x, 1, dtype=torch.float64)
    return torch.cumsum(torch.cat([x, torch.zeros_like(x)]), 1,
                        dtype=torch.float64)[:1]


class Segments:
    """Coded groups' rows sorted by code once, for segment sums in a fixed
    order, with no float atomic and no host read, in O(n + d) bytes a
    group. The groups share one stream (their codes told apart by offsets
    in the order of `ds`), so that a call is a dozen launches whatever
    their number.

    The stream: chunk 0 all padding, each group's rows in code order from
    position B = SEGMENT_CHUNK, padding to C chunks; `order` (C * B,)
    holds each position's row, padding as n (the caller's zero column).
    A call prefixes each chunk in fp64 (P; a chunk may cross codes and
    groups), then the chunk totals T (Q). Code j at positions [s, e) sums
    to P[e-1] - P[s-1] when one chunk holds it, and otherwise adds T[cs]
    + Q[ce-1] - Q[cs], its first chunk's total and those of the chunks
    between, s in chunk cs and e-1 in ce. `pos` holds e-1 and s-1 (or 0,
    a zero of chunk 0, where s starts a chunk), `tq` cs and the two Q
    positions (past C), all pointing at zeros for a code one chunk holds,
    so that its fix-up is exactly 0; an empty code reads zeros only.
    Where the 2d windows of B positions that end at `pos` take at most a
    quarter of the stream (few codes), P is read at `pos` only: T sums
    each chunk (in yt's dtype) and each window sums its rows in fp64
    (`win`, padding past pos), and no prefix of the whole stream is
    written. 4 (rows + 2B) + 20 d
    bytes, and the windows' 8 d B when they are taken, built with a sort
    a group and two searches on the codes' device."""

    def __init__(self, codes: List[torch.Tensor], ds: List[int]):
        n, dev = codes[0].shape[0], codes[0].device
        b = SEGMENT_CHUNK
        self.ds = [int(d) for d in ds]
        d = sum(self.ds)
        rows = n * len(codes)
        self.chunks = max(2, 1 + -(-rows // b))
        self.order = torch.full((self.chunks * b,), n, dtype=torch.int32,
                                device=dev)
        keys, at, off = [], b, 0
        for c, dg in zip(codes, self.ds):
            k, o = torch.sort(c.to(torch.int64), stable=True)
            keys.append(k + off)
            self.order[at:at + n] = o.to(torch.int32)
            at += n
            off += dg
        keys = torch.cat(keys)
        j = torch.arange(d, device=dev)
        s = torch.searchsorted(keys, j) + b
        e = torch.searchsorted(keys, j, right=True) + b
        del keys
        cs, ce = s // b, (e - 1) // b
        zero = torch.zeros_like(j)
        present = e > s
        multi = present & (ce != cs)
        q0 = zero + self.chunks
        self.pos = torch.cat([
            torch.where(present, e - 1, zero),
            torch.where(present & (s % b != 0), s - 1, zero)]).to(torch.int32)
        self.tq = torch.cat([
            torch.where(multi, cs, zero),
            torch.where(multi, ce - 1 + self.chunks, q0),
            torch.where(multi, cs + self.chunks, q0)]).to(torch.int32)
        self.win = None
        if 8 * d * b <= rows:
            at = torch.arange(b, device=dev)
            pos = self.pos.to(torch.int64)[:, None]
            self.win = torch.where(
                at <= pos % b, self.order[pos - pos % b + at],
                torch.full_like(self.order[:1], n)).reshape(-1)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.order, self.pos, self.tq, self.win)
                   if t is not None)

    def sums(self, yt_ext: torch.Tensor) -> torch.Tensor:
        """(k, sum of ds) in float64: each row of yt summed by code, the
        groups' codes one after another; yt_ext is yt (k, n) with a zero
        column appended."""
        k, c, b = yt_ext.shape[0], self.chunks, SEGMENT_CHUNK
        d = self.pos.shape[0] // 2
        v = yt_ext.index_select(1, self.order).reshape(k * c, b)
        if self.win is None:
            p = torch.cumsum(v, 1, dtype=torch.float64).reshape(k, c * b)
            t = p[:, b - 1::b]
            pe = p.index_select(1, self.pos)
        else:
            # a chunk sums in yt's dtype: a cast first would write the
            # stream again in fp64
            t = v.sum(1).to(torch.float64).reshape(k, c)
            pe = yt_ext.index_select(1, self.win).reshape(k, 2 * d, b).sum(
                2, dtype=torch.float64)
        tq = torch.cat([t, _row_scan(t)], 1).index_select(1, self.tq)
        return (pe[:, :d] - pe[:, d:]) + (tq[:, :d] + (tq[:, d:2 * d]
                                                        - tq[:, 2 * d:]))


class DeviceGroup:
    """One column group on the device: coded (dict + codes) or dense
    values."""

    def __init__(self, cols: np.ndarray, device, dict_dev=None,
                 codes=None, vals_dev=None):
        self.cols = np.asarray(cols, dtype=np.int64)
        self.cols_dev = torch.from_numpy(self.cols).to(device)
        self.dict = dict_dev      # (d, g) or None
        self.vals = vals_dev      # (n, g) dense fallback or None
        self.codes = None
        if codes is not None:     # the narrow uint width is kept
            self.codes = torch.from_numpy(np.ascontiguousarray(codes)).to(
                device)           # (n,)

    @property
    def coded(self) -> bool:
        return self.dict is not None

    def index(self) -> torch.Tensor:
        """The codes widened to int32, the index type of torch's gather
        and scatter ops (a temporary of the call)."""
        return self.codes.to(torch.int32)


class DeviceCompressed:
    """Device mirror of a CompressedMatrixBlock: its groups, and the coded
    ones' segment streams (Segments, each with its groups in order),
    consecutive coded groups sharing one up to SEGMENT_STREAM rows."""

    def __init__(self, groups: List[DeviceGroup], shape: Tuple[int, int]):
        self.groups = groups
        self.shape = shape
        self.streams: List[Tuple[Segments, List[DeviceGroup]]] = []
        batch: List[DeviceGroup] = []
        for g in [g for g in groups if g.coded] + [None]:
            if batch and (g is None or (len(batch) + 1) * shape[0]
                          > SEGMENT_STREAM):
                self.streams.append((Segments(
                    [x.codes for x in batch],
                    [x.dict.shape[0] for x in batch]), batch))
                batch = []
            if g is not None:
                batch.append(g)


def device_mirror(c: CompressedMatrixBlock) -> DeviceCompressed:
    """Build (and cache) the device tensors of a compressed block, on the
    configured device."""
    cached = getattr(c, "_device_mirror", None)
    if cached is not None:
        return cached
    dev = torch.device(get_config().device)
    groups = []
    for g in c.groups:
        if isinstance(g, ColGroupUncompressed):
            groups.append(DeviceGroup(
                g.cols, dev,
                vals_dev=torch.from_numpy(np.ascontiguousarray(
                    g.values())).to(dev)))
        else:
            groups.append(DeviceGroup(
                g.cols, dev,
                dict_dev=torch.from_numpy(np.ascontiguousarray(
                    g.dictionary())).to(dev),
                codes=g.codes()))
    dc = DeviceCompressed(groups, c.shape)
    c._device_mirror = dc
    return dc


def _mm(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _right(dc: DeviceCompressed, w):
    """X @ W from the per-group tensors, summed in group order."""
    out = None
    for g in dc.groups:
        wg = w.index_select(0, g.cols_dev)
        if g.coded:
            part = _mm(g.dict, wg).index_select(0, g.index())
        else:
            part = _mm(g.vals, wg)
        out = part if out is None else out + part
    return out


def _left(dc: DeviceCompressed, yt):
    """Y^T @ X -> (k, m); yt is (k, n). Each coded group's part is its
    segment sums (its stream's Segments, a fixed order) times its
    dictionary."""
    out = torch.zeros((yt.shape[0], dc.shape[1]), dtype=yt.dtype,
                      device=yt.device)
    for g in dc.groups:
        if not g.coded:
            out.index_copy_(1, g.cols_dev, _mm(yt, g.vals).to(out.dtype))
    if dc.streams:
        ext = torch.cat([yt, torch.zeros((yt.shape[0], 1), dtype=yt.dtype,
                                         device=yt.device)], 1)
    for seg, batch in dc.streams:
        sums = seg.sums(ext).to(yt.dtype)
        at = 0
        for g, d in zip(batch, seg.ds):
            part = _mm(sums[:, at:at + d], g.dict)
            out.index_copy_(1, g.cols_dev, part.to(out.dtype))
            at += d
    return out


def _tsmm_pair(gi: DeviceGroup, gj: DeviceGroup, dtype):
    if gi.coded and gj.coded:
        di, dj = gi.dict.to(dtype), gj.dict.to(dtype)
        if gi is gj:
            cnt = torch.bincount(gi.index(), minlength=di.shape[0]).to(dtype)
            return torch.matmul(di.T, cnt[:, None] * di)
        joint = torch.bincount(
            gi.codes.long() * dj.shape[0] + gj.codes.long(),
            minlength=di.shape[0] * dj.shape[0]).reshape(
                di.shape[0], dj.shape[0]).to(dtype)
        return torch.matmul(torch.matmul(di.T, joint), dj)
    vi = gi.vals if not gi.coded else gi.dict.index_select(0, gi.index())
    vj = gj.vals if not gj.coded else gj.dict.index_select(0, gj.index())
    return torch.matmul(vi.to(dtype).T, vj.to(dtype))


def _tsmm(dc: DeviceCompressed):
    m = dc.shape[1]
    first = dc.groups[0] if dc.groups else None
    dtype = (torch.float32 if first is None
             else (first.dict if first.coded else first.vals).dtype)
    dev = torch.device(get_config().device) if first is None \
        else first.cols_dev.device
    out = torch.zeros((m, m), dtype=dtype, device=dev)
    for i, gi in enumerate(dc.groups):
        for gj in dc.groups[i:]:
            blk = _tsmm_pair(gi, gj, dtype)
            out[gi.cols_dev[:, None], gj.cols_dev[None, :]] = blk
            if gj is not gi:
                out[gj.cols_dev[:, None], gi.cols_dev[None, :]] = blk.T
    return out


# --------------------------------------------------------------------------
# the kernel backend's four compressed families (the JAX package's
# device.py:197-450) with its analytic costs (:155-195, :385-394)
# --------------------------------------------------------------------------


def _host_meta(c: CompressedMatrixBlock):
    """(layout signature, code bytes, K6 shape) of a block, from its
    HOST-side group metadata only, computed once and cached on it (a
    block's groups do not change): the per-group kind and columns (as a
    string, whose hash Python keeps: the choice's key hashes it per
    call), the bytes a coded op streams, and (dmax, groups) when every
    group is coded (else None, the JAX package's _tpu_chain_layout
    refusal)."""
    meta = getattr(c, "_cla_host_meta", None)
    if meta is None:
        n = c.shape[0]
        code_bytes = 0.0
        sig = []
        for g in c.groups:
            if isinstance(g, ColGroupUncompressed):
                sig.append(("dense", tuple(int(x) for x in g.cols)))
                code_bytes += float(g.values().nbytes)
            else:
                d = int(g.dictionary().shape[0])
                width = 1 if d <= 256 else (2 if d <= 65536 else 4)
                sig.append(("coded", tuple(int(x) for x in g.cols)))
                code_bytes += float(width * n)
        coded = [g for g in c.groups
                 if not isinstance(g, ColGroupUncompressed)]
        shape = (None if not coded or len(coded) != len(c.groups) else
                 (max(int(g.dictionary().shape[0]) for g in coded),
                  len(coded)))
        meta = c._cla_host_meta = (repr(tuple(sig)), code_bytes, shape)
    return meta


def _cla_ctx(c: CompressedMatrixBlock, k: int) -> dict:
    """Key/cost context from HOST-side group metadata only: building the
    device mirror here would upload every code array even when selection
    picks decompress_dense (which never reads it)."""
    n, m = c.shape
    sig, code_bytes, _ = _host_meta(c)
    return {"c": c, "rows": n, "cols": m, "k": k,
            "groups": len(c.groups), "code_bytes": code_bytes,
            "layout_sig": sig, "shape": (n, m, k)}


def _cla_cost_coded(ctx) -> float:
    from systemml_tpu_torch.hops.cost import (QUATERNARY_GATHER_OVERHEAD,
                                              HwProfile)

    hw = HwProfile.detect()
    gather_flops = QUATERNARY_GATHER_OVERHEAD * ctx["rows"] \
        * ctx["groups"] * max(ctx["k"], 1)
    return (ctx["code_bytes"] / hw.hbm_bw
            + gather_flops / hw.peak_flops_f32 + hw.dispatch_us * 1e-6)


def _cla_cost_dense(ctx) -> float:
    from systemml_tpu_torch.hops.cost import HwProfile

    hw = HwProfile.detect()
    cells = float(ctx["rows"]) * ctx["cols"]
    host_decompress = cells * 8.0 / 1e9   # numpy scatter, ~1 GB/s
    return (host_decompress + cells * hw.bytes_per_cell / hw.hbm_bw
            + 2.0 * cells * max(ctx["k"], 1) / hw.peak_flops_f32)


def _cla_cost_tpu_chain(ctx) -> float:
    """The JAX package's cost of its chain kernel: code bytes stream once,
    compare/dot work scales rows * groups * dmax (kept for the choice;
    K6 looks each row's entry up instead)."""
    from systemml_tpu_torch.hops.cost import HwProfile

    hw = HwProfile.detect()
    vpu_flops = 2.0 * ctx["rows"] * ctx["groups"] * CHAIN_MAX_DICT \
        * max(ctx["k"], 1)
    return (ctx["code_bytes"] / hw.hbm_bw
            + vpu_flops / hw.peak_flops_f32 + hw.dispatch_us * 1e-6)


def _cla_chain_kernel_ok(ctx) -> bool:
    """The JAX package's gate of its chain kernel (tpu_chain_supported:
    on the accelerator, every group coded, at most CHAIN_MAX_DICT
    dictionary rows), which pallas_mode "never" also closes here; K6
    takes the call when chain_supported accepts it."""
    shape = _host_meta(ctx["c"])[2]
    return (ctx["backend"] == "cuda" and get_config().pallas_mode != "never"
            and shape is not None and shape[0] <= CHAIN_MAX_DICT)


def _cla_chain_accepts(ctx, c, v, w, ctype) -> bool:
    return chain_supported(c, ctx["k"], v.dtype)


def _dense_of(c: CompressedMatrixBlock, like):
    return torch.as_tensor(c.decompress(), dtype=like.dtype,
                           device=like.device)


def _dispatch(op: str, args: tuple, ctx: dict, dtype, backend: str,
              extra=()):
    """Dispatch a compressed family (key: its shape bucket, its group
    layout's digest, `extra` static config)."""
    return kbackend.dispatch(
        op, args, shape=ctx["shape"], dtype=dtype,
        config=(("layout", kbackend.plan_digest(ctx["layout_sig"])),)
        + tuple(extra), ctx=ctx, backend=backend)


_cla_right_fam = kbackend.family("cla_right")


@_cla_right_fam.variant("coded", cost=_cla_cost_coded,
                        fallback="decompress_dense")
def _cla_right_coded(ctx, c, w):
    return _right(device_mirror(c), w)


@_cla_right_fam.variant("decompress_dense", cost=_cla_cost_dense,
                        is_fallback=True)
def _cla_right_dense(ctx, c, w):
    return torch.matmul(_dense_of(c, w), w)


def right_mult(c: CompressedMatrixBlock, w):
    """X @ W -> dense (n, k) on the device."""
    if w.ndim == 1:
        w = w.reshape(-1, 1)
    return _dispatch("cla_right", (c, w), _cla_ctx(c, int(w.shape[1])),
                     w.dtype, w.device.type)


_cla_left_fam = kbackend.family("cla_left")


@_cla_left_fam.variant("coded", cost=_cla_cost_coded,
                       fallback="decompress_dense")
def _cla_left_coded(ctx, c, yt):
    return _left(device_mirror(c), yt)


@_cla_left_fam.variant("decompress_dense", cost=_cla_cost_dense,
                       is_fallback=True)
def _cla_left_dense(ctx, c, yt):
    return torch.matmul(yt, _dense_of(c, yt))


def left_mult(c: CompressedMatrixBlock, yt):
    """Y^T @ X -> dense (k, m) on the device. yt is (k, n)."""
    if yt.ndim == 1:
        yt = yt.reshape(1, -1)
    return _dispatch("cla_left", (c, yt), _cla_ctx(c, int(yt.shape[0])),
                     yt.dtype, yt.device.type)


_cla_tsmm_fam = kbackend.family("cla_tsmm")


@_cla_tsmm_fam.variant("coded", cost=_cla_cost_coded,
                       fallback="decompress_dense")
def _cla_tsmm_coded(ctx, c):
    return _tsmm(device_mirror(c))


@_cla_tsmm_fam.variant("decompress_dense", cost=_cla_cost_dense,
                       is_fallback=True)
def _cla_tsmm_dense(ctx, c):
    x = c.to_dense()
    return torch.matmul(x.T, x)


def tsmm(c: CompressedMatrixBlock):
    """t(X) @ X via code counts and joint code histograms."""
    from systemml_tpu_torch.compress.block import _host_op

    _host_op("tsmm")      # bincount reads the largest code
    return _dispatch("cla_tsmm", (c,), _cla_ctx(c, c.shape[1]), "f32",
                     torch.device(get_config().device).type)


def gather_mmchain(c: CompressedMatrixBlock, v, w, ctype: str):
    """The gather arm: the right mult feeding the left mult."""
    dc = device_mirror(c)
    n, m = dc.shape
    xv = _right(dc, v.reshape(m, -1))
    if ctype == "XtwXv":
        xv = w.reshape(n, -1) * xv
    elif ctype == "XtXvy":
        xv = xv - w.reshape(n, -1)
    return _left(dc, xv.T).T


_cla_chain_fam = kbackend.family("cla_mmchain")


@_cla_chain_fam.variant("tpu_chain", cost=_cla_cost_tpu_chain,
                        supported=_cla_chain_kernel_ok,
                        accepts=_cla_chain_accepts,
                        fallback="gather_segment")
def _cla_chain_kernel(ctx, c, v, w, ctype):
    return chain_mmchain(c, v, w, ctype)


@_cla_chain_fam.variant("gather_segment", cost=_cla_cost_coded,
                        is_fallback=True)
def _cla_chain_gather(ctx, c, v, w, ctype):
    if not chain_supported(c, ctx["k"], v.dtype):
        _count("cla_chain_plain_by_layout")
    return gather_mmchain(c, v, w, ctype)


def mmchain(c: CompressedMatrixBlock, v, w=None, ctype: str = "XtXv"):
    """t(X) %*% (w? * (X %*% v) -? y) with X compressed; X's dense form
    never exists. Family `cla_mmchain`: K6 ("tpu_chain", chain_mmchain)
    or the gather arm; a call whose block layout or shape K6 refuses
    (chain_supported) takes the gather arm and counts
    cla_chain_plain_by_layout, decided before any launch."""
    if ctype not in CHAIN_CTYPES:
        raise ValueError(f"unknown mmchain ctype {ctype!r}")
    if ctype != "XtXv" and w is None:
        raise ValueError(f"mmchain {ctype} needs w/y")
    k = int(v.shape[1]) if v.ndim == 2 else 1
    return _dispatch("cla_mmchain", (c, v, w, ctype), _cla_ctx(c, k), "f32",
                     v.device.type, (("ctype", ctype),))


def _count(kind: str) -> None:
    st = stats_mod.current()
    if st is not None:
        st.count_estim(kind)


# --------------------------------------------------------------------------
# K6: the compressed chain kernel (csrc/cla_chain.cu; replaces
# systemml_tpu/compress/device.py:525 _chain_kernel_call)
# --------------------------------------------------------------------------

CHAIN_CTYPES = {"XtXv": 0, "XtwXv": 1, "XtXvy": 2}
CHAIN_DTYPES = {torch.float32: 0, torch.float64: 1}
# what the kernel takes (csrc/cla_chain.cu): at most 8 dictionary rows per
# group (the JAX package's _TPU_CHAIN_DMAX), at most 8 columns of v a launch
# (chain_mmchain runs a wider v in chunks of 8), and a block's shared
# memory within the card's 227 KB
CHAIN_MAX_DICT = 8
CHAIN_MAX_K = 8
CHAIN_MAX_SMEM = 232448
# fp32: one block per SM, at most 1024 rows a tile (the kernel picks the
# largest of 1024, 512, ..., 64 whose block fits); fp64: 4 blocks of 256
# threads per SM, a row a thread
CHAIN_BLOCKS_PER_SM = {torch.float32: 1, torch.float64: 4}
_CHAIN_MIN_TILE = 64
_CHAIN_TILE_F64 = 256


def chain_smem_bytes(dmax: int, groups: int, k: int,
                     dtype=torch.float32) -> int:
    """The least shared memory a block of K6 takes for k <= 8 columns of
    v, as csrc/cla_chain.cu computes it (smem_f32_at at its smallest tile
    / smem_f64): the kernel takes the shape if and only if this fits. The
    launch takes its tile and bytes from the built kernel
    (chain_kernel_plan).

    fp32, at 64 rows a tile: the alignment slack, the table (256-byte
    blocks of 8 // kp groups, kp the power of two at or above k; of 2 for
    k = 1, a lookup adding a pair of groups), two stages of codes (a
    group's row padded by 16 bytes), the tile's z, the int32 histogram (8
    code slots of 128 max(kp, 2) bytes per 8 groups, and one chunk more
    for its alignment), the fp64 accumulators and the per-warp maxima of
    512 threads (k <= 2) or 256.

    fp64: the table and one histogram per row slice (256 // (groups * k)
    slices, at least 1) in double, the tile's z in double, and its codes,
    each group's row padded by 4 bytes."""
    if dtype == torch.float64:
        pairs = groups * k
        slices = 1 if pairs >= _CHAIN_TILE_F64 else _CHAIN_TILE_F64 // pairs
        return (8 * (dmax * pairs * (1 + slices) + _CHAIN_TILE_F64 * k)
                + groups * (_CHAIN_TILE_F64 + 4))
    kp = 1 << (k - 1).bit_length()
    tile = _CHAIN_MIN_TILE
    table = 256 * -(-groups // (2 if k == 1 else max(1, 8 // kp)))
    warps = (512 if k <= 2 else 256) // 32
    return (256 + table + 2 * groups * (tile + 16) + 4 * kp * tile
            + 1024 * max(kp, 2) * (-(-groups // 8) + 1)
            + 8 * dmax * groups * k + 4 * kp * warps)


def chain_supported(c: CompressedMatrixBlock, k: int, dtype) -> bool:
    """Whether K6 takes the block with k columns of v of `dtype`: the JAX
    package's predicate (every group coded, dmax <= 8), and this kernel's
    own bounds (fp32 or fp64, the shared memory of a block at the widest
    chunk of v, min(k, 8) columns). From host metadata alone: nothing is
    uploaded."""
    shape = _host_meta(c)[2]
    if shape is None:
        return False
    dmax, groups = shape
    return (dmax <= CHAIN_MAX_DICT and k >= 1 and dtype in CHAIN_DTYPES
            and chain_smem_bytes(dmax, groups, min(k, CHAIN_MAX_K), dtype)
            <= CHAIN_MAX_SMEM)


def chain_codes(codes):
    """codes (G, n) uint8 in the layout K6 reads: a view of a (G, n rounded
    up to 16) tensor, each row starting 16 bytes aligned (the padding
    bytes are zero and never counted)."""
    G, n = codes.shape
    buf = torch.zeros((G, -(-n // 16) * 16), dtype=torch.uint8,
                      device=codes.device)
    buf[:, :n] = codes
    return buf[:, :n]


class ChainLayout:
    """K6's device form of an all-coded block, built once and cached on
    it: the codes as one (G, n) uint8 tensor (chain_codes), and the
    dictionaries spread into one (dmax * G, m) matrix `a`, a[j * G + g,
    cols_g[t]] = dict_g[j, t] (0 past a dictionary's rows), in which the
    value table is a @ v and the output a^T @ part (`a64`, in double, as
    the histograms are)."""

    def __init__(self, c: CompressedMatrixBlock, device):
        n, m = c.shape
        dmax, G = _host_meta(c)[2]
        codes = np.empty((G, n), dtype=np.uint8)
        a = np.zeros((dmax, G, m), dtype=c.groups[0].dictionary().dtype)
        for i, g in enumerate(c.groups):
            d = g.dictionary()
            codes[i] = g.codes()
            a[:d.shape[0], i][:, g.cols] = d
        self.dmax, self.groups, self.n, self.m = dmax, G, n, m
        self.codes = chain_codes(torch.from_numpy(codes).to(device))
        self.a = torch.from_numpy(a.reshape(dmax * G, m)).to(device)
        self.a64 = self.a.double()


def chain_layout(c: CompressedMatrixBlock) -> ChainLayout:
    lay = getattr(c, "_chain_layout", None)
    if lay is None:
        if _host_meta(c)[2] is None:
            raise ValueError("K6 takes a block whose groups are all coded")
        lay = c._chain_layout = ChainLayout(c, get_config().device)
    return lay


def chain_mmchain(c: CompressedMatrixBlock, v, w=None,
                  ctype: str = "XtXv"):
    """The compressed mmchain through K6 (chain_kernel), as the JAX
    package's tpu_mmchain: the value table sv[j, g, :] = dict_g[j, :] @
    v[cols_g, :] and the output out[cols_g, :] = dict_g^T @ part[:, g, :]
    are torch ops around the kernel's pass over the rows (one product
    each, with the layout's `a`); the kernel takes v's columns 8 at a time,
    a launch each. Returns (m, k) in v's dtype. The caller checks
    chain_supported first."""
    lay = chain_layout(c)
    v = v.reshape(lay.m, -1)
    wv = None if ctype == "XtXv" else w.reshape(lay.n, -1).to(v.dtype)
    sv = chain_table(lay, v)
    k = sv.shape[2]
    parts = []
    for c0 in range(0, k, CHAIN_MAX_K):   # a launch per 8 columns of v
        c1 = min(k, c0 + CHAIN_MAX_K)
        wc = wv if wv is None or wv.shape[1] == 1 else wv[:, c0:c1]
        parts.append(chain_kernel(lay.codes, sv[:, :, c0:c1].contiguous(),
                                  wc, ctype))
    part = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
    out = torch.matmul(lay.a64.T, part.reshape(lay.dmax * lay.groups, -1))
    return out.to(v.dtype)


def chain_table(lay: ChainLayout, v):
    """The value table sv[j, g, :] = dict_g[j, :] @ v[cols_g, :],
    (dmax, G, k) contiguous in v's dtype; v is (m, k)."""
    return torch.matmul(lay.a.to(v.dtype), v).reshape(
        lay.dmax, lay.groups, -1)


def _chain_operands(codes, sv, w, ctype: str):
    if ctype not in CHAIN_CTYPES:
        raise ValueError(f"unknown mmchain ctype {ctype!r}")
    if codes.ndim != 2 or sv.ndim != 3 or sv.shape[1] != codes.shape[0]:
        raise ValueError(f"chain: codes {tuple(codes.shape)} and table "
                         f"{tuple(sv.shape)} do not match (G, n) and "
                         f"(dmax, G, k)")
    n, k = codes.shape[1], sv.shape[2]
    if ctype == "XtXv":
        return None
    if w is None:
        raise ValueError(f"mmchain {ctype} needs w/y")
    w = w.reshape(n, -1)
    if w.shape[1] not in (1, k):
        raise ValueError(f"chain {ctype}: w/y has {w.shape[1]} columns, v "
                         f"has {k}")
    return w


def chain_plain(codes, sv, w=None, ctype: str = "XtXv"):
    """The plain version of K6: codes (G, n) of dictionary rows, the value
    table sv (dmax, G, k), w or y (n, 1) or (n, k). Returns the histograms
    part[j, g, :] = sum of z over the rows with code_g == j, (dmax, G, k)
    in float64, with z = w? * xv -? y and xv[r] = sum_g sv[code_g[r], g];
    sums in double, as the kernel's."""
    w = _chain_operands(codes, sv, w, ctype)
    G, n = codes.shape
    dmax, _, k = sv.shape
    svd = sv.double()
    idx = [codes[g].long() for g in range(G)]
    xv = torch.zeros((n, k), dtype=torch.float64, device=sv.device)
    for g in range(G):
        xv += svd[:, g, :].index_select(0, idx[g])
    z = xv
    if ctype == "XtwXv":
        z = w.double() * xv
    elif ctype == "XtXvy":
        z = xv - w.double()
    part = torch.zeros((dmax, G, k), dtype=torch.float64, device=sv.device)
    for g in range(G):
        part[:, g, :] = torch.zeros((dmax, k), dtype=torch.float64,
                                    device=sv.device).index_add_(0, idx[g], z)
    return part


_chain_lib: Optional[ctypes.CDLL] = None


def _chain_library() -> ctypes.CDLL:
    global _chain_lib
    if _chain_lib is None:
        from systemml_tpu_torch.codegen import build

        lib = build.load("cla_chain")
        lib.smtorch_cla_chain.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
            + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.smtorch_cla_chain.restype = ctypes.c_int
        lib.smtorch_cla_chain_smem.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
        lib.smtorch_cla_chain_smem.restype = ctypes.c_longlong
        _chain_lib = lib
    return _chain_lib


@functools.lru_cache(maxsize=None)
def chain_kernel_plan(dmax: int, groups: int, k: int, dtype):
    """(rows per tile, shared bytes) of a block as the built kernel computes
    them (smtorch_cla_chain_smem), (0, 0) for a shape it does not take.
    Builds the kernel."""
    tile = ctypes.c_int(0)
    smem = _chain_library().smtorch_cla_chain_smem(
        dmax, groups, k, CHAIN_DTYPES[dtype], ctypes.byref(tile))
    return tile.value, int(smem)


_chain_sm_count: Dict[Optional[int], int] = {}


def _chain_sms(dev) -> int:
    sms = _chain_sm_count.get(dev.index)
    if sms is None:
        sms = _chain_sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


def chain_kernel(codes, sv, w=None, ctype: str = "XtXv"):
    """K6: the compressed chain's pass over the rows (csrc/cla_chain.cu),
    the function of chain_plain. On a CUDA tensor it launches the kernel,
    or raises on what the kernel does not take: codes not a (G, n) uint8
    tensor whose rows start 16 bytes aligned (chain_codes lays them out
    so), a table not contiguous (dmax, G, k) fp32 or fp64 with dmax <= 8
    and k <= 8 (chain_mmchain takes a wider v 8 columns at a time), w/y of
    another dtype, or a block past its shared memory (chain_kernel_plan). The
    codes must index rows of the table (the layout that builds them
    guarantees it). On a CPU tensor it runs chain_plain. Returns
    (dmax, G, k) float64."""
    if codes.device.type == "cpu":
        return chain_plain(codes, sv, w, ctype)
    if codes.device.type != "cuda":
        raise ValueError(f"chain_kernel: unsupported device {codes.device}")
    w = _chain_operands(codes, sv, w, ctype)
    G, n = codes.shape
    dmax, _, k = sv.shape
    operands = (codes, sv) if w is None else (codes, sv, w)
    if any(t.device != codes.device for t in operands):
        raise ValueError("chain_kernel: operands on different devices")
    if codes.dtype != torch.uint8:
        raise TypeError("chain_kernel takes uint8 codes")
    ldc = codes.stride(0)
    if (codes.stride(1) != 1 or ldc % 16 or ldc < n
            or codes.data_ptr() % 16):
        raise ValueError("chain_kernel reads code rows 16 bytes aligned "
                         "(chain_codes lays them out so); got strides "
                         f"{tuple(codes.stride())}")
    if sv.dtype not in CHAIN_DTYPES or not sv.is_contiguous():
        raise TypeError("chain_kernel takes a contiguous fp32 or fp64 table")
    if w is not None:
        if w.dtype != sv.dtype:
            raise TypeError("chain_kernel: w/y and the table differ in dtype")
        w = w.contiguous()
    tile = chain_kernel_plan(dmax, G, k, sv.dtype)[0]
    if not tile:
        raise ValueError(f"chain_kernel takes dmax <= {CHAIN_MAX_DICT}, k <= "
                         f"{CHAIN_MAX_K} and {CHAIN_MAX_SMEM} B of shared "
                         f"memory; got dmax={dmax}, G={G}, k={k}")
    lib = _chain_library()
    dev = codes.device
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return chain_kernel(codes, sv, w, ctype)
    sms = _chain_sms(dev)
    grid = max(1, min(-(-n // tile), CHAIN_BLOCKS_PER_SM[sv.dtype] * sms))
    partial = torch.empty((grid, dmax, G, k), dtype=torch.float64,
                          device=dev)
    out = torch.empty((dmax, G, k), dtype=torch.float64, device=dev)
    err = lib.smtorch_cla_chain(
        codes.data_ptr(), ldc, sv.data_ptr(),
        None if w is None else w.data_ptr(), partial.data_ptr(),
        out.data_ptr(), n, G, dmax, k, CHAIN_CTYPES[ctype],
        1 if w is None else w.shape[1], CHAIN_DTYPES[sv.dtype], grid,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cla_chain kernel launch failed: CUDA error {err}")
    counts.count(chain_kernel)
    return out


chain_kernel.launches = 0
