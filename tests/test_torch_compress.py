"""Compressed linear algebra in the port against the JAX package, module by
module, on the same numpy-seeded inputs (systemml_tpu_torch/compress/
against systemml_tpu/compress/):

- compress() picks the same groups: kinds, columns, dictionaries, codes
  and code widths, OLE offsets and RLE runs;
- the compressed ops agree with the JAX package's on its CPU paths and
  with the dense numpy product: right and left mult, tsmm, the
  aggregates, scalar and unary maps, decompress; on the blocks of
  tests/test_compress.py and tests/test_compress_device.py (uint8 and
  uint16 codes, a single-value group, an all-default OLE group);
- K6's plain version (chain_plain, through chain_mmchain on CPU tensors)
  for the three chain types at dmax 1..8, ragged n, k = 1 and 3, against
  the JAX package's device.mmchain (its gather arm: its chain kernel runs
  only off the CPU) and the dense product;
- K6's support predicate refuses what the JAX package's
  _tpu_chain_layout refuses, and a refused layout takes the gather arm,
  counted.

Bars (SURVEY.md, the reference's CP and GPU bars): relative 1e-9 in fp64,
1e-3 in fp32. K6 on the card: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from systemml_tpu.compress import compress as jax_compress
from systemml_tpu.compress import device as jax_dev
from systemml_tpu.compress.block import \
    CompressedMatrixBlock as JaxBlock
from systemml_tpu.compress import colgroup as jax_cg
from systemml_tpu.ops import agg as jax_agg
from systemml_tpu.ops import cellwise as jax_cellwise
from systemml_tpu_torch.compress import colgroup as cg
from systemml_tpu_torch.compress import compress
from systemml_tpu_torch.compress import device as cla_dev
from systemml_tpu_torch.compress.block import CompressedMatrixBlock
from systemml_tpu_torch.ops import agg, cellwise, mult
from systemml_tpu_torch.utils import config as port_config
from systemml_tpu_torch.utils import stats as port_stats

TOL = {np.float64: 1e-9, np.float32: 1e-3}


@pytest.fixture(autouse=True)
def port_cpu():
    old = port_config.get_config()
    port_config.set_config(port_config.DMLConfig(device="cpu"))
    yield
    port_config.set_config(old)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    den = np.linalg.norm(ref)
    return np.linalg.norm(got - ref) / (den if den else 1.0)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---- the matrices ----------------------------------------------------------

def _cla_matrix(rng, n=500):
    """tests/test_compress.py's mixed matrix: categorical, binary, runs, a
    sparse column with a dominant zero, an incompressible column."""
    c0 = rng.choice([0.0, 1.0, 2.0], n)
    c1 = rng.choice([10.0, 20.0], n)
    c2 = np.repeat(rng.choice([5.0, 7.0, 9.0], n // 10), 10)[:n]
    c3 = np.where(rng.random(n) < 0.05, rng.choice([1.0, 2.0], n), 0.0)
    c4 = rng.random(n)
    return np.column_stack([c0, c1, c2, c3, c4])


def _categorical(rng, n, m, dmin=2, dmax=8):
    """Column j takes d_j values in dmin..dmax, uniform codes, N(0, 1)
    dictionary values."""
    cols = []
    for _ in range(m):
        d = int(rng.integers(dmin, dmax + 1))
        cols.append(rng.standard_normal(d)[rng.integers(0, d, n)])
    return np.column_stack(cols)


def _correlated(rng, n=400):
    a = rng.choice([1.0, 2.0, 3.0], n)
    return np.column_stack([a, a * 10, rng.choice([4.0, 5.0], n)])


MATRICES = {
    "mixed": lambda rng: _cla_matrix(rng),
    "categorical": lambda rng: _categorical(rng, 3000, 8),
    "correlated": _correlated,
    "runs": lambda rng: np.repeat([1.0, 2.0, 3.0, 1.0], 250).reshape(-1, 1),
    "ole": lambda rng: np.where(np.arange(1000) % 50 == 0, 3.0,
                                0.0).reshape(-1, 1),
    "wide_dict": lambda rng: np.column_stack(
        [rng.integers(0, 300, 2000).astype(np.float64),
         rng.choice([0.5, 1.5], 2000)]),
}


def _group_desc(g):
    kind = type(g).__name__
    out = [kind, g.cols.tolist()]
    if kind == "ColGroupUncompressed":
        return out + [g.values()]
    out += [g.dictionary(), g.codes(), str(g.codes().dtype)]
    if kind == "ColGroupOLE":
        out += [[o.tolist() for o in g._offsets], g._default]
    if kind == "ColGroupRLE":
        out += [g._starts.tolist(), g._lens.tolist(), g._run_vals.tolist()]
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_compress_picks_the_same_groups(name):
    x = MATRICES[name](np.random.default_rng(13))
    cj, cp = jax_compress(x), compress(x)
    assert cp.shape == cj.shape and len(cp.groups) == len(cj.groups)
    for gj, gp in zip(cj.groups, cp.groups):
        _same(_group_desc(gp), _group_desc(gj))
    assert cp.compression_ratio() == cj.compression_ratio()
    np.testing.assert_array_equal(cp.decompress(), x)
    assert cp.decompress().dtype == np.float64
    dense = cp.to_dense()
    assert isinstance(dense, torch.Tensor) and dense.device.type == "cpu"
    np.testing.assert_array_equal(_np(dense), x)


def test_compress_keeps_fp32_dictionaries():
    x = _categorical(np.random.default_rng(3), 2000, 6).astype(np.float32)
    cp, cj = compress(x), jax_compress(x)
    for gj, gp in zip(cj.groups, cp.groups):
        _same(_group_desc(gp), _group_desc(gj))
    assert cp.to_dense().dtype == torch.float32


# ---- the compressed ops ----------------------------------------------------

def _ddc(mod, cols, n_distinct, n_cols, rng, n=200):
    dict_vals = rng.standard_normal((n_distinct, n_cols))
    return mod.ColGroupDDC(cols, dict_vals, rng.integers(0, n_distinct, n))


def _pair(build, n_cols, n=200):
    """The same groups in both packages, from one seed."""
    gj = build(jax_cg, np.random.default_rng(91))
    gp = build(cg, np.random.default_rng(91))
    return JaxBlock(gj, (n, n_cols)), CompressedMatrixBlock(gp, (n, n_cols))


def _unc(mod, cols, rng, n=200):
    return mod.ColGroupUncompressed(cols, rng.standard_normal((n, len(cols))))


# tests/test_compress_device.py's blocks
BLOCKS = {
    "uint8": (lambda m, r: [_ddc(m, [0, 1], 7, 2, r), _ddc(m, [2], 250, 1, r),
                            _unc(m, [3], r)], 4),
    "uint16": (lambda m, r: [_ddc(m, [0], 300, 1, r),
                             _ddc(m, [1, 2], 5, 2, r)], 3),
    "mixed_widths": (lambda m, r: [_ddc(m, [0], 300, 1, r),
                                   _ddc(m, [1], 9, 1, r), _unc(m, [2], r)],
                     3),
    "single_value": (lambda m, r: [
        m.ColGroupDDC([0, 1], np.array([[2.5, -1.0]]),
                      np.zeros(200, dtype=np.int64)),
        _ddc(m, [2], 4, 1, r)], 3),
    "all_default_ole": (lambda m, r: [
        m.ColGroupOLE.from_codes([0], np.array([[0.0], [3.0]]),
                                 np.zeros(200, dtype=np.int64),
                                 default_idx=0),
        _ddc(m, [1], 6, 1, r)], 2),
    "one_coded_group": (lambda m, r: [_ddc(m, [0, 1, 2], 11, 3, r)], 3),
}


def _block_pair(name):
    build, n_cols = BLOCKS[name]
    return _pair(build, n_cols)


def test_device_mirror_keeps_code_widths():
    _, cp = _block_pair("mixed_widths")
    dc = cla_dev.device_mirror(cp)
    assert dc.groups[0].codes.dtype == torch.uint16
    assert dc.groups[1].codes.dtype == torch.uint8
    assert dc.groups[2].codes is None and dc.groups[2].vals is not None


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_ops_match_jax_and_dense(name):
    cj, cp = _block_pair(name)
    x = cj.decompress()
    np.testing.assert_array_equal(cp.decompress(), x)
    n, m = x.shape
    rng = np.random.default_rng(5)
    W, Y = rng.standard_normal((m, 3)), rng.standard_normal((4, n))
    v, w = rng.standard_normal((m, 1)), rng.standard_normal((n, 1))
    t = torch.from_numpy
    pairs = [
        (mult.matmult(cp, t(W)), jax_dev.right_mult(cj, W), x @ W),
        (mult.matmult(t(Y), cp), jax_dev.left_mult(cj, Y), Y @ x),
        (mult.tsmm(cp), jax_dev.tsmm(cj), x.T @ x),
        (mult.tsmm(cp, left=False), x @ x.T, x @ x.T),
    ]
    for ct, wv, exp in (("XtXv", None, x.T @ (x @ v)),
                        ("XtwXv", w, x.T @ (w * (x @ v))),
                        ("XtXvy", w, x.T @ ((x @ v) - w))):
        pairs.append((mult.mmchain(cp, t(v), None if wv is None else t(wv),
                                   ct),
                      jax_dev.mmchain(cj, v, wv, ct), exp))
    for got, ref, exp in pairs:
        assert _rel(_np(got), np.asarray(ref)) <= 1e-9
        assert _rel(_np(got), exp) <= 1e-9


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_aggregates_and_maps_match_jax(name):
    cj, cp = _block_pair(name)
    x = cj.decompress()
    for op in ("sum", "min", "max", "mean"):
        got, ref = agg.agg(op, cp), jax_agg.agg(op, cj)
        assert isinstance(got, float)
        assert got == pytest.approx(float(ref), rel=1e-12)
    for op, direction in (("sum", "col"), ("min", "col"), ("max", "col"),
                          ("sum", "row"), ("var", "all")):
        got = _np(agg.agg(op, cp, direction))
        assert _rel(got, np.asarray(jax_agg.agg(op, cj, direction))) <= 1e-9
    for op, a, b in (("*", cp, 2.5), ("/", cp, 4.0), ("+", cp, 1.0),
                     ("-", cp, 0.5), ("^", cp, 2.0), ("min", cp, 0.1),
                     ("max", cp, 0.1), ("*", 3.0, cp), ("+", 3.0, cp),
                     ("-", 3.0, cp)):
        got = cellwise.binary_op(op, a, b)
        ja, jb = (cj if a is cp else a), (cj if b is cp else b)
        ref = jax_cellwise.binary_op(op, ja, jb)
        assert type(got).__name__ == "CompressedMatrixBlock"
        assert _rel(got.decompress(), ref.decompress()) <= 1e-9
    for op in ("exp", "abs", "sigmoid", "round", "-"):
        got, ref = cellwise.unary_op(op, cp), jax_cellwise.unary_op(op, cj)
        assert _rel(got.decompress(), ref.decompress()) <= 1e-9
    # an op with no compressed form decompresses, as there
    z = np.ones_like(x)
    got = cellwise.binary_op("*", cp, torch.from_numpy(z))
    assert _rel(_np(got), np.asarray(jax_cellwise.binary_op("*", cj, z))) \
        <= 1e-9


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ops_on_a_compressed_matrix(dtype):
    x = _cla_matrix(np.random.default_rng(13)).astype(dtype)
    cj, cp = jax_compress(x), compress(x)
    rng = np.random.default_rng(8)
    W = rng.standard_normal((5, 3)).astype(dtype)
    Y = rng.standard_normal((4, 500)).astype(dtype)
    t = torch.from_numpy
    tol = TOL[dtype]
    xd = x.astype(np.float64)
    for got, ref, exp in (
            (mult.matmult(cp, t(W)), jax_dev.right_mult(cj, W), xd @ W),
            (mult.matmult(t(Y), cp), jax_dev.left_mult(cj, Y), Y @ xd),
            (mult.tsmm(cp), jax_dev.tsmm(cj), xd.T @ xd)):
        assert _rel(_np(got), np.asarray(ref)) <= tol
        assert _rel(_np(got), exp) <= tol
    # compressed times compressed: the right side is decompressed
    y = np.random.default_rng(2).choice([0.0, 1.0], (5, 5)).astype(dtype)
    got = mult.matmult(compress(x[:100]), compress(y))
    assert _rel(_np(got), xd[:100] @ y) <= tol


# ---- K6's plain version ----------------------------------------------------

def _chain_block(rng, n, dmax, groups=(1, 2, 1, 3)):
    """An all-coded block whose dictionaries have 1..dmax rows (one of
    exactly dmax), groups of the given widths, uint8 codes."""
    gp, gj, col = [], [], 0
    for i, width in enumerate(groups):
        d = dmax if i == 0 else int(rng.integers(1, dmax + 1))
        dct = rng.standard_normal((d, width))
        codes = rng.integers(0, d, n)
        cols = list(range(col, col + width))
        col += width
        gp.append(cg.ColGroupDDC(cols, dct, codes))
        gj.append(jax_cg.ColGroupDDC(cols, dct, codes))
    return JaxBlock(gj, (n, col)), CompressedMatrixBlock(gp, (n, col))


CHAIN_CASES = [(dmax, n, k) for dmax in range(1, 9)
               for n, k in ((1037, 1), (2000, 3))]


@pytest.mark.parametrize("dmax,n,k", CHAIN_CASES)
def test_chain_plain_matches_jax_gather_arm(dmax, n, k):
    rng = np.random.default_rng(dmax * 100 + k)
    cj, cp = _chain_block(rng, n, dmax)
    assert cla_dev.chain_supported(cp, k, torch.float64)
    assert jax_dev._tpu_chain_layout(cj) is not None
    x = cj.decompress()
    v = rng.standard_normal((x.shape[1], k))
    for ct, wc in (("XtXv", 0), ("XtwXv", 1), ("XtXvy", k)):
        w = rng.standard_normal((n, wc)) if wc else None
        got = cla_dev.chain_mmchain(cp, torch.from_numpy(v),
                                    None if w is None else torch.from_numpy(w),
                                    ct)
        ref = jax_dev.mmchain(cj, v, w, ct)
        z = x @ v
        z = z if ct == "XtXv" else (w * z if ct == "XtwXv" else z - w)
        assert got.dtype == torch.float64
        assert _rel(_np(got), np.asarray(ref)) <= 1e-9, ct
        assert _rel(_np(got), x.T @ z) <= 1e-9, ct


@pytest.mark.parametrize("ctype", ["XtXv", "XtwXv", "XtXvy"])
def test_chain_plain_fp32(ctype):
    rng = np.random.default_rng(17)
    cj, cp = _chain_block(rng, 3001, 8)
    x = cj.decompress()
    for g in cp.groups:
        g._dict = g._dict.astype(np.float32)
    v = rng.standard_normal((x.shape[1], 1)).astype(np.float32)
    w = rng.standard_normal((3001, 1)).astype(np.float32)
    wv = None if ctype == "XtXv" else w
    got = cla_dev.chain_mmchain(cp, torch.from_numpy(v),
                                None if wv is None else torch.from_numpy(wv),
                                ctype)
    assert got.dtype == torch.float32
    assert _rel(_np(got), np.asarray(jax_dev.mmchain(cj, v, wv, ctype))) \
        <= 1e-3


def test_chain_plain_histograms():
    """chain_plain itself: part[j, g] sums z over the rows coded j."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, (3, 97)).astype(np.uint8)
    sv = rng.standard_normal((5, 3, 2))
    y = rng.standard_normal((97, 2))
    part = cla_dev.chain_plain(torch.from_numpy(codes), torch.from_numpy(sv),
                               torch.from_numpy(y), "XtXvy")
    xv = sum(sv[codes[g], g, :] for g in range(3))
    z = xv - y
    ref = np.zeros((5, 3, 2))
    for g in range(3):
        np.add.at(ref[:, g, :], codes[g], z)
    assert part.dtype == torch.float64
    np.testing.assert_allclose(_np(part), ref, rtol=1e-12, atol=1e-12)
    # on a CPU tensor the wrapper is the plain version, and no launch
    before = cla_dev.chain_kernel.launches
    again = cla_dev.chain_kernel(torch.from_numpy(codes),
                                 torch.from_numpy(sv), torch.from_numpy(y),
                                 "XtXvy")
    assert torch.equal(again, part)
    assert cla_dev.chain_kernel.launches == before


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chain_wide_v_runs_in_chunks_of_8(monkeypatch, dtype):
    """k = 12: chain_mmchain takes v's columns 8 and then 4 through the
    kernel's wrapper, and agrees with the JAX package's chain."""
    rng = np.random.default_rng(12)
    cj, cp = _chain_block(rng, 2003, 8, groups=(1, 2, 3, 1, 2))
    if dtype == np.float32:
        for g in cp.groups:
            g._dict = g._dict.astype(np.float32)
    x = cj.decompress()
    k = 12
    assert cla_dev.chain_supported(cp, k, torch.float32)
    widths = []
    wrapped = cla_dev.chain_kernel

    def counting(codes, sv, w=None, ctype="XtXv"):
        widths.append((sv.shape[2], None if w is None else w.shape[1]))
        return wrapped(codes, sv, w, ctype)

    monkeypatch.setattr(cla_dev, "chain_kernel", counting)
    v = rng.standard_normal((x.shape[1], k)).astype(dtype)
    for ct, wc in (("XtXv", 0), ("XtwXv", 1), ("XtXvy", k), ("XtXvy", 1)):
        w = rng.standard_normal((2003, wc)).astype(dtype) if wc else None
        widths.clear()
        got = cla_dev.chain_mmchain(
            cp, torch.from_numpy(v),
            None if w is None else torch.from_numpy(w), ct)
        wcols = None if w is None else (1 if wc == 1 else None)
        assert widths == [(8, wcols or (None if w is None else 8)),
                          (4, wcols or (None if w is None else 4))], ct
        ref = np.asarray(jax_dev.mmchain(cj, v, w, ct))
        assert got.shape == (x.shape[1], k)
        assert _rel(_np(got), ref) <= (1e-9 if dtype == np.float64
                                       else 1e-3), ct


def test_chain_support_refuses_what_jax_refuses():
    rng = np.random.default_rng(6)
    dct9 = rng.standard_normal((9, 1))
    cases = {
        "uncompressed group": [cg.ColGroupDDC([0], rng.standard_normal((3, 1)),
                                              rng.integers(0, 3, 300)),
                               cg.ColGroupUncompressed(
                                   [1], rng.standard_normal((300, 1)))],
        "dictionary of 9": [cg.ColGroupDDC([0], dct9,
                                           rng.integers(0, 9, 300))],
    }
    for label, groups in cases.items():
        cp = CompressedMatrixBlock(groups, (300, len(groups)))
        cj = JaxBlock([_to_jax(g) for g in groups], (300, len(groups)))
        assert jax_dev._tpu_chain_layout(cj) is None, label
        assert not cla_dev.chain_supported(cp, 1, torch.float64), label
    _, ok = _chain_block(rng, 300, 8)
    assert cla_dev.chain_supported(ok, 8, torch.float32)
    # this kernel's own bounds: fp32/fp64 and a block's shared memory; a v
    # wider than 8 columns runs in chunks of 8, so k itself is no bound
    # (the JAX package's kernel has none)
    for k in (9, 12, 100):
        assert cla_dev.chain_supported(ok, k, torch.float32)
        assert cla_dev.chain_supported(ok, k, torch.float64)
    assert not cla_dev.chain_supported(ok, 1, torch.float16)
    many = CompressedMatrixBlock(
        [cg.ColGroupDDC([i], rng.standard_normal((8, 1)),
                        rng.integers(0, 8, 50)) for i in range(800)],
        (50, 800))
    # any number of groups: past one block's shared memory the kernel
    # takes them in slabs
    assert cla_dev.chain_supported(many, 1, torch.float32)
    assert cla_dev.chain_supported(many, 8, torch.float64)


def _to_jax(g):
    if isinstance(g, cg.ColGroupUncompressed):
        return jax_cg.ColGroupUncompressed(g.cols, g.values())
    return jax_cg.ColGroupDDC(g.cols, g.dictionary(), g.codes())


def test_refused_layout_takes_gather_arm_counted():
    rng = np.random.default_rng(9)
    x = np.column_stack([rng.integers(0, 9, 400).astype(np.float64),
                         rng.choice([1.0, 2.0], 400)])
    cp, cj = compress(x), jax_compress(x)
    v = rng.standard_normal((2, 1))
    st = port_stats.Statistics()
    with port_stats.stats_scope(st):
        got = mult.mmchain(cp, torch.from_numpy(v))
    assert st.estim_counts["cla_chain_plain_by_layout"] == 1
    assert _rel(_np(got), np.asarray(jax_dev.mmchain(cj, v))) <= 1e-9
    # a supported layout on the CPU takes the gather arm too, uncounted
    # (K6 runs on the card), as the JAX package takes it off its TPU
    cp2 = compress(x[:, 1:])
    st = port_stats.Statistics()
    with port_stats.stats_scope(st):
        mult.mmchain(cp2, torch.from_numpy(v[1:]))
    assert "cla_chain_plain_by_layout" not in dict(st.estim_counts.items())


def _many_codes(n, d, dominant, seed):
    """n codes over d values, a `dominant` share of the rows on one code."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, d, n)
    codes[rng.random(n) < dominant] = d // 3
    return codes


@pytest.mark.parametrize("n,d,dominant,k", [
    (200_003, 50_000, 0.6, 1), (200_003, 50_000, 0.6, 3),
    (70_001, 65_536, 0.0, 2), (3_000, 8, 0.9, 1), (200_003, 6, 0.7, 2),
    (1, 1, 0.0, 1)])
def test_left_mult_segments_many_codes_one_dominant(n, d, dominant, k):
    """The left mult's fixed-order segment sums (Segments) on a group of
    tens of thousands of codes, one of them holding most rows: equal to
    the float64 bincount within 1e-12 of the largest sum, the same bits
    on a repeat, and a layout of O(n + d) bytes (no code padded to a
    chunk); with few codes (the last two but one) the sums read the
    prefix at the codes' ends only, through windows of at most n bytes."""
    codes = _many_codes(n, d, dominant, seed=n + d)
    y = np.random.default_rng(5).standard_normal((k, n))
    seg = cla_dev.Segments([torch.from_numpy(codes.astype(np.int32))], [d])
    ext = torch.from_numpy(np.concatenate([y, np.zeros((k, 1))], 1))
    got = seg.sums(ext)
    ref = np.stack([np.bincount(codes, weights=y[i], minlength=d)
                    for i in range(k)])
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * max(
        1.0, np.max(np.abs(ref)))
    assert torch.equal(got, seg.sums(ext))
    b = cla_dev.SEGMENT_CHUNK
    assert (seg.win is not None) == (8 * d * b <= n)
    assert seg.nbytes() <= 4 * (n + 2 * b) + 20 * d + (
        n if seg.win is not None else 0)


@pytest.mark.parametrize("stream", [1 << 25, 700, 1])
def test_left_mult_groups_share_segment_streams(monkeypatch, stream):
    """A block's coded groups share segment streams of at most
    SEGMENT_STREAM rows (one, several, one a group), beside an
    uncompressed group: the left mult equals the dense product within
    1e-12 whatever the split, and the JAX package's left mult within
    1e-9."""
    monkeypatch.setattr(cla_dev, "SEGMENT_STREAM", stream)
    rng = np.random.default_rng(21)
    n = 300
    x = np.column_stack([rng.integers(0, d, n).astype(np.float64) * 0.5
                         for d in (2, 5, 9, 300, 3)]
                        + [rng.standard_normal(n)])
    cp, cj = compress(x), jax_compress(x)
    dc = cla_dev.device_mirror(cp)
    coded = [g for g in dc.groups if g.coded]
    assert sum(len(b) for _, b in dc.streams) == len(coded) >= 4
    assert len(dc.streams) == (1 if stream > 6 * n else
                               -(-len(coded) // max(1, stream // n)))
    y = rng.standard_normal((2, n))
    got = cla_dev._left(dc, torch.from_numpy(y)).numpy()
    assert np.max(np.abs(got - y @ x)) <= 1e-12 * np.max(np.abs(y @ x))
    assert _rel(got, np.asarray(jax_dev.left_mult(cj, y))) <= 1e-9
