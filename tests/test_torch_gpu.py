"""The hand-written kernels on the card, against their plain versions:
mmchain (systemml_tpu_torch/codegen/csrc/mmchain.cu), the spoof cell,
row, multi-aggregate (K3) and outer-product (K5) templates
(csrc/spoof.cuh, one generated source per plan) and the compressed chain
K6 (csrc/cla_chain.cu, against compress/device.py chain_plain; also the
compressed mmchain's choice of K6 by layout); the loop regions' graphs,
the sparse arms, and the algorithm-breadth ops on the card (solvers in a
captured region, seq and sample equal to the CPU's draw, the index
aggregates, repeatable weighted tables, betainc); the DNN ops (both conv
arms, max-pool ties, the normal draw equal to the CPU's, a loop of
conv2d, batch norm and pooling captured as one region).

Marked `gpu`: without a CUDA card every test skips, with the reason,
from the `cuda` fixture (decided at run time, never at import, so every
test worker collects the same tests). On the card:

    python -m pytest tests/test_torch_gpu.py -q

Bar: normwise relative error <= 1e-5 against the plain version run in
fp64 on the card from the same fp32 inputs (fp32 sums over 1,037 rows in
another order; the spoof kernels' fp32 exp/pow/tan are within a few ulp),
<= 1e-12 for the spoof kernels and K6 in fp64, NaN at the same places, and
bit-identical output from two launches.
"""

import os

import numpy as np
import pytest
import torch

from systemml_tpu_torch.codegen import kernels
from systemml_tpu_torch.codegen.cplan import CNode
from systemml_tpu_torch.ops import mult
from systemml_tpu_torch.utils import stats

pytestmark = pytest.mark.gpu

M, K = 1037, 128
CASES = [("XtXv", 1, 0), ("XtXv", 4, 0),
         ("XtwXv", 1, 1), ("XtwXv", 4, 1), ("XtwXv", 4, 4),
         ("XtXvy", 1, 1), ("XtXvy", 4, 1), ("XtXvy", 4, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(dev, c, wc, k=K, m=M, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((k, c)).astype(np.float32))
    w = (torch.from_numpy(rng.standard_normal((m, wc)).astype(np.float32))
         if wc else None)
    return x.to(dev), v.to(dev), None if w is None else w.to(dev)


def _check(x, v, w, ctype):
    before = kernels.mmchain_kernel.launches
    out = kernels.mmchain_kernel(x, v, w, ctype)
    again = kernels.mmchain_kernel(x, v, w, ctype)
    torch.cuda.synchronize()
    assert kernels.mmchain_kernel.launches == before + 2
    assert torch.equal(out, again)
    ref = kernels.mmchain_plain(x.double(), v.double(),
                                None if w is None else w.double(), ctype)
    err = (torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref))
    assert out.shape == ref.shape and float(err) <= 1e-5


@pytest.mark.parametrize("ctype,c,wc", CASES)
def test_kernel_matches_plain(cuda, ctype, c, wc):
    _check(*_inputs(cuda, c, wc), ctype)


@pytest.mark.parametrize("k", [128, 130, 1000, 2048])
def test_kernel_widths_and_unaligned_k(cuda, k):
    _check(*_inputs(cuda, 8, 8, k=k, m=777), "XtXvy")


def test_dispatch_takes_kernel_by_shape(cuda):
    x, v, _ = _inputs(cuda, 1, 0)
    before = kernels.mmchain_kernel.launches
    mult.mmchain(x, v)
    assert kernels.mmchain_kernel.launches == before + 1
    mult.mmchain(x[:, :100].contiguous(), v[:100])   # k < 128: two-pass
    mult.mmchain(x.double(), v.double())             # fp64: two-pass
    assert kernels.mmchain_kernel.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, v, _ = _inputs(cuda, 1, 0)
    with pytest.raises(TypeError):
        kernels.mmchain_kernel(x.double(), v.double())
    with pytest.raises(ValueError):
        kernels.mmchain_kernel(x.T.contiguous().T, v)
    with pytest.raises(ValueError):
        kernels.mmchain_kernel(x[:, :100].contiguous(), v[:100])


@pytest.mark.parametrize("width,rows,cols", [
    (260, slice(5, None), slice(0, 200)),    # 16-byte loads
    (260, slice(0, None), slice(1, 131)),    # misaligned start
    (260, slice(3, None), slice(3, 259)),    # misaligned, k % 4 == 0
    (258, slice(0, None), slice(0, 128)),    # row stride % 4 != 0
])
def test_kernel_reads_slices_in_place(cuda, width, rows, cols):
    x, v, w = _inputs(cuda, 4, 1, k=width, m=901)
    xs = x[rows, cols]
    assert not xs.is_contiguous()
    _check(xs, v[:xs.shape[1]], w[rows], "XtwXv")


def test_dispatch_launches_on_views(cuda):
    x, v, _ = _inputs(cuda, 1, 0, k=300)
    b, _, _ = _inputs(cuda, 1, 0, k=M, m=K, seed=4)
    before = kernels.mmchain_kernel.launches
    for xs in (x[:, :200], x[10:, 50:250], b.T):   # X[, a:b], t(B)
        vs = v[:xs.shape[1]]
        out = mult.mmchain(xs, vs)
        ref = kernels.mmchain_plain(xs.double(), vs.double())
        err = torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref)
        assert float(err) <= 1e-5
    assert kernels.mmchain_kernel.launches == before + 3



# ---- spoof cell and row templates ----------------------------------------

def _n(op, *kids):
    return CNode(op, list(kids))


def _in(name):
    return CNode("in", name=name)


def _lit(v):
    return CNode("lit", value=v)


# every layout: i0 (m, n), i1 (1, n), i2 (m, 1), i3 (1, 1), s a Python
# number, t a 0-d tensor; min, max, sigmoid, pow, a comparison (of exact
# inputs: fp32 and fp64 agree on it) and x^2
SPOOF_PLAN = _n(
    "b(+)",
    _n("b(*)", _n("b(min)", _in("i0"), _in("i1")),
       _n("b(-)", _in("s"), _in("i2"))),
    _n("b(+)", _n("b(^)", _n("b(max)", _in("i0"), _in("t")), _lit(2.0)),
       _n("b(+)", _n("b(*)", _n("u(sigmoid)", _in("i3")),
                     _n("b(>)", _in("i0"), _n("u(abs)", _in("i2")))),
          _n("b(^)", _n("u(abs)", _in("i2")), _lit(0.5)))))
SPOOF_NAMES = ["i0", "i1", "s", "i2", "t", "i3"]


def _spoof_env(dev, dtype, m, n, seed=7, nan=False):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev, dtype)
    env = {"i0": t(rng.standard_normal((m, n))),
           "i1": t(rng.standard_normal((1, n))),
           "i2": t(rng.standard_normal((m, 1))),
           "i3": t(rng.standard_normal((1, 1))),
           "s": 0.25, "t": torch.tensor(-0.5, device=dev,
                                        dtype=torch.float64)}
    if nan:   # every 7th row NaN (through min and max), the rest finite
        env["i0"][::7, 0] = float("nan")
    return env


def _spoof_check(out, again, ref, dtype):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.nan_to_num(0.0), again.nan_to_num(0.0))
    ok = ~ref.isnan()
    err = (torch.linalg.norm(out.double()[ok] - ref[ok])
           / torch.linalg.norm(ref[ok]))
    assert float(err) <= (1e-5 if dtype == torch.float32 else 1e-12)


def _double(env):
    return {k: (v.double() if isinstance(v, torch.Tensor) else v)
            for k, v in env.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("agg", [None, "sum"])
@pytest.mark.parametrize("m,n", [(1037, 7), (100_003, 1), (33, 300)])
def test_spoof_cell_matches_plain(cuda, dtype, agg, m, n):
    env = _spoof_env(cuda, dtype, m, n)
    before = kernels.cell_kernel.launches
    out = kernels.cell_kernel(SPOOF_PLAN, SPOOF_NAMES, agg, env)
    again = kernels.cell_kernel(SPOOF_PLAN, SPOOF_NAMES, agg, env)
    assert kernels.cell_kernel.launches == before + 2
    ref = kernels.cell_plain(SPOOF_PLAN, SPOOF_NAMES, agg, _double(env))
    _spoof_check(out, again, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("row_agg", ["sum", "min", "max"])
@pytest.mark.parametrize("m,n", [(1037, 5), (515, 32), (300, 33),
                                 (64, 1000)])
def test_spoof_row_matches_plain(cuda, dtype, row_agg, m, n):
    """One thread per row for n <= 32, one warp per row above; NaN in the
    leaves of min and max."""
    env = _spoof_env(cuda, dtype, m, n, nan=True)
    before = kernels.row_kernel.launches
    out = kernels.row_kernel(SPOOF_PLAN, SPOOF_NAMES, row_agg, env)
    again = kernels.row_kernel(SPOOF_PLAN, SPOOF_NAMES, row_agg, env)
    assert kernels.row_kernel.launches == before + 2
    ref = kernels.row_plain(SPOOF_PLAN, SPOOF_NAMES, row_agg, _double(env))
    _spoof_check(out, again, ref, dtype)


@pytest.mark.parametrize("m,n", [(0, 7), (0, 1), (5, 0)])
def test_spoof_empty_main_leaf_launches(cuda, m, n):
    """An empty main leaf launches both templates (their loops run no
    iteration): cell gives an empty (m, n) or a sum of 0, a row sum of no
    cells 0; a row min or max of no cells raises, as the plain version."""
    env = _spoof_env(cuda, torch.float32, m, n)
    before = (kernels.cell_kernel.launches, kernels.row_kernel.launches)
    cells = kernels.cell_kernel(SPOOF_PLAN, SPOOF_NAMES, None, env)
    total = kernels.cell_kernel(SPOOF_PLAN, SPOOF_NAMES, "sum", env)
    rows = kernels.row_kernel(SPOOF_PLAN, SPOOF_NAMES, "sum", env)
    torch.cuda.synchronize()
    assert (kernels.cell_kernel.launches, kernels.row_kernel.launches) \
        == (before[0] + 2, before[1] + 1)
    assert cells.shape == (m, n) and cells.dtype == torch.float32
    assert total.shape == () and float(total) == 0.0
    assert rows.shape == (m, 1) and bool((rows == 0).all())
    for row_agg in ("min", "max"):
        if n == 0:
            with pytest.raises(ValueError):
                kernels.row_kernel(SPOOF_PLAN, SPOOF_NAMES, row_agg, env)
        else:
            out = kernels.row_kernel(SPOOF_PLAN, SPOOF_NAMES, row_agg, env)
            assert out.shape == (0, 1)


def test_spoof_refused_layout_takes_plain_arm(cuda):
    plan = _n("b(-)", _in("a"), _in("b"))
    env = {"a": torch.ones(40, 1, device=cuda),
           "b": torch.ones(40, 3, device=cuda)}
    st = stats.Statistics()
    before = kernels.cell_kernel.launches
    with stats.stats_scope(st):
        out = kernels.cell_kernel(plan, ["a", "b"], "sum", env)
    assert kernels.cell_kernel.launches == before
    assert st.estim_counts["spoof_plain_by_layout"] == 1
    assert float(out) == 0.0


def test_spoof_refuses_what_the_kernel_does_not_take(cuda):
    plan = _n("u(exp)", _in("a"))
    with pytest.raises(TypeError):
        kernels.cell_kernel(plan, ["a"], "sum",
                            {"a": torch.ones(4, 4, device=cuda,
                                             dtype=torch.float16)})
    with pytest.raises(ValueError):
        kernels.row_kernel(plan, ["a"], "prod",
                           {"a": torch.ones(4, 4, device=cuda)})


def test_optlevel3_program_launches_spoof_kernels(cuda):
    """L2SVM and MultiLogReg at optlevel 3 on the card: every fused plan
    is built before the program runs, the cell (and, for MultiLogReg, the
    row) kernel launches, and the results agree with optlevel 2."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dmlFromFile
    from systemml_tpu_torch.utils.config import DMLConfig

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3000, 40)).astype(np.float32)
    z = x @ rng.standard_normal((40, 1)).astype(np.float32)
    cases = [("l2-svm.dml", {"X": x, "Y": np.where(z >= 0, 1.0, -1.0)},
              {"maxiter": 5}, "w"),
             ("MultiLogReg.dml",
              {"X": x, "Y_vec": 1.0 + (np.argsort(np.argsort(z[:, 0])) * 5)
               // len(z)}, {"moi": 3}, "B")]
    for script, inputs, args, out in cases:
        results = {}
        for optlevel in (2, 3):
            cfg = DMLConfig()
            cfg.optlevel = optlevel
            ml = MLContext(cfg)
            ml.printer = lambda s: None
            s = dmlFromFile(os.path.join(root, "scripts", "algorithms",
                                         script))
            for k, v in inputs.items():
                s.input(k, np.asarray(v, np.float32).reshape(len(x), -1))
            for k, v in args.items():
                s.arg(k, v)
            cell0, row0 = (kernels.cell_kernel.launches,
                           kernels.row_kernel.launches)
            results[optlevel] = ml.execute(s.output(out)).get_tensor(out)
            torch.cuda.synchronize()
            launched = (kernels.cell_kernel.launches - cell0,
                        kernels.row_kernel.launches - row0)
            if optlevel == 3:
                assert launched[0] > 0
                assert (launched[1] > 0) == (script == "MultiLogReg.dml")
                assert ml._stats.estim_counts["spoof_plain_by_layout"] == 0
            else:
                assert launched == (0, 0)
        a, b = results[3].double(), results[2].double()
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-3


# ---- K6: the compressed chain (csrc/cla_chain.cu) -------------------------

CHAIN_BARS = {torch.float32: 1e-5, torch.float64: 1e-12}


def _chain_inputs(dev, dmax, groups, n, k, wc, dtype, seed=5):
    rng = np.random.default_rng(seed)
    from systemml_tpu_torch.compress import device as cla_dev

    codes = cla_dev.chain_codes(torch.from_numpy(
        rng.integers(0, dmax, (groups, n)).astype(np.uint8)).to(dev))
    sv = torch.from_numpy(rng.standard_normal((dmax, groups, k))).to(
        dev, dtype)
    w = (torch.from_numpy(rng.standard_normal((n, wc))).to(dev, dtype)
         if wc else None)
    return codes, sv, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ctype,k,wc", [("XtXv", 1, 0), ("XtXv", 4, 0),
                                        ("XtwXv", 1, 1), ("XtwXv", 4, 1),
                                        ("XtXvy", 1, 1), ("XtXvy", 4, 4)])
@pytest.mark.parametrize("dmax,groups,n", [(8, 68, 100_003), (1, 3, 1037),
                                           (5, 7, 255), (3, 200, 4097)])
def test_cla_chain_matches_plain(cuda, dtype, ctype, k, wc, dmax, groups, n):
    """K6 against chain_plain in fp64 on the card, from the same inputs;
    two launches bit-identical."""
    from systemml_tpu_torch.compress import device as cla_dev

    codes, sv, w = _chain_inputs(cuda, dmax, groups, n, k, wc, dtype)
    before = cla_dev.chain_kernel.launches
    out = cla_dev.chain_kernel(codes, sv, w, ctype)
    again = cla_dev.chain_kernel(codes, sv, w, ctype)
    ref = cla_dev.chain_plain(codes, sv.double(),
                              None if w is None else w.double(), ctype)
    torch.cuda.synchronize()
    assert cla_dev.chain_kernel.launches == before + 2
    assert out.dtype == torch.float64 and out.shape == (dmax, groups, k)
    assert torch.equal(out, again)
    err = torch.linalg.norm(out - ref) / torch.linalg.norm(ref)
    assert float(err) <= CHAIN_BARS[dtype]


def test_cla_mmchain_takes_kernel_by_layout(cuda):
    """A compressed X on the card: mmchain launches K6 when every group is
    coded with at most 8 dictionary rows; a block with a dictionary of 9
    or an uncompressed column takes the gather arm, counted, with no
    launch."""
    from systemml_tpu_torch.compress import compress
    from systemml_tpu_torch.compress import device as cla_dev

    rng = np.random.default_rng(8)
    n = 20_011
    cols = [rng.standard_normal(d)[rng.integers(0, d, n)]
            for d in (2, 5, 8, 3)]
    blocks = {
        "coded": np.column_stack(cols),
        "dmax 9": np.column_stack(
            cols + [rng.standard_normal(9)[rng.integers(0, 9, n)]]),
        "uncompressed": np.column_stack(cols + [rng.standard_normal(n)]),
    }
    for label, x in blocks.items():
        c = compress(x.astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((x.shape[1], 1))
                             .astype(np.float32)).to(cuda)
        y = torch.from_numpy(rng.standard_normal((n, 1))
                             .astype(np.float32)).to(cuda)
        st = stats.Statistics()
        before = cla_dev.chain_kernel.launches
        with stats.stats_scope(st):
            out = mult.mmchain(c, v, y, "XtXvy")
            again = mult.mmchain(c, v, y, "XtXvy")
        torch.cuda.synchronize()
        xd = torch.from_numpy(x.astype(np.float32)).to(cuda).double()
        ref = xd.T @ (xd @ v.double() - y.double())
        err = torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref)
        assert out.dtype == torch.float32 and float(err) <= 1e-5, label
        by_layout = st.estim_counts.get("cla_chain_plain_by_layout", 0)
        if label == "coded":
            assert cla_dev.chain_kernel.launches == before + 2
            assert by_layout == 0 and torch.equal(out, again)
        else:
            assert cla_dev.chain_kernel.launches == before, label
            assert by_layout == 2, label


def test_cla_chain_refuses_what_the_kernel_does_not_take(cuda):
    from systemml_tpu_torch.compress import device as cla_dev

    codes, sv, w = _chain_inputs(cuda, 8, 4, 300, 1, 1, torch.float32)
    with pytest.raises(TypeError):
        cla_dev.chain_kernel(codes.int(), sv, w, "XtwXv")
    with pytest.raises(ValueError):   # rows not 16 bytes apart
        cla_dev.chain_kernel(codes.contiguous()[:, 1:], sv, w[1:], "XtwXv")
    with pytest.raises(TypeError):
        cla_dev.chain_kernel(codes, sv, w.double(), "XtwXv")
    with pytest.raises(TypeError):
        cla_dev.chain_kernel(codes, sv.half(), None, "XtXv")
    with pytest.raises(ValueError):
        cla_dev.chain_kernel(codes, torch.zeros(9, 4, 1, device=cuda), None,
                             "XtXv")
    with pytest.raises(ValueError):
        cla_dev.chain_kernel(codes, sv, None, "XtwXv")
    with pytest.raises(ValueError):   # 9 columns: chain_mmchain chunks them
        cla_dev.chain_kernel(codes, torch.zeros(8, 4, 9, device=cuda), None,
                             "XtXv")


def _chain_masks(out, ref):
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(out), f(ref))


def _chain_same(out, ref, bar):
    """NaN and +-Inf in the same slots, the finite slots within `bar`
    normwise."""
    _chain_masks(out, ref)
    fin = torch.isfinite(ref)
    den = torch.linalg.norm(ref[fin])
    err = torch.linalg.norm(out[fin] - ref[fin]) / (den if den > 0 else 1.0)
    assert float(err) <= bar


def _chain_tree(codes, sv, w, ctype):
    """chain_plain's function with each histogram slot summed by a tree
    reduction (torch.sum of the slot's rows) instead of index_add_'s
    atomics in device memory, which add a slot's rows in an arbitrary
    order: over 1e5 rows of one slot (dmax = 1) that order's rounding
    reaches 1e-12 of a cancelling sum, the fp64 bar itself."""
    G = codes.shape[0]
    dmax = sv.shape[0]
    svd = sv.double()
    xv = sum(svd[:, g, :].index_select(0, codes[g].long()) for g in range(G))
    z = xv if ctype == "XtXv" else (
        w.double() * xv if ctype == "XtwXv" else xv - w.double())
    return torch.stack([torch.stack([z[codes[g] == j].sum(0)
                                     for g in range(G)])
                        for j in range(dmax)])


def _chain_check(codes, sv, w, ctype, dtype):
    """K6 twice: bit-identical, NaN and +-Inf where chain_plain has them,
    within the bar of _chain_tree."""
    from systemml_tpu_torch.compress import device as cla_dev

    before = cla_dev.chain_kernel.launches
    out = cla_dev.chain_kernel(codes, sv, w, ctype)
    again = cla_dev.chain_kernel(codes, sv, w, ctype)
    plain = cla_dev.chain_plain(codes, sv.double(),
                                None if w is None else w.double(), ctype)
    ref = _chain_tree(codes, sv, w, ctype)
    torch.cuda.synchronize()
    assert cla_dev.chain_kernel.launches == before + 2
    assert out.dtype == torch.float64 and out.shape == plain.shape
    assert torch.equal(out.nan_to_num(), again.nan_to_num())
    _chain_masks(out, plain)
    _chain_same(out, ref, CHAIN_BARS[dtype])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dmax", [1, 8])
@pytest.mark.parametrize("n", [1, 15, 255, 257, 100_003, 135_169])
def test_cla_chain_ragged_rows(cuda, dtype, dmax, n):
    """Every chain type, k = 1 and 4, at row counts around the tiles: the
    ragged last tile and the padding past n are never counted; at 132 *
    1024 + 1 rows the last blocks of a 132-block grid have no rows (each
    block takes an equal share in 64-row blocks)."""
    for ctype, k, wc in (("XtXv", 1, 0), ("XtXv", 4, 0), ("XtwXv", 1, 1),
                         ("XtwXv", 4, 1), ("XtXvy", 1, 1), ("XtXvy", 4, 4)):
        _chain_check(*_chain_inputs(cuda, dmax, 68, n, k, wc, dtype, seed=n),
                     ctype, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 4])
def test_cla_chain_one_code_per_group(cuda, dtype, k):
    """Every row of a group on one code (the integer atomics' worst case:
    a warp's lanes each hit one slot for all of the tile's rows), beside
    groups of uniform codes."""
    codes, sv, w = _chain_inputs(cuda, 8, 68, 100_003, k, k, dtype, seed=9)
    codes[::2] = torch.arange(34, device=cuda, dtype=torch.uint8)[:, None] % 8
    for ctype in ("XtXv", "XtXvy"):
        _chain_check(codes, sv, None if ctype == "XtXv" else w, ctype, dtype)


def _chain_rounding(codes, sv, w):
    """Per slot of XtwXv, a bound on K6's fp32 rounding (csrc/cla_chain.cu,
    "Rounding"), summed over the slot's rows: z's own, G + 2 units of
    2^-24 of the row's sum of |terms| times |w|, and the rounding of z
    against its tile's largest |z|, at most 2^-22 of it. A tile starts at a
    multiple of 64 rows and spans at most 1024, so that largest |z| is at
    most the largest over the 31 64-row blocks around the row's."""
    G, n = codes.shape
    dmax = sv.shape[0]
    svd = sv.double()
    idx = [codes[g].long() for g in range(G)]
    xv = sum(svd[:, g, :].index_select(0, idx[g]) for g in range(G))
    mag = sum(svd[:, g, :].abs().index_select(0, idx[g]) for g in range(G))
    wd = w.double()
    z = (wd * xv).abs()
    k = z.shape[1]
    blocks = torch.nn.functional.pad(z.T, (0, -n % 64)).view(k, -1, 64)
    near = torch.nn.functional.max_pool1d(
        blocks.amax(2)[None], 31, stride=1, padding=15)[0]
    near = near.repeat_interleave(64, dim=1)[:, :n].T
    row = 2.0 ** -22 * near + (G + 2) * 2.0 ** -24 * wd.abs() * mag
    return torch.stack([
        torch.zeros((dmax, k), dtype=torch.float64, device=z.device)
        .index_add_(0, idx[g], row) for g in range(G)], dim=1)


@pytest.mark.parametrize("k", [1, 4])
def test_cla_chain_heavy_tailed_z(cuda, k):
    """z from 1e-6 to 1e6 within one tile (w log-uniform over 12 decades):
    the tile's scale drops the low bits of the small z. The fp32 bar
    normwise; every slot within its rounding bound (_chain_rounding); and
    the slots at least 1e3 times their bound (here a fifth or more of
    them), within the fp32 bar each."""
    codes, sv, _ = _chain_inputs(cuda, 8, 68, 100_003, k, 0, torch.float32,
                                 seed=10)
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.choice([-1.0, 1.0], (100_003, 1))
                         * 10.0 ** rng.uniform(-6, 6, (100_003, 1)))
    w = w.to(cuda, torch.float32)
    out = _chain_check(codes, sv, w, "XtwXv", torch.float32)
    ref = _chain_tree(codes, sv, w, "XtwXv")
    bound = _chain_rounding(codes, sv, w)
    err = (out - ref).abs()
    assert bool((err <= bound).all())
    well = ref.abs() >= 1e3 * bound
    assert int(well.sum()) >= 0.1 * ref.numel()
    assert float((err[well] / ref[well].abs()).max()) <= \
        CHAIN_BARS[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ctype", ["XtwXv", "XtXvy"])
def test_cla_chain_non_finite_rows(cuda, dtype, ctype):
    """NaN, +Inf and -Inf rows in w or y: NaN and Inf in the slots where
    chain_plain has them (a tile with one takes the kernel's fp64 branch);
    the finite slots within the bar."""
    from systemml_tpu_torch.compress import device as cla_dev

    for k, wc in ((1, 1), (4, 1), (4, 4)):
        codes, sv, w = _chain_inputs(cuda, 8, 68, 100_003, k, wc, dtype,
                                     seed=12)
        w[5, 0] = float("nan")          # tile 0
        w[2_000, 0] = float("inf")      # tile 1
        w[40_000, 0] = float("inf")     # one tile: +Inf beside -Inf
        w[40_001, 0] = float("-inf")
        w[99_999, wc - 1] = float("-inf")  # the last tile
        out = _chain_check(codes, sv, w, ctype, dtype)
        assert bool(torch.isnan(out).any()) and bool(
            torch.isfinite(out).any())
        # a NaN in the table: every slot of its group's rows is NaN
        sv2 = sv.clone()
        sv2[0, 3, 0] = float("nan")
        _chain_check(codes, sv2, w, ctype, dtype)
    assert cla_dev.chain_kernel.launches > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cla_chain_repeats_bit_identical(cuda, dtype):
    """100 launches, and launches on two streams at once, give the same
    bits."""
    from systemml_tpu_torch.compress import device as cla_dev

    codes, sv, w = _chain_inputs(cuda, 8, 68, 300_007, 1, 1, dtype, seed=13)
    first = cla_dev.chain_kernel(codes, sv, w, "XtXvy")
    outs = [cla_dev.chain_kernel(codes, sv, w, "XtXvy") for _ in range(100)]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        a = [cla_dev.chain_kernel(codes, sv, w, "XtXvy") for _ in range(5)]
    with torch.cuda.stream(s2):
        b = [cla_dev.chain_kernel(codes, sv, w, "XtXvy") for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for o in outs + a + b)


def test_cla_chain_plan_matches_the_kernel(cuda):
    """The wrapper's estimate of a block's least shared memory
    (chain_smem_bytes, which chain_supported reads without a build)
    accepts exactly the shapes the built kernel accepts
    (smtorch_cla_chain_smem), and equals the kernel's bytes where the
    kernel takes its smallest tile (fp32: 64 rows; fp64: always)."""
    from systemml_tpu_torch.compress import device as cla_dev

    smallest = 0
    for dtype in (torch.float32, torch.float64):
        for dmax in (1, 3, 8):
            for groups in (1, 31, 32, 33, 68, 200, 330, 450, 800):
                for k in range(1, 9):
                    est = cla_dev.chain_smem_bytes(dmax, groups, k, dtype)
                    tile, smem = cla_dev.chain_kernel_plan(dmax, groups, k,
                                                           dtype)
                    at = (dtype, dmax, groups, k)
                    assert (est <= cla_dev.CHAIN_MAX_SMEM) == (tile > 0), at
                    if not tile:
                        assert smem == 0, at
                    elif dtype == torch.float64 or tile == 64:
                        assert smem == est, at
                        smallest += tile == 64
                    else:
                        assert est < smem <= cla_dev.CHAIN_MAX_SMEM, at
    assert smallest > 0
    assert cla_dev.chain_kernel_plan(9, 4, 1, torch.float32) == (0, 0)
    assert cla_dev.chain_kernel_plan(8, 4, 9, torch.float32) == (0, 0)
    # the Census shape takes the largest tile
    assert cla_dev.chain_kernel_plan(8, 68, 1, torch.float32)[0] == 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cla_mmchain_wide_v_through_the_kernel(cuda, dtype):
    """k = 12 on the card: the compressed mmchain launches K6 twice (v's
    columns 8 and 4), and agrees with the dense product."""
    from systemml_tpu_torch.compress import compress
    from systemml_tpu_torch.compress import device as cla_dev

    rng = np.random.default_rng(14)
    n = 20_011
    x = np.column_stack([rng.standard_normal(d)[rng.integers(0, d, n)]
                         for d in (2, 5, 8, 3, 7)])
    npd = np.float32 if dtype == torch.float32 else np.float64
    c = compress(x.astype(npd))
    v = torch.from_numpy(rng.standard_normal((5, 12)).astype(npd)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((n, 12)).astype(npd)).to(cuda)
    assert cla_dev.chain_supported(c, 12, dtype)
    st = stats.Statistics()
    before = cla_dev.chain_kernel.launches
    with stats.stats_scope(st):
        out = mult.mmchain(c, v, y, "XtXvy")
    torch.cuda.synchronize()
    assert cla_dev.chain_kernel.launches == before + 2
    assert st.estim_counts.get("cla_chain_plain_by_layout", 0) == 0
    xd = torch.from_numpy(x.astype(npd)).to(cuda).double()
    ref = xd.T @ (xd @ v.double() - y.double())
    err = torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref)
    assert out.dtype == dtype and out.shape == (5, 12)
    assert float(err) <= CHAIN_BARS[dtype]


# ---- K5: the outer-product template ---------------------------------------

OUTER_PLANS = {
    # ALS-CG's loss plan sum((X * UV)^2)
    "als_loss": _n("b(^)", _n("b(*)", _in("X"), _in("UV")), _lit(2.0)),
    "wsloss": _n("b(*)", _in("X"), _n("b(^)", _n("b(-)", _in("X"),
                                                 _in("UV")), _lit(2.0))),
    # a host number a and a 0-d tensor b beside X and UV
    "scalars": _n("b(*)", _n("b(-)", _in("X"), _n("b(*)", _in("a"),
                                                  _in("UV"))),
                  _n("u(exp)", _n("b(min)", _in("UV"), _in("b")))),
}


def _outer_inputs(dev, dtype, m, n, r, seed=11, nan=False):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev, dtype)
    x = np.where(rng.random((m, n)) < 0.3,
                 np.round(rng.uniform(0.5, 5.0, (m, n)) * 2) / 2, 0.0)
    if nan:
        x[m // 2, n // 3] = np.nan
    extra = {"a": 0.5, "b": torch.tensor(0.75, device=dev,
                                         dtype=torch.float64)}
    return (t(x), t(rng.standard_normal((m, r)) / np.sqrt(max(r, 1))),
            t(rng.standard_normal((n, r))), extra)


def _outer_check(plan, x, u, v, extra, dtype):
    before = kernels.outer_kernel.launches
    out = kernels.outer_kernel(plan, x, u, v, extra)
    again = kernels.outer_kernel(plan, x, u, v, extra)
    ref = kernels.outer_plain(plan, x.double(), u.double(), v.double(),
                              _double(extra))
    torch.cuda.synchronize()
    assert kernels.outer_kernel.launches == before + 2
    assert out.shape == () and out.dtype == dtype
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.nan_to_num(0.0), again.nan_to_num(0.0))
    if not bool(ref.isnan()):
        err = abs(float(out) - float(ref)) / abs(float(ref))
        assert err <= (1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(OUTER_PLANS))
@pytest.mark.parametrize("m,n,r", [(1037, 777, 10), (100_003, 77, 3),
                                   (64, 256, 16), (65, 300, 1),
                                   (130, 50, 32), (7, 1, 5)])
def test_outer_matches_plain(cuda, dtype, case, m, n, r):
    """Row tiles of 64 (ragged and exact), column chunks of 256, every
    rank bucket (4, 8, 16, 32); repeats bit-identical."""
    x, u, v, extra = _outer_inputs(cuda, dtype, m, n, r)
    _outer_check(OUTER_PLANS[case], x, u, v, extra, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_outer_nan_in_x(cuda, dtype):
    x, u, v, extra = _outer_inputs(cuda, dtype, 1037, 300, 10, nan=True)
    for plan in OUTER_PLANS.values():
        _outer_check(plan, x, u, v, extra, dtype)


def test_outer_reads_views_in_place(cuda):
    """X a column slice, U a column slice of a wider matrix, V a
    transposed view: the kernel reads each by its strides."""
    x, u, v, extra = _outer_inputs(cuda, torch.float32, 2000, 600, 12)
    xs = x[:, 5:505]
    uw = torch.cat([u, u[:, :3]], dim=1)[:, :12]
    vt = v[5:505].T.contiguous().T
    assert vt.stride() == (1, 500) and uw.stride(0) == 15
    _outer_check(OUTER_PLANS["wsloss"], xs, uw, vt, extra, torch.float32)


def test_outer_wide_rank_takes_plain_arm(cuda):
    x, u, v, extra = _outer_inputs(cuda, torch.float32, 300, 40, 33)
    st = stats.Statistics()
    before = kernels.outer_kernel.launches
    with stats.stats_scope(st):
        out = kernels.outer_kernel(OUTER_PLANS["als_loss"], x, u, v, extra)
    ref = kernels.outer_plain(OUTER_PLANS["als_loss"], x, u, v, extra)
    assert kernels.outer_kernel.launches == before
    assert st.estim_counts["spoof_plain_by_layout"] == 1
    assert torch.equal(out, ref)


@pytest.mark.parametrize("m,n", [(0, 7), (9, 0)])
def test_outer_empty_x_launches(cuda, m, n):
    x, u, v, extra = _outer_inputs(cuda, torch.float32, m, n, 4)
    before = kernels.outer_kernel.launches
    out = kernels.outer_kernel(OUTER_PLANS["wsloss"], x, u, v, extra)
    assert kernels.outer_kernel.launches == before + 1
    assert float(out) == 0.0


def test_outer_refuses_what_the_kernel_does_not_take(cuda):
    x, u, v, extra = _outer_inputs(cuda, torch.float32, 30, 20, 4)
    with pytest.raises(TypeError):
        kernels.outer_kernel(OUTER_PLANS["als_loss"], x.half(), u, v, extra)
    with pytest.raises(ValueError):
        kernels.outer_kernel(OUTER_PLANS["als_loss"], x, u, v.T, extra)


# ---- K3: the multi-aggregate template -------------------------------------

MAGG_ORDERS = [["sum", "min", "max"], ["max", "sum"], ["min"],
               ["min", "min", "sum", "max", "sum", "max", "min", "sum"]]


def _magg_check(plan, names, aggs, env, dtype):
    """min and max at the bar relative to the plain version's value; a sum
    relative to the sum of the summands' magnitudes (a sum may cancel to
    near 0: the ratings summary's does)."""
    before = kernels.multiagg_kernel.launches
    out = kernels.multiagg_kernel(plan, names, aggs, env)
    again = kernels.multiagg_kernel(plan, names, aggs, env)
    ref = kernels.multiagg_plain(plan, names, aggs, _double(env))
    scale = float(kernels._plain_value(plan, names, _double(env)).abs()
                  .nansum())
    torch.cuda.synchronize()
    assert kernels.multiagg_kernel.launches == before + 2
    assert len(out) == len(ref) == len(aggs)
    for o, a, r, agg in zip(out, again, ref, aggs):
        assert o.shape == () and o.dtype == dtype
        assert bool(o.isnan()) == bool(r.isnan())
        assert torch.equal(o.nan_to_num(0.0), a.nan_to_num(0.0))
        if not bool(r.isnan()):
            den = scale if agg == "sum" else abs(float(r))
            err = abs(float(o) - float(r)) / max(den, 1e-300)
            assert err <= (1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("aggs", MAGG_ORDERS)
@pytest.mark.parametrize("m,n", [(1037, 7), (100_003, 1), (33, 300),
                                 (2049, 1000)])
@pytest.mark.parametrize("nan", [False, True])
def test_multiagg_matches_plain(cuda, dtype, aggs, m, n, nan):
    """SPOOF_PLAN's every layout (host number, 0-d tensor, (1, n), (m, 1),
    (1, 1)), every aggregate order with repeats, NaN in the main leaf."""
    env = _spoof_env(cuda, dtype, m, n, nan=nan)
    _magg_check(SPOOF_PLAN, SPOOF_NAMES, aggs, env, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_multiagg_ratings_summary_plan(cuda, dtype):
    """The ratings summary's plan (V != 0) * (V - s / c), V read twice,
    two 0-d sums."""
    plan = _n("b(*)", _n("b(!=)", _in("i0"), _lit(0.0)),
              _n("b(-)", _in("i1"), _n("b(/)", _in("i2"), _in("i3"))))
    x, _, _, _ = _outer_inputs(cuda, dtype, 10_007, 301, 1)
    env = {"i0": x, "i1": x, "i2": x.sum(), "i3": (x != 0).sum().to(dtype)}
    _magg_check(plan, ["i0", "i1", "i2", "i3"], ["sum", "min", "max"], env,
                dtype)


def test_multiagg_empty_main_leaf(cuda):
    env = _spoof_env(cuda, torch.float32, 0, 7)
    before = kernels.multiagg_kernel.launches
    (s,) = kernels.multiagg_kernel(SPOOF_PLAN, SPOOF_NAMES, ["sum"], env)
    assert kernels.multiagg_kernel.launches == before + 1
    assert float(s) == 0.0
    with pytest.raises(ValueError):
        kernels.multiagg_kernel(SPOOF_PLAN, SPOOF_NAMES, ["sum", "max"], env)


def test_optlevel3_als_and_summary_launch_k5_and_k3(cuda):
    """ALS-CG at optlevel 3 on the card launches K5 once per outer
    iteration and agrees with optlevel 2 (the dense wdivmm arm); the
    ratings summary launches K3 once and agrees with optlevel 2."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml, dmlFromFile
    from systemml_tpu_torch.utils.config import DMLConfig

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    x, _, _, _ = _outer_inputs(cuda, torch.float32, 3000, 400, 1)
    summary = ("mu = sum(V) / sum(V != 0)\nZ = (V != 0) * (V - mu)\n"
               "s = sum(Z)\nlo = min(Z)\nhi = max(Z)")
    res = {}
    for optlevel in (3, 2):
        cfg = DMLConfig()
        cfg.optlevel = optlevel
        ml = MLContext(cfg)
        lines = []
        ml.printer = lines.append
        k5, k3 = kernels.outer_kernel.launches, kernels.multiagg_kernel.launches
        out = ml.execute(
            dmlFromFile(os.path.join(root, "scripts", "algorithms",
                                     "ALS-CG.dml"))
            .input("V", x).arg("rank", 10).arg("maxi", 4).arg("mii", 3)
            .output("L", "R"))
        iters = int(lines[-1].split("iterations = ")[1].split(",")[0])
        summ = ml.execute(dml(summary).input("V", x).output("s", "lo", "hi"))
        torch.cuda.synchronize()
        launched = (kernels.outer_kernel.launches - k5,
                    kernels.multiagg_kernel.launches - k3)
        assert launched == ((iters, 1) if optlevel == 3 else (0, 0))
        res[optlevel] = (out.get_tensor("L").double(),
                         [float(summ.get(k)) for k in ("s", "lo", "hi")])
    a, b = res[3][0], res[2][0]
    assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-3
    zsum = float(((x != 0) * (x - x.sum() / (x != 0).sum())).abs().sum())
    (s3, lo3, hi3), (s2, lo2, hi2) = res[3][1], res[2][1]
    assert abs(s3 - s2) <= 1e-6 * zsum
    assert abs(lo3 - lo2) <= 1e-5 * abs(lo2) and abs(hi3 - hi2) <= 1e-5 * abs(hi2)


# ---- K2 and K3: the flat and general walks (csrc/spoof.cuh) ---------------

# leaves a, b, c read per cell, s a host number, t a 0-d tensor; NaN in a
# reaches the value through max and the products
WALK_PLAN = _n("b(+)",
               _n("b(*)", _n("b(-)", _in("a"), _in("s")),
                  _n("b(max)", _in("b"), _in("a"))),
               _n("b(*)", _in("t"),
                  _n("u(exp)", _n("b(*)", _lit(0.1), _in("c")))))
WALK_NAMES = ["a", "s", "b", "c", "t"]


def _walk_env(dev, dtype, m, n, walk, alias=False, seed=17):
    """WALK_PLAN's leaves: contiguous (the flat walk) or each a column
    block of a wider matrix starting one element in (the general walk:
    neither contiguous, when m > 1, nor 16-byte aligned); b the same
    tensor as a when `alias`."""
    rng = np.random.default_rng(seed)

    def mat():
        t = torch.from_numpy(rng.standard_normal((m, n))).to(dev, dtype)
        if walk == "flat":
            return t
        wide = torch.zeros((m, n + 2), device=dev, dtype=dtype)
        wide[:, 1:n + 1] = t
        return wide[:, 1:n + 1]

    a = mat()
    return {"a": a, "b": a if alias else mat(), "c": mat(), "s": 0.25,
            "t": torch.tensor(-0.5, device=dev, dtype=torch.float64)}


def _walks(st):
    return {w: st.estim_counts.get(f"spoof_{w}_walk", 0)
            for w in ("flat", "general")}


def _walk_check(env, walk, dtype, aggs=("sum", "min", "max")):
    """Cell map, cell sum and the multi-aggregate against the plain
    version in fp64; each launch on `walk` (counted in the statistics)."""
    st = stats.Statistics()
    with stats.stats_scope(st):
        _walk_launches(env, dtype, aggs)
    assert _walks(st) == {"flat": 6 if walk == "flat" else 0,
                          "general": 6 if walk == "general" else 0}


def _walk_launches(env, dtype, aggs):
    """Two launches each of the cell map, the cell sum and the
    multi-aggregate, each against its plain version."""
    out = kernels.cell_kernel(WALK_PLAN, WALK_NAMES, None, env)
    again = kernels.cell_kernel(WALK_PLAN, WALK_NAMES, None, env)
    _spoof_check(out, again, kernels.cell_plain(WALK_PLAN, WALK_NAMES, None,
                                                _double(env)), dtype)
    total = kernels.cell_kernel(WALK_PLAN, WALK_NAMES, "sum", env)
    again = kernels.cell_kernel(WALK_PLAN, WALK_NAMES, "sum", env)
    ref = kernels.cell_plain(WALK_PLAN, WALK_NAMES, "sum", _double(env))
    scale = float(kernels._plain_value(WALK_PLAN, WALK_NAMES, _double(env))
                  .abs().nansum())
    torch.cuda.synchronize()
    assert total.shape == () and total.dtype == dtype
    assert torch.equal(total.nan_to_num(0.0), again.nan_to_num(0.0))
    assert bool(total.isnan()) == bool(ref.isnan())
    if not bool(ref.isnan()):
        assert abs(float(total) - float(ref)) <= \
            (1e-5 if dtype == torch.float32 else 1e-12) * max(scale, 1e-300)
    _magg_check(WALK_PLAN, WALK_NAMES, list(aggs), env, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("walk", ["flat", "general"])
@pytest.mark.parametrize("m,n", [(1, 3), (3, 1), (1, 1), (1037, 7),
                                 (2049, 5), (100_003, 1), (33, 300)])
@pytest.mark.parametrize("alias", [False, True])
def test_walks_match_plain(cuda, dtype, walk, m, n, alias):
    """Fewer cells than one vector, m n not a multiple of the vector
    width (a ragged tail), whole vectors; aliased leaves."""
    _walk_check(_walk_env(cuda, dtype, m, n, walk, alias), walk, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_leaf_at_an_offset_takes_scalar_loads(cuda, dtype):
    """A leaf that starts one element into its buffer (4 or 8 bytes: not
    16-byte aligned) sends the launch to the general walk."""
    env = _walk_env(cuda, dtype, 1037, 7, "flat")
    buf = torch.empty(1037 * 7 + 1, device=cuda, dtype=dtype)
    buf[1:] = env["c"].reshape(-1)
    env["c"] = buf[1:].view(1037, 7)
    assert env["c"].is_contiguous() and env["c"].data_ptr() % 16 != 0
    _walk_check(env, "general", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("walk", ["flat", "general"])
@pytest.mark.parametrize("where", ["tail", "body"])
def test_nan_reaches_min_and_max(cuda, dtype, walk, where):
    """NaN in the last cell (the flat walk's scalar tail: 1037 x 7 is not
    a multiple of 4) or inside a vector, through min, max and sum."""
    env = _walk_env(cuda, dtype, 1037, 7, walk)
    if where == "tail":
        env["a"][-1, -1] = float("nan")
    else:
        env["a"][500, 3] = float("nan")
    _walk_check(env, walk, dtype)
    out = kernels.multiagg_kernel(WALK_PLAN, WALK_NAMES, ["min", "max"], env)
    assert all(bool(o.isnan()) for o in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("walk", ["flat", "general"])
@pytest.mark.parametrize("aggs", MAGG_ORDERS)
def test_walks_every_aggregate_order(cuda, dtype, walk, aggs):
    env = _walk_env(cuda, dtype, 2049, 5, walk, alias=True)
    st = stats.Statistics()
    with stats.stats_scope(st):
        _magg_check(WALK_PLAN, WALK_NAMES, aggs, env, dtype)
    assert _walks(st)[walk] == 2


@pytest.mark.parametrize("walk", ["flat", "general"])
def test_hundred_launches_are_bit_identical(cuda, walk):
    """One launch per reduction: the last block resets the ticket, so 100
    back-to-back launches on one stream give the same bits."""
    env = _walk_env(cuda, torch.float32, 100_003, 7, walk)
    sums = [kernels.cell_kernel(WALK_PLAN, WALK_NAMES, "sum", env)
            for _ in range(100)]
    aggs = [torch.stack(kernels.multiagg_kernel(
        WALK_PLAN, WALK_NAMES, ["sum", "min", "max"], env))
        for _ in range(100)]
    torch.cuda.synchronize()
    assert all(torch.equal(s, sums[0]) for s in sums)
    assert all(torch.equal(a, aggs[0]) for a in aggs)


def test_two_streams_keep_their_own_tickets(cuda):
    """Launches on two streams at once (each with its own partials and
    ticket) give what a launch on the default stream gives."""
    env = _walk_env(cuda, torch.float32, 1_000_003, 5, "flat")
    want = torch.stack(kernels.multiagg_kernel(WALK_PLAN, WALK_NAMES,
                                               ["sum", "min", "max"], env))
    want_sum = kernels.cell_kernel(WALK_PLAN, WALK_NAMES, "sum", env)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = {0: [], 1: []}
    for _ in range(20):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[k].append((torch.stack(kernels.multiagg_kernel(
                    WALK_PLAN, WALK_NAMES, ["sum", "min", "max"], env)),
                    kernels.cell_kernel(WALK_PLAN, WALK_NAMES, "sum", env)))
    torch.cuda.synchronize()
    for k in got:
        for a, s in got[k]:
            assert torch.equal(a, want) and torch.equal(s, want_sum)
    keys = {key for key in kernels._scratch if key[0] == cuda.index or
            key[0] == torch.cuda.current_device()}
    assert {s.cuda_stream for s in streams} <= {key[1] for key in keys}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("walk", ["flat", "general"])
@pytest.mark.parametrize("n_aggs", [9, 12])
def test_multiagg_many_aggregates_launch_the_kernel(cuda, dtype, walk,
                                                    n_aggs):
    """The aggregates are a template pack of any length: 9 or 12 of them
    launch the kernel on either walk, against multiagg_plain, and none
    takes the plain arm."""
    env = _walk_env(cuda, dtype, 1037, 7, walk)
    if n_aggs == 12:
        env["a"][500, 3] = float("nan")
    aggs = (["max", "sum", "min"] * 4)[:n_aggs]
    st = stats.Statistics()
    with stats.stats_scope(st):
        _magg_check(WALK_PLAN, WALK_NAMES, aggs, env, dtype)
    assert _walks(st)[walk] == 2
    assert st.estim_counts.get("spoof_plain_by_layout", 0) == 0


@pytest.mark.parametrize("walk", ["flat", "general"])
def test_memoised_launch_follows_new_values(cuda, walk):
    """A second launch on the same tensors reuses the first's prepared
    arguments, yet reads a new host number and the tensors' new contents."""
    env = _walk_env(cuda, torch.float32, 1037, 7, walk)
    env["t"] = env["t"].float()     # a cast leaf is not memoised
    for s, scale in ((0.25, 1.0), (0.5, 1.0), (0.5, -2.0)):
        env["s"] = s
        env["c"].mul_(scale)
        total = kernels.cell_kernel(WALK_PLAN, WALK_NAMES, "sum", env)
        ref = kernels.cell_plain(WALK_PLAN, WALK_NAMES, "sum", _double(env))
        scale_sum = float(kernels._plain_value(
            WALK_PLAN, WALK_NAMES, _double(env)).abs().sum())
        assert abs(float(total) - float(ref)) <= 1e-5 * scale_sum
    assert len(WALK_PLAN.__dict__["_spoof_prepared"]) >= 1


# --------------------------------------------------------------------------
# fused loop regions: one CUDA graph per loop, WHILE and IF nodes
# (runtime/loopfuse.py, codegen/csrc/loop_graph.cu), against the region
# executor's plain arm on the CPU; `-k region` runs these alone
# --------------------------------------------------------------------------

def _region_run(src, device, inputs=None, outputs=(), codegen=True):
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    cfg = DMLConfig(device=device)
    cfg.floating_point_precision = "double"
    cfg.codegen_enabled = codegen
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    s = dml(src)
    for k, v in (inputs or {}).items():
        s.input(k, v)
    return ml.execute(s.output(*outputs)), ml


def _region_values(res, outs):
    out = []
    for o in outs:
        v = res.get(o)
        out.append(np.asarray(res.get_matrix(o), dtype=np.float64)
                   if isinstance(v, torch.Tensor) and v.ndim else
                   np.asarray(float(res.get_scalar(o))))
    return out


def _region_program(src, input_names, outputs):
    from systemml_tpu_torch.lang.parser import parse
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    cfg = DMLConfig()
    cfg.floating_point_precision = "double"
    set_config(cfg)
    try:
        return compile_program(parse(src), input_names=input_names,
                               outputs=outputs)
    finally:
        set_config(DMLConfig())


def _region_exec(prog, inputs):
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    cfg = DMLConfig()
    cfg.floating_point_precision = "double"
    set_config(cfg)
    try:
        return prog.execute(inputs)
    finally:
        set_config(DMLConfig())


def _top_loop(prog):
    from systemml_tpu_torch.runtime import program as P

    return [b for b in prog.blocks
            if isinstance(b, (P.WhileBlock, P.ForBlock))][0]


REGION_X = np.arange(1.0, 7.0).reshape(3, 2) / 7.0
REGION_SCRIPTS = {
    "zero_trips": ("x = 5\ni = 0\nwhile (x < 0) { x = x - 1\ni = i + 1 }\n",
                   ["x", "i"]),
    "one_trip": ("x = 5\ni = 0\nwhile (x > 4) { x = x - 1\ni = i + 1 }\n",
                 ["x", "i"]),
    "many_trips": ("""
i = 0
A = X
while (i < 40) {
  A = A * 1.01 + 0.5
  i = i + 1
}
""", ["A", "i"]),
    "nested": ("""
outer = 0
total = X
while (outer < 4) {
  inner = 0
  acc = 0.0
  while (inner < outer + 2) {
    if (inner - 2 * floor(inner / 2) == 0) {
      acc = acc + inner + 1
    } else {
      acc = acc - 0.5
    }
    inner = inner + 1
  }
  for (j in 1:3) {
    total = total + acc * j
  }
  outer = outer + 1
}
""", ["total", "outer", "j"]),
    "zero_trip_inner_local": ("""
i = 0
s = 0
while (i < 3) {
  k = i
  while (k < 1) {
    t = k + 5
    k = k + 1
  }
  s = s + t
  i = i + 1
}
""", ["s"]),
}


@pytest.mark.parametrize("case", sorted(REGION_SCRIPTS))
def test_region_graph_matches_plain_arm(cuda, case):
    src, outs = REGION_SCRIPTS[case]
    got, _ = _region_run(src, "cuda", {"X": REGION_X}, outs)
    ref, _ = _region_run(src, "cpu", {"X": REGION_X}, outs)
    eager, _ = _region_run(src, "cpu", {"X": REGION_X}, outs, codegen=False)
    for a, b, c in zip(_region_values(got, outs), _region_values(ref, outs),
                       _region_values(eager, outs)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        if case != "zero_trip_inner_local":     # eager: t is stale there
            np.testing.assert_allclose(a, c, rtol=1e-12, atol=1e-12)


def test_region_one_capture_across_traced_int_reentry(cuda):
    """Another value of a traced int (maxi) reuses the graph: one capture,
    three launches, the first and last runs bit-identical; another X at
    the same shape is a new capture."""
    src = """
w = matrix(0, rows=ncol(X), cols=1)
i = 0
while (i < maxi) {
  w = w + 0.001 * (t(X) %*% (X %*% w + 1))
  i = i + 1
}
r = sum(w)
"""
    prog = _region_program(src, ["X", "maxi"], ["r"])
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((256, 8))).to(cuda)
    rs = [_region_exec(prog, {"X": x, "maxi": m}).vars["r"]
          for m in (5, 9, 5)]
    fl = _top_loop(prog)._fused_loop
    assert fl.record["captures"] == 1 and fl.record["launches"] == 3
    assert fl.record["trips"] == [5, 9, 5]
    assert torch.equal(rs[0], rs[2])
    x2 = torch.from_numpy(rng.standard_normal((256, 8))).to(cuda)
    _region_exec(prog, {"X": x2, "maxi": 5})
    assert fl.record["captures"] == 2


def test_region_launch_accounting_equals_eager(cuda):
    """The kernel launches of a captured loop (each body's count scaled by
    its executions) equal the eager run's, and so do the statistics'
    counts of executed blocks and walks."""
    from systemml_tpu_torch.runtime import loopfuse

    rng = np.random.default_rng(11)
    x = rng.standard_normal((4096, 128)).astype(np.float32)
    y = x @ rng.standard_normal((128, 1)).astype(np.float32)
    src = """
w = matrix(0, rows=ncol(X), cols=1)
r = -(t(X) %*% y)
p = -r
nr = sum(r^2)
i = 0
while (i < 12 & nr > 1e-10) {
  q = t(X) %*% (X %*% p)
  a = nr / sum(p * q)
  w = w + a * p
  r = r + a * q
  old = nr
  nr = sum(r^2)
  if (nr < old) {
    p = -r + (nr / old) * p
  } else {
    p = -r
  }
  i = i + 1
}
"""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    counts = {}
    for codegen in (True, False):
        cfg = DMLConfig()
        cfg.optlevel = 3
        cfg.codegen_enabled = codegen
        for f in loopfuse.launch_counters().values():
            f.launches = 0
        ml = MLContext(cfg)
        res = ml.execute(dml(src).input("X", x).input("y", y).output("w"))
        torch.cuda.synchronize()
        counts[codegen] = ({k: f.launches for k, f in
                            loopfuse.launch_counters().items()
                            if k != "set_cond"},
                           # the blocks outside the loop run through the
                           # block compile either way, the body's inside
                           # the region or through it
                           ml._stats.eager_blocks + ml._stats.fused_blocks,
                           {k: v for k, v in ml._stats.estim_counts.items()
                            if k.startswith("spoof_")},
                           res.get_matrix("w"))
    assert counts[True][0] == counts[False][0]
    assert counts[True][0]["mmchain"] >= 2
    assert counts[True][1] == counts[False][1]
    assert counts[True][2] == counts[False][2]
    np.testing.assert_allclose(counts[True][3], counts[False][3],
                               rtol=1e-5, atol=1e-6)


def test_region_capture_leaves_reduce_scratch_alone(cuda):
    """A capture makes no spoof reduce scratch: the capture streams' own
    exist before it, and the eager streams' are the same tensors after."""
    from systemml_tpu_torch.runtime import loopfuse

    loopfuse.capture_streams(cuda)
    before = {k: (a.data_ptr(), b.data_ptr())
              for k, (a, b) in kernels._scratch.items()}
    src = """
i = 0
s = 0.0
while (i < 6) {
  s = s + sum(X * X + i)
  i = i + 1
}
"""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    cfg = DMLConfig()
    cfg.optlevel = 3
    x = np.random.default_rng(3).standard_normal((1000, 30))
    MLContext(cfg).execute(dml(src).input("X", x).output("s"))
    after = {k: (a.data_ptr(), b.data_ptr())
             for k, (a, b) in kernels._scratch.items()}
    assert {k: v for k, v in after.items() if k in before} == before
    stream_keys = {(cuda.index if cuda.index is not None
                    else torch.cuda.current_device(), s.cuda_stream)
                   for s in loopfuse.capture_streams(cuda)}
    assert stream_keys <= set(before)


def test_region_graph_dies_with_its_program(cuda):
    import gc

    from systemml_tpu_torch.runtime import loopfuse

    gc.collect()
    n0 = loopfuse.live_graphs()
    prog = _region_program(REGION_SCRIPTS["many_trips"][0], ["X"], ["A"])
    _region_exec(prog, {"X": torch.from_numpy(REGION_X).to(cuda)})
    assert loopfuse.live_graphs() == n0 + 1
    del prog
    assert loopfuse.live_graphs() == n0     # no cycle: refcount frees it


def _region_lines(src, device, inputs=None, outputs=(), codegen=True):
    """(results, the lines printed, MLContext) of a run in fp64."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    cfg = DMLConfig(device=device)
    cfg.floating_point_precision = "double"
    cfg.codegen_enabled = codegen
    ml = MLContext(cfg)
    lines = []
    ml.printer = lines.append
    s = dml(src)
    for k, v in (inputs or {}).items():
        s.input(k, v)
    return ml.execute(s.output(*outputs)), lines, ml


def test_region_compressed_left_mult_captures_without_sync(cuda):
    """The compressed left mult (segment sums in a fixed order, no float
    atomic, no host read) captured into a CUDA graph with sync debug mode
    "error" around capture and replays; two replays bit-identical, and
    within 1e-12 of the product on the dense X (fp64)."""
    from systemml_tpu_torch.compress import compress
    from systemml_tpu_torch.compress import device as cla_dev
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    rng = np.random.default_rng(12)
    x = rng.integers(0, 6, (200_003, 9)).astype(np.float64)
    x[:, 4] = (rng.random(200_003) < 0.97) * 2.0        # one dominant code
    set_config(DMLConfig())
    try:
        c = compress(x)
        yt = torch.from_numpy(rng.standard_normal((3, 200_003))).to(cuda)
        cla_dev._left(cla_dev.device_mirror(c), yt)       # mirror, warm-up
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.graph(g):
                out = cla_dev._left(cla_dev.device_mirror(c), yt)
            g.replay()
            first = out.clone()
            g.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        set_config(DMLConfig())
    assert torch.equal(out, first)
    ref = yt.cpu().numpy() @ x
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=1e-12,
                               atol=1e-9)


def test_region_left_mult_segments_many_codes_one_dominant(cuda):
    """The left mult's segment sums on a group of 65,536 codes over
    2,458,285 rows, 60% of them on one code, captured into a CUDA graph
    with sync debug mode "error" around the build, the capture and the
    replays: two replays bit-identical, within 1e-12 of the largest sum
    of the CPU's float64 bincount, and a layout of O(n + d) bytes."""
    from systemml_tpu_torch.compress import device as cla_dev

    n, d = 2_458_285, 65_536
    rng = np.random.default_rng(31)
    codes = rng.integers(0, d, n)
    codes[rng.random(n) < 0.6] = 123
    y = rng.standard_normal((1, n))
    ext = torch.from_numpy(np.concatenate([y, np.zeros((1, 1))], 1)).to(cuda)
    codes_dev = torch.from_numpy(codes.astype(np.int32)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        seg = cla_dev.Segments([codes_dev], [d])
        seg.sums(ext)                                     # warm-up
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = seg.sums(ext)
        g.replay()
        first = out.clone()
        g.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    ref = np.bincount(codes, weights=y[0], minlength=d)
    assert np.max(np.abs(out.cpu().numpy()[0] - ref)) <= 1e-12 * np.max(
        np.abs(ref))
    assert seg.nbytes() <= 4 * (n + 2 * cla_dev.SEGMENT_CHUNK) + 20 * d


@pytest.mark.parametrize("case", ["slice", "left_index"])
def test_region_dynamic_slice_inside_a_graph(cuda, case):
    """X[beg:beg+bs-1,] and R[beg:endb,] = ... at a device offset inside
    one captured graph, equal to the plain arm on the CPU."""
    src = {"slice": """
acc = matrix(0, rows=1, cols=ncol(X))
bs = 8
for (i in 1:4) {
  beg = (i-1)*bs + 1
  Xb = X[beg:(beg+bs-1),]
  acc = acc + colSums(Xb) * i
}
""", "left_index": """
R = matrix(0, rows=nrow(X), cols=ncol(X))
bs = 8
for (i in 1:4) {
  beg = (i-1)*bs + 1
  endb = beg + bs - 1
  R[beg:endb,] = X[beg:endb,] * i
}
"""}[case]
    out = "acc" if case == "slice" else "R"
    x = np.random.default_rng(17).normal(size=(32, 6))
    got, _, ml = _region_lines(src, "cuda", {"X": x}, [out])
    ref, _, _ = _region_lines(src, "cpu", {"X": x}, [out])
    assert ml._stats.estim_counts.get("loop_regions_refused", 0) == 0
    np.testing.assert_allclose(_region_values(got, [out])[0],
                               _region_values(ref, [out])[0],
                               rtol=1e-12, atol=1e-12)
    assert sum(ml._stats.region_counts.values()) == 1


def test_region_loop_varying_seed_equals_cpu_bits(cuda):
    """rand(seed=42 + i) in a captured for loop: each iteration's key from
    the device loop variable; the draws equal the CPU's bit for bit, in
    fp32 and fp64."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    src = """
D = matrix(0, rows=20, cols=3)
for (i in 1:5) {
  beg = (i-1)*4 + 1
  D[beg:(beg+3),] = rand(rows=4, cols=3, min=-1, max=2, sparsity=0.7,
                         seed=42 + i)
}
"""
    for prec in ("single", "double"):
        outs = {}
        for device in ("cuda", "cpu"):
            cfg = DMLConfig(device=device)
            cfg.floating_point_precision = prec
            ml = MLContext(cfg)
            outs[device] = ml.execute(dml(src).output("D")).get_tensor(
                "D").cpu()
            assert ml._stats.estim_counts.get("loop_regions_refused", 0) == 0
        assert torch.equal(outs["cuda"], outs["cpu"])


def test_region_print_ring_drains_and_relaunches(cuda, monkeypatch):
    """A ring of 3 records under 11 iterations printing one or two lines
    each: the graph stops whenever the next iteration might not fit,
    the host prints, the same graph is launched again; the lines equal
    the eager run's in order, one capture, launches = drains + 1; on a
    second run, the synchronizing calls torch reports equal the record's
    host syncs."""
    import warnings

    from systemml_tpu_torch.lang.parser import parse
    from systemml_tpu_torch.runtime import loopfuse
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    monkeypatch.setattr(loopfuse, "RING_RECORDS", 3)
    src = """
i = 0
x = 0.5
b = TRUE
while (i < 11) {
  x = x * 1.5
  print("i=" + i + " x=" + x + " b=" + b)
  if (i - 2 * floor(i / 2) == 0) {
    print("even " + i)
  }
  b = !b
  i = i + 1
}
"""
    cfg = DMLConfig()
    cfg.floating_point_precision = "double"
    set_config(cfg)
    try:
        prog = compile_program(parse(src), outputs=["x"])
        lines = []
        prog.execute(printer=lines.append)
    finally:
        set_config(DMLConfig())
    _, eager, _ = _region_lines(src, "cpu", outputs=["x"], codegen=False)
    assert lines == eager and len(lines) == 17
    fl = _top_loop(prog)._fused_loop
    rec = fl.record
    assert fl.refused is None and rec["captures"] == 1
    assert rec["drains"] >= 4 and rec["launches"] == rec["drains"] + 1
    assert rec["trips"] == [11]
    # a second run meets the cache: the synchronizing calls torch sees are
    # the record's host syncs, the entry test and one read per launch
    h0, l0 = rec["host_syncs"], rec["launches"]
    set_config(cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            again = []
            prog.execute(printer=again.append)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        set_config(DMLConfig())
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    assert again == eager
    assert syncs == rec["host_syncs"] - h0 == 1 + rec["launches"] - l0



# --------------------------------------------------------------------------
# the sparse plane on the card (runtime/sparse.py): the ELL kernels and
# the sampled quaternary arms against the same call on the CPU, the CSR
# arms (cuSPARSE through torch.sparse) against dense products, and a loop
# region over a sparse invariant
# --------------------------------------------------------------------------

def _sparse_pair(cuda, m=777, n=301, density=0.03, seed=21):
    from systemml_tpu_torch.runtime import sparse as sp

    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, n)) < density,
                 rng.standard_normal((m, n)), 0.0)
    cpu = sp.SparseMatrix.from_dense(a)
    return a, cpu, sp.SparseMatrix.from_dense(torch.from_numpy(a).to(cuda))


def _same_value(got, ref, bar=1e-12):
    from systemml_tpu_torch.runtime import sparse as sp

    def dense(v):
        if sp.is_ell(v):
            v = v.to_dense()
        elif sp.is_sparse(v):
            return v.to_numpy()
        return v.detach().cpu().numpy()

    g, r = dense(got), dense(ref)
    assert g.shape == r.shape
    nr = np.linalg.norm(r)
    assert np.linalg.norm(g - r) <= bar * (nr if nr else 1.0)


def test_sparse_ell_kernels_match_cpu(cuda):
    """ELL mm, tmm, spmv, mul_dense and sddmm, and every q_* sampled arm,
    on CUDA tensors against the same call on the CPU (fp64; tmm and the
    left wdivmm add with float atomics on the card: 1e-12)."""
    from systemml_tpu_torch.runtime import sparse as sp

    a, cpu, dev = _sparse_pair(cuda)
    rng = np.random.default_rng(22)
    m, n = a.shape
    u, v = rng.standard_normal((m, 10)), rng.standard_normal((n, 10))
    d = rng.standard_normal((m, n))
    tu, tv, td = (torch.from_numpy(t) for t in (u, v, d))
    cu, cv, cd = (t.to(cuda) for t in (tu, tv, td))
    for carrier in ("ell", "csr"):
        if carrier == "ell":
            x_c = sp.EllMatrix(*cpu.to_ell_device(), cpu.shape)
            x_d = sp.EllMatrix(*dev.to_ell_device(), dev.shape)
            assert x_d.idx.is_cuda and x_d.idx.dtype == torch.int32
            _same_value(x_d.mm(cv), x_c.mm(tv))
            _same_value(x_d.mm(cv[:, :1]), x_c.mm(tv[:, :1]))
            _same_value(x_d.tmm(cu), x_c.tmm(tu))
            _same_value(sp.ell_spmv(x_d.idx, x_d.val, cv[:, 0]),
                        sp.ell_spmv(x_c.idx, x_c.val, tv[:, 0]))
            _same_value(x_d.mul_dense(cd), x_c.mul_dense(td))
        else:
            x_c, x_d = cpu, dev
        _same_value(sp.sddmm(x_d, cu, cv.T), sp.sddmm(x_c, tu, tv.T))
        for post in ("NONE", "POST_NZ"):
            _same_value(sp.q_wsloss(x_d, cu, cv, None, post),
                        sp.q_wsloss(x_c, tu, tv, None, post))
        for post in ("POST", "PRE"):
            _same_value(sp.q_wsloss(cd, cu, cv, x_d, post),
                        sp.q_wsloss(td, tu, tv, x_c, post))
        for flags in ("", "minus log"):
            _same_value(sp.q_wsigmoid(x_d, cu, cv, flags),
                        sp.q_wsigmoid(x_c, tu, tv, flags))
        for left, mw, eps in ((False, True, 0.0), (True, False, 0.5)):
            _same_value(sp.q_wdivmm(x_d, cu, cv, left, mw, eps),
                        sp.q_wdivmm(x_c, tu, tv, left, mw, eps))
        _same_value(sp.q_wcemm(x_d, cu.abs(), cv.abs(), 1.0),
                    sp.q_wcemm(x_c, tu.abs(), tv.abs(), 1.0))
        _same_value(sp.q_wumm(x_d, cu, cv, "exp", True),
                    sp.q_wumm(x_c, tu, tv, "exp", True))


def test_sparse_csr_arms_match_dense_products(cuda):
    """The CSR arms on the card (cuSPARSE SpMM and SpGEMM through
    torch.sparse) against the dense products of to_dense()."""
    from systemml_tpu_torch.runtime import sparse as sp
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    a, _, x = _sparse_pair(cuda)
    dx = torch.from_numpy(a).to(cuda)
    rng = np.random.default_rng(23)
    b = torch.from_numpy(rng.standard_normal((a.shape[1], 7))).to(cuda)
    c = torch.from_numpy(rng.standard_normal((5, a.shape[0]))).to(cuda)
    cfg = DMLConfig()
    cfg.mem_budget_bytes = 1e4       # the CSR arms of spgemm and sp_tsmm
    set_config(cfg)
    try:
        st = stats.Statistics()
        with stats.stats_scope(st):
            _same_value(sp.spmm(x, b), dx @ b)
            _same_value(sp.spmm_exact(x, b), dx @ b)
            _same_value(sp.gemm_sp(c, x), c @ dx)
            xt = x.transpose()
            _same_value(xt, dx.T)
            got = sp.spgemm(x, xt)
            _same_value(got, dx @ dx.T, 1e-11)
            _same_value(sp.sp_tsmm(x, True), dx.T @ dx, 1e-11)
            _same_value(sp.sp_tsmm(x, False), dx @ dx.T, 1e-11)
            _same_value(x.row_sums(), dx.sum(1))
            _same_value(x.col_sums(), dx.sum(0))
            _same_value(x.slice(3, 500, 10, 200), dx[3:500, 10:200])
        assert st.estim_counts.get("spmm_bcoo") == 1
        assert st.estim_counts.get("sp_tsmm_host") == 2
        assert st.estim_counts.get("sparse_densify", 0) == 0
    finally:
        set_config(DMLConfig())


SPARSE_REGION = """
i = 0
while (i < maxi) {
  G = -(WV %*% R) + (W * (L %*% t(R))) %*% R + 0.01 * L
  L = L - 0.01 * G
  R = 0.99 * R
  i = i + 1
}
loss = sum(WV ^ 2) - 2 * sum(WV * (L %*% t(R))) + sum((W * (L %*% t(R))) ^ 2)
"""


@pytest.mark.parametrize("view,kw", [("ell", {"ultra_sparsity_turn_point":
                                              0.05}),
                                     ("dense", {})])
def test_region_with_sparse_invariant_captures_once(cuda, view, kw):
    """A loop over sparse invariants (W and W * V, as ALS-CG's, bound as
    inputs, so that both entries read the same matrices; R is carried, so
    that no product of invariants is hoisted into a new tensor per
    execution): on the card one
    capture across two entries with another maxi (each view is cached on
    its matrix: the same addresses), one launch and two host syncs per
    entry (a host sync inside a capture raises), the views the reference's
    rule gives, and the results of the CPU's plain arm within 1e-12."""
    from systemml_tpu_torch.lang.parser import parse
    from systemml_tpu_torch.runtime import sparse as sp
    from systemml_tpu_torch.runtime.program import compile_program
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    rng = np.random.default_rng(24)
    a = np.where(rng.random((900, 60)) < 0.02,
                 np.round(rng.uniform(1, 10, (900, 60))) / 2, 0.0)
    outs = {}
    for device in ("cuda", "cpu"):
        cfg = DMLConfig(device=device)
        cfg.floating_point_precision = "double"
        cfg.optlevel = 3
        for k, v in kw.items():
            setattr(cfg, k, v)
        set_config(cfg)
        try:
            prog = compile_program(parse(SPARSE_REGION),
                                   input_names=["W", "WV", "L", "R", "maxi"],
                                   outputs=["L", "loss"])
            V = sp.SparseMatrix.from_dense(torch.from_numpy(a).to(device))
            W = V.value_map(lambda d: (d != 0).to(d.dtype))
            WV = W.with_values(W.data * V.data)
            lr = {n: torch.from_numpy(0.1 * rng2.random((rows, 4))).to(device)
                  for n, rows, rng2 in (("L", 900, np.random.default_rng(7)),
                                        ("R", 60, np.random.default_rng(8)))}
            runs = [prog.execute({"W": W, "WV": WV, **lr, "maxi": mx})
                    for mx in (3, 5)]
        finally:
            set_config(DMLConfig())
        fl = [b for b in prog.blocks
              if hasattr(b, "_fused_loop")][0]._fused_loop
        assert fl.record["refused"] is None
        assert fl.record["views"] == {"W": view, "WV": view}
        assert fl.record["trips"] == [3, 5]
        if device == "cuda":
            assert fl.record["captures"] == 1 and fl.record["launches"] == 2
            assert fl.record["host_syncs"] == 4
        outs[device] = [(r.vars["L"].cpu().numpy(), float(r.vars["loss"]))
                        for r in runs]
    for (lc, sc), (lp, spl) in zip(outs["cuda"], outs["cpu"]):
        assert np.linalg.norm(lc - lp) <= 1e-12 * np.linalg.norm(lp)
        assert abs(sc - spl) <= 1e-12 * abs(spl)


# --------------------------------------------------------------------------
# algorithm breadth on the card: solvers inside a captured region, seq and
# sample equal to the CPU's draw, the index aggregates, deterministic
# weighted tables, betainc; `-k breadth` runs these alone
# --------------------------------------------------------------------------

BREADTH_SOLVE = """
A = t(X) %*% X + diag(matrix(0.5, rows=ncol(X), cols=1))
b = matrix(1, rows=ncol(X), cols=1)
i = 0
w = b
while (i < 6) {
  w = solve(A, w + b)
  L = cholesky(A + diag(abs(w)))
  w = w + 0.01 * rowSums(L)
  i = i + 1
}
"""


def test_breadth_solvers_inside_a_captured_region(cuda):
    """solve (solve_ex) and cholesky (cholesky_ex) in a while body: the
    region is captured, with no refusal, in one graph launch, and agrees
    with the plain arm on the CPU at 1e-12 (fp64)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, 6))
    got, ml = _region_run(BREADTH_SOLVE, "cuda", {"X": x}, ["w"])
    ref, _ = _region_run(BREADTH_SOLVE, "cpu", {"X": x}, ["w"])
    np.testing.assert_allclose(_region_values(got, ["w"])[0],
                               _region_values(ref, ["w"])[0],
                               rtol=1e-12, atol=1e-12)
    assert ml._stats.estim_counts.get("loop_regions_refused", 0) == 0
    assert any("refused=0" in ln for ln in ml._stats.display().split("\n")
               if ln.startswith("Loop regions"))


@pytest.mark.parametrize("args", [(2_000_000, 5, False, 7),
                                  (3_000_000, 10, True, 7),
                                  (1_000, 1_000, False, 3),
                                  (5_000, 60, True, 11)])
def test_breadth_sample_on_the_card_equals_cpu(cuda, args):
    from systemml_tpu_torch.ops import datagen

    for dtype in (torch.float32, torch.float64):
        got = datagen.sample(*args, dtype=dtype, device=cuda)
        ref = datagen.sample(*args, dtype=dtype, device="cpu")
        assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("args", [(1, 2_000_000, 8_000), (3.5, -7.25, -0.3),
                                  (0.1, 1e6, 0.7)])
def test_breadth_seq_on_the_card_equals_cpu(cuda, args):
    from systemml_tpu_torch.ops import datagen

    for dtype in (torch.float32, torch.float64):
        got = datagen.seq(*args, dtype=dtype, device=cuda)
        ref = datagen.seq(*args, dtype=dtype, device="cpu")
        assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("op", ["indexmax", "indexmin"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_breadth_index_aggregates_ties_and_nan(cuda, op, dtype):
    """rowIndexMax / rowIndexMin on the card as on the CPU: the first
    index wins a tie, a NaN counts as the extreme; wide rows too."""
    from systemml_tpu_torch.ops import agg

    rng = np.random.default_rng(8)
    x = np.round(rng.standard_normal((3001, 1000)), 1)
    x[::7, 13] = np.nan
    x[5, :] = 2.0
    t = torch.from_numpy(x).to(dtype)
    for direction in ("row", "col"):
        got = agg.agg(op, t.to(cuda), direction).cpu()
        assert torch.equal(got, agg.agg(op, t, direction))


def test_breadth_weighted_table_repeats_bit_for_bit(cuda):
    """table(A, B, W) adds without float atomics: repeats on the card give
    the same bits, and agree with the CPU at 1e-5 (fp32) and 1e-12
    (fp64)."""
    from systemml_tpu_torch.ops import param

    rng = np.random.default_rng(9)
    n = 2_000_000
    i = torch.from_numpy(rng.integers(1, 6, n).astype(np.float64))
    j = torch.from_numpy(rng.integers(1, 4, n).astype(np.float64))
    w = torch.from_numpy(rng.standard_normal(n))
    for dtype, bar in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        args = [v.to(dtype).to(cuda) for v in (i, j, w)]
        a = param.table(*args, 5, 3)
        b = param.table(*args, 5, 3)
        assert torch.equal(a, b)
        ref = param.table(*[v.to(dtype) for v in (i, j, w)], 5, 3)
        assert float((a.cpu() - ref).abs().max()) <= bar * float(
            ref.abs().max())
        counts = param.table(args[0], args[1], 1.0, 5, 3)
        assert torch.equal(counts.cpu(),
                           param.table(i.to(dtype), j.to(dtype), 1.0, 5, 3))


def test_breadth_betainc_on_the_card_equals_cpu(cuda):
    from systemml_tpu_torch.ops import param

    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.uniform(0.05, 50, 4000))
    b = torch.from_numpy(rng.uniform(0.05, 50, 4000))
    x = torch.from_numpy(rng.uniform(0, 1, 4000))
    got = param.betainc(a.to(cuda), b.to(cuda), x.to(cuda)).cpu()
    ref = param.betainc(a, b, x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-300)
    t = torch.from_numpy(rng.standard_normal(4000) * 3)
    np.testing.assert_allclose(
        param.cdf(t.to(cuda), "t", df=5.0).cpu().numpy(),
        param.cdf(t, "t", df=5.0).numpy(), rtol=1e-12)


# --------------------------------------------------------------------------
# the buffer pool, the block compile, the IO library and fault 1 on the card
# --------------------------------------------------------------------------

POOL_LOOP = """
A = rand(rows=2000, cols=100, seed=1)
B = A * 2
s = 0.0
for (j in 1:2) {
  C = rand(rows=2000, cols=100, seed=10 + j)
  D = C + 1
  i = 0
  while (i < 3) {
    s = s + sum(B * D) / (i + 1)
    i = i + 1
  }
}
"""


def test_pool_eviction_drops_the_region_graph_reading_it(cuda):
    """A loop-invariant input of a captured region evicted between the
    loop's entries: the eviction drops the cached graph that read its
    address, the next entry captures on the restored tensor, and the
    result equals the run without pressure."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    got = {}
    for budget in (None, 1.5e6):
        cfg = DMLConfig()
        cfg.floating_point_precision = "double"
        cfg.bufferpool_min_bytes = 1024
        cfg.bufferpool_budget_bytes = budget
        ml = MLContext(cfg)
        got[budget] = (float(ml.execute(dml(POOL_LOOP).output("s"))
                             .get_scalar("s")), dict(ml._stats.pool_counts))
    assert got[1.5e6][0] == got[None][0]
    counts = got[1.5e6][1]
    assert counts["evict"] > 0 and counts["restore"] > 0
    assert counts["graph_invalidate"] >= 1
    assert not got[None][1].get("evict")


def test_block_graph_replays_under_a_new_binding(cuda):
    """A prepared script's block runs through its plan, watched for
    synchronizing calls, until a run is free of them (the first, or the
    second after a one-time set-up), is captured at the next and replayed
    after: each call's result equals torch's on that call's binding."""
    from systemml_tpu_torch.api.jmlc import Connection

    ps = Connection().prepare_script("yhat = (X %*% B) * 2 + 1",
                                     input_names=["X", "B"],
                                     output_names=["yhat"])
    gen = torch.Generator(device=cuda).manual_seed(5)
    b = torch.randn(100, 1, generator=gen, device=cuda)
    outs = []
    for _ in range(5):
        x = torch.randn(1000, 100, generator=gen, device=cuda)
        y = ps.execute({"X": x, "B": b}).get_tensor("yhat")
        outs.append((y.clone(), torch.matmul(x, b) * 2 + 1))
    torch.cuda.synchronize()
    for y, ref in outs:
        assert torch.allclose(y, ref, rtol=1e-5, atol=1e-5)
    g = dict(ps.stats.block_graph_counts.items())
    assert g["capture"] == 1 and g["watched"] in (1, 2)
    assert g["watched"] + g["replay"] == 5


def test_block_graph_draws_unseeded_rand_anew(cuda):
    """A prepared unseeded rand() keeps its block out of a graph
    ("nograph:rand"): four calls give four draws, bit-identical to four
    calls with graphs off under the same global seed."""
    from systemml_tpu_torch.api.jmlc import Connection
    from systemml_tpu_torch.ops import datagen
    from systemml_tpu_torch.utils.config import DMLConfig

    draws, counts = {}, {}
    for graphs in (True, False):
        cfg = DMLConfig()
        cfg.codegen_enabled = graphs
        ps = Connection(cfg).prepare_script(
            "R = rand(rows=100, cols=1)", input_names=[],
            output_names=["R"])
        datagen.set_global_seed(11)
        try:
            draws[graphs] = [ps.execute({}).get_tensor("R").clone()
                             for _ in range(4)]
        finally:
            datagen.set_global_seed(None)
        counts[graphs] = dict(ps.stats.block_graph_counts.items())
    got = draws[True]
    assert all(not torch.equal(a, b) for i, a in enumerate(got)
               for b in got[i + 1:])
    assert all(torch.equal(a, b) for a, b in zip(got, draws[False]))
    assert counts[True] == {"nograph:rand": 1}


def test_fault1_loop_on_the_card_matches_the_cpu(cuda):
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    src = ("s = 0; for (i in 1:4) { c = pnorm(target=0.5, mean=0, sd=i); "
           "s = s + c }")
    vals = []
    for device in ("cuda", "cpu"):
        cfg = DMLConfig(device=device)
        cfg.floating_point_precision = "double"
        vals.append(float(MLContext(cfg).execute(dml(src).output("s"))
                          .get_scalar("s")))
    assert vals[0] == pytest.approx(vals[1], rel=1e-12)
    assert vals[1] == pytest.approx(2.4060908443979536, rel=1e-12)


def test_binary_block_read_of_1gb_equals_the_write(cuda, tmp_path):
    """1 GB of fp32 written from the card (one copy into pinned memory,
    the native tiled write) and read back (the native read into pinned
    memory, one copy to the card): equal bit for bit, both arms native."""
    from systemml_tpu_torch.io import binaryblock

    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(262_144, 1_024, generator=gen, device=cuda)
    p = str(tmp_path / "x.bb")
    binaryblock.ARM_COUNTS.clear()
    binaryblock.write_tensor(p, x)
    back = binaryblock.read_tensor(p, cuda, torch.float32)
    assert back.device.type == "cuda" and torch.equal(back, x)
    assert binaryblock.ARM_COUNTS == {("write", "native"): 1,
                                      ("read", "native"): 1}


# --------------------------------------------------------------------------
# parfor on worker lanes (runtime/parfor.py): region entries, captures and
# the merge under eight workers, each on a CUDA stream of its own
# --------------------------------------------------------------------------

PARFOR_REGION = """
fit = function(matrix[double] A, matrix[double] y) return (matrix[double] w) {
  w = matrix(0, rows=ncol(A), cols=1)
  it = 0
  while (it < 20) {
    w = w - 0.001 * (t(A) %*% (A %*% w - y))
    it = it + 1
  }
}
R = matrix(0, rows=ncol(X), cols=16)
parfor (j in 1:16, par=P) {
  w = fit(X, y + j)
  R[, j] = w
}
"""


def _parfor_run(src, device, inputs, outs, par, optlevel=2):
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    cfg = DMLConfig(device=device)
    cfg.floating_point_precision = "double"
    cfg.optlevel = optlevel
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    s = dml(src.replace("par=P", f"par={par}"))
    for k, v in inputs.items():
        s.input(k, v)
    res = ml.execute(s.output(*outs))
    return [res.get_matrix(o) for o in outs], ml


def test_parfor_eight_workers_enter_one_region_key(cuda):
    """Eight workers call one function whose while loop is a region, on
    the same X and y at once (one key): the results equal par=1's bit for
    bit and the CPU's at 1e-12, the entry shared under the loop's lock."""
    rng = np.random.default_rng(3)
    ins = {"X": rng.standard_normal((2000, 12)),
           "y": rng.standard_normal((2000, 1))}
    (r8,), ml8 = _parfor_run(PARFOR_REGION, "cuda", ins, ["R"], 8)
    (r1,), _ = _parfor_run(PARFOR_REGION, "cuda", ins, ["R"], 1)
    (rc,), _ = _parfor_run(PARFOR_REGION, "cpu", ins, ["R"], 4)
    np.testing.assert_array_equal(r8, r1)
    np.testing.assert_allclose(r8, rc, rtol=1e-12, atol=1e-12)
    assert ml8._stats.estim_counts["parfor_lanes"] == 8
    assert sum(ml8._stats.region_counts.values()) == 16


def test_parfor_capture_beside_launches_and_host_reads(cuda):
    """Even iterations capture a loop region on their lanes while odd ones
    launch kernels and read the device from the host (a loop refused for
    its removeEmpty, whose row count and as.scalar read the card): every
    capture stays valid, the results equal par=1's and the CPU's."""
    src = """
R = matrix(0, rows=16, cols=1)
parfor (j in 1:16, par=P) {
  if (j %% 2 == 0) {
    v = matrix(j, rows=nrow(X), cols=1)
    it = 0
    while (it < 30) {
      v = 0.5 * v + 0.1 * (X %*% (t(X) %*% v)) / nrow(X)
      it = it + 1
    }
    R[j, 1] = sum(v)
  } else {
    s = 0
    for (k in 1:25) {
      t = removeEmpty(target=X[1:4, ], margin="rows")
      s = s + as.scalar(sum(t * j)) / 1000
    }
    R[j, 1] = s
  }
}
"""
    x = np.random.default_rng(8).standard_normal((3000, 16))
    (r8,), ml = _parfor_run(src, "cuda", {"X": x}, ["R"], 8)
    (r1,), _ = _parfor_run(src, "cuda", {"X": x}, ["R"], 1)
    (rc,), _ = _parfor_run(src, "cpu", {"X": x}, ["R"], 8)
    np.testing.assert_array_equal(r8, r1)
    np.testing.assert_allclose(r8, rc, rtol=1e-12, atol=1e-12)


def test_parfor_merge_after_the_lane_stream_reuses_memory(cuda):
    """A worker's result, made on its lane stream and read by the merge on
    the caller's (held back here by a sleep kernel), stays intact while
    the lane stream allocates and overwrites memory after the worker has
    dropped it: the merge recorded it on the caller's stream."""
    from types import SimpleNamespace

    from systemml_tpu_torch.runtime import parfor

    lane = parfor.lane_stream(cuda, 7)
    shape = (2048, 1024)
    orig = torch.zeros(shape, dtype=torch.float64, device=cuda)
    lane.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(lane):
        v = torch.full(shape, 7.0, dtype=torch.float64, device=cuda)
    done = torch.cuda.Event()
    done.record(lane)
    caller = torch.cuda.current_stream(cuda)
    caller.wait_event(done)
    torch.cuda._sleep(200_000_000)          # the merge runs late
    ec = SimpleNamespace(vars={})
    results = [{"R": v}]
    parfor.merge_results(ec, {"R": orig}, results, home=cuda)
    del v, results
    with torch.cuda.stream(lane):
        for _ in range(4):
            w = torch.full(shape, -1.0, dtype=torch.float64, device=cuda)
            del w
    torch.cuda.synchronize()
    assert torch.equal(ec.vars["R"], torch.full_like(orig, 7.0))


def test_parfor_rand_draws_equal_the_cpu_bits(cuda):
    """Unseeded rand() in a parfor body under a global seed: each
    iteration's sub-stream gives the card the CPU's bits, for par 1 and 8."""
    from systemml_tpu_torch.ops import datagen

    src = """
R = matrix(0, rows=16, cols=40)
parfor (i in 1:16, par=P) {
  R[i,] = rand(rows=1, cols=40, min=-1, max=1)
}
"""
    got = []
    for device, par in (("cuda", 8), ("cuda", 1), ("cpu", 8)):
        datagen.set_global_seed(21)
        try:
            (r,), _ = _parfor_run(src, device, {}, ["R"], par)
        finally:
            datagen.set_global_seed(None)
        got.append(r)
    np.testing.assert_array_equal(got[0], got[2])
    np.testing.assert_array_equal(got[1], got[2])


_SOLVE_LOOP = """
s = matrix(0, rows=ncol(A), cols=1)
i = 0
while (i < 3) {
  s = s + solve(A, b * (i + 1))
  i = i + 1
}
"""


def _solve_runs(a, b, precision):
    """The solve loop's s with regions (codegen on) and eagerly: the sum
    of solve(A, b * k) for k = 1, 2, 3 (b scaled, so that a b in A's
    range stays there)."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    outs = []
    for codegen in (True, False):
        cfg = DMLConfig()
        cfg.floating_point_precision = precision
        cfg.codegen_enabled = codegen
        ml = MLContext(cfg)
        outs.append(ml.execute(
            dml(_SOLVE_LOOP).input("A", a).input("b", b).output("s"))
            .get_matrix("s"))
        if codegen:
            assert sum(ml._stats.region_counts.values()) == 1
    return outs


@pytest.mark.parametrize("precision", ["single", "double"])
def test_solve_in_a_region_at_every_order(cuda, precision):
    """solve() inside a while region at orders 1 to 1,000 (square; LU's
    solve of orders 12 to 128 left a graph memory node that the region's
    conditional body refused, so a region solves through the fp64
    inverse, ops/linalg._solve_graph_safe) and on tall systems (least
    squares): the region's and the eager run's within the fp32 or fp64
    bar of the CPU's fp64 solve."""
    bar = 1e-4 if precision == "single" else 1e-10
    rng = np.random.default_rng(2)
    for n, m in [(k, k) for k in (1, 2, 8, 9, 12, 16, 33, 64, 128, 256,
                                  512, 1000)] + [(200, 3), (300, 12),
                                                 (500, 40)]:
        a = rng.standard_normal((n, m)) + (n * np.eye(n, m) if n == m
                                           else 0)
        b = rng.standard_normal((n, 1))
        ref = 6 * np.linalg.lstsq(a, b, rcond=None)[0]
        for out in _solve_runs(a, b, precision):
            assert np.linalg.norm(out - ref) <= bar * np.linalg.norm(ref), \
                (n, m)


@pytest.mark.parametrize("shape", [(2000, 50), (50, 50)])
def test_solve_of_an_ill_conditioned_fp64_system_matches_lstsq(cuda, shape):
    """An fp64 A of condition number 1e6 (tall and square): eagerly (cuSOLVER's QR or LU) and inside a region
    (the fp64 inverse with refinement), within 1e-10 of numpy's lstsq;
    the normal equations alone are about 1e-4 off."""
    n, m = shape
    rng = np.random.default_rng(6)
    u, _ = np.linalg.qr(rng.standard_normal((n, m)))
    v, _ = np.linalg.qr(rng.standard_normal((m, m)))
    a = (u * np.logspace(0, -6, m)) @ v.T
    # consistent (b in A's range): with a residual, the answer's own
    # sensitivity at this condition number is about 1e-10 (numpy's lstsq
    # is that far from the exact one), which no method could meet
    b = a @ rng.standard_normal((m, 1))
    ref = 6 * np.linalg.lstsq(a, b, rcond=None)[0]
    for out in _solve_runs(a, b, "double"):
        assert np.linalg.norm(out - ref) <= 1e-10 * np.linalg.norm(ref)


# ---- the DNN slice (ops/dnn.py, the normal draw, DNN ops in a region) ---

def _dnn_conv_case(dev, seed=5):
    from systemml_tpu_torch.ops import dnn

    rng = np.random.default_rng(seed)
    n, c, h, w, f, k, s, p = 8, 16, 28, 28, 32, 3, 2, 1
    ho = dnn.out_dim(h, k, s, p)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    return (t(n, c * h * w), t(f, c * k * k), t(n, f * ho * ho),
            ([n, c, h, w], [f, c, k, k], [s, s], [p, p]))


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_dnn_conv_arms_agree_on_the_card(cuda, layout):
    """cuDNN and im2col, forward and both gradients, fp32 with TF32 off,
    within 1e-5 normwise of each other and of the CPU in fp64."""
    from systemml_tpu_torch.ops import dnn
    from systemml_tpu_torch.utils.config import (DMLConfig,
                                                 apply_matmul_precision,
                                                 set_config)

    x, w, d, args = _dnn_conv_case(cuda)
    outs = {}
    try:
        for algo in ("conv", "im2col"):
            cfg = DMLConfig()
            cfg.conv_algorithm, cfg.conv_layout = algo, layout
            set_config(cfg)
            apply_matmul_precision()
            outs[algo] = (dnn.conv2d(x, w, *args),
                          dnn.conv2d_backward_filter(x, d, *args),
                          dnn.conv2d_backward_data(w, d, *args))
        set_config(DMLConfig(device="cpu"))
        ref = (dnn.conv2d(x.cpu().double(), w.cpu().double(), *args),
               dnn.conv2d_backward_filter(x.cpu().double(), d.cpu().double(),
                                          *args),
               dnn.conv2d_backward_data(w.cpu().double(), d.cpu().double(),
                                        *args))
    finally:
        set_config(DMLConfig())
    for a, b, r in zip(outs["conv"], outs["im2col"], ref):
        for got in (a, b):
            assert got.device.type == "cuda"
            err = float(torch.linalg.norm(got.cpu().double() - r)
                        / torch.linalg.norm(r))
            assert err <= 1e-5, err


@pytest.mark.parametrize("ctype,c,wc", [("XtXv", 1, 0), ("XtwXv", 4, 1),
                                        ("XtXvy", 4, 4)])
def test_mmchain_bf16_policy_takes_the_kernel(cuda, ctype, c, wc):
    """Under "bfloat16" mmchain still launches K1, over X and v rounded
    to bf16: within 1e-5 normwise of the plain chain in fp64 over the
    same rounded operands, and not equal to the fp32 chain."""
    from systemml_tpu_torch.utils.config import DMLConfig, set_config

    x, v, w = _inputs(cuda, c, wc)
    xr, vr = x.bfloat16().float(), v.bfloat16().float()
    cfg = DMLConfig()
    cfg.floating_point_precision = "bfloat16"
    before = kernels.mmchain_kernel.launches
    set_config(cfg)
    try:
        out = mult.mmchain(x, v, w, ctype)
    finally:
        set_config(DMLConfig())
    torch.cuda.synchronize()
    assert kernels.mmchain_kernel.launches == before + 1
    ref = kernels.mmchain_plain(xr.double(), vr.double(),
                                None if w is None else w.double(), ctype)
    err = torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref)
    assert out.dtype == torch.float32 and float(err) <= 1e-5
    fp32 = kernels.mmchain_plain(x.double(), v.double(),
                                 None if w is None else w.double(), ctype)
    assert float(torch.linalg.norm(out.double() - fp32)
                 / torch.linalg.norm(fp32)) > 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dnn_normal_draw_equals_cpu_bits(cuda, dtype):
    from systemml_tpu_torch.ops import datagen

    bits = torch.int32 if dtype == torch.float32 else torch.int64
    for seed in (7, torch.tensor(7)):
        a = datagen.rand(513, 129, pdf="normal", sparsity=0.7,
                         seed=seed.to(cuda) if isinstance(seed, torch.Tensor)
                         else seed, dtype=dtype, device=cuda)
        b = datagen.rand(513, 129, pdf="normal", sparsity=0.7, seed=7,
                         dtype=dtype, device="cpu")
        assert torch.equal(a.cpu().view(bits), b.view(bits))


@pytest.mark.parametrize("geom", [(2, 2, 2, 0), (3, 2, 1, 0)])
def test_dnn_max_pool_ties_on_the_card(cuda, geom):
    """Tied windows: the non-overlapping rule splits the gradient, the
    overlapping and padded one gives it to the first maximum, as on the
    CPU (tests/test_torch_dnn.py holds the CPU to the JAX package)."""
    from systemml_tpu_torch.ops import dnn

    ps, s, p, _ = geom
    rng = np.random.default_rng(2)
    x = np.round(rng.standard_normal((4, 3 * 8 * 8)) * 2) / 2
    ho = dnn.out_dim(8, ps, s, p)
    d = rng.standard_normal((4, 3 * ho * ho))
    args = ([4, 3, 8, 8], [ps, ps], [s, s], [p, p])
    got = dnn.max_pool_backward(torch.from_numpy(x).to(cuda),
                                torch.from_numpy(d).to(cuda), *args)
    ref = dnn.max_pool_backward(torch.from_numpy(x), torch.from_numpy(d),
                                *args)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(dnn.max_pool(torch.from_numpy(x).to(cuda), *args).cpu(),
                       dnn.max_pool(torch.from_numpy(x), *args))


_DNN_LOOP = """
s = 0
for (i in 1:6) {
  Y = conv2d(X, W, input_shape=[8,3,12,12], filter_shape=[4,3,3,3],
             stride=[1,1], padding=[1,1])
  Y = bias_add(Y, b)
  [Z, m1, v1, cm, cv] = batch_norm2d(Y, g, bb, em, ev,
                                     input_shape=[8,4,12,12], mode="train",
                                     epsilon=1e-5, momentum=0.9)
  P = max_pool(Z, input_shape=[8,4,12,12], pool_size=[3,3], stride=[2,2],
               padding=[1,1])
  dP = max_pool_backward(Z, P, input_shape=[8,4,12,12], pool_size=[3,3],
                         stride=[2,2], padding=[1,1])
  dW = conv2d_backward_filter(X, dP, input_shape=[8,3,12,12],
                              filter_shape=[4,3,3,3], stride=[1,1],
                              padding=[1,1])
  W = W - 0.01 * dW
  em = m1
  ev = v1
  s = s + sum(P)
}
"""


def test_dnn_loop_is_one_region_equal_to_its_eager_run(cuda):
    """A for loop over fixed batches calling conv2d, batch norm, pooling
    and a conv gradient: captured as one region (one capture, one graph
    launch) and equal to the same loop run eagerly."""
    from systemml_tpu_torch.api.mlcontext import MLContext, dml
    from systemml_tpu_torch.utils.config import DMLConfig

    rng = np.random.default_rng(4)
    ins = {"X": rng.standard_normal((8, 3 * 144)),
           "W": rng.standard_normal((4, 27)) * 0.3,
           "b": rng.standard_normal((4, 1)), "g": np.ones((4, 1)),
           "bb": np.zeros((4, 1)), "em": np.zeros((4, 1)),
           "ev": np.ones((4, 1))}
    res = {}
    for regions in (True, False):
        cfg = DMLConfig()
        cfg.codegen_enabled = regions
        s = dml(_DNN_LOOP)
        for k, v in ins.items():
            s.input(k, v)
        ml = MLContext(cfg)
        with stats.stats_scope(None):
            out = ml.execute(s.output("W", "s", "em"))
        res[regions] = out
        if regions:
            assert ml._stats.region_counts, "the loop did not run as a region"
            assert not ml._stats.estim_counts.get("loop_regions_refused")
    for name in ("W", "em"):
        a = res[True].get_tensor(name)
        b = res[False].get_tensor(name)
        assert torch.equal(a, b) or float(
            torch.linalg.norm(a.double() - b.double())
            / torch.linalg.norm(b.double())) <= 1e-5
    assert abs(float(res[True].get_scalar("s"))
               - float(res[False].get_scalar("s"))) <= 1e-5 * abs(
        float(res[False].get_scalar("s")))


# ---- the kernel backend on the card (codegen/backend.py, tune.py) -------

def _selected_choice(rec, op):
    sel = [e.args for e in rec.events() if e.name == "kernel_select"
           and e.args["op"] == op]
    assert len(sel) == 1, sel
    return sel[0]


def test_backend_dispatches_every_family_on_the_card(cuda):
    """Every family through its entry point on CUDA tensors: the key's
    backend is "cuda"; the hand-kernel families choose their kernel
    (K1, K2-K5, K6) and launch it; each value equals the CPU's (the
    plain arms) within 1e-5 normwise."""
    from systemml_tpu_torch.codegen import backend
    from systemml_tpu_torch.codegen.compiler import execute_spoof
    from systemml_tpu_torch.compress import compress
    from systemml_tpu_torch.compress import device as cla_dev
    from systemml_tpu_torch.hops.hop import Hop
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.runtime.sparse import SparseMatrix
    from systemml_tpu_torch.utils.config import (DMLConfig, get_config,
                                                 set_config)

    rng = np.random.default_rng(8)
    x = rng.standard_normal((4096, 256)).astype(np.float32)
    a = rng.standard_normal((2048, 6)).astype(np.float32)
    v = rng.standard_normal((256, 1)).astype(np.float32)
    w = rng.standard_normal((4096, 1)).astype(np.float32)
    sp = np.where(rng.random((300, 200)) < 0.05,
                  rng.uniform(1, 5, (300, 200)), 0.0).astype(np.float32)
    # positive factors: wcemm takes log(U %*% t(V) + eps)
    uf = rng.uniform(0.1, 1.0, (300, 4)).astype(np.float32)
    vf = rng.uniform(0.1, 1.0, (200, 4)).astype(np.float32)
    cat = np.floor(rng.random((5000, 6)) * 4) + 1
    cv = cat[:1].T.astype(np.float32)
    cw = cat[:, :1].astype(np.float32)
    plan = CNode("b(*)", [CNode("in", name="a"), CNode("in", name="b")])
    row = CNode("u(exp)", [CNode("in", name="a")])
    mag = CNode("u(abs)", [CNode("in", name="a")])
    outer = CNode("b(*)", [CNode("in", name="X"), CNode("in", name="UV")])

    def calls(dev):
        t = lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        c = compress(cat)
        vs = SparseMatrix.from_dense(t(sp))
        h = lambda tmpl, p: Hop("spoof", [], dict(p, template=tmpl))
        return {
            "mmchain": lambda: mult.mmchain(t(x), t(v), t(w), "XtwXv"),
            "spoof_cell": lambda: execute_spoof(h("cell", {
                "plan": plan, "agg": "sum", "leaf_names": ["a", "b"]}),
                [t(a), t(a)]),
            "spoof_row": lambda: execute_spoof(h("row", {
                "plan": row, "row_agg": "max", "leaf_names": ["a"]}), [t(a)]),
            "spoof_multiagg": lambda: execute_spoof(h("multiagg", {
                "plan": mag, "aggs": ["sum", "max"], "leaf_names": ["a"]}),
                [t(a)]),
            "spoof_outer": lambda: execute_spoof(h("outer", {
                "plan": outer, "scalar_names": []}), [t(sp), t(uf), t(vf)]),
            "q_wsloss": lambda: mult.wsloss(vs, t(uf), t(vf), None,
                                            "POST_NZ"),
            "q_wsigmoid": lambda: mult.wsigmoid(vs, t(uf), t(vf), ""),
            "q_wdivmm": lambda: mult.wdivmm(vs, t(uf), t(vf), False),
            "q_wcemm": lambda: mult.wcemm(vs, t(uf), t(vf), 1e-3),
            "q_wumm": lambda: mult.wumm(vs, t(uf), t(vf), "*", uop="exp"),
            "cla_right": lambda: cla_dev.right_mult(c, t(cv)),
            "cla_left": lambda: cla_dev.left_mult(c, t(cw.T)),
            "cla_tsmm": lambda: cla_dev.tsmm(c),
            "cla_mmchain": lambda: cla_dev.mmchain(c, t(cv), t(cw),
                                                   "XtwXv")}

    def value(r):
        if isinstance(r, tuple):
            return torch.stack([x.reshape(()) for x in r]).double().cpu()
        if isinstance(r, SparseMatrix):
            r = r.to_dense()
        return r.double().cpu()

    kernel_of = {"mmchain": "kernel", "spoof_cell": "kernel",
                 "spoof_row": "kernel", "spoof_multiagg": "kernel",
                 "spoof_outer": "kernel", "cla_mmchain": "tpu_chain"}
    prev = get_config()
    try:
        set_config(DMLConfig(device="cpu"))
        backend.reset_process_state()
        ref = {op: value(f()) for op, f in calls("cpu").items()}
        cfg = DMLConfig()
        cfg.floating_point_precision = "single"
        set_config(cfg)
        backend.reset_process_state()
        for op, f in calls(cuda).items():
            with obs.session() as rec:
                got = value(f())
            sel = _selected_choice(rec, op)
            assert "|cuda|" in sel["key"], sel
            if op in kernel_of:
                assert sel["choice"] == kernel_of[op], (op, sel)
            err = float(torch.linalg.norm(got - ref[op])
                        / max(float(torch.linalg.norm(ref[op])), 1e-30))
            assert err <= 1e-5, (op, err)
    finally:
        set_config(prev)
        backend.reset_process_state()


def test_a_variant_that_raises_on_the_card_raises_through_dispatch(cuda):
    """K1 accepts the call's shapes, then its wrapper refuses operands on
    two devices: the error reaches the caller, with no fallback run."""
    from systemml_tpu_torch.codegen import backend
    from systemml_tpu_torch.obs import trace as obs

    x, v, _ = _inputs(cuda, 1, 0)
    backend.reset_process_state()
    with obs.session() as rec:
        with pytest.raises(ValueError, match="different devices"):
            mult.mmchain(x, v.cpu())
    assert not [e for e in rec.events() if e.name == "kernel_fallback"]


def test_tune_cache_keyed_by_the_cards_name(cuda, tmp_path):
    """codegen_tune_mode "cached" on the card: the verdict's key is the
    kernel key (backend "cuda") and torch.cuda.get_device_name(); a fresh
    process's memory serves it with 0 measurements."""
    import json

    from systemml_tpu_torch.codegen import backend, tune
    from systemml_tpu_torch.utils.config import (DMLConfig, get_config,
                                                 set_config)

    x, v, w = _inputs(cuda, 1, 1, m=200_000, k=256)
    prev = get_config()
    cfg = DMLConfig()
    cfg.codegen_tune_mode = "cached"
    cfg.codegen_tune_cache = str(tmp_path / "tune.json")
    cfg.codegen_tune_trials = 2
    set_config(cfg)
    try:
        backend.reset_process_state()
        first = mult.mmchain(x, v, w, "XtwXv")
        assert tune.measurement_count() == 1
        (key, ent), = json.loads(
            (tmp_path / "tune.json").read_text())["entries"].items()
        assert key.startswith("mmchain|cuda|float32|")
        assert key.endswith("|" + torch.cuda.get_device_name())
        assert ent["measured_on"]["device_kind"] == \
            torch.cuda.get_device_name()
        backend.reset_process_state()
        again = mult.mmchain(x, v, w, "XtwXv")
        assert tune.measurement_count() == 0
        assert torch.equal(first, again)
    finally:
        set_config(prev)
        backend.reset_process_state()


_BUILD_CHILD = r"""
import sys
import time
import torch
from systemml_tpu_torch.codegen import build, kernels

while time.time() < float(sys.argv[1]):
    time.sleep(0.01)
x = torch.randn(4096, 256, device="cuda")
v = torch.randn(256, 1, device="cuda")
out = kernels.mmchain_kernel(x, v)
ref = kernels.mmchain_plain(x.double(), v.double())
err = float(torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref))
assert err <= 1e-5, err
print("BUILT", sorted(build.build_reports), flush=True)
"""


def test_two_processes_build_one_source_at_once(cuda, tmp_path):
    """Two processes (a remote parfor's workers) reach the same source at
    the same moment in a fresh build directory: the file lock lets one
    nvcc build it while the other waits; both load the whole library and
    launch it, and the directory holds one library and no temporary."""
    import shutil
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(root, "systemml_tpu_torch"),
                    tmp_path / "systemml_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    start = str(time.time() + 8.0)
    ps = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, start],
                           cwd=str(tmp_path), env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
          for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in ps]
    for p, (out, err) in zip(ps, outs):
        assert p.returncode == 0, err[-3000:]
        assert "BUILT" in out
    built = [o for o, _ in outs if "'mmchain'" in o]
    assert len(built) == 1, outs       # one nvcc ran; the other waited
    libs = os.listdir(tmp_path / "systemml_tpu_torch" / "_build")
    assert len([f for f in libs if f.startswith("libmmchain-")
                and f.endswith(".so")]) == 1, libs
    assert not [f for f in libs if f.endswith(".tmp")], libs
