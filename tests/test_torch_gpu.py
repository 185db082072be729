"""The hand-written kernels on the card, against their plain versions:
mmchain (systemml_tpu_torch/codegen/csrc/mmchain.cu), the spoof cell
and row templates (csrc/spoof.cuh, one generated source per plan) and the
compressed chain K6 (csrc/cla_chain.cu, against compress/device.py
chain_plain; also the compressed mmchain's choice of K6 by layout).

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
