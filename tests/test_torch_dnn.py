"""The port's DNN ops (systemml_tpu_torch/ops/dnn.py), attention
(parallel/ring.py), the DNN builtins' lowering and the layout pass
(hops/layout.py), against the JAX package's (systemml_tpu/ops/dnn.py,
parallel/ring.py), on the CPU.

Inputs are numpy-seeded, at the geometries of tests/test_dnn_hotpath.py
and a few more (stride, padding, groups, wide pool padding). Bars: fp64
relative error 1e-9; the "bfloat16" mixed policy within 4e-2 of the fp32
("single") results, the bar of tests/test_dnn_hotpath.py, and "single"
within 1e-5 of the JAX package's. The port's bf16 policy rounds the
operands to bf16 on every device, where XLA on the CPU ignores the
reduced precision, so only the 4e-2 bar holds between the two packages
under "bfloat16".
"""

import numpy as np
import pytest
import torch

from systemml_tpu.ops import dnn as jdnn
from systemml_tpu.parallel import ring as jring
from systemml_tpu.utils.config import DMLConfig as JConfig
from systemml_tpu.utils.config import set_config as jset
from systemml_tpu_torch.ops import dnn
from systemml_tpu_torch.parallel import ring
from systemml_tpu_torch.utils.config import DMLConfig, set_config


@pytest.fixture(autouse=True)
def _configs():
    yield
    jset(JConfig())
    set_config(DMLConfig())


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def _both(**kw):
    """The same settings in both packages (the port on the CPU)."""
    jc, tc = JConfig(), DMLConfig(device="cpu")
    for k, v in kw.items():
        setattr(jc, k, v)
        setattr(tc, k, v)
    jset(jc)
    set_config(tc)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (n, c, h, w, f, hf, wf, stride, pad, groups)
GEOMS = [
    (2, 3, 8, 8, 4, 3, 3, 1, 1, 1),
    (2, 4, 9, 9, 2, 3, 3, 2, 0, 1),
    (2, 2, 12, 12, 3, 5, 5, 1, 2, 1),    # >= 5x5: im2col under "auto"
    (2, 3, 16, 16, 4, 7, 7, 2, 3, 1),    # a ResNet stem in small
    (2, 4, 8, 8, 6, 3, 3, 1, 1, 2),      # grouped
    (2, 4, 7, 7, 4, 3, 3, 2, 1, 4),      # depthwise
]


def _conv_case(g, rng):
    n, c, h, w, f, hf, wf, s, p, groups = g
    x = rng.standard_normal((n, c * h * w))
    wt = rng.standard_normal((f, (c // groups) * hf * wf))
    ho, wo = dnn.out_dim(h, hf, s, p), dnn.out_dim(w, wf, s, p)
    dout = rng.standard_normal((n, f * ho * wo))
    args = ([n, c, h, w], [f, c // groups, hf, wf], [s, s], [p, p], groups)
    return x, wt, dout, args


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("algo", ["auto", "conv", "im2col"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_conv2d_and_backwards_match_jax(geom, algo, layout, rng):
    x, wt, dout, args = _conv_case(geom, rng)
    _both(conv_algorithm=algo, conv_layout=layout)
    assert _rel(dnn.conv2d(_t(x), _t(wt), *args),
                jdnn.conv2d(x, wt, *args)) < 1e-9
    assert _rel(dnn.conv2d_backward_filter(_t(x), _t(dout), *args),
                jdnn.conv2d_backward_filter(x, dout, *args)) < 1e-9
    assert _rel(dnn.conv2d_backward_data(_t(wt), _t(dout), *args),
                jdnn.conv2d_backward_data(wt, dout, *args)) < 1e-9


@pytest.mark.parametrize("geom", GEOMS)
def test_conv_algo_picks_the_jax_packages_arm_on_the_cpu(geom):
    n, c, h, w, f, hf, wf, s, p, groups = geom
    g = (n, c, h, w, f, hf, wf, s, s, p, p, groups)
    _both()
    assert dnn.conv_algo(*g) == jdnn.conv_algo(*g)
    assert dnn.conv_algo(*g) == dnn.conv_algo(*g)   # the cached pick
    _both(mem_budget_bytes=1e4)
    assert dnn.conv_algo(*g) == jdnn.conv_algo(*g) == "conv"
    _both(conv_algorithm="im2col")
    assert dnn.conv_algo(*g) == ("conv" if groups > 1 else "im2col")


def test_conv_arms_agree_and_backwards_follow_the_forward(rng):
    """Forced "conv" and "im2col" agree with each other, forward and
    backward: each backward is the adjoint of its own forward's arm."""
    x, wt, dout, args = _conv_case((2, 2, 12, 12, 3, 5, 5, 1, 2, 1), rng)
    outs = {}
    for algo in ("conv", "im2col"):
        _both(conv_algorithm=algo)
        outs[algo] = (dnn.conv2d(_t(x), _t(wt), *args),
                      dnn.conv2d_backward_filter(_t(x), _t(dout), *args),
                      dnn.conv2d_backward_data(_t(wt), _t(dout), *args))
    for a, b in zip(outs["conv"], outs["im2col"]):
        assert _rel(a, b.numpy()) < 1e-10


# (n, c, h, w, pool, stride, pad): non-overlapping; overlapping and padded
# (the ResNet stem's 3x3 s2 p1); padding wider than torch's kernels take
POOLS = [(2, 3, 8, 8, 2, 2, 0), (2, 2, 9, 9, 3, 2, 1), (2, 2, 8, 8, 3, 2, 1),
         (2, 2, 9, 9, 3, 2, 2), (1, 2, 6, 6, 3, 3, 0)]


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("geom", POOLS)
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_pools_and_backwards_match_jax(kind, geom, ties, layout, rng):
    """With ties (values rounded to halves) the non-overlapping max-pool
    backward splits a window's gradient equally between its maxima, as
    the JAX package's; the overlapping and padded one gives it to the
    window's first maximum in row-major order, as XLA's select_and_
    scatter does."""
    n, c, h, w, ps, s, p = geom
    x = rng.standard_normal((n, c * h * w))
    if ties:
        x = np.round(x * 2) / 2
    ho = dnn.out_dim(h, ps, s, p)
    dout = rng.standard_normal((n, c * ho * ho))
    args = ([n, c, h, w], [ps, ps], [s, s], [p, p])
    _both(conv_layout=layout)
    fwd, jfwd = ((dnn.max_pool, jdnn.max_pool) if kind == "max"
                 else (dnn.avg_pool, jdnn.avg_pool))
    bwd, jbwd = ((dnn.max_pool_backward, jdnn.max_pool_backward)
                 if kind == "max"
                 else (dnn.avg_pool_backward, jdnn.avg_pool_backward))
    assert _rel(fwd(_t(x), *args), jfwd(x, *args)) < 1e-12
    got = bwd(_t(x), _t(dout), *args)
    assert _rel(got, jbwd(x, dout, *args)) < 1e-12


def test_max_pool_backward_tie_rules():
    """One 2x2 window of four equal values: the non-overlapping rule
    gives each a quarter; with stride 1 (overlapping) the first cell of
    each window takes it all."""
    x = torch.ones(1, 4, dtype=torch.float64)
    split = dnn.max_pool_backward(x, torch.ones(1, 1, dtype=torch.float64),
                                  [1, 1, 2, 2], [2, 2], [2, 2], [0, 0])
    assert split.tolist() == [[0.25, 0.25, 0.25, 0.25]]
    x9 = torch.ones(1, 9, dtype=torch.float64)
    one = dnn.max_pool_backward(x9, torch.ones(1, 4, dtype=torch.float64),
                                [1, 1, 3, 3], [2, 2], [1, 1], [0, 0])
    expect = np.asarray(jdnn.max_pool_backward(
        np.ones((1, 9)), np.ones((1, 4)), [1, 1, 3, 3], [2, 2], [1, 1],
        [0, 0]))
    assert np.array_equal(one.numpy(), expect)
    assert one.tolist() == [[1, 1, 0, 1, 1, 0, 0, 0, 0]]


@pytest.mark.parametrize("op", ["bias_add", "bias_multiply"])
@pytest.mark.parametrize("nhwc_in,nhwc_out", [(False, False), (True, False),
                                              (True, True)])
def test_bias_ops_with_nhwc_flags(op, nhwc_in, nhwc_out, rng):
    n, c, h, w = 2, 3, 4, 5
    x = rng.standard_normal((n, c * h * w))
    b = rng.standard_normal((c, 1))
    _both()
    ref = np.asarray(getattr(jdnn, op)(x, b, c))
    xin = dnn.to_nhwc(_t(x), n, c, h, w) if nhwc_in else _t(x)
    got = getattr(dnn, op)(xin, _t(b), c, nhwc_in=nhwc_in,
                           nhwc_out=nhwc_out)
    if nhwc_out:
        assert tuple(got.shape) == (n, h, w, c)
        got = dnn.from_nhwc(got)
    assert _rel(got, ref) < 1e-15
    jx = jdnn.to_nhwc(x, n, c, h, w) if nhwc_in else x
    jgot = getattr(jdnn, op)(jx, b, c, nhwc_in=nhwc_in, nhwc_out=nhwc_out)
    if nhwc_out:
        jgot = jdnn.from_nhwc(jgot)
    assert _rel(got, jgot) < 1e-15


@pytest.mark.parametrize("kind", ["conv", "max", "avg"])
def test_raw_nhwc_in_and_out_match_the_boundary_form(kind, rng):
    """An op fed a raw (N, H, W, C) tensor and asked for one (the layout
    pass's chain) gives the flattened op's values, as the JAX package's
    does; the boundary transposes are counted."""
    from systemml_tpu_torch.utils import stats as stats_mod

    n, c, h, w = 2, 3, 8, 8
    x = rng.standard_normal((n, c * h * w))
    wt = rng.standard_normal((4, c * 9))
    _both(conv_layout="nhwc")
    if kind == "conv":
        args = ([n, c, h, w], [4, c, 3, 3], [1, 1], [1, 1])
        f = lambda v, **kw: dnn.conv2d(v, _t(wt), *args, **kw)
        jf = lambda v, **kw: jdnn.conv2d(v, wt, *args, **kw)
    else:
        args = ([n, c, h, w], [2, 2], [2, 2], [0, 0])
        f = lambda v, **kw: getattr(dnn, f"{kind}_pool")(v, *args, **kw)
        jf = lambda v, **kw: getattr(jdnn, f"{kind}_pool")(v, *args, **kw)
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st):
        raw = f(dnn.to_nhwc(_t(x), n, c, h, w), nhwc_in=True, nhwc_out=True)
    jraw = jf(jdnn.to_nhwc(x, n, c, h, w), nhwc_in=True, nhwc_out=True)
    assert raw.dim() == 4 and tuple(raw.shape) == tuple(jraw.shape)
    assert _rel(raw, np.asarray(jraw)) < 1e-12
    assert _rel(dnn.from_nhwc(raw), f(_t(x))) < 1e-15
    assert st.estim_counts.get("dnn_transposes", 0) == 1


@pytest.mark.parametrize("return_sequences", [True, False])
def test_lstm_matches_jax(return_sequences, rng):
    n, t, d, m = 3, 4, 5, 6
    x = rng.standard_normal((n, t * d))
    w = rng.standard_normal((d + m, 4 * m)) * 0.3
    b = rng.standard_normal((1, 4 * m))
    out0 = rng.standard_normal((n, m))
    c0 = rng.standard_normal((n, m))
    _both()
    got = dnn.lstm(_t(x), _t(w), _t(b), _t(out0), _t(c0), return_sequences)
    ref = jdnn.lstm(x, w, b, out0, c0, return_sequences)
    assert tuple(got[0].shape) == tuple(ref[0].shape)
    for a, r in zip(got, ref):
        assert _rel(a, np.asarray(r)) < 1e-9


@pytest.mark.parametrize("mode", ["train", "test"])
def test_batch_norm2d_matches_jax(mode, rng):
    n, c, h, w = 4, 3, 5, 5
    x = rng.standard_normal((n, c * h * w)) * 2 + 1
    g, b = rng.standard_normal((c, 1)), rng.standard_normal((c, 1))
    em, ev = rng.standard_normal((c, 1)), rng.random((c, 1)) + 0.5
    _both()
    got = dnn.batch_norm2d(*map(_t, (x, g, b, em, ev)), [n, c, h, w], mode,
                           1e-5, 0.9)
    ref = jdnn.batch_norm2d(x, g, b, em, ev, [n, c, h, w], mode, 1e-5, 0.9)
    for a, r in zip(got, ref):
        assert _rel(a, np.asarray(r)) < 1e-9


def test_relu_and_softmax_match_jax(rng):
    x = rng.standard_normal((6, 7))
    d = rng.standard_normal((6, 7))
    _both()
    assert _rel(dnn.relu(_t(x)), jdnn.relu(x)) == 0
    assert _rel(dnn.relu_backward(_t(x), _t(d)),
                jdnn.relu_backward(x, d)) == 0
    assert _rel(dnn.softmax_rows(_t(x)), jdnn.softmax_rows(x)) < 1e-15


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(6, 4), (2, 6, 4), (3, 5, 8)])
def test_attention_matches_jax(causal, shape, rng):
    q, k, v = (rng.standard_normal(shape) for _ in range(3))
    got = ring.attention(_t(q), _t(k), _t(v), causal=causal)
    ref = np.asarray(jring.attention(q, k, v, causal=causal))
    assert tuple(got.shape) == ref.shape
    assert _rel(got, ref) < 1e-9


# ---- the bfloat16 mixed policy (tests/test_dnn_hotpath.py's bars) -------

HOT_GEOMS = [g for g in GEOMS[:3]]


@pytest.mark.parametrize("geom", HOT_GEOMS)
@pytest.mark.parametrize("algo", ["conv", "im2col"])
def test_conv_bf16_policy_within_the_hotpath_bar(geom, algo, rng):
    """Under "bfloat16" the conv family gives fp32 results within 4e-2 of
    the fp32 ("single") ones, the JAX package's included; "single" is
    within 1e-5 of the JAX package's."""
    x, wt, dout, args = _conv_case(geom, rng)
    x, wt, dout = (a.astype(np.float32) for a in (x, wt, dout))
    outs, jouts = {}, {}
    for prec in ("single", "bfloat16"):
        _both(floating_point_precision=prec, conv_algorithm=algo)
        outs[prec] = (dnn.conv2d(_t(x), _t(wt), *args),
                      dnn.conv2d_backward_filter(_t(x), _t(dout), *args),
                      dnn.conv2d_backward_data(_t(wt), _t(dout), *args))
        jouts[prec] = (jdnn.conv2d(x, wt, *args),
                       jdnn.conv2d_backward_filter(x, dout, *args),
                       jdnn.conv2d_backward_data(wt, dout, *args))
        if prec == "bfloat16":
            assert all(o.dtype == torch.float32 for o in outs[prec])
    for a, j in zip(outs["single"], jouts["single"]):
        assert _rel(a, np.asarray(j)) < 1e-5
    for a, s, j in zip(outs["bfloat16"], outs["single"], jouts["bfloat16"]):
        assert _rel(a, s.numpy()) < 4e-2
        assert _rel(a, np.asarray(j)) < 4e-2
        assert _rel(a, s.numpy()) > 0   # the operands really were rounded


def test_matmult_and_lstm_bf16_policy(rng):
    from systemml_tpu_torch.ops import mult

    a = rng.standard_normal((20, 30)).astype(np.float32)
    b = rng.standard_normal((30, 10)).astype(np.float32)
    _both(floating_point_precision="bfloat16")
    got = mult.matmult(_t(a), _t(b))
    assert got.dtype == torch.float32
    assert 0 < _rel(got, a @ b) < 4e-2
    ab = torch.from_numpy(a).bfloat16().float()
    bb = torch.from_numpy(b).bfloat16().float()
    assert torch.equal(got, ab @ bb)
    x = rng.standard_normal((2, 3 * 4)).astype(np.float32)
    w = (rng.standard_normal((4 + 5, 20)) * 0.3).astype(np.float32)
    bias = np.zeros((1, 20), np.float32)
    o0 = np.zeros((2, 5), np.float32)
    out, _ = dnn.lstm(*map(_t, (x, w, bias, o0, o0)))
    _both(floating_point_precision="single")
    ref, _ = dnn.lstm(*map(_t, (x, w, bias, o0, o0)))
    assert 0 < _rel(out, ref.numpy()) < 4e-2


@pytest.mark.parametrize("ctype,wc", [("XtXv", 0), ("XtwXv", 1),
                                      ("XtXvy", 1)])
def test_mmchain_bf16_policy_matches_the_jax_package(ctype, wc, rng):
    """mmchain under "bfloat16" on the CPU: the two-pass arm over X and v
    rounded to bf16, X v rounded again for the second product, within
    4e-2 of the JAX package's jnp_two_pass (whose DEFAULT precision is
    fp32 on the CPU) and of the fp32 chain, and not equal to the latter."""
    from systemml_tpu.ops import mult as jmult
    from systemml_tpu_torch.ops import mult

    x = rng.standard_normal((300, 130)).astype(np.float32)
    v = rng.standard_normal((130, 1)).astype(np.float32)
    w = rng.standard_normal((300, 1)).astype(np.float32) if wc else None
    tw = None if w is None else _t(w)
    _both(floating_point_precision="single")
    ref = mult.mmchain(_t(x), _t(v), tw, ctype)
    _both(floating_point_precision="bfloat16")
    got = mult.mmchain(_t(x), _t(v), tw, ctype)
    want = jmult.mmchain(x, v, w, ctype)
    r = lambda a: torch.from_numpy(a).bfloat16().float()
    xv = r(x) @ r(v)
    xv = xv * tw if ctype == "XtwXv" else (xv - tw if ctype == "XtXvy"
                                           else xv)
    assert got.dtype == torch.float32
    assert torch.equal(got, r(x).T @ xv.bfloat16().float())
    assert _rel(got, np.asarray(want)) < 4e-2
    assert 0 < _rel(got, ref.numpy()) < 4e-2


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pools_ignore_the_bf16_policy(kind, rng):
    x = _t(rng.standard_normal((2, 3 * 8 * 8)).astype(np.float32))
    args = ([2, 3, 8, 8], [2, 2], [2, 2], [0, 0])
    outs = []
    for prec in ("single", "bfloat16"):
        _both(floating_point_precision=prec)
        outs.append(getattr(dnn, f"{kind}_pool")(x, *args))
    assert torch.equal(*outs)


# ---- settings, builtins, the layout pass, the stats line ---------------

def test_dnn_settings_are_ported():
    from systemml_tpu_torch.utils.config import (check_ported, default_dtype,
                                                 mixed_bf16_enabled)

    cfg = DMLConfig(device="cpu")
    cfg.conv_layout, cfg.conv_algorithm = "nhwc", "im2col"
    cfg.floating_point_precision = "bfloat16"
    check_ported(cfg)
    set_config(cfg)
    assert mixed_bf16_enabled() and default_dtype() == torch.float32
    assert dnn.device_layout() == "NHWC"
    cfg.conv_layout = "auto"
    assert dnn.device_layout() == "NCHW"
    assert dnn.device_layout("cuda") == dnn.CUDA_AUTO_LAYOUT


_CHAIN = """
out = conv2d(X, W, input_shape=[3,4,8,8], filter_shape=[5,4,3,3],
             stride=[1,1], padding=[1,1])
out = bias_add(out, b)
out = max(out, 0)
p = max_pool(out, input_shape=[3,5,8,8], pool_size=[2,2], stride=[2,2],
             padding=[0,0])
s = sum(p)
"""


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_layout_chain_through_jmlc(layout, rng):
    """tests/test_dnn_hotpath.py's chain through the port's JMLC: under
    NHWC the layout pass annotates conv, bias_add and max_pool, and the
    results equal the JAX package's."""
    from systemml_tpu.api.jmlc import Connection as JConnection
    from systemml_tpu_torch.api.jmlc import Connection
    from systemml_tpu_torch.hops.hop import postorder
    from systemml_tpu_torch.runtime.program import iter_basic_blocks

    X = rng.standard_normal((3, 4 * 8 * 8))
    W = rng.standard_normal((5, 4 * 3 * 3))
    b = rng.standard_normal((5, 1))
    _both(conv_layout=layout)
    cfg = DMLConfig(device="cpu")
    cfg.conv_layout = layout
    set_config(cfg)
    ps = Connection(config=cfg).prepare_script(
        _CHAIN, input_names=["X", "W", "b"], output_names=["p", "s"])
    ann = [h.op for bb in iter_basic_blocks(ps._program)
           for h in postorder(list(bb.hops.writes.values())
                              + list(bb.hops.sinks))
           if h.params.get("nhwc_in") or h.params.get("nhwc_out")]
    if layout == "nhwc":
        assert {"call:conv2d", "call:max_pool", "call:bias_add"} <= set(ann)
    else:
        assert not ann
    out = ps.execute({"X": X, "W": W, "b": b})
    jps = JConnection().prepare_script(
        _CHAIN, input_names=["X", "W", "b"], output_names=["p", "s"])
    jps.set_matrix("X", X).set_matrix("W", W).set_matrix("b", b)
    jout = jps.execute_script()
    assert _rel(out.get_matrix("p"), np.asarray(jout.get("p"))) < 1e-12
    assert abs(float(out.get_scalar("s")) - float(np.asarray(jout.get("s")))) \
        <= 1e-9 * abs(float(np.asarray(jout.get("s"))))


_BUILTINS = """
Y = conv2d(X, W, input_shape=[2,3,6,6], filter_shape=[4,3,3,3],
           stride=[1,1], padding=[1,1])
Y = bias_add(Y, b)
dW = conv2d_backward_filter(X, Y, input_shape=[2,3,6,6],
                            filter_shape=[4,3,3,3], stride=[1,1],
                            padding=[1,1])
dX = conv2d_backward_data(W, Y, input_shape=[2,3,6,6],
                          filter_shape=[4,3,3,3], stride=[1,1],
                          padding=[1,1])
P = max_pool(Y, input_shape=[2,4,6,6], pool_size=[3,3], stride=[2,2],
             padding=[1,1])
dP = max_pool_backward(Y, P, input_shape=[2,4,6,6], pool_size=[3,3],
                       stride=[2,2], padding=[1,1])
A = avg_pool(Y, input_shape=[2,4,6,6], pool_size=[2,2], stride=[2,2],
             padding=[0,0])
dA = avg_pool_backward(Y, A, input_shape=[2,4,6,6], pool_size=[2,2],
                       stride=[2,2], padding=[0,0])
M = bias_multiply(Y, b)
[BN, m1, v1, cm, cv] = batch_norm2d(Y, g, b, e, f, input_shape=[2,4,6,6],
                                    mode="train", epsilon=1e-5,
                                    momentum=0.9)
[O, C] = lstm(L, Wl, bl, o0, c0, TRUE)
Q = attention(q, q, q, causal=TRUE)
"""


def test_dnn_builtins_through_mlcontext_match_jax(rng):
    from systemml_tpu.api.mlcontext import MLContext as JML
    from systemml_tpu.api.mlcontext import dml as jdml
    from systemml_tpu_torch.api.mlcontext import MLContext, dml

    ins = {"X": rng.standard_normal((2, 3 * 36)),
           "W": rng.standard_normal((4, 27)),
           "b": rng.standard_normal((4, 1)),
           "g": rng.standard_normal((4, 1)),
           "e": rng.standard_normal((4, 1)),
           "f": rng.random((4, 1)) + 0.5,
           "L": rng.standard_normal((2, 3 * 2)),
           "Wl": rng.standard_normal((2 + 3, 12)) * 0.3,
           "bl": rng.standard_normal((1, 12)),
           "o0": np.zeros((2, 3)), "c0": np.zeros((2, 3)),
           "q": rng.standard_normal((5, 4))}
    outs = ("Y", "dW", "dX", "P", "dP", "A", "dA", "M", "BN", "m1", "v1",
            "O", "C", "Q")
    s, js = dml(_BUILTINS), jdml(_BUILTINS)
    for k, v in ins.items():
        s.input(k, v)
        js.input(k, v)
    got = MLContext(device="cpu").execute(s.output(*outs))
    ref = JML().execute(js.output(*outs))
    for name in outs:
        assert _rel(got.get_matrix(name), ref.get_matrix(name)) < 1e-9, name


def test_dnn_stats_line(rng):
    from systemml_tpu_torch.api.mlcontext import MLContext, dml

    cfg = DMLConfig(device="cpu")
    cfg.conv_layout = "nhwc"
    ml = MLContext(cfg)
    ml.execute(dml(_CHAIN).input("X", rng.standard_normal((3, 256)))
               .input("W", rng.standard_normal((5, 36)))
               .input("b", rng.standard_normal((5, 1))).output("s"))
    text = ml._stats.display()
    assert "DNN hot path:" in text and "layout_errors=0" in text
    assert "conv algorithms: conv[3x3s1c4g1]=1" in text
    assert "conv[conv,NHWC,3x3s1,4x8x8]=1" in text
    assert ml._stats.estim_counts.get("dnn_nhwc_edges", 0) >= 2
