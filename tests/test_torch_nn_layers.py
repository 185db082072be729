"""The scripts/nn layer library, optimizers and util.dml through the port's
JMLC (systemml_tpu_torch/api/jmlc.py), against the JAX package's JMLC on
the same numpy-seeded inputs, on the CPU.

Each case of tests/test_nn.py (its 35 test functions and their
parametrizations) runs its forward script and, where it has one, its
backward script through both packages: every output within 1e-9 relative
(fp64). The port's backward is then held to central finite differences
of its own forward, as tests/test_nn.py holds the JAX package's (step
1e-5, rtol 1e-3).
"""

import os

import numpy as np
import pytest
import torch

from systemml_tpu.api.jmlc import Connection as JConnection
from systemml_tpu_torch.api.jmlc import Connection

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
EPS = 1e-5


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class DML:
    """A prepared snippet of one package, called with numpy inputs."""

    def __init__(self, conn, script, input_names, output_names):
        self.ps = conn.prepare_script(script, input_names=input_names,
                                      output_names=output_names,
                                      base_dir=SCRIPTS)
        self.output_names = output_names

    def __call__(self, **inputs):
        for k, v in inputs.items():
            if isinstance(v, np.ndarray):
                self.ps.set_matrix(k, v)
            else:
                self.ps.set_scalar(k, v)
        res = self.ps.execute_script()
        return tuple(_np(res.get(o)) for o in self.output_names)


def port(script, inputs, outputs):
    return DML(Connection(device="cpu"), script, list(inputs), outputs)


def jax(script, inputs, outputs):
    return DML(JConnection(), script, list(inputs), outputs)


def _L(name):
    return f'source("nn/layers/{name}.dml") as L\n'


def _O(name):
    return f'source("nn/optim/{name}.dml") as O\n'


def _U(body):
    return 'source("nn/util.dml") as util\n' + body


def _n(rng, *shape):
    return rng.normal(size=shape)


# Each case: (inputs(rng) -> dict, forward script, its outputs, backward
# script or None, [(input, gradient output)], finite-difference probes).
# A backward script's forward is its gradcheck's J = sum(out * D) script.
def _act(name):
    return (lambda r: {"X": _n(r, 4, 6), "D": _n(r, 4, 6)},
            _L(name) + "out = L::forward(X)\nJ = sum(out * D)", ["out", "J"],
            _L(name) + "dX = L::backward(D, X)", [("X", "dX")], 3)


def _loss_inputs(name):
    def make(r):
        n, k = 4, 3
        if name == "log_loss":
            return {"pred": r.uniform(0.05, 0.95, (n, 1)),
                    "y": (r.uniform(size=(n, 1)) > 0.5).astype(float)}
        if name == "cross_entropy_loss":
            p = r.uniform(0.1, 1.0, (n, k))
            return {"pred": p / p.sum(1, keepdims=True),
                    "y": np.eye(k)[r.integers(0, k, n)]}
        return {"pred": _n(r, n, k), "y": _n(r, n, k)}
    return make


def _conv_in(r):
    return {"X": _n(r, 2, 75), "W": _n(r, 4, 27), "b": _n(r, 4, 1),
            "D": _n(r, 2, 100)}


_CONV = "L::forward(X, W, b, 3, 5, 5, 3, 3, 1, 1, 1, 1)"
_CONV_B = "L::backward(D, 5, 5, X, W, b, 3, 5, 5, 3, 3, 1, 1, 1, 1)"
_POOL = "L::forward(X, 3, 6, 6, 2, 2, 2, 2, 0, 0)"
_POOL_B = "L::backward(D, 3, 3, X, 3, 6, 6, 2, 2, 2, 2, 0, 0)"
_DW = "L::forward(X, W, b, 5, 5, 2, 3, 3, 1, 1, 1, 1)"
_DW_B = "L::backward(D, 5, 5, X, W, b, 5, 5, 2, 3, 3, 1, 1, 1, 1)"
_CT = "L::forward(X, W, b, 3, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1)"
_CT_B = "L::backward(D, 8, 8, X, W, b, 3, 4, 4, 3, 3, 2, 2, 1, 1)"
_CTD = "L::forward(X, W, b, 4, 4, 4, 2, 3, 3, 2, 2, 1, 1, 1, 1)"
_CTD_B = "L::backward(D, 8, 8, X, W, b, 4, 4, 4, 2, 3, 3, 2, 2, 1, 1)"
_BN1 = ('mode = "train"\n[out, emu, evu, cm, cv, cn] = L::forward(X, gamma, '
        'beta, mode, em, ev, 0.9, 1e-5)\n')
_BN1_B = ("[dX, dgamma, dbeta] = L::backward(D, out, emu, evu, cm, cv, cn, "
          "X, gamma, beta, mode, em, ev, 0.9, 1e-5)")
_BN2 = ('mode = "train"\n[out, emu, evu, cm, cv, cn] = L::forward(X, gamma, '
        'beta, 2, 2, 2, mode, em, ev, 0.9, 1e-5)\n')
_BN2_B = ("[dX, dgamma, dbeta] = L::backward(D, out, emu, evu, cm, cv, cn, "
          "X, gamma, beta, 2, 2, 2, mode, em, ev, 0.9, 1e-5)")
_LSTM = "[out, c, co, cc, ci] = L::forward(X, W, b, 3, 4, TRUE, out0, c0)\n"
_LSTM_B = ("[dX, dW, db, dout0, dc0] = L::backward(DO, DC, X, W, b, 3, 4, "
           "TRUE, out0, c0, co, cc, ci)")
_LSTM1 = "[out, c, co, cc, ci] = L::forward(X, W, b, 3, 3, FALSE, out0, c0)\n"
_LSTM1_B = ("[dX, dW, db, dout0, dc0] = L::backward(DO, DC, X, W, b, 3, 3, "
            "FALSE, out0, c0, co, cc, ci)")
_RNN = "[out, co] = L::forward(X, W, b, 3, 4, TRUE, out0)\n"
_RNN_B = "[dX, dW, db, dout0] = L::backward(DO, X, W, b, 3, 4, TRUE, out0, co)"


def _lstm_in(r):
    return {"X": _n(r, 2, 12), "W": _n(r, 7, 12) * 0.5,
            "b": _n(r, 1, 12) * 0.1, "out0": _n(r, 2, 3), "c0": _n(r, 2, 3),
            "DO": _n(r, 2, 9), "DC": _n(r, 2, 3)}


def _lstm1_in(r):
    return {"X": _n(r, 2, 9), "W": _n(r, 5, 8) * 0.5, "b": np.zeros((1, 8)),
            "out0": np.zeros((2, 2)), "c0": np.zeros((2, 2)),
            "DO": _n(r, 2, 2), "DC": np.zeros((2, 2))}


def _ce2d_in(r):
    p = r.uniform(0.1, 1.0, (2, 3, 4))
    p = p / p.sum(1, keepdims=True)
    y = np.zeros((2, 3, 4))
    yi = r.integers(0, 3, (2, 4))
    for i in range(2):
        for j in range(4):
            y[i, yi[i, j], j] = 1
    return {"pred": p.reshape(2, -1), "y": y.reshape(2, -1)}


def _three(r):
    return {k: _n(r, 3, 3) for k in ("X", "dX", "v")}


CASES = {
    "affine": (lambda r: {"X": _n(r, 4, 3), "W": _n(r, 3, 5),
                          "b": _n(r, 1, 5), "D": _n(r, 4, 5)},
               _L("affine") + "out = L::forward(X, W, b)\nJ = sum(out * D)",
               ["out", "J"], _L("affine") + "[dX, dW, db] = L::backward(D, "
               "X, W, b)", [("X", "dX"), ("W", "dW"), ("b", "db")], 3),
    "relu": _act("relu"), "sigmoid": _act("sigmoid"), "tanh": _act("tanh"),
    "elu": (lambda r: {"X": _n(r, 4, 6), "D": _n(r, 4, 6)},
            _L("elu") + "out = L::forward(X, 1)\nJ = sum(out * D)",
            ["out", "J"], _L("elu") + "dX = L::backward(D, X, 1)",
            [("X", "dX")], 3),
    "softmax": _act("softmax"),
    "dropout": (lambda r: {"X": _n(r, 6, 8) + 3.0, "D": _n(r, 6, 8)},
                _L("dropout") + "[out, mask] = L::forward(X, 0.5, 42)\n"
                "J = sum(out * D)", ["out", "mask", "J"],
                _L("dropout") + "[out, mask] = L::forward(X, 0.5, 42)\n"
                "dX = L::backward(D, X, 0.5, mask)", [("X", "dX")], 3),
    **{loss: (_loss_inputs(loss), _L(loss) + "J = L::forward(pred, y)",
              ["J"], _L(loss) + "dpred = L::backward(pred, y)",
              [("pred", "dpred")], 3)
       for loss in ("l1_loss", "l2_loss", "log_loss", "cross_entropy_loss")},
    **{reg: (lambda r: {"X": _n(r, 4, 3)}, _L(reg) + "J = L::forward(X, 0.7)",
             ["J"], _L(reg) + "dX = L::backward(X, 0.7)", [("X", "dX")], 3)
       for reg in ("l1_reg", "l2_reg")},
    "scale_shift1d": (
        lambda r: {"X": _n(r, 4, 5), "gamma": _n(r, 1, 5),
                   "beta": _n(r, 1, 5), "D": _n(r, 4, 5)},
        _L("scale_shift1d") + "out = L::forward(X, gamma, beta)\n"
        "J = sum(out * D)", ["out", "J"],
        _L("scale_shift1d") + "out = L::forward(X, gamma, beta)\n"
        "[dX, dgamma, dbeta] = L::backward(D, out, X, gamma, beta)",
        [("X", "dX"), ("gamma", "dgamma"), ("beta", "dbeta")], 3),
    "scale_shift2d": (
        lambda r: {"X": _n(r, 2, 12), "gamma": _n(r, 3, 1),
                   "beta": _n(r, 3, 1), "D": _n(r, 2, 12)},
        _L("scale_shift2d") + "out = L::forward(X, gamma, beta, 3, 2, 2)\n"
        "J = sum(out * D)", ["out", "J"],
        _L("scale_shift2d") + "out = L::forward(X, gamma, beta, 3, 2, 2)\n"
        "[dX, dgamma, dbeta] = L::backward(D, out, X, gamma, beta, 3, 2, 2)",
        [("X", "dX"), ("gamma", "dgamma"), ("beta", "dbeta")], 3),
    "low_rank_affine": (
        lambda r: {"X": _n(r, 4, 6), "U": _n(r, 6, 2), "V": _n(r, 2, 5),
                   "b": _n(r, 1, 5), "D": _n(r, 4, 5)},
        _L("low_rank_affine") + "out = L::forward(X, U, V, b)\n"
        "J = sum(out * D)", ["out", "J"],
        _L("low_rank_affine") + "[dX, dU, dV, db] = L::backward(D, X, U, V, "
        "b)", [("X", "dX"), ("U", "dU"), ("V", "dV"), ("b", "db")], 3),
    "fm": (lambda r: {"X": _n(r, 5, 4), "w0": _n(r, 1, 1), "W": _n(r, 4, 1),
                      "V": _n(r, 4, 3), "D": _n(r, 5, 1)},
           _L("fm") + "out = L::forward(X, w0, W, V)\nJ = sum(out * D)",
           ["out", "J"], _L("fm") + "[dw0, dW, dV] = L::backward(D, X, w0, "
           "W, V)", [("w0", "dw0"), ("W", "dW"), ("V", "dV")], 3),
    **{name: (_conv_in, _L(name) + f"[out, Hout, Wout] = {_CONV}\n"
              "J = sum(out * D)", ["out", "Hout", "Wout", "J"],
              _L(name) + f"[dX, dW, db] = {_CONV_B}",
              [("X", "dX"), ("W", "dW"), ("b", "db")], 3)
       for name in ("conv2d_builtin", "conv2d")},
    **{name: (lambda r: {"X": _n(r, 2, 108), "D": _n(r, 2, 27)},
              _L(name) + f"[out, Hout, Wout] = {_POOL}\nJ = sum(out * D)",
              ["out", "Hout", "Wout", "J"], _L(name) + f"dX = {_POOL_B}",
              [("X", "dX")], 3)
       for name in ("max_pool2d_builtin", "max_pool2d",
                    "avg_pool2d_builtin")},
    "conv2d_depthwise": (
        lambda r: {"X": _n(r, 2, 75), "W": _n(r, 3, 18), "b": _n(r, 6, 1),
                   "D": _n(r, 2, 150)},
        _L("conv2d_depthwise") + f"[out, Hout, Wout] = {_DW}\n"
        "J = sum(out * D)", ["out", "Hout", "Wout", "J"],
        _L("conv2d_depthwise") + f"[dX, dW, db] = {_DW_B}",
        [("X", "dX"), ("W", "dW"), ("b", "db")], 3),
    "conv2d_transpose": (
        lambda r: {"X": _n(r, 2, 48), "W": _n(r, 3, 18), "b": _n(r, 2, 1),
                   "D": _n(r, 2, 128)},
        _L("conv2d_transpose") + f"[out, Hout, Wout] = {_CT}\n"
        "J = sum(out * D)", ["out", "Hout", "Wout", "J"],
        _L("conv2d_transpose") + f"[dX, dW, db] = {_CT_B}",
        [("X", "dX"), ("W", "dW"), ("b", "db")], 3),
    "conv2d_transpose_depthwise": (
        lambda r: {"X": _n(r, 2, 64), "W": _n(r, 2, 18), "b": _n(r, 2, 1),
                   "D": _n(r, 2, 128)},
        _L("conv2d_transpose_depthwise") + f"[out, Hout, Wout] = {_CTD}\n"
        "J = sum(out * D)", ["out", "Hout", "Wout", "J"],
        _L("conv2d_transpose_depthwise") + f"[dX, dW, db] = {_CTD_B}",
        [("X", "dX"), ("W", "dW"), ("b", "db")], 3),
    "upsample2d": (
        lambda r: {"X": _n(r, 2, 27), "D": _n(r, 2, 108)},
        _L("upsample2d") + "out = L::forward(X, 3, 3, 3, 2, 2)\n"
        "J = sum(out * D)", ["out", "J"],
        _L("upsample2d") + "dX = L::backward(D, 3, 3, 3, 2, 2)",
        [("X", "dX")], 3),
    "batch_norm1d": (
        lambda r: {"X": _n(r, 5, 4), "gamma": _n(r, 1, 4),
                   "beta": _n(r, 1, 4), "em": np.zeros((1, 4)),
                   "ev": np.ones((1, 4)), "D": _n(r, 5, 4)},
        _L("batch_norm1d") + _BN1 + "J = sum(out * D)",
        ["out", "emu", "evu", "J"], _L("batch_norm1d") + _BN1 + _BN1_B,
        [("X", "dX"), ("gamma", "dgamma"), ("beta", "dbeta")], 3),
    "batch_norm2d": (
        lambda r: {"X": _n(r, 3, 8), "gamma": _n(r, 2, 1),
                   "beta": _n(r, 2, 1), "em": np.zeros((2, 1)),
                   "ev": np.ones((2, 1)), "D": _n(r, 3, 8)},
        _L("batch_norm2d") + _BN2 + "J = sum(out * D)",
        ["out", "emu", "evu", "J"], _L("batch_norm2d") + _BN2 + _BN2_B,
        [("X", "dX"), ("gamma", "dgamma"), ("beta", "dbeta")], 3),
    "lstm": (_lstm_in, _L("lstm") + _LSTM + "J = sum(out * DO) + sum(c * DC)",
             ["out", "c", "J"], _L("lstm") + _LSTM + _LSTM_B,
             [("X", "dX"), ("W", "dW"), ("b", "db"), ("out0", "dout0"),
              ("c0", "dc0")], 2),
    "lstm_last_only": (
        _lstm1_in, _L("lstm") + _LSTM1 + "J = sum(out * DO)", ["out", "J"],
        _L("lstm") + _LSTM1 + _LSTM1_B, [("X", "dX"), ("W", "dW")], 2),
    "rnn": (lambda r: {"X": _n(r, 2, 12), "W": _n(r, 7, 3) * 0.5,
                       "b": _n(r, 1, 3) * 0.1, "out0": _n(r, 2, 3),
                       "DO": _n(r, 2, 9)},
            _L("rnn") + _RNN + "J = sum(out * DO)", ["out", "J"],
            _L("rnn") + _RNN + _RNN_B,
            [("X", "dX"), ("W", "dW"), ("b", "db"), ("out0", "dout0")], 2),
    "softmax2d": (lambda r: {"X": _n(r, 2, 12), "D": _n(r, 2, 12)},
                  _L("softmax2d") + "out = L::forward(X, 3)\nJ = sum(out * D)",
                  ["out", "J"], _L("softmax2d") + "dX = L::backward(D, X, 3)",
                  [("X", "dX")], 3),
    "cross_entropy_loss2d": (
        _ce2d_in, _L("cross_entropy_loss2d") + "J = L::forward(pred, y, 3)",
        ["J"], _L("cross_entropy_loss2d") + "dpred = L::backward(pred, y, 3)",
        [("pred", "dpred")], 3),
    # optimizers: one update each, no backward
    "sgd": (lambda r: {"X": _n(r, 3, 3), "dX": _n(r, 3, 3)},
            _O("sgd") + "Xn = O::update(X, dX, 0.1)", ["Xn"], None, [], 0),
    "sgd_momentum": (_three, _O("sgd_momentum") + "[Xn, vn] = O::update(X, "
                     "dX, 0.1, 0.9, v)", ["Xn", "vn"], None, [], 0),
    "sgd_nesterov": (_three, _O("sgd_nesterov") + "[Xn, vn] = O::update(X, "
                     "dX, 0.1, 0.9, v)", ["Xn", "vn"], None, [], 0),
    "adagrad": (lambda r: {"X": _n(r, 3, 3), "dX": _n(r, 3, 3),
                           "cache": np.abs(_n(r, 3, 3))},
                _O("adagrad") + "[Xn, cn] = O::update(X, dX, 0.1, 1e-8, "
                "cache)", ["Xn", "cn"], None, [], 0),
    "rmsprop": (lambda r: {"X": _n(r, 3, 3), "dX": _n(r, 3, 3),
                           "cache": np.abs(_n(r, 3, 3))},
                _O("rmsprop") + "[Xn, cn] = O::update(X, dX, 0.1, 0.95, "
                "1e-8, cache)", ["Xn", "cn"], None, [], 0),
    "adam": (lambda r: {"X": _n(r, 3, 3), "dX": _n(r, 3, 3),
                        "m": _n(r, 3, 3), "v": np.abs(_n(r, 3, 3))},
             _O("adam") + "[Xn, mn, vn] = O::update(X, dX, 0.001, 0.9, "
             "0.999, 1e-8, 0, m, v)", ["Xn", "mn", "vn"], None, [], 0),
    # util.dml
    "channel_sums": (lambda r: {"X": _n(r, 3, 16)},
                     _U("out = util::channel_sums(X, 4, 2, 2)"), ["out"],
                     None, [], 0),
    "predict_class": (lambda r: {"P": r.uniform(size=(5, 4))},
                      _U("out = util::predict_class(P, 4, 1, 1)"), ["out"],
                      None, [], 0),
    "predict_class_2d": (lambda r: {"P": r.uniform(size=(2, 12))},
                         _U("out = util::predict_class(P, 3, 2, 2)"), ["out"],
                         None, [], 0),
    "im2col_col2im": (lambda r: {"img": _n(r, 2, 16)},
                      _U("cols = util::im2col(img, 4, 4, 2, 2, 2, 2)\n"
                         "out = util::col2im(cols, 2, 4, 4, 2, 2, 2, 2, "
                         "\"add\")"), ["cols", "out"], None, [], 0),
    "pad_unpad": (lambda r: {"img": _n(r, 2, 9)},
                  _U("p = util::pad_image(img, 3, 3, 1, 1, 0)\n"
                     "out = util::unpad_image(p, 3, 3, 1, 1)"), ["p", "out"],
                  None, [], 0),
    "top_k": (lambda r: {"X": _n(r, 4, 6)}, _U("[v, i] = util::top_k(X, 3)"),
              ["v", "i"], None, [], 0),
}
WITH_BACKWARD = [k for k, c in CASES.items() if c[3] is not None]


def _close(a, b, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(float(np.abs(b).max()) if b.size else 0.0, 1e-300)
    assert float(np.abs(a - b).max()) <= 1e-9 * scale, name


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case, rng):
    make, fwd, outs, _, _, _ = CASES[case]
    inputs = make(rng)
    for name, a, b in zip(outs, port(fwd, inputs, outs)(**inputs),
                          jax(fwd, inputs, outs)(**inputs)):
        _close(a, b, name)


@pytest.mark.parametrize("case", WITH_BACKWARD)
def test_backward_matches_jax(case, rng):
    make, _, _, bwd, pairs, _ = CASES[case]
    inputs = make(rng)
    names = [g for _, g in pairs]
    for name, a, b in zip(names, port(bwd, inputs, names)(**inputs),
                          jax(bwd, inputs, names)(**inputs)):
        _close(a, b, name)


@pytest.mark.parametrize("case", WITH_BACKWARD)
def test_backward_matches_finite_differences(case, rng):
    """The port's analytic gradients against central differences of the
    port's own forward J."""
    make, fwd, _, bwd, pairs, probes = CASES[case]
    inputs = make(rng)
    f = port(fwd, inputs, ["J"])
    grads = dict(zip([g for _, g in pairs],
                     port(bwd, inputs, [g for _, g in pairs])(**inputs)))
    pick = np.random.default_rng(0)
    for var, gname in pairs:
        g, x = grads[gname], inputs[var]
        for fi in pick.choice(x.size, size=min(probes, x.size),
                              replace=False):
            e = np.zeros_like(x)
            e.flat[fi] = EPS
            jp = float(f(**{**inputs, var: x + e})[0])
            jm = float(f(**{**inputs, var: x - e})[0])
            fd = (jp - jm) / (2 * EPS)
            assert np.isclose(np.asarray(g).flat[fi], fd, rtol=1e-3,
                              atol=1e-6), \
                f"{var}[{fi}]: analytic={np.asarray(g).flat[fi]} fd={fd}"
