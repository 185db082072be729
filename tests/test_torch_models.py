"""The port's model layer (systemml_tpu_torch/models/): Caffe2DML,
Keras2DML, the prototxt reader, the model zoo and the mllearn estimators,
against the JAX package's (systemml_tpu/models/), on the CPU.

The cases of tests/test_models.py run through both packages from the same
seed: the fitted parameters agree within 1e-9 relative (fp64), the
predictions likewise, and the port meets the reference test's own
accuracy bars. ResNet-18's spec and scripts are checked at full width
(3x224x224, 1,000 classes). Parameters fitted by the JAX package, carried
over by `load_params`, predict the JAX package's probabilities.
"""

import numpy as np
import pytest
import torch

from systemml_tpu import models as J
from systemml_tpu.models import dmlgen as jdmlgen
from systemml_tpu.models import zoo as jzoo
from systemml_tpu.utils.config import DMLConfig as JConfig
from systemml_tpu.utils.config import set_config as jset
from systemml_tpu_torch import models as T
from systemml_tpu_torch.models import dmlgen, zoo
from systemml_tpu_torch.models.netspec import DATA_BOTTOM, NetSpecError
from systemml_tpu_torch.utils.config import DMLConfig, set_config


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _cpu():
    # one device for the JAX package: the conftest's 8-device mesh would
    # otherwise shard its ops (exec_mode AUTO), as tests/test_torch_als.py
    # notes
    jc = JConfig()
    jc.exec_mode = "SINGLE_NODE"
    jset(jc)
    set_config(DMLConfig(device="cpu"))
    yield
    set_config(DMLConfig())


def _digits(rng, n=240, size=8):
    """tests/test_models.py's 3-class synthetic digits."""
    X = np.zeros((n, size * size))
    y = np.zeros(n)
    for i in range(n):
        c = i % 3
        img = 0.1 * rng.standard_normal((size, size))
        if c == 0:
            img[:, : size // 2] += 1.0
        elif c == 1:
            img[: size // 2, :] += 1.0
        else:
            np.fill_diagonal(img, 2.0)
        X[i] = img.ravel()
        y[i] = c + 1
    return X, y


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _same_params(port_clf, jax_clf, bar=1e-9):
    """Every parameter within `bar` of the JAX package's, relative to the
    largest parameter value of the model: a conv bias followed by batch
    norm has an exactly-zero gradient, so its values are rounding noise
    (1e-10 after a few steps) in both packages, and only the model's
    scale measures them."""
    assert set(port_clf.params) == set(jax_clf.params)
    scale = max(float(np.abs(np.asarray(v)).max())
                for v in jax_clf.params.values())
    for k, v in jax_clf.params.items():
        a, b = _np(port_clf.params[k]), np.asarray(v)
        assert a.shape == b.shape, k
        assert float(np.abs(a - b).max()) <= bar * scale, k


def _jax_proba(j, X):
    """The JAX estimator's predict_proba on one device: its own
    predict_proba runs under a fresh DMLConfig, whose exec_mode AUTO
    shards over the conftest's 8-device mesh."""
    from systemml_tpu.api.mlcontext import MLContext, dml
    from systemml_tpu.models.estimators import _nn_base_dir

    s = dml(j.get_prediction_script())
    s.base_dir = _nn_base_dir()
    s.input("X", np.asarray(X, dtype=float))
    for n, v in j.params.items():
        s.input(n, v)
    cfg = JConfig()
    cfg.exec_mode = "SINGLE_NODE"
    return MLContext(cfg).execute(s.output("probs")).get_matrix("probs")


def _fit_both(build, X, y, **kw):
    """The same estimator built from each package's NetSpec API, fitted
    on the same data; returns (port, jax)."""
    p = build(T, **kw).fit(X, y)
    j = build(J, **kw).fit(X, y)
    _same_params(p, j)
    np.testing.assert_allclose(p.predict_proba(X[:16]), _jax_proba(j, X[:16]),
                               rtol=1e-9, atol=1e-12)
    return p, j


def _lenet(m, **kw):
    spec = (m.NetSpec((1, 8, 8)).conv(8, 3, pad=1).relu().pool(2, 2)
            .dense(32).relu().dense(3).softmax_loss())
    return m.Caffe2DML(spec, **kw)


def _spec_lenet_dropout(m):
    return (m.NetSpec((1, 8, 8)).conv(8, 3, pad=1).relu().pool(2, 2)
            .dense(32).relu().dropout(0.5).dense(3).softmax_loss())


# ---- script generation ----------------------------------------------------

@pytest.mark.parametrize("optimizer", ["sgd", "sgd_momentum", "sgd_nesterov",
                                       "adam"])
def test_generated_scripts_equal_the_jax_packages(optimizer):
    from systemml_tpu_torch.lang.parser import parse

    for spec_t, spec_j in ((_spec_lenet_dropout(T), _spec_lenet_dropout(J)),
                           (zoo.resnet18(), jzoo.resnet18())):
        train = dmlgen.generate_training_script(spec_t, optimizer)
        ref = jdmlgen.generate_training_script(spec_j, optimizer)
        # the first line names the generating module
        assert train.splitlines()[1:] == ref.splitlines()[1:]
        assert dmlgen.generate_predict_script(spec_t).splitlines()[1:] == \
            jdmlgen.generate_predict_script(spec_j).splitlines()[1:]
        parse(train)
        parse(dmlgen.generate_predict_script(spec_t))


def test_spec_shapes():
    shapes = _spec_lenet_dropout(T).shapes()
    assert shapes[0] == (8, 8, 8) and shapes[2] == (8, 4, 4)
    assert shapes[-1] == (3, 1, 1)


def test_resnet18_spec_and_scripts_at_full_width():
    net = zoo.resnet18(num_classes=1000, input_shape=(3, 224, 224))
    net.validate()
    shp = net.shapes()
    assert shp == jzoo.resnet18().shapes()
    assert shp[0] == (64, 112, 112) and shp[3] == (64, 56, 56)
    assert shp[-3] == (512, 1, 1) and shp[-1] == (1000, 1, 1)
    assert sum(1 for l in net.layers if l.type == "Eltwise") == 8
    assert sum(1 for l in net.layers if l.type == "Convolution") == 20
    assert sum(1 for l in net.layers if l.type == "BatchNorm") == 20
    from systemml_tpu_torch.lang.parser import parse

    train = dmlgen.generate_training_script(net)
    parse(train)
    parse(dmlgen.generate_predict_script(net))
    assert "for (it in 1:(epochs * iters))" in train   # one flat loop
    assert len(dmlgen.param_names(net)) == 2 * 21 + 4 * 20


def test_eltwise_validation():
    net = T.NetSpec((1, 8, 8))
    net.conv(4, kernel_size=3, pad=1, name="a")
    net.conv(8, kernel_size=3, pad=1, name="b")
    with pytest.raises(NetSpecError, match="mismatch"):
        net.eltwise(bottom2="a", name="bad")
        net.shapes()


# ---- Caffe2DML fits: both packages from one seed --------------------------

def test_lenet_trains_on_digits(rng):
    X, y = _digits(rng)
    p, j = _fit_both(_lenet, X, y - 1, optimizer="sgd_nesterov", epochs=4,
                     batch_size=32, lr=0.05)
    assert set(np.unique(p.predict(X[:20]))) <= {0.0, 1.0, 2.0}
    assert p.score(X, y - 1) > 0.9
    np.testing.assert_allclose(p.predict_proba(X[:5]).sum(1), 1.0, rtol=1e-6)


def test_tiny_convnet_and_its_region(rng):
    from systemml_tpu_torch.runtime import loopfuse

    x = rng.standard_normal((64, 64))
    y = np.arange(64) % 10
    p, _ = _fit_both(lambda m, **kw: m.Caffe2DML(
        (zoo if m is T else jzoo).tiny_convnet(), **kw),
        x, y, epochs=2, batch_size=16, seed=1)
    rep = loopfuse.region_report(p._fit_prog)
    assert rep[0]["entries"] == 1 and rep[0]["refused"] is None
    text = p.fit_stats_.display()
    assert "Loop regions" in text and "DNN hot path" in text


def test_batchnorm_adam_path(rng):
    X, y = _digits(rng, n=120)

    def build(m, **kw):
        spec = (m.NetSpec((1, 8, 8)).conv(4, 3, pad=1).batch_norm().relu()
                .pool(2, 2).dense(3).softmax_loss())
        return m.Caffe2DML(spec, **kw)

    p, _ = _fit_both(build, X, y, optimizer="adam", epochs=3, batch_size=40,
                     lr=0.01)
    assert p.score(X, y) > 0.8


def test_tiny_resnet_trains(rng):
    def build(m, **kw):
        net = m.NetSpec((1, 8, 8))
        net.conv(4, kernel_size=3, stride=1, pad=1, name="stem")
        net.relu(name="stemr")
        (zoo if m is T else jzoo)._basic_block(net, "blk", 4, 8, 2,
                                               "stemr")
        net.pool(kernel_size=4, stride=1, pad=0, pool="AVE", name="gap")
        net.dense(2, name="fc")
        net.softmax_loss()
        net.validate()
        return m.Caffe2DML(net, **kw)

    n = 32
    y = np.repeat([1.0, 2.0], n // 2)
    x = rng.normal(size=(n, 64)) * 0.2
    x[y == 2.0] += 1.0
    p, _ = _fit_both(build, x, y, epochs=6, batch_size=16, lr=0.05, seed=0)
    assert p.score(x, y) >= 0.9
    probs = p.predict_proba(x)
    assert probs.shape == (n, 2)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)


def _stem_and_block():
    """ResNet-18's stem (7x7/2 conv, batch norm, 3x3/2 max pool with
    padding 1) and one basic block with its 1x1/2 shortcut, at 3x32x32."""
    net = T.NetSpec((3, 32, 32))
    net.conv(8, kernel_size=7, stride=2, pad=3, name="stem")
    net.batch_norm(name="stemn")
    net.relu(name="stemr")
    net.pool(kernel_size=3, stride=2, pad=1, name="stemp")
    zoo._basic_block(net, "blk", 8, 16, 2, "stemp")
    net.pool(kernel_size=4, stride=1, pad=0, pool="AVE", name="gap")
    net.dense(3, name="fc")
    net.softmax_loss()
    return net


@pytest.mark.parametrize("precision,bar", [("double", 1e-12),
                                           ("single", 1e-4)])
def test_conv_arms_update_alike(precision, bar, rng, monkeypatch):
    """chip_smoke.py's im2col check at a small size: two sgd_momentum
    steps from the same seeded init under each conv arm. Their updates of
    the learned parameters (the batch norms' running statistics left
    out) agree to 1e-12 normwise in fp64 and to 1e-4 in fp32 (the two
    arms sum in another order; at ResNet-18's full depth and width the
    fp32 updates round further apart, hence the card check's wider bar);
    with im2col's filter gradient halved they differ by more than 0.3."""
    from systemml_tpu_torch.ops import dnn

    x = rng.standard_normal((16, 3 * 32 * 32))
    y = np.arange(16) % 3 + 1.0
    x += 0.5 * y[:, None]

    def fit(algo, n, lr=0.01):
        cfg = DMLConfig(device="cpu")
        cfg.conv_algorithm = algo
        cfg.floating_point_precision = precision
        set_config(cfg)
        clf = T.Caffe2DML(_stem_and_block(), epochs=1, batch_size=8,
                          lr=lr, seed=3).fit(x[:n], y[:n])
        return {k: v.double() for k, v in clf.params.items()
                if not k.startswith("EMA")}

    def rel(a, b, start):
        num = sum(float(torch.sum((a[k] - b[k]) ** 2)) for k in a)
        den = sum(float(torch.sum((b[k] - start[k]) ** 2)) for k in a)
        return (num / den) ** 0.5

    start = fit("conv", 8, lr=0.0)            # the seeded init itself
    conv, im2col = fit("conv", 16), fit("im2col", 16)
    assert rel(im2col, conv, start) <= bar
    sound = dnn.conv2d_backward_filter
    monkeypatch.setattr(dnn, "conv2d_backward_filter",
                        lambda *a, **k: 0.5 * sound(*a, **k))
    assert rel(fit("im2col", 16), conv, start) > 0.3


def test_ragged_tail_trains(rng):
    def build(m, **kw):
        net = m.NetSpec((1, 4, 4)).dense(8).relu().dense(2).softmax_loss()
        return m.Caffe2DML(net, **kw)

    n = 20
    y = np.repeat([1.0, 2.0], n // 2)
    x = rng.normal(size=(n, 16)) * 0.3
    x[y == 2.0] += 1.5
    p, _ = _fit_both(build, x, y, epochs=30, batch_size=16, lr=0.1, seed=1)
    assert p.score(x, y) >= 0.9


_NET = """
name: "TinyNet"
input_shape { dim: 1 dim: 1 dim: 8 dim: 8 }
layer {
  name: "conv1"  type: "Convolution"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 1 }
}
layer { name: "relu1" type: "ReLU" }
layer {
  name: "pool1" type: "Pooling"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 }
}
layer {
  name: "ip1" type: "InnerProduct"
  inner_product_param { num_output: 3 }
}
layer { name: "loss" type: "SoftmaxWithLoss" }
"""
_SOLVER = """
base_lr: 0.05
momentum: 0.9
weight_decay: 0.0005
max_iter: 100
type: "Nesterov"
"""


def test_from_prototxt(tmp_path, rng):
    net, solver = tmp_path / "net.prototxt", tmp_path / "solver.prototxt"
    net.write_text(_NET)
    solver.write_text(_SOLVER)

    def build(m, **kw):
        return m.Caffe2DML(network_file=str(net), solver_file=str(solver),
                           **kw)

    assert build(T).optimizer == "sgd_nesterov"
    assert build(T).hyper["lr"] == 0.05
    X, y = _digits(rng, n=120)
    p, _ = _fit_both(build, X, y, epochs=3, batch_size=40)
    assert p.score(X, y) > 0.75


# ---- Keras2DML (duck-typed: no keras installed) ---------------------------

def _fake(cls, **kw):
    o = type(cls, (), {})()
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def _flayer(cls, *parents, **kw):
    o = _fake(cls, **kw)
    o._inbound_nodes = [_fake("Node", inbound_layers=list(parents))]
    return o


def _sequential():
    return _fake("Sequential", layers=[
        _fake("Conv2D", filters=4, kernel_size=(3, 3), strides=(1, 1),
              padding="same", activation="relu"),
        _fake("MaxPooling2D", pool_size=(2, 2)), _fake("Flatten"),
        _fake("Dense", units=16, activation="relu"),
        _fake("Dense", units=3, activation="softmax")])


def _residual():
    inp = _flayer("InputLayer", name="input")
    c1 = _flayer("Conv2D", inp, name="c1", filters=4, kernel_size=3,
                 strides=1, padding="same", activation="relu")
    c2 = _flayer("Conv2D", c1, name="c2", filters=4, kernel_size=3,
                 strides=1, padding="same", activation=None)
    add = _flayer("Add", c1, c2, name="res_add")
    act = _flayer("Activation", add, name="res_relu", activation="relu")
    fl = _flayer("Flatten", act, name="flat")
    d1 = _flayer("Dense", fl, name="fc", units=3, activation="softmax")
    return _fake("Model", layers=[inp, c1, c2, add, act, fl, d1])


def _concat():
    inp = _flayer("InputLayer", name="input")
    c1 = _flayer("Conv2D", inp, name="b1", filters=3, kernel_size=3,
                 strides=1, padding="same", activation="relu")
    c2 = _flayer("Conv2D", inp, name="b2", filters=5, kernel_size=3,
                 strides=1, padding="same", activation="relu")
    cat = _flayer("Concatenate", c1, c2, name="merge")
    fl = _flayer("Flatten", cat, name="flat")
    d = _flayer("Dense", fl, name="fc", units=3, activation="softmax")
    return _fake("Model", layers=[inp, c1, c2, cat, fl, d])


@pytest.mark.parametrize("model", [_sequential, _residual, _concat])
def test_keras_models_convert_and_train(model, rng):
    X, y = _digits(rng, n=120)

    def build(m, **kw):
        return m.Keras2DML(model(), input_shape=(1, 8, 8), **kw)

    pk, jk = build(T), build(J)
    assert [(l.type, l.bottom, l.bottom2) for l in pk.spec.layers] == \
        [(l.type, l.bottom, l.bottom2) for l in jk.spec.layers]
    p, _ = _fit_both(build, X, y, epochs=3, batch_size=40, lr=0.05)
    assert p.score(X, y) > 0.75


def test_keras_residual_matches_native_wiring(rng):
    native = T.NetSpec((1, 8, 8))
    native.conv(4, 3, stride=1, pad=1, name="c1", bottom=DATA_BOTTOM)
    native.relu(name="c1_act", bottom="c1")
    native.conv(4, 3, stride=1, pad=1, name="c2", bottom="c1_act")
    native.eltwise(bottom2="c2", bottom="c1_act", name="res_add")
    native.relu(name="res_relu", bottom="res_add")
    native.dense(3, name="fc", bottom="res_relu")
    native.softmax_loss(name="fc_act", bottom="fc")
    keras_spec = T.Keras2DML(_residual(), input_shape=(1, 8, 8)).spec
    assert [(l.type, l.bottom, l.bottom2) for l in keras_spec.layers] \
        == [(l.type, l.bottom, l.bottom2) for l in native.layers]
    X, y = _digits(rng, n=120)
    a = T.Caffe2DML(native, epochs=2, batch_size=40, lr=0.05, seed=11)
    b = T.Keras2DML(_residual(), input_shape=(1, 8, 8), epochs=2,
                    batch_size=40, lr=0.05, seed=11)
    np.testing.assert_allclose(a.fit(X, y).predict_proba(X),
                               b.fit(X, y).predict_proba(X), atol=1e-12)


# ---- parameters carried over; the upload cache; the bf16 policy ----------

def test_predict_from_jax_parameters(rng):
    """load_params carries the JAX estimator's fitted parameters into the
    port's; its predict_proba then equals the JAX package's."""
    X, y = _digits(rng, n=120)
    j = _lenet(J, epochs=2, batch_size=40, lr=0.05).fit(X, y)
    p = _lenet(T).load_params({k: np.asarray(v) for k, v in j.params.items()},
                              classes=j.classes_)
    np.testing.assert_allclose(p.predict_proba(X), _jax_proba(j, X),
                               rtol=1e-9, atol=1e-12)
    assert np.array_equal(p.predict(X),
                          j.classes_[np.argmax(_jax_proba(j, X), axis=1)])
    with pytest.raises(NetSpecError, match="missing"):
        _lenet(T).load_params({"W1": np.zeros((8, 9))})


def test_fit_input_cache_detects_mutation(rng):
    clf = T.Caffe2DML(zoo.tiny_convnet(), epochs=1, batch_size=16, seed=1)
    X = rng.standard_normal((32, 64))
    y = np.arange(32) % 10
    clf.fit(X, y)
    first = clf._input_cache["X"][2]
    clf.fit(X, y)
    assert clf._input_cache["X"][2] is first
    X[:] = rng.standard_normal((32, 64))
    clf.fit(X, y)
    assert clf._input_cache["X"][2] is not first
    t = torch.from_numpy(rng.standard_normal((32, 64)))
    clf.fit(t, y)
    again = clf._input_cache["X"][2]
    clf.fit(t, y)
    assert clf._input_cache["X"][2] is again
    fp = clf._input_cache["X"][1]
    t.add_(1.0)
    clf.fit(t, y)
    assert clf._input_cache["X"][1] != fp   # an in-place write re-keys


def test_bf16_policy_fit_within_the_hotpath_bar(rng):
    """Under precision="bfloat16" the fit keeps fp32 master weights and
    lands within 4e-2 of the fp32 ("single") fit of both packages."""
    x = rng.standard_normal((32, 64))
    y = np.arange(32) % 10
    fits = {}
    for prec in ("single", "bfloat16"):
        fits[prec] = T.Caffe2DML(zoo.tiny_convnet(), epochs=1, batch_size=16,
                                 seed=1, precision=prec).fit(x, y)
    j = J.Caffe2DML(jzoo.tiny_convnet(), epochs=1, batch_size=16, seed=1,
                    precision="single").fit(x, y)
    _same_params(fits["single"], j, bar=1e-5)
    for k, v in fits["bfloat16"].params.items():
        assert v.dtype == torch.float32
        ref = np.asarray(j.params[k])
        err = np.abs(_np(v) - ref).max() / np.abs(ref).max()
        assert err < 4e-2, k


# ---- mllearn ----------------------------------------------------------------

def test_logistic_regression(rng):
    x = rng.standard_normal((300, 4))
    y = (x @ np.array([2.0, -1.5, 0.5, 0.0]) > 0).astype(float)
    p = T.LogisticRegression(max_iter=40).fit(x, y)
    j = J.LogisticRegression(max_iter=40).fit(x, y)
    np.testing.assert_allclose(p.coef_, j.coef_, rtol=1e-9, atol=1e-12)
    assert p.score(x, y) > 0.95
    np.testing.assert_allclose(p.predict_proba(x).sum(1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("solver", ["newton-cg", "direct-solve"])
def test_linear_regression(solver, rng):
    x = rng.standard_normal((200, 5))
    y = x @ rng.standard_normal(5) + 0.01 * rng.standard_normal(200)
    p = T.LinearRegression(solver=solver, fit_intercept=False).fit(x, y)
    j = J.LinearRegression(solver=solver, fit_intercept=False).fit(x, y)
    np.testing.assert_allclose(p.coef_, j.coef_, rtol=1e-9, atol=1e-12)
    assert p.score(x, y) > 0.999


def test_svm_binary_and_multi(rng):
    n = 240
    x = rng.standard_normal((n, 3))
    yb = np.where(x[:, 0] + x[:, 1] > 0, 3.0, 7.0)
    p, j = T.SVM(max_iter=100).fit(x, yb), J.SVM(max_iter=100).fit(x, yb)
    assert np.array_equal(p.predict(x), j.predict(x))
    assert p.score(x, yb) > 0.95
    centers = np.array([[3, 0, 0], [-3, 1, 0], [0, -4, 0]])
    xm = np.vstack([c + 0.5 * rng.standard_normal((n // 3, 3))
                    for c in centers])
    ym = np.repeat([10.0, 20.0, 30.0], n // 3)
    p, j = T.SVM(max_iter=60).fit(xm, ym), J.SVM(max_iter=60).fit(xm, ym)
    assert np.array_equal(p.predict(xm), j.predict(xm))
    assert p.score(xm, ym) > 0.95


def test_naive_bayes(rng):
    n = 200
    x = np.vstack([rng.poisson([6, 1, 1], (n // 2, 3)),
                   rng.poisson([1, 1, 6], (n // 2, 3))]).astype(float)
    y = np.repeat([1.0, 2.0], n // 2)
    p = T.NaiveBayes(laplace=1.0).fit(x, y)
    j = J.NaiveBayes(laplace=1.0).fit(x, y)
    assert np.array_equal(p.predict(x), j.predict(x))
    assert p.score(x, y) > 0.95
