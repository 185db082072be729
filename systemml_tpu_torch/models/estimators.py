# Port of systemml_tpu/models/estimators.py: the same estimators, whose fit runs
# over the port's compile_program on the device of the active config.
"""Caffe2DML / Keras2DML estimator APIs.

Equivalents of the reference's deep-learning estimators:
* Caffe2DML (src/main/scala/org/apache/sysml/api/dl/Caffe2DML.scala:209
  fit, :308 getTrainingScript) — proto/NetSpec -> generated DML training
  and scoring scripts executed through MLContext;
* Keras2DML (src/main/python/systemml/mllearn/estimators.py:910,
  keras2caffe.py) — a Keras Sequential model mapped onto the same
  NetSpec (duck-typed: anything exposing `.layers` with Keras-style
  class names and attributes works, no TensorFlow import required).

Fit and predict run on the device of the active config
(utils/config.get_config; "cuda" unless the caller sets "cpu"), under the
estimator's precision policy. Fitted parameters stay on that device as
torch tensors; `load_params` installs parameters fitted elsewhere (the
JAX package's, as numpy arrays).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from systemml_tpu_torch.models.dmlgen import (generate_predict_script,
                                        generate_training_script,
                                        param_names)
from systemml_tpu_torch.models.netspec import NetSpec, NetSpecError


def _nn_base_dir() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "scripts"))


def _host(a) -> np.ndarray:
    """A numpy copy of a host array or a torch tensor."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _host_or_device(a):
    """X as fit/predict take it: a torch tensor (already on the device,
    as a generator on the card makes it) as it is, else a float array."""
    return a if hasattr(a, "detach") else np.asarray(a, dtype=float)


def _one_hot(y: np.ndarray, classes: np.ndarray) -> np.ndarray:
    y = np.asarray(y).reshape(-1)
    idx = {c: i for i, c in enumerate(classes)}
    out = np.zeros((y.size, len(classes)))
    out[np.arange(y.size), [idx[v] for v in y]] = 1.0
    return out


class Caffe2DML:
    """Estimator over a NetSpec (or Caffe prototxt files).

    >>> spec = NetSpec((1, 28, 28)).conv(32, 5, pad=2).relu().pool() \\
    ...        .dense(10).softmax_loss()
    >>> clf = Caffe2DML(spec, epochs=2).fit(X, y)
    >>> yhat = clf.predict(Xtest)
    """

    def __init__(self, spec: Optional[NetSpec] = None,
                 solver_file: Optional[str] = None,
                 network_file: Optional[str] = None,
                 input_shape: Optional[Tuple[int, int, int]] = None,
                 optimizer: str = "sgd_momentum", epochs: int = 5,
                 batch_size: int = 64, lr: float = 0.01, momentum: float = 0.9,
                 decay: float = 0.95, reg: float = 0.0, seed: int = 42,
                 precision: str = "auto"):
        if spec is None:
            if network_file is None:
                raise NetSpecError("pass a NetSpec or a network_file")
            from systemml_tpu_torch.models.proto import (netspec_from_prototxt,
                                                   solver_from_prototxt)

            with open(network_file) as f:
                spec = netspec_from_prototxt(f.read(), input_shape)
            if solver_file:
                with open(solver_file) as f:
                    sol = solver_from_prototxt(f.read())
                lr = sol.get("base_lr", lr)
                momentum = sol.get("momentum", momentum)
                reg = sol.get("weight_decay", reg)
                st = sol.get("type", "").lower()
                if st in ("adam",):
                    optimizer = "adam"
                elif st in ("nesterov",):
                    optimizer = "sgd_nesterov"
        spec.validate()
        self.spec = spec
        self.optimizer = optimizer
        # precision policy for fit/predict ("auto" inherits the ambient
        # config; "bfloat16" = mixed bf16 compute / fp32 master weights,
        # "single"/"double" as in DMLConfig.floating_point_precision)
        self.precision = precision
        self.hyper = dict(epochs=epochs, batch_size=batch_size, lr=lr,
                          mu=momentum, decay=decay, reg=reg, seed=seed)
        # fitted parameters, name -> torch tensor on the run's device
        # (.cpu().numpy() for a numpy copy)
        self.params: Dict[str, Any] = {}
        # device-upload cache for fit() inputs, keyed on (object
        # identity, sampled-content fingerprint): re-fitting on the
        # SAME unmodified X/y — the steady-state benchmark/epoch-sweep
        # pattern — re-uses the device copies instead of re-uploading
        # per fit; an in-place refill re-uploads (see _fingerprint)
        self._input_cache: Dict[str, Tuple[Any, Any, Any]] = {}
        self._train_src = generate_training_script(spec, optimizer,
                                                   precision=precision)
        self._predict_src = generate_predict_script(spec)

    def _run_config(self):
        """A copy of the active config with this estimator's precision
        policy."""
        from systemml_tpu_torch.utils.config import get_config

        cfg = get_config().copy()
        if self.precision != "auto":
            cfg.floating_point_precision = self.precision
        return cfg

    def _config_scope(self):
        """Installs `_run_config()` (and its matmul precision switches)
        for the duration of a fit."""
        import contextlib

        from systemml_tpu_torch.utils.config import (apply_matmul_precision,
                                                     get_config, set_config)

        @contextlib.contextmanager
        def scope():
            prev = get_config()
            cfg = self._run_config()
            set_config(cfg)
            try:
                apply_matmul_precision()
                yield cfg
            finally:
                set_config(prev)

        return scope()

    # ---- scripts (the reference exposes get_training_script) -------------

    def get_training_script(self) -> str:
        return self._train_src

    def get_prediction_script(self) -> str:
        return self._predict_src

    # ---- estimator surface ----------------------------------------------

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Caffe2DML":
        """Train on (X, y). Device uploads of X/y are cached keyed on
        the array objects (plus a sampled-content fingerprint), so a
        steady-state re-fit on the same arrays issues no host->device
        transfer; the cached device copies stay resident for the
        estimator's lifetime — drop the estimator (or fit on fresh
        arrays) to release them."""
        self.classes_ = np.unique(_host(y).reshape(-1))
        if len(self.classes_) != self.spec.num_classes():
            raise NetSpecError(
                f"y has {len(self.classes_)} classes but the net's final "
                f"InnerProduct outputs {self.spec.num_classes()}")
        names = param_names(self.spec)
        with self._config_scope():
            return self._fit_prepared(X, y, names)

    def _fit_prepared(self, X, y, names):
        from systemml_tpu_torch.api.mlcontext import dml
        from systemml_tpu_torch.ops import datagen

        # prepare-once, fit-many (the JMLC contract): re-executing the
        # SAME Program hits its per-block plan caches and fused-loop
        # cache, so a warm re-fit re-traces nothing — rebuilding the
        # Program per fit() cost ~2.5s of pure re-tracing per call
        from systemml_tpu_torch.utils.config import get_config, resolve_device

        cfg = get_config()
        device = resolve_device(cfg)
        key = (tuple(X.shape) if hasattr(X, "shape") else np.shape(X),
               len(self.classes_), self.precision,
               tuple(sorted(self.hyper.items())), cfg.device,
               cfg.optlevel, cfg.codegen_enabled, cfg.conv_algorithm,
               cfg.conv_layout, cfg.floating_point_precision)
        if getattr(self, "_fit_prog_key", None) != key:
            from systemml_tpu_torch.runtime.program import compile_program

            # multi-host init waits for ROADMAP queue 1, distributed and
            # elastic (item 12); the JAX package's XLA disk cache has no
            # counterpart (kernels are built by nvcc into _build/)
            s = dml(self._train_src)
            s.base_dir = _nn_base_dir()
            s.output(*names)
            self._fit_prog = compile_program(
                s.parse(), clargs=dict(self.hyper), outputs=names,
                input_names=["X", "Y"])
            self._fit_prog_key = key
        # seed the unseeded rand() in layer init fns so fit() is
        # reproducible regardless of what ran before in the process
        # (reference: the CLI -seed contract)
        datagen.set_global_seed(int(self.hyper["seed"]))
        # FRESH stats per fit (plan caches stay): resetting in place
        # would retroactively zero a fit_stats_ a caller saved earlier
        self._fit_prog.fresh_stats()
        try:
            from systemml_tpu_torch.api.mlcontext import _unwrap_input

            # batched input feeding: identity-keyed device-copy reuse —
            # a steady-state re-fit on the same arrays issues ZERO
            # host->device uploads, so the warm fit is the fused train
            # loop's single dispatch plus the parameter-init block
            inputs = {
                "X": self._upload("X", X, lambda: _unwrap_input(
                    _host_or_device(X), device)),
                "Y": self._upload("Y", y, lambda: _unwrap_input(
                    _one_hot(_host(y), self.classes_), device)),
            }
            ec = self._fit_prog.execute(inputs=inputs, printer=print)
        finally:
            datagen.set_global_seed(None)
        self.fit_stats_ = self._fit_prog.stats
        missing = [n for n in names if n not in ec.vars]
        if missing:
            raise RuntimeError(
                f"training script did not produce parameter outputs "
                f"{missing}")
        res = {n: ec.vars[n] for n in names}
        if hasattr(ec.vars, "release"):
            ec.vars.release()  # drop the run's pool scope (rebind-many)
        # parameters stay on the device: predict() feeds them straight
        # back as inputs
        from systemml_tpu_torch.runtime.bufferpool import resolve

        def _arr(v):
            v = resolve(v)
            return v.array if hasattr(v, "array") else v

        self.params = {n: _arr(v) for n, v in res.items()}
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)   # the training barrier
        return self

    def load_params(self, params: Dict[str, Any],
                    classes: Optional[np.ndarray] = None) -> "Caffe2DML":
        """Installs fitted parameters (name -> array, e.g. the JAX
        package's estimator's `params` as numpy arrays) on the active
        config's device in its value dtype, as fit() would leave them;
        `classes` is the label space (default 0 .. num_classes - 1)."""
        from systemml_tpu_torch.api.mlcontext import _unwrap_input
        from systemml_tpu_torch.utils.config import resolve_device

        missing = [n for n in param_names(self.spec) if n not in params]
        if missing:
            raise NetSpecError(f"load_params: missing {missing}")
        with self._config_scope() as cfg:
            device = resolve_device(cfg)
            self.params = {n: _unwrap_input(np.asarray(v, dtype=float),
                                            device)
                           for n, v in params.items()}
        self.classes_ = (np.arange(self.spec.num_classes())
                         if classes is None else np.asarray(classes))
        return self

    @staticmethod
    def _fingerprint(obj):
        if hasattr(obj, "detach"):
            # a device tensor: its version counter moves on every in-place
            # write, with no host read of its data
            return (tuple(obj.shape), str(obj.dtype), obj.device.type,
                    obj._version)
        return Caffe2DML._host_fingerprint(obj)

    @staticmethod
    def _host_fingerprint(obj):
        """Cheap mutation guard for the upload cache: shape + dtype + 16
        strided sample values. Catches the sklearn-style in-place
        refill (`X[:] = next_chunk`) that identity keying alone would
        silently train stale data on; a crafted mutation that preserves
        every sampled value can still slip through — pass a fresh array
        when in doubt."""
        a = np.asarray(obj)
        if a.size == 0:
            return (a.shape, str(a.dtype))
        flat = a.reshape(-1)
        idx = np.linspace(0, flat.size - 1, num=min(16, flat.size),
                          dtype=int)
        return (a.shape, str(a.dtype), flat[idx].tobytes())

    def _upload(self, name: str, obj, make):
        """Identity-keyed device-copy cache (the PreparedScript
        set_matrix contract): binding the SAME unmodified host object
        again skips the host->device upload; a different object — or
        the same object failing the sampled-content fingerprint —
        re-uploads."""
        fp = self._fingerprint(obj)
        cached = self._input_cache.get(name)
        if cached is not None and cached[0] is obj and cached[1] == fp:
            return cached[2]
        v = make()
        self._input_cache[name] = (obj, fp, v)
        return v

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        if not self.params:
            raise RuntimeError("fit() the model first")
        from systemml_tpu_torch.api.mlcontext import MLContext, dml

        # MLContext installs its OWN config for the run: the active
        # config with the estimator's precision policy
        cfg = self._run_config()
        s = dml(self._predict_src)
        s.base_dir = _nn_base_dir()
        s.input("X", _host_or_device(X))
        for n, v in self.params.items():
            s.input(n, v)
        res = MLContext(cfg).execute(s.output("probs"))
        return res.get_matrix("probs")

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predictions in the ORIGINAL label space seen at fit time."""
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        return float((self.predict(X) == _host(y).reshape(-1)).mean())


class Keras2DML(Caffe2DML):
    """Keras Sequential -> NetSpec -> Caffe2DML (reference:
    mllearn/estimators.py:910 + keras2caffe.py). Duck-typed: the model
    needs `.layers`, each with `.__class__.__name__` and the usual Keras
    attributes (filters, kernel_size, strides, padding, units, rate,
    activation)."""

    def __init__(self, model, input_shape: Tuple[int, int, int], **kw):
        spec = _keras_to_netspec(model, input_shape)
        super().__init__(spec, **kw)


def _keras_inbound(lyr):
    """Parent layers of a Keras layer (functional graphs), duck-typed on
    the `_inbound_nodes`/`inbound_nodes` attributes the reference's
    converter walks (keras2caffe.py:59-60,192-194). [] = unknown/none."""
    nodes = (getattr(lyr, "_inbound_nodes", None)
             or getattr(lyr, "inbound_nodes", None))
    if not nodes:
        return []
    nd = nodes[0]
    inb = getattr(nd, "inbound_layers", [])
    if not isinstance(inb, (list, tuple)):
        inb = [inb]
    return list(inb)


def _is_functional(model) -> bool:
    """A model needs graph conversion when any layer merges inputs
    (Add/Concatenate) or declares multiple inbound layers."""
    for lyr in getattr(model, "layers", ()):
        if lyr.__class__.__name__ in ("Add", "Concatenate"):
            return True
        if len(_keras_inbound(lyr)) > 1:
            return True
    return False


def _keras_to_netspec(model, input_shape) -> NetSpec:
    if _is_functional(model):
        return _keras_graph_to_netspec(model, input_shape)
    spec = NetSpec(input_shape)

    def add_activation(act):
        if act in (None, "linear"):
            return
        if act == "relu":
            spec.relu()
        elif act == "sigmoid":
            spec.add("Sigmoid")
        elif act == "tanh":
            spec.add("TanH")
        elif act == "softmax":
            spec.softmax_loss()
        else:
            raise NetSpecError(f"unsupported keras activation {act!r}")

    for lyr in model.layers:
        cls = lyr.__class__.__name__
        if cls == "InputLayer":
            continue
        act = getattr(lyr, "activation", None)
        act = getattr(act, "__name__", act)
        if cls == "Conv2D":
            ks = lyr.kernel_size
            ks = ks[0] if isinstance(ks, (tuple, list)) else ks
            st = getattr(lyr, "strides", (1, 1))
            st = st[0] if isinstance(st, (tuple, list)) else st
            pad = (ks // 2 if getattr(lyr, "padding", "valid") == "same"
                   else 0)
            spec.conv(lyr.filters, ks, stride=st, pad=pad)
            add_activation(act)
        elif cls == "MaxPooling2D":
            ps = getattr(lyr, "pool_size", (2, 2))
            ps = ps[0] if isinstance(ps, (tuple, list)) else ps
            spec.pool(ps, stride=ps, pool="MAX")
        elif cls == "AveragePooling2D":
            ps = getattr(lyr, "pool_size", (2, 2))
            ps = ps[0] if isinstance(ps, (tuple, list)) else ps
            spec.pool(ps, stride=ps, pool="AVE")
        elif cls == "Dense":
            spec.dense(lyr.units)
            add_activation(act)
        elif cls == "Dropout":
            spec.dropout(lyr.rate)
        elif cls == "BatchNormalization":
            spec.batch_norm()
        elif cls == "Activation":
            add_activation(act)
        elif cls == "Flatten":
            continue  # implicit: InnerProduct flattens
        else:
            raise NetSpecError(f"unsupported keras layer {cls!r}")
    if spec.layers and spec.layers[-1].type != "SoftmaxWithLoss":
        spec.softmax_loss()
    return spec


def _keras_graph_to_netspec(model, input_shape) -> NetSpec:
    """Functional-model conversion: walks model.layers (Keras lists them
    topologically), wiring each NetSpec layer's `bottom` to the mapped
    output of its inbound layer; Add -> Eltwise, Concatenate -> Concat
    (reference: keras2caffe.py graph traversal). A Keras ResNet converts
    to the same Eltwise-residual DAG models/zoo.py builds natively."""
    from systemml_tpu_torch.models.netspec import DATA_BOTTOM

    spec = NetSpec(input_shape)
    # keras layer (by id) -> name of the NetSpec layer carrying its
    # output; DATA_BOTTOM = the raw data input (an explicit sentinel —
    # bottom=None would wire to the PREVIOUS layer in list order, which
    # silently mis-wires a second branch off the input)
    mapped: dict = {}

    def out_name(klyr):
        key = id(klyr)
        if key not in mapped:
            raise NetSpecError(
                f"layer {getattr(klyr, 'name', klyr)!r} referenced before "
                f"definition (is model.layers topological?)")
        return mapped[key]

    def bottom_of(lyr):
        inb = _keras_inbound(lyr)
        if not inb:
            return None    # chain fallback: previous layer
        return out_name(inb[0])

    def add_activation(act, base, name=None):
        if act in (None, "linear"):
            return base
        nm = name or (f"{base}_act" if base
                      else f"act{len(spec.layers) + 1}")
        if act == "relu":
            spec.relu(name=nm, bottom=base)
        elif act == "sigmoid":
            spec.add("Sigmoid", name=nm, bottom=base)
        elif act == "tanh":
            spec.add("TanH", name=nm, bottom=base)
        elif act == "softmax":
            spec.softmax_loss(name=nm, bottom=base)
        else:
            raise NetSpecError(f"unsupported keras activation {act!r}")
        return nm

    for lyr in model.layers:
        cls = lyr.__class__.__name__
        kname = getattr(lyr, "name", None) or f"l{len(spec.layers) + 1}"
        act = getattr(lyr, "activation", None)
        act = getattr(act, "__name__", act)
        if cls == "InputLayer":
            mapped[id(lyr)] = DATA_BOTTOM
            continue
        bot = bottom_of(lyr)
        if cls == "Conv2D":
            ks = lyr.kernel_size
            ks = ks[0] if isinstance(ks, (tuple, list)) else ks
            st = getattr(lyr, "strides", (1, 1))
            st = st[0] if isinstance(st, (tuple, list)) else st
            pad = (ks // 2 if getattr(lyr, "padding", "valid") == "same"
                   else 0)
            spec.conv(lyr.filters, ks, stride=st, pad=pad, name=kname,
                      bottom=bot)
            mapped[id(lyr)] = add_activation(act, kname)
        elif cls in ("MaxPooling2D", "AveragePooling2D"):
            ps = getattr(lyr, "pool_size", (2, 2))
            ps = ps[0] if isinstance(ps, (tuple, list)) else ps
            spec.pool(ps, stride=ps,
                      pool="MAX" if cls == "MaxPooling2D" else "AVE",
                      name=kname, bottom=bot)
            mapped[id(lyr)] = kname
        elif cls == "Dense":
            spec.dense(lyr.units, name=kname, bottom=bot)
            mapped[id(lyr)] = add_activation(act, kname)
        elif cls == "Dropout":
            spec.dropout(lyr.rate, name=kname, bottom=bot)
            mapped[id(lyr)] = kname
        elif cls == "BatchNormalization":
            spec.batch_norm(name=kname, bottom=bot)
            mapped[id(lyr)] = kname
        elif cls == "Activation":
            mapped[id(lyr)] = add_activation(act, bot, name=kname)
        elif cls == "Flatten":
            mapped[id(lyr)] = bot   # implicit: InnerProduct flattens
        elif cls in ("Add", "Concatenate"):
            inb = _keras_inbound(lyr)
            if len(inb) != 2:
                raise NetSpecError(
                    f"{cls} {kname!r}: exactly 2 inputs supported, "
                    f"got {len(inb)}")
            b1, b2 = out_name(inb[0]), out_name(inb[1])
            if b1 == DATA_BOTTOM or b2 == DATA_BOTTOM or b1 is None \
                    or b2 is None:
                raise NetSpecError(f"{cls} {kname!r}: cannot merge the "
                                   f"raw data input")
            if cls == "Add":
                spec.eltwise(bottom2=b2, bottom=b1, name=kname)
            else:
                spec.concat(bottom2=b2, bottom=b1, name=kname)
            mapped[id(lyr)] = kname
        else:
            raise NetSpecError(f"unsupported keras layer {cls!r}")
    if spec.layers and spec.layers[-1].type != "SoftmaxWithLoss":
        spec.softmax_loss()
    return spec
