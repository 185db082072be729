# Copy of systemml_tpu/models/dmlgen.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""DML script generation from a NetSpec.

TPU-native equivalent of the reference's per-layer DML emission
(CaffeLayer.scala forward/backward snippets assembled by
Caffe2DML.getTrainingScript, dl/Caffe2DML.scala:308, and
DMLGenerator.scala). Each layer contributes forward lines, backward
lines (emitted in reverse), parameter init, and optimizer updates; the
generator threads the (C, H, W) shape through the chain and produces two
standalone scripts over scripts/nn:

  * training: minibatch SGD (sgd / sgd_momentum / sgd_nesterov / adam)
    with optional L2 regularization,
  * predict: batched forward pass in test mode emitting `probs`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from systemml_tpu_torch.models.netspec import Layer, NetSpec, NetSpecError

_OPTIMIZERS = {"sgd", "sgd_momentum", "sgd_nesterov", "adam"}


class _Emitter:
    def __init__(self):
        self.lines: List[str] = []

    def __call__(self, line: str = ""):
        self.lines.append(line)

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def _sources(spec: NetSpec, optimizer: str, nn_dir: str) -> List[str]:
    mods = {"InnerProduct": "affine", "Convolution": "conv2d_builtin",
            "Pooling": "max_pool2d_builtin", "ReLU": "relu",
            "Sigmoid": "sigmoid", "TanH": "tanh", "Dropout": "dropout",
            "BatchNorm": "batch_norm2d", "SoftmaxWithLoss": "softmax",
            "Softmax": "softmax"}
    need = {"softmax", "cross_entropy_loss", "l2_reg", optimizer}
    for l in spec.layers:
        m = mods.get(l.type)
        if m:
            need.add(m)
    avg = any(l.type == "Pooling" and l.pool.upper() == "AVE"
              for l in spec.layers)
    if avg:
        need.add("avg_pool2d_builtin")
    out = []
    for m in sorted(need):
        sub = "optim" if m in _OPTIMIZERS else "layers"
        alias = "opt" if m == optimizer else m
        out.append(f'source("{nn_dir}/{sub}/{m}.dml") as {alias}')
    return out


def _params_of(spec: NetSpec) -> List[Tuple[Layer, List[str]]]:
    """(layer, [param names]) for each trainable layer, in order."""
    out = []
    for idx, l in enumerate(spec.layers, 1):
        if l.type == "Convolution":
            out.append((l, [f"W{idx}", f"b{idx}"]))
        elif l.type == "InnerProduct":
            out.append((l, [f"W{idx}", f"b{idx}"]))
        elif l.type == "BatchNorm":
            out.append((l, [f"G{idx}", f"B{idx}"]))
    return out


def generate_training_script(spec: NetSpec, optimizer: str = "sgd_momentum",
                             nn_dir: str = "nn",
                             precision: str = "auto") -> str:
    """Full minibatch-SGD training script. Script contract:
    inputs  X (N x C*H*W), Y (N x K one-hot);
    args    $epochs, $batch_size, $lr, $mu, $decay, $reg, $seed;
    outputs every parameter matrix (W*/b*/G*/B*/EMA buffers).

    `precision` records the policy the script is generated for
    (auto | single | bfloat16 | double — the DMLConfig
    floating_point_precision values). Under "bfloat16" the runtime
    executes the conv/matmul ops in bf16 with fp32 accumulation while
    every DML matrix — in particular the W*/b* master weights and the
    v_*/m_* optimizer state this script updates — stays fp32
    (utils/config.default_dtype), so the generated update step IS the
    fp32-master-weight half of the mixed-precision recipe; no loss
    scaling is needed because gradients accumulate in fp32 end to end."""
    spec.validate()
    if optimizer not in _OPTIMIZERS:
        raise NetSpecError(f"unknown optimizer {optimizer!r}")
    e = _Emitter()
    e("# generated by systemml_tpu_torch.models.dmlgen (Caffe2DML analog)")
    if precision != "auto":
        e(f"# precision policy: {precision} (master weights + optimizer "
          f"state stay fp32 under bfloat16 mixed mode)")
    for s in _sources(spec, optimizer, nn_dir):
        e(s)
    e()
    c0, h0, w0 = spec.input_shape
    e(f"C = {c0}; Hin = {h0}; Win = {w0}")
    e('epochs = ifdef($epochs, 5)')
    e('batch_size = ifdef($batch_size, 64)')
    e('lr = ifdef($lr, 0.01)')
    e('mu = ifdef($mu, 0.9)')
    e('decay = ifdef($decay, 0.95)')
    e('reg = ifdef($reg, 0.0)')
    e('seedv = ifdef($seed, 42)')
    e("N = nrow(X)")
    e()
    _emit_param_init(e, spec, optimizer)
    e()
    # uniform batches keep every slice the same static shape, so the
    # batch loop compiles to one lax.fori_loop with dynamic-start
    # slicing (instead of a host dispatch per batch); the ragged tail is
    # its own statically-shaped step after the loop so EVERY row trains
    e("batch_size = min(batch_size, N)")
    e("iters = floor(N / batch_size)")
    e("tail = N - iters * batch_size")
    e("t = 0")
    # When the batch divides N (the common case), train in ONE flat
    # loop over epochs*iters: a nested epoch loop is host-interpreted
    # per epoch (its body contains the inner for), paying host syncs
    # and a predicate round-trip every epoch, while the flat loop fuses
    # the WHOLE training run into one device-side fori_loop. The
    # per-epoch lr decay becomes arithmetic on the epoch-boundary
    # indicator (decay^(i==iters)) — same schedule, no branch. A ragged
    # tail keeps the original nested structure so the per-epoch
    # main-batches-then-tail training ORDER is preserved exactly.
    def step(indent):
        # ONE emission of the per-batch step (slice -> fwd -> bwd ->
        # updates -> t), shared by all three loop shapes
        e(f"{indent}Xb = X[beg:endb,]")
        e(f"{indent}Yb = Y[beg:endb,]")
        names = _emit_forward(e, spec, "Xb", indent=indent, train=True)
        _emit_backward(e, spec, names, "Yb", indent=indent)
        _emit_updates(e, spec, optimizer, indent=indent)
        e(f"{indent}t = t + 1")
        return names

    e("if (tail == 0) {")
    e("  for (it in 1:(epochs * iters)) {")
    e("    i = ((it - 1) %% iters) + 1")
    e("    beg = (i-1)*batch_size + 1")
    e("    endb = beg + batch_size - 1")
    fwd_names = step("    ")
    e("    lr = lr * decay ^ (i == iters)")
    e("  }")
    e(f"  probs_final = {fwd_names[-1]}")
    e("} else {")
    e("  for (e_i in 1:epochs) {")
    e("    for (i in 1:iters) {")
    e("      beg = (i-1)*batch_size + 1")
    e("      endb = beg + batch_size - 1")
    step("      ")
    e("    }")
    e("    beg = iters*batch_size + 1")
    e("    endb = N")
    fwd_names = step("    ")
    e("    lr = lr * decay")
    e("  }")
    e(f"  probs_final = {fwd_names[-1]}")
    e("}")
    return e.text()


def generate_predict_script(spec: NetSpec, nn_dir: str = "nn") -> str:
    """Forward-only script: inputs X + all parameters; output `probs`."""
    spec.validate()
    e = _Emitter()
    e("# generated by systemml_tpu_torch.models.dmlgen (Caffe2DML predict)")
    for s in _sources(spec, "sgd", nn_dir):
        if "/optim/" in s or "l2_reg" in s or "cross_entropy" in s:
            continue
        e(s)
    e()
    c0, h0, w0 = spec.input_shape
    e(f"C = {c0}; Hin = {h0}; Win = {w0}")
    names = _emit_forward(e, spec, "X", indent="", train=False)
    e(f"probs = {names[-1]}")
    return e.text()


# --------------------------------------------------------------------------
# emission pieces
# --------------------------------------------------------------------------

def _emit_param_init(e, spec: NetSpec, optimizer: str):
    in_shapes = _in_shapes(spec)
    for idx, l in enumerate(spec.layers, 1):
        c, h, w = in_shapes[idx - 1]
        if l.type == "Convolution":
            e(f"[W{idx}, b{idx}] = conv2d_builtin::init({l.num_output}, {c}, "
              f"{l.kernel_size}, {l.kernel_size})")
        elif l.type == "InnerProduct":
            e(f"[W{idx}, b{idx}] = affine::init({c * h * w}, {l.num_output})")
        elif l.type == "BatchNorm":
            e(f"[G{idx}, B{idx}, EMAm{idx}, EMAv{idx}] = "
              f"batch_norm2d::init({c})")
    if optimizer != "sgd":
        for l, params in _params_of(spec):
            for p in params:
                if optimizer == "adam":
                    e(f"[m_{p}, v_{p}] = opt::init({p})")
                else:
                    e(f"v_{p} = opt::init({p})")


def _in_shapes(spec: NetSpec) -> List[Tuple[int, int, int]]:
    """Input (C, H, W) per layer, following caffe-style `bottom` wiring."""
    from systemml_tpu_torch.models.netspec import DATA_BOTTOM

    shp = spec.shapes()
    names = {l.name: i for i, l in enumerate(spec.layers)}
    out: List[Tuple[int, int, int]] = []
    prev = spec.input_shape
    for i, l in enumerate(spec.layers):
        if l.bottom == DATA_BOTTOM:
            out.append(spec.input_shape)
        else:
            out.append(shp[names[l.bottom]] if l.bottom else prev)
        prev = shp[i]
    return out


def _bottom_of(spec: NetSpec, idx: int) -> int:
    """0-based index of layer idx's bottom producer; -1 = the data input."""
    from systemml_tpu_torch.models.netspec import DATA_BOTTOM

    l = spec.layers[idx]
    if l.bottom == DATA_BOTTOM:
        return -1
    if l.bottom is None:
        return idx - 1
    names = {ll.name: i for i, ll in enumerate(spec.layers)}
    return names[l.bottom]


def _emit_forward(e, spec: NetSpec, x0: str, indent: str, train: bool
                  ) -> List[str]:
    """Emit the forward pass in layer order (a DAG via `bottom` refs);
    returns the output variable per layer."""
    shapes = spec.shapes()
    in_shapes = _in_shapes(spec)
    names = {l.name: i for i, l in enumerate(spec.layers)}
    outs: List[str] = []
    for idx, l in enumerate(spec.layers, 1):
        bi = _bottom_of(spec, idx - 1)
        cur = x0 if bi < 0 else outs[bi]
        c, h, w = in_shapes[idx - 1]
        o = f"out{idx}"
        if l.type == "Eltwise":
            o2 = outs[names[l.bottom2]]
            e(f"{indent}{o} = {cur} + {o2}")
        elif l.type == "Concat":
            # channel concat == cbind in the (N, C*H*W) layout
            o2 = outs[names[l.bottom2]]
            e(f"{indent}{o} = cbind({cur}, {o2})")
        elif l.type == "Convolution":
            e(f"{indent}[{o}, Hout{idx}, Wout{idx}] = conv2d_builtin::forward("
              f"{cur}, W{idx}, b{idx}, {c}, {h}, {w}, {l.kernel_size}, "
              f"{l.kernel_size}, {l.stride}, {l.stride}, {l.pad}, {l.pad})")
        elif l.type == "Pooling":
            mod = ("avg_pool2d_builtin" if l.pool.upper() == "AVE"
                   else "max_pool2d_builtin")
            e(f"{indent}[{o}, Hout{idx}, Wout{idx}] = {mod}::forward("
              f"{cur}, {c}, {h}, {w}, {l.kernel_size}, {l.kernel_size}, "
              f"{l.stride}, {l.stride}, {l.pad}, {l.pad})")
        elif l.type == "InnerProduct":
            e(f"{indent}{o} = affine::forward({cur}, W{idx}, b{idx})")
        elif l.type == "ReLU":
            e(f"{indent}{o} = relu::forward({cur})")
        elif l.type == "Sigmoid":
            e(f"{indent}{o} = sigmoid::forward({cur})")
        elif l.type == "TanH":
            e(f"{indent}{o} = tanh::forward({cur})")
        elif l.type == "Dropout":
            if train:
                # distinct stream per dropout layer AND per step: two
                # same-shape dropout layers must not share masks
                e(f"{indent}[{o}, mask{idx}] = dropout::forward({cur}, "
                  f"{1.0 - l.dropout_ratio}, seedv + t * {len(spec.layers)} "
                  f"+ {idx})")
            else:
                e(f"{indent}{o} = {cur}")
        elif l.type == "BatchNorm":
            mode = "train" if train else "test"
            e(f"{indent}[{o}, EMAmu{idx}, EMAvu{idx}, cm{idx}, cv{idx}, "
              f"cn{idx}] = batch_norm2d::forward({cur}, G{idx}, B{idx}, "
              f"{c}, {h}, {w}, \"{mode}\", EMAm{idx}, EMAv{idx}, 0.9, 1e-5)")
            if train:
                e(f"{indent}EMAm{idx} = EMAmu{idx}")
                e(f"{indent}EMAv{idx} = EMAvu{idx}")
        elif l.type in ("SoftmaxWithLoss", "Softmax"):
            e(f"{indent}{o} = softmax::forward({cur})")
        outs.append(o)
    del shapes  # out-shapes unused: each layer reads its bottom's shape
    return outs


def _emit_backward(e, spec: NetSpec, outs: List[str], yb: str, indent: str):
    """Reverse-order backward over the layer DAG. Gradients accumulate
    per PRODUCER: a layer output consumed by several layers (residual
    fan-out) sums the contributions — reverse emission order guarantees
    every consumer has contributed before the producer's backward runs
    (the reference's CaffeNetwork does the same over proto DAGs)."""
    in_shapes = _in_shapes(spec)
    out_shapes = spec.shapes()
    n = len(spec.layers)
    # accumulated output-gradient variable per layer index (-1 = data in)
    gacc: Dict[int, str] = {}

    def contribute(dst: int, var: str):
        if dst < 0:
            return  # gradient w.r.t. the data input is discarded
        g = f"gacc{dst + 1}"
        if dst in gacc:
            e(f"{indent}{g} = {g} + {var}")
        else:
            e(f"{indent}{g} = {var}")
            gacc[dst] = g

    names = {l.name: i for i, l in enumerate(spec.layers)}
    e(f"{indent}dprobs = cross_entropy_loss::backward({outs[-1]}, {yb})")
    contribute(n - 1, "dprobs")
    for idx in range(n, 0, -1):
        l = spec.layers[idx - 1]
        if (idx - 1) not in gacc:
            raise NetSpecError(f"layer {l.name!r} output never reaches "
                               f"the loss")
        grad = gacc[idx - 1]
        bi = _bottom_of(spec, idx - 1)
        src = "Xb" if bi < 0 else outs[bi]
        c, h, w = in_shapes[idx - 1]
        g = f"d{idx}"
        if l.type == "Eltwise":
            contribute(bi, grad)
            contribute(names[l.bottom2], grad)
            continue
        if l.type == "Concat":
            c1, h1, w1 = (out_shapes[bi] if bi >= 0 else spec.input_shape)
            k1 = c1 * h1 * w1
            e(f"{indent}{g}a = {grad}[, 1:{k1}]")
            e(f"{indent}{g}b = {grad}[, {k1 + 1}:ncol({grad})]")
            contribute(bi, f"{g}a")
            contribute(names[l.bottom2], f"{g}b")
            continue
        if l.type in ("SoftmaxWithLoss", "Softmax"):
            e(f"{indent}{g} = softmax::backward({grad}, {src})")
        elif l.type == "InnerProduct":
            e(f"{indent}[{g}, dW{idx}, db{idx}] = affine::backward({grad}, "
              f"{src}, W{idx}, b{idx})")
        elif l.type == "ReLU":
            e(f"{indent}{g} = relu::backward({grad}, {src})")
        elif l.type == "Sigmoid":
            e(f"{indent}{g} = sigmoid::backward({grad}, {src})")
        elif l.type == "TanH":
            e(f"{indent}{g} = tanh::backward({grad}, {src})")
        elif l.type == "Dropout":
            e(f"{indent}{g} = dropout::backward({grad}, {src}, "
              f"{1.0 - l.dropout_ratio}, mask{idx})")
        elif l.type == "Pooling":
            mod = ("avg_pool2d_builtin" if l.pool.upper() == "AVE"
                   else "max_pool2d_builtin")
            e(f"{indent}{g} = {mod}::backward({grad}, Hout{idx}, Wout{idx}, "
              f"{src}, {c}, {h}, {w}, {l.kernel_size}, {l.kernel_size}, "
              f"{l.stride}, {l.stride}, {l.pad}, {l.pad})")
        elif l.type == "Convolution":
            e(f"{indent}[{g}, dW{idx}, db{idx}] = conv2d_builtin::backward("
              f"{grad}, Hout{idx}, Wout{idx}, {src}, W{idx}, b{idx}, {c}, "
              f"{h}, {w}, {l.kernel_size}, {l.kernel_size}, {l.stride}, "
              f"{l.stride}, {l.pad}, {l.pad})")
        elif l.type == "BatchNorm":
            e(f"{indent}[{g}, dG{idx}, dB{idx}] = batch_norm2d::backward("
              f"{grad}, {outs[idx-1]}, EMAmu{idx}, EMAvu{idx}, cm{idx}, "
              f"cv{idx}, cn{idx}, {src}, G{idx}, B{idx}, {c}, {h}, {w}, "
              f"\"train\", EMAm{idx}, EMAv{idx}, 0.9, 1e-5)")
        contribute(bi, g)


def _emit_updates(e, spec: NetSpec, optimizer: str, indent: str):
    for l, params in _params_of(spec):
        for p in params:
            dp = "d" + p
            if p.startswith("W"):
                e(f"{indent}{dp} = {dp} + l2_reg::backward({p}, reg)")
            if optimizer == "sgd":
                e(f"{indent}{p} = opt::update({p}, {dp}, lr)")
            elif optimizer == "adam":
                e(f"{indent}[{p}, m_{p}, v_{p}] = opt::update({p}, {dp}, "
                  f"lr, 0.9, 0.999, 1e-8, t, m_{p}, v_{p})")
            else:
                e(f"{indent}[{p}, v_{p}] = opt::update({p}, {dp}, lr, mu, "
                  f"v_{p})")


def param_names(spec: NetSpec) -> List[str]:
    """All persistent parameter/buffer names the training script outputs."""
    out = []
    for idx, l in enumerate(spec.layers, 1):
        if l.type in ("Convolution", "InnerProduct"):
            out += [f"W{idx}", f"b{idx}"]
        elif l.type == "BatchNorm":
            out += [f"G{idx}", f"B{idx}", f"EMAm{idx}", f"EMAv{idx}"]
    return out
