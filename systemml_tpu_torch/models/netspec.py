# Copy of systemml_tpu/models/netspec.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""Network specification: the layer-graph model behind Caffe2DML.

TPU-native equivalent of the reference's CaffeNetwork/CaffeLayer layer
graph (src/main/scala/org/apache/sysml/api/dl/CaffeNetwork.scala,
CaffeLayer.scala) — a declarative chain of layers that the DML generator
(dmlgen.py) turns into training/predict scripts over scripts/nn.

Supported layer types mirror the Caffe2DML surface: Data (implicit),
Convolution, Pooling (MAX/AVG), InnerProduct, ReLU, Sigmoid, TanH,
Dropout, BatchNorm (2d), SoftmaxWithLoss (the classifier head).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class NetSpecError(ValueError):
    pass


# reserved `bottom` name for the raw data input: bottom=None means "the
# previous layer in list order" (the chain default), which mis-wires any
# NON-first layer that should read the input — functional graphs with
# several branches off the input name it explicitly
DATA_BOTTOM = "__data__"


@dataclasses.dataclass
class Layer:
    type: str
    name: str = ""
    # convolution / pooling
    num_output: int = 0
    kernel_size: int = 3
    stride: int = 1
    pad: int = 0
    pool: str = "MAX"
    # dropout
    dropout_ratio: float = 0.5
    # DAG wiring (caffe-style bottoms): None = previous layer's output.
    # Eltwise takes two bottoms (bottom, bottom2) — the residual-add
    # primitive (reference: CaffeLayer.scala Eltwise; ResNet topologies
    # reach Caffe2DML as proto DAGs, not chains)
    bottom: Optional[str] = None
    bottom2: Optional[str] = None

    def __post_init__(self):
        if not self.name:
            self.name = self.type.lower()
        # normalize pooling spellings: caffe says AVE, keras says AVG
        p = self.pool.upper()
        if p in ("AVE", "AVG", "AVERAGE"):
            self.pool = "AVE"
        elif p == "MAX":
            self.pool = "MAX"
        else:
            raise NetSpecError(f"unknown pooling kind {self.pool!r}")


# layer types with trainable parameters
_PARAM_TYPES = {"Convolution", "InnerProduct", "BatchNorm"}
_KNOWN = {"Convolution", "Pooling", "InnerProduct", "ReLU", "Sigmoid",
          "TanH", "Dropout", "BatchNorm", "SoftmaxWithLoss", "Softmax",
          "Eltwise", "Concat"}


class NetSpec:
    """Sequential layer graph with input shape (C, H, W) and the number
    of classes derived from the final InnerProduct."""

    def __init__(self, input_shape: Tuple[int, int, int],
                 layers: Optional[List[Layer]] = None):
        self.input_shape = tuple(int(v) for v in input_shape)
        self.layers: List[Layer] = list(layers or [])

    def add(self, type: str, **kw) -> "NetSpec":
        if type not in _KNOWN:
            raise NetSpecError(f"unsupported layer type {type!r}")
        kw.setdefault("name", f"{type.lower()}{len(self.layers) + 1}")
        self.layers.append(Layer(type=type, **kw))
        return self

    # convenience builders (mirroring caffe net definition helpers)
    def conv(self, num_output, kernel_size=3, stride=1, pad=0, **kw):
        return self.add("Convolution", num_output=num_output,
                        kernel_size=kernel_size, stride=stride, pad=pad, **kw)

    def pool(self, kernel_size=2, stride=2, pool="MAX", **kw):
        return self.add("Pooling", kernel_size=kernel_size, stride=stride,
                        pool=pool, **kw)

    def dense(self, num_output, **kw):
        return self.add("InnerProduct", num_output=num_output, **kw)

    def relu(self, **kw):
        return self.add("ReLU", **kw)

    def dropout(self, ratio=0.5, **kw):
        return self.add("Dropout", dropout_ratio=ratio, **kw)

    def batch_norm(self, **kw):
        return self.add("BatchNorm", **kw)

    def eltwise(self, bottom2, bottom=None, **kw):
        """Elementwise SUM of two named layer outputs (the residual add)."""
        return self.add("Eltwise", bottom=bottom, bottom2=bottom2, **kw)

    def concat(self, bottom2, bottom=None, **kw):
        """Channel concatenation of two named layer outputs (reference:
        CaffeLayer.scala Concat; Keras Concatenate merges). In the
        row-per-sample (N, C*H*W) layout, channel concat IS cbind when
        the spatial dims agree — the generator emits exactly that."""
        return self.add("Concat", bottom=bottom, bottom2=bottom2, **kw)

    def softmax_loss(self, **kw):
        return self.add("SoftmaxWithLoss", **kw)

    # ---- validation / shape inference -----------------------------------

    def validate(self) -> None:
        if not self.layers:
            raise NetSpecError("empty network")
        if self.layers[-1].type not in ("SoftmaxWithLoss", "Softmax"):
            raise NetSpecError("network must end in SoftmaxWithLoss")
        ip = [l for l in self.layers if l.type == "InnerProduct"]
        if not ip:
            raise NetSpecError("network needs at least one InnerProduct "
                               "before the softmax head")
        seen_flat = False
        for l in self.layers:
            if l.type == "InnerProduct":
                seen_flat = True
            elif l.type in ("Convolution", "Pooling", "BatchNorm") and seen_flat:
                raise NetSpecError(
                    f"spatial layer {l.name!r} after InnerProduct")

    def num_classes(self) -> int:
        for l in reversed(self.layers):
            if l.type == "InnerProduct":
                return l.num_output
        raise NetSpecError("no InnerProduct layer")

    def shapes(self) -> List[Tuple[int, int, int]]:
        """Output (C, H, W) after each layer (H=W=1 once flattened).
        Layers consume their `bottom`'s shape (previous layer when None)."""
        names: dict = {}
        out: List[Tuple[int, int, int]] = []
        prev = self.input_shape
        for i, l in enumerate(self.layers):
            if l.bottom == DATA_BOTTOM:
                c, h, w = self.input_shape
            elif l.bottom is not None:
                if l.bottom not in names:
                    raise NetSpecError(f"layer {l.name!r}: unknown bottom "
                                       f"{l.bottom!r} (must be an earlier "
                                       f"layer name)")
                c, h, w = out[names[l.bottom]]
            else:
                c, h, w = prev
            if l.type == "Convolution":
                h = (h + 2 * l.pad - l.kernel_size) // l.stride + 1
                w = (w + 2 * l.pad - l.kernel_size) // l.stride + 1
                c = l.num_output
            elif l.type == "Pooling":
                h = (h + 2 * l.pad - l.kernel_size) // l.stride + 1
                w = (w + 2 * l.pad - l.kernel_size) // l.stride + 1
            elif l.type == "InnerProduct":
                c, h, w = l.num_output, 1, 1
            elif l.type == "Eltwise":
                if l.bottom2 not in names:
                    raise NetSpecError(f"eltwise {l.name!r}: unknown "
                                       f"bottom2 {l.bottom2!r}")
                other = out[names[l.bottom2]]
                if other != (c, h, w):
                    raise NetSpecError(
                        f"eltwise {l.name!r}: shape mismatch "
                        f"{(c, h, w)} vs {other}")
            elif l.type == "Concat":
                if l.bottom2 not in names:
                    raise NetSpecError(f"concat {l.name!r}: unknown "
                                       f"bottom2 {l.bottom2!r}")
                c2, h2, w2 = out[names[l.bottom2]]
                if (h2, w2) != (h, w):
                    raise NetSpecError(
                        f"concat {l.name!r}: spatial mismatch "
                        f"{(h, w)} vs {(h2, w2)}")
                c = c + c2
            names[l.name] = i
            out.append((c, h, w))
            prev = (c, h, w)
        return out
