# Copy of systemml_tpu/models/zoo.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""Model zoo: standard topologies as NetSpec builders.

The reference ships ResNet/LeNet-style networks to Caffe2DML as proto
files (e.g. the examples in docs/beginners-guide-caffe2dml.md and the
mllearn notebooks); here the same topologies are Python builders over
NetSpec — the BASELINE.md north star (Caffe2DML ResNet-18) lives here.
"""

from __future__ import annotations

from typing import Tuple

from systemml_tpu_torch.models.netspec import NetSpec


def _basic_block(net: NetSpec, prefix: str, cin: int, cout: int,
                 stride: int, bottom: str) -> str:
    """ResNet-v1 basic block: conv3x3(s)-bn-relu-conv3x3-bn + shortcut,
    then relu. Returns the name of the block's output layer."""
    net.conv(cout, kernel_size=3, stride=stride, pad=1,
             name=f"{prefix}c1", bottom=bottom)
    net.batch_norm(name=f"{prefix}n1")
    net.relu(name=f"{prefix}r1")
    net.conv(cout, kernel_size=3, stride=1, pad=1, name=f"{prefix}c2")
    net.batch_norm(name=f"{prefix}n2")
    if stride != 1 or cin != cout:
        # projection shortcut from the block input
        net.conv(cout, kernel_size=1, stride=stride, pad=0,
                 name=f"{prefix}sc", bottom=bottom)
        net.batch_norm(name=f"{prefix}sn")
        skip = f"{prefix}sn"
    else:
        skip = bottom
    net.eltwise(bottom2=skip, bottom=f"{prefix}n2", name=f"{prefix}add")
    net.relu(name=f"{prefix}out")
    return f"{prefix}out"


def resnet18(num_classes: int = 1000,
             input_shape: Tuple[int, int, int] = (3, 224, 224),
             small_input: bool = False) -> NetSpec:
    """ResNet-18 (v1). `small_input=True` uses the CIFAR-style stem
    (3x3 stride-1 conv, no max-pool) for 32x32-class inputs."""
    net = NetSpec(input_shape)
    if small_input:
        net.conv(64, kernel_size=3, stride=1, pad=1, name="stem")
    else:
        net.conv(64, kernel_size=7, stride=2, pad=3, name="stem")
    net.batch_norm(name="stemn")
    net.relu(name="stemr")
    last = "stemr"
    if not small_input:
        net.pool(kernel_size=3, stride=2, pad=1, name="stemp")
        last = "stemp"
    cin = 64
    for si, cout in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            last = _basic_block(net, f"s{si}b{bi}", cin, cout, stride, last)
            cin = cout
    # global average pool over whatever spatial extent remains
    c, h, w = net.shapes()[-1]
    net.pool(kernel_size=h, stride=1, pad=0, pool="AVE", name="gap")
    net.dense(num_classes, name="fc")
    net.softmax_loss()
    return net


def tiny_convnet(num_classes: int = 10,
                 input_shape: Tuple[int, int, int] = (1, 8, 8)) -> NetSpec:
    """Two conv/relu/pool stages + classifier head: the smallest net
    that exercises the whole DNN hot path (conv -> bias -> relu -> pool
    chains, generated train step, whole-epoch loop fusion). Used by the
    dispatch-budget regression test (tests/test_dnn_hotpath.py) and as
    a cheap smoke model."""
    return (NetSpec(input_shape)
            .conv(4, kernel_size=3, stride=1, pad=1).relu().pool()
            .conv(8, kernel_size=3, stride=1, pad=1).relu().pool()
            .dense(num_classes).softmax_loss())


def lenet(num_classes: int = 10,
          input_shape: Tuple[int, int, int] = (1, 28, 28)) -> NetSpec:
    """The classic LeNet the reference's mnist examples train."""
    return (NetSpec(input_shape)
            .conv(32, kernel_size=5, stride=1, pad=2).relu().pool()
            .conv(64, kernel_size=5, stride=1, pad=2).relu().pool()
            .dense(512).relu().dropout(0.5)
            .dense(num_classes).softmax_loss())
