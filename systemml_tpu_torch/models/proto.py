# Copy of systemml_tpu/models/proto.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""Minimal Caffe text-proto parsing: net .prototxt -> NetSpec, solver
.prototxt -> dict.

TPU-native equivalent of the reference's proto ingestion
(src/main/proto/caffe/caffe.proto definitions consumed by
Caffe2DML.scala / CaffeNetwork.scala via protobuf). The text format is a
simple block grammar — `key: value` pairs and nested `name { ... }`
messages — so a small recursive parser covers the subset Caffe2DML
reads: layer type/params, input shape, and solver hyperparameters.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from systemml_tpu_torch.models.netspec import Layer, NetSpec, NetSpecError

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<comment>\#[^\n]*) |
      (?P<brace>[{}]) |
      (?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*(?P<colon>:)? |
      (?P<str>"(?:[^"\\]|\\.)*") |
      (?P<num>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    )""", re.VERBOSE)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None or m.end() == pos:
            if text[pos:].strip() == "":
                return
            raise NetSpecError(f"prototxt parse error at: {text[pos:pos+40]!r}")
        pos = m.end()
        if m.group("comment"):
            continue
        if m.group("brace"):
            yield ("brace", m.group("brace"))
        elif m.group("key"):
            yield ("key", m.group("key"), bool(m.group("colon")))
        elif m.group("str"):
            yield ("value", m.group("str")[1:-1])
        elif m.group("num"):
            n = m.group("num")
            yield ("value", float(n) if ("." in n or "e" in n or "E" in n)
                   else int(n))


def parse_prototxt(text: str) -> Dict[str, Any]:
    """Parse to a nested dict; repeated fields become lists."""
    toks = list(_tokenize(text))
    i = 0

    def block() -> Dict[str, Any]:
        nonlocal i
        out: Dict[str, Any] = {}

        def put(k, v):
            if k in out:
                if not isinstance(out[k], list):
                    out[k] = [out[k]]
                out[k].append(v)
            else:
                out[k] = v

        while i < len(toks):
            t = toks[i]
            if t[0] == "brace" and t[1] == "}":
                i += 1
                return out
            if t[0] != "key":
                raise NetSpecError(f"expected field name, got {t!r}")
            name = t[1]
            i += 1
            if i < len(toks) and toks[i][0] == "brace" and toks[i][1] == "{":
                i += 1
                put(name, block())
            elif i < len(toks) and toks[i][0] == "value":
                put(name, toks[i][1])
                i += 1
            elif i < len(toks) and toks[i][0] == "key" and not toks[i][2]:
                # enum value (e.g. pool: MAX)
                put(name, toks[i][1])
                i += 1
            else:
                raise NetSpecError(f"field {name!r} has no value")
        return out

    return block()


def _as_list(v) -> List:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def netspec_from_prototxt(text: str,
                          input_shape: Tuple[int, int, int] = None) -> NetSpec:
    """Build a NetSpec from a net .prototxt (reference: CaffeNetwork
    construction from NetParameter)."""
    d = parse_prototxt(text)
    if input_shape is None:
        dims = None
        shape = d.get("input_shape")
        if shape:
            dims = _as_list(_as_list(shape)[0].get("dim"))
        elif "input_dim" in d:
            dims = _as_list(d["input_dim"])
        if not dims or len(dims) < 4:
            raise NetSpecError("net prototxt has no input_shape; pass "
                               "input_shape=(C, H, W)")
        input_shape = tuple(int(x) for x in dims[1:4])
    layers: List[Layer] = []
    for lyr in _as_list(d.get("layer")):
        t = lyr.get("type")
        name = lyr.get("name", t.lower() if t else "")
        if t in (None, "Data", "Input", "Accuracy"):
            continue
        if t == "Convolution":
            p = lyr.get("convolution_param", {})
            layers.append(Layer("Convolution", name,
                                num_output=int(p.get("num_output", 1)),
                                kernel_size=int(p.get("kernel_size", 3)),
                                stride=int(p.get("stride", 1)),
                                pad=int(p.get("pad", 0))))
        elif t == "Pooling":
            p = lyr.get("pooling_param", {})
            layers.append(Layer("Pooling", name,
                                kernel_size=int(p.get("kernel_size", 2)),
                                stride=int(p.get("stride", 2)),
                                pad=int(p.get("pad", 0)),
                                pool=str(p.get("pool", "MAX"))))
        elif t == "InnerProduct":
            p = lyr.get("inner_product_param", {})
            layers.append(Layer("InnerProduct", name,
                                num_output=int(p.get("num_output", 1))))
        elif t == "Dropout":
            p = lyr.get("dropout_param", {})
            layers.append(Layer("Dropout", name,
                                dropout_ratio=float(p.get("dropout_ratio", 0.5))))
        elif t in ("ReLU", "Sigmoid", "TanH", "BatchNorm",
                   "SoftmaxWithLoss", "Softmax"):
            layers.append(Layer(t, name))
        else:
            raise NetSpecError(f"unsupported caffe layer type {t!r}")
    spec = NetSpec(input_shape, layers)
    spec.validate()
    return spec


_SOLVER_KEYS = {"base_lr": float, "momentum": float, "weight_decay": float,
                "max_iter": int, "gamma": float, "lr_policy": str,
                "type": str, "stepsize": int, "test_interval": int}


def solver_from_prototxt(text: str) -> Dict[str, Any]:
    """Solver hyperparameters (reference: CaffeSolver.scala)."""
    d = parse_prototxt(text)
    out = {}
    for k, cast in _SOLVER_KEYS.items():
        if k in d:
            out[k] = cast(d[k])
    return out
