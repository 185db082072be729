"""Device-side loop control for CUDA graphs (csrc/loop_graph.cu).

The host side of the WHILE and IF conditional nodes that a fused loop
region (runtime/loopfuse.py) is captured into: begin and end a graph's
capture, add a conditional node to the graph a stream is capturing and
capture its body on another stream, instantiate and launch. The one
kernel, `set_cond`, reads a 0-d predicate tensor on the card and sets the
node's handle: it runs once before a node (the entry test) and, in a WHILE
body, once after each iteration. It has no Pallas counterpart: XLA
evaluates the condition of the JAX package's lax.while_loop itself.

`set_cond.launches` grows by one each time the kernel is captured; a
region's replays are added by the region executor, from the per-body
execution counters it reads at the loop's exit.

Conditional nodes need a CUDA 12.4 runtime and driver (`check_versions`).
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import types
from typing import Optional, Tuple

import torch

from systemml_tpu_torch.codegen import build, counts

IF, WHILE = 0, 1
# cudaStreamCaptureMode: the region's stream captures thread-locally;
# the allocator's cudaMalloc runs relaxed (torch's guard)
CAPTURE_THREAD_LOCAL = 1
MIN_CUDA = 12040
PRED_DTYPES = {torch.bool: 0, torch.uint8: 0, torch.float32: 1,
               torch.float64: 2, torch.int64: 3, torch.int32: 4}

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("loop_graph")
        vp, ip = ctypes.c_void_p, ctypes.c_int
        u64p = ctypes.POINTER(ctypes.c_ulonglong)
        sigs = {
            "smtorch_lg_versions": [ctypes.POINTER(ip)] * 2,
            "smtorch_lg_capture_begin": [vp, ip],
            "smtorch_lg_capture_end": [vp, ctypes.POINTER(vp)],
            "smtorch_lg_begin_node": [vp, vp, ip, vp, ip, ip, u64p],
            "smtorch_lg_end_node": [vp, ip, ctypes.c_ulonglong, vp, ip],
            "smtorch_lg_instantiate": [vp, ctypes.POINTER(vp),
                                       ctypes.POINTER(ip), ctypes.POINTER(ip),
                                       ctypes.c_char_p, ip],
            "smtorch_lg_launch": [vp, vp],
            "smtorch_lg_num_nodes": [vp, u64p],
            "smtorch_lg_abort": [vp, ip],
            "smtorch_lg_destroy": [vp, vp],
            "smtorch_lg_stream_create": [ctypes.POINTER(vp)],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def versions() -> Tuple[int, int]:
    """(runtime, driver) CUDA versions as 12040 for 12.4."""
    rt, drv = ctypes.c_int(0), ctypes.c_int(0)
    _check(library().smtorch_lg_versions(ctypes.byref(rt), ctypes.byref(drv)),
           "CUDA version query")
    return rt.value, drv.value


def check_versions() -> None:
    """Raises, naming both, when the runtime or the driver is older than
    CUDA 12.4: a region then cannot be captured."""
    rt, drv = versions()
    if rt < MIN_CUDA or drv < MIN_CUDA:
        raise RuntimeError(f"fused loop regions need conditional graph nodes "
                           f"(CUDA 12.4): runtime {rt}, driver {drv}")


def _pred_args(pred: torch.Tensor):
    if not isinstance(pred, torch.Tensor) or pred.numel() != 1 \
            or pred.device.type != "cuda":
        raise ValueError("set_cond reads a one-element CUDA tensor")
    code = PRED_DTYPES.get(pred.dtype)
    if code is None:
        raise TypeError(f"set_cond does not read {pred.dtype}")
    return pred.data_ptr(), code


def new_stream(dev: torch.device) -> "torch.cuda.ExternalStream":
    """A non-blocking CUDA stream of `dev` that no other caller holds
    (torch.cuda.Stream hands out a pool of 32 streams per device, round
    robin); it lives as long as the process."""
    ptr = ctypes.c_void_p()
    with torch.cuda.device(dev):
        _check(library().smtorch_lg_stream_create(ctypes.byref(ptr)),
               "stream create")
    return torch.cuda.ExternalStream(ptr.value, device=dev)


def capture_begin(stream: int) -> None:
    _check(library().smtorch_lg_capture_begin(stream, CAPTURE_THREAD_LOCAL),
           "graph capture begin")


def capture_end(stream: int) -> int:
    g = ctypes.c_void_p()
    _check(library().smtorch_lg_capture_end(stream, ctypes.byref(g)),
           "graph capture end")
    return g.value


def begin_node(stream: int, body_stream: int, kind: int, pred: torch.Tensor,
               negate: bool = False) -> int:
    """Adds a conditional node (IF or WHILE) to the graph `stream` is
    capturing, after set_cond(pred) (its entry test; negate: pred == 0),
    and begins capturing `body_stream` into its body. Returns the handle."""
    ptr, code = _pred_args(pred)
    h = ctypes.c_ulonglong(0)
    _check(library().smtorch_lg_begin_node(stream, body_stream, kind, ptr,
                                           code, int(negate), ctypes.byref(h)),
           "conditional node")
    counts.count(set_cond)
    return h.value


def end_node(body_stream: int, kind: int, handle: int,
             pred: Optional[torch.Tensor] = None) -> None:
    """Ends a node's body capture; a WHILE body ends with set_cond(pred),
    the test after each iteration."""
    ptr, code = (None, 0) if kind != WHILE else _pred_args(pred)
    _check(library().smtorch_lg_end_node(body_stream, kind, handle, ptr,
                                         code), "conditional node body")
    if kind == WHILE:
        counts.count(set_cond)


def instantiate(graph: int) -> int:
    """The executable of `graph`; a failure raises with CUDA's reason
    (cudaGraphInstantiateResult) and the node at fault."""
    x = ctypes.c_void_p()
    res, typ = ctypes.c_int(0), ctypes.c_int(-1)
    name = ctypes.create_string_buffer(256)
    err = library().smtorch_lg_instantiate(graph, ctypes.byref(x),
                                           ctypes.byref(res),
                                           ctypes.byref(typ), name, 256)
    if err != 0:
        raise RuntimeError(
            f"graph instantiate failed: CUDA error {err}, instantiate "
            f"result {res.value}, node type {typ.value} "
            f"{name.value.decode(errors='replace')!r}")
    return x.value


def launch(exec_: int, stream: int) -> None:
    _check(library().smtorch_lg_launch(exec_, stream), "graph launch")


def num_nodes(graph: int) -> int:
    n = ctypes.c_ulonglong(0)
    _check(library().smtorch_lg_num_nodes(graph, ctypes.byref(n)),
           "graph node count")
    return n.value


def abort(stream: int, destroy_graph: bool) -> None:
    """Ends `stream`'s capture if it is capturing (after a capture that
    raised), clearing the capture's error."""
    _check(library().smtorch_lg_abort(stream, int(destroy_graph)),
           "capture abort")


def destroy(graph: Optional[int], exec_: Optional[int]) -> None:
    _check(library().smtorch_lg_destroy(graph, exec_), "graph destroy")


def set_cond_plain(pred: torch.Tensor) -> bool:
    """The plain version of the set_cond kernel: the value the handle
    takes, read on the host."""
    return bool(pred.reshape(()) != 0)


# the kernel's launch counter (begin_node and end_node launch it)
set_cond = types.SimpleNamespace(launches=0)
