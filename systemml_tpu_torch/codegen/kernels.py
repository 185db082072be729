"""Hand-written CUDA kernels of the port, with their plain versions.

Port of the kernels of systemml_tpu/codegen/kernels.py that the port's
paths run. So far: mmchain (that file's `mmchain_kernel`, line 347), the
kernel of the LinearRegCG loop body. The cell, multi-aggregate, row and
outer-product kernels wait (ROADMAP, spoof codegen).

Every kernel here has:

- a wrapper that launches it on a CUDA tensor, after checking device,
  dtype, shape and layout, and raises on what the kernel does not
  take; on a CPU tensor the wrapper runs the plain version instead, and
  only because the tensor lies on the CPU;
- a plain PyTorch version of the same function (`*_plain`), which the
  CPU tests use and chip_smoke.py compares the kernel with;
- a launch counter, `<wrapper>.launches`, a plain integer that grows by
  one per kernel launch and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from systemml_tpu_torch.codegen import build

# --------------------------------------------------------------------------
# mmchain: t(X) %*% (w? * (X %*% v) -? y) in ONE pass over X
# (csrc/mmchain.cu; reference: MapMultChain / LibMatrixMult.matrixMultChain)
# --------------------------------------------------------------------------

MMCHAIN_CTYPES = {"XtXv": 0, "XtwXv": 1, "XtXvy": 2}
# what the kernel takes (csrc/mmchain.cu): 8 accumulator columns of k per
# thread of a 256-thread block, and c <= 8 chain columns
MMCHAIN_MIN_K = 128
MMCHAIN_MAX_K = 2048
MMCHAIN_MAX_C = 8

_mmchain_lib: Optional[ctypes.CDLL] = None
# (device index, k, c, rows contiguous) -> blocks of the partial kernel
# resident per SM
_mmchain_occupancy: Dict[Tuple[int, int, int, bool], int] = {}


def mmchain_supported(m: int, k: int, c: int, dtype) -> bool:
    """The shapes and dtype the hand kernel takes. The JAX package's
    family predicate (fp32, k >= 128, c <= 8) plus this kernel's own
    bound k <= 2048 (ROADMAP lists lifting it)."""
    return (dtype == torch.float32 and MMCHAIN_MIN_K <= k <= MMCHAIN_MAX_K
            and 1 <= c <= MMCHAIN_MAX_C)


def _chain_operands(x, v, w, ctype: str):
    if ctype not in MMCHAIN_CTYPES:
        raise ValueError(f"unknown mmchain ctype {ctype!r}")
    m, k = x.shape
    v = v.reshape(k, -1)
    if ctype != "XtXv":
        if w is None:
            raise ValueError(f"mmchain {ctype} needs w/y")
        w = w.reshape(m, -1)
        if w.shape[1] not in (1, v.shape[1]):
            raise ValueError(f"mmchain {ctype}: w/y has {w.shape[1]} "
                             f"columns, v has {v.shape[1]}")
    return v, w


def mmchain_plain(x, v, w=None, ctype: str = "XtXv"):
    """The plain version: two products, as the JAX package's two-pass arm
    (systemml_tpu/ops/mult.py, jnp_two_pass)."""
    v, w = _chain_operands(x, v, w, ctype)
    xv = torch.matmul(x, v)
    if ctype == "XtwXv":
        xv = w * xv
    elif ctype == "XtXvy":
        xv = xv - w
    return torch.matmul(x.T, xv)


def _library() -> ctypes.CDLL:
    global _mmchain_lib
    if _mmchain_lib is None:
        lib = build.load("mmchain")
        lib.smtorch_mmchain_blocks_per_sm.argtypes = [
            ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.smtorch_mmchain_blocks_per_sm.restype = ctypes.c_int
        lib.smtorch_mmchain_chunk_rows.argtypes = []
        lib.smtorch_mmchain_chunk_rows.restype = ctypes.c_int
        lib.smtorch_mmchain.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.smtorch_mmchain.restype = ctypes.c_int
        _mmchain_lib = lib
    return _mmchain_lib


def mmchain_row_stride(x) -> Optional[int]:
    """The distance in elements between X's rows when the kernel can read
    X in place: its rows contiguous and apart (a contiguous X, or a row
    or column slice of one). None for any other layout, a transposed
    view among them."""
    m, k = x.shape
    ldx = x.stride(0) if m > 1 else k
    if (k > 1 and x.stride(1) != 1) or ldx < k:
        return None
    return ldx


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _mmchain_grid(lib, dev: torch.device, m: int, k: int, c: int,
                  flat: bool) -> int:
    key = (dev.index, k, c, flat)
    per_sm = _mmchain_occupancy.get(key)
    if per_sm is None:
        n = ctypes.c_int(0)
        _check(lib.smtorch_mmchain_blocks_per_sm(k, c, int(flat),
                                                 ctypes.byref(n)),
               "mmchain occupancy query")
        if n.value < 1:
            raise RuntimeError(f"mmchain kernel cannot be resident at k={k}, "
                               f"c={c}")
        per_sm = _mmchain_occupancy[key] = n.value
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = -(-m // lib.smtorch_mmchain_chunk_rows())
    return max(1, min(chunks, per_sm * sms))


def mmchain_kernel(x, v, w=None, ctype: str = "XtXv", precise: bool = True):
    """t(X) %*% (X %*% v) (XtXv), t(X) %*% (w * (X %*% v)) (XtwXv) or
    t(X) %*% ((X %*% v) - y) (XtXvy), reading X once (csrc/mmchain.cu).

    x (m, k); v (k,) or (k, c); w/y (m, 1), broadcast over c, or (m, c).
    Returns (k, c). On a CUDA tensor it launches the kernel, or raises
    when the kernel does not take the input (not fp32, X's rows not
    contiguous, k or c outside mmchain_supported). X may be a row or
    column slice of a wider matrix: the kernel reads it in place; on a CPU tensor it runs
    mmchain_plain. `precise` is accepted for the JAX package's signature
    and changes nothing: the kernel always multiplies in true fp32."""
    if x.device.type == "cpu":
        return mmchain_plain(x, v, w, ctype)
    if x.device.type != "cuda":
        raise ValueError(f"mmchain_kernel: unsupported device {x.device}")
    v, w = _chain_operands(x, v, w, ctype)
    m, k = x.shape
    c = v.shape[1]
    operands = (x, v) if w is None else (x, v, w)
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError("mmchain_kernel takes fp32 operands only")
    if any(t.device != x.device for t in operands):
        raise ValueError("mmchain_kernel: operands on different devices")
    ldx = mmchain_row_stride(x)
    if ldx is None:
        raise ValueError(f"mmchain_kernel: X's rows are not contiguous and "
                         f"apart (strides {tuple(x.stride())})")
    if not mmchain_supported(m, k, c, x.dtype):
        raise ValueError(f"mmchain_kernel takes {MMCHAIN_MIN_K} <= k <= "
                         f"{MMCHAIN_MAX_K} and c <= {MMCHAIN_MAX_C}; got "
                         f"k={k}, c={c}")
    v = v.contiguous()
    w = None if w is None else w.contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        grid = _mmchain_grid(lib, x.device, m, k, c, ldx == k)
        partial = torch.empty((grid, k, c), dtype=torch.float32,
                              device=x.device)
        out = torch.empty((k, c), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.smtorch_mmchain(
            x.data_ptr(), v.data_ptr(), None if w is None else w.data_ptr(),
            partial.data_ptr(), out.data_ptr(), m, ldx, k, c,
            MMCHAIN_CTYPES[ctype], 1 if w is None else w.shape[1], grid,
            stream)
    _check(err, "mmchain kernel launch")
    mmchain_kernel.launches += 1
    return out


mmchain_kernel.launches = 0
