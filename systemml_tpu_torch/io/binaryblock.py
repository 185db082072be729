"""Binary-block matrix format: a tiled flat file, parallel host IO.

Port of systemml_tpu/io/binaryblock.py. The layout is the JAX package's
(native/src/bbio.cpp): a 48-byte header, then row-major tiles in
row-major grid order (dense) or one CSR section (indptr, indices, data),
so files written by either package read in the other. The native arm
(the port's own libsmtpu_torch.so, native/__init__.py) fans tile
transfers over OpenMP threads with pread/pwrite; the pure-Python arm
below is the plain version of the same layout, run only with
SMTPU_NATIVE=0, and the tests hold the two to the same bytes.

On the card a dense read lands in pinned host memory and goes to the
device in one copy; a dense write comes back in one copy into pinned
memory (`read_tensor`, `write_tensor`). Every read and write counts the
arm it took in `ARM_COUNTS` and in the run's statistics (`io_<op>_<arm>`).
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np
import torch

from systemml_tpu_torch import native

MAGIC = 0x53424D42
VERSION = 1
DEFAULT_BLOCKSIZE = 1024
_HDR = struct.Struct("<IIQQIIIIQ")  # 48 bytes, matches SmtpuBBHeader
assert _HDR.size == 48

_DT_CODE = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}
_CODE_DT = {0: np.dtype(np.float32), 1: np.dtype(np.float64)}
_TORCH_DT = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64}

# (op, arm) -> count: op is read or write, arm native or python
ARM_COUNTS: Dict[tuple, int] = {}


def count_arm(op: str, arm: str) -> None:
    from systemml_tpu_torch.utils import stats as stats_mod

    ARM_COUNTS[(op, arm)] = ARM_COUNTS.get((op, arm), 0) + 1
    st = stats_mod.current()
    if st is not None:
        st.count_estim(f"io_{op}_{arm}")


def _arm() -> str:
    return "native" if native.enabled() else "python"


def _tiles(rows: int, cols: int, bs: int):
    """(r0, c0, h, w, elem_off) per tile, row-major grid order, in
    lockstep with tile_plan() in native/src/bbio.cpp."""
    if bs == 0 or (bs >= rows and bs >= cols):
        yield 0, 0, rows, cols, 0
        return
    off = 0
    for r0 in range(0, rows, bs):
        for c0 in range(0, cols, bs):
            h, w = min(bs, rows - r0), min(bs, cols - c0)
            yield r0, c0, h, w, off
            off += h * w


def read_header(path: str) -> dict:
    if native.enabled():
        return native.bb_read_header(path)
    with open(path, "rb") as f:
        magic, ver, rows, cols, bs, dt, st, _, nnz = _HDR.unpack(
            f.read(_HDR.size))
    if magic != MAGIC or ver != VERSION:
        raise ValueError(f"{path}: not a binary-block file")
    return {"rows": rows, "cols": cols, "blocksize": bs,
            "dtype": _CODE_DT[dt].type, "storage": "dense" if st == 0
            else "csr", "nnz": nnz}


def write(path: str, value, blocksize: int = DEFAULT_BLOCKSIZE) -> None:
    """Writes a dense ndarray or tensor, or a SparseMatrix (CSR on disk)."""
    from systemml_tpu_torch.runtime.sparse import SparseMatrix

    if isinstance(value, SparseMatrix):
        ip, ix, data = (t.cpu().numpy() for t in (value.indptr,
                                                  value.indices, value.data))
        if data.dtype not in _DT_CODE:
            data = data.astype(np.float64)
        arm = _arm()
        if arm == "native":
            native.bb_write_csr(path, ip, ix, data, value.shape)
        else:
            _py_write_csr(path, ip, ix, data, value.shape)
        count_arm("write", arm)
        return
    if isinstance(value, torch.Tensor):
        write_tensor(path, value, blocksize)
        return
    arr = np.ascontiguousarray(value)
    if arr.dtype not in _DT_CODE:
        arr = arr.astype(np.float64)
    arm = _arm()
    if arm == "native":
        native.bb_write_dense(path, arr, blocksize)
    else:
        _py_write_dense(path, arr, blocksize)
    count_arm("write", arm)


def write_tensor(path: str, t: torch.Tensor,
                 blocksize: int = DEFAULT_BLOCKSIZE) -> None:
    """A dense 2-d tensor to a file: from the card, one copy into pinned
    host memory, then the native tiled write from that buffer."""
    if t.dtype not in (torch.float32, torch.float64):
        t = t.to(torch.float64)
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
    else:
        host = t.contiguous()
    arm = _arm()
    if arm == "native":
        native.bb_write_dense_ptr(path, host.data_ptr(), host.shape[0],
                                  host.shape[1], host.numpy().dtype,
                                  blocksize)
    else:
        _py_write_dense(path, host.numpy(), blocksize)
    count_arm("write", arm)


def read(path: str):
    """-> dense ndarray, or (indptr, indices, data, shape) for CSR files."""
    hdr = read_header(path)
    arm = _arm()
    if hdr["storage"] == "dense":
        if arm == "native":
            out = np.empty((hdr["rows"], hdr["cols"]), dtype=hdr["dtype"])
            native.bb_read_dense_ptr(path, out.ctypes.data)
        else:
            out = _py_read_dense(path, hdr)
        count_arm("read", arm)
        return out
    if arm == "native":
        ip, ix, d = native.bb_read_csr(path, hdr)
        got = ip, ix, d, (hdr["rows"], hdr["cols"])
    else:
        got = _py_read_csr(path, hdr)
    count_arm("read", arm)
    return got


def read_tensor(path: str, device, dtype: torch.dtype):
    """A file as a tensor on `device` in `dtype` (dense), or as the
    read() tuple (CSR). On the card the native arm reads into pinned host
    memory and the tensor reaches the device in one copy."""
    hdr = read_header(path)
    if hdr["storage"] != "dense":
        return read(path)
    device = torch.device(device)
    file_dt = _TORCH_DT[np.dtype(hdr["dtype"])]
    arm = _arm()
    if arm == "native":
        host = torch.empty((hdr["rows"], hdr["cols"]), dtype=file_dt,
                           pin_memory=device.type == "cuda")
        native.bb_read_dense_ptr(path, host.data_ptr())
    else:
        host = torch.from_numpy(_py_read_dense(path, hdr))
    count_arm("read", arm)
    if device.type == "cuda":
        out = host.to(device, non_blocking=False)
        return out if out.dtype == dtype else out.to(dtype)
    return host if host.dtype == dtype else host.to(dtype)


# -------------------------------------------------------------------------
# the plain version of the layout (SMTPU_NATIVE=0, and the tests' oracle)
# -------------------------------------------------------------------------

def _py_write_dense(path: str, arr: np.ndarray, bs: int) -> None:
    rows, cols = arr.shape
    with open(path, "wb") as f:
        f.write(_HDR.pack(MAGIC, VERSION, rows, cols, bs,
                          _DT_CODE[arr.dtype], 0, 0, rows * cols))
        for r0, c0, h, w, _ in _tiles(rows, cols, bs):
            f.write(np.ascontiguousarray(arr[r0:r0 + h, c0:c0 + w]).tobytes())


def _py_read_dense(path: str, hdr: dict) -> np.ndarray:
    rows, cols, bs = hdr["rows"], hdr["cols"], hdr["blocksize"]
    dt = np.dtype(hdr["dtype"])
    out = np.empty((rows, cols), dtype=dt)
    with open(path, "rb") as f:
        f.seek(_HDR.size)
        for r0, c0, h, w, _ in _tiles(rows, cols, bs):
            tile = np.frombuffer(f.read(h * w * dt.itemsize), dtype=dt)
            out[r0:r0 + h, c0:c0 + w] = tile.reshape(h, w)
    return out


def _py_write_csr(path: str, indptr, indices, data, shape) -> None:
    data = np.ascontiguousarray(data)
    with open(path, "wb") as f:
        f.write(_HDR.pack(MAGIC, VERSION, shape[0], shape[1], 0,
                          _DT_CODE[data.dtype], 1, 0, len(data)))
        f.write(np.ascontiguousarray(indptr, dtype=np.int64).tobytes())
        f.write(np.ascontiguousarray(indices, dtype=np.int64).tobytes())
        f.write(data.tobytes())


def _py_read_csr(path: str, hdr: dict):
    rows, cols, nnz = hdr["rows"], hdr["cols"], hdr["nnz"]
    dt = np.dtype(hdr["dtype"])
    with open(path, "rb") as f:
        f.seek(_HDR.size)
        ip = np.frombuffer(f.read((rows + 1) * 8), dtype=np.int64)
        ix = np.frombuffer(f.read(nnz * 8), dtype=np.int64)
        d = np.frombuffer(f.read(nnz * dt.itemsize), dtype=dt)
    return ip.copy(), ix.copy(), d.copy(), (rows, cols)
