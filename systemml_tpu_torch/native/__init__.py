"""Host IO library: ctypes bindings over libsmtpu_torch.so.

Port of systemml_tpu/native/__init__.py. The C++ sources are the port's
own copies (src/: bbio.cpp, csr.cpp, textio.cpp, smtpu.h): parallel
binary-block IO with pread/pwrite over OpenMP threads, host CSR, and the
chunk-parallel csv and ijv parsers. They are host code, not kernels. The
port binds what its readers and writers call: the binary-block IO and
the two parsers (its CSR lives on the device, runtime/sparse.py).

The library is built once with `g++ -O3 -fopenmp` into
systemml_tpu_torch/_build/ at its first use, under BUILD_TIMEOUT_S; a
build that fails or times out raises, naming the compiler's output. The
pure-Python readers and writers in io/binaryblock.py and io/matrixio.py
are the plain versions: they run only when `SMTPU_NATIVE=0` is set in
the environment, never because the build failed. Each read and write
counts the arm it took (`ARM_COUNTS`, io/binaryblock.count_arm).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = ("bbio.cpp", "csr.cpp", "textio.cpp")
_ABI = 1
BUILD_TIMEOUT_S = 180
_OUT = os.path.join(os.path.dirname(_HERE), "_build", "libsmtpu_torch.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

i64 = ctypes.c_int64
u32 = ctypes.c_uint32
u64 = ctypes.c_uint64
_p = ctypes.POINTER


class NativeBuildError(RuntimeError):
    pass


def enabled() -> bool:
    """False only where the caller switched the library off
    (SMTPU_NATIVE=0): the plain Python arms then run, counted."""
    return os.environ.get("SMTPU_NATIVE", "1") != "0"


def _stale(out: str) -> bool:
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(os.path.getmtime(os.path.join(_HERE, "src", s)) > t
               for s in _SRC + ("smtpu.h",))


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    srcs = [os.path.join(_HERE, "src", s) for s in _SRC]
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared",
           "-o", tmp] + srcs
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise NativeBuildError(f"g++ took over {BUILD_TIMEOUT_S} s: "
                               f"{' '.join(cmd)}") from e
    if r.returncode != 0 or not os.path.exists(tmp):
        raise NativeBuildError(f"g++ failed ({r.returncode}): "
                               f"{r.stderr[-2000:]}")
    os.replace(tmp, out)


def _sig(lib):
    lib.smtpu_abi_version.restype = ctypes.c_int
    lib.smtpu_bb_write_dense.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                         u64, u64, u32, u32]
    lib.smtpu_bb_write_dense.restype = ctypes.c_int
    lib.smtpu_bb_read_header.argtypes = [ctypes.c_char_p, _p(u64), _p(u64),
                                         _p(u32), _p(u32), _p(u32), _p(u64)]
    lib.smtpu_bb_read_header.restype = ctypes.c_int
    lib.smtpu_bb_read_dense.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.smtpu_bb_read_dense.restype = ctypes.c_int
    lib.smtpu_bb_write_csr.argtypes = [ctypes.c_char_p, _p(i64), _p(i64),
                                       ctypes.c_void_p, u64, u64, u64, u32]
    lib.smtpu_bb_write_csr.restype = ctypes.c_int
    lib.smtpu_bb_read_csr.argtypes = [ctypes.c_char_p, _p(i64), _p(i64),
                                      ctypes.c_void_p]
    lib.smtpu_bb_read_csr.restype = ctypes.c_int
    lib.smtpu_count_lines.argtypes = [ctypes.c_char_p, i64]
    lib.smtpu_count_lines.restype = i64
    lib.smtpu_parse_ijv.argtypes = [ctypes.c_char_p, i64, _p(i64), _p(i64),
                                    _p(ctypes.c_double), i64]
    lib.smtpu_parse_ijv.restype = i64
    lib.smtpu_parse_csv.argtypes = [ctypes.c_char_p, i64, ctypes.c_char,
                                    i64, _p(ctypes.c_double), i64]
    lib.smtpu_parse_csv.restype = i64


def lib() -> ctypes.CDLL:
    """The loaded library, built at the first call; raises
    NativeBuildError when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _stale(_OUT):
                _build(_OUT)
            loaded = ctypes.CDLL(_OUT)
            if loaded.smtpu_abi_version() != _ABI:
                raise NativeBuildError(f"{_OUT}: ABI "
                                       f"{loaded.smtpu_abi_version()}, "
                                       f"expected {_ABI}")
            _sig(loaded)
            _lib = loaded
    return _lib


def _cp(a: np.ndarray, ct):
    return a.ctypes.data_as(_p(ct))


# the header's dtype codes
_DT = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}


def _check(rc: int, what: str, path: str) -> None:
    if rc != 0:
        raise OSError(-rc if rc < 0 else rc, f"{what} failed", path)


# -------------------------------------------------------------------------
# binary-block IO
# -------------------------------------------------------------------------

def bb_write_dense_ptr(path: str, ptr: int, rows: int, cols: int,
                       dtype, blocksize: int) -> None:
    """Writes the row-major (rows, cols) host buffer at `ptr` (a numpy
    array's or a pinned tensor's) as a binary-block file."""
    code = _DT[np.dtype(dtype)]
    _check(lib().smtpu_bb_write_dense(path.encode(), ptr, rows, cols,
                                      blocksize, code),
           "binary-block write", path)


def bb_write_dense(path: str, arr: np.ndarray, blocksize: int) -> None:
    a = np.ascontiguousarray(arr)
    bb_write_dense_ptr(path, a.ctypes.data, a.shape[0], a.shape[1],
                       a.dtype, blocksize)


def bb_read_header(path: str) -> dict:
    rows, cols, nnz = u64(), u64(), u64()
    bs, dt, st = u32(), u32(), u32()
    _check(lib().smtpu_bb_read_header(path.encode(), rows, cols, bs, dt, st,
                                      nnz), "binary-block header read", path)
    return {"rows": rows.value, "cols": cols.value, "blocksize": bs.value,
            "dtype": np.float32 if dt.value == 0 else np.float64,
            "storage": "dense" if st.value == 0 else "csr",
            "nnz": nnz.value}


def bb_read_dense_ptr(path: str, ptr: int) -> None:
    """Reads a dense binary-block file into the row-major host buffer at
    `ptr`, sized from its header (a pinned tensor's, for one copy to the
    card)."""
    _check(lib().smtpu_bb_read_dense(path.encode(), ptr),
           "binary-block read", path)


def bb_write_csr(path: str, indptr, indices, data, shape) -> None:
    data = np.ascontiguousarray(data)
    ip = np.ascontiguousarray(indptr, dtype=np.int64)
    ix = np.ascontiguousarray(indices, dtype=np.int64)
    code = _DT[data.dtype]
    _check(lib().smtpu_bb_write_csr(path.encode(), _cp(ip, i64),
                                    _cp(ix, i64), data.ctypes.data,
                                    shape[0], shape[1], len(data), code),
           "binary-block csr write", path)


def bb_read_csr(path: str, hdr: dict):
    ip = np.empty(hdr["rows"] + 1, dtype=np.int64)
    ix = np.empty(hdr["nnz"], dtype=np.int64)
    data = np.empty(hdr["nnz"], dtype=hdr["dtype"])
    _check(lib().smtpu_bb_read_csr(path.encode(), _cp(ip, i64), _cp(ix, i64),
                                   data.ctypes.data),
           "binary-block csr read", path)
    return ip, ix, data


# -------------------------------------------------------------------------
# parallel text parsing
# -------------------------------------------------------------------------

def parse_ijv(text: bytes):
    """'i j v' textcell bytes -> (rows, cols, vals) int64/int64/f64; raises
    ValueError on a malformed line."""
    L = lib()
    nlines = L.smtpu_count_lines(text, len(text))
    rows = np.empty(nlines, dtype=np.int64)
    cols = np.empty(nlines, dtype=np.int64)
    vals = np.empty(nlines, dtype=np.float64)
    n = L.smtpu_parse_ijv(text, len(text), _cp(rows, i64), _cp(cols, i64),
                          _cp(vals, ctypes.c_double), nlines)
    if n < 0:
        raise ValueError("malformed textcell input")
    return rows[:n], cols[:n], vals[:n]


def parse_csv(text: bytes, sep: str, ncols: int) -> np.ndarray:
    L = lib()
    nlines = L.smtpu_count_lines(text, len(text))
    out = np.empty((nlines, ncols), dtype=np.float64)
    n = L.smtpu_parse_csv(text, len(text), sep.encode()[:1], ncols,
                          _cp(out, ctypes.c_double), nlines * ncols)
    if n < 0:
        raise ValueError("malformed csv input")
    return out[:n]
