"""Hand-written CUDA kernels of the port, with their plain versions.

Port of the kernels of systemml_tpu/codegen/kernels.py: mmchain (that
file's `mmchain_kernel`, line 347), the kernel of the LinearRegCG loop
body, and the four spoof templates, the fused plans of optlevel 3: cell
(`cell_kernel`, line 124), row (`row_kernel`, line 199), multi-aggregate
(`multiagg_kernel`, line 242) and outer product (`outer_sum_kernel`, line
419). The compressed chain, K6, is in compress/device.py.

Every kernel here has:

- a wrapper that launches it on a CUDA tensor, after checking device,
  dtype, shape and layout, and raises on what the kernel does not
  take; on a CPU tensor the wrapper runs the plain version instead, and
  only because the tensor lies on the CPU (the spoof wrappers also run
  it, on any device, for a leaf layout that the JAX package's kernel
  refuses and its dispatch sends to its jnp arm, counting
  spoof_plain_by_layout);
- a plain PyTorch version of the same function (`*_plain`), which the
  CPU tests use and chip_smoke.py compares the kernel with;
- a launch counter, `<wrapper>.launches`, a plain integer that grows by
  one per kernel launch and nowhere else (codegen/counts.count, which also
  keeps the launching thread's tally).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from systemml_tpu_torch.codegen import build, counts
from systemml_tpu_torch.utils import stats as stats_mod

# --------------------------------------------------------------------------
# mmchain: t(X) %*% (w? * (X %*% v) -? y) in ONE pass over X
# (csrc/mmchain.cu; reference: MapMultChain / LibMatrixMult.matrixMultChain)
# --------------------------------------------------------------------------

MMCHAIN_CTYPES = {"XtXv": 0, "XtwXv": 1, "XtXvy": 2}
# what the kernel takes (csrc/mmchain.cu), the JAX package's family
# predicate: k >= 128 and c <= 8 chain columns, any k above (a k past
# 2,048 takes the cluster kernel, mmchain_wide)
MMCHAIN_MIN_K = 128
MMCHAIN_MAX_C = 8

_mmchain_lib: Optional[ctypes.CDLL] = None
# (device index, k, c, rows contiguous) -> blocks of the partial kernel
# resident per SM; for k past the narrow kernel's width, (blocks per
# cluster, passes, clusters resident on the device) of the wide kernel
_mmchain_occupancy: Dict[Tuple[int, int, int, bool], object] = {}


def mmchain_supported(m: int, k: int, c: int, dtype) -> bool:
    """The shapes and dtype the hand kernel takes: the JAX package's
    family predicate (fp32, k >= 128, c <= 8), at any k."""
    return (dtype == torch.float32 and k >= MMCHAIN_MIN_K
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
        lib.smtorch_mmchain_narrow_max_k.argtypes = []
        lib.smtorch_mmchain_narrow_max_k.restype = ctypes.c_int
        lib.smtorch_mmchain_wide_plan.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3)
        lib.smtorch_mmchain_wide_plan.restype = ctypes.c_int
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
                  flat: bool, blocks_per_sm: Optional[int] = None) -> int:
    """A block per chunk of rows, at most the SMs times the blocks
    resident per SM (capped at `blocks_per_sm`, the kernel backend's
    sweep of K1). For k past the narrow kernel's width, the clusters of
    the wide kernel per pass: a cluster per chunk of rows, at most the
    clusters resident on the device over the passes (the cap counting
    the cluster's blocks)."""
    chunks = -(-m // lib.smtorch_mmchain_chunk_rows())
    if k > lib.smtorch_mmchain_narrow_max_k():
        key = (dev.index, k, c, "wide")
        plan = _mmchain_occupancy.get(key)
        if plan is None:
            blocks, passes, clusters = (ctypes.c_int(0), ctypes.c_int(0),
                                        ctypes.c_int(0))
            _check(lib.smtorch_mmchain_wide_plan(
                k, c, ctypes.byref(blocks), ctypes.byref(passes),
                ctypes.byref(clusters)), "mmchain wide occupancy query")
            if clusters.value < 1:
                raise RuntimeError(f"mmchain wide kernel cannot be resident "
                                   f"at k={k}, c={c}")
            plan = _mmchain_occupancy[key] = (blocks.value, passes.value,
                                              clusters.value)
        blocks, passes, clusters = plan
        if blocks_per_sm is not None:
            clusters = min(clusters, max(1, int(blocks_per_sm) * _sms(dev)
                                         // blocks))
        return max(1, min(chunks, clusters // passes))
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
    if blocks_per_sm is not None:
        per_sm = max(1, min(per_sm, int(blocks_per_sm)))
    return max(1, min(chunks, per_sm * _sms(dev)))


def mmchain_kernel(x, v, w=None, ctype: str = "XtXv", precise: bool = True,
                   blocks_per_sm: Optional[int] = None):
    """t(X) %*% (X %*% v) (XtXv), t(X) %*% (w * (X %*% v)) (XtwXv) or
    t(X) %*% ((X %*% v) - y) (XtXvy), reading X once (csrc/mmchain.cu).

    x (m, k); v (k,) or (k, c); w/y (m, 1), broadcast over c, or (m, c).
    Returns (k, c). On a CUDA tensor it launches the kernel, or raises
    when the kernel does not take the input (not fp32, X's rows not
    contiguous, k or c outside mmchain_supported). X may be a row or
    column slice of a wider matrix: the kernel reads it in place; on a CPU tensor it runs
    mmchain_plain. `precise` is accepted for the JAX package's signature
    and changes nothing: the kernel always multiplies in true fp32.
    `blocks_per_sm` caps the grid's resident blocks per SM (None: as
    many as fit)."""
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
        raise ValueError(f"mmchain_kernel takes k >= {MMCHAIN_MIN_K} and "
                         f"c <= {MMCHAIN_MAX_C}; got k={k}, c={c}")
    v = v.contiguous()
    w = None if w is None else w.contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        grid = _mmchain_grid(lib, x.device, m, k, c, ldx == k,
                             blocks_per_sm)
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
    counts.count(mmchain_kernel)
    return out


mmchain_kernel.launches = 0


# --------------------------------------------------------------------------
# spoof cell, row and multi-aggregate templates: one fused plan over the
# main leaf's cells (csrc/spoof.cuh instantiated per plan and Variant;
# reference: SpoofCellwise, SpoofRowwise, SpoofMultiAggregate)
# --------------------------------------------------------------------------

SPOOF_DTYPES = {torch.float32: 0, torch.float64: 1}
SPOOF_AGGS = {"sum": 0, "min": 1, "max": 2}
SPOOF_MAX_LEAVES = 64      # spoof::kMaxLeaves
SPOOF_THREADS = 256        # spoof::kThreads
# blocks of SPOOF_THREADS that an SM holds at most (2,048 threads): the
# row template's grid-stride grids, the cell and multi-aggregate
# templates' persistent grids at most
SPOOF_BLOCKS_PER_SM = 8
# the flat walk's vector: 16 bytes (float4, double2)
SPOOF_VECTOR_BYTES = 16
WALK_FLAT, WALK_GENERAL = 0, 1


def _matrices(names: Sequence[str], env: Dict[str, object]):
    """The plan's matrix leaves (2-D tensors), in the order of `names`;
    the first is the main leaf, as in the JAX package."""
    return [n for n in names
            if isinstance(env[n], torch.Tensor) and env[n].ndim == 2]


def spoof_layout_ok(names: Sequence[str], env: Dict[str, object],
                    mats: Optional[Sequence[str]] = None) -> bool:
    """Whether every matrix leaf has a layout the kernels take, as the JAX
    package's `_leaf_layout` (systemml_tpu/codegen/kernels.py:88-116)
    decides it: with the main leaf (m, n), each matrix leaf is (m, n),
    (m, 1), (1, n) or (1, 1). Another shape (Kmeans' (m, 1) main leaf
    beside an (m, k) leaf) takes the plain arm there and here. `mats`:
    _matrices(names, env), when the caller has it."""
    mats = _matrices(names, env) if mats is None else mats
    m, n = env[mats[0]].shape
    for nm in mats:
        am, an = env[nm].shape
        if not ((am == m and an in (n, 1)) or (am == 1 and an in (1, n))):
            return False
    return True


def _plain_env(names: Sequence[str], env: Dict[str, object], main):
    """Every leaf as a tensor of the main leaf's dtype on its device,
    which is what the kernel reads."""
    out = {}
    for nm in names:
        v = env[nm]
        if isinstance(v, torch.Tensor):
            out[nm] = v.to(main.dtype)
        else:
            out[nm] = torch.full((), float(v), dtype=main.dtype,
                                 device=main.device)
    return out


def _plain_value(plan, names, env):
    """The plan's value, in the main leaf's dtype. Its shape is the
    broadcast of the leaves' shapes: the main leaf's (m, n) when the
    layout is one the kernels take (the main leaf is one of the leaves).
    A plan without a matrix leaf is evaluated on its scalars, as the JAX
    package does when it has no matrix to tile (`has_matrix`)."""
    from systemml_tpu_torch.codegen.cplan import emit

    mats = _matrices(names, env)
    if not mats:
        return torch.as_tensor(emit(plan, env))
    main = env[mats[0]]
    return emit(plan, _plain_env(names, env, main)).to(main.dtype)


def cell_plain(plan, names: Sequence[str], agg: Optional[str],
               env: Dict[str, object]):
    """The plain version of the cell template: the plan evaluated by torch
    ops, then its full sum (agg "sum", a 0-d tensor) or its values (agg
    None, (m, n) for the layouts the kernel takes)."""
    val = _plain_value(plan, names, env)
    return torch.sum(val) if agg == "sum" else val.contiguous()


def row_plain(plan, names: Sequence[str], row_agg: str,
              env: Dict[str, object]):
    """The plain version of the row template: the plan evaluated by torch
    ops, each row reduced under sum, min or max, as (m, 1).
    min and max propagate NaN, as jnp.min/jnp.max."""
    val = _plain_value(plan, names, env)
    if val.ndim < 2:
        val = val.reshape(1, -1)
    _check_row_width(row_agg, val.shape[1])
    if row_agg == "sum":
        return torch.sum(val, dim=1, keepdim=True)
    if row_agg in ("min", "max"):
        red = torch.amin if row_agg == "min" else torch.amax
        return red(val, dim=1, keepdim=True)
    raise ValueError(f"unknown row aggregate {row_agg!r}")


def _check_row_width(row_agg: str, n: int) -> None:
    """min and max of a row of no cells have no value, as jnp.min/jnp.max
    of an empty axis; a row sum of no cells is 0."""
    if n == 0 and row_agg in ("min", "max"):
        raise ValueError(f"row {row_agg} of rows with no columns")


def _count(event: str) -> None:
    st = stats_mod.current()
    if st is not None:
        st.count_estim(event)


def _count_plain_by_layout() -> None:
    _count("spoof_plain_by_layout")


def is_scalar_value(v) -> bool:
    """A leaf value that the generated source takes as a scalar: a Python
    number, or a tensor of fewer than 2 dims."""
    return not isinstance(v, torch.Tensor) or v.ndim < 2


def _tensor_key(v) -> Tuple:
    """What makes two tensors the same leaf value: storage address,
    shape, strides, dtype and device."""
    return (v.data_ptr(), v.shape, v.stride(), v.dtype, v.device)


def env_variant(template: str, order: Sequence[str], env: Dict[str, object],
                aggs: Sequence[str] = ()) -> "build.Variant":
    """The Variant of a plan built on demand, from the wrapper's values of
    its leaves `order` (the plan's input names): the scalars are
    is_scalar_value's; a tensor leaf that is the same tensor as an earlier
    one (_tensor_key) aliases the first such, for the cell and
    multi-aggregate templates (the only ones with a flat walk). The outer
    template's X and UV are never scalars."""
    fixed = ("X", "UV") if template == "outer" else ()
    scalars = frozenset(nm for nm in order
                        if nm not in fixed and is_scalar_value(env[nm]))
    aliases = []
    if template in ("cell", "multiagg"):
        keys: Dict[int, Tuple] = {}
        firsts: Dict[Tuple, str] = {}
        for nm in order:
            if nm in scalars:
                continue
            v = env[nm]
            key = keys.get(id(v))
            if key is None:
                key = keys[id(v)] = _tensor_key(v)
            tgt = firsts.setdefault(key, nm)
            if tgt != nm:
                aliases.append((nm, tgt))
    return build.Variant(tuple(aggs), scalars, tuple(aliases))


def _spoof_leaves(order, env, main, variant):
    """Per leaf, in `order` (the plan's input names: the order of the
    generated source's leaves), the ctypes arrays of pointers (None for a
    host number), row strides, column strides and host numbers; the
    tensors the pointers point into; and the leaf's class: "uniform" (a
    scalar of `variant`: one value, read once), "alias" (an alias of
    `variant` that is the same tensor as its target), "flat" (the main
    leaf's (m, n), contiguous, 16-byte aligned) or "general" (any other
    layout, read through its descriptor). The flat walk runs when no leaf
    is general. A tensor of another dtype than the main leaf's is cast on
    the device (a 0-d sum among them: no host read); a tensor named twice
    is looked at once."""
    n = len(order)
    ptrs, rs, cs, scal = ((ctypes.c_void_p * n)(), (ctypes.c_longlong * n)(),
                          (ctypes.c_longlong * n)(), (ctypes.c_double * n)())
    keep, classes = [], []
    scalars, alias = variant.scalars, dict(variant.aliases)
    # id(tensor) -> (pointer, row stride, column stride, elements, flat)
    seen: Dict[int, Tuple] = {}
    for i, nm in enumerate(order):
        v = env[nm]
        if not isinstance(v, torch.Tensor):
            scal[i] = float(v)
            classes.append("uniform" if nm in scalars else "general")
            continue
        hit = seen.get(id(v))
        if hit is None:
            hit = seen[id(v)] = _describe_leaf(nm, v, main, keep)
        ptrs[i], r, c, numel, flat = hit
        if r:
            rs[i] = r
        if c:
            cs[i] = c
        if nm in scalars:
            if numel != 1:
                raise ValueError(f"spoof leaf {nm!r} is a scalar of the "
                                 f"plan's source, but has shape "
                                 f"{tuple(v.shape)}")
            classes.append("uniform")
        elif nm in alias:
            tgt = env[alias[nm]]
            same = tgt is v or (isinstance(tgt, torch.Tensor)
                                and _tensor_key(tgt) == _tensor_key(v))
            classes.append("alias" if same else "general")
        else:
            classes.append("flat" if flat else "general")
    return (ptrs, rs, cs, scal), keep, classes


def _describe_leaf(nm: str, v, main, keep: list) -> Tuple:
    """(pointer, row stride, column stride, elements, flat) of tensor leaf
    v, cast to the main leaf's dtype (the cast kept alive in `keep`)."""
    if v.device != main.device:
        raise ValueError(f"spoof leaf {nm!r} is on {v.device}, the main "
                         f"leaf on {main.device}")
    t = v if v.dtype == main.dtype else v.to(main.dtype)
    if t.ndim == 2:
        r = t.stride(0) if t.shape[0] > 1 else 0
        c = t.stride(1) if t.shape[1] > 1 else 0
    elif t.numel() == 1:
        r = c = 0
    else:
        raise ValueError(f"spoof leaf {nm!r} has shape {tuple(t.shape)}")
    keep.append(t)
    ptr = t.data_ptr()
    return (ptr, r, c, t.numel(), t.shape == main.shape and t.is_contiguous()
            and ptr % SPOOF_VECTOR_BYTES == 0)


def leaf_classes(plan, template: str, env: Dict[str, object], variant=None
                 ) -> Dict[str, str]:
    """Each leaf's class at a launch of `plan` on `env` (see
    _spoof_leaves): the flat walk runs when none is "general". `variant`
    as the wrappers take it."""
    order = plan.input_names()
    main = env[_matrices(order, env)[0]]
    variant = _variant_of(template, plan, env, variant,
                          variant.aggs if variant is not None else ())
    return dict(zip(order, _spoof_leaves(order, env, main, variant)[2]))


# the launch preparations a plan keeps (a loop launches one plan on the
# same few tensors again and again)
_PREP_CAP = 64


def _prepare(plan, template: str, env: Dict[str, object], main, variant,
             aggs: Tuple[str, ...] = ()):
    """(Variant, (ptrs, rs, cs, scal), leaf classes, tensors to keep alive)
    of a launch of `plan` for `template` on `env`, as _variant_of and
    _spoof_leaves give them. Memoised per plan on the leaves' signature
    (each tensor's pointer, shape, strides and dtype; a host number's
    place) and the main leaf's shape and dtype, of which the Variant
    derived from the values, the classes and the arguments are all
    functions (device pointers are unique across devices). A launch that
    casts a leaf to the main leaf's dtype (a new tensor each call) is not
    memoised. Host numbers are written anew each call."""
    d = plan.__dict__
    order = d.get("_spoof_order")
    if order is None:
        order = d["_spoof_order"] = plan.input_names()
    sig, seen = [], {}
    for nm in order:
        v = env[nm]
        if isinstance(v, torch.Tensor):
            s = seen.get(id(v))     # a tensor named twice is looked at once
            if s is None:
                s = seen[id(v)] = (v.data_ptr(), v.shape, v.stride(), v.dtype)
            sig.append(s)
        else:
            sig.append(None)
    sig = tuple(sig)
    key = (template, variant, aggs, main.shape, main.dtype, sig)
    memo = d.setdefault("_spoof_prepared", {})
    hit = memo.get(key)
    if hit is None:
        variant = _variant_of(template, plan, env, variant, aggs)
        args, keep, classes = _spoof_leaves(order, env, main, variant)
        host = tuple(i for i, s in enumerate(sig) if s is None)
        if all(s is None or s[3] == main.dtype for s in sig):
            if len(memo) >= _PREP_CAP:
                memo.clear()
            memo[key] = (variant, args, classes, host)
        return variant, args, classes, keep
    variant, (ptrs, rs, cs, scal), classes, host = hit
    if host:
        scal = (ctypes.c_double * len(order))()
        for i in host:
            scal[i] = float(env[order[i]])
    return variant, (ptrs, rs, cs, scal), classes, ()


_ARGTYPES = {
    # dtype, walk, ptrs, rs, cs, scal, n_leaves, m, n, n_aggs, out,
    # partial, ticket, grid, stream
    "multiagg": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]),
    # dtype, ptrs, rs, cs, scal, n_leaves, m, n, r, u, urs, ucs, v, vrs,
    # vcs, out, partial, grid_x, grid_y, stream
    "outer": ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
              + [ctypes.c_longlong] * 2 + [ctypes.c_int]
              + ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 2
              + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
              + [ctypes.c_void_p]),
    # dtype, agg, walk, ptrs, rs, cs, scal, n_leaves, m, n, out, partial,
    # ticket, grid, stream
    "cell": ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
             + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_void_p]),
    # dtype, row_agg, ptrs, rs, cs, scal, n_leaves, m, n, out, grid, stream
    "row": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
            + [ctypes.c_int, ctypes.c_void_p]),
}
# the occupancy queries: (dtype, [agg,] walk, int *blocks)
_OCC_ARGTYPES = {"cell": [ctypes.c_int] * 3 + [ctypes.c_void_p],
                 "multiagg": [ctypes.c_int] * 2 + [ctypes.c_void_p]}
_sm_count: Dict[int, int] = {}
# (device index, stream) -> (partials, ticket) of the one-launch reductions,
# made under _scratch_lock (parfor workers make theirs at once)
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_scratch_lock = threading.Lock()


class _Launcher:
    """A plan's library for one template and Variant: its extern "C"
    launcher, its leaf order, and its kernels' resident blocks per SM by
    (device, dtype, agg, walk), asked once."""

    def __init__(self, plan, template: str, variant):
        self.order = plan.input_names()
        if len(self.order) > SPOOF_MAX_LEAVES:
            raise ValueError(f"spoof kernel takes at most {SPOOF_MAX_LEAVES}"
                             f" leaves; the plan has {len(self.order)}")
        lib = build.load_plan(template, plan, variant)
        self.fn = getattr(lib, f"smtorch_spoof_{template}")
        self.fn.argtypes = _ARGTYPES[template]
        self.fn.restype = ctypes.c_int
        self.occ = None
        if template in _OCC_ARGTYPES:
            self.occ = getattr(lib, f"smtorch_spoof_{template}_occupancy")
            self.occ.argtypes = _OCC_ARGTYPES[template]
            self.occ.restype = ctypes.c_int
        self.template = template
        self._per_sm: Dict[Tuple[int, ...], int] = {}
        # (device, dtype, [agg,] walk, cells) -> grid: a loop launches one
        # plan at one shape many times
        self.grids: Dict[Tuple[int, ...], int] = {}

    def per_sm(self, dev: torch.device, *key: int) -> int:
        hit = self._per_sm.get((dev.index,) + key)
        if hit is None:
            n = ctypes.c_int(0)
            with torch.cuda.device(dev):
                _check(self.occ(*key, ctypes.byref(n)),
                       f"spoof {self.template} occupancy query")
            if not 1 <= n.value <= SPOOF_BLOCKS_PER_SM:
                raise RuntimeError(f"spoof {self.template} kernel: "
                                   f"{n.value} resident blocks per SM")
            hit = self._per_sm[(dev.index,) + key] = n.value
        return hit


def _launcher(plan, template: str, variant) -> _Launcher:
    """`plan`'s launcher for `template` and `variant`, built at first use
    (codegen/build.py), kept on the plan object: a loop launches the same
    plan many times, and generating and hashing its source again would
    cost more host time than the kernel takes."""
    cache = plan.__dict__.setdefault("_spoof_launchers", {})
    hit = cache.get((template, variant))
    if hit is None:
        hit = cache[(template, variant)] = _Launcher(plan, template, variant)
    return hit


def _sms(dev: torch.device) -> int:
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


def _per_sm(resident: int, blocks_per_sm: Optional[int]) -> int:
    """Blocks per SM of a grid: those resident, capped at
    `blocks_per_sm` (the kernel backend's sweep; None: no cap)."""
    if blocks_per_sm is None:
        return resident
    return max(1, min(resident, int(blocks_per_sm)))


def _spoof_grid(dev: torch.device, work: int,
                blocks_per_sm: Optional[int] = None) -> int:
    return max(1, min(-(-work // SPOOF_THREADS),
                      _per_sm(SPOOF_BLOCKS_PER_SM, blocks_per_sm)
                      * _sms(dev)))


def _walk_grid(launcher: _Launcher, main, key: Tuple[int, ...], walk: int,
               cells: int, blocks_per_sm: Optional[int] = None) -> int:
    """A persistent grid: the SMs times the kernel's resident blocks
    (capped at `blocks_per_sm`), or fewer when the work needs fewer
    threads (the flat walk gives a thread two vectors a step, and the
    ragged tail a thread a cell)."""
    dev = main.device
    gkey = (dev.index, SPOOF_DTYPES[main.dtype]) + key + (walk, cells)
    grid = launcher.grids.get(gkey + (blocks_per_sm,))
    if grid is None:
        if walk == WALK_FLAT:
            per_vec = SPOOF_VECTOR_BYTES // main.element_size()
            nvec = cells // per_vec
            threads = max(-(-nvec // 2), cells - nvec * per_vec)
        else:
            threads = cells
        per_sm = _per_sm(launcher.per_sm(dev, *gkey[1:-1]), blocks_per_sm)
        grid = launcher.grids[gkey + (blocks_per_sm,)] = max(1, min(
            -(-threads // SPOOF_THREADS), per_sm * _sms(dev)))
    return grid


def _reduce_scratch(dev: torch.device, stream: int):
    """The partials (3 doubles per block) and the ticket of the one-launch
    reductions on `stream`, made once: a call allocates nothing, and the
    last block leaves the ticket at 0. Two streams never share them."""
    key = (dev.index, stream)
    hit = _scratch.get(key)
    if hit is None:
        if torch.cuda.is_current_stream_capturing():
            # made inside a capture it would live in the graph's pool
            raise RuntimeError("spoof reduce scratch of a capturing stream "
                               "is made before its capture "
                               "(runtime/loopfuse.capture_streams)")
        with _scratch_lock:
            hit = _scratch.get(key)
            if hit is None:
                cap = 3 * SPOOF_BLOCKS_PER_SM * _sms(dev)
                hit = _scratch[key] = (
                    torch.empty(cap, dtype=torch.float64, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev))
    return hit


def _count_walk(walk: int) -> None:
    _count("spoof_flat_walk" if walk == WALK_FLAT else "spoof_general_walk")


def _kernel_main(names: Sequence[str], env: Dict[str, object], what: str):
    """The main leaf when a kernel is to run this call, else None and the
    caller runs its plain version: for a plan without a matrix leaf, for
    a leaf layout the JAX package's kernel refuses (on any device; counted
    in spoof_plain_by_layout) and for a CPU main leaf. Raises on a CUDA
    main leaf the kernels do not take. An empty main leaf launches too:
    the kernels' loops then run no iteration (a sum of nothing is 0)."""
    mats = _matrices(names, env)
    if not mats:
        return None
    if not spoof_layout_ok(names, env, mats):
        _count_plain_by_layout()
        return None
    main = env[mats[0]]
    if main.device.type == "cpu":
        return None
    if main.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {main.device}")
    if main.dtype not in SPOOF_DTYPES:
        raise TypeError(f"{what} takes fp32 and fp64 main leaves; got "
                        f"{main.dtype}")
    return main


def _variant_of(template, plan, env, variant, aggs=()):
    if variant is None:
        return env_variant(template, plan.input_names(), env, aggs)
    if tuple(variant.aggs) != tuple(aggs):
        raise ValueError(f"{template} source for aggregates "
                         f"{list(variant.aggs)}, called for {list(aggs)}")
    return variant


def cell_kernel(plan, names: Sequence[str], agg: Optional[str],
                env: Dict[str, object], variant=None,
                blocks_per_sm: Optional[int] = None):
    """The cell template (systemml_tpu/codegen/kernels.py:124): the plan
    evaluated at every cell of the main leaf's (m, n), written out as
    (m, n) (agg None) or summed (agg "sum", a 0-d tensor), in the main
    leaf's dtype.

    `env` maps each name of `names` to a tensor (2-D, or a 0-d/one-element
    scalar) or a Python number; `variant` is the build.Variant of the
    plan's source (a spoof hop's, from the compiler), derived from `env`
    when None. A leaf layout that the JAX package's kernel refuses takes
    the plain arm, on any device, and counts `spoof_plain_by_layout`.
    Otherwise, on a CUDA main leaf it launches the plan's kernel
    (csrc/spoof.cuh) on the flat walk or the general one (counted in
    spoof_flat_walk / spoof_general_walk), or raises on what the kernel
    does not take; on a CPU main leaf it runs cell_plain. A plan with no
    matrix leaf runs on its scalars. `blocks_per_sm` caps the grid's
    resident blocks per SM (None: as many as fit)."""
    if agg not in (None, "sum"):
        raise ValueError(f"unknown cell aggregate {agg!r}")
    main = _kernel_main(names, env, "cell_kernel")
    if main is None:
        return cell_plain(plan, names, agg, env)
    variant, (ptrs, rs, cs, scal), classes, keep = _prepare(
        plan, "cell", env, main, variant)
    la = _launcher(plan, "cell", variant)
    m, n = main.shape
    code = 0 if agg is None else 1
    walk = WALK_GENERAL if "general" in classes else WALK_FLAT
    with torch.cuda.device(main.device):
        stream = torch.cuda.current_stream(main.device).cuda_stream
        grid = _walk_grid(la, main, (code,), walk, m * n, blocks_per_sm)
        if agg is None:
            out = torch.empty((m, n), dtype=main.dtype, device=main.device)
            partial = ticket = None
        else:
            out = torch.empty((), dtype=main.dtype, device=main.device)
            partial, ticket = (t.data_ptr() for t in
                               _reduce_scratch(main.device, stream))
        err = la.fn(SPOOF_DTYPES[main.dtype], code, walk, ptrs, rs, cs, scal,
                    len(la.order), m, n, out.data_ptr(), partial, ticket,
                    grid, stream)
    _check(err, "spoof cell kernel launch")
    del keep
    counts.count(cell_kernel)
    _count_walk(walk)
    return out


def row_kernel(plan, names: Sequence[str], row_agg: str,
               env: Dict[str, object], variant=None,
               blocks_per_sm: Optional[int] = None):
    """The row template (systemml_tpu/codegen/kernels.py:199): the plan
    evaluated over the main leaf's (m, n), then each row reduced under
    `row_agg` ("sum", "min" or "max"), giving (m, 1) in the main leaf's
    dtype. Dispatch and `blocks_per_sm` as cell_kernel's; the row kernels
    read every leaf through its descriptor."""
    if row_agg not in SPOOF_AGGS:
        raise ValueError(f"unknown row aggregate {row_agg!r}")
    main = _kernel_main(names, env, "row_kernel")
    if main is None:
        return row_plain(plan, names, row_agg, env)
    m, n = main.shape
    _check_row_width(row_agg, n)
    variant, (ptrs, rs, cs, scal), _, keep = _prepare(plan, "row", env,
                                                      main, variant)
    la = _launcher(plan, "row", variant)
    with torch.cuda.device(main.device):
        grid = _spoof_grid(main.device, m if n <= 32 else 32 * m,
                           blocks_per_sm)
        out = torch.empty((m, 1), dtype=main.dtype, device=main.device)
        err = la.fn(SPOOF_DTYPES[main.dtype], SPOOF_AGGS[row_agg], ptrs, rs,
                    cs, scal, len(la.order), m, n, out.data_ptr(), grid,
                    torch.cuda.current_stream(main.device).cuda_stream)
    _check(err, "spoof row kernel launch")
    del keep
    counts.count(row_kernel)
    return out


cell_kernel.launches = 0
row_kernel.launches = 0


def _reduce(agg: str, val):
    """sum, min or max of every cell; min and max propagate NaN and have
    no value over no cells, as jnp.min/jnp.max (ValueError)."""
    if agg == "sum":
        return torch.sum(val)
    if val.numel() == 0:
        raise ValueError(f"{agg} of no cells has no value")
    return torch.amin(val) if agg == "min" else torch.amax(val)


def multiagg_plain(plan, names: Sequence[str], aggs: Sequence[str],
                   env: Dict[str, object]):
    """The plain version of the multi-aggregate template: the plan
    evaluated by torch ops once, then reduced under each aggregate of
    `aggs`; a tuple of 0-d tensors in the main leaf's dtype, as the JAX
    package's jnp arm (`_magg_jnp`)."""
    val = _plain_value(plan, names, env)
    return tuple(_reduce(a, val) for a in aggs)


def multiagg_kernel(plan, names: Sequence[str], aggs: Sequence[str],
                    env: Dict[str, object], variant=None,
                    blocks_per_sm: Optional[int] = None):
    """The multi-aggregate template (systemml_tpu/codegen/kernels.py:242):
    the plan evaluated once at every cell of the main leaf's (m, n) and
    reduced under every aggregate of `aggs` ("sum", "min", "max", any
    order, repeats allowed), a tuple of 0-d tensors in the main leaf's
    dtype; the aggregates are compiled into the plan's source (`variant`,
    whose aggs are `aggs`). Dispatch and `blocks_per_sm` as
    cell_kernel's. A min or max over no cells raises ValueError on either
    device."""
    aggs = tuple(str(a) for a in aggs)
    if not aggs or any(a not in SPOOF_AGGS for a in aggs):
        raise ValueError(f"multi-aggregate takes sum, min and max; got "
                         f"{list(aggs)}")
    main = _kernel_main(names, env, "multiagg_kernel")
    if main is None:
        return multiagg_plain(plan, names, aggs, env)
    m, n = main.shape
    if m * n == 0 and any(a != "sum" for a in aggs):
        raise ValueError(f"{list(aggs)}: min and max of no cells have no "
                         f"value")
    variant, (ptrs, rs, cs, scal), classes, keep = _prepare(
        plan, "multiagg", env, main, variant, aggs)
    la = _launcher(plan, "multiagg", variant)
    walk = WALK_GENERAL if "general" in classes else WALK_FLAT
    with torch.cuda.device(main.device):
        stream = torch.cuda.current_stream(main.device).cuda_stream
        grid = _walk_grid(la, main, (), walk, m * n, blocks_per_sm)
        out = torch.empty(len(aggs), dtype=main.dtype, device=main.device)
        partial, ticket = _reduce_scratch(main.device, stream)
        err = la.fn(SPOOF_DTYPES[main.dtype], walk, ptrs, rs, cs, scal,
                    len(la.order), m, n, len(aggs), out.data_ptr(),
                    partial.data_ptr(), ticket.data_ptr(), grid, stream)
    _check(err, "spoof multiagg kernel launch")
    del keep
    counts.count(multiagg_kernel)
    _count_walk(walk)
    return tuple(out[k] for k in range(len(aggs)))


multiagg_kernel.launches = 0


# --------------------------------------------------------------------------
# spoof outer-product template: sum(f(X, U %*% t(V))) without the (m, n)
# product (csrc/spoof.cuh outer_sum; reference: SpoofOuterProduct)
# --------------------------------------------------------------------------

OUTER_ROWS = 64            # spoof::kOuterRows
# past spoof::kOuterBucketRank, outer_sum_wide's blocks take tiles of
# OUTER_WIDE_TILE x OUTER_WIDE_TILE cells (spoof::kWideTile)
OUTER_BUCKET_RANK = 32
OUTER_WIDE_TILE = 128
_MAX_GRID_Y = 65535


def _outer_shapes(x, u, v) -> Tuple[int, int, int]:
    if x.ndim != 2 or u.ndim != 2 or v.ndim != 2:
        raise ValueError("outer template: X, U and V must be matrices")
    m, n = x.shape
    if u.shape[0] != m or v.shape[0] != n or u.shape[1] != v.shape[1]:
        raise ValueError(f"outer template: X {tuple(x.shape)}, U "
                         f"{tuple(u.shape)}, V {tuple(v.shape)} do not fit "
                         f"sum(f(X, U %*% t(V)))")
    return m, n, u.shape[1]


def outer_plain(plan, x, u, v, extra: Dict[str, object]):
    """The plain version of the outer template, the JAX package's jnp arm
    (`_outer_jnp`, systemml_tpu/codegen/compiler.py:397-404): UV = U %*%
    t(V) built whole by torch.matmul, the plan evaluated on X, UV and the
    scalar leaves `extra`, and summed; a 0-d tensor in X's dtype."""
    from systemml_tpu_torch.codegen.cplan import emit

    _outer_shapes(x, u, v)
    env = dict(extra)
    env["X"] = x
    env["UV"] = torch.matmul(u.to(x.dtype), v.to(x.dtype).T)
    names = [nm for nm in plan.input_names() if nm in env]
    return torch.sum(emit(plan, _plain_env(names, env, x))).to(x.dtype)


def outer_kernel(plan, x, u, v, extra: Dict[str, object], variant=None,
                 grid_y: Optional[int] = None):
    """The outer-product template (systemml_tpu/codegen/kernels.py:419):
    sum over X's (m, n) of the plan on X, UV = U %*% t(V) and the scalar
    leaves `extra` (Python numbers or 0-d tensors), in X's dtype; X (m, n),
    U (m, r), V (n, r), any strides, any rank. On a CUDA X it launches
    the plan's kernel (csrc/spoof.cuh outer_sum, or outer_sum_wide for a
    rank above 32; neither builds the (m, n) product), or raises on what
    the kernel does not take; on a CPU X it runs outer_plain. `variant` is
    the build.Variant of the plan's source (its scalar leaves), derived
    from `extra` when None. `grid_y` caps the grid's rows of blocks, each
    of which strides over X's tiles of OUTER_ROWS rows (of OUTER_WIDE_TILE
    past rank 32; None: a block row per tile, up to CUDA's 65,535)."""
    m, n, r = _outer_shapes(x, u, v)
    if x.device.type == "cpu":
        return outer_plain(plan, x, u, v, extra)
    if x.device.type != "cuda":
        raise ValueError(f"outer_kernel: unsupported device {x.device}")
    if x.dtype not in SPOOF_DTYPES:
        raise TypeError(f"outer_kernel takes fp32 and fp64 X; got {x.dtype}")
    if u.device != x.device or v.device != x.device:
        raise ValueError("outer_kernel: X, U and V on different devices")
    u, v = u.to(x.dtype), v.to(x.dtype)
    env = dict(extra)
    env["X"] = x
    env["UV"] = 0.0          # computed per cell; never read as a leaf
    variant, (ptrs, rs, cs, scal), _, keep = _prepare(plan, "outer", env, x,
                                                      variant)
    la = _launcher(plan, "outer", variant)
    cols, rows = ((SPOOF_THREADS, OUTER_ROWS) if r <= OUTER_BUCKET_RANK
                  else (OUTER_WIDE_TILE, OUTER_WIDE_TILE))
    grid_x = max(1, -(-n // cols))
    grid_y = max(1, min(-(-m // rows), _MAX_GRID_Y,
                        _MAX_GRID_Y if grid_y is None else int(grid_y)))
    stride = lambda t, d: t.stride(d) if t.shape[d] > 1 else 0
    with torch.cuda.device(x.device):
        out = torch.empty((), dtype=x.dtype, device=x.device)
        partial = torch.empty(grid_x * grid_y, dtype=torch.float64,
                              device=x.device)
        err = la.fn(SPOOF_DTYPES[x.dtype], ptrs, rs, cs, scal, len(la.order),
                    m, n, r, u.data_ptr(), stride(u, 0), stride(u, 1),
                    v.data_ptr(), stride(v, 0), stride(v, 1), out.data_ptr(),
                    partial.data_ptr(), grid_x, grid_y,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _check(err, "spoof outer kernel launch")
    del keep
    counts.count(outer_kernel)
    return out


outer_kernel.launches = 0
