"""Buffer pool: device/host/disk residency of symbol-table matrices.

Port of systemml_tpu/runtime/bufferpool.py (the reference's
CacheableData acquireRead/release, LazyWriteBuffer and GPUMemoryManager):
a matrix bound into the symbol table (`VarMap`) becomes a
`CacheableMatrix` handle; when the tracked device bytes pass the budget,
the least recently used unpinned handles are evicted: copied into
(pinned) host memory, and the pool drops its device tensor. A read
resolves the handle, restoring it to the device first. Host copies past
the host budget spill to `scratch_dir` on disk.

The budget is `bufferpool_budget_bytes`, else `mem_util_factor` times
`mem_budget_bytes`, else times the card's memory
(`torch.cuda.mem_get_info()`'s total; the host's on the CPU).

Where the port departs from the JAX package:

* Port tensors are not immutable. Loop regions write carried state into
  their static buffers in place, and in-place ops write their operands.
  So a host copy records the tensor's `_version` when it is taken; an
  eviction whose tensor's version has moved since takes the copy again
  (counted `stale_recopy`), and one whose version has not reuses it.
* A captured CUDA graph (runtime/loopfuse.py) reads the device addresses
  it captured. An eviction therefore drops every cached region graph
  that reads the evicted storage (loopfuse.invalidate_storage, counted
  `graph_invalidate`); the next entry of that loop captures again on the
  restored tensor's address. A block graph (runtime/blockcompile.py)
  copies its inputs into buffers of its own, so evictions do not reach
  it.
* Nothing is admitted or evicted while a loop region runs: its reads and
  writes are the region's static buffers.
* Tensors bound by the API caller (MLContext inputs, JMLC bindings) are
  never admitted: the caller holds them, so an eviction would free
  nothing (`VarMap.external`).

Eviction drops the pool's reference; the storage returns to torch's
caching allocator once no other reference holds it. The fault-injection
site at admission waits for ROADMAP queue 1, distributed and elastic.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
import weakref
from typing import Dict, List, Optional

import torch


class BufferPoolError(RuntimeError):
    pass


class CacheableMatrix:
    """Residency handle for one matrix value. May be bound under several
    symbol-table names (aliases share the handle, reference: CacheableData
    reference counting)."""

    __slots__ = ("_pool", "names", "nbytes", "shape", "dtype", "device",
                 "_device", "_host", "_host_version", "_disk_path",
                 "last_use", "pins", "__weakref__")

    def __init__(self, pool: "BufferPool", t: torch.Tensor, nbytes: int):
        # weakly: the pool holds its handles, and a dropped program frees
        # its pool's tensors without waiting for the cyclic collector
        self._pool = weakref.ref(pool)
        self.names: List[str] = []
        self.nbytes = nbytes
        self.shape = tuple(t.shape)
        self.dtype = t.dtype
        self.device = t.device
        self._device: Optional[torch.Tensor] = t
        self._host: Optional[torch.Tensor] = None
        # the device tensor's _version when _host was copied from it
        self._host_version: Optional[int] = None
        self._disk_path: Optional[str] = None
        self.last_use = time.monotonic()
        # >0: an input of an executing block, not evictable
        self.pins = 0

    @property
    def pool(self) -> "BufferPool":
        return self._pool()

    @property
    def on_device(self) -> bool:
        return self._device is not None

    def resolve(self) -> torch.Tensor:
        return self.pool.acquire(self)

    def __repr__(self):
        tier = ("device" if self._device is not None else
                "host" if self._host is not None else "disk")
        return (f"<CacheableMatrix {self.shape} {self.dtype} "
                f"[{tier}] names={self.names}>")


def resolve(v):
    """A CacheableMatrix as its live tensor; anything else as it is."""
    if isinstance(v, CacheableMatrix):
        return v.resolve()
    return v


def _in_region() -> bool:
    from systemml_tpu_torch.compiler.lower import current_region

    return current_region() is not None


class pin_reads:
    """Pins the handles behind `names` in a VarMap while a block runs
    (reference: acquireRead/release around every instruction). No-op for
    plain dicts."""

    def __init__(self, vars_map, names):
        self._pinned: List[CacheableMatrix] = []
        pool = getattr(vars_map, "pool", None)
        if pool is None or not isinstance(vars_map, VarMap):
            return
        with pool._lock:
            for n in names:
                v = dict.get(vars_map, n)
                if isinstance(v, CacheableMatrix):
                    v.pins += 1
                    self._pinned.append(v)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self._pinned:
            with h.pool._lock:
                h.pins -= 1
        self._pinned.clear()
        return False


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class BufferPool:
    """Device-budgeted LRU pool over CacheableMatrix handles."""

    def __init__(self, cfg=None, stats=None):
        from systemml_tpu_torch.utils.config import get_config

        self.cfg = cfg or get_config()
        self.stats = stats
        self._lock = threading.RLock()
        self._entries: Dict[int, CacheableMatrix] = {}
        self._by_name: Dict[str, CacheableMatrix] = {}
        self._by_buffer: Dict[int, CacheableMatrix] = {}   # id(tensor)
        self.device_bytes = 0
        self.host_bytes = 0
        self._scratch: Optional[str] = None
        self._budget = None
        self._host_budget = None

    def _count(self, kind: str) -> None:
        if self.stats is not None:
            self.stats.count_pool(kind)

    def _obs_event(self, kind: str, h: CacheableMatrix) -> None:
        from systemml_tpu_torch.obs import trace as obs

        if obs.recording():
            obs.instant(kind, obs.CAT_POOL, bytes=h.nbytes,
                        device_bytes=self.device_bytes,
                        host_bytes=self.host_bytes)

    # ---- budgets --------------------------------------------------------

    def budget(self) -> float:
        if self._budget is None:
            cfg = self.cfg
            if cfg.bufferpool_budget_bytes is not None:
                self._budget = float(cfg.bufferpool_budget_bytes)
            else:
                cap = cfg.mem_budget_bytes
                if cap is None:
                    dev = torch.device(cfg.device)
                    if dev.type == "cuda":
                        cap = torch.cuda.mem_get_info(
                            dev.index if dev.index is not None
                            else torch.cuda.current_device())[1]
                    else:
                        cap = (os.sysconf("SC_PAGE_SIZE")
                               * os.sysconf("SC_PHYS_PAGES"))
                self._budget = cfg.mem_util_factor * float(cap)
        return self._budget

    def host_budget(self) -> float:
        if self._host_budget is None:
            hb = self.cfg.bufferpool_host_budget_bytes
            self._host_budget = float(hb if hb is not None
                                      else 4 * self.budget())
        return self._host_budget

    def scratch_dir(self) -> str:
        if self._scratch is None:
            import atexit
            import shutil

            d = os.path.join(self.cfg.scratch_dir,
                             f"bufferpool-{os.getpid()}-{uuid.uuid4().hex[:8]}")
            os.makedirs(d, exist_ok=True)
            self._scratch = d
            atexit.register(shutil.rmtree, d, ignore_errors=True)
        return self._scratch

    # ---- admission ------------------------------------------------------

    def _eligible(self, v) -> bool:
        return (isinstance(v, torch.Tensor) and v.layout == torch.strided
                and v.ndim >= 1
                and v.numel() * v.element_size() >= self.cfg.bufferpool_min_bytes)

    def admit(self, name: str, v):
        """Binds `name` to `v`: a large tensor becomes a tracked handle
        (returned); anything else passes through. Rebinding a name first
        releases its previous handle (the reference's rmvar-first
        freeing, GPUMemoryManager.java:200)."""
        if isinstance(v, CacheableMatrix):
            with self._lock:
                if self._by_name.get(name) is v:
                    return v
                # named first, so that unbinding the name's previous
                # handle cannot drop this one
                if id(v) not in self._entries:
                    self._track(v)
                if name not in v.names:
                    v.names.append(name)
                self._unname(name)
                self._by_name[name] = v
            return v
        if (not self.cfg.bufferpool_enabled or not self._eligible(v)
                or _in_region()):
            with self._lock:
                self._unname(name)
            return v
        with self._lock:
            self._unname(name)
            h = self._by_buffer.get(id(v))
            if h is None or h._device is not v:
                h = CacheableMatrix(self, v, v.numel() * v.element_size())
                self._entries[id(h)] = h
                self._by_buffer[id(v)] = h
                self.device_bytes += h.nbytes
                self._obs_event("pool_admit", h)
            h.names.append(name)
            h.last_use = time.monotonic()
            self._by_name[name] = h
            self._evict_to_budget(exclude=h)
        return h

    def _unname(self, name: str):
        h = self._by_name.pop(name, None)
        if h is None:
            return
        if name in h.names:
            h.names.remove(name)
        if not h.names:
            self._drop(h)

    def _drop(self, h: CacheableMatrix):
        """Stops tracking a handle that no name binds. Its tiers go with
        the handle object: a raw copy of a symbol table (a loop region's
        saved env) may still hold it and bind it again (`_track`), and its
        spill file is removed when the handle dies."""
        if self._entries.pop(id(h), None) is None:
            return
        if h._device is not None:
            self._by_buffer.pop(id(h._device), None)
            self.device_bytes -= h.nbytes
        if h._host is not None:
            self.host_bytes -= h.nbytes

    def _track(self, h: CacheableMatrix):
        """Tracks a dropped handle bound again."""
        self._entries[id(h)] = h
        if h._device is not None:
            self._by_buffer[id(h._device)] = h
            self.device_bytes += h.nbytes
        if h._host is not None:
            self.host_bytes += h.nbytes

    # ---- acquire / restore ----------------------------------------------

    def acquire(self, h: CacheableMatrix) -> torch.Tensor:
        with self._lock:
            h.last_use = time.monotonic()
            if h._device is not None:
                return h._device
            if h._host is None:
                self._restore_from_disk(h)
            t = h._host.to(h.device, non_blocking=False)
            # the host copy stays valid for this tensor until it is
            # written in place
            h._host_version = t._version
            if id(h) not in self._entries:
                return t
            h._device = t
            self._by_buffer[id(t)] = h
            self.device_bytes += h.nbytes
            self._count("restore")
            self._obs_event("pool_restore", h)
            self._evict_to_budget(exclude=h)
            return t

    def _restore_from_disk(self, h: CacheableMatrix):
        import numpy as np

        if not h._disk_path:
            raise BufferPoolError(f"handle {h!r} has no backing tier")
        h._host = torch.from_numpy(np.load(h._disk_path))
        self.host_bytes += h.nbytes
        self._count("disk_restore")

    # ---- eviction -------------------------------------------------------

    def _evict_to_budget(self, exclude: Optional[CacheableMatrix] = None):
        budget = self.budget()
        if self.device_bytes <= budget:
            return
        cands = sorted((h for h in self._entries.values()
                        if h._device is not None and h is not exclude
                        and h.pins == 0),
                       key=lambda h: h.last_use)
        for h in cands:
            if self.device_bytes <= budget:
                break
            self._evict_device(h)
        # host tier overflow -> disk (LazyWriteBuffer.writeBlock analog)
        if self.host_bytes > self.host_budget():
            hcands = sorted((h for h in self._entries.values()
                             if h._host is not None and h._device is None
                             and h is not exclude),
                            key=lambda h: h.last_use)
            for h in hcands:
                if self.host_bytes <= self.host_budget():
                    break
                self._spill_to_disk(h)

    def spill_device(self, exclude: Optional[CacheableMatrix] = None) -> int:
        """Evicts every unpinned device-resident handle to host, ignoring
        the budget. Returns the bytes freed."""
        with self._lock:
            freed = 0
            for h in sorted((h for h in self._entries.values()
                             if h._device is not None and h is not exclude
                             and h.pins == 0),
                            key=lambda h: h.last_use):
                freed += h.nbytes
                self._evict_device(h)
            return freed

    def _evict_device(self, h: CacheableMatrix):
        from systemml_tpu_torch.runtime import loopfuse

        t = h._device
        if h._host is not None and h._host_version != t._version:
            # written in place since the copy was taken: the copy is stale
            self.host_bytes -= h.nbytes
            h._host = None
            self._count("stale_recopy")
        if h._host is None:
            host = torch.empty(h.shape, dtype=h.dtype,
                               pin_memory=t.device.type == "cuda")
            host.copy_(t)
            h._host = host
            h._host_version = t._version
            self.host_bytes += h.nbytes
        self._by_buffer.pop(id(t), None)
        h._device = None
        self.device_bytes -= h.nbytes
        st = t.untyped_storage()
        n = loopfuse.invalidate_storage(st.data_ptr(), st.nbytes())
        if n:
            self._count("graph_invalidate")
        self._count("evict")
        self._obs_event("pool_evict", h)

    def _spill_to_disk(self, h: CacheableMatrix):
        import numpy as np

        if h._disk_path is None:
            h._disk_path = os.path.join(self.scratch_dir(),
                                        f"m{id(h):x}-{uuid.uuid4().hex[:8]}"
                                        ".npy")
            np.save(h._disk_path, h._host.numpy())
            weakref.finalize(h, _unlink, h._disk_path)
        h._host = None
        self.host_bytes -= h.nbytes
        self._count("disk_spill")
        self._obs_event("pool_spill", h)

    # ---- shutdown -------------------------------------------------------

    def clear(self):
        with self._lock:
            for h in list(self._entries.values()):
                self._drop(h)
            self._by_name.clear()
            if self._scratch and os.path.isdir(self._scratch):
                import shutil

                shutil.rmtree(self._scratch, ignore_errors=True)
                self._scratch = None


class VarMap(dict):
    """Symbol table backed by a BufferPool (reference: LocalVariableMap +
    its CacheableData handles). Stores handles; every read resolves to a
    live tensor, so the rest of the runtime never sees a handle. NOTE:
    `dict(varmap)` copies the raw handles (CPython bypasses the
    overridden items()); the Evaluator's treads resolve for that case."""

    _next_scope = [0]
    _scope_lock = threading.Lock()

    def __init__(self, pool: Optional[BufferPool] = None):
        super().__init__()
        self.pool = pool
        # tensors the API caller bound, by id: never admitted
        self.external = weakref.WeakValueDictionary()
        # pool names are scoped per symbol table: a function's frame may
        # bind its caller's names without aliasing their handles
        with VarMap._scope_lock:
            VarMap._next_scope[0] += 1
            self._scope = f"s{VarMap._next_scope[0]}"

    def _q(self, k) -> str:
        return f"{self._scope}:{k}"

    # ---- writes ---------------------------------------------------------

    def __setitem__(self, k, v):
        if self.pool is not None:
            if isinstance(v, torch.Tensor) and \
                    self.external.get(id(v)) is v:
                with self.pool._lock:
                    self.pool._unname(self._q(k))
            else:
                v = self.pool.admit(self._q(k), v)
        super().__setitem__(k, v)

    def bind_external(self, k, v):
        """A value the API caller holds: bound, never admitted."""
        if isinstance(v, torch.Tensor):
            self.external[id(v)] = v
        self[k] = v

    def update(self, other=(), **kw):
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v
        for k, v in kw.items():
            self[k] = v

    def __delitem__(self, k):
        if self.pool is not None:
            with self.pool._lock:
                self.pool._unname(self._q(k))
        super().__delitem__(k)

    def release(self):
        """Drops this scope's pool references (the rmvar cleanup of a dying
        call frame). Values already resolved by callers stay alive."""
        if self.pool is not None:
            with self.pool._lock:
                for k in list(super().keys()):
                    self.pool._unname(self._q(k))
        super().clear()

    # ---- reads ----------------------------------------------------------

    def __getitem__(self, k):
        return resolve(super().__getitem__(k))

    def get(self, k, default=None):
        if k in self:
            return self[k]
        return default

    def pop(self, k, *default):
        if k in self:
            v = self[k]
            del self[k]
            return v
        if default:
            return default[0]
        raise KeyError(k)

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def copy(self):
        return {k: self[k] for k in self.keys()}
