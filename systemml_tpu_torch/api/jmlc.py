"""JMLC-style embedded low-latency scoring API.

Port of systemml_tpu/api/jmlc.py (reference: api/jmlc/Connection.java:190
prepareScript compiles once; PreparedScript.executeScript rebinds inputs
per call without recompiling). "Prepared" means the ProgramBlock tree and
its block plans persist across calls: a call whose inputs have the shapes
of an earlier one finds its blocks' plans by key, and on the card runs
each block that already ran under that key as one CUDA graph launch
(runtime/blockcompile.py), so rebinding a batch costs a copy into the
graph's input buffers and a launch.

The connection runs on the device its config names: the card by default,
the CPU only when the caller sets `device="cpu"`; with "cuda" and no card
it raises, as MLContext does. `ensure_xla_cache` of the JAX package has
no counterpart here.

Threads (docs/serving.md, "Thread-safety contract"): one PreparedScript
may be executed from any number of threads at once. The binding context
is request-scoped: the fluent `set_* ... execute_script()` API binds
into a thread-local slot, and `execute(inputs=...)` takes the whole
binding per call. The identity unwrap cache is guarded by a lock and its
entries are immutable; the program's plans and block graphs are guarded
per key (runtime/blockcompile.py); the statistics count under locks and
`run_time` is the union of overlapping runs. api/serving.py serves
concurrent traffic over one PreparedScript on these terms.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from systemml_tpu_torch.api.mlcontext import (MLResults, Script,
                                              _input_sparsity, _unwrap_input)
from systemml_tpu_torch.runtime.program import Program, compile_program
from systemml_tpu_torch.utils.config import (DMLConfig, apply_matmul_precision,
                                             get_config, resolve_device,
                                             set_config)


def SILENT_PRINTER(s: str) -> None:
    """JMLC runs discard print() output (the reference's JMLC mode)."""


def _shares_memory(u, value) -> bool:
    """Is `u` a tensor over `value`'s own memory (a host array unwrapped
    on the CPU without a copy)?"""
    return (isinstance(u, torch.Tensor) and isinstance(value, np.ndarray)
            and u.device.type == "cpu" and u.layout == torch.strided
            and np.shares_memory(u.numpy(), value))


class PreparedScript:
    def __init__(self, program: Program, input_names: Sequence[str],
                 output_names: Sequence[str], config: DMLConfig,
                 input_meta: Optional[Dict[str, Any]] = None):
        self._program = program
        self._input_names = list(input_names)
        self._output_names = list(output_names)
        self._config = config
        self._device = resolve_device(config)
        self.input_meta: Dict[str, Any] = dict(input_meta or {})
        self._tls = threading.local()
        # identity-keyed device copies: rebinding the SAME host array
        # skips its upload; the host array is held weakly, so a per-call
        # batch's device copy dies with it
        self._unwrap_cache: Dict[str, tuple] = {}
        self._cache_lock = threading.RLock()
        # set_trace(path): every execute records into a fresh recorder
        # and writes it to `path`; the last recorder stays on
        # last_recorder (a debugging hook: set it before traffic starts)
        self._trace_path: Optional[str] = None
        self.last_recorder = None

    @property
    def stats(self):
        return self._program.stats

    # ---- request-scoped binding context ---------------------------------

    def _bindings(self) -> Dict[str, Any]:
        b = getattr(self._tls, "bound", None)
        if b is None:
            b = self._tls.bound = {}
        return b

    def set_matrix(self, name: str, value) -> "PreparedScript":
        """Binds an input for this thread's next execute_script. Binding
        the SAME array object again reuses its device copy: pass a new
        array for new data."""
        self._bindings()[name] = self._unwrap_cached(name, value)
        return self

    def _unwrap(self, value):
        """`value` as a runtime value on this script's device, under its
        config, without the identity cache (a per-request value)."""
        old = get_config()
        set_config(self._config)
        try:
            return _unwrap_input(value, self._device)
        finally:
            set_config(old)

    def _unwrap_cached(self, name: str, value):
        with self._cache_lock:
            cached = self._unwrap_cache.get(name)
        if cached is not None and cached[0]() is value:
            return cached[1]
        u = self._unwrap(value)
        if u is value or _shares_memory(u, value):
            # no copy was made, so there is none to reuse; an entry would
            # hold the host array through the tensor over its memory
            return u
        try:
            ref = weakref.ref(value, lambda r: self._evict(name, r))
        except TypeError:
            return u
        with self._cache_lock:
            self._unwrap_cache[name] = (ref, u)
        return u

    def _evict(self, name: str, ref) -> None:
        with self._cache_lock:
            cached = self._unwrap_cache.get(name)
            if cached is not None and cached[0] is ref:
                del self._unwrap_cache[name]

    def set_trace(self, path: Optional[str]) -> "PreparedScript":
        """Trace every execute to `path` (None: stop tracing)."""
        self._trace_path = path
        return self

    def set_scalar(self, name: str, value) -> "PreparedScript":
        self._bindings()[name] = value
        return self

    def set(self, name: str, value) -> "PreparedScript":
        return self.set_matrix(name, value)

    def execute_script(self) -> MLResults:
        """Executes with this thread's fluent bindings; they clear after a
        successful run and stay after a failed one."""
        res = self.execute(self._bindings(), _unwrap=False)
        self._tls.bound = {}
        return res

    def execute(self, inputs: Dict[str, Any],
                _unwrap: bool = True) -> MLResults:
        """Runs with `inputs` as the whole binding of this call."""
        if _unwrap:
            inputs = {n: self._unwrap_cached(n, v)
                      for n, v in inputs.items()}
        missing = [n for n in self._input_names if n not in inputs]
        if missing:
            raise ValueError(f"unbound inputs: {missing}")
        from systemml_tpu_torch import obs

        old = get_config()
        set_config(self._config)
        try:
            with obs.traced_run(self._trace_path) as recorder:
                try:
                    apply_matmul_precision()
                    ec = self._program.execute(
                        inputs=dict(inputs), printer=SILENT_PRINTER,
                        skip_writes=True, block_graphs=True)
                finally:
                    if recorder is not None:
                        self.last_recorder = recorder
        finally:
            set_config(old)
        # the outputs leave as live values, and the run's pool scope is
        # released (reference: JMLC clears the per-execute symbol table)
        out_vars = {n: ec.vars[n] for n in self._output_names
                    if n in ec.vars}
        if hasattr(ec.vars, "release"):
            ec.vars.release()
        return MLResults(out_vars, self._output_names)

    executeScript = execute_script


class Connection:
    """reference: api/jmlc/Connection. `config` (default DMLConfig(),
    device "cuda") is the connection's: every script it prepares compiles
    and runs under it."""

    def __init__(self, config: Optional[DMLConfig] = None, *,
                 device: Optional[str] = None):
        self.config = config or DMLConfig()
        if device is not None:
            self.config.device = device
        resolve_device(self.config)

    def prepare_script(self, source: str, input_names: Sequence[str] = (),
                       output_names: Sequence[str] = (),
                       args: Optional[Dict[str, Any]] = None,
                       base_dir: Optional[str] = None,
                       input_meta: Optional[Dict[str, Any]] = None
                       ) -> PreparedScript:
        """input_meta: per-input metadata, name -> {"shape": ...,
        "sparsity": ...}, a bare sparsity, or an example value; the
        sparsity seeds the compiler's estimates."""
        s = Script(source=source, base_dir=base_dir)
        sps: Dict[str, float] = {}
        examples = {}
        for name, m in (input_meta or {}).items():
            if isinstance(m, dict):
                if m.get("sparsity") is not None:
                    sps[name] = float(m["sparsity"])
            elif isinstance(m, (int, float)) and not isinstance(m, bool):
                sps[name] = float(m)
            elif m is not None:
                examples[name] = m
        if examples:
            sps.update(_input_sparsity(examples, {}))
        old = get_config()
        set_config(self.config)
        try:
            prog = compile_program(s.parse(), clargs=args or {},
                                   outputs=output_names or None,
                                   input_names=input_names or (),
                                   input_sparsity=sps or None)
        finally:
            set_config(old)
        return PreparedScript(prog, input_names, output_names, self.config,
                              input_meta=input_meta)

    prepareScript = prepare_script

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
