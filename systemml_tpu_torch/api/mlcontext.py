"""Programmatic script API.

Port of systemml_tpu/api/mlcontext.py (reference: api/mlcontext/
MLContext.java:52, Script/ScriptFactory/MLResults): a session object that
compiles DML source, binds in-memory inputs (numpy arrays, torch
tensors, scalars, frames (runtime.data.FrameObject, host columns, bound
as they are), and sparse matrices: a scipy.sparse matrix, a
runtime.sparse.SparseMatrix or a torch sparse CSR tensor), runs the
compiler and runtime, and returns the requested outputs (a frame as its
FrameObject).

A sparse input below `sparsity_turn_point` binds as a SparseMatrix on the
session's device (a torch CSR tensor on the card stays there: its own
index and value tensors are used); above it, a scipy or torch sparse
input binds dense, as in the JAX package. The bound inputs' sparsity
seeds the compiler's estimates (compile_program's input_sparsity), so
that the quaternary rewrites see a sparse V as sparse: read from the
metadata of a sparse input, counted once per input object for a numpy
array, and not read for a dense tensor (a host read on the card). Each
input is converted once per Script and conversion policy, so that a
re-execution finds the same SparseMatrix with its device mirrors.

The session runs on the device its config names: the card by default
(`DMLConfig.device = "cuda"`); the CPU only when the caller sets
`device="cpu"`. Construction raises when the config asks for the card and
there is none.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from systemml_tpu_torch.compress import CompressedMatrixBlock
from systemml_tpu_torch.lang import ast as A
from systemml_tpu_torch.lang.parser import parse, parse_file, resolve_imports
from systemml_tpu_torch.runtime.data import (ListObject, MatrixObject,
                                             ScalarObject)
from systemml_tpu_torch.runtime.program import compile_program
from systemml_tpu_torch.runtime.sparse import SparseMatrix
from systemml_tpu_torch.utils.config import (DMLConfig, apply_matmul_precision,
                                             get_config, resolve_device,
                                             set_config)


class MLResults:
    """Output accessor (reference: api/mlcontext/MLResults.java)."""

    def __init__(self, vars: Dict[str, Any], outputs: Sequence[str]):
        self._vars = vars
        self._outputs = list(outputs)

    def get(self, name: str):
        if name not in self._vars:
            raise KeyError(f"output {name!r} was not produced by the script")
        return self._vars[name]

    def get_tensor(self, name: str) -> torch.Tensor:
        """A matrix output as the tensor it is, on its device (a sparse
        output as its torch sparse CSR tensor)."""
        v = self.get(name)
        if isinstance(v, SparseMatrix):
            return v.to_csr_tensor()
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"output {name!r} is not a matrix")
        return v

    def get_matrix(self, name: str) -> np.ndarray:
        v = self.get(name)
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, (MatrixObject, CompressedMatrixBlock,
                          SparseMatrix)):
            return v.to_numpy()
        return np.asarray(v)

    def get_scalar(self, name: str):
        v = self.get(name)
        if isinstance(v, torch.Tensor) and v.numel() == 1:
            return v.item()
        return v

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)


class Script:
    """A DML script with bound inputs/outputs (reference:
    api/mlcontext/Script.java)."""

    def __init__(self, source: Optional[str] = None,
                 path: Optional[str] = None, base_dir: Optional[str] = None):
        self.source = source
        self.path = path
        self.base_dir = base_dir
        self._inputs: Dict[str, Any] = {}
        self._args: Dict[str, Any] = {}
        self._outputs: List[str] = []
        self._spmeta_memo: Dict[str, tuple] = {}
        self._unwrap_memo: Dict[str, tuple] = {}

    def input(self, name: str, value: Any) -> "Script":
        if name.startswith("$"):
            self._args[name[1:]] = value
        else:
            # raw until execute: the conversion policy (dtype, device)
            # belongs to the executing MLContext's config
            self._inputs[name] = value
        return self

    def arg(self, name: str, value: Any) -> "Script":
        self._args[name.lstrip("$")] = value
        return self

    def output(self, *names: str) -> "Script":
        self._outputs.extend(names)
        return self

    def parse(self) -> A.DMLProgram:
        if self.path:
            return parse_file(self.path)
        prog = parse(self.source)
        resolve_imports(prog, self.base_dir or ".")
        return prog


def _unwrap_input(v: Any, device: torch.device):
    """A bound input as a runtime value on `device` under the active
    dtype policy. A tensor that already has the device and dtype is used
    as it is: an 8 GB X on the card makes no round trip through the
    host and is not copied."""
    from systemml_tpu_torch.utils.config import default_dtype

    if isinstance(v, MatrixObject):
        v = v.array
    elif isinstance(v, ScalarObject):
        return v.value
    elif isinstance(v, ListObject):
        return v
    turn = get_config().sparsity_turn_point
    if _is_scipy_sparse(v):
        if v.nnz / max(1, v.shape[0] * v.shape[1]) < turn:
            return SparseMatrix.from_scipy(v, device=device,
                                           dtype=default_dtype())
        v = np.asarray(v.todense())   # dense-ish input: the dense path
    if isinstance(v, torch.Tensor) and v.layout != torch.strided:
        csr = v if v.layout == torch.sparse_csr else v.to_sparse_csr()
        if csr.values().numel() / max(1, v.shape[0] * v.shape[1]) < turn:
            v = SparseMatrix.from_csr_tensor(csr)
        else:
            v = csr.to_dense()
    if isinstance(v, SparseMatrix):
        if v.device == device and v.dtype == default_dtype():
            return v
        return SparseMatrix(v.indptr.to(device), v.indices.to(device),
                            v.data.to(device=device, dtype=default_dtype()),
                            v.shape)
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, torch.Tensor):
        if v.is_floating_point():
            v = v.to(device=device, dtype=default_dtype())
        else:
            v = v.to(device=device)
        return v.reshape(-1, 1) if v.ndim == 1 else v
    return v


def _is_scipy_sparse(v) -> bool:
    return type(v).__module__.startswith("scipy.sparse") \
        and hasattr(v, "tocsr")


def _input_sparsity(inputs: Dict[str, Any], memo: Dict[str, tuple]
                    ) -> Dict[str, float]:
    """name -> observed sparsity of each bound matrix input, for the
    compiler's estimates (the JAX package's _input_sparsity_meta): the nnz
    of a sparse input is metadata, a numpy array is counted once per
    object (`memo`), a dense tensor is skipped."""
    meta = {}
    for name, v in inputs.items():
        if isinstance(v, MatrixObject):
            v = v.array
        if isinstance(v, SparseMatrix):
            meta[name] = v.sparsity()
        elif _is_scipy_sparse(v):
            meta[name] = float(v.getnnz()) / max(1, v.shape[0] * v.shape[1])
        elif isinstance(v, torch.Tensor) and v.layout != torch.strided \
                and v.ndim == 2:
            nnz = (v.values().numel() if v.layout == torch.sparse_csr
                   else v._nnz())
            meta[name] = float(nnz) / max(1, v.shape[0] * v.shape[1])
        elif isinstance(v, np.ndarray) and v.ndim == 2 and v.size:
            hit = memo.get(name)
            if hit is not None and hit[0] is v:
                meta[name] = hit[1]
            else:
                meta[name] = float(np.count_nonzero(v)) / v.size
                memo[name] = (v, meta[name])
    return meta


def dml(source: str) -> Script:
    """ScriptFactory.dml analog."""
    return Script(source=source)


def dmlFromFile(path: str) -> Script:
    return Script(path=path)


class MLContext:
    """Session API (reference: MLContext.execute,
    api/mlcontext/MLContext.java:52). Holds the config; each execute()
    runs the full chain parse -> hops -> rewrites -> runtime on the
    config's device."""

    def __init__(self, config: Optional[DMLConfig] = None, *,
                 device: Optional[str] = None):
        self.config = config or DMLConfig()
        if device is not None:
            self.config.device = device
        self.device = resolve_device(self.config)
        # print the statistics / the compiled plan of each execute (also
        # when the config's `stats` / `explain` ask for them)
        self.statistics = False
        self.explain = False
        # where print() output of the script goes
        self.printer = print
        self._stats = None  # Statistics of the last execute()
        # set_trace(path) records every execute() into a fresh recorder
        # and writes it to `path` (obs.export.write: Chrome-trace JSON, or
        # JSON lines for .jsonl); the last recorder stays on last_recorder
        self.trace_file: Optional[str] = None
        self.last_recorder = None

    def set_config_property(self, key: str, value):
        self.config.set(key, value)
        if key in ("device", "sysml.device"):
            self.device = resolve_device(self.config)

    def set_trace(self, path: Optional[str]) -> "MLContext":
        """Trace every execute() to `path` (None: stop tracing)."""
        self.trace_file = path
        return self

    def execute(self, script: Script) -> MLResults:
        from systemml_tpu_torch import obs

        # traced_run installs the recorder (or warns and skips when
        # another trace is active), releases it and writes the file
        with obs.traced_run(self.trace_file) as recorder:
            try:
                return self._execute(script)
            finally:
                if recorder is not None:
                    self.last_recorder = recorder

    def _execute(self, script: Script) -> MLResults:
        from systemml_tpu_torch.obs import trace as obs

        old = get_config()
        set_config(self.config)
        try:
            apply_matmul_precision()
            with obs.span("parse", obs.CAT_COMPILE):
                ast_prog = script.parse()
            with obs.span("compile", obs.CAT_COMPILE):
                prog = compile_program(
                    ast_prog, clargs=script._args,
                    outputs=script._outputs or None,
                    input_names=list(script._inputs),
                    input_sparsity=_input_sparsity(script._inputs,
                                                   script._spmeta_memo))
            explain = self.config.explain if self.config.explain != "none" \
                else ("hops" if self.explain else None)
            if explain:
                from systemml_tpu_torch.utils.explain import explain_program

                print(explain_program(prog, mode=explain))
            # converted once per (input object, policy): a re-execution
            # finds the same SparseMatrix and its device mirrors
            policy = (str(self.device), self.config.floating_point_precision,
                      self.config.sparsity_turn_point)
            inputs = {}
            for k, v in script._inputs.items():
                hit = script._unwrap_memo.get(k)
                if hit is None or hit[0] is not v or hit[1] != policy:
                    hit = (v, policy, _unwrap_input(v, self.device))
                    script._unwrap_memo[k] = hit
                inputs[k] = hit[2]
            ec = prog.execute(inputs=inputs, printer=self.printer)
            self._stats = prog.stats
            if self.statistics or self.config.stats:
                print(prog.stats.display(self.config.stats_max_heavy_hitters))
            return MLResults(ec.vars, script._outputs)
        finally:
            set_config(old)
