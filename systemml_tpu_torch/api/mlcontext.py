"""Programmatic script API.

Port of systemml_tpu/api/mlcontext.py (reference: api/mlcontext/
MLContext.java:52, Script/ScriptFactory/MLResults): a session object that
compiles DML source, binds in-memory inputs (numpy arrays, torch
tensors, scalars), runs the compiler and runtime, and returns the
requested outputs.

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
        """A matrix output as the tensor it is, on its device."""
        v = self.get(name)
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"output {name!r} is not a matrix")
        return v

    def get_matrix(self, name: str) -> np.ndarray:
        v = self.get(name)
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, (MatrixObject, CompressedMatrixBlock)):
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
    if type(v).__module__.startswith("scipy.sparse"):
        raise NotImplementedError(
            "sparse inputs wait for ROADMAP queue 1, sparse plane")
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, torch.Tensor):
        if v.layout != torch.strided:
            raise NotImplementedError(
                "sparse tensors wait for ROADMAP queue 1, sparse plane")
        if v.is_floating_point():
            v = v.to(device=device, dtype=default_dtype())
        else:
            v = v.to(device=device)
        return v.reshape(-1, 1) if v.ndim == 1 else v
    return v


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
        self.statistics = False
        # where print() output of the script goes
        self.printer = print
        self._stats = None  # Statistics of the last execute()

    def set_config_property(self, key: str, value):
        self.config.set(key, value)
        if key in ("device", "sysml.device"):
            self.device = resolve_device(self.config)

    def execute(self, script: Script) -> MLResults:
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
                    input_names=list(script._inputs))
            inputs = {k: _unwrap_input(v, self.device)
                      for k, v in script._inputs.items()}
            ec = prog.execute(inputs=inputs, printer=self.printer)
            self._stats = prog.stats
            if self.statistics:
                print(prog.stats.display(self.config.stats_max_heavy_hitters))
            return MLResults(ec.vars, script._outputs)
        finally:
            set_config(old)
