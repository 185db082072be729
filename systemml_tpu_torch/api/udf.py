"""Python UDF registration.

Port of systemml_tpu/api/udf.py: a UDF is called with the runtime's
values (torch tensors on the configured device, host numbers) and
returns such values. It runs on the host wherever it is called; a loop
that calls one is refused as a region (an external function is impure).

TPU-native equivalent of the reference's external-function framework
(udf/PackageFunction.java + ExternalFunctionProgramBlock + the shipped
udf/lib): where the reference loads Java classes named in an
`externalFunction` declaration, here the host language IS Python, so a
UDF is just a registered callable:

    from systemml_tpu_torch.api.udf import register_udf
    register_udf("myscale", lambda X, k: X * k)
    # DML:  Y = myscale(X, 2.5)

Multi-output UDFs return a tuple and register with n_outputs:

    register_udf("splitq", lambda X: (X[:10], X[10:]), n_outputs=2)
    # DML:  [A, B] = splitq(X)

Resolution order: user DML functions bind at compile time, builtins
next, then UDFs — a UDF can never shadow either. DML
`externalFunction` declarations also dispatch here by name
(`call_external`).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

_lock = threading.Lock()
_REGISTRY: Dict[str, Tuple[Callable, int]] = {}


def register_udf(name: str, fn: Callable, n_outputs: int = 1) -> None:
    if not callable(fn):
        raise TypeError("UDF must be callable")
    with _lock:
        _REGISTRY[name] = (fn, int(n_outputs))


def unregister_udf(name: str) -> None:
    with _lock:
        _REGISTRY.pop(name, None)


def lookup_udf(name: str) -> Optional[Tuple[Callable, int]]:
    with _lock:
        return _REGISTRY.get(name)


def call_udf(name: str, pos, named,
             entry: Optional[Tuple[Callable, int]] = None):
    """Invoke a UDF with evaluated values, validating declared arity.
    Pass the `entry` from a prior lookup_udf to avoid a second registry
    access (and the unregister race between them)."""
    if entry is None:
        entry = lookup_udf(name)
    if entry is None:
        raise KeyError(f"no Python UDF registered as {name!r}")
    fn, n_outputs = entry
    out = fn(*pos, **named)
    if n_outputs > 1:
        if not isinstance(out, (tuple, list)) or len(out) != n_outputs:
            got = len(out) if isinstance(out, (tuple, list)) else 1
            raise ValueError(
                f"UDF {name!r} registered with n_outputs={n_outputs} "
                f"but returned {got} value(s)")
        return tuple(out)
    return out


def call_external(fd, bound: Dict[str, object], n_outputs: int = 1):
    """An `externalFunction` declaration's call: the UDF registered under
    its name, called positionally in the DECLARED order of its inputs
    (`bound`: name -> value, defaults filled), its outputs checked
    against the declaration (systemml_tpu/runtime/program.py:936-960)."""
    from systemml_tpu_torch.hops.builder import DMLValidationError
    from systemml_tpu_torch.runtime.program import DMLRuntimeError

    name = fd.name
    entry = lookup_udf(name)
    if entry is None:
        raise DMLValidationError(
            f"external function {name!r}: no Python UDF registered under "
            f"that name (systemml_tpu_torch.api.udf.register_udf)")
    out = call_udf(name, [bound[p.name] for p in fd.inputs], {}, entry)
    n_declared = len(fd.outputs)
    if n_declared > 1 and (not isinstance(out, tuple)
                           or len(out) != n_declared):
        raise DMLRuntimeError(
            f"external function {name!r} declares {n_declared} outputs "
            f"but the UDF returned "
            f"{len(out) if isinstance(out, tuple) else 1}")
    return out
