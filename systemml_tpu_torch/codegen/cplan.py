# Port of systemml_tpu/codegen/cplan.py: CNode, CELL_BINARY and CELL_UNARY
# are copied. `emit` becomes the plain torch evaluator of a plan, and
# `emit_cuda` and `hoist` (new) write a plan as the C++ of a functor for
# the hand-written spoof kernels (csrc/spoof.cuh).
"""CPlan IR: the fused-operator expression tree.

Equivalent of the reference's CNode IR (hops/codegen/cplan/CNode.java,
CNodeBinary/Unary/Data/... and the CNodeCell/Row templates). The
reference generates Java source compiled by janino; here a plan is
evaluated by torch ops (`emit`, the plain version) or written as the
expression of a CUDA functor (`emit_cuda`) that the kernel skeletons of
csrc/spoof.cuh are instantiated with.

Both keep the JAX package's `cplan.emit` semantics: round is
floor(v + 0.5), a comparison gives 1/0 in the operand's dtype, sprop is
v * (1 - v), sigmoid is the logistic function, and min and max propagate
NaN (jnp.minimum/jnp.maximum).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclass
class CNode:
    op: str                       # 'in' | 'lit' | 'b(+)' ... | 'u(exp)' ...
    inputs: List["CNode"] = field(default_factory=list)
    # literal value (op == 'lit'); for 'b(*)', the position of its mask
    # operand (hops.hop.mask_operand), or None for the IEEE product
    value: Any = None
    name: Optional[str] = None    # input name (op == 'in')

    def key(self) -> Tuple:
        """Structural key for the plan cache (reference: SpoofCompiler plan
        cache keyed on CPlan equivalence, hops/codegen/SpoofCompiler.java:162)."""
        return (self.op, self.name, self.value,
                tuple(c.key() for c in self.inputs))

    def input_names(self, acc=None) -> List[str]:
        acc = acc if acc is not None else []
        if self.op == "in" and self.name not in acc:
            acc.append(self.name)
        for c in self.inputs:
            c.input_names(acc)
        return acc

    def pretty(self) -> str:
        if self.op == "in":
            return self.name
        if self.op == "lit":
            return repr(self.value)
        return f"{self.op}({', '.join(c.pretty() for c in self.inputs)})"


def _tensor_like(x, like):
    """A Python number as a 0-d tensor of `like`'s dtype and device."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(like, torch.Tensor):
        return torch.full((), x, dtype=like.dtype, device=like.device)
    return torch.tensor(x, dtype=torch.float64)


def _cmp(fn):
    def f(a, b):
        like = a if isinstance(a, torch.Tensor) else b
        a, b = _tensor_like(a, like), _tensor_like(b, like)
        return fn(a, b).to(torch.result_type(a, b))
    return f


def _minmax(fn):
    def f(a, b):
        like = a if isinstance(a, torch.Tensor) else b
        return fn(_tensor_like(a, like), _tensor_like(b, like))
    return f


def _mask_mul(m, x):
    """x where the mask m is set, +0 elsewhere (op_mask_mul)."""
    like = m if isinstance(m, torch.Tensor) else x
    m, x = _tensor_like(m, like), _tensor_like(x, like)
    dt = torch.result_type(m, x)
    return torch.where(m != 0, x.to(dt), torch.zeros((), dtype=dt,
                                                     device=x.device))


_BINARY = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "^": lambda a, b: a ** b, "min": _minmax(torch.minimum),
    "max": _minmax(torch.maximum),
    "==": _cmp(torch.eq), "!=": _cmp(torch.ne), "<": _cmp(torch.lt),
    "<=": _cmp(torch.le), ">": _cmp(torch.gt), ">=": _cmp(torch.ge),
}

_UNARY = {
    "-": torch.neg, "abs": torch.abs, "exp": torch.exp, "log": torch.log,
    "sqrt": torch.sqrt, "sin": torch.sin,
    # torch.sign(NaN) is 0; jnp.sign(NaN) is NaN
    "sign": lambda v: torch.where(torch.isnan(v), v, torch.sign(v)),
    "cos": torch.cos, "tan": torch.tan, "tanh": torch.tanh,
    "sigmoid": torch.sigmoid, "floor": torch.floor, "ceil": torch.ceil,
    "ceiling": torch.ceil,
    "round": lambda v: torch.floor(v + 0.5),
    "sprop": lambda v: v * (1.0 - v),
}


def emit(node: CNode, env: Dict[str, Any]):
    """Evaluate a CPlan with torch ops against an environment of tensors
    and Python numbers: the plain version of the spoof kernels."""
    if node.op == "in":
        return env[node.name]
    if node.op == "lit":
        return node.value
    xs = [emit(c, env) for c in node.inputs]
    o = node.op
    if o.startswith("b("):
        a, b = xs
        fn = _BINARY[o[2:-1]]
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = _tensor_like(a, None)
        if o == "b(*)" and node.value is not None:
            return _mask_mul(*((a, b) if node.value == 0 else (b, a)))
        return fn(a, b)
    if o.startswith("u("):
        (x,) = xs
        return _UNARY[o[2:-1]](_tensor_like(x, None))
    raise ValueError(f"cplan cannot emit op {o!r}")


# --------------------------------------------------------------------------
# CUDA expression
# --------------------------------------------------------------------------

# op -> the device function of csrc/spoof.cuh that computes it
CUDA_BINARY = {
    "b(+)": "op_add", "b(-)": "op_sub", "b(*)": "op_mul", "b(/)": "op_div",
    "b(^)": "op_pow", "b(min)": "op_min", "b(max)": "op_max",
    "b(==)": "op_eq", "b(!=)": "op_ne", "b(<)": "op_lt", "b(<=)": "op_le",
    "b(>)": "op_gt", "b(>=)": "op_ge",
}
CUDA_UNARY = {
    "u(-)": "op_neg", "u(abs)": "op_abs", "u(exp)": "op_exp",
    "u(log)": "op_log", "u(sqrt)": "op_sqrt", "u(sign)": "op_sign",
    "u(sin)": "op_sin", "u(cos)": "op_cos", "u(tan)": "op_tan",
    "u(tanh)": "op_tanh", "u(sigmoid)": "op_sigmoid",
    "u(floor)": "op_floor", "u(ceil)": "op_ceil", "u(ceiling)": "op_ceil",
    "u(round)": "op_round", "u(sprop)": "op_sprop",
}


def _cuda_literal(v) -> str:
    f = float(v)
    if f != f:
        return "T(CUDART_NAN)"
    if f in (float("inf"), float("-inf")):
        return "T(CUDART_INF)" if f > 0 else "T(-CUDART_INF)"
    # repr round-trips: the C++ double literal is the same double
    return f"T({f!r})"


# the input names that `hoist` gives its scalar-only subtrees
HOIST_PREFIX = "_h"


def hoist(plan: CNode, scalars) -> Tuple[CNode, List[CNode]]:
    """Split off every maximal subtree of `plan` whose leaves are all in
    `scalars` (and which has one leaf at least: a subtree of literals
    stays), for the CUDA functor to compute once per thread before its
    walk. Returns the plan with each such subtree replaced by an input
    named `_h<k>`, and the subtrees by k; equal subtrees share one k. The
    operations are unchanged, so evaluating the subtrees first and the
    plan on their values gives the plan's value bit for bit."""
    scalars = frozenset(scalars)
    if any(nm.startswith(HOIST_PREFIX) for nm in plan.input_names()):
        raise ValueError(f"a plan input is named {HOIST_PREFIX}*: "
                         f"{plan.input_names()}")
    subs: List[CNode] = []
    index: Dict[Tuple, int] = {}

    # id(node) -> (every leaf of it is a scalar, it has a leaf)
    info: Dict[int, Tuple[bool, bool]] = {}

    def classify(n: CNode) -> Tuple[bool, bool]:
        if n.op == "in":
            out = (n.name in scalars, True)
        else:
            kids = [classify(c) for c in n.inputs]
            out = (all(k[0] for k in kids), any(k[1] for k in kids))
        info[id(n)] = out
        return out

    def rec(n: CNode) -> CNode:
        if n.op == "lit":
            return n
        only, has_leaf = info[id(n)]
        if only and has_leaf:
            k = index.setdefault(n.key(), len(subs))
            if k == len(subs):
                subs.append(n)
            return CNode("in", name=f"{HOIST_PREFIX}{k}")
        if n.op == "in":
            return n
        return CNode(n.op, [rec(c) for c in n.inputs], value=n.value,
                     name=n.name)

    classify(plan)
    return rec(plan), subs


def emit_cuda(plan: CNode, names: Optional[List[str]] = None) -> str:
    """The plan as one C++ expression of type T over the leaf reads
    `LEAF(i)`, i the leaf's position in `names` (by default
    `plan.input_names()`), and the hoisted values `HOISTED(k)` (the
    inputs `_h<k>` that `hoist` made), for the functor of csrc/spoof.cuh.
    Every op is a device function of that header, so each operand is
    evaluated once; `b(^)` with a literal 2 is `op_sq` (v * v, what XLA
    lowers it to), and a `b(*)` by a mask is `op_mask_mul`."""
    names = plan.input_names() if names is None else names

    def rec(n: CNode) -> str:
        if n.op == "in":
            if n.name not in names and n.name.startswith(HOIST_PREFIX):
                return f"HOISTED({int(n.name[len(HOIST_PREFIX):])})"
            return f"LEAF({names.index(n.name)})"
        if n.op == "lit":
            return _cuda_literal(n.value)
        args = [rec(c) for c in n.inputs]
        if n.op == "b(^)" and n.inputs[1].op == "lit" \
                and float(n.inputs[1].value) == 2.0:
            return f"op_sq({args[0]})"
        if n.op == "b(*)" and n.value is not None:
            m = int(n.value)
            return f"op_mask_mul({args[m]}, {args[1 - m]})"
        if n.op in CUDA_BINARY:
            return f"{CUDA_BINARY[n.op]}({args[0]}, {args[1]})"
        if n.op in CUDA_UNARY:
            return f"{CUDA_UNARY[n.op]}({args[0]})"
        raise ValueError(f"cplan cannot emit op {n.op!r} for CUDA")

    return rec(plan)


# ops a Cell template may absorb (reference: TemplateCell.isValidOperation)
CELL_BINARY = {"b(+)", "b(-)", "b(*)", "b(/)", "b(^)", "b(min)", "b(max)",
               "b(==)", "b(!=)", "b(<)", "b(<=)", "b(>)", "b(>=)"}
CELL_UNARY = {"u(-)", "u(abs)", "u(exp)", "u(log)", "u(sqrt)", "u(sign)",
              "u(sin)", "u(cos)", "u(tan)", "u(tanh)", "u(sigmoid)",
              "u(floor)", "u(ceil)", "u(ceiling)", "u(round)", "u(sprop)"}
