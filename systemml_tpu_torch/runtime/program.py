"""Runtime program: ProgramBlock tree + interpreter.

Port of systemml_tpu/runtime/program.py, the eager subset: control flow
and function calls run on the host; each basic block is evaluated op by
op (compiler/lower.py Evaluator), every op a torch call on the
configured device. `compile_program` keeps the JAX package's validate,
HOP build, superblock merge, hoist, liveness, IPA size propagation and
dynamic-rewrite stages.

At optlevel >= 3 the spoof fusion pass (codegen/compiler.py) runs per
basic block after the dynamic rewrites, and on loop and if predicates;
on the card the program's fused plans are then built into kernels
(codegen/build.py) before it runs.

Automatic compression (compress/rewrite.py) runs as in the JAX package:
unless cla is "false", compile_program marks each loop's loop-invariant
matmult inputs, and at While/For entry a marked matrix is compressed when
its estimated ratio clears cla_min_ratio (cla "auto"), or always (cla
"true"); the loop then runs the compressed ops (compress/device.py). A
failure there raises: the loop does not run dense unseen.

Fused loop regions run as in the JAX package: with `codegen_enabled`
(the default) compile_program plans every while/for nest last
(compiler/lower.plan_loop_regions), and WhileBlock and ForBlock hand each
loop to the region executor (runtime/loopfuse.py), which on the card
captures the nest into one CUDA graph with the predicates kept on the
device (conditional WHILE and IF nodes) and launches it once per loop
entry; on the CPU it runs the same state handling in Python. A region
refused, by the plan or by a classified reason at entry, runs eagerly
with the same kernels, counted. Without `codegen_enabled` every loop runs
eagerly, as in the JAX package.

A basic block that reads a sparse value (runtime/sparse.py) runs
eagerly, counted: the JAX package demotes such values out of its
whole-block compile (systemml_tpu/runtime/program.py:162-185); inside a
loop region a loop-invariant SparseMatrix is read through its device
view (runtime/loopfuse.py).

Every basic block outside a loop region runs through the whole-block
compile (runtime/blockcompile.py): a plan per key of the values it reads,
its spoof plans selected with the run-time dims, and on the card one
CUDA graph per key that runs again. The symbol table is a VarMap over the
program's buffer pool (runtime/bufferpool.py).

A parfor runs through runtime/parfor.py: its dependency check, its
cost-based plan, worker threads each on a CUDA stream of its own, and the
result merge on the device. Its body compiles with no constant
substitution, and liveness, hoisting and the block compile treat a
ParForBlock as the ForBlock it subclasses.

What waits: the exec-type planner and MESH mode, the
rest of the lifetime analysis, and remote parfor. A config that asks for
one of them outright (exec_mode MESH), or sets any other field the port
does not read (utils/config.check_ported), raises NotImplementedError.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from systemml_tpu_torch.hops.builder import (BlockHops, DMLValidationError,
                                             HopBuilder)
from systemml_tpu_torch.hops.hop import Hop
from systemml_tpu_torch.lang import ast as A
from systemml_tpu_torch.utils.config import check_ported, get_config


class DMLRuntimeError(Exception):
    pass


# --------------------------------------------------------------------------
# Program blocks
# --------------------------------------------------------------------------

class ProgramBlock:
    def execute(self, ec: "ExecutionContext"):
        raise NotImplementedError


class BasicBlock(ProgramBlock):
    """Straight-line statements compiled to one HOP DAG."""

    def __init__(self, hops: BlockHops, program: "Program",
                 file_id: int = 0):
        self.hops = hops
        # weakly: the Program holds its blocks, and a dropped Program
        # frees them, and its loop regions' CUDA graphs, without waiting
        # for the cyclic collector
        self._program = weakref.ref(program)
        self.file_id = file_id  # namespace scope for fcall resolution
        # names whose LAST use is this block (set by compiler/liveness.py);
        # deleted after execution, the rmvar analog
        self.kill_after: Set[str] = set()
        # the whole-block compile (runtime/blockcompile.py): the block's
        # analysis and its plans by key
        self._analysis = None
        self._plans: Dict[tuple, Any] = {}
        # at the top level of the main program (in no loop, no function):
        # the block compile re-selects its fused plans with run-time dims
        self.top_level = False

    @property
    def program(self) -> "Program":
        return self._program()

    def analysis(self):
        if self._analysis is None:
            from systemml_tpu_torch.compiler.lower import analyze_block

            def fcall_ok(h) -> bool:
                return self.program.fn_is_pure(self.file_id,
                                               h.params.get("namespace"),
                                               h.params.get("name"))

            self._analysis = analyze_block(self.hops, fcall_ok=fcall_ok)
        return self._analysis

    def label(self) -> str:
        """The block's name in traces and profiles: its first writes, as
        the JAX package's fused[...] label."""
        lbl = getattr(self, "_label", None)
        if lbl is None:
            ws = list(self.hops.writes)
            more = "" if len(ws) <= 3 else ",..."
            lbl = self._label = f"fused[{','.join(ws[:3])}{more}]"
        return lbl

    def execute(self, ec: "ExecutionContext"):
        from systemml_tpu_torch.compiler.lower import (Evaluator,
                                                       current_region)
        from systemml_tpu_torch.obs import trace as obs
        from systemml_tpu_torch.runtime import blockcompile
        from systemml_tpu_torch.runtime.bufferpool import pin_reads

        hops = self.hops
        run = current_region()
        if run is not None and run.skip and run.skip & set(hops.writes):
            # a loop region drops its dead string accumulators
            hops = copy.copy(hops)
            hops.writes = {n: h for n, h in self.hops.writes.items()
                           if n not in run.skip}
        with pin_reads(ec.vars, hops.reads):
            reason = None
            if run is None:
                # outside a loop region: the whole-block compile, as the
                # JAX package's fused block path
                reason = blockcompile.eager_reason(self, ec)
                if reason is None:
                    blockcompile.execute(self, ec)
                    ec.stats.count_block(fused=True)
            if reason is not None or run is not None:
                # a block inside a graph capture is recorded, not run: its
                # host time is the capture's (a recompile span)
                with (obs.span("block", obs.CAT_RUNTIME, mode="eager")
                      if run is None or run.mode != "capture"
                      else contextlib.nullcontext()):
                    ev = Evaluator(ec.vars, ec.call_function, ec.printer,
                                   stats=ec.stats, timing=True,
                                   skip_writes=ec.skip_writes)
                    ec.vars.update(ev.run(hops))
                ec.stats.count_block(reason=reason)
        for n in self.kill_after:
            ec.vars.pop(n, None)


def _host_value(v):
    """A one-element tensor as a host scalar: control flow needs a value,
    so this is where a device predicate synchronises."""
    if isinstance(v, torch.Tensor) and v.numel() == 1:
        from systemml_tpu_torch.obs import profile as prof
        from systemml_tpu_torch.obs import trace as obs

        if obs.recording():
            # a host evaluation of a device predicate (dispatch_stats'
            # host_pred_syncs): what a loop region saves per iteration
            obs.instant("pred_host_sync", obs.CAT_RUNTIME)
        return prof.host_read(v, "pred")
    return v


class CompiledPredicate:
    """A predicate or loop bound: a rewritten HOP DAG evaluated to a host
    value. Predicates over host scalars (loop counters, $-args) are
    evaluated on the host without touching the device
    (lower.host_eval_scalar); the rest run as a block and synchronise
    once for the value."""

    _PRED = "__pred__"

    def __init__(self, hop: Hop, reads: Set[str], program: "Program"):
        blk = BlockHops()
        blk.writes = {self._PRED: hop}
        blk.reads = set(reads)
        self.block = BasicBlock(blk, program)

    def eval(self, ec: "ExecutionContext"):
        return _host_value(self.eval_device(ec))

    def eval_bool(self, ec) -> bool:
        return bool(self.eval(ec))

    def eval_device(self, ec):
        """The value without a host read (a loop region's predicate): a
        host value when the predicate reads host values only (no device
        data), else a 0-d tensor."""
        from systemml_tpu_torch.compiler.lower import (Evaluator,
                                                       _NotHostEvaluable,
                                                       host_eval_scalar)

        hop = self.block.hops.writes[self._PRED]
        try:
            return host_eval_scalar(hop, ec.vars)
        except _NotHostEvaluable:
            pass
        ev = Evaluator(ec.vars, ec.call_function, ec.printer,
                       stats=ec.stats, timing=True)
        v = ev.eval(hop)
        if isinstance(v, torch.Tensor) and v.numel() == 1:
            return v.reshape(())
        return v


class IfBlock(ProgramBlock):
    def __init__(self, pred: CompiledPredicate,
                 if_body: List[ProgramBlock], else_body: List[ProgramBlock]):
        self.pred = pred
        self.if_body = if_body
        self.else_body = else_body

    def execute(self, ec):
        from systemml_tpu_torch.compiler.lower import current_region

        run = current_region()
        if run is None:
            taken = self.pred.eval_bool(ec)
        else:
            # inside a loop region: a device predicate becomes IF nodes; a
            # host one (loop invariants only) picks its branch here
            taken = self.pred.eval_device(ec)
            if isinstance(taken, torch.Tensor):
                from systemml_tpu_torch.runtime.loopfuse import exec_if

                exec_if(self, ec, run, taken)
                return
        for b in (self.if_body if taken else self.else_body):
            b.execute(ec)


class WhileBlock(ProgramBlock):
    def __init__(self, pred: CompiledPredicate, body: List[ProgramBlock]):
        self.pred = pred
        self.body = body
        self._fused_loop = None

    def execute(self, ec):
        from systemml_tpu_torch.compiler.lower import current_region

        run = current_region()
        if run is not None:
            # nested in a running region: a WHILE node of its graph
            from systemml_tpu_torch.runtime.loopfuse import exec_while

            exec_while(self, ec, run)
            return
        _maybe_auto_compress(self, ec)
        # the whole loop as one CUDA graph launch (runtime/loopfuse.py),
        # as systemml_tpu/runtime/program.py:717-731 hands it to FusedLoop
        if get_config().codegen_enabled:
            if self._fused_loop is None:
                from systemml_tpu_torch.runtime.loopfuse import FusedLoop

                self._fused_loop = FusedLoop(self, "while")
            if self._fused_loop.run_while(self, ec):
                return
        while self.pred.eval_bool(ec):
            for b in self.body:
                b.execute(ec)


def _maybe_auto_compress(loop, ec):
    """Loop-entry compressed reblock (reference: the injected compression
    op of RewriteCompressedReblock executing before the loop)."""
    if getattr(loop, "cla_candidates", None):
        from systemml_tpu_torch.compress.rewrite import apply_auto_compression

        apply_auto_compression(ec, loop)


class ForBlock(ProgramBlock):
    def __init__(self, var: str, from_h: "CompiledPredicate",
                 to_h: "CompiledPredicate", incr_h: Optional["CompiledPredicate"],
                 body: List[ProgramBlock]):
        self.var = var
        self.from_h, self.to_h, self.incr_h = from_h, to_h, incr_h
        self.body = body
        self._fused_loop = None

    def _range(self, ec):
        fv = self.from_h.eval(ec)
        tv = self.to_h.eval(ec)
        iv = self.incr_h.eval(ec) if self.incr_h is not None else None
        if iv is None:
            iv = 1 if tv >= fv else -1
        if float(iv) == int(iv) and float(fv) == int(fv) and float(tv) == int(tv):
            fv, tv, iv = int(fv), int(tv), int(iv)
            return range(fv, tv + (1 if iv > 0 else -1), iv)
        # fractional increments
        out, v = [], fv
        while (iv > 0 and v <= tv) or (iv < 0 and v >= tv):
            out.append(v)
            v += iv
        return out

    def execute(self, ec):
        from systemml_tpu_torch.compiler.lower import current_region

        run = current_region()
        if run is not None:
            from systemml_tpu_torch.runtime.loopfuse import exec_for

            exec_for(self, ec, run)
            return
        _maybe_auto_compress(self, ec)
        if get_config().codegen_enabled:
            if self._fused_loop is None:
                from systemml_tpu_torch.runtime.loopfuse import FusedLoop

                self._fused_loop = FusedLoop(self, "for")
            if self._fused_loop.run_for(self, ec):
                return
        for i in self._range(ec):
            ec.vars[self.var] = i
            for b in self.body:
                b.execute(ec)


class ParForBlock(ForBlock):
    """Task-parallel loop. Execution strategy lives in runtime/parfor.py
    (reference: ParForProgramBlock.java:572 + parfor/ package)."""

    def __init__(self, var, from_h, to_h, incr_h, body,
                 params: Dict[str, Hop],
                 dep_check_result: Optional[str] = None):
        super().__init__(var, from_h, to_h, incr_h, body)
        self.params = params
        self.dep_check_result = dep_check_result
        self.body_stmts: Optional[List[A.Stmt]] = None  # set by compiler
        self.last_plan = None   # the last run's plan (-explain runtime)

    def execute(self, ec):
        from systemml_tpu_torch.runtime.parfor import execute_parfor

        execute_parfor(self, ec)


class FunctionBlocks:
    def __init__(self, fn_def: A.FunctionDef, blocks: List[ProgramBlock],
                 file_id: int):
        self.fn_def = fn_def
        self.blocks = blocks
        self.file_id = file_id


# --------------------------------------------------------------------------
# Execution context
# --------------------------------------------------------------------------

class ExecutionContext:
    """Symbol table + services handle (reference: ExecutionContext.java:59,
    LocalVariableMap.java:39)."""

    def __init__(self, program: "Program", stats=None,
                 printer: Optional[Callable[[str], None]] = None,
                 file_id: int = 0):
        from systemml_tpu_torch.runtime.bufferpool import VarMap

        self.program = program
        # the symbol table, backed by the program's buffer pool
        # (runtime/bufferpool.py) when bufferpool_enabled
        self.vars: Dict[str, Any] = VarMap(
            program.pool if get_config().bufferpool_enabled else None)
        self.stats = stats if stats is not None else program.stats
        self.printer = printer or (lambda s: print(s))
        self.file_id = file_id  # namespace scope for unqualified fcalls
        # JMLC in-memory mode: write() is a no-op (api/jmlc.py)
        self.skip_writes = False
        # JMLC re-execution: blocks seen before run as CUDA graphs
        # (runtime/blockcompile.py)
        self.block_graphs = False

    def child(self, file_id: Optional[int] = None) -> "ExecutionContext":
        from systemml_tpu_torch.runtime.bufferpool import VarMap

        c = ExecutionContext(self.program, self.stats, self.printer,
                             self.file_id if file_id is None else file_id)
        c.skip_writes = self.skip_writes
        c.block_graphs = self.block_graphs
        if not isinstance(self.vars, VarMap):
            # a parfor worker's frames stay plain dicts, as its own
            # environment: the pool is the caller's (runtime/parfor.py)
            c.vars = {}
        return c

    def eval_scalar(self, h: Hop):
        """A hop (a parfor parameter) evaluated to a host value."""
        from systemml_tpu_torch.compiler.lower import Evaluator, _scalar

        v = Evaluator(self.vars, self.call_function, self.printer).eval(h)
        return _scalar(v) if isinstance(v, torch.Tensor) else v

    # ---- function calls --------------------------------------------------

    @staticmethod
    def _bind_args(fd: A.FunctionDef, name: str, args, argnames
                   ) -> Dict[str, Any]:
        """Bind call args against a declared signature: positional first,
        then named, then defaults (reference: FunctionCallCPInstruction
        argument binding)."""
        bound: Dict[str, Any] = {}
        argnames = argnames or [None] * len(args)
        pos_i = 0
        input_names = [p.name for p in fd.inputs]
        for pname, v in zip(argnames, args):
            if pname is None:
                if pos_i >= len(input_names):
                    raise DMLValidationError(
                        f"too many arguments for function {name!r}")
                bound[input_names[pos_i]] = v
                pos_i += 1
            else:
                if pname not in input_names:
                    raise DMLValidationError(
                        f"unknown parameter {pname!r} for function {name!r}")
                bound[pname] = v
        for p in fd.inputs:
            if p.name not in bound:
                if p.default is None:
                    raise DMLValidationError(
                        f"missing argument {p.name!r} for function {name!r}")
                bound[p.name] = _literal_of(p.default)
        return bound

    def call_function(self, namespace: Optional[str], name: str,
                      args: Sequence[Any], argnames=None, n_outputs: int = 1):
        fb = self.program.resolve_function(self.file_id, namespace, name)
        if fb is None:
            where = f"{namespace}::{name}" if namespace else name
            raise DMLValidationError(f"undefined function {where!r}")
        fd = fb.fn_def
        if fd.external:
            # a Python UDF (api/udf.py)
            from systemml_tpu_torch.api.udf import call_external

            self.stats.count_fcall(name)
            return call_external(fd, self._bind_args(fd, name, args,
                                                     argnames), n_outputs)
        self.stats.count_fcall(name)
        fec = self.child(file_id=fb.file_id)
        fec.vars.update(self._bind_args(fd, name, args, argnames))
        for b in fb.blocks:
            b.execute(fec)
        outs = []
        for o in fd.outputs:
            if o.name not in fec.vars:
                raise DMLRuntimeError(
                    f"function {name!r} did not assign output {o.name!r}")
            outs.append(fec.vars[o.name])
        # the frame's pool references go with it (the rmvar cleanup of
        # FunctionCallCPInstruction); the outputs are live tensors
        release = getattr(fec.vars, "release", None)
        if release is not None:
            release()
        if len(outs) == 1 and n_outputs == 1:
            return outs[0]
        return tuple(outs)


def _constant_branch(pred: "CompiledPredicate"):
    """True/False when the (rewritten) predicate hop is a literal, else
    None (branch must stay at runtime)."""
    h = pred.block.hops.writes[CompiledPredicate._PRED]
    if h.op == "lit" and isinstance(h.value, (bool, int, float)):
        return bool(h.value)
    return None


def _literal_of(e: A.Expr):
    if isinstance(e, (A.IntLiteral, A.FloatLiteral, A.StringLiteral, A.BoolLiteral)):
        return e.value
    if isinstance(e, A.UnaryOp) and e.op == "-":
        return -_literal_of(e.operand)
    raise DMLValidationError("function default values must be literals")


def _assigned_names(stmts) -> Set[str]:
    """All names any statement in `stmts` may assign (nested control flow
    included), used to invalidate the compile-time constant table at
    joins and loop back edges."""
    out: Set[str] = set()
    for s in stmts:
        if isinstance(s, (A.Assignment, A.IfdefAssignment)):
            t = s.target
            if isinstance(t, A.Identifier):
                out.add(t.name)
            elif isinstance(t, A.Indexed) and isinstance(t.target,
                                                         A.Identifier):
                out.add(t.target.name)
        elif isinstance(s, A.MultiAssignment):
            for t in s.targets:
                if isinstance(t, A.Identifier):
                    out.add(t.name)
        elif isinstance(s, A.IfStatement):
            out |= _assigned_names(s.if_body) | _assigned_names(s.else_body)
        elif isinstance(s, (A.ForStatement, A.ParForStatement)):
            out.add(s.var)
            out |= _assigned_names(s.body)
        elif isinstance(s, A.WhileStatement):
            out |= _assigned_names(s.body)
    return out


# --------------------------------------------------------------------------
# Program construction
# --------------------------------------------------------------------------

class Program:
    """Compiled runtime program (reference: Program.java + the compile chain
    DMLTranslator.constructHops/rewriteHopsDAG/constructLops)."""

    def __init__(self, blocks: List[ProgramBlock], stats=None):
        from systemml_tpu_torch.utils.stats import Statistics

        self.blocks = blocks
        self.functions: Dict[Tuple[int, str], FunctionBlocks] = {}
        self.alias_maps: Dict[int, Dict[str, int]] = {}
        self.stats = stats or Statistics()
        self._purity: Dict[Tuple[int, str], bool] = {}
        self._pool = None
        self._lock = threading.Lock()

    @property
    def pool(self):
        """The buffer pool every ExecutionContext of this program shares,
        made at first use (once, whichever threads run it first)."""
        if self._pool is None:
            from systemml_tpu_torch.runtime.bufferpool import BufferPool

            with self._lock:
                if self._pool is None:
                    self._pool = BufferPool(stats=self.stats)
        return self._pool

    def fresh_stats(self):
        """Swaps in a new Statistics (the pool counting into it), so that
        re-executions of a prepared Program count apart without zeroing a
        snapshot an earlier caller kept. Not while requests are in
        flight: a run counts into the Statistics it started with
        (systemml_tpu/runtime/program.py:1078)."""
        from systemml_tpu_torch.utils.stats import Statistics

        with self._lock:
            self.stats = Statistics()
            if self._pool is not None:
                self._pool.stats = self.stats
            return self.stats

    # builtins whose execution has host side effects or host state: a
    # function reaching any of these must not run inside a captured loop
    # region (systemml_tpu/runtime/program.py:1100-1155)
    _IMPURE_BUILTINS = {
        "print", "write", "stop", "assert", "read", "checkpoint",
        "restore", "checkpointExists", "time", "eval", "sample",
        "transformencode", "transformapply", "transformdecode",
        "transformcolmap", "compress", "decompress", "toString",
    }

    def fn_is_pure(self, file_id: int, namespace: Optional[str],
                   name: Optional[str]) -> bool:
        """Static purity of a user function (transitively): may its body
        run inside a loop region? (reference analog:
        IPAPassInlineFunctions' side-effect-free criteria)."""
        if name is None:
            return False
        fb = self.resolve_function(file_id, namespace, name)
        if fb is None or fb.fn_def.external:
            return False
        key = (fb.file_id, fb.fn_def.name)
        cached = self._purity.get(key)
        if cached is not None:
            return cached
        self._purity[key] = False  # recursion guard
        pure = self._fn_body_pure(fb)
        self._purity[key] = pure
        return pure

    def _fn_body_pure(self, fb: FunctionBlocks) -> bool:
        import dataclasses as _dc

        for s in A.walk_stmts(fb.fn_def.body):
            for f in _dc.fields(s):
                v = getattr(s, f.name)
                exprs = []
                if isinstance(v, A.Expr):
                    exprs = [v]
                elif isinstance(v, list) and v and isinstance(v[0], A.Expr):
                    exprs = v
                elif isinstance(v, dict):
                    exprs = [x for x in v.values() if isinstance(x, A.Expr)]
                for e in exprs:
                    for sub in A.walk_expr(e):
                        if not isinstance(sub, A.FunctionCall):
                            continue
                        target = self.resolve_function(
                            fb.file_id, sub.namespace, sub.name)
                        if target is not None:
                            if not self.fn_is_pure(fb.file_id,
                                                   sub.namespace, sub.name):
                                return False
                        elif sub.name in self._IMPURE_BUILTINS:
                            return False
        return True

    def resolve_function(self, file_id: int, namespace: Optional[str],
                         name: str) -> Optional[FunctionBlocks]:
        if namespace is not None:
            target = self.alias_maps.get(file_id, {}).get(namespace)
            if target is None:
                return None
            return self.functions.get((target, name))
        fb = self.functions.get((file_id, name))
        if fb is None and file_id != 0:
            fb = self.functions.get((0, name))
        return fb

    def execute(self, inputs: Optional[Dict[str, Any]] = None,
                printer=None, skip_writes: bool = False,
                block_graphs: bool = False) -> ExecutionContext:
        from systemml_tpu_torch.obs import trace as obs
        from systemml_tpu_torch.utils import stats as stats_mod

        from systemml_tpu_torch.resil import inject

        # (re)arm the config channel of the fault-injection registry at
        # run entry: counters reset per execution, so a prepared script
        # re-run under injection sees the same deterministic schedule
        inject.arm(get_config().fault_injection)
        # bound once for the run: a fresh_stats() swap mid-run must end the
        # run on the Statistics that started it
        stats = self.stats
        ec = ExecutionContext(self, stats=stats, printer=printer)
        ec.skip_writes = skip_writes
        ec.block_graphs = block_graphs
        if inputs:
            # the caller holds its inputs: the pool never admits them
            for k, v in inputs.items():
                ec.vars.bind_external(k, v)
        stats.start_run()
        try:
            with stats_mod.stats_scope(stats), \
                    obs.span("program_execute", obs.CAT_RUNTIME,
                             blocks=len(self.blocks)):
                for b in self.blocks:
                    b.execute(ec)
        finally:
            stats.end_run()
        return ec


class ProgramCompiler:
    """AST -> ProgramBlock tree (reference: DMLTranslator + ProgramConverter
    duties)."""

    def __init__(self, clargs: Optional[Dict[str, Any]] = None):
        self.clargs = clargs or {}
        self.program: Optional[Program] = None
        self._file_ids: Dict[int, int] = {}
        self._next_file_id = 0
        self._current_fid = 0  # file scope of the body being compiled

    def compile(self, ast_prog: A.DMLProgram) -> Program:
        from systemml_tpu_torch.hops.ipa import run_ipa
        from systemml_tpu_torch.utils import stats as stats_mod

        run_ipa(ast_prog)
        self.program = Program([])
        # compile-time rewrite counters land on the program's Statistics
        with stats_mod.stats_scope(self.program.stats):
            main_id = self._register_file(ast_prog)
            assert main_id == 0
            builder = self._builder_for(ast_prog)
            self.program.blocks = self._compile_body(ast_prog.statements,
                                                     builder)
        return self.program

    # ---- files / namespaces ---------------------------------------------

    def _register_file(self, prog: A.DMLProgram) -> int:
        key = id(prog)
        if key in self._file_ids:
            return self._file_ids[key]
        fid = self._next_file_id
        self._next_file_id += 1
        self._file_ids[key] = fid
        self.program.alias_maps[fid] = {}
        builder = self._builder_for(prog)
        prev_fid = self._current_fid
        self._current_fid = fid
        for (ns, name), fd in prog.functions.items():
            builder.consts = {}   # per-function scope: args are unknown
            blocks = self._compile_body(fd.body, builder)
            self.program.functions[(fid, name)] = FunctionBlocks(fd, blocks, fid)
        self._current_fid = prev_fid
        for alias, sub in prog.imports.items():
            sub_id = self._register_file(sub)
            self.program.alias_maps[fid][alias] = sub_id
        return fid

    def _builder_for(self, prog: A.DMLProgram) -> HopBuilder:
        user_fns = {(None, name) for (_ns, name) in prog.functions.keys()}
        return HopBuilder(self.clargs, user_fns)

    def _pred(self, e: A.Expr, builder: HopBuilder) -> CompiledPredicate:
        from systemml_tpu_torch.hops.rewrite import rewrite_block

        hop, reads = builder.build_predicate(e)
        tmp = BlockHops()
        tmp.writes = {CompiledPredicate._PRED: hop}
        tmp.reads = set(reads)
        rewrite_block(tmp)
        if get_config().optlevel >= 3:
            from systemml_tpu_torch.codegen.compiler import compile_spoof

            compile_spoof(tmp)  # predicate dims unknown: structural match
        return CompiledPredicate(tmp.writes[CompiledPredicate._PRED],
                                 tmp.reads, self.program)

    # ---- block splitting -------------------------------------------------

    def _compile_body(self, stmts: List[A.Stmt], builder: HopBuilder
                      ) -> List[ProgramBlock]:
        from systemml_tpu_torch.hops.rewrite import rewrite_block

        blocks: List[ProgramBlock] = []
        run: List[A.Stmt] = []

        def flush():
            if run:
                blk = builder.build_block(list(run))
                rewrite_block(blk)
                blocks.append(BasicBlock(blk, self.program,
                                         self._current_fid))
                run.clear()
                # cross-block constant propagation: record literal-valued
                # writes for later blocks/predicates, invalidate the rest
                for n, h in blk.writes.items():
                    if h.op == "lit" and isinstance(h.value,
                                                    (bool, int, float, str)):
                        builder.consts[n] = h.value
                    elif not (h.op == "tread" and h.name == n):
                        builder.consts.pop(n, None)

        for s in stmts:
            if isinstance(s, (A.ImportStatement, A.PathStatement, A.FunctionDef)):
                continue
            if isinstance(s, A.IfStatement):
                flush()
                pred = self._pred(s.predicate, builder)
                taken = _constant_branch(pred)
                if taken is not None:
                    # branch removal (reference: RewriteRemoveUnnecessary-
                    # Branches): a predicate that folded to a literal
                    # inlines the taken branch; the dead one is never
                    # compiled
                    body = s.if_body if taken else s.else_body
                    blocks.extend(self._compile_body(body, builder))
                    continue
                # each branch sees pre-if constants; the join keeps only
                # names neither branch may assign
                saved = dict(builder.consts)
                if_blocks = self._compile_body(s.if_body, builder)
                builder.consts = dict(saved)
                else_blocks = self._compile_body(s.else_body, builder)
                builder.consts = saved
                for n in (_assigned_names(s.if_body)
                          | _assigned_names(s.else_body)):
                    builder.consts.pop(n, None)
                blocks.append(IfBlock(pred, if_blocks, else_blocks))
            elif isinstance(s, A.WhileStatement):
                flush()
                # back edge: the predicate and body see post-iteration
                # state, so anything the body assigns is not constant
                for n in _assigned_names(s.body):
                    builder.consts.pop(n, None)
                blocks.append(WhileBlock(self._pred(s.predicate, builder),
                                         self._compile_body(s.body, builder)))
            elif isinstance(s, A.ParForStatement):
                flush()
                params = {k: builder.build_predicate(v)[0]
                          for k, v in s.params.items()}
                # bounds evaluate ONCE at entry (pre-loop constants ok);
                # the body runs post-assignment state
                from_p = self._pred(s.from_expr, builder)
                to_p = self._pred(s.to_expr, builder)
                incr_p = (self._pred(s.incr_expr, builder)
                          if s.incr_expr else None)
                for n in _assigned_names(s.body) | {s.var}:
                    builder.consts.pop(n, None)
                # no constant substitution inside the body, as the JAX
                # package compiles it (its remote workers re-parse the
                # body's source; the port keeps the same hops)
                saved_consts = builder.consts
                builder.consts = {}
                pf_body = self._compile_body(s.body, builder)
                builder.consts = saved_consts
                pb = ParForBlock(s.var, from_p, to_p, incr_p, pf_body, params)
                pb.body_stmts = s.body
                blocks.append(pb)
            elif isinstance(s, A.ForStatement):
                flush()
                from_p = self._pred(s.from_expr, builder)
                to_p = self._pred(s.to_expr, builder)
                incr_p = (self._pred(s.incr_expr, builder)
                          if s.incr_expr else None)
                for n in _assigned_names(s.body) | {s.var}:
                    builder.consts.pop(n, None)
                blocks.append(ForBlock(
                    s.var, from_p, to_p, incr_p,
                    self._compile_body(s.body, builder)))
            else:
                run.append(s)
        flush()
        return blocks


def _merge_adjacent_blocks(blocks: List[ProgramBlock]) -> List[ProgramBlock]:
    """Superblock formation: adjacent BasicBlocks merge into ONE block by
    rewiring the second block's treads onto the first block's write hops
    (reference: parser/StatementBlock.mergeStatementBlocks). Constant
    propagation prunes the output-file and icpt branches of every
    algorithm script and leaves a chain of small blocks; merged, each op
    of the chain is evaluated once per run of the merged block."""
    out: List[ProgramBlock] = []
    for b in blocks:
        if isinstance(b, IfBlock):
            b.if_body = _merge_adjacent_blocks(b.if_body)
            b.else_body = _merge_adjacent_blocks(b.else_body)
        elif isinstance(b, (WhileBlock, ForBlock)):
            b.body = _merge_adjacent_blocks(b.body)
        if (out and isinstance(b, BasicBlock)
                and isinstance(out[-1], BasicBlock)
                and out[-1].file_id == b.file_id):
            out[-1] = _merge_two_blocks(out[-1], b)
        else:
            out.append(b)
    return out


def _merge_two_blocks(a: "BasicBlock", b: "BasicBlock") -> "BasicBlock":
    from systemml_tpu_torch.hops.hop import postorder

    amap = a.hops.writes
    # rewire: b's treads of names a writes become direct references to
    # a's value hops (collect first: mutation during the postorder walk
    # would confuse its visited set)
    hops_b = list(postorder(b.hops.roots()))
    for h in hops_b:
        if any(c.op == "tread" and c.name in amap for c in h.inputs):
            h.inputs = [amap[c.name]
                        if c.op == "tread" and c.name in amap else c
                        for c in h.inputs]
    new_writes = dict(amap)
    for n, h in b.hops.writes.items():
        if h.op == "tread" and h.name in amap:
            h = amap[h.name]   # identity tread of an a-written name
        new_writes[n] = h
    merged = BlockHops()
    merged.writes = new_writes
    merged.sinks = list(a.hops.sinks) + list(b.hops.sinks)
    merged.reads = set(a.hops.reads) | (set(b.hops.reads) - set(amap))
    return BasicBlock(merged, a.program, a.file_id)


def _check_config_supported(cfg) -> None:
    import os

    from systemml_tpu_torch.utils.config import check_fault_sites

    check_ported(cfg)
    check_fault_sites(cfg.fault_injection)
    check_fault_sites(os.environ.get("SMTPU_FAULT", ""))
    if cfg.exec_mode == "MESH":
        raise NotImplementedError(
            "exec_mode MESH waits for ROADMAP queue 1, distributed and "
            "elastic")


def compile_program(ast_prog: A.DMLProgram,
                    clargs: Optional[Dict[str, Any]] = None,
                    outputs: Optional[Sequence[str]] = None,
                    input_names: Optional[Sequence[str]] = None,
                    input_sparsity: Optional[Dict[str, float]] = None
                    ) -> Program:
    """outputs = the caller's requested result variables (MLContext); they
    seed the exit-live set of the rmvar liveness pass. None keeps every
    top-level write alive to program end. input_names = in-memory
    bindings the caller will supply at execute time (they count as
    defined for the validate pass). input_sparsity = name -> observed
    sparsity of bound inputs: seeds Hop.est_sp, so that the estimate-
    guarded rewrites (the quaternary tranche, hops/rewrite._q_guard) see
    a bound sparse matrix as sparse. At optlevel 3 on the card the
    program's fused plans are built before it returns."""
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.utils import stats as stats_mod

    cfg = get_config()
    _check_config_supported(cfg)
    if cfg.validate_enabled:
        from systemml_tpu_torch.lang.validate import validate_program

        with obs.span("validate", obs.CAT_COMPILE):
            validate_program(ast_prog, input_names or ())
    with obs.span("hop_build", obs.CAT_COMPILE):
        prog = ProgramCompiler(clargs).compile(ast_prog)
    if cfg.optlevel >= 2:
        with obs.span("superblock_merge", obs.CAT_COMPILE):
            prog.blocks = _merge_adjacent_blocks(prog.blocks)
            for fb in prog.functions.values():
                fb.blocks = _merge_adjacent_blocks(fb.blocks)
        # loop-invariant code motion BEFORE liveness so the synthetic
        # pre-loop blocks get real liveness annotations
        from systemml_tpu_torch.hops.hoist import hoist_program

        with stats_mod.stats_scope(prog.stats), \
                obs.span("hoist", obs.CAT_COMPILE):
            hoist_program(prog)
    if cfg.liveness_enabled:
        from systemml_tpu_torch.compiler.liveness import annotate_program

        with obs.span("liveness", obs.CAT_COMPILE):
            annotate_program(prog,
                             set(outputs) if outputs is not None else None)
    # program-wide size propagation, then the dynamic (size-conditional)
    # rewrites now that dims are known (reference: RewriteAlgebraic-
    # SimplificationDynamic during recompilation), alternating with the
    # static tranche until a dynamic sweep applies nothing
    from systemml_tpu_torch.hops.ipa import propagate_program_sizes
    from systemml_tpu_torch.hops.rewrite import (rewrite_block,
                                                 rewrite_block_dynamic)

    with obs.span("size_propagation", obs.CAT_COMPILE):
        propagate_program_sizes(prog, input_sps=input_sparsity)
    if cfg.optlevel >= 2:
        with stats_mod.stats_scope(prog.stats), \
                obs.span("dynamic_rewrites", obs.CAT_COMPILE) as dsp:
            total_dyn = rounds = 0
            for _ in range(4):
                rounds += 1
                n_dyn = sum(rewrite_block_dynamic(bb.hops)
                            for bb in iter_basic_blocks(prog))
                total_dyn += n_dyn
                if not n_dyn:
                    break
                for bb in iter_basic_blocks(prog):
                    rewrite_block(bb.hops)
                propagate_program_sizes(prog, input_sps=input_sparsity)
            dsp.set(applied=total_dyn, rounds=rounds)
        if total_dyn:
            prog.stats.count_estim("dynamic_rewrites", total_dyn)
    if cfg.optlevel >= 3:
        _spoof_codegen(prog, cfg)
    _propagate_layout(prog)
    if cfg.cla != "false":
        # compressed-reblock injection: mark loop-invariant matmult inputs
        # for sample-estimated compression at loop entry (reference:
        # hops/rewrite/RewriteCompressedReblock.java)
        from systemml_tpu_torch.compress.rewrite import plan_auto_compression

        n_cla = plan_auto_compression(prog)
        if n_cla:
            prog.stats.count_estim("cla_candidates", n_cla)
    _mark_top_level(prog.blocks)
    # loop-region planning LAST, over the final hop graphs, as
    # systemml_tpu/runtime/program.py:1655-1665: every while/for nest gets
    # a LoopRegion plan (carried state, invariants, shape statics, the
    # predicate's mode) or a classified refusal, which the region executor
    # (runtime/loopfuse.py) runs from
    if cfg.codegen_enabled:
        from systemml_tpu_torch.compiler.lower import plan_loop_regions

        with obs.span("loop_region_planning", obs.CAT_COMPILE) as rsp:
            regions = plan_loop_regions(prog)
            refused = sum(1 for r in regions if r.refused)
            rsp.set(regions=len(regions), refused=refused)
        if regions:
            prog.stats.count_estim("loop_regions", len(regions))
        if refused:
            prog.stats.count_estim("loop_regions_refused", refused)
    return prog


def _propagate_layout(prog: "Program") -> None:
    """DNN layout propagation (hops/layout.py) after every rewrite pass,
    where systemml_tpu/runtime/program.py:1602-1615 runs it: chained
    conv/bias/relu/pool hops pass raw NHWC tensors when the device layout
    is NHWC. The annotations are an optimization only, so a failure
    leaves the program unannotated; unlike the JAX package, which drops
    it silently, it is counted in `dnn_layout_errors` and emitted as a
    `layout_error` event."""
    from systemml_tpu_torch.hops.layout import propagate_program_layout
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.utils import stats as stats_mod

    with stats_mod.stats_scope(prog.stats), \
            obs.span("layout_propagation", obs.CAT_COMPILE) as sp:
        try:
            sp.set(edges=propagate_program_layout(prog))
        except Exception as e:  # except-ok: layout annotations are an optimization only; counted
            prog.stats.count_estim("dnn_layout_errors", 1)
            obs.instant("layout_error", obs.CAT_COMPILE,
                        error=f"{type(e).__name__}: {e}")


def _mark_top_level(blocks) -> None:
    """Marks the basic blocks outside every loop of the main program (an
    if's branches included) for the block compile's re-selection."""
    for b in blocks:
        if isinstance(b, BasicBlock):
            b.top_level = True
        elif isinstance(b, IfBlock):
            _mark_top_level(b.if_body)
            _mark_top_level(b.else_body)


def _spoof_codegen(prog: "Program", cfg) -> None:
    """Operator-fusion codegen with dims in hand: enumerate template
    matches into the memo table and select by cost (reference:
    SpoofCompiler.generateCode + PlanSelectionFuseCostBasedV2). Per-block
    isolation, as in the JAX package: a selection fault in one block
    leaves that block unfused and is counted in spoof_compile_errors, not
    raised. Each spoof hop's source variant (its scalar and aliased
    leaves, its aggregates) is then fixed, and on the card the kernels of
    every selected plan are built, all nvcc runs together, before the
    program runs."""
    from systemml_tpu_torch.codegen import build
    from systemml_tpu_torch.codegen.compiler import (assign_variants,
                                                     compile_spoof,
                                                     program_plans)
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.utils import stats as stats_mod

    with stats_mod.stats_scope(prog.stats), \
            obs.span("spoof_codegen", obs.CAT_COMPILE):
        for bb in iter_basic_blocks(prog):
            try:
                compile_spoof(bb.hops)
            except Exception:  # except-ok: per-block spoof isolation; counted, not fatal
                prog.stats.count_estim("spoof_compile_errors", 1)
        assign_variants(prog)
    if cfg.device != "cpu":
        with obs.span("spoof_build", obs.CAT_COMPILE) as sp:
            sp.set(built=len(build.build_plans(
                program_plans(prog), limit=cfg.compile_timeout_s or None)))


def iter_basic_blocks(program: "Program"):
    """Every BasicBlock in the program, including control-flow and
    function bodies."""
    def walk(blocks):
        for b in blocks:
            if isinstance(b, BasicBlock):
                yield b
            elif isinstance(b, IfBlock):
                yield from walk(b.if_body)
                yield from walk(b.else_body)
            elif isinstance(b, (WhileBlock, ForBlock)):
                yield from walk(b.body)

    yield from walk(program.blocks)
    for fb in program.functions.values():
        yield from walk(fb.blocks)


def _predicates(block: ProgramBlock):
    if isinstance(block, IfBlock):
        return [block.pred]
    if isinstance(block, WhileBlock):
        return [block.pred]
    if isinstance(block, ForBlock):
        return [p for p in (block.from_h, block.to_h, block.incr_h)
                if p is not None]
    return []


def iter_spoof_hops(program: "Program"):
    """Every spoof hop of the program: in its basic blocks, including
    control-flow and function bodies, and in its loop and if predicates."""
    from systemml_tpu_torch.hops.hop import postorder

    def walk(blocks):
        for b in blocks:
            for p in _predicates(b):
                yield p.block
            if isinstance(b, BasicBlock):
                yield b
            elif isinstance(b, IfBlock):
                yield from walk(b.if_body)
                yield from walk(b.else_body)
            elif isinstance(b, (WhileBlock, ForBlock)):
                yield from walk(b.body)

    bodies = [program.blocks] + [fb.blocks
                                 for fb in program.functions.values()]
    for blocks in bodies:
        for bb in walk(blocks):
            for h in postorder(bb.hops.roots()):
                if h.op == "spoof":
                    yield h
