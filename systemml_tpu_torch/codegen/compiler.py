# Port of systemml_tpu/codegen/compiler.py: SpoofCompiler, _extract_cell, _apply
# and compile_spoof (lines 33-284) are copied with their imports pointed at
# systemml_tpu_torch; the four spoof families of the kernel backend
# (lines 345-420 there) register the hand kernels K2-K5 as their templates
# and the plain versions as their fallbacks; execute_spoof dispatches
# through the backend as there, with each hop's build.Variant; and
# _outer_sampled (line 510 there) is rewritten so that it runs (the JAX
# package's uses jnp without importing it, and raises NameError on a
# sparse X).
"""Codegen planner: template matching over HOP DAGs + plan cache.

TPU-native equivalent of the reference's SpoofCompiler
(hops/codegen/SpoofCompiler.java:100 — generateCode at :168, plan cache
:162, template matching via TemplateCell/Row/MultiAgg/OuterProduct in
hops/codegen/template/, memo table CPlanMemoTable.java:46, cost-based
selection PlanSelectionFuseCostBasedV2).

Matching is two-phase, like the reference: candidate enumeration records
every template match (plus trimmed / leaf variants) in a MemoTable
(codegen/memo.py), then cost-based selection picks the compatible subset
with the lowest modeled time — including the "don't fuse, XLA-default
wins" arm. Selected plans replace their region with `spoof` hops carrying
a CPlan; execution (execute_spoof below, codegen/kernels.py) streams the
region through one hand-written CUDA kernel on the card (csrc/spoof.cuh
instantiated with the plan's expression). On the CPU the same CPlan
evaluates as torch ops, the kernels' plain versions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from systemml_tpu_torch.codegen.cplan import CELL_BINARY, CELL_UNARY, CNode
from systemml_tpu_torch.codegen.memo import (MemoEntry, MemoTable,
                                             build_consumers, select_plans)
from systemml_tpu_torch.hops.builder import BlockHops
from systemml_tpu_torch.hops.hop import Hop, postorder
from systemml_tpu_torch.runtime.sparse import ensure_dense, is_ell, is_sparse

# minimum fused-op count for a plan to be worth a spoof operator
MIN_FUSED_OPS = 2


class SpoofCompiler:
    def __init__(self):
        # plan cache: structural key -> compiled callable (reference:
        # SpoofCompiler.PLAN_CACHE, hops/codegen/SpoofCompiler.java:162)
        self.plan_cache: Dict[Tuple, object] = {}

    def compile_block(self, blk: BlockHops,
                      wide_single_op: bool = False) -> int:
        """Enumerate template matches, select by cost, apply winners;
        returns #spoof operators created. With `wide_single_op` (the block
        compile, runtime/blockcompile.py) an aggregate of one cellwise op
        over a matrix of more than one column is a candidate too: the
        fusion XLA makes in the JAX package's whole-block jit, which
        keeps the op's (m, n) temporary from being formed."""
        roots = blk.roots()
        materialized = {h.id for h in blk.writes.values()}
        materialized |= {h.id for h in blk.sinks}
        hop_by_id = {h.id: h for h in postorder(roots)}
        memo = MemoTable([], build_consumers(roots), materialized)
        memo.entries.extend(self._enumerate(blk, memo, wide_single_op))
        if not memo.entries:
            return 0
        chosen = select_plans(memo, None, hop_by_id)
        for e in chosen:
            self._apply(blk, e)
        return len(chosen)

    # ---- candidate enumeration ------------------------------------------

    def _enumerate(self, blk: BlockHops, memo: MemoTable,
                   wide: bool) -> List[MemoEntry]:
        roots = blk.roots()
        ext = memo.ext_consumed
        entries: List[MemoEntry] = []
        # multi-agg groups (several full aggregates over one shared source)
        by_src: Dict[int, List[Hop]] = {}
        for h in postorder(roots):
            if h.op.startswith("ua(") and h.params.get("dir") == "all" and \
                    h.params.get("aop") in ("sum", "min", "max"):
                by_src.setdefault(h.inputs[0].id, []).append(h)
        for _src_id, aggs in by_src.items():
            if len(aggs) < 2:
                continue
            plan, leaves, nops, mm, cover = _extract_cell(
                aggs[0].inputs[0], allow_one_mm=False)
            if plan is not None and nops >= 1 and mm is None:
                entries.append(MemoEntry(
                    "multiagg", list(aggs), cover, plan, leaves, nops,
                    {"aggs": [a.params["aop"] for a in aggs]}))
        # per-root cell / row / outer candidates
        for h in postorder(roots):
            if h.op.startswith("ua(") and h.params.get("dir") == "all" \
                    and h.params.get("aop") == "sum":
                entries.extend(self._cands_agg_cell(h, ext, wide))
            elif h.op.startswith("ua(") and h.params.get("dir") == "row" \
                    and h.params.get("aop") in ("sum", "min", "max"):
                entries.extend(self._cands_row(h, ext, wide))
        return entries

    def _cands_agg_cell(self, agg: Hop, ext, wide: bool) -> List[MemoEntry]:
        src = agg.inputs[0]
        out: List[MemoEntry] = []
        plan, leaves, nops, mm, cover = _extract_cell(src, allow_one_mm=True)
        base_cover = cover  # allow_one_mm=False cover for the trim pass
        if plan is not None and nops >= MIN_FUSED_OPS and mm is not None:
            # OuterProduct: one interior U %*% t(V) plus exactly one other
            # matrix leaf (the X in sum(f(X, UV))); scalars ride along
            u, vt = mm.inputs
            v = vt.inputs[0]
            real = [l for l in leaves if l != "UV"]
            mat = [l for l in real if _hop_of(l).dt == "matrix"]
            sca = [l for l in real if _hop_of(l).dt != "matrix"]
            if len(mat) == 1:
                oplan = _clone(plan)
                _rename_leaf(oplan, _name_of(mat[0]), "X")
                out.append(MemoEntry(
                    "outer", [agg], cover | {mm.id}, oplan,
                    [mat[0]] + sca, nops,
                    {"mm": mm, "u": u, "v": v,
                     "scalar_names": [_name_of(l) for l in sca]}))
        if plan is not None and mm is None and _enough(nops, leaves, wide):
            out.append(MemoEntry("cell", [agg], cover, plan, leaves, nops,
                                 {"agg": "sum"}))
        if mm is not None:
            # leaf variant: the product is a plain kernel input (wins when
            # it is materialized for another consumer anyway)
            plan2, leaves2, nops2, mm2, cover2 = _extract_cell(
                src, allow_one_mm=False)
            base_cover = cover2
            if plan2 is not None and nops2 >= MIN_FUSED_OPS and mm2 is None:
                out.append(MemoEntry("cell", [agg], cover2, plan2, leaves2,
                                     nops2, {"agg": "sum"}))
        out.extend(self._trimmed("cell", agg, src, ext, {"agg": "sum"},
                                 base_cover))
        return out

    def _cands_row(self, agg: Hop, ext, wide: bool) -> List[MemoEntry]:
        src = agg.inputs[0]
        out: List[MemoEntry] = []
        plan, leaves, nops, mm, cover = _extract_cell(src, allow_one_mm=False)
        if plan is not None and mm is None and _enough(nops, leaves, wide):
            out.append(MemoEntry("row", [agg], cover, plan, leaves, nops,
                                 {"row_agg": agg.params["aop"]}))
        out.extend(self._trimmed("row", agg, src, ext,
                                 {"row_agg": agg.params.get("aop")}, cover))
        return out

    def _trimmed(self, template: str, agg: Hop, src: Hop,
                 ext, extra: dict, cover: Set[int]) -> List[MemoEntry]:
        """Variant that stops at externally-consumed interior hops (they
        materialize regardless, so the kernel reads them as inputs instead
        of recomputing). Reference analog: the material-point partitioning
        in PlanSelectionFuseCostBasedV2.getMaterializationPoints."""
        if not cover:
            return []
        footprint = cover | {agg.id}
        stop = {hid for hid in cover if ext(hid, footprint)}
        if not stop:
            return []
        plan2, leaves2, nops2, mm2, cover2 = _extract_cell(
            src, allow_one_mm=False, stop=stop)
        if plan2 is None or nops2 < MIN_FUSED_OPS or mm2 is not None \
                or cover2 == cover:
            return []
        e = MemoEntry(template, [agg], cover2, plan2, leaves2, nops2,
                      dict(extra))
        e.extra["trimmed"] = True
        return [e]

    # ---- applying selected plans ----------------------------------------

    def _apply(self, blk: BlockHops, e: MemoEntry):
        if e.template == "outer":
            sp = Hop("spoof", [_hop_of(e.leaves[0])] +
                     [_hop_of(l) for l in e.leaves[1:]] +
                     [e.extra["u"], e.extra["v"]],
                     {"template": "outer", "plan": e.plan,
                      "scalar_names": e.extra["scalar_names"],
                      "cost_ratio": e.cost_ratio()},
                     dt="scalar")
            _replace(blk, e.roots[0], sp)
        elif e.template == "cell":
            sp = Hop("spoof", [_hop_of(l) for l in e.leaves],
                     {"template": "cell", "plan": e.plan, "agg": "sum",
                      "leaf_names": [_name_of(l) for l in e.leaves],
                      "cost_ratio": e.cost_ratio()},
                     dt="scalar")
            _replace(blk, e.roots[0], sp)
        elif e.template == "row":
            sp = Hop("spoof", [_hop_of(l) for l in e.leaves],
                     {"template": "row", "plan": e.plan,
                      "row_agg": e.extra["row_agg"],
                      "leaf_names": [_name_of(l) for l in e.leaves],
                      "cost_ratio": e.cost_ratio()},
                     dt="matrix")
            _replace(blk, e.roots[0], sp)
        elif e.template == "multiagg":
            sp = Hop("spoof", [_hop_of(l) for l in e.leaves],
                     {"template": "multiagg", "plan": e.plan,
                      "aggs": e.extra["aggs"],
                      "leaf_names": [_name_of(l) for l in e.leaves],
                      "cost_ratio": e.cost_ratio()},
                     dt="list")
            for i, a in enumerate(e.roots):
                pick = Hop("pick", [sp], {"index": i}, dt="scalar")
                _replace(blk, a, pick)
        else:
            raise ValueError(f"unknown template {e.template!r}")


# --------------------------------------------------------------------------
# cplan extraction
# --------------------------------------------------------------------------

def _extract_cell(h: Hop, allow_one_mm: bool,
                  stop: Optional[Set[int]] = None
                  ) -> Tuple[Optional[CNode], List, int, Optional[Hop],
                             Set[int]]:
    """Extract a maximal elementwise CPlan rooted at `h`. Leaves are
    non-fusible hops (tread, lit stays inline, matmult when allowed, any
    hop id in `stop`). Returns (plan, leaves, n_fused_ops, mm_hop|None,
    covered interior hop ids)."""
    leaves: List = []
    cover: Set[int] = set()
    state = {"nops": 0, "mm": None, "ok": True}
    stop = stop or set()

    def visit(x: Hop) -> Optional[CNode]:
        if not state["ok"]:
            return None
        if x.op == "lit" and not isinstance(x.value, str):
            return CNode("lit", value=float(x.value)
                         if not isinstance(x.value, bool) else float(x.value))
        if (x.op in CELL_BINARY or x.op in CELL_UNARY) and x.id not in stop:
            kids = [visit(c) for c in x.inputs]
            if any(k is None for k in kids):
                state["ok"] = False
                return None
            state["nops"] += 1
            cover.add(x.id)
            return CNode(x.op, kids)
        if allow_one_mm and x.op == "ba+*" and state["mm"] is None and \
                x.inputs[1].op == "reorg(t)" and x.id not in stop:
            state["mm"] = x
            leaves.append("UV")
            return CNode("in", name="UV")
        # leaf: any other hop (tread, call:, ba+*, ...) enters as an input
        name = f"i{len(leaves)}"
        leaves.append((name, x))
        return CNode("in", name=name)

    plan = visit(h)
    if not state["ok"] or plan is None:
        return None, [], 0, None, set()
    return plan, leaves, state["nops"], state["mm"], cover


def _hop_of(leaf) -> Hop:
    return leaf[1]


def _name_of(leaf) -> str:
    return leaf[0]


def _rename_leaf(plan: CNode, old: str, new: str):
    if plan.op == "in" and plan.name == old:
        plan.name = new
    for c in plan.inputs:
        _rename_leaf(c, old, new)


def _clone(plan: CNode) -> CNode:
    return CNode(plan.op, [_clone(c) for c in plan.inputs],
                 value=plan.value, name=plan.name)


def _replace(blk: BlockHops, old: Hop, new: Hop):
    for h in postorder(blk.roots()):
        if old in h.inputs:
            h.inputs = [new if c is old else c for c in h.inputs]
    blk.writes = {k: (new if v is old else v) for k, v in blk.writes.items()}
    blk.sinks = [new if s is old else s for s in blk.sinks]


def _enough(nops: int, leaves, wide: bool) -> bool:
    """A plan of `nops` ops is worth a spoof operator: MIN_FUSED_OPS, or
    with `wide` one op over a matrix of more than one column."""
    if nops >= MIN_FUSED_OPS:
        return True
    return (nops == 1 and wide
            and any(h.is_matrix and h.rows > 1 and h.cols > 1
                    for _, h in leaves))


_GLOBAL = SpoofCompiler()


def compile_spoof(blk: BlockHops, wide_single_op: bool = False) -> int:
    """Entry point called from the compile pipeline at optlevel >= 3, after
    program-wide size propagation so plan selection sees concrete dims
    (reference: DMLTranslator.rewriteHopsDAG codegen step,
    parser/DMLTranslator.java:287-295; selection during recompile has dims
    the same way), and from the block compile with run-time dims
    (runtime/blockcompile.py, `wide_single_op`)."""
    return _GLOBAL.compile_block(blk, wide_single_op)


# --------------------------------------------------------------------------
# spoof execution (reference: SpoofCPInstruction dispatching the janino-
# compiled operator). Each template is a family of the kernel backend
# (codegen/backend.py): its hand kernel (codegen/kernels.py, csrc/
# spoof.cuh), swept over the launch's grid, and its plain version, which
# runs where the kernel does not: on the CPU (pallas_mode "auto"), under
# pallas_mode "never", and for a call whose leaf layout (or outer rank)
# the kernel refuses, which counts spoof_plain_by_layout as before.
# --------------------------------------------------------------------------

from systemml_tpu_torch.codegen import backend as kbackend
from systemml_tpu_torch.codegen import kernels


def _spoof_kernel_ok(ctx) -> bool:
    return kbackend.use_kernel(ctx["backend"]) and ctx.get("has_matrix",
                                                           False)


def _spoof_cost_kernel(ctx) -> float:
    """One pass over the leaves and one launch."""
    from systemml_tpu_torch.hops.cost import HwProfile

    hw = HwProfile.detect()
    return ctx.get("bytes", 0.0) / hw.hbm_bw + hw.dispatch_us * 1e-6


def _spoof_cost_plain(ctx) -> float:
    """The plain arm, modeled as the two-pass lowering of the same region
    (the memo table's alt arm uses the same additive shape)."""
    from systemml_tpu_torch.hops.cost import HwProfile

    hw = HwProfile.detect()
    return 2.0 * ctx.get("bytes", 0.0) / hw.hbm_bw + hw.dispatch_us * 1e-6


def _spoof_grid_sweep():
    """The resident blocks per SM of the kernel's grid: the empty point
    keeps the kernel's own (as many as fit); the others cap it. Each is a
    run-time launch parameter of the one build of the plan."""
    return [{}] + [{"bps": b} for b in (1, 2, 4)]


def _outer_grid_sweep():
    """Rows of blocks of the outer kernel's grid, each striding over X's
    row tiles: the empty point keeps one per tile (up to 65,535)."""
    return [{}] + [{"grid_y": g} for g in (64, 256, 1024)]


def _bps(ctx):
    return (ctx.get("sched") or {}).get("bps")


def _layout_ok(ctx, plan, names, op, env, variant) -> bool:
    """Whether the spoof kernels take the call's leaf layout (a plan with
    no matrix leaf runs on its scalars in the wrapper)."""
    return not kernels._matrices(names, env) or kernels.spoof_layout_ok(
        names, env)


def _plain_layout_count(names, env) -> None:
    """The count of a call whose leaf layout the kernels refuse, as the
    wrappers count it (codegen/kernels._kernel_main)."""
    if kernels._matrices(names, env) and not kernels.spoof_layout_ok(names,
                                                                     env):
        kernels._count_plain_by_layout()


_cell_fam = kbackend.family("spoof_cell")


@_cell_fam.template("kernel", _spoof_grid_sweep, cost=_spoof_cost_kernel,
                    supported=_spoof_kernel_ok, accepts=_layout_ok,
                    fallback="plain")
def _cell_kernel(ctx, plan, names, agg, env, variant):
    return kernels.cell_kernel(plan, names, agg, env, variant,
                               blocks_per_sm=_bps(ctx))


@_cell_fam.variant("plain", cost=_spoof_cost_plain, is_fallback=True)
def _cell_plain(ctx, plan, names, agg, env, variant):
    _plain_layout_count(names, env)
    return kernels.cell_plain(plan, names, agg, env)


_row_fam = kbackend.family("spoof_row")


@_row_fam.template("kernel", _spoof_grid_sweep, cost=_spoof_cost_kernel,
                   supported=_spoof_kernel_ok, accepts=_layout_ok,
                   fallback="plain")
def _row_kernel(ctx, plan, names, row_agg, env, variant):
    return kernels.row_kernel(plan, names, row_agg, env, variant,
                              blocks_per_sm=_bps(ctx))


@_row_fam.variant("plain", cost=_spoof_cost_plain, is_fallback=True)
def _row_plain(ctx, plan, names, row_agg, env, variant):
    _plain_layout_count(names, env)
    return kernels.row_plain(plan, names, row_agg, env)


_magg_fam = kbackend.family("spoof_multiagg")


@_magg_fam.template("kernel", _spoof_grid_sweep, cost=_spoof_cost_kernel,
                    supported=_spoof_kernel_ok, accepts=_layout_ok,
                    fallback="plain")
def _magg_kernel(ctx, plan, names, aggs, env, variant):
    return kernels.multiagg_kernel(plan, names, aggs, env, variant,
                                   blocks_per_sm=_bps(ctx))


@_magg_fam.variant("plain", cost=_spoof_cost_plain, is_fallback=True)
def _magg_plain(ctx, plan, names, aggs, env, variant):
    _plain_layout_count(names, env)
    return kernels.multiagg_plain(plan, names, aggs, env)


_outer_fam = kbackend.family("spoof_outer")


def _outer_rank_ok(ctx, plan, x, u, v, extra, variant) -> bool:
    return u.shape[1] <= kernels.OUTER_MAX_RANK


@_outer_fam.template("kernel", _outer_grid_sweep, cost=_spoof_cost_kernel,
                     supported=_spoof_kernel_ok, accepts=_outer_rank_ok,
                     fallback="plain")
def _outer_kernel(ctx, plan, x, u, v, extra, variant):
    return kernels.outer_kernel(plan, x, u, v, extra, variant,
                                grid_y=(ctx.get("sched") or {}).get("grid_y"))


@_outer_fam.variant("plain", cost=_spoof_cost_plain, is_fallback=True)
def _outer_plain(ctx, plan, x, u, v, extra, variant):
    # the wrapper counts a rank above its bound on the card only (a CPU X
    # runs the plain version first)
    if x.device.type == "cuda" and u.shape[1] > kernels.OUTER_MAX_RANK:
        kernels._count_plain_by_layout()
    return kernels.outer_plain(plan, x, u, v, extra)


def _spoof_ctx(env) -> dict:
    """Key and cost fields: the main leaf's shape and dtype, and the
    leaves' bytes that the roofline costs read."""
    import torch

    mats = [v for v in env.values()
            if isinstance(v, torch.Tensor) and v.ndim == 2]
    main = mats[0] if mats else None
    return {
        "has_matrix": bool(mats),
        "bytes": sum(float(m.shape[0]) * m.shape[1] * m.element_size()
                     for m in mats),
        "shape": tuple(int(d) for d in main.shape) if main is not None
        else (),
        "dtype": main.dtype if main is not None else "f32",
        "backend": (main.device.type if main is not None
                    else kbackend._device_type(env.values())),
    }


def plan_key_digest(h: Hop) -> str:
    """The kernel key's digest of a spoof hop's plan, kept on the hop."""
    d = h.params.get("plan_digest")
    if d is None:
        d = h.params["plan_digest"] = kbackend.plan_digest(
            h.params["plan"].key())
    return d


def _leaf_hops(h: Hop) -> Dict[str, Hop]:
    """A spoof hop's leaf names and the hops that give their values (the
    outer template's X and scalar leaves; U and V are not leaves)."""
    if h.params["template"] == "outer":
        sca = h.params["scalar_names"]
        return dict(zip(["X"] + list(sca), h.inputs[:1 + len(sca)]))
    return dict(zip(h.params["leaf_names"], h.inputs))


def _same_value(a: Hop, b: Hop) -> bool:
    """Two leaf hops of one block that give the same value: one hop, or
    two reads of one variable (a block's treads read its entry values)."""
    return a is b or (a.op == "tread" and b.op == "tread"
                      and a.name is not None and a.name == b.name)


def hop_variant(h: Hop, is_scalar: Optional[Callable[[Hop], bool]] = None):
    """The build.Variant of a spoof hop's source, from its inputs, kept in
    its params (assign_variants sets it for a compiled program): the
    leaves whose hops give scalars (`is_scalar`, Hop.is_scalar when None),
    and for the cell and multi-aggregate templates each leaf whose hop
    gives the same value as an earlier leaf's (the first such), in the
    plan's input order; a multi-aggregate hop's aggregates."""
    from systemml_tpu_torch.codegen.build import Variant

    hit = h.params.get("variant")
    if hit is not None and is_scalar is None:
        return hit
    is_scalar = is_scalar or (lambda x: x.is_scalar)
    t = h.params["template"]
    by_name = _leaf_hops(h)
    order = [nm for nm in h.params["plan"].input_names() if nm in by_name]
    scalars = frozenset(nm for nm in order if is_scalar(by_name[nm]))
    aliases: List[Tuple[str, str]] = []
    if t in ("cell", "multiagg"):
        firsts: List[str] = []
        for nm in order:
            if nm in scalars:
                continue
            tgt = next((f for f in firsts
                        if _same_value(by_name[f], by_name[nm])), None)
            if tgt is None:
                firsts.append(nm)
            else:
                aliases.append((nm, tgt))
    aggs = tuple(h.params["aggs"]) if t == "multiagg" else ()
    hit = h.params["variant"] = Variant(aggs, scalars, tuple(aliases))
    return hit


def _scope_blocks(blocks):
    """Every basic block of one scope (a program's main body or one
    function's), predicates included; its for-loop variables; and its
    live-in variables: those that some path may read before the scope
    writes them (the program's inputs, a function's parameters)."""
    from systemml_tpu_torch.runtime.program import (BasicBlock, ForBlock,
                                                    IfBlock, WhileBlock,
                                                    _predicates)

    out: List = []
    loop_vars: Set[str] = set()
    live_in: Set[str] = set()

    def walk(bs, defined: Set[str]) -> Set[str]:
        """Walks bs with `defined` written on every path before it;
        returns what is written on every path after it."""
        defined = set(defined)
        for b in bs:
            for p in _predicates(b):
                out.append(p.block)
                live_in.update(p.block.hops.reads - defined)
            if isinstance(b, BasicBlock):
                out.append(b)
                live_in.update(b.hops.reads - defined)
                defined |= set(b.hops.writes)
            elif isinstance(b, IfBlock):
                defined = walk(b.if_body, defined) & walk(b.else_body,
                                                          defined)
            elif isinstance(b, ForBlock):
                loop_vars.add(b.var)
                walk(b.body, defined | {b.var})
            elif isinstance(b, WhileBlock):
                walk(b.body, defined)
        return defined

    walk(blocks, set())
    return out, loop_vars, live_in


def scalar_test(blocks, params: Dict[str, bool]) -> Callable[[Hop], bool]:
    """Whether a hop of this scope gives a scalar. A hop whose dt is
    "scalar" does, and a literal; an elementwise op does when its inputs
    do; a read of a variable does when the variable is a parameter
    declared scalar (`params`: name -> declared scalar) or a for-loop
    variable, or is not live-in, and every write of it in the scope does
    (a fixpoint over the scope's writes, from the optimistic start). The
    hop builder leaves every read's dt "matrix", so the reads need this."""
    bbs, loop_vars, live_in = _scope_blocks(blocks)
    writes: Dict[str, List[Hop]] = {}
    for bb in bbs:
        for name, hop in bb.hops.writes.items():
            writes.setdefault(name, []).append(hop)
    known = {v for v, sc in params.items() if sc} | loop_vars
    candidates = known | (set(writes) - live_in - set(params))
    holds: Set[str] = set(candidates)

    def test(h: Hop, memo: Dict[int, bool]) -> bool:
        hit = memo.get(id(h))
        if hit is None:
            if h.op == "lit":
                hit = not isinstance(h.value, str)
            elif h.op == "tread":
                hit = h.name in holds
            elif h.op.startswith(("b(", "u(")):
                hit = all(test(c, memo) for c in h.inputs)
            else:
                hit = h.dt == "scalar"
            memo[id(h)] = hit
        return hit

    while True:
        memo: Dict[int, bool] = {}
        new = {v for v in candidates
               if all(test(h, memo) for h in writes.get(v, ()))}
        if new == holds:
            break
        holds = new
    return lambda h: test(h, {})


def assign_variants(program) -> None:
    """Sets the build.Variant of every spoof hop of a compiled program
    (hop_variant), its scalar leaves found by scalar_test over the hop's
    scope: the program's body, or its function's."""
    from systemml_tpu_torch.hops.hop import postorder
    from systemml_tpu_torch.lang import ast as A

    scopes = [(program.blocks, {})]
    for fb in program.functions.values():
        scopes.append((fb.blocks, {p.name: p.data_type == A.DataType.SCALAR
                                   for p in fb.fn_def.inputs}))
    for blocks, params in scopes:
        is_scalar = scalar_test(blocks, params)
        for bb in _scope_blocks(blocks)[0]:
            for h in postorder(bb.hops.roots()):
                if h.op == "spoof":
                    hop_variant(h, is_scalar)


def execute_spoof(h: Hop, arg_values: List) -> object:
    from systemml_tpu_torch.compiler.lower import current_region

    t = h.params["template"]
    plan: CNode = h.params["plan"]
    run = current_region()
    if run is not None:
        run.check_spoof_numbers(h, arg_values)
    digest = plan_key_digest(h)
    # the memo selector's fused/alt modeled-time ratio rides along as a
    # feature of the learned cost model (memo.MemoEntry.cost_ratio)
    cost_ratio = h.params.get("cost_ratio")
    if t == "outer":
        # inputs: X, the scalar leaves, U, V (SpoofCompiler._apply)
        sca = h.params["scalar_names"]
        extra = dict(zip(sca, arg_values[1:1 + len(sca)]))
        x = arg_values[0]
        u, v = ensure_dense(arg_values[-2]), ensure_dense(arg_values[-1])
        if is_sparse(x) or is_ell(x):
            # sampled on X's stored cells when the plan keeps zeros in X
            # (f(0, uv) == 0); otherwise X densifies, the only correct way
            r = _outer_sampled(plan, x, u, v, extra)
            if r is not None:
                return r
        x = ensure_dense(x)
        m, n = x.shape
        ctx = {"has_matrix": True, "shape": (int(m), int(n)),
               "bytes": float(m * n + m * u.shape[1]
                              + n * v.shape[1]) * x.element_size(),
               "cost_ratio": cost_ratio}
        return kbackend.dispatch(
            "spoof_outer", (plan, x, u, v, extra, hop_variant(h)),
            shape=(m, n, u.shape[1]), dtype=x.dtype,
            config={"plan": digest}, ctx=ctx, backend=x.device.type)
    names = h.params["leaf_names"]
    # a sparse leaf of a cell, row or multi-aggregate plan densifies, as
    # in the JAX package (its _prep)
    env = {nm: ensure_dense(v) for nm, v in zip(names, arg_values)}
    ctx = _spoof_ctx(env)
    ctx["cost_ratio"] = cost_ratio
    backend = ctx.pop("backend")
    if t == "cell":
        agg = h.params.get("agg")
        return kbackend.dispatch(
            "spoof_cell", (plan, names, agg, env, hop_variant(h)),
            shape=ctx["shape"], dtype=ctx["dtype"],
            config={"plan": digest, "agg": agg}, ctx=ctx, backend=backend)
    if t == "row":
        return kbackend.dispatch(
            "spoof_row", (plan, names, h.params["row_agg"], env,
                          hop_variant(h)),
            shape=ctx["shape"], dtype=ctx["dtype"],
            config={"plan": digest, "row_agg": h.params["row_agg"]},
            ctx=ctx, backend=backend)
    if t == "multiagg":
        return kbackend.dispatch(
            "spoof_multiagg", (plan, names, h.params["aggs"], env,
                               hop_variant(h)),
            shape=ctx["shape"], dtype=ctx["dtype"],
            config={"plan": digest, "aggs": tuple(h.params["aggs"])},
            ctx=ctx, backend=backend)
    raise ValueError(f"unknown spoof template {t!r}")


# (plan key, scalar leaves) -> whether the outer plan keeps zeros in X
_ZERO_PRESERVING: Dict[tuple, bool] = {}


def _outer_zero_preserving(plan: CNode, extra) -> bool:
    """The JAX package's probe: the plan at X = 0 over UV = linspace(-3, 3,
    17) is 0 everywhere. Taken on the host in fp64 and cached per plan and
    scalar values, so that a loop region captures no host read; a scalar
    leaf that is a device value is read once (a host read, which refuses a
    loop region before its capture)."""
    import torch

    from systemml_tpu_torch.codegen.cplan import emit
    from systemml_tpu_torch.compiler.lower import _host_read

    host = {}
    for nm, val in extra.items():
        if isinstance(val, torch.Tensor):
            val = _host_read(val, "a scalar leaf of a sampled outer plan")
        host[nm] = float(val)
    key = (plan.key(), tuple(sorted(host.items())))
    ok = _ZERO_PRESERVING.get(key)
    if ok is None:
        env = dict(host)
        env["X"] = torch.zeros(17, dtype=torch.float64)
        env["UV"] = torch.linspace(-3.0, 3.0, 17, dtype=torch.float64)
        try:
            z = torch.as_tensor(emit(plan, env), dtype=torch.float64)
            ok = bool(torch.all(torch.abs(z) < 1e-12))
        except (KeyError, ValueError, RuntimeError):
            ok = False
        _ZERO_PRESERVING[key] = ok
    return ok


def _outer_sampled(plan: CNode, x, u, v, extra):
    """The outer template over a sparse or ELL X, sampled at X's stored
    cells (SDDMM style): sum over them of the plan on X's values and
    UV = U %*% t(V) sampled there, one rank column at a time
    (runtime/sparse._uv), without K5 or the (m, n) product. None when
    the plan is not zero-preserving in X: the cells outside the pattern
    would then contribute, and only the dense evaluation is right. ELL
    pad slots hold X == 0, which zero-preservation sends to 0."""
    import torch

    from systemml_tpu_torch.codegen.cplan import emit
    from systemml_tpu_torch.runtime import sparse as spm

    if not _outer_zero_preserving(plan, extra):
        return None
    env = dict(extra)
    env["X"] = x.val if is_ell(x) else x.data
    env["UV"] = spm._uv(x, u, v)
    return torch.sum(emit(plan, env))


def program_plans(program) -> List[Tuple[str, CNode, object]]:
    """(template, plan, build.Variant) of every spoof hop of a compiled
    program, predicates included, each distinct source once: the kernels
    that build.build_plans compiles before the program runs."""
    from systemml_tpu_torch.runtime.program import iter_spoof_hops

    seen: Dict[Tuple, Tuple[str, CNode, object]] = {}
    for h in iter_spoof_hops(program):
        t, v = h.params["template"], hop_variant(h)
        seen.setdefault((t, h.params["plan"].key(), v),
                        (t, h.params["plan"], v))
    return list(seen.values())
