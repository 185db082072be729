# Copy of systemml_tpu/hops/layout.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch; a mutated block's analysis is dropped
# for a lazy re-analysis, as the port's BasicBlock analyses on demand.
"""Layout propagation over DNN hop chains.

An analog of TVM's layout selection for conv workloads (arxiv
1802.04799): conv/pool ops compute internally in NHWC where
ops/dnn.device_layout says so
(ops/dnn.device_layout), but every op converting its flattened-2D
(N, C*H*W) boundary form to NHWC and back would materialize a transpose
pair PER OP. This pass walks each block's hop DAG and finds chains of
layout-capable ops — conv2d -> bias_add -> relu(max) -> max_pool and
residual-add variants — whose intermediate values never leave the block,
then annotates the call hops with ``nhwc_out`` / ``nhwc_in`` params so
the value flows between them as a raw 4-D NHWC tensor: the to/from-NHWC
conversions CANCEL between adjacent layers instead of materializing per
op (ops/dnn.py honors the annotations; every transpose that still
materializes is byte-counted into `-stats`).

Safety rules (each violation removes a hop from the NHWC value set):

* only ops whose NHWC geometry is STATICALLY known may start a chain
  (conv2d/max_pool/avg_pool with literal shape lists); bias_add /
  bias_multiply and whitelisted elementwise hops may only CONTINUE one
  (a flattened-2D input does not carry H and W separately);
* a hop's value may be NHWC only when every consumer takes it in a
  data position and itself handles NHWC — a sink, slice, or any
  un-whitelisted consumer keeps the boundary form. A WRITTEN
  intermediate (DML assigns every chain step to a name) may stay NHWC:
  the symbol-table write is rerouted through an internal
  ``call:__from_nhwc`` conversion hop, so downstream consumers inside
  the block read the raw tensor while the name binds the flattened
  form — one boundary transpose, exactly what the unannotated op would
  have paid anyway (and none at all once liveness kills the name);
* binary elementwise hops (the residual add) require both matrix
  operands NHWC with the SAME (N, H, W, C) geometry, or one scalar
  operand.

Values that cross function/block boundaries (the scripts/nn layer-
function path, where shapes are runtime values) are NOT annotated; there
the per-op boundary conversions become adjacent transpose/reshape pairs
inside the one fused XLA program of the training step, which XLA's
algebraic simplifier folds. This pass is what guarantees cancellation on
the per-op (eager) path and on directly-chained builtin calls, where no
surrounding jit exists to fold them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from systemml_tpu_torch.hops.builder import BlockHops
from systemml_tpu_torch.hops.hop import Hop, postorder

# ops that can START a chain: geometry comes from their literal params
_STARTERS = {"call:conv2d", "call:max_pool", "call:avg_pool"}
# ops that can CONTINUE a chain (NHWC in -> NHWC out, geometry preserved)
_CONTINUERS = {"call:bias_add", "call:bias_multiply"}
# elementwise hops that pass NHWC through untouched (relu is b(max) with
# a scalar 0 in DML; residual adds are b(+) of two conv outputs)
_ELEMENTWISE = {"b(+)", "b(-)", "b(*)", "b(/)", "b(min)", "b(max)",
                "u(sqrt)", "u(exp)", "u(log)", "u(abs)", "u(sign)",
                "u(round)", "u(floor)", "u(ceil)", "u(tanh)",
                "u(sigmoid)"}


def _lit_ints(h: Optional[Hop]) -> Optional[List[int]]:
    """[N,C,H,W]-style shape list with all-literal entries, else None."""
    if h is None:
        return None
    if h.op in ("call:list", "elist"):
        out = []
        for c in h.inputs:
            if c.op != "lit" or isinstance(c.value, (bool, str)):
                return None
            out.append(int(c.value))
        return out
    if h.op == "lit" and not isinstance(h.value, (bool, str)):
        return [int(h.value)]
    return None


def _named_inputs(h: Hop) -> Tuple[List[Hop], Dict[str, Hop]]:
    names = h.params.get("argnames") or [None] * len(h.inputs)
    pos = [c for n, c in zip(names, h.inputs) if n is None]
    named = {n: c for n, c in zip(names, h.inputs) if n is not None}
    return pos, named


def _nhwc_geometry(h: Hop) -> Optional[Tuple[int, int, int, int]]:
    """The (N, Hout, Wout, C) an NHWC-producing starter would emit, or
    None when the geometry is not statically known."""
    from systemml_tpu_torch.ops.dnn import out_dim

    pos, named = _named_inputs(h)
    ish = _lit_ints(named.get("input_shape"))
    if ish is None or len(ish) != 4:
        return None
    n, c, hi, wi = ish
    stride = _lit_ints(named.get("stride")) or [1, 1]
    padding = _lit_ints(named.get("padding")) or [0, 0]
    if h.op == "call:conv2d":
        fsh = _lit_ints(named.get("filter_shape"))
        groups = _lit_ints(named.get("groups")) or [1]
        if fsh is None or len(fsh) != 4 or groups[0] != 1:
            return None
        f, _ci, hf, wf = fsh
        return (n, out_dim(hi, hf, stride[0], padding[0]),
                out_dim(wi, wf, stride[1], padding[1]), f)
    psize = _lit_ints(named.get("pool_size")) or [1, 1]
    return (n, out_dim(hi, psize[0], stride[0], padding[0]),
            out_dim(wi, psize[1], stride[1], padding[1]), c)


def _data_input(h: Hop) -> Optional[Hop]:
    """The first positional (data) operand of a DNN call hop."""
    pos, _ = _named_inputs(h)
    return pos[0] if pos else None


def _accepts_nhwc(consumer: Hop, operand: Hop, nhwc: Set[int],
                  geo: Dict[int, Tuple[int, int, int, int]]) -> bool:
    """May `consumer` take `operand` as a raw NHWC tensor?"""
    if consumer.op in _STARTERS or consumer.op in _CONTINUERS:
        if _data_input(consumer) is not operand:
            return False  # filter/bias operand positions stay flattened
        if consumer.op in _STARTERS:
            # the consumer's declared input geometry must match what the
            # producer emits, or the flattened convention is violated
            pos, named = _named_inputs(consumer)
            ish = _lit_ints(named.get("input_shape"))
            g = geo.get(operand.id)
            if ish is None or g is None or len(ish) != 4:
                return False
            n, c, hi, wi = ish
            if (n, hi, wi, c) != g:
                return False
        return operand.id in nhwc
    if consumer.op in _ELEMENTWISE:
        return consumer.id in nhwc
    return False


def propagate_block_layout(blk: BlockHops) -> Tuple[int, bool]:
    """Annotate one block's hop DAG; returns (edges, mutated): the
    number of producer->consumer NHWC edges created, and whether the
    block was changed AT ALL — a write-only NHWC producer creates zero
    edges yet still gets nhwc_out + a rerouted write, and the caller
    must re-analyze the block whenever anything changed."""
    roots = list(blk.writes.values()) + list(blk.sinks)
    order = postorder(roots)
    consumers: Dict[int, List[Hop]] = {}
    sink_ids = {s.id for s in blk.sinks}
    for h in order:
        for c in h.inputs:
            consumers.setdefault(c.id, []).append(h)

    # ---- phase 1 (bottom-up): hops structurally able to carry NHWC ----
    nhwc: Set[int] = set()
    geo: Dict[int, Tuple[int, int, int, int]] = {}
    by_id: Dict[int, Hop] = {}
    for h in order:
        by_id[h.id] = h
        if h.op in _STARTERS:
            g = _nhwc_geometry(h)
            if g is not None:
                nhwc.add(h.id)
                geo[h.id] = g
        elif h.op in _CONTINUERS:
            d = _data_input(h)
            if d is not None and d.id in nhwc:
                nhwc.add(h.id)
                geo[h.id] = geo[d.id]
        elif h.op in _ELEMENTWISE:
            mats = [c for c in h.inputs if c.dt == "matrix"
                    and c.op != "lit"]
            scalars_ok = all(c.dt == "scalar" or c.op == "lit"
                             for c in h.inputs if c not in mats)
            gs = {geo.get(c.id) for c in mats}
            if (mats and scalars_ok and all(c.id in nhwc for c in mats)
                    and len(gs) == 1 and None not in gs):
                nhwc.add(h.id)
                geo[h.id] = geo[mats[0].id]

    # ---- phase 2 (fixpoint): every consumer must accept the raw form ----
    changed = True
    while changed:
        changed = False
        for hid in list(nhwc):
            h = by_id[hid]
            if hid in sink_ids:
                nhwc.discard(hid)
                changed = True
                continue
            for consumer in consumers.get(hid, ()):  # unconsumed: dead hop
                if not _accepts_nhwc(consumer, h, nhwc, geo):
                    nhwc.discard(hid)
                    changed = True
                    break
            if hid not in nhwc:
                continue
            # a continuer/elementwise whose upstream got evicted loses
            # its own NHWC-ness (its input arrives flattened again)
            if h.op in _CONTINUERS:
                d = _data_input(h)
                if d is None or d.id not in nhwc:
                    nhwc.discard(hid)
                    changed = True
            elif h.op in _ELEMENTWISE:
                mats = [c for c in h.inputs if c.dt == "matrix"
                        and c.op != "lit"]
                if not all(c.id in nhwc for c in mats):
                    nhwc.discard(hid)
                    changed = True

    # ---- phase 3: write the annotations. A call hop may consume NHWC
    # (nhwc_in) even when its own value stays flattened (it converts
    # back at its output — the chain's exit); nhwc_out marks members of
    # the NHWC value set. Elementwise hops need no params: they simply
    # operate on whatever 4-D value flows through.
    edges = 0
    for h in order:
        if h.op in _STARTERS or h.op in _CONTINUERS:
            if h.id in nhwc:
                h.params["nhwc_out"] = True
            d = _data_input(h)
            if d is not None and d.id in nhwc:
                h.params["nhwc_in"] = True
                edges += 1
        elif h.op in _ELEMENTWISE and h.id in nhwc:
            edges += sum(1 for c in h.inputs
                         if c.dt == "matrix" and c.id in nhwc)

    # written intermediates that stayed NHWC: reroute the symbol-table
    # binding through a conversion hop (one per value hop — aliased
    # names share it) so the NAME binds the flattened boundary form
    # while in-block consumers keep the raw tensor
    conv_hops: Dict[int, Hop] = {}
    for name, wh in list(blk.writes.items()):
        if wh.id in nhwc:
            cv = conv_hops.get(wh.id)
            if cv is None:
                cv = Hop("call:__from_nhwc", inputs=[wh], dt="matrix")
                cv.rows, cv.cols, cv.nnz = wh.rows, wh.cols, wh.nnz
                conv_hops[wh.id] = cv
            blk.writes[name] = cv
    if edges:
        from systemml_tpu_torch.obs import trace as obs
        from systemml_tpu_torch.utils import stats as stats_mod

        st = stats_mod.current()
        if st is not None:
            st.count_estim("dnn_nhwc_edges", edges)
        obs.instant("layout_chain", obs.CAT_COMPILE, edges=edges,
                    hops=len(nhwc))
    return edges, bool(nhwc or conv_hops)


def propagate_program_layout(prog) -> int:
    """Run the pass over every basic block of a compiled program (main +
    function bodies); returns total annotated edges. Called from
    compile_program AFTER rewrites/size-propagation (annotations change
    the runtime value shapes of interior hops, which no earlier pass may
    observe) and only when the device layout is NHWC."""
    from systemml_tpu_torch.ops.dnn import device_layout

    if device_layout() != "NHWC":
        return 0
    from systemml_tpu_torch.runtime.program import iter_basic_blocks

    total = 0
    for bb in iter_basic_blocks(prog):
        n, mutated = propagate_block_layout(bb.hops)
        if mutated:
            # the pass annotated hops and may have rerouted writes
            # through conversion hops: refresh the block's fused/host
            # partition even when no chain EDGE was created (a
            # write-only NHWC producer mutates with edges == 0)
            bb._analysis = None
        total += n
    return total
