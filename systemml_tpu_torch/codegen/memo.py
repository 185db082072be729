# Copy of systemml_tpu/codegen/memo.py for the PyTorch port: the same code, with its
# imports pointed at systemml_tpu_torch.
"""CPlan memo table + cost-based fusion plan selection.

TPU-native equivalent of the reference's codegen plan-selection pair:
CPlanMemoTable (hops/codegen/template/CPlanMemoTable.java:46) records every
template match per hop, and PlanSelectionFuseCostBasedV2
(hops/codegen/opt/PlanSelectionFuseCostBasedV2.java:1) partitions the memo
into connected components, enumerates compatible plan subsets, and picks
the cheapest by a compute+IO cost model — including the "don't fuse" arm.

The TPU translation: a fused spoof region becomes one Pallas kernel (or a
jnp subtree XLA fuses); the alternative arm is XLA's own default fusion of
the same region. On TPU the two differ in exactly two measurable ways:

- **materialization**: the outer template computes U @ t(V) tile-wise and
  never writes the m*n product to HBM; XLA-default materializes it. When
  that product is *also* consumed outside the region it materializes
  anyway, so the outer kernel's 2mkn FLOP recompute is pure waste — the
  cell-with-leaf variant (read the materialized product) wins.
- **recompute**: a maximal fused region that swallows an interior hop with
  consumers outside the region recomputes it inside the kernel while the
  external consumer forces a materialized copy regardless. The trimmed
  variant (interior hop becomes a kernel input) avoids the double compute.

Costs come from the same roofline HwProfile as the rest of the planner
(hops/cost.py). Unknown dims yield NaN costs; selection then falls back to
the structural preference order (multiagg > outer > cell/row, maximal
region) that matched the pre-costed behavior.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from systemml_tpu_torch.codegen.cplan import CNode
from systemml_tpu_torch.hops.cost import HwProfile
from systemml_tpu_torch.hops.hop import Hop, postorder


@dataclass
class MemoEntry:
    """One candidate fusion plan (reference: MemoTableEntry,
    CPlanMemoTable.java:486 — template type + input refs per hop)."""

    template: str                    # 'cell' | 'row' | 'multiagg' | 'outer'
    roots: List[Hop]                 # agg hops the spoof replaces
    cover: Set[int]                  # interior hop ids fused into the kernel
    plan: CNode
    leaves: List[Tuple[str, Hop]]    # (input name, hop) kernel inputs
    nops: int                        # fused cell-op count
    extra: dict = field(default_factory=dict)
    # filled by the selector
    fused_t: float = float("nan")    # modeled time of the fused kernel
    alt_t: float = float("nan")      # modeled time of the XLA-default arm

    @property
    def footprint(self) -> Set[int]:
        return self.cover | {r.id for r in self.roots}

    def cost_ratio(self) -> Optional[float]:
        """Modeled fused/alt time ratio — the planner's own opinion of
        how much the fusion should win. Threaded through the spoof hop
        into the learned kernel cost model (codegen/costmodel.py) as
        the analytic-cost-ratio feature; None before costing or when
        either arm is unknown (NaN)."""
        if (self.fused_t == self.fused_t and self.alt_t == self.alt_t
                and self.alt_t > 0):
            return self.fused_t / self.alt_t
        return None

    @property
    def known(self) -> bool:
        return self.fused_t == self.fused_t and self.alt_t == self.alt_t

    @property
    def saving(self) -> float:
        return self.alt_t - self.fused_t


class MemoTable:
    """All candidate plans for one block DAG, plus the consumer map used
    for recompute/materialization reasoning (the reference tracks the same
    via Hop.getParent() in TemplateUtils.isValidSingleOperation checks)."""

    def __init__(self, entries: List[MemoEntry],
                 consumers: Dict[int, Set[int]],
                 materialized: Set[int]):
        self.entries = entries
        self.consumers = consumers        # hop id -> consumer hop ids
        self.materialized = materialized  # hop ids that are block writes/sinks

    def ext_consumed(self, hop_id: int, footprint: Set[int]) -> bool:
        """True if `hop_id` must exist outside the fused region: it is a
        block write (live-out) or has a consumer hop outside the region."""
        if hop_id in self.materialized:
            return True
        return any(c not in footprint for c in self.consumers.get(hop_id, ()))


def build_consumers(roots: List[Hop]) -> Dict[int, Set[int]]:
    cons: Dict[int, Set[int]] = {}
    for h in postorder(roots):
        for c in h.inputs:
            cons.setdefault(c.id, set()).add(h.id)
    return cons


# --------------------------------------------------------------------------
# costing
# --------------------------------------------------------------------------

def _cells(h: Hop) -> float:
    c = h.cells()
    return float(c) if c >= 0 else float("nan")


def cost_entry(e: MemoEntry, memo: MemoTable, hw: HwProfile,
               hop_by_id: Dict[int, Hop]) -> None:
    """Fill e.fused_t / e.alt_t.

    Time is compute + IO (additive, like the reference's
    CostEstimatorStaticRuntime sums per-instruction IO and compute) rather
    than the roofline max used for absolute estimates — max() ties every
    bandwidth-bound variant and the selector needs the FLOP differences
    (recompute, outer-product rebuild) to discriminate. The differential
    terms are the outer-product materialization, interior recompute, and
    the production charge for matmult leaves nothing else needs.
    """
    bc = hw.bytes_per_cell
    leaf_bytes = sum(_cells(h) for _, h in e.leaves if h.is_matrix) * bc
    out_cells = sum(max(_cells(r), 1.0) if r.is_matrix else 1.0
                    for r in e.roots)
    out_bytes = out_cells * bc
    max_cells = max([_cells(h) for _, h in e.leaves if h.is_matrix]
                    or [1.0])
    flops = e.nops * max_cells

    fused_f, fused_b = flops, leaf_bytes + out_bytes
    alt_f, alt_b = flops, leaf_bytes + out_bytes

    if e.template == "outer":
        mm: Hop = e.extra["mm"]
        u, vt = mm.inputs
        m, k = u.rows, u.cols
        n = vt.inputs[0].rows if vt.op == "reorg(t)" else vt.cols
        if min(m, k, n) < 0:
            e.fused_t = e.alt_t = float("nan")
            return
        mm_flops = 2.0 * m * k * n
        # quaternary negotiation: an est-sparse X leaf means
        # the outer kernel samples the product at X's nonzeros at run
        # time (compiler._outer_sampled), so cost the fused arm at the
        # sampled gather rate — the memo then prices the pattern with
        # the SAME model as the quaternary rewrite guard
        # (hops/rewrite._q_guard + hops/cost.quaternary_exploit) instead
        # of fighting it with a dense-FLOP estimate
        x_leaf = next((hh for _nm, hh in e.leaves if hh.is_matrix), None)
        if x_leaf is not None and x_leaf.est_sp >= 0.0:
            from systemml_tpu_torch.hops.cost import QUATERNARY_GATHER_OVERHEAD
            from systemml_tpu_torch.utils.config import get_config

            turn = getattr(get_config(), "sparsity_turn_point", 0.4)
            if x_leaf.est_sp < turn:
                mm_flops = min(mm_flops, QUATERNARY_GATHER_OVERHEAD * 2.0
                               * x_leaf.est_sp * m * n * k)
        prod_bytes = float(m * n) * bc
        uv_bytes = float(m * k + k * n) * bc
        # fused kernel streams U,V and recomputes tiles of U@Vt: mm FLOPs,
        # U/V reads, but never the m*n product in HBM
        fused_f += mm_flops
        fused_b += uv_bytes
        if memo.ext_consumed(mm.id, e.footprint):
            # product materializes regardless; XLA arm just re-reads it
            # while the fused arm still burns the recompute FLOPs
            alt_b += prod_bytes
        else:
            alt_f += mm_flops
            alt_b += uv_bytes + 2.0 * prod_bytes  # write + read back
    else:
        # interior recompute: covered hop also needed outside the region
        for hid in e.cover:
            if memo.ext_consumed(hid, e.footprint):
                h = hop_by_id.get(hid)
                if h is None:
                    continue
                c = _cells(h)
                # fused arm recomputes the op; both arms pay the
                # materialized copy, so only the extra FLOPs differ
                fused_f += c if c == c else float("nan")
        # production charge: a matmult leaf nothing else consumes exists
        # only to feed this region — selecting this entry (or the XLA
        # default) forces it to run, while a competing plan that fuses
        # the matmult away (outer template) never pays it. Charged to
        # both arms so the entry stays comparable across the component.
        for _nm, h in e.leaves:
            if h.op in ("ba+*", "tsmm", "mmchain") and \
                    not memo.ext_consumed(h.id, e.footprint):
                from systemml_tpu_torch.hops.cost import op_cost

                c = op_cost(h, hw)
                fused_f += c.flops
                fused_b += c.bytes
                alt_f += c.flops
                alt_b += c.bytes

    e.fused_t = fused_f / hw.peak_flops_f32 + fused_b / hw.hbm_bw
    e.alt_t = alt_f / hw.peak_flops_f32 + alt_b / hw.hbm_bw


# --------------------------------------------------------------------------
# selection
# --------------------------------------------------------------------------

# structural preference when costs are unknown — the pre-memo greedy order
_TPL_RANK = {"multiagg": 0, "outer": 1, "cell": 2, "row": 2}


def select_plans(memo: MemoTable, hw: Optional[HwProfile],
                 hop_by_id: Dict[int, Hop]) -> List[MemoEntry]:
    """Pick the winning compatible subset of candidate plans (reference:
    PlanSelectionFuseCostBasedV2.selectPlans — partition into connected
    components, enumerate, cost, prune)."""
    hw = hw or HwProfile.detect()
    for e in memo.entries:
        cost_entry(e, memo, hw, hop_by_id)

    chosen: List[MemoEntry] = []
    for comp in _components(memo.entries):
        chosen.extend(_select_component(comp, memo))
    _record_stats(memo.entries, chosen)
    return chosen


def _components(entries: List[MemoEntry]) -> List[List[MemoEntry]]:
    """Group entries whose footprints overlap (reference: the BFS over
    connected sub-DAGs in PlanSelectionFuseCostBasedV2.getConnectedSubGraphs)."""
    comps: List[Tuple[Set[int], List[MemoEntry]]] = []
    for e in entries:
        hit = [c for c in comps if c[0] & e.footprint]
        if not hit:
            comps.append((set(e.footprint), [e]))
        else:
            base = hit[0]
            for other in hit[1:]:
                base[0].update(other[0])
                base[1].extend(other[1])
                comps.remove(other)
            base[0].update(e.footprint)
            base[1].append(e)
    return [c[1] for c in comps]


def _compatible(sel: List[MemoEntry], e: MemoEntry) -> bool:
    return all(not (s.footprint & e.footprint) for s in sel)


def _select_component(comp: List[MemoEntry], memo: MemoTable
                      ) -> List[MemoEntry]:
    if not all(e.known for e in comp):
        # NaN-cost structural fallback (unknown dims): historically
        # SILENT — now an obs instant + `-stats` count (no-silent-caps
        # rule; the "Kernel backend" line shows kb_nan_cost next to the
        # runtime selector's own falls)
        _note_structural_fallback(comp)
        return _select_structural(comp)
    # exact subset enumeration — components are tiny (a handful of
    # variants per agg root); cap guards pathological DAGs
    if len(comp) > 12:
        return _select_greedy_by_cost(comp)
    roots_all: Dict[int, MemoEntry] = {}
    for e in comp:
        for r in e.roots:
            cur = roots_all.get(r.id)
            # the maximal (largest-cover) entry models the XLA-default arm
            if cur is None or len(e.cover) > len(cur.cover):
                roots_all[r.id] = e
    best: Tuple[float, List[MemoEntry]] = (float("inf"), [])
    for k in range(len(comp) + 1):
        for subset in itertools.combinations(comp, k):
            sel: List[MemoEntry] = []
            ok = True
            for e in subset:
                if not _compatible(sel, e):
                    ok = False
                    break
                sel.append(e)
            if not ok:
                continue
            covered_roots = {r.id for e in sel for r in e.roots}
            t = sum(e.fused_t for e in sel)
            # charge each unfused region's XLA-default arm once per
            # distinct representative entry, not once per root — a
            # multiagg group shares one region across several roots
            unfused = {id(e): e for rid, e in roots_all.items()
                       if rid not in covered_roots}
            t += sum(e.alt_t for e in unfused.values())
            # deterministic tie-break: prefer more fusion (Pallas wins the
            # cases the roofline can't see: fewer HLOs, better VMEM reuse)
            t -= 1e-12 * sum(e.nops for e in sel)
            if t < best[0]:
                best = (t, sel)
    return best[1]


def _select_greedy_by_cost(comp: List[MemoEntry]) -> List[MemoEntry]:
    sel: List[MemoEntry] = []
    for e in sorted(comp, key=lambda x: -x.saving):
        if e.saving >= 0 and _compatible(sel, e):
            sel.append(e)
    return sel


def _select_structural(comp: List[MemoEntry]) -> List[MemoEntry]:
    """Unknown dims: keep the historical greedy behavior — multiagg first,
    then outer, then cell/row, maximal regions, first match wins."""
    sel: List[MemoEntry] = []
    order = sorted(comp, key=lambda e: (_TPL_RANK.get(e.template, 9),
                                        -len(e.cover)))
    for e in order:
        if e.extra.get("trimmed"):
            # trimmed variants exist only to be chosen by cost
            if any(s.footprint & e.footprint for s in sel):
                continue
            full = [o for o in comp if o is not e and
                    set(r.id for r in o.roots) == set(r.id for r in e.roots)]
            if full:
                continue
        if _compatible(sel, e):
            sel.append(e)
    return sel


def _note_structural_fallback(comp: List[MemoEntry]) -> None:
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_estim("spoof_structural_fallback")
        st.count_estim("kb_nan_cost")
    if obs.recording():
        unknown = [e.template for e in comp if not e.known]
        obs.instant("kernel_fallback", obs.CAT_CODEGEN,
                    op="spoof_select", kind="structural",
                    reason="nan_cost", entries=len(comp),
                    unknown_templates=unknown)


def _record_stats(entries: List[MemoEntry], chosen: List[MemoEntry]):
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is None:
        return
    st.count_estim("spoof_candidates", len(entries))
    st.count_estim("spoof_selected", len(chosen))
    rej = [e for e in entries if e not in chosen and e.known and
           not any(set(r.id for r in e.roots) & set(r.id for r in c.roots)
                   for c in chosen)]
    if rej:
        st.count_estim("spoof_nofuse_by_cost", len(rej))
