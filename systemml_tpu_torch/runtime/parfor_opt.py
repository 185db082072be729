"""Cost-based ParFor optimizer.

Port of systemml_tpu/runtime/parfor_opt.py. What differs: the devices
are the CUDA devices when the config's device is "cuda" and the one CPU
otherwise (one device: AUTO picks local; on one card with no par set,
k=1), the roofline is the card's
(hops/cost.HwProfile.h100) or the host's, and mode "remote" raises
NotImplementedError: remote parfor waits for ROADMAP queue 1, item 9b.

TPU-native equivalent of the reference's rule-based parfor optimizer
(parfor/opt/OptimizerRuleBased.java, 2,696 LoC — decides exec mode,
degree of parallelism, task partitioner, data partitioning and result
merge from memory/cost estimates over the OptTree; invoked by
OptimizationWrapper before ParForProgramBlock.execute).

Here the decisions collapse onto the TPU execution landscape:

* exec mode `seq | local | device | remote` — costed with the roofline
  model (hops/cost.py) over the loop body's HOP DAGs, with CONCRETE
  dims propagated from the runtime symbol table (the dynamic-
  recompilation advantage: by parfor execution time every input shape
  is known).
    - seq: n * iter_time, no overhead;
    - local (k threads, one device): device work serializes on the one
      chip, only host/dispatch time overlaps — the model splits
      iteration time into device time (not parallelizable) and
      dispatch/host time (parallelizable k-way);
    - device (one worker per chip): true n_devices-way parallelism,
      charged the one-time per-device replica broadcast of shared
      read inputs (reference: RemoteParForSpark broadcast) and gated
      on the replica set fitting the per-device HBM budget;
    - remote (worker processes): only entered on explicit request
      (mode="remote") — process spawn costs seconds and shipping is
      validated by runtime/remote.shippable.
* degree of parallelism k — devices for device mode, else
  min(requested, cpu budget, iterations).
* task partitioner `static | factoring` — static (one contiguous chunk
  per worker, minimal queue overhead) when the body's per-iteration
  cost is provably uniform (straight-line: no data-dependent control
  flow); factoring (reference: TaskPartitionerFactoring) otherwise.

The chosen plan is surfaced through Statistics (estim counters) and
carried back to the ParForBlock for -explain runtime output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set

import numpy as np

from systemml_tpu_torch.hops.cost import HwProfile, estimate_dag_cost


@dataclass
class ParForPlan:
    mode: str                    # seq | local | device | remote
    k: int
    partitioner: str             # static | factoring | naive
    iter_time_s: float           # roofline estimate, -1 when unknown
    reason: str

    def describe(self) -> str:
        it = (f"{self.iter_time_s * 1e3:.2f}ms/iter"
              if self.iter_time_s >= 0 else "iter cost unknown")
        return (f"mode={self.mode} k={self.k} "
                f"partitioner={self.partitioner} [{it}; {self.reason}]")


def _shape_dtype(v):
    """(shape, dtype) without resolving pool handles — CacheableMatrix
    exposes both directly; resolve() would restore evicted arrays from
    host/disk just to plan, pure wasted I/O."""
    shp = getattr(v, "shape", None)
    return shp, getattr(v, "dtype", None)


def _runtime_dims(ec, names: Set[str]):
    dims = {}
    for n in names:
        v = ec.vars.get(n)
        if v is None:
            continue
        shp, _ = _shape_dtype(v)
        if shp is not None and len(shp) == 2:
            dims[n] = (int(shp[0]), int(shp[1]))
        elif shp is not None and len(shp) == 0 \
                or isinstance(v, (bool, int, float)):
            dims[n] = (0, 0)
    return dims


def _body_blocks(blocks, out, uniform):
    from systemml_tpu_torch.runtime import program as P

    for b in blocks:
        if isinstance(b, P.BasicBlock):
            out.append(b)
        elif isinstance(b, P.IfBlock):
            uniform[0] = False  # data-dependent branch: variable cost
            _body_blocks(b.if_body, out, uniform)
            _body_blocks(b.else_body, out, uniform)
        elif isinstance(b, P.WhileBlock):
            uniform[0] = False  # data-dependent trip count
            _body_blocks(b.body, out, uniform)
        elif isinstance(b, P.ForBlock):
            _body_blocks(b.body, out, uniform)


def _body_cost(pb, ec, body_reads: Set[str], hw: HwProfile,
               blocks: Optional[List] = None):
    """(iteration_time_s, dispatch_s): roofline time of ONE iteration
    with concrete runtime dims and the dispatch/host share. `blocks`
    reuses the caller's _body_blocks scan."""
    from systemml_tpu_torch.hops.ipa import propagate_sizes

    if blocks is None:
        blocks = []
        _body_blocks(pb.body, blocks, [True])
    dims = _runtime_dims(ec, body_reads)
    dims[pb.var] = (0, 0)  # the loop variable is a scalar
    t = 0.0
    dispatch = 0.0
    known = bool(blocks)
    for b in blocks:
        roots = list(b.hops.writes.values()) + list(b.hops.sinks)
        try:
            propagate_sizes(roots, dict(dims))
            pc = estimate_dag_cost(roots, hw)
        except Exception:  # except-ok: cost estimate optional; unknown is modeled
            known = False
            continue
        if pc.known:
            t += pc.time_s
        else:
            # ONE uncostable block makes the whole estimate unusable —
            # summing only the known blocks would report a heavy loop as
            # microseconds and keep it off the mesh
            known = False
        dispatch += hw.dispatch_us * 1e-6
    return (t if known else -1.0), dispatch


def devices() -> List:
    """The devices a parfor plans over: every CUDA device when the config
    runs on the card, else the one CPU."""
    import torch

    from systemml_tpu_torch.utils.config import get_config

    if get_config().device == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def optimize(pb, ec, iters: List, k_req: int, body_reads: Set[str],
             mode_req: str = "auto", explicit_k: bool = False) -> ParForPlan:
    """Pick the parfor execution plan (the OptimizerRuleBased analog).
    Explicit user choices (mode=..., par=...) are respected; AUTO is
    cost-based. `explicit_k` marks a user-pinned par=...; otherwise
    device mode takes one worker per device regardless of the host
    cpu-count-derived default."""
    from systemml_tpu_torch.utils.config import get_config

    n = len(iters)
    devs = devices()
    hw = HwProfile.detect()
    # one card and no par set by the script or the config: one worker.
    # Eight lanes share the card's SMs and each region entry
    # (runtime/loopfuse.py), and ran slower than one on every parfor
    # measured (StepGLM, Univar-Stats; PERF.md section 6); a par= still
    # holds
    one_card = (not explicit_k and get_config().parfor_par <= 0
                and len(devs) == 1 and devs[0].type == "cuda")
    if one_card:
        k_req = 1

    # the partitioner only needs the cheap uniformity scan; the full
    # roofline body costing is deferred to the AUTO path (explicit-mode
    # parfors in hot outer loops would pay it for nothing)
    blocks: List = []
    uniform = [True]
    _body_blocks(pb.body, blocks, uniform)
    partitioner = "static" if uniform[0] else "factoring"
    iter_t = -1.0
    dispatch_t = 0.0

    def dev_k():
        return min(k_req, len(devs)) if explicit_k else len(devs)

    # ---- explicit modes pass through (validated) ------------------------
    if mode_req in ("seq", "local"):
        return ParForPlan(mode_req, max(1, min(k_req, n)), partitioner,
                          iter_t, "user-requested")
    if mode_req == "remote":
        raise NotImplementedError(
            "parfor mode=\"remote\" (worker processes) waits for ROADMAP "
            "queue 1, remote parfor (item 9b)")
    if mode_req == "device":
        return ParForPlan("device", dev_k(), partitioner, iter_t,
                          "user-requested")

    # ---- AUTO: cost the candidates --------------------------------------
    iter_t, dispatch_t = _body_cost(pb, ec, body_reads, hw, blocks)
    cfg = get_config()
    if len(devs) <= 1 or n < 2:
        return ParForPlan("local", max(1, min(k_req, n)), partitioner,
                          iter_t, "single device / single iteration"
                          + ("; one card, par unset: k=1" if one_card
                             else ""))
    if iter_t < 0:
        # unknown body cost: keep the conservative memory-gated rule
        repl = _replica_bytes(ec, body_reads)
        cap = cfg.mem_budget_bytes or hw.hbm_bytes
        if repl > cfg.mem_util_factor * cap:
            return ParForPlan("local", max(1, min(k_req, n)), partitioner,
                              iter_t, "cost unknown; replicas bust budget")
        return ParForPlan("device", dev_k(), partitioner, iter_t,
                          "cost unknown; replicas fit")

    nd = len(devs)
    repl = _replica_bytes(ec, body_reads)
    cap = cfg.mem_budget_bytes or hw.hbm_bytes
    # h2d: replica broadcast of shared inputs to the other nd-1 devices
    h2d_bw = hw.hbm_bw / 8.0  # host link is ~an order under HBM
    t_seq = n * iter_t
    # one chip: device time serializes; only dispatch overlaps k-way
    # (iter_t already includes one iteration's dispatch share)
    k_local = max(1, min(k_req, n))
    t_local = (n * max(iter_t - dispatch_t, 0.0)
               + n * dispatch_t / k_local)
    dk = min(dev_k(), n)  # workers the plan will ACTUALLY run with
    t_device = (float(np.ceil(n / dk)) * iter_t
                + repl * (dk - 1) / h2d_bw
                + dk * dispatch_t)
    feasible_device = repl <= cfg.mem_util_factor * cap and dk > 1
    cands = [(t_seq, 1, "seq", max(1, min(k_req, n))),
             (t_local, 0, "local", k_local)]
    if feasible_device:
        cands.append((t_device, 2, "device", dk))
    t, _, mode, k = min(cands)
    why = (f"seq={t_seq * 1e3:.1f}ms local={t_local * 1e3:.1f}ms "
           f"device={'%.1fms' % (t_device * 1e3) if feasible_device else 'infeasible'}")
    return ParForPlan(mode, k, partitioner, iter_t, why)


def _replica_bytes(ec, body_reads: Set[str]) -> int:
    total = 0
    for n in body_reads:
        v = ec.vars.get(n)
        if v is None:
            continue
        shp, dt = _shape_dtype(v)
        if shp is not None and dt is not None:
            # a torch dtype carries its itemsize; a numpy one through
            # np.dtype
            itemsize = getattr(dt, "itemsize", None) or np.dtype(dt).itemsize
            total += int(np.prod(shp)) * itemsize
    return total
