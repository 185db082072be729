# Port of systemml_tpu/codegen/backend.py: kernel keys and their buckets,
# plan_digest, Variant, KernelFamily with template sweeps, select, run,
# dispatch, force_variant and reset_process_state, with the imports
# pointed at systemml_tpu_torch. What differs:
# - no runtime fallback: the reference catches PallasUnsupported from a
#   launched kernel and reruns the fallback variant (:445-454). Here a
#   variant's `accepts` predicate (shape, dtype, layout: what the hand
#   kernel takes) is asked before the launch; a refused call runs the
#   declared fallback, counted as kb_fallback and evented as a
#   kernel_fallback of kind "unsupported". A variant that raises raises
#   through dispatch: no `except` stands around a variant's run;
# - a key's backend is the torch device type of the call's tensors
#   ("cuda" or "cpu"), not jax.default_backend() (:467);
# - `pallas_mode` keeps its name and means "hand kernel" (use_kernel):
#   "always" forces the kernel variants (on the CPU their wrappers run
#   the plain versions), "never" the fallbacks, "auto" takes the kernels
#   on the card;
# - no measurement inside a CUDA graph capture: a key first met while
#   the current stream captures takes its memoised or analytic choice
#   and counts kb_capture_unmeasured; the choice is made once per key and
#   process under a lock, so parfor lanes and a region's graph run the
#   variant its peel ran;
# - device-time profiling of each launch (obs/profile.py) waits for
#   ROADMAP queue 1, observability (item 11).
"""Unified kernel backend: one variant registry and one selector for
every hand kernel of the port and its plain or library arms.

- every call site registers its candidate **variants** (a hand CUDA
  kernel with its run-time launch parameters, the torch composition of
  the same function, the sampled against the dense quaternary arm, ...)
  under a stable **kernel key** (op, device type, dtype, shape bucket,
  sparsity bucket, static config);
- the first call of a key selects by the **analytic** cost model (the
  roofline HwProfile the planner uses); all-NaN costs fall back to
  registration order and emit an instant;
- with tuning on (config ``codegen_tune_mode: off|online|cached``) the
  short-listed variants are **measured in-process** with the paired
  obs/ab harness, the winner replaces the analytic guess, and in
  ``cached`` mode the verdict persists to an on-disk JSON cache
  (codegen/tune.py) keyed by kernel key and device name, so that a later
  process dispatches from the cache with no measurement.

Every selection and fallback lands on the obs bus (CAT_CODEGEN events
``kernel_select`` / ``kernel_fallback`` / ``kernel_search``) and in
`-stats` (the "Kernel backend" line, kb_* counters).
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# kernel keys
# --------------------------------------------------------------------------


def shape_bucket(*dims) -> Tuple[int, ...]:
    """Per-dim next-power-of-two bucket: one tuning verdict covers every
    shape in the bucket (unknown/negative dims bucket to 0)."""
    out = []
    for d in dims:
        d = int(d) if d is not None else -1
        if d <= 0:
            out.append(0)
        else:
            out.append(1 << max(0, d - 1).bit_length())
    return tuple(out)


def sparsity_bucket(sp: Optional[float]) -> str:
    """Decade bucket of the carrier sparsity ('dense' for dense/unknown):
    selection between a sampled-gather and a dense variant flips with
    nnz/cells, so the decade is the natural cache granularity."""
    if sp is None or not (sp == sp) or sp < 0:
        return "dense"
    if sp <= 0:
        return "1e-99"
    return f"1e{math.ceil(math.log10(min(1.0, float(sp)))):d}"


def plan_digest(obj: Any) -> str:
    """Stable short digest for structural config values (CPlan keys) —
    Python's salted hash() is process-local, useless for a disk cache."""
    return hashlib.md5(repr(obj).encode()).hexdigest()[:12]


def dtype_name(dtype: Any) -> str:
    """A dtype as the key spells it: torch.float32 -> "float32"."""
    return str(dtype).replace("torch.", "")


@dataclass(frozen=True)
class KernelKey:
    op: str
    backend: str                       # torch device type: cuda | cpu
    dtype: str
    shape: Tuple[int, ...]             # shape_bucket(...)
    sparsity: str                      # sparsity_bucket(...)
    config: Tuple[Tuple[str, Any], ...]  # sorted static-config items

    def cache_str(self) -> str:
        cfg = ",".join(f"{k}={v}" for k, v in self.config)
        shp = "x".join(str(d) for d in self.shape)
        return (f"{self.op}|{self.backend}|{self.dtype}|{shp}|"
                f"{self.sparsity}|{cfg}")


def make_key(op: str, *, backend: str = "cpu", shape: Sequence[int] = (),
             dtype: Any = "f32", sparsity: Optional[float] = None,
             config: Dict[str, Any] | Sequence[Tuple[str, Any]] = ()
             ) -> KernelKey:
    items = sorted(dict(config).items()) if config else []
    return KernelKey(op, backend, dtype_name(dtype), shape_bucket(*shape),
                     sparsity_bucket(sparsity), tuple(items))


def use_kernel(backend: str) -> bool:
    """Whether the hand kernels are candidates on `backend` under
    `pallas_mode` (the reference's codegen/compiler.use_pallas)."""
    from systemml_tpu_torch.utils.config import get_config

    mode = get_config().pallas_mode
    if mode == "never":
        return False
    if mode == "always":
        return True
    return backend == "cuda"


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------


@dataclass
class Variant:
    """One candidate implementation. ``fn(ctx, *args, **kwargs)`` runs
    it; ``cost(ctx)`` returns modeled seconds (NaN = unknown);
    ``supported(ctx)`` is the static gate of selection (the mode, the
    family's dtype and shape rules); ``accepts(ctx, *args)`` is the hand
    kernel's own check of this call's shapes, dtype and layout, asked
    before the launch: a refused call runs ``fallback``. ``is_fallback``
    marks the family's always-works terminal variant.

    Swept points generated by ``KernelFamily.template`` carry ``sched``
    (the launch parameters of this point, e.g. ``{"bps": 2}``) and
    ``template`` (the base name they derive from)."""

    name: str
    fn: Callable[..., Any]
    cost: Optional[Callable[[dict], float]] = None
    supported: Optional[Callable[[dict], bool]] = None
    fallback: Optional[str] = None
    is_fallback: bool = False
    accepts: Optional[Callable[..., bool]] = None
    sched: Optional[Dict[str, Any]] = None
    template: Optional[str] = None

    def with_sched(self, ctx: dict) -> dict:
        """ctx as the variant fn/cost sees it: swept points get their
        schedule parameters injected under ``ctx["sched"]``."""
        if self.sched is None:
            return ctx
        c = dict(ctx)
        c["sched"] = dict(self.sched)
        return c


def sched_suffix(params: Dict[str, Any]) -> str:
    """Canonical, sorted ``k=v`` rendering of one schedule point — the
    stable key suffix swept variant names (and thus cache keys) embed."""
    return ",".join(f"{k}={params[k]}" for k in sorted(params))


def sched_name(base: str, params: Optional[Dict[str, Any]]) -> str:
    """Name of a swept point: ``base@k=v,...``; the empty point keeps the
    bare base name (the template's own launch configuration)."""
    if not params:
        return base
    return f"{base}@{sched_suffix(params)}"


class KernelFamily:
    """All registered variants of one logical kernel (op)."""

    def __init__(self, op: str,
                 analytic: Optional[Callable[[dict, List[str]], str]] = None):
        self.op = op
        self.variants: Dict[str, Variant] = {}
        self.order: List[str] = []      # registration order = structural pref
        self.analytic = analytic        # optional custom analytic selector

    def variant(self, name: str, *, cost=None, supported=None,
                fallback: Optional[str] = None, is_fallback: bool = False,
                accepts=None):
        def deco(fn):
            self.variants[name] = Variant(name, fn, cost, supported,
                                          fallback, is_fallback, accepts)
            self.order.append(name)
            return fn
        return deco

    def template(self, name: str, sweep, *, cost=None, supported=None,
                 fallback: Optional[str] = None, accepts=None):
        """Register a **parameterized schedule space**: one variant
        template plus its sweep. Each point becomes a distinct Variant
        whose name derives from the template via ``sched_name``, so
        tuning-cache entries and force_variant address single points.
        ``sweep`` is a callable returning an iterable of schedule dicts
        (or the iterable itself); the empty dict is the template's own
        launch configuration and keeps the bare name. Every point is a
        parameter the launch takes at run time: no point needs a build
        of its own. Swept points are never the family fallback — they
        declare ``fallback=`` naming a plain sibling."""
        def deco(fn):
            points = list(sweep() if callable(sweep) else sweep)
            if not any(not p for p in points):
                points.insert(0, {})  # the auto point is always swept
            for params in points:
                vname = sched_name(name, params)
                if vname in self.variants:
                    continue  # idempotent under re-import
                self.variants[vname] = Variant(
                    vname, fn, cost, supported, fallback, False, accepts,
                    sched=dict(params) or None, template=name)
                self.order.append(vname)
            return fn
        return deco

    def template_points(self, base: str) -> List[str]:
        """Registered point names of template `base`, sweep order."""
        return [n for n in self.order
                if self.variants[n].template == base]

    @property
    def fallback_name(self) -> Optional[str]:
        for n in self.order:
            if self.variants[n].is_fallback:
                return n
        return None

    def candidates(self, ctx: dict) -> List[Variant]:
        out = [self.variants[n] for n in self.order
               if self.variants[n].supported is None
               or self.variants[n].supported(ctx)]
        if not out and self.fallback_name:
            out = [self.variants[self.fallback_name]]
        return out


_FAMILIES: Dict[str, KernelFamily] = {}
_DECISIONS: Dict[tuple, str] = {}
_FORCED: Dict[str, str] = {}
_lock = threading.RLock()


def family(op: str, analytic=None) -> KernelFamily:
    """Get-or-create the family for `op` (module-import-time idiom:
    ``_fam = family("mmchain")`` then ``@_fam.variant(...)``)."""
    with _lock:
        fam = _FAMILIES.get(op)
        if fam is None:
            fam = _FAMILIES[op] = KernelFamily(op, analytic)
        elif analytic is not None and fam.analytic is None:
            fam.analytic = analytic
        return fam


def families() -> Dict[str, KernelFamily]:
    return dict(_FAMILIES)


def reset_process_state() -> None:
    """Drop all in-memory selection state (decision memo + loaded tuning
    cache + the cost model's records) — what a fresh process starts
    with. Tests and chip_smoke.py use this to show that the cached mode
    serves a second run from disk with no measurement."""
    from systemml_tpu_torch.codegen import costmodel, tune

    with _lock:
        _DECISIONS.clear()
    tune.reset_loaded()
    costmodel.reset()


@contextlib.contextmanager
def force_variant(op: str, name: str):
    """Force every dispatch of `op` to `name` (bench arms / tests). A
    call the forced variant does not accept still runs its fallback."""
    _FORCED[op] = name
    try:
        yield
    finally:
        _FORCED.pop(op, None)


# --------------------------------------------------------------------------
# stats + trace plumbing
# --------------------------------------------------------------------------


def _count(kind: str, n: int = 1) -> None:
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_estim(f"kb_{kind}", n)


def _instant(name: str, **attrs) -> None:
    from systemml_tpu_torch.obs import trace as obs

    if obs.recording():
        obs.instant(name, obs.CAT_CODEGEN, **attrs)


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


# --------------------------------------------------------------------------
# selection + dispatch
# --------------------------------------------------------------------------


def _analytic_choice(fam: KernelFamily, cands: List[Variant],
                     ctx: dict) -> Tuple[str, str, Dict[str, float]]:
    """(choice, source, costs). A family's own analytic selector (the
    quaternary exploit/dense decision) runs first; otherwise the least
    modeled time; all-NaN falls back to registration order and emits
    the instant."""
    costs = {v.name: (float(v.cost(v.with_sched(ctx))) if v.cost
                      else float("nan")) for v in cands}
    if fam.analytic is not None:
        pick = fam.analytic(ctx, [v.name for v in cands])
        if pick in fam.variants:
            return pick, "analytic", costs
    known = {n: c for n, c in costs.items() if c == c}
    if known:
        return min(known, key=known.get), "analytic", costs
    choice = cands[0].name
    _count("nan_cost")
    _instant("kernel_fallback", op=fam.op, reason="nan_cost",
             choice=choice, kind="structural")
    return choice, "structural", costs


def select(op: str, key: KernelKey, ctx: dict, args: tuple,
           kwargs: Optional[dict] = None) -> str:
    """Resolve the variant for (op, key): decision memo -> tuning cache
    -> analytic model (+ in-process measurement when tuning is on and
    the stream is not capturing)."""
    from systemml_tpu_torch.utils.config import get_config

    forced = _FORCED.get(op)
    if forced is not None:
        return forced
    fam = _FAMILIES[op]
    cands = fam.candidates(ctx)
    mode = get_config().codegen_tune_mode
    # the memo key holds the candidate set (config-derived: pallas_mode)
    # and the call site's ctx["memo_extra"], an analytic input finer than
    # the buckets (the quaternary exploit decision)
    memo_key = (key, tuple(v.name for v in cands), ctx.get("memo_extra"),
                mode)
    hit = _DECISIONS.get(memo_key)
    if hit is not None:
        return hit
    with _lock:
        hit = _DECISIONS.get(memo_key)
        if hit is not None:
            return hit
        return _select_locked(fam, op, key, ctx, cands, mode, memo_key,
                              args, kwargs)


def _select_locked(fam, op, key, ctx, cands, mode, memo_key, args, kwargs):
    choice, source, costs = _analytic_choice(fam, cands, ctx)
    if mode in ("online", "cached") and len(cands) >= 2:
        from systemml_tpu_torch.codegen import costmodel, tune

        if mode == "cached":
            cached = tune.lookup(key)
            if cached is not None and cached in fam.variants:
                choice, source = cached, "cache"
        if source != "cache" and _capturing():
            # a graph capture cannot synchronise: the key keeps its
            # analytic choice (loop regions peel their first iteration
            # eagerly, so a body's keys are met there first)
            _count("capture_unmeasured")
        elif source != "cache":
            order, search = costmodel.shortlist(fam, cands, key, ctx,
                                                costs, incumbent=choice)
            if search.get("source") == "cold":
                _count("cold_model")
                _instant("kernel_fallback", op=op, reason="cold_model",
                         kind="shortlist", records=search.get("records", 0))
            measured, meta = tune.measure(fam, order, ctx, args,
                                          kwargs or {})
            if measured is not None:
                choice, source = measured, "measured"
                recs = costmodel.record(key, fam, ctx, costs, meta)
                if mode == "cached":
                    tune.store(key, choice, meta, records=recs)
            # every swept point is either in the measured short-list or
            # named in `pruned`
            space = [v.name for v in cands]
            pruned = [n for n in space if n not in order]
            _count("search_space", len(space))
            _count("search_measured", len(order))
            _count("search_pruned", len(pruned))
            _instant("kernel_search", op=op, key=key.cache_str(),
                     space=len(space), shortlist=list(order),
                     pruned=pruned,
                     pruning_ratio=round(len(order) / max(1, len(space)), 4),
                     model=search.get("source"),
                     records=search.get("records", 0),
                     residual=costmodel.residual(search, meta, choice))
    _DECISIONS[memo_key] = choice
    _count(f"select_{source}")
    _count(f"pick_{op}.{choice}")
    _instant("kernel_select", op=op, choice=choice, source=source,
             key=key.cache_str(),
             costs={k: (round(v, 9) if v == v else None)
                    for k, v in costs.items()})
    return choice


def run(op: str, name: str, ctx: dict, args: tuple,
        kwargs: Optional[dict] = None) -> Any:
    """Run variant `name`, or its declared fallback when the variant's
    `accepts` refuses this call (counted and evented as kind
    "unsupported"). What a variant raises, dispatch raises."""
    fam = _FAMILIES[op]
    kwargs = kwargs or {}
    v = fam.variants[name]
    while v.accepts is not None and v.fallback is not None \
            and not v.accepts(v.with_sched(ctx), *args, **kwargs):
        _count("fallback")
        _instant("kernel_fallback", op=op, kind="unsupported",
                 variant=v.name, fallback=v.fallback)
        v = fam.variants[v.fallback]
    vctx = v.with_sched(ctx)
    from systemml_tpu_torch.obs import profile as prof

    # under the profiler each launch is a kernel_launch span with the
    # variant's modeled time for the roofline join; a fenced one first
    # waits for the stream's earlier work (its block's), so that the span
    # times this launch alone, then for its outputs. A launch into a graph
    # capture is recorded, not run: no span
    if prof.enabled() and not _capturing():
        from systemml_tpu_torch.obs import trace as obs

        modeled = float(v.cost(vctx)) if v.cost else None
        due = prof.fence_due(f"kernel:{op}")
        if due:
            prof.fence(args)
        with obs.span("kernel_launch", obs.CAT_CODEGEN, op=op,
                      variant=v.name, modeled_s=modeled) as sp:
            out = v.fn(vctx, *args, **kwargs)
            if due:
                prof.fenced(sp, out)
        return out
    return v.fn(vctx, *args, **kwargs)


def _device_type(args) -> Optional[str]:
    import torch

    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device.type
        dev = getattr(a, "device", None)
        if isinstance(dev, torch.device):
            return dev.type
    return None


def dispatch(op: str, args: tuple, *, shape: Sequence[int] = (),
             dtype: Any = "f32", sparsity: Optional[float] = None,
             config: Dict[str, Any] | Sequence[Tuple[str, Any]] = (),
             ctx: Optional[dict] = None, kwargs: Optional[dict] = None,
             backend: Optional[str] = None) -> Any:
    """The single entry point every hand-kernel call site uses: build
    the key, select (memo/cache/analytic/measured), run. `backend` is
    the torch device type of the call (default: that of the first
    tensor among `args`, else the configured device); `ctx` carries
    whatever the variants' fns/costs need beyond the key fields."""
    if backend is None:
        backend = _device_type(args)
        if backend is None:
            from systemml_tpu_torch.utils.config import get_config

            backend = str(get_config().device).split(":")[0]
    key = make_key(op, backend=backend, shape=shape, dtype=dtype,
                   sparsity=sparsity, config=config)
    c = dict(ctx or {})
    c.setdefault("shape", tuple(int(d) for d in shape))
    c.setdefault("dtype", dtype_name(dtype))
    c.setdefault("sparsity", sparsity)
    c.setdefault("backend", backend)
    c.setdefault("config", dict(config) if config else {})
    name = select(op, key, c, args, kwargs)
    return run(op, name, c, args, kwargs)
