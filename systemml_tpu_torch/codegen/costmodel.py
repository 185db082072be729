# Port of systemml_tpu/codegen/costmodel.py, with the imports pointed at
# systemml_tpu_torch: the ridge model over tune.training_records,
# shortlist, residual and ingest_profile (:160, over obs/profile.py's
# report) as they are.
"""Learned cost model for the kernel backend's schedule-space search.

TVM-style (arXiv:1802.04799): exhaustive tournaments over the swept
schedule space (codegen/backend.py ``KernelFamily.template``) are too
expensive, so a lightweight learned model short-lists the top-K
candidates per kernel key for the measured ``tune.measure`` tournament.

The model is a closed-form **ridge regression over log wall time** with
hand-engineered features (``featurize``): shape bucket, dtype bytes,
sparsity decade, the point's tile/grid schedule parameters, the analytic
roofline cost, and hops/cost.kernel_feature_row's roofline bytes/flops
row. Training records accumulate from two sources:

- measured tournament samples (``record``, persisted per entry in the
  ``codegen_tune_cache`` schema-v2 ``records`` field), and
- the profiler's per-kernel rows (``ingest_profile``).

Because features are key-derived (not raw shapes), a model fit on one
shape bucket **transfers** to sibling buckets of the same family — that
is the whole point: the first key in a family pays full analytic-ranked
tournaments, later keys get model-ranked short-lists.

Below ``codegen_cost_model_min_records`` records for a family the model
refuses to rank and selection falls back to pure analytic ordering —
surfaced as a named ``kernel_fallback(reason=cold_model)`` instant and a
``kb_cold_model`` counter, never silent.
"""

from __future__ import annotations

import hashlib
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

_lock = threading.Lock()
_RECORDS: Dict[str, List[dict]] = {}   # op -> in-process training records
_FITS: Dict[Tuple[str, int], Any] = {}  # (op, n_records) -> fitted model

_NAME_BUCKETS = 8
_RIDGE_LAMBDA = 1.0


def reset() -> None:
    """Drop in-process training records + fitted models
    (backend.reset_process_state)."""
    with _lock:
        _RECORDS.clear()
        _FITS.clear()


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------


_DTYPE_BYTES = {"float64": 8, "f64": 8, "float32": 4, "f32": 4,
                "bfloat16": 2, "bf16": 2, "float16": 2, "f16": 2,
                "int32": 4, "i32": 4, "int8": 1, "i8": 1, "bool": 1}


def _dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(str(dtype), 4)


def _sparsity_decade(bucket: str) -> float:
    """'dense' -> 0, '1e-3' -> 3 (decades of sparsity below dense)."""
    if not bucket or bucket == "dense":
        return 0.0
    try:
        return -math.log10(float(bucket))
    except (TypeError, ValueError):
        return 0.0


def _name_bucket(base: str) -> int:
    """Stable small hash bucket of the variant's base name (template
    name for swept points) — the model's only categorical feature."""
    return int(hashlib.md5(base.encode()).hexdigest(), 16) % _NAME_BUCKETS


def featurize(key, variant, ctx: dict,
              analytic_cost: Optional[float]) -> List[float]:
    """Fixed-length feature vector for one (key, variant) pair. Every
    feature is key/schedule-derived so vectors are comparable across
    shape buckets (transfer within a family)."""
    from systemml_tpu_torch.hops import cost as hcost

    shape = list(key.shape)[:3] + [0] * max(0, 3 - len(key.shape))
    dbytes = _dtype_bytes(key.dtype)
    sched = getattr(variant, "sched", None) or {}
    tile = sched.get("tile")
    c = float("nan") if analytic_cost is None else float(analytic_cost)
    cost_known = c == c and c > 0
    base = getattr(variant, "template", None) or variant.name
    bucket = _name_bucket(base)
    feat = [1.0]
    feat += [math.log2(d + 1.0) for d in shape[:3]]
    feat.append(float(dbytes))
    feat.append(_sparsity_decade(key.sparsity))
    feat.append(math.log10(c) if cost_known else 0.0)
    feat.append(0.0 if cost_known else 1.0)
    feat.append(math.log2(float(tile)) if tile else 0.0)
    feat.append(1.0 if tile else 0.0)
    feat.append(math.log10(float(ctx.get("bytes", 0) or 0) + 1.0))
    # the planner's fused/alt modeled-time ratio (memo.MemoEntry
    # .cost_ratio, threaded through the spoof hop) — how much the
    # analytic model thinks this fusion should win
    cr = ctx.get("cost_ratio")
    try:
        cr = float(cr) if cr is not None and float(cr) > 0 else None
    except (TypeError, ValueError):
        cr = None
    feat.append(math.log10(cr) if cr else 0.0)
    feat += hcost.kernel_feature_row(key.shape, dbytes,
                                     ctx.get("sparsity"))
    feat += [1.0 if i == bucket else 0.0 for i in range(_NAME_BUCKETS)]
    return [round(float(x), 6) for x in feat]


def feature_len() -> int:
    """Length of the featurize() vector (schema constant for records)."""
    return 12 + 4 + _NAME_BUCKETS


# --------------------------------------------------------------------------
# training records
# --------------------------------------------------------------------------


def add_record(op: str, variant: str, time_s: float,
               feat: List[float]) -> dict:
    """Append one training record for `op` and return its JSON form
    (the shape persisted in cache schema v2 ``records``)."""
    rec = {"variant": variant, "time_s": float(time_s),
           "feat": [float(x) for x in feat]}
    with _lock:
        _RECORDS.setdefault(op, []).append(rec)
        _FITS.clear()
    return rec


def record(key, fam, ctx: dict, costs: Dict[str, float],
           meta: Optional[dict]) -> List[dict]:
    """Convert one measured tournament's per-variant wall samples
    (tune.measure meta["samples"]) into training records. Returns the
    records for persistence alongside the cache entry."""
    samples = (meta or {}).get("samples") or {}
    out = []
    for name, t in samples.items():
        v = fam.variants.get(name)
        if v is None or not t or t <= 0:
            continue
        feat = featurize(key, v, ctx, costs.get(name))
        out.append(add_record(fam.op, name, float(t), feat))
    return out


def ingest_profile(report: Any) -> int:
    """Ingest the per-kernel roofline rows of a device-time profile
    (obs/profile.py report ``kernels`` dict: "op.variant" -> {count,
    device_s, modeled_s, ...}) as weak training records: per-launch
    device seconds against a key-less feature vector built from the
    row's own analytic cost. Returns the number of records added."""
    from systemml_tpu_torch.codegen import backend as kb

    kernels = getattr(report, "kernels", None)
    if kernels is None and isinstance(report, dict):
        kernels = report.get("kernels")
    if not isinstance(kernels, dict):
        return 0
    n = 0
    for row in kernels.values():
        if not isinstance(row, dict):
            continue
        op, variant = row.get("op"), row.get("variant")
        count = int(row.get("count", 0) or 0)
        dev_s = float(row.get("device_s", 0.0) or 0.0)
        if not op or not variant or count <= 0 or dev_s <= 0:
            continue
        fam = kb.families().get(op)
        v = fam.variants.get(variant) if fam else None
        if v is None:
            continue
        key = kb.KernelKey(op, "profile", "f32", (), "dense", ())
        modeled = row.get("modeled_s")
        feat = featurize(key, v, {}, modeled)
        add_record(op, variant, dev_s / count, feat)
        n += 1
    return n


def records_for(op: str) -> List[dict]:
    """All training records for `op`: in-process measurements plus the
    persisted schema-v2 records in the on-disk tuning cache."""
    from systemml_tpu_torch.codegen import tune

    with _lock:
        mem = list(_RECORDS.get(op, ()))
    seen = {(r["variant"], r["time_s"], tuple(r["feat"])) for r in mem}
    out = mem
    for r in tune.training_records(op):
        try:
            sig = (r["variant"], float(r["time_s"]), tuple(r["feat"]))
        except (KeyError, TypeError, ValueError):
            continue
        if sig not in seen:
            seen.add(sig)
            out.append(r)
    return out


# --------------------------------------------------------------------------
# ridge model
# --------------------------------------------------------------------------


class RidgeModel:
    """Closed-form ridge regression on log10 wall time. Tiny on purpose:
    tens of records, ~20 features — numpy.linalg.solve is microseconds
    and there is nothing to install."""

    def __init__(self, weights, y_mean: float, n_records: int):
        self.weights = weights
        self.y_mean = float(y_mean)
        self.n_records = int(n_records)

    def predict_log10(self, feat: List[float]) -> float:
        import numpy as np

        x = np.asarray(feat, dtype=float)
        if x.shape[0] != self.weights.shape[0]:
            return float("nan")
        return float(x @ self.weights + self.y_mean)

    def predict_s(self, feat: List[float]) -> float:
        p = self.predict_log10(feat)
        return 10.0 ** p if p == p else float("nan")


def fit_records(records: List[dict],
                min_records: int = 1) -> Optional[RidgeModel]:
    """Fit a RidgeModel over `records` ({"time_s", "feat"}); None when
    fewer than `min_records` usable rows."""
    import numpy as np

    rows, ys = [], []
    for r in records:
        feat, t = r.get("feat"), r.get("time_s")
        if not feat or not t or t <= 0:
            continue
        rows.append([float(x) for x in feat])
        ys.append(math.log10(float(t)))
    if len(rows) < max(1, int(min_records)):
        return None
    width = max(len(r) for r in rows)
    X = np.zeros((len(rows), width))
    for i, r in enumerate(rows):
        X[i, :len(r)] = r
    y = np.asarray(ys)
    y_mean = float(y.mean())
    A = X.T @ X + _RIDGE_LAMBDA * np.eye(width)
    try:
        w = np.linalg.solve(A, X.T @ (y - y_mean))
    except np.linalg.LinAlgError:
        return None
    return RidgeModel(w, y_mean, len(rows))


def _min_records() -> int:
    from systemml_tpu_torch.utils.config import get_config

    return max(1, int(getattr(get_config(),
                              "codegen_cost_model_min_records", 8)))


def fit(op: str) -> Optional[RidgeModel]:
    """Fitted model for `op`, or None when disabled/under-trained.
    Memoized on (op, record count) so steady-state dispatches never
    re-solve."""
    from systemml_tpu_torch.utils.config import get_config

    if getattr(get_config(), "codegen_cost_model", "ridge") == "off":
        return None
    recs = records_for(op)
    cache_key = (op, len(recs))
    with _lock:
        hit = _FITS.get(cache_key)
    if hit is not None:
        return hit or None
    model = fit_records(recs, min_records=_min_records())
    with _lock:
        _FITS[cache_key] = model if model is not None else False
    return model


# --------------------------------------------------------------------------
# short-listing (the backend.select hook)
# --------------------------------------------------------------------------


def _analytic_order(names: List[str], costs: Dict[str, float],
                    incumbent: str) -> List[str]:
    """Analytic ranking: incumbent first, then ascending modeled cost
    (NaN last, registration order as the tiebreak via sort stability)."""
    def rank(n):
        c = costs.get(n, float("nan"))
        return (n != incumbent, c if c == c else float("inf"))
    return sorted(names, key=rank)


def _with_guardrail(order: List[str], fam, names: List[str],
                    k: int) -> List[str]:
    """Reserve one shortlist slot for the family's terminal fallback
    (the XLA-default arm) when it is a live candidate: it is the arm an
    analytic mis-pricing hurts most, and always measuring it means
    neither the analytic ranking nor an under-explored model can lock a
    family into a modeled-fast-but-actually-slow kernel."""
    order = order[:k]
    fb = fam.fallback_name
    if fb and fb in names and fb not in order:
        order[-1] = fb
    return order


def shortlist(fam, cands, key, ctx: dict, costs: Dict[str, float],
              incumbent: str) -> Tuple[List[str], dict]:
    """Top-K candidate names for the measured tournament plus a search
    info dict ({"source": model|cold|off|analytic, "records": n,
    "pred": {name: seconds}}). K = codegen_tune_shortlist. The learned
    model ranks when trained past the min-records threshold; otherwise
    analytic ranking (source "cold" iff the model was enabled but
    under-trained — the caller emits the cold_model fallback event).
    One slot is always the terminal-fallback guardrail arm."""
    from systemml_tpu_torch.utils.config import get_config

    cfg = get_config()
    k = max(2, int(getattr(cfg, "codegen_tune_shortlist", 2)))
    names = [v.name for v in cands]
    enabled = getattr(cfg, "codegen_cost_model", "ridge") != "off"
    if len(names) <= k:
        # nothing to prune: skip the fit, measure the whole space
        return (_analytic_order(names, costs, incumbent),
                {"source": "analytic", "records": len(records_for(fam.op))})
    model = fit(fam.op) if enabled else None
    n_rec = len(records_for(fam.op))
    if model is None:
        src = "cold" if enabled else "off"
        order = _with_guardrail(_analytic_order(names, costs, incumbent),
                                fam, names, k)
        return order, {"source": src, "records": n_rec}
    pred = {}
    for v in cands:
        p = model.predict_s(featurize(key, v, ctx, costs.get(v.name)))
        pred[v.name] = p if p == p else float("inf")
    order = _with_guardrail(sorted(names, key=lambda n: pred[n]),
                            fam, names, k)
    return order, {"source": "model", "records": n_rec,
                   "pred": {n: (round(p, 9) if p != float("inf") else None)
                            for n, p in pred.items()}}


def residual(search: dict, meta: Optional[dict],
             choice: str) -> Optional[dict]:
    """Model-vs-measured residual for the tournament winner (the
    kernel_search instant's honesty field): log10(pred) - log10(meas).
    None when the model didn't rank or the winner wasn't measured."""
    pred = (search or {}).get("pred", {}).get(choice)
    meas = ((meta or {}).get("samples") or {}).get(choice)
    if not pred or not meas or pred <= 0 or meas <= 0:
        return None
    return {"pred_s": round(float(pred), 9),
            "measured_s": round(float(meas), 9),
            "log10_ratio": round(math.log10(pred / meas), 4)}
