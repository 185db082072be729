# Port of systemml_tpu/codegen/tune.py, with the imports pointed at
# systemml_tpu_torch. What differs:
# - the device kind of a verdict is torch.cuda.get_device_name() for a
#   key whose backend is "cuda" ("NVIDIA H100 80GB HBM3" on the card),
#   and "cpu" for a CPU key (the reference asks jax.devices(), :74);
# - `measure` times each arm by wall clock after torch.cuda.synchronize()
#   (it replaces the reference's `_sync`, :203-219), and a variant that
#   raises is an error: the reference's probe drops it (:246-251); here
#   only the variants' predicates decide which arms are eligible;
# - the cache defaults to a path of the port's own
#   (utils/config.py codegen_tune_cache).
"""Measured-cost autotuner + on-disk verdict cache for the kernel backend.

TVM-style (arXiv:1802.04799): the analytic roofline proposes, hardware
disposes. The backend short-lists candidate variants; this module
measures them IN-PROCESS with the paired obs/ab harness — interleaved,
order-flipped trials, wall-clock arms (runners synchronise the device
and return None, the ab.interleave contract) — and picks by the paired
verdict. An INCONCLUSIVE verdict keeps the analytic incumbent: the
tuner only overrides the model on conclusive evidence.

``codegen_tune_mode: cached`` additionally persists verdicts to a JSON
file (config ``codegen_tune_cache``), keyed by kernel key + device
name, with its ``measured_on`` metadata (device, backend, wall time,
trials, per-arm median seconds, ratio CI). A later process — or this one
after ``backend.reset_process_state()`` — serves every dispatch of a
cached key with no measurement; ``measurement_count()`` counts them.

File format (schema 2 over version 1, as the reference writes it):

    {"version": 1, "schema": 2,
     "entries": {"<kernel key>|<device kind>":
         {"choice": "<variant>", "measured_on": {...},
          "records": [{"variant": ..., "time_s": ..., "feat": [...]}]}}}
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

_VERSION = 1
_SCHEMA = 2

_lock = threading.Lock()
_loaded: Dict[str, dict] = {}      # path -> {"entries": {...}, "mtime": ns}
_own: Dict[str, Dict[str, dict]] = {}  # path -> entries THIS process stored
_measure_count = 0                 # process-lifetime measurement counter


def measurement_count() -> int:
    """Number of in-process A/B measurements taken since process start
    (one per judged pair). A cached run over keys already on disk
    leaves it at 0."""
    return _measure_count


def reset_loaded() -> None:
    """Forget loaded cache files (backend.reset_process_state)."""
    global _measure_count
    with _lock:
        _loaded.clear()
        _own.clear()
        _measure_count = 0


def _cache_path() -> Optional[str]:
    from systemml_tpu_torch.utils.config import get_config

    p = get_config().codegen_tune_cache
    return os.path.expanduser(p) if p else None


def _device_kind(backend: Optional[str] = None) -> str:
    """The card's name for a "cuda" key, "cpu" for a CPU key; without a
    backend, that of the configured device."""
    if backend is None:
        from systemml_tpu_torch.utils.config import get_config

        backend = str(get_config().device).split(":")[0]
    if backend != "cuda":
        return "cpu"
    import torch

    return torch.cuda.get_device_name()


def _mtime_ns(path: str) -> int:
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return -1


def _read_entries(path: str) -> Optional[dict]:
    """The file's entries, or None when it is missing, unreadable or not
    a cache of this version: a corrupt cache is an empty one."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(raw, dict) and raw.get("version") == _VERSION \
            and isinstance(raw.get("entries"), dict):
        return dict(raw["entries"])
    return None


def _load(path: str) -> dict:
    """In-process snapshot of the cache file, reloaded only when the
    file's mtime changes. On reload, entries THIS process stored
    (`_own`) are overlaid so a reload never forgets our own verdicts
    (the concurrent-writer merge store() maintains)."""
    mt = _mtime_ns(path)
    with _lock:
        cached = _loaded.get(path)
        if cached is not None and cached.get("mtime") == mt:
            return cached
    entries = _read_entries(path) or {}
    with _lock:
        entries.update(_own.get(path, {}))
        # mtime taken BEFORE the read: a write racing the read makes the
        # snapshot look stale and triggers one extra (correct) reload
        data = {"entries": entries, "mtime": mt}
        _loaded[path] = data
    return data


def _full_key(key) -> str:
    return f"{key.cache_str()}|{_device_kind(key.backend)}"


def lookup(key) -> Optional[str]:
    """Cached variant choice for `key` on this device kind, or None."""
    path = _cache_path()
    if not path:
        return None
    ent = _load(path)["entries"].get(_full_key(key))
    return ent.get("choice") if isinstance(ent, dict) else None


def store(key, choice: str, meta: Optional[dict],
          records: Optional[List[dict]] = None) -> None:
    """Persist a verdict (plus the tournament's cost-model training
    `records`). The committed file is the FRESH on-disk state overlaid
    with only the entries THIS process itself measured (`_own`) — never
    the process-start snapshot: a concurrent process may have re-tuned a
    key we merely loaded. The tmp+rename commit keeps a concurrent
    reader off a torn file."""
    path = _cache_path()
    if not path:
        return
    data = _load(path)
    with _lock:
        ent = {"choice": choice, "measured_on": meta or {}}
        if records:
            ent["records"] = list(records)
        data["entries"][_full_key(key)] = ent
        own = _own.setdefault(path, {})
        own[_full_key(key)] = ent
        merged = _read_entries(path)
        if merged is None:   # first write, or unreadable on disk
            merged = dict(data["entries"])
        merged.update(own)
        data["entries"].update(merged)  # lookups see the freshest view
        payload = {"version": _VERSION, "schema": _SCHEMA,
                   "entries": merged}
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            return   # the cache is an optimisation: a dispatch goes on
        data["mtime"] = _mtime_ns(path)  # our write isn't "stale"


def training_records(op: str) -> List[dict]:
    """Schema-2 ``records`` persisted for `op` on THIS device kind — the
    learned cost model's on-disk training data."""
    path = _cache_path()
    if not path:
        return []
    suffix = f"|{_device_kind()}"
    out: List[dict] = []
    for full_key, ent in _load(path)["entries"].items():
        if not full_key.startswith(f"{op}|"):
            continue
        if not full_key.endswith(suffix):
            continue
        if isinstance(ent, dict) and isinstance(ent.get("records"), list):
            out.extend(r for r in ent["records"] if isinstance(r, dict))
    return out


# --------------------------------------------------------------------------
# in-process measurement
# --------------------------------------------------------------------------


def _sync(backend: str) -> None:
    """Wait for the card's queued work: a wall-clock arm ends with it."""
    if backend == "cuda":
        import torch

        torch.cuda.synchronize()


def measure(fam, order: List[str], ctx: dict, args: tuple,
            kwargs: dict) -> Tuple[Optional[str], Optional[dict]]:
    """Winner-stays tournament over the short-listed variant names
    (analytic incumbent first), each of which accepts this call. Each
    round is one paired obs/ab run; the challenger must win CONCLUSIVELY
    to displace the incumbent. A variant that raises raises here.
    Returns (winner, metadata), or (None, None) when fewer than two
    variants are eligible."""
    global _measure_count
    from systemml_tpu_torch.obs import ab
    from systemml_tpu_torch.utils.config import get_config

    cfg = get_config()
    trials = max(2, int(cfg.codegen_tune_trials))
    shortlist = max(2, int(cfg.codegen_tune_shortlist))
    backend = ctx.get("backend", "cpu")

    def runner(name):
        v = fam.variants[name]
        rctx = v.with_sched(ctx)  # swept points see their schedule

        def r():
            v.fn(rctx, *args, **kwargs)
            _sync(backend)
            return None  # wall-clock arm: ab.interleave times us
        return r

    alive = [n for n in order[:shortlist]
             if fam.variants[n].accepts is None
             or fam.variants[n].accepts(fam.variants[n].with_sched(ctx),
                                        *args, **kwargs)]
    if len(alive) < 2:
        return None, None
    _sync(backend)
    t0 = time.time()
    incumbent = alive[0]
    rounds = []
    res = None
    samples: Dict[str, List[float]] = {}
    for challenger in alive[1:]:
        # interleave + judge split (rather than ab.ab) so the raw wall
        # samples survive into meta["samples"] — the learned cost
        # model's training records (codegen/costmodel.py)
        sa, sb = ab.interleave(runner(incumbent), runner(challenger),
                               trials=trials, warmup=1, mode="wall")
        res = ab.compare_samples(sa, sb, higher_is_better=False)
        samples.setdefault(incumbent, []).extend(sa)
        samples.setdefault(challenger, []).extend(sb)
        with _lock:
            _measure_count += 1
        rounds.append({"a": incumbent, "b": challenger,
                       "verdict": res.verdict,
                       "ratio": round(res.ratio, 4)})
        if res.verdict == ab.VERDICT_B:
            incumbent = challenger
    meta = {
        "device_kind": _device_kind(backend),
        "backend": backend,
        "at_unix": round(t0, 3),
        "trials": trials,
        "rounds": rounds,
        "last_ratio_ci": [round(res.ratio_ci[0], 4),
                          round(res.ratio_ci[1], 4)] if res else None,
        "wall_s": round(time.time() - t0, 4),
        "samples": {n: round(statistics.median(v), 9)
                    for n, v in samples.items() if v},
        "n": {n: len(v) for n, v in samples.items()},
    }
    return incumbent, meta
