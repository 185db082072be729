# Port of systemml_tpu/obs/fleet.py: the same code, with its imports
# pointed at systemml_tpu_torch. The identity is set by whoever starts a
# process of the fleet (the JAX package's multihost.init_distributed has
# no counterpart until ROADMAP queue 1, item 12); the merge command is
# `python -m systemml_tpu_torch.obs.fleet_trace DIR`.
"""Fleet observability: one coherent view over a multi-process run.

The per-process flight recorder (obs/trace.py) and metrics registry
(obs/metrics.py) are process-local. This module lays several processes'
timelines side by side and explains where a failover or a rolling
update spent its time (reference analog: the SINGLE `-stats`/`-explain`
view SystemML renders over a hybrid CP/Spark plan — one summary for
the whole cluster, not one per executor):

- **Run/rank identity** — every process carries a ``FleetIdentity``
  (stable ``run_id`` + ORIGINAL first-join rank + CURRENT rank +
  reform generation), set by the process's launcher through
  ``set_identity`` so its events stay attributable.
- **Per-rank trace shards** — ``attach_shard`` subscribes a JSONL
  writer to the flight-recorder bus: every event streams to
  ``<obs_fleet_dir>/shard_r<orig>.jsonl`` as it lands (line-flushed, so
  a SIGKILLed rank leaves a readable shard with at most one torn tail
  line). Each line is stamped with the current rank + generation; a
  reform appends a fresh header record instead of losing the lane.
- **Clock alignment** — a liveness handshake or a registry scan
  piggybacks a wall-clock announcement (``handshake_payload`` /
  ``note_peer_ready``); the resulting bidirectional ``clock_probe``
  events give the merge an NTP-style offset estimate per rank, so lanes
  align even when hosts' clocks disagree (either sign).
- **Fleet merge** — ``merge_dir`` + ``chrome_fleet_trace`` produce one
  Chrome/Perfetto timeline with one process lane per ORIGINAL rank;
  ``failover_storyline`` extracts the causally-ordered CAT_RESIL chain
  (a serving fleet's ``fleet_route_epoch`` among it) and
  ``rollout_storyline`` the rolling-update chain.
- **Metrics rollup** — ``rollup_metrics`` merges per-rank registry
  snapshots (sum counters, max gauges, merge histograms) into one
  fleet view; ``render_fleet_stats`` renders it.
- **Straggler attribution** — ``fleet_report`` names the slowest rank
  per step window from the per-rank ``fleet_step`` events and splits
  fleet wall time into compute / exposed-DCN / straggler-wait.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from systemml_tpu_torch.obs.export import _jsonable
from systemml_tpu_torch.obs.trace import (CAT_FLEET, CAT_MESH, CAT_RESIL,
                                    FlightRecorder, TraceEvent)

# --------------------------------------------------------------------------
# the fleet event vocabulary
# --------------------------------------------------------------------------

# The CAT_RESIL recovery chain, in causal order WITHIN one recovery
# episode. ``failover_storyline`` surfaces exactly these (time-ordered
# across ranks after clock alignment); chained reforms — a second death
# mid-reform, a reattach followed later by a failover, a grow-back
# after a reform — repeat the chain at successive generations in ONE
# causally-ordered lane (``storyline_generations`` names the traversal,
# e.g. 0→1→2). The harness asserts the detach/election/reinit/reform
# chain in the 3-process SIGKILL runs and the doubled chain (abandoned
# reinit + re-election at generation 2) in the 4-process double-SIGKILL
# run.
STORYLINE_EVENTS = (
    "coord_detach",            # lockstep coordination detach (healthy point)
    "fault",                   # the classified failure, NAMING dead ranks
    "election",                # deterministic new-coordinator election
    "reinit",                  # survivors re-joined the re-formed job
    "reinit_abandoned",        # in-flight reinit abandoned: a SECOND death
    #                            mid-barrier; election re-runs, generation
    #                            slot consumed (second-death recovery)
    "mesh_reform",             # shared survivor mesh stood up
    "coordinator_failover",    # ...whose dead set included rank 0
    "mesh_reform_skipped",     # reform declined (rank_space / attached)
    "mesh_shrink",             # local-domain fallback shrink
    "coord_reattach",          # reattach-on-demand: lockstep re-join of the
    #                            unchanged membership while detached
    "reattach_skipped",        # transient at the reattach site: skip one
    #                            boundary, retry at the next
    "reverse_reinit",          # grow-back across a reform: re-expansion to
    #                            the original rank space begins
    "mesh_grow",               # grow-back re-admission
    "mesh_trim",               # topology trim to uniform fault domains
    "grow_probe_skipped",      # transient probe failure, retry next cadence
    "ckpt_snapshot",           # cadence snapshot committed
    "ckpt_skipped",            # snapshot skipped (stage backlog)
    "reshard",                 # snapshot restored re-sharded on a new mesh
    "resume",                  # loop resumed (bounded rework)
    "fleet_route_epoch",       # serving router swapped routing tables: a
    #                            reform (or quarantine) became a new epoch,
    #                            never an error surfaced to a client
)

# CAT_MESH / CAT_FLEET traffic the per-rank summary section renders:
# dist_op dispatches with payload bytes, dcn_bucket cross-host buckets,
# exposed_comm wait windows, fleet_step per-iteration timings and the
# clock_announce / clock_probe alignment samples.
TRAFFIC_EVENTS = ("dist_op", "dcn_bucket", "exposed_comm", "fleet_step",
                 "clock_announce", "clock_probe")

# CAT_FLEET serving-plane traffic (fleet/): replica
# registration lifecycle and the router's straggler-aware hedges.
# Hedges are traffic, not recovery — they never enter the failover lane.
SERVING_EVENTS = ("replica_up", "replica_retire", "fleet_hedge")

# The rolling-update chain, in causal order within one g→g+1 rollout.
# Emitted via ``faults.emit`` (CAT_RESIL: a rollout is a controlled
# membership change and belongs in the resilience rollup), but rendered
# in its OWN ``fleet_rollout`` storyline lane — ``failover_storyline``
# excludes these names so an update never masquerades as a recovery.
ROLLOUT_EVENTS = (
    "rollout_start",           # router began shifting g → g+1
    "rollout_load",            # a replica loaded the g+1 program on its
    #                            generation-scheduled port
    "rollout_shift",           # router committed a traffic-weight step
    "rollout_drain",           # generation-g in-flight work drained
    "rollout_retire",          # a replica retired its g program
    "rollout_done",            # rollout complete; g+1 serves 100%
)

# CAT_FLEET overload-protection decisions (fleet/admission.py via
# ``admission.emit_overload``): every refusal carries a NAMED reason
# (folded into the -stats counter label, e.g.
# ``fleet_admission_reject[expired]``) so shed load stays attributable.
# Refusals are traffic control, not recovery — like hedges they never
# enter the failover lane.
OVERLOAD_EVENTS = (
    "fleet_admission_reject",  # replica answered 429 before scoring
    "fleet_budget_exhausted",  # router retry/hedge token denied
    #                            (brownout: redispatch degrades to
    #                            fail-fast, hedge skipped)
    "fleet_breaker_open",      # per-replica circuit opened after a run
    #                            of consecutive transient failures
    "fleet_breaker_close",     # circuit re-closed (probe succeeded)
    "microbatch_shed",         # queued request expired before dispatch
    "microbatch_queue_full",   # bounded pending-row queue refused an
    #                            enqueue (backpressure at the door)
)

FLEET_EVENT_NAMES = (STORYLINE_EVENTS + TRAFFIC_EVENTS + SERVING_EVENTS
                     + ROLLOUT_EVENTS + OVERLOAD_EVENTS)

SHARD_PREFIX = "shard_r"
METRICS_PREFIX = "metrics_r"


# --------------------------------------------------------------------------
# identity
# --------------------------------------------------------------------------

class FleetIdentity:
    """Who this process is within the run: stable ``run_id`` (identical
    on every rank), ORIGINAL first-join rank (stable across reforms —
    the lane identity), CURRENT rank (renumbered by reforms), reform
    ``generation`` and current job size."""

    __slots__ = ("run_id", "orig_rank", "rank", "generation", "nproc")

    def __init__(self, run_id: str, orig_rank: int, rank: int,
                 generation: int = 0, nproc: int = 1):
        self.run_id = str(run_id)
        self.orig_rank = int(orig_rank)
        self.rank = int(rank)
        self.generation = int(generation)
        self.nproc = int(nproc)

    def to_dict(self) -> Dict[str, Any]:
        return {"run_id": self.run_id, "orig_rank": self.orig_rank,
                "rank": self.rank, "generation": self.generation,
                "nproc": self.nproc}

    def __repr__(self):
        return (f"<FleetIdentity run={self.run_id} orig={self.orig_rank} "
                f"rank={self.rank} gen={self.generation}>")


_identity: Optional[FleetIdentity] = None
_identity_lock = threading.Lock()
_writer: Optional["FleetShardWriter"] = None


def derive_run_id(coordinator: str, num_processes: int) -> str:
    """Stable run id every process derives IDENTICALLY with no message
    exchange: the first-join job tuple is the shared fact (all ranks
    pass the same coordinator address), hashed short. Env
    ``SMTPU_RUN_ID`` overrides for launcher-assigned ids."""
    env = os.environ.get("SMTPU_RUN_ID", "").strip()
    if env:
        return env
    h = hashlib.sha256(
        f"{coordinator}|{num_processes}".encode()).hexdigest()[:12]
    return f"run-{h}"


def set_identity(run_id: str, orig_rank: int, rank: int,
                 generation: int = 0, nproc: int = 1) -> FleetIdentity:
    """Install/refresh this process's fleet identity (called by the
    process's launcher before it serves or joins, and again after a
    reform). A generation change is re-stamped into the active shard
    (new header record), so renumbered lanes stay attributable to the
    original identity."""
    global _identity
    with _identity_lock:
        ident = FleetIdentity(run_id, orig_rank, rank, generation, nproc)
        _identity = ident
        w = _writer
    if w is not None:
        w.restamp(ident)
    return ident


def identity() -> Optional[FleetIdentity]:
    return _identity


def clear_identity() -> None:
    """Test hook: drop the process identity (and detach any writer)."""
    global _identity, _writer
    with _identity_lock:
        _identity = None
        w, _writer = _writer, None
    if w is not None:
        w.close()


def identity_labels() -> Dict[str, str]:
    """Prometheus const labels for this process (``rank`` +
    ``generation``) — empty when no fleet identity is set, so
    single-process scrapes render unchanged."""
    ident = _identity
    if ident is None:
        return {}
    return {"rank": str(ident.rank), "generation": str(ident.generation)}


# --------------------------------------------------------------------------
# per-rank shard writer (the bus listener)
# --------------------------------------------------------------------------

class FleetShardWriter:
    """Streams every recorder event to one JSONL shard, line-flushed.

    The shard leads with a ``fleet_header`` record carrying the
    identity AND a (wall_ns, perf_ns) clock anchor captured together —
    the pair that maps perf_counter timestamps onto this host's wall
    clock at merge time. ``restamp`` appends a fresh header when the
    identity changes (reform generation bump): later events carry the
    new rank/generation while the file — keyed by ORIGINAL rank —
    remains one lane."""

    def __init__(self, path: str, ident: FleetIdentity):
        self._path = path
        self._lock = threading.Lock()
        self._ident = ident
        # a re-attach WITHIN the same run (grow-back re-admission, a
        # second attach_shard) must append — truncating would erase the
        # lane's pre-death history the merge promises to keep. A shard
        # left by a DIFFERENT run is overwritten (the merge excludes
        # stale run_ids anyway; one file must never mix runs).
        self._f = open(path,
                       "a" if _same_run_shard(path, ident.run_id)
                       else "w")
        self._write_header(ident)

    def _write_header(self, ident: FleetIdentity) -> None:
        rec = {"meta": "fleet_header", "wall_ns": time.time_ns(),
               "perf_ns": time.perf_counter_ns(), "pid": os.getpid()}
        rec.update(ident.to_dict())
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def restamp(self, ident: FleetIdentity) -> None:
        with self._lock:
            self._ident = ident
            if not self._f.closed:
                self._write_header(ident)

    def __call__(self, ev: TraceEvent) -> None:
        """Recorder-bus listener: one JSON line per event, stamped with
        the CURRENT rank + generation (the per-event half of the
        identity contract; run_id/orig_rank live in the header)."""
        ident = self._ident
        line = json.dumps({
            "id": ev.id, "name": ev.name, "cat": ev.cat, "ph": ev.ph,
            "ts_ns": ev.ts, "dur_ns": ev.dur, "tid": ev.tid,
            "parent": ev.parent, "rank": ident.rank,
            "gen": ident.generation, "args": _jsonable(ev.args) or {},
        })
        with self._lock:
            if not self._f.closed:
                self._f.write(line + "\n")
                self._f.flush()   # a SIGKILL tears at most the last line

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _same_run_shard(path: str, run_id: str) -> bool:
    """Does an existing shard at `path` belong to `run_id`? (Reads the
    leading header line; a missing/torn/foreign file reads False.)"""
    try:
        with open(path) as f:
            head = json.loads(f.readline())
        return (head.get("meta") == "fleet_header"
                and head.get("run_id") == run_id)
    except (OSError, ValueError):
        return False


def shard_path(fleet_dir: str, orig_rank: int) -> str:
    return os.path.join(fleet_dir, f"{SHARD_PREFIX}{orig_rank:03d}.jsonl")


def attach_shard(recorder: FlightRecorder,
                 fleet_dir: Optional[str] = None) -> FleetShardWriter:
    """Subscribe a shard writer for THIS process to `recorder`. The
    directory comes from the argument or config ``obs_fleet_dir``;
    requires a fleet identity (join the job first). The writer is
    process-global so a later ``set_identity`` (reform) re-stamps it."""
    global _writer
    if fleet_dir is None:
        from systemml_tpu_torch.utils.config import get_config

        fleet_dir = str(getattr(get_config(), "obs_fleet_dir", "") or "")
    if not fleet_dir:
        raise ValueError("no fleet directory: pass fleet_dir or set "
                         "config obs_fleet_dir")
    ident = _identity
    if ident is None:
        raise RuntimeError("no fleet identity set "
                           "(the launcher installs one with set_identity)")
    os.makedirs(fleet_dir, exist_ok=True)
    w = FleetShardWriter(shard_path(fleet_dir, ident.orig_rank), ident)
    recorder.subscribe(w)
    with _identity_lock:
        prev, _writer = _writer, w
    if prev is not None:
        # a still-subscribed prior writer would keep streaming through
        # a stale handle; closing makes its listener a no-op
        prev.close()
    return w


# --------------------------------------------------------------------------
# clock-offset piggyback on the liveness handshake
# --------------------------------------------------------------------------

def handshake_payload(step: int) -> str:
    """The announcement a rank writes into its per-step ready file:
    its identity + wall clock NOW. Also emits a ``clock_announce``
    instant so the shard carries the same sample."""
    from systemml_tpu_torch.obs import trace as obs

    ident = _identity
    wall = time.time_ns()
    rank = ident.orig_rank if ident is not None else -1
    if obs.recording():
        obs.instant("clock_announce", CAT_FLEET, step=int(step),
                    wall_ns=wall)
    return json.dumps({"rank": rank, "step": int(step), "wall_ns": wall})


def note_peer_ready(peer_orig_rank: int, payload: str,
                    step: Optional[int] = None) -> None:
    """Record one clock probe: the peer announced at ``peer.wall_ns``
    (its clock), we observed it at ``time.time_ns()`` (ours). The
    one-way sample bounds offset + delay; with samples in BOTH
    directions (every rank observes every peer each step) the merge
    recovers the pairwise offset NTP-style. Malformed payloads (torn
    write, legacy empty ready file) are ignored — liveness, not
    alignment, is the handshake's load-bearing job."""
    from systemml_tpu_torch.obs import trace as obs

    if not obs.recording():
        return
    try:
        d = json.loads(payload)
        peer_wall = int(d["wall_ns"])
    except (ValueError, KeyError, TypeError):
        return
    obs.instant("clock_probe", CAT_FLEET, peer=int(peer_orig_rank),
                step=int(step if step is not None else d.get("step", -1)),
                peer_wall_ns=peer_wall, self_wall_ns=time.time_ns())


def note_step(step: int, dur_ns: int, epoch: int = 0) -> None:
    """Per-iteration heartbeat from the elastic runner: a
    ``fleet_step`` instant (step index, duration, generation) feeding
    the straggler report, plus the ``fleet_steps_total`` counter on the
    ambient Statistics so plain `-stats` shows progress without a
    recorder.

    ``epoch`` is the runner's recovery count (shrinks so far): a
    LOCAL-domain shrink replays steps without a reform, so the
    generation alone cannot distinguish a replayed step 3 from the
    pre-fault one — the report must never pair a dead rank's pre-fault
    completion with a survivor's post-recovery replay."""
    from systemml_tpu_torch.obs import trace as obs
    from systemml_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.count_step()
    if not obs.recording():
        return
    ident = _identity
    obs.instant("fleet_step", CAT_FLEET, step=int(step),
                dur_ns=int(dur_ns), epoch=int(epoch),
                gen=ident.generation if ident is not None else 0)


# --------------------------------------------------------------------------
# shard reading + fleet merge
# --------------------------------------------------------------------------

class Shard:
    """One rank's parsed shard: headers (identity + clock anchors, one
    per generation seen), events (raw dicts), and the count of torn
    lines tolerated (a rank that died mid-write)."""

    def __init__(self, path: str):
        self.path = path
        self.headers: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.torn_lines = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except ValueError:
                    # a SIGKILLed writer tears at most its last line;
                    # tolerate (and count) rather than losing the lane
                    self.torn_lines += 1
                    continue
                if d.get("meta") == "fleet_header":
                    self.headers.append(d)
                else:
                    self.events.append(d)
        if not self.headers:
            raise ValueError(f"{path}: no fleet_header record "
                             f"(not a fleet shard)")

    @property
    def orig_rank(self) -> int:
        return int(self.headers[0]["orig_rank"])

    @property
    def run_id(self) -> str:
        return str(self.headers[0]["run_id"])

    @property
    def generations(self) -> List[int]:
        return sorted({int(h["generation"]) for h in self.headers})

    def wall_of(self, ts_ns: int) -> int:
        """Map a perf_counter timestamp onto this host's wall clock via
        the nearest preceding header's (wall, perf) anchor pair."""
        best = self.headers[0]
        for h in self.headers:
            if h["perf_ns"] <= ts_ns:
                best = h
        return int(ts_ns - best["perf_ns"] + best["wall_ns"])


class FleetTrace:
    """The merged view: shards keyed by original rank, per-rank wall
    offsets relative to the reference rank, and one aligned event list
    (each event dict gains ``orig_rank`` + ``t_ns``, the aligned
    wall-clock time in the reference rank's clock)."""

    def __init__(self, shards: Dict[int, Shard],
                 offsets: Dict[int, int],
                 stale_shards: Optional[List[Dict[str, Any]]] = None,
                 unreadable_shards: Optional[List[Dict[str, Any]]]
                 = None):
        self.shards = shards
        self.offsets = offsets
        # shards from OTHER run_ids found in the directory (a reused
        # obs_fleet_dir) — excluded from the merge, surfaced so the
        # timeline never silently interleaves two runs
        self.stale_shards = list(stale_shards or [])
        # shard files that could not be read at all (empty file, torn
        # header): skipped, never fatal — one dead rank's unreadable
        # shard must not cost the survivors' timeline
        self.unreadable_shards = list(unreadable_shards or [])
        self.run_id = next(iter(shards.values())).run_id if shards else ""
        self.events: List[Dict[str, Any]] = []
        for r, sh in sorted(shards.items()):
            off = offsets.get(r, 0)
            for e in sh.events:
                e = dict(e)
                e["orig_rank"] = r
                e["t_ns"] = sh.wall_of(int(e["ts_ns"])) - off
                self.events.append(e)
        self.events.sort(key=lambda e: (e["t_ns"], e["orig_rank"],
                                        e.get("id", 0)))

    @property
    def torn_lines(self) -> int:
        return sum(sh.torn_lines for sh in self.shards.values())


def estimate_offsets(shards: Dict[int, Shard]) -> Dict[int, int]:
    """Per-rank wall-clock offset (rank_wall - reference_wall) from the
    handshake's bidirectional ``clock_probe`` samples.

    One probe "a observed b" gives ``d_ab = self_wall_a - peer_wall_b =
    offset_ab + delay`` with ``delay >= 0``; the minimum over samples
    approaches the true offset plus minimal delay. With probes both
    ways, ``offset_ab ~= (min d_ab - min d_ba) / 2`` — the classic
    NTP estimate, robust to either SIGN of skew. Reference = lowest
    original rank present; ranks with no usable probe pair fall back to
    one-way bound, then to 0 (same-host shards are near-aligned
    already)."""
    ranks = sorted(shards)
    if not ranks:
        return {}
    ref = ranks[0]
    # min one-way sample per ordered pair
    d: Dict[Tuple[int, int], int] = {}
    for a, sh in shards.items():
        for e in sh.events:
            if e.get("name") != "clock_probe":
                continue
            args = e.get("args") or {}
            try:
                b = int(args["peer"])
                sample = int(args["self_wall_ns"]) - int(
                    args["peer_wall_ns"])
            except (KeyError, TypeError, ValueError):
                continue
            key = (a, b)
            d[key] = sample if key not in d else min(d[key], sample)
    offsets = {ref: 0}
    for r in ranks[1:]:
        fwd, back = d.get((r, ref)), d.get((ref, r))
        if fwd is not None and back is not None:
            offsets[r] = (fwd - back) // 2
        elif fwd is not None:
            offsets[r] = fwd         # upper bound: offset + min delay
        elif back is not None:
            offsets[r] = -back
        else:
            offsets[r] = 0
    return offsets


def merge_dir(fleet_dir: str) -> FleetTrace:
    """Read every ``shard_r*.jsonl`` under `fleet_dir`, estimate clock
    offsets from the piggybacked probes, and return the aligned merged
    trace (dead ranks' truncated shards included — their lane simply
    ends at the death).

    A REUSED fleet dir can hold leftover shards from an earlier run
    (each rank only overwrites its OWN file): shards are partitioned by
    run_id and only the NEWEST run (by header wall clock) merges —
    mixing runs would interleave a previous run's failover into this
    one's storyline. Excluded shards surface in ``stale_shards``, the
    same honesty rule ``rollup_metrics`` enforces by refusing."""
    by_run: Dict[str, Dict[int, Shard]] = {}
    unreadable: List[Dict[str, Any]] = []
    for name in sorted(os.listdir(fleet_dir)):
        if not (name.startswith(SHARD_PREFIX)
                and name.endswith(".jsonl")):
            continue
        path = os.path.join(fleet_dir, name)
        try:
            sh = Shard(path)
        except (OSError, ValueError) as e:
            # a rank killed before its header flushed (or a truncated
            # disk-full shard) must not abort the POSTMORTEM view the
            # tool exists for — skip it, surfaced like stale shards
            unreadable.append({"path": path, "error": str(e)})
            continue
        by_run.setdefault(sh.run_id, {})[sh.orig_rank] = sh
    if not by_run:
        detail = ("; unreadable: "
                  + ", ".join(u["path"] for u in unreadable)
                  if unreadable else "")
        raise ValueError(f"no usable {SHARD_PREFIX}*.jsonl shards in "
                         f"{fleet_dir!r}{detail}")
    newest = max(by_run, key=lambda rid: max(
        h["wall_ns"] for sh in by_run[rid].values()
        for h in sh.headers))
    shards = by_run.pop(newest)
    stale = [{"run_id": rid, "orig_rank": r, "path": sh.path}
             for rid, group in sorted(by_run.items())
             for r, sh in sorted(group.items())]
    return FleetTrace(shards, estimate_offsets(shards),
                      stale_shards=stale, unreadable_shards=unreadable)


def chrome_fleet_trace(merged: FleetTrace) -> Dict[str, Any]:
    """One Chrome/Perfetto timeline over every rank: pid = ORIGINAL
    rank (the stable lane), process_name metadata names the lane with
    its generation history + final rank, and a synthetic "failover
    storyline" lane (pid 9999) carries the causally-ordered CAT_RESIL
    chain so the recovery reads as one span sequence."""
    t0 = min((e["t_ns"] for e in merged.events), default=0)
    out: List[Dict[str, Any]] = []
    for r, sh in sorted(merged.shards.items()):
        gens = "/".join(f"g{g}" for g in sh.generations)
        last = sh.headers[-1]
        out.append({"ph": "M", "pid": r, "tid": 0, "name": "process_name",
                    "args": {"name": f"rank {r} ({gens}, now rank "
                                     f"{last['rank']})"}})
    for e in merged.events:
        d: Dict[str, Any] = {
            "name": e["name"], "cat": e["cat"], "pid": e["orig_rank"],
            "tid": e.get("tid", 0), "ts": (e["t_ns"] - t0) / 1e3,
        }
        if e.get("ph") == "X":
            d["ph"] = "X"
            d["dur"] = e.get("dur_ns", 0) / 1e3
        else:
            d["ph"] = "i"
            d["s"] = "t"
        # copy: the merged events' args are shared with the storyline/
        # report views — stamping gen/rank here must not mutate them
        d["args"] = dict(e.get("args") or {})
        d["args"]["gen"] = e.get("gen", 0)
        d["args"]["rank"] = e.get("rank", e["orig_rank"])
        out.append(d)
    story = failover_storyline(merged)
    # ONE causally-ordered storyline lane even for CHAINED recoveries;
    # the lane name carries the full generation traversal (g0→g1→g2
    # for a double failover), matching the per-rank lanes' history
    gens = storyline_generations(story)
    lane_name = "failover storyline"
    if len(gens) > 1:
        lane_name += " (" + "→".join(f"g{g}" for g in gens) + ")"
    out.append({"ph": "M", "pid": 9999, "tid": 0, "name": "process_name",
                "args": {"name": lane_name}})
    for i, s in enumerate(story):
        nxt = story[i + 1]["t_ns"] if i + 1 < len(story) else s["t_ns"]
        out.append({"name": f"{s['seq']}:{s['name']}@r{s['orig_rank']}",
                    "cat": CAT_RESIL, "pid": 9999, "tid": 0, "ph": "X",
                    "ts": (s["t_ns"] - t0) / 1e3,
                    "dur": max((nxt - s["t_ns"]) / 1e3, 1.0),
                    "args": dict(s.get("args") or {}, gen=s.get("gen", 0),
                                 chain_gen=s.get("chain_gen", 0),
                                 rank=s["orig_rank"])})
    # the rolling-update lane (pid 9998): present only when a rollout
    # actually ran, so pre-fleet traces render byte-identically
    rollout = rollout_storyline(merged)
    if rollout:
        out.append({"ph": "M", "pid": 9998, "tid": 0,
                    "name": "process_name",
                    "args": {"name": "fleet_rollout"}})
        for i, s in enumerate(rollout):
            nxt = (rollout[i + 1]["t_ns"] if i + 1 < len(rollout)
                   else s["t_ns"])
            out.append({"name": f"{s['seq']}:{s['name']}@r{s['orig_rank']}",
                        "cat": CAT_RESIL, "pid": 9998, "tid": 0, "ph": "X",
                        "ts": (s["t_ns"] - t0) / 1e3,
                        "dur": max((nxt - s["t_ns"]) / 1e3, 1.0),
                        "args": dict(s.get("args") or {},
                                     gen=s.get("gen", 0),
                                     rank=s["orig_rank"])})
    meta: Dict[str, Any] = {"displayTimeUnit": "ms", "traceEvents": out,
                            "otherData": {"run_id": merged.run_id,
                                          "ranks": sorted(merged.shards),
                                          "generations": gens,
                                          "clock_offsets_ns":
                                              merged.offsets}}
    if merged.torn_lines:
        meta["otherData"]["torn_lines"] = merged.torn_lines
    if merged.stale_shards:
        meta["otherData"]["stale_shards"] = merged.stale_shards
    if merged.unreadable_shards:
        meta["otherData"]["unreadable_shards"] = \
            merged.unreadable_shards
    return meta


def failover_storyline(merged: FleetTrace) -> List[Dict[str, Any]]:
    """The CAT_RESIL recovery chain, causally ordered across ranks by
    aligned time — ONE lane even when recoveries CHAIN (second death
    mid-reform, reattach then failover, grow-back after a reform): each
    episode repeats fault -> election -> reinit -> mesh_reform ->
    reshard -> resume at its own generation, and the ``chain_gen``
    field carries the generation the fleet had REACHED by that event
    (monotonic — the 0→1→2 traversal ``storyline_generations``
    summarizes), so a reader can segment the lane without assuming a
    single detach→reform chain. Returns one entry per event with a
    fleet-wide sequence number.

    Rollout events are CAT_RESIL too (they feed the resilience rollup)
    but narrate a *planned* membership change — they get their own
    ``rollout_storyline`` lane and are excluded here so a rolling
    update never reads as a failure chain."""
    chain = [e for e in merged.events
             if e.get("cat") == CAT_RESIL
             and e["name"] not in ROLLOUT_EVENTS]
    out: List[Dict[str, Any]] = []
    reached = 0
    for i, e in enumerate(chain):
        args = e.get("args") or {}
        g = int(e.get("gen", 0) or 0)
        try:
            g = max(g, int(args.get("generation", 0) or 0))
        except (TypeError, ValueError):
            pass
        reached = max(reached, g)
        out.append({"seq": i, "name": e["name"],
                    "orig_rank": e["orig_rank"], "rank": e.get("rank"),
                    "gen": e.get("gen", 0), "chain_gen": reached,
                    "t_ns": e["t_ns"], "args": args})
    return out


def rollout_storyline(merged: FleetTrace) -> List[Dict[str, Any]]:
    """The rolling-update chain, causally ordered across ranks by
    aligned time: ``rollout_start -> rollout_load* -> rollout_shift* ->
    rollout_drain -> rollout_retire* -> rollout_done`` for each g→g+1
    update. Each entry carries ``from_gen``/``to_gen`` (the PROGRAM
    generations being shifted, independent of the mesh generation in
    ``gen``) plus the traffic weight for shift events, so a reader can
    replay the weight schedule and confirm bounded rework."""
    chain = [e for e in merged.events if e["name"] in ROLLOUT_EVENTS]
    out: List[Dict[str, Any]] = []
    for i, e in enumerate(chain):
        args = e.get("args") or {}
        out.append({"seq": i, "name": e["name"],
                    "orig_rank": e["orig_rank"], "rank": e.get("rank"),
                    "gen": e.get("gen", 0),
                    "from_gen": args.get("from_gen"),
                    "to_gen": args.get("to_gen"),
                    "t_ns": e["t_ns"], "args": args})
    return out


def render_rollout_storyline(story: Sequence[Dict[str, Any]]) -> str:
    if not story:
        return "Rollout storyline: no rollout events recorded"
    t0 = story[0]["t_ns"]
    # load/retire events carry only one side of the pair: headline the
    # fully-specified g→g+1 shifts
    pairs = sorted({(s["from_gen"], s["to_gen"]) for s in story
                    if s.get("from_gen") is not None
                    and s.get("to_gen") is not None})
    head = f"Rollout storyline ({len(story)} events"
    if pairs:
        head += ", " + ", ".join(f"g{a}→g{b}" for a, b in pairs)
    lines = [head + "):"]
    for s in story:
        args = s.get("args") or {}
        keys = ("from_gen", "to_gen", "weight", "port", "in_flight",
                "reworked", "attempt", "responses")
        detail = ", ".join(f"{k}={args[k]}" for k in keys if k in args)
        lines.append(
            f"  {s['seq']:>3}  +{(s['t_ns'] - t0) / 1e6:9.3f}ms  "
            f"r{s['orig_rank']}  {s['name']}"
            + (f"  ({detail})" if detail else ""))
    return "\n".join(lines)


def storyline_generations(story: Sequence[Dict[str, Any]]) -> List[int]:
    """The generation chain the storyline traverses in causal order —
    ``[0, 1, 2]`` for a double failover (or a failover whose reinit was
    abandoned and re-elected), ``[0, 1]`` for a single reform or a
    reattach. The full history is the lane's name material: a chained
    recovery must read as one causally-ordered traversal, never as a
    single detach→reform assumed-shape."""
    gens: List[int] = []
    for s in story:
        g = int(s.get("chain_gen", s.get("gen", 0)) or 0)
        if not gens or g > gens[-1]:
            gens.append(g)
    return gens


def render_storyline(story: Sequence[Dict[str, Any]]) -> str:
    if not story:
        return "Failover storyline: no CAT_RESIL events recorded"
    t0 = story[0]["t_ns"]
    gens = storyline_generations(story)
    head = f"Failover storyline ({len(story)} events"
    if len(gens) > 1:
        head += ", generations " + "→".join(str(g) for g in gens)
    lines = [head + "):"]
    reached = 0
    for s in story:
        args = s.get("args") or {}
        keys = ("site", "kind", "step", "dead", "newly_dead",
                "coordinator", "nproc", "rank", "rework_iters",
                "readmitted", "generation", "attempt")
        detail = ", ".join(f"{k}={args[k]}" for k in keys if k in args)
        g = int(s.get("chain_gen", s.get("gen", 0)) or 0)
        if g > reached:
            # a generation boundary inside the ONE lane: the chain
            # moved to a new membership epoch here
            lines.append(f"  --- generation {reached} → {g} ---")
            reached = g
        lines.append(
            f"  {s['seq']:>3}  +{(s['t_ns'] - t0) / 1e6:9.3f}ms  "
            f"r{s['orig_rank']} g{s.get('gen', 0)}  {s['name']}"
            + (f"  ({detail})" if detail else ""))
    return "\n".join(lines)


def overload_summary(merged: FleetTrace) -> Dict[str, Any]:
    """Aggregate overload-protection decisions across the merged fleet
    (``OVERLOAD_EVENTS``): counts by event name, by ``name[reason]``
    label, and shed totals per original rank. One merged view of every
    refusal the fleet made under load — the fleet-trace CLI renders it
    and the 3-process overload harness asserts its shed counts through
    the real CLI, not process-local counters."""
    by_name: Dict[str, int] = {}
    by_reason: Dict[str, int] = {}
    by_rank: Dict[int, int] = {}
    for e in merged.events:
        if e["name"] not in OVERLOAD_EVENTS:
            continue
        args = e.get("args") or {}
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
        reason = args.get("reason")
        if reason:
            key = f"{e['name']}[{reason}]"
            by_reason[key] = by_reason.get(key, 0) + 1
        r = int(e.get("orig_rank", -1))
        by_rank[r] = by_rank.get(r, 0) + 1
    return {"total": sum(by_name.values()), "by_name": by_name,
            "by_reason": by_reason, "by_rank": by_rank}


def render_overload_summary(summary: Dict[str, Any]) -> str:
    if not summary.get("total"):
        return "Overload: no shed/refusal events recorded"
    lines = [f"Overload ({summary['total']} events):"]
    for key, n in sorted(summary["by_reason"].items()):
        lines.append(f"  {key:<40} {n}")
    unreasoned = {k: v for k, v in summary["by_name"].items()
                  if not any(r.startswith(k + "[")
                             for r in summary["by_reason"])}
    for key, n in sorted(unreasoned.items()):
        lines.append(f"  {key:<40} {n}")
    ranks = ", ".join(f"r{r}={n}" for r, n in
                      sorted(summary["by_rank"].items()))
    lines.append(f"  by rank: {ranks}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# straggler & skew attribution
# --------------------------------------------------------------------------

def fleet_report(merged: FleetTrace, window: int = 5) -> Dict[str, Any]:
    """Straggler attribution over the per-rank ``fleet_step`` events:
    per step-window the slowest rank (by summed step time), and the
    fleet wall split compute / exposed-DCN / straggler-wait.

    straggler-wait for a rank at step s is (slowest rank's aligned
    completion) - (its own aligned completion): time the fleet's
    lockstep cadence left it idle. exposed-DCN comes from the
    ``exposed_comm`` windows (parallel/overlap.py); compute is the
    remainder of the rank's own step time. ``dist_op``/``dcn_bucket``
    traffic is tallied per rank alongside."""
    # (gen, step) -> {rank: (t_end_ns, dur_ns)}
    window = max(1, int(window))
    # (gen, epoch, step) -> {rank: (aligned_end_ns, dur_ns)}: the epoch
    # (recovery count) keeps a post-shrink REPLAY of step s from
    # pairing with a dead rank's pre-fault execution of the same s
    steps: Dict[Tuple[int, int, int], Dict[int, Tuple[int, int]]] = {}
    per_rank: Dict[int, Dict[str, Any]] = {
        r: {"steps": 0, "step_s": 0.0, "exposed_dcn_s": 0.0,
            "straggler_wait_s": 0.0, "dist_ops": 0, "dist_op_bytes": 0,
            "dcn_buckets": 0, "dcn_bucket_bytes": 0}
        for r in merged.shards}
    for e in merged.events:
        r = e["orig_rank"]
        args = e.get("args") or {}
        if e["name"] == "fleet_step":
            key = (int(e.get("gen", 0)), int(args.get("epoch", 0) or 0),
                   int(args.get("step", -1)))
            dur = int(args.get("dur_ns", 0) or 0)
            steps.setdefault(key, {})[r] = (e["t_ns"], dur)
            per_rank[r]["steps"] += 1
            per_rank[r]["step_s"] += dur / 1e9
        elif e["name"] == "exposed_comm":
            per_rank[r]["exposed_dcn_s"] += int(
                args.get("exposed_ns", 0) or 0) / 1e9
        elif e["name"] == "dist_op":
            per_rank[r]["dist_ops"] += 1
            per_rank[r]["dist_op_bytes"] += int(args.get("bytes", 0) or 0)
        elif e["name"] == "dcn_bucket":
            per_rank[r]["dcn_buckets"] += 1
            per_rank[r]["dcn_bucket_bytes"] += int(
                args.get("bytes", 0) or 0)
    # straggler wait per shared step; slowest rank per window
    windows: Dict[Tuple[int, int, int], Dict[int, float]] = {}
    for (gen, epoch, step), ranks in steps.items():
        if len(ranks) >= 2:
            t_max = max(t for t, _ in ranks.values())
            for r, (t_end, _d) in ranks.items():
                per_rank[r]["straggler_wait_s"] += (t_max - t_end) / 1e9
        w = windows.setdefault((gen, epoch, step // window), {})
        for r, (_t, dur) in ranks.items():
            w[r] = w.get(r, 0.0) + dur / 1e9
    win_rows = []
    for (gen, epoch, w), totals in sorted(windows.items()):
        slowest = max(totals, key=lambda r: totals[r])
        win_rows.append({
            "generation": gen, "epoch": epoch, "window": w,
            "steps": [w * window, (w + 1) * window - 1],
            "slowest_rank": slowest,
            "slowest_s": round(totals[slowest], 6),
            "per_rank_s": {r: round(t, 6)
                           for r, t in sorted(totals.items())}})
    for r, row in per_rank.items():
        row["compute_s"] = max(row["step_s"] - row["exposed_dcn_s"], 0.0)
    totals = {
        "compute_s": sum(r["compute_s"] for r in per_rank.values()),
        "exposed_dcn_s": sum(r["exposed_dcn_s"]
                             for r in per_rank.values()),
        "straggler_wait_s": sum(r["straggler_wait_s"]
                                for r in per_rank.values()),
    }
    slowest_overall = None
    if any(r["step_s"] > 0 for r in per_rank.values()):
        slowest_overall = max(per_rank, key=lambda r:
                              per_rank[r]["step_s"])
    return {"run_id": merged.run_id, "windows": win_rows,
            "per_rank": {r: per_rank[r] for r in sorted(per_rank)},
            "wall_split": totals, "slowest_rank": slowest_overall,
            "clock_offsets_ns": merged.offsets,
            "torn_lines": merged.torn_lines,
            "stale_shards": merged.stale_shards,
            "unreadable_shards": merged.unreadable_shards}


def render_fleet_report(rep: Dict[str, Any]) -> str:
    lines = [f"Fleet report (run {rep['run_id']}, "
             f"{len(rep['per_rank'])} ranks)"
             + (f" — {rep['torn_lines']} torn shard line(s) tolerated"
                if rep.get("torn_lines") else "")]
    ws = rep["wall_split"]
    lines.append(
        f"  wall split: compute={ws['compute_s']:.4f}s, "
        f"exposed_dcn={ws['exposed_dcn_s']:.4f}s, "
        f"straggler_wait={ws['straggler_wait_s']:.4f}s"
        + (f"; slowest rank overall: r{rep['slowest_rank']}"
           if rep.get("slowest_rank") is not None else ""))
    for r, row in sorted(rep["per_rank"].items()):
        lines.append(
            f"  r{r}: steps={row['steps']} ({row['step_s']:.4f}s), "
            f"wait={row['straggler_wait_s']:.4f}s, "
            f"dist_ops={row['dist_ops']}/{row['dist_op_bytes']}B, "
            f"dcn_buckets={row['dcn_buckets']}/"
            f"{row['dcn_bucket_bytes']}B")
    for w in rep["windows"]:
        lines.append(
            f"  window g{w['generation']}/e{w.get('epoch', 0)} steps "
            f"{w['steps'][0]}-{w['steps'][1]}: slowest r"
            f"{w['slowest_rank']} ({w['slowest_s']:.4f}s; "
            + ", ".join(f"r{r}={t:.4f}"
                        for r, t in w["per_rank_s"].items()) + ")")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# fleet metrics rollup
# --------------------------------------------------------------------------

def write_metrics_snapshot(fleet_dir: str, stats,
                           extra: Optional[Dict[str, Any]] = None
                           ) -> str:
    """Persist this rank's metrics snapshot (``Statistics.to_dict()``
    stamped with the fleet identity) as
    ``metrics_r<orig>.json`` — atomic rename, so a reader never sees a
    torn snapshot. Returns the path."""
    ident = _identity
    if ident is None:
        raise RuntimeError("no fleet identity set")
    os.makedirs(fleet_dir, exist_ok=True)
    snap = {"identity": ident.to_dict(),
            "metrics": stats.to_dict() if hasattr(stats, "to_dict")
            else dict(stats)}
    if extra:
        snap["extra"] = extra
    path = os.path.join(fleet_dir,
                        f"{METRICS_PREFIX}{ident.orig_rank:03d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f)
    os.replace(tmp, path)
    return path


def load_metrics_snapshots(fleet_dir: str,
                           run_id: Optional[str] = None
                           ) -> List[Dict[str, Any]]:
    """Per-rank snapshots from `fleet_dir`. With `run_id`, snapshots
    left by OTHER runs in a reused directory are filtered out — the
    graceful sibling of ``rollup_metrics``'s mixed-run refusal (a
    caller that knows its run must not lose the whole rollup to one
    stale file)."""
    out = []
    for name in sorted(os.listdir(fleet_dir)):
        if name.startswith(METRICS_PREFIX) and name.endswith(".json"):
            with open(os.path.join(fleet_dir, name)) as f:
                snap = json.load(f)
            if run_id is not None and \
                    (snap.get("identity") or {}).get("run_id") != run_id:
                continue
            out.append(snap)
    return out


def _merge_values(name: str, vals: List[Any]) -> Any:
    """Merge one metric across ranks by snapshot shape + naming
    convention: histograms ({buckets,sum,count}) merge bucket-wise,
    labeled families sum per label, scalar ``*_total``/``*_count``
    counters sum, remaining scalars (gauges, ``*_seconds`` clocks)
    take the max — a fleet's run clock is its slowest rank's."""
    first = vals[0]
    if isinstance(first, dict) and "buckets" in first \
            and "count" in first:
        buckets: Dict[str, float] = {}
        s = c = 0
        for v in vals:
            for le, n in (v.get("buckets") or {}).items():
                buckets[le] = buckets.get(le, 0) + n
            s += v.get("sum", 0)
            c += v.get("count", 0)
        return {"buckets": buckets, "sum": s, "count": c}
    if isinstance(first, dict):
        out: Dict[str, Any] = {}
        for v in vals:
            for k, n in v.items():
                out[k] = out.get(k, 0) + n
        return {k: out[k] for k in sorted(out)}
    if name.endswith(("_total", "_count")):
        return sum(vals)
    return max(vals)


def rollup_metrics(snapshots: Sequence[Dict[str, Any]]
                   ) -> Dict[str, Any]:
    """Aggregate per-rank registry snapshots into ONE fleet view:
    ``fleet`` holds the merged metrics, ``ranks`` the per-rank identity
    (orig rank -> current rank, generation) so labels stay auditable.
    All snapshots must share one run_id — mixing runs is the silent
    drift this layer exists to kill."""
    if not snapshots:
        return {"run_id": "", "ranks": {}, "fleet": {}}
    run_ids = {s["identity"]["run_id"] for s in snapshots}
    if len(run_ids) > 1:
        raise ValueError(f"snapshots from different runs: "
                         f"{sorted(run_ids)}")
    names: Dict[str, List[Any]] = {}
    ranks: Dict[int, Dict[str, Any]] = {}
    for s in snapshots:
        ident = s["identity"]
        ranks[int(ident["orig_rank"])] = {
            "rank": int(ident["rank"]),
            "generation": int(ident["generation"])}
        for name, v in (s.get("metrics") or {}).items():
            names.setdefault(name, []).append(v)
    fleet = {name: _merge_values(name, vals)
             for name, vals in sorted(names.items())}
    return {"run_id": run_ids.pop(),
            "ranks": {r: ranks[r] for r in sorted(ranks)},
            "fleet": fleet}


def render_fleet_stats(rollup: Dict[str, Any], top: int = 8) -> str:
    """The `-stats` fleet section rank 0 prints: who contributed (rank
    + generation labels), then the summed counter families that tell
    the run's story — steps, resilience events, mesh traffic."""
    ranks = rollup.get("ranks") or {}
    fleet = rollup.get("fleet") or {}
    lines = [f"Fleet statistics (run {rollup.get('run_id', '?')}, "
             f"{len(ranks)} rank(s)):"]
    lines.append("  ranks: " + ", ".join(
        f"r{orig}->rank{info['rank']}@gen{info['generation']}"
        for orig, info in sorted(ranks.items())))
    steps = fleet.get("fleet_steps_total")
    if steps:
        lines.append(f"  fleet steps completed: {steps}")
    resil = fleet.get("resil_events_total")
    if isinstance(resil, dict) and resil:
        lines.append("  resilience events (summed): " + ", ".join(
            f"{k}={v}" for k, v in sorted(resil.items())))
    mesh = fleet.get("mesh_op_total")
    if isinstance(mesh, dict) and mesh:
        lines.append("  mesh ops (summed): " + ", ".join(
            f"{k}={v}" for k, v in sorted(mesh.items())))
    dropped = fleet.get("trace_dropped_events")
    if dropped:
        lines.append(f"  trace events dropped (ring eviction, fleet "
                     f"max): {dropped}")
    scalars = {k: v for k, v in fleet.items()
               if isinstance(v, (int, float)) and v
               and k not in ("fleet_steps_total", "trace_dropped_events")}
    if scalars:
        top_items = sorted(scalars.items(),
                           key=lambda kv: -abs(kv[1]))[:top]
        lines.append("  top fleet counters: " + ", ".join(
            f"{k}={round(v, 6)}" for k, v in top_items))
    return "\n".join(lines)
