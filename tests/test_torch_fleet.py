"""Fleet observability of the port (systemml_tpu_torch/obs/fleet.py and
`python -m systemml_tpu_torch.obs.fleet_trace`) against the JAX package's
(systemml_tpu/obs/fleet.py, scripts/fleet_trace.py) on the CPU: the
analogues of tests/test_fleet.py.

The same event lists, with the same identities, skews and re-stamps, go
through both packages' FleetShardWriter (each module's clock replaced by
one that reads the event's time) into two directories; the shards must
be byte-identical. Then `merge_dir`, `estimate_offsets` (both signs of
skew), `chrome_fleet_trace`, both storylines and their renderers,
`fleet_report`, `overload_summary` and the metrics rollups of each
package must be equal: dicts and text exactly, offsets exactly on the
integer nanoseconds. The live path (attach_shard, set_identity,
handshake payloads, re-attach) runs in each package and the two shards
must agree on every stamped field. The torn-tail, stale-shard,
headerless-shard and reattach cases are here, and the merge command of
each package runs on the same directory with equal output.

Waiting, and named in ROADMAP: `test_negotiated_run_id_unique_per_launch`
(it needs the multi-process runtime, item 12),
`test_check_metrics_fleet_coverage_catches_unrendered_event` (the lints,
item 11b), `test_prometheus_const_labels_rank_generation` and the CLI's
`-stats` fleet section (item 12).
"""

import json
import os
import subprocess
import sys

import pytest

from systemml_tpu.obs import fleet as jfleet
from systemml_tpu.obs import trace as jtrace
from systemml_tpu.utils.stats import Statistics as JStatistics
from systemml_tpu_torch.obs import fleet as pfleet
from systemml_tpu_torch.obs import trace as ptrace
from systemml_tpu_torch.utils.stats import Statistics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000  # ns
WALL0 = 1_000_000 * MS
PERF0 = 500 * MS
PKGS = {"jax": (jfleet, jtrace), "torch": (pfleet, ptrace)}


@pytest.fixture(autouse=True)
def _clean_identity():
    jfleet.clear_identity()
    pfleet.clear_identity()
    yield
    jfleet.clear_identity()
    pfleet.clear_identity()


class _Clock:
    """Stands in for a fleet module's `time`: the wall and perf clocks of
    a host whose wall clock is `skew_ns` off true time, at true time
    `t` (ns since the run's start)."""

    def __init__(self, skew_ns=0):
        self.t = 0
        self.skew = skew_ns

    def time_ns(self):
        return WALL0 + self.skew + self.t

    def perf_counter_ns(self):
        return PERF0 + self.t


def _write(pkg, path, orig, events, monkeypatch, skew_ns=0, gens=None,
           run_id="run-t"):
    """One rank's shard through `pkg`'s FleetShardWriter: a header at
    true time 0, the (name, cat, t, args) events in order, and a
    re-stamp (rank 0, generation g, 2 processes) at each `gens` time."""
    fleet, trace = PKGS[pkg]
    clock = _Clock(skew_ns)
    with monkeypatch.context() as mp:
        mp.setattr(fleet, "time", clock)
        _write_events(fleet, trace, clock, path, orig, events, gens,
                      run_id)
    return path


def _write_events(fleet, trace, clock, path, orig, events, gens, run_id):
    w = fleet.FleetShardWriter(
        path, fleet.FleetIdentity(run_id, orig, orig, 0, nproc=3))
    restamps = sorted((gens or {}).items(), key=lambda kv: kv[1])
    for i, (name, cat, t, args) in enumerate(events):
        while restamps and restamps[0][1] <= t:
            g, tg = restamps.pop(0)
            clock.t = tg
            w.restamp(fleet.FleetIdentity(run_id, orig, 0, g, nproc=2))
        clock.t = t
        w(trace.TraceEvent(i + 1, name, cat, "i", PERF0 + t, 0, 1, None,
                           dict(args)))
    for g, tg in restamps:
        clock.t = tg
        w.restamp(fleet.FleetIdentity(run_id, orig, 0, g, nproc=2))
    w.close()


def _both(tmp_path, monkeypatch, shards):
    """Writes `shards` ({file name: (orig, events, kwargs)}) through both
    packages into tmp_path/jax and tmp_path/torch, asserts the files
    byte-identical, and returns the two directories."""
    dirs = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        for fname, (orig, events, kw) in shards.items():
            _write(pkg, str(d / fname), orig, events, monkeypatch, **kw)
        dirs[pkg] = d
    for fname in shards:
        assert (dirs["jax"] / fname).read_bytes() == \
            (dirs["torch"] / fname).read_bytes(), fname
    return dirs


def _strip_paths(obj, dirs):
    """`obj` with each directory's path replaced by one name, so that
    two packages' views of their own directory compare equal."""
    text = json.dumps(obj, sort_keys=True, default=str)
    for d in dirs.values():
        text = text.replace(str(d), "<dir>")
    return json.loads(text)


def _views(merged, fleet, window=5):
    story = fleet.failover_storyline(merged)
    rollout = fleet.rollout_storyline(merged)
    overload = fleet.overload_summary(merged)
    report = fleet.fleet_report(merged, window=window)
    return {
        "run_id": merged.run_id, "ranks": sorted(merged.shards),
        "offsets": merged.offsets, "torn": merged.torn_lines,
        "stale": merged.stale_shards,
        "unreadable": merged.unreadable_shards,
        "events": merged.events,
        "generations": {r: sh.generations
                        for r, sh in merged.shards.items()},
        "storyline": story, "story_text": fleet.render_storyline(story),
        "story_gens": fleet.storyline_generations(story),
        "rollout": rollout,
        "rollout_text": fleet.render_rollout_storyline(rollout),
        "overload": overload,
        "overload_text": fleet.render_overload_summary(overload),
        "report": report, "report_text": fleet.render_fleet_report(report),
        "chrome": fleet.chrome_fleet_trace(merged)}


def _merged_equal(dirs, window=5):
    """Both packages' merges of their directories, asserted equal view by
    view; returns the port's merge and views."""
    views = {}
    merged = {}
    for pkg, d in dirs.items():
        fleet = PKGS[pkg][0]
        merged[pkg] = fleet.merge_dir(str(d))
        views[pkg] = _strip_paths(_views(merged[pkg], fleet, window), dirs)
    for key in views["jax"]:
        assert views["torch"][key] == views["jax"][key], key
    return merged["torch"], views["torch"]


def _probe(peer, announced_t, seen_t, skew_self, skew_peer):
    """Args of a clock_probe as note_peer_ready records them: the peer's
    announced wall (its clock) and our observation wall (ours)."""
    return {"peer": peer, "step": 0,
            "peer_wall_ns": WALL0 + announced_t + skew_peer,
            "self_wall_ns": WALL0 + seen_t + skew_self}


def _step(t, s, dur=MS, **extra):
    return ("fleet_step", "fleet", t, dict({"step": s, "dur_ns": dur},
                                           **extra))


# --------------------------------------------------------------------------
# identity and the shard writer, live
# --------------------------------------------------------------------------

def _live_shard(pkg, tmp_path):
    fleet, T = PKGS[pkg]
    fleet.set_identity("run-a", orig_rank=2, rank=2, generation=0, nproc=3)
    rec = T.FlightRecorder()
    prev = T.install(rec)
    try:
        w = fleet.attach_shard(rec, str(tmp_path / pkg))
        T.instant("fleet_step", T.CAT_FLEET, step=0, dur_ns=MS)
        # a reform renumbers rank 2 -> 1 and bumps the generation: the
        # writer re-stamps and later events carry the new tags
        fleet.set_identity("run-a", orig_rank=2, rank=1, generation=1,
                           nproc=2)
        T.instant("fleet_step", T.CAT_FLEET, step=1, dur_ns=MS)
        w.close()
    finally:
        T.install(prev)
    return fleet.Shard(fleet.shard_path(str(tmp_path / pkg), 2))


def test_shard_writer_stamps_identity_and_restamps_on_reform(tmp_path):
    shards = {pkg: _live_shard(pkg, tmp_path) for pkg in PKGS}
    for sh in shards.values():
        assert sh.orig_rank == 2 and sh.run_id == "run-a"
        assert sh.generations == [0, 1]
        assert [e["rank"] for e in sh.events] == [2, 1]
        assert [e["gen"] for e in sh.events] == [0, 1]
        assert sh.torn_lines == 0
    clocked = ("wall_ns", "perf_ns", "ts_ns", "id")
    p, j = shards["torch"], shards["jax"]
    assert [{k: v for k, v in h.items() if k not in clocked}
            for h in p.headers] == \
        [{k: v for k, v in h.items() if k not in clocked}
         for h in j.headers]
    assert [{k: v for k, v in e.items() if k not in clocked}
            for e in p.events] == \
        [{k: v for k, v in e.items() if k not in clocked}
         for e in j.events]
    assert os.path.basename(p.path) == os.path.basename(j.path) == \
        "shard_r002.jsonl"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_attach_shard_requires_identity_and_dir(tmp_path, pkg):
    fleet, T = PKGS[pkg]
    rec = T.FlightRecorder()
    with pytest.raises(RuntimeError, match="identity"):
        fleet.attach_shard(rec, str(tmp_path))
    fleet.set_identity("run-a", 0, 0)
    with pytest.raises(ValueError, match="fleet directory"):
        fleet.attach_shard(rec, "")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_handshake_payload_roundtrip_records_probe(pkg):
    fleet, T = PKGS[pkg]
    fleet.set_identity("run-a", orig_rank=1, rank=1)
    rec = T.FlightRecorder()
    prev = T.install(rec)
    try:
        payload = fleet.handshake_payload(step=4)
        d = json.loads(payload)
        assert d["rank"] == 1 and d["step"] == 4 and d["wall_ns"] > 0
        fleet.note_peer_ready(0, payload, step=4)
        fleet.note_peer_ready(0, "", step=4)          # empty ready file
        fleet.note_peer_ready(0, "gar{bage", step=4)  # torn payload
    finally:
        T.install(prev)
    evs = rec.events()
    assert [e.name for e in evs] == ["clock_announce", "clock_probe"]
    probe = evs[-1].args
    assert probe["peer"] == 0
    assert probe["self_wall_ns"] >= probe["peer_wall_ns"]


def test_identity_labels_and_run_ids_agree(monkeypatch):
    for fleet in (jfleet, pfleet):
        assert fleet.identity_labels() == {}
        fleet.set_identity("run-t", orig_rank=2, rank=1, generation=3)
    assert pfleet.identity_labels() == jfleet.identity_labels() == \
        {"rank": "1", "generation": "3"}
    monkeypatch.delenv("SMTPU_RUN_ID", raising=False)
    for coord, n in (("10.0.0.1:4000", 3), ("10.0.0.2:4000", 3),
                     ("h:1", 2)):
        assert pfleet.derive_run_id(coord, n) == \
            jfleet.derive_run_id(coord, n)
    a = pfleet.derive_run_id("10.0.0.1:4000", 3)
    assert a.startswith("run-") and a != pfleet.derive_run_id(
        "10.0.0.2:4000", 3)
    monkeypatch.setenv("SMTPU_RUN_ID", "launcher-7")
    assert pfleet.derive_run_id("10.0.0.1:4000", 3) == "launcher-7"


def test_note_step_counts_and_records_in_both(monkeypatch):
    from systemml_tpu.utils.stats import stats_scope as jscope
    from systemml_tpu_torch.utils.stats import stats_scope

    out = {}
    for pkg, (fleet, T), st, scope in (
            ("jax", PKGS["jax"], JStatistics(), jscope),
            ("torch", PKGS["torch"], Statistics(), stats_scope)):
        fleet.set_identity("run-t", orig_rank=0, rank=0, generation=2)
        rec = T.FlightRecorder()
        prev = T.install(rec)
        try:
            with scope(st):
                fleet.note_step(3, 5 * MS, epoch=1)
                fleet.note_step(4, 6 * MS)
        finally:
            T.install(prev)
        out[pkg] = ([(e.name, e.cat, e.args) for e in rec.events()],
                    st.fleet_steps, st.to_dict()["fleet_steps_total"])
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 2
    st = Statistics()
    st.count_step(2)
    assert "Elastic steps completed:\t2." in st.display()


# --------------------------------------------------------------------------
# merge edge cases
# --------------------------------------------------------------------------

def test_merge_tolerates_truncated_tail_from_dead_rank(tmp_path,
                                                       monkeypatch):
    dirs = _both(tmp_path, monkeypatch, {
        "shard_r000.jsonl": (0, [_step(1 * MS, 0)], {}),
        "shard_r001.jsonl": (1, [_step(2 * MS, 0)], {})})
    for d in dirs.values():   # rank 1 died mid-write: a torn half-line
        with open(d / "shard_r001.jsonl", "a") as f:
            f.write('{"id": 99, "name": "fleet_st')
    merged, views = _merged_equal(dirs)
    assert sorted(merged.shards) == [0, 1]
    assert merged.torn_lines == 1
    assert len(merged.events) == 2
    assert views["report"]["torn_lines"] == 1
    assert views["report"]["per_rank"]["1"]["steps"] == 1


def test_merge_excludes_stale_shards_from_reused_dir(tmp_path,
                                                     monkeypatch):
    dirs = _both(tmp_path, monkeypatch, {
        "shard_r002.jsonl": (2, [("mesh_reform", "resil", 1 * MS,
                                  {"step": 0})], {"run_id": "run-old"}),
        "shard_r000.jsonl": (0, [_step(1 * MS, 0)],
                             {"run_id": "run-new",
                              "skew_ns": 3_600_000 * MS}),
        "shard_r001.jsonl": (1, [_step(1 * MS, 0)],
                             {"run_id": "run-new",
                              "skew_ns": 3_600_000 * MS})})
    merged, views = _merged_equal(dirs)
    assert merged.run_id == "run-new"
    assert sorted(merged.shards) == [0, 1]
    assert [s["run_id"] for s in merged.stale_shards] == ["run-old"]
    assert views["storyline"] == []
    assert views["report"]["stale_shards"] == views["stale"]


def test_fleet_report_clamps_degenerate_window(tmp_path, monkeypatch):
    dirs = _both(tmp_path, monkeypatch, {
        "shard_r000.jsonl": (0, [_step((1 + s) * MS, s)
                                 for s in range(3)], {})})
    _, views = _merged_equal(dirs, window=0)
    assert [w["steps"] for w in views["report"]["windows"]] == \
        [[0, 0], [1, 1], [2, 2]]


def test_merge_rejects_empty_dir_and_all_unreadable(tmp_path):
    errors = {}
    for pkg, (fleet, _) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        with pytest.raises(ValueError, match="no usable") as e1:
            fleet.merge_dir(str(d))
        (d / "shard_r000.jsonl").write_text('{"id": 1}\n')
        with pytest.raises(ValueError, match="no usable.*shard_r000") as e2:
            fleet.merge_dir(str(d))
        errors[pkg] = [str(e.value).replace(str(d), "<dir>")
                       for e in (e1, e2)]
    assert errors["torch"] == errors["jax"]


def test_merge_skips_headerless_shard_keeping_survivors(tmp_path,
                                                        monkeypatch):
    dirs = _both(tmp_path, monkeypatch, {
        "shard_r000.jsonl": (0, [_step(1 * MS, 0)], {})})
    for d in dirs.values():
        (d / "shard_r001.jsonl").write_text("")          # empty
        (d / "shard_r002.jsonl").write_text('{"torn')    # torn header
    merged, views = _merged_equal(dirs)
    assert sorted(merged.shards) == [0]
    assert {os.path.basename(u["path"])
            for u in merged.unreadable_shards} == \
        {"shard_r001.jsonl", "shard_r002.jsonl"}
    assert views["report"]["unreadable_shards"] == views["unreadable"]


def test_merge_reform_generation_bump_renumbers_lane(tmp_path,
                                                     monkeypatch):
    dirs = _both(tmp_path, monkeypatch, {
        "shard_r001.jsonl": (1, [_step(1 * MS, 0),
                                 ("mesh_reform", "resil", 6 * MS,
                                  {"step": 0, "generation": 1}),
                                 _step(8 * MS, 1)], {"gens": {1: 6 * MS}})})
    merged, views = _merged_equal(dirs)
    assert merged.shards[1].generations == [0, 1]
    lane = next(e for e in views["chrome"]["traceEvents"]
                if e.get("name") == "process_name" and e.get("pid") == 1)
    assert "g0/g1" in lane["args"]["name"]
    assert "now rank 0" in lane["args"]["name"]
    assert {w["generation"] for w in views["report"]["windows"]} == {0, 1}


@pytest.mark.parametrize("skew1,skew2", [
    (5 * MS, -7 * MS),     # rank 1 ahead, rank 2 behind
    (-5 * MS, 7 * MS),     # both signs flipped
])
def test_clock_offset_estimation_both_signs(tmp_path, monkeypatch, skew1,
                                            skew2):
    """Three ranks, two skewed clocks, bidirectional probes with small
    asymmetric delays: both packages recover each skew to within the
    delay asymmetry, to the same integer nanosecond."""
    delays = (100_000, 150_000)
    t_ev = 10 * MS                # the same TRUE instant on every rank
    ranks = {0: 0, 1: skew1, 2: skew2}
    shards = {}
    for r, skew in ranks.items():
        probes = []
        for q, qskew in ranks.items():
            if q == r:
                continue
            probes.append(("clock_probe", "fleet", 2 * MS,
                           _probe(q, 1 * MS, 2 * MS + delays[0], skew,
                                  qskew)))
            probes.append(("clock_probe", "fleet", 4 * MS,
                           _probe(q, 3 * MS, 4 * MS + delays[1], skew,
                                  qskew)))
        shards[f"shard_r{r:03d}.jsonl"] = (
            r, probes + [_step(t_ev, 3)], {"skew_ns": skew})
    dirs = _both(tmp_path, monkeypatch, shards)
    merged, _ = _merged_equal(dirs)
    jmerged = jfleet.merge_dir(str(dirs["jax"]))
    assert pfleet.estimate_offsets(merged.shards) == \
        jfleet.estimate_offsets(jmerged.shards) == merged.offsets
    assert all(isinstance(v, int) for v in merged.offsets.values())
    tol = max(delays)
    assert abs(merged.offsets[1] - skew1) <= tol, merged.offsets
    assert abs(merged.offsets[2] - skew2) <= tol, merged.offsets
    aligned = {e["orig_rank"]: e["t_ns"] for e in merged.events
               if e["name"] == "fleet_step"}
    assert max(aligned.values()) - min(aligned.values()) <= 2 * tol
    raw = {r: merged.shards[r].wall_of(PERF0 + t_ev) for r in ranks}
    assert max(raw.values()) - min(raw.values()) >= 10 * MS


def test_one_way_probe_falls_back_and_no_probe_is_zero(tmp_path,
                                                       monkeypatch):
    dirs = _both(tmp_path, monkeypatch, {
        "shard_r000.jsonl": (0, [], {}),
        "shard_r001.jsonl": (1, [("clock_probe", "fleet", 2 * MS,
                                  _probe(0, 1 * MS, 2 * MS, 3 * MS, 0))],
                             {"skew_ns": 3 * MS}),
        "shard_r002.jsonl": (2, [], {})})
    merged, _ = _merged_equal(dirs)
    assert merged.offsets == {0: 0, 1: 3 * MS + 1 * MS, 2: 0}


# --------------------------------------------------------------------------
# storylines and the straggler report
# --------------------------------------------------------------------------

def _failover_shards(tmp_path, monkeypatch):
    """Two survivors (0, 1) of a 3-rank job whose rank 2 died: the
    recovery chain on each, slightly staggered and re-stamped at
    generation 1 by the reform; rank 1 straggles (slower steps)."""
    chain = (("coord_detach", 1 * MS, {"step": 1}),
             ("fault", 20 * MS, {"site": "collective.allreduce",
                                 "kind": "worker_lost"}),
             ("election", 21 * MS, {"coordinator": "h:1", "nproc": 2,
                                    "generation": 1}),
             ("reinit", 23 * MS, {"generation": 1}),
             ("mesh_reform", 25 * MS, {"generation": 1, "nproc": 2}),
             ("reshard", 26 * MS, {"step": 6}),
             ("resume", 27 * MS, {"step": 6, "generation": 1}),
             ("fleet_route_epoch", 28 * MS, {"epoch": 1, "dead": [2],
                                             "reason": "transport"}))
    shards = {}
    for r, stagger in ((0, 0), (1, 30_000)):
        dur = MS if r == 0 else 3 * MS
        evs = [(n, "resil", t + stagger, a) for n, t, a in chain]
        evs += [_step((2 + s) * 4 * MS + dur + stagger, s, dur)
                for s in range(4)]
        evs += [("exposed_comm", "mesh", 9 * MS + stagger,
                 {"exposed_ns": MS // 2, "window_ns": MS}),
                ("dist_op", "mesh", 9 * MS + stagger,
                 {"op": "tsmm", "bytes": 1024}),
                ("dcn_bucket", "mesh", 9 * MS + stagger, {"bytes": 256})]
        evs.sort(key=lambda e: e[2])
        shards[f"shard_r{r:03d}.jsonl"] = (r, evs,
                                           {"gens": {1: 24 * MS}})
    shards["shard_r002.jsonl"] = (2, [_step((2 + s) * 4 * MS + MS, s)
                                      for s in range(2)], {})
    return _both(tmp_path, monkeypatch, shards)


def test_failover_storyline_orders_chain_across_ranks(tmp_path,
                                                      monkeypatch):
    merged, views = _merged_equal(_failover_shards(tmp_path, monkeypatch))
    names = [s["name"] for s in views["storyline"]]
    order = [names.index(n) for n in
             ("coord_detach", "fault", "election", "reinit",
              "mesh_reform", "reshard", "resume", "fleet_route_epoch")]
    assert order == sorted(order), names
    assert {s["orig_rank"] for s in views["storyline"]} == {0, 1}
    reform = next(s for s in views["storyline"]
                  if s["name"] == "mesh_reform")
    assert reform["gen"] == 1 and reform["args"]["generation"] == 1
    assert "election" in views["story_text"]
    assert "r1 g1" in views["story_text"]
    assert "dead=[2]" in views["story_text"]


def test_chained_reform_storyline_one_causal_lane(tmp_path, monkeypatch):
    chain = (("coord_detach", 1 * MS, {"step": 1}),
             ("fault", 10 * MS, {"site": "collective.allreduce",
                                 "kind": "worker"}),
             ("reinit_abandoned", 12 * MS,
              {"generation": 1, "newly_dead": [2], "dead": [2, 3],
               "phase": "gate", "attempt": 1}),
             ("election", 14 * MS, {"coordinator": "h:2", "nproc": 2,
                                    "generation": 2}),
             ("reinit", 16 * MS, {"generation": 2}),
             ("mesh_reform", 18 * MS, {"generation": 2, "nproc": 2}),
             ("reshard", 19 * MS, {"step": 6}),
             ("resume", 20 * MS, {"step": 6, "generation": 2}))
    dirs = _both(tmp_path, monkeypatch, {
        f"shard_r{r:03d}.jsonl": (r, [(n, "resil", t, a)
                                      for n, t, a in chain],
                                  {"gens": {2: 18 * MS}})
        for r in (0, 1)})
    _, views = _merged_equal(dirs)
    assert views["story_gens"] == [0, 1, 2]
    chain_gens = [s["chain_gen"] for s in views["storyline"]]
    assert chain_gens == sorted(chain_gens)
    assert "generations 0→1→2" in views["story_text"]
    assert "generation 0 → 1" in views["story_text"]
    assert "newly_dead=[2]" in views["story_text"]
    lane = next(e for e in views["chrome"]["traceEvents"]
                if e.get("name") == "process_name" and e.get("pid") == 9999)
    assert "g0→g1→g2" in lane["args"]["name"]
    assert views["chrome"]["otherData"]["generations"] == [0, 1, 2]


def test_fleet_report_names_straggler_and_splits_wall(tmp_path,
                                                      monkeypatch):
    dirs = _failover_shards(tmp_path, monkeypatch)
    _, views = _merged_equal(dirs, window=2)
    rep = views["report"]
    assert rep["slowest_rank"] == 1
    r1 = rep["per_rank"]["1"]
    assert r1["steps"] == 4
    assert r1["exposed_dcn_s"] == pytest.approx(0.0005)
    assert r1["dist_ops"] == 1 and r1["dist_op_bytes"] == 1024
    assert r1["dcn_buckets"] == 1
    assert rep["per_rank"]["0"]["straggler_wait_s"] > 0
    assert "slowest rank overall: r1" in views["report_text"]


def test_local_shrink_replay_epoch_never_pairs_with_prefault(tmp_path,
                                                             monkeypatch):
    survivor = [_step((1 + s) * 2 * MS, s, epoch=0) for s in range(4)]
    survivor += [_step(5000 * MS + s * 2 * MS, s, epoch=1) for s in (2, 3)]
    dirs = _both(tmp_path, monkeypatch, {
        "shard_r001.jsonl": (1, [_step((1 + s) * 2 * MS, s, epoch=0)
                                 for s in range(4)], {}),
        "shard_r000.jsonl": (0, survivor, {})})
    _, views = _merged_equal(dirs, window=2)
    rep = views["report"]
    assert rep["per_rank"]["1"]["straggler_wait_s"] < 0.1
    assert rep["per_rank"]["0"]["straggler_wait_s"] < 0.1
    assert {(w["generation"], w["epoch"]) for w in rep["windows"]} == \
        {(0, 0), (0, 1)}


def _serving_shards(tmp_path, monkeypatch):
    """A serving fleet's lanes: replicas 0 and 1 load and retire, the
    router (rank 3) drives a rollout, bumps an epoch for a dead replica
    2 and sheds under overload; replica 0 refuses two requests."""
    R, F = "resil", "fleet"
    router = [
        ("fleet_route_epoch", R, 5 * MS, {"epoch": 1, "dead": [2],
                                          "reason": "transport"}),
        ("fleet_hedge", F, 6 * MS, {"primary": 1, "hedge": 0, "gen": 0}),
        ("rollout_start", R, 10 * MS, {"from_gen": 0, "to_gen": 1,
                                       "targets": [50, 100]}),
        ("rollout_shift", R, 30 * MS, {"from_gen": 0, "to_gen": 1,
                                       "weight": 50, "attempt": 1}),
        ("rollout_shift", R, 40 * MS, {"from_gen": 0, "to_gen": 1,
                                       "weight": 100, "attempt": 1}),
        ("rollout_drain", R, 50 * MS, {"from_gen": 0, "to_gen": 1,
                                       "in_flight": 2, "reworked": 1}),
        ("rollout_done", R, 70 * MS, {"from_gen": 0, "to_gen": 1,
                                      "reworked": 1, "attempts": 2}),
        ("fleet_budget_exhausted", F, 80 * MS, {"action": "shed_retry",
                                                "tokens": 0.0})]
    replica = {r: [("replica_up", F, 1 * MS, {"orig_rank": r, "gen": 0}),
                   ("rollout_load", R, (20 + r) * MS,
                    {"to_gen": 1, "port": 7101 + r}),
                   ("rollout_retire", R, (60 + r) * MS, {"from_gen": 0})]
               for r in (0, 1)}
    replica[0] += [("fleet_admission_reject", F, 81 * MS,
                    {"reason": "inflight", "rank": 0}),
                   ("fleet_admission_reject", F, 82 * MS,
                    {"reason": "predicted_wait", "rank": 0})]
    return _both(tmp_path, monkeypatch, {
        "shard_r000.jsonl": (0, replica[0], {}),
        "shard_r001.jsonl": (1, replica[1], {}),
        "shard_r003.jsonl": (3, router, {})})


def test_serving_fleet_storylines_and_overload(tmp_path, monkeypatch):
    merged, views = _merged_equal(_serving_shards(tmp_path, monkeypatch))
    names = [s["name"] for s in views["rollout"]]
    assert names[0] == "rollout_start" and names[-1] == "rollout_done"
    assert names.count("rollout_load") == 2
    assert names.count("rollout_retire") == 2
    fo = [s["name"] for s in views["storyline"]]
    assert fo == ["fleet_route_epoch"]
    assert "Rollout storyline (9 events, g0→g1)" in views["rollout_text"]
    assert views["overload"]["by_reason"] == {
        "fleet_admission_reject[inflight]": 1,
        "fleet_admission_reject[predicted_wait]": 1}
    assert views["overload"]["by_name"]["fleet_budget_exhausted"] == 1
    assert views["overload"]["total"] == 3
    assert "by rank: r0=2, r3=1" in views["overload_text"]
    pids = {e.get("pid") for e in views["chrome"]["traceEvents"]}
    assert {0, 1, 3, 9998, 9999} <= pids
    assert pfleet.render_rollout_storyline([]) == \
        jfleet.render_rollout_storyline([])
    assert pfleet.render_overload_summary({"total": 0}) == \
        jfleet.render_overload_summary({"total": 0})


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_shard_reattach_same_run_appends_not_truncates(tmp_path, pkg):
    fleet, T = PKGS[pkg]
    fleet.set_identity("run-a", orig_rank=0, rank=0)
    rec = T.FlightRecorder()
    prev = T.install(rec)
    try:
        w1 = fleet.attach_shard(rec, str(tmp_path))
        T.instant("fleet_step", T.CAT_FLEET, step=0, dur_ns=MS)
        w2 = fleet.attach_shard(rec, str(tmp_path))
        T.instant("fleet_step", T.CAT_FLEET, step=1, dur_ns=MS)
        w2.close()
        assert w1._f.closed
    finally:
        T.install(prev)
    sh = fleet.Shard(fleet.shard_path(str(tmp_path), 0))
    assert [e["args"]["step"] for e in sh.events] == [0, 1]
    assert len(sh.headers) == 2 and sh.torn_lines == 0
    fleet.clear_identity()
    fleet.set_identity("run-b", orig_rank=0, rank=0)
    rec2 = T.FlightRecorder()
    prev = T.install(rec2)
    try:
        w3 = fleet.attach_shard(rec2, str(tmp_path))
        T.instant("fleet_step", T.CAT_FLEET, step=9, dur_ns=MS)
        w3.close()
    finally:
        T.install(prev)
    sh2 = fleet.Shard(fleet.shard_path(str(tmp_path), 0))
    assert sh2.run_id == "run-b"
    assert [e["args"]["step"] for e in sh2.events] == [9]


# --------------------------------------------------------------------------
# the merge command
# --------------------------------------------------------------------------

def _cli(args, module):
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = ([sys.executable, "-m", "systemml_tpu_torch.obs.fleet_trace"]
           if module else
           [sys.executable, os.path.join(REPO, "scripts", "fleet_trace.py")])
    return subprocess.run(cmd + args, capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)


@pytest.mark.parametrize("shape", ["failover", "serving"])
def test_fleet_trace_command_equals_the_scripts(tmp_path, monkeypatch,
                                                shape):
    make = _failover_shards if shape == "failover" else _serving_shards
    dirs = make(tmp_path, monkeypatch)
    out = {}
    for pkg, d in dirs.items():
        module = pkg == "torch"
        chrome = tmp_path / f"{pkg}.json"
        r = _cli([str(d), "--json", "--out", str(chrome)], module)
        assert r.returncode == 0, r.stdout + r.stderr
        text = _cli([str(d)], module)
        assert text.returncode == 0, text.stderr
        out[pkg] = (_strip_paths(json.loads(r.stdout), dirs),
                    json.loads(chrome.read_text()), text.stdout)
    assert out["torch"] == out["jax"]
    obj, chrome, text = out["torch"]
    assert "Failover storyline" in text and "Fleet report" in text
    if shape == "failover":
        assert obj["ranks"] == [0, 1, 2] and obj["report"]["slowest_rank"] == 1
        assert {0, 1, 2, 9999} <= {e.get("pid")
                                   for e in chrome["traceEvents"]}
    else:
        assert "Rollout storyline" in text and "Overload (3 events)" in text
        assert obj["rollout"][0]["name"] == "rollout_start"


def test_fleet_trace_command_errors_cleanly_on_missing_dir(tmp_path):
    r = _cli([str(tmp_path / "nope")], True)
    assert r.returncode == 1
    assert r.stderr.startswith("fleet_trace:")
    j = _cli([str(tmp_path / "nope")], False)
    assert j.returncode == 1 and j.stderr == r.stderr


# --------------------------------------------------------------------------
# metrics rollup
# --------------------------------------------------------------------------

def _snap(orig, rank, gen, steps, run_id="run-t", **resil):
    st = Statistics()
    for _ in range(steps):
        st.count_step()
    for k, v in resil.items():
        st.count_resil(k, v)
    st.count_mesh_op("mapmm")
    st.count_overload("fleet_admission_reject[inflight]", 2)
    st.registry.histogram("lat_seconds", buckets=(1.0,)).observe(0.5)
    return {"identity": {"run_id": run_id, "orig_rank": orig,
                         "rank": rank, "generation": gen, "nproc": 2},
            "metrics": st.to_dict()}


def test_rollup_sums_counters_merges_histograms_maxes_gauges():
    s0 = _snap(0, 0, 1, steps=13, mesh_reform=1)
    s1 = _snap(1, 1, 1, steps=13, mesh_reform=1)
    s0["metrics"]["run_seconds"] = 2.0
    s1["metrics"]["run_seconds"] = 5.0
    roll = pfleet.rollup_metrics([s0, s1])
    assert roll == jfleet.rollup_metrics([s0, s1])
    assert pfleet.render_fleet_stats(roll) == jfleet.render_fleet_stats(roll)
    f = roll["fleet"]
    assert f["fleet_steps_total"] == 26
    assert f["resil_events_total"] == {"mesh_reform": 2}
    assert f["mesh_op_total"] == {"mapmm": 2}
    assert f["overload_events_total"] == {
        "fleet_admission_reject[inflight]": 4}
    assert f["run_seconds"] == 5.0
    assert f["lat_seconds"]["count"] == 2
    text = pfleet.render_fleet_stats(roll)
    assert "fleet steps completed: 26" in text
    assert "r0->rank0@gen1" in text and "mesh_reform=2" in text
    # the port's snapshot carries the counters the JAX package's does
    jst = JStatistics()
    jst.count_step()
    assert {"fleet_steps_total", "resil_events_total", "mesh_op_total",
            "overload_events_total", "run_seconds",
            "trace_dropped_events"} <= set(s0["metrics"]) & \
        set(jst.to_dict())


def test_rollup_refuses_mixed_runs_and_roundtrips_files(tmp_path):
    mixed = [_snap(0, 0, 0, 1), _snap(1, 1, 0, 1, run_id="other")]
    msgs = []
    for fleet in (pfleet, jfleet):
        with pytest.raises(ValueError, match="different runs") as e:
            fleet.rollup_metrics(mixed)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    snaps = {}
    for pkg, (fleet, _) in PKGS.items():
        fleet.set_identity("run-t", orig_rank=1, rank=0, generation=1,
                           nproc=2)
        st = Statistics()
        st.count_step(7)
        path = fleet.write_metrics_snapshot(str(tmp_path / pkg), st,
                                            extra={"k4_launches": 3})
        assert os.path.basename(path) == "metrics_r001.json"
        snaps[pkg] = fleet.load_metrics_snapshots(str(tmp_path / pkg))
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"][0]["identity"]["generation"] == 1
    assert snaps["torch"][0]["metrics"]["fleet_steps_total"] == 7
    assert snaps["torch"][0]["extra"] == {"k4_launches": 3}


def test_load_metrics_snapshots_filters_stale_run(tmp_path):
    for snap in (_snap(0, 0, 0, steps=2, run_id="run-b"),
                 _snap(1, 1, 0, steps=2, run_id="run-b"),
                 _snap(2, 2, 0, steps=9, run_id="run-a")):
        p = tmp_path / f"metrics_r{snap['identity']['orig_rank']:03d}.json"
        p.write_text(json.dumps(snap))
    for fleet in (pfleet, jfleet):
        with pytest.raises(ValueError, match="different runs"):
            fleet.rollup_metrics(fleet.load_metrics_snapshots(str(tmp_path)))
    roll = pfleet.rollup_metrics(
        pfleet.load_metrics_snapshots(str(tmp_path), run_id="run-b"))
    assert roll == jfleet.rollup_metrics(
        jfleet.load_metrics_snapshots(str(tmp_path), run_id="run-b"))
    assert sorted(roll["ranks"]) == [0, 1]
    assert roll["fleet"]["fleet_steps_total"] == 4


def test_trace_dropped_events_live_gauge():
    st = Statistics()
    assert st.to_dict()["trace_dropped_events"] == 0
    rec = ptrace.FlightRecorder(max_events=4)
    prev = ptrace.install(rec)
    try:
        for _ in range(10):
            ptrace.instant("x", ptrace.CAT_RUNTIME)
        assert st.to_dict()["trace_dropped_events"] == 6
    finally:
        ptrace.install(prev)
    assert st.to_dict()["trace_dropped_events"] == 0
    assert set(st.to_dict(include_timings=False)) == \
        set(st.to_dict()) - {"run_seconds", "op_seconds"}


def test_vocabulary_equals_the_jax_package_s():
    for name in ("STORYLINE_EVENTS", "TRAFFIC_EVENTS", "SERVING_EVENTS",
                 "ROLLOUT_EVENTS", "OVERLOAD_EVENTS", "FLEET_EVENT_NAMES",
                 "SHARD_PREFIX", "METRICS_PREFIX"):
        assert getattr(pfleet, name) == getattr(jfleet, name), name
