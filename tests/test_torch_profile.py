"""The port's device-time profiler (systemml_tpu_torch/obs/profile.py)
against the JAX package's (systemml_tpu/obs/profile.py), on the CPU: the
analogues of tests/test_profile.py, through both packages on the same
numpy-seeded inputs.

Held: the same bucket names; region rows whose counts equal
`dispatch_stats`' `loop_regions` and whose labels equal `-stats`' region
counters (and the JAX package's labels); a report that round-trips
through `json`; "off" adding no fence, span or event of the profiler and
leaving LinearRegCG's launches and host syncs per while entry as a run
without a recorder; "sample" keeping the dispatch count; no fence
without a recorder or inside a graph capture; the ring buffer keeping the
newest events and annotating the drop; kernel rows joined to the
variant's modeled time; the folding of one event stream equal in both
packages; `ingest_profile` returning the number of rows it read; and the
CLI's `-profile`.

No test here holds a coverage or time bar: on the CPU under a loaded
test run those measure the host, not the code. The coverage bar is held
on the card (tests/test_torch_gpu.py, chip_smoke.py's `[profile]`).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from systemml_tpu import obs as jax_obs
from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.obs import profile as jax_prof
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu.utils.config import set_config as jax_set_config
from systemml_tpu_torch import obs
from systemml_tpu_torch.api import cli
from systemml_tpu_torch.api.jmlc import Connection
from systemml_tpu_torch.api.mlcontext import MLContext, dmlFromFile
from systemml_tpu_torch.codegen import costmodel
from systemml_tpu_torch.obs import profile as prof
from systemml_tpu_torch.runtime import loopfuse
from systemml_tpu_torch.utils.config import DMLConfig, set_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINREG = os.path.join(REPO, "scripts", "algorithms", "LinearRegCG.dml")
NAMED = ("compile", "device", "host_sync", "transfer", "collective")

RNG = np.random.default_rng(41)
X = RNG.standard_normal((600, 24))
Y = X @ RNG.standard_normal((24, 1)) + 0.01 * RNG.standard_normal((600, 1))
ARGS = {"maxi": 8, "tol": 1e-12}


def _port_cfg(mode="off", regions=True, **kw):
    cfg = DMLConfig(device="cpu")
    cfg.profile_mode = mode
    cfg.codegen_enabled = regions
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _linreg(make, x=X, y=Y, args=ARGS):
    s = make(LINREG).input("X", x).input("y", y).output("beta")
    for k, v in args.items():
        s.arg(k, v)
    return s


def _port_profiled(mode="full", regions=True, runs=2, **kw):
    """LinearRegCG through the port's MLContext, the last of `runs` runs
    recorded; the report rendered while the mode is armed."""
    cfg = _port_cfg(mode, regions, **kw)
    ml = MLContext(cfg)
    ml.printer = lambda s: None
    for _ in range(runs - 1):
        ml.execute(_linreg(dmlFromFile))
    prof.reset_sampling()
    with obs.session() as rec:
        res = ml.execute(_linreg(dmlFromFile))
    set_config(cfg)
    try:
        rep = obs.profile_report(rec)
    finally:
        set_config(DMLConfig())
    return rec, rep, ml._stats, res


def _jax_profiled(mode="full"):
    cfg = JaxConfig()
    cfg.exec_mode = "SINGLE_NODE"
    cfg.profile_mode = mode
    ml = JaxMLContext(cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        ml.execute(_linreg(jax_dml_file))
        jax_set_config(cfg)
        try:
            jax_prof.reset_sampling()
            with jax_obs.session() as rec:
                ml.execute(_linreg(jax_dml_file))
            rep = jax_obs.profile_report(rec)
        finally:
            jax_set_config(JaxConfig())
    return rec, rep, ml._stats


def test_bucket_names_equal_the_jax_package():
    assert prof.BUCKETS == jax_prof.BUCKETS
    assert prof.PROFILE_MODES == jax_prof.PROFILE_MODES


def test_profile_full_linregcg_region_rows_match_dispatch_stats():
    rec, rep, st, res = _port_profiled("full")
    jrec, jrep, jst = _jax_profiled("full")
    assert set(rep.buckets) == set(jrep.buckets)
    for k in NAMED:
        assert k in rep.buckets
    assert rep.total_dispatches > 0
    # full mode: every dispatch fenced (on the CPU the fence is a no-op
    # that counts, as block_until_ready there)
    assert rep.fenced_dispatches == rep.total_dispatches
    assert rep.buckets["device"] > 0
    assert rep.buckets["collective"] == 0.0
    ds = obs.dispatch_stats(rec)
    assert sum(r["count"] for r in rep.regions.values()) == \
        ds["dispatches"]
    assert ds.get("loop_regions")
    for label, info in ds["loop_regions"].items():
        assert rep.regions[label]["count"] == info["dispatches"]
    # the report's loop labels are -stats' region counters, and the JAX
    # package's
    loops = {lbl for lbl in rep.regions if lbl.startswith("while[")}
    assert loops == set(st.region_counts)
    assert loops == {lbl for lbl in jrep.regions
                     if lbl.startswith("while[")}
    assert set(ds["loop_regions"]) == set(
        obs_ds for obs_ds in jax_obs.dispatch_stats(jrec)["loop_regions"])
    d = json.loads(json.dumps(rep.to_dict()))
    assert set(d) == set(jrep.to_dict())
    assert d["profile_mode"] == "full"
    text = rep.text()
    assert "Profile report (mode=full)" in text
    assert "Top regions/blocks" in text
    beta = np.asarray(res.get_matrix("beta"))
    assert np.all(np.isfinite(beta))


def test_profile_report_eager_kernel_rows_count_every_launch():
    """Regions off: every kernel launch is a kernel_launch row, fenced,
    nested in its block's dispatch."""
    rec, rep, st, _ = _port_profiled("full", regions=False)
    assert not st.region_counts
    rows = {k: r for k, r in rep.kernels.items() if k.startswith("mmchain.")}
    assert rows, sorted(rep.kernels)
    n = sum(r["count"] for r in rows.values())
    launches = [e for e in rec.events() if e.name == "kernel_launch"
                and (e.args or {}).get("op") == "mmchain"]
    assert n == len(launches) >= 1
    assert all(r["fenced"] == r["count"] for r in rows.values())
    spans = {e.id: e for e in rec.events() if e.ph == "X"}
    for e in launches:
        assert spans[e.parent].name in ("dispatch", "block")


def test_profile_off_adds_no_fences():
    """The dispatch-budget contract: with profile_mode=off a recorded run
    carries no fenced span and no profiler event."""
    rec, rep, _, _ = _port_profiled("off")
    assert rep.fenced_dispatches == 0
    for e in rec.events():
        assert not (e.args or {}).get("fenced")
        assert e.name not in ("host_sync", "kernel_launch", "dist_op_exec")


def _jmlc_linreg(mode, recorder, monkeypatch):
    """LinearRegCG through a prepared script (which keeps its program):
    the kernel launches by op (codegen/backend.run's calls) and each
    while entry's host syncs."""
    from systemml_tpu_torch.codegen import backend

    src = open(LINREG).read()
    cfg = _port_cfg(mode)
    ps = Connection(cfg).prepare_script(src, ["X", "y"], ["beta"],
                                        args=ARGS)
    ps.execute({"X": X, "y": Y})        # warm: plans and peels
    launches = {}
    run = backend.run

    def spy(op, *a, **k):
        launches[op] = launches.get(op, 0) + 1
        return run(op, *a, **k)

    monkeypatch.setattr(backend, "run", spy)
    try:
        with obs.session() if recorder else contextlib.nullcontext():
            ps.execute({"X": X, "y": Y})
    finally:
        monkeypatch.setattr(backend, "run", run)
    regions = loopfuse.region_report(ps._program)
    return launches, [(r["label"], r.get("entries"), r.get("host_syncs"),
                       r.get("launches")) for r in regions]


def test_profile_off_with_a_recorder_keeps_launches_and_syncs(monkeypatch):
    plain = _jmlc_linreg("off", False, monkeypatch)
    assert plain[0].get("mmchain", 0) >= 1 and plain[1]
    assert _jmlc_linreg("off", True, monkeypatch) == plain
    # nor do the profiler's fences add a region's host sync or a launch
    assert _jmlc_linreg("full", True, monkeypatch) == plain


def test_profile_sample_keeps_dispatch_count():
    rec_off, _, _, _ = _port_profiled("off")
    rec_smp, rep, _, _ = _port_profiled("sample")
    off_n = obs.dispatch_stats(rec_off)["dispatches"]
    smp_n = obs.dispatch_stats(rec_smp)["dispatches"]
    assert smp_n == off_n
    assert 0 < rep.fenced_dispatches <= rep.total_dispatches


def _fenced(sp) -> bool:
    return bool((sp.args or {}).get("fenced"))


def test_sample_fences_the_first_then_every_nth_per_site():
    cfg = _port_cfg("sample", profile_sample_every=3)
    set_config(cfg)
    try:
        prof.reset_sampling()
        with obs.session():
            marks = []
            for _ in range(7):
                with obs.span("dispatch", obs.CAT_RUNTIME) as sp:
                    prof.maybe_fence(sp, None, site="a")
                marks.append(_fenced(sp))
            with obs.span("dispatch", obs.CAT_RUNTIME) as sp:
                prof.maybe_fence(sp, None, site="b")
    finally:
        set_config(DMLConfig())
    assert marks == [True, False, False, True, False, False, True]
    assert _fenced(sp)


def test_no_fence_without_recorder():
    """profile_mode armed but no recorder installed: nothing to
    attribute, so neither a fence nor a profiler span."""
    cfg = _port_cfg("full")
    set_config(cfg)
    try:
        assert not prof.enabled()

        class Boom:
            @property
            def data(self):  # pragma: no cover
                raise AssertionError("fenced without a recorder")

        prof.maybe_fence(None, Boom())
    finally:
        set_config(DMLConfig())
    ml = MLContext(_port_cfg("full"))
    ml.printer = lambda s: None
    ml.execute(_linreg(dmlFromFile))
    assert obs.active() is None


def test_no_fence_inside_a_graph_capture(monkeypatch):
    """A launch into a CUDA-graph capture is recorded, not run, and a sync
    would invalidate the capture: maybe_fence takes none there, nor while
    torch's sync debug mode watches a run (the block compile's watched
    run)."""
    import torch

    waited = []
    monkeypatch.setattr(prof, "fence", lambda v: waited.append(v))
    cfg = _port_cfg("full")
    set_config(cfg)
    try:
        with obs.session():
            with obs.span("dispatch", obs.CAT_RUNTIME) as sp:
                prof.maybe_fence(sp, "out")
            assert _fenced(sp) and waited == ["out"]
            monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                                lambda: True)
            monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                                lambda: 0)
            with obs.span("dispatch", obs.CAT_RUNTIME) as sp:
                prof.maybe_fence(sp, "captured")
            assert not _fenced(sp)
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                                lambda: False)
            monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                                lambda: 1)
            with obs.span("dispatch", obs.CAT_RUNTIME) as sp:
                prof.maybe_fence(sp, "watched")
            assert not _fenced(sp)
    finally:
        set_config(DMLConfig())
    assert waited == ["out"]


def test_fence_waits_for_nothing_on_the_cpu():
    import torch

    prof.fence({"a": torch.ones(3), "b": [torch.zeros(2), 1.0], "c": None})
    assert prof._cuda_devices({"a": torch.ones(3)}) == set()


# --------------------------------------------------------------------------
# the report's folding, one event stream through both packages
# --------------------------------------------------------------------------

def _synthetic(trace_mod, prof_mod):
    """The same nested spans and instants recorded through either
    package's bus (durations from the clock, so compared as structure)."""
    rec = trace_mod.FlightRecorder()
    prev = trace_mod.install(rec)
    try:
        with trace_mod.span("program_execute", trace_mod.CAT_RUNTIME):
            with trace_mod.span("recompile", trace_mod.CAT_COMPILE):
                pass
            trace_mod.instant("kernel_select", trace_mod.CAT_CODEGEN,
                              op="mmchain", choice="kernel",
                              costs={"kernel": 1e-9, "two_pass": 2e-9})
            for region in ("while[a]@0", "while[a]@0", "fused[b]"):
                key = "region" if region.startswith("while") else "block"
                with trace_mod.span("dispatch", trace_mod.CAT_RUNTIME,
                                    **{key: region}) as sp:
                    with trace_mod.span("kernel_launch",
                                        trace_mod.CAT_CODEGEN, op="mmchain",
                                        variant="kernel") as kp:
                        kp.set(fenced=True)
                    sp.set(fenced=True)
            with trace_mod.span("host_sync", trace_mod.CAT_RUNTIME,
                                kind="pred"):
                pass
            with trace_mod.span("host_transfer", trace_mod.CAT_RUNTIME):
                pass
    finally:
        trace_mod.install(prev)
    return prof_mod.profile_report(rec)


def test_report_folds_one_stream_as_the_jax_package():
    from systemml_tpu.obs import trace as jax_trace
    from systemml_tpu_torch.obs import trace as port_trace

    p = _synthetic(port_trace, prof).to_dict()
    j = _synthetic(jax_trace, jax_prof).to_dict()
    assert set(p) == set(j)
    assert set(p["buckets_s"]) == set(j["buckets_s"])
    for k in ("total_dispatches", "fenced_dispatches", "dropped_events"):
        assert p[k] == j[k]
    assert {k: (r["count"], r["fenced"]) for k, r in p["regions"].items()} \
        == {k: (r["count"], r["fenced"]) for k, r in j["regions"].items()}
    assert {k: (r["count"], r["fenced"], r["op"], r["variant"])
            for k, r in p["kernels"].items()} == \
        {k: (r["count"], r["fenced"], r["op"], r["variant"])
         for k, r in j["kernels"].items()}
    # the kernel_select join: modeled 1e-9 s a launch in both
    assert p["kernels"]["mmchain.kernel"]["modeled_s"] == \
        j["kernels"]["mmchain.kernel"]["modeled_s"] == 1e-9
    assert 0 < p["kernels"]["mmchain.kernel"]["roofline_frac"] <= 1.0
    for b in ("compile", "device", "host_sync", "transfer"):
        assert p["buckets_s"][b] > 0 and j["buckets_s"][b] > 0
    assert p["buckets_s"]["collective"] == j["buckets_s"]["collective"] == 0


# --------------------------------------------------------------------------
# kernel rows and the roofline join
# --------------------------------------------------------------------------

def _mmchain_kernel_run():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((512, 128))
    src = ("w = matrix(0.01, rows=ncol(X), cols=1)\n"
           "g = t(X) %*% (X %*% w)\n"
           "s = sum(g)\n")
    from systemml_tpu_torch.api.mlcontext import dml

    cfg = _port_cfg("full", regions=False, pallas_mode="always",
                    floating_point_precision="single")
    ml = MLContext(cfg)
    with obs.session() as rec:
        ml.execute(dml(src).input("X", x).output("s"))
    set_config(cfg)
    try:
        return obs.profile_report(rec)
    finally:
        set_config(DMLConfig())


def test_kernel_rows_join_the_modeled_time():
    """An eager mmchain launch is a kernel row joined with the variant's
    modeled time (hops/cost.HwProfile.detect()), whether or not this run
    made the selection (the kernel backend selects once a process)."""
    for _ in range(2):
        rep = _mmchain_kernel_run()
        rows = [r for k, r in rep.kernels.items() if k.startswith("mmchain.")]
        assert len(rows) == 1, sorted(rep.kernels)
        row = rows[0]
        assert row["count"] >= 1 and row["device_s"] > 0
        assert row["modeled_s"] > 0
        assert 0.0 < row["roofline_frac"] <= 1.0


def test_ingest_profile_returns_the_rows_it_read():
    rep = _mmchain_kernel_run()
    n_rows = sum(1 for r in rep.kernels.values()
                 if r["count"] and r["device_s"] > 0)
    assert costmodel.ingest_profile(rep) == n_rows >= 1
    assert costmodel.ingest_profile(rep.to_dict()) == n_rows
    assert costmodel.ingest_profile({"kernels": {}}) == 0
    assert costmodel.ingest_profile(object()) == 0


# --------------------------------------------------------------------------
# the ring buffer
# --------------------------------------------------------------------------

def _ring(obs_mod, set_cfg, cfg_cls, tmp_path):
    cfg = cfg_cls()
    cfg.trace_max_events = 16
    set_cfg(cfg)
    try:
        rec = obs_mod.FlightRecorder()
        prev = obs_mod.install(rec)
        try:
            for i in range(40):
                obs_mod.instant(f"e{i}", obs_mod.CAT_RUNTIME)
        finally:
            obs_mod.install(prev)
    finally:
        set_cfg(cfg_cls())
    p = str(tmp_path / "t.jsonl")
    obs_mod.write_jsonl(rec, p)
    lines = open(p).read().strip().splitlines()
    return (rec.max_events, len(rec), rec.dropped_events,
            [e.name for e in rec.events()][::15],
            "dropped" in obs_mod.render_summary(rec),
            obs_mod.chrome_trace(rec)["otherData"]["dropped_events"],
            json.loads(lines[0]), len(lines) - len(rec.events()),
            obs_mod.dispatch_stats(rec)["trace_dropped_events"])


def test_ring_buffer_keeps_most_recent_and_annotates(tmp_path):
    got = _ring(obs, set_config, lambda: DMLConfig(device="cpu"), tmp_path)
    ref = _ring(jax_obs, jax_set_config, JaxConfig, tmp_path)
    assert got == ref
    assert got[:3] == (16, 16, 24) and got[3] == ["e24", "e39"]
    assert got[6]["meta"] == "truncated"


# --------------------------------------------------------------------------
# CLI -profile
# --------------------------------------------------------------------------

_LOOP_SRC = ("X = rand(rows=128, cols=64, seed=1)\n"
             "w = matrix(0, rows=64, cols=1)\n"
             "i = 0\n"
             "while(i < 10) {\n"
             "  g = t(X) %*% (X %*% w) + 0.001 * w\n"
             "  w = w - 0.0001 * g\n"
             "  i = i + 1\n"
             "}\n"
             "print(sum(w))\n")


@pytest.fixture
def cpu_json(tmp_path):
    p = tmp_path / "cpu.json"
    p.write_text(json.dumps({"device": "cpu"}))
    return str(p)


def test_cli_profile_flag_prints_report(capsys, cpu_json):
    from systemml_tpu.api.cli import main as jax_main

    rc = cli.main(["-s", _LOOP_SRC, "-profile", "-config", cpu_json])
    out = capsys.readouterr().out
    assert rc == 0
    assert jax_main(["-s", _LOOP_SRC, "-profile"]) == 0
    jout = capsys.readouterr().out
    for text in (out, jout):
        assert "Profile report (mode=full)" in text
        for k in NAMED:
            assert k in text
        assert "Top regions/blocks" in text
    # the printed sum is the JAX package's
    np.testing.assert_allclose(float(out.splitlines()[0]),
                               float(jout.splitlines()[0]), rtol=1e-9)
    assert obs.active() is None


def test_cli_profile_sample_mode(capsys, cpu_json):
    assert cli.main(["-s", _LOOP_SRC, "-profile", "sample", "-config",
                     cpu_json]) == 0
    assert "Profile report (mode=sample)" in capsys.readouterr().out


def test_cli_profile_releases_recorder_on_parse_error(cpu_json):
    """A -profile run whose script fails to parse must still release the
    process-global recorder slot."""
    with pytest.raises(Exception):
        cli.main(["-s", "while (", "-profile", "-config", cpu_json])
    assert obs.active() is None
    assert cli.main(["-s", "x = 1\nprint(x)", "-profile", "-config",
                     cpu_json]) == 0
    assert obs.active() is None


def test_cli_profile_with_trace_shares_recorder(tmp_path, capsys, cpu_json):
    path = str(tmp_path / "t.json")
    rc = cli.main(["-s", _LOOP_SRC, "-profile", "-trace", path, "-config",
                   cpu_json])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Profile report (mode=full)" in out
    with open(path) as f:
        d = json.load(f)
    assert any(e.get("args", {}).get("fenced") for e in d["traceEvents"])
    assert obs.active() is None
