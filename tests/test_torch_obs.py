"""The port's exporters (systemml_tpu_torch/obs/export.py), its traced-run
hooks and its fleet identity against the JAX package's (systemml_tpu/
obs/), on the CPU: the analogues of tests/test_obs.py, through both
packages on the same numpy-seeded inputs.

Held: the Chrome trace loads as JSON with the compile, runtime and
`dispatch` events of a run, complete events with a duration and instants
without, in both packages; the JSONL export one event a line;
`render_summary` and `dispatch_stats` with the JAX package's sections
and keys; the CLI's `-trace` as a Chrome trace (`.json`) or JSON lines
(`.jsonl`), and with `-stats` the summary; `MLContext.set_trace` and
`PreparedScript.set_trace` writing a trace, keeping `last_recorder` and
leaving no recorder installed; `traced_run`'s warnings; the fleet
identity stamped into a Chrome trace, and the rest of obs/fleet.py
ported (tests/test_torch_fleet.py holds it against the JAX package's).

The mesh's collective events (`test_mesh_dispatch_events_with_collective
_bytes`) wait for item 12.
"""

import json
import os

import numpy as np
import pytest

from systemml_tpu import obs as jax_obs
from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.obs import export as jax_export
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch import obs
from systemml_tpu_torch.api import cli
from systemml_tpu_torch.api.jmlc import Connection
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.obs import export
from systemml_tpu_torch.obs import fleet
from systemml_tpu_torch.utils.config import DMLConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = ("X = rand(rows=128, cols=128, seed=1)\n"
       "Y = t(X) %*% X\n"
       "z = sum(Y)\n")
X16 = np.random.default_rng(0).standard_normal((16, 8))
# the spans and categories of a small run, in both packages
CORE = ("validate", "hop_build", "rewrite_block", "ipa",
        "size_propagation", "program_execute", "block", "dispatch",
        "parse", "compile")


def _port_run(src=SRC, out="z", **kw):
    cfg = DMLConfig(device="cpu")
    for k, v in kw.items():
        setattr(cfg, k, v)
    with obs.session() as rec:
        res = MLContext(cfg).execute(dml(src).output(out))
    return rec, res


def _jax_run(src=SRC, out="z"):
    cfg = JaxConfig()
    cfg.exec_mode = "SINGLE_NODE"
    with jax_obs.session() as rec:
        res = JaxMLContext(cfg).execute(jax_dml(src).output(out))
    return rec, res


@pytest.fixture(scope="module")
def runs():
    rp, resp = _port_run()
    rj, resj = _jax_run()
    np.testing.assert_allclose(float(resp.get_scalar("z")),
                               float(np.asarray(resj.get_scalar("z"))),
                               rtol=1e-9)
    return rp, rj


@pytest.fixture
def cpu_json(tmp_path):
    p = tmp_path / "cpu.json"
    p.write_text(json.dumps({"device": "cpu"}))
    return str(p)


def _chrome(rec, mod, path):
    mod.write(rec, path)
    with open(path) as f:
        return json.load(f)


def test_chrome_trace_valid_json_with_phase_names(runs, tmp_path):
    rp, rj = runs
    for rec, mod, tag in ((rp, export, "p"), (rj, jax_export, "j")):
        d = _chrome(rec, mod, str(tmp_path / f"{tag}.json"))
        evs = d["traceEvents"]
        names = {e["name"] for e in evs}
        for want in CORE:
            assert want in names, (tag, want, sorted(names))
        assert {"compile", "runtime"} <= {e["cat"] for e in evs}
        for e in evs:
            assert ("dur" in e) == (e["ph"] == "X")
            assert e["ph"] in ("X", "i")
        assert d["displayTimeUnit"] == "ms"


def test_jsonl_export_parses_line_per_event(runs, tmp_path):
    rp, rj = runs
    for rec, mod, tag in ((rp, export, "p"), (rj, jax_export, "j")):
        path = str(tmp_path / f"{tag}.jsonl")
        mod.write(rec, path)           # extension dispatch
        lines = open(path).read().strip().splitlines()
        assert len(lines) == len(rec.events())
        parsed = [json.loads(ln) for ln in lines]
        assert all({"id", "name", "cat", "ph", "ts_ns", "dur_ns", "tid",
                    "parent", "args"} == set(p) for p in parsed)


def test_render_summary_from_stream(runs):
    rp, rj = runs
    out = export.render_summary(rp)
    assert "Heavy hitter spans" in out and out.startswith("Flight recorder:")
    assert "runtime:dispatch" in out
    assert set(export.CATEGORY_SUMMARIES) == \
        set(jax_export.CATEGORY_SUMMARIES)
    jout = jax_export.render_summary(rj)
    heads = [ln.split(":")[0] for ln in jout.splitlines()
             if not ln.startswith(" ") and ":" in ln]
    assert "Heavy hitter spans (top 10)" in heads
    assert "Runtime" in [ln.split(":")[0] for ln in out.splitlines()]


def test_dispatch_stats_has_the_jax_package_keys(runs):
    rp, rj = runs
    got, ref = export.dispatch_stats(rp), jax_export.dispatch_stats(rj)
    assert set(got) - {"loop_regions"} == set(ref) - {"loop_regions"}
    assert got["dispatches"] >= 1 and got["dispatch_s"] > 0
    assert got["recompiles"] == 0 and got["overlap_fraction"] is None


def test_dispatch_stats_loop_regions_equal_the_jax_package():
    src = ("X = rand(rows=64, cols=8, seed=3)\n"
           "w = matrix(0, rows=8, cols=1)\n"
           "i = 0\n"
           "while (i < 5) {\n"
           "  w = w - 0.01 * (t(X) %*% (X %*% w) - 1)\n"
           "  i = i + 1\n"
           "}\n"
           "z = sum(w)\n")
    rp, resp = _port_run(src)
    rj, resj = _jax_run(src)
    np.testing.assert_allclose(float(resp.get_scalar("z")),
                               float(np.asarray(resj.get_scalar("z"))),
                               rtol=1e-9)
    got = export.dispatch_stats(rp)["loop_regions"]
    ref = jax_export.dispatch_stats(rj)["loop_regions"]
    assert set(got) == set(ref)
    for label, r in got.items():
        for k in ("dispatches", "outer_iters", "carried", "kind", "pred"):
            assert r[k] == ref[label][k], (label, k)
    assert export.dispatch_stats(rp)["region_dispatches"] == 1


def test_pred_host_sync_counted_per_eager_iteration():
    """A loop run eagerly reads its device predicate on the host once an
    iteration (dispatch_stats' host_pred_syncs); one region entry reads
    it once."""
    src = ("X = rand(rows=32, cols=4, seed=3)\n"
           "s = 0\n"
           "while (s < 3) {\n"
           "  s = s + sum(X) / sum(X)\n"
           "}\n"
           "z = s\n")
    rp, _ = _port_run(src, codegen_enabled=False)
    eager = export.dispatch_stats(rp)["host_pred_syncs"]
    assert eager >= 3
    rp, _ = _port_run(src)
    assert export.dispatch_stats(rp)["host_pred_syncs"] < eager


# --------------------------------------------------------------------------
# the CLI's -trace, MLContext and JMLC hooks
# --------------------------------------------------------------------------

def test_cli_trace_end_to_end(tmp_path, capsys, cpu_json):
    from systemml_tpu.api.cli import main as jax_main

    src = ("X = rand(rows=128, cols=128, seed=1)\n"
           "s = sum(t(X) %*% X)\nprint(s)")
    docs = {}
    for tag, main, extra in (("p", cli.main, ["-config", cpu_json]),
                             ("j", jax_main, [])):
        path = str(tmp_path / f"{tag}.json")
        assert main(["-s", src, "-trace", path] + extra) == 0
        docs[tag] = json.load(open(path))
    printed = capsys.readouterr().out.splitlines()
    np.testing.assert_allclose(float(printed[0]), float(printed[1]),
                               rtol=1e-9)
    for tag, d in docs.items():
        cats = {e["cat"] for e in d["traceEvents"]}
        names = {e["name"] for e in d["traceEvents"]}
        assert {"compile", "runtime"} <= cats
        for want in ("parse", "compile", "hop_build", "program_execute",
                     "block", "dispatch"):
            assert want in names, (tag, want, sorted(names))
    assert obs.active() is None and jax_obs.active() is None


def test_cli_trace_jsonl_writes_one_event_a_line(tmp_path, cpu_json):
    path = tmp_path / "run.jsonl"
    assert cli.main(["-s", "print(sum(rand(rows=8, cols=8, seed=1)))",
                     "-trace", str(path), "-config", cpu_json]) == 0
    lines = path.read_text().strip().splitlines()
    evs = [json.loads(ln) for ln in lines]
    assert {"program_execute", "dispatch"} <= {e["name"] for e in evs}
    assert all("ts_ns" in e and "parent" in e for e in evs)


def test_cli_trace_with_stats_prints_summary(tmp_path, capsys, cpu_json):
    from systemml_tpu.api.cli import main as jax_main

    src = "print(sum(rand(rows=8, cols=8, seed=1)))"
    for tag, main, extra in (("p", cli.main, ["-config", cpu_json]),
                             ("j", jax_main, [])):
        path = str(tmp_path / f"{tag}.jsonl")
        assert main(["-s", src, "-trace", path, "-stats"] + extra) == 0
        out = capsys.readouterr().out
        assert "Flight recorder:" in out
        assert "Heavy hitter spans" in out
        assert len(open(path).read().strip().splitlines()) > 0


def test_cli_trace_while_another_trace_records_warns(tmp_path, cpu_json):
    with obs.session():
        with pytest.warns(RuntimeWarning, match="another trace"):
            assert cli.main(["-s", "print(1)", "-trace",
                             str(tmp_path / "t.json"), "-config",
                             cpu_json]) == 0
    assert not (tmp_path / "t.json").exists()
    assert obs.active() is None


def test_mlcontext_set_trace(tmp_path):
    path = str(tmp_path / "ml.json")
    ml = MLContext(DMLConfig(device="cpu")).set_trace(path)
    res = ml.execute(dml(SRC).output("z"))
    assert np.isfinite(float(res.get_scalar("z")))
    d = json.load(open(path))
    assert any(e["name"] == "program_execute" for e in d["traceEvents"])
    assert ml.last_recorder is not None
    assert obs.active() is None
    first = ml.last_recorder
    ml.set_trace(None).execute(dml(SRC).output("z"))
    assert ml.last_recorder is first


def test_jmlc_prepared_script_trace_hook(tmp_path):
    from systemml_tpu.api.jmlc import Connection as JaxConnection

    outs = {}
    for tag, conn in (("p", Connection(DMLConfig(device="cpu"))),
                      ("j", JaxConnection())):
        path = str(tmp_path / f"score_{tag}.json")
        ps = conn.prepare_script("y = sum(X %*% t(X))", input_names=["X"],
                                 output_names=["y"])
        ps.set_trace(path)
        res = ps.set_matrix("X", X16).execute_script()
        outs[tag] = float(np.asarray(res.get("y")))
        d = json.load(open(path))
        assert any(e["name"] == "program_execute" for e in d["traceEvents"])
        assert ps.last_recorder is not None
    np.testing.assert_allclose(outs["p"], outs["j"], rtol=1e-9)
    assert obs.active() is None


def test_scoring_service_set_trace(tmp_path):
    """A served script's PreparedScript traces the dispatch the service
    makes, and releases the recorder."""
    from systemml_tpu_torch.api.serving import ScoringService

    rng = np.random.default_rng(7)
    w = rng.standard_normal((8, 3))
    ps = Connection(DMLConfig(device="cpu")).prepare_script(
        "P = X %*% W", input_names=["X", "W"], output_names=["P"],
        input_meta={"X": {"shape": (None, 8)}, "W": {"shape": (8, 3)}})
    path = str(tmp_path / "srv.jsonl")
    ps.set_trace(path)
    svc = ScoringService(ps, "X", constants={"W": w})
    x = rng.standard_normal((5, 8))
    out = svc.score(x)
    np.testing.assert_allclose(np.asarray(out["P"]), x @ w, rtol=1e-9)
    evs = [json.loads(ln) for ln in open(path).read().splitlines()]
    assert any(e["name"] == "program_execute" for e in evs)
    assert ps.last_recorder is not None and obs.active() is None


def test_traced_run_warns_on_a_failed_write(tmp_path):
    bad = str(tmp_path / "missing" / "t.json")
    with pytest.warns(RuntimeWarning, match="could not write trace"):
        with obs.traced_run(bad) as rec:
            assert rec is not None and obs.active() is rec
    assert obs.active() is None
    with obs.traced_run(None) as rec:
        assert rec is None


# --------------------------------------------------------------------------
# the fleet identity
# --------------------------------------------------------------------------

def test_chrome_trace_stamps_the_fleet_identity(monkeypatch):
    from systemml_tpu.obs import fleet as jax_fleet

    rec = obs.FlightRecorder()
    assert "otherData" not in export.chrome_trace(rec)
    ident = fleet.FleetIdentity("run-abc", 2, 1, generation=3, nproc=4)
    monkeypatch.setattr(fleet, "_identity", ident)
    ref = jax_fleet.FleetIdentity("run-abc", 2, 1, generation=3, nproc=4)
    assert export.chrome_trace(rec)["otherData"]["fleet"] == ref.to_dict()
    assert repr(ident) == repr(ref)
    fleet.clear_identity()
    assert fleet.identity() is None


@pytest.mark.parametrize("name", ["set_identity", "attach_shard",
                                  "merge_dir", "chrome_fleet_trace",
                                  "rollup_metrics", "fleet_report"])
def test_the_rest_of_obs_fleet_is_ported(name):
    """The names that raised until the fleet (item 13a) are the port's
    own functions now, with the JAX package's signatures
    (tests/test_torch_fleet.py holds their results equal)."""
    import inspect

    from systemml_tpu.obs import fleet as jax_fleet

    ported = getattr(fleet, name)
    assert callable(ported) and ported.__module__ == fleet.__name__
    assert inspect.signature(ported) == \
        inspect.signature(getattr(jax_fleet, name))
    assert not hasattr(fleet, "no_such_name")


def test_obs_reexports_the_jax_package_names():
    names = [n for n in dir(jax_obs) if not n.startswith("_")
             and n not in ("contextlib", "trace", "export", "metrics",
                           "profile", "fleet", "ab")]
    missing = [n for n in names if not hasattr(obs, n)]
    assert not missing


def test_summary_sections_of_the_port_s_events():
    """The sections the port's events reach render as the JAX package's
    do from the same events; the mesh and fleet sections stay empty."""
    from systemml_tpu.obs import trace as jax_trace
    from systemml_tpu_torch.obs import trace as port_trace

    def record(trace_mod):
        rec = trace_mod.FlightRecorder()
        prev = trace_mod.install(rec)
        try:
            trace_mod.instant("rw_fold", trace_mod.CAT_REWRITE)
            trace_mod.instant("pool_admit", trace_mod.CAT_POOL)
            trace_mod.instant("kernel_select", trace_mod.CAT_CODEGEN,
                              source="analytic")
            trace_mod.instant("bucket_dispatch", trace_mod.CAT_SERVING,
                              hit=True, pad_rows=3)
            with trace_mod.span("parfor", trace_mod.CAT_PARFOR,
                                mode="local"):
                pass
            trace_mod.instant("parfor_task_retry", trace_mod.CAT_RESIL,
                              site="parfor.task")
        finally:
            trace_mod.install(prev)
        return rec

    got = export.render_summary(record(port_trace)).splitlines()[1:]
    ref = jax_export.render_summary(record(jax_trace)).splitlines()[1:]
    strip = [ln for ln in got if not ln.startswith("  ")]
    assert strip == [ln for ln in ref if not ln.startswith("  ")]
    assert not any(ln.startswith(("Mesh", "DCN", "Fleet")) for ln in got)
