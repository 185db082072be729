"""The port's learned kernel cost model (systemml_tpu_torch/codegen/
costmodel.py) against the JAX package's (systemml_tpu/codegen/
costmodel.py), on the CPU.

Held equal to the JAX package, on the same seeded records: the feature
vectors of the same (key, variant) pairs (hops/cost.kernel_feature_row
included), the ridge weights and intercept (1e-9), the model's
predictions and shortlists, and the residual. Held in the port: the
cold-start ladder (a kernel_fallback "cold_model" event and the analytic
shortlist with the guardrail arm), a warm model's ranking, the schema-2
records a cached tournament persists and that a fresh process reads
back, and ingest_profile raising until the profiler is ported (ROADMAP
queue 1, item 11).
"""

import json
import math

import numpy as np
import pytest

from systemml_tpu.codegen import backend as jkb
from systemml_tpu.codegen import costmodel as jcm
from systemml_tpu.hops import cost as jcost
from systemml_tpu.utils.config import get_config as jax_config
from systemml_tpu_torch.codegen import backend as kb
from systemml_tpu_torch.codegen import costmodel, tune
from systemml_tpu_torch.hops import cost as pcost
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.utils import stats as stats_mod
from systemml_tpu_torch.utils.config import DMLConfig, set_config


@pytest.fixture(autouse=True)
def _isolated():
    cfg = DMLConfig(device="cpu")
    cfg.codegen_tune_cache = ""
    set_config(cfg)
    jc = jax_config()
    saved = (jc.codegen_tune_cache, jc.codegen_cost_model_min_records)
    jc.codegen_tune_cache = ""
    kb.reset_process_state()
    jkb.reset_process_state()
    yield cfg
    jc.codegen_tune_cache, jc.codegen_cost_model_min_records = saved
    kb.reset_process_state()
    jkb.reset_process_state()
    kb._FAMILIES.pop("_test_sched_fam", None)
    set_config(DMLConfig())


POINTS = [{}, {"tile": 64}, {"tile": 128}, {"tile": 256}]


def _families():
    """The same synthetic schedule space, registered in both packages:
    a four-point template and a plain terminal fallback."""
    def register(mod):
        fam = mod.KernelFamily("_test_sched_fam")
        fam.template("tmpl", POINTS,
                     cost=lambda ctx: 1e-6 * (ctx.get("sched") or {})
                     .get("tile", 32), fallback="plain")(
            lambda ctx: float((ctx.get("sched") or {}).get("tile", 32)))
        fam.variant("plain", cost=lambda ctx: 1e-3, is_fallback=True)(
            lambda ctx: 32.0)
        return fam

    return register(kb), register(jkb)


def _keys(shape):
    cfg = {"agg": "sum"}
    return (kb.make_key("_test_sched_fam", backend="cpu", shape=shape,
                        dtype="float32", sparsity=0.01, config=cfg),
            jkb.make_key("_test_sched_fam", shape=shape, dtype="float32",
                         sparsity=0.01, config=cfg))


def _records(fam, key, featurize, shapes, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for m, n in shapes:
        for name in fam.order:
            v = fam.variants[name]
            tile = (v.sched or {}).get("tile", 0)
            lt = (-6.0 + 0.9 * math.log2(m) + (0.5 if v.sched is None
                                               and v.template else 0.0)
                  + (0.1 * math.log2(tile) if tile else 0.0)
                  + 0.02 * rng.standard_normal())
            t = 10.0 ** lt
            out.append({"variant": name, "time_s": t,
                        "feat": featurize(key(m, n), v,
                                          {"bytes": 4.0 * m * n,
                                           "cost_ratio": 0.5}, t * 1.5)})
    return out


SHAPES = [(256, 64), (1024, 64), (4096, 64), (16384, 64)]


def test_kernel_feature_row_equals_the_jax_package():
    for shape, db, sp in (((1000, 64), 4, None), ((71567, 10681, 10), 8,
                                                  0.013), ((0,), 1, 2.0)):
        assert pcost.kernel_feature_row(shape, db, sp,
                                        pcost.HwProfile.cpu()) == \
            jcost.kernel_feature_row(shape, db, sp, jcost.HwProfile.cpu())


def test_features_equal_the_jax_package():
    pf, jf = _families()
    for shape in SHAPES:
        pk, jk = _keys(shape)
        for name in pf.order:
            for cost in (1e-4, None, float("nan")):
                ctx = {"bytes": 1e6, "cost_ratio": 0.25, "sparsity": 0.01}
                assert costmodel.featurize(pk, pf.variants[name], ctx,
                                           cost) == \
                    jcm.featurize(jk, jf.variants[name], ctx, cost)
    assert costmodel.feature_len() == jcm.feature_len()


def test_ridge_weights_equal_the_jax_package():
    pf, jf = _families()
    precs = _records(pf, lambda m, n: _keys((m, n))[0], costmodel.featurize,
                     SHAPES)
    jrecs = _records(jf, lambda m, n: _keys((m, n))[1], jcm.featurize,
                     SHAPES)
    assert precs == jrecs
    pm = costmodel.fit_records(precs, min_records=4)
    jm = jcm.fit_records(jrecs, min_records=4)
    np.testing.assert_allclose(pm.weights, jm.weights, rtol=1e-9, atol=1e-12)
    assert pm.y_mean == pytest.approx(jm.y_mean, rel=1e-12)
    assert pm.n_records == jm.n_records == len(precs)
    pk, jk = _keys((60000, 64))
    for name in pf.order:
        f = costmodel.featurize(pk, pf.variants[name], {}, 1e-3)
        assert pm.predict_s(f) == pytest.approx(jm.predict_s(f), rel=1e-9)
    assert costmodel.fit_records(precs[:3], min_records=4) is None


def test_shortlist_and_residual_equal_the_jax_package(_isolated):
    pf, jf = _families()
    _isolated.codegen_cost_model_min_records = 4
    jax_config().codegen_cost_model_min_records = 4
    for rec in _records(pf, lambda m, n: _keys((m, n))[0],
                        costmodel.featurize, SHAPES):
        costmodel.add_record("_test_sched_fam", rec["variant"],
                             rec["time_s"], rec["feat"])
        jcm.add_record("_test_sched_fam", rec["variant"], rec["time_s"],
                       rec["feat"])
    pk, jk = _keys((8192, 64))
    costs = {n: 1e-5 * (i + 1) for i, n in enumerate(pf.order)}
    cands = [pf.variants[n] for n in pf.order]
    kb._FAMILIES["_test_sched_fam"] = pf
    try:
        po, pi = costmodel.shortlist(pf, cands, pk, {}, costs, "tmpl")
    finally:
        kb._FAMILIES.pop("_test_sched_fam", None)
    jo, ji = jcm.shortlist(jf, [jf.variants[n] for n in jf.order], jk, {},
                           costs, "tmpl")
    assert po == jo and pi["source"] == ji["source"] == "model"
    assert "plain" in po                        # the guardrail arm
    assert pi["pred"] == pytest.approx(ji["pred"], rel=1e-9)
    meta = {"samples": {po[0]: 2e-4}}
    assert costmodel.residual(pi, meta, po[0]) == \
        jcm.residual(ji, meta, jo[0])


def test_cold_start_falls_back_analytic_with_named_event(_isolated):
    pf, _ = _families()
    kb._FAMILIES["_test_sched_fam"] = pf
    _isolated.codegen_tune_mode = "online"
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st), obs.session() as rec:
        kb.dispatch("_test_sched_fam", (), shape=(64, 64))
    cold = [e for e in rec.events() if e.name == "kernel_fallback"
            and e.args.get("reason") == "cold_model"]
    assert cold and st.estim_counts.get("kb_cold_model", 0) == 1
    search = [e for e in rec.events() if e.name == "kernel_search"][0]
    assert search.args["model"] == "cold" and search.args["space"] == 5
    assert "plain" in search.args["shortlist"]
    assert sorted(search.args["shortlist"] + search.args["pruned"]) == \
        sorted(pf.order)
    assert st.estim_counts.get("kb_select_measured", 0) == 1


def test_warm_model_ranks_and_cached_records_persist(_isolated, tmp_path):
    """With records past the threshold the model ranks the sweep; a
    cached tournament persists its records, which a fresh process reads
    back as training data for the same device kind."""
    pf, _ = _families()
    kb._FAMILIES["_test_sched_fam"] = pf
    _isolated.codegen_tune_mode = "cached"
    _isolated.codegen_tune_cache = str(tmp_path / "tune.json")
    _isolated.codegen_cost_model_min_records = 4
    key = kb.make_key("_test_sched_fam", backend="cpu", shape=(64, 64))
    for name in pf.order:
        v = pf.variants[name]
        t = 1e-5 if v.sched else 1e-3
        costmodel.add_record("_test_sched_fam", name, t,
                             costmodel.featurize(key, v, {}, t))
    with obs.session() as rec:
        kb.dispatch("_test_sched_fam", (), shape=(4096, 64))
    search = [e for e in rec.events() if e.name == "kernel_search"][0]
    assert search.args["model"] == "model"
    assert "plain" in search.args["shortlist"]
    raw = json.loads((tmp_path / "tune.json").read_text())
    (ent,) = raw["entries"].values()
    assert raw["schema"] == 2 and ent["records"]
    assert len(ent["records"][0]["feat"]) == costmodel.feature_len()
    kb.reset_process_state()
    assert len(tune.training_records("_test_sched_fam")) == \
        len(ent["records"])
    assert len(costmodel.records_for("_test_sched_fam")) == \
        len(ent["records"])


def test_fit_memoised_and_switched_off(_isolated):
    _isolated.codegen_cost_model_min_records = 2
    pf, _ = _families()
    key = kb.make_key("_test_sched_fam", backend="cpu", shape=(64, 64))
    for name in pf.order[:3]:
        costmodel.add_record("_test_sched_fam", name, 1e-4,
                             costmodel.featurize(key, pf.variants[name], {},
                                                 1e-4))
    m1 = costmodel.fit("_test_sched_fam")
    assert m1 is not None and costmodel.fit("_test_sched_fam") is m1
    _isolated.codegen_cost_model = "off"
    assert costmodel.fit("_test_sched_fam") is None


def test_ingest_profile_waits_for_the_profiler():
    with pytest.raises(NotImplementedError, match="item 11"):
        costmodel.ingest_profile({"kernels": {}})
