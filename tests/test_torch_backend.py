"""The port's kernel backend (systemml_tpu_torch/codegen/backend.py,
tune.py) against the JAX package's (systemml_tpu/codegen/backend.py,
tune.py), on the CPU, with seeded numpy inputs.

Held equal to the JAX package: the shape and sparsity buckets, kernel
keys (cache strings, with the backend "cpu") and plan digests, and the
analytic choice of every family under the CPU profile (pallas_mode
"auto", and "always", where the hand-kernel variants are candidates and
their wrappers run the plain versions on the CPU). Held in the port:
one kernel_select event per key, force_variant, a call the hand kernel
does not take counted and evented as a fallback of kind "unsupported"
(no runtime fallback: a variant that raises raises through dispatch),
online and cached tuning with 0 re-measurements, a corrupt cache
ignored, concurrent writers merged, no measurement inside a capture,
and the equivalence matrix: every registered family's variants (the
sweeps sampled) on the same inputs give the JAX package's fallback arm's
value, at 1e-9 in fp64, and 1e-4 for mmchain in fp32 (its two products
sum in another order than the JAX package's; the reference's own bar for
that family is 5e-4).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import systemml_tpu.codegen.compiler  # noqa: F401  (registers spoof_*)
import systemml_tpu.compress.device   # noqa: F401  (registers cla_*)
import systemml_tpu.ops.mult          # noqa: F401  (registers mmchain/q_*)
import systemml_tpu_torch.codegen.compiler  # noqa: F401
import systemml_tpu_torch.compress.device   # noqa: F401
import systemml_tpu_torch.ops.mult          # noqa: F401
from systemml_tpu.codegen import backend as jkb
from systemml_tpu.utils.config import get_config as jax_config
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.codegen import backend as kb
from systemml_tpu_torch.codegen import tune
from systemml_tpu_torch.codegen.cplan import CNode
from systemml_tpu_torch.hops.hop import Hop
from systemml_tpu_torch.utils import stats as stats_mod
from systemml_tpu_torch.utils.config import DMLConfig, set_config

# the port's variant names -> the JAX package's
JAX_NAME = {"kernel": "pallas", "plain": "jnp", "two_pass": "jnp_two_pass"}
JAX_TEMPLATE = {"mmchain": "pallas_single_pass"}


def _jax_name(op, name):
    if name == "kernel":
        return JAX_TEMPLATE.get(op, "pallas")
    return JAX_NAME.get(name, name)


@pytest.fixture(autouse=True)
def _fresh():
    """A CPU config of the port's and the JAX package's defaults, off any
    real tuning cache, with the decision memos cleared."""
    cfg = DMLConfig(device="cpu")
    cfg.codegen_tune_cache = ""
    set_config(cfg)
    jc = jax_config()
    saved = (jc.pallas_mode, jc.codegen_tune_mode, jc.codegen_tune_cache)
    jc.pallas_mode, jc.codegen_tune_mode, jc.codegen_tune_cache = \
        "auto", "off", ""
    kb.reset_process_state()
    jkb.reset_process_state()
    yield cfg
    jc.pallas_mode, jc.codegen_tune_mode, jc.codegen_tune_cache = saved
    kb.reset_process_state()
    jkb.reset_process_state()
    set_config(DMLConfig())


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------


def test_buckets_equal_the_jax_package():
    for dims in [(100, 129), (1, 0, -5), (2_000_000, 1000, 1), (3,), ()]:
        assert kb.shape_bucket(*dims) == jkb.shape_bucket(*dims)
    for sp in (None, float("nan"), -1.0, 0.0, 0.001, 0.05, 0.5, 1.0, 2.0):
        assert kb.sparsity_bucket(sp) == jkb.sparsity_bucket(sp)


@pytest.mark.parametrize("op,shape,dtype,sp,config", [
    ("mmchain", (1000, 128, 1), "float32", None,
     {"ctype": "XtXv", "precise": True}),
    ("spoof_cell", (2_000_000, 1), "float64", None,
     {"plan": "abc", "agg": "sum"}),
    ("q_wsloss", (71567, 10681, 10), "float32", 0.013, {"post": "POST_NZ"}),
    ("cla_mmchain", (2_458_285, 68, 1), "f32", None,
     {"layout": "0f1e", "ctype": "XtXv"}),
])
def test_kernel_keys_equal_the_jax_package(op, shape, dtype, sp, config):
    mine = kb.make_key(op, backend="cpu", shape=shape, dtype=dtype,
                       sparsity=sp, config=config)
    ref = jkb.make_key(op, shape=shape, dtype=dtype, sparsity=sp,
                       config=config)
    assert mine.cache_str() == ref.cache_str()
    assert kb.make_key(op, backend="cuda", shape=shape, dtype=dtype,
                       sparsity=sp, config=config).cache_str() == \
        ref.cache_str().replace("|cpu|", "|cuda|", 1)
    assert kb.dtype_name(torch.float32) == "float32"


def test_plan_digests_equal_the_jax_package():
    from systemml_tpu.codegen.cplan import CNode as JCNode

    def plan(C):
        return C("b(+)", [C("b(*)", [C("in", name="a"), C("lit", value=2.0)]),
                          C("u(exp)", [C("in", name="b")])])

    assert kb.plan_digest(plan(CNode).key()) == \
        jkb.plan_digest(plan(JCNode).key())
    assert kb.plan_digest(("b(+)", None)) == jkb.plan_digest(("b(+)", None))


# --------------------------------------------------------------------------
# the families and their inputs (numpy-seeded, the same for both packages)
# --------------------------------------------------------------------------


def _csr(rng, m=30, n=20, k=3, sp=0.15):
    x = np.where(rng.random((m, n)) < sp, rng.standard_normal((m, n)), 0.0)
    return x, rng.standard_normal((m, k)), rng.standard_normal((n, k))


def _cla_data(rng, distinct=4, n=64):
    vals = rng.choice(np.linspace(1.0, 2.0, distinct), (n, 2))
    run = np.repeat(rng.choice([3.0, 5.0], n // 8), 8)[:n]
    return np.column_stack([vals, run])


def _spoof_hop(pkg, template, params):
    if pkg == "jax":
        from systemml_tpu.hops.hop import Hop as JHop

        return JHop("spoof", [], dict(params, template=template))
    return Hop("spoof", [], dict(params, template=template))


def _plan(pkg, kind):
    from systemml_tpu.codegen.cplan import CNode as JCNode

    C = JCNode if pkg == "jax" else CNode
    if kind == "cell":
        return C("b(*)", [C("in", name="a"), C("in", name="b")])
    if kind == "row":
        return C("u(exp)", [C("in", name="a")])
    if kind == "outer":
        return C("b(*)", [C("in", name="X"), C("in", name="UV")])
    return C("u(abs)", [C("in", name="a")])


def _call(pkg, op, seed=1234):
    """A thunk running family `op` through the package's entry point on
    seeded inputs; the array of its value as float64."""
    rng = np.random.default_rng(seed)
    if pkg == "jax":
        import jax.numpy as jnp

        from systemml_tpu.codegen.compiler import execute_spoof
        from systemml_tpu.compress import compress
        from systemml_tpu.compress import device as dev
        from systemml_tpu.ops import mult
        from systemml_tpu.runtime.sparse import SparseMatrix

        arr = lambda a, dt=np.float64: jnp.asarray(np.asarray(a, dt))
        sparse = SparseMatrix.from_dense
    else:
        from systemml_tpu_torch.codegen.compiler import execute_spoof
        from systemml_tpu_torch.compress import compress
        from systemml_tpu_torch.compress import device as dev
        from systemml_tpu_torch.ops import mult
        from systemml_tpu_torch.runtime.sparse import SparseMatrix

        arr = lambda a, dt=np.float64: torch.as_tensor(np.asarray(a, dt))
        sparse = lambda a: SparseMatrix.from_dense(torch.as_tensor(a))
    if op.startswith("spoof_"):
        kind = op[len("spoof_"):]
        if kind == "cell":
            h = _spoof_hop(pkg, "cell", {"plan": _plan(pkg, "cell"),
                                         "agg": "sum",
                                         "leaf_names": ["a", "b"]})
            args = [arr(rng.standard_normal((24, 10))),
                    arr(rng.standard_normal((24, 10)))]
        elif kind == "row":
            h = _spoof_hop(pkg, "row", {"plan": _plan(pkg, "row"),
                                        "row_agg": "max",
                                        "leaf_names": ["a"]})
            args = [arr(rng.standard_normal((24, 10)))]
        elif kind == "outer":
            h = _spoof_hop(pkg, "outer", {"plan": _plan(pkg, "outer"),
                                          "scalar_names": []})
            args = [arr(rng.standard_normal((24, 10))),
                    arr(rng.standard_normal((24, 4))),
                    arr(rng.standard_normal((10, 4)))]
        else:
            h = _spoof_hop(pkg, "multiagg", {"plan": _plan(pkg, "magg"),
                                             "aggs": ["sum", "max"],
                                             "leaf_names": ["a"]})
            args = [arr(rng.standard_normal((12, 6)))]
        return lambda: execute_spoof(h, args)
    if op == "mmchain":
        x = arr(rng.standard_normal((40, 130)), np.float32)
        v = arr(rng.standard_normal((130, 1)), np.float32)
        w = arr(rng.standard_normal((40, 1)), np.float32)
        return lambda: mult.mmchain(x, v, w, "XtwXv")
    if op.startswith("q_"):
        x, u, v = _csr(rng)
        sx, u, v = sparse(x), arr(u), arr(v)
        return {
            "q_wsloss": lambda: mult.wsloss(sx, u, v, None, "POST_NZ"),
            "q_wsigmoid": lambda: mult.wsigmoid(sx, u, v, "log"),
            "q_wdivmm": lambda: mult.wdivmm(sx, u, v, False, True),
            "q_wcemm": lambda: mult.wcemm(sx, u, v, 1.5),
            "q_wumm": lambda: mult.wumm(sx, u, v, "*", uop="abs"),
        }[op]
    c = compress(_cla_data(rng))
    if op == "cla_right":
        w = arr(rng.standard_normal((3, 2)))
        return lambda: dev.right_mult(c, w)
    if op == "cla_left":
        yt = arr(rng.standard_normal((2, 64)))
        return lambda: dev.left_mult(c, yt)
    if op == "cla_tsmm":
        return lambda: dev.tsmm(c)
    v = arr(rng.standard_normal((3, 1)))
    w = arr(rng.standard_normal((64, 1)))
    return lambda: dev.mmchain(c, v, w, "XtwXv")


def _value(r):
    if isinstance(r, tuple):
        return np.concatenate([np.asarray(_value(x)).ravel() for x in r])
    if hasattr(r, "to_dense"):
        r = r.to_dense()
    if isinstance(r, torch.Tensor):
        return r.detach().cpu().double().numpy()
    return np.asarray(r, dtype=np.float64)


FAMILIES = ["spoof_cell", "spoof_row", "spoof_outer", "spoof_multiagg",
            "mmchain", "q_wsloss", "q_wsigmoid", "q_wdivmm", "q_wcemm",
            "q_wumm", "cla_right", "cla_left", "cla_tsmm", "cla_mmchain"]


def test_every_registered_family_is_covered_and_named_as_the_jax_package():
    assert sorted(kb.families()) == sorted(FAMILIES)
    assert sorted(op for op in jkb.families()
                  if not op.startswith("_test")) == sorted(FAMILIES)
    for op in FAMILIES:
        fam = kb.families()[op]
        assert fam.fallback_name is not None
        # every variant but the fallback declares one
        for name in fam.order:
            v = fam.variants[name]
            assert v.is_fallback or v.fallback == fam.fallback_name, name
        bases = {fam.variants[n].template or n for n in fam.order}
        assert {_jax_name(op, b) for b in bases} == {
            jkb.families()[op].variants[n].template or n
            for n in jkb.families()[op].order}


def _selected(rec, op):
    return [e for e in rec.events() if e.name == "kernel_select"
            and e.args["op"] == op]


@pytest.mark.parametrize("mode", ["auto", "always"])
@pytest.mark.parametrize("op", FAMILIES)
def test_analytic_choice_equals_the_jax_package(op, mode, _fresh):
    """The CPU profile's analytic choice of each family, in both packages,
    with the hand kernels candidates or not."""
    from systemml_tpu.obs import trace as jobs

    _fresh.pallas_mode = mode
    jax_config().pallas_mode = mode
    with obs.session() as rec:
        _call("port", op)()
    with jobs.session() as jrec:
        _call("jax", op)()
    mine = _selected(rec, op)
    ref = [e for e in jrec.events() if e.name == "kernel_select"
           and e.args["op"] == op]
    assert len(mine) == 1 and len(ref) == 1
    assert _jax_name(op, mine[0].args["choice"]) == ref[0].args["choice"]
    assert mine[0].args["source"] == ref[0].args["source"]


def test_one_select_event_per_key_and_the_stats_line():
    run = _call("port", "mmchain")
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st), obs.session() as rec:
        for _ in range(3):
            run()
    assert len(_selected(rec, "mmchain")) == 1
    assert st.estim_counts.get("kb_select_analytic", 0) == 1
    assert st.estim_counts.get("kb_pick_mmchain.two_pass", 0) == 1
    assert "Kernel backend (event=count): pick_mmchain.two_pass=1" \
        in st.display()


def test_one_choice_per_key_across_threads():
    """Parfor lanes meeting a key at once: the choice is made once, under
    the lock, and every lane runs it."""
    run = _call("port", "spoof_cell")
    barrier = threading.Barrier(8)

    def lane():
        barrier.wait()
        run()

    with obs.session() as rec:
        ts = [threading.Thread(target=lane) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert len(_selected(rec, "spoof_cell")) == 1
    assert len(kb._DECISIONS) == 1


def test_force_variant_overrides_selection():
    run = _call("port", "q_wsloss")
    ref = _value(run())
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st):
        with kb.force_variant("q_wsloss", "dense"):
            got = _value(run())
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert st.estim_counts.get("spx_wsloss_densify", 0) == 1


def test_a_call_the_kernel_refuses_is_an_unsupported_fallback(_fresh):
    """pallas_mode "always" makes K1 and K2 candidates on the CPU. A
    chain of c = 9 columns (K1 takes c <= 8, as the JAX family) and a leaf
    layout the spoof kernels refuse are turned away by the variants'
    `accepts` before any launch: the fallback runs, counted kb_fallback
    and evented kind "unsupported" (the spoof one also counts
    spoof_plain_by_layout, as before)."""
    from systemml_tpu_torch.codegen.compiler import execute_spoof
    from systemml_tpu_torch.ops import mult

    _fresh.pallas_mode = "always"
    rng = np.random.default_rng(3)
    # 300 x 2,100: large enough that the CPU profile prices K1 below the
    # two products (the JAX package's crossover, about 430,000 cells)
    x = _t(rng.standard_normal((300, 2100)), torch.float32)
    v = _t(rng.standard_normal((2100, 9)), torch.float32)
    h = Hop("spoof", [], {"template": "cell", "plan": _plan("port", "cell"),
                          "agg": "sum", "leaf_names": ["a", "b"]})
    a = rng.standard_normal((8, 6))
    b = rng.standard_normal((8, 2))      # a layout the kernels refuse
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st), obs.session() as rec:
        got = mult.mmchain(x, v)
        with pytest.raises(RuntimeError):
            # the plain arm, too, finds (8, 6) * (8, 2) incompatible
            execute_spoof(h, [_t(a), _t(b)])
    np.testing.assert_allclose(got.numpy(), (x.T @ (x @ v)).numpy(),
                               rtol=1e-4)
    fb = [e for e in rec.events() if e.name == "kernel_fallback"]
    assert [(e.args["op"], e.args["kind"], e.args["fallback"])
            for e in fb] == [("mmchain", "unsupported", "two_pass"),
                             ("spoof_cell", "unsupported", "plain")]
    assert st.estim_counts.get("kb_fallback", 0) == 2
    assert st.estim_counts.get("spoof_plain_by_layout", 0) == 1
    # the selection still chose the kernel: the refusal is per call
    assert st.estim_counts.get("kb_pick_mmchain.kernel", 0) == 1


def test_a_variant_that_raises_raises_through_dispatch():
    fam = kb.family("_test_raising")
    if not fam.variants:
        @fam.variant("boom", cost=lambda ctx: 0.0, fallback="ok")
        def _boom(ctx):
            raise ValueError("the variant's own failure")

        @fam.variant("ok", cost=lambda ctx: 1.0, is_fallback=True)
        def _ok(ctx):
            return "ok"

    try:
        with pytest.raises(ValueError, match="own failure"):
            kb.dispatch("_test_raising", ())
    finally:
        kb._FAMILIES.pop("_test_raising", None)


def test_nan_costs_fall_back_to_registration_order():
    fam = kb.family("_test_nan")
    if not fam.variants:
        fam.variant("a", cost=lambda ctx: float("nan"), fallback="b")(
            lambda ctx: "a")
        fam.variant("b", cost=lambda ctx: float("nan"), is_fallback=True)(
            lambda ctx: "b")
    st = stats_mod.Statistics()
    try:
        with stats_mod.stats_scope(st), obs.session() as rec:
            assert kb.dispatch("_test_nan", ()) == "a"
    finally:
        kb._FAMILIES.pop("_test_nan", None)
    fb = [e for e in rec.events() if e.name == "kernel_fallback"]
    assert fb and fb[0].args["reason"] == "nan_cost"
    assert st.estim_counts.get("kb_nan_cost", 0) == 1


# --------------------------------------------------------------------------
# measured tuning + the on-disk cache
# --------------------------------------------------------------------------


def test_online_tuning_measures_and_picks_a_variant(_fresh):
    _fresh.codegen_tune_mode = "online"
    _fresh.codegen_tune_trials = 2
    run = _call("port", "q_wsloss")
    before = tune.measurement_count()
    with obs.session() as rec:
        run()
    assert tune.measurement_count() == before + 1
    sel = _selected(rec, "q_wsloss")
    assert sel and sel[0].args["source"] == "measured"
    search = [e for e in rec.events() if e.name == "kernel_search"]
    assert search and search[0].args["shortlist"] == ["exploit", "dense"]


def test_cached_mode_zero_remeasure_and_equal_results(_fresh, tmp_path):
    """A second "process" (backend.reset_process_state) serves the key
    from the disk cache with 0 measurements, choosing what was measured;
    the entry names the device ("cpu") and each arm's median."""
    run = _call("port", "mmchain")
    ref = _value(run())
    cache = tmp_path / "tune.json"
    _fresh.codegen_tune_cache = str(cache)
    _fresh.codegen_tune_mode = "cached"
    _fresh.codegen_tune_trials = 2
    _fresh.pallas_mode = "always"
    kb.reset_process_state()
    got1 = _value(run())
    assert tune.measurement_count() == 1
    (full_key, entry), = json.loads(cache.read_text())["entries"].items()
    assert full_key.startswith("mmchain|cpu|float32|") and \
        full_key.endswith("|cpu")
    mo = entry["measured_on"]
    assert mo["device_kind"] == "cpu" and mo["backend"] == "cpu"
    assert mo["trials"] == 2 and mo["rounds"]
    assert set(mo["samples"]) == {"kernel", "two_pass"}
    assert mo["n"] == {"kernel": 2, "two_pass": 2}
    kb.reset_process_state()
    assert tune.measurement_count() == 0
    with obs.session() as rec:
        got2 = _value(run())
    assert tune.measurement_count() == 0
    sel = _selected(rec, "mmchain")
    assert sel[0].args["source"] == "cache"
    assert sel[0].args["choice"] == entry["choice"]
    np.testing.assert_allclose(got1, ref, rtol=1e-5)
    assert np.array_equal(got1, got2)


def test_no_measurement_inside_a_capture(_fresh, monkeypatch):
    """A key first met while the stream captures keeps its analytic
    choice and counts kb_capture_unmeasured (a capture cannot sync)."""
    _fresh.codegen_tune_mode = "online"
    monkeypatch.setattr(kb, "_capturing", lambda: True)
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st), obs.session() as rec:
        _call("port", "q_wcemm")()
    assert tune.measurement_count() == 0
    assert st.estim_counts.get("kb_capture_unmeasured", 0) == 1
    assert _selected(rec, "q_wcemm")[0].args["source"] == "analytic"


def test_corrupt_tune_cache_is_ignored(_fresh, tmp_path):
    cache = tmp_path / "tune.json"
    cache.write_text("{not json")
    _fresh.codegen_tune_cache = str(cache)
    _fresh.codegen_tune_mode = "cached"
    _fresh.codegen_tune_trials = 2
    x, u, v = _csr(np.random.default_rng(1234))
    got = float(_value(_call("port", "q_wsloss")()))
    exp = ((x != 0) * (x - u @ v.T) ** 2).sum()
    assert got == pytest.approx(float(exp), rel=1e-9)
    assert json.loads(cache.read_text())["version"] == 1


def test_tune_store_merges_concurrent_writers(_fresh, tmp_path):
    """store() commits the fresh disk state with this process's own
    verdicts only: another process's new keys survive, and a key this
    process merely loaded does not revert."""
    cache = tmp_path / "tune.json"
    _fresh.codegen_tune_cache = str(cache)
    k1 = kb.make_key("opA", shape=(8,), dtype="f32")
    tune.store(k1, "x", {"trials": 2})
    kb.reset_process_state()              # "fresh process": drops _own
    assert tune.lookup(k1) == "x"
    raw = json.loads(cache.read_text())
    for ks in list(raw["entries"]):
        raw["entries"][ks] = {"choice": "x2", "measured_on": {}}
    raw["entries"]["other|key"] = {"choice": "y", "measured_on": {}}
    cache.write_text(json.dumps(raw))
    k2 = kb.make_key("opB", shape=(8,), dtype="f32")
    tune.store(k2, "z", {"trials": 2})
    final = json.loads(cache.read_text())["entries"]
    assert "other|key" in final and len(final) == 3
    assert [v for ks, v in final.items() if "opA" in ks][0]["choice"] == "x2"


def test_tune_cache_defaults_to_the_ports_own_path():
    assert DMLConfig().codegen_tune_cache == \
        "~/.cache/systemml_tpu_torch/tune.json"
    assert tune._device_kind("cpu") == "cpu"


# --------------------------------------------------------------------------
# the equivalence matrix: every family, its variants (sweeps sampled),
# against the JAX package's fallback arm
# --------------------------------------------------------------------------


def _sampled_variants(fam):
    """Every plain variant, and of each template its own point, its first
    swept point and its last: the sched-injection path and both ends."""
    plain, by_template = [], {}
    for name in fam.order:
        t = fam.variants[name].template
        if t is None:
            plain.append(name)
        else:
            by_template.setdefault(t, []).append(name)
    for pts in by_template.values():
        plain.extend(dict.fromkeys([pts[0], pts[1 % len(pts)], pts[-1]]))
    return plain


@pytest.mark.parametrize("op", ["spoof_cell", "spoof_row", "spoof_outer",
                                "spoof_multiagg", "mmchain"])
def test_template_families_sweep_run_time_launch_parameters(op):
    fam = kb.families()[op]
    swept = [n for n in fam.order if "@" in n]
    assert swept and all(fam.variants[n].template == "kernel" for n in swept)
    keys = {k for n in swept for k in fam.variants[n].sched}
    assert keys == ({"grid_y"} if op == "spoof_outer" else {"bps"})
    sampled = [n for n in _sampled_variants(fam) if "@" in n]
    assert 0 < len(sampled) < len(swept)


@pytest.mark.parametrize("op", FAMILIES)
def test_variant_equivalence_against_the_jax_package(op, _fresh):
    _fresh.pallas_mode = "always"
    ref_name = jkb.families()[op].fallback_name
    with jkb.force_variant(op, ref_name):
        ref = _value(_call("jax", op)())
    rtol = 1e-4 if op == "mmchain" else 1e-9
    fam = kb.families()[op]
    for name in _sampled_variants(fam):
        with kb.force_variant(op, name):
            got = _value(_call("port", op)())
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-12,
                                   err_msg=f"{op}: {name} vs the JAX "
                                           f"package's {ref_name}")


# --------------------------------------------------------------------------
# grep-level: no private dispatch branches left, no runtime fallback
# --------------------------------------------------------------------------


def _src(*parts):
    root = os.path.join(os.path.dirname(__file__), "..", "systemml_tpu_torch")
    with open(os.path.join(root, *parts)) as f:
        return f.read()


def test_no_private_dispatch_branches_left():
    import re

    device_src = _src("compress", "device.py")
    assert "_DECISIONS" not in device_src and "_COSTS" not in device_src
    assert not re.search(r"\b_select\(", device_src)
    assert "reset_decisions" not in device_src
    mult_src = _src("ops", "mult.py")
    assert "def _q_run(" not in mult_src and "def _q_decision(" not in mult_src
    assert "kernels.mmchain_supported(m, k, c" not in \
        mult_src.split("def _mmchain_kernel_accepts")[0]
    compiler_src = _src("codegen", "compiler.py")
    body = compiler_src.split("def execute_spoof")[1].split("\ndef ")[0]
    assert "kernels.cell_kernel(" not in body
    assert "kbackend.dispatch(" in body
    # no except clause in the backend at all, nor in the tuner's
    # tournament: a variant that raises raises, and none is dropped
    import ast

    tree = ast.parse(_src("codegen", "backend.py"))
    assert not [n for n in ast.walk(tree)
                if isinstance(n, ast.ExceptHandler)]
    tree = ast.parse(_src("codegen", "tune.py"))
    measure = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                   and n.name == "measure")
    assert not [n for n in ast.walk(measure)
                if isinstance(n, ast.ExceptHandler)]
