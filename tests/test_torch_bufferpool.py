"""The port's buffer pool (runtime/bufferpool.py) against the JAX
package's, on the CPU.

The cases of tests/test_bufferpool.py (the parfor case waits for parfor):
evictions and restores under a small budget with the results of an
unlimited pool and of the JAX package, the disk tier, rebinding and
function frames releasing their handles, JMLC releasing each run's
scope, the pool switched off, an out-of-budget sweep; and the port's own
cases: a host copy that goes stale when its tensor is written in place,
an eviction dropping the cached region entries that read the evicted
storage, a loop's reads pinned while it runs, and the caller's inputs
never admitted.

Bars: fp64 relative 1e-12 against the unlimited pool, 1e-9 against the
JAX package; a restored tensor equal to what was evicted, bit for bit.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dml as jax_dml
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu_torch.api.mlcontext import MLContext, dml
from systemml_tpu_torch.lang.parser import parse
from systemml_tpu_torch.runtime import bufferpool as bp
from systemml_tpu_torch.runtime import loopfuse
from systemml_tpu_torch.runtime.program import compile_program
from systemml_tpu_torch.utils import config as port_config
from systemml_tpu_torch.utils.config import DMLConfig

# if-blocks keep A, B and C in blocks of their own, re-read later; the
# predicates read a runtime value, so that no branch folds away
SCRIPT = """
gate = as.scalar(rand(rows=1, cols=1, min=1, max=1, seed=9))
A = rand(rows=200, cols=200, seed=1)
B = rand(rows=200, cols=200, seed=2)
s1 = 0.0
s2 = 0.0
s3 = 0.0
if (gate > 0) { s1 = sum(A %*% B) }
C = rand(rows=200, cols=200, seed=3)
if (gate > 0) { s2 = sum(B %*% C) }
if (gate > 0) { s3 = sum(A + C) }
out = s1 + s2 + s3
"""


def _cfg(tmp_path, **kw):
    cfg = DMLConfig(device="cpu")
    cfg.bufferpool_min_bytes = 1 << 10
    cfg.scratch_dir = str(tmp_path)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _run(cfg, src=SCRIPT, out="out", inputs=None):
    ml = MLContext(cfg)
    s = dml(src).output(out)
    for k, v in (inputs or {}).items():
        s.input(k, v)
    with contextlib.redirect_stdout(io.StringIO()):
        res = ml.execute(s)
    return float(res.get_scalar(out)), ml._stats


def _jax(src=SCRIPT, out="out"):
    cfg = JaxConfig()
    cfg.pallas_mode = "never"
    cfg.exec_mode = "SINGLE_NODE"
    res = JaxMLContext(cfg).execute(jax_dml(src).output(out))
    return float(np.asarray(res.get(out)))


@pytest.fixture
def port_cpu(tmp_path):
    old = port_config.get_config()
    port_config.set_config(_cfg(tmp_path))
    yield port_config.get_config()
    port_config.set_config(old)


def test_eviction_under_small_budget(tmp_path):
    expect, st0 = _run(_cfg(tmp_path))
    assert st0.pool_counts.get("evict", 0) == 0
    # 200 x 200 fp64 = 320 KB a matrix: a 400 KB budget holds one
    got, st = _run(_cfg(tmp_path, bufferpool_budget_bytes=400_000.0))
    assert got == pytest.approx(expect, rel=1e-12)
    assert st.pool_counts["evict"] > 0 and st.pool_counts["restore"] > 0
    assert got == pytest.approx(_jax(), rel=1e-9)


def test_disk_spill_tier(tmp_path):
    expect, _ = _run(_cfg(tmp_path))
    got, st = _run(_cfg(tmp_path, bufferpool_budget_bytes=400_000.0,
                        bufferpool_host_budget_bytes=300_000.0))
    assert got == pytest.approx(expect, rel=1e-12)
    assert st.pool_counts["disk_spill"] > 0
    assert st.pool_counts["disk_restore"] > 0


def test_rebinding_releases_device_bytes(tmp_path, port_cpu):
    port_cpu.bufferpool_budget_bytes = 10e9
    prog = compile_program(parse("X = rand(rows=200, cols=200, seed=1)\n"
                                 "X = X + 1\nX = X * 2\ns = sum(X)\n"))
    prog.execute()
    live = [h for h in prog.pool._entries.values() if h.names]
    assert sum(h.nbytes for h in live) <= 2 * 200 * 200 * 8


def test_function_scope_releases(tmp_path, port_cpu):
    port_cpu.bufferpool_budget_bytes = 10e9
    prog = compile_program(parse(
        "f = function(matrix[double] M) return (double s) {\n"
        "  T = M %*% t(M)\n  s = sum(T)\n}\n"
        "X = rand(rows=200, cols=200, seed=1)\nr = f(X)\n"))
    prog.execute()
    names = [n for h in prog.pool._entries.values() for n in h.names]
    assert not any(n.endswith(":T") or n.endswith(":M") for n in names)


def test_jmlc_rebind_releases_scope(tmp_path):
    from systemml_tpu_torch.api.jmlc import Connection

    conn = Connection(_cfg(tmp_path, bufferpool_budget_bytes=10e9))
    ps = conn.prepare_script("s = sum(X %*% t(X))", input_names=["X"],
                             output_names=["s"])
    x = np.random.default_rng(0).standard_normal((200, 200))
    n_entries = []
    for _ in range(4):
        ps.set_matrix("X", x)
        float(ps.execute_script().get_scalar("s"))
        n_entries.append(len(ps._program.pool._entries))
    assert n_entries[-1] <= n_entries[0] + 1


def test_pool_disabled_passthrough(tmp_path):
    expect, _ = _run(_cfg(tmp_path))
    got, st = _run(_cfg(tmp_path, bufferpool_enabled=False))
    assert got == expect
    assert not st.pool_counts


def test_out_of_budget_sweep_spills_and_restores(tmp_path):
    k, n, m = 5, 500, 400
    lines = []
    for b in range(1, k + 1):
        lines.append(f"X{b} = rand(rows={n}, cols={m}, seed={b})")
        lines.append(f"for (z{b} in 1:1) {{ d{b} = 0 }}")
    sweep = " + ".join(f"sum(X{b})" for b in range(1, k + 1))
    lines += [f"acc1 = {sweep}", "for (zz in 1:1) { d0 = 0 }",
              f"acc2 = {sweep}", "out = acc1 - acc2"]
    src = "\n".join(lines)
    got, st = _run(_cfg(tmp_path, codegen_enabled=False,
                        bufferpool_budget_bytes=int(2.5 * n * m * 8)), src)
    assert got == 0.0
    assert st.pool_counts["evict"] > 0 and st.pool_counts["restore"] > 0


def test_stale_host_copy_is_taken_again(tmp_path, port_cpu):
    """restore, write in place, evict, restore: the second restore gives
    the written values, not the first eviction's copy."""
    pool = bp.BufferPool(cfg=port_cpu)
    t = torch.arange(4096, dtype=torch.float64).reshape(64, 64)
    h = pool.admit("s:X", t)
    pool.spill_device()
    assert not h.on_device
    first = pool.acquire(h)
    assert torch.equal(first, t)
    pool.spill_device()        # the copy is still good: taken once
    again = pool.acquire(h)
    again.add_(1.0)            # written in place after its restore
    pool.spill_device()
    back = pool.acquire(h)
    assert torch.equal(back, t + 1.0)
    from systemml_tpu_torch.utils.stats import Statistics

    st = Statistics()
    pool.stats = st
    back.mul_(2.0)
    pool.spill_device()
    assert st.pool_counts["stale_recopy"] == 1
    assert torch.equal(pool.acquire(h), (t + 1.0) * 2.0)


def test_unwritten_restore_reuses_its_host_copy(tmp_path, port_cpu):
    from systemml_tpu_torch.utils.stats import Statistics

    st = Statistics()
    pool = bp.BufferPool(cfg=port_cpu, stats=st)
    h = pool.admit("s:X", torch.ones(64, 64, dtype=torch.float64))
    for _ in range(3):
        pool.spill_device()
        pool.acquire(h)
    assert st.pool_counts["evict"] == 3
    assert "stale_recopy" not in st.pool_counts


def test_eviction_drops_region_entries_reading_the_storage(tmp_path,
                                                           port_cpu):
    """A cached region entry is keyed by the address of each invariant
    tensor it reads: evicting that tensor drops the entry, and the loop's
    next entry peels and captures again (on the card a new graph)."""
    src = ("s = 0.0\ni = 0\nwhile (i < 4) {\n  s = s + sum(X) * i\n"
           "  i = i + 1\n}\n")
    x = np.random.default_rng(1).standard_normal((64, 64))
    prog = compile_program(parse(src), input_names=["X"], outputs=["s"])
    xt = torch.from_numpy(x)
    prog.execute(inputs={"X": xt})
    loops = [fl for fl in list(loopfuse._live_loops)
             if fl.record["entries"] and fl._cache]
    fl = next(f for f in loops if any(
        len(p) == 6 and p[1] == "t" and p[5] == xt.data_ptr()
        for key in f._cache for p in key[1]))
    st = xt.untyped_storage()
    assert loopfuse.invalidate_storage(st.data_ptr(), st.nbytes()) >= 1
    assert not fl._cache
    ec = prog.execute(inputs={"X": xt})
    assert float(ec.vars["s"]) == pytest.approx(6 * x.sum(), rel=1e-12)
    assert fl.record["entries"] == 2


def test_region_invariant_under_pressure_matches(tmp_path):
    """A loop whose invariant input the pool evicts between entries gives
    the unpressured result (the region restores it, re-keyed)."""
    src = """
gate = as.scalar(rand(rows=1, cols=1, min=1, max=1, seed=9))
A = rand(rows=200, cols=200, seed=1)
B = rand(rows=200, cols=200, seed=2)
out = 0.0
for (j in 1:3) {
  if (gate > 0) { C = B * j }
  i = 0
  while (i < 3) {
    out = out + sum(A * C) / (i + 1)
    i = i + 1
  }
}
"""
    expect, _ = _run(_cfg(tmp_path), src)
    got, st = _run(_cfg(tmp_path, bufferpool_budget_bytes=400_000.0), src)
    assert got == expect
    assert st.pool_counts["evict"] > 0
    assert got == pytest.approx(_jax(src), rel=1e-9)


def test_loop_reads_are_pinned_while_it_runs(tmp_path, port_cpu):
    pool = bp.BufferPool(cfg=port_cpu)
    vm = bp.VarMap(pool)
    vm["X"] = torch.ones(64, 64, dtype=torch.float64)
    h = dict.get(vm, "X")
    with bp.pin_reads(vm, {"X"}):
        assert pool.spill_device() == 0
        assert h.on_device
    assert pool.spill_device() == h.nbytes


def test_caller_inputs_are_never_admitted(tmp_path, port_cpu):
    prog = compile_program(parse("s = sum(X * 2)"), input_names=["X"],
                           outputs=["s", "X"])
    xt = torch.ones(200, 200, dtype=torch.float64)
    ec = prog.execute(inputs={"X": xt})
    assert not isinstance(dict.get(ec.vars, "X"), bp.CacheableMatrix)
    assert ec.vars["X"] is xt


def test_budget_from_mem_settings(tmp_path):
    cfg = _cfg(tmp_path, mem_budget_bytes=1e9, mem_util_factor=0.5)
    assert bp.BufferPool(cfg=cfg).budget() == 0.5e9
    cfg.bufferpool_budget_bytes = 123.0
    assert bp.BufferPool(cfg=cfg).budget() == 123.0
    assert bp.BufferPool(cfg=cfg).host_budget() == 4 * 123.0


def test_dropped_program_frees_its_pool_without_the_cycle_collector(
        tmp_path, port_cpu):
    """A handle holds its pool weakly: a dropped program's pool and the
    tensors its handles hold die with the last reference, not at the
    next cyclic collection (an 8 GB matrix would otherwise stay on the
    card after its run)."""
    import gc
    import weakref as wr

    gc.disable()
    try:
        prog = compile_program(parse("A = rand(rows=200, cols=200, seed=1)\n"
                                     "s = sum(A)\n"), outputs=["A", "s"])
        ec = prog.execute()
        a = wr.ref(ec.vars["A"])
        pool = wr.ref(prog.pool)
        del prog, ec
        assert pool() is None and a() is None
    finally:
        gc.enable()
