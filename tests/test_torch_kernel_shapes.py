"""K1, K5 and K6 at every shape their TPU kernels take, against the JAX
package's families, on the CPU.

- K1 (mmchain): the port's kernel variant takes what the JAX family's
  predicate takes (fp32, k >= 128, c <= 8) at any k, 2,049 and 65,536
  among them; with pallas_mode "always" the mmchain family picks the
  kernel at k = 2,304 with no kb_fallback, and equals the JAX package's
  mmchain (its Pallas kernel in interpret mode) at the fp32 bar.
- K5 (the outer template): any rank. Its wrapper on a CPU X (the plain
  version) at ranks 33 and 256 against the JAX package's Pallas
  outer_sum_kernel in interpret mode; ALS-CG at ranks 40 and 100 at
  optlevel 3 through both packages' MLContext, the port's kernel variant
  taken once per outer iteration (pallas_mode "always"), no fallback.
- K6 (the compressed chain): any number of groups of at most 8 codes.
  chain_supported takes 113 and 800 groups and refuses what the JAX
  package's layout refuses (a dictionary of 9, an uncompressed group);
  the compressed mmchain through K6's route (chain_mmchain, whose
  wrapper runs the plain version on the CPU) at 130 and 300 groups
  against the JAX package's mmchain.

Inputs from numpy seeds. Bars (the North star's): relative 1e-9 in fp64,
1e-3 in fp32 (K1's kernel against the Pallas kernel: normwise 1e-5, the
same products summed in another order). The JAX package runs with
exec_mode SINGLE_NODE where a program runs (tests/conftest.py's 8-device
mesh would take its mesh quaternary ops).
"""

import contextlib
import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from systemml_tpu.api.mlcontext import MLContext as JaxMLContext
from systemml_tpu.api.mlcontext import dmlFromFile as jax_dml_file
from systemml_tpu.codegen import backend as jkb
from systemml_tpu.codegen import kernels as jax_kernels
from systemml_tpu.codegen.cplan import CNode as JaxCNode
from systemml_tpu.compress import colgroup as jax_cg
from systemml_tpu.compress import device as jax_dev
from systemml_tpu.compress.block import \
    CompressedMatrixBlock as JaxBlock
from systemml_tpu.ops import mult as jmult
from systemml_tpu.utils.config import DMLConfig as JaxConfig
from systemml_tpu.utils.config import get_config as jax_get_config
from systemml_tpu.utils.config import set_config as jax_set_config
from systemml_tpu_torch.api.mlcontext import MLContext, dmlFromFile
from systemml_tpu_torch.codegen import backend as kb
from systemml_tpu_torch.codegen import kernels
from systemml_tpu_torch.codegen.cplan import CNode
from systemml_tpu_torch.compress import colgroup as cg
from systemml_tpu_torch.compress import device as cla_dev
from systemml_tpu_torch.compress.block import CompressedMatrixBlock
from systemml_tpu_torch.obs import trace as obs
from systemml_tpu_torch.ops import mult
from systemml_tpu_torch.utils import stats as stats_mod
from systemml_tpu_torch.utils.config import DMLConfig, get_config, set_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALS = os.path.join(ROOT, "scripts", "algorithms", "ALS-CG.dml")
BARS = {np.float64: 1e-9, np.float32: 1e-3}
_LOSS = re.compile(r"ALS-CG: iterations = (\d+), loss = (\S+)")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture
def always():
    """Both packages on the CPU with pallas_mode "always" (the hand
    kernels candidates; the port's wrappers run their plain versions on
    a CPU tensor, the JAX package's Pallas kernels in interpret mode),
    the kernel backends' decisions cleared."""
    old, jold = get_config(), jax_get_config()
    cfg = DMLConfig(device="cpu")
    cfg.pallas_mode = "always"
    cfg.codegen_tune_cache = ""
    set_config(cfg)
    jcfg = JaxConfig()
    jcfg.pallas_mode = "always"
    jcfg.codegen_tune_mode, jcfg.codegen_tune_cache = "off", ""
    jax_set_config(jcfg)
    kb.reset_process_state()
    jkb.reset_process_state()
    yield cfg
    set_config(old)
    jax_set_config(jold)
    kb.reset_process_state()
    jkb.reset_process_state()


# --------------------------------------------------------------------------
# K1: mmchain at any k
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,c,dtype,takes", [
    (2049, 1, "float32", True), (4096, 1, "float32", True),
    (65_536, 8, "float32", True), (128, 8, "float32", True),
    (127, 1, "float32", False), (2304, 9, "float32", False),
    (4096, 1, "float64", False)])
def test_k1_takes_what_the_jax_family_takes(always, k, c, dtype, takes):
    """The kernel variant's gate and its per-call accepts together equal
    the JAX family's predicate; no bound on k."""
    m = 4097
    jax_ok = jmult._mmchain_pallas_ok({"shape": (m, k, c), "dtype": dtype})
    ctx = {"shape": (m, k, c), "dtype": dtype, "backend": "cpu"}
    tdt = torch.float32 if dtype == "float32" else torch.float64
    port_ok = (mult._mmchain_kernel_ok(ctx)
               and kernels.mmchain_supported(m, k, c, tdt))
    assert port_ok == jax_ok == takes
    assert not hasattr(kernels, "MMCHAIN_MAX_K")


@pytest.mark.parametrize("ctype,c,wc", [("XtXv", 1, 0), ("XtwXv", 4, 1),
                                        ("XtXvy", 4, 4)])
def test_k1_family_takes_kernel_at_k_2304(always, ctype, c, wc):
    """300 x 2,304 (past the narrow kernel's 2,048 columns): the family
    picks the kernel (its wrapper's plain version on the CPU), counts no
    fallback, and equals the JAX package's mmchain through its Pallas
    kernel."""
    rng = np.random.default_rng(2304 + c)
    x = rng.standard_normal((300, 2304)).astype(np.float32)
    v = rng.standard_normal((2304, c)).astype(np.float32)
    w = rng.standard_normal((300, wc)).astype(np.float32) if wc else None
    st = stats_mod.Statistics()
    with stats_mod.stats_scope(st), obs.session() as rec:
        got = mult.mmchain(torch.from_numpy(x), torch.from_numpy(v),
                           None if w is None else torch.from_numpy(w), ctype)
    assert st.estim_counts.get("kb_pick_mmchain.kernel", 0) == 1
    assert st.estim_counts.get("kb_fallback", 0) == 0
    assert not [e for e in rec.events() if e.name == "kernel_fallback"]
    ref = np.asarray(jmult.mmchain(jnp.asarray(x), jnp.asarray(v),
                                   None if w is None else jnp.asarray(w),
                                   ctype))
    assert got.shape == ref.shape == (2304, c)
    assert _rel(got.numpy(), ref) <= 1e-5


# --------------------------------------------------------------------------
# K5: the outer template at any rank
# --------------------------------------------------------------------------

def _plan(cls):
    """ALS-CG's loss plan sum((X * UV)^2)."""
    return cls("b(^)", [cls("b(*)", [cls("in", name="X"),
                                     cls("in", name="UV")]),
                        cls("lit", value=2.0)])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r", [33, 256])
def test_k5_any_rank_matches_jax_pallas_kernel(dtype, r):
    """Ranks past the former bound of 32: the wrapper (the plain version on
    a CPU X) against the JAX package's Pallas outer_sum_kernel, which
    forms UV in fp32 (so the fp32 bar), and its jnp arm at the dtype's."""
    from systemml_tpu.codegen import compiler as jax_compiler

    rng = np.random.default_rng(r)
    m, n = 70, 23
    x = np.where(rng.random((m, n)) < 0.5,
                 np.round(rng.uniform(0.5, 5.0, (m, n)) * 2) / 2,
                 0.0).astype(dtype)
    u = (rng.standard_normal((m, r)) / np.sqrt(r)).astype(dtype)
    v = rng.standard_normal((n, r)).astype(dtype)
    ref = jax_kernels.outer_sum_kernel(_plan(JaxCNode), jnp.asarray(x),
                                       jnp.asarray(u), jnp.asarray(v), {})
    jnp_ref = jax_compiler._outer_jnp({}, _plan(JaxCNode), jnp.asarray(x),
                                      jnp.asarray(u), jnp.asarray(v), {})
    got = kernels.outer_kernel(_plan(CNode), torch.from_numpy(x),
                               torch.from_numpy(u), torch.from_numpy(v), {})
    assert got.shape == () and got.dtype == torch.from_numpy(x).dtype
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    assert abs(float(got) - float(jnp_ref)) <= BARS[dtype] * abs(
        float(jnp_ref))


def _als(ml, script, v, rank, outputs=("L", "R")):
    s = script.input("V", v).arg("rank", rank).arg("maxi", 3).arg("mii", 3)
    s.arg("reg", "L2")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ml.execute(s.output(*outputs))
    hits = [_LOSS.match(ln) for ln in out.getvalue().splitlines()
            if _LOSS.match(ln)]
    assert len(hits) == 1
    return res, int(hits[0].group(1)), float(hits[0].group(2))


@pytest.mark.parametrize("rank", [40, 100])
@pytest.mark.parametrize("prec,ndt", [("double", np.float64),
                                      ("single", np.float32)])
def test_k5_als_cg_at_rank_matches_jax(always, monkeypatch, rank, prec, ndt):
    """ALS-CG at optlevel 3 on a 120 x 90 V at rank 40 and 100, through
    both packages: L, R and the loss at the dtype's bar; the port's outer
    plan takes the kernel variant once per outer iteration, with no
    fallback of the outer family."""
    rng = np.random.default_rng(rank)
    v = np.round(rng.uniform(0.5, 5.0, (120, 90)) * 2) / 2
    v = np.where(rng.random((120, 90)) < 0.4, v, 0.0).astype(ndt)
    # the JAX package's spoof plans through its jnp arms (its Pallas cell
    # kernel refuses the plans' captured scalars in interpret mode)
    jcfg = JaxConfig()
    jcfg.optlevel, jcfg.floating_point_precision = 3, prec
    jcfg.exec_mode = "SINGLE_NODE"
    always.optlevel, always.floating_point_precision = 3, prec
    calls = []
    outer = kernels.outer_kernel
    monkeypatch.setattr(kernels, "outer_kernel", lambda plan, *a, **kw: (
        calls.append(plan.pretty()) or outer(plan, *a, **kw)))
    with obs.session() as rec:
        rp, itp, lossp = _als(MLContext(always), dmlFromFile(ALS), v, rank)
    rj, itj, lossj = _als(JaxMLContext(jcfg), jax_dml_file(ALS), v, rank)
    assert itp == itj == 3
    assert calls == ["b(^)(b(*)(X, UV), 2.0)"] * itp
    assert not [e for e in rec.events() if e.name == "kernel_fallback"
                and e.args.get("op") == "spoof_outer"]
    for out in ("L", "R"):
        a, b = rp.get_matrix(out), rj.get_matrix(out)
        assert a.dtype == ndt and a.shape == b.shape == (
            (120, rank) if out == "L" else (90, rank))
        assert _rel(a, b) < BARS[ndt], out
    assert abs(lossp - lossj) < BARS[ndt] * abs(lossj)


# --------------------------------------------------------------------------
# K6: the compressed chain at any number of groups
# --------------------------------------------------------------------------

def _blocks(rng, n, groups, dmax=8, dtype=np.float64):
    """Both packages' all-coded block of `groups` one-column DDC groups,
    the first with dmax codes, the others 1..dmax."""
    gp, gj = [], []
    for j in range(groups):
        d = dmax if j == 0 else int(rng.integers(1, dmax + 1))
        dct = rng.standard_normal((d, 1)).astype(dtype)
        codes = rng.integers(0, d, n)
        gp.append(cg.ColGroupDDC([j], dct, codes))
        gj.append(jax_cg.ColGroupDDC([j], dct, codes))
    return (CompressedMatrixBlock(gp, (n, groups)),
            JaxBlock(gj, (n, groups)))


@pytest.mark.parametrize("groups", [113, 800])
def test_k6_takes_any_number_of_groups(groups):
    """113 and 800 groups of 8 codes (past one block's shared memory at
    k = 8 and at k = 1): K6 takes them in fp32 and fp64 at every k, as the
    JAX package's layout does; a dictionary of 9 and an uncompressed group
    are refused by both."""
    rng = np.random.default_rng(groups)
    cp, cj = _blocks(rng, 64, groups)
    assert jax_dev._tpu_chain_layout(cj) is not None
    for dtype in (torch.float32, torch.float64):
        for k in (1, 8, 12):
            assert cla_dev.chain_supported(cp, k, dtype)
    refused = {
        "dictionary of 9": [cg.ColGroupDDC([0], rng.standard_normal((9, 1)),
                                           rng.integers(0, 9, 64))],
        "uncompressed group": [cg.ColGroupUncompressed(
            [0], rng.standard_normal((64, 1)))]}
    for label, extra in refused.items():
        gp = list(cp.groups) + [type(extra[0])(
            [groups], *((extra[0].dictionary(), extra[0].codes())
                        if isinstance(extra[0], cg.ColGroupDDC)
                        else (extra[0].values(),)))]
        cpx = CompressedMatrixBlock(gp, (64, groups + 1))
        gj = list(cj.groups) + [
            jax_cg.ColGroupDDC([groups], gp[-1].dictionary(), gp[-1].codes())
            if isinstance(gp[-1], cg.ColGroupDDC)
            else jax_cg.ColGroupUncompressed([groups], gp[-1].values())]
        cjx = JaxBlock(gj, (64, groups + 1))
        assert jax_dev._tpu_chain_layout(cjx) is None, label
        assert not cla_dev.chain_supported(cpx, 1, torch.float32), label


@pytest.mark.parametrize("groups", [130, 300])
@pytest.mark.parametrize("ndt", [np.float64, np.float32])
def test_k6_route_at_many_groups_matches_jax(groups, ndt):
    """The compressed mmchain through K6's route (chain_mmchain: the value
    table, the kernel's wrapper, the output assembly) and through the
    family's dispatch, at 130 and 300 groups, every chain type, against
    the JAX package's mmchain."""
    rng = np.random.default_rng(groups + 7)
    n = 1037
    cp, cj = _blocks(rng, n, groups, dtype=ndt)
    old = get_config()
    set_config(DMLConfig(device="cpu"))
    try:
        assert cla_dev.chain_supported(cp, 1, torch.from_numpy(
            np.zeros(1, ndt)).dtype)
        for ctype, k, wc in (("XtXv", 1, 0), ("XtwXv", 1, 1),
                             ("XtXvy", 3, 3)):
            v = rng.standard_normal((groups, k)).astype(ndt)
            w = rng.standard_normal((n, wc)).astype(ndt) if wc else None
            tw = None if w is None else torch.from_numpy(w)
            ref = np.asarray(jax_dev.mmchain(
                cj, jnp.asarray(v), None if w is None else jnp.asarray(w),
                ctype))
            via_k6 = cla_dev.chain_mmchain(cp, torch.from_numpy(v), tw, ctype)
            via_dispatch = mult.mmchain(cp, torch.from_numpy(v), tw, ctype)
            for got in (via_k6, via_dispatch):
                assert got.shape == ref.shape == (groups, k), ctype
                assert got.dtype == torch.from_numpy(v).dtype
                assert _rel(got.numpy(), ref) <= BARS[ndt], ctype
    finally:
        set_config(old)
