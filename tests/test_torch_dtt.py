"""Port vs reference: the whole slice — treecode.prepare + dtt.solve_dtt
for grav3d with sibling-paired leaves — on the same inputs, the keys
the port used to refuse (split rows, the fp64 tier) against the
reference, plus the port's import boundary and its refusal of unported
configuration."""

import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import (SLICE_KW, jax_parts, jax_x64, make_inputs,
                           rel_rms, torch_parts)
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as JK
from onbody_tpu.traverse import direct as jdirect
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu.traverse import treecode as jtc
from onbody_tpu_torch import interop
from onbody_tpu_torch.config import SolverConfig, tuned_config
from onbody_tpu_torch.ops import cuda_direct, cuda_pairs
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import direct as tdirect
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.traverse import treecode as ttc

torch.set_num_threads(1)

JKER = JK.KERNELS["grav3d"]
TKER = get_kernel("grav3d")


@pytest.fixture(scope="module")
def slice_run():
    """The reference (Pallas executors in interpret mode, full-fp32
    contractions) and the port on one input set, N = 3000."""
    sx, sr, ss, tx, tr = make_inputs(60, 3000)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    jcfg = JConfig(pair_backend="pallas", **SLICE_KW)
    jplan = jtc.prepare(JKER, jcfg, js, jt)
    jout, jinfo = jdtt.solve_dtt(JKER, jcfg, jplan)
    ts, tt = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    tcfg = SolverConfig(**SLICE_KW)
    tplan = ttc.prepare(TKER, tcfg, ts, tt)
    tout, tinfo = tdtt.solve_dtt(TKER, tcfg, tplan)
    oracle = np.asarray(jdirect.direct_oracle(JKER, js, jt))
    return dict(jout=np.asarray(jout), jinfo=jinfo, tout=tout.numpy(),
                tinfo=tinfo, tplan=tplan, oracle=oracle, ts=ts, tt=tt,
                jplan=jplan)


def test_slice_matches_reference(slice_run):
    r = slice_run
    assert r["tout"].shape == r["jout"].shape == (3000, 3)
    assert rel_rms(r["tout"], r["jout"]) <= 1e-5


def test_solve_on_reference_plan(slice_run):
    """Lists, executor and downward pass fed the reference's own plan
    (trees, sorted particles, blocks) through interop."""
    r = slice_run
    plan = interop.plan_from_numpy(r["jplan"])
    out, info = tdtt.solve_dtt(TKER, SolverConfig(**SLICE_KW), plan)
    assert rel_rms(out.numpy(), r["jout"]) <= 1e-5
    assert int(info.n_valid) == int(r["jinfo"].n_valid)


def test_slice_accuracy_and_overflow(slice_run):
    r = slice_run
    assert rel_rms(r["jout"], r["oracle"]) <= 3e-3
    assert rel_rms(r["tout"], r["oracle"]) <= 3e-3
    assert int(r["tinfo"].overflow) == int(r["jinfo"].overflow) == 0
    assert int(r["tinfo"].n_valid) == int(r["jinfo"].n_valid)


def test_slice_tree_order_and_oracle(slice_run):
    """unscramble=False keeps tree order; mapped through tgt_gidx it is
    the unscrambled result. The port's fp64 oracle agrees too."""
    r = slice_run
    cfg = SolverConfig(**SLICE_KW)
    sorted_out, _ = tdtt.solve_dtt(TKER, cfg, r["tplan"], unscramble=False)
    g = r["tplan"].tgt_gidx
    real = g < 3000
    back = torch.zeros((3000, 3))
    back[g[real]] = sorted_out[real]
    np.testing.assert_array_equal(back.numpy(), r["tout"])
    orc = tdirect.direct_oracle(TKER, r["ts"], r["tt"]).numpy()
    np.testing.assert_allclose(orc, r["oracle"], rtol=1e-12,
                               atol=1e-12 * np.abs(r["oracle"]).max())


def test_slice_stats_and_launch_counts_on_cpu(slice_run):
    """fastsumm_stats counts the interior list; on CPU tensors the twins
    run and no kernel launch is counted."""
    from onbody_tpu_torch.traverse import lists as tl
    r = slice_run
    plan = r["tplan"]
    before = (dict(cuda_pairs.LAUNCHES), dict(cuda_direct.LAUNCHES))
    pl, pl2 = tl.build_dtt_pairs_level2(plan.stree, plan.ttree, 1.2, 256,
                                        n_live=3000)
    st = tdtt.fastsumm_stats(pl, plan.stree.nleaf, plan.ttree.nleaf, pl2)
    assert int(sum(st.values())) == int((pl.src != 0).sum()
                                        + 2 * (pl2.src != 0).sum())
    tdirect.direct(TKER, r["ts"], r["tt"])
    assert (dict(cuda_pairs.LAUNCHES), dict(cuda_direct.LAUNCHES)) == before


@pytest.mark.parametrize("key,value,item", [
    ("tree_mode", "morton", "item 17"),
    ("tree_mode", "bisect", "item 17"), ("tree_quant", "gather", "item 17"),
    ("dtt_lists", "flat", "item 17")])
def test_unported_config_raises(key, value, item):
    cfg = SolverConfig(**SLICE_KW).replace(**{key: value})
    sx, sr, ss, tx, tr = make_inputs(61, 200)
    with pytest.raises(NotImplementedError, match=item):
        ttc.prepare(TKER, cfg, torch_parts(sx, sr, ss), torch_parts(tx, tr))


def _slice_vs_reference(seed: int, n: int, x64: bool = False, **kw):
    """prepare + solve_dtt at the test slice with `kw` in both packages
    on one input (the reference's executors as XLA code; its fp64 tier
    with jax_enable_x64 on), and the fp64 oracle."""
    sx, sr, ss, tx, tr = make_inputs(seed, n)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    tcfg = SolverConfig(**SLICE_KW).replace(**kw)
    tout, tinfo = tdtt.solve_dtt(TKER, tcfg, ttc.prepare(
        TKER, tcfg, torch_parts(sx, sr, ss), torch_parts(tx, tr)))
    with jax_x64() if x64 else contextlib.nullcontext():
        import jax.numpy as jnp
        jkw = {k: jnp.float64 if v is torch.float64 else v
               for k, v in kw.items()}
        jcfg = JConfig(pair_backend="xla", **SLICE_KW).replace(**jkw)
        jout, jinfo = jdtt.solve_dtt(JKER, jcfg, jtc.prepare(JKER, jcfg,
                                                             js, jt))
        jout = np.asarray(jout)
    oracle = tdirect.direct_oracle(TKER, torch_parts(sx, sr, ss),
                                   torch_parts(tx, tr))
    assert int(tinfo.overflow) == int(jinfo.overflow) == 0
    return tout, jout, oracle


@pytest.mark.parametrize("key,value", [
    # order 6's 343 proxies span three 128-slot rows at block 32
    ("order", 6),
    # lean rows are block_size wide: order 3's 64 slots in two rows of 32
    ("lean_plan", True),
    # the accuracy tier (K1-f64's twin, the paired leaf list off)
    ("accum_dtype", torch.float64)])
def test_formerly_refused_config_matches_reference(key, value):
    """Keys the port used to refuse (split rows, ROADMAP item 11; the
    fp64 tier, item 9) now solve as the reference does: within 1e-5
    rel-RMS of its solve (fp32 sums in another order) and inside the
    order-3 envelope against the oracle. The fp64 tier within 1e-7: its
    sums are double, but its proxies are fp32-stored sums whose last
    bits differ between the packages' contraction orders, and the far
    field carries that (~4e-9 here; test_torch_precision_ref.py holds
    the tier to 1e-9 where the proxies agree)."""
    f64 = value is torch.float64
    tout, jout, oracle = _slice_vs_reference(61, 1200, x64=f64,
                                             **{key: value})
    assert tout.dtype == (torch.float64 if f64 else torch.float32)
    assert rel_rms(tout, jout) <= (1e-7 if f64 else 1e-5)
    assert rel_rms(tout, oracle) < 3e-3


def test_split_equivalent_rows_raise():
    """order 5 at block 32 needs 216 > 128 proxy slots: the grids split
    over two rows, as in the reference, instead of refusing; the solve
    within 1e-5 of the reference's and more accurate than order 3."""
    tout, jout, oracle = _slice_vs_reference(62, 1200, order=5)
    assert rel_rms(tout, jout) <= 1e-5
    tout3, _, _ = _slice_vs_reference(62, 1200)
    assert rel_rms(tout, oracle) < rel_rms(tout3, oracle)


def test_tuned_config_table_matches_reference():
    from onbody_tpu.config import tuned_config as jtuned
    for n in (100_000, 1_000_000, 10_000_000, 100_000_000):
        got, ref = tuned_config(n), jtuned(n)
        for f in ("block_size", "order", "theta_dtt", "frontier_width",
                  "cap_groups_dtt", "tree_mode", "pair_group",
                  "dtt_leaf_pair2", "lean_plan", "pair_backend"):
            assert getattr(got, f) == getattr(ref, f), (n, f)


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib, onbody_tpu_torch\n"
        "for m in pkgutil.walk_packages(onbody_tpu_torch.__path__, "
        "'onbody_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'onbody_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr

