"""Port vs reference: the whole slice — treecode.prepare + dtt.solve_dtt
for grav3d with sibling-paired leaves — on the same inputs, plus the
port's import boundary and its refusal of unported configuration."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import (SLICE_KW, jax_parts, make_inputs,
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
    # order < 0 (pair-merge) is ported; order 6's 343 proxies exceed the
    # 128-slot rows at block 32: split rows
    ("order", 6, "item 11"), ("tree_mode", "morton", "item 17"),
    ("tree_mode", "bisect", "item 17"), ("tree_quant", "gather", "item 17"),
    # lean rows are block_size wide (not rounded up to 128): order 3 at
    # block 32 needs 64 > 32 slots there, which is split rows
    ("lean_plan", True, "item 11"), ("dtt_traversal", "refine", "item 11"),
    ("dtt_lists", "flat", "item 17"),
    ("accum_dtype", torch.float64, "item 9")])
def test_unported_config_raises(key, value, item):
    cfg = SolverConfig(**SLICE_KW).replace(**{key: value})
    sx, sr, ss, tx, tr = make_inputs(61, 200)
    with pytest.raises(NotImplementedError, match=item):
        ttc.prepare(TKER, cfg, torch_parts(sx, sr, ss), torch_parts(tx, tr))


def test_split_equivalent_rows_raise():
    """order 5 at block 32 needs 216 > 128 proxy slots: split rows are
    not ported and refuse instead of truncating."""
    cfg = SolverConfig(**SLICE_KW).replace(order=5)
    sx, sr, ss, tx, tr = make_inputs(62, 500)
    with pytest.raises(NotImplementedError, match="item 11"):
        ttc.prepare(TKER, cfg, torch_parts(sx, sr, ss), torch_parts(tx, tr))


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

