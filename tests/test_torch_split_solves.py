"""Port vs reference: the DTT and treecode3 solves with split equivalent
rows (a proxy grid wider than a block row spread over extension rows;
the builders and lists are in test_torch_split_rows.py) on the same
numpy inputs: within 1e-5 rel-RMS of the reference's solve, and inside
its own accuracy bounds (tests/test_traverse.py:375, :406)."""

import functools

import numpy as np
import torch

from _torch_parity import jax_parts, kernel_inputs, rel_rms, torch_parts
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as JK
from onbody_tpu.traverse import direct as jdirect
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu.traverse import treecode as jtc
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.traverse import treecode as ttc

torch.set_num_threads(1)

# order 5 at block 32: 216 proxies in two rows of 128
SOLVE_KW = dict(block_size=32, order=5, frontier_width=256,
                list_width=1024, cap_groups_dtt=64, cap_groups_treecode=64)


@functools.lru_cache(maxsize=None)
def _problem(name: str, n: int):
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 92, n)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    orc = np.asarray(jdirect.direct_oracle(jk, js, jt))
    return jk, tk, js, jt, torch_parts(sx, sr, ss), torch_parts(tx, tr), orc


def test_split_equivalent_rows_dtt():
    """Mirror of tests/test_traverse.py:test_split_equivalent_rows: the
    DTT with two rows a grid, the reference's solve within 1e-5, inside
    the order-5 envelope (5e-5 vs the oracle), and more accurate than
    order 4 at the same theta."""
    jk, tk, js, jt, ts, tt, orc = _problem("grav3d", 3000)
    jcfg = JConfig(theta_dtt=1.3, pair_backend="xla", **SOLVE_KW)
    jout, _ = jdtt.solve_dtt(jk, jcfg, jtc.prepare(jk, jcfg, js, jt))
    cfg = SolverConfig(theta_dtt=1.3, **SOLVE_KW)
    plan = ttc.prepare(tk, cfg, ts, tt)
    assert plan.tgt_geo.shape[0] == 3 * plan.ttree.nleaf
    out, info = tdtt.solve_dtt(tk, cfg, plan)
    assert int(info.overflow) == 0
    assert rel_rms(out, np.asarray(jout)) <= 1e-5
    e5 = rel_rms(out, orc)
    assert e5 < 5e-5, e5
    cfg4 = cfg.replace(order=4)
    out4, _ = tdtt.solve_dtt(tk, cfg4, ttc.prepare(tk, cfg4, ts, tt))
    assert e5 < rel_rms(out4, orc)


def test_split_equivalent_rows_treecode3():
    """Mirror of tests/test_traverse.py:test_split_equivalent_rows_
    treecode3: vort3d's boxwise treecode with two source rows a grid,
    the reference's solve within 1e-5, within 1e-4 of the oracle."""
    jk, tk, js, jt, ts, tt, orc = _problem("vort3d", 2000)
    jcfg = JConfig(theta_boxwise=1.0, pair_backend="xla", **SOLVE_KW)
    jout, _ = jtc.solve_treecode3(jk, jcfg, jtc.prepare(jk, jcfg, js, jt))
    cfg = SolverConfig(theta_boxwise=1.0, **SOLVE_KW)
    out, info = ttc.solve_treecode3(tk, cfg, ttc.prepare(tk, cfg, ts, tt))
    assert int(info.overflow) == 0
    assert rel_rms(out, np.asarray(jout)) <= 1e-5
    assert rel_rms(out, orc) < 1e-4
