"""Port vs reference: prepare + the three treecodes + the DTT at order -1
(pair-merge equivalents, refined trees, the copy prolongation) against
the JAX package's output on the same inputs, and the reference's
envelopes of test_pairmerge_treecode_and_dtt against the fp64 oracle.
The stages one by one are in test_torch_pairmerge.py.
"""

import functools

import numpy as np
import pytest
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


SOLVERS = ("solve_treecode1", "solve_treecode2", "solve_treecode3",
           "solve_dtt")
CFG = dict(block_size=64, order=-1, frontier_width=256, list_width=512)


@functools.lru_cache(maxsize=None)
def _problem(name):
    """One problem per workload at order -1: inputs, both packages'
    outputs of every solver, and the fp64 oracle."""
    kernel = JK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 80, 1000)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    ts, tt = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    jcfg, tcfg = JConfig(**CFG), SolverConfig(**CFG)
    jplan = jtc.prepare(kernel, jcfg, js, jt)
    tplan = ttc.prepare(TK.KERNELS[name], tcfg, ts, tt)
    mods = {"solve_dtt": (jdtt, tdtt)}
    res = {}
    for s in SOLVERS:
        jm, tm = mods.get(s, (jtc, ttc))
        jout, _ = getattr(jm, s)(kernel, jcfg, jplan)
        tout, info = getattr(tm, s)(TK.KERNELS[name], tcfg, tplan)
        res[s] = (np.asarray(jout), tout.numpy(), int(info.overflow))
    oracle = np.asarray(jdirect.direct_oracle(kernel, js, jt))
    return res, oracle, tplan


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("name", ["grav3d", "vort3d", "vort2d"])
def test_solvers_at_order_minus_one_match_jax(name, solver):
    """prepare + every solver at order -1 within 1e-5 rel-RMS of the JAX
    package on the same inputs (vort2d with target radii), overflow 0."""
    res, _, plan = _problem(name)
    ref, got, overflow = res[solver]
    assert overflow == 0
    assert rel_rms(got, ref) <= 1e-5
    assert plan.src_blocks is not None          # pair-merge Blocks, refined


@pytest.mark.parametrize("solver", SOLVERS)
def test_vortgrad3d_at_order_minus_one_matches_jax(solver):
    """vortgrad3d, the default path of onvortgrad3d: prepare + every
    solver at order -1 against the JAX package on the same inputs,
    velocities within 1e-5 rel-RMS and the nine gradients within 5e-5
    (the treecode tolerance of test_torch_treecode.py), overflow 0."""
    res, _, plan = _problem("vortgrad3d")
    ref, got, overflow = res[solver]
    assert overflow == 0
    assert rel_rms(got[:, :3], ref[:, :3]) <= 1e-5
    assert rel_rms(got[:, 3:], ref[:, 3:]) <= 5e-5
    assert plan.src_blocks is not None


@pytest.mark.parametrize("solver,limit", [("solve_treecode2", 3e-2),
                                          ("solve_dtt", 5e-2)])
def test_pairmerge_envelopes_against_oracle(solver, limit):
    """The reference's envelopes (test_pairmerge_treecode_and_dtt):
    treecode2 < 3e-2 and the DTT < 5e-2 against the fp64 oracle."""
    res, oracle, _ = _problem("grav3d")
    assert rel_rms(res[solver][1], oracle) < limit


def test_lean_plan_at_order_minus_one_takes_blocks():
    """The lean builders are barycentric only: at order < 0 the plan is
    the pair-merge Blocks path, as in the reference."""
    kernel = TK.KERNELS["grav3d"]
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 81, 600)
    plan = ttc.prepare(kernel, SolverConfig(**CFG).replace(lean_plan=True),
                       torch_parts(sx, sr, ss), torch_parts(tx, tr))
    ref = ttc.prepare(kernel, SolverConfig(**CFG), torch_parts(sx, sr, ss),
                      torch_parts(tx, tr))
    assert plan.src_blocks is not None
    assert torch.equal(plan.src_fm, ref.src_fm)
    assert torch.equal(plan.tgt_geo, ref.tgt_geo)
