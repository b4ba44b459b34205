"""Port vs reference: vort3d's Vatistas core (core_func="v2", the CUDA
body K6-v2 of csrc/core.cuh CoreV2; its twin on the CPU) through the DTT
and treecode3 on the same numpy inputs: within 1e-5 rel-RMS of the
reference's solves (fp32 sums in another order) and inside the order-4
envelope against the fp64 oracle."""

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_parts, kernel_inputs, rel_rms, torch_parts
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as JK
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu.traverse import treecode as jtc
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import direct as tdirect
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.traverse import treecode as ttc

torch.set_num_threads(1)

# the reference's traverse test configuration (tests/test_traverse.py:33)
CFG_KW = dict(block_size=64, order=4, frontier_width=256, list_width=512)


@functools.lru_cache(maxsize=None)
def _problem(name: str, n: int, seed: int):
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, seed, n)
    return (jk, tk, jax_parts(sx, sr, ss), jax_parts(tx, tr),
            torch_parts(sx, sr, ss), torch_parts(tx, tr))


@pytest.mark.parametrize("method", ["dtt", "treecode3"])
def test_v2_core_matches_reference(method):
    jk, tk, js, jt, ts, tt = _problem("vort3d", 2000, 80)
    kw = dict(CFG_KW, core_func="v2")
    jcfg, cfg = JConfig(pair_backend="xla", **kw), SolverConfig(**kw)
    jplan, plan = jtc.prepare(jk, jcfg, js, jt), ttc.prepare(tk, cfg, ts, tt)
    if method == "dtt":
        jout, jinfo = jdtt.solve_dtt(jk, jcfg, jplan)
        out, info = tdtt.solve_dtt(tk, cfg, plan)
    else:
        jout, jinfo = jtc.solve_treecode3(jk, jcfg, jplan)
        out, info = ttc.solve_treecode3(tk, cfg, plan)
    assert int(info.overflow) == int(jinfo.overflow) == 0
    assert int(info.n_valid) == int(jinfo.n_valid)
    assert rel_rms(out, np.asarray(jout)) <= 1e-5
    orc = tdirect.direct_oracle(tk, ts, tt, "v2")
    assert rel_rms(out, orc) < 3e-3
    # a core other than the default: v2 differs from rm
    rm = SolverConfig(**CFG_KW)
    out_rm, _ = tdtt.solve_dtt(tk, rm, ttc.prepare(tk, rm, ts, tt))
    assert rel_rms(out_rm, out) > 1e-3
