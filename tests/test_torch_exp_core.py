"""Port vs reference: the compact exponential core (core_func="exp") end
to end, the DTT of vort2d, vort3d and vortgrad3d on the same numpy
inputs (treecode3 in test_torch_exp_treecode.py). The port's solve (the
CPU twins of the exp bodies, csrc/core.cuh CoreExp) within 1e-5 rel-RMS
of the reference's (vortgrad3d's gradients 5e-5: the reference's moment
form of that body), with its counts, and inside the order-4 envelope
against the fp64 oracle (3e-3, tests/test_traverse.py)."""

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

VORTEX = ["vort2d", "vort3d", "vortgrad3d"]
# the reference's traverse test configuration (tests/test_traverse.py:33)
EXP_KW = dict(block_size=64, order=4, frontier_width=256, list_width=512,
              core_func="exp")


@functools.lru_cache(maxsize=None)
def _plans(name: str):
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 83, 1500)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    ts, tt = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    jcfg, cfg = JConfig(pair_backend="xla", **EXP_KW), SolverConfig(**EXP_KW)
    return (jk, tk, jcfg, cfg, jtc.prepare(jk, jcfg, js, jt),
            ttc.prepare(tk, cfg, ts, tt),
            tdirect.direct_oracle(tk, ts, tt, "exp"))


def _check_exp(name: str, method: str):
    jk, tk, jcfg, cfg, jplan, plan, orc = _plans(name)
    jsolve = jdtt.solve_dtt if method == "dtt" else jtc.solve_treecode3
    tsolve = tdtt.solve_dtt if method == "dtt" else ttc.solve_treecode3
    jout, jinfo = jsolve(jk, jcfg, jplan)
    out, info = tsolve(tk, cfg, plan)
    jout = np.asarray(jout)
    assert int(info.overflow) == int(jinfo.overflow) == 0
    assert int(info.n_valid) == int(jinfo.n_valid)
    assert rel_rms(out[:, :3], jout[:, :3]) <= 1e-5
    if name == "vortgrad3d":
        assert rel_rms(out[:, 3:], jout[:, 3:]) <= 5e-5
    assert rel_rms(out, orc) < 3e-3
    assert rel_rms(jout, orc) < 3e-3


@pytest.mark.parametrize("name", VORTEX)
def test_exp_core_dtt_matches_reference(name):
    _check_exp(name, "dtt")
