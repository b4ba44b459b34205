"""Port vs reference: the whole slice under the fetch schedules 'dma'
(kernel K10), 'dma_p' (K11, on lists compacted with
list_compact='idsort') and 'static' (K12): treecode.prepare +
dtt.solve_dtt for all four workloads, and solve_treecode3 under
'static', against the reference's solver on the same plan. The
reference runs its plain jnp executors (its Pallas paths in interpret
mode cost minutes here; tests/test_torch_fetch.py holds the executors
against them); the plan is the port's, carried over as numpy, which
tests/test_torch_dtt.py shows equal to the reference's own.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (SLICE_KW, jax_tree, kernel_inputs, rel_rms,
                           torch_parts)
from _torch_parity import jax_array as _j
from onbody_tpu import parts as JP
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as JK
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu.traverse import treecode as jtc
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.traverse import treecode as ttc

torch.set_num_threads(1)

WORKLOADS = ["grav3d", "vort2d", "vort3d", "vortgrad3d"]
TOL, TOL_GRAD = 1e-5, 5e-5


def _jparts(p):
    return JP.Parts(x=_j(p.x), r=_j(p.r), s=None if p.s is None else _j(p.s),
                    n_real=p.n_real)


def _jplan(p):
    """The port's Plan as the reference's (the inverse of interop)."""
    blocks = [jeq.Blocks(pos=_j(b.pos), rad=_j(b.rad),
                         s=None if b.s is None else _j(b.s))
              for b in (p.src_blocks, p.tgt_blocks)]
    return jtc.Plan(stree=jax_tree(p.stree), ttree=jax_tree(p.ttree),
                    src_sorted=_jparts(p.src_sorted),
                    tgt_sorted=_jparts(p.tgt_sorted), src_blocks=blocks[0],
                    tgt_blocks=blocks[1], src_gidx=_j(p.src_gidx),
                    tgt_gidx=_j(p.tgt_gidx), src_fm=_j(p.src_fm),
                    tgt_geo=_j(p.tgt_geo),
                    tgt_inv=None if p.tgt_inv is None else _j(p.tgt_inv))


# the slice configurations at test size: S-dma, S-dma_p (idsort lists)
# and S-static (the leaf pairing switches off, as in the reference)
FETCHES = {"dma": dict(pair_fetch="dma"),
           "dma_p": dict(pair_fetch="dma_p", list_compact="idsort"),
           "static": dict(pair_fetch="static")}


@pytest.fixture(scope="module", params=WORKLOADS)
def fetch_slices(request):
    name = request.param
    tk = TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 80, 2000)
    base = SolverConfig(**SLICE_KW)
    if name == "vort2d":
        base = base.replace(theta_dtt=1.4)
    plan = ttc.prepare(tk, base, torch_parts(sx, sr, ss),
                       torch_parts(tx, tr))
    outs = {f: tdtt.solve_dtt(tk, base.replace(**kw), plan)
            for f, kw in FETCHES.items()}
    jcfg = JConfig(pair_backend="jnp", **SLICE_KW).replace(
        theta_dtt=base.theta_dtt, list_compact="idsort")
    jout, jinfo = jdtt.solve_dtt(JK.KERNELS[name], jcfg, _jplan(plan))
    return dict(name=name, outs=outs, jout=np.asarray(jout), jinfo=jinfo)


@pytest.mark.parametrize("fetch", list(FETCHES))
def test_fetch_slice_matches_reference(fetch_slices, fetch):
    """S-dma, S-dma_p and S-static against the reference's DTT on the
    same plan (idsort lists; the executors' order of sums differs only
    by rounding): 1e-5 rel-RMS, gradients 5e-5 (test_torch_vortex.py
    gives the reason); overflow 0 and the same valid pair count."""
    r = fetch_slices
    out, info = r["outs"][fetch]
    got = out.numpy()
    assert got.shape == r["jout"].shape
    assert rel_rms(got[:, :3], r["jout"][:, :3]) <= TOL
    if got.shape[1] > 3:
        assert rel_rms(got[:, 3:], r["jout"][:, 3:]) <= TOL_GRAD
    assert int(info.overflow) == int(r["jinfo"].overflow) == 0
    assert int(info.n_valid) == int(r["jinfo"].n_valid)


def test_treecode3_static_matches_reference():
    """solve_treecode3 with pair_fetch='static' (K12's twin on the
    treecode's long runs) against the reference's treecode3."""
    tk = TK.KERNELS["grav3d"]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 81, 3000)
    cfg = SolverConfig(block_size=32, order=3, pair_fetch="static")
    plan = ttc.prepare(tk, cfg, torch_parts(sx, sr, ss), torch_parts(tx, tr))
    out, info = ttc.solve_treecode3(tk, cfg, plan)
    jout, jinfo = jtc.solve_treecode3(
        JK.KERNELS["grav3d"], JConfig(block_size=32, order=3,
                                      pair_backend="jnp"), _jplan(plan))
    assert rel_rms(out.numpy(), np.asarray(jout)) <= TOL
    assert int(info.overflow) == int(jinfo.overflow) == 0
