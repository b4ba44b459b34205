"""Port vs reference: the refine-the-larger DTT (dtt_traversal "refine",
traverse/lists.py build_dtt_pairs, the reference's original traversal)
on the same numpy inputs. The lists identical, ids, counts and overflow
included, on trees the reference's prepare built: equal trees, a source
tree deeper than the target tree (the leaf level's inner refinement),
split equivalent rows and a list width that overflows. The solve (split
and fused) within 1e-5 of the reference's, with split rows as
tests/test_traverse.py:374's "refine" case runs it."""

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_parts, kernel_inputs, rel_rms, torch_parts
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as JK
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu.traverse import lists as jl
from onbody_tpu.traverse import treecode as jtc
from onbody_tpu.tree import build as jbuild
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch import interop
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.traverse import lists as tl
from onbody_tpu_torch.traverse import treecode as ttc

torch.set_num_threads(1)

# order 5 at block 64: 216 proxies in two rows of 128 (split rows)
BASE = dict(block_size=64, order=5, theta_dtt=1.2, frontier_width=256,
            list_width=1024, cap_groups_dtt=64, dtt_traversal="refine")
N = 600
# (targets of the target tree, source / target parts, list width) of each
# list case: the problem's trees; a target tree of fewer targets (the
# source tree deeper, so the leaf level refines sources); split rows; a
# list width that overflows
CASES = {"equal": (N, 1, 1024), "deeper": (200, 1, 1024),
         "split": (N, 2, 1024), "overflow": (N, 1, 8)}


@functools.lru_cache(maxsize=None)
def _problem():
    """The reference's plan of one grav3d problem and the same inputs as
    the port's Parts."""
    tk = TK.KERNELS["grav3d"]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 93, N)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    jcfg = JConfig(pair_backend="xla", **BASE)
    plan = jtc.prepare(JK.KERNELS["grav3d"], jcfg, js, jt)
    return jcfg, plan, torch_parts(sx, sr, ss), torch_parts(tx, tr)


@pytest.mark.parametrize("case", list(CASES))
def test_refine_lists_identical(case):
    """build_dtt_pairs on the reference's trees: its tgt, src, n_valid and
    overflow exactly."""
    n_tgt, parts, width = CASES[case]
    _, plan, _, _ = _problem()
    st, tt = plan.stree, plan.ttree
    if n_tgt != N:
        _, _, _, tx, tr = kernel_inputs(TK.KERNELS["grav3d"], 94, 16, n_tgt)
        tt, _, _ = jbuild.build_tree(jax_parts(tx, tr), BASE["block_size"],
                                     need_r=False)
    ref = jl.build_dtt_pairs(st, tt, 1.2, 256, width, parts, parts)
    got = tl.build_dtt_pairs(interop.tree_from_numpy(st),
                             interop.tree_from_numpy(tt), 1.2, 256, width,
                             parts, parts)
    for f in ("tgt", "src", "n_valid", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    assert int(got.n_valid) > 0
    assert (int(got.overflow) > 0) == (case == "overflow")
    if case == "deeper":
        assert st.levels > tt.levels
    if case == "split":
        assert (got.src >= 2 * st.nleaf).any()
        assert (got.tgt >= 2 * tt.nleaf).any()


def test_refine_solve_matches_reference():
    """prepare + solve_dtt at dtt_traversal "refine" with split rows (two
    rows a grid; tests/test_traverse.py:374's "refine" case) within 1e-5
    of the reference's solve, overflow 0 and the same n_valid;
    solve_dtt_fused (the lists at their static capacity) bit for bit the
    split solve."""
    jcfg, jplan, srcs, targs = _problem()
    assert jeq.n_eq_parts(jplan.tgt_geo.shape[-1], BASE["order"], 3) == 2
    jout, jinfo = jdtt.solve_dtt(JK.KERNELS["grav3d"], jcfg, jplan)
    kernel = TK.KERNELS["grav3d"]
    cfg = SolverConfig(**BASE)
    out, info = tdtt.solve_dtt(kernel, cfg, ttc.prepare(kernel, cfg, srcs,
                                                        targs))
    assert int(info.overflow) == int(jinfo.overflow) == 0
    assert int(info.n_valid) == int(jinfo.n_valid)
    assert rel_rms(out, np.asarray(jout)) <= 1e-5
    fused, finfo = tdtt.solve_dtt_fused(kernel, cfg, srcs, targs)
    assert torch.equal(fused, out)
    assert int(finfo.overflow) == 0
