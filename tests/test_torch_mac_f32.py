"""Port vs reference: the DTT's exact MAC geometry (mac_geometry="f32",
ROADMAP item 5): the lists on the reference's own trees identical to the
reference's, ids included, and the mirror of
tests/test_traverse.py:test_mac_geometry_quant_matches_f32."""

import numpy as np
import pytest
import torch

from _torch_parity import jax_parts, kernel_inputs, rel_rms, torch_parts
from onbody_tpu.traverse import lists as jl
from onbody_tpu.tree import build as jbuild
from onbody_tpu_torch import interop
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import direct as tdirect
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.traverse import lists as tl
from onbody_tpu_torch.traverse import treecode as ttc

torch.set_num_threads(1)

# the reference's traverse test configuration (tests/test_traverse.py:33)
CFG_KW = dict(block_size=64, order=4, frontier_width=256, list_width=512)


@pytest.mark.parametrize("name", ["grav3d", "vort2d"])
def test_f32_mac_lists_identical(name):
    """build_dtt_pairs_level and _level2 with mac_geometry='f32' on the
    reference's trees: the reference's lists, counts and overflow."""
    k = TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(k, 81, 3000)
    st, _, _ = jbuild.build_tree(jax_parts(sx, sr, ss), 32, mode="span")
    tt, _, _ = jbuild.build_tree(jax_parts(tx, tr), 32, mode="span",
                                 need_r=k.uses_tr)
    ts, ttt = interop.tree_from_numpy(st), interop.tree_from_numpy(tt)
    refs = [jl.build_dtt_pairs_level(st, tt, 1.2, 256, "f32", n_live=3000)]
    refs += jl.build_dtt_pairs_level2(st, tt, 1.2, 256, "f32", n_live=3000)
    gots = [tl.build_dtt_pairs_level(ts, ttt, 1.2, 256, "f32", n_live=3000)]
    gots += tl.build_dtt_pairs_level2(ts, ttt, 1.2, 256, "f32",
                                      n_live=3000)
    for g, r in zip(gots, refs):
        for f in ("tgt", "src", "n_valid", "overflow"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(r, f)), f)


def test_mac_geometry_quant_matches_f32():
    """Mirror of tests/test_traverse.py:211: the quantized and the exact
    MAC geometry give the same accuracy envelope and near-identical pair
    volumes (razor-edge decisions may differ), with zero overflow."""
    tk = TK.KERNELS["grav3d"]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 82, 6000)
    ts, tt = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    ref = tdirect.direct_oracle(tk, ts, tt)
    res = {}
    for mg in ("quant", "f32"):
        cfg = SolverConfig(**dict(CFG_KW, frontier_width=160,
                                  mac_geometry=mg))
        out, info = tdtt.solve_dtt(tk, cfg, ttc.prepare(tk, cfg, ts, tt))
        assert int(info.overflow) == 0
        assert rel_rms(out, ref) < 3e-3, (mg, rel_rms(out, ref))
        res[mg] = int(info.n_valid)
    assert abs(res["quant"] - res["f32"]) <= max(20, res["f32"] // 100)
