"""Port vs reference: the three treecode MACs and the treecode lists
(traverse/lists.py) on the reference's own trees. Masks, lists,
counts and overflow must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_parts, kernel_inputs
from onbody_tpu.traverse import lists as jl
from onbody_tpu.tree import build as jbuild
from onbody_tpu_torch import interop
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import lists as tl

torch.set_num_threads(1)


def _same(got, ref, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), what)


@pytest.fixture(scope="module", params=[("grav3d", 2048, 2048),
                                        ("vort2d", 3000, 1700),
                                        ("grav3d", 1000, 3000)],
                ids=["3d-equal", "2d-ragged", "3d-deep-target"])
def trees(request):
    name, ns_, nt_ = request.param
    k = TK.KERNELS[name]
    sx, sr, ss, _, _ = kernel_inputs(k, 72, ns_)
    _, _, _, tx, tr = kernel_inputs(k, 73, 16, nt_)
    st, _, _ = jbuild.build_tree(jax_parts(sx, sr, ss), 64)
    tt, _, _ = jbuild.build_tree(jax_parts(tx, tr), 64, need_r=k.uses_tr)
    return st, tt


MACS = [("boxwise", 1.0), ("pointwise", 1.05), ("treecode1", 2.0)]


@pytest.mark.parametrize("mac,theta", MACS)
def test_macs_identical(trees, mac, theta):
    """Each MAC's accept mask on a frontier of every source node against
    every target leaf."""
    st, tt = trees
    pd = st.nc.shape[1]
    nleaf_t = tt.nleaf
    cand = np.broadcast_to(np.arange(1, 2 * st.nleaf, dtype=np.int32),
                           (nleaf_t, 2 * st.nleaf - 1))
    tnc = tt.nc[nleaf_t:][:, None, :]
    tns = tt.ns[nleaf_t:][:, None, :]
    tnr = tt.nr[nleaf_t:][:, None]
    ref = jl._MACS[mac](st, jnp.asarray(cand), pd, tnc, tns, tnr,
                        jnp.float32(theta))
    ts, ttt = interop.tree_from_numpy(st), interop.tree_from_numpy(tt)
    got = tl._MACS[mac](ts, torch.from_numpy(cand.astype(np.int64)),
                        ttt.nc[nleaf_t:][:, None, :],
                        ttt.ns[nleaf_t:][:, None, :],
                        ttt.nr[nleaf_t:][:, None],
                        torch.tensor(theta, dtype=torch.float32))
    _same(got, ref)
    # not vacuous (treecode1 at theta 2 accepts no node of the small
    # equal trees; it does on the other two)
    assert not got.all()
    assert got.any() or (mac == "treecode1" and st.levels == tt.levels)


@pytest.mark.parametrize("mac,theta", MACS)
def test_treecode_lists_identical(trees, mac, theta):
    st, tt = trees
    ref = jl._treecode_lists(st, tt, jnp.float32(theta), mac, st.levels,
                             256, 512)
    got = tl._treecode_lists(interop.tree_from_numpy(st),
                             interop.tree_from_numpy(tt), theta, mac, 256,
                             512)
    for g, r, what in zip(got, ref, ("rows", "counts", "overflow")):
        _same(g, r, what)
    assert int(got[2]) == 0 and int(got[1].sum()) > 0


@pytest.mark.parametrize("mac,theta,widths", [
    ("boxwise", 1.0, (256, 512)), ("pointwise", 1.05, (256, 512)),
    ("boxwise", 1.0, (8, 512)), ("pointwise", 1.05, (256, 12))],
    ids=["boxwise-wide", "pointwise-wide", "narrow-frontier",
         "narrow-list"])
def test_build_treecode_pairs_identical(trees, mac, theta, widths):
    """Pair lists, counts and overflow; the narrow widths overflow
    identically (counted, never silent)."""
    st, tt = trees
    fw, lw = widths
    ref = jl.build_treecode_pairs(st, tt, theta, mac, fw, lw)
    got = tl.build_treecode_pairs(interop.tree_from_numpy(st),
                                  interop.tree_from_numpy(tt), theta, mac,
                                  fw, lw)
    for f in ("tgt", "src", "n_valid", "overflow"):
        _same(getattr(got, f), getattr(ref, f), f)
    assert (int(got.overflow) == 0) == (widths == (256, 512))


def test_split_rows_refuse_in_treecode_lists(trees):
    """Split source rows (src_parts 2) no longer refuse: the list names
    each accepted interior node's extension row, as the reference's."""
    st, tt = trees
    ref = jl.build_treecode_pairs(st, tt, 1.0, "boxwise", src_parts=2)
    got = tl.build_treecode_pairs(interop.tree_from_numpy(st),
                                  interop.tree_from_numpy(tt), 1.0,
                                  "boxwise", src_parts=2)
    for f in ("tgt", "src", "n_valid", "overflow"):
        _same(getattr(got, f), getattr(ref, f), f)
    assert (got.src >= 2 * st.nleaf).any()
