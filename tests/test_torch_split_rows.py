"""Port vs reference: split equivalent rows, a proxy grid wider than a
block row spread over extension rows (part j >= 1 of node i at row
(j+1)*nleaf + i).

The builders (tree/equivalents.py) fed the reference's own trees: the
layout (shapes, which entries are exactly zero) identical, the values
within 1e-6 of the largest (fp32 anterpolation summed in another
order). The DTT lists with source and target parts and the treecode3
list with source parts (traverse/lists.py) identical, ids included. The
solves are in test_torch_split_solves.py."""

import functools

import numpy as np
import pytest
import torch

from _torch_parity import jax_parts, kernel_inputs
from onbody_tpu.traverse import lists as jl
from onbody_tpu.tree import build as jbuild
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch import interop
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import lists as tl
from onbody_tpu_torch.tree import equivalents as teq

torch.set_num_threads(1)

# (order, block size): 2 parts of 128 on the Blocks path (7 of 32 lean),
# 4 parts (8 lean), and order 3 at block 32, one Blocks row but 2 lean
CASES = [(5, 32), (7, 64), (3, 32)]
IDS = [f"order{o}-b{b}" for o, b in CASES]
VALUE_TOL = 1e-6


def _same_layout_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(
        got, ref, rtol=VALUE_TOL,
        atol=VALUE_TOL * max(np.abs(ref).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _trees(block: int):
    """Reference trees and sorted parts of one vort3d problem (3D, three
    strength components)."""
    k = TK.KERNELS["vort3d"]
    sx, sr, ss, _, _ = kernel_inputs(k, 90, 1500)
    _, _, _, tx, tr = kernel_inputs(k, 91, 16, 1300)
    st, sp, _ = jbuild.build_tree(jax_parts(sx, sr, ss), block,
                                  mode="span")
    tt, tp, _ = jbuild.build_tree(jax_parts(tx, tr), block, mode="span",
                                  need_r=False)
    return st, sp, tt, tp


@pytest.mark.parametrize("order,block", CASES, ids=IDS)
def test_split_blocks_match_reference(order, block):
    """barycentric_blocks and target_blocks: (1 + parts) * nleaf rows of
    the lane-rounded width."""
    st, sp, tt, tp = _trees(block)
    parts = teq.n_eq_parts(teq.block_width(block), order, 3)
    ref = jeq.barycentric_blocks(st, sp, order)
    got = teq.barycentric_blocks(interop.tree_from_numpy(st),
                                 interop.parts_from_numpy(sp), order)
    assert got.pos.shape[0] == (1 + parts) * st.nleaf
    for f in ("pos", "rad", "s"):
        _same_layout_close(getattr(got, f), getattr(ref, f))
    ref = jeq.target_blocks(tt, tp, order)
    got = teq.target_blocks(interop.tree_from_numpy(tt),
                            interop.parts_from_numpy(tp), order)
    assert got.s is None
    for f in ("pos", "rad"):
        _same_layout_close(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("pad8", [True, False], ids=["pad8", "lean"])
@pytest.mark.parametrize("order,block", CASES, ids=IDS)
def test_split_lean_rows_match_reference(order, block, pad8):
    """barycentric_fm and target_geo_fm: rows block_size wide, so the
    grids split sooner (order 3 at block 32: 64 proxies in 2 rows)."""
    st, sp, tt, tp = _trees(block)
    parts = teq.n_eq_parts(block, order, 3)
    assert parts > 1
    ref = jeq.barycentric_fm(st, sp, order, "vort3d", pad8=pad8)
    got = teq.barycentric_fm(interop.tree_from_numpy(st),
                             interop.parts_from_numpy(sp), order, "vort3d",
                             pad8=pad8)
    assert got.shape[0] == (1 + parts) * st.nleaf
    _same_layout_close(got, ref)
    ref = jeq.target_geo_fm(tt, tp, order)
    got = teq.target_geo_fm(interop.tree_from_numpy(tt),
                            interop.parts_from_numpy(tp), order)
    _same_layout_close(got, ref)


@pytest.mark.parametrize("order,block", CASES[:2], ids=IDS[:2])
def test_split_dtt_lists_identical(order, block):
    """build_dtt_pairs_level and build_dtt_pairs_level2 with source and
    target parts: the reference's lists, counts and overflow."""
    st, _, tt, _ = _trees(block)
    parts = teq.n_eq_parts(teq.block_width(block), order, 3)
    ts, ttt = interop.tree_from_numpy(st), interop.tree_from_numpy(tt)
    kw = dict(src_parts=parts, tgt_parts=parts, n_live=1300)
    ref = jl.build_dtt_pairs_level(st, tt, 1.2, 256, "quant", **kw)
    got = tl.build_dtt_pairs_level(ts, ttt, 1.2, 256, "quant", **kw)
    refs, gots = [ref], [got]
    if st.levels <= tt.levels:
        refs += jl.build_dtt_pairs_level2(st, tt, 1.2, 256, "quant", **kw)
        gots += tl.build_dtt_pairs_level2(ts, ttt, 1.2, 256, "quant", **kw)
    assert int(ref.overflow) == 0
    for g, r in zip(gots, refs):
        for f in ("tgt", "src", "n_valid", "overflow"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(r, f)), f)
    # extension rows appear as targets and as sources
    nleaf = tt.nleaf
    assert (got.tgt >= 2 * nleaf).any() and (got.src >= 2 * nleaf).any()


@pytest.mark.parametrize("order,block", CASES[:2], ids=IDS[:2])
def test_split_treecode_list_identical(order, block):
    """The boxwise (treecode3) list with source parts."""
    st, _, tt, _ = _trees(block)
    parts = teq.n_eq_parts(teq.block_width(block), order, 3)
    ref = jl.build_treecode_pairs(st, tt, 1.0, "boxwise", 256, 1024,
                                  src_parts=parts)
    got = tl.build_treecode_pairs(interop.tree_from_numpy(st),
                                  interop.tree_from_numpy(tt), 1.0,
                                  "boxwise", 256, 1024, src_parts=parts)
    for f in ("tgt", "src", "n_valid", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    assert (got.src >= 2 * st.nleaf).any()
