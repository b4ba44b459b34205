"""Port vs reference: DTT interaction lists and grouping
(traverse/lists.py), built on the reference's own trees. Integer
outputs must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_parts, jax_tree, make_inputs, torch_parts
from onbody_tpu.traverse import lists as jl
from onbody_tpu.tree import build as jbuild
from onbody_tpu_torch import interop
from onbody_tpu_torch.traverse import lists as tl

torch.set_num_threads(1)

W = 256


def _same(got, ref, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), what)


def _same_list(got, ref):
    for f in ("tgt", "src", "n_valid", "overflow"):
        _same(getattr(got, f), getattr(ref, f), f)


@pytest.fixture(scope="module",
                params=[(3000, 3000), (1500, 2048), (3000, 1000)],
                ids=["equal", "ragged", "deep-source"])
def trees(request):
    """Reference trees: equal sizes, a ragged source set, and a source
    tree deeper than the target tree."""
    ns_, nt_ = request.param
    sx, sr, ss, _, _ = make_inputs(50, ns_)
    _, _, _, tx, tr = make_inputs(51, 16, nt_)
    st, _, _ = jbuild.build_tree(jax_parts(sx, sr, ss), 32, mode="span")
    tt, _, _ = jbuild.build_tree(jax_parts(tx, tr), 32, mode="span",
                                 need_r=False)
    return st, tt, nt_


@pytest.mark.parametrize("theta", [1.2, 0.8])
def test_dtt_level2_lists_identical(trees, theta):
    st, tt, n_live = trees
    if st.levels > tt.levels:
        # no paired form for a deeper source tree: both refuse
        for mod, t in ((jl, lambda x: x), (tl, interop.tree_from_numpy)):
            with pytest.raises(ValueError, match="leaf_pair2"):
                mod.build_dtt_pairs_level2(t(st), t(tt), theta, W,
                                           n_live=n_live)
        return
    ref = jl.build_dtt_pairs_level2(st, tt, theta, W, "quant",
                                    n_live=n_live)
    got = tl.build_dtt_pairs_level2(interop.tree_from_numpy(st),
                                    interop.tree_from_numpy(tt), theta, W,
                                    "quant", n_live=n_live)
    for g, r in zip(got, ref):
        _same_list(g, r)


@pytest.mark.parametrize("live_prefix", [True, False])
def test_dtt_level_lists_identical(trees, live_prefix):
    """With n_live the levels are sliced to their live prefix; without
    it dead target rows are masked through `alive` instead."""
    st, tt, n_live = trees
    n_live = n_live if live_prefix else 0
    ref = jl.build_dtt_pairs_level(st, tt, 1.2, W, "quant", n_live=n_live)
    got = tl.build_dtt_pairs_level(interop.tree_from_numpy(st),
                                   interop.tree_from_numpy(tt), 1.2, W,
                                   n_live=n_live)
    _same_list(got, ref)


def test_dtt_lists_overflow_counted(trees):
    """A narrow frontier overflows identically (counted, never silent)."""
    st, tt, n_live = trees
    ref = jl.build_dtt_pairs_level(st, tt, 1.2, 16, "quant", n_live=n_live)
    got = tl.build_dtt_pairs_level(interop.tree_from_numpy(st),
                                   interop.tree_from_numpy(tt), 1.2, 16,
                                   n_live=n_live)
    assert int(got.overflow) > 0
    _same_list(got, ref)


@pytest.mark.parametrize("group,cap", [(8, 4096), (16, 2048), (8, 64)])
def test_group_pairs_identical(trees, group, cap):
    st, tt, n_live = trees
    refs = [jl.build_dtt_pairs_level(st, tt, 1.2, W, "quant",
                                     n_live=n_live)]
    if st.levels <= tt.levels:
        refs += jl.build_dtt_pairs_level2(st, tt, 1.2, W, "quant",
                                          n_live=n_live)
    for ref in refs:
        rg = jl.group_pairs(ref, cap, group, W, "sort")
        gg = tl.group_pairs(interop.pairlist_from_numpy(ref), cap, group, W)
        _same_list(gg, rg)


@pytest.mark.parametrize("width", [3, 8, 12])
def test_compact_rows_identical(width):
    rng = np.random.default_rng(52)
    vals = np.where(rng.random((40, 10)) < 0.6, 0,
                    rng.integers(1, 100, (40, 10))).astype(np.int32)
    ref, ov = jl._compact_rows(jnp.asarray(vals), width, "sort")
    got, ovg = tl._compact_rows(torch.from_numpy(vals).long(), width)
    _same(got, ref)
    assert int(ovg) == int(ov)


def test_group_pairs_chunking():
    """Grouped compaction keeps every valid pair exactly once (the
    reference's test_group_pairs_chunking, on the port)."""
    K, G = 16, 8
    tgt = torch.arange(1, 5).repeat_interleave(K)
    src = torch.zeros((4, K), dtype=torch.int64)
    src[0, :3] = torch.tensor([7, 8, 9])
    src[2, :10] = torch.arange(10, 20)
    raw = tl.PairList(tgt=tgt, src=src.reshape(-1),
                      n_valid=torch.tensor(13), overflow=torch.tensor(0))
    pg = tl.group_pairs(raw, cap=8, group=G, slot_width=K)
    assert int(pg.overflow) == 0
    got = [(int(t), [int(v) for v in s if v]) for t, s in
           zip(pg.tgt, pg.src) if s.any()]
    assert got == [(1, [7, 8, 9]), (3, list(range(10, 18))),
                   (3, [18, 19])]


@pytest.mark.parametrize("mode", ["scatter", "sort", "idsort"])
@pytest.mark.parametrize("width", [3, 8, 12])
def test_compact_rows_modes_identical(mode, width):
    """Every list_compact mode against the reference's, on rows of
    distinct ids (as the builders' rows are)."""
    rng = np.random.default_rng(53)
    vals = np.stack([rng.permutation(np.arange(1, 100))[:10]
                     for _ in range(40)])
    vals = np.where(rng.random((40, 10)) < 0.5, 0, vals).astype(np.int32)
    ref, ov = jl._compact_rows(jnp.asarray(vals), width, mode)
    got, ovg = tl._compact_rows(torch.from_numpy(vals).long(), width, mode)
    _same(got, ref)
    assert int(ovg) == int(ov)
    if mode == "idsort":
        g = got.numpy()
        for row in g:
            nz = row[row != 0]
            assert (np.diff(nz) > 0).all() and not row[len(nz):].any()


def _check_idsort(st, tt, n_live, theta):
    """Both DTT builders with compact='idsort' on the reference's trees:
    the port's lists and groups equal the reference's, and the rows
    really are in id order, unlike the scatter builder's."""
    pst, ptt = interop.tree_from_numpy(st), interop.tree_from_numpy(tt)
    pairs = [(jl.build_dtt_pairs_level(st, tt, theta, W, "quant",
                                       compact="idsort", n_live=n_live),
              tl.build_dtt_pairs_level(pst, ptt, theta, W, n_live=n_live,
                                       compact="idsort"))]
    if st.levels <= tt.levels:
        pairs += zip(jl.build_dtt_pairs_level2(st, tt, theta, W, "quant",
                                               compact="idsort",
                                               n_live=n_live),
                     tl.build_dtt_pairs_level2(pst, ptt, theta, W,
                                               n_live=n_live,
                                               compact="idsort"))
    for ref, got in pairs:
        _same_list(got, ref)
        _same_list(tl.group_pairs(got, 4096, 8, W),
                   jl.group_pairs(ref, 4096, 8, W, "sort"))
    plain = tl.build_dtt_pairs_level(pst, ptt, theta, W, n_live=n_live)
    got = pairs[0][1]
    assert not torch.equal(got.src, plain.src)
    assert torch.equal(got.src.view(-1, W).sort(1).values,
                       plain.src.view(-1, W).sort(1).values)


def test_dtt_lists_idsort_identical(trees):
    """list_compact='idsort' (3D trees: equal, ragged, deep source):
    both builders' rows, lists and groups equal the reference's."""
    st, tt, n_live = trees
    _check_idsort(st, tt, n_live, 1.2)


def test_dtt_lists_idsort_identical_2d():
    """The same in two dimensions (vort2d's trees and theta 1.4), on the
    port's trees carried to the reference (tests/test_torch_vortex.py
    holds the 2D trees equal), which spares the reference's 2D tree
    build its compilation."""
    from onbody_tpu_torch.tree import build as tbuild
    sx, sr, ss, _, _ = make_inputs(54, 1500, pd=2)
    _, _, _, tx, tr = make_inputs(55, 16, 2048, pd=2)
    st = tbuild.build_tree(torch_parts(sx, sr, ss), 32, mode="span")[0]
    tt = tbuild.build_tree(torch_parts(tx, tr), 32, mode="span",
                           need_r=False)[0]
    _check_idsort(jax_tree(st), jax_tree(tt), 2048, 1.4)
