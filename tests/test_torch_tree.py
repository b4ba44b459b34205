"""Port vs reference: tree construction (tree/build.py)."""

import numpy as np
import pytest
import torch

from _torch_parity import jax_parts, make_inputs, torch_parts
from onbody_tpu.tree import build as jbuild
from onbody_tpu_torch.tree import build as tbuild

torch.set_num_threads(1)

BS = 32
# 2048 = 64 full leaves; 1500 -> 47 leaves padded to 64 (n < n_pad <= 2n)
SIZES = [2048, 1500]


def _assert_tree(got, ref):
    for f in ("nc", "ns", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_max_ulp(got.nr.numpy(), np.asarray(ref.nr),
                                    maxulp=1)
    for f in ("x", "s", "pr"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30),
                                   err_msg=f)
    assert (got.levels, got.block_size) == (ref.levels, ref.block_size)


def _assert_sorted(got, ref, gidx, gidx_ref):
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(gidx_ref))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(ref.x))
    # real radii are moved exactly; pad radii are the mean real radius,
    # a float sum that rounds apart by a few ulp
    real = gidx.numpy() < got.n_real
    r, r_ref = got.r.numpy(), np.asarray(ref.r)
    np.testing.assert_array_equal(r[real], r_ref[real])
    np.testing.assert_allclose(r, r_ref, rtol=1e-6)
    if ref.s is None:
        assert got.s is None
    else:
        np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", ["median", "span"])
def test_build_tree_matches_reference(mode, n):
    sx, sr, ss, tx, tr = make_inputs(10 + n, n)
    for args, targets in (((sx, sr, ss), False), ((tx, tr), True)):
        ref_tree, ref_parts, ref_g = jbuild.build_tree(
            jax_parts(*args), BS, mode=mode, span_top=3,
            need_r=not targets)
        tree, parts, g = tbuild.build_tree(
            torch_parts(*args), BS, mode=mode, span_top=3,
            need_r=not targets)
        _assert_tree(tree, ref_tree)
        _assert_sorted(parts, ref_parts, g, ref_g)


@pytest.mark.parametrize("mode", ["median", "span"])
def test_paired_build_matches_reference_and_single(mode):
    n = SIZES[1]
    sx, sr, ss, tx, tr = make_inputs(20, n)
    ref = jbuild.build_trees_paired(jax_parts(sx, sr, ss),
                                    jax_parts(tx, tr), BS, mode=mode,
                                    defer_rs=True, need_tgt_r=False)
    got = tbuild.build_trees_paired(torch_parts(sx, sr, ss),
                                    torch_parts(tx, tr), BS, mode=mode,
                                    need_tgt_r=False)
    single = (tbuild.build_tree(torch_parts(sx, sr, ss), BS, mode=mode),
              tbuild.build_tree(torch_parts(tx, tr), BS, mode=mode,
                                need_r=False))
    for (t, p, g), (rt, rp, rg), (st, sp, sg) in zip(got, ref, single):
        _assert_tree(t, rt)
        _assert_sorted(p, rp, g, rg)
        for f in ("nc", "ns", "nr", "x", "s", "pr", "alive"):
            assert torch.equal(getattr(t, f), getattr(st, f)), f
        assert torch.equal(g, sg) and torch.equal(p.x, sp.x)


def test_sort_schedule_matches_reference():
    """The port's sort levels are the reference schedule's sort steps."""
    for levels, n_pad, q, top in ((7, 4096, 2, 6), (12, 1 << 20, 2, 6),
                                  (5, 1024, 1, 6), (9, 16384, 3, 4)):
        ref = [l for kind, l, *_ in jbuild._build_schedule(
            levels, levels, n_pad, q, top, None, n_pad, 1) if kind == "sort"]
        assert tbuild._sort_levels(levels, n_pad, q, top, None) == ref


@pytest.mark.parametrize("n_pad", [2048, 3000])
def test_pad_to_matches_reference(n_pad):
    """Zero-strength clones one diameter past the max corner."""
    from onbody_tpu import parts as JP
    from onbody_tpu_torch import parts as TP
    sx, sr, ss, _, _ = make_inputs(31, 1500)
    ref = JP.pad_to(jax_parts(sx, sr, ss), n_pad)
    got = TP.pad_to(torch_parts(sx, sr, ss), n_pad)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))
    np.testing.assert_allclose(got.r.numpy(), np.asarray(ref.r), rtol=1e-6)
    assert got.n_real == ref.n_real == 1500


def test_plan_and_unported_modes():
    for n, bs in ((1, 32), (1000, 32), (1024, 32), (1025, 256)):
        assert tbuild.plan(n, bs) == jbuild.plan(n, bs)
    sx, sr, ss, _, _ = make_inputs(30, 100)
    with pytest.raises(NotImplementedError, match="item 17"):
        tbuild.build_tree(torch_parts(sx, sr, ss), BS, mode="morton")
    # refine=True (the pair-merge ordering) is ported: it builds a
    # permutation (held to the reference in test_torch_pairmerge.py)
    _, _, g = tbuild.build_tree(torch_parts(sx, sr, ss), BS, refine=True)
    assert torch.equal(g.sort().values, torch.arange(g.numel()))
