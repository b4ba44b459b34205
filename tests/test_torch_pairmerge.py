"""Port vs reference: the order < 0 (pair-merge) path, stage by stage.

build_tree(refine=True) against the reference's on tie-free inputs;
pairmerge_blocks and the pair-merge target_blocks on the reference's
own sorted parts (through interop); _downward_copy on one accumulator;
the solvers at order -1 are in test_torch_pairmerge_solvers.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import jax_parts, kernel_inputs, make_inputs, torch_parts
from onbody_tpu.tree import build as jbuild
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch import interop
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.tree import build as tbuild
from onbody_tpu_torch.tree import equivalents as teq

torch.set_num_threads(1)

BS = 32


def _same_tree(got, ref):
    for f in ("nc", "ns", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2048, 1500])
@pytest.mark.parametrize("mode", ["median", "span"])
def test_refine_tree_matches_reference(mode, n):
    """The sorts go on inside the leaves (log2(n_pad) levels): gidx,
    sorted positions, boxes and alive identical to the reference's."""
    sx, sr, ss, tx, tr = make_inputs(40 + n, n)
    ref_t, ref_p, ref_g = jbuild.build_tree(jax_parts(sx, sr, ss), BS,
                                            refine=True, mode=mode,
                                            span_top=3)
    tree, parts, g = tbuild.build_tree(torch_parts(sx, sr, ss), BS,
                                       refine=True, mode=mode, span_top=3)
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref_g))
    np.testing.assert_array_equal(parts.x.numpy(), np.asarray(ref_p.x))
    _same_tree(tree, ref_t)
    # the refinement reorders inside leaves only: the leaves hold the
    # particles of the unrefined build
    _, _, g0 = tbuild.build_tree(torch_parts(sx, sr, ss), BS, mode=mode,
                                 span_top=3)
    assert not torch.equal(g, g0)
    leaves = tree.nleaf
    assert torch.equal(g.view(leaves, BS).sort(1).values,
                       g0.view(leaves, BS).sort(1).values)


def test_refine_paired_build_matches_reference():
    sx, sr, ss, tx, tr = make_inputs(44, 1500)
    ref = jbuild.build_trees_paired(jax_parts(sx, sr, ss),
                                    jax_parts(tx, tr), BS, refine=True,
                                    mode="span", need_tgt_r=False)
    got = tbuild.build_trees_paired(torch_parts(sx, sr, ss),
                                    torch_parts(tx, tr), BS, refine=True,
                                    mode="span", need_tgt_r=False)
    for (t, p, g), (rt, rp, rg) in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
        np.testing.assert_array_equal(p.x.numpy(), np.asarray(rp.x))
        _same_tree(t, rt)


def _close(got, ref, rel=1e-6):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("name,bs", [("grav3d", 32), ("vort3d", 64),
                                     ("vort2d", 128)])
def test_pairmerge_blocks_match_reference(name, bs):
    """Sources (strength-weighted) and targets (unit weights) on the
    reference's refined trees; rows padded to 128 slots below 128."""
    kernel = TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 50 + bs, 600)
    for args, targets in (((sx, sr, ss), False), ((tx, tr), True)):
        rt, rp, _ = jbuild.build_tree(jax_parts(*args), bs, refine=True)
        tree, parts = interop.tree_from_numpy(rt), \
            interop.parts_from_numpy(rp)
        if targets:
            ref = jeq.target_blocks(rt, rp, -1)
            got = teq.target_blocks(tree, parts, -1)
            assert got.s is None
        else:
            ref = jeq.pairmerge_blocks(rt, rp)
            got = teq.pairmerge_blocks(tree, parts)
            np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))
        assert got.pos.shape == (2 * tree.nleaf, max(bs, 128), kernel.pd)
        _close(got.pos, ref.pos)
        _close(got.rad, ref.rad)


def test_pairmerge_conserves_strength():
    """Each interior row holds the strength sum of its subtree (the
    reference's test_pairmerge_blocks_conserve_strength, per level)."""
    sx, sr, ss, _, _ = make_inputs(61, 1000)
    tree, parts, _ = tbuild.build_tree(torch_parts(sx, sr, ss), BS,
                                       refine=True)
    b = teq.pairmerge_blocks(tree, parts)
    tot = ss.astype(np.float64).sum()
    for l in range(tree.levels + 1):
        lvl = b.s[tree.level_slice(l)].double().sum()
        assert abs(float(lvl) - tot) <= 1e-5 * np.abs(ss).sum()


def test_downward_copy_matches_reference():
    from onbody_tpu.traverse.dtt import _downward_copy as jcopy
    import jax.numpy as jnp
    rng = np.random.default_rng(70)
    levels, bs = 4, 32
    out = rng.standard_normal((2 << levels, 128, 3)).astype(np.float32)
    ref = np.asarray(jcopy(jnp.asarray(out), levels, bs))
    got = tdtt._downward_copy(torch.from_numpy(out.copy()), levels, bs)
    np.testing.assert_array_equal(got.numpy(), ref)
