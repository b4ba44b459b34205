"""tree/hsplit.py (the exact top k-d split on u16 codes, the out-of-core
tier's first step) against the JAX package on the CPU.

The same integer codes, made with numpy, go through both packages. Ties
are made on purpose (one axis drawn from a few hundred codes), the chunks
are ragged and the split carries virtual pad slots, so every branch of
the tie quotas and the pad bookkeeping runs. Everything is an integer:
planes, quotas, axes and subtree ids must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onbody_tpu.tree import hsplit as jhsplit
from onbody_tpu_torch.tree import hsplit

torch.set_num_threads(1)

SIZES = [700, 1024, 333, 900]


def _codes(seed: int, sizes, tie_axis_codes: int = 300):
    """Per-chunk (m, 3) int32 codes: axes 0 and 2 spread over 0..65534,
    axis 1 over `tie_axis_codes` values (ties at every plane)."""
    rng = np.random.default_rng(seed)
    out = []
    for m in sizes:
        c = rng.integers(0, 65535, (m, 3))
        c[:, 1] = rng.integers(0, tie_axis_codes, m) * 97
        out.append(c.astype(np.int32))
    return out


def _split_both(codes, split: int, pads: int, box):
    lo, hi = box
    ref = jhsplit.run_top_split(lambda c: jnp.asarray(codes[c]), len(codes),
                                0, split, lo, hi, virtual_pad_slots=pads,
                                chunk_sizes=[len(c) for c in codes])
    got = hsplit.run_top_split(lambda c: torch.from_numpy(codes[c]),
                               len(codes), 0, split, lo, hi,
                               virtual_pad_slots=pads,
                               chunk_sizes=[len(c) for c in codes])
    return ref, got


# (split, virtual pad slots, box): the box's long axis decides the first
# split axis; a flat box in y makes the tied axis win at depth
CASES = {
    "split3-pads": (3, 4096 - sum(SIZES), (np.array([-1., -1., -1.]),
                                           np.array([1., 1., 1.]))),
    "split4-nopads": (4, 0, (np.array([0., 0., 0.]),
                             np.array([1., 4., 2.]))),
    "split2-manypads": (2, 8192 - sum(SIZES), (np.array([0., 0., 0.]),
                                               np.array([3., 1., 1.]))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_top_split_identical(case):
    split, pads, box = CASES[case]
    codes = _codes(11, SIZES)
    (rp, rq, ra, rn), (gp, gq, ga, gn) = _split_both(codes, split, pads, box)
    for l in range(split):
        np.testing.assert_array_equal(gp[l], rp[l])
        np.testing.assert_array_equal(ga[l], ra[l])
        assert gp[l].dtype == rp[l].dtype and ga[l].dtype == ra[l].dtype
        for qg, qr in zip(gq[l], rq[l]):
            np.testing.assert_array_equal(qg, qr)
    for c in range(len(SIZES)):
        np.testing.assert_array_equal(gn[c].numpy(), np.asarray(rn[c]))
    # the VAMsplit invariant: every subtree gets its share of the real +
    # virtual pad slots, the left ones exactly n_slots >> split
    ids = np.concatenate([n.numpy() for n in gn])
    counts = np.bincount(ids, minlength=1 << split)
    assert counts.sum() == sum(SIZES)
    if (sum(SIZES) + pads) % (1 << split) == 0:
        assert (counts <= (sum(SIZES) + pads) >> split).all()


def test_chunk_stages_identical():
    """chunk_hist, chunk_tie_counts and chunk_assign on one chunk with
    ties, at a level of 4 nodes, against the reference's jits."""
    rng = np.random.default_rng(3)
    codes = _codes(5, [1500])[0]
    nid = rng.integers(0, 4, 1500).astype(np.int32)
    axes = np.array([1, 0, 1, 2], np.int32)
    planes = np.array([97 * 150, 30000, 97 * 10, 65535], np.int32)
    quota = np.array([3, 0, 7, 2], np.int32)
    J, T = jnp.asarray, torch.from_numpy
    np.testing.assert_array_equal(
        hsplit.chunk_hist(T(codes), T(nid), T(axes).long(), 4).numpy(),
        np.asarray(jhsplit.chunk_hist(J(codes), J(nid), J(axes), 4)))
    np.testing.assert_array_equal(
        hsplit.chunk_tie_counts(T(codes), T(nid), T(axes).long(),
                                T(planes)).numpy(),
        np.asarray(jhsplit.chunk_tie_counts(J(codes), J(nid), J(axes),
                                            J(planes))))
    np.testing.assert_array_equal(
        hsplit.chunk_assign(T(codes), T(nid), T(axes).long(), T(planes),
                            T(quota)).numpy(),
        np.asarray(jhsplit.chunk_assign(J(codes), J(nid), J(axes),
                                        J(planes), J(quota))))


PLAN_CASES = {
    # (per-node histograms as {bin: count}, target)
    "one-bin-all-ties": ([{500: 10}], 4),
    "split-below-ties": ([{3: 2, 9: 5, 20: 3}], 4),
    "exact-at-plane": ([{3: 2, 9: 2, 20: 6}], 4),
    "pads-only-right": ([{7: 3, 65535: 5}], 4),
    "two-nodes": ([{0: 4, 1: 4}, {65534: 1, 65535: 7}], 4),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_level_hand_cases(case):
    bins, target = PLAN_CASES[case]
    hists = np.zeros((len(bins), 65536), np.int64)
    for i, b in enumerate(bins):
        for k, v in b.items():
            hists[i, k] = v
    gp, gn = hsplit.plan_level(hists, target)
    rp, rn = jhsplit.plan_level(hists, target)
    np.testing.assert_array_equal(gp, rp)
    np.testing.assert_array_equal(gn, rn)
    # left = code < plane plus `need` ties is exactly the target
    less = np.array([hists[i, :p].sum() for i, p in enumerate(gp)])
    np.testing.assert_array_equal(less + gn, target)


@pytest.mark.parametrize("ties,need", [
    ([np.array([3, 0]), np.array([2, 5]), np.array([4, 1])],
     np.array([4, 5])),
    ([np.array([0]), np.array([0]), np.array([6])], np.array([6])),
    ([np.array([2, 2])], np.array([0, 2])),
])
def test_tie_quotas_hand_cases(ties, need):
    got = hsplit.tie_quotas(ties, need)
    ref = jhsplit.tie_quotas(ties, need)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # the quotas hand out exactly min(need, total ties), chunks in order
    np.testing.assert_array_equal(np.sum(got, axis=0),
                                  np.minimum(need, np.sum(ties, axis=0)))
