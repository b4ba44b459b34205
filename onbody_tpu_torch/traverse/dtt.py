"""O(N) dual-tree traversal ("fastsumm") solver (port of
onbody_tpu/traverse/dtt.py, level traversal).

Lists come from the simultaneous-descent builder, every interaction
type runs through the one pair executor (far contributions land in the
target equivalent rows of the same accumulator), and the prolongation is
a top-down per-level barycentric interpolation (calcBarycentricDownward,
BarycentricLagrange.hpp:63-166) at order >= 0, a copy from the merged
parent points at order < 0 (pair-merge).
"""

from __future__ import annotations

from typing import Optional

import torch

from onbody_tpu_torch.config import SolverConfig, check_supported
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.tree import equivalents as eq
from onbody_tpu_torch.traverse import exec as pexec
from onbody_tpu_torch.traverse import lists
from onbody_tpu_torch.traverse.treecode import Plan, _leaf_outputs
from onbody_tpu_torch.utils.timing import phase

# children per prolongation batch: bounds the (nodes, k, j, i, P) temporary
_DOWN_CHUNK = 2048


def _downward(out, tree_nc, tree_ns, tgt_geo, order: int, levels: int,
              block_size: int):
    """Prolong accumulated equivalent-target outputs down the tree, in
    place on out (NN, B, OD): for each level top-down, the children's
    points (proxies, or leaf particles at the bottom) receive the
    parent's equivalent outputs interpolated on the parent grid."""
    pd = tree_nc.shape[-1]
    M = (order + 1) ** pd
    for l in range(1, levels + 1):
        np_l = 1 << (l - 1)
        width = block_size if l == levels else M
        for c0 in range(2 * np_l, 4 * np_l, _DOWN_CHUNK):
            c1 = min(c0 + _DOWN_CHUNK, 4 * np_l)
            p0, p1 = c0 // 2, c1 // 2
            pts = tgt_geo[c0:c1, :pd, :width].transpose(1, 2)
            pnc = torch.repeat_interleave(tree_nc[p0:p1], 2, dim=0)
            pns = torch.repeat_interleave(tree_ns[p0:p1], 2, dim=0)
            pu = torch.repeat_interleave(out[p0:p1, :M], 2, dim=0)
            out[c0:c1, :width] += eq.prolong_factored(pts, pnc, pns, order,
                                                      pu)
    return out


def _downward_copy(out, levels: int, block_size: int):
    """Order < 0 prolongation, in place on out (NN, B, OD): child point i
    inherits parent equivalent i // 2, left children from the parent's
    first half and right children from its second, the halves merged
    from them (ongrav3d.cpp:241-251, barneshut.hpp:974-976)."""
    bs = block_size
    h = bs // 2
    for l in range(1, levels + 1):
        np_l = 1 << (l - 1)
        pu = out[np_l:2 * np_l, :bs]                     # (np_l, bs, OD)
        left = torch.repeat_interleave(pu[:, :h], 2, dim=1)
        right = torch.repeat_interleave(pu[:, h:], 2, dim=1)
        add = torch.stack([left, right], dim=1).reshape(2 * np_l, bs, -1)
        out[2 * np_l:4 * np_l, :bs] += add
    return out


def fastsumm_stats(raw: lists.PairList, nleaf_s: int, nleaf_t: int,
                   raw2: Optional[lists.PairList] = None):
    """Interaction-type counters {sltl, sbtl, sltb, sbtb} over the pair
    list (the reference's fastsumm_stats, ongrav3d.cpp:193-196). Each
    entry of a sibling-paired leaf list raw2 counts as two leaf-leaf
    pairs (both children, alive or not)."""
    valid = raw.src != 0
    s_leaf = (raw.src >= nleaf_s) & (raw.src < 2 * nleaf_s)
    t_leaf = (raw.tgt >= nleaf_t) & (raw.tgt < 2 * nleaf_t)
    stats = {
        "sltl": (valid & s_leaf & t_leaf).sum(),
        "sbtl": (valid & ~s_leaf & t_leaf).sum(),
        "sltb": (valid & s_leaf & ~t_leaf).sum(),
        "sbtb": (valid & ~s_leaf & ~t_leaf).sum(),
    }
    if raw2 is not None:
        stats["sltl"] = stats["sltl"] + 2 * (raw2.src != 0).sum()
    return stats


def solve_dtt(kernel: Kernel, cfg: SolverConfig, plan: Plan,
              theta: Optional[float] = None, unscramble: bool = True,
              timer=None):
    """Full evaluation; returns (outputs, info). unscramble=False keeps
    outputs in SORTED (tree) order, (nleaf*block_size, OD) including
    padded slots — the reference drivers' convention; map rows through
    plan.tgt_gidx. cfg.dtt_leaf_pair2 runs the leaf level through the
    sibling-paired executor (on either backend; K2 for a dma-family
    pair_fetch, K9 for 'pregather'; 'static' has no paired form and
    keeps the unpaired leaf level, reference dtt.py:213-224)."""
    check_supported(cfg, kernel)
    theta = cfg.theta_dtt if theta is None else theta
    stree, ttree = plan.stree, plan.ttree
    use_p2 = (cfg.dtt_leaf_pair2 and cfg.pair_fetch != "static"
              and stree.levels <= ttree.levels and ttree.levels >= 1)
    n_live = plan.tgt_sorted.n_real
    pl2 = None
    with phase(timer, "lists"):
        if use_p2:
            pl, pl2 = lists.build_dtt_pairs_level2(
                stree, ttree, theta, cfg.frontier_width, cfg.mac_geometry,
                n_live=n_live, compact=cfg.list_compact)
        else:
            pl = lists.build_dtt_pairs_level(
                stree, ttree, theta, cfg.frontier_width, cfg.mac_geometry,
                n_live=n_live, compact=cfg.list_compact)
    out, info = pexec.exec_pairs(kernel, cfg, plan, pl, cfg.frontier_width,
                                 cfg.cap_groups_dtt, raw2=pl2, timer=timer)
    with phase(timer, "downward"):
        if cfg.order >= 0:
            out = _downward(out, ttree.nc, ttree.ns, plan.tgt_geo,
                            cfg.order, ttree.levels, ttree.block_size)
        else:
            out = _downward_copy(out, ttree.levels, ttree.block_size)
    if not unscramble:
        nleaf, bs = ttree.nleaf, ttree.block_size
        return out[nleaf:2 * nleaf, :bs, :].reshape(-1, kernel.od), info
    return _leaf_outputs(out, plan, kernel, plan.tgt_sorted.n_real), info
