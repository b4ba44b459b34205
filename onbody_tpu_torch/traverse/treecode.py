"""The plan shared by the fast methods and the three O(N log N)
treecode solvers (port of onbody_tpu/traverse/treecode.py).

MAC list construction (traverse/lists.py) followed by dense pair
execution (traverse/exec.py). treecode2/3 evaluate accepted far nodes as
equivalent proxy blocks through the pair executor; treecode1 evaluates
them as single pseudo-particles at the node's center of mass with summed
strength and mean radius, gathered per leaf (plain torch: the reference's
form is XLA code, not a Pallas kernel), and only the near leaf-leaf part
goes through the executor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import SolverConfig, check_supported
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel, featurize
from onbody_tpu_torch.parts import Parts
from onbody_tpu_torch.traverse import exec as pexec
from onbody_tpu_torch.traverse import lists
from onbody_tpu_torch.tree import build as tree_build
from onbody_tpu_torch.tree import equivalents as eq
from onbody_tpu_torch.utils.timing import phase


@dataclasses.dataclass
class Plan:
    """Everything data-independent of theta: trees, sorted parts, blocks."""
    stree: tree_build.Tree
    ttree: tree_build.Tree
    src_sorted: Parts
    tgt_sorted: Parts
    src_blocks: Optional[eq.Blocks]  # None on the lean plan
    tgt_blocks: Optional[eq.Blocks]
    src_gidx: torch.Tensor
    tgt_gidx: torch.Tensor
    src_fm: torch.Tensor             # (NN, C, B) sources, accum_dtype
    tgt_geo: torch.Tensor            # (NN, 8, B) [pos | radius | 0]
    tgt_inv: Optional[torch.Tensor]  # original target index -> slot


def prepare(kernel: Kernel, cfg: SolverConfig, srcs: Parts, targs: Parts,
            want_inv: bool = True, timer=None) -> Plan:
    """Build both trees and the unified block arrays (the reference
    times this as 'build tree' + 'calc equivalents'). want_inv=False
    skips the inverse target permutation (results stay in tree order).

    Particles, trees, proxies and tgt_geo are in cfg.storage_dtype; the
    source rows src_fm are featurized in cfg.accum_dtype from them (the
    promotion is exact but for grav3d's stored sr^2, which the
    reference's fp64 tier squares after promoting). With split
    equivalent rows both arrays have (1 + parts) * nleaf rows."""
    check_supported(cfg, kernel)
    srcs = P.astype(srcs, cfg.storage_dtype)
    targs = P.astype(targs, cfg.storage_dtype)
    # order < 0 (pair-merge) needs the refined intra-leaf ordering
    kw = dict(block_size=cfg.block_size, refine=cfg.order < 0,
              mode=cfg.tree_mode, span=cfg.tree_span,
              span_top=cfg.tree_span_top, span_bot=cfg.tree_span_bot)
    with phase(timer, "tree"):
        stree, ss, sg = tree_build.build_tree(srcs, **kw)
        # kernels that ignore target radii get zero radii (reference
        # build need_r)
        ttree, ts, tg = tree_build.build_tree(targs, need_r=kernel.uses_tr,
                                              **kw)
    with phase(timer, "equivalents"):
        if cfg.lean_plan and cfg.order >= 0:
            # the feature-major arrays directly, no point-major Blocks;
            # a dma-family fetch stores the rows padded to 8, as the
            # reference does (treecode.py:121), pregather the lean rows.
            # The lean builders are barycentric only: order < 0 takes
            # the Blocks path, as in the reference (treecode.py:113)
            pad8 = cfg.pair_fetch.startswith("dma")
            src_fm = eq.barycentric_fm(stree, ss, cfg.order, kernel.name,
                                       pad8=pad8, dtype=cfg.accum_dtype)
            tgt_geo = eq.target_geo_fm(ttree, ts, cfg.order)
            sblocks = tblocks = None
        else:
            sblocks = (eq.barycentric_blocks(stree, ss, cfg.order)
                       if cfg.order >= 0 else eq.pairmerge_blocks(stree, ss))
            tblocks = eq.target_blocks(ttree, ts, cfg.order)
            src_fm = pp.build_fm_blocks(
                kernel, *(a.to(cfg.accum_dtype)
                          for a in (sblocks.pos, sblocks.rad, sblocks.s)))
            tgt_geo = pp.build_tgt_geo(tblocks.pos, tblocks.rad)
    tgt_inv = None
    if want_inv:
        # slot i of a real target goes to its original index; pad slots
        # to a dump entry past the end, dropped (no nonzero: no host wait)
        n = targs.n_real
        tgt_inv = torch.zeros((n + 1,), dtype=torch.int64,
                              device=tg.device).scatter_(
            0, torch.where(tg < n, tg.long(), n),
            torch.arange(tg.shape[0], device=tg.device))[:n]
    return Plan(stree=stree, ttree=ttree, src_sorted=ss, tgt_sorted=ts,
                src_blocks=sblocks, tgt_blocks=tblocks, src_gidx=sg,
                tgt_gidx=tg, src_fm=src_fm, tgt_geo=tgt_geo,
                tgt_inv=tgt_inv)


def _unscramble(u_sorted: torch.Tensor, gidx: torch.Tensor, n_real: int):
    """Scatter sorted-order outputs back to original target order,
    dropping padded slots."""
    real = gidx < n_real
    out = u_sorted.new_zeros((n_real,) + u_sorted.shape[1:])
    out[gidx[real].long()] = u_sorted[real]
    return out


def _leaf_outputs(out_blocks: torch.Tensor, plan: Plan, kernel: Kernel,
                  n_real: int):
    nleaf = plan.ttree.nleaf
    bs = plan.ttree.block_size
    leaf = out_blocks[nleaf:2 * nleaf, :bs, :].reshape(-1, kernel.od)
    if plan.tgt_inv is None:
        return _unscramble(leaf, plan.tgt_gidx, n_real)
    return leaf[plan.tgt_inv]


def _solve_proxy(kernel: Kernel, cfg: SolverConfig, plan: Plan, theta: float,
                 mac: str, timer=None):
    check_supported(cfg, kernel)
    parts = eq.n_eq_parts(plan.tgt_geo.shape[-1], cfg.order, kernel.pd)
    with phase(timer, "lists"):
        pl = lists.build_treecode_pairs(plan.stree, plan.ttree, theta, mac,
                                        cfg.frontier_width, cfg.list_width,
                                        src_parts=parts)
    out, info = pexec.exec_pairs(kernel, cfg, plan, pl, cfg.list_width,
                                 cfg.cap_groups_treecode, timer=timer)
    return _leaf_outputs(out, plan, kernel, plan.tgt_sorted.n_real), info


def solve_treecode2(kernel: Kernel, cfg: SolverConfig, plan: Plan,
                    theta: Optional[float] = None, timer=None):
    """Equivalent-particle treecode, pointwise-conservative MAC. Returns
    (outputs (n_real, OD) in the targets' original order, info)."""
    theta = cfg.theta_pointwise if theta is None else theta
    return _solve_proxy(kernel, cfg, plan, theta, "pointwise", timer)


def solve_treecode3(kernel: Kernel, cfg: SolverConfig, plan: Plan,
                    theta: Optional[float] = None, timer=None):
    """Boxwise treecode, the library API's production path
    (interface2dvort.cpp:289-293). Returns (outputs, info)."""
    theta = cfg.theta_boxwise if theta is None else theta
    return _solve_proxy(kernel, cfg, plan, theta, "boxwise", timer)


# elements per (leaves, bs, K) temporary of the monopole evaluation
_MONO_ELEMS = 1 << 24


def _monopole_eval(kernel: Kernel, tgt_pos, tgt_rad, mono_pos, mono_rad,
                   mono_str, core: str, accum_dtype=torch.float32):
    """Each leaf's targets (L, bs, PD) against its gathered monopoles
    (L, K, PD): (L, bs, OD), evaluated in accum_dtype (the inputs
    promoted, as the reference's jnp form does). Sliced over leaves so
    the (leaves, bs, K) temporaries stay bounded (leaf-independent
    math)."""
    L, bs = tgt_rad.shape
    k = mono_rad.shape[1]
    out = tgt_pos.new_empty((L, bs, kernel.od), dtype=accum_dtype)
    step = max(1, _MONO_ELEMS // (bs * max(k, 1)))
    for l0 in range(0, L, step):
        sl = slice(l0, l0 + step)
        t, tr, mp, mr, ms = (a[sl].to(accum_dtype) for a in (
            tgt_pos, tgt_rad, mono_pos, mono_rad, mono_str))
        srcT = featurize(kernel.name, mp, mr, ms, pad8=False)
        out[sl] = kernel.tile_fm(t, tr, srcT, core)
    return out


def solve_treecode1(kernel: Kernel, cfg: SolverConfig, plan: Plan,
                    theta: Optional[float] = None, timer=None):
    """Monopole treecode: far nodes as single center-of-mass
    pseudo-particles. Returns (outputs, info)."""
    check_supported(cfg, kernel)
    theta = cfg.theta_treecode1 if theta is None else theta
    stree, ttree = plan.stree, plan.ttree
    with phase(timer, "lists"):
        rows, _, ov = lists._treecode_lists(stree, ttree, theta, "treecode1",
                                            cfg.frontier_width,
                                            cfg.list_width)
    nleaf_s, nleaf_t, bs = stree.nleaf, ttree.nleaf, ttree.block_size
    with phase(timer, "monopoles"):
        # accepted interior rows are the monopoles; node 0 (zero strength
        # sums) pads. Trimmed to the widest leaf's count: one host sync
        is_interior = (rows > 0) & (rows < nleaf_s)
        mono_ids, mono_ov = lists._compact_rows(
            torch.where(is_interior, rows, 0), cfg.list_width)
        ov = ov + mono_ov
        kmax = int((mono_ids != 0).sum(1).max()) if nleaf_t else 0
        mono_ids = mono_ids[:, :max(kmax, 1)]
        far = _monopole_eval(
            kernel, plan.tgt_sorted.x.view(nleaf_t, bs, -1),
            plan.tgt_sorted.r.view(nleaf_t, bs), stree.x[mono_ids],
            stree.pr[mono_ids], stree.s[mono_ids], cfg.core_func,
            cfg.accum_dtype)
    # near: leaf-leaf direct through the pair executor
    leaf_rows = torch.where(rows >= nleaf_s, rows, 0)
    tgt = torch.arange(nleaf_t, 2 * nleaf_t, dtype=torch.int64,
                       device=rows.device)[:, None].expand_as(leaf_rows)
    pl = lists.PairList(tgt=tgt.reshape(-1), src=leaf_rows.reshape(-1),
                        n_valid=(leaf_rows != 0).sum(), overflow=ov)
    out, info = pexec.exec_pairs(kernel, cfg, plan, pl, cfg.list_width,
                                 cfg.cap_groups_treecode, timer=timer)
    out = out.clone()
    out[nleaf_t:2 * nleaf_t, :bs] += far
    return _leaf_outputs(out, plan, kernel, plan.tgt_sorted.n_real), info
