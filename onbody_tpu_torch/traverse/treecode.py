"""Solve setup shared by the fast methods (port of the plan part of
onbody_tpu/traverse/treecode.py). The treecode solvers themselves are
not ported yet (ROADMAP item 10)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import SolverConfig, check_supported
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.parts import Parts
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
    src_blocks: eq.Blocks
    tgt_blocks: eq.Blocks
    src_gidx: torch.Tensor
    tgt_gidx: torch.Tensor
    src_fm: torch.Tensor             # (NN, C, B) feature-major sources
    tgt_geo: torch.Tensor            # (NN, 8, B) [pos | radius | 0]
    tgt_inv: Optional[torch.Tensor]  # original target index -> slot


def prepare(kernel: Kernel, cfg: SolverConfig, srcs: Parts, targs: Parts,
            want_inv: bool = True, timer=None) -> Plan:
    """Build both trees and the unified block arrays (the reference
    times this as 'build tree' + 'calc equivalents'). want_inv=False
    skips the inverse target permutation (results stay in tree order)."""
    check_supported(cfg, kernel)
    srcs = P.astype(srcs, cfg.storage_dtype)
    targs = P.astype(targs, cfg.storage_dtype)
    kw = dict(block_size=cfg.block_size, mode=cfg.tree_mode,
              span=cfg.tree_span, span_top=cfg.tree_span_top,
              span_bot=cfg.tree_span_bot)
    with phase(timer, "tree"):
        stree, ss, sg = tree_build.build_tree(srcs, **kw)
        # kernels that ignore target radii get zero radii (reference
        # build need_r)
        ttree, ts, tg = tree_build.build_tree(targs, need_r=kernel.uses_tr,
                                              **kw)
    with phase(timer, "equivalents"):
        sblocks = eq.barycentric_blocks(stree, ss, cfg.order)
        tblocks = eq.target_blocks(ttree, ts, cfg.order)
        src_fm = pp.build_fm_blocks(kernel, sblocks.pos, sblocks.rad,
                                    sblocks.s)
        tgt_geo = pp.build_tgt_geo(tblocks.pos, tblocks.rad)
    tgt_inv = None
    if want_inv:
        real = tg < targs.n_real
        tgt_inv = torch.zeros((targs.n_real,), dtype=torch.int64,
                              device=tg.device)
        tgt_inv[tg[real].long()] = torch.nonzero(real).squeeze(1)
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
