"""Subtree-chunked DTT solve (port of onbody_tpu/traverse/chunked.py):
the routine bench.py runs for N >= 4e7.

The owner-major subtree decomposition of parallel/mesh.py, walked one
subtree after another on one device: the lean feature-major source
array stays resident while the target geometry, the interaction lists,
the pair execution and the downward prolongation are made one
level-`split` target subtree at a time. Peak memory is

    src_fm (lean rows, 2*n_pad slots) + sorted target particles
    + the output leaves + ONE subtree's geometry, lists, groups and
      accumulator (about 1/n_chunks of the monolithic plan's)

The top target levels (< split) are descended once (lists._dtt_lists_top);
every subtree re-executes the few top-level pairs, so its replicated top
rows carry the partial sums its downward pass reads.

Each subtree step (_chunk_step) drops its buffers when it returns; with
profile=True the solve prints, after each phase and subtree, its time and
the device memory in use and the phase's peak (torch.cuda.
max_memory_allocated, reset after each line; the reference prints its
HBM statistics there).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import SolverConfig, check_supported
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.parallel.mesh import (_downward_local,
                                            _exec_groups_slab,
                                            _resolve_shard_backend,
                                            local_rows)
from onbody_tpu_torch.parts import Parts
from onbody_tpu_torch.traverse import lists
from onbody_tpu_torch.traverse.exec import _trim
from onbody_tpu_torch.traverse.treecode import _unscramble
from onbody_tpu_torch.tree import build as tree_build
from onbody_tpu_torch.tree import equivalents as eq


def _chunk_step(kernel: Kernel, cfg: SolverConfig, stree, ttree, ts, src_fm,
                out_leaf, cand_row, root: int, c: int, loc, glob_c, top_t,
                top_s, theta: float, levels_s: int, levels_t: int,
                split: int, cap: int, backend: str, use_p2: bool = False):
    """One target subtree: lists -> groups -> pair execution -> downward
    -> its leaves written into out_leaf (in place). Returns (out_leaf,
    n_valid, overflow) of the subtree's own lists.

    use_p2: sibling-paired leaf execution (cfg.dtt_leaf_pair2). The leaf
    pairs come parent-keyed from the sub builder and run through the
    paired executor (K9 for 'pregather', K2 for the dma family), whose
    key k covers slab rows 2k and 2k+1. The children of the subtree's
    i-th leaf parent sit at local rows leaf0_loc + 2i, and leaf0_loc =
    2^split + 2^(levels_t - split) - 1 is odd for every split >= 1, so
    the paired pass runs on the views geo[1:] and out_fm[1:]: key k
    there covers slab rows 2k + 1 and 2k + 2. The groups are trimmed, so
    no pad key (0, slab rows 1-2: top rows that the downward pass reads)
    reaches the executor; the paired kernels and twins leave rows 0/1 of
    the accumulator they are given untouched besides."""
    bs = ttree.block_size
    pd = kernel.pd
    W = cfg.frontier_width
    g = cfg.pair_group
    wleaf = 1 << (levels_t - split)
    n_chunks = 1 << split
    leaf0_loc = n_chunks + wleaf - 1

    sub_t, sub_s, *p2, nv, ovc = lists._dtt_lists_sub(
        stree, ttree, theta, cand_row, root, levels_s, levels_t, split, W,
        cfg.mac_geometry, leaf_pair2=use_p2)
    pl = lists.PairList(tgt=torch.cat([top_t, loc[sub_t]]),
                        src=torch.cat([top_s, sub_s]), n_valid=nv,
                        overflow=torch.zeros_like(ovc))
    pg = lists.group_pairs(pl, cap, g, W)
    del sub_t, sub_s, pl
    ovc = ovc + pg.overflow
    pg = _trim(pg)

    geo = eq.target_geo_slab(ttree, ts, root, cfg.order, split)
    out_fm = pp._zeros_fm(kernel, geo)
    _exec_groups_slab(kernel, cfg, geo, src_fm, pg.tgt, pg.src, out_fm,
                      backend)
    del pg
    if use_p2:
        p2t, p2s = p2
        pl2 = lists.PairList(tgt=p2t, src=p2s, n_valid=(p2s != 0).sum(),
                             overflow=torch.zeros_like(ovc))
        del p2, p2t, p2s
        pg2 = lists.group_pairs(pl2, max(256, cap // 2), g, W)
        ovc = ovc + pg2.overflow
        pg2 = _trim(pg2)
        # the i-th leaf parent of this subtree -> key k with 2k == its
        # first child's local row (shifted by one row when that is odd)
        parent0 = root << (levels_t - 1 - split)
        keys = torch.where(pg2.tgt != 0,
                           pg2.tgt - parent0 + (leaf0_loc >> 1), 0)
        shift = leaf0_loc % 2
        pp.exec_pairs_t2(kernel, geo[shift:], src_fm, keys, pg2.src,
                         out_fm[shift:], cfg.core_func, fetch=cfg.pair_fetch,
                         twin=backend == "torch")
        del pl2, pg2, keys
    out = out_fm[:, :kernel.od, :].transpose(1, 2)
    _downward_local(out, ttree.nc[glob_c], ttree.ns[glob_c],
                    geo[:, :pd, :].transpose(1, 2), cfg.order, levels_t,
                    split, bs, c)
    out_leaf[c * wleaf * bs:(c + 1) * wleaf * bs] = (
        out[leaf0_loc:leaf0_loc + wleaf, :bs, :].reshape(wleaf * bs,
                                                         kernel.od))
    return out_leaf, nv, ovc


def solve_dtt_chunked(kernel: Kernel, cfg: SolverConfig,
                      srcs: Optional[Parts] = None,
                      targs: Optional[Parts] = None, n_chunks: int = 8,
                      theta: Optional[float] = None,
                      make_problem=None, make_srcs=None,
                      make_targs=None, unscramble: bool = True,
                      profile: bool = False):
    """Full DTT evaluation with the target subtrees processed one after
    another. Returns (out (n_real, OD), info), or ((out_leaf in tree
    order (nleaf * B, OD), tgt_gidx), info) with unscramble=False (the
    reference drivers' convention; map rows through tgt_gidx); info is a
    PairList with n_valid and overflow and empty tgt/src.

    Requires order >= 0 (the lean barycentric path), one equivalent row
    per node, fp32 accumulation and 2^split < nleaf_t; raises ValueError
    otherwise. Runs on the device of the particles: CUDA tensors launch
    the kernels of cfg.pair_fetch (K8/K9 for 'pregather', K1/K2 for
    'dma_i', ...) or raise; CPU tensors run their twins.

    make_problem: zero-argument callable returning (srcs, targs);
    make_srcs / make_targs: one per side, called in the order the trees
    are built (targets first), so only one side's originals exist at a
    time. The solver drops its references to the originals after each
    build; passing srcs/targs directly keeps the caller's alive.

    The sibling-paired leaf pass runs on either backend (the port's
    executors have a paired form for every fetch but 'static', as
    dtt.solve_dtt gates it; the reference runs it on 'pallas' only).
    Dead subtree roots (padding only) are skipped, one host read per
    solve; their output rows stay zero. profile=True prints each phase's
    and subtree's time, the device memory in use after it and its peak
    (which resets the card's peak statistic as it goes)."""
    check_supported(cfg, kernel)
    if cfg.order < 0:
        raise ValueError("solve_dtt_chunked uses the lean barycentric path: "
                         f"order must be >= 0, got {cfg.order}")
    if eq.n_eq_parts(cfg.block_size, cfg.order, kernel.pd) != 1:
        raise ValueError("solve_dtt_chunked does not support split "
                         f"equivalent rows: order {cfg.order} grids exceed "
                         f"the block of {cfg.block_size}")
    if cfg.accum_dtype != torch.float32:
        raise ValueError("solve_dtt_chunked runs the fp32 executors: the "
                         "accuracy tier (accum_dtype float64) takes "
                         "prepare + solve_dtt")
    split = n_chunks.bit_length() - 1
    if n_chunks < 1 or 1 << split != n_chunks:
        raise ValueError(f"n_chunks {n_chunks} must be a power of two")
    theta = cfg.theta_dtt if theta is None else theta
    t_last = [time.perf_counter()]

    def _ph(label: str, dev: torch.device):
        if not profile:
            return
        mem = ""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            mem = (f"  device {torch.cuda.memory_allocated(dev) / 2**30:5.2f}"
                   f" GiB (phase peak "
                   f"{torch.cuda.max_memory_allocated(dev) / 2**30:5.2f})")
            torch.cuda.reset_peak_memory_stats(dev)
        now = time.perf_counter()
        print(f"[chunked] {label:14s} {now - t_last[0]:7.3f} s{mem}",
              flush=True)
        t_last[0] = now

    if make_problem is not None:
        if srcs is not None or targs is not None:
            raise ValueError("make_problem replaces srcs and targs")
        srcs, targs = make_problem()
    if make_targs is not None:
        if targs is not None:
            raise ValueError("make_targs replaces targs")
        targs = make_targs()
    build_kw = dict(block_size=cfg.block_size, mode=cfg.tree_mode,
                    span=cfg.tree_span, span_top=cfg.tree_span_top,
                    span_bot=cfg.tree_span_bot)
    # the target tree first, then the sources, then the top lists, then
    # the featurize: each phase's temporaries die before the next
    # phase's large arrays exist (reference chunked.py:215-275)
    n_tgt_real = targs.n_real
    ttree, ts, tg = tree_build.build_tree(
        P.astype(targs, cfg.storage_dtype), need_r=kernel.uses_tr,
        **build_kw)
    targs = None
    dev = ts.x.device
    _ph("tgt tree", dev)
    levels_t = ttree.levels
    if levels_t <= split:
        raise ValueError(f"{n_chunks} chunks need more target leaves than "
                         f"chunks ({ttree.nleaf} leaves)")

    if make_srcs is not None:
        if srcs is not None:
            raise ValueError("make_srcs replaces srcs")
        srcs = make_srcs()
    stree, ss, _ = tree_build.build_tree(P.astype(srcs, cfg.storage_dtype),
                                         **build_kw)
    srcs = None
    _ph("src tree", dev)
    bs = ttree.block_size
    nleaf = ttree.nleaf

    top_t, top_s, cand_roots, ov_top = lists._dtt_lists_top(
        stree, ttree, theta, stree.levels, split, cfg.frontier_width,
        cfg.mac_geometry)
    _ph("lists_top", dev)

    # the lean rows for 'pregather' (K8/K9 read them at any stride), the
    # rows padded to 8 for the dma family, as treecode.prepare stores them
    src_fm = eq.barycentric_fm(stree, ss, cfg.order, kernel.name,
                               pad8=cfg.pair_fetch.startswith("dma"))
    ss = None
    _ph("featurize", dev)
    glob_all, local = local_rows(levels_t, n_chunks)
    loc = torch.from_numpy(local).to(dev, torch.int64)
    glob_all = torch.from_numpy(glob_all).to(dev, torch.int64)
    # static group capacity per subtree (overflow-checked)
    rows_chunk = (2 << (levels_t - split)) - 1 + n_chunks
    cap = max(1024, rows_chunk * (cfg.cap_groups_dtt * 8 // cfg.pair_group))

    out_leaf = torch.zeros((nleaf * bs, kernel.od), dtype=cfg.accum_dtype,
                           device=dev)
    total_valid = (top_s != 0).sum()
    overflow = ov_top
    backend = _resolve_shard_backend(cfg)
    # subtree roots holding only padding produce nothing: skip them (one
    # host read); their output rows stay zero, the masked result
    alive_roots = ttree.alive[n_chunks:2 * n_chunks].tolist()
    use_p2 = (cfg.dtt_leaf_pair2 and cfg.pair_fetch != "static"
              and stree.levels <= levels_t)
    for c in range(n_chunks):
        if not alive_roots[c]:
            continue
        out_leaf, nv, ovc = _chunk_step(
            kernel, cfg, stree, ttree, ts, src_fm, out_leaf,
            cand_roots[c:c + 1], n_chunks + c, c, loc, glob_all[c], top_t,
            top_s, theta, stree.levels, levels_t, split, cap, backend,
            use_p2=use_p2)
        total_valid = total_valid + nv
        overflow = overflow + ovc
        _ph(f"chunk {c}", dev)

    ts = None
    info = lists.PairList(tgt=top_t.new_zeros((0,)),
                          src=top_t.new_zeros((0,)), n_valid=total_valid,
                          overflow=overflow)
    if not unscramble:
        return (out_leaf, tg), info
    return _unscramble(out_leaf, tg, n_tgt_real), info
