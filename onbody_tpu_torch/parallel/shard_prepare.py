"""Fully sharded prepare + DTT solve over torch.distributed (port of
onbody_tpu/parallel/shard_prepare.py): memory scale-out over the ranks.

parallel/mesh.py shards the SOLVE of a plan every rank prepared whole;
this module builds everything rank-local from batch shards of the
particles:

  1. TOP SPLIT (`_top_split`): the top log2(D) k-d levels as exact
     count-based median splits on u16 codes of the global box (MIN/MAX
     all_reduces): tree/hsplit.py's per-node histograms summed over the
     ranks (int64 all_reduce) and its tie quotas over the ranks' tie
     counts gathered in rank order, so every rank plans the planes,
     axes and quotas that hsplit.run_top_split plans on the whole input
     (each rank's shard one hsplit chunk). No particle moves; only count
     arrays do.
  2. EXCHANGE (`_split_exchange_fn`): each rank stable-sorts its shard by
     owner into fixed cap_b-row buckets and all_to_all_single's them;
     received rows are compacted valid-first (in global input order) into
     the owner's slab of n_pad / D slots; bucket overflow is counted. The
     original ids travel as int64 (the reference carries them as float32,
     exact only to 2^24).
  3. LOCAL BUILD: each rank builds its subtree at the fixed shape
     (levels - split, n_pad / D) in median mode (as the capacity tiers
     do) and featurizes its source rows.
  4. TOP ASSEMBLY (`_assemble_global_tree`): the local trees' node rows
     all_gather'ed (~11 numbers a node), finishTree's weighted merges of
     the levels above the split, and the top source proxies continued
     from the gathered subtree-root grids (equivalents.top_proxies, row
     0 the inert row: the reference leaves it all zero).
  5. LISTS + EXEC: the replicated top lists plus the rank's own subtree
     lists against the gathered geometry, bucketed by source owner into
     ring stages; the locally built source slabs pass around the ring
     (batch_isend_irecv) through the executors of cfg.pair_fetch;
     downward pass and leaf extraction stay local.

No rank holds a global (NN, C, B) array: particle shards, source slabs,
target slabs, lists and outputs are 1/D-sized, but for the result, which
every rank returns whole in the original order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from onbody_tpu_torch.config import SolverConfig, check_supported
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel, featurize, pad_fm_rows
from onbody_tpu_torch.parallel.mesh import (Mesh, _all_gather,
                                            _downward_local,
                                            _exec_groups_slab, _node_level,
                                            _ring_shift,
                                            _resolve_shard_backend,
                                            local_rows)
from onbody_tpu_torch.parts import Parts
from onbody_tpu_torch.traverse import lists
from onbody_tpu_torch.traverse.exec import _trim
from onbody_tpu_torch.tree import build as tree_build
from onbody_tpu_torch.tree import equivalents as eq
from onbody_tpu_torch.tree import hsplit
from onbody_tpu_torch.tree.build import TREE_FIELDS, Tree
from onbody_tpu_torch.utils.timing import phase

_NB = hsplit._NB


# ----------------------------------------------------------- stage 1+2

def _global_box(mesh: Mesh, x: torch.Tensor):
    """(lo, hi) of every rank's x, as float32 numpy (pd,)."""
    lo, hi = x.amin(dim=0), x.amax(dim=0)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    return lo.cpu().numpy(), hi.cpu().numpy()


def _top_split(mesh: Mesh, codes: torch.Tensor, split: int, n_slots: int,
               virtual_pad_slots: int, box_lo: np.ndarray,
               box_hi: np.ndarray):
    """hsplit.run_top_split with this rank's shard as its chunk `rank`:
    the histograms summed over the ranks, the tie counts gathered in rank
    order. Returns (nid (m,) int32 owner of each particle, planes_all,
    axes_all, quotas_all (this rank's per level))."""
    dev = codes.device
    pd = codes.shape[1]
    nid = torch.zeros((codes.shape[0],), dtype=torch.int32, device=dev)
    blo = np.zeros((1, pd))
    bhi = np.full((1, pd), 65535.0)
    pads = np.array([virtual_pad_slots], np.int64)
    planes_all, axes_all, quotas_all = [], [], []
    for l in range(split):
        nnode = 1 << l
        axes = hsplit.level_axes(blo, bhi, box_lo, box_hi)
        axes_t = torch.from_numpy(axes).to(dev, torch.int64)
        h = hsplit.chunk_hist(codes, nid, axes_t, nnode)
        dist.all_reduce(h, group=mesh.group)
        hist = h.cpu().numpy()
        hist[:, _NB - 1] += pads                       # virtual pads
        target = n_slots // (2 * nnode)
        planes, need = hsplit.plan_level(hist, target)
        planes_t = torch.from_numpy(planes).to(dev)
        ties = [t.cpu().numpy() for t in _all_gather(
            mesh, hsplit.chunk_tie_counts(codes, nid, axes_t, planes_t))]
        quota = hsplit.tie_quotas(ties, need)[mesh.rank]
        nid = hsplit.chunk_assign(codes, nid, axes_t, planes_t,
                                  torch.from_numpy(quota).to(dev))
        pads = hsplit.child_pads(hist, planes, need, ties, pads, target)
        blo, bhi = hsplit.child_boxes(blo, bhi, axes, planes)
        planes_all.append(planes)
        axes_all.append(axes)
        quotas_all.append(quota)
    return nid, planes_all, axes_all, quotas_all


def _split_exchange_fn(mesh: Mesh, x, r, s, oid, split: int, n_total: int,
                       n_pad: int, cap_b: int, timer=None):
    """Top split + all_to_all exchange of ONE side (reference
    _split_exchange_fn), on every rank of the mesh.

    x (m, pd), r (m,), s (m, sd) or None, oid (m,) int64 original global
    ids: this rank's batch shard; n_total the particles over all ranks,
    n_pad the padded slots of the global tree. Returns (x, r, s, orig,
    count, overflow) of the rank's subtree: its count real particles in
    global input order (orig their int64 ids), count <= n_pad / D, and
    the particles that did not fit a cap_b bucket or the slab. timer:
    phases "split" and "exchange"."""
    n_sub = n_pad // mesh.size
    with phase(timer, "split"):
        lo, hi = _global_box(mesh, x)
        codes = hsplit.box_codes(x, lo, hi)
        nid = _top_split(mesh, codes, split, n_pad, n_pad - n_total, lo,
                         hi)[0]
    with phase(timer, "exchange"):
        return _exchange(mesh, x, r, s, oid, nid, n_sub, cap_b)


def _exchange(mesh: Mesh, x, r, s, oid, nid, n_sub: int, cap_b: int):
    """_split_exchange_fn's all_to_all: this rank's particles to their
    owners nid, cap_b rows an owner."""
    ndev = mesh.size
    m, pd = x.shape
    cols = [x, r[:, None]] + ([s] if s is not None else [])
    payload = torch.cat(cols, dim=1)
    k = payload.shape[1]
    snid, sidx = torch.sort(nid.long(), stable=True)
    cnt = torch.bincount(snid, minlength=ndev)
    starts = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(m, device=x.device) - starts[snid]
    overflow = int((cnt - cap_b).clamp(min=0).sum())
    slot = torch.where(rank < cap_b, snid * cap_b + rank, ndev * cap_b)
    buf = payload.new_zeros((ndev * cap_b + 1, k))
    buf[slot] = payload[sidx]
    ids = oid.new_full((ndev * cap_b + 1,), -1)      # -1: an empty slot
    ids[slot] = oid[sidx]
    # dim 0 indexes the destination, cap_b rows each
    recv = torch.empty_like(buf[:-1])
    dist.all_to_all_single(recv, buf[:-1].contiguous(), group=mesh.group)
    rids = torch.empty_like(ids[:-1])
    dist.all_to_all_single(rids, ids[:-1].contiguous(), group=mesh.group)

    # valid-first compaction into the n_sub-slot slab, in rank order
    valid = rids >= 0
    count = int(valid.sum())
    overflow += max(count - n_sub, 0)
    slab = recv[valid][:n_sub]
    orig = rids[valid][:n_sub]
    xs = slab[:, :pd].contiguous()
    rs = slab[:, pd].contiguous()
    ss = slab[:, pd + 1:].contiguous() if s is not None else None
    return xs, rs, ss, orig, min(count, n_sub), overflow


# ------------------------------------------------------------- stage 3-4

def _dead_tree(levels: int, bs: int, pd: int, sd: int, dtype, dev) -> Tree:
    """A subtree holding only padding: every node dead (the global
    assembly puts dead nodes at the far point)."""
    nn = 2 << levels

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return Tree(nc=z(nn, pd), ns=z(nn, pd), nr=z(nn), x=z(nn, pd),
                s=z(nn, max(sd, 1)), pr=z(nn),
                alive=torch.zeros((nn,), dtype=torch.bool, device=dev),
                levels=levels, block_size=bs)


def _assemble_global_tree(mesh: Mesh, tree_l: Tree, w_root: torch.Tensor,
                          split: int, levels_glob: int) -> Tree:
    """The replicated global tree (reference _assemble_global_tree): the
    local trees' node rows gathered in rank order fill levels >= split
    (owner d's level-lam nodes are global [2^(split+lam) + d 2^lam, ...)),
    the levels above are finishTree's weighted merges of the subtree
    roots (tree/build.py merge_top_levels, weights w_root gathered), and
    every dead node sits at the far point past the root box."""
    ndev = mesh.size
    levels_loc = levels_glob - split
    nn = 2 << levels_glob
    arr = {}
    for f in TREE_FIELDS:
        loc = getattr(tree_l, f)
        # (D, NN_loc - 1, ...); the alive flags travel as bytes
        rows = torch.stack(_all_gather(mesh, loc[1:].to(torch.uint8)
                                       if f == "alive" else loc[1:]))
        rows = rows.to(loc.dtype)
        a = loc.new_zeros((nn,) + loc.shape[1:])
        for lam in range(levels_loc + 1):
            w = 1 << lam
            a[1 << (split + lam):2 << (split + lam)] = rows[
                :, w - 1:2 * w - 1].reshape((ndev * w,) + loc.shape[1:])
        arr[f] = a
    w_roots = torch.stack(_all_gather(mesh, w_root.reshape(1)))[:, 0]
    tree_build.merge_top_levels(arr, w_roots, split)
    lo = arr["nc"][1] - 0.5 * arr["ns"][1]
    hi = arr["nc"][1] + 0.5 * arr["ns"][1]
    fp = hi + 8.0 * (hi - lo).max() + 1.0
    dead = ~arr["alive"]
    dead[0] = True
    arr["nc"][dead] = fp
    arr["x"][dead] = fp
    arr["ns"][dead] = 0.0
    arr["nr"][dead] = 0.0
    return Tree(**arr, levels=levels_glob, block_size=tree_l.block_size)


# --------------------------------------------------------------- driver

def prepare_and_solve_sharded(kernel: Kernel, cfg: SolverConfig, mesh: Mesh,
                              srcs: Parts, targs: Parts,
                              theta: Optional[float] = None, timer=None):
    """Fully sharded prepare + DTT solve, called by every rank with the
    same srcs / targs (n particles each on the mesh's device; rank d
    takes batch rows [d n/D, (d+1) n/D)). Returns (out (n, OD) in the
    original order, overflow summed over the ranks), the same on every
    rank. Each rank sends an owner at most 2.2 n / D^2 rows (at least
    256, the reference's bucket). timer: a utils.timing.PhaseTimer that
    receives the phases split, exchange, builds, top assembly, lists,
    exec (the ring), downward, gather.

    Needs order >= 0, one equivalent row per node, fp32 accumulation,
    equal source and target counts, n divisible by D and a global tree
    deeper than split + 1; raises ValueError otherwise."""
    check_supported(cfg, kernel)
    theta = cfg.theta_dtt if theta is None else theta
    ndev = mesh.size
    split = ndev.bit_length() - 1
    bs = cfg.block_size
    pd, sd, od = kernel.pd, kernel.sd, kernel.od
    order = cfg.order
    n = srcs.n_real
    if 1 << split != ndev:
        raise ValueError(f"{ndev} ranks: a power of two")
    if order < 0 or eq.n_eq_parts(bs, order, pd) != 1:
        raise ValueError("prepare_and_solve_sharded runs the barycentric "
                         "path with one equivalent row per node: order "
                         f"{order} at block {bs}")
    if cfg.accum_dtype != torch.float32:
        raise ValueError("prepare_and_solve_sharded runs fp32 "
                         "accumulation")
    if targs.n_real != n or n % ndev:
        raise ValueError(f"equal source and target counts divisible by "
                         f"{ndev}: got {n} and {targs.n_real}")
    if srcs.x.device != mesh.device or targs.x.device != mesh.device:
        raise ValueError(f"the particles must be on the mesh's device "
                         f"{mesh.device}")
    levels_glob, n_pad = tree_build.plan(n, bs)
    if levels_glob <= split + 1:
        raise ValueError(f"{ndev} ranks need a tree deeper than "
                         f"{split + 1} levels, got {levels_glob}")
    levels_loc = levels_glob - split
    n_sub = n_pad // ndev
    d = mesh.rank
    dev = mesh.device
    m = n // ndev
    rows = slice(d * m, (d + 1) * m)
    cap_b = max(256, int(2.2 * n // (ndev * ndev)))
    pad8 = cfg.pair_fetch.startswith("dma")

    def exchange(p: Parts, with_s: bool):
        oid = torch.arange(d * m, (d + 1) * m, device=dev)
        return _split_exchange_fn(
            mesh, p.x[rows].float(), p.r[rows].float(),
            p.s[rows].float() if with_s else None, oid, split, n, n_pad,
            cap_b, timer)

    sx, sr, ss, _, s_cnt, s_ov = exchange(srcs, True)
    tx, tr, _, torig, t_cnt, t_ov = exchange(targs, False)

    # ---- local builds at the fixed subtree shape (median mode)
    def build(x, r, s, count, need_r):
        if count == 0:
            z = x.new_zeros
            sp = Parts(x=z((n_sub, pd)), r=z((n_sub,)),
                       s=z((n_sub, sd)) if s is not None else None,
                       n_real=0)
            return (_dead_tree(levels_loc, bs, pd, sd if s is not None
                               else 0, x.dtype, dev), sp,
                    torch.arange(n_sub, 2 * n_sub, device=dev))
        return tree_build.build_tree(Parts(x=x, r=r, s=s, n_real=count), bs,
                                     need_r=need_r,
                                     force_plan=(levels_loc, n_sub))

    with phase(timer, "builds"):
        stree_l, ssp, _ = build(sx, sr, ss, s_cnt, True)
        ttree_l, tsp, tgl = build(tx, tr, None, t_cnt, kernel.uses_tr)
        M = (order + 1) ** pd
        if s_cnt:
            fm_loc, rg, re = eq.barycentric_fm(stree_l, ssp, order,
                                               kernel.name, pad8=pad8,
                                               return_root=True)
            w_s = (ssp.s.abs().sum() if sd == 1
                   else ssp.s.square().sum(1).sqrt().sum())
            rfirst = ssp.r[0]
        else:
            # a subtree of padding only: the inert row everywhere
            inert = featurize(kernel.name, sx.new_zeros((1, bs, pd)),
                              sx.new_ones((1, bs)),
                              sx.new_zeros((1, bs, sd)), pad8)
            fm_loc = inert.expand(2 << levels_loc, -1, -1).contiguous()
            rg, re = sx.new_zeros((M, pd)), sx.new_zeros((M, sd))
            w_s, rfirst = sx.new_zeros(()), sx.new_full((), 1e-3)

    with phase(timer, "top assembly"):
        stree_g = _assemble_global_tree(mesh, stree_l, w_s.float(), split,
                                        levels_glob)
        ttree_g = _assemble_global_tree(
            mesh, ttree_l, torch.tensor(float(t_cnt), device=dev), split,
            levels_glob)
        # top source rows: the upward pass continued from the gathered
        # subtree-root grids, row 0 the inert row
        top_fm = eq.top_proxies(
            stree_g.nc, stree_g.ns, torch.stack(_all_gather(mesh, rg)),
            torch.stack(_all_gather(mesh, re)),
            torch.stack(_all_gather(mesh, rfirst.reshape(1)))[:, 0],
            order, bs, kernel.name)
        if pad8:
            top_fm = pad_fm_rows(kernel.name, top_fm)
        sfm_slab = torch.cat([top_fm, fm_loc[1:]])
        del fm_loc

    W = cfg.frontier_width
    g = cfg.pair_group
    with phase(timer, "lists"):
        top_t, top_s, cand_roots, ov_top = lists._dtt_lists_top(
            stree_g, ttree_g, theta, levels_glob, split, W,
            cfg.mac_geometry)
        root = ndev + d
        sub_t, sub_s, _, ov_sub = lists._dtt_lists_sub(
            stree_g, ttree_g, theta, cand_roots[d:d + 1], root, levels_glob,
            levels_glob, split, W, cfg.mac_geometry)
        glob_all, local = local_rows(levels_glob, ndev)
        loc = torch.from_numpy(local.astype(np.int64)).to(dev)
        tl = torch.cat([top_t, loc[sub_t]])
        sl = torch.cat([top_s, sub_s])
        del sub_t, sub_s
        # each source row's ring stage: top rows (< D) are in every slab
        # (stage 0), the others their level-split ancestor's owner's
        lev = _node_level(sl)
        owner = torch.where(sl < ndev, d,
                            (sl >> (lev - split).clamp(min=0)) - ndev)
        stage = torch.where(sl != 0, (owner - d) % ndev, 0)
        src_loc = torch.where(sl < ndev, sl, loc[sl])
        tgeo = eq._target_geo_slab_impl(ttree_g, tsp.x, tsp.r, root, order,
                                        levels_glob, split, bs,
                                        x_base=d * n_sub)

    rows_dev = ndev + (2 << levels_loc) - 1
    cap_groups = max(1024, rows_dev * (cfg.cap_groups_dtt * 8 // g))
    ov_g = 0
    backend = _resolve_shard_backend(cfg)
    out_fm = pp._zeros_fm(kernel, tgeo)
    buf = sfm_slab
    with phase(timer, "exec"):
        for k in range(ndev):
            sel = (stage == k) & (sl != 0)
            # mask only the sources: group_pairs reads each G-chunk's
            # target from its first slot (every W-run shares one target)
            pl_k = lists.PairList(tgt=tl, src=torch.where(sel, src_loc, 0),
                                  n_valid=sel.sum(),
                                  overflow=torch.zeros_like(ov_top))
            pg = lists.group_pairs(pl_k, cap_groups, g, W)
            ov_g += int(pg.overflow)
            pg = _trim(pg)
            _exec_groups_slab(kernel, cfg, tgeo, buf, pg.tgt, pg.src,
                              out_fm, backend)
            if k + 1 < ndev:
                buf = _ring_shift(mesh, buf)
    del buf, sfm_slab

    with phase(timer, "downward"):
        out = out_fm[:, :od, :].transpose(1, 2)
        glob_d = torch.from_numpy(glob_all[d].astype(np.int64)).to(dev)
        _downward_local(out, ttree_g.nc[glob_d], ttree_g.ns[glob_d],
                        tgeo[:, :pd, :].transpose(1, 2), order, levels_glob,
                        split, bs, d)
        wleaf = 1 << levels_loc
        leaf0 = ndev + wleaf - 1
        leaf = out[leaf0:leaf0 + wleaf, :bs, :].reshape(n_sub, od)

    with phase(timer, "gather"):
        # each sorted slot's original id (n for pads), gathered with the
        # leaves; every rank scatters the whole result
        real = tgl < t_cnt
        dest = torch.full((n_sub,), n, dtype=torch.int64, device=dev)
        dest[real] = torig[tgl[real]]
        dest = torch.cat(_all_gather(mesh, dest))
        leaf = torch.cat(_all_gather(mesh, leaf))
        res = leaf.new_zeros((n + 1, od))
        res[dest] = leaf
        ovt = torch.tensor([s_ov + t_ov + ov_g], device=dev) + ov_top + ov_sub
        dist.all_reduce(ovt, group=mesh.group)
    return res[:n], int(ovt)
