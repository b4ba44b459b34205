"""Owner-major subtree decomposition and the multi-device solves over
torch.distributed (port of onbody_tpu/parallel/mesh.py).

The reference decomposes the target tree owner-major: with D = 2^split
owners, owner d holds the subtree rooted at node D + d, and every
per-node array is stored as a slab of R rows,

    rows [0, D)   the global top nodes 0..D-1 (row 0 the inert dummy,
                  rows 1..D-1 the levels above the split), replicated;
    rows [D, R)   the nodes of d's subtree, level-contiguous (level
                  l >= split contributes 2^(l - split) rows),

R = D + 2^(levels - split + 1) - 1. Pair lists are bucketed by owner
with target ids rewritten to local rows; the top-level pairs go into
every bucket, so the replicated top rows stay consistent without any
cross-device sum.

One device: the subtree-chunked solve (traverse/chunked.py) and the
capacity tiers walk the owners one after another with `local_rows`,
`_downward_local` and `_exec_groups_slab`.

Several devices: a `Mesh` over an initialized torch.distributed process
group, one rank an owner (make_mesh; make_mesh_2level's slice-major
ranks). Every solve is one SPMD function that every rank calls with the
same plan (each rank prepares it from the same inputs, as the
reference's single controller holds it); `dist.get_rank` plays
`axis_index`. Each rank executes its own slab's pairs through the port's
executors (`pair_fetch` picks K1, K8 + its reduction, K10, K11 or K12,
as on one device), runs the downward pass on its slab, and the leaf rows
are gathered in rank order, so every rank returns the full result in the
targets' original order and the (replicated) pair list with its
overflow:

  * solve_dtt_sharded: every source row read from the plan (the
    reference all-gathers its sharded source rows here; the port's
    ranks already hold them);
  * solve_dtt_sharded_stream: each rank starts from its owner's source
    slab and passes it around the ring with batch_isend_irecv (rank d
    sends to d - 1, so at stage k it holds the slab of owner
    (d + k) % D); the pairs are bucketed by (owner, ring stage) on the
    device (partition_groups_device);
  * solve_treecode3_sharded: exec_pairs_sharded on host-bucketed pairs
    (partition_pairs), each rank featurizing its share of the source
    blocks, the full (NN, B, OD) array gathered back.

These three take a plan that every rank holds whole, so they split the
work but not the memory: the stream solve's ring carries slabs that a
rank could slice from its own plan. It mirrors the reference's data
flow, and prepare_and_solve_sharded (parallel/shard_prepare.py) runs
the same ring on slabs that only their owner built, where each rank
holds its own subtrees and the replicated top.

A CUDA mesh takes the NCCL backend, a CPU mesh gloo; a mesh refuses the
other pairing (parallel/launch.py starts ranks either way).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from onbody_tpu_torch.config import SolverConfig, check_supported, pair_backend
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.traverse import lists
from onbody_tpu_torch.traverse.treecode import Plan, _unscramble
from onbody_tpu_torch.tree import equivalents as eq
from onbody_tpu_torch.utils.device import resolve


# ------------------------------------------------------------------ mesh

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one torch.distributed process group as the
    reference's device mesh: `size` owners in flat rank order, this
    process `rank`, its tensors on `device`. axis_names / shape are the
    reference mesh's (("tgt",), (D,)) or (("dcn", "ici"), (slices,
    chips)); the solves use the flat rank order either way."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], group,
          device) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed process group; "
                           "init_process_group first (parallel/launch.py "
                           "run_ranks starts ranks with one)")
    size = dist.get_world_size(group)
    want = int(np.prod(shape))
    if want != size:
        raise ValueError(f"a mesh of {shape} needs {want} ranks; the "
                         f"process group has {size}")
    dev = resolve(device, "onbody_tpu_torch.parallel.mesh")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend(group)
    need = "nccl" if dev.type == "cuda" else "gloo"
    if backend != need:
        raise ValueError(f"a mesh on {dev} runs over {need}, not "
                         f"{backend}")
    return Mesh(group=group, size=size, rank=dist.get_rank(group),
                device=dev, axis_names=names, shape=shape)


def make_mesh(n_devices: Optional[int] = None, axis: str = "tgt",
              group=None, device=None) -> Mesh:
    """A flat mesh over the process group (the default one for None):
    n_devices, when given, must be its size. device None: this rank's
    current CUDA device (raising without one); "cpu" for a gloo group."""
    if n_devices is None and dist.is_initialized():
        n_devices = dist.get_world_size(group)
    return _mesh((n_devices or 1,), (axis,), group, device)


def make_mesh_2level(n_slices: int, chips_per_slice: int, group=None,
                     device=None) -> Mesh:
    """Two-level (DCN x ICI) mesh, ranks slice-major: rank s *
    chips_per_slice + c is chip c of slice s, so the solves' flat ring
    (shift by one over the combined axis) crosses a slice boundary once
    per slice per rotation (reference make_mesh_2level)."""
    return _mesh((n_slices, chips_per_slice), ("dcn", "ici"), group,
                 device)


def _mesh_axis(mesh: Mesh):
    """The reference's collective axis: the full axis-name tuple for a
    multi-level mesh, the bare name for a flat one. The port's
    collectives run over the whole group in flat rank order either way."""
    names = mesh.axis_names
    return names if len(names) > 1 else names[0]


def _all_gather(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's t (equal shapes), in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return out


def _replicate_rows(mesh: Mesh, a: torch.Tensor, fn) -> torch.Tensor:
    """fn over a's rows split across the ranks: rank d applies fn to its
    share of the rows (the last shares padded with zero rows to equal
    length), and the shares are all-gathered back in rank order,
    trimmed to a's rows."""
    n = a.shape[0]
    share = -(-n // mesh.size)
    mine = a[mesh.rank * share:(mesh.rank + 1) * share]
    if mine.shape[0] < share:
        mine = torch.cat([mine, mine.new_zeros((share - mine.shape[0],)
                                               + mine.shape[1:])])
    return torch.cat(_all_gather(mesh, fn(mine)))[:n]


def _global_rank(mesh: Mesh, r: int) -> int:
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def _ring_shift(mesh: Mesh, buf: torch.Tensor) -> torch.Tensor:
    """The reference's ppermute perm [(i, (i - 1) % D)]: send buf to rank
    d - 1, receive rank d + 1's."""
    d, n = mesh.rank, mesh.size
    buf = buf.contiguous()
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, _global_rank(mesh, (d - 1) % n),
                      mesh.group),
           dist.P2POp(dist.irecv, recv, _global_rank(mesh, (d + 1) % n),
                      mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _check_plan(mesh: Mesh, plan: Plan, cfg: SolverConfig, kernel: Kernel,
                who: str) -> int:
    """Common refusals of the sharded solves; returns split."""
    check_supported(cfg, kernel)
    if plan.tgt_geo.device != mesh.device:
        raise ValueError(f"{who}: the plan is on {plan.tgt_geo.device}, "
                         f"the mesh on {mesh.device}")
    if eq.n_eq_parts(plan.tgt_geo.shape[-1], cfg.order, kernel.pd) != 1:
        raise ValueError(f"{who} does not support split equivalent rows "
                         f"(order {cfg.order} grids exceed the block)")
    split = mesh.size.bit_length() - 1
    if 1 << split != mesh.size or plan.ttree.levels < split:
        raise ValueError(f"{who}: {mesh.size} ranks must be a power of two "
                         f"no deeper than the target tree "
                         f"({plan.ttree.levels} levels)")
    return split


# ------------------------------------------------------ owner-major maps

def node_owner(node_ids: np.ndarray, levels: int, split: int) -> np.ndarray:
    """Owner of each tree node: nodes at level >= split belong to the
    owner of their level-`split` ancestor; nodes above the split level
    are replicated (owner -1)."""
    node_ids = np.asarray(node_ids)
    lev = np.zeros_like(node_ids)
    nz = node_ids > 0
    lev[nz] = np.floor(np.log2(node_ids[nz])).astype(node_ids.dtype)
    owner = np.where(
        lev >= split,
        (node_ids >> np.maximum(lev - split, 0)) - (1 << split),
        -1)
    owner[~nz] = -1
    return owner


def local_rows(levels: int, ndev: int) -> Tuple[np.ndarray, np.ndarray]:
    """Owner-major layout maps (static, numpy).

    Returns (glob_of_local, local_of_glob):
      glob_of_local: (ndev, R) the global node id stored at each local row;
      local_of_glob: (NN,)     the local row of each global node in its
                               owner's slab (top nodes: row == id, valid
                               for every owner)."""
    split = int(np.log2(ndev))
    if 1 << split != ndev or levels < split:
        raise ValueError(f"local_rows: {ndev} owners must be a power of "
                         f"two no deeper than the tree ({levels} levels)")
    nn = 2 << levels
    R = ndev + (2 << (levels - split)) - 1
    glob = np.zeros((ndev, R), np.int32)
    local = np.zeros((nn,), np.int32)
    top = np.arange(ndev)
    glob[:, :ndev] = top[None, :]
    local[:ndev] = top
    r = ndev
    for l in range(split, levels + 1):
        w = 1 << (l - split)
        for d in range(ndev):
            ids = (1 << l) + d * w + np.arange(w)
            glob[d, r:r + w] = ids
            local[ids] = r + np.arange(w)
        r += w
    return glob, local


def partition_pairs(pl: lists.PairList, levels_t: int, ndev: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Bucket a pair list by owner on the host, rewriting target ids to
    local slab rows. Returns (tgt_local, src) of shape (ndev, Pd),
    padded with (0, 0). Replicated-top pairs (owner -1) go into EVERY
    owner's bucket so the top target rows are computed identically
    everywhere."""
    split = int(np.log2(ndev))
    tgt = pl.tgt.cpu().numpy()
    src = pl.src.cpu().numpy()
    valid = src != 0
    owner = node_owner(tgt, levels_t, split)
    _, local = local_rows(levels_t, ndev)
    tgt_l = local[tgt]
    buckets_t, buckets_s = [], []
    top = valid & (owner == -1)
    for d in range(ndev):
        m = valid & ((owner == d) | top)
        buckets_t.append(tgt_l[m])
        buckets_s.append(src[m])
    pd_max = max(1, max(len(b) for b in buckets_t))
    out_t = np.zeros((ndev, pd_max), np.int32)
    out_s = np.zeros((ndev, pd_max), np.int32)
    for d in range(ndev):
        out_t[d, :len(buckets_t[d])] = buckets_t[d]
        out_s[d, :len(buckets_s[d])] = buckets_s[d]
    return out_t, out_s


def _gather_local(a: torch.Tensor, glob: np.ndarray) -> torch.Tensor:
    """(NN, ...) global per-node array -> (ndev, R, ...) owner-major (one
    owner's (R, ...) for a (R,) glob row)."""
    idx = torch.from_numpy(glob.reshape(-1).astype(np.int64)).to(a.device)
    return a[idx].reshape(glob.shape + a.shape[1:])


# ------------------------------------------------- pair partitioning

def _node_level(ids: torch.Tensor) -> torch.Tensor:
    """floor(log2(id)) of node ids >= 1 (0 for 0), exact: the binary
    exponent of the id as a double."""
    return torch.frexp(ids.clamp(min=1).double()).exponent.long() - 1


def _flat_groups(tgt: torch.Tensor, src: torch.Tensor, group: int):
    """Trimmed G-wide groups of a flat (tgt, src) list whose targets run
    contiguously (a partition_pairs bucket): pad entries (src 0) drop."""
    valid = src != 0
    prev = torch.cat([tgt.new_full((1,), -1), tgt[:-1]])
    gt, gs, _ = lists._emit_groups(tgt, src, valid, valid & (tgt != prev),
                                   group, max(1, int(valid.sum())))
    n = int((gt != 0).sum())          # front-packed; target rows are >= 1
    return gt[:n], gs[:n]


def partition_groups_device(tgt, src, levels_t: int, levels_s: int,
                            ndev: int, slot_width: int, group: int,
                            caps_stage: Tuple[int, ...]):
    """Bucket a global (tgt, src) level list into per-owner, per-stage
    executor groups on the list's device (reference
    partition_groups_device).

    Owner d holds target subtree D + d; a pair's STAGE is the ring
    distance (src_owner - tgt_owner) mod D, so stage k runs on the
    source slab the ring has moved onto the owner by step k. Top-target
    pairs (target level < split, the first top_prefix_len(split,
    levels_t, W) entries of the level-ordered list) are replicated to
    every owner; top SOURCE rows are replicated in every source slab, so
    pairs with a top source run at stage 0. caps_stage[k] is the group
    capacity per (owner, stage-k) bucket, overflow-counted.

    Returns (top_t (Tg,), top_s (Tg, G), gt (D, D, C), gs (D, D, C, G),
    overflow) with C = max(caps_stage); target ids are local slab rows,
    source ids local source-slab rows."""
    split = int(np.log2(ndev))
    if len(caps_stage) != ndev:
        raise ValueError(f"caps_stage needs {ndev} capacities")
    dev = tgt.device
    local_t = torch.from_numpy(local_rows(levels_t, ndev)[1]).to(
        dev, torch.int64)
    local_s = torch.from_numpy(local_rows(levels_s, ndev)[1]).to(
        dev, torch.int64)
    tgt, src = tgt.long(), src.long()

    n_top = lists.top_prefix_len(split, levels_t, slot_width)
    top_t_raw, top_s_raw = tgt[:n_top], src[:n_top]
    rest_t, rest_s = tgt[n_top:], src[n_top:]

    # replicated top-target groups: the list is level-ordered, so these
    # are target-sorted; their sources sit at levels < split (the
    # level-matched descent), the top rows
    valid_top = top_s_raw != 0
    prev = torch.cat([top_t_raw.new_zeros((1,)), top_t_raw[:-1]])
    is_start = valid_top & (top_t_raw != prev)
    cap_top = max(1, n_top // group + ndev)
    top_t, top_s, ov_top = lists._emit_groups(
        torch.where(valid_top, top_t_raw, 0),
        torch.where(valid_top, local_s[top_s_raw], 0),
        valid_top, is_start, group, cap_top)

    # owned pairs: sorted by (owner * D + stage, local target row)
    valid = rest_s != 0
    lev_t = _node_level(rest_t)
    own_t = (rest_t >> (lev_t - split).clamp(min=0)) - ndev
    lev_s = _node_level(rest_s)
    own_s = torch.where(lev_s >= split,
                        (rest_s >> (lev_s - split).clamp(min=0)) - ndev,
                        own_t)                       # top src: stage 0
    stage = (own_s - own_t) % ndev
    tl = local_t[rest_t]
    sl = local_s[rest_s]
    bucket = own_t * ndev + stage
    big = 1 << 30
    k1 = torch.where(valid, bucket, big)
    k2 = torch.where(valid, tl, big)
    # two keys: a stable sort on the minor key, then on the major
    o = torch.sort(k2, stable=True).indices
    o = o[torch.sort(k1[o], stable=True).indices]
    k1, tl, sl = k1[o], tl[o], sl[o]
    valid = k1 < big
    bucket = k1

    # group emission, bucket boundaries breaking runs
    prev_k1 = torch.cat([k1.new_full((1,), -1), k1[:-1]])
    prev_tl = torch.cat([tl.new_full((1,), -1), tl[:-1]])
    is_start = valid & ((tl != prev_tl) | (k1 != prev_k1))
    slot = lists._seg_rank(valid, is_start) % group
    gstart = valid & (slot == 0)
    gid = torch.cumsum(gstart.long(), 0) - 1
    bkt_start = valid & (k1 != prev_k1)
    gid_base = torch.cummax(torch.where(bkt_start, gid, 0), 0).values
    gid_in = gid - gid_base                      # group rank in bucket

    C = int(max(caps_stage))
    offs = torch.arange(ndev, device=dev) * C            # stage offsets
    cap_of = torch.tensor(caps_stage, dtype=torch.int64, device=dev)
    st = (bucket % ndev).clamp(0, ndev - 1)
    dv = bucket // ndev
    ok = valid & (gid_in < cap_of[st])
    overflow = (valid & ~ok).sum() + ov_top
    total = ndev * ndev * C
    dst = torch.where(ok, dv * (ndev * C) + offs[st] + gid_in, total)
    out_t = tl.new_zeros((total + 1,)).index_put_(
        (torch.where(gstart & ok, dst, total),), tl)[:total]
    flat = torch.where(ok, dst * group + slot, total * group)
    out_s = sl.new_zeros((total * group + 1,)).index_put_(
        (flat,), torch.where(ok, sl, 0))[:total * group]
    return (top_t, top_s, out_t.view(ndev, ndev, C),
            out_s.view(ndev, ndev, C, group), overflow)


# ----------------------------------------------------- slab execution

# rows per prolongation slice: bounds the factored contraction's
# (rows, ncp, ncp, OD, width) intermediate (reference mesh.py:289-314)
_PROLONG_SLICE_ROWS = 2048


def _prolong_sliced(pts, pnc, pns, order: int, pu):
    """eq.prolong_factored over slices of _PROLONG_SLICE_ROWS rows, one
    after another, so its intermediate stays that small."""
    rows = pts.shape[0]
    cap = _PROLONG_SLICE_ROWS
    if rows <= cap:
        return eq.prolong_factored(pts, pnc, pns, order, pu)
    return torch.cat([eq.prolong_factored(pts[i:i + cap], pnc[i:i + cap],
                                          pns[i:i + cap], order,
                                          pu[i:i + cap])
                      for i in range(0, rows, cap)])


def _downward_local(out, nc_loc, ns_loc, pos_loc, order: int, levels: int,
                    split: int, block_size: int, dev: int):
    """DTT downward prolongation on owner `dev`'s slab, in place on out.

    out: (R, B, OD); nc/ns_loc: (R, pd); pos_loc: (R, B, pd). Levels
    < split walk the replicated top rows (local row == global id there);
    the split-crossing step reads this owner's own parent top row; the
    deeper levels are the slab's own."""
    pd = nc_loc.shape[-1]
    M = (order + 1) ** pd
    ndev = 1 << split

    def level(par: slice, chl: slice, width: int):
        pnc = torch.repeat_interleave(nc_loc[par], 2, dim=0)
        pns = torch.repeat_interleave(ns_loc[par], 2, dim=0)
        pu = torch.repeat_interleave(out[par, :M], 2, dim=0)
        out[chl, :width] += _prolong_sliced(pos_loc[chl, :width], pnc, pns,
                                            order, pu)

    # top levels: parents [2^(l-1), 2^l), children [2^l, 2^(l+1)), all
    # replicated rows
    for l in range(1, split + 1):
        np_l = 1 << (l - 1)
        if l == split:
            # the children are the subtree roots: only this owner's root
            # (local row ndev) is stored; its parent is top row
            # (ndev + dev) // 2
            proot = (ndev + dev) // 2
            width = block_size if l == levels else M
            out[ndev:ndev + 1, :width] += _prolong_sliced(
                pos_loc[ndev:ndev + 1, :width], nc_loc[proot:proot + 1],
                ns_loc[proot:proot + 1], order, out[proot:proot + 1, :M])
        else:
            level(slice(np_l, 2 * np_l), slice(2 * np_l, 4 * np_l), M)
    # subtree levels: level l's rows start at ndev + 2^(l-split) - 1
    for l in range(split + 1, levels + 1):
        wpar = 1 << (l - 1 - split)
        par0 = ndev + wpar - 1
        chl0 = ndev + 2 * wpar - 1
        level(slice(par0, par0 + wpar), slice(chl0, chl0 + 2 * wpar),
              block_size if l == levels else M)
    return out


def _downward_copy_local(out, levels: int, split: int, block_size: int,
                         dev: int):
    """Order < 0 copy prolongation on owner `dev`'s slab, in place on
    out (R, B, OD): dtt._downward_copy's side-aware halves, the
    split-crossing step taking the half of the parent top row that falls
    to this owner's root (reference _downward_copy_local)."""
    bs = block_size
    h = bs // 2
    ndev = 1 << split

    def kids_from(pu):
        left = torch.repeat_interleave(pu[:, :h], 2, dim=1)
        right = torch.repeat_interleave(pu[:, h:], 2, dim=1)
        return torch.stack([left, right], dim=1).reshape(
            2 * pu.shape[0], bs, -1)

    for l in range(1, split + 1):
        np_l = 1 << (l - 1)
        if l == split:
            proot = (ndev + dev) // 2
            pu = out[proot:proot + 1, :bs]
            # this owner's root is the (ndev + dev) % 2-th child
            half = pu[:, h:] if (ndev + dev) % 2 else pu[:, :h]
            out[ndev:ndev + 1, :bs] += torch.repeat_interleave(half, 2,
                                                               dim=1)
        else:
            out[2 * np_l:4 * np_l, :bs] += kids_from(out[np_l:2 * np_l,
                                                         :bs])
    for l in range(split + 1, levels + 1):
        wpar = 1 << (l - 1 - split)
        par0 = ndev + wpar - 1
        chl0 = ndev + 2 * wpar - 1
        out[chl0:chl0 + 2 * wpar, :bs] += kids_from(out[par0:par0 + wpar,
                                                        :bs])
    return out


def _resolve_shard_backend(cfg) -> str:
    """The slab executor's backend: the port's pair_backend ('auto':
    the kernels on CUDA tensors, the twins on CPU tensors; 'cuda'; or
    'torch'). The reference's 'xla' has no port counterpart and
    raises there."""
    return pair_backend(cfg)


def _exec_groups_slab(kernel: Kernel, cfg, tgt_geo, src_fm, gt, gs,
                      out_fm, backend: str, fetch: Optional[str] = None):
    """Run one slab's groups against the resident sources, adding into
    the feature-major accumulator out_fm (R_t, od8, B) in place (the
    reference adds into a point-major (R_t, B, OD) one); returns out_fm.
    gt/gs are trimmed groups (no pad steps). backend 'torch' runs the
    twins; 'cuda' needs CUDA tensors; 'auto' lets the wrappers choose by
    the tensors' device. fetch: cfg.pair_fetch for None."""
    if backend == "cuda" and tgt_geo.device.type != "cuda":
        raise ValueError("pair_backend='cuda' needs CUDA tensors")
    return pp.exec_pairs(kernel, tgt_geo, src_fm, gt, gs, cfg.core_func,
                         fetch=fetch or cfg.pair_fetch, out_fm=out_fm,
                         final=False, twin=backend == "torch")


def _finish(mesh: Mesh, kernel: Kernel, cfg: SolverConfig, plan: Plan,
            out_fm, tgeo, glob_d: np.ndarray, split: int):
    """This owner's slab after its pairs ran (out_fm, tgeo its target
    geometry, glob_d its rows' global ids): the downward pass on it, then
    its leaf rows gathered from every rank in rank order (owner d's
    leaves are the d-th contiguous share of the global leaf order) and
    unscrambled: the (n_real, OD) result."""
    ttree = plan.ttree
    levels, bs = ttree.levels, ttree.block_size
    out = out_fm[:, :kernel.od, :].transpose(1, 2)
    if cfg.order >= 0:
        rows = torch.from_numpy(glob_d.astype(np.int64)).to(mesh.device)
        # the positions at the plan's storage dtype, as dtt._downward
        # reads them (tgeo may be cast up to the accumulation dtype)
        pos = tgeo[:, :kernel.pd, :].to(plan.tgt_geo.dtype)
        _downward_local(out, ttree.nc[rows], ttree.ns[rows],
                        pos.transpose(1, 2), cfg.order, levels, split, bs,
                        mesh.rank)
    else:
        _downward_copy_local(out, levels, split, bs, mesh.rank)
    wleaf = 1 << (levels - split)
    leaf0 = mesh.size + wleaf - 1
    leaf = out[leaf0:leaf0 + wleaf, :bs, :].reshape(wleaf * bs, kernel.od)
    leaf = torch.cat(_all_gather(mesh, leaf))
    return _unscramble(leaf, plan.tgt_gidx, plan.tgt_sorted.n_real)


# ------------------------------------------------------------- solves

def solve_dtt_sharded_stream(kernel: Kernel, cfg: SolverConfig, mesh: Mesh,
                             plan: Plan, theta: Optional[float] = None):
    """O(N) dual-tree traversal with SHARDED sources streamed around the
    ring of ranks (reference solve_dtt_sharded_stream).

    Both trees are decomposed owner-major: rank d holds the target slab
    and the source slab of subtree D + d (top rows replicated). Pairs are
    bucketed on the device by (target owner, ring stage); stage k of rank
    d runs on source slab (d + k) % D, which batch_isend_irecv passes
    from rank d + 1 after each stage but the last. The downward pass and
    the leaves stay local; the only traffic is the source ring and the
    final gather of the leaves (with the plan whole on every rank, the
    ring moves slabs that each rank also holds: see the module's
    docstring). Trees shallower than the split, and
    dtt_traversal 'refine', take solve_dtt_sharded (the reference's own
    routing). Returns (out (n_real, OD), the list with the partition's
    overflow added) on every rank."""
    theta = cfg.theta_dtt if theta is None else theta
    split = _check_plan(mesh, plan, cfg, kernel, "solve_dtt_sharded_stream")
    ndev = mesh.size
    levels = plan.ttree.levels
    levels_s = plan.stree.levels
    if levels_s < split or cfg.dtt_traversal != "level":
        return solve_dtt_sharded(kernel, cfg, mesh, plan, theta)
    pl = lists.build_dtt_pairs_level(plan.stree, plan.ttree, theta,
                                     cfg.frontier_width, cfg.mac_geometry)
    g = cfg.pair_group
    W = cfg.frontier_width
    # hard per-owner bound: owned rows x max groups per row
    rows_dev = (2 << (levels - split)) - 1 + ndev
    cap0 = max(256, rows_dev * (W // g + 2))
    caps = (cap0,) + (max(256, cap0 // 2),) * (ndev - 1)
    top_t, top_s, gt, gs, ov = partition_groups_device(
        pl.tgt, pl.src, levels, levels_s, ndev, W, g, caps)
    info = pl._replace(overflow=pl.overflow + ov)

    d = mesh.rank
    glob_t, _ = local_rows(levels, ndev)
    glob_s, _ = local_rows(levels_s, ndev)
    tgeo = _gather_local(plan.tgt_geo, glob_t[d]).to(cfg.accum_dtype)
    buf = _gather_local(plan.src_fm, glob_s[d])
    out_fm = pp._zeros_fm(kernel, tgeo)
    backend = _resolve_shard_backend(cfg)
    for k in range(ndev):
        gt_k, gs_k = gt[d, k], gs[d, k]
        if k == 0:
            # the top-target groups (replicated content, top rows only)
            gt_k = torch.cat([top_t, gt_k])
            gs_k = torch.cat([top_s, gs_k])
        keep = gt_k != 0
        _exec_groups_slab(kernel, cfg, tgeo, buf, gt_k[keep], gs_k[keep],
                          out_fm, backend)
        if k + 1 < ndev:
            buf = _ring_shift(mesh, buf)
    return _finish(mesh, kernel, cfg, plan, out_fm, tgeo, glob_t[d],
                   split), info


def solve_dtt_sharded(kernel: Kernel, cfg: SolverConfig, mesh: Mesh,
                      plan: Plan, theta: Optional[float] = None):
    """O(N) dual-tree traversal over the mesh (reference
    solve_dtt_sharded): each rank executes its bucket of the
    host-partitioned list (partition_pairs) on its target slab against
    every source row, runs the downward pass there, and the leaves are
    gathered. The reference all-gathers its sharded source rows; every
    rank here holds them in the plan. Returns (out (n_real, OD), the
    list) on every rank."""
    theta = cfg.theta_dtt if theta is None else theta
    split = _check_plan(mesh, plan, cfg, kernel, "solve_dtt_sharded")
    if cfg.dtt_traversal == "level":
        pl = lists.build_dtt_pairs_level(plan.stree, plan.ttree, theta,
                                         cfg.frontier_width,
                                         cfg.mac_geometry)
    else:
        pl = lists.build_dtt_pairs(plan.stree, plan.ttree, theta,
                                   cfg.frontier_width, cfg.list_width)
    ndev = mesh.size
    d = mesh.rank
    levels = plan.ttree.levels
    pt, ps = partition_pairs(pl, levels, ndev)
    glob, _ = local_rows(levels, ndev)
    tgeo = _gather_local(plan.tgt_geo, glob[d]).to(cfg.accum_dtype)
    gt, gs = _flat_groups(*(torch.from_numpy(a[d].astype(np.int64)).to(
        mesh.device) for a in (pt, ps)), cfg.pair_group)
    out_fm = pp._zeros_fm(kernel, tgeo)
    _exec_groups_slab(kernel, cfg, tgeo, plan.src_fm, gt, gs, out_fm,
                      _resolve_shard_backend(cfg))
    return _finish(mesh, kernel, cfg, plan, out_fm, tgeo, glob[d],
                   split), pl


def exec_pairs_sharded(kernel: Kernel, cfg: SolverConfig, mesh: Mesh,
                       tgt_blocks: eq.Blocks, src_blocks: eq.Blocks,
                       pair_t: np.ndarray, pair_s: np.ndarray,
                       levels: int) -> torch.Tensor:
    """Owner-major sharded pair execution (reference
    exec_pairs_sharded): pair_t holds LOCAL slab rows (partition_pairs'
    output). The source blocks are split evenly over the ranks,
    featurized there and all-gathered; each rank runs its bucket through
    K1 (pair_fetch 'dma_i'; the reference runs exec_pairs_jnp, K1's
    twin, here), and the slabs are gathered back. Returns the full
    global (NN, B, OD) array on every rank (top rows: owner 0's)."""
    check_supported(cfg, kernel)
    ndev = mesh.size
    d = mesh.rank
    glob, _ = local_rows(levels, ndev)
    tpos = _gather_local(tgt_blocks.pos, glob[d])
    trad = _gather_local(tgt_blocks.rad, glob[d])
    tgeo = pp.build_tgt_geo(tpos, trad).to(cfg.accum_dtype)
    # the source blocks, split evenly over the ranks, featurized there
    # (a (rows, B, PD + 1 + SD) stack) and gathered back
    pd, sd = kernel.pd, kernel.sd
    stack = torch.cat([src_blocks.pos, src_blocks.rad[..., None],
                       src_blocks.s], dim=-1).to(cfg.accum_dtype)
    src_fm = _replicate_rows(mesh, stack, lambda b: pp.build_fm_blocks(
        kernel, b[..., :pd], b[..., pd], b[..., pd + 1:pd + 1 + sd]))
    gt, gs = _flat_groups(*(torch.from_numpy(a[d].astype(np.int64)).to(
        mesh.device) for a in (pair_t, pair_s)), cfg.pair_group)
    out_fm = pp._zeros_fm(kernel, tgeo)
    _exec_groups_slab(kernel, cfg, tgeo, src_fm, gt, gs, out_fm,
                      _resolve_shard_backend(cfg), fetch="dma_i")
    slab = out_fm[:, :kernel.od, :].transpose(1, 2)
    slabs = _all_gather(mesh, slab)
    # real rows are disjoint; the top rows are identical everywhere
    nn = 2 << levels
    out = slab.new_zeros((nn,) + slab.shape[1:])
    rows_all = torch.from_numpy(glob.reshape(-1).astype(np.int64)).to(
        mesh.device)
    out[rows_all] = torch.cat(slabs)
    out[:ndev] = slabs[0][:ndev]
    return out


def solve_treecode3_sharded(kernel: Kernel, cfg: SolverConfig, mesh: Mesh,
                            plan: Plan, theta: Optional[float] = None):
    """Boxwise treecode with the target subtrees sharded over the ranks
    (reference solve_treecode3_sharded). Needs the Blocks plan (not
    lean_plan). Returns (out (n_real, OD), the list) on every rank."""
    theta = cfg.theta_boxwise if theta is None else theta
    _check_plan(mesh, plan, cfg, kernel, "solve_treecode3_sharded")
    if plan.tgt_blocks is None:
        raise ValueError("solve_treecode3_sharded needs the Blocks plan: "
                         "prepare with lean_plan=False")
    pl = lists.build_treecode_pairs(plan.stree, plan.ttree, theta,
                                    "boxwise", cfg.frontier_width,
                                    cfg.list_width)
    pt, ps = partition_pairs(pl, plan.ttree.levels, mesh.size)
    out = exec_pairs_sharded(kernel, cfg, mesh, plan.tgt_blocks,
                             plan.src_blocks, pt, ps, plan.ttree.levels)
    nleaf = plan.ttree.nleaf
    bs = plan.ttree.block_size
    leaf = out[nleaf:, :bs, :].reshape(-1, kernel.od)
    return _unscramble(leaf, plan.tgt_gidx, plan.tgt_sorted.n_real), pl
