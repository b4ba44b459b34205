"""Owner-major subtree slabs on one device (port of the single-device
helpers of onbody_tpu/parallel/mesh.py).

The reference decomposes the target tree owner-major: with D = 2^split
owners, owner d holds the subtree rooted at node D + d, and every
per-node array is stored as a slab of R rows,

    rows [0, D)   the global top nodes 0..D-1 (row 0 the inert dummy,
                  rows 1..D-1 the levels above the split), replicated;
    rows [D, R)   the nodes of d's subtree, level-contiguous (level
                  l >= split contributes 2^(l - split) rows),

R = D + 2^(levels - split + 1) - 1. The subtree-chunked solve
(traverse/chunked.py) walks the owners one after another on one device
with these helpers: `local_rows` (the static maps), `_downward_local`
(the DTT prolongation on one slab) and `_exec_groups_slab` (the pair
executor on one slab).

Not ported yet (ROADMAP.md Queue 1 item 14, multi-device): the sharded
solves (`solve_dtt_sharded`, `solve_dtt_sharded_stream`,
`solve_treecode3_sharded`), `partition_pairs` / `partition_groups_device`
and the reference's XLA executor `_exec_groups_xla_chunked`, which the
port's executors of ops/cuda_pairs.py replace.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from onbody_tpu_torch.config import pair_backend
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.tree import equivalents as eq


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


def _resolve_shard_backend(cfg) -> str:
    """The slab executor's backend: the port's pair_backend ('auto':
    the kernels on CUDA tensors, the twins on CPU tensors; 'cuda'; or
    'torch'). The reference's 'xla' has no port counterpart and
    raises there."""
    return pair_backend(cfg)


def _exec_groups_slab(kernel: Kernel, cfg, tgt_geo, src_fm, gt, gs,
                      out_fm, backend: str):
    """Run one slab's groups against the resident sources, adding into
    the feature-major accumulator out_fm (R_t, od8, B) in place (the
    reference adds into a point-major (R_t, B, OD) one); returns out_fm.
    gt/gs are trimmed groups (no pad steps). backend 'torch' runs the
    twins; 'cuda' needs CUDA tensors; 'auto' lets the wrappers choose by
    the tensors' device."""
    if backend == "cuda" and tgt_geo.device.type != "cuda":
        raise ValueError("pair_backend='cuda' needs CUDA tensors")
    return pp.exec_pairs(kernel, tgt_geo, src_fm, gt, gs, cfg.core_func,
                         fetch=cfg.pair_fetch, out_fm=out_fm, final=False,
                         twin=backend == "torch")
