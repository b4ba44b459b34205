"""Exact top-level k-d splits from histograms of u16 codes (port of
onbody_tpu/tree/hsplit.py).

The out-of-core tier (traverse/outofcore.py) needs the top `split` levels
of the VAMsplit k-d tree without holding the whole particle set at once:
only each node's exact split plane and each particle's subtree. Counting
gives both:

  * particles stream in regenerable chunks; each chunk adds a per-node
    histogram over the node's split-axis u16 code;
  * the host reduces the histograms and picks, per node, the largest
    code T with count(code < T) <= target, the MSB-exact median split;
  * ties (code == T) go left by GLOBAL rank in (chunk, slot) order: the
    `need = target - count_less` left tie slots are handed to the chunks
    in order, so every node's slot counts stay exact.

Split axes come from plane-derived boxes in code units (the split axis
halved at the plane). Every result is an integer: the histograms are
int64 `torch.bincount`s, with no float atomics, so planes, quotas, axes
and subtree ids equal the reference's integer for integer.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

_NB = 65536


def box_codes(x: torch.Tensor, box_lo: np.ndarray,
              box_hi: np.ndarray) -> torch.Tensor:
    """u16 grid codes (0..65534) of (m, pd) positions in the real box
    (box_lo, box_hi: float32 numpy (pd,)), int32; the step is computed
    in float32 on the host, so every chunk or rank gets the same grid."""
    step = np.maximum((box_hi - box_lo) / 65534.0, 1e-30)
    lo = torch.from_numpy(np.asarray(box_lo, np.float32)).to(x.device)
    step = torch.from_numpy(np.asarray(step, np.float32)).to(x.device)
    c = torch.clamp(torch.floor((x - lo[None, :]) / step[None, :]), 0, 65534)
    return c.to(torch.int32)


def _axis_codes(codes: torch.Tensor, nid: torch.Tensor,
                axes: torch.Tensor) -> torch.Tensor:
    """Each particle's code on its node's split axis: (m,) int64."""
    return codes.gather(1, axes[nid.long()][:, None]).squeeze(1).long()


def chunk_hist(codes: torch.Tensor, nid: torch.Tensor, axes: torch.Tensor,
               nnode: int) -> torch.Tensor:
    """Per-node histogram of each particle's split-axis code.

    codes: (m, pd) u16 codes in an integer tensor; nid: (m,) node id at
    the current level (0..nnode-1); axes: (nnode,) split axis per node.
    Returns (nnode, 65536) int64 counts."""
    flat = nid.long() * _NB + _axis_codes(codes, nid, axes)
    return torch.bincount(flat, minlength=nnode * _NB).view(nnode, _NB)


def chunk_tie_counts(codes: torch.Tensor, nid: torch.Tensor,
                     axes: torch.Tensor, planes: torch.Tensor
                     ) -> torch.Tensor:
    """Per-node count of code == plane ties in this chunk: (nnode,)
    int64."""
    tie = _axis_codes(codes, nid, axes) == planes.long()[nid.long()]
    return torch.bincount(nid[tie].long(),
                          minlength=planes.shape[0])


def plan_level(hists: np.ndarray, target: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact plane per node from the REDUCED histograms.

    hists: (nnode, 65536) total counts; target: left-child slot count
    (n_slots_per_node // 2 of the PADDED set; pads carry code 65535).
    Returns (planes (nnode,), need (nnode,)) int32: left = code < plane,
    plus the first `need` ties in global (chunk, slot) order."""
    cum = np.cumsum(hists, axis=1)
    # largest T with count(code < T) <= target: the first index where
    # the cumulative count passes target
    planes = np.argmax(cum > target, axis=1).astype(np.int64)
    less = np.where(planes > 0,
                    np.take_along_axis(cum, (planes - 1)[:, None],
                                       1)[:, 0], 0)
    need = target - less
    assert (need >= 0).all()
    return planes.astype(np.int32), need.astype(np.int32)


def tie_quotas(per_chunk_ties: List[np.ndarray], need: np.ndarray
               ) -> List[np.ndarray]:
    """Per-chunk left-tie quotas, chunks in order: chunk c takes
    min(ties_c, remaining need)."""
    out = []
    rem = need.astype(np.int64).copy()
    for t in per_chunk_ties:
        q = np.minimum(t.astype(np.int64), np.maximum(rem, 0))
        out.append(q.astype(np.int32))
        rem -= t
    return out


def chunk_assign(codes: torch.Tensor, nid: torch.Tensor, axes: torch.Tensor,
                 planes: torch.Tensor, quota: torch.Tensor) -> torch.Tensor:
    """Advance node ids one level: nid -> 2*nid + (not left).

    left = code < plane, or code == plane with a within-chunk tie rank
    (slot order) below this chunk's quota. The per-node tie rank comes
    from one stable sort by node id (non-ties keyed past the last node)
    less each key run's start."""
    m = codes.shape[0]
    c = _axis_codes(codes, nid, axes)
    nid64 = nid.long()
    p = planes.long()[nid64]
    tie = c == p
    nnode = planes.shape[0]
    key = torch.where(tie, nid64, nnode)
    skey, sidx = torch.sort(key, stable=True)
    cnt = torch.bincount(key, minlength=nnode + 1)
    starts = torch.cumsum(cnt, 0) - cnt
    iota = torch.arange(m, dtype=torch.int64, device=codes.device)
    rank = torch.empty_like(iota).scatter_(0, sidx, iota - starts[skey])
    left = (c < p) | (tie & (rank < quota.long()[nid64]))
    return 2 * nid + (~left).to(nid.dtype)


def level_axes(blo: np.ndarray, bhi: np.ndarray, box_lo: np.ndarray,
               box_hi: np.ndarray) -> np.ndarray:
    """Split axis per node: the longest side of its plane-derived box
    (blo, bhi (nnode, pd), code units) in the real box's units."""
    scale = (box_hi.astype(np.float64) - box_lo.astype(np.float64)) / 65535.0
    return np.argmax((bhi - blo) * scale[None, :], axis=1).astype(np.int32)


def child_pads(hist: np.ndarray, planes: np.ndarray, need: np.ndarray,
               ties: List[np.ndarray], pads: np.ndarray, target: int
               ) -> np.ndarray:
    """The children's virtual-pad mass (2 * nnode,), left then right per
    node: left reals = count_less(real) + the real tie quota; left pads
    fill the rest of the target slots. hist holds the pads at bin 65535."""
    real_cum = np.cumsum(hist, axis=1)
    real_cum[:, _NB - 1] -= pads                       # reals only
    less_r = np.where(planes > 0,
                      np.take_along_axis(real_cum, (planes - 1)[:, None],
                                         1)[:, 0], 0)
    total_ties = (np.sum(ties, axis=0) if len(ties)
                  else np.zeros(len(planes), np.int64))
    left_reals = less_r + np.minimum(need, total_ties)
    pads_l = target - left_reals
    out = np.stack([pads_l, pads - pads_l], axis=1).reshape(-1)
    assert (out >= 0).all()
    return out


def child_boxes(blo: np.ndarray, bhi: np.ndarray, axes: np.ndarray,
                planes: np.ndarray):
    """The children's plane-derived boxes, left then right per node."""
    nlo = np.repeat(blo, 2, axis=0)
    nhi = np.repeat(bhi, 2, axis=0)
    for i in range(len(planes)):
        a = axes[i]
        nhi[2 * i, a] = planes[i]
        nlo[2 * i + 1, a] = planes[i]
    return nlo, nhi


def run_top_split(gen_codes, n_chunks: int, m_chunk: int, split: int,
                  box_lo: np.ndarray, box_hi: np.ndarray,
                  keep_nid: bool = True, virtual_pad_slots: int = 0,
                  chunk_sizes=None):
    """Drive `split` histogram levels over regenerable chunks.

    gen_codes(c) -> (m_c, pd) integer codes on the device; chunks are
    regenerated per level. Each chunk's node ids stay on its device
    between levels (one int32 per particle).

    virtual_pad_slots: the padding clones of the monolithic build,
    represented analytically: real codes clamp to 65534, so pads are
    mass at bin 65535 that never ties with a real particle. Per-node pad
    mass is tracked on the host and added to the histograms before
    planning; a plane of 65535 sends every real of that node left and
    fills the rest of the left slots with pads, as the padded VAMsplit
    does.

    Returns (planes_all, quotas_all, axes_all, nids): per-level planes
    (nnode,), per-level per-chunk tie quotas, per-level axes (numpy
    int32), and the final per-chunk subtree ids (int32 tensors; None if
    keep_nid=False)."""
    pd = box_lo.shape[0]
    sizes = chunk_sizes or [m_chunk] * n_chunks
    # plane-derived boxes per node, in code units
    blo = np.zeros((1, pd))
    bhi = np.full((1, pd), 65535.0)
    planes_all, quotas_all, axes_all = [], [], []
    n_slots = sum(sizes) + virtual_pad_slots
    pads = np.array([virtual_pad_slots], np.int64)     # per-node pads
    nids = [None] * n_chunks

    for l in range(split):
        nnode = 1 << l
        axes = level_axes(blo, bhi, box_lo, box_hi)
        target = n_slots // (2 * nnode)
        hist = np.zeros((nnode, _NB), np.int64)
        per_chunk_hists = []
        for c in range(n_chunks):
            codes = gen_codes(c)
            if nids[c] is None:
                nids[c] = torch.zeros((sizes[c],), dtype=torch.int32,
                                      device=codes.device)
            axes_t = torch.from_numpy(axes).to(codes.device, torch.int64)
            h = chunk_hist(codes, nids[c], axes_t, nnode).cpu().numpy()
            per_chunk_hists.append(h)
            hist += h
        hist[:, _NB - 1] += pads                       # virtual pads
        planes, need = plan_level(hist, target)
        ties = [h[np.arange(nnode), planes] for h in per_chunk_hists]
        quotas = tie_quotas(ties, need)
        pads = child_pads(hist, planes, need, ties, pads, target)
        for c in range(n_chunks):
            codes = gen_codes(c)
            dev = codes.device
            nids[c] = chunk_assign(
                codes, nids[c], torch.from_numpy(axes).to(dev, torch.int64),
                torch.from_numpy(planes).to(dev),
                torch.from_numpy(quotas[c]).to(dev))
        planes_all.append(planes)
        quotas_all.append(quotas)
        axes_all.append(axes)
        blo, bhi = child_boxes(blo, bhi, axes, planes)
    if split == 0:
        nids = [torch.zeros((sizes[c],), dtype=torch.int32,
                            device=gen_codes(c).device)
                for c in range(n_chunks)]
    return planes_all, quotas_all, axes_all, (nids if keep_nid else None)
