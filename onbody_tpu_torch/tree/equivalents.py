"""Equivalent particles (port of onbody_tpu/tree/equivalents.py).

Order >= 0: each interior node carries a Chebyshev-2nd-kind tensor grid
of M = (order+1)^PD proxies (BarycentricLagrange.hpp:256-417); leaf
particles are anterpolated onto their parents' grids and proxies onto
grandparents', one batched per-dimension factor contraction per level.
Order < 0: pair-merge equivalents (barneshut.hpp:947-1061), each node's
block_size proxies merged pairwise, strength-weighted, from its
children's 2*block_size; they need build_tree(refine=True)'s ordering,
which keeps merged pairs spatially close.

Output is the unified `Blocks` array: row i holds node i's proxies if
interior, its particles if a leaf; row 0 is the inert pad row (position
0, RADIUS 1, zero strength), so padded pair lists contribute nothing and
no pair meets rsqrt(0). `barycentric_fm` / `target_geo_fm` build the
executors' feature-major layouts directly (the lean plan).

A grid wider than a row (M > width: order 5 at block 128, order 6 and 7
at block 256 in 3D) spans n_eq_parts rows: part j >= 1 of node i lives at
the extension row ext_offset(j, nleaf) + i = (j+1)*nleaf + i, appended
after the 2*nleaf unified rows (the reference's layout), and the pair
lists name the parts as separate rows (traverse/lists.py _ext_src).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from onbody_tpu_torch.ops.kernels import featurize, featurize_flat
from onbody_tpu_torch.parts import Parts
from onbody_tpu_torch.tree.build import Tree

CLOSE_THRESH = 1e-10
LANE = 128


@dataclasses.dataclass
class Blocks:
    """pos (NN, B, PD); rad (NN, B); s (NN, B, SD) or None."""

    pos: torch.Tensor
    rad: torch.Tensor
    s: Optional[torch.Tensor]


def chebyshev_sk_wk(order: int, dtype=torch.float32, device=None):
    """Chebyshev-2nd-kind nodes on [-1,1] and barycentric weights
    (BarycentricLagrange.hpp:29-48), computed in float64 on `device`
    (no host-to-device copy) and rounded."""
    k = torch.arange(order + 1, dtype=torch.float64, device=device)
    sk = -torch.cos(k * math.pi / order)
    wk = 1.0 - 2.0 * (k % 2)
    wk[0] *= 0.5
    wk[-1] *= 0.5
    return sk.to(dtype), wk.to(dtype)


def _amat(pts, nc, ns, order: int):
    """Per-dimension barycentric terms wk/(x - lsk) with the CLOSE_THRESH
    one-hot capture. pts (..., P, PD); nc/ns (..., PD) ->
    (..., P, PD, ncp)."""
    sk, wk = chebyshev_sk_wk(order, pts.dtype, pts.device)
    lsk = nc[..., :, None] + 0.5 * sk * ns[..., :, None]
    dist = pts[..., :, :, None] - lsk[..., None, :, :]
    sing = dist.abs() < CLOSE_THRESH
    has_sing = sing.any(dim=-1, keepdim=True)
    safe = torch.where(sing, 1.0, dist)
    amat = wk / safe
    return torch.where(has_sing, sing.to(pts.dtype), amat)


def bary_weights(pts, nc, ns, order: int):
    """Barycentric interpolation weights of `pts` on a node's grid:
    (..., P, PD) -> (..., P, M), multi-index flattened with dimension 0
    fastest. A vanishing normalizer (padding clones far outside the grid
    cancel to rowsum 0 in fp32) gives zero weights, not inf."""
    amat = _amat(pts, nc, ns, order)
    prod = amat.sum(-1).prod(-1)                         # (..., P)
    denom = torch.where(prod.abs() > 1e-35, 1.0 / prod, 0.0)
    pd = pts.shape[-1]
    w = amat[..., 0, :]
    for d in range(1, pd):
        w = (amat[..., d, :][..., :, None] * w[..., None, :]).reshape(
            w.shape[:-1] + (w.shape[-1] * amat.shape[-1],))
    return w * denom[..., None]


def bary_factors(pts, nc, ns, order: int):
    """Per-dimension normalized factor rows (..., P, PD, ncp); the full
    weight tensor is their product over dimensions. Zero-rowsum rows get
    zero factors (bary_weights' guard)."""
    amat = _amat(pts, nc, ns, order)
    rowsum = amat.sum(-1, keepdim=True)
    inv = torch.where(rowsum.abs() > 1e-35, 1.0 / rowsum, 0.0)
    return amat * inv


def anterp_factored(pts, nc, ns, order: int, s):
    """Upward anterpolation: (n,P,PD) points with (n,P,SD) strengths ->
    (n, M, SD) grid strengths, M flattened with dimension 0 fastest
    (PD 3 or 2)."""
    f = bary_factors(pts, nc, ns, order)            # (n, P, PD, ncp)
    if pts.shape[-1] == 3:
        t = torch.einsum("npk,nps->npks", f[..., 2, :], s)
        t = torch.einsum("npj,npks->npjks", f[..., 1, :], t)
        eq = torch.einsum("npi,npjks->nkjis", f[..., 0, :], t)
        n, ncp = eq.shape[0], eq.shape[1]
        return eq.reshape(n, ncp ** 3, s.shape[-1])
    t = torch.einsum("npj,nps->npjs", f[..., 1, :], s)
    eq = torch.einsum("npi,npjs->njis", f[..., 0, :], t)
    n, ncp = eq.shape[0], eq.shape[1]
    return eq.reshape(n, ncp ** 2, s.shape[-1])


def prolong_factored(pts, nc, ns, order: int, U):
    """Downward prolongation: (n, M, OD) grid values -> (n, P, OD) at
    pts (n, P, PD), PD 3 or 2. The factors are computed in the points'
    type and promoted to U's (the reference's fp64 tier, which keeps
    fp32 geometry, does the same)."""
    f = bary_factors(pts, nc, ns, order).to(U.dtype)
    ncp = order + 1
    n, _, od = U.shape
    if pts.shape[-1] == 3:
        uk = U.reshape(n, ncp, ncp, ncp, od)        # (n, k, j, i, o)
        t = torch.einsum("nkjio,npk->njiop", uk, f[..., 2, :])
        t = torch.einsum("njiop,npj->niop", t, f[..., 1, :])
    else:
        uj = U.reshape(n, ncp, ncp, od)             # (n, j, i, o)
        t = torch.einsum("njio,npj->niop", uj, f[..., 1, :])
    return torch.einsum("niop,npi->npo", t, f[..., 0, :])


def _grid_positions(nc, ns, order: int):
    """Tensor Chebyshev grid points: nc, ns (N, PD) -> (N, M, PD)."""
    ncp = order + 1
    pd = nc.shape[-1]
    sk, _ = chebyshev_sk_wk(order, torch.float64, nc.device)
    idx = torch.arange(ncp ** pd, device=nc.device)
    kidx = torch.stack([(idx // ncp ** d) % ncp for d in range(pd)], dim=1)
    skg = sk[kidx].to(nc.dtype)                             # (M, PD)
    return nc[:, None, :] + 0.5 * skg * ns[:, None, :]


def block_width(block_size: int) -> int:
    """Lane-aligned block row width (the reference rounds to 128)."""
    return -(-block_size // LANE) * LANE


def n_eq_parts(width: int, order: int, pd: int) -> int:
    """Block rows an interior node's proxy grid spans: ceil(M / width)."""
    if order < 0:
        return 1
    return -(-((order + 1) ** pd) // width)


def ext_offset(part: int, nleaf: int) -> int:
    """Row offset of extension part j >= 1: row = (j+1)*nleaf + node."""
    return (part + 1) * nleaf


def grid_parts(sl: slice, nleaf: int, M: int, width: int):
    """The rows of a level's grids, part by part: yields (rows, lo, m),
    part j holding grid slots [lo, lo + m) of the level's nodes `sl` in
    the rows `sl` (j 0) or `sl` moved to the extension rows (j >= 1)."""
    for j in range(-(-M // width)):
        lo = j * width
        shift = ext_offset(j, nleaf) if j else 0
        yield (slice(sl.start + shift, sl.stop + shift), lo,
               min(M, lo + width) - lo)


# nodes per anterpolation batch: the factored contraction's largest
# temporary, (points, ncp, ncp, SD) a node, is 72 KB at order 5 in 3D with
# 512 points and SD 1 (19 GB for the 2^18 leaf parents of a 1e8 tree)
_ANTERP_NODES = 4096


def _proxy_levels(tree: Tree, x, r, s, order: int):
    """Interior levels bottom-up: yields (rows, nc, grid, eq_s, r_first)
    per level, the level's row slice, node centers (nseg, PD), proxy
    grid (nseg, M, PD), anterpolated proxy strengths (nseg, M, SD) and
    the radius of each node's first particle (the proxies' radius,
    ref :349-354). s None (targets) yields eq_s None. The anterpolation
    runs _ANTERP_NODES nodes at a time, which bounds its temporaries."""
    pd = x.shape[1]
    M = (order + 1) ** pd
    n_pad = x.shape[0]
    child_pos = child_str = eq_s = None
    for l in range(tree.levels - 1, -1, -1):
        nseg = 1 << l
        sl = tree.level_slice(l)
        nc_l, ns_l = tree.nc[sl], tree.ns[sl]
        grid = _grid_positions(nc_l, ns_l, order)        # (nseg, M, pd)
        if s is not None:
            sd = s.shape[1]
            if l == tree.levels - 1:
                src_pos = x.view(nseg, n_pad >> l, pd)
                src_str = s.view(nseg, n_pad >> l, sd)
            else:
                src_pos = child_pos.reshape(nseg, 2 * M, pd)
                src_str = child_str.reshape(nseg, 2 * M, sd)
            eq_s = torch.cat([anterp_factored(
                src_pos[i:i + _ANTERP_NODES], nc_l[i:i + _ANTERP_NODES],
                ns_l[i:i + _ANTERP_NODES], order,
                src_str[i:i + _ANTERP_NODES])
                for i in range(0, nseg, _ANTERP_NODES)])
        yield sl, nc_l, grid, eq_s, r.view(nseg, n_pad >> l)[:, :1]
        child_pos, child_str = grid, eq_s


def barycentric_blocks(tree: Tree, sorted_parts: Parts,
                       order: int) -> Blocks:
    """Unified source Blocks with barycentric-Lagrange interior proxies
    (reference _bary_impl): leaf rows the particles, interior rows the
    grid (unused slots parked at the node center, zero strength, radius
    of the node's first particle), a grid wider than the row split over
    extension rows."""
    x, r, s = sorted_parts.x, sorted_parts.r, sorted_parts.s
    pd, sd = x.shape[1], s.shape[1]
    width = block_width(tree.block_size)
    M = (order + 1) ** pd
    nleaf, bs = tree.nleaf, tree.block_size
    nn = (1 + n_eq_parts(width, order, pd)) * nleaf
    pos = x.new_zeros((nn, width, pd))
    rad = x.new_ones((nn, width))
    st = x.new_zeros((nn, width, sd))
    pos[nleaf:2 * nleaf, :bs] = x.view(nleaf, bs, pd)
    rad[nleaf:2 * nleaf, :bs] = r.view(nleaf, bs)
    st[nleaf:2 * nleaf, :bs] = s.view(nleaf, bs, sd)
    for sl, nc_l, grid, eq_s, r_first in _proxy_levels(tree, x, r, s, order):
        for rows, lo, m in grid_parts(sl, nleaf, M, width):
            pos[rows, :m] = grid[:, lo:lo + m]
            pos[rows, m:] = nc_l[:, None, :]
            st[rows, :m] = eq_s[:, lo:lo + m]
            rad[rows] = r_first
    return Blocks(pos=pos, rad=rad, s=st)


# ------------------------------------------------- pair-merge (order < 0)

def _merge_pairs(pos, rad, st):
    """Strength-weighted merge of adjacent pairs (barneshut.hpp:986-1000):
    (N, 2k, PD) positions, (N, 2k) radii, (N, 2k, SD) strengths ->
    (N, k, ...). Weights |s| (SD 1) or |s|_2, at least 1e-20; positions
    the weighted mean, radii the weighted RMS, strengths the sum."""
    n, twok, pd = pos.shape
    k = twok // 2
    p2 = pos.reshape(n, k, 2, pd)
    r2 = rad.reshape(n, k, 2)
    s2 = st.reshape(n, k, 2, st.shape[-1])
    if st.shape[-1] == 1:
        w = s2[..., 0].abs()
    else:
        w = torch.sqrt((s2 * s2).sum(-1))
    w = torch.clamp(w, min=1e-20)
    wsum = w.sum(-1, keepdim=True)                       # (n, k, 1)
    mpos = (p2 * w[..., None]).sum(2) / wsum
    mrad = torch.sqrt((r2 * r2 * w).sum(2) / wsum[..., 0])
    mstr = s2.sum(2)
    return mpos, mrad, mstr


def _pairmerge_impl(x, r, s, levels: int, block_size: int):
    """Blocks (NN, block_size, ...) of the pair-merge equivalents: leaf
    rows the sorted particles, each interior node its children's
    2*block_size entries merged to block_size, bottom-up; row 0 inert
    (position 0, radius 1, zero strength)."""
    pd, sd = x.shape[1], s.shape[1]
    nleaf = 1 << levels
    nn = 2 * nleaf
    pos = x.new_zeros((nn, block_size, pd))
    rad = x.new_ones((nn, block_size))
    st = x.new_zeros((nn, block_size, sd))
    pos[nleaf:] = x.view(nleaf, block_size, pd)
    rad[nleaf:] = r.view(nleaf, block_size)
    st[nleaf:] = s.view(nleaf, block_size, sd)
    # node at level l merges its children's 2*bs entries to bs
    cp = x.reshape(nleaf // 2, 2 * block_size, pd)
    cr = r.reshape(nleaf // 2, 2 * block_size)
    cs = s.reshape(nleaf // 2, 2 * block_size, sd)
    for l in range(levels - 1, -1, -1):
        nseg = 1 << l
        mp, mr, ms = _merge_pairs(cp, cr, cs)
        pos[nseg:2 * nseg] = mp
        rad[nseg:2 * nseg] = mr
        st[nseg:2 * nseg] = ms
        if l > 0:
            cp = mp.reshape(nseg // 2, 2 * block_size, pd)
            cr = mr.reshape(nseg // 2, 2 * block_size)
            cs = ms.reshape(nseg // 2, 2 * block_size, sd)
    return pos, rad, st


def _pad_block_width(pos, rad, st, width: int):
    """Pad blocks to `width` slots with inert ones: zero strength, radius
    1, position the block's slot-0 point (never a bogus in-domain
    origin)."""
    nn, w0, pd = pos.shape
    extra = width - w0
    if extra <= 0:
        return pos, rad, st
    pos = torch.cat([pos, pos[:, :1, :].expand(nn, extra, pd)], dim=1)
    rad = torch.cat([rad, rad.new_ones((nn, extra))], dim=1)
    if st is not None:
        st = torch.cat([st, st.new_zeros((nn, extra, st.shape[2]))], dim=1)
    return pos, rad, st


def pairmerge_blocks(tree: Tree, sorted_parts: Parts) -> Blocks:
    """Source Blocks with pair-merge equivalents (order < 0), rows
    block_width(block_size) wide. Needs build_tree(refine=True)."""
    pos, rad, st = _pairmerge_impl(sorted_parts.x, sorted_parts.r,
                                   sorted_parts.s, tree.levels,
                                   tree.block_size)
    pos, rad, st = _pad_block_width(pos, rad, st,
                                    block_width(tree.block_size))
    return Blocks(pos=pos, rad=rad, s=st)


def target_blocks(tree: Tree, sorted_targs: Parts, order: int) -> Blocks:
    """Target-side Blocks: leaf rows the targets, interior rows the
    equivalent target points, no strengths: the nodes' grids (order
    >= 0) or their pair-merged points with unit weights (order < 0)."""
    x, r = sorted_targs.x, sorted_targs.r
    pd = x.shape[1]
    width = block_width(tree.block_size)
    if order < 0:
        pos, rad, _ = _pairmerge_impl(x, r, x.new_ones((x.shape[0], 1)),
                                      tree.levels, tree.block_size)
        pos, rad, _ = _pad_block_width(pos, rad, None, width)
        return Blocks(pos=pos, rad=rad, s=None)
    M = (order + 1) ** pd
    nleaf, bs = tree.nleaf, tree.block_size
    nn = (1 + n_eq_parts(width, order, pd)) * nleaf
    pos = x.new_zeros((nn, width, pd))
    rad = x.new_ones((nn, width))
    pos[nleaf:2 * nleaf, :bs] = x.view(nleaf, bs, pd)
    rad[nleaf:2 * nleaf, :bs] = r.view(nleaf, bs)
    for sl, nc_l, grid, _, r_first in _proxy_levels(tree, x, r, None, order):
        for rows, lo, m in grid_parts(sl, nleaf, M, width):
            pos[rows, :m] = grid[:, lo:lo + m]
            pos[rows, m:] = nc_l[:, None, :]
            rad[rows] = r_first
    return Blocks(pos=pos, rad=rad, s=None)


# ------------------------------------------------ lean feature-major path
# The executors read only the feature-major (NN, C, B) sources and the
# (NN, 8, B) target geometry. These functions write those layouts directly,
# level by level, without the point-major Blocks (SolverConfig.lean_plan).
# Rows are block_size wide here (the Blocks path rounds the width up to a
# multiple of 128), so a grid wider than the block splits over extension
# rows sooner (order 3 in 3D at block 32).

def _parked(grid, nc_l, width: int):
    """(nseg, width, PD): the grid, then unused slots at the node center."""
    nseg, m, pd = grid.shape
    return torch.cat([grid, nc_l[:, None, :].expand(nseg, width - m, pd)], 1)


def barycentric_fm(tree: Tree, sorted_parts: Parts, order: int,
                   kernel_name: str, pad8: bool = True, flat: bool = False,
                   leaf_chunk: int = 4096, dtype=None,
                   return_root: bool = False,
                   out: Optional[torch.Tensor] = None):
    """Feature-major source blocks (NN, C, B) with barycentric proxies,
    equal row for row to featurize(barycentric_blocks(...), pad8) where
    the block size is a multiple of 128 (reference barycentric_fm); a
    grid wider than the block splits over extension rows (NN = (1 +
    parts) * nleaf). pad8=False stores the lean rows (grav3d 5, vort2d
    4). Row 0 is the inert row FEATURIZED (position 0, radius 1, zero
    strength), never all-zero. flat=True returns the (NN, C*B) view of
    the same memory. Leaves are featurize(d) leaf_chunk at a time, which
    bounds the temporary beside the output. dtype (None: the particles')
    is the type the rows are featurized in: the proxies are computed in
    the particles' type, then promoted (grav3d's sr^2 squared after the
    promotion, as the reference's fp64 tier squares it). return_root=True
    returns (fm, root grid (M, PD), root strengths (M, SD)) as well: the
    raw root proxies, which the capacity tiers anterpolate on upward
    across subtree roots (reference :554-560). out: a (NN, C, B) tensor
    to write the rows into (the capacity tiers pass a view of a larger
    slab, so no second slab-sized array is made)."""
    x, r, s = sorted_parts.x, sorted_parts.r, sorted_parts.s
    pd, sd = x.shape[1], s.shape[1]
    width = tree.block_size
    M = (order + 1) ** pd
    nleaf = tree.nleaf
    dtype = x.dtype if dtype is None else dtype

    def feat(pos, rad, st):
        return featurize(kernel_name, pos.to(dtype), rad.to(dtype),
                         st.to(dtype), pad8)

    safe0 = feat(x.new_zeros((1, width, pd)), x.new_ones((1, width)),
                 x.new_zeros((1, width, sd)))
    nn = (1 + n_eq_parts(width, order, pd)) * nleaf
    if out is None:
        fm = safe0.new_zeros((nn,) + safe0.shape[1:])
    else:
        if out.shape != (nn,) + safe0.shape[1:] or out.dtype != dtype:
            raise ValueError(f"out {tuple(out.shape)} {out.dtype}: the rows "
                             f"are {(nn,) + tuple(safe0.shape[1:])} {dtype}")
        fm = out.zero_()
    fm[0] = safe0[0]
    xb, rb, sb = (x.view(nleaf, width, pd), r.view(nleaf, width),
                  s.view(nleaf, width, sd))
    for lo in range(0, nleaf, leaf_chunk):
        hi = min(lo + leaf_chunk, nleaf)
        fm[nleaf + lo:nleaf + hi] = feat(xb[lo:hi], rb[lo:hi], sb[lo:hi])
    for sl, nc_l, grid, eq_s, r_first in _proxy_levels(tree, x, r, s, order):
        nseg = eq_s.shape[0]
        for rows, lo, m in grid_parts(sl, nleaf, M, width):
            st_w = torch.cat([eq_s[:, lo:lo + m],
                              eq_s.new_zeros((nseg, width - m, sd))], 1)
            fm[rows] = feat(_parked(grid[:, lo:lo + m], nc_l, width),
                            r_first.expand(nseg, width), st_w)
    fm = fm.view(nn, -1) if flat else fm
    if return_root:
        return fm, grid[0], eq_s[0]
    return fm


def top_proxies(nc, ns, root_grid, root_eq, rfirst, order: int,
                width: int, kernel_name: str) -> torch.Tensor:
    """The capacity tiers' top source rows (reference bigN.py:359-398,
    outofcore.py:425-451): the barycentric upward pass continued from the
    2^split subtree roots' raw proxies (root_grid (ndev, M, PD), root_eq
    (ndev, M, SD), barycentric_fm(return_root=True)) through the global
    levels < split, featurized as lean rows. nc, ns: the global tree's
    (NN, PD) boxes; rfirst (ndev,): each subtree's first particle radius
    (a top node takes its leftmost subtree's). Returns (ndev, C, width):
    top node i at row i, and row 0 the inert pad row (position 0, radius
    1, strength 0), which every padded group entry gathers, so a target
    grid point exactly at the origin cannot meet rsqrt(<= 0) (three top
    nodes cornered at the origin at split 6)."""
    ndev, M, pd = root_grid.shape
    sd = root_eq.shape[2]
    dev = root_grid.device
    inert = featurize_flat(kernel_name,
                           torch.zeros((width, pd), device=dev),
                           torch.ones((width,), device=dev),
                           torch.zeros((width, sd), device=dev))
    top_fm = inert.new_zeros((ndev,) + tuple(inert.shape))
    top_fm[0] = inert
    child_pos, child_str = root_grid, root_eq
    rf = torch.as_tensor(rfirst, dtype=torch.float32, device=dev)
    nseg = ndev
    while nseg > 1:
        nseg //= 2
        nc_l = nc[nseg:2 * nseg]
        ns_l = ns[nseg:2 * nseg].clamp(min=1e-20)
        eq_s = anterp_factored(child_pos.reshape(nseg, -1, pd), nc_l, ns_l,
                               order, child_str.reshape(nseg, -1, sd))
        grid = _grid_positions(nc_l, ns_l, order)
        rf = rf[0::2]
        st_w = torch.cat([eq_s, eq_s.new_zeros((nseg, width - M, sd))], 1)
        top_fm[nseg:2 * nseg] = featurize_flat(
            kernel_name, _parked(grid, nc_l, width),
            rf[:, None].expand(nseg, width), st_w)
        child_pos, child_str = grid, eq_s
    return top_fm


def target_geo_fm(tree: Tree, sorted_targs: Parts,
                  order: int) -> torch.Tensor:
    """(NN, 8, B) target geometry [pos | radius | 0..] built directly
    (reference target_geo_fm): rows 1.. equal
    build_tgt_geo(target_blocks(...)) where the block size is a multiple
    of 128, a grid wider than the block split over extension rows; row 0
    is all zero here (the Blocks path gives it radius 1; no executor
    reads it as a target)."""
    x, r = sorted_targs.x, sorted_targs.r
    pd = x.shape[1]
    width = tree.block_size
    M = (order + 1) ** pd
    nleaf = tree.nleaf
    geo = x.new_zeros(((1 + n_eq_parts(width, order, pd)) * nleaf, 8,
                       width))
    geo[nleaf:2 * nleaf, :pd] = x.view(nleaf, width, pd).transpose(1, 2)
    geo[nleaf:2 * nleaf, pd] = r.view(nleaf, width)
    for sl, nc_l, grid, _, r_first in _proxy_levels(tree, x, r, None, order):
        for rows, lo, m in grid_parts(sl, nleaf, M, width):
            geo[rows, :pd] = _parked(grid[:, lo:lo + m], nc_l,
                                     width).transpose(1, 2)
            geo[rows, pd] = r_first
    return geo


def _target_geo_slab_impl(tree: Tree, x, r, root: int, order: int,
                          levels: int, split: int, block_size: int,
                          x_base: int = 0) -> torch.Tensor:
    """Owner-major target-geometry slab (R, 8, B) of the level-`split`
    subtree rooted at node `root` (reference _target_geo_slab_impl).

    Row layout is parallel.mesh.local_rows': rows [0, 2^split) the global
    top nodes (their grids at the nodes' boxes, sizes floored at 1e-20,
    radius the mean of r), then the subtree's levels split..levels, each
    row as target_geo_fm writes it. x, r: the sorted targets from global
    slot x_base on: the whole array (x_base 0), or one subtree's slots
    (x_base = its first global slot), as the capacity tiers
    (traverse/bigN.py, traverse/outofcore.py) pass them; the top rows'
    radius is then the mean over those slots, as in the reference."""
    pd = x.shape[1]
    M = (order + 1) ** pd
    nleaf = 1 << levels
    width = block_size
    ndev = 1 << split
    R = ndev + (2 << (levels - split)) - 1
    geo = x.new_zeros((R, 8, width))

    def grid_rows(rows: slice, nc_l, ns_l, rad):
        geo[rows, :pd] = _parked(_grid_positions(nc_l, ns_l, order), nc_l,
                                 width).transpose(1, 2)
        geo[rows, pd] = rad[:, None]

    grid_rows(slice(0, ndev), tree.nc[:ndev], tree.ns[:ndev].clamp(min=1e-20),
              r.mean().expand(ndev))
    row = ndev
    for l in range(split, levels + 1):
        w = 1 << (l - split)
        id0 = root << (l - split)
        if l == levels:
            p0 = (id0 - nleaf) * block_size - x_base
            geo[row:row + w, :pd] = x[p0:p0 + w * block_size].view(
                w, width, pd).transpose(1, 2)
            geo[row:row + w, pd] = r[p0:p0 + w * block_size].view(w, width)
        else:
            # the per-node first-particle radius, from the global slot
            # count of the level
            n_lvl = (nleaf * block_size) >> l
            p0 = (id0 - (1 << l)) * n_lvl - x_base
            grid_rows(slice(row, row + w), tree.nc[id0:id0 + w],
                      tree.ns[id0:id0 + w], r[p0:p0 + w * n_lvl:n_lvl])
        row += w
    return geo


def target_geo_slab(tree: Tree, sorted_targs: Parts, root: int, order: int,
                    split: int) -> torch.Tensor:
    """(R, 8, B) owner-major target-geometry slab for subtree `root`
    (reference target_geo_slab); one row per node, so the grid must fit
    the block (the chunked solve refuses split rows, as the reference
    does)."""
    if n_eq_parts(tree.block_size, order, sorted_targs.pd) > 1:
        raise ValueError(f"target_geo_slab: order {order} grids exceed "
                         f"the block of {tree.block_size}")
    return _target_geo_slab_impl(tree, sorted_targs.x, sorted_targs.r,
                                 int(root), order, tree.levels, split,
                                 tree.block_size)
