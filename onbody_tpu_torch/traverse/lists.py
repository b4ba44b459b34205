"""Interaction lists as dense, fixed-width frontier expansions (port of
the treecode traversal and the DTT level and refine traversals of
onbody_tpu/traverse/lists.py).

Every target node keeps a row of `frontier_width` candidate source
nodes; each round one MAC classification sorts the candidates (treecode:
accept / expand-children; DTT: accept / defer-to-target-children), rows
are front-compacted, and the accepted pairs are emitted. Node ids follow
tree/build.py (root 1, children 2i/2i+1, leaves [nleaf, 2*nleaf)); a
source node id is its row in the unified Blocks array and 0 is the inert
pad row. Overflow of a fixed width is counted, never silent.

The DTT MAC reads the source geometry quantized onto a shared 16-bit
grid (the reference's mac_geometry='quant') or exact (mac_geometry='f32'),
as the reference does; the two can differ on razor-edge decisions. The
treecode MACs read the trees' geometry as it is, as the reference's do.

With split equivalent rows (tree/equivalents.py n_eq_parts > 1) an
accepted interior source also names its extension rows (_ext_src,
src_parts), and the DTT gives each interior target's extension rows the
same accepted list (tgt_parts), in the reference's order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from onbody_tpu_torch.tree.build import Tree


class PairList(NamedTuple):
    """Padded (tgt_row, src_row) interactions, grouped by tgt_row;
    src 0 marks a pad entry. overflow > 0 means a width was exceeded."""
    tgt: torch.Tensor       # (P,) int64
    src: torch.Tensor       # (P,) int64
    n_valid: torch.Tensor   # () int64
    overflow: torch.Tensor  # () int64


class PairGroups(NamedTuple):
    """Executor work list: each entry one target row and G source rows
    (padded with row 0); pad entries have tgt 0."""
    tgt: torch.Tensor       # (P,) int64
    src: torch.Tensor       # (P, G) int64
    n_valid: torch.Tensor
    overflow: torch.Tensor


def _compact_rows(vals: torch.Tensor, width: int,
                  mode: str = "scatter") -> Tuple[torch.Tensor, torch.Tensor]:
    """Move each row's non-zero entries to the front and truncate/pad to
    `width` columns. Returns (rows, overflow count).

    mode 'scatter' and 'sort' keep the entries in order (the reference's
    two movers give identical rows; this is the stable sort); 'idsort'
    sorts them by ascending id, zeros last (reference lists.py:80-88),
    so sibling blocks (2c, 2c+1) land in adjacent slots, the layout the
    bundled fetch (pair_fetch 'dma_p') copies two at a time. Ids within a
    row are distinct, so the order is unique."""
    valid = vals != 0
    counts = valid.sum(1)
    overflow = (counts - width).clamp(min=0).sum()
    if mode == "idsort":
        big = torch.iinfo(vals.dtype).max
        out = torch.sort(torch.where(valid, vals, big), dim=1).values
        out = torch.where(out == big, 0, out)
    else:
        order = torch.sort((~valid).to(torch.uint8), dim=1,
                           stable=True).indices
        out = torch.gather(vals, 1, order)
    k = out.shape[1]
    if width > k:
        out = torch.cat([out, out.new_zeros((out.shape[0], width - k))], 1)
    return out[:, :width], overflow


def _append_rows(out, out_cnt, vals):
    """Append each row's non-zero entries of `vals` to `out` (L, K+1)
    at out_cnt; column K is a dump column. Returns (out, cnt, overflow)."""
    K = out.shape[1] - 1
    valid = vals != 0
    pos = out_cnt[:, None] + torch.cumsum(valid.to(torch.int64), 1) - 1
    pos = torch.where(valid & (pos < K), pos, K)
    out = out.clone()
    out.scatter_(1, pos, torch.where(valid, vals, 0))
    out[:, K].zero_()
    new_cnt = out_cnt + valid.sum(1)
    overflow = (new_cnt - K).clamp(min=0).sum()
    return out, new_cnt.clamp(max=K), overflow


# ------------------------------------------------------------------- MACs
# cand (L, W) source node ids; tnc/tns (L, 1, PD) and tnr (L, 1) the
# target leaves' box centers, sizes and radii; theta a float32 scalar
# tensor. Each returns the (L, W) mask of candidates far enough to accept.

def _center_dist(snc, cand, tnc):
    d2 = None
    for d in range(snc.shape[1]):
        diff = snc[:, d][cand] - tnc[:, :, d]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return torch.sqrt(d2)


def mac_boxwise(stree: Tree, cand, tnc, tns, tnr, theta):
    """treecode3 MAC (barneshut.hpp:250-283): box-center distance against
    2 * (max(snr, tnr) + 0.25 * min(snr, tnr))."""
    snr = stree.nr[cand]
    dist = _center_dist(stree.nc, cand, tnc)
    testrad = torch.maximum(snr, tnr) + 0.25 * torch.minimum(snr, tnr)
    return dist / (2.0 * testrad) > theta


def mac_pointwise_conservative(stree: Tree, cand, tnc, tns, tnr, theta):
    """Leaf-conservative treecode2 MAC (barneshut.hpp:160-175): the least
    distance from any point of the target leaf box (center distance minus
    the target node radius) against 2 * snr, so acceptance holds for
    every point of the block."""
    snr = stree.nr[cand]
    dist = (_center_dist(stree.nc, cand, tnc) - tnr).clamp(min=0.0)
    return dist / (2.0 * snr) > theta


def mac_treecode1_conservative(stree: Tree, cand, tnc, tns, tnr, theta):
    """Leaf-conservative treecode1 surface-distance MAC
    (barneshut.hpp:85-93): per-axis distance from the source box (centered
    on its CM) to the nearest possible target point."""
    snr = stree.nr[cand]
    d2 = None
    for d in range(stree.nc.shape[1]):
        dd = ((stree.x[:, d][cand] - tnc[:, :, d]).abs()
              - 0.5 * stree.ns[:, d][cand] - 0.5 * tns[:, :, d]
              ).clamp(min=0.0)
        d2 = dd * dd if d2 is None else d2 + dd * dd
    return torch.sqrt(d2) / (2.0 * snr) > theta


_MACS = {
    "boxwise": mac_boxwise,
    "pointwise": mac_pointwise_conservative,
    "treecode1": mac_treecode1_conservative,
}


# ------------------------------------------------- single-tree traversal

def _treecode_lists(stree: Tree, ttree: Tree, theta: float, mac: str,
                    frontier_width: int, list_width: int):
    """Per-target-leaf accepted source rows (reference _treecode_lists):
    far nodes that pass the MAC (proxies or monopoles) and near source
    leaves (direct), in one list because both are rows of the unified
    block array. Returns (out (L, K), counts (L,), overflow)."""
    nleaf_s, nleaf_t = stree.nleaf, ttree.nleaf
    W, K = frontier_width, list_width
    dev = ttree.x.device
    mac_fn = _MACS[mac]
    th = torch.full((), theta, dtype=torch.float32, device=dev)
    tnc = ttree.nc[nleaf_t:][:, None, :]
    tns = ttree.ns[nleaf_t:][:, None, :]
    tnr = ttree.nr[nleaf_t:][:, None]
    # dead target leaves (pure padding, outputs discarded) start empty
    cand = torch.zeros((nleaf_t, W), dtype=torch.int64, device=dev)
    cand[:, 0] = ttree.alive[nleaf_t:].to(torch.int64)
    out = cand.new_zeros((nleaf_t, K + 1))
    out_cnt = cand.new_zeros((nleaf_t,))
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(stree.levels + 1):
        valid = cand != 0
        passes = mac_fn(stree, cand, tnc, tns, tnr, th)
        is_leaf = cand >= nleaf_s
        accept = valid & (passes | is_leaf)
        expand = valid & ~passes & ~is_leaf
        out, out_cnt, ov1 = _append_rows(out, out_cnt,
                                         torch.where(accept, cand, 0))
        kids = torch.cat([torch.where(expand, 2 * cand, 0),
                          torch.where(expand, 2 * cand + 1, 0)], dim=1)
        cand, ov2 = _compact_rows(kids, W)
        overflow = overflow + ov1 + ov2
    # leaves always terminate: anything left in cand is counted as overflow
    overflow = overflow + (cand != 0).sum()
    return out[:, :K], out_cnt, overflow


def _ext_src(out, nleaf_s: int, parts: int):
    """Each row's accepted ids (L, W) followed by the extension-row ids
    of its accepted interior sources, whose proxy grid spans `parts`
    block rows: part j >= 1 of node i is row (j+1)*nleaf_s + i; leaves
    and pads give 0 there. Returns (L, parts*W) (reference _ext_src)."""
    if parts == 1:
        return out
    interior = (out > 0) & (out < nleaf_s)
    return torch.cat([out] + [torch.where(interior, out + (j + 1) * nleaf_s,
                                          0) for j in range(1, parts)], 1)


def build_treecode_pairs(stree: Tree, ttree: Tree, theta: float, mac: str,
                         frontier_width: int = 256, list_width: int = 1024,
                         src_parts: int = 1) -> PairList:
    """The (tgt_leaf_row, src_row) pair list of a treecode sweep; slot
    width list_width."""
    out, cnt, ov = _treecode_lists(stree, ttree, theta, mac, frontier_width,
                                   list_width)
    n_valid = cnt.sum()
    if src_parts > 1:
        # accepted interior nodes span extension rows, in the same width
        out, ov2 = _compact_rows(_ext_src(out, stree.nleaf, src_parts),
                                 out.shape[1])
        ov = ov + ov2
        n_valid = (out != 0).sum()
    nleaf_t = ttree.nleaf
    tgt = torch.arange(nleaf_t, 2 * nleaf_t, dtype=torch.int64,
                       device=out.device)[:, None].expand_as(out)
    return PairList(tgt=tgt.reshape(-1), src=out.reshape(-1),
                    n_valid=n_valid, overflow=ov)


# --------------------------------------------------- dual-tree traversal

def _quant_u16(v: torch.Tensor) -> torch.Tensor:
    """Grid-unit value rounded onto the 16-bit grid (as float32)."""
    return torch.round(v).clamp(0.0, 65535.0)


def _quant_grid(stree: Tree, ttree: Tree):
    """Shared 16-bit grid over both trees' CMs (pad cluster included)
    and the node-radius range. Returns (lo (pd,), scale ())."""
    lo = torch.minimum(stree.x.amin(0), ttree.x.amin(0))
    hi = torch.maximum(stree.x.amax(0), ttree.x.amax(0))
    ext = (hi - lo).max()
    nr_max = torch.maximum(stree.nr.max(), ttree.nr.max())
    scale = torch.maximum(ext, nr_max) / 65534.0
    return lo, scale.clamp(min=1e-30)


def _mk_classifier(stree: Tree, ttree: Tree, theta: float, nleaf_s: int,
                   mac_geometry: str = "quant"):
    """MAC classifier over dense candidate rows (reference
    _mk_classifier). Returns (classify, prep): prep(tcm, tnr) puts a
    level's target geometry in the sources' units, classify(cand, tgeo,
    t_is_leaf) -> (accept, expand, defer). mac_geometry 'quant' reads
    the source CMs and radii on a shared 16-bit grid (the targets in
    grid units, unrounded), 'f32' reads them exact."""
    pd = stree.nc.shape[1]
    th = torch.full((), theta, dtype=torch.float32, device=stree.x.device)
    if mac_geometry == "quant":
        lo, scale = _quant_grid(stree, ttree)
        inv = 1.0 / scale
        # grid-unit CM per dimension, then the node radius (2D: x, y, nr;
        # reference lists.py:591-600)
        sgeo = [_quant_u16((stree.x[:, d] - lo[d]) * inv) for d in range(pd)]
        sgeo.append(_quant_u16(stree.nr * inv))

        def prep(tcm, tnr):
            return (tcm - lo[None, :]) * inv, tnr * inv
    elif mac_geometry == "f32":
        sgeo = [stree.x[:, d] for d in range(pd)] + [stree.nr]

        def prep(tcm, tnr):
            return tcm, tnr
    else:
        raise ValueError(f"mac_geometry {mac_geometry!r}: 'quant' or 'f32'")

    def classify(cand, tgeo, t_is_leaf: bool):
        tcm_u, tnr_u = tgeo
        valid = cand != 0
        s_is_leaf = cand >= nleaf_s
        d2 = None
        for d in range(pd):
            dd = sgeo[d][cand] - tcm_u[:, None, d]
            d2 = dd * dd if d2 is None else d2 + dd * dd
        lim = th * (sgeo[pd][cand] + tnr_u[:, None])
        sep = d2 > lim * lim
        accept = valid & ((s_is_leaf & t_is_leaf) | sep)
        if t_is_leaf:
            expand = valid & ~accept & ~s_is_leaf
            defer = torch.zeros_like(valid)
        else:
            expand = torch.zeros_like(valid)
            defer = valid & ~accept
        return accept, expand, defer
    return classify, prep


def _defer_kids(cand, defer, nleaf_s: int, width: int,
                compact: str = "scatter"):
    """The next level's candidate row of each target from its deferred
    candidates: children of deferred interior sources, deferred source
    leaves riding along unrefined (sharing the first child slot), rows
    compacted to `width` (_compact_rows' mode). Returns (rows,
    overflow)."""
    s_leaf = cand >= nleaf_s
    keep_leaf = defer & s_leaf
    split = defer & ~s_leaf
    kids = torch.cat([torch.where(split, 2 * cand,
                                  torch.where(keep_leaf, cand, 0)),
                      torch.where(split, 2 * cand + 1, 0)], dim=1)
    return _compact_rows(kids, width, compact)


def _dtt_lists_level(stree: Tree, ttree: Tree, theta: float,
                     frontier_width: int, mac_geometry: str = "quant",
                     n_live: int = 0, leaf_pair2: bool = False,
                     compact: str = "scatter", src_parts: int = 1,
                     tgt_parts: int = 1):
    """Simultaneous-descent dual-tree traversal, one MAC round per
    target level (reference _dtt_lists_level). `compact` is the row
    order of every compaction (_compact_rows' mode). With split
    equivalent rows, an accepted interior source names its src_parts
    rows (_ext_src, inside the row's width) and each interior target's
    tgt_parts - 1 extension rows get its row's list, right after the
    level's rows.

    A target node's candidates are the children of its parent's
    non-separated list (a non-separated source leaf rides along
    unrefined), so acceptance keeps dist > theta * (snr + tnr) and the
    error envelope of the reference traversal. n_live (real target
    count) slices each level to its live-row prefix: pads sort last, so
    node k of level l holds a real target iff k < ceil(n_live / m_l).

    leaf_pair2: the leaf level's candidate rows would be the parents'
    rows repeated twice with a vacuous classify, so emit ONE entry per
    (parent q, source) instead; n_valid counts it once per alive child.
    Returns (tgt, src, [p2_tgt, p2_src,] n_valid, overflow)."""
    levels_s, levels_t = stree.levels, ttree.levels
    nleaf_s, nleaf_t = 1 << levels_s, 1 << levels_t
    W = frontier_width
    dev = ttree.x.device
    n_pad_t = nleaf_t * ttree.block_size
    classify, prep = _mk_classifier(stree, ttree, theta, nleaf_s,
                                    mac_geometry)

    def live_rows(l: int) -> int:
        if not n_live:
            return 1 << l
        return min(1 << l, -(-n_live // (n_pad_t >> l)))

    all_tgt: List[torch.Tensor] = []
    all_src: List[torch.Tensor] = []
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    total_valid, overflow = zero, zero
    cand = torch.zeros((1, W), dtype=torch.int64, device=dev)
    cand[0, 0].fill_(1)     # root vs root (a fill: no copy from the host)
    p2 = None
    for l in range(levels_t + 1):
        nt = 1 << l
        rows = live_rows(l)
        tgt_ids = torch.arange(nt, nt + rows, dtype=torch.int64, device=dev)
        t_is_leaf = l == levels_t
        if not n_live:
            cand = torch.where(ttree.alive[nt:nt + rows][:, None], cand, 0)
        if t_is_leaf and levels_s <= levels_t:
            # every candidate is a source leaf and leaf-leaf pairs always
            # accept: rows are already front-packed by the last compaction
            out = cand
            total_valid = total_valid + (out != 0).sum()
        else:
            tgeo = prep(ttree.x[nt:nt + rows], ttree.nr[nt:nt + rows])
            accept, expand, defer = classify(cand, tgeo, t_is_leaf)
            out = torch.where(accept, cand, 0)
            if t_is_leaf:
                # deep source tree: refine remaining interior sources
                out_ext = cand.new_zeros((rows, W + 1))
                out_cnt = cand.new_zeros((rows,))
                out_ext, out_cnt, ov0 = _append_rows(
                    out_ext, out_cnt, _ext_src(out, nleaf_s, src_parts))
                overflow = overflow + ov0
                for _ in range(levels_s - levels_t):
                    kids = torch.cat([torch.where(expand, 2 * cand, 0),
                                      torch.where(expand, 2 * cand + 1, 0)],
                                     dim=1)
                    cand, ovc = _compact_rows(kids, W, compact)
                    overflow = overflow + ovc
                    accept, expand, defer = classify(cand, tgeo, True)
                    out_ext, out_cnt, ovc = _append_rows(
                        out_ext, out_cnt,
                        _ext_src(torch.where(accept, cand, 0), nleaf_s,
                                 src_parts))
                    overflow = overflow + ovc
                overflow = overflow + expand.sum()
                out = out_ext[:, :W]
                total_valid = total_valid + out_cnt.sum()
            else:
                out, ovc = _compact_rows(_ext_src(out, nleaf_s, src_parts),
                                         W, compact)
                overflow = overflow + ovc + expand.sum()
                total_valid = total_valid + (out != 0).sum()
        all_tgt.append(tgt_ids[:, None].expand(rows, out.shape[1])
                       .reshape(-1))
        all_src.append(out.reshape(-1))
        if t_is_leaf:
            break
        for j in range(1, tgt_parts):
            # the interior targets' extension rows: the same list
            all_tgt.append((tgt_ids + (j + 1) * nleaf_t)[:, None]
                           .expand(rows, out.shape[1]).reshape(-1))
            all_src.append(out.reshape(-1))
            total_valid = total_valid + (out != 0).sum()
        nxt, ovc = _defer_kids(cand, defer, nleaf_s, W, compact)
        overflow = overflow + ovc
        if leaf_pair2 and l == levels_t - 1:
            ch_alive = ttree.alive[2 * nt:2 * nt + 2 * rows].view(rows, 2)
            n_ch = ch_alive.sum(1)
            p2 = (tgt_ids[:, None].expand_as(nxt).reshape(-1),
                  nxt.reshape(-1))
            total_valid = total_valid + ((nxt != 0) * n_ch[:, None]).sum()
            break
        cand = torch.repeat_interleave(nxt, 2, dim=0)[:live_rows(l + 1)]

    tgt, src = torch.cat(all_tgt), torch.cat(all_src)
    if leaf_pair2:
        return tgt, src, p2[0], p2[1], total_valid, overflow
    return tgt, src, total_valid, overflow


def _dtt_lists_refine(stree: Tree, ttree: Tree, theta: float,
                      frontier_width: int, list_width: int,
                      src_parts: int = 1, tgt_parts: int = 1):
    """The refine-the-larger dual-tree traversal (reference _dtt_lists,
    ongrav3d.cpp:307-402): for each target level, an inner loop expands
    the non-separated sources the target is not bigger than, and defers
    the rest (source leaves, bigger targets) to the target's children.
    The MAC is the reference's classify: exact CMs and radii, dist /
    (snr + tnr) > theta.

    The reference's inner while_loop stops once no source expands, or
    after levels_s + 2 rounds, then flushes the last round's accepts and
    defers. Here the loop runs levels_s + 2 rounds always, with no host
    read: once no source expands, a round appends exactly what the flush
    would, in the same order, and leaves no candidate, so the rounds
    after it and the flush append nothing and the lists are the
    reference's id for id. As there, expands left at the round bound are
    dropped without counting as overflow. Returns (tgt, src, n_valid,
    overflow): every target row's list_width slots, level by level, each
    interior level's rows followed by its extension rows' copies."""
    levels_s, levels_t = stree.levels, ttree.levels
    nleaf_s, nleaf_t = 1 << levels_s, 1 << levels_t
    W, K = frontier_width, list_width
    dev = ttree.x.device
    pd = stree.nc.shape[1]
    th = torch.full((), theta, dtype=stree.nc.dtype, device=dev)
    all_tgt: List[torch.Tensor] = []
    all_src: List[torch.Tensor] = []
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    total_valid, overflow = zero, zero
    cand = torch.zeros((1, W), dtype=torch.int64, device=dev)
    cand[0, 0].fill_(1)     # root vs root (a fill: no copy from the host)
    for l in range(levels_t + 1):
        nt = 1 << l
        tgt_ids = torch.arange(nt, 2 * nt, dtype=torch.int64, device=dev)
        t_is_leaf = l == levels_t
        tnr = ttree.nr[nt:2 * nt]
        tcm = ttree.x[nt:2 * nt]
        cand = torch.where(ttree.alive[nt:2 * nt][:, None], cand, 0)

        def classify(cand):
            valid = cand != 0
            s_is_leaf = cand >= nleaf_s
            snr = stree.nr[cand]
            d2 = None
            for d in range(pd):
                diff = stree.x[:, d][cand] - tcm[:, None, d]
                d2 = diff * diff if d2 is None else d2 + diff * diff
            sep = torch.sqrt(d2) / (snr + tnr[:, None]) > th
            accept = valid & ((s_is_leaf & t_is_leaf) | sep)
            if t_is_leaf:
                # the target cannot refine: expand interior sources
                return accept, valid & ~accept & ~s_is_leaf, \
                    torch.zeros_like(valid)
            bigger = tnr[:, None] > snr
            return (accept, valid & ~accept & ~s_is_leaf & ~bigger,
                    valid & ~accept & (s_is_leaf | bigger))

        out = cand.new_zeros((nt, K + 1))
        out_cnt = cand.new_zeros((nt,))
        defer_out = cand.new_zeros((nt, W + 1))
        defer_cnt = cand.new_zeros((nt,))
        accept, expand, defer = classify(cand)
        for _ in range(levels_s + 2):
            out, out_cnt, ov1 = _append_rows(
                out, out_cnt, _ext_src(torch.where(accept, cand, 0),
                                       nleaf_s, src_parts))
            defer_out, defer_cnt, ov2 = _append_rows(
                defer_out, defer_cnt, torch.where(defer, cand, 0))
            kids = torch.cat([torch.where(expand, 2 * cand, 0),
                              torch.where(expand, 2 * cand + 1, 0)], dim=1)
            cand, ov3 = _compact_rows(kids, W)
            overflow = overflow + ov1 + ov2 + ov3
            accept, expand, defer = classify(cand)
        # the flush: what the last round left (nothing, unless it hit the
        # round bound)
        out, out_cnt, ov1 = _append_rows(
            out, out_cnt, _ext_src(torch.where(accept, cand, 0), nleaf_s,
                                   src_parts))
        defer_out, defer_cnt, ov2 = _append_rows(
            defer_out, defer_cnt, torch.where(defer, cand, 0))
        overflow = overflow + ov1 + ov2
        rows = tgt_ids[:, None].expand(nt, K).reshape(-1)
        all_tgt.append(rows)
        all_src.append(out[:, :K].reshape(-1))
        total_valid = total_valid + out_cnt.sum()
        if tgt_parts > 1 and not t_is_leaf:
            for j in range(1, tgt_parts):
                all_tgt.append(rows + (j + 1) * nleaf_t)
                all_src.append(out[:, :K].reshape(-1))
                total_valid = total_valid + out_cnt.sum()
        if not t_is_leaf:
            # children inherit the deferred list (ongrav3d.cpp:418-422)
            cand = torch.repeat_interleave(defer_out[:, :W], 2, dim=0)
    return torch.cat(all_tgt), torch.cat(all_src), total_valid, overflow


def build_dtt_pairs(stree: Tree, ttree: Tree, theta: float,
                    frontier_width: int = 256, list_width: int = 256,
                    src_parts: int = 1, tgt_parts: int = 1) -> PairList:
    """The refine-the-larger DTT pair list (dtt_traversal 'refine',
    reference build_dtt_pairs); slot width list_width; src_parts /
    tgt_parts the rows a source's / target's proxy grid spans."""
    tgt, src, nv, ov = _dtt_lists_refine(stree, ttree, theta,
                                         frontier_width, list_width,
                                         src_parts, tgt_parts)
    return PairList(tgt=tgt, src=src, n_valid=nv, overflow=ov)


def top_prefix_len(split: int, levels_t: int, W: int) -> int:
    """Flat pair-list length of target levels 0..split-1 of a level list
    W slots a row (the replicated top prefix of the sharded and chunked
    decompositions; reference top_prefix_len). levels_t is unused, as
    in the reference."""
    return sum((1 << l) * W for l in range(split))


def _dtt_lists_top(stree: Tree, ttree: Tree, theta: float, levels_s: int,
                   split: int, frontier_width: int,
                   mac_geometry: str = "quant"):
    """Simultaneous descent of target levels 0..split-1 only (reference
    _dtt_lists_top), the prefix shared by every subtree of the chunked
    solve (traverse/chunked.py). Returns (tgt, src, cand, overflow):
    the top levels' pairs (global ids, tgt on pad slots too) and the
    deferred candidate rows (2^split, W) of the level-`split` subtree
    roots, from which each subtree continues its own descent. Needs
    split < levels_t (the roots are not leaves); at split 0 the lists
    are empty and the row is the root's own, [1, 0, ...]."""
    W = frontier_width
    dev = ttree.x.device
    nleaf_s = 1 << levels_s
    classify, prep = _mk_classifier(stree, ttree, theta, nleaf_s,
                                    mac_geometry)
    all_tgt: List[torch.Tensor] = []
    all_src: List[torch.Tensor] = []
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    cand = torch.zeros((1, W), dtype=torch.int64, device=dev)
    cand[0, 0].fill_(1)
    for l in range(split):
        nt = 1 << l
        tgeo = prep(ttree.x[nt:2 * nt], ttree.nr[nt:2 * nt])
        cand = torch.where(ttree.alive[nt:2 * nt][:, None], cand, 0)
        accept, expand, defer = classify(cand, tgeo, False)
        out, ovc = _compact_rows(torch.where(accept, cand, 0), W)
        overflow = overflow + ovc + expand.sum()
        all_tgt.append(torch.arange(nt, 2 * nt, dtype=torch.int64,
                                    device=dev)[:, None].expand(nt, W)
                       .reshape(-1))
        all_src.append(out.reshape(-1))
        nxt, ovc = _defer_kids(cand, defer, nleaf_s, W)
        overflow = overflow + ovc
        cand = torch.repeat_interleave(nxt, 2, dim=0)
    if not split:
        # no top levels: the root's own row is the one subtree's start
        none = cand.new_zeros((0,))
        return none, none, cand, overflow
    return torch.cat(all_tgt), torch.cat(all_src), cand, overflow


def _dtt_lists_sub(stree: Tree, ttree: Tree, theta: float, cand0,
                   root: int, levels_s: int, levels_t: int, split: int,
                   frontier_width: int, mac_geometry: str = "quant",
                   leaf_pair2: bool = False):
    """Continue the descent for the one target subtree rooted at node
    `root` (level `split`) from its deferred row cand0 (1, W) (reference
    _dtt_lists_sub). Emits GLOBAL (tgt, src) pairs for target levels
    split..levels_t of the subtree, tgt 0 on pad slots. Returns (tgt,
    src, n_valid, overflow).

    leaf_pair2: the leaf level's candidates would be the parents' rows
    repeated twice with a vacuous classify, so emit one parent-keyed
    list (p2_tgt, p2_src) instead, each entry standing for both children
    leaf pairs; n_valid counts it once per alive child. Needs levels_s
    <= levels_t and split <= levels_t - 1. Returns (tgt, src, p2_tgt,
    p2_src, n_valid, overflow)."""
    if leaf_pair2 and not (levels_s <= levels_t and split <= levels_t - 1):
        raise ValueError("leaf_pair2 needs levels_s <= levels_t and a "
                         "subtree root above the leaves")
    W = frontier_width
    dev = ttree.x.device
    nleaf_s = 1 << levels_s
    classify, prep = _mk_classifier(stree, ttree, theta, nleaf_s,
                                    mac_geometry)
    all_tgt: List[torch.Tensor] = []
    all_src: List[torch.Tensor] = []
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    total_valid, overflow = zero, zero
    cand = cand0
    for l in range(split, levels_t + 1):
        w = 1 << (l - split)
        id0 = root << (l - split)
        tgt_ids = torch.arange(id0, id0 + w, dtype=torch.int64, device=dev)
        t_is_leaf = l == levels_t
        cand = torch.where(ttree.alive[id0:id0 + w][:, None], cand, 0)
        if t_is_leaf and levels_s <= levels_t:
            # every candidate is a source leaf: leaf-leaf pairs accept
            out = cand
            total_valid = total_valid + (out != 0).sum()
        else:
            tgeo = prep(ttree.x[id0:id0 + w], ttree.nr[id0:id0 + w])
            accept, expand, defer = classify(cand, tgeo, t_is_leaf)
            out = torch.where(accept, cand, 0)
            if t_is_leaf:
                # deep source tree: refine remaining interior sources
                out_ext = cand.new_zeros((w, W + 1))
                out_cnt = cand.new_zeros((w,))
                out_ext, out_cnt, ov0 = _append_rows(out_ext, out_cnt, out)
                overflow = overflow + ov0
                for _ in range(levels_s - levels_t):
                    kids = torch.cat([torch.where(expand, 2 * cand, 0),
                                      torch.where(expand, 2 * cand + 1, 0)],
                                     dim=1)
                    cand, ovc = _compact_rows(kids, W)
                    overflow = overflow + ovc
                    accept, expand, defer = classify(cand, tgeo, True)
                    out_ext, out_cnt, ovc = _append_rows(
                        out_ext, out_cnt, torch.where(accept, cand, 0))
                    overflow = overflow + ovc
                overflow = overflow + expand.sum()
                out = out_ext[:, :W]
                total_valid = total_valid + out_cnt.sum()
            else:
                out, ovc = _compact_rows(out, W)
                overflow = overflow + ovc + expand.sum()
                total_valid = total_valid + (out != 0).sum()
        all_tgt.append(torch.where(out != 0, tgt_ids[:, None], 0)
                       .reshape(-1))
        all_src.append(out.reshape(-1))
        if t_is_leaf:
            break
        nxt, ovc = _defer_kids(cand, defer, nleaf_s, W)
        overflow = overflow + ovc
        if leaf_pair2 and l == levels_t - 1:
            # a dead right sibling is evaluated too (its rows are never
            # read) but not counted: reals sort first, so count each
            # parent's alive children
            n_ch = ttree.alive[2 * id0:2 * id0 + 2 * w].view(w, 2).sum(1)
            total_valid = total_valid + ((nxt != 0) * n_ch[:, None]).sum()
            p2_tgt = torch.where(nxt != 0, tgt_ids[:, None], 0).reshape(-1)
            return (torch.cat(all_tgt), torch.cat(all_src), p2_tgt,
                    nxt.reshape(-1), total_valid, overflow)
        cand = torch.repeat_interleave(nxt, 2, dim=0)
    return torch.cat(all_tgt), torch.cat(all_src), total_valid, overflow


def build_dtt_pairs_level(stree: Tree, ttree: Tree, theta: float,
                          frontier_width: int = 128,
                          mac_geometry: str = "quant",
                          n_live: int = 0,
                          compact: str = "scatter", src_parts: int = 1,
                          tgt_parts: int = 1) -> PairList:
    """Simultaneous-descent DTT pair list; slot width frontier_width;
    `compact` orders each row (_compact_rows); src_parts / tgt_parts the
    rows a source's / target's proxy grid spans."""
    tgt, src, nv, ov = _dtt_lists_level(stree, ttree, theta,
                                        frontier_width, mac_geometry,
                                        n_live, compact=compact,
                                        src_parts=src_parts,
                                        tgt_parts=tgt_parts)
    return PairList(tgt=tgt, src=src, n_valid=nv, overflow=ov)


def build_dtt_pairs_level2(stree: Tree, ttree: Tree, theta: float,
                           frontier_width: int = 128,
                           mac_geometry: str = "quant",
                           n_live: int = 0, compact: str = "scatter",
                           src_parts: int = 1, tgt_parts: int = 1
                           ) -> Tuple[PairList, PairList]:
    """DTT lists with sibling-paired leaf emission. Returns (interior,
    leaf2): interior holds target levels 0..levels_t-1 (with the
    extension rows of split grids), leaf2 one entry per (target PARENT
    q, source leaf) standing for rows 2q and 2q+1. interior.n_valid is
    the combined pair count."""
    if stree.levels > ttree.levels or ttree.levels < 1:
        raise ValueError("leaf_pair2 needs levels_s <= levels_t >= 1")
    tgt, src, p2t, p2s, nv, ov = _dtt_lists_level(
        stree, ttree, theta, frontier_width, mac_geometry, n_live,
        leaf_pair2=True, compact=compact, src_parts=src_parts,
        tgt_parts=tgt_parts)
    interior = PairList(tgt=tgt, src=src, n_valid=nv, overflow=ov)
    leaf2 = PairList(tgt=p2t, src=p2s, n_valid=(p2s != 0).sum(),
                     overflow=torch.zeros_like(ov))
    return interior, leaf2


def _seg_rank(flag, is_start):
    """Within-run rank among flagged entries (0-based, valid where flag)
    (reference _seg_rank)."""
    f = flag.long()
    c = torch.cumsum(f, 0)
    excl = c - f
    base = torch.cummax(torch.where(is_start, excl, 0), 0).values
    return c - 1 - base


def _emit_groups(pt, ps, accept, is_start, group: int, cap_g: int):
    """G-wide groups from the accepted entries of a flat run list
    (reference _emit_groups): a target's groups stay consecutive.
    Returns (out_t (cap_g,), out_s (cap_g, G), entries past cap_g)."""
    slot = _seg_rank(accept, is_start) % group
    gstart = accept & (slot == 0)
    gid = torch.cumsum(gstart.long(), 0) - 1
    ok = accept & (gid < cap_g)
    overflow = (accept & (gid >= cap_g)).sum()
    out_t = pt.new_zeros((cap_g + 1,)).index_put_(
        (torch.where(gstart & ok, gid, cap_g),), pt)[:cap_g]
    flat = torch.where(ok, gid * group + slot, cap_g * group)
    out_s = ps.new_zeros((cap_g * group + 1,)).index_put_(
        (flat,), torch.where(ok, ps, 0))[:cap_g * group]
    return out_t, out_s.view(cap_g, group), overflow


def _compact_groups(tgt, src, cap: int, group: int, slot_width: int):
    """Flat (tgt, src) builder rows -> G-wide chunks; chunks with a
    valid source survive, front-packed in order, padded/truncated to
    cap. Returns (tgt (cap,), src (cap, G), n_valid, dropped chunks), the
    counts as tensors. The reference's 'scatter' mover: each kept chunk's
    place from a cumsum, one scatter into cap + 1 rows whose last is the
    dump of the dropped tail, so nothing waits on the host."""
    if slot_width % group:
        raise ValueError(f"slot width {slot_width} is not a multiple of "
                         f"the group {group}")
    n_valid = (src != 0).sum()
    tgt_c = tgt.view(-1, group)[:, 0]
    src_c = src.view(-1, group)
    keep = (src_c != 0).any(1)
    pos = torch.cumsum(keep, 0) - 1
    pos = torch.where(keep & (pos < cap), pos, cap)
    out_t = tgt.new_zeros((cap + 1,)).scatter_(0, pos, tgt_c)
    out_s = src.new_zeros((cap + 1, group)).scatter_(
        0, pos[:, None].expand(-1, group), src_c)
    return (out_t[:cap], out_s[:cap], n_valid,
            (keep.sum() - cap).clamp(min=0))


def group_pairs(pl: PairList, cap: int, group: int,
                slot_width: int) -> PairGroups:
    """Builder output -> G-wide grouped chunks for the executor (the
    reference's 'scatter' and 'sort' movers give the same groups)."""
    tgt, src, n, dropped = _compact_groups(pl.tgt, pl.src, cap, group,
                                           slot_width)
    return PairGroups(tgt=tgt, src=src, n_valid=n,
                      overflow=pl.overflow + dropped * group)
