"""Level-synchronous k-d tree construction (port of onbody_tpu/tree/build.py).

Particles are padded so the leaf count is a power of two and every leaf
holds exactly `block_size` particles; the tree is the implicit complete
binary tree (root 1, children 2i/2i+1, leaves [nleaf, 2*nleaf)). Each
split level sorts every live segment along its longest axis (over real
particles) with one stable torch.sort of a (segment, coordinate) key.

The reference's TPU schedules of the same result — paired stacked sorts,
deferred radius/strength gathers, fused dispatches — collapse into this
one path: radii and strengths never influence a split, so they are
gathered once through the final permutation. Its slicing rules are kept
because they decide where the pad clones end up (and hence gidx): dead
(all-pad) segments are never sorted, and from PREFIX_SORT_MIN real
particles on only the real prefix of the partial segment is.

Node boxes are the real-particle boxes of each level's segments. Later
sorts only permute inside deeper segments, so they are computed once
from the final order; the same holds for the sorts `refine` adds below
the leaf level.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from onbody_tpu_torch.parts import Parts, pad_to

# from this many real particles on the reference sorts only the real
# prefix of the partial segment (build._split_step_impl prefix slicing)
PREFIX_SORT_MIN = 1 << 18
_BIG = 3.0e38


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x - 1).bit_length())


@dataclasses.dataclass
class Tree:
    """Per-node arrays of shape (2*nleaf, ...); index 0 unused, root 1,
    leaves [nleaf, 2*nleaf) (reference Tree)."""

    nc: torch.Tensor      # (NN, PD) geometric centers
    ns: torch.Tensor      # (NN, PD) box sizes
    nr: torch.Tensor      # (NN,)    node radius = 0.5*|ns|
    x: torch.Tensor       # (NN, PD) center of |strength|-weighted mass
    s: torch.Tensor       # (NN, SD) summed strengths
    pr: torch.Tensor      # (NN,)    mean particle radius
    alive: torch.Tensor   # (NN,) bool — node holds >= 1 real particle
    levels: int
    block_size: int

    @property
    def nleaf(self) -> int:
        return 1 << self.levels

    def level_slice(self, l: int) -> slice:
        return slice(1 << l, 1 << (l + 1))


TREE_FIELDS = ("nc", "ns", "nr", "x", "s", "pr", "alive")


def merge_top_levels(arr, w_roots: torch.Tensor, split: int) -> None:
    """finishTree's interior merge (barneshut.hpp:733-746) for the levels
    < split of a global tree whose levels >= split hold the 2^split
    subtrees (the capacity tiers' assembly), in place. arr maps
    TREE_FIELDS to (NN, ...) tensors; w_roots (2^split,) the subtree
    roots' weights, in the type the merge computes in. A parent's box is
    the union of its alive children's: a dead child sits at the far
    point with a zero box, which must not widen it."""
    ndev = 1 << split
    w = w_roots
    cm = arr["x"][ndev:2 * ndev]
    s = arr["s"][ndev:2 * ndev]
    pr = arr["pr"][ndev:2 * ndev]
    al = arr["alive"][ndev:2 * ndev]
    lo = arr["nc"][ndev:2 * ndev] - 0.5 * arr["ns"][ndev:2 * ndev]
    hi = arr["nc"][ndev:2 * ndev] + 0.5 * arr["ns"][ndev:2 * ndev]
    for l in range(split - 1, -1, -1):
        w0, w1 = w[0::2], w[1::2]
        wp = w0 + w1
        safe = 1e-20 + wp
        any_w = wp > 1e-12
        cm = torch.where(any_w[:, None],
                         (cm[0::2] * w0[:, None] + cm[1::2] * w1[:, None])
                         / safe[:, None], 0.5 * (cm[0::2] + cm[1::2]))
        pr = torch.where(any_w, (pr[0::2] * w0 + pr[1::2] * w1) / safe,
                         0.5 * (pr[0::2] + pr[1::2]))
        s = s[0::2] + s[1::2]
        a0, a1 = al[0::2, None], al[1::2, None]
        lo = torch.where(a0 & a1, torch.minimum(lo[0::2], lo[1::2]),
                         torch.where(a0, lo[0::2], lo[1::2]))
        hi = torch.where(a0 & a1, torch.maximum(hi[0::2], hi[1::2]),
                         torch.where(a0, hi[0::2], hi[1::2]))
        al = al[0::2] | al[1::2]
        w = wp
        sl = slice(1 << l, 2 << l)
        arr["x"][sl] = cm
        arr["s"][sl] = s
        arr["pr"][sl] = pr
        arr["nc"][sl] = 0.5 * (lo + hi)
        arr["ns"][sl] = hi - lo
        arr["nr"][sl] = 0.5 * torch.sqrt(((hi - lo) ** 2).sum(1))
        arr["alive"][sl] = al


def plan(n: int, block_size: int) -> Tuple[int, int]:
    """(levels, n_pad): power-of-two leaves of exactly block_size."""
    nleaf = next_pow2(max(1, -(-n // block_size)))
    return nleaf.bit_length() - 1, nleaf * block_size


def _sort_levels(sort_levels: int, n_pad: int, q: int, span_top: int,
                 span_bot: Optional[int]) -> List[int]:
    """Levels that sort, in order (the reference's _build_schedule walk:
    span mode lets one sort serve q levels down to span_top)."""
    out, l = [], 0
    while l != sort_levels and (n_pad >> l) >= 2:
        out.append(l)
        l += 1
        if l <= span_top or (span_bot is not None and l >= span_bot):
            for _ in range(q - 1):
                if l == sort_levels or (n_pad >> l) < 2:
                    break
                l += 1
    return out


def _ordered_u32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) with the float order."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= (1 << 31), (~b) & 0xFFFFFFFF, b | (1 << 31))


def _masked_box(xs: torch.Tensor, mask: torch.Tensor):
    """(nseg, m, pd) positions, (nseg, m) real mask -> per-segment
    (lo, hi) over real particles (every caller's segments hold one)."""
    mk = mask[..., None]
    lo = torch.where(mk, xs, _BIG).amin(dim=1)
    hi = torch.where(mk, xs, -_BIG).amax(dim=1)
    return lo, hi


def _fma_sumsq(v: torch.Tensor) -> torch.Tensor:
    """Row sums of squares of float32 (n, k), accumulated as the chain
    fma(v_k, v_k, ... fma(v_1, v_1, v_0 * v_0)) that the reference's
    compiled reduction computes: each product is exact in float64 and
    each step is rounded to float32 (through float64, so a rare last
    bit can still differ from a true fma). float64 rows sum in the same
    order in float64."""
    if v.dtype == torch.float64:
        acc = v[:, 0] * v[:, 0]
        for d in range(1, v.shape[1]):
            acc = v[:, d] * v[:, d] + acc
        return acc
    acc = (v[:, 0] * v[:, 0]).double()
    for d in range(1, v.shape[1]):
        w = v[:, d].double()
        acc = (w * w + acc).float().double()
    return acc.float()


def _live(n_pad: int, l: int, n_real: int) -> int:
    """Segments of level l that hold a real particle (reals sort first)."""
    return min(1 << l, -(-n_real // (n_pad >> l)))


def _split(x: torch.Tensor, gidx: torch.Tensor, n_real: int, l: int):
    """One median-split level, in place: sort each live segment of
    m = n_pad >> l slots along its longest real-particle axis."""
    n_pad, pd = x.shape
    nseg, m = 1 << l, n_pad >> l
    live = _live(n_pad, l, n_real)
    full = min(nseg, n_real // m)
    end = (n_real if n_real >= PREFIX_SORT_MIN and full < nseg
           else live * m)
    xs = x[:live * m].view(live, m, pd)
    lo, hi = _masked_box(xs, (gidx[:live * m] < n_real).view(live, m))
    axis = torch.argmax(hi - lo, dim=1)
    ids = torch.arange(end, device=x.device)
    seg = ids // m
    v = x[ids, axis[seg]]
    if x.dtype == torch.float32:
        order = torch.sort((seg << 32) | _ordered_u32(v), stable=True).indices
    else:
        # float64 storage: by value, then (stably) by segment
        by_v = torch.sort(v, stable=True).indices
        order = by_v[torch.sort(seg[by_v], stable=True).indices]
    x[:end] = x[:end][order]
    gidx[:end] = gidx[:end][order]


def _upward_stats(x, r, s, mask, levels: int, block_size: int, sd: int,
                  are_targets: bool, n_live: int):
    """Leaf + interior centers of mass, strength sums, mean radii over
    the live leaf prefix (reference build._upward_stats, n_live slicing):
    |strength| weights for sources, the real mask for targets."""
    nleaf = 1 << levels
    nn = 2 * nleaf
    pd = x.shape[1]
    dtype, dev = x.dtype, x.device
    lleaf = min(nleaf, -(-n_live // block_size))

    cm_all = torch.zeros((nn, pd), dtype=dtype, device=dev)
    s_all = torch.zeros((nn, max(sd, 1)), dtype=dtype, device=dev)
    pr_all = torch.zeros((nn,), dtype=dtype, device=dev)
    alive_all = torch.zeros((nn,), dtype=torch.bool, device=dev)

    lb = lleaf * block_size
    xs = x[:lb].view(lleaf, block_size, pd)
    maskf = mask[:lb].view(lleaf, block_size).to(dtype)
    if s is not None and not are_targets:
        ss = s[:lb].view(lleaf, block_size, sd)
        w = ss[..., 0].abs() if sd == 1 else ss.square().sum(-1).sqrt()
    else:
        w = maskf
    wsum = w.sum(1)
    leaf_cm = (torch.einsum("lbp,lb->lp", xs, w)
               / (1e-20 + wsum[:, None]))
    leaf_cm = torch.where((wsum > 1e-12)[:, None], leaf_cm, xs.mean(1))
    leaf_s = (s[:lb].view(lleaf, block_size, sd).sum(1) if s is not None
              else torch.zeros((lleaf, 1), dtype=dtype, device=dev))
    rs = r[:lb].view(lleaf, block_size)
    msum = maskf.sum(1)
    leaf_pr = torch.where(msum > 0, (rs * maskf).sum(1) / (1e-20 + msum),
                          rs.mean(1))
    alive_l = msum > 0
    cm_all[nleaf:nleaf + lleaf] = leaf_cm
    s_all[nleaf:nleaf + lleaf] = leaf_s
    pr_all[nleaf:nleaf + lleaf] = leaf_pr
    alive_all[nleaf:nleaf + lleaf] = alive_l

    def pad_even(a):
        # the merge takes children two at a time: pad an odd live prefix
        # with one dead (zero-weight) row
        if a.shape[0] % 2 == 0:
            return a
        return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])

    cm_l, s_l, pr_l, w_l = (pad_even(leaf_cm), pad_even(leaf_s),
                            pad_even(leaf_pr), pad_even(wsum))
    alive_l = pad_even(alive_l)
    for l in range(levels - 1, -1, -1):
        nseg = 1 << l
        w0, w1 = w_l[0::2], w_l[1::2]
        wp = w0 + w1
        safe = 1e-20 + wp
        any_w = wp > 1e-12
        cm_m = (cm_l[0::2] * w0[:, None] + cm_l[1::2] * w1[:, None]) \
            / safe[:, None]
        cm_l = torch.where(any_w[:, None], cm_m,
                           0.5 * (cm_l[0::2] + cm_l[1::2]))
        pr_m = (pr_l[0::2] * w0 + pr_l[1::2] * w1) / safe
        pr_l = torch.where(any_w, pr_m, 0.5 * (pr_l[0::2] + pr_l[1::2]))
        s_l = s_l[0::2] + s_l[1::2]
        w_l = wp
        alive_l = alive_l[0::2] | alive_l[1::2]
        lseg = cm_l.shape[0]
        cm_all[nseg:nseg + lseg] = cm_l
        s_all[nseg:nseg + lseg] = s_l
        pr_all[nseg:nseg + lseg] = pr_l
        alive_all[nseg:nseg + lseg] = alive_l
        if l:
            cm_l, s_l, pr_l = pad_even(cm_l), pad_even(s_l), pad_even(pr_l)
            w_l, alive_l = pad_even(w_l), pad_even(alive_l)
    return cm_all, s_all, pr_all, alive_all


def build_tree(p: Parts, block_size: int = 128, refine: bool = False,
               mode: str = "median", span: int = 2, span_top: int = 6,
               span_bot: Optional[int] = None, need_r: bool = True,
               force_plan: Optional[Tuple[int, int]] = None
               ) -> Tuple[Tree, Parts, torch.Tensor]:
    """Build the tree; returns (tree, sorted padded parts, gidx).

    gidx[i] is the original index of the particle in slot i (pads have
    gidx >= n_real). mode 'median' sorts every level; 'span' lets one
    sort serve `span` levels for the top `span_top` levels. refine=True
    goes on splitting below the leaf level, log2(n_pad) levels in all,
    so each leaf's slots are ordered as a binary tree of their own (the
    reference's refineTree/refineLeaf ordering, which the pair-merge
    equivalents of order < 0 need); boxes and stats are those of levels
    0..levels, which the finer sorts do not change. need_r=False
    (targets of a kernel that ignores target radii) returns zero radii,
    as the reference does. force_plan=(levels, n_pad) builds a tree of
    that fixed shape even where plan(n, block_size) would give a smaller
    one (the capacity tiers build every subtree at n_pad / 2^split
    slots, so the global implicit tree lines up)."""
    if mode not in ("median", "span"):
        raise NotImplementedError(f"tree mode {mode!r} is not ported: "
                                  "measurement rejected it (onbody_tpu_"
                                  "torch/PARITY.md; ROADMAP.md Queue 1 "
                                  "item 17)")
    n_real = p.n_real
    levels, n_pad = force_plan or plan(n_real, block_size)
    if n_pad < n_real or (1 << levels) * block_size != n_pad:
        raise ValueError(f"force_plan {force_plan}: {n_pad} slots must "
                         f"hold {n_real} particles in 2^levels blocks of "
                         f"{block_size}")
    pp = pad_to(p, n_pad)
    dev = pp.device
    pd = pp.pd
    sd = pp.sd
    x = pp.x.clone()
    gidx = torch.arange(n_pad, dtype=torch.int64, device=dev)
    q = span if mode == "span" else 1
    # refine: the splits go on inside the leaves down to segments of two
    # (the pair-merge equivalents merge adjacent slots)
    sort_levels = n_pad.bit_length() - 1 if refine else levels
    for l in _sort_levels(sort_levels, n_pad, q, span_top, span_bot):
        _split(x, gidx, n_real, l)

    nn = 2 << levels
    nc = torch.zeros((nn, pd), dtype=x.dtype, device=dev)
    ns = torch.zeros((nn, pd), dtype=x.dtype, device=dev)
    root = None
    for l in range(levels + 1):
        live = _live(n_pad, l, n_real)
        m = n_pad >> l
        lo, hi = _masked_box(x[:live * m].view(live, m, pd),
                             (gidx[:live * m] < n_real).view(live, m))
        nc[1 << l:(1 << l) + live] = 0.5 * (lo + hi)
        ns[1 << l:(1 << l) + live] = hi - lo
        if l == 0:
            root = (lo, hi)
    nr = 0.5 * torch.sqrt(_fma_sumsq(ns))

    r = pp.r[gidx] if need_r else torch.zeros_like(pp.r)
    s = pp.s[gidx] if sd else None
    cm, s_sum, pr, alive = _upward_stats(x, r, s, gidx < n_real, levels,
                                         block_size, sd, not p.are_sources,
                                         n_real)

    # dead nodes (pure padding) become zero-size boxes at a far point, so
    # the MAC separates them on their first frontier appearance
    lo0, hi0 = root
    fp = hi0 + 8.0 * (hi0 - lo0).max() + 1.0                  # (1, pd)
    dead = ~alive
    nc = torch.where(dead[:, None], fp, nc)
    ns = torch.where(dead[:, None], 0.0, ns)
    nr = torch.where(dead, 0.0, nr)
    cm = torch.where(dead[:, None], fp, cm)
    pr = torch.where(dead, 0.0, pr)
    tree = Tree(nc=nc, ns=ns, nr=nr, x=cm, s=s_sum, pr=pr, alive=alive,
                levels=levels, block_size=block_size)
    return tree, Parts(x=x, r=r, s=s, n_real=n_real), gidx


def build_trees_paired(ps: Parts, pt: Parts, block_size: int = 128,
                       refine: bool = False, mode: str = "median",
                       span: int = 2, span_top: int = 6,
                       span_bot: Optional[int] = None,
                       need_tgt_r: bool = True):
    """Source and target trees of equal padded size. The reference
    stacks both into one sort sequence and asserts the result equals two
    build_tree calls; here it is two build_tree calls. Returns
    ((stree, src_sorted, sgidx), (ttree, tgt_sorted, tgidx))."""
    if plan(ps.n_real, block_size) != plan(pt.n_real, block_size):
        raise ValueError("paired trees need equal padded sizes")
    kw = dict(block_size=block_size, refine=refine, mode=mode, span=span,
              span_top=span_top, span_bot=span_bot)
    return build_tree(ps, **kw), build_tree(pt, need_r=need_tgt_r, **kw)
