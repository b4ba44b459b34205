"""O(N) dual-tree traversal ("fastsumm") solver (port of
onbody_tpu/traverse/dtt.py).

Lists come from the simultaneous descent (dtt_traversal "level") or
the refine-the-larger walk ("refine"), every interaction
type runs through the one pair executor (far contributions land in the
target equivalent rows of the same accumulator), and the prolongation is
a top-down per-level barycentric interpolation (calcBarycentricDownward,
BarycentricLagrange.hpp:63-166) at order >= 0, a copy from the merged
parent points at order < 0 (pair-merge).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from onbody_tpu_torch.config import SolverConfig, check_supported, pair_backend
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.parts import Parts
from onbody_tpu_torch.tree import equivalents as eq
from onbody_tpu_torch.traverse import exec as pexec
from onbody_tpu_torch.traverse import lists
from onbody_tpu_torch.traverse.treecode import Plan, _leaf_outputs, prepare
from onbody_tpu_torch.utils.timing import phase

# children per prolongation batch: bounds the (nodes, k, j, i, P) temporary
_DOWN_CHUNK = 2048


def _downward(out, tree_nc, tree_ns, tgt_geo, order: int, levels: int,
              block_size: int):
    """Prolong accumulated equivalent-target outputs down the tree, in
    place on out (NN, B, OD): for each level top-down, the children's
    points (proxies, or leaf particles at the bottom) receive the
    parent's equivalent outputs interpolated on the parent grid. With
    split equivalent rows (a grid wider than the row B, reference
    dtt.py:35-114) a node's M grid slots are reassembled from its row and
    its extension rows, and the children's additions go back across the
    same split."""
    pd = tree_nc.shape[-1]
    M = (order + 1) ** pd
    nleaf = 1 << levels
    B = tgt_geo.shape[-1]

    def split(a, lo, hi):
        """[(rows of a holding part j of nodes [lo, hi), its slots)]"""
        return [(a[rows], m) for rows, _, m in
                eq.grid_parts(slice(lo, hi), nleaf, M, B)]

    for l in range(1, levels + 1):
        np_l = 1 << (l - 1)
        for c0 in range(2 * np_l, 4 * np_l, _DOWN_CHUNK):
            c1 = min(c0 + _DOWN_CHUNK, 4 * np_l)
            p0, p1 = c0 // 2, c1 // 2
            pu = torch.cat([u[:, :m] for u, m in split(out, p0, p1)], 1)
            pnc = torch.repeat_interleave(tree_nc[p0:p1], 2, dim=0)
            pns = torch.repeat_interleave(tree_ns[p0:p1], 2, dim=0)
            pu = torch.repeat_interleave(pu, 2, dim=0)
            if l == levels:
                pts = tgt_geo[c0:c1, :pd, :block_size].transpose(1, 2)
                out[c0:c1, :block_size] += eq.prolong_factored(
                    pts, pnc, pns, order, pu)
                continue
            pts = torch.cat([g[:, :pd, :m] for g, m in
                             split(tgt_geo, c0, c1)], 2).transpose(1, 2)
            add = eq.prolong_factored(pts, pnc, pns, order, pu)
            lo = 0
            for u, m in split(out, c0, c1):
                u[:, :m] += add[:, lo:lo + m]
                lo += m
    return out


def _downward_copy(out, levels: int, block_size: int):
    """Order < 0 prolongation, in place on out (NN, B, OD): child point i
    inherits parent equivalent i // 2, left children from the parent's
    first half and right children from its second, the halves merged
    from them (ongrav3d.cpp:241-251, barneshut.hpp:974-976)."""
    bs = block_size
    h = bs // 2
    for l in range(1, levels + 1):
        np_l = 1 << (l - 1)
        pu = out[np_l:2 * np_l, :bs]                     # (np_l, bs, OD)
        left = torch.repeat_interleave(pu[:, :h], 2, dim=1)
        right = torch.repeat_interleave(pu[:, h:], 2, dim=1)
        add = torch.stack([left, right], dim=1).reshape(2 * np_l, bs, -1)
        out[2 * np_l:4 * np_l, :bs] += add
    return out


def fastsumm_stats(raw: lists.PairList, nleaf_s: int, nleaf_t: int,
                   raw2: Optional[lists.PairList] = None):
    """Interaction-type counters {sltl, sbtl, sltb, sbtb} over the pair
    list (the reference's fastsumm_stats, ongrav3d.cpp:193-196). Each
    entry of a sibling-paired leaf list raw2 counts as two leaf-leaf
    pairs (both children, alive or not)."""
    valid = raw.src != 0
    s_leaf = (raw.src >= nleaf_s) & (raw.src < 2 * nleaf_s)
    t_leaf = (raw.tgt >= nleaf_t) & (raw.tgt < 2 * nleaf_t)
    stats = {
        "sltl": (valid & s_leaf & t_leaf).sum(),
        "sbtl": (valid & ~s_leaf & t_leaf).sum(),
        "sltb": (valid & s_leaf & ~t_leaf).sum(),
        "sbtb": (valid & ~s_leaf & ~t_leaf).sum(),
    }
    if raw2 is not None:
        stats["sltl"] = stats["sltl"] + 2 * (raw2.src != 0).sum()
    return stats


def solve_dtt(kernel: Kernel, cfg: SolverConfig, plan: Plan,
              theta: Optional[float] = None, unscramble: bool = True,
              timer=None, checks: Optional[pp.RunChecks] = None):
    """Full evaluation; returns (outputs, info). unscramble=False keeps
    outputs in SORTED (tree) order, (nleaf*block_size, OD) including
    padded slots — the reference drivers' convention; map rows through
    plan.tgt_gidx. cfg.dtt_leaf_pair2 runs the leaf level through the
    sibling-paired executor (on either backend; K2 for a dma-family
    pair_fetch, K9 for 'pregather'; 'static' has no paired form and
    keeps the unpaired leaf level, reference dtt.py:213-224). checks:
    the fused route (solve_dtt_fused): the groups keep their static
    capacity and the executors' id checks go to `checks` on the device
    (exec.exec_pairs). cfg.accum_dtype float64 runs every pass in double
    (K1-f64, the paired leaf list off, as the reference's dtt.py:221);
    orders whose grids exceed the block row split them over extension
    rows (tree/equivalents.py n_eq_parts). dtt_traversal "refine" builds
    lists.build_dtt_pairs' lists, cfg.list_width slots a row, with no
    paired leaf list (reference dtt.py:214-244)."""
    check_supported(cfg, kernel)
    theta = cfg.theta_dtt if theta is None else theta
    stree, ttree = plan.stree, plan.ttree
    # split equivalent rows: both trees share block size and order, so
    # the source and target grids split alike (reference dtt.py:201)
    parts = eq.n_eq_parts(plan.tgt_geo.shape[-1], cfg.order, kernel.pd)
    refine = cfg.dtt_traversal == "refine"
    # the accuracy tier has no paired executor (reference dtt.py:221)
    use_p2 = (cfg.dtt_leaf_pair2 and not refine
              and cfg.pair_fetch != "static"
              and cfg.accum_dtype != torch.float64
              and stree.levels <= ttree.levels and ttree.levels >= 1)
    n_live = plan.tgt_sorted.n_real
    pl2 = None
    slot_width = cfg.list_width if refine else cfg.frontier_width
    kw = dict(n_live=n_live, compact=cfg.list_compact, src_parts=parts,
              tgt_parts=parts)
    with phase(timer, "lists"):
        if refine:
            pl = lists.build_dtt_pairs(stree, ttree, theta,
                                       cfg.frontier_width, cfg.list_width,
                                       src_parts=parts, tgt_parts=parts)
        elif use_p2:
            pl, pl2 = lists.build_dtt_pairs_level2(
                stree, ttree, theta, cfg.frontier_width, cfg.mac_geometry,
                **kw)
        else:
            pl = lists.build_dtt_pairs_level(
                stree, ttree, theta, cfg.frontier_width, cfg.mac_geometry,
                **kw)
    out, info = pexec.exec_pairs(kernel, cfg, plan, pl, slot_width,
                                 cfg.cap_groups_dtt, raw2=pl2, timer=timer,
                                 checks=checks)
    with phase(timer, "downward"):
        if cfg.order >= 0:
            out = _downward(out, ttree.nc, ttree.ns, plan.tgt_geo,
                            cfg.order, ttree.levels, ttree.block_size)
        else:
            out = _downward_copy(out, ttree.levels, ttree.block_size)
    if not unscramble:
        nleaf, bs = ttree.nleaf, ttree.block_size
        return out[nleaf:2 * nleaf, :bs, :].reshape(-1, kernel.od), info
    return _leaf_outputs(out, plan, kernel, plan.tgt_sorted.n_real), info


# ------------------------------------------------------------ fused solve

def _check_fused(cfg: SolverConfig, device) -> None:
    if device.type == "cuda" and pair_backend(cfg) == "torch":
        raise ValueError("solve_dtt_fused on the card runs the kernels: "
                         "pair_backend 'torch' waits on the host")


def fused_eager(kernel: Kernel, cfg: SolverConfig, srcs: Parts,
                targs: Parts, unscramble: bool = True):
    """The fused route run once, eagerly: prepare + solve_dtt with the
    lists at their static capacity and the executors' id checks kept on
    the device. Returns (result, info, word, checks): result and info as
    solve_dtt_fused returns them, word the checks' error codes (one int32
    per executor launch, all 0 when every list passed), checks the
    RunChecks that reads them (checks.raise_for(word.tolist())). Reads
    nothing back from the card: on CUDA tensors nothing in it waits on
    the host."""
    check_supported(cfg, kernel)
    _check_fused(cfg, srcs.x.device)
    checks = pp.RunChecks()
    plan = prepare(kernel, cfg, srcs, targs)
    out, info = solve_dtt(kernel, cfg, plan, unscramble=unscramble,
                          checks=checks)
    res = out if unscramble else (out, plan.tgt_inv)
    return res, info, checks.word(srcs.x.device), checks


def _clone(x):
    """x with every tensor in it copied (tuples and named tuples kept)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _parts_tensors(srcs: Parts, targs: Parts):
    return [t for t in (srcs.x, srcs.r, srcs.s, targs.x, targs.r)
            if t is not None]


class FusedGraph:
    """solve_dtt_fused's program for one key, on the card: the fused route
    (fused_eager) captured as one CUDA graph over static input buffers.

    Built by a warm-up, run eagerly on a side stream with
    torch.cuda.set_sync_debug_mode("error"), so any wait on the host in
    the route raises here instead of being captured; then the capture
    (torch.cuda.graph). warmup_s and capture_s are their host times. Each
    call copies its inputs into the buffers, replays the graph, copies the
    results out of the graph's memory (the next replay overwrites it) and
    reads the checks' word once: the only wait on the host."""

    def __init__(self, kernel: Kernel, cfg: SolverConfig, srcs: Parts,
                 targs: Parts, unscramble: bool):
        dev = srcs.x.device
        self.inputs = [t.clone() for t in _parts_tensors(srcs, targs)]
        it = iter(self.inputs)
        s_in = Parts(x=next(it), r=next(it),
                     s=None if srcs.s is None else next(it),
                     n_real=srcs.n_real)
        t_in = Parts(x=next(it), r=next(it), s=None, n_real=targs.n_real)
        args = (kernel, cfg, s_in, t_in, unscramble)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                fused_eager(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.result, self.info, self.word, self.checks = fused_eager(
                *args)
        torch.cuda.synchronize(dev)
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1

    def __call__(self, srcs: Parts, targs: Parts):
        for buf, t in zip(self.inputs, _parts_tensors(srcs, targs)):
            buf.copy_(t)
        self.graph.replay()
        res, info = _clone(self.result), _clone(self.info)
        self.checks.raise_for(self.word.tolist())
        return res, info


# solve_dtt_fused's graphs by key (clear_fused_cache empties it)
_FUSED = {}


def _fused_key(kernel: Kernel, cfg: SolverConfig, srcs: Parts,
               targs: Parts, unscramble: bool):
    ts = _parts_tensors(srcs, targs)
    return (kernel.name, cfg, srcs.n_real, targs.n_real, unscramble,
            srcs.x.device, tuple((tuple(t.shape), t.dtype) for t in ts))


def fused_graph(kernel: Kernel, cfg: SolverConfig, srcs: Parts,
                targs: Parts, unscramble: bool = True) -> FusedGraph:
    """The cached FusedGraph of solve_dtt_fused's key for these CUDA
    inputs, built (warm-up, capture) when the key is new."""
    check_supported(cfg, kernel)
    _check_fused(cfg, srcs.x.device)
    key = _fused_key(kernel, cfg, srcs, targs, unscramble)
    if key not in _FUSED:
        _FUSED[key] = FusedGraph(kernel, cfg, srcs, targs, unscramble)
    return _FUSED[key]


def clear_fused_cache() -> None:
    """Drop every captured graph of solve_dtt_fused and its memory pool
    (the reference's jax.clear_caches() for its jitted program)."""
    _FUSED.clear()


def solve_dtt_fused(kernel: Kernel, cfg: SolverConfig, srcs: Parts,
                    targs: Parts, unscramble: bool = True):
    """Whole pipeline (tree builds -> equivalents -> lists -> pair
    execution -> downward -> unscramble) as one call with no host wait
    inside it (port of onbody_tpu/traverse/dtt.py:solve_dtt_fused).
    Computes prepare + solve_dtt on the same inputs; returns (out, info),
    or ((out in tree order, plan.tgt_inv), info) with unscramble=False.
    info holds the interior groups at their static capacity, as the
    reference's jitted program keeps them.

    On CUDA tensors the first call for a key (the reference's static
    arguments: kernel, cfg, n_src, n_tgt, unscramble; and the device,
    shapes and dtypes) builds a FusedGraph: a warm-up in which any wait on
    the host raises, then one CUDA graph of the whole route. Every call
    copies the inputs into the graph's buffers, replays it, copies the
    results out (a later call never overwrites them) and reads the
    executors' id checks once, raising the eager wrappers' ValueError if a
    list failed them. A failed capture raises: there is no fallback to the
    split path. The graphs keep every intermediate of the pipeline alive
    between calls (the reference's "peak HBM is higher");
    clear_fused_cache() frees them. On CPU tensors the same route runs
    eagerly on the kernels' twins, with no graph.

    Every pair_fetch runs: the dma family's kernels read the run count
    from device memory, 'pregather' and 'static' plan each gather chunk
    on the card and read its segment counts there
    (cuda_pairs.exec_pairs_capped)."""
    if srcs.x.device.type != "cuda":
        res, info, word, checks = fused_eager(kernel, cfg, srcs, targs,
                                              unscramble)
        checks.raise_for(word.tolist())
        return res, info
    return fused_graph(kernel, cfg, srcs, targs, unscramble)(srcs, targs)
