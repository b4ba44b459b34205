"""Out-of-core DTT solve with host RAM as the capacity tier (port of
onbody_tpu/traverse/outofcore.py).

The same algorithm as the monolithic solve (VAMsplit k-d trees,
barycentric proxies, dual-tree MAC lists, grouped pair execution,
downward prolongation) for particle sets larger than device memory: the
host holds the particles, the source feature rows and the result, the
device computes.

  1. TOP SPLIT (tree/hsplit.py): the top `split` k-d levels are exact
     count-based median splits over streamed, regenerated particle
     chunks; padding is analytic (virtual_pad_slots), so each subtree's
     slot count equals the monolithic padded build's.
  2. PARTITION: one streaming pass per side sorts each chunk by subtree
     id on the device and appends per-subtree runs to host buffers.
  3. SUBTREE BUILDS: each of the 2^split subtrees is built with
     build_tree(force_plan=(levels - split, n_pad / 2^split)) in median
     mode, whatever cfg.tree_mode says, and featurized (the lean rows);
     the local tree and source rows go back to host stores.
  4. TOP ASSEMBLY: the global trees are assembled on the host from the
     local trees (levels >= split are row-range copies, levels < split
     the weighted merges of the reference's finishTree); the top proxies
     continue the barycentric upward pass from the subtree-root grids.
     The global tree geometry is device-resident; the rows and the
     particles stay on the host.
  5. CHUNK LOOP: per alive target subtree, its MAC lists against the
     resident global trees (lists._dtt_lists_top / _dtt_lists_sub), the
     referenced source rows gathered from the host store into one
     compact slab (row 0 the inert pad row), its sorted targets copied
     in, execution (_exec_groups_slab), downward prolongation, and the
     leaf outputs copied back into the host result.

Host stores are numpy arrays. The referenced rows are found on the device
(torch.unique / searchsorted over the chunk's list) and gathered with
numpy fancy indexing on one host thread from pageable memory. With
profile=True the solve prints each phase's and chunk's seconds, the bytes
it copied each way, each chunk's rows, bytes and copy time, the device's
peak memory and the host's peak RSS.
"""

from __future__ import annotations

import resource
import time
from typing import Callable, List, Optional

import numpy as np
import torch

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
from onbody_tpu_torch.tree import build as tree_build
from onbody_tpu_torch.tree import equivalents as eq
from onbody_tpu_torch.tree import hsplit
from onbody_tpu_torch.tree.build import TREE_FIELDS, Tree
from onbody_tpu_torch.utils.device import resolve


def _partition_chunk(cols, idx, nid):
    """Stable-sort a chunk's float columns and original-index column by
    subtree id. Returns (stacked (m, k), idx, nid sorted)."""
    snid, order = torch.sort(nid, stable=True)
    return torch.stack(cols, dim=1)[order], idx[order], snid


class _SidePartition:
    """Host store of one particle side, partitioned by subtree."""

    def __init__(self, store: List[np.ndarray], idx: List[np.ndarray],
                 counts: np.ndarray, lo, hi):
        self.store = store          # per subtree (m_t, k) float32
        self.idx = idx              # per subtree (m_t,) int32 orig index
        self.counts = counts
        self.lo, self.hi = lo, hi


def _partition_side(gen_chunk, chunk_sizes, split: int, n_pad: int,
                    ncols: int, ph=None, moved=None) -> _SidePartition:
    """Top split + host partition of one particle side.

    gen_chunk(c) -> (cols tuple of (m_c,) float32 tensors [x0..x_pd-1,
    ...], x (m_c, pd)), on the device. ncols = number of float columns.
    moved: a dict whose "d2h" entry counts the bytes copied to the
    host."""
    n_chunks = len(chunk_sizes)
    ndev = 1 << split
    lo = hi = None
    for c in range(n_chunks):
        x = gen_chunk(c)[1]
        l = x.amin(dim=0).cpu().numpy()
        h = x.amax(dim=0).cpu().numpy()
        lo = l if lo is None else np.minimum(lo, l)
        hi = h if hi is None else np.maximum(hi, h)
    if ph:
        ph("box")
    dev = x.device

    def gen_codes(c):
        return hsplit.box_codes(gen_chunk(c)[1], lo, hi)

    n = sum(chunk_sizes)
    planes, quotas, axes, nids = hsplit.run_top_split(
        gen_codes, n_chunks, 0, split, lo, hi,
        virtual_pad_slots=n_pad - n, chunk_sizes=list(chunk_sizes))
    if ph:
        ph("top split")

    bincs = [torch.bincount(nids[c].long(), minlength=ndev).cpu().numpy()
             for c in range(n_chunks)]
    counts = np.sum(bincs, axis=0)
    assert (counts <= n_pad // ndev).all(), counts
    store = [np.empty((int(counts[t]), ncols), np.float32)
             for t in range(ndev)]
    idxs = [np.empty((int(counts[t]),), np.int32) for t in range(ndev)]
    offs = np.zeros(ndev, np.int64)
    base = 0
    for c in range(n_chunks):
        cols, _x = gen_chunk(c)
        iota = base + torch.arange(chunk_sizes[c], dtype=torch.int32,
                                   device=dev)
        stacked, sidx, _snid = _partition_chunk(tuple(cols), iota, nids[c])
        host = stacked.cpu().numpy()
        hidx = sidx.cpu().numpy()
        if moved is not None:
            moved["d2h"] += host.nbytes + hidx.nbytes
        b = np.concatenate([[0], np.cumsum(bincs[c])])
        for t in range(ndev):
            k = b[t + 1] - b[t]
            if k:
                store[t][offs[t]:offs[t] + k] = host[b[t]:b[t + 1]]
                idxs[t][offs[t]:offs[t] + k] = hidx[b[t]:b[t + 1]]
                offs[t] += k
        base += chunk_sizes[c]
        nids[c] = None              # free the chunk's subtree ids
    assert (offs == counts).all()
    if ph:
        ph("partition")
    return _SidePartition(store, idxs, counts, lo, hi)


def _glob_to_local_rows(g: np.ndarray, split: int):
    """Map global node ids (>= 2^split region) to (subtree, local tree
    node id). Top ids (< 2^split) return subtree -1."""
    g = g.astype(np.int64)
    l = np.zeros_like(g)
    nz = g > 0
    l[nz] = np.frexp(g[nz].astype(np.float64))[1] - 1
    lam = l - split
    top = l < split
    d = np.where(top, -1, (g - (1 << l)) >> np.maximum(lam, 0))
    lid = np.where(top, g,
                   (1 << np.maximum(lam, 0))
                   + ((g - (1 << l)) - (d << np.maximum(lam, 0))))
    return d.astype(np.int32), lid.astype(np.int64)


def _peak_rss_gb() -> float:
    """The host process's peak resident set (ru_maxrss, KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def solve_dtt_outofcore(kernel: Kernel, cfg: SolverConfig, n: int,
                        gen_srcs_chunk: Callable[[int], Parts],
                        gen_targs_chunk: Callable[[int], Parts],
                        m_chunk: int = 1 << 26, split: int = 6,
                        theta: Optional[float] = None,
                        profile: bool = False,
                        fm_dtype=np.float32, device=None):
    """Full out-of-core DTT evaluation.

    gen_*_chunk(c) -> Parts holding chunk c of the n particles
    (deterministic: the same c must always yield the same particles);
    they are moved to `device` (the CUDA device for None, which raises
    without one; "cpu" runs the kernels' twins). Returns (result, info):
    result is a host dict
      {"out": (nleaf*bs, OD) numpy, the leaf outputs in global sorted
              order,
       "gidx": (nleaf*bs,) numpy, the original index per sorted slot
               (>= n for pad slots)},
    info {"n_valid": int, "overflow": int, and the measurement:
    "phase_s" (seconds per phase), "h2d_bytes", "d2h_bytes",
    "peak_rss_gb", "chunks" (per chunk: rows, bytes, copy seconds)}.

    Needs order >= 0, one equivalent row per node (M <= block_size),
    fp32 accumulation and storage; raises ValueError otherwise."""
    check_supported(cfg, kernel)
    if cfg.order < 0:
        raise ValueError("solve_dtt_outofcore uses the lean barycentric "
                         f"path: order must be >= 0, got {cfg.order}")
    if eq.n_eq_parts(cfg.block_size, cfg.order, kernel.pd) != 1:
        raise ValueError("the out-of-core path needs single-row "
                         "equivalent grids (M <= block_size)")
    if (cfg.accum_dtype, cfg.storage_dtype) != (torch.float32,) * 2:
        raise ValueError("solve_dtt_outofcore runs fp32 storage and "
                         "accumulation")
    if cfg.pair_fetch not in ("pregather", "static"):
        raise ValueError("the out-of-core path stores lean source rows, "
                         "which the gathering fetches read: pair_fetch "
                         f"'pregather' or 'static', got {cfg.pair_fetch!r}")
    dev = resolve(device, "solve_dtt_outofcore")
    theta = cfg.theta_dtt if theta is None else theta
    bs = cfg.block_size
    pd, sd, od = kernel.pd, kernel.sd, kernel.od
    ndev = 1 << split
    levels_glob, n_pad = tree_build.plan(n, bs)
    if levels_glob <= split + 1:
        raise ValueError(f"split {split} needs a deeper tree than "
                         f"{levels_glob} levels")
    levels_loc = levels_glob - split
    n_pad_sub = n_pad // ndev
    nleaf_glob = 1 << levels_glob
    nn_glob = 2 * nleaf_glob
    order = cfg.order
    M = (order + 1) ** pd
    moved = {"h2d": 0, "d2h": 0}
    phase_s, chunk_log = {}, []
    t0 = [time.perf_counter()]

    def ph(label: str):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        phase_s[label] = now - t0[0]
        if profile:
            mem = ""
            if dev.type == "cuda":
                mem = (f"  device peak "
                       f"{torch.cuda.max_memory_allocated(dev) / 2**30:6.2f}"
                       f" GiB")
            print(f"[ooc] {label:22s} {now - t0[0]:8.3f} s  h2d "
                  f"{moved['h2d'] / 2**30:7.3f} GiB  d2h "
                  f"{moved['d2h'] / 2**30:7.3f} GiB  host peak RSS "
                  f"{_peak_rss_gb():7.2f} GiB{mem}", flush=True)
        t0[0] = now

    n_chunks = -(-n // m_chunk)
    sizes = [min(m_chunk, n - c * m_chunk) for c in range(n_chunks)]

    # ---------------------------------------------- partition both sides
    def side_gen(gen, want_r, want_s):
        def g(c):
            p = gen(c)
            x = p.x.to(dev)
            cols = tuple(x[:, d] for d in range(pd))
            if want_r:
                cols += (p.r.to(dev),)
            if want_s:
                s = p.s.to(dev)
                cols += tuple(s[:, d] for d in range(sd))
            return cols, x
        return g

    src_part = _partition_side(side_gen(gen_srcs_chunk, True, True),
                               sizes, split, n_pad, pd + 1 + sd,
                               ph=lambda s: ph(f"src {s}"), moved=moved)
    need_tr = kernel.uses_tr
    tgt_part = _partition_side(side_gen(gen_targs_chunk, need_tr, False),
                               sizes, split, n_pad,
                               pd + (1 if need_tr else 0),
                               ph=lambda s: ph(f"tgt {s}"), moved=moved)

    # ------------------------------------------------- per-subtree builds
    def to_dev(a: np.ndarray) -> torch.Tensor:
        moved["h2d"] += a.nbytes
        return torch.from_numpy(a).to(dev)

    def to_host(t: torch.Tensor) -> np.ndarray:
        a = t.cpu().numpy()
        moved["d2h"] += a.nbytes
        return a

    def build_sub(arr, count, is_src):
        """Build one subtree; returns (tree, sorted parts, gidx, the tree
        on the host)."""
        a = to_dev(arr)
        x = a[:, :pd].contiguous()
        if is_src or need_tr:
            r = a[:, pd].contiguous()
            soff = pd + 1
        else:
            r = torch.full((a.shape[0],), 1e-3, dtype=torch.float32,
                           device=dev)
            soff = pd
        s = a[:, soff:soff + sd].contiguous() if is_src else None
        del a
        p = Parts(x=x, r=r, s=s, n_real=int(count))
        # median mode, whatever cfg.tree_mode: span mode's 4-way splits
        # below the binary top split leave elongated boxes where the MAC
        # separates (ROADMAP Queue 3)
        tree, sp, gl = tree_build.build_tree(
            p, bs, need_r=is_src or need_tr,
            force_plan=(levels_loc, n_pad_sub))
        th = {f: to_host(getattr(tree, f)) for f in TREE_FIELDS}
        return tree, sp, gl, th

    # sources: local trees + rows + root proxies
    src_trees = [None] * ndev
    fm_store: List[Optional[np.ndarray]] = [None] * ndev
    root_grid = np.zeros((ndev, M, pd), np.float32)
    root_eq = np.zeros((ndev, M, sd), np.float32)
    w_sub = np.zeros(ndev, np.float64)
    rfirst_s = np.full(ndev, 1e-3, np.float32)
    for t in range(ndev):
        if src_part.counts[t] == 0:
            continue
        tree, sp, _g, th = build_sub(src_part.store[t],
                                     src_part.counts[t], True)
        fm, rg, re = eq.barycentric_fm(tree, sp, order, kernel.name,
                                       pad8=False, return_root=True)
        fm_store[t] = to_host(fm).astype(fm_dtype, copy=False)
        src_trees[t] = th
        root_grid[t] = to_host(rg)
        root_eq[t] = to_host(re)
        if sd == 1:
            w_sub[t] = float(sp.s.abs().sum())
        else:
            w_sub[t] = float(torch.sqrt((sp.s * sp.s).sum(1)).sum())
        rfirst_s[t] = float(sp.r[0])
        src_part.store[t] = None          # free the unsorted copy
        del tree, sp, fm
    ph("src subtree builds")

    # targets: local trees + sorted particles + global gidx
    tgt_trees = [None] * ndev
    tgt_sorted_x = [None] * ndev
    tgt_sorted_r = [None] * ndev
    tgt_gidx = np.full((nleaf_glob * bs,), np.int32(n), np.int32)
    w_tsub = np.zeros(ndev, np.float64)
    for t in range(ndev):
        if tgt_part.counts[t] == 0:
            continue
        tree, sp, gl, th = build_sub(tgt_part.store[t],
                                     tgt_part.counts[t], False)
        tgt_trees[t] = th
        tgt_sorted_x[t] = to_host(sp.x)
        if need_tr:
            tgt_sorted_r[t] = to_host(sp.r)
        # local sorted slot i holds subtree-local original gl[i];
        # subtree-local j maps to global original idx[t][j]
        gl = to_host(gl)
        real = gl < tgt_part.counts[t]
        gg = np.full(gl.shape, np.int32(n), np.int32)
        gg[real] = tgt_part.idx[t][gl[real]]
        base = t * n_pad_sub
        tgt_gidx[base:base + n_pad_sub] = gg
        w_tsub[t] = float(tgt_part.counts[t])
        tgt_part.store[t] = None
        del tree, sp
    ph("tgt subtree builds")

    # --------------------------------------------------- global assembly
    def assemble(local_trees, w_roots, lo_g, hi_g):
        arr = {
            "nc": np.zeros((nn_glob, pd), np.float32),
            "ns": np.zeros((nn_glob, pd), np.float32),
            "nr": np.zeros((nn_glob,), np.float32),
            "x": np.zeros((nn_glob, pd), np.float32),
            "s": np.zeros((nn_glob, max(sd, 1)), np.float32),
            "pr": np.zeros((nn_glob,), np.float32),
            "alive": np.zeros((nn_glob,), bool),
        }
        diam = float(np.max(hi_g - lo_g))
        fp = hi_g + 8.0 * diam + 1.0
        for t in range(ndev):
            th = local_trees[t]
            for lam in range(levels_loc + 1):
                w = 1 << lam
                gl0 = (1 << (split + lam)) + t * w
                if th is None:
                    arr["nc"][gl0:gl0 + w] = fp[None, :]
                    arr["x"][gl0:gl0 + w] = fp[None, :]
                    continue
                sl = slice(w, 2 * w)
                for f in TREE_FIELDS:
                    arr[f][gl0:gl0 + w] = th[f][sl]
        tree_build.merge_top_levels(
            {f: torch.from_numpy(a) for f, a in arr.items()},
            torch.from_numpy(w_roots), split)
        # dead nodes -> the far point
        dead = ~arr["alive"]
        dead[0] = True
        arr["nc"][dead] = fp[None, :]
        arr["x"][dead] = fp[None, :]
        arr["ns"][dead] = 0.0
        arr["nr"][dead] = 0.0
        arr["alive"][0] = False
        return arr

    sarr = assemble(src_trees, w_sub, src_part.lo, src_part.hi)
    tarr = assemble(tgt_trees, w_tsub, tgt_part.lo, tgt_part.hi)

    def to_tree(arr):
        return Tree(**{f: to_dev(arr[f]) for f in TREE_FIELDS},
                    levels=levels_glob, block_size=bs)

    stree = to_tree(sarr)
    ttree = to_tree(tarr)
    ph("global assembly")

    # top source proxies: continue the upward pass from subtree roots
    top_fm = to_host(eq.top_proxies(stree.nc, stree.ns, to_dev(root_grid),
                                    to_dev(root_eq), rfirst_s, order, bs,
                                    kernel.name)).astype(fm_dtype,
                                                         copy=False)
    ph("top proxies")

    # --------------------------------------------------------- top lists
    W = cfg.frontier_width
    top_t, top_s, cand_roots, ov_top = lists._dtt_lists_top(
        stree, ttree, theta, levels_glob, split, W, cfg.mac_geometry)
    overflow = int(ov_top)
    total_valid = int((top_s != 0).sum())
    ph("top lists")

    glob_all, local = local_rows(levels_glob, ndev)
    loc = torch.from_numpy(local).to(dev, torch.int64)
    g = cfg.pair_group
    rows_chunk = ndev + (2 << levels_loc) - 1
    cap = max(1024, rows_chunk * (cfg.cap_groups_dtt * 8 // g))
    out_host = np.zeros((nleaf_glob * bs, od), np.float32)
    backend = _resolve_shard_backend(cfg)
    wleaf = 1 << levels_loc
    leaf0_loc = ndev + wleaf - 1

    for c in range(ndev):
        if tgt_trees[c] is None:
            continue
        root = ndev + c
        sub_t, sub_s, nv, ovc = lists._dtt_lists_sub(
            stree, ttree, theta, cand_roots[c:c + 1], root, levels_glob,
            levels_glob, split, W, cfg.mac_geometry)
        tl = torch.cat([top_t, loc[sub_t]])
        sl = torch.cat([top_s, sub_s])
        del sub_t, sub_s
        total_valid += int(nv)
        overflow += int(ovc)

        # the referenced rows, found on the device, gathered on the host
        # into one compact slab (row 0 the inert pad row)
        u = torch.unique(sl)
        u = u[1:] if u.numel() and int(u[0]) == 0 else u
        u_h = to_host(u)
        slab = np.empty((len(u_h) + 1,) + top_fm.shape[1:], fm_dtype)
        slab[0] = top_fm[0]
        d_own, lid = _glob_to_local_rows(u_h, split)
        t_gather = time.perf_counter()
        for s_own in np.unique(d_own):
            m = d_own == s_own
            rows = 1 + np.nonzero(m)[0]
            if s_own < 0:
                slab[rows] = top_fm[u_h[m]]
            elif fm_store[s_own] is None:
                # a subtree of padding only (zero strength, at the far
                # point): its nodes contribute nothing, as the inert row
                # does (the reference asserts here)
                slab[rows] = top_fm[0]
            else:
                slab[rows] = fm_store[s_own][lid[m]]
        t_gather = time.perf_counter() - t_gather
        # the pair list in compact rows (0 stays 0, the inert row)
        comp = torch.where(sl > 0, torch.searchsorted(u, sl) + 1, 0)
        pl = lists.PairList(tgt=tl, src=comp, n_valid=nv,
                            overflow=torch.zeros_like(ovc))
        pg = lists.group_pairs(pl, cap, g, W)
        del tl, sl, comp, pl, u
        overflow += int(pg.overflow)
        pg = _trim(pg)

        base = c * n_pad_sub
        xh = tgt_sorted_x[c]
        rh = (tgt_sorted_r[c] if need_tr else
              np.zeros(n_pad_sub, np.float32))
        geo = eq._target_geo_slab_impl(ttree, to_dev(xh), to_dev(rh), root,
                                       order, levels_glob, split, bs,
                                       x_base=base)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_copy = time.perf_counter()
        slab_d = to_dev(slab).to(torch.float32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_copy = time.perf_counter() - t_copy
        out_fm = pp._zeros_fm(kernel, geo)
        _exec_groups_slab(kernel, cfg, geo, slab_d, pg.tgt, pg.src, out_fm,
                          backend)
        del pg, slab_d
        out = out_fm[:, :od, :].transpose(1, 2)
        glob_c = torch.from_numpy(glob_all[c]).to(dev, torch.int64)
        _downward_local(out, ttree.nc[glob_c], ttree.ns[glob_c],
                        geo[:, :pd, :].transpose(1, 2), order, levels_glob,
                        split, bs, c)
        out_host[base:base + n_pad_sub] = to_host(
            out[leaf0_loc:leaf0_loc + wleaf, :bs, :]).reshape(n_pad_sub, od)
        del out, out_fm, geo
        chunk_log.append({"chunk": c, "rows": len(u_h),
                          "bytes": slab.nbytes, "gather_s": t_gather,
                          "copy_s": t_copy})
        ph(f"chunk {c} (rows {len(u_h)}, {slab.nbytes / 2**20:.1f} MiB, "
           f"gather {t_gather:.3f} s, copy {t_copy:.3f} s)")

    info = {"n_valid": total_valid, "overflow": overflow,
            "phase_s": phase_s, "h2d_bytes": moved["h2d"],
            "d2h_bytes": moved["d2h"], "peak_rss_gb": _peak_rss_gb(),
            "chunks": chunk_log}
    return {"out": out_host, "gidx": tgt_gidx}, info
