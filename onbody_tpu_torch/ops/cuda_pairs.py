"""Grouped pair executors: kernels K1/K2 (sources fetched by id with
cp.async), K10/K11 (fetched by id with bulk asynchronous copies, K11
bundling adjacent ids), K8/K9 and K12 (sources pre-gathered contiguous
per step) and their plain twins (port of onbody_tpu/ops/pallas_pairs.py),
for every workload.

Work list: groups ordered by target row, group_t (P,) target rows (K2:
target PARENT ids q, standing for rows 2q and 2q+1) and group_s (P, G)
source rows; row 0 is the inert pad row and a pad step has group_t == 0.
Layouts are the reference's: tgt_geo (NN_t, 8, B) [pos | rad | 0],
src_fm (NN_s, C, B) from `featurize`, and the feature-major accumulator
out_fm (NN_t, od8, B) with od8 = OD rounded up to 8 (16 for vortgrad3d).

The accumulator is updated IN PLACE (the reference donates it to an
aliased output) and returned, so the interior pass and the paired leaf
pass chain through one buffer in stream order.

Each `exec_pairs_*_cuda` wrapper launches csrc/pairs.cuh's instantiation
for the kernel and core on CUDA tensors and takes its plain twin for CPU
tensors; it never moves work between devices and never gives way to
another kernel.

`exec_pairs` / `exec_pairs_t2` are the front doors with the reference's
`fetch` argument: 'pregather' chunks the list, gathers each chunk and
runs K8/K9; 'dma_i' runs K1/K2, 'dma' K10/K2, 'dma_p' K11/K2; 'static'
chunks and gathers as 'pregather' and runs K12, and has no paired form.

K8 and K9 cut every run of a chunk into segments of at most S steps
(`_plan_segments`; S from `seg_steps_for`), launch one CTA per segment
and, when a run was split, an ordered reduction of its segments' partial
rows; `exec_pairs_pre_split_torch` is the plain twin of that split. K12
is K8 at one step per segment.

`exec_pairs_capped` is the front door at a list's static capacity, the
fused solve's (traverse/dtt.py solve_dtt_fused): the run table made on
the list's device (`capped_runs`), K1/K2/K10/K11 launched with the run
count in device memory; for 'pregather' and 'static' each gather chunk's
segment plan made there too (`capped_segments`) and K8/K9/K12 and the
reduction launched with the segment and split-run counts in device
memory; the id checks collected in a `RunChecks` and read once after
the solve; nothing waits on the host.

The accuracy tier (accum_dtype float64): double source rows run K1-f64
(`exec_pairs64_cuda`, csrc/fp64.cuh) through both front doors whatever
the fetch, as the reference routes every fetch to its one fp64 executor
(traverse/exec.py:151-152); there is no paired fp64 executor, the
solvers turn the paired leaf list off there.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from onbody_tpu_torch.config import PAIR_FETCHES
from onbody_tpu_torch.ops import cuda_lib
from onbody_tpu_torch.ops.kernels import (FM_ROWS, KERNELS, Kernel,
                                          featurize, pad_fm_rows)

GROUP = 8
# kernel launches by the wrappers, keyed (kind, instance) with kind one of
# cuda_lib.KINDS' executors ("exec", "exec_t2", "exec_pre_seg",
# "exec_pre_t2_seg", "exec_pre_reduce", "exec_dma", "exec_dmap",
# "exec_static") or K13's "exec_ablate_<mode>", and the instance as
# cuda_lib.instance names it (reset by callers that count a run)
LAUNCHES = collections.Counter()
# elements per (steps, B, B) twin temporary: bounds its chunk of steps;
# on the CPU a cache-sized chunk (2-4x faster there than 1 << 22). The
# chunking does not change the result: each step's sum is its own, and
# index_add_ adds the steps in order
_TWIN_ELEMS = 1 << 22
_TWIN_CPU_ELEMS = 1 << 16


def _twin_steps(t: torch.Tensor, b: int) -> int:
    """Steps per twin chunk for B-wide blocks on t's device."""
    elems = _TWIN_ELEMS if t.device.type == "cuda" else _TWIN_CPU_ELEMS
    return max(1, elems // (b * b))
# bytes of the gathered source buffer per pregather chunk (reference
# pallas_pairs.py:894-897), sized at the row count padded to 8. K8/K9
# split a chunk's runs to fill the card, so the size no longer sets the
# grid: on an NVIDIA H100 80GB HBM3 (700.00 W) the API's vortgrad3d
# treecode3 list at N = 1e6 spent 0.1811 / 0.1571 / 0.1596 / 0.1690 /
# 0.1484 s in the executor at 64 / 256 / 1024 / 8192 / 32768 MiB
# (chip_smoke.py --chunk-sweep; PERF.md): 256 MiB is within 6% of the
# best size for a small share of its memory
PREGATHER_BYTES = 256 << 20


def build_fm_blocks(kernel: Kernel, blocks_pos, blocks_rad, blocks_s):
    """(NN, B, PD)/(NN, B)/(NN, B, SD) -> feature-major (NN, C, B)."""
    return featurize(kernel.name, blocks_pos, blocks_rad, blocks_s)


def build_tgt_geo(blocks_pos, blocks_rad):
    """(NN, B, PD)/(NN, B) -> feature-major (NN, 8, B) [pos | rad | 0]."""
    nn, b, pd = blocks_pos.shape
    g = torch.cat([blocks_pos.transpose(1, 2), blocks_rad[:, None, :]],
                  dim=1)
    return torch.cat([g, g.new_zeros((nn, 8 - pd - 1, b))], dim=1)


def od8(kernel: Kernel) -> int:
    """Rows of the feature-major accumulator: OD rounded up to 8."""
    return -(-kernel.od // 8) * 8


def _zeros_fm(kernel: Kernel, tgt_geo):
    """A zero feature-major accumulator (NN_t, od8, B) for tgt_geo."""
    return tgt_geo.new_zeros((tgt_geo.shape[0], od8(kernel),
                              tgt_geo.shape[2]))


def _finish(kernel: Kernel, out_fm, final: bool):
    if not final:
        return out_fm
    return out_fm[:, :kernel.od, :].transpose(1, 2)


# ---------------------------------------------------------------- twins

def _twin_add(kernel: Kernel, tgt_geo, out_fm, rows, src_block, group: int,
              core: str, keys=None):
    """out_fm[keys[i]] += sum_j tile(target block rows[i], src_block(sel,
    j)) over the group slots j, in chunks of steps; src_block(sel, j)
    gives the (len(sel), C, B) source blocks of slot j for the steps
    sel (a slice of rows); keys default to rows."""
    b = tgt_geo.shape[2]
    pd = kernel.pd
    step = _twin_steps(tgt_geo, b)
    for p0 in range(0, rows.shape[0], step):
        sel = slice(p0, p0 + step)
        t_c = rows[sel]
        geo = tgt_geo[t_c]
        tpos = geo[:, :pd, :].transpose(1, 2)               # (P, B, PD)
        trad = geo[:, pd, :]                                # (P, B)
        acc = None
        for j in range(group):
            tj = kernel.tile_fm(tpos, trad, src_block(sel, j), core)
            acc = tj if acc is None else acc + tj
        add = out_fm.new_zeros((t_c.shape[0],) + out_fm.shape[1:])
        add[:, :kernel.od] = acc.transpose(1, 2)
        out_fm.index_add_(0, t_c if keys is None else keys[sel], add)


def exec_pairs_torch(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                     out_fm=None, final: bool = True, core: str = "rm",
                     accum_dtype=None):
    """Plain twin of K1 (and of K10, K11 and K1-f64): per chunk of steps,
    gather the target blocks and each group slot's source blocks,
    evaluate the batched tiles with the kernel's per-pair form, and
    index_add_ them into their rows (the reference's
    traverse/exec.py:_exec_groups_xla_chunked). Pad steps are dropped.
    Computes in the rows' type, or in accum_dtype (the rows promoted to
    it) when given, as the reference's jnp executor does."""
    if accum_dtype is not None:
        tgt_geo, src_fm = tgt_geo.to(accum_dtype), src_fm.to(accum_dtype)
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    keep = group_t != 0
    gt, gs = group_t[keep].long(), group_s[keep].long()
    _twin_add(kernel, tgt_geo, out_fm, gt,
              lambda sel, j: src_fm[gs[sel, j]], gs.shape[1], core)
    return _finish(kernel, out_fm, final)


def exec_pairs_torch_t2(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                        out_fm, core: str = "rm"):
    """Plain twin of K2: expand each parent-keyed step q to the steps
    (2q, srcs) and (2q+1, srcs) and run the unpaired twin. Pad steps are
    dropped, so rows 0 and 1 (the root) are never written."""
    keep = group_t != 0
    q, gs = group_t[keep], group_s[keep]
    return exec_pairs_torch(kernel, tgt_geo, src_fm,
                            torch.cat([2 * q, 2 * q + 1]),
                            torch.cat([gs, gs]), out_fm, final=False,
                            core=core)


def _pre_twin(kernel, tgt_geo, src_gathered, group_t, out_fm, core, group,
              paired: bool):
    c = src_gathered.shape[1] // group
    steps = torch.nonzero(group_t).squeeze(1)
    rows = group_t[steps].long()
    if paired:
        rows = torch.cat([2 * rows, 2 * rows + 1])
        steps = torch.cat([steps, steps])
    _twin_add(kernel, tgt_geo, out_fm, rows,
              lambda sel, j: src_gathered[steps[sel], j * c:(j + 1) * c],
              group, core)


def exec_pairs_pre_torch(kernel: Kernel, tgt_geo, src_gathered, group_t,
                         out_fm=None, final: bool = True, core: str = "rm",
                         group: int = GROUP):
    """Plain twin of K8: step p's `group` source blocks are
    src_gathered[p] (G*C, B), C rows each (the lean rows or the rows
    padded to 8: the tile forms read the lean rows of either). Batched
    tiles + index_add_; pad steps (group_t == 0) are dropped. Inert
    slots of a real step are evaluated and add exactly zero."""
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    _pre_twin(kernel, tgt_geo, src_gathered, group_t, out_fm, core, group,
              False)
    return _finish(kernel, out_fm, final)


def exec_pairs_pre_torch_t2(kernel: Kernel, tgt_geo, src_gathered, group_t,
                            out_fm, core: str = "rm", group: int = GROUP):
    """Plain twin of K9: step p's one gathered block serves rows 2q and
    2q+1 of its parent key q = group_t[p]. Pad steps are dropped, so
    rows 0 and 1 (the root) are never written."""
    _pre_twin(kernel, tgt_geo, src_gathered, group_t, out_fm, core, group,
              True)
    return out_fm


# K12's twin: K12 computes K8's sums (at one step per segment), so the
# pre-gathered twin is its twin
exec_pairs_static_torch = exec_pairs_pre_torch


def reduce_segments_torch(out_fm, partials, run_tgt, run_seg,
                          paired: bool = False):
    """Plain twin of K8/K9's ordered reduction: for every run of more
    than one segment, its partial rows partials[run_seg[r]:run_seg[r+1]]
    (n_seg, rows, OD, B), rows 2 when paired, summed in segment order
    and added onto its output rows (target key t: row t; parent key q:
    rows 2q and 2q+1). Returns out_fm."""
    first, nseg = run_seg[:-1].long(), (run_seg[1:] - run_seg[:-1]).long()
    split = torch.nonzero(nseg > 1).squeeze(1)
    if split.numel() == 0:
        return out_fm
    first, nseg = first[split], nseg[split]
    red = partials[first]
    for k in range(1, int(nseg.max())):
        more = torch.nonzero(nseg > k).squeeze(1)
        red[more] += partials[first[more] + k]
    rows = red.shape[1]
    keys = run_tgt.long()[split]
    idx = (keys[:, None] * rows + torch.arange(rows, device=keys.device))
    out_fm[:, :red.shape[2]].index_add_(0, idx.reshape(-1),
                                         red.reshape((-1,) + red.shape[2:]))
    return out_fm


def exec_pairs_pre_split_torch(kernel: Kernel, tgt_geo, src_gathered,
                               group_t, out_fm, seg_steps, core: str = "rm",
                               group: int = GROUP, paired: bool = False):
    """Plain twin of K8 (K9 when paired, parent-keyed steps) as the
    kernels split it: the chunk's runs cut into segments of at most
    seg_steps steps (_plan_segments; None: one per run); a run of one
    segment is added onto its rows, every segment of a split run summed
    into its own partial rows, then reduce_segments_torch. The sums of
    exec_pairs_pre_torch(_t2) up to the order of the fp32 additions.
    Returns out_fm."""
    c = src_gathered.shape[1] // group
    steps, run_tgt, run_off = _run_table(group_t)
    seg_run, seg_off, run_seg = _plan_segments(run_off, seg_steps)
    n_seg = seg_run.shape[0]
    if n_seg == 0:
        return out_fm
    rows = 2 if paired else 1
    seg_of = torch.repeat_interleave(
        torch.arange(n_seg, device=steps.device),
        (seg_off[1:] - seg_off[:-1]).long())
    key = run_tgt.long()[seg_run.long()][seg_of]
    tgt = torch.cat([rows * key + r for r in range(rows)])
    part_keys = torch.cat([rows * seg_of + r for r in range(rows)])
    st = torch.cat([steps] * rows)
    partials = out_fm.new_zeros((n_seg * rows,) + out_fm.shape[1:])
    _twin_add(kernel, tgt_geo, partials, tgt,
              lambda sel, j: src_gathered[st[sel], j * c:(j + 1) * c],
              group, core, keys=part_keys)
    partials = partials.view((n_seg, rows) + out_fm.shape[1:])
    whole = (run_seg[1:] - run_seg[:-1]) == 1
    one = torch.nonzero(whole).squeeze(1)
    idx = (run_tgt.long()[one][:, None] * rows
           + torch.arange(rows, device=one.device)).reshape(-1)
    out_fm.index_add_(0, idx, partials[run_seg.long()[one]].reshape(
        (-1,) + out_fm.shape[1:]))
    return reduce_segments_torch(out_fm, partials[:, :, :kernel.od],
                                 run_tgt, run_seg, paired)


# --------------------------------------------------------------- kernels

def _run_table(group_t):
    """Runs of a work list: maximal stretches of consecutive equal
    non-zero group_t. Returns (steps, run_tgt, run_off): the non-pad
    steps' indices, each run's target key, and the runs' bounds in
    `steps` (run r at [run_off[r], run_off[r+1])); the last two as
    contiguous int32 on the list's device. Raises if one target appears
    in two separate runs: two CTAs would race on its output row."""
    idx = torch.nonzero(group_t).squeeze(1)
    gt = group_t[idx]
    brk = torch.ones_like(gt, dtype=torch.bool)
    brk[1:] = (gt[1:] != gt[:-1]) | (idx[1:] != idx[:-1] + 1)
    starts = torch.nonzero(brk).squeeze(1)
    run_tgt = gt[starts]
    if torch.unique(run_tgt).numel() != run_tgt.numel():
        raise ValueError("pair executor: a target row appears in two "
                         "separate runs; the list must be grouped by "
                         "target")
    run_off = torch.cat([starts, starts.new_tensor([gt.shape[0]])])
    return (idx, run_tgt.to(torch.int32).contiguous(),
            run_off.to(torch.int32).contiguous())


def _runs(group_t, group_s):
    """Run table of a work list for K1/K2: (run_tgt, run_off, pair_s),
    pair_s holding the non-pad steps' source ids as contiguous int32
    (runs are contiguous in it, see _run_table)."""
    idx, run_tgt, run_off = _run_table(group_t)
    return run_tgt, run_off, group_s[idx].to(torch.int32).contiguous()


def _plan_segments(run_off, seg_steps):
    """K8/K9's split planner: every run of a run table (_run_table) cut
    into segments of at most seg_steps consecutive steps, in order
    (seg_steps None: one segment per run). Returns (seg_run, seg_off,
    run_seg) as contiguous int32 on run_off's device: each segment's
    run, the segments' bounds in `steps` (segment s at [seg_off[s],
    seg_off[s+1]), inside one run) and each run's segments (run r at
    [run_seg[r], run_seg[r+1]); a run of at most seg_steps steps is one
    segment). Vectorized: no host loop over runs."""
    off = run_off.long()
    lens = off[1:] - off[:-1]
    if seg_steps is None:
        nseg, width = torch.ones_like(lens), 0
    elif seg_steps < 1:
        raise ValueError(f"segments of {seg_steps} steps: need >= 1")
    else:
        nseg, width = (lens + seg_steps - 1) // seg_steps, seg_steps
    run_seg = torch.cat([nseg.new_zeros(1), torch.cumsum(nseg, 0)])
    n = int(run_seg[-1])
    # each segment's run: a step up at every run's first segment, summed
    # (repeat_interleave's CPU kernel wakes every intra-op thread, which
    # on a busy host cost the wrapper's plan up to tens of ms)
    seg_run = torch.zeros(n, dtype=torch.long, device=off.device)
    seg_run[run_seg[1:-1]] = 1
    seg_run = torch.cumsum(seg_run, 0)
    rank = torch.arange(n, device=off.device) - run_seg[seg_run]
    seg_off = torch.cat([off[seg_run] + rank * width, off[-1:]])
    return tuple(t.to(torch.int32).contiguous()
                 for t in (seg_run, seg_off, run_seg))


# waves of resident CTAs a pregather chunk's segments should fill
SEG_WAVES = 2


@functools.cache
def _resident_ctas(kind: str, inst: str, b: int, c: int, g: int,
                   device_index: int):
    with torch.cuda.device(device_index):
        ctas = cuda_lib.occupancy(kind, inst, b, c, g)["ctas_per_sm"]
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return ctas, sms


def seg_steps_for(kind: str, inst: str, n_steps: int, b: int, c: int,
                  g: int, device) -> int:
    """S, the most steps a segment of K8/K9 ("exec_pre_seg" /
    "exec_pre_t2_seg") takes in a chunk of n_steps real steps: the
    largest S whose segments still fill SEG_WAVES waves of the segment
    kernel's resident CTAs on the card's SMs (the CUDA occupancy
    calculator's CTAs per SM), at least 1. A chunk has at least n_steps /
    S segments however its runs fall, so a list of long runs (a treecode
    leaf's 27-77 steps) fills the card; runs no longer than S stay
    whole."""
    ctas, sms = _resident_ctas(kind, inst, b, c, g, device.index or 0)
    return max(1, n_steps // (SEG_WAVES * sms * max(ctas, 1)))


def _check_layout(kernel: Kernel, tgt_geo, out_fm, c: int, paired: bool,
                  dtype=torch.float32, **tensors):
    """Shapes and types every executor kernel needs: tgt_geo (NN, 8, B),
    out_fm (NN, od8, B), C source rows >= the body's, all contiguous
    `dtype` (float32; K1-f64 float64)."""
    nn_t, rows_t, b = tgt_geo.shape
    rows = FM_ROWS[kernel.name]
    if rows_t != 8 or c < rows:
        raise ValueError(f"pair executor {kernel.name}: tgt_geo "
                         f"{tuple(tgt_geo.shape)} and {c} source rows do "
                         f"not match (NN, 8, B) / C>={rows}")
    if tuple(out_fm.shape) != (nn_t, od8(kernel), b):
        raise ValueError(f"pair executor: out_fm {tuple(out_fm.shape)}, "
                         f"expected {(nn_t, od8(kernel), b)}")
    for name, t in dict(tgt_geo=tgt_geo, out_fm=out_fm, **tensors).items():
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"pair executor: {name} must be contiguous "
                             f"{dtype}, got {t.dtype}")
    if b > 2048:
        raise ValueError(f"pair executor: block width {b} > 2048")
    if paired and nn_t % 2:
        raise ValueError("paired executor needs an even target row count")


def _check_exec(kernel: Kernel, tgt_geo, src_fm, group_t, group_s, out_fm,
                paired: bool, dtype=torch.float32):
    nn_t, _, b = tgt_geo.shape
    nn_s, c, b_s = src_fm.shape
    if b_s != b:
        raise ValueError(f"pair executor {kernel.name}: tgt_geo "
                         f"{tuple(tgt_geo.shape)} and src_fm "
                         f"{tuple(src_fm.shape)} differ in block width")
    _check_layout(kernel, tgt_geo, out_fm, c, paired, dtype, src_fm=src_fm)
    if group_s.ndim != 2 or group_t.shape[0] != group_s.shape[0]:
        raise ValueError("pair executor: group_t (P,) and group_s (P, G) "
                         "disagree")
    if max(nn_t, nn_s, group_s.numel()) >= 2 ** 31:
        raise ValueError("pair executor: sizes must fit in int32")


def _one_cuda_device(name: str, *tensors):
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or devs.pop().type != "cuda":
        raise ValueError(f"{name}: the kernel needs every tensor on one "
                         "CUDA device")


def _check_targets(name: str, run_tgt, nn_keys: int):
    t_lo, t_hi = torch.stack([run_tgt.min(), run_tgt.max()]).tolist()
    if t_lo < 1 or t_hi >= nn_keys:
        raise ValueError(f"{name}: row ids out of range (targets "
                         f"[{t_lo}, {t_hi}] of {nn_keys})")


def _launch(kind: str, kernel, core, tgt_geo, src_fm, group_t, group_s,
            out_fm, runs=None) -> bool:
    """Run one launch of a kernel that fetches by id (K1 "exec", K2
    "exec_t2", K10 "exec_dma", K11 "exec_dmap", K1-f64 "exec64", K13
    "exec_ablate_<mode>"); False when the list has no real step. runs
    None: the run table is made here, checked on the host (raising at
    once) and launched at its trimmed count. runs (CappedRuns, K1/K2/
    K10/K11): the list stays at its static capacity, one CTA per step
    slot, the run count read on the card; no wait on the host."""
    paired = kind == "exec_t2"
    inst = cuda_lib.instance(kernel.name, core)
    # K13's entry points carry their mode, not an instance
    ablate = kind.startswith("exec_ablate_")
    name = f"onbody_{kind}" if ablate else cuda_lib.entry(kind, inst)
    _one_cuda_device(name, tgt_geo, src_fm, group_t, group_s, out_fm)
    _check_exec(kernel, tgt_geo, src_fm, group_t, group_s, out_fm, paired,
                torch.float64 if kind == "exec64" else torch.float32)
    _, c, b = src_fm.shape
    if (ablate or kind in ("exec_dma", "exec_dmap")) and (
            b % 4 or src_fm.data_ptr() % 16):
        raise ValueError(f"{name}: bulk copies need 16-byte aligned "
                         f"blocks: B={b} must be a multiple of 4 and "
                         "src_fm 16-byte aligned")
    if runs is None:
        run_tgt, run_off, pair_s = _runs(group_t, group_s)
        if run_tgt.numel() == 0:
            return False
        _check_targets(name, run_tgt,
                       tgt_geo.shape[0] // (2 if paired else 1))
        s_lo, s_hi = torch.stack([pair_s.min(), pair_s.max()]).tolist()
        if s_lo < 0 or s_hi >= src_fm.shape[0]:
            raise ValueError(f"{name}: row ids out of range (sources "
                             f"[{s_lo}, {s_hi}] of {src_fm.shape[0]})")
        count, grid = None, run_tgt.numel()
    else:
        run_tgt, run_off, pair_s = runs.run_tgt, runs.run_off, runs.pair_s
        count, grid = runs.n_runs.data_ptr(), group_t.shape[0]
        if grid == 0:
            return False
    ptrs = [tgt_geo.data_ptr(), src_fm.data_ptr(), out_fm.data_ptr(),
            run_tgt.data_ptr(), run_off.data_ptr(), pair_s.data_ptr()]
    if not ablate:
        ptrs.append(count)
    rc = getattr(cuda_lib.lib(), name)(
        *ptrs, grid, b, c, pair_s.shape[1], out_fm.shape[1],
        cuda_lib.stream_ptr(out_fm.device))
    cuda_lib.check(rc, name)
    LAUNCHES[(kind, inst)] += 1
    return True


def _launch_pre(kind: str, kernel, core, tgt_geo, src_gathered, group_t,
                out_fm, group: int, n_slots, seg_steps=None,
                gt_host=None) -> bool:
    """Run one gathered chunk (K8 "exec_pre", K9 "exec_pre_t2", K12
    "exec_static"): its plan, the segment kernel, then, when a run was
    split, the ordered reduction of the split runs' partial rows (a
    scratch allocated here, one or two rows per segment); False when the
    chunk has no real step. n_slots (P,) or None: slots of each step to
    evaluate (the rest hold the inert row, which adds exactly zero).
    K8/K9 cut the runs into segments of at most seg_steps steps (None:
    seg_steps_for's choice), K12 into its steps. The run and segment
    tables are made on the host, from gt_host (group_t's copy there;
    copied here when None), and sent to the card in one asynchronous
    copy: a chunk waits on the card at most for that one copy of its
    keys, and not at all when the caller copied the whole list once (the
    front door)."""
    paired = kind == "exec_pre_t2"
    inst = cuda_lib.instance(kernel.name, core)
    launched = kind if kind == "exec_static" else kind + "_seg"
    name = cuda_lib.entry(launched, inst)
    _one_cuda_device(name, tgt_geo, src_gathered, group_t, out_fm, n_slots)
    p, gc, b = src_gathered.shape
    if gc % group or group_t.shape[0] != p or b != tgt_geo.shape[2]:
        raise ValueError(f"{name}: src_gathered {tuple(src_gathered.shape)}"
                         f" is not (P={group_t.shape[0]}, G*C with G="
                         f"{group}, B={tgt_geo.shape[2]})")
    _check_layout(kernel, tgt_geo, out_fm, gc // group, paired,
                  src_gathered=src_gathered)
    if max(tgt_geo.shape[0], p) >= 2 ** 31:
        raise ValueError("pair executor: sizes must fit in int32")
    if gt_host is None:
        gt_host = group_t.cpu()
    steps, run_tgt, run_off = _run_table(gt_host)
    if run_tgt.numel() == 0:
        return False
    _check_targets(name, run_tgt, tgt_geo.shape[0] // (2 if paired else 1))
    if kind == "exec_static":
        seg_steps = 1
    elif seg_steps is None:
        seg_steps = seg_steps_for(launched, inst, steps.numel(), b,
                                  gc // group, group, out_fm.device)
    plan = _seg_plan(launched, kernel, core, steps, run_tgt, run_off,
                     n_slots, seg_steps, out_fm.device)
    partials = launch_segments(plan, tgt_geo, src_gathered, out_fm, group)
    if partials is not None:
        reduce_segments_cuda(plan, out_fm, partials)
    return True


class SegPlan(collections.namedtuple("SegPlan", (
        "kernel", "core", "kind", "steps", "n_slots", "run_tgt", "seg_run",
        "seg_off", "run_seg", "split_runs"))):
    """One gathered chunk's K8/K9/K12 launch: the kernel, core and kind
    ("exec_pre_seg", "exec_pre_t2_seg" or "exec_static"), the real steps
    and their slot counts (or None), the run and segment tables of
    _run_table / _plan_segments (K12: one step per segment) and the runs
    of more than one segment, which the reduction adds up; all int32 on
    the card."""


def _seg_plan(kind, kernel, core, steps, run_tgt, run_off, n_slots,
              seg_steps, device) -> SegPlan:
    """SegPlan of a run table on `device`; a table made elsewhere (the
    host) goes there in one asynchronous copy from pinned memory."""
    seg_run, seg_off, run_seg = _plan_segments(run_off, seg_steps)
    split = torch.nonzero(run_seg[1:] - run_seg[:-1] > 1).squeeze(1)
    tables = [steps.to(torch.int32), run_tgt, seg_run, seg_off, run_seg,
              split.to(torch.int32)]
    if steps.device != device:
        flat = torch.cat(tables).pin_memory().to(device, non_blocking=True)
        tables = list(torch.split(flat, [t.numel() for t in tables]))
    slots = None
    if n_slots is not None:
        slots = n_slots[tables[0]].to(torch.int32).contiguous()
    return SegPlan(kernel, core, kind, tables[0], slots, *tables[1:])


def plan_chunk(kind: str, kernel: Kernel, core: str, group_t, n_slots,
               seg_steps: int = 1) -> SegPlan:
    """The K8 ("exec_pre_seg"), K9 ("exec_pre_t2_seg") or K12
    ("exec_static", at seg_steps 1) plan of one gathered chunk's keys
    group_t at seg_steps steps per segment, on group_t's device, as the
    wrapper makes it (no checks): for timing the kernels apart from the
    planning (launch_segments)."""
    steps, run_tgt, run_off = _run_table(group_t.cpu())
    return _seg_plan(kind, kernel, core, steps, run_tgt, run_off, n_slots,
                     seg_steps, group_t.device)


def launch_segments(plan: SegPlan, tgt_geo, src_gathered, out_fm,
                    group: int):
    """Launch a planned chunk's segment kernel (K8/K9's or K12's): runs
    of one segment are added onto out_fm; returns the partial rows of the
    split runs' segments (a scratch allocated here, (n_seg, 1 or 2 rows,
    OD, B)) for reduce_segments_cuda, or None when no run was split."""
    inst = cuda_lib.instance(plan.kernel.name, plan.core)
    name = cuda_lib.entry(plan.kind, inst)
    _, gc, b = src_gathered.shape
    n_seg = plan.seg_run.numel()
    partials = None
    if plan.split_runs.numel():
        partials = out_fm.new_empty((n_seg, 2 if "t2" in plan.kind else 1,
                                     plan.kernel.od, b))
    rc = getattr(cuda_lib.lib(), name)(
        tgt_geo.data_ptr(), src_gathered.data_ptr(), out_fm.data_ptr(),
        None if partials is None else partials.data_ptr(),
        plan.run_tgt.data_ptr(), plan.run_seg.data_ptr(),
        plan.seg_run.data_ptr(), plan.seg_off.data_ptr(),
        plan.steps.data_ptr(),
        None if plan.n_slots is None else plan.n_slots.data_ptr(), None,
        n_seg, b, gc // group, group, out_fm.shape[1],
        cuda_lib.stream_ptr(out_fm.device))
    cuda_lib.check(rc, name)
    LAUNCHES[(plan.kind, inst)] += 1
    return partials


def reduce_segments_cuda(plan: SegPlan, out_fm, partials):
    """K8/K9's and K12's ordered reduction on CUDA tensors: partials
    (n_seg, rows, OD, B) of a planned chunk's segments (run r's at
    [run_seg[r], run_seg[r+1])), rows 2 for parent keys, summed in
    segment order onto the output rows of the plan's split runs (no CTA
    for a run of one segment). Twin: reduce_segments_torch. Returns
    out_fm."""
    inst = cuda_lib.instance(plan.kernel.name, plan.core)
    name = cuda_lib.entry("exec_pre_reduce", inst)
    _one_cuda_device(name, out_fm, partials, plan.run_tgt)
    n_seg, rows, od, b = partials.shape
    if (od != plan.kernel.od or b != out_fm.shape[2] or rows not in (1, 2)
            or n_seg != plan.seg_run.numel()
            or not partials.is_contiguous()
            or partials.dtype != torch.float32):
        raise ValueError(f"{name}: partials {tuple(partials.shape)} and "
                         f"the plan do not match")
    rc = getattr(cuda_lib.lib(), name)(
        out_fm.data_ptr(), partials.data_ptr(), plan.run_tgt.data_ptr(),
        plan.run_seg.data_ptr(), plan.split_runs.data_ptr(), None,
        plan.split_runs.numel(), rows, b, out_fm.shape[1],
        cuda_lib.stream_ptr(out_fm.device))
    cuda_lib.check(rc, name)
    LAUNCHES[("exec_pre_reduce", inst)] += 1
    return out_fm


def exec_pairs_cuda(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                    out_fm=None, final: bool = True, core: str = "rm"):
    """Unpaired grouped executor. CUDA tensors launch K1, CPU tensors
    take exec_pairs_torch. Adds into out_fm (zeros when None) and returns
    it, or with final=True the point-major (NN_t, B, OD) view.

    K1 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk with
    _body_interleaved. A block of B sources staged once serves B
    targets, so device memory carries ~kRows * 4 / B bytes a pair and K1
    is bound by the SM's FP32/MUFU rates over the operations each pair
    needs (counted in the body's header; PERF.md has the bound). Against
    that: one CTA per run of a target row keeps the row's sums in
    registers and adds them onto the row once (no atomics); each thread
    owns two of the row's B targets, and every source, staged in whole
    float4s, serves both, so a pair costs one shared load (vort2d 0.5);
    the run's blocks, fetched by id with cp.async into a ring of three,
    arrive while an earlier one is summed (csrc/pairs.cuh exec_tile, the
    tile K8 runs; the same sums as K8, K10 and K11, bit for bit)."""
    return _exec_by_id("exec", kernel, tgt_geo, src_fm, group_t, group_s,
                       out_fm, final, core)


def _exec_by_id(kind: str, kernel, tgt_geo, src_fm, group_t, group_s,
                out_fm, final: bool, core: str):
    """K1, K10 or K11 on CUDA tensors, their twin exec_pairs_torch on
    CPU tensors."""
    if tgt_geo.device.type == "cpu":
        return exec_pairs_torch(kernel, tgt_geo, src_fm, group_t, group_s,
                                out_fm, final, core)
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    _launch(kind, kernel, core, tgt_geo, src_fm, group_t, group_s, out_fm)
    return _finish(kernel, out_fm, final)


def exec_pairs_dma_cuda(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                        out_fm=None, final: bool = True, core: str = "rm"):
    """K1's sum with the source blocks fetched by bulk asynchronous
    copies: CUDA tensors launch K10, CPU tensors take exec_pairs_torch.
    Adds into out_fm (zeros when None) and returns it, or with
    final=True the point-major (NN_t, B, OD) view. B must be a multiple
    of 4 (the copies need 16-byte alignment).

    K10 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk with _body
    (pair_fetch 'dma'). K1's design, one CTA per run of a target row,
    two targets per thread; one thread copies the run's blocks into a
    ring of three shared-memory stages ahead of the sums, each copy
    completing on its own mbarrier, and the inert id 0 starts no copy;
    the pair loop reads the copied rows where they land, four sources a
    load (csrc/pairs.cuh exec_fetch_runs, body.cuh block_rows). Bound by
    the pairs' operations, as K1; on the same groups it gives K1's
    result bit for bit."""
    return _exec_by_id("exec_dma", kernel, tgt_geo, src_fm, group_t,
                       group_s, out_fm, final, core)


def exec_pairs_dmap_cuda(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                         out_fm=None, final: bool = True, core: str = "rm"):
    """K10 with adjacent source ids (a, a+1) of a step fetched by one
    copy of both blocks: CUDA tensors launch K11, CPU tensors take
    exec_pairs_torch. Arguments and result as exec_pairs_dma_cuda.

    K11 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk with
    _body_pair (pair_fetch 'dma_p'), with its greedy bundling
    (csrc/pairs.cuh copy_blocks; bundled_blocks counts it). On lists
    compacted with list_compact='idsort' sibling blocks sit in adjacent
    slots. K1's result bit for bit on the same groups."""
    return _exec_by_id("exec_dmap", kernel, tgt_geo, src_fm, group_t,
                       group_s, out_fm, final, core)


def bundled_blocks(group_s) -> int:
    """Source blocks K11 fetches two to a copy on the (P, G) list: the
    reference's greedy scan per step (a slot heads a bundle when its id
    is not 0, the next slot holds the next id and the slot was not taken
    by the bundle before it). K11 starts (non-zero slots) - bundled / 2
    copies."""
    consumed = torch.zeros_like(group_s[:, 0], dtype=torch.bool)
    bundled = group_s.new_zeros(())
    for j in range(group_s.shape[1] - 1):
        a = group_s[:, j]
        head = (a != 0) & (group_s[:, j + 1] == a + 1) & ~consumed
        bundled = bundled + 2 * head.sum()
        consumed = head
    return int(bundled)


def exec_pairs_cuda_t2(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                       out_fm, core: str = "rm"):
    """Sibling-paired grouped executor on parent-keyed steps. CUDA
    tensors launch K2, CPU tensors take exec_pairs_torch_t2. Adds into
    out_fm and returns it; rows 0 and 1 are never written.

    K2 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk_t2 with
    _body_interleaved_t2. K1's bound and design, with each thread owning
    the same point of both sibling rows, so one staged block serves 2B
    targets: half K1's source traffic and shared loads per pair (the
    tile K9 runs, the same sums bit for bit)."""
    if tgt_geo.device.type == "cpu":
        return exec_pairs_torch_t2(kernel, tgt_geo, src_fm, group_t,
                                   group_s, out_fm, core)
    _launch("exec_t2", kernel, core, tgt_geo, src_fm, group_t, group_s,
            out_fm)
    return out_fm


def exec_pairs64_cuda(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                      out_fm=None, final: bool = True, core: str = "rm"):
    """The unpaired grouped executor in double, the accuracy tier's: the
    rows promoted to float64 once (exact; a no-op on double rows), then
    CUDA tensors launch K1-f64 and CPU tensors take exec_pairs_torch in
    float64. Adds into out_fm (float64 zeros when None) and returns it,
    or with final=True the point-major (NN_t, B, OD) view.

    K1-f64 replaces the reference's fp64 executor, traverse/exec.py
    exec_pairs_jnp, to which every fetch goes at accum_dtype=float64
    (exec.py:151-152), standing where onbody_tpu/ops/pallas_pairs.py:
    _exec_chunk (:623) stands in fp32. d, |d|^2, the core and the sums
    are double. K1's tile in double (csrc/fp64.cuh): one CTA per run of
    a target row, two target points per thread, the source blocks
    staged source by source through a cp.async ring of 2, each summed by
    every thread into its partials, the partials added in block order
    onto the row once; the RM core's rsqrt and reciprocal one MUFU and
    Newton's steps. Bound by the pairs' FP64 operations (64 FP64 lanes
    an SM)."""
    if tgt_geo.device.type == "cpu":
        return exec_pairs_torch(kernel, tgt_geo, src_fm, group_t, group_s,
                                out_fm, final, core, torch.float64)
    tgt_geo, src_fm = tgt_geo.double(), src_fm.double()
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    _launch("exec64", kernel, core, tgt_geo, src_fm.contiguous(), group_t,
            group_s, out_fm)
    return _finish(kernel, out_fm, final)


def exec_pairs_pre_cuda(kernel: Kernel, tgt_geo, src_gathered, group_t,
                        out_fm=None, final: bool = True, core: str = "rm",
                        group: int = GROUP, n_slots=None, seg_steps=None,
                        gt_host=None):
    """Unpaired executor on pre-gathered sources: src_gathered (P, G*C, B)
    holds step p's G source blocks contiguous, C rows each. CUDA tensors
    launch K8, CPU tensors take exec_pairs_pre_torch. Adds into out_fm
    (zeros when None) and returns it, or with final=True the point-major
    (NN_t, B, OD) view. CUDA only: seg_steps, the most steps of a
    segment (None for seg_steps_for's choice); gt_host, group_t's copy
    on the host, which the segment plan is made from (None: copied
    here, one wait on the card).

    K8 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk_pre with
    _body_pre. Every run of a target row is cut into segments of at most
    seg_steps steps; one CTA per segment reads its steps' blocks at
    src_gathered + step*G*C*B, contiguous and with no source-id load in
    front, copies them asynchronously into a ring of shared-memory
    stages and sums them in registers, several targets per thread. A run
    of one segment is added onto its row; the segments of a split run
    write partial rows that the ordered reduction adds onto the row in
    segment order, so the result never depends on the schedule
    (csrc/pairs.cuh). The kernel reads a body's lean rows inside a block
    of C rows, so it takes the lean layout (C 5 for grav3d, 4 for
    vort2d) and the layout padded to 8 alike; the derived rows the
    reference's gather appends are for its tile bodies, which switch
    path on the row count. Its bound is the larger of the pairs'
    operations and the gathered and partial bytes (PERF.md)."""
    if tgt_geo.device.type == "cpu":
        return exec_pairs_pre_torch(kernel, tgt_geo, src_gathered, group_t,
                                    out_fm, final, core, group)
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    _launch_pre("exec_pre", kernel, core, tgt_geo, src_gathered, group_t,
                out_fm, group, n_slots, seg_steps, gt_host)
    return _finish(kernel, out_fm, final)


def exec_pairs_pre_cuda_t2(kernel: Kernel, tgt_geo, src_gathered, group_t,
                           out_fm, core: str = "rm", group: int = GROUP,
                           n_slots=None, seg_steps=None, gt_host=None):
    """Sibling-paired executor on pre-gathered sources, parent-keyed
    steps. CUDA tensors launch K9, CPU tensors take
    exec_pairs_pre_torch_t2. Adds into out_fm and returns it; rows 0 and
    1 are never written. seg_steps and gt_host as for
    exec_pairs_pre_cuda.

    K9 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk_pre_t2 with
    _body_pre_t2: K8's segments and reduction, each staged block serving
    both sibling rows, so one gathered block per step does the work of
    two."""
    if tgt_geo.device.type == "cpu":
        return exec_pairs_pre_torch_t2(kernel, tgt_geo, src_gathered,
                                       group_t, out_fm, core, group)
    _launch_pre("exec_pre_t2", kernel, core, tgt_geo, src_gathered, group_t,
                out_fm, group, n_slots, seg_steps, gt_host)
    return out_fm


def exec_pairs_static_cuda(kernel: Kernel, tgt_geo, src_gathered, group_t,
                           out_fm=None, final: bool = True,
                           core: str = "rm", group: int = GROUP,
                           n_slots=None, gt_host=None):
    """One CTA per step on pre-gathered sources (P, G*C, B): CUDA tensors
    launch K12, CPU tensors take exec_pairs_static_torch. Adds into
    out_fm (zeros when None) and returns it, or with final=True the
    point-major (NN_t, B, OD) view. K8's sums at one step per segment,
    bit for bit, fixed by the list alone. gt_host: group_t's copy on the
    host, which the plan is made from (copied here when None).

    K12 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk_static with
    _body_static (pair_fetch 'static'), whose per-step output rows its
    caller segment-adds. Here each step's CTA is K8's tile on the step's
    blocks, so a long run of one target spreads over the card: a step
    whose run has one step adds onto its row, a step of a longer run
    writes a partial row, and the ordered reduction adds a run's
    partials onto its row in step order, with no atomics. Bound by the
    pairs' operations; its bytes add the partial rows, written once and
    read back once (csrc/pairs.cuh)."""
    if tgt_geo.device.type == "cpu":
        return exec_pairs_static_torch(kernel, tgt_geo, src_gathered,
                                       group_t, out_fm, final, core, group)
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    _launch_pre("exec_static", kernel, core, tgt_geo, src_gathered, group_t,
                out_fm, group, n_slots, gt_host=gt_host)
    return _finish(kernel, out_fm, final)


# ------------------------------------------------------- pregather + doors

def pregather_chunk(group: int, c: int, b: int) -> int:
    """Steps per pregather chunk: the largest power of two whose gathered
    buffer stays within PREGATHER_BYTES at C rounded up to 8 rows, at
    least 1024 (reference pallas_pairs.py:894-897)."""
    c8 = -(-c // 8) * 8
    chunk = max(1024, PREGATHER_BYTES // (group * c8 * b * 4))
    return 1 << (chunk.bit_length() - 1)


def _pregather(kernel_name: str, src_fm, gs, b: int, pad8: bool = True,
               out=None):
    """One row gather: (P, G) block ids of src_fm (NN, C, B) ->
    (P, G*C, B) contiguous source blocks.

    pad8=True is the reference's pass (pallas_pairs.py:_pregather): lean
    rows are padded to 8 with the DERIVED rows of the padded layout
    (pad_fm_rows), never zeros where featurize puts a product. The
    port's executors pass pad8=False: K8/K9 read only the lean rows, at
    whatever row stride the buffer has, so the gathered bytes stay
    C/8 of the padded ones. `out` (>= P*G, C, B) is a buffer to gather
    into (pad8=False only)."""
    p, g = gs.shape
    ids = gs.reshape(-1)
    if out is not None and not pad8:
        srcs = torch.index_select(src_fm, 0, ids, out=out[:p * g])
    else:
        srcs = src_fm.index_select(0, ids)
    if pad8:
        srcs = pad_fm_rows(kernel_name, srcs)
    return srcs.view(p, -1, b)


def n_real_slots(group_s):
    """(P,) slots of each step up to its last non-zero source id."""
    g = group_s.shape[1]
    pos = torch.arange(1, g + 1, device=group_s.device)
    return ((group_s != 0) * pos).amax(dim=1)


def _check_fetch(fetch: str):
    if fetch not in PAIR_FETCHES:
        raise ValueError(f"pair_fetch {fetch!r}: one of {PAIR_FETCHES}")


def _exec_pregather(kind: str, kernel, tgt_geo, src_fm, group_t, group_s,
                    out_fm, core: str, twin: bool):
    """Chunked execution on gathered sources into out_fm: per chunk of
    steps one row gather into a buffer allocated once, then `kind` (K8
    "exec_pre" or K9 "exec_pre_t2": the segment kernel and, when a run
    was split, the reduction; K12 "exec_static") or its twin. Chunks are
    separate launches in stream order on one accumulator, so a run cut
    by a chunk boundary resumes from its partial sum (reference
    pallas_pairs.py:31-36). K8/K9/K12 plan every chunk from one host copy
    of group_t, so no chunk waits on the card before it is queued."""
    p, g = group_s.shape
    b = tgt_geo.shape[2]
    chunk = pregather_chunk(g, src_fm.shape[1], b)
    if kind == "exec_static":
        run = exec_pairs_static_torch if twin else exec_pairs_static_cuda
    elif kind == "exec_pre_t2":
        run = exec_pairs_pre_torch_t2 if twin else exec_pairs_pre_cuda_t2
    else:
        run = exec_pairs_pre_torch if twin else exec_pairs_pre_cuda
    # every chunk planned from one host copy of the list
    host = (None if twin or tgt_geo.device.type != "cuda"
            else group_t.cpu())
    buf = src_fm.new_empty((min(p, chunk) * g,) + src_fm.shape[1:])
    for i in range(0, p, chunk):
        gt_c, gs_c = group_t[i:i + chunk], group_s[i:i + chunk]
        src_c = _pregather(kernel.name, src_fm, gs_c, b, pad8=False,
                           out=buf)
        kw = {} if twin else dict(n_slots=n_real_slots(gs_c))
        if host is not None:
            kw["gt_host"] = host[i:i + chunk]
        if kind != "exec_pre_t2":
            kw["final"] = False
        run(kernel, tgt_geo, src_c, gt_c, out_fm, core=core, group=g, **kw)


def exec_pairs(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
               core: str = "rm", fetch: str = "pregather", out_fm=None,
               final: bool = True, twin: bool = False):
    """Unpaired grouped execution with the reference's fetch argument
    (pallas_pairs.py:exec_pairs_pallas). 'pregather' gathers each chunk
    of steps contiguous and runs K8; 'static' does the same and runs
    K12; 'dma_i' runs K1, 'dma' K10 and 'dma_p' K11, which fetch by
    source id. CPU tensors, or twin=True, take the plain twins through
    the same chunking. Double source rows (the accuracy tier) run K1-f64
    whatever the fetch (tgt_geo promoted). Adds into out_fm (zeros when
    None); final=True returns (NN_t, B, OD)."""
    _check_fetch(fetch)
    if src_fm.dtype == torch.float64:
        # the accuracy tier: K1-f64 for every fetch
        if twin:
            return exec_pairs_torch(kernel, tgt_geo, src_fm, group_t,
                                    group_s, out_fm, final, core,
                                    torch.float64)
        return exec_pairs64_cuda(kernel, tgt_geo, src_fm, group_t, group_s,
                                 out_fm, final, core)
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    if fetch in ("pregather", "static"):
        kind = "exec_pre" if fetch == "pregather" else "exec_static"
        _exec_pregather(kind, kernel, tgt_geo, src_fm, group_t, group_s,
                        out_fm, core, twin)
        return _finish(kernel, out_fm, final)
    run = exec_pairs_torch if twin else {
        "dma_i": exec_pairs_cuda, "dma": exec_pairs_dma_cuda,
        "dma_p": exec_pairs_dmap_cuda}[fetch]
    return run(kernel, tgt_geo, src_fm, group_t, group_s, out_fm, final,
               core)


def exec_pairs_t2(kernel: Kernel, tgt_geo, src_fm, group_t, group_s, out_fm,
                  core: str = "rm", fetch: str = "dma_i",
                  twin: bool = False):
    """Sibling-paired grouped execution on parent-keyed steps
    (pallas_pairs.py:exec_pairs_pallas_t2): 'pregather' runs K9, the
    dma family K2 (the reference runs _body_interleaved_t2 for all
    three); 'static' has no chained-accumulator form and is refused.
    Adds into out_fm and returns it."""
    _check_fetch(fetch)
    if fetch == "static":
        raise ValueError("sibling-paired lists need a dma-family or "
                         "pregather pair_fetch")
    if src_fm.dtype == torch.float64:
        raise ValueError("sibling-paired lists have no fp64 executor: the "
                         "accuracy tier runs the leaf level unpaired")
    if fetch == "pregather":
        _exec_pregather("exec_pre_t2", kernel, tgt_geo, src_fm, group_t,
                        group_s, out_fm, core, twin)
        return out_fm
    run = exec_pairs_torch_t2 if twin else exec_pairs_cuda_t2
    return run(kernel, tgt_geo, src_fm, group_t, group_s, out_fm, core)


# ------------------------------------- static capacity (the fused solve)

# bits of a capped launch's error code: each the failure of one of the
# eager wrappers' checks (_launch), found on the device
RUN_TARGETS, RUN_SOURCES, RUN_TWICE, RUN_GAP = 1, 2, 4, 8


class CappedRuns(NamedTuple):
    """The run table of a work list at its static capacity P, made on the
    list's device with no wait on the host (capped_runs): runs [0, n_runs)
    of run_tgt (P + 1,) and run_off (P + 2,) are _run_table's, pair_s
    (P, G) the list's source ids, all int32; n_runs (1,) int32 is 0 when
    `bad` ((), int32, RUN_* bits) is not, so a failed list launches no
    work."""
    run_tgt: torch.Tensor
    run_off: torch.Tensor
    pair_s: torch.Tensor
    n_runs: torch.Tensor
    bad: torch.Tensor


def capped_runs(group_t, group_s, nn_keys: int, nn_src: int) -> CappedRuns:
    """_runs and the id checks of _launch on a cap-sized list whose real
    steps (group_t != 0) form a prefix, as group_pairs leaves them: a run
    starts where the key changes, counted by a cumsum and placed by a
    scatter (no nonzero, no unique, no host read). The checks set bits of
    `bad` instead of raising: a target key outside [1, nn_keys)
    (RUN_TARGETS), a source id of a real step outside [0, nn_src)
    (RUN_SOURCES), a key in two separate runs (RUN_TWICE: two CTAs would
    race on its rows), a real step after a pad step (RUN_GAP)."""
    p = group_t.shape[0]
    dev = group_t.device
    gt = group_t.long()
    real = gt != 0
    prev = torch.cat([gt.new_zeros(1), gt])[:p]
    prev_real = torch.cat([real.new_zeros(1), real])[:p]
    start = real & ((gt != prev) | ~prev_real)
    n_runs = start.sum()
    rid = torch.cumsum(start, 0) - 1
    # slot p of run_tgt and p + 1 of run_off are dump slots
    run_tgt = gt.new_zeros(p + 1).scatter_(0, torch.where(start, rid, p), gt)
    run_off = gt.new_zeros(p + 2).scatter_(
        0, torch.where(start, rid, p + 1), torch.arange(p, device=dev))
    run_off.scatter_(0, n_runs.view(1), real.sum().view(1))
    in_range = (gt >= 1) & (gt < nn_keys)
    bad_t = (real & ~in_range).any()
    bad_s = (real[:, None] & ((group_s < 0) | (group_s >= nn_src))).any()
    # runs per key (key 0 collects the starts out of range)
    seen = torch.zeros(nn_keys, dtype=torch.int64, device=dev).scatter_add_(
        0, torch.where(start & in_range, gt, 0), start.long())
    twice = (seen[1:] > 1).any()
    gap = (real & ~prev_real)[1:].any()
    bad = (bad_t.int() * RUN_TARGETS + bad_s.int() * RUN_SOURCES
           + twice.int() * RUN_TWICE + gap.int() * RUN_GAP)
    n_runs = torch.where(bad == 0, n_runs, 0).to(torch.int32).view(1)
    return CappedRuns(run_tgt.to(torch.int32), run_off.to(torch.int32),
                      group_s.to(torch.int32).contiguous(), n_runs, bad)


class RunChecks:
    """The id checks of a solve's capped launches, kept on the device: each
    launch adds its entry name, its key and source ranges and its error
    code (CappedRuns.bad). word() stacks the codes into one small tensor,
    read once when the solve is done; raise_for(values) raises the eager
    wrappers' ValueError for the first failed launch."""

    def __init__(self):
        self.names, self.codes = [], []

    def add(self, name: str, nn_keys: int, nn_src: int, bad) -> None:
        self.names.append((name, nn_keys, nn_src))
        self.codes.append(bad)

    def word(self, device) -> torch.Tensor:
        if not self.codes:
            return torch.zeros((0,), dtype=torch.int32, device=device)
        return torch.stack(self.codes)

    def raise_for(self, values) -> None:
        for (name, nn_keys, nn_src), v in zip(self.names, values):
            if v & RUN_TARGETS:
                raise ValueError(f"{name}: row ids out of range (targets "
                                 f"outside [1, {nn_keys}))")
            if v & RUN_SOURCES:
                raise ValueError(f"{name}: row ids out of range (sources "
                                 f"outside [0, {nn_src}))")
            if v & RUN_TWICE:
                raise ValueError("pair executor: a target row appears in "
                                 "two separate runs; the list must be "
                                 "grouped by target")
            if v & RUN_GAP:
                raise ValueError(f"{name}: a pad step lies between real "
                                 "steps; the list must be front-packed")


class CappedSegments(NamedTuple):
    """The segment plan of a gathered chunk at its static capacity P (its
    CappedRuns'), made on the chunk's device with no wait on the host
    (capped_segments): segments [0, n_seg) of seg_run (P,) and seg_off
    (P + 1,) and runs [0, n_runs] of run_seg (P + 2,) are _plan_segments'
    tables and split runs [0, n_split) of split_runs (P + 1,) the eager
    plan's (SegPlan), all int32; n_seg and n_split (1,) int32 are 0 when
    the runs' count is."""
    seg_run: torch.Tensor
    seg_off: torch.Tensor
    run_seg: torch.Tensor
    split_runs: torch.Tensor
    n_seg: torch.Tensor
    n_split: torch.Tensor


def capped_segments(runs: CappedRuns, seg_steps) -> CappedSegments:
    """_plan_segments (at seg_steps, an int or a () tensor on the card,
    >= 1) and the split runs of the eager plan, on a chunk's capped run
    table: each run's segment count from its length, their starts by a
    cumsum, each segment's run by a scatter and a cumsum, the split runs
    placed by a cumsum and a scatter (no nonzero, no repeat_interleave,
    no host read). Runs past runs.n_runs have no segment, so the tables'
    prefixes are the eager plan's integer for integer."""
    p = runs.run_tgt.shape[0] - 1
    dev = runs.run_tgt.device
    n = runs.n_runs.long()
    off = runs.run_off.long()
    r = torch.arange(p + 1, device=dev)
    live = r < n
    lens = torch.where(live, off[1:] - off[:-1], 0)
    nseg = (lens + seg_steps - 1) // seg_steps
    run_seg = torch.cat([nseg.new_zeros(1), torch.cumsum(nseg, 0)])
    n_seg = run_seg[n]
    # each segment's run: a step up at every later run's first segment
    # (slot p is the dump of the runs that add none), summed
    up = torch.zeros(p + 1, dtype=torch.long, device=dev).scatter_(
        0, torch.where(live & (r > 0), run_seg[:-1], p), 1)
    seg_run = torch.cumsum(up, 0)[:p]
    rank = torch.arange(p, device=dev) - run_seg[seg_run]
    seg_off = torch.cat([off[seg_run] + rank * seg_steps,
                         off.new_zeros(1)]).scatter_(0, n_seg, off[n])
    split = nseg > 1
    pos = torch.cumsum(split, 0) - 1
    split_runs = r.new_zeros(p + 2).scatter_(
        0, torch.where(split, pos, p + 1), r)[:p + 1]
    return CappedSegments(*(t.to(torch.int32) for t in (
        seg_run, seg_off, run_seg, split_runs, n_seg, split.sum().view(1))))


def capped_seg_steps(kind: str, inst: str, group_t, b: int, c: int,
                     g: int):
    """seg_steps_for's S of a chunk's K8/K9 segment kernel, on the card:
    the chunk's real steps counted there (a () int64 tensor)."""
    ctas, sms = _resident_ctas(kind, inst, b, c, g,
                               group_t.device.index or 0)
    n_real = (group_t != 0).sum()
    return (n_real // (SEG_WAVES * sms * max(ctas, 1))).clamp(min=1)


def _exec_pregather_capped(kind: str, kernel, tgt_geo, src_fm, group_t,
                           group_s, out_fm, core: str, checks: RunChecks):
    """_exec_pregather on a list kept at its static capacity: the same
    chunks (the real steps form a prefix, so their bounds are the eager
    ones), each gathered whole into one buffer, its run table and segment
    plan made on the card (capped_runs, capped_segments at S from
    capped_seg_steps; K12 at 1) with the error code added to `checks`,
    then `kind`'s segment kernel (K8 "exec_pre", K9 "exec_pre_t2", K12
    "exec_static") launched at the chunk's capacity and the reduction on
    a quarter of it (its rows walk the split runs), the counts read on
    the card, the partial rows in a scratch of the chunk's capacity
    allocated once per list. CPU tensors take the twins on the same chunks, masked as
    exec_pairs_capped masks the dma family's. A chunk that fails its checks adds nothing; a real step
    after a pad step anywhere in the list fails every chunk (RUN_GAP)."""
    paired = kind == "exec_pre_t2"
    launched = kind if kind == "exec_static" else kind + "_seg"
    inst = cuda_lib.instance(kernel.name, core)
    name = cuda_lib.entry(launched, inst)
    p, g = group_s.shape
    nn_s, c, b = src_fm.shape
    nn_keys = tgt_geo.shape[0] // (2 if paired else 1)
    cuda = tgt_geo.device.type == "cuda"
    if cuda:
        _one_cuda_device(name, tgt_geo, src_fm, group_t, group_s, out_fm)
        _check_layout(kernel, tgt_geo, out_fm, c, paired, src_fm=src_fm)
        if max(tgt_geo.shape[0], p) >= 2 ** 31:
            raise ValueError("pair executor: sizes must fit in int32")
    chunk = pregather_chunk(g, c, b)
    real = group_t != 0
    gap = (real[1:] & ~real[:-1]).any().to(torch.int32) * RUN_GAP
    # ids out of range gather row 0 (their chunk fails RUN_SOURCES)
    ids = torch.where((group_s >= 0) & (group_s < nn_s), group_s, 0)
    buf = src_fm.new_empty((min(p, chunk) * g, c, b))
    rows = 2 if paired else 1
    partials = None
    for i in range(0, p, chunk):
        gt_c, gs_c = group_t[i:i + chunk], group_s[i:i + chunk]
        runs = capped_runs(gt_c, gs_c, nn_keys, nn_s)
        bad = runs.bad | gap
        checks.add(name, nn_keys, nn_s, bad)
        src_c = _pregather(kernel.name, src_fm, ids[i:i + chunk], b,
                           pad8=False, out=buf)
        if not cuda:
            gt_m = torch.where(bad == 0, gt_c, 0)
            if paired:
                exec_pairs_pre_torch_t2(kernel, tgt_geo, src_c, gt_m,
                                        out_fm, core, g)
            else:
                exec_pairs_pre_torch(kernel, tgt_geo, src_c, gt_m, out_fm,
                                     False, core, g)
            continue
        runs = runs._replace(n_runs=torch.where(bad == 0, runs.n_runs, 0))
        cap = gt_c.shape[0]
        seg_steps = 1 if kind == "exec_static" else capped_seg_steps(
            launched, inst, gt_c, b, c, g)
        segs = capped_segments(runs, seg_steps)
        if partials is None:
            partials = out_fm.new_empty((cap, rows, kernel.od, b))
        slots = n_real_slots(gs_c).to(torch.int32)
        steps = torch.arange(cap, dtype=torch.int32, device=gt_c.device)
        stream = cuda_lib.stream_ptr(out_fm.device)
        rc = getattr(cuda_lib.lib(), name)(
            tgt_geo.data_ptr(), src_c.data_ptr(), out_fm.data_ptr(),
            partials.data_ptr(), runs.run_tgt.data_ptr(),
            segs.run_seg.data_ptr(), segs.seg_run.data_ptr(),
            segs.seg_off.data_ptr(), steps.data_ptr(), slots.data_ptr(),
            segs.n_seg.data_ptr(), cap, b, c, g, out_fm.shape[1], stream)
        cuda_lib.check(rc, name)
        LAUNCHES[(launched, inst)] += 1
        red = cuda_lib.entry("exec_pre_reduce", inst)
        rc = getattr(cuda_lib.lib(), red)(
            out_fm.data_ptr(), partials.data_ptr(), runs.run_tgt.data_ptr(),
            segs.run_seg.data_ptr(), segs.split_runs.data_ptr(),
            segs.n_split.data_ptr(), max(1, cap // 4), rows, b,
            out_fm.shape[1], stream)
        cuda_lib.check(rc, red)
        LAUNCHES[("exec_pre_reduce", inst)] += 1
    return out_fm


# the kernel each dma-family fetch runs on an unpaired list
_BY_ID = {"dma_i": "exec", "dma": "exec_dma", "dma_p": "exec_dmap"}


def exec_pairs_capped(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                      checks: RunChecks, core: str = "rm",
                      fetch: str = "dma_i", out_fm=None,
                      paired: bool = False):
    """The executors on a list kept at its static capacity, as the fused
    solve runs them. The dma family: the run table made on the list's
    device (capped_runs) and its checks added to `checks`, then K1, K10
    or K11 (paired: K2, parent-keyed steps) launched with the run count
    in device memory, one CTA per step slot, those past the count exiting
    at once. 'pregather' and 'static': _exec_pregather_capped, K8 (paired:
    K9) or K12 and the reduction per gather chunk on a plan made on the
    card. Nothing waits on the host. CPU tensors take the twins on the
    same list. A list that fails its checks adds nothing (its run count
    is 0; the twins see pad steps). Adds into out_fm (zeros when None)
    and returns it, feature-major. Double source rows run K1-f64 for
    every fetch (tgt_geo promoted; no paired form)."""
    _check_fetch(fetch)
    f64 = src_fm.dtype == torch.float64
    if f64:
        if paired:
            raise ValueError("sibling-paired lists have no fp64 executor")
        tgt_geo = tgt_geo.double()
    elif paired and fetch == "static":
        raise ValueError("sibling-paired lists need a dma-family or "
                         "pregather pair_fetch")
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    if not f64 and fetch in ("pregather", "static"):
        kind = ("exec_static" if fetch == "static" else
                "exec_pre_t2" if paired else "exec_pre")
        return _exec_pregather_capped(kind, kernel, tgt_geo, src_fm,
                                      group_t, group_s, out_fm, core, checks)
    kind = "exec64" if f64 else "exec_t2" if paired else _BY_ID[fetch]
    inst = (kernel.name if kernel.name == "grav3d"
            else f"{kernel.name}_{core}")
    nn_keys = tgt_geo.shape[0] // (2 if paired else 1)
    runs = capped_runs(group_t, group_s, nn_keys, src_fm.shape[0])
    checks.add(cuda_lib.entry(kind, inst), nn_keys, src_fm.shape[0],
               runs.bad)
    if tgt_geo.device.type == "cpu":
        gt = torch.where(runs.bad == 0, group_t, 0)
        if paired:
            return exec_pairs_torch_t2(kernel, tgt_geo, src_fm, gt, group_s,
                                       out_fm, core)
        return exec_pairs_torch(kernel, tgt_geo, src_fm, gt, group_s,
                                out_fm, False, core)
    _launch(kind, kernel, core, tgt_geo, src_fm, group_t, group_s, out_fm,
            runs)
    return out_fm


# ------------------------------------------------- K13: the ablated K10

def _ablate_tile(mode: str, tpos, src):
    """One slot's term of K13's `mode` for each step: tpos (P, B_t, 3)
    targets, src (P, C, B_s) source blocks with rows x, y, z, sr, m ->
    (P, B_t, k): 'full' sum m (|d|^2 + sr^2)^(-3/2) d and 'norsqrt' sum
    m (|d|^2 + sr^2) d (k 3, d = s - t), 'd2' sum |d|^2 (k 1), 'dma'
    the target's own lane of rows 0-2 (k 3, no pair sum)."""
    if mode == "dma":
        return src[:, 0:3, :].transpose(1, 2)
    d = [src[:, k:k + 1, :] - tpos[:, :, k:k + 1] for k in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    if mode == "d2":
        return d2.sum(-1, keepdim=True)
    sr = src[:, 3:4, :]
    r2 = d2 + sr * sr
    if mode == "norsqrt":
        w = src[:, 4:5, :] * r2
    else:
        rinv = torch.rsqrt(r2)
        w = src[:, 4:5, :] * (rinv * rinv * rinv)
    return torch.stack([(w * dk).sum(-1) for dk in d], dim=-1)


def exec_ablate_torch(mode: str, tgt_geo, src_fm, group_t, group_s,
                      out_fm=None):
    """Plain twin of K13 in `mode` (cuda_lib.ABLATE_MODES): out_fm
    (NN_t, 8, B) rows 0-2 (row 0 for 'd2') += the mode's sum over every
    step of a target row and its non-zero source ids (_ablate_tile), in
    chunks of steps, index_add_-ed as _twin_add does. Source id 0 is
    skipped, as the kernel starts no copy for it. Returns out_fm."""
    if mode not in cuda_lib.ABLATE_MODES:
        raise ValueError(f"K13 mode {mode!r}: one of "
                         f"{cuda_lib.ABLATE_MODES}")
    if out_fm is None:
        out_fm = _zeros_fm(KERNELS["grav3d"], tgt_geo)
    keep = group_t != 0
    gt, gs = group_t[keep].long(), group_s[keep].long()
    b = tgt_geo.shape[2]
    step = _twin_steps(tgt_geo, b)
    for p0 in range(0, gt.shape[0], step):
        sel = slice(p0, p0 + step)
        t_c = gt[sel]
        tpos = tgt_geo[t_c][:, :3, :].transpose(1, 2)
        acc = None
        for j in range(gs.shape[1]):
            ids = gs[sel, j]
            tj = _ablate_tile(mode, tpos, src_fm[ids])
            tj = torch.where((ids != 0)[:, None, None], tj, 0.0)
            acc = tj if acc is None else acc + tj
        add = out_fm.new_zeros((t_c.shape[0],) + out_fm.shape[1:])
        add[:, :acc.shape[-1]] = acc.transpose(1, 2)
        out_fm.index_add_(0, t_c, add)
    return out_fm


def exec_ablate(mode: str, tgt_geo, src_fm, group_t, group_s, out_fm=None):
    """K13, the grav3d executor K10 with its body ablated to `mode`
    ('dma', 'd2', 'norsqrt', 'full'; see csrc/grav3d_ablate_body.cuh):
    CUDA tensors launch K13's `mode`, CPU tensors take
    exec_ablate_torch. tgt_geo (NN_t, 8, B), src_fm (NN_s, C >= 5, B)
    float32, B a multiple of 4; the work list as for K10 (steps grouped
    by target row, pad steps group_t == 0). Adds into out_fm (NN_t, 8, B)
    (zeros when None) and returns it.

    K13 replaces scripts/exp_kernel.py:run with make_variant(mode):
    K10's schedule, one CTA per run fetching its blocks by bulk
    asynchronous copies, on the ablated bodies, so the four modes split
    K10's time into fetch, distances, the rest of the arithmetic and the
    rsqrt. Each mode reads row 3 as sr and squares it, as the script
    does (the production rows store sr^2 there). 'dma' is bound by the
    bytes it fetches, the others by the operations their pairs need."""
    if tgt_geo.device.type == "cpu":
        return exec_ablate_torch(mode, tgt_geo, src_fm, group_t, group_s,
                                 out_fm)
    if mode not in cuda_lib.ABLATE_MODES:
        raise ValueError(f"K13 mode {mode!r}: one of "
                         f"{cuda_lib.ABLATE_MODES}")
    kernel = KERNELS["grav3d"]
    if out_fm is None:
        out_fm = _zeros_fm(kernel, tgt_geo)
    _launch(f"exec_ablate_{mode}", kernel, "rm", tgt_geo, src_fm, group_t,
            group_s, out_fm)
    return out_fm
