"""Grouped pair executors: kernels K1/K2 and their plain twins (port of
onbody_tpu/ops/pallas_pairs.py), for every workload.

Work list: groups ordered by target row, group_t (P,) target rows (K2:
target PARENT ids q, standing for rows 2q and 2q+1) and group_s (P, G)
source rows; row 0 is the inert pad row and a pad step has group_t == 0.
Layouts are the reference's: tgt_geo (NN_t, 8, B) [pos | rad | 0],
src_fm (NN_s, C, B) from `featurize`, and the feature-major accumulator
out_fm (NN_t, od8, B) with od8 = OD rounded up to 8 (16 for vortgrad3d).

The accumulator is updated IN PLACE (the reference donates it to an
aliased output) and returned, so the interior pass and the paired leaf
pass chain through one buffer in stream order.

`exec_pairs_cuda` / `exec_pairs_cuda_t2` launch csrc/pairs.cuh's
instantiation for the kernel and core on CUDA tensors and take the twins
`exec_pairs_torch` / `exec_pairs_torch_t2` for CPU tensors; they never
move work between devices.
"""

from __future__ import annotations

import collections

import torch

from onbody_tpu_torch.ops import cuda_lib
from onbody_tpu_torch.ops.kernels import FM_ROWS, Kernel, featurize

GROUP = 8
# kernel launches by the wrappers, keyed ("exec" or "exec_t2", instance)
# with the instance as cuda_lib.instance names it (reset by callers that
# count a run)
LAUNCHES = collections.Counter()
# elements per (steps, B, B) twin temporary: bounds its chunk of steps
_TWIN_ELEMS = 1 << 22


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


def _finish(kernel: Kernel, out_fm, final: bool):
    if not final:
        return out_fm
    return out_fm[:, :kernel.od, :].transpose(1, 2)


# ---------------------------------------------------------------- twins

def exec_pairs_torch(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                     out_fm=None, final: bool = True, core: str = "rm"):
    """Plain twin of K1: per chunk of steps, gather the target blocks and
    each group slot's source blocks, evaluate the batched tiles with the
    kernel's per-pair form, and index_add_ them into their rows (the
    reference's traverse/exec.py:_exec_groups_xla_chunked). Pad steps are
    dropped."""
    nn_t, _, b = tgt_geo.shape
    pd = kernel.pd
    if out_fm is None:
        out_fm = tgt_geo.new_zeros((nn_t, od8(kernel), b))
    keep = group_t != 0
    gt, gs = group_t[keep].long(), group_s[keep].long()
    step = max(1, _TWIN_ELEMS // (b * b))
    for p0 in range(0, gt.shape[0], step):
        t_c, s_c = gt[p0:p0 + step], gs[p0:p0 + step]
        geo = tgt_geo[t_c]
        tpos = geo[:, :pd, :].transpose(1, 2)               # (P, B, PD)
        trad = geo[:, pd, :]                                # (P, B)
        acc = None
        for j in range(s_c.shape[1]):
            tj = kernel.tile_fm(tpos, trad, src_fm[s_c[:, j]], core)
            acc = tj if acc is None else acc + tj
        add = out_fm.new_zeros((t_c.shape[0],) + out_fm.shape[1:])
        add[:, :kernel.od] = acc.transpose(1, 2)
        out_fm.index_add_(0, t_c, add)
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


# --------------------------------------------------------------- kernels

def _runs(group_t, group_s):
    """Run table of a work list: maximal stretches of consecutive equal
    non-zero group_t. Returns (run_tgt, run_off, pair_s) as contiguous
    int32 on the list's device, pair_s holding the non-pad steps' source
    ids (runs are contiguous in it, run r at [run_off[r], run_off[r+1])).
    Raises if one target appears in two separate runs: two CTAs would
    race on its output row."""
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
    return (run_tgt.to(torch.int32).contiguous(),
            run_off.to(torch.int32).contiguous(),
            group_s[idx].to(torch.int32).contiguous())


def _check_exec(kernel: Kernel, tgt_geo, src_fm, group_t, group_s, out_fm,
                paired: bool):
    nn_t, rows_t, b = tgt_geo.shape
    nn_s, c, b_s = src_fm.shape
    rows = FM_ROWS[kernel.name]
    if rows_t != 8 or b_s != b or c < rows:
        raise ValueError(f"pair executor {kernel.name}: tgt_geo "
                         f"{tuple(tgt_geo.shape)} and src_fm "
                         f"{tuple(src_fm.shape)} do not match (NN, 8, B) / "
                         f"(NN, C>={rows}, B)")
    if tuple(out_fm.shape) != (nn_t, od8(kernel), b):
        raise ValueError(f"pair executor: out_fm {tuple(out_fm.shape)}, "
                         f"expected {(nn_t, od8(kernel), b)}")
    for name, t in (("tgt_geo", tgt_geo), ("src_fm", src_fm),
                    ("out_fm", out_fm)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"pair executor: {name} must be contiguous "
                             f"float32, got {t.dtype}")
    if group_s.ndim != 2 or group_t.shape[0] != group_s.shape[0]:
        raise ValueError("pair executor: group_t (P,) and group_s (P, G) "
                         "disagree")
    if b > 2048:
        raise ValueError(f"pair executor: block width {b} > 2048")
    if paired and nn_t % 2:
        raise ValueError("paired executor needs an even target row count")
    if max(nn_t, nn_s, group_s.numel()) >= 2 ** 31:
        raise ValueError("pair executor: sizes must fit in int32")


def _launch(kind: str, kernel, core, tgt_geo, src_fm, group_t, group_s,
            out_fm) -> bool:
    """Run one executor kernel; False when the list has no real step."""
    paired = kind == "exec_t2"
    inst = cuda_lib.instance(kernel.name, core)
    name = cuda_lib.entry(kind, inst)
    devs = {t.device for t in (tgt_geo, src_fm, group_t, group_s, out_fm)}
    if len(devs) != 1 or devs.pop().type != "cuda":
        raise ValueError(f"{name}: the kernel needs every tensor on one "
                         "CUDA device")
    _check_exec(kernel, tgt_geo, src_fm, group_t, group_s, out_fm, paired)
    run_tgt, run_off, pair_s = _runs(group_t, group_s)
    if run_tgt.numel() == 0:
        return False
    nn_t = tgt_geo.shape[0] // (2 if paired else 1)
    t_lo, t_hi, s_lo, s_hi = torch.stack(
        [run_tgt.min(), run_tgt.max(), pair_s.min(), pair_s.max()]).tolist()
    if t_lo < 1 or t_hi >= nn_t or s_lo < 0 or s_hi >= src_fm.shape[0]:
        raise ValueError(f"{name}: row ids out of range (targets "
                         f"[{t_lo}, {t_hi}] of {nn_t}, sources "
                         f"[{s_lo}, {s_hi}] of {src_fm.shape[0]})")
    _, c, b = src_fm.shape
    rc = getattr(cuda_lib.lib(), name)(
        tgt_geo.data_ptr(), src_fm.data_ptr(), out_fm.data_ptr(),
        run_tgt.data_ptr(), run_off.data_ptr(), pair_s.data_ptr(),
        run_tgt.numel(), b, c, pair_s.shape[1], out_fm.shape[1],
        cuda_lib.stream_ptr(out_fm.device))
    cuda_lib.check(rc, name)
    LAUNCHES[(kind, inst)] += 1
    return True


def exec_pairs_cuda(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                    out_fm=None, final: bool = True, core: str = "rm"):
    """Unpaired grouped executor. CUDA tensors launch K1, CPU tensors
    take exec_pairs_torch. Adds into out_fm (zeros when None) and returns
    it, or with final=True the point-major (NN_t, B, OD) view.

    K1 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk with
    _body_interleaved. It is bound by the SM's FP32/MUFU rates over the
    operations each pair needs (counted in the body's header; PERF.md
    has the bound):
    one CTA per run of a target row keeps the row's sums in registers
    and stages each source block in shared memory once for all B targets
    (csrc/pairs.cuh)."""
    if tgt_geo.device.type == "cpu":
        return exec_pairs_torch(kernel, tgt_geo, src_fm, group_t, group_s,
                                out_fm, final, core)
    if out_fm is None:
        out_fm = tgt_geo.new_zeros((tgt_geo.shape[0], od8(kernel),
                                    tgt_geo.shape[2]))
    _launch("exec", kernel, core, tgt_geo, src_fm, group_t, group_s,
            out_fm)
    return _finish(kernel, out_fm, final)


def exec_pairs_cuda_t2(kernel: Kernel, tgt_geo, src_fm, group_t, group_s,
                       out_fm, core: str = "rm"):
    """Sibling-paired grouped executor on parent-keyed steps. CUDA
    tensors launch K2, CPU tensors take exec_pairs_torch_t2. Adds into
    out_fm and returns it; rows 0 and 1 are never written.

    K2 replaces onbody_tpu/ops/pallas_pairs.py:_exec_chunk_t2 with
    _body_interleaved_t2. Same bound and design as K1; each staged
    source block serves both sibling rows, halving source traffic and
    shared-memory staging per pair."""
    if tgt_geo.device.type == "cpu":
        return exec_pairs_torch_t2(kernel, tgt_geo, src_fm, group_t,
                                   group_s, out_fm, core)
    _launch("exec_t2", kernel, core, tgt_geo, src_fm, group_t, group_s,
            out_fm)
    return out_fm
