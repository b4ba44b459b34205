"""Pair-list executor dispatch (port of onbody_tpu/traverse/exec.py).

Groups the builder's flat (tgt_row, src_row) list into G-wide chunks and
runs them through the grouped executor into one feature-major
accumulator (od8 = OD rounded up to 8 rows: 16 for vortgrad3d); the
sibling-paired leaf list, when given, chains into the same accumulator
through the paired executor (reference exec.py:263-302). Both run the
workload's body with cfg.core_func.

Backends (config.pair_backend): 'auto' runs the CUDA kernels on CUDA
tensors and the torch twins on CPU tensors, 'cuda' the kernels (raising
on CPU tensors), 'torch' the twins.
"""

from __future__ import annotations

from typing import Optional

from onbody_tpu_torch.config import pair_backend
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.traverse.lists import PairGroups, PairList, group_pairs
from onbody_tpu_torch.utils.timing import phase


def _executors(cfg, tgt_geo):
    backend = pair_backend(cfg)
    if backend == "torch":
        return pp.exec_pairs_torch, pp.exec_pairs_torch_t2
    if backend == "cuda" and tgt_geo.device.type != "cuda":
        raise ValueError("pair_backend='cuda' needs CUDA tensors")
    return pp.exec_pairs_cuda, pp.exec_pairs_cuda_t2


def _grouped(raw: PairList, cfg, slot_width: int,
             cap_groups_per_row: int) -> PairGroups:
    """Group at the reference's static capacity, then trim the padding
    tail (groups are front-packed) so the executor visits real groups."""
    g = cfg.pair_group
    n_rows = raw.tgt.shape[0] // slot_width
    cap = max(1024, n_rows * cap_groups_per_row * pp.GROUP // g)
    pg = group_pairs(raw, cap, g, slot_width)
    n = int((pg.tgt != 0).sum())
    return pg._replace(tgt=pg.tgt[:n], src=pg.src[:n])


def exec_pairs(kernel: Kernel, cfg, plan, raw: PairList, slot_width: int,
               cap_groups_per_row: int, raw2: Optional[PairList] = None,
               timer=None):
    """Run the builder's list (and the paired leaf list raw2) and return
    (out (NN_t, B, OD), info). info carries the interior groups, with
    the builder's combined n_valid and the summed overflow."""
    run, run_t2 = _executors(cfg, plan.tgt_geo)
    nn_t, _, b = plan.tgt_geo.shape
    out_fm = plan.tgt_geo.new_zeros((nn_t, pp.od8(kernel), b))
    with phase(timer, "exec interior"):
        pg = _grouped(raw, cfg, slot_width, cap_groups_per_row)
        run(kernel, plan.tgt_geo, plan.src_fm, pg.tgt, pg.src, out_fm,
            final=False, core=cfg.core_func)
    info = pg
    if raw2 is not None:
        with phase(timer, "exec leaf2"):
            pg2 = _grouped(raw2, cfg, slot_width, cap_groups_per_row)
            run_t2(kernel, plan.tgt_geo, plan.src_fm, pg2.tgt, pg2.src,
                   out_fm, core=cfg.core_func)
        info = pg._replace(n_valid=raw.n_valid,
                           overflow=pg.overflow + pg2.overflow)
    return out_fm[:, :kernel.od, :].transpose(1, 2), info
