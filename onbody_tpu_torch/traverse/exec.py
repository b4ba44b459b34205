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

Fetch (config.pair_fetch, the reference's exec.py:252-292): 'pregather'
gathers each chunk of steps contiguous and runs K8 (paired: K9); the dma
family fetches by source id, 'dma_i' with K1, 'dma' with K10 and 'dma_p'
with K11 (paired: K2 for all three, as the reference runs one paired
body for them); 'static' gathers each chunk and runs K12 (K8 at one step
per segment), and refuses a paired list, as the reference does.

The eager path trims each grouped list to its real steps (one read of
the count); the fused solve's route (`checks`) keeps the static
capacity, as the reference does inside jit (exec.py:237-246, 266-275),
and plans every kernel launch on the card.

cfg.accum_dtype float64 (the accuracy tier) runs every fetch through
K1-f64 on the double source rows the plan holds, tgt_geo promoted, into
a float64 accumulator (reference exec.py:151-152); it takes no paired
leaf list.
"""

from __future__ import annotations

from typing import Optional

from onbody_tpu_torch.config import pair_backend
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.traverse.lists import PairGroups, PairList, group_pairs
from onbody_tpu_torch.utils.timing import phase


def _use_twin(cfg, tgt_geo) -> bool:
    backend = pair_backend(cfg)
    if backend == "cuda" and tgt_geo.device.type != "cuda":
        raise ValueError("pair_backend='cuda' needs CUDA tensors")
    return backend == "torch"


def _trim(pg: PairGroups) -> PairGroups:
    """Drop the padding tail (groups are front-packed), so the executor
    and the pregather pass visit real groups only. One host sync."""
    n = int((pg.tgt != 0).sum())
    return pg._replace(tgt=pg.tgt[:n], src=pg.src[:n])


def _grouped(raw: PairList, cfg, slot_width: int, cap_groups_per_row: int,
             trim: bool = True) -> PairGroups:
    """Group at the reference's static capacity, then (trim) trim the
    tail."""
    g = cfg.pair_group
    n_rows = raw.tgt.shape[0] // slot_width
    cap = max(1024, n_rows * cap_groups_per_row * pp.GROUP // g)
    pg = group_pairs(raw, cap, g, slot_width)
    return _trim(pg) if trim else pg


def exec_groups(kernel: Kernel, cfg, plan, pg: PairGroups):
    """Run pre-grouped interactions (reference exec.py:exec_groups) and
    return (out (NN_t, B, OD), pg)."""
    twin = _use_twin(cfg, plan.tgt_geo)
    trimmed = _trim(pg)
    out = pp.exec_pairs(kernel, plan.tgt_geo.to(cfg.accum_dtype),
                        plan.src_fm, trimmed.tgt,
                        trimmed.src, cfg.core_func, fetch=cfg.pair_fetch,
                        twin=twin)
    return out, pg


def exec_pairs(kernel: Kernel, cfg, plan, raw: PairList, slot_width: int,
               cap_groups_per_row: int, raw2: Optional[PairList] = None,
               timer=None, checks: Optional[pp.RunChecks] = None):
    """Run the builder's list (and the paired leaf list raw2) and return
    (out (NN_t, B, OD), info). info carries the interior groups, with
    raw's combined n_valid (lists.build_dtt_pairs_level2) and the summed
    overflow.

    checks (the fused solve's route, every fetch): the groups keep their
    static capacity (no trim, so info holds the cap-sized arrays, as the
    reference's jitted program keeps them) and run through
    cuda_pairs.exec_pairs_capped (the kernels on CUDA tensors, whatever
    pair_backend says; solve_dtt_fused refuses 'torch' there), whose id
    checks land in `checks` on the device instead of raising; nothing
    waits on the host."""
    twin = _use_twin(cfg, plan.tgt_geo)
    fetch = cfg.pair_fetch
    capped = checks is not None
    if raw2 is not None and fetch == "static":
        raise ValueError("sibling-paired leaf lists need a dma-family or "
                         "pregather pair_fetch")
    # the rows in accum_dtype: src_fm is built so, tgt_geo is promoted
    tgt_geo = plan.tgt_geo.to(cfg.accum_dtype)
    with phase(timer, "exec interior"):
        pg = _grouped(raw, cfg, slot_width, cap_groups_per_row,
                      trim=not capped)
        if capped:
            out_fm = pp.exec_pairs_capped(
                kernel, tgt_geo, plan.src_fm, pg.tgt, pg.src, checks,
                cfg.core_func, fetch)
        else:
            out_fm = pp.exec_pairs(kernel, tgt_geo, plan.src_fm,
                                   pg.tgt, pg.src, cfg.core_func,
                                   fetch=fetch, final=False, twin=twin)
    info = pg
    if raw2 is not None:
        with phase(timer, "exec leaf2"):
            pg2 = _grouped(raw2, cfg, slot_width, cap_groups_per_row,
                           trim=not capped)
            if capped:
                pp.exec_pairs_capped(kernel, tgt_geo, plan.src_fm,
                                     pg2.tgt, pg2.src, checks,
                                     cfg.core_func, fetch, out_fm,
                                     paired=True)
            else:
                pp.exec_pairs_t2(kernel, tgt_geo, plan.src_fm, pg2.tgt,
                                 pg2.src, out_fm, cfg.core_func, fetch=fetch,
                                 twin=twin)
        info = pg._replace(n_valid=raw.n_valid,
                           overflow=pg.overflow + pg2.overflow)
    return out_fm[:, :kernel.od, :].transpose(1, 2), info
