"""Port vs reference: utils/timing.py (PhaseTimer and the flop
accounting the drivers' GFlop/s rest on) and Kernel.flops_fn."""

import types

import numpy as np
import pytest
import torch

from _torch_parity import kernel_inputs, torch_parts
from onbody_tpu.ops import kernels as JK
from onbody_tpu.utils import timing as jtiming
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import treecode as ttc
from onbody_tpu_torch.utils import timing as ttiming

torch.set_num_threads(1)


@pytest.mark.parametrize("levels,bs,n,order,pd,n_rows,width", [
    (4, 64, 1000, 4, 3, 32, 128),       # partial last leaf
    (5, 32, 1000, 3, 3, 96, 32),        # 64 proxies in 32: extension rows
    (4, 64, 1000, -1, 3, 32, 128),      # pair-merge
    (6, 128, 5000, 5, 2, 128, 128),
    (3, 16, 77, -1, 2, 16, 0)])
def test_block_real_counts_match_reference(levels, bs, n, order, pd,
                                           n_rows, width):
    got = ttiming.block_real_counts(levels, bs, n, order, pd, n_rows, width)
    ref = jtiming.block_real_counts(levels, bs, n, order, pd, n_rows, width)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("order", [4, -1])
def test_block_real_counts_match_blocks(order):
    """The per-row real-slot model matches the plan's Blocks (real slots
    carry non-zero strength; pad clones and parked proxies are zero; the
    mirror of test_block_real_counts_match_blocks). Pair-merge rows of a
    node that holds pad clones merge a real slot with a pad one, so they
    hold fewer slots than the model's min(real particles, bs), which is
    the reference's approximation (an upper bound there)."""
    kernel = TK.KERNELS["grav3d"]
    n = 1000                       # partial last leaf (16 x 64 = 1024)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 90, n)
    cfg = SolverConfig(block_size=64, order=order)
    plan = ttc.prepare(kernel, cfg, torch_parts(sx, sr, ss),
                       torch_parts(tx, tr))
    cnt = ttiming.block_real_counts(plan.stree.levels, cfg.block_size, n,
                                    cfg.order, kernel.pd,
                                    plan.src_fm.shape[0],
                                    plan.src_fm.shape[-1])
    actual = (plan.src_blocks.s.abs() > 0).any(-1).sum(1).numpy()
    if order >= 0:
        np.testing.assert_array_equal(cnt, actual)
        return
    nleaf = plan.stree.nleaf
    np.testing.assert_array_equal(cnt[nleaf:], actual[nleaf:])
    differ = np.flatnonzero(cnt != actual)
    assert (cnt >= actual).all() and differ.size
    # the rows that differ are the ancestors of the partial leaf
    partial_leaf = nleaf + n // cfg.block_size
    assert set(differ) == {partial_leaf >> k
                           for k in range(1, plan.stree.levels + 1)}


def test_interaction_flops_vs_hand_count_and_reference():
    """Real targets x real sources over the executed groups: equal to a
    numpy enumeration of the list and, on the same list, to the
    reference's count (which sums in float32), below the padded-tile
    upper bound."""
    kernel = TK.KERNELS["grav3d"]
    n = 3000
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 91, n)
    cfg = SolverConfig(block_size=64, order=4)
    plan = ttc.prepare(kernel, cfg, torch_parts(sx, sr, ss),
                       torch_parts(tx, tr))
    _, info = ttc.solve_treecode3(kernel, cfg, plan, theta=1.0)
    cnt_s = ttiming.block_real_counts(plan.stree.levels, cfg.block_size, n,
                                      cfg.order, kernel.pd,
                                      plan.src_fm.shape[0],
                                      plan.src_fm.shape[-1])
    cnt_t = ttiming.block_real_counts(plan.ttree.levels, cfg.block_size, n,
                                      cfg.order, kernel.pd,
                                      plan.tgt_geo.shape[0],
                                      plan.tgt_geo.shape[-1])
    kflops = kernel.flops_fn(cfg.core_func)
    got = ttiming.interaction_flops(info, cnt_t, cnt_s, kflops)
    tgt, src = info.tgt.numpy(), info.src.numpy()
    hand = sum(int(cnt_t[t]) * int(cnt_s[s])
               for t, row in zip(tgt, src) for s in row if s != 0)
    assert got == hand * kflops
    ref = jtiming.interaction_flops(types.SimpleNamespace(tgt=tgt, src=src),
                                    cnt_t, cnt_s, kflops)
    assert abs(ref - got) <= 1e-6 * got
    # a flat PairList counts the same pairs
    flat = info._replace(tgt=info.tgt.repeat_interleave(src.shape[1]),
                         src=info.src.reshape(-1))
    assert ttiming.interaction_flops(flat, cnt_t, cnt_s, kflops) == got
    ub = ttiming.pair_flops(int((info.src != 0).sum()), cfg.block_size,
                            kflops) * plan.src_fm.shape[-1] / cfg.block_size
    assert 0 < got < ub


@pytest.mark.parametrize("name", ["grav3d", "vort2d", "vort3d",
                                  "vortgrad3d"])
def test_flops_fn_matches_reference(name):
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    for core in tk.cores or ("rm",):
        assert tk.flops_fn(core) == jk.flops_fn(core), core


def test_phase_timer_time_report_total():
    timer = ttiming.PhaseTimer(torch.device("cpu"))
    assert timer.time("build", lambda a, b=0: a + b, 2, b=3) == 5
    with timer.phase("solve"):
        pass
    timer.time("build", lambda: None)
    assert list(timer.phases) == ["build", "solve"]
    lines = []
    timer.report(lines.append)
    assert [ln.split(":")[0] for ln in lines] == ["  build", "  solve"]
    assert all(ln.endswith("] seconds") for ln in lines)
    assert timer.total("build") == timer.phases["build"]
    assert timer.total("build", "absent") == timer.phases["build"]
    assert timer.total() == pytest.approx(sum(timer.phases.values()))
    assert timer.total("absent") == 0.0
