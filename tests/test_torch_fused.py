"""solve_dtt_fused on the CPU: the port's fused route (traverse/dtt.py)
against the reference's solve_dtt_fused, against the port's own prepare +
solve_dtt, and its pieces (the no-wait compaction, the run table made on
the list's device and its error codes) against their eager forms; a
dispatch guard shows the route never reads the device back outside the
kernels' twins. The card's side (the CUDA graph, the kernels at static
capacity) is in test_torch_cuda.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (SLICE_KW, SyncGuard, exempt, jax_parts,
                           kernel_inputs, rel_rms, torch_parts)
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops.kernels import get_kernel as jget_kernel
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import cuda_pairs as pp
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import dtt, lists, treecode
from onbody_tpu_torch.traverse import exec as pexec

torch.set_num_threads(1)

N = 900
# the reference's xla executor has no sibling-paired leaf pass
UNPAIRED = dict(SLICE_KW, dtt_leaf_pair2=False)


def _problem(name: str, n: int = N, seed: int = 5):
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, seed, n)
    return kernel, (sx, sr, ss, tx, tr), torch_parts(sx, sr, ss), \
        torch_parts(tx, tr)


@functools.lru_cache(maxsize=None)
def _reference_fused():
    """The reference's solve_dtt_fused (its xla executor, as
    tests/test_traverse.py:421 runs it) on one problem, in both unscramble
    forms, compiled once for every fetch the port runs against it."""
    jax.clear_caches()
    kernel, arrs, srcs, targs = _problem("grav3d", 1000, seed=3)
    sx, sr, ss, tx, tr = arrs
    jcfg = JConfig(**dict(UNPAIRED, pair_backend="xla"))
    jk = jget_kernel("grav3d")
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    ref, rinfo = jdtt.solve_dtt_fused(jk, jcfg, js, jt)
    (rtree, rinv), _ = jdtt.solve_dtt_fused(jk, jcfg, js, jt,
                                            unscramble=False)
    return (kernel, srcs, targs, np.asarray(ref), rinfo, np.asarray(rtree),
            np.asarray(rinv))


@pytest.mark.parametrize("fetch", ["dma_i", "pregather", "static"])
def test_fused_matches_reference_fused(fetch):
    """The same numpy inputs through the reference's solve_dtt_fused and
    the port's at `fetch`, in both unscramble forms: outputs within
    rel-RMS 1e-5, the cap-sized interior groups, n_valid, overflow and
    tgt_inv exactly; the tree-order output through tgt_inv is the
    unscrambled one."""
    kernel, srcs, targs, ref, rinfo, rtree, rinv = _reference_fused()
    cfg = SolverConfig(**dict(UNPAIRED, pair_fetch=fetch))
    out, info = dtt.solve_dtt_fused(kernel, cfg, srcs, targs)
    (tree, inv), info2 = dtt.solve_dtt_fused(kernel, cfg, srcs, targs,
                                             unscramble=False)
    assert rel_rms(out.numpy(), ref) <= 1e-5
    # real slots only: the pad slots' outputs are discarded
    assert rel_rms(tree[inv].numpy(), rtree[rinv]) <= 1e-5
    for got in (info, info2):
        assert got.tgt.shape == rinfo.tgt.shape
        np.testing.assert_array_equal(got.tgt.numpy(), np.asarray(rinfo.tgt))
        np.testing.assert_array_equal(got.src.numpy(), np.asarray(rinfo.src))
        assert int(got.n_valid) == int(rinfo.n_valid)
        assert int(got.overflow) == int(rinfo.overflow) == 0
    np.testing.assert_array_equal(inv.numpy(), rinv)
    assert torch.equal(tree[inv], out)


# the four workloads on the slice's keys (dma_i, paired leaves), grav3d at
# order -1 (pair-merge, _downward_copy) and under dma_p on idsort lists;
# pregather (K8 + K9) and static (K12, no paired list) for grav3d and
# vort2d
STATIC = dict(pair_fetch="static", dtt_leaf_pair2=False)
FUSED_CASES = {"grav3d": ("grav3d", {}), "vort3d": ("vort3d", {}),
               "vortgrad3d": ("vortgrad3d", {}), "vort2d": ("vort2d", {}),
               "grav3d-order-1": ("grav3d", dict(order=-1)),
               "grav3d-dma_p": ("grav3d", dict(pair_fetch="dma_p",
                                                list_compact="idsort")),
               "grav3d-pregather": ("grav3d", dict(pair_fetch="pregather")),
               "grav3d-static": ("grav3d", STATIC),
               "vort2d-pregather": ("vort2d", dict(pair_fetch="pregather")),
               "vort2d-static": ("vort2d", STATIC)}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_equals_split(case):
    """The fused route gives prepare + solve_dtt's outputs bit for bit in
    both forms; its interior groups are the split path's trimmed ones
    followed by pad steps, with the same n_valid and overflow."""
    name, kw = FUSED_CASES[case]
    kernel, _, srcs, targs = _problem(name)
    cfg = SolverConfig(**dict(SLICE_KW, **kw))
    plan = treecode.prepare(kernel, cfg, srcs, targs)
    ref, rinfo = dtt.solve_dtt(kernel, cfg, plan)
    out, info = dtt.solve_dtt_fused(kernel, cfg, srcs, targs)
    assert torch.equal(out, ref)
    (tree, inv), _ = dtt.solve_dtt_fused(kernel, cfg, srcs, targs,
                                         unscramble=False)
    rtree, _ = dtt.solve_dtt(kernel, cfg, plan, unscramble=False)
    assert torch.equal(tree, rtree) and torch.equal(inv, plan.tgt_inv)
    k = rinfo.tgt.shape[0]
    assert torch.equal(info.tgt[:k], rinfo.tgt)
    assert torch.equal(info.src[:k], rinfo.src)
    assert not info.tgt[k:].any() and not info.src[k:].any()
    assert int(info.n_valid) == int(rinfo.n_valid)
    assert int(info.overflow) == int(rinfo.overflow) == 0


def _compact_groups_nonzero(tgt, src, cap: int, group: int):
    """The eager compaction as it was before the fused route: the kept
    chunks found with nonzero (one wait on the host)."""
    tgt_c = tgt.view(-1, group)[:, 0]
    src_c = src.view(-1, group)
    keep = torch.nonzero((src_c != 0).any(1)).squeeze(1)
    k = min(keep.shape[0], cap)
    out_t = tgt.new_zeros((cap,))
    out_s = src.new_zeros((cap, group))
    out_t[:k] = tgt_c[keep[:k]]
    out_s[:k] = src_c[keep[:k]]
    return out_t, out_s, (src != 0).sum(), max(keep.shape[0] - cap, 0)


@pytest.mark.parametrize("cap", [4096, 200, 7])
def test_compact_groups_equals_nonzero_form(cap):
    """_compact_groups (cumsum + scatter) gives the nonzero form's groups,
    n_valid and dropped chunks, at a roomy capacity and at two that drop
    the tail (overflow)."""
    g = torch.Generator().manual_seed(cap)
    src = torch.randint(1, 50, (240, 16), generator=g)
    src[torch.rand((240, 16), generator=g) < 0.6] = 0
    src[30:90] = 0                                  # whole empty rows
    tgt = torch.arange(1, 241)[:, None].expand(-1, 16).reshape(-1)
    got = lists._compact_groups(tgt, src.reshape(-1), cap, 8, 16)
    want = _compact_groups_nonzero(tgt, src.reshape(-1), cap, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[2]) == int(want[2]) and int(got[3]) == want[3]
    assert (int(got[3]) > 0) == (cap < 4096)


def _dtt_groups(paired: bool):
    """A slice's cap-sized interior (or paired leaf) groups and its plan."""
    kernel, _, srcs, targs = _problem("grav3d")
    cfg = SolverConfig(**SLICE_KW)
    plan = treecode.prepare(kernel, cfg, srcs, targs)
    raws = lists.build_dtt_pairs_level2(
        plan.stree, plan.ttree, cfg.theta_dtt, cfg.frontier_width,
        n_live=plan.tgt_sorted.n_real)
    pg = pexec._grouped(raws[paired], cfg, cfg.frontier_width,
                        cfg.cap_groups_dtt, trim=False)
    return plan, pg


@pytest.mark.parametrize("paired", [False, True])
def test_capped_runs_equal_run_table(paired):
    """capped_runs on a slice's cap-sized list: on its real prefix the
    eager run table (_runs) exactly, the count in memory, no error."""
    plan, pg = _dtt_groups(paired)
    nn_keys = plan.tgt_geo.shape[0] // (2 if paired else 1)
    runs = pp.capped_runs(pg.tgt, pg.src, nn_keys, plan.src_fm.shape[0])
    run_tgt, run_off, pair_s = pp._runs(pg.tgt, pg.src)
    n = run_tgt.numel()
    assert int(runs.bad) == 0 and runs.n_runs.tolist() == [n]
    assert pg.tgt.shape[0] > pair_s.shape[0] >= n > 0
    assert torch.equal(runs.run_tgt[:n], run_tgt)
    assert torch.equal(runs.run_off[:n + 1], run_off)
    assert torch.equal(runs.pair_s[:pair_s.shape[0]], pair_s)
    assert runs.run_tgt.dtype == runs.run_off.dtype == torch.int32


BAD_LISTS = {
    # key 3 in runs 0 and 2
    "twice": ([3, 3, 5, 3, 0, 0], pp.RUN_TWICE, "two separate runs"),
    "target": ([3, 3, 16, 0], pp.RUN_TARGETS, "out of range"),
    "negative": ([3, -2, 0], pp.RUN_TARGETS, "out of range"),
    "source": ([3, 3, 5, 0], pp.RUN_SOURCES, "out of range"),
    "gap": ([3, 0, 5, 0], pp.RUN_GAP, "pad step"),
}


@pytest.mark.parametrize("case", list(BAD_LISTS))
def test_capped_runs_error_codes(case):
    """Each failed check sets its bit and zeroes the run count (the failed
    list launches no work); RunChecks raises the eager wrappers' text."""
    keys, bit, text = BAD_LISTS[case]
    gt = torch.tensor(keys)
    gs = torch.ones((len(keys), 4), dtype=torch.int64)
    gs[gt == 0] = 0
    if case == "source":
        gs[1, 2] = 9
    runs = pp.capped_runs(gt, gs, 16, 9)
    assert int(runs.bad) == bit and runs.n_runs.tolist() == [0]
    checks = pp.RunChecks()
    checks.add("onbody_exec_grav3d", 16, 9, runs.bad)
    with pytest.raises(ValueError, match=text):
        checks.raise_for(checks.word(gt.device).tolist())


@pytest.mark.parametrize("corrupt,text", [("target", "out of range"),
                                          ("twice", "two separate runs")])
def test_fused_raises_eager_texts(monkeypatch, corrupt, text):
    """A list corrupted inside the route (a target key out of range, or a
    key in two runs) makes solve_dtt_fused raise the eager wrappers'
    ValueError after the solve, not fail inside it."""
    kernel, _, srcs, targs = _problem("grav3d", 800)
    cfg = SolverConfig(**SLICE_KW)
    nn = treecode.prepare(kernel, cfg, srcs, targs).tgt_geo.shape[0]

    def corrupted(pl, cap, group, slot_width):
        pg = lists.group_pairs(pl, cap, group, slot_width)
        t = pg.tgt.clone()
        if corrupt == "target":
            t[0] = nn
        else:
            # the step after the first change of key goes back to key 0's
            j = int(torch.nonzero(t != t[0])[0])
            t[j + 1] = t[0]
        return pg._replace(tgt=t)
    monkeypatch.setattr(pexec, "group_pairs", corrupted)
    with pytest.raises(ValueError, match=text):
        dtt.solve_dtt_fused(kernel, cfg, srcs, targs)


@pytest.mark.parametrize("name,kw", [
    ("grav3d", {}), ("vort2d", dict(order=-1)),
    ("grav3d", dict(pair_fetch="pregather")), ("vort2d", STATIC)])
def test_fused_route_never_waits(monkeypatch, name, kw):
    """Outside the kernels' twins (which stand in for CUDA kernels on the
    CPU) the fused route reaches no op that reads the device back, at a
    dma-family fetch, pregather and static; the same guard catches the
    split path's waits (exec._trim's count)."""
    kernel, _, srcs, targs = _problem(name, 900)
    cfg = SolverConfig(**dict(SLICE_KW, **kw))
    guard = SyncGuard()
    for twin in ("exec_pairs_torch", "exec_pairs_torch_t2",
                 "exec_pairs_pre_torch", "exec_pairs_pre_torch_t2"):
        monkeypatch.setattr(pp, twin, exempt(guard, getattr(pp, twin)))
    with guard:
        dtt.fused_eager(kernel, cfg, srcs, targs)
    assert guard.hits == []
    with guard:
        dtt.solve_dtt(kernel, cfg, treecode.prepare(kernel, cfg, srcs,
                                                    targs))
    assert "aten._local_scalar_dense" in guard.hits
