"""K8/K9's split of long runs (ops/cuda_pairs.py): the planner that cuts
a chunk's runs into segments of at most S steps, the choice of S, the
plain twin of "segment partials, then the ordered reduction" against the
unsplit twins, and the chunked pregather front door on lists of long
runs (a treecode leaf's 27-77 steps) against the reference's
`_exec_chunk_pre` / `_exec_chunk_pre_t2` with Pallas in interpret mode.
The kernels themselves are held to these twins in
test_torch_csrc_host.py (g++) and test_torch_cuda.py (the card).

Tolerances (rel-RMS): split twin against the unsplit twin 1e-6, the
same fp32 sums in another order; port against the reference 1e-5 and
vortgrad3d's gradients 5e-5, as in test_torch_pregather.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_rms
from onbody_tpu.ops import kernels as JK
from onbody_tpu.ops import pallas_pairs as jpp
from onbody_tpu_torch.ops import cuda_pairs as tpp
from onbody_tpu_torch.ops import kernels as TK

torch.set_num_threads(1)

B, NN, G = 32, 16, jpp.GROUP
TOL, TOL_GRAD, TOL_SPLIT = 1e-5, 5e-5, 1e-6


def _runs_list(rng, keys, lo, hi, pad=0.3):
    """Runs of lo..hi steps for the given keys, a pad step after some of
    them and two at the tail."""
    gt = []
    for k in keys:
        gt += [k] * int(rng.integers(lo, hi + 1))
        if rng.random() < pad:
            gt.append(0)
    return np.array(gt + [0, 0], np.int64)


def _blocks(name, seed):
    """Block tables of compact clusters, targets on the sources (the
    d2 = 0 diagonal), inert row 0, lean source rows."""
    kernel = TK.KERNELS[name]
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-1, 1, (NN, 1, kernel.pd))
           + rng.uniform(-0.15, 0.15, (NN, B, kernel.pd))).astype(np.float32)
    rad = rng.uniform(0.03, 0.07, (NN, B)).astype(np.float32)
    s = (rng.normal(size=(NN, B, kernel.sd)) / B).astype(np.float32)
    rad[0], s[0], pos[0] = 1.0, 0.0, 0.0
    src_fm = TK.featurize(name, *(torch.from_numpy(a) for a in
                                  (pos, rad, s)), pad8=False).numpy()
    tgt_geo = np.array(jpp.build_tgt_geo(jnp.asarray(pos),
                                         jnp.asarray(rad)))
    return src_fm, tgt_geo


def _sources(rng, gt):
    """(P, G) source ids, inert slots at the end of some real steps."""
    gs = rng.integers(1, NN, (gt.shape[0], G))
    n_real = rng.integers(1, G + 1, gt.shape[0])
    gs = np.where(np.arange(G)[None, :] < n_real[:, None], gs, 0)
    gs[gt == 0] = 0
    return gs.astype(np.int64)


# ----------------------------------------------------------------- planner

def _check_plan(gt, seg_steps):
    steps, run_tgt, run_off = tpp._run_table(torch.from_numpy(gt))
    seg_run, seg_off, run_seg = tpp._plan_segments(run_off, seg_steps)
    for t in (seg_run, seg_off, run_seg):
        assert t.dtype == torch.int32 and t.is_contiguous()
    n_runs, n_seg = run_tgt.numel(), seg_run.numel()
    off, so = run_off.tolist(), seg_off.tolist()
    rs, sr = run_seg.tolist(), seg_run.tolist()
    assert len(so) == n_seg + 1 and len(rs) == n_runs + 1
    # the segments tile the real steps in order, each step exactly once
    assert so[0] == 0 and so[-1] == steps.numel()
    assert all(a < b for a, b in zip(so, so[1:]))
    s_max = max(np.diff(off), default=1) if seg_steps is None else seg_steps
    for s in range(n_seg):
        r = sr[s]
        assert rs[r] <= s < rs[r + 1]               # its run's range
        assert off[r] <= so[s] < so[s + 1] <= off[r + 1]
        assert so[s + 1] - so[s] <= s_max
    for r in range(n_runs):
        # a run's segments start at its first step and end at its last
        assert so[rs[r]] == off[r] and so[rs[r + 1]] == off[r + 1]
        whole = off[r + 1] - off[r] <= s_max
        assert (rs[r + 1] - rs[r] == 1) == whole    # single segment marked
    return n_runs, n_seg


@pytest.mark.parametrize("seg_steps", [1, 2, 3, 7, 40, None])
def test_planner_covers_every_step_once_inside_its_run(seg_steps):
    rng = np.random.default_rng(0)
    for lo, hi in ((1, 4), (27, 77)):
        for _ in range(4):
            keys = rng.permutation(np.arange(1, 40))[:rng.integers(1, 12)]
            n_runs, n_seg = _check_plan(_runs_list(rng, keys, lo, hi),
                                        seg_steps)
            if seg_steps is None:
                assert n_seg == n_runs


def test_planner_counts_and_edge_cases():
    gt = np.array([5, 5, 5, 5, 5, 0, 3, 0, 0, 8, 8], np.int64)
    _, _, run_off = tpp._run_table(torch.from_numpy(gt))
    seg_run, seg_off, run_seg = tpp._plan_segments(run_off, 2)
    assert seg_run.tolist() == [0, 0, 0, 1, 2]
    assert seg_off.tolist() == [0, 2, 4, 5, 6, 8]
    assert run_seg.tolist() == [0, 3, 4, 5]
    # an empty table plans no segment; S < 1 is refused
    _, _, empty = tpp._run_table(torch.zeros(4, dtype=torch.int64))
    seg_run, seg_off, run_seg = tpp._plan_segments(empty, 3)
    assert seg_run.numel() == 0 and seg_off.tolist() == [0]
    assert run_seg.tolist() == [0]
    with pytest.raises(ValueError, match=">= 1"):
        tpp._plan_segments(run_off, 0)


@pytest.mark.parametrize("lo,hi", [(1, 4), (27, 77), (1, 1)])
def test_static_plan_is_k8s_at_one_step(lo, hi):
    """K12's plan (plan_chunk "exec_static", as its wrapper makes it) is
    K8's at one step per segment: segment s is step s, each step's run
    and the runs' bounds in the steps, the same steps and slots, and the
    split runs are the runs of more than one step."""
    rng = np.random.default_rng(3)
    kernel = TK.KERNELS["grav3d"]
    for _ in range(4):
        keys = rng.permutation(np.arange(1, 40))[:rng.integers(1, 12)]
        gt = torch.from_numpy(_runs_list(rng, keys, lo, hi))
        if rng.random() < 0.5:
            gt[-1] = 45                 # a run of one step, the last one
        slots = torch.from_numpy(rng.integers(1, G + 1, gt.shape[0]))
        got = tpp.plan_chunk("exec_static", kernel, "rm", gt, slots)
        want = tpp.plan_chunk("exec_pre_seg", kernel, "rm", gt, slots, 1)
        steps, run_tgt, run_off = tpp._run_table(gt)
        n = steps.numel()
        lens = run_off[1:] - run_off[:-1]
        assert got.kind == "exec_static"
        assert got.seg_off.tolist() == list(range(n + 1))
        assert got.run_seg.tolist() == run_off.tolist()
        assert got.seg_run.tolist() == torch.repeat_interleave(
            torch.arange(run_tgt.numel()), lens).tolist()
        assert got.split_runs.tolist() == torch.nonzero(
            lens > 1).squeeze(1).tolist()
        for f in ("steps", "n_slots", "run_tgt", "seg_run", "seg_off",
                  "run_seg", "split_runs"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == torch.int32 and a.is_contiguous(), f
            assert torch.equal(a, b), f
        if hi == 1:
            assert got.split_runs.numel() == 0


@pytest.mark.parametrize("seg_steps", [1, 2, 3, 100])
def test_split_runs_are_the_cut_runs(seg_steps):
    """The plan's split runs, the only runs the reduction gets a CTA
    for, are the runs cut into more than one segment at seg_steps, in
    run order; every other run is one segment, added onto its row by
    the segment kernel."""
    rng = np.random.default_rng(5)
    keys = rng.permutation(np.arange(1, 40))[:14]
    gt = torch.from_numpy(_runs_list(rng, keys, 1, 9))
    plan = tpp.plan_chunk("exec_pre_seg", TK.KERNELS["vort3d"], "rm", gt,
                          None, seg_steps)
    _, _, run_off = tpp._run_table(gt)
    lens = (run_off[1:] - run_off[:-1]).tolist()
    n_segs = (plan.run_seg[1:] - plan.run_seg[:-1]).tolist()
    assert n_segs == [-(-n // seg_steps) for n in lens]
    assert plan.split_runs.tolist() == [r for r, n in enumerate(lens)
                                        if n > seg_steps]
    assert plan.split_runs.dtype == torch.int32
    if seg_steps == 100:
        assert plan.split_runs.numel() == 0


def test_seg_steps_fill_two_waves(monkeypatch):
    """S = steps // (2 waves x SMs x resident CTAs), at least 1: a chunk
    of long runs is cut into at least that many CTAs."""
    monkeypatch.setattr(tpp, "_resident_ctas", lambda *a: (8, 132))
    dev = torch.device("cpu")
    args = ("exec_pre_seg", "grav3d")
    assert tpp.seg_steps_for(*args, 8192, 128, 8, 8, dev) == 3
    assert tpp.seg_steps_for(*args, 2112, 128, 8, 8, dev) == 1
    assert tpp.seg_steps_for(*args, 10, 128, 8, 8, dev) == 1
    rng = np.random.default_rng(1)
    gt = _runs_list(rng, np.arange(1, 200), 27, 77, pad=0.0)
    s = tpp.seg_steps_for(*args, int((gt != 0).sum()), 128, 8, 8, dev)
    _, n_seg = _check_plan(gt, s)
    assert n_seg >= 2 * 132 * 8


# ------------------------------------------------------ split twin vs twin

def _gathered(name, seed, gt, gs):
    src_fm, tgt_geo = _blocks(name, seed)
    gathered = tpp._pregather(name, torch.from_numpy(src_fm),
                              torch.from_numpy(gs), B, pad8=False)
    return torch.from_numpy(tgt_geo), gathered


@pytest.mark.parametrize("runs", [(1, 4), (27, 77)], ids=["short", "long"])
@pytest.mark.parametrize("name", ["grav3d", "vort2d", "vortgrad3d"])
def test_split_twin_equals_unsplit_twin(name, runs):
    """Segment partials then the ordered reduction, at S = 1, 2 and
    unsplit (None), against exec_pairs_pre_torch(_t2) on the same chunk:
    within 1e-6 rel-RMS; K9's rows 0/1 untouched."""
    tk = TK.KERNELS[name]
    rng = np.random.default_rng(2)
    for paired in (False, True):
        keys = rng.permutation(np.arange(1, NN // 2 if paired else NN))[:5]
        gt = _runs_list(rng, keys, *runs)
        gs = _sources(rng, gt)
        tgt_geo, gathered = _gathered(name, 3, gt, gs)
        out0 = torch.zeros((NN, tpp.od8(tk), B))
        out0[1] = 7.25
        ref = out0.clone()
        gtt = torch.from_numpy(gt)
        if paired:
            tpp.exec_pairs_pre_torch_t2(tk, tgt_geo, gathered, gtt, ref,
                                        group=G)
        else:
            tpp.exec_pairs_pre_torch(tk, tgt_geo, gathered, gtt, ref,
                                     final=False, group=G)
        for seg_steps in (1, 2, None):
            got = tpp.exec_pairs_pre_split_torch(
                tk, tgt_geo, gathered, gtt, out0.clone(), seg_steps,
                group=G, paired=paired)
            assert rel_rms(got[2:].numpy(), ref[2:].numpy()) <= TOL_SPLIT
            assert (got[1] == 7.25).all() and not got[0].any()


def test_reduce_twin_sums_in_segment_order():
    """reduce_segments_torch adds each split run's partials onto its rows
    (parent keys: rows 2q, 2q+1) and leaves runs of one segment alone."""
    run_tgt = torch.tensor([2, 5, 7], dtype=torch.int32)
    run_seg = torch.tensor([0, 3, 4, 6], dtype=torch.int32)
    partials = torch.arange(6 * 2 * 1 * 2, dtype=torch.float32).view(
        6, 2, 1, 2)
    out = torch.zeros((16, 8, 2))
    tpp.reduce_segments_torch(out, partials, run_tgt, run_seg, paired=True)
    assert torch.equal(out[4, 0], partials[0:3, 0, 0].sum(0))
    assert torch.equal(out[5, 0], partials[0:3, 1, 0].sum(0))
    assert torch.equal(out[14, 0], partials[4:6, 0, 0].sum(0))
    assert not out[10:12].any() and not out[:, 1:].any()


# ------------------------------------------- long runs against the reference

def _check(name, got, ref):
    od = TK.KERNELS[name].od
    got, ref = np.asarray(got)[:, :od], np.asarray(ref)[:, :od]
    assert np.isfinite(got).all()
    assert rel_rms(got[:, :3], ref[:, :3]) <= TOL
    if od > 3:
        assert rel_rms(got[:, 3:], ref[:, 3:]) <= TOL_GRAD


@pytest.mark.parametrize("name", ["grav3d", "vortgrad3d"])
def test_long_runs_front_door_and_split_match_pallas(name, monkeypatch):
    """A list of runs of 27-77 steps (keys for K8, parent keys for K9)
    through the chunked front door, chunks of 32 steps so boundaries cut
    runs, and through the split twin at S = 2, against the reference's
    _exec_chunk_pre and _exec_chunk_pre_t2 on the whole list in
    interpret mode."""
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    rng = np.random.default_rng(4)
    src_fm, tgt_geo = _blocks(name, 5)
    od8 = tpp.od8(tk)
    monkeypatch.setattr(tpp, "pregather_chunk", lambda g, c, b: 32)
    for paired, keys in ((False, [3, 9]), (True, [2, 6])):
        gt = _runs_list(rng, keys, 27, 77)
        gs = _sources(rng, gt)
        out0 = np.zeros((NN, od8, B), np.float32)
        out0[1] = 7.25
        jsrc = jpp._pregather(name, jnp.asarray(src_fm), jnp.asarray(gs),
                              B)
        fn = jpp._exec_chunk_pre_t2 if paired else jpp._exec_chunk_pre
        ref = np.asarray(fn(jk, jnp.asarray(tgt_geo), jsrc,
                            jnp.asarray(gt.astype(np.int32)),
                            jnp.asarray(out0), "rm", jnp.float32, True,
                            "outer", G))
        tg, fm = torch.from_numpy(tgt_geo), torch.from_numpy(src_fm)
        gtt, gst = torch.from_numpy(gt), torch.from_numpy(gs)
        door = torch.from_numpy(out0.copy())
        if paired:
            tpp.exec_pairs_t2(tk, tg, fm, gtt, gst, door, fetch="pregather")
        else:
            tpp.exec_pairs(tk, tg, fm, gtt, gst, fetch="pregather",
                           out_fm=door, final=False)
        split = tpp.exec_pairs_pre_split_torch(
            tk, tg, tpp._pregather(name, fm, gst, B, pad8=False), gtt,
            torch.from_numpy(out0.copy()), 2, group=G, paired=paired)
        for got in (door, split):
            _check(name, got[2:].numpy(), ref[2:])
            assert (got[1] == 7.25).all() and not got[0].any()
