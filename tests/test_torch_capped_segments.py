"""The segment plan of K8/K9/K12 made on the list's device
(cuda_pairs.capped_segments, the fused solve's 'pregather' and 'static'
route) against the eager plan made on the host (_run_table,
_plan_segments and the split runs of _seg_plan), integer for integer, on
gather chunks of random lists kept at their static capacity; its error
codes; S on the card (capped_seg_steps) against seg_steps_for; and a
dispatch guard that the plan never reads the device back."""

import pytest
import torch

from _torch_parity import SyncGuard
from onbody_tpu_torch.ops import cuda_pairs as pp

torch.set_num_threads(1)

NN_KEYS, NN_SRC, G = 400, 50, 8


def _list(seed: int, n_runs: int, max_len: int, pad: int):
    """A front-packed capped list: n_runs runs of distinct keys, each 1 to
    max_len steps long, then `pad` pad steps; source ids with id-0
    slots."""
    g = torch.Generator().manual_seed(seed)
    keys = torch.randperm(NN_KEYS - 1, generator=g)[:n_runs] + 1
    lens = torch.randint(1, max_len + 1, (n_runs,), generator=g)
    gt = torch.cat([torch.repeat_interleave(keys, lens),
                    torch.zeros(pad, dtype=torch.int64)])
    gs = torch.randint(1, NN_SRC, (gt.shape[0], G), generator=g)
    gs[torch.rand(gs.shape, generator=g) < 0.2] = 0
    gs[gt == 0] = 0
    return gt, gs


def _eager(gt_c, seg_steps: int):
    """The eager wrapper's plan of one chunk (_launch_pre): its run table
    on the host, segments of at most seg_steps steps, the split runs."""
    steps, run_tgt, run_off = pp._run_table(gt_c)
    seg_run, seg_off, run_seg = pp._plan_segments(run_off, seg_steps)
    split = torch.nonzero(run_seg[1:] - run_seg[:-1] > 1).squeeze(1)
    return steps, run_tgt, seg_run, seg_off, run_seg, split


# (seed, runs, longest run, pad steps, gather chunk, S): runs cut at chunk
# bounds (chunk 37) at S 1 and 3 and S a tensor; runs of one step at S 2
# (every run one segment, no split run); runs of up to 4 steps at S 4 (no
# split run); long runs at S 5 in one chunk
PLAN_CASES = {"cut-S1": (1, 40, 9, 30, 37, 1),
              "cut-S3": (2, 40, 9, 30, 37, 3),
              "cut-S2-tensor": (3, 40, 9, 30, 37, torch.tensor(2)),
              "single-steps": (4, 60, 1, 10, 37, 2),
              "no-split": (5, 30, 4, 20, 64, 4),
              "long-S5": (6, 6, 40, 50, 512, 5)}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_capped_segments_equal_eager_plan(case):
    """On every gather chunk of a capped list (pad chunks included):
    capped_runs + capped_segments give the eager plan's run keys, segment
    runs, segment bounds, run segments and split runs on their prefixes,
    and their counts in memory; the steps are the chunk's prefix."""
    seed, n_runs, max_len, pad, chunk, s = PLAN_CASES[case]
    gt, gs = _list(seed, n_runs, max_len, pad)
    cut = split_seen = 0
    for i in range(0, gt.shape[0], chunk):
        gt_c, gs_c = gt[i:i + chunk], gs[i:i + chunk]
        runs = pp.capped_runs(gt_c, gs_c, NN_KEYS, NN_SRC)
        segs = pp.capped_segments(runs, s)
        assert int(runs.bad) == 0
        steps, run_tgt, seg_run, seg_off, run_seg, split = _eager(
            gt_c, int(s))
        n_runs_c, n_seg = run_tgt.numel(), seg_run.numel()
        assert torch.equal(steps, torch.arange(steps.numel()))
        assert runs.n_runs.tolist() == [n_runs_c]
        assert segs.n_seg.tolist() == [n_seg]
        assert segs.n_split.tolist() == [split.numel()]
        assert torch.equal(runs.run_tgt[:n_runs_c], run_tgt)
        assert torch.equal(segs.seg_run[:n_seg], seg_run)
        assert torch.equal(segs.seg_off[:n_seg + 1], seg_off)
        assert torch.equal(segs.run_seg[:n_runs_c + 1], run_seg)
        assert torch.equal(segs.split_runs[:split.numel()],
                           split.to(torch.int32))
        cap = gt_c.shape[0]
        assert [t.shape[0] for t in segs[:4]] == [cap, cap + 1, cap + 2,
                                                  cap + 1]
        assert all(t.dtype == torch.int32 for t in segs)
        cut += int(i > 0 and gt_c[0] != 0 and gt_c[0] == gt[i - 1])
        split_seen += split.numel()
    if case.startswith("cut"):
        assert cut > 0
    assert (split_seen > 0) == (case not in ("single-steps", "no-split"))


@pytest.mark.parametrize("case", ["twice", "target", "gap"])
def test_capped_segments_of_failed_list_launch_nothing(case):
    """A chunk that fails capped_runs' checks (its run count 0) has no
    segment and no split run, whatever S."""
    gt, gs = _list(7, 12, 6, 8)
    if case == "twice":
        gt[gt == gt[-9]] = gt[0]
    elif case == "target":
        gt[3] = NN_KEYS
    else:
        gt[5] = 0
    runs = pp.capped_runs(gt, gs, NN_KEYS, NN_SRC)
    assert int(runs.bad) != 0 and runs.n_runs.tolist() == [0]
    for s in (1, 3):
        segs = pp.capped_segments(runs, s)
        assert segs.n_seg.tolist() == [0] and segs.n_split.tolist() == [0]


def test_capped_seg_steps_equal_seg_steps_for(monkeypatch):
    """S on the card from the chunk's real steps: seg_steps_for's value
    at the same occupancy, below one wave's worth of steps (S 1) and
    above it."""
    monkeypatch.setattr(pp, "_resident_ctas", lambda *a: (3, 4))
    for n_real, pad in ((5, 10), (24, 0), (50, 7), (97, 3)):
        gt = torch.cat([torch.arange(1, n_real + 1), torch.zeros(pad)])
        got = pp.capped_seg_steps("exec_pre_seg", "grav3d", gt.long(), 32,
                                  8, G)
        want = pp.seg_steps_for("exec_pre_seg", "grav3d", n_real, 32, 8, G,
                                torch.device("cpu"))
        assert int(got) == want


def test_capped_plan_never_waits():
    """capped_runs + capped_segments (S an int or a tensor) reach no op
    that reads the device back."""
    gt, gs = _list(8, 20, 7, 12)
    guard, s3 = SyncGuard(), torch.tensor(3)
    with guard:
        for s in (1, s3):
            pp.capped_segments(pp.capped_runs(gt, gs, NN_KEYS, NN_SRC), s)
    assert guard.hits == []
