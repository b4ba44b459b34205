"""Port vs reference: K13, the ablated executor of scripts/exp_kernel.py.

The script's `run` runs in Pallas interpret mode for the duration of a
test (pl.pallas_call patched with interpret=True; nothing in scripts/
changes) on numpy inputs drawn as the script draws its own (uniform
[0, 1) rows, ids >= 1), and the port's twins (cuda_pairs.exec_ablate on
CPU tensors) run on the same inputs. `full` and `norsqrt` are held to
the script's output; `dma` and `d2`, which the script computes as stubs
(prev + ... overwritten every step), to their definitions in numpy.

The script's list wraps its target ids (`% (nn - 1)`), so at its
default size target 2 comes back in a second run. In interpret mode
that second visit does not add onto the first: the aliased `prev` it
reads is the call's input, so the row ends as the last visit's sum.
The port sorts the list by target (one run per target) and sums every
visit; the wrapped case is held to that sum, and the interpret-mode
row to its last visit, so the difference stays documented.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from _torch_parity import rel_rms
from onbody_tpu_torch.ops import cuda_pairs
from onbody_tpu_torch.scripts import exp_kernel as tek

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, G = 16, 2


@pytest.fixture(scope="module")
def ref_script():
    spec = importlib.util.spec_from_file_location(
        "reference_exp_kernel", ROOT / "scripts" / "exp_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _problem(nn: int, p: int, seed: int, group: int = G, b: int = B):
    """The script's inputs at a small size, in numpy: rows uniform in
    [0, 1), its list (:136-138), source ids uniform in [1, nn)."""
    rng = np.random.default_rng(seed)
    tg = rng.uniform(0, 1, (nn, 8, b)).astype(np.float32)
    sf = rng.uniform(0, 1, (nn, 8, b)).astype(np.float32)
    gt = np.repeat(np.arange(1, p // 4 + 1) % (nn - 1) + 1, 4)[:p]
    gs = rng.integers(1, nn, (p, group))
    return tg, sf, gt.astype(np.int32), gs.astype(np.int32)


def _ref_run(ref_script, mode, tg, sf, gt, gs):
    import jax.numpy as jnp
    return np.asarray(ref_script.run(mode, jnp.asarray(tg), jnp.asarray(sf),
                                     jnp.asarray(gt), jnp.asarray(gs),
                                     gs.shape[1], 3))


def _twin(mode, tg, sf, gt, gs):
    t = (torch.from_numpy(tg), torch.from_numpy(sf))
    gt_s, gs_s = tek.sort_by_target(torch.from_numpy(gt).long(),
                                    torch.from_numpy(gs).long())
    return cuda_pairs.exec_ablate(mode, *t, gt_s, gs_s).numpy()


@pytest.mark.parametrize("mode", ["full", "norsqrt"])
def test_twin_matches_script_run(ref_script, interpret, mode):
    """nn 64, 48 steps, B 16, G 2: no target wraps, every row one run."""
    tg, sf, gt, gs = _problem(64, 48, seed=1)
    assert len(np.unique(gt)) == 12
    ref = _ref_run(ref_script, mode, tg, sf, gt, gs)
    got = _twin(mode, tg, sf, gt, gs)
    assert np.abs(ref[:, 3:]).max() == 0.0
    assert rel_rms(got[:, :3], ref[:, :3]) <= 1e-5
    np.testing.assert_array_equal(got[:, 3:], 0.0)


@pytest.mark.parametrize("mode", ["full", "norsqrt"])
def test_wrapped_list_revisit(ref_script, interpret, mode):
    """nn 8: the ids wrap, targets 2-6 come back in a second run. The
    port's merged runs give every visit's sum; the interpret-mode row is
    its last visit's sum (the revisit does not accumulate there)."""
    tg, sf, gt, gs = _problem(8, 48, seed=2)
    again = [t for t in np.unique(gt)
             if np.count_nonzero(np.diff(np.flatnonzero(gt == t)) > 1)]
    assert again == [2, 3, 4, 5, 6]
    got = _twin(mode, tg, sf, gt, gs)
    # every visit: the twin on the unsorted list adds each step in turn
    every = cuda_pairs.exec_ablate_torch(
        mode, torch.from_numpy(tg), torch.from_numpy(sf),
        torch.from_numpy(gt).long(), torch.from_numpy(gs).long()).numpy()
    assert rel_rms(got, every) <= 1e-6
    ref = _ref_run(ref_script, mode, tg, sf, gt, gs)
    # the last visit of each target alone
    last = np.zeros_like(gt, dtype=bool)
    for t in np.unique(gt):
        idx = np.flatnonzero(gt == t)
        start = idx[np.flatnonzero(np.diff(idx) > 1)[-1] + 1] if t in again \
            else idx[0]
        last[idx[idx >= start]] = True
    keep = np.where(last, gt, 0)
    last_sum = cuda_pairs.exec_ablate_torch(
        mode, torch.from_numpy(tg), torch.from_numpy(sf),
        torch.from_numpy(keep).long(), torch.from_numpy(gs).long()).numpy()
    assert rel_rms(last_sum[:, :3], ref[:, :3]) <= 1e-5
    assert rel_rms(got[again, :3], ref[again, :3]) > 0.1


def test_dma_and_d2_twins_against_numpy():
    tg, sf, gt, gs = _problem(32, 40, seed=3, group=3)
    gs[5, 1] = 0                         # an inert slot: no copy, no term
    dma = _twin("dma", tg, sf, gt, gs)
    d2 = _twin("d2", tg, sf, gt, gs)
    want_dma = np.zeros((32, 8, B))
    want_d2 = np.zeros((32, 8, B))
    for t, ids in zip(gt, gs):
        for s in ids[ids != 0]:
            want_dma[t, :3] += sf[s, :3]
            d = sf[s, None, :3, :] - tg[t, :3, :].T[:, :, None]
            want_d2[t, 0] += (d.astype(np.float64) ** 2).sum((1, 2))
    np.testing.assert_allclose(dma, want_dma, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d2, want_d2, rtol=1e-5)


def test_run_table_refuses_the_wrapped_list_unsorted():
    """The script's own default list: target 2 comes back in a second
    run at the end, which the run table refuses (two CTAs would race on
    its row); sorted by target it is one run per target."""
    gt, gs = tek.make_list(tek.NN, tek.STEPS, 16,
                           torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        gt.numpy(), np.repeat(np.arange(1, tek.STEPS // 4 + 1)
                              % (tek.NN - 1) + 1, 4))
    assert int(gs.min()) >= 1 and int(gs.max()) < tek.NN
    assert int(gt[0]) == 2 and int(gt[-1]) == 2
    with pytest.raises(ValueError, match="two separate runs"):
        cuda_pairs._run_table(gt)
    gt_s, gs_s = tek.sort_by_target(gt, gs)
    _, run_tgt, run_off = cuda_pairs._run_table(gt_s)
    assert run_tgt.numel() == tek.NN - 1
    assert int((run_off[1:] - run_off[:-1]).max()) == 8     # target 2
    assert torch.equal(torch.sort(gs_s[gt_s == 2], 0).values,
                       torch.sort(gs[gt == 2], 0).values)


def test_front_door_runs_on_cpu_when_asked():
    """exp_kernel's timing loop at a small size on the CPU: one line per
    mode in the script's format; without a CUDA device main raises."""
    lines = []
    problem = tek.make_problem(16, 2, torch.device("cpu"), nn=32, p=24)
    best = tek.run_modes(problem, reps=1, printer=lines.append)
    assert list(best) == list(tek.MODES)
    assert [ln.split(":")[0] for ln in lines] == [
        f"bs=16 g=2 {m:>8}" for m in tek.MODES]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tek.main([])


def test_unknown_mode_raises():
    tg, sf, gt, gs = (torch.from_numpy(a) for a in _problem(8, 8, seed=4))
    with pytest.raises(ValueError, match="K13 mode"):
        cuda_pairs.exec_ablate("rsqrt", tg, sf, gt.long(), gs.long())
