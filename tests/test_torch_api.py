"""Port vs reference: the library API (api/solver.py) on the problems of
tests/test_api.py, the same numpy inputs through both packages, the
port on the CPU (device="cpu": the kernels' plain twins).

Tolerances: solver outputs within 5e-6 rel-RMS of the reference's (fp32
sums in another order; vortgrad3d gradients 5e-5, the reference's moment
form of that body), direct sums 2e-5 (test_torch_vortex.py's bound), and
the reference's own accuracy bounds against the direct sum
(tests/test_api.py: velocities 1e-3 in 2D, 2e-3 / gradients 2e-2 in 3D).
"""

import numpy as np
import pytest
import torch

from _torch_parity import rel_rms
from onbody_tpu.api import solver as jsolver
from onbody_tpu_torch.api import solver as tsolver
from onbody_tpu_torch.parts import from_arrays

torch.set_num_threads(1)


def _problem_2d(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    sx = rng.uniform(-1, 1, n).astype(np.float32)
    sy = rng.uniform(-1, 1, n).astype(np.float32)
    ss = (rng.uniform(-1, 1, n) / n).astype(np.float32)
    sr = np.full(n, (1.0 / n) ** 0.5, np.float32)
    return sx, sy, ss, sr


def _problem_3d(n=1200, seed=3):
    rng = np.random.default_rng(seed)
    sx, sy, sz = (rng.uniform(-1, 1, n).astype(np.float32)
                  for _ in range(3))
    ssx = (np.cos(0.7 * 10 * sx) / n).astype(np.float32)
    ssy = (np.cos(1.7 * 10 * sy) / n).astype(np.float32)
    ssz = (np.cos(2.7 * 10 * sz) / n).astype(np.float32)
    sr = np.full(n, (1.0 / n) ** (1 / 3), np.float32)
    return sx, sy, sz, ssx, ssy, ssz, sr


def _stack(cols):
    assert all(isinstance(c, np.ndarray) and c.dtype == np.float32
               for c in cols)
    return np.stack(cols, 1)


@pytest.mark.parametrize("alias", [True, False],
                         ids=["targets-alias-sources", "no-target-radii"])
def test_2dvort_matches_reference(alias):
    """vel_solver_2d / vel_direct_2d: targets aliasing the sources with
    target radii (self-pairs, d2 = 0), and separate targets without."""
    sx, sy, ss, sr = _problem_2d()
    if alias:
        targs = dict(tx=sx, ty=sy, tr=sr)
    else:
        rng = np.random.default_rng(7)
        targs = dict(tx=rng.uniform(-1, 1, 700).astype(np.float32),
                     ty=rng.uniform(-1, 1, 700).astype(np.float32))
    stats = {}
    got = _stack(tsolver.vel_solver_2d(sx, sy, ss, sr, **targs,
                                       device="cpu", stats=stats))
    ref = _stack(jsolver.vel_solver_2d(sx, sy, ss, sr, **targs))
    want = _stack(tsolver.vel_direct_2d(sx, sy, ss, sr, **targs,
                                        device="cpu"))
    jwant = _stack(jsolver.vel_direct_2d(sx, sy, ss, sr, **targs))
    assert np.isfinite(got).all() and stats["retries"] == 0
    assert rel_rms(got, ref) <= 5e-6
    assert rel_rms(want, jwant) <= 2e-5
    assert rel_rms(got, want) < 1e-3


def test_3dvortgrads_matches_reference():
    p = _problem_3d()
    t = p[:3]
    got = _stack(tsolver.vel_solver_3dvortgrads(*p, *t, device="cpu"))
    ref = _stack(jsolver.vel_solver_3dvortgrads(*p, *t))
    want = _stack(tsolver.vel_direct_3dvortgrads(*p, *t, device="cpu"))
    jwant = _stack(jsolver.vel_direct_3dvortgrads(*p, *t))
    assert got.shape == (1200, 12)
    assert rel_rms(got[:, :3], ref[:, :3]) <= 5e-6
    assert rel_rms(got[:, 3:], ref[:, 3:]) <= 5e-5
    assert rel_rms(want[:, :3], jwant[:, :3]) <= 2e-5
    assert rel_rms(want[:, 3:], jwant[:, 3:]) <= 5e-5
    assert rel_rms(got[:, :3], want[:, :3]) < 2e-3
    assert rel_rms(got[:, 3:], want[:, 3:]) < 2e-2


def test_api_takes_tensors_and_keyword_tuning():
    """Tensors go in like arrays; theta and order reach the solve."""
    sx, sy, ss, sr = _problem_2d(n=900, seed=5)
    ref = _stack(tsolver.vel_solver_2d(sx, sy, ss, sr, sx, sy, tr=sr,
                                       device="cpu"))
    cols = [torch.from_numpy(a) for a in (sx, sy, ss, sr)]
    got = _stack(tsolver.vel_solver_2d(*cols, cols[0], cols[1], tr=cols[3],
                                       device="cpu"))
    np.testing.assert_array_equal(got, ref)
    want = _stack(tsolver.vel_direct_2d(sx, sy, ss, sr, sx, sy, tr=sr,
                                        device="cpu"))
    loose = _stack(tsolver.vel_solver_2d(sx, sy, ss, sr, sx, sy, tr=sr,
                                         theta=0.7, order=2, device="cpu"))
    assert rel_rms(loose, want) > 4 * rel_rms(ref, want)


def test_api_group_cap_overflow_recovers():
    """The mirror of the reference's test of that name: a group-cap
    overflow through the API path is healed by the retry, which widens
    cap_groups_* too, never an error or a truncated sum, and both
    packages agree. Block 32 in groups of 2 makes the port's grouped
    list outgrow its capacity (the reference's CPU path caps
    pairs, not groups, and heals on its own schedule)."""
    from onbody_tpu.api.solver import _CFG_2D as JCFG
    from onbody_tpu.api.solver import _solve_boxwise as jsolve
    from onbody_tpu.parts import from_arrays as jfrom

    sx, sy, ss, sr = _problem_2d(n=3000, seed=11)
    xy = np.stack([sx, sy], 1)
    kw = dict(block_size=32, pair_group=2, cap_groups_treecode=1)
    ref = jsolve("vort2d", JCFG.replace(**kw),
                 jfrom(xy, r=sr, s=ss), jfrom(xy, r=sr), theta=1.3)
    cfg = tsolver._CFG_2D.replace(**kw)
    t = torch.from_numpy
    stats = {}
    out = tsolver._solve_boxwise("vort2d", cfg,
                                 from_arrays(t(xy), r=t(sr), s=t(ss)),
                                 from_arrays(t(xy), r=t(sr)), theta=1.3,
                                 stats=stats).numpy()
    assert stats["retries"] >= 1
    assert stats["cfg"].cap_groups_treecode == 4 ** stats["retries"]
    assert stats["cfg"].list_width == 2048 * 4 ** stats["retries"]
    want = _stack(tsolver.vel_direct_2d(sx, sy, ss, sr, sx, sy, tr=sr,
                                        device="cpu"))
    assert rel_rms(out, want) < 1e-3
    assert rel_rms(out, np.asarray(ref)) <= 5e-6


def test_api_overflow_that_never_heals_raises(monkeypatch):
    """Never a truncated sum: when the lists still overflow after the
    last retry the solve raises."""
    sx, sy, ss, sr = _problem_2d(n=600, seed=2)
    monkeypatch.setattr(tsolver, "_RETRIES", 0)
    monkeypatch.setattr(tsolver, "_CFG_2D", tsolver._CFG_2D.replace(
        block_size=64, list_width=8))
    with pytest.raises(RuntimeError, match="overflowing"):
        tsolver.vel_solver_2d(sx, sy, ss, sr, sx, sy, tr=sr, device="cpu")


@pytest.mark.parametrize("fn", ["vel_solver_2d", "vel_direct_2d",
                                "vel_solver_3dvortgrads",
                                "vel_direct_3dvortgrads"])
def test_api_without_a_cuda_device_raises(fn, monkeypatch):
    """device=None means the CUDA device: without one every entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _problem_3d(50) if "3d" in fn else _problem_2d(50)
    targs = args[:3] if "3d" in fn else args[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tsolver, fn)(*args, *targs)


def test_api_configs_are_the_references():
    from onbody_tpu.api import solver as js
    for got, ref in ((tsolver._CFG_2D, js._CFG_2D),
                     (tsolver._CFG_3D, js._CFG_3D)):
        for f in ("block_size", "order", "theta_boxwise", "frontier_width",
                  "list_width", "cap_groups_treecode", "cap_groups_dtt",
                  "pair_group", "pair_fetch", "tree_mode", "lean_plan"):
            assert getattr(got, f) == getattr(ref, f), f
    assert tsolver._CFG_2D.pair_fetch == "pregather"
