"""The port's theta auto-tuner (scripts/speedtest.py) on the CPU: the
overflow retry of `measure`, the secant bisection of `bisect_theta` on a
grav3d problem of 4000 points, and where the rows go."""

import subprocess
import types

import numpy as np
import pytest
import torch

from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.scripts import speedtest
from onbody_tpu_torch.traverse import dtt, treecode

torch.set_num_threads(1)

N = 4000


@pytest.fixture(scope="module")
def problem():
    kernel = get_kernel("grav3d")
    srcs, targs, ref, tskip = speedtest.problem(kernel, N,
                                                torch.device("cpu"))
    # the script's configuration on the CPU twins (its 'pallas' backend
    # is the CUDA kernels), at block 64 / order 3 so that 4000 points
    # give a far field (the error spans 5e-2 to 4e-6 over the bracket)
    cfg = speedtest.config(64, 3).replace(pair_backend="auto")
    plan = treecode.prepare(kernel, cfg, srcs, targs)
    return kernel, cfg, plan, ref, tskip


def test_problem_and_config(problem):
    kernel, cfg, plan, ref, tskip = problem
    assert tskip == 1 and ref.shape == (N, 3)
    base = speedtest.config(128, 4)
    assert (base.pair_backend, base.mxu_precision, base.lean_plan,
            base.tree_mode, base.pair_group) == ("pallas", "3x", True,
                                                 "span", 16)
    assert not speedtest.config(64, -1).lean_plan


def test_measure_retries_overflow(problem):
    """A tiny frontier overflows; measure doubles it (up to three tries)
    and returns the error of the complete sum, or None when the lists
    still overflow after the third."""
    kernel, cfg, plan, ref, tskip = problem
    err, dt = speedtest.measure(kernel, cfg, plan, dtt.solve_dtt, 1.2,
                                ref, tskip)
    assert 0 < err < 1e-3 and dt > 0
    calls = []

    def solver(k, c, p, theta):
        calls.append(c.frontier_width)
        return dtt.solve_dtt(k, c, p, theta=theta)
    tight = cfg.replace(frontier_width=16, cap_groups_dtt=2)
    err2, _ = speedtest.measure(kernel, tight, plan, solver, 1.2, ref,
                                tskip)
    assert calls[::2] == [16, 32, 64]
    assert err2 == pytest.approx(err, rel=1e-6)
    calls.clear()

    def never_heals(k, c, p, theta):
        calls.append(c.frontier_width)
        return torch.zeros((N, 3)), types.SimpleNamespace(
            overflow=torch.tensor(1))
    err3, _ = speedtest.measure(kernel, tight, plan, never_heals, 1.2, ref,
                                tskip)
    assert calls[::2] == [16, 32, 64] and err3 is None


def test_bisect_theta_reaches_target(problem):
    kernel, cfg, plan, ref, tskip = problem
    res = speedtest.bisect_theta(kernel, cfg, plan, dtt.solve_dtt, 1e-4,
                                 ref, tskip)
    assert res is not None
    theta, err, dt = res
    assert 0.8 <= theta <= 2.0 and dt > 0
    assert abs(np.log(err / 1e-4)) < np.log(1.03)


def test_bisect_theta_none_when_endpoints_never_valid(problem):
    kernel, cfg, plan, ref, tskip = problem

    thetas = []

    def overflowing(k, c, p, theta):
        thetas.append(theta)
        return torch.zeros((N, 3)), types.SimpleNamespace(
            overflow=torch.tensor(1))
    assert speedtest.bisect_theta(kernel, cfg, plan, overflowing, 1e-4,
                                  ref, tskip) is None
    # lo walks up by 0.1 from 0.8 to 2.0 while it overflows, then hi is
    # tried once: 14 measures of three tries, two solves each
    assert thetas[0] == 0.8 and thetas[-1] == pytest.approx(2.0) \
        and len(thetas) == 6 * 14


def test_rows_go_to_the_ignored_build_directory(tmp_path):
    """The default output lies under build/, which git ignores (the
    reference appends to the tracked new.dat); --out names another."""
    root = speedtest.OUT.parents[2]
    rel = speedtest.OUT.relative_to(root)
    assert rel.parts[:2] == ("build", "onbody_tpu_torch")
    res = subprocess.run(["git", "check-ignore", "-q", str(rel)], cwd=root)
    assert res.returncode == 0
    out = tmp_path / "sub" / "rows.dat"
    speedtest.write_rows([(1, 2, "dtt"), (3, 4, "dtt")], out)
    speedtest.write_rows([(5, 6, "dtt")], out)
    assert out.read_text() == "1\t2\tdtt\n3\t4\tdtt\n5\t6\tdtt\n"


def test_main_without_a_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        speedtest.main(["-n=100"])
