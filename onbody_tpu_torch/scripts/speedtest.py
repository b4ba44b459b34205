"""Theta auto-tuner: time-vs-error Pareto sweep (port of
scripts/speedtest.py).

For each (N, target error, block size, order), bisect theta in
log-error space (speedtest.pl:53-96) until the measured rel-RMS is
within 3% of target, then time the solve and append a row to the
output file.

Usage: python -m onbody_tpu_torch.scripts.speedtest [-n=...] [-b=...]
       [-o=...] [--method=dtt] [--out=<path>]

It runs on the CUDA device and raises without one. Rows go to --out,
by default build/onbody_tpu_torch/speedtest.dat under the repository
root (a directory git ignores); the reference appends to new.dat in the
working directory, a file the repository tracks.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import cuda_lib
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import direct, dtt, treecode
from onbody_tpu_torch.utils.device import resolve

TARGET_ERRORS = [1e-2, 1e-3, 1e-4, 1e-5]
OUT = cuda_lib.BUILD_DIR / "speedtest.dat"
SOLVERS = {"dtt": dtt.solve_dtt,
           "treecode1": treecode.solve_treecode1,
           "treecode2": treecode.solve_treecode2,
           "treecode3": treecode.solve_treecode3}


def _sync(out):
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def measure(kernel, cfg, plan, solver, theta, ref, tskip):
    """Timed solve at one theta; on frontier/group overflow retries with
    doubled list widths (the API layer's recovery, api/solver.py) so a
    tight theta at a small block size yields a real error instead of a
    corrupted one. Returns (err, dt) or (None, dt) if 3 retries still
    overflow."""
    for _ in range(3):
        out, pl = solver(kernel, cfg, plan, theta=theta)
        _sync(out)
        t0 = time.perf_counter()
        out, pl = solver(kernel, cfg, plan, theta=theta)
        _sync(out)
        dt = time.perf_counter() - t0
        if int(pl.overflow) == 0:
            got = out[::tskip][:ref.shape[0]].cpu().numpy()
            err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
            return err, dt
        cfg = cfg.replace(frontier_width=2 * cfg.frontier_width,
                          cap_groups_dtt=2 * cfg.cap_groups_dtt)
    return None, dt


def bisect_theta(kernel, cfg, plan, solver, target, ref, tskip,
                 lo=0.8, hi=2.0, max_iter=12):
    """Secant bisection in (theta, log error) space (speedtest.pl:53-96).

    Error decreases with theta (tighter MAC). Endpoints that stay
    invalid (overflow after retries) pull the bracket inward; a
    non-monotone bracket (fp32 floor reached before hi) falls back to
    plain bisection steps. Returns (theta, err, seconds) of the last
    valid probe, or None when an endpoint never became valid."""
    e_lo, t_lo = measure(kernel, cfg, plan, solver, lo, ref, tskip)
    while e_lo is None and lo < hi - 0.05:
        lo += 0.1
        e_lo, t_lo = measure(kernel, cfg, plan, solver, lo, ref, tskip)
    e_hi, t_hi = measure(kernel, cfg, plan, solver, hi, ref, tskip)
    while e_hi is None and hi > lo + 0.05:
        hi -= 0.15
        e_hi, t_hi = measure(kernel, cfg, plan, solver, hi, ref, tskip)
    if e_lo is None or e_hi is None:
        return None
    best = None
    for _ in range(max_iter):
        # interpolate log-error linearly in theta
        le_lo, le_hi, le_t = np.log(e_lo), np.log(e_hi), np.log(target)
        if abs(le_hi - le_lo) < 1e-9 or le_hi >= le_lo:
            mid = 0.5 * (lo + hi)
        else:
            mid = lo + (hi - lo) * (le_t - le_lo) / (le_hi - le_lo)
            mid = min(max(mid, min(lo, hi)), max(lo, hi))
        e_mid, dt = measure(kernel, cfg, plan, solver, float(mid), ref,
                            tskip)
        if e_mid is None:
            hi = float(mid)          # overflow: tighten from above
            continue
        best = (float(mid), e_mid, dt)
        if abs(np.log(e_mid / target)) < np.log(1.03):
            break
        if e_mid > target:
            lo, e_lo = mid, e_mid
        else:
            hi, e_hi = mid, e_mid
        if hi - lo < 1e-3:
            break
    return best


def config(block: int, order: int) -> SolverConfig:
    """The reference script's configuration: span tree build, the '3x'
    MXU tier and the 'pallas' backend (the port computes in fp32 and
    runs its CUDA kernels for them, config.py), group 16, the lean plan
    at order >= 0, and a frontier sized for the tightest theta the
    bisection visits (near-neighbor count ~ 42 theta^3: theta 2.0 ->
    ~340 rows)."""
    return SolverConfig(block_size=block, order=order,
                        frontier_width=384, cap_groups_dtt=28,
                        tree_mode="span", mxu_precision="3x",
                        pair_backend="pallas", pair_group=16,
                        lean_plan=order >= 0)


def problem(kernel, n: int, device):
    """Sources and targets uniform in the cube (seed 12345), every
    tskip-th target's fp32 direct sum as the reference (as
    speedtest.pl greps the drivers' own fp32 direct results), tskip.
    Returns (srcs, targs, ref (numpy), tskip)."""
    gen = torch.Generator(device=device).manual_seed(12345)
    srcs = P.random_in_cube(gen, n, kernel.pd, kernel.sd, True)
    targs = P.random_in_cube(gen, n, kernel.pd, 0, False)
    tskip = max(1, int(float(n) * n / 2e9))
    sub = P.Parts(x=targs.x[::tskip].contiguous(),
                  r=targs.r[::tskip].contiguous(), s=None,
                  n_real=targs.x[::tskip].shape[0])
    ref = direct.direct(kernel, srcs, sub).cpu().numpy()
    return srcs, targs, ref, tskip


def write_rows(rows, out=OUT) -> None:
    """Append rows, tab-separated, to `out` (its directory made)."""
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = 100_000
    block = 128
    order = 4
    method = "dtt"
    out = OUT
    for a in argv:
        if a.startswith("-n="):
            n = int(float(a[3:]))
        elif a.startswith("-b="):
            block = int(a[3:])
        elif a.startswith("-o="):
            order = int(a[3:])
        elif a.startswith("--method="):
            method = a[9:]
        elif a.startswith("--out="):
            out = a[6:]

    dev = resolve(None, "speedtest")
    kernel = get_kernel("grav3d")
    cfg = config(block, order)
    solver = SOLVERS[method]
    # treecode1 is monopole-only: its error floor is ~1e-3-class and its
    # surface MAC runs at larger theta (reference default -t=2.0,
    # ongrav3d.cpp:477), so the bisection bracket shifts right
    bracket = dict(lo=1.0, hi=4.5) if method == "treecode1" else {}

    srcs, targs, ref, tskip = problem(kernel, n, dev)
    plan = treecode.prepare(kernel, cfg, srcs, targs)

    rows = []
    for target in TARGET_ERRORS:
        res = bisect_theta(kernel, cfg, plan, solver, target, ref, tskip,
                           **bracket)
        if res is None:
            continue
        theta, err, dt = res
        row = (n, block, order, method, target, theta, err, dt, n / dt)
        rows.append(row)
        print(f"N={n} b={block} o={order} {method}: target {target:.0e} "
              f"-> theta={theta:.4f} err={err:.3e} time={dt:.4f}s "
              f"({n / dt:.3e} parts/s)")
    write_rows(rows, out)
    return rows


if __name__ == "__main__":
    main()
