"""Shared benchmark-driver harness (port of onbody_tpu/drivers/common.py).

Mirrors the reference drivers' structure and report format
(ongrav3d.cpp:465-912): flag parsing (-n= -t= -t1..4= -o= -b= -h), the
five-stage toggle vector, per-phase timing with tree-time attribution,
best-of-k method timing, GFlop/s from kernel flop counts, sample-output
echo, and rel-RMS + max error against the direct sum.

Flags accept both '-t=1.4' and '-t 1.4'; the reference's -t1..-t4
off-by-one parse bug (ongrav3d.cpp:490-505 reads past the '=') is fixed
here, not reproduced.

The drivers run on the CUDA device and raise without one.
ONBODY_DRIVER_PLATFORM=cpu (the reference's switch) or run_driver's
`device` runs them elsewhere. Particles come from torch.Generators
seeded 12345 (sources, then targets) and 54321 (-radii), so the numbers
are the port's own, not the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import direct, dtt, treecode
from onbody_tpu_torch.utils.device import resolve
from onbody_tpu_torch.utils.timing import (PhaseTimer, block_real_counts,
                                           interaction_flops)


def _parse_flags(argv: List[str], progname: str, defaults: dict) -> dict:
    vals = dict(defaults)

    def usage():
        print(f"Usage: {progname} [-h] [-n=<nparticles>] [-t=<theta>] "
              f"[-t1..4=<theta>] [-o=<order>] [-b=<blocksize>] "
              f"[-i=<iterations>] [-g] [-charges=0|1] [-radii] "
              f"[-test=n,t1,t2,t3,f] [-justtrees]", file=sys.stderr)
        raise SystemExit(1)

    # value-taking flags accept both '-t=1.4' and '-t 1.4' (the latter
    # consumes the next argv entry); bare flags take neither
    valued = {"-n": ("n", lambda v: int(float(v))),
              "-t1": ("theta1", float), "-t2": ("theta2", float),
              "-t3": ("theta3", float), "-t4": ("theta4", float),
              "-o": ("order", int), "-b": ("block_size", int),
              "-i": ("iters", int),
              # stage toggles {naive, tree1, tree2, tree3, fast} — the
              # reference's test_iterations fixture (ongrav3d.cpp:470)
              "-test": ("test_iterations",
                        lambda v: tuple(int(x) for x in v.split(","))),
              # abs-mass gravity vs signed charges (ongrav3d.cpp:468,
              # :585-590; in-source there, a real flag here)
              "-charges": ("use_charges", lambda v: bool(int(v)))}
    args = list(argv)
    i = 0
    while i < len(args):
        a = args[i]
        i += 1
        if a == "-g":
            # galaxy initial condition: central star + disk of orbiters
            # (random_in_disk, ongrav3d.cpp:579-583)
            vals["galaxy"] = True
        elif a == "-radii":
            # r *= U(0.5, 1.5) (random_radii, ongrav3d.cpp:467,:596)
            vals["random_radii"] = True
        elif a == "-justtrees":
            # build trees/equivalents, skip all evaluation
            # (just_build_trees, ongrav3d.cpp:471,727)
            vals["just_build_trees"] = True
        elif a.startswith("-h") or a.startswith("--h"):
            usage()
        elif a == "-t" or a.startswith("-t="):
            v = a[3:] if a.startswith("-t=") else None
            if v is None:
                if i >= len(args):
                    usage()
                v, i = args[i], i + 1
            th = float(v)
            for k in ("theta1", "theta2", "theta3", "theta4"):
                vals[k] = th
        else:
            name, eq, v = a.partition("=")
            if name not in valued:
                usage()
            key, conv = valued[name]
            if not eq:
                if i >= len(args):
                    usage()
                v, i = args[i], i + 1
            try:
                vals[key] = conv(v)
            except ValueError:
                usage()
    return vals


def _widen(cfg: SolverConfig) -> SolverConfig:
    return cfg.replace(frontier_width=cfg.frontier_width * 4,
                       list_width=cfg.list_width * 4,
                       cap_groups_dtt=cfg.cap_groups_dtt * 4,
                       cap_groups_treecode=cfg.cap_groups_treecode * 4)


def run_driver(kernel_name: str, progname: str, argv: List[str],
               test_iterations=(1, 1, 1, 1, 1), use_charges: bool = True,
               defaults: Optional[dict] = None,
               cfg_overrides: Optional[dict] = None, device=None) -> None:
    """Run one driver: parse argv, build the problem on `device` (None:
    ONBODY_DRIVER_PLATFORM if set, else the CUDA device), time the
    prepare and every enabled stage, and print the reference's report."""
    if device is None:
        device = os.environ.get("ONBODY_DRIVER_PLATFORM") or None
    dev = resolve(device, progname)
    base = dict(n=10000, order=-1, block_size=128, iters=1,
                theta1=2.0, theta2=1.05, theta3=1.0, theta4=1.35,
                galaxy=False, test_iterations=test_iterations,
                just_build_trees=False, use_charges=use_charges,
                random_radii=False)
    if defaults:
        base.update(defaults)
    vals = _parse_flags(argv, progname, base)
    test_iterations = vals["test_iterations"]
    use_charges = vals["use_charges"]

    kernel = get_kernel(kernel_name)
    n = vals["n"]
    cfg = SolverConfig(block_size=vals["block_size"], order=vals["order"],
                       theta_treecode1=vals["theta1"],
                       theta_pointwise=vals["theta2"],
                       theta_boxwise=vals["theta3"],
                       theta_dtt=vals["theta4"],
                       **(cfg_overrides or {}))

    echonum = 1
    withwhat = ("equivalent particles" if cfg.order < 0
                else "a barycentric grid")
    print(f"Running {progname} with {n} sources and {n} targets")
    print(f"  source block sizes {cfg.block_size}, target block size "
          f"{cfg.block_size}\n")

    # subsample the oracle so validation work stays bounded
    # (ntskip heuristic, ongrav3d.cpp:556-568)
    ntskip = max(1, int(float(n) * float(n) / 2e10))

    print("Allocate and initialize")
    timer = PhaseTimer(dev)
    gen = torch.Generator(device=dev).manual_seed(12345)
    with timer.phase("init parts time"):
        if vals["galaxy"]:
            srcs = P.random_in_disk(gen, n, kernel.pd, kernel.sd, True)
        else:
            srcs = P.random_in_cube(gen, n, kernel.pd, kernel.sd, True)
        if kernel_name == "grav3d" and not use_charges:
            srcs = dataclasses.replace(srcs, s=srcs.s.abs())
        if vals["random_radii"]:
            srcs = P.randomize_radii(
                torch.Generator(device=dev).manual_seed(54321), srcs)
        targs = P.random_in_cube(gen, n, kernel.pd, 0, False)
    timer.report()
    if kernel_name == "grav3d":
        kind = ("electrostatics simulation with random charges"
                if use_charges else "gravitational simulation")
        print(f"  {kind}")

    print("\nBuilding trees and equivalent particles")
    plan = timer.time("build trees+equivs", treecode.prepare,
                      kernel, cfg, srcs, targs)
    print(f"  source tree: {plan.stree.levels} levels, "
          f"{plan.stree.nleaf} leaves")
    timer.report()
    treetime = timer.total("build trees+equivs")

    if vals["just_build_trees"]:
        print("\nDone (just_build_trees).")
        return

    kflops = kernel.flops_fn(cfg.core_func)
    naive_ref = None

    if test_iterations[0]:
        print(f"\nRun the naive O(N^2) method (every {ntskip} particles)")
        t0 = time.perf_counter()
        naive_ref = direct.direct_oracle(kernel, srcs, targs,
                                         tskip=ntskip).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"[{progname} naive]:\t\t[{dt * ntskip:.4f}] seconds "
              f"(extrapolated)")
        gf = (n / ntskip) * n * kflops * 1e-9
        print(f"  GFlop: {gf * ntskip:.2f} and GFlop/s: {gf / dt:.3f}")
        for i in range(echonum):
            print(f"  particle {i * ntskip} vel "
                  + " ".join(f"{v:g}" for v in naive_ref[i]))

    methods = []
    if test_iterations[1]:
        methods.append(("treecode", treecode.solve_treecode1,
                        vals["theta1"]))
    if test_iterations[2]:
        methods.append(("treecode2", treecode.solve_treecode2,
                        vals["theta2"]))
    if test_iterations[3]:
        methods.append(("treecode3", treecode.solve_treecode3,
                        vals["theta3"]))
    if test_iterations[4]:
        methods.append(("fast", dtt.solve_dtt, vals["theta4"]))

    def timed(fn, c, theta):
        """(out, info, seconds) of one solve, synchronized."""
        timer.sync()
        t0 = time.perf_counter()
        out, info = fn(kernel, c, plan, theta=theta)
        timer.sync()
        return out, info, time.perf_counter() - t0

    for name, fn, theta in methods:
        label = {"treecode": "O(NlogN)", "treecode2": "O(NlogN)",
                 "treecode3": "O(NlogN) boxwise", "fast": "fast O(N)"}[name]
        print(f"\nRun the {name} {label} with {withwhat} and theta {theta}")
        best = 1e30
        out = info = None
        for _ in range(max(1, vals["iters"])):
            out, info, dt = timed(fn, cfg, theta)
            print(f"  this run time:\t\t[{dt:.4f}] seconds")
            best = min(best, dt)
        # two-phase count/fill recovery: never report a truncated sum
        # (mirrors the API layer, api/solver.py:_solve_boxwise)
        wide = cfg
        for _ in range(3):
            if int(info.overflow) == 0:
                break
            print(f"  interaction list overflow ({int(info.overflow)}) — "
                  f"retrying with 4x widths")
            wide = _widen(wide)
            out, info, best = timed(fn, wide, theta)
        assert int(info.overflow) == 0, "interaction lists kept overflowing"
        # honest GFlop/s: real interactions only (valid pairs x real
        # slots per block), comparable with the reference's
        # per-interaction counters (barneshut.hpp:131, ongrav3d.cpp:60),
        # not padded BxB tiles. treecode1's far-field monopole
        # evaluations are not in the executed pair list and are left
        # uncounted there (a slight undercount).
        cnt_s = block_real_counts(plan.stree.levels, cfg.block_size,
                                  n, cfg.order, kernel.pd,
                                  plan.src_fm.shape[0],
                                  plan.src_fm.shape[-1])
        cnt_t = block_real_counts(plan.ttree.levels, cfg.block_size,
                                  n, cfg.order, kernel.pd,
                                  plan.tgt_geo.shape[0],
                                  plan.tgt_geo.shape[-1])
        flops = interaction_flops(info, cnt_t, cnt_s, kflops)
        print(f"[{progname} {name}]:\t\t[{best:.4f}] seconds")
        print(f"  GFlop: {flops * 1e-9:.3f} and GFlop/s: "
              f"{flops * 1e-9 / best:.3f}")
        print(f"[{name} total]:\t\t[{treetime + best:.4f}] seconds")
        outv = out.cpu().numpy()
        for i in range(echonum):
            print(f"  particle {i * ntskip} vel "
                  + " ".join(f"{v:g}" for v in outv[i * ntskip]))

        if naive_ref is not None:
            sub = outv[::ntskip][:naive_ref.shape[0]].astype(np.float64)
            err = sub - naive_ref
            errsum = float((err ** 2).sum())
            errcnt = float((naive_ref ** 2).sum())
            maxerr = float((err ** 2).max())
            ntg = naive_ref.shape[0]
            print(f"error in {name} (max/rms):\t"
                  f"{np.sqrt(maxerr / (errcnt / ntg)):g} / "
                  f"{np.sqrt(errsum / errcnt):g}")

    print("\nDone.")
