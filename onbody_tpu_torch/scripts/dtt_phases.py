"""Phases of the DTT evaluation over repeated runs on the card.

For each workload: one problem of n uniform sources and targets (the
seed and sampling of chip_smoke.py's DTT slices), `treecode.prepare` +
`dtt.solve_dtt` at tuned_config(n, workload) with the fetch given, run
once to warm up and then `reps` times under a synchronized PhaseTimer.
Prints every run's seconds per phase, then each phase's minimum and
median, and the executor launches of one run. A phase of a few
milliseconds spreads up to twofold between single runs on the card's
shared host, so compare two trees by these minima and medians, with
both trees run in one session.

Usage: python -m onbody_tpu_torch.scripts.dtt_phases [-n N] [--reps R]
       [--fetch pregather|dma_i|dma|dma_p|static] [--device D]
       [workload ...]

'pregather' also sets lean_plan, as tuned_config's row for the largest N
does. It runs on the CUDA device unless --device names another, and
raises without one.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import tuned_config
from onbody_tpu_torch.ops import cuda_pairs
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import dtt, treecode
from onbody_tpu_torch.utils.device import resolve
from onbody_tpu_torch.utils.timing import PhaseTimer

SEED = 12345
WORKLOADS = ("grav3d", "vort3d", "vortgrad3d", "vort2d")
FETCH = {"pregather": dict(pair_fetch="pregather", lean_plan=True),
         "dma_i": dict(pair_fetch="dma_i"), "dma": dict(pair_fetch="dma"),
         "dma_p": dict(pair_fetch="dma_p", list_compact="idsort"),
         "static": dict(pair_fetch="static")}


def phases(name: str, n: int, reps: int, fetch: str, dev) -> dict:
    """{phase: [seconds of each run]} of the DTT evaluation of `name`,
    and the executor launches of its last run."""
    kernel = get_kernel(name)
    cfg = tuned_config(n, name).replace(**FETCH[fetch])
    if dev.type != "cuda":  # the twins: tuned_config asks for the kernels
        cfg = cfg.replace(pair_backend="auto")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    srcs = P.random_in_cube(gen, n, kernel.pd, kernel.sd, True)
    targs = P.random_in_cube(gen, n, kernel.pd, 0, False)

    def run(timer=None):
        plan = treecode.prepare(kernel, cfg, srcs, targs, want_inv=False,
                                timer=timer)
        dtt.solve_dtt(kernel, cfg, plan, unscramble=False, timer=timer)

    run()
    PhaseTimer(dev).sync()
    runs = {}
    for _ in range(reps):
        cuda_pairs.LAUNCHES.clear()
        timer = PhaseTimer(dev)
        run(timer)
        for k, v in timer.phases.items():
            runs.setdefault(k, []).append(v)
    return runs, {k[0]: v for k, v in cuda_pairs.LAUNCHES.items() if v}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--fetch", default="pregather", choices=tuple(FETCH))
    ap.add_argument("--device", default=None)
    ap.add_argument("workloads", nargs="*", default=WORKLOADS)
    args = ap.parse_args(argv)
    dev = resolve(args.device, "dtt_phases")
    for name in args.workloads:
        runs, launches = phases(name, args.n, args.reps, args.fetch, dev)
        print(f"{name} {args.fetch} N={args.n}: launches {launches}")
        for k, v in runs.items():
            print(f"  {k}: min {min(v):.4f} median "
                  f"{statistics.median(v):.4f} s; runs "
                  + " ".join(f"{t:.4f}" for t in v), flush=True)


if __name__ == "__main__":
    main()
