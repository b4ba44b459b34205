"""Attribute per-step cost inside the pair executor K10 (port of
scripts/exp_kernel.py).

Runs K13 (`cuda_pairs.exec_ablate`: K10's schedule, one CTA per run
fetching its source blocks by bulk asynchronous copies, on the grav3d
body ablated to a mode) on the reference script's synthetic list and
prints the time of each mode, so the per-step budget of K10 splits into
fetch (`dma`), distances (`d2` - `dma`), the rest of the arithmetic
(`norsqrt` - `d2`) and the rsqrt (`full` - `norsqrt`).

Usage: python -m onbody_tpu_torch.scripts.exp_kernel [bs] [group]

Where it differs from the script, on purpose:
- every mode is a sum over a run's steps (csrc/grav3d_ablate_body.cuh).
  The script's `dma` and `d2` overwrite the output with `prev + ...` on
  every step (exp_kernel.py:65-77): they are stubs that time a body, not
  sums, and the port's kernel and twin need one exact meaning;
- row 3 is read as sr and squared, as the script reads it (:78-80); the
  production grav3d rows store sr^2 there (ops/kernels.py featurize), so
  `full` is Grav3d's arithmetic on other rows, not K10's function;
- the list is the script's (:130-138), stable-sorted by target before
  the run: at the default size its target ids wrap (`% (nn - 1)`), so
  target 2 comes back at the end in a second run. The TPU kernel's
  second visit adds onto the row its first visit wrote back through the
  aliased `prev`; on the card two runs of one target would be two CTAs
  racing on one row, which the run table refuses (cuda_pairs._run_table).
  Sorted, each target is one run and the kernel computes the same sum in
  another fp32 order;
- the data come from a torch.Generator seeded 0 (the script draws
  tgt_geo, src_fm and the ids from one JAX key), so the numbers differ;
- a failing mode raises instead of printing FAILED and going on.
It runs on the CUDA device and raises without one; the tests run
`run_modes` on the CPU at a small size.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import torch

from onbody_tpu_torch.ops import cuda_pairs
from onbody_tpu_torch.utils.device import resolve

# the script's sizes: target/source rows and steps (:131-132)
NN, STEPS = 16384, 65536
MODES = ("dma", "d2", "norsqrt", "full")
SEED = 0


def make_list(nn: int, p: int, group: int, gen: torch.Generator):
    """The script's list (:136-138): ~4 steps per target row, target ids
    wrapping modulo nn - 1, `group` uniform source ids in [1, nn) per
    step. Returns (gt (p,), gs (p, group)) int64 on the generator's
    device, in the script's order."""
    dev = gen.device
    gt = (torch.arange(1, p // 4 + 1, device=dev) % (nn - 1) + 1)
    gt = gt.repeat_interleave(4)[:p]
    gs = torch.randint(1, nn, (p, group), generator=gen, device=dev)
    return gt, gs


def sort_by_target(gt, gs):
    """The steps stable-sorted by target row: each target one run."""
    order = torch.sort(gt, stable=True).indices
    return gt[order], gs[order]


def make_problem(bs: int, group: int, device, nn: int = NN,
                 p: int = STEPS, seed: int = SEED):
    """(tgt_geo, src_fm, gt, gs): (nn, 8, bs) uniform [0, 1) target and
    source rows as the script draws them, and its list sorted by
    target."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tgt_geo = torch.rand((nn, 8, bs), generator=gen, device=device)
    src_fm = torch.rand((nn, 8, bs), generator=gen, device=device)
    gt, gs = sort_by_target(*make_list(nn, p, group, gen))
    return tgt_geo, src_fm, gt, gs


def run(mode: str, tgt_geo, src_fm, gt, gs):
    """One mode on a fresh zero accumulator (nn, 8, B)."""
    out = tgt_geo.new_zeros((tgt_geo.shape[0], 8, tgt_geo.shape[2]))
    return cuda_pairs.exec_ablate(mode, tgt_geo, src_fm, gt, gs, out)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_modes(problem, reps: int = 3, printer=print) -> Dict[str, float]:
    """Each mode once to warm up, then `reps` timed runs (wall clock
    around a synchronized run); prints the script's line per mode and
    returns {mode: fastest seconds}."""
    tgt_geo, _, gt, gs = problem
    dev = tgt_geo.device
    bs, group, p = tgt_geo.shape[2], gs.shape[1], gt.shape[0]
    best = {}
    for mode in MODES:
        run(mode, *problem)
        _sync(dev)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(mode, *problem)
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        best[mode] = t = min(ts)
        printer(f"bs={bs} g={group} {mode:>8}: {t:.4f}s "
                f"({t / p * 1e6:.2f}us/step)")
    return best


def main(argv=None) -> Dict[str, float]:
    argv = sys.argv[1:] if argv is None else argv
    bs = int(argv[0]) if len(argv) > 0 else 128
    group = int(argv[1]) if len(argv) > 1 else 16
    dev = resolve(None, "exp_kernel")
    return run_modes(make_problem(bs, group, dev),
                     printer=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
