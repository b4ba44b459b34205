"""Stratified big-N runs (traverse/bigN.solve_dtt_stratified).

Usage: python -m onbody_tpu_torch.scripts.bign [N] [split] [slab_cache]
           [theta] [n_val] [exec_groups] [coarse_depth] [--seed S]
           [--device D]

N 1e8 at split 4 checks the machinery and the chunk and cache behaviour;
N 1e9 at split 6 is the reference's last published row (grav3d). Prints
the profile lines and then one JSON line of the stats and info. Runs on
the CUDA device unless --device names another (--device cpu runs the
kernels' twins), and raises without one.
"""

from __future__ import annotations

import argparse
import json

from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import bigN


def config(split: int, theta: float = 1.15) -> SolverConfig:
    """The 1e8-tier settings with the pregather fetch (lean slabs);
    frontier 256 at split >= 6, where 128 and 192 overflowed below the 64
    stratum roots at 1e9, 128 below."""
    return SolverConfig(block_size=256, order=5, theta_dtt=theta,
                        frontier_width=256 if split >= 6 else 128,
                        list_width=320, cap_groups_dtt=16, pair_group=16,
                        pair_fetch="pregather", mxu_precision="3xt",
                        tree_mode="span", tree_defer_rs=True, tree_fuse=2,
                        list_compact="sort")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=float, default=1e8)
    ap.add_argument("split", nargs="?", type=int, default=4)
    ap.add_argument("slab_cache", nargs="?", type=int, default=8)
    ap.add_argument("theta", nargs="?", type=float, default=1.15)
    ap.add_argument("n_val", nargs="?", type=int, default=256)
    ap.add_argument("exec_groups", nargs="?", type=int, default=4096)
    ap.add_argument("coarse_depth", nargs="?", type=int, default=8)
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    stats, info = bigN.solve_dtt_stratified(
        get_kernel("grav3d"), config(a.split, a.theta), int(a.n), a.seed,
        split=a.split, slab_cache=a.slab_cache, n_val=a.n_val,
        profile=True, exec_groups=a.exec_groups,
        coarse_depth=a.coarse_depth, device=a.device)
    row = {**stats, **info}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
