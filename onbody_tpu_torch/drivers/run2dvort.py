"""Library smoke/bench driver — equivalent of main2dvort.cpp (run2dvort):
build a random 2D problem with targets == sources, call the solver API
(target-radii variant), validate against the direct API on a subsample,
report rel-RMS and max error (main2dvort.cpp:52-158).

Runs on the CUDA device and raises without one; ONBODY_DRIVER_PLATFORM
or `device` names another (as the CLI drivers).

Usage: python -m onbody_tpu_torch.drivers.run2dvort [-n=<count>]
"""

import os
import sys
import time

import numpy as np

from onbody_tpu_torch.api import solver


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if device is None:
        device = os.environ.get("ONBODY_DRIVER_PLATFORM") or None
    n = 10000
    for a in argv:
        if a.startswith("-n="):
            n = int(float(a[3:]))

    rng = np.random.default_rng(12345)
    f32 = np.float32
    sx = rng.uniform(-1, 1, n).astype(f32)
    sy = rng.uniform(-1, 1, n).astype(f32)
    ss = (rng.uniform(-1, 1, n) / n).astype(f32)
    sr = np.full(n, (1.0 / n) ** 0.5, f32)

    print(f"Running run2dvort with {n} vortices (targets == sources)")
    t0 = time.perf_counter()
    tu, tv = solver.vel_solver_2d(sx, sy, ss, sr, sx, sy, tr=sr,
                                  device=device)
    print(f"  solver time:\t\t[{time.perf_counter() - t0:.4f}] seconds")

    nsub = min(n, max(100, int(2e9 / max(n, 1))))
    t0 = time.perf_counter()
    du, dv = solver.vel_direct_2d(sx, sy, ss, sr, sx[:nsub], sy[:nsub],
                                  tr=sr[:nsub], device=device)
    print(f"  direct time ({nsub} targs):\t[{time.perf_counter() - t0:.4f}]"
          f" seconds")

    got = np.stack([tu[:nsub], tv[:nsub]], 1)
    want = np.stack([du, dv], 1)
    err = got - want
    rel = np.linalg.norm(err) / np.linalg.norm(want)
    mx = np.abs(err).max() / np.abs(want).max()
    print(f"error in solver (max/rms):\t{mx:g} / {rel:g}")
    assert rel < 1e-3, rel
    print("Done.")


if __name__ == "__main__":
    main()
