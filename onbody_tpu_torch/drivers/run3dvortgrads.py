"""Library smoke/bench driver — equivalent of main3dvortgrads.cpp
(run3dvortgrads): random 3D problem with wave strengths, solver vs direct
validation on a subsample (main3dvortgrads.cpp:56-209).

Runs on the CUDA device and raises without one; ONBODY_DRIVER_PLATFORM
or `device` names another (as the CLI drivers).

Usage: python -m onbody_tpu_torch.drivers.run3dvortgrads [-n=<count>]
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
    sx, sy, sz = (rng.uniform(-1, 1, n).astype(f32) for _ in range(3))
    # wave strengths (Parts.hpp:171-177)
    ssx = (np.cos(0.7 * 10 * sx) / n).astype(f32)
    ssy = (np.cos(1.7 * 10 * sy) / n).astype(f32)
    ssz = (np.cos(2.7 * 10 * sz) / n).astype(f32)
    sr = np.full(n, (1.0 / n) ** (1.0 / 3.0), f32)

    print(f"Running run3dvortgrads with {n} vortices (targets == sources)")
    t0 = time.perf_counter()
    res = solver.vel_solver_3dvortgrads(sx, sy, sz, ssx, ssy, ssz, sr,
                                        sx, sy, sz, device=device)
    print(f"  solver time:\t\t[{time.perf_counter() - t0:.4f}] seconds")

    nsub = min(n, max(100, int(1e9 / max(n, 1))))
    t0 = time.perf_counter()
    ref = solver.vel_direct_3dvortgrads(sx, sy, sz, ssx, ssy, ssz, sr,
                                        sx[:nsub], sy[:nsub], sz[:nsub],
                                        device=device)
    print(f"  direct time ({nsub} targs):\t[{time.perf_counter() - t0:.4f}]"
          f" seconds")

    got = np.stack([c[:nsub] for c in res], 1)
    want = np.stack(ref, 1)
    relv = (np.linalg.norm(got[:, :3] - want[:, :3]) /
            np.linalg.norm(want[:, :3]))
    relg = (np.linalg.norm(got[:, 3:] - want[:, 3:]) /
            np.linalg.norm(want[:, 3:]))
    print(f"error in velocities (rms):\t{relv:g}")
    print(f"error in gradients (rms):\t{relg:g}")
    assert relv < 2e-3, relv
    print("Done.")


if __name__ == "__main__":
    main()
