"""Call the C ABI shim's six symbols as a host program does (the mirror
of the reference's run2dvort smoke driver, main2dvort.cpp).

    python -m onbody_tpu_torch.scripts.cabi_driver OUT_DIR [--lib PATH]
        [--n 100000] [--m M] [--n3 N3] [--seed 0] [--reps 2]

Builds the shim (api/cabi_lib.py; --lib names a built one instead),
dlopens it with ctypes and calls external_vel_{solver,direct}_f_ and
_tr_f_ on n 2D sources (targets: the sources, or m points of their own
with --m; radii for the _tr_ symbols) and external_vel_{solver,direct}_
3dvg_f_ on n3 vortgrad3d sources (targets the sources), each `reps`
times. Each symbol's last outputs go to OUT_DIR/<symbol>.npy (targets x
outputs, float32), and the last line printed is "CABI {json}": the
build and dlopen seconds and per symbol the returned flop estimate, each
call's seconds and the kernel launches of the last call
(ops/cuda_pairs.LAUNCHES, ops/cuda_direct.LAUNCHES; none on the CPU).
The bridge runs where ONBODY_CABI_DEVICE says (the card when unset).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import time

import numpy as np

from onbody_tpu_torch.api import cabi_lib
from onbody_tpu_torch.ops import cuda_direct, cuda_pairs

F32 = np.float32


def _problems(n: int, m, n3: int, seed: int):
    rng = np.random.default_rng(seed)
    x2 = [rng.uniform(-1, 1, n).astype(F32) for _ in range(2)]
    s2 = (rng.uniform(-1, 1, n) / n).astype(F32)
    r2 = np.full(n, (1.0 / n) ** 0.5, F32)
    if m is None:
        t2, tr = x2, r2
    else:
        t2 = [rng.uniform(-1, 1, m).astype(F32) for _ in range(2)]
        tr = np.full(m, (1.0 / m) ** 0.5, F32)
    x3 = [rng.uniform(-1, 1, n3).astype(F32) for _ in range(3)]
    w3 = [(np.cos(c * 10 * x) / n3).astype(F32)
          for c, x in zip((0.7, 1.7, 2.7), x3)]
    r3 = np.full(n3, (1.0 / n3) ** (1 / 3), F32)
    return x2, s2, r2, t2, tr, x3, w3, r3


def run(out_dir: str, lib_path=None, n: int = 100_000, m=None,
        n3: int = 100_000, seed: int = 0, reps: int = 2) -> dict:
    t0 = time.perf_counter()
    path = lib_path or cabi_lib.build()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    t_open = time.perf_counter() - t0
    x2, s2, r2, t2, tr, x3, w3, r3 = _problems(n, m, n3, seed)
    mt = len(t2[0])

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def cnt(k):
        return ctypes.byref(ctypes.c_int(k))

    ins = {"f": ([cnt(n), *map(ptr, x2), ptr(s2), ptr(r2), cnt(mt),
                  *map(ptr, t2)], mt, 2),
           "tr_f": ([cnt(n), *map(ptr, x2), ptr(s2), ptr(r2), cnt(mt),
                     *map(ptr, t2), ptr(tr)], mt, 2),
           "3dvg_f": ([cnt(n3), *map(ptr, x3 + w3), ptr(r3), cnt(n3),
                       *map(ptr, x3)], n3, 12)}
    res = {"build_s": t_build, "open_s": t_open, "calls": {}}
    for kind, (args, n_t, n_out) in ins.items():
        for role in ("solver", "direct"):
            sym = f"external_vel_{role}_{kind}_"
            fn = getattr(lib, sym)
            fn.restype = ctypes.c_float
            times = []
            for _ in range(reps):
                cols = [np.zeros(n_t, F32) for _ in range(n_out)]
                cuda_pairs.LAUNCHES.clear()
                cuda_direct.LAUNCHES.clear()
                t0 = time.perf_counter()
                flops = fn(*args, *map(ptr, cols))
                times.append(time.perf_counter() - t0)
            launches = {k[0]: v for k, v in
                        list(cuda_pairs.LAUNCHES.items())
                        + list(cuda_direct.LAUNCHES.items()) if v}
            np.save(os.path.join(out_dir, sym + ".npy"), np.stack(cols, 1))
            res["calls"][sym] = {"flops": float(flops), "times_s": times,
                                 "launches": launches}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--lib")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int)
    ap.add_argument("--n3", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    a = ap.parse_args(argv)
    res = run(a.out_dir, a.lib, a.n, a.m, a.n3, a.seed, a.reps)
    print("CABI " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
