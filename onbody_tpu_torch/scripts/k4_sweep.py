"""K4-f64's tile, swept on the card.

    python -m onbody_tpu_torch.scripts.k4_sweep [INSTANCE ...] [--reps 7]

Builds `csrc/fp64.cuh`'s `direct64_kernel` with every (workload, core)
body in double (or the instances named, e.g. `vortgrad3d_exp`) at every
tile of VARIANTS: 128 and 256 threads a CTA, one and two targets a
thread, 256 and 512 sources a chunk; and times each at the accuracy
check's shape (4000 targets, every 250th of 1e6, against 1e6 sources for
grav3d; every 25th of 1e5 against 1e5 for the vortex bodies;
`chip_smoke.py`'s `accuracy_phase`) with the split count K4's planner
gives that tile (`cuda_direct.plan_splits` on the variant's resident CTAs
per SM), each variant's output within 1e-12 of the library's K4-f64
(`cuda_direct.direct_cuda` at float64) relative to its largest value:
the kernel's time (CUDA events, the median of `reps`, every variant once
and then in the reverse order, in turns), Gpairs/s, splits, CTAs,
resident CTAs per SM, registers and local bytes per thread, and nvcc's
spills; the library's own tile (`csrc/fp64.cuh` `Direct64Tile`) is
marked. Builds into `build/onbody_tpu_torch/k4_sweep/` (one nvcc per
workload, started together) and prints the card's name and power
limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import statistics
import subprocess
import sys

import torch

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.ops import cuda_direct, cuda_lib
from onbody_tpu_torch.ops.kernels import get_kernel

# K4-f64: (threads a CTA, targets a thread, sources a chunk)
VARIANTS = tuple((t, n, c) for t in (128, 256) for n in (1, 2)
                 for c in (256, 512))
# every (workload, core) instantiation's body in double
BODIES = {("grav3d", "rm"): "onbody::Grav3dF64",
          ("vort3d", "rm"): "onbody::Vort3dF64<onbody::CoreRmF64>",
          ("vort3d", "exp"): "onbody::Vort3dF64<onbody::CoreExpF64>",
          ("vort3d", "v2"): "onbody::Vort3dF64<onbody::CoreV2F64>",
          ("vortgrad3d", "rm"):
              "onbody::Vortgrad3dF64<onbody::CoreRmF64>",
          ("vortgrad3d", "exp"):
              "onbody::Vortgrad3dF64<onbody::CoreExpF64>",
          ("vort2d", "rm"): "onbody::Vort2dF64<onbody::CoreRmF64>",
          ("vort2d", "exp"): "onbody::Vort2dF64<onbody::CoreExpF64>"}
# (sources, target skip) of the accuracy check, by workload
SHAPES = {"grav3d": (1_000_000, 250), "vort3d": (100_000, 25),
          "vortgrad3d": (100_000, 25), "vort2d": (100_000, 25)}
SEED = 12345
MAX_REL = 1e-12
OUT_DIR = cuda_lib.BUILD_DIR / "k4_sweep"


def _sym(name: str, core: str, t: int, n: int, c: int) -> str:
    return f"{name}_{core}_{t}_{n}_{c}"


def _tile_source(name: str, insts) -> str:
    """One translation unit: every tile variant of a workload's bodies
    among `insts`, and each body's library tile (tile_<name>_<core>)."""
    lines = ['#include "entries.cuh"']
    for (w, core), body in BODIES.items():
        if w != name or (w, core) not in insts:
            continue
        lines.append(
            f"extern \"C\" int tile_{w}_{core}(int* tile) {{ "
            f"using T = onbody::Direct64Tile<{body}>; tile[0] = T::kThreads; "
            f"tile[1] = T::kTgts; tile[2] = T::kChunk; return 0; }}")
        for t, n, c in VARIANTS:
            sym = _sym(w, core, t, n, c)
            tile = f"onbody::Direct64TileOf<{t}, {n}, {c}>"
            lines.append(
                f"extern \"C\" int run_{sym}(const double* tgt, const "
                f"double* src, double* dst, int M, int S, int splits, void* "
                f"stream) {{ return onbody::launch_direct64<{body}, {tile}>("
                f"tgt, src, dst, M, S, splits, stream); }}")
            lines.append(
                f"extern \"C\" int occ_{sym}(int* info) {{ return "
                f"onbody::occupancy_of((const void*)onbody::direct64_kernel<"
                f"{body}, {tile}>, {t}, onbody::direct64_smem<{body}, "
                f"{tile}>(), onbody::kDirect64Stages, info); }}")
    return "\n".join(lines) + "\n"


def build(sources: dict, lib_name: str) -> ctypes.CDLL:
    """sources {unit name: text}: one nvcc per unit, started together, then
    one link; nvcc's registers and spills printed."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_lib._nvcc()
    cmds, objs = [], []
    for unit, text in sources.items():
        cu = OUT_DIR / f"{unit}.cu"
        cu.write_text(text)
        obj = OUT_DIR / f"{unit}.o"
        objs.append(str(obj))
        cmds.append([nvcc, *cuda_lib.NVCC_FLAGS, f"-I{cuda_lib.CSRC}", "-c",
                     "-o", str(obj), str(cu)])
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        reports = list(pool.map(cuda_lib._run, cmds))
    lib = OUT_DIR / lib_name
    cuda_lib._run([nvcc, "-shared", "-o", str(lib), *objs])
    func = None
    for line in "".join(reports).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        func = m.group(1) if m else func
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            print(f"  ptxas {func}: {m.group(1)} registers")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and func and any(int(v) for v in m.groups()):
            print(f"  ptxas {func}: stack {m.group(1)} B, spill stores "
                  f"{m.group(2)} B, loads {m.group(3)} B")
    return ctypes.CDLL(str(lib))


def _problem(dev, name: str):
    kernel = get_kernel(name)
    n, tskip = SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    srcs = P.random_in_cube(gen, n, kernel.pd, kernel.sd, True)
    targs = P.random_in_cube(gen, n, kernel.pd, 0, False)
    tx, tr = targs.x[::tskip].contiguous(), targs.r[::tskip].contiguous()
    if not kernel.uses_tr:
        tr = torch.zeros_like(tr)
    return kernel, (tx, tr, srcs.x, srcs.r, srcs.s)


def _ms(fn) -> float:
    """The CUDA-event time of one call."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def tile_part(dev, reps: int, insts) -> None:
    so = build({name: _tile_source(name, insts) for name in SHAPES
                if any(w == name for w, _ in insts)}, "libtile.so")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f64 = torch.float64
    for (name, core) in insts:
        kernel, a = _problem(dev, name)
        ref = cuda_direct.direct_cuda(kernel, *a, core, accum_dtype=f64)
        tgt, src = cuda_direct.layout(kernel, *(x.to(f64) for x in a))
        m, s = tgt.shape[1], src.shape[1]
        lib_tile = (ctypes.c_int * 3)()
        cuda_lib.check(getattr(so, f"tile_{name}_{core}")(lib_tile), "tile")
        runs = {}
        for t, n, c in VARIANTS:
            sym = _sym(name, core, t, n, c)
            occ = getattr(so, f"occ_{sym}")
            occ.argtypes = [ctypes.c_void_p]
            info = (ctypes.c_int * 5)()
            cuda_lib.check(occ(ctypes.addressof(info)), "occupancy")
            splits = cuda_direct.plan_splits(m, s, kernel.od, info[1], sms,
                                             itemsize=8, tile=n * t,
                                             chunk=c)
            dst = torch.empty((splits, m, kernel.od), dtype=f64, device=dev)
            out = torch.empty((m, kernel.od), dtype=f64, device=dev)
            fn = getattr(so, f"run_{sym}")
            fn.argtypes = cuda_lib._ARGTYPES["direct64"]

            def launch(fn=fn, dst=dst, splits=splits):
                cuda_lib.check(fn(tgt.data_ptr(), src.data_ptr(),
                                  dst.data_ptr(), m, s, splits,
                                  cuda_lib.stream_ptr(dev)), "direct64")
            launch()
            if splits > 1:
                cuda_direct.reduce_splits_cuda(kernel, core, out, dst)
            else:
                out = dst[0]
            torch.cuda.synchronize()
            rel = float((out - ref).abs().max() / ref.abs().max())
            if not rel <= MAX_REL:
                raise AssertionError(f"{name} {core} {t} x {n} x {c}: "
                                     f"max-rel {rel} against the library's "
                                     "K4-f64")
            runs[(t, n, c)] = dict(launch=launch, ms=[], splits=splits,
                                   ctas=-(-m // (n * t)) * splits,
                                   per_sm=info[1], smem=info[0],
                                   regs=info[3], local=info[4], rel=rel)
        order = list(runs)
        for _ in range(max(1, reps // 2 + 1)):
            for key in order + order[::-1]:
                runs[key]["ms"].append(_ms(runs[key]["launch"]))
        for (t, n, c), r in runs.items():
            ms = statistics.median(r["ms"])
            mark = " (the library's)" if (t, n, c) == tuple(lib_tile) else ""
            print(f"direct64[{name}_{core}] {m} x {s}, {t} threads x {n} "
                  f"targets x {c} sources{mark}: {ms:.4f} ms "
                  f"({m * s / ms / 1e6:.1f} Gpairs/s), "
                  f"{r['splits']} splits, {r['ctas']} CTAs "
                  f"({r['ctas'] / (sms * max(r['per_sm'], 1)):.2f} waves "
                  f"of {r['per_sm']} resident CTAs per SM), {r['smem']} B "
                  f"shared memory, {r['regs']} registers, {r['local']} "
                  f"local bytes; max-rel vs the library's {r['rel']:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("instances", nargs="*", metavar="INSTANCE",
                    help="workload_core, e.g. vortgrad3d_exp (default: all)")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    names = {f"{w}_{c}": (w, c) for w, c in BODIES}
    if set(args.instances) - set(names):
        ap.error(f"instances are {sorted(names)}, not {args.instances}")
    insts = [names[i] for i in args.instances] or list(BODIES)
    if not torch.cuda.is_available():
        print("k4_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    tile_part(dev, args.reps, insts)
    print(f"card: {card.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
