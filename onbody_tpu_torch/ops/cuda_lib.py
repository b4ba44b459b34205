"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources in `csrc/` have a plain C interface. Each workload's
translation unit (`grav3d.cu`, `vort2d.cu`, `vort3d.cu`,
`vortgrad3d.cu`) instantiates, for each of its cores, the executor (K1,
K2, K8-K12; K8 and K9 each a segment kernel and an ordered reduction,
which K12 shares with K8 at one step per segment) and direct (K4, a
kernel and an ordered reduction of its source splits) templates
(`pairs.cuh`, `direct.cuh`) on its body, and the fp64 executor K1-f64
and direct sum K4-f64 (with its reduction; `fp64.cuh`) on the same body
in double (`body64.cuh`), and `grav3d.cu`
also K13, K10's template on the four ablated grav3d bodies
(`grav3d_ablate_body.cuh`); nvcc compiles
the units in parallel for sm_90a and links them into
`build/onbody_tpu_torch/libonbody_kernels.so` under the repository root
at first use, rebuilt when a hash of the sources and flags changes.
Nothing here runs at import time, so the module imports on machines
without nvcc or a GPU.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# one translation unit per workload
SOURCES = ("grav3d.cu", "vort2d.cu", "vort3d.cu", "vortgrad3d.cu")
HEADERS = ("core.cuh", "mufu.cuh", "body.cuh", "async_copy.cuh",
           "pairs.cuh", "direct.cuh", "entries.cuh", "body64.cuh",
           "fp64.cuh", "grav3d_body.cuh", "grav3d_ablate_body.cuh",
           "vort2d_body.cuh", "vort3d_body.cuh", "vortgrad3d_body.cuh")
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "onbody_tpu_torch")
LIB_NAME = "libonbody_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# core_func values with a CUDA body (core.cuh), by workload; grav3d has
# no core (its one instantiation is listed under "rm")
CUDA_CORES = {"grav3d": ("rm",), "vort2d": ("rm", "exp"),
              "vort3d": ("rm", "exp", "v2"), "vortgrad3d": ("rm", "exp")}
# (workload, core) of every compiled instantiation
INSTANCE_CORES = tuple((k, c) for k, cs in CUDA_CORES.items() for c in cs)
# K8 and K9 are each a segment kernel ("exec_pre_seg", "exec_pre_t2_seg")
# and the ordered reduction they share ("exec_pre_reduce"); K12
# ("exec_static") is K8's segment kernel at one step per segment and
# launches the same reduction; K4 is the
# direct kernel ("direct") and the ordered reduction of its source
# splits ("direct_reduce"); K1-f64 ("exec64") and K4-f64 ("direct64",
# "direct64_reduce") are the fp64 forms of K1 and K4
KINDS = ("exec", "exec_t2", "direct", "direct_reduce", "exec_pre_seg",
         "exec_pre_t2_seg", "exec_pre_reduce", "exec_dma", "exec_dmap",
         "exec_static", "exec64", "direct64", "direct64_reduce")
# the kinds that run on double rows and sums
F64_KINDS = ("exec64", "direct64", "direct64_reduce")
# kinds whose shared memory and residency `occupancy` reports, by the
# code the C entry point takes (K4's "direct" has an entry of its own)
OCCUPANCY_KINDS = {"exec_dma": 0, "exec_dmap": 1, "exec_static": 2,
                   "exec_pre_seg": 3, "exec_pre_t2_seg": 4, "exec": 5,
                   "exec_t2": 6, "exec64": 7, "direct64": 8}
# K13's modes: entry points onbody_exec_ablate_<mode> and
# onbody_occupancy_ablate_<mode>, grav3d only
ABLATE_MODES = ("dma", "d2", "norsqrt", "full")

_P = ctypes.c_void_p
_I = ctypes.c_int
# K1/K2/K10/K11: tgt_geo, src_fm, out, run_tgt, run_off, pair_s, the run
# count in device memory (None: n_runs), n_runs (the grid), B, C, G, od8,
# stream; K13 ("exec_ablate") the same without the device count; the
# segment kernels (K8, K9, K12) and the reduction likewise take their
# segment (split-run) count in device memory, None, before the grid
_ARGTYPES = {
    "exec": [_P] * 7 + [_I] * 5 + [_P],
    "exec_t2": [_P] * 7 + [_I] * 5 + [_P],
    "direct": [_P] * 3 + [_I] * 3 + [_P],
    "direct_reduce": [_P] * 2 + [_I] * 2 + [_P],
    "exec_pre_seg": [_P] * 11 + [_I] * 5 + [_P],
    "exec_pre_t2_seg": [_P] * 11 + [_I] * 5 + [_P],
    "exec_pre_reduce": [_P] * 6 + [_I] * 4 + [_P],
    "exec_dma": [_P] * 7 + [_I] * 5 + [_P],
    "exec_dmap": [_P] * 7 + [_I] * 5 + [_P],
    "exec_ablate": [_P] * 6 + [_I] * 5 + [_P],
    "exec_static": [_P] * 11 + [_I] * 5 + [_P],
    "exec64": [_P] * 7 + [_I] * 5 + [_P],
    "direct64": [_P] * 3 + [_I] * 3 + [_P],
    "direct64_reduce": [_P] * 2 + [_I] * 2 + [_P],
    "occupancy": [_I] * 4 + [_P],
    "direct_occupancy": [_P],
    "direct64_tile": [],
}


def instance(kernel_name: str, core: str) -> str:
    """The compiled instantiation of a (workload, core): 'grav3d' (the
    gravity body has no core) or '<workload>_<core>'. Raises for a core
    the workload has no CUDA body for."""
    if kernel_name == "grav3d":
        return "grav3d"
    if core not in CUDA_CORES[kernel_name]:
        raise ValueError(f"core_func {core!r}: the CUDA bodies of "
                         f"{kernel_name} take one of "
                         f"{CUDA_CORES[kernel_name]}")
    return f"{kernel_name}_{core}"


INSTANCES = tuple(instance(k, c) for k, c in INSTANCE_CORES)


def entry(kind: str, inst: str) -> str:
    """C entry point name of kernel `kind` for instantiation `inst`."""
    return f"onbody_{kind}_{inst}"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are compiled with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def build() -> str:
    """Compile the library unless an up-to-date one exists: one nvcc per
    translation unit, all started together, then one link. Returns
    nvcc's diagnostics (the ptxas register/spill report), or "" when the
    cached library was current."""
    digest = source_hash()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return ""
    nvcc = _nvcc()
    # build under private names and rename: concurrent builders never
    # load a half-written library
    tmp_dir = BUILD_DIR / f".obj.{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp_dir / (s[:-3] + ".o") for s in SOURCES]
        with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
            reports = list(pool.map(_run, [
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]))
        tmp = tmp_dir / LIB_NAME
        reports.append(_run([nvcc, "-shared", "-o", str(tmp),
                             *map(str, objs)]))
        os.replace(tmp, lib)
        tmp_stamp = tmp_dir / "stamp"
        tmp_stamp.write_text(digest)
        os.replace(tmp_stamp, stamp)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return "".join(reports)


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    build()
    so = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    for inst in INSTANCES:
        for kind in KINDS + ("occupancy", "direct_occupancy",
                             "direct64_tile"):
            fn = getattr(so, entry(kind, inst))
            fn.argtypes = _ARGTYPES[kind]
            fn.restype = ctypes.c_int
    for mode in ABLATE_MODES:
        fn = getattr(so, f"onbody_exec_ablate_{mode}")
        fn.argtypes = _ARGTYPES["exec_ablate"]
        fn.restype = ctypes.c_int
        fn = getattr(so, f"onbody_occupancy_ablate_{mode}")
        fn.argtypes = _ARGTYPES["occupancy"][1:]
        fn.restype = ctypes.c_int
    so.onbody_error_string.argtypes = [ctypes.c_int]
    so.onbody_error_string.restype = ctypes.c_char_p
    return so


def occupancy(kind: str, inst: str, b: int, c: int, g: int) -> dict:
    """Dynamic shared memory per CTA (bytes), resident CTAs per SM, ring
    stages, registers per thread and local (spill) bytes per thread of a
    K1/K2, K10/K11/K12, K8/K9 segment or K1-f64 launch at (B, C, G) (a
    kind of OCCUPANCY_KINDS; K4-f64's "direct64" takes none of them), or
    of a K4 launch (kind "direct"; B, C, G unused),
    from the CUDA occupancy calculator and the kernel's attributes. kind
    "ablate_<mode>" (inst "grav3d") reports K13's launch of that mode."""
    info = (ctypes.c_int * 5)()
    if kind.startswith("ablate_"):
        name = f"onbody_occupancy_{kind}"
        check(getattr(lib(), name)(b, c, g, ctypes.addressof(info)), name)
    elif kind == "direct":
        name = entry("direct_occupancy", inst)
        check(getattr(lib(), name)(ctypes.addressof(info)), name)
    else:
        check(getattr(lib(), entry("occupancy", inst))(
            OCCUPANCY_KINDS[kind], b, c, g, ctypes.addressof(info)),
            entry("occupancy", inst))
    return dict(smem=info[0], ctas_per_sm=info[1], stages=info[2],
                regs=info[3], local_bytes=info[4])


def check(rc: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        msg = lib().onbody_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """torch's current stream on `device`, as the pointer the C entry
    points take."""
    return torch.cuda.current_stream(device).cuda_stream
