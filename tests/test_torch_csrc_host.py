"""The CUDA kernel sources (onbody_tpu_torch/ops/csrc) compiled for the
host and held against their plain twins on the CPU.

g++ builds the four translation units with CUDA's few keywords stubbed
out and each launch run block by block on one thread: a block of `t`
threads becomes `t` blocks of one thread, so the staging loops stage the
whole block and the barriers are no-ops. That exercises the kernels' own
indexing, staging, run tables, masking of ragged edges, output layouts
and body arithmetic (rsqrtf as 1/sqrtf) without a GPU; the card itself
is tested in test_torch_cuda.py. Skips where there is no g++.

K10 and K11 fetch their blocks with bulk asynchronous copies and
mbarriers, and K8/K9's segment kernel and K4 with cp.async, inline PTX
that g++ cannot build; all of it lives in csrc/async_copy.cuh, and this
test swaps that one header for a synchronous host version (HOST_ASYNC:
the bulk copy is a memcpy that completes its barrier's phase at once,
the wait checks that the phase it waits for has completed; a cp.async
is a plain store). So for K4 and K8-K11 the emulation checks the indexing,
the slot walk, the ring's stage and phase bookkeeping and the order of
the sums, not asynchrony.

Limits: there is no concurrency inside a block, so nothing here tests
the barriers, shared-memory races, the copies' asynchrony or any
warp-level code (shuffles, multi-thread reductions); and the rewrite
finds the dynamic shared buffers and the `<<<...>>>` launches by regex,
so it depends on how the sources spell them. Once a kernel gains
warp-level code, this emulation no longer means anything for it: drop
it then rather than grow the stubs.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onbody_tpu.ops import core_funcs as JC
from onbody_tpu.ops import kernels as JK
from onbody_tpu.ops import pallas_pairs as jpp
from onbody_tpu_torch.ops import cuda_direct, cuda_lib, cuda_pairs
from onbody_tpu_torch.ops.kernels import featurize, get_kernel

torch.set_num_threads(1)

# instantiations as (workload, core)
INSTANCES = list(cuda_lib.INSTANCE_CORES)
IDS = [f"{k}-{c}" for k, c in INSTANCES]
REL_RMS, MAX_REL = 1e-5, 1e-4           # chip_smoke.py's kernel limits

HOST_STUB = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#define __global__
#define __device__
#define __host__
#define __align__(x)
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0), blockDim(1, 1, 1),
    gridDim(1, 1, 1);
struct float4 {
  float x, y, z, w;
};
struct double2 {
  double x, y;
};
alignas(16) static float host_dyn_smem[1 << 16];
inline void __syncthreads() {}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline double rsqrt(double x) { return 1.0 / sqrt(x); }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "host"; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*,
                                                         int, size_t) {
  *n = 1;
  return 0;
}
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes;
};
inline int cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return 0;
}
template <class... A> struct HostLaunch {
  void (*k)(A...);
  unsigned gx, gy;
  void operator()(A... a) const {
    gridDim = dim3(gx, gy, 1);
    for (unsigned y = 0; y < gy; ++y)
      for (unsigned x = 0; x < gx; ++x) {
        blockIdx = dim3(x, y, 0);
        k(a...);
      }
  }
};
// executors: a 2D grid, thread blocks along y
template <class... A> HostLaunch<A...> host_launch(void (*k)(A...), dim3 g,
                                                   int t) {
  return HostLaunch<A...>{k, g.x, g.y * (unsigned)t};
}
// direct: a 1D grid
template <class... A> HostLaunch<A...> host_launch(void (*k)(A...), int g,
                                                   int t) {
  return HostLaunch<A...>{k, (unsigned)(g * t), 1u};
}
// csrc/mufu.cuh's one-MUFU operations and K1-f64's double rsqrt and
// reciprocal (the file is swapped for an empty header): exact division
// and square root, the twins' arithmetic
namespace onbody {
inline float rcp_approx(float x) { return 1.0f / x; }
inline float rsqrt_approx(float x) { return 1.0f / sqrtf(x); }
inline float sqrt_approx(float x) { return sqrtf(x); }
inline double rsqrt_f64(double x) { return 1.0 / sqrt(x); }
inline double rcp_f64(double x) { return 1.0 / x; }
}  // namespace onbody
"""

# csrc/async_copy.cuh on the host: each barrier counts its completed
# phases; a copy completes at once; a wait for a phase that has not
# completed would hang on the card, so it aborts here
HOST_ASYNC = r"""
#pragma once
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
namespace onbody {
inline void mbar_init(uint64_t* bar, uint32_t) { *bar = 0; }
inline void expect_copy(uint64_t*, uint32_t) {}
inline void fence_before_copy() {}
inline void bulk_copy(float* dst, const float* src, uint32_t bytes,
                      uint64_t* bar) {
  if (bytes % 16) abort();
  memcpy(dst, src, bytes);
  ++*bar;
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  if ((*bar & 1u) == parity) abort();
}
inline void copy4_async(float* dst, const float* src) { *dst = *src; }
inline void copy8_async(double* dst, const double* src) { *dst = *src; }
template <int kBytes> inline void copy_bytes_async(void* dst, const void* src) {
  memcpy(dst, src, kBytes);
}
inline void copy_commit() {}
template <int kPending> inline void copy_wait() {}
}  // namespace onbody
"""
# K11's planner, exported for the test
HOST_EXPORTS = r"""
// the split reduction's staged pass alone (no streaming pass) with 4 KB
// a CTA, so that a few splits take several passes
extern "C" int host_split_reduce_staged_float(float* out, const float* p,
                                              int n, int splits) {
  return onbody::launch_split_reduce<float, 1, 1 << 30, 4096>(
      out, p, n, splits, nullptr);
}
extern "C" int host_split_reduce_staged_double(double* out, const double* p,
                                               int n, int splits) {
  return onbody::launch_split_reduce<double, 1, 1 << 30, 4096>(
      out, p, n, splits, nullptr);
}
extern "C" int host_copy_blocks(const int* ids, int j, int g) {
  return onbody::copy_blocks(ids, j, g);
}
// the exp core (csrc/core.cuh CoreExp) on n points: which 0, c3(a = d^2,
// aux3(b = sr)); 1, c3g (r3 into out, bbb into out2); 2, c2(a = dx, b =
// dy, c = sr^2, d = tr^2)
extern "C" void host_core_exp(int which, int n, const float* a,
                              const float* b, const float* c,
                              const float* d, float* out, float* out2) {
  using onbody::CoreExp;
  for (int i = 0; i < n; ++i) {
    if (which == 0) out[i] = CoreExp::c3(a[i], CoreExp::aux3(b[i]));
    if (which == 1) CoreExp::c3g(a[i], CoreExp::aux3(b[i]), out[i], out2[i]);
    if (which == 2) out[i] = CoreExp::c2(a[i], b[i], c[i], d[i]);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the host")
    d = tmp_path_factory.mktemp("csrc_host")
    for f in cuda_lib.SOURCES + cuda_lib.HEADERS:
        text = (cuda_lib.CSRC / f).read_text()
        if f == "async_copy.cuh":
            text = HOST_ASYNC
        elif f == "mufu.cuh":
            text = "#pragma once\n"
        text = re.sub(r"extern __shared__ (__align__\(\d+\) )?float "
                      r"(\w+)\[\];", r"float* \2 = host_dyn_smem;", text)
        text = re.sub(r"(\w+<[^<>;]*>)<<<([^,]+), ([^,]+), [^>]*>>>\(",
                      r"host_launch(\1, \2, \3)(", text)
        (d / f).write_text(text)
    (d / "cuda_runtime.h").write_text("#pragma once\n")
    (d / "host_stub.h").write_text(HOST_STUB)
    (d / "all.cpp").write_text("".join(f'#include "{s}"\n'
                                       for s in cuda_lib.SOURCES)
                               + HOST_EXPORTS)
    lib = d / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
                    f"-I{d}", "-include", "host_stub.h", "-o", str(lib),
                    str(d / "all.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _entry(lib, kind, name, core):
    fn = getattr(lib, cuda_lib.entry(kind, cuda_lib.instance(name, core)))
    fn.argtypes = cuda_lib._ARGTYPES[kind]
    fn.restype = ctypes.c_int
    return fn


def _errors(got, ref):
    got, ref = got.double(), ref.double()
    return (float((got - ref).norm() / ref.norm()),
            float((got - ref).abs().max() / ref.abs().max()))


def _blocks(kernel, b=32, nn=16, seed=0):
    """Source and target tables from the same points (the d2 = 0 leaf
    diagonal included), varied radii, inert row 0."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((nn, b, kernel.pd), generator=g)
    rad = 0.03 + 0.04 * torch.rand((nn, b), generator=g)
    s = torch.randn((nn, b, kernel.sd), generator=g) / b
    pos[0], rad[0], s[0] = 0.0, 1.0, 0.0
    return (featurize(kernel.name, pos, rad, s).contiguous(),
            cuda_pairs.build_tgt_geo(pos, rad).contiguous())


def _groups(gt_list, nn=16, group=8, seed=1):
    g = torch.Generator().manual_seed(seed)
    gt = torch.tensor(gt_list)
    gs = torch.randint(1, nn, (len(gt_list), group), generator=g)
    gs[:, -2:] = torch.where(torch.rand((len(gt_list), 2), generator=g)
                             < 0.5, 0, gs[:, -2:])   # some pad slots
    gs[gt == 0] = 0
    gs[0, 0] = gt_list[0]               # a block against itself
    return gt, gs


def _run_exec(lib, kind, kernel, core, tgt_geo, src_fm, gt, gs, out):
    """K1/K2/K10/K11 on the wrapper's trimmed run table (no device
    count)."""
    run_tgt, run_off, pair_s = cuda_pairs._runs(gt, gs)
    _, c, b = src_fm.shape
    return _entry(lib, kind, kernel.name, core)(
        tgt_geo.data_ptr(), src_fm.data_ptr(), out.data_ptr(),
        run_tgt.data_ptr(), run_off.data_ptr(), pair_s.data_ptr(), None,
        run_tgt.numel(), b, c, pair_s.shape[1], out.shape[1], None)


def _run_capped(lib, kind, kernel, core, tgt_geo, src_fm, gt, gs, out):
    """K1/K2/K10/K11 as the fused solve launches them: the list at its
    capacity, the run table from capped_runs, the count read by the
    kernel, one CTA per step slot."""
    nn_keys = tgt_geo.shape[0] // (2 if kind == "exec_t2" else 1)
    runs = cuda_pairs.capped_runs(gt, gs, nn_keys, src_fm.shape[0])
    assert int(runs.bad) == 0
    _, c, b = src_fm.shape
    return _entry(lib, kind, kernel.name, core)(
        tgt_geo.data_ptr(), src_fm.data_ptr(), out.data_ptr(),
        runs.run_tgt.data_ptr(), runs.run_off.data_ptr(),
        runs.pair_s.data_ptr(), runs.n_runs.data_ptr(), gt.shape[0], b, c,
        gs.shape[1], out.shape[1], None)


# the ragged case of K1/K2: an odd block width above 512, so a row takes
# two CTAs in K1 (289 threads of two points) and three in K2 (577 threads
# of one point on two rows), the last one partly idle; pad steps between
# and after the runs, and id-0 slots inside steps as well as at their end
RAGGED_B = 577


def _ragged_groups(gt_list, seed, group=8):
    gt, gs = _groups(gt_list, seed=seed, group=group)
    gs[1, 1] = 0
    gs[3, 0:2] = 0
    gs[gt == 0] = 0
    return gt, gs


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k1_matches_twin(host_lib, name, core):
    """K1 at B 32 and at the ragged B 577 (two CTAs per row): its twin's
    sums within the kernel limits, rows without a run untouched."""
    kernel = get_kernel(name)
    for b, seed, gt_list, group in (
            (32, 0, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0], 8),
            (RAGGED_B, 30, [3, 0, 5, 5, 9, 0], 4)):
        src_fm, tgt_geo = _blocks(kernel, b=b, seed=seed)
        gt, gs = _ragged_groups(gt_list, seed + 1, group)
        out = torch.zeros((16, cuda_pairs.od8(kernel), b))
        assert _run_exec(host_lib, "exec", kernel, core, tgt_geo, src_fm,
                         gt, gs, out) == 0
        twin = cuda_pairs.exec_pairs_torch(kernel, tgt_geo, src_fm, gt, gs,
                                           final=False, core=core)
        assert torch.isfinite(out).all()
        rms, mx = _errors(out, twin)
        assert rms <= REL_RMS and mx <= MAX_REL, b
        # rows without a run stay untouched
        assert not out[torch.tensor([r for r in range(16)
                                     if r not in gt_list])].any()


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k2_matches_twin_and_keeps_root(host_lib, name, core):
    """K2 at B 32 and at the ragged B 577 (three CTAs per row pair): its
    twin's sums within the kernel limits, rows 0/1 (the root) and rows
    without a run untouched."""
    kernel = get_kernel(name)
    for b, seed, gt_list, group in ((32, 2, [1, 1, 2, 0, 3, 5, 0, 7], 8),
                                    (RAGGED_B, 32, [2, 0, 3, 3, 7, 0], 4)):
        src_fm, tgt_geo = _blocks(kernel, b=b, seed=seed)
        gt, gs = _ragged_groups(gt_list, seed + 1, group)
        out = torch.zeros((16, cuda_pairs.od8(kernel), b))
        out[1] = 7.25
        twin = out.clone()
        assert _run_exec(host_lib, "exec_t2", kernel, core, tgt_geo, src_fm,
                         gt, gs, out) == 0
        cuda_pairs.exec_pairs_torch_t2(kernel, tgt_geo, src_fm, gt, gs, twin,
                                       core=core)
        rms, mx = _errors(out[2:], twin[2:])
        assert rms <= REL_RMS and mx <= MAX_REL, b
        assert (out[1] == 7.25).all() and not out[0].any()
        keys = {2 * k + r for k in gt_list if k for r in (0, 1)}
        assert not out[torch.tensor([r for r in range(2, 16)
                                     if r not in keys])].any()


# the reference's pad lists (tests/test_pallas.py:192-193), parent keys
# below 8 of the 16 rows so that they serve K2 too
REF_PAD_LISTS = ([1, 1, 2, 3, 3, 0, 0, 0], [1, 1, 0, 2, 2, 0, 3, 0])
# K1/K2 against the reference: rel-RMS 5e-5, the bound the other executor
# parity tests (test_torch_pregather.py, test_torch_fetch.py) hold the
# reference's fp32 moment forms to, and a scaled max of 1e-4. Those forms
# are what differs: on these blocks the reference sits up to 1.3e-5
# (rel-RMS) from the float64 twin, the kernels within 3e-7 of it, held
# here to 1e-6 (F64_TOL)
REF_RMS, F64_TOL = 5e-5, 1e-6


@pytest.mark.parametrize("name", ["grav3d", "vortgrad3d"])
def test_host_k1_k2_match_reference_interpret(host_lib, name):
    """Host-built K1 and K2 (rm) against the JAX package's dma_i
    executors, _exec_chunk with _body_interleaved and _exec_chunk_t2
    with _body_interleaved_t2, in Pallas interpret mode, and against
    their twins in float64, on the reference's pad lists with id-0 slots
    inside and at the end of the steps, B 32, G 4, the same numpy inputs
    on both sides (the compact clusters of test_torch_pregather.py)."""
    jk, kernel = JK.KERNELS[name], get_kernel(name)
    b, nn, group = 32, 16, 4
    rng = np.random.default_rng(40)
    pos = (rng.uniform(-1, 1, (nn, 1, kernel.pd))
           + rng.uniform(-0.15, 0.15, (nn, b, kernel.pd))).astype(np.float32)
    rad = rng.uniform(0.03, 0.07, (nn, b)).astype(np.float32)
    s = (rng.normal(size=(nn, b, kernel.sd)) / b).astype(np.float32)
    pos[0], rad[0], s[0] = 0.0, 1.0, 0.0
    src_fm = featurize(name, torch.from_numpy(pos), torch.from_numpy(rad),
                       torch.from_numpy(s)).contiguous()
    tgt_geo = cuda_pairs.build_tgt_geo(torch.from_numpy(pos),
                                       torch.from_numpy(rad)).contiguous()
    tgt_j, src_j = jnp.asarray(tgt_geo.numpy()), jnp.asarray(src_fm.numpy())
    od8 = cuda_pairs.od8(kernel)
    for gt_list in REF_PAD_LISTS:
        gt = np.array(gt_list, np.int32)
        gs = rng.integers(1, nn, (len(gt_list), group)).astype(np.int32)
        gs[0, 1] = gs[2, 0] = gs[4, 3] = 0
        gs[gt == 0] = 0
        gt_t = torch.from_numpy(gt.astype(np.int64))
        gs_t = torch.from_numpy(gs.astype(np.int64))
        zeros64 = torch.zeros((nn, od8, b), dtype=torch.float64)
        refs = {
            "exec": (jpp.exec_pairs_pallas(
                jk, tgt_j, src_j, jnp.asarray(gt), jnp.asarray(gs),
                interpret=True, fetch="dma_i", group=group, final=False),
                cuda_pairs.exec_pairs_torch(
                    kernel, tgt_geo.double(), src_fm.double(), gt_t, gs_t,
                    final=False)),
            "exec_t2": (jpp.exec_pairs_pallas_t2(
                jk, tgt_j, src_j, jnp.asarray(gt), jnp.asarray(gs),
                jnp.zeros((nn, od8, b), jnp.float32), interpret=True,
                fetch="dma_i", group=group),
                cuda_pairs.exec_pairs_torch_t2(
                    kernel, tgt_geo.double(), src_fm.double(), gt_t, gs_t,
                    zeros64))}
        for kind, (ref, f64) in refs.items():
            out = torch.zeros((nn, od8, b))
            assert _run_exec(host_lib, kind, kernel, "rm", tgt_geo, src_fm,
                             gt_t, gs_t, out) == 0
            rms, mx = _errors(out, torch.from_numpy(np.array(ref)))
            assert rms <= REF_RMS and mx <= MAX_REL, (kind, gt_list, rms)
            rms, mx = _errors(out, f64)
            assert rms <= F64_TOL and mx <= F64_TOL, (kind, gt_list, rms)
            if kind == "exec_t2":
                assert not out[:2].any()


# (M, S, forced splits): 301 targets (a partial CTA tile of 512, in which
# threads 45-255 have no second target) against 2500 sources (four full
# chunks of 512 and a short one, some sources on the targets themselves),
# in one launch and cut into 3 splits (1, 2 and 2 chunks) plus the
# reduction; then an odd M, 777 (the second tile's threads 9-255 have no
# second target), against 2561 sources (five full chunks and one of a
# single source), in one launch and in 3 splits of 2 chunks
K4_CASES = [(301, 2500, 1), (301, 2500, 3), (777, 2561, 1), (777, 2561, 3)]


@pytest.mark.parametrize("m,s,splits", K4_CASES,
                         ids=[f"{m}x{s}-{k}" for m, s, k in K4_CASES])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k4_matches_twin(host_lib, name, core, m, s, splits):
    """K4 as the wrapper runs it: one launch writing the output, or a
    launch writing one partial slab per split (each held against the twin
    on its split's sources; the scratch starts as NaN, so a value the
    kernel should have written and did not shows), then the ordered
    reduction; against the twin and the split path's twin."""
    kernel = get_kernel(name)
    g = torch.Generator().manual_seed(4)
    tx = torch.rand((m, kernel.pd), generator=g)
    tr = torch.full((m,), 0.03)
    sx = torch.cat([tx[:40], torch.rand((s - 40, kernel.pd), generator=g)])
    sr = 0.02 + 0.03 * torch.rand((s,), generator=g)
    ss = torch.randn((s, kernel.sd), generator=g) / s
    tgt, src = cuda_direct.layout(kernel, tx, tr, sx, sr, ss)
    out = torch.full((m, kernel.od), float("nan"))
    dst = out if splits == 1 else torch.full((splits, m, kernel.od),
                                             float("nan"))
    assert _entry(host_lib, "direct", name, core)(
        tgt.data_ptr(), src.data_ptr(), dst.data_ptr(), m, s, splits,
        None) == 0
    if splits > 1:
        bounds = cuda_direct.split_bounds(s, splits)
        for part, (lo, hi) in zip(dst, bounds):
            ref = cuda_direct.direct_torch(kernel, tx, tr, sx[lo:hi],
                                           sr[lo:hi], ss[lo:hi], core)
            rms, mx = _errors(part, ref)
            assert rms <= REL_RMS and mx <= MAX_REL, (lo, hi)
        assert _entry(host_lib, "direct_reduce", name, core)(
            out.data_ptr(), dst.data_ptr(), m, splits, None) == 0
        # the reduction adds the slabs in split order, as its twin does
        assert torch.equal(out, cuda_direct.reduce_splits_torch(dst))
    twin = cuda_direct.direct_torch(kernel, tx, tr, sx, sr, ss, core)
    split_twin = cuda_direct.direct_split_torch(kernel, tx, tr, sx, sr, ss,
                                                core, splits)
    for ref in (twin, split_twin):
        rms, mx = _errors(out, ref)
        assert rms <= REL_RMS and mx <= MAX_REL


def _run_pre(lib, kind, kernel, core, tgt_geo, src_gathered, gt, out,
             group, n_slots=None, seg_steps=None):
    """K8 (kind "exec_pre") or K9 ("exec_pre_t2") on one gathered chunk as
    the wrapper runs them: the runs cut into segments of at most
    seg_steps steps (None: one per run), the segment kernel, then the
    ordered reduction when a run was split. Partial rows start as NaN,
    so a value the kernels should have written and did not shows."""
    steps, run_tgt, run_off = cuda_pairs._run_table(gt)
    plan = cuda_pairs._seg_plan(kind + "_seg", kernel, core, steps, run_tgt,
                                run_off, n_slots, seg_steps, gt.device)
    return _launch_plan(lib, plan, tgt_geo, src_gathered, out, group)


def _launch_plan(lib, plan, tgt_geo, src_gathered, out, group):
    """A planned chunk (cuda_pairs.SegPlan) as launch_segments and
    reduce_segments_cuda run it: the segment kernel, then the reduction
    over the split runs. Partial rows start as NaN, so a value the
    kernels should have written and did not shows."""
    _, gc, b = src_gathered.shape
    rows = 2 if plan.kind == "exec_pre_t2_seg" else 1
    n_seg = plan.seg_run.numel()
    partials = torch.full((max(n_seg, 1), rows, plan.kernel.od, b),
                          float("nan"))
    rc = _entry(lib, plan.kind, plan.kernel.name, plan.core)(
        tgt_geo.data_ptr(), src_gathered.data_ptr(), out.data_ptr(),
        partials.data_ptr(), plan.run_tgt.data_ptr(),
        plan.run_seg.data_ptr(), plan.seg_run.data_ptr(),
        plan.seg_off.data_ptr(), plan.steps.data_ptr(),
        None if plan.n_slots is None else plan.n_slots.data_ptr(), None,
        n_seg, b, gc // group, group, out.shape[1], None)
    if rc or plan.split_runs.numel() == 0:
        return rc
    return _entry(lib, "exec_pre_reduce", plan.kernel.name, plan.core)(
        out.data_ptr(), partials.data_ptr(), plan.run_tgt.data_ptr(),
        plan.run_seg.data_ptr(), plan.split_runs.data_ptr(), None,
        plan.split_runs.numel(), rows, b, out.shape[1], None)


def _run_pre_capped(lib, kind, kernel, core, tgt_geo, src_gathered, gt, gs,
                    out, group, seg_steps):
    """K8 ("exec_pre"), K9 ("exec_pre_t2") or K12 ("exec_static") on one
    gathered chunk as the fused solve launches them: the chunk at its
    capacity, its run table and segment plan from capped_runs and
    capped_segments, the segment kernel over a CTA per step slot and the
    reduction over a row per four, which walk the split runs, both
    reading their counts from memory. Partial rows start as NaN."""
    paired = kind == "exec_pre_t2"
    launched = kind if kind == "exec_static" else kind + "_seg"
    runs = cuda_pairs.capped_runs(gt, gs, tgt_geo.shape[0] // (1 + paired),
                                  1 << 20)
    assert int(runs.bad) == 0
    segs = cuda_pairs.capped_segments(runs, seg_steps)
    cap, (_, gc, b) = gt.shape[0], src_gathered.shape
    rows = 2 if paired else 1
    partials = torch.full((cap, rows, kernel.od, b), float("nan"))
    slots = cuda_pairs.n_real_slots(gs).int()
    steps = torch.arange(cap, dtype=torch.int32)
    rc = _entry(lib, launched, kernel.name, core)(
        tgt_geo.data_ptr(), src_gathered.data_ptr(), out.data_ptr(),
        partials.data_ptr(), runs.run_tgt.data_ptr(),
        segs.run_seg.data_ptr(), segs.seg_run.data_ptr(),
        segs.seg_off.data_ptr(), steps.data_ptr(), slots.data_ptr(),
        segs.n_seg.data_ptr(), cap, b, gc // group, group, out.shape[1],
        None)
    if rc:
        return rc
    return _entry(lib, "exec_pre_reduce", kernel.name, core)(
        out.data_ptr(), partials.data_ptr(), runs.run_tgt.data_ptr(),
        segs.run_seg.data_ptr(), segs.split_runs.data_ptr(),
        segs.n_split.data_ptr(), max(1, cap // 4), rows, b, out.shape[1],
        None)


@pytest.mark.parametrize("pad8", [False, True], ids=["lean", "pad8"])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k8_matches_twin_and_k1(host_lib, name, core, pad8):
    """K8 on a gathered buffer of lean rows and of rows padded to 8, in
    two launches cut inside the run of target 1, with and without the
    slot counts: equal to its twin within the kernel limits and to K1 on
    the same groups exactly (the same order of sums)."""
    kernel = get_kernel(name)
    b, group = 32, 8
    g = torch.Generator().manual_seed(5)
    pos = torch.rand((16, b, kernel.pd), generator=g)
    rad = 0.03 + 0.04 * torch.rand((16, b), generator=g)
    s = torch.randn((16, b, kernel.sd), generator=g) / b
    pos[0], rad[0], s[0] = 0.0, 1.0, 0.0
    src_fm = featurize(name, pos, rad, s, pad8=pad8).contiguous()
    tgt_geo = cuda_pairs.build_tgt_geo(pos, rad).contiguous()
    gt, gs = _groups([3, 3, 0, 5, 1, 1, 1, 0, 9, 0], seed=6)
    gathered = cuda_pairs._pregather(name, src_fm, gs, b, pad8=False)
    assert gathered.shape == (10, group * src_fm.shape[1], b)
    twin = cuda_pairs.exec_pairs_pre_torch(kernel, tgt_geo, gathered, gt,
                                           final=False, core=core,
                                           group=group)
    k1 = torch.zeros((16, cuda_pairs.od8(kernel), b))
    assert _run_exec(host_lib, "exec", kernel, core, tgt_geo, src_fm, gt,
                     gs, k1) == 0
    for slots in (None, cuda_pairs.n_real_slots(gs)):
        out = torch.zeros_like(k1)
        for lo, hi in ((0, 6), (6, 10)):        # target 1's run is cut
            assert _run_pre(host_lib, "exec_pre", kernel, core, tgt_geo,
                            gathered[lo:hi].contiguous(), gt[lo:hi], out,
                            group, None if slots is None
                            else slots[lo:hi]) == 0
        assert torch.isfinite(out).all()
        rms, mx = _errors(out, twin)
        assert rms <= REL_RMS and mx <= MAX_REL
        assert not out[torch.tensor([0, 2, 4, 6, 7, 8])].any()
        # rows not cut by the launch boundary: K1's sums in K1's order
        assert torch.equal(out[torch.tensor([3, 5, 9])],
                           k1[torch.tensor([3, 5, 9])])
        rms, mx = _errors(out[1], k1[1])
        assert rms <= REL_RMS and mx <= MAX_REL


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k9_matches_twin_and_keeps_root(host_lib, name, core):
    kernel = get_kernel(name)
    b, group = 32, 8
    src_fm, tgt_geo = _blocks(kernel, seed=7)
    lean = src_fm[:, :cuda_pairs.FM_ROWS[name]].contiguous()
    gt, gs = _groups([1, 1, 2, 0, 3, 5, 0, 7], seed=8)
    gathered = cuda_pairs._pregather(name, lean, gs, b, pad8=False)
    out = torch.zeros((16, cuda_pairs.od8(kernel), b))
    out[1] = 7.25
    twin, k2 = out.clone(), out.clone()
    for lo, hi in ((0, 1), (1, 8)):             # parent 1's run is cut
        assert _run_pre(host_lib, "exec_pre_t2", kernel, core, tgt_geo,
                        gathered[lo:hi].contiguous(), gt[lo:hi], out, group,
                        cuda_pairs.n_real_slots(gs)[lo:hi]) == 0
    cuda_pairs.exec_pairs_pre_torch_t2(kernel, tgt_geo, gathered, gt, twin,
                                       core=core, group=group)
    assert _run_exec(host_lib, "exec_t2", kernel, core, tgt_geo, src_fm,
                     gt, gs, k2) == 0
    rms, mx = _errors(out[2:], twin[2:])
    assert rms <= REL_RMS and mx <= MAX_REL
    assert (out[1] == 7.25).all() and not out[0].any()
    assert torch.equal(out[4:], k2[4:])         # parents 2, 3, 5, 7
    rms, mx = _errors(out[2:4], k2[2:4])
    assert rms <= REL_RMS and mx <= MAX_REL


# runs of 1 to 6 steps with pads between and after them: target keys for
# K8, parent keys (< 8 of the 16 rows) for K9
SPLIT_LISTS = {"exec_pre": [4, 4, 4, 4, 4, 4, 0, 2, 2, 2, 7, 0, 9, 9, 9, 9,
                            9, 0, 0],
               "exec_pre_t2": [3, 3, 3, 3, 3, 0, 1, 1, 2, 2, 2, 2, 0, 5, 7,
                               7, 7, 0]}


@pytest.mark.parametrize("seg_steps", [1, 2, 3])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k8_k9_split_match_twins(host_lib, name, core, seg_steps):
    """K8 and K9 with the runs forced into segments of 1, 2 or 3 steps, in
    two launches cut inside a run, lean rows and the slot counts: the
    segment kernel's partial rows and the ordered reduction give the
    unsplit twin's sums within the kernel limits and the split twin's,
    rows without a run and K9's rows 0/1 untouched."""
    kernel = get_kernel(name)
    b, group = 32, 8
    src_fm, tgt_geo = _blocks(kernel, seed=20)
    lean = src_fm[:, :cuda_pairs.FM_ROWS[name]].contiguous()
    for kind, gt_list in SPLIT_LISTS.items():
        paired = kind == "exec_pre_t2"
        gt, gs = _groups(gt_list, seed=21)
        gathered = cuda_pairs._pregather(name, lean, gs, b, pad8=False)
        slots = cuda_pairs.n_real_slots(gs)
        out = torch.zeros((16, cuda_pairs.od8(kernel), b))
        out[1] = 7.25
        twin, split = out.clone(), out.clone()
        for lo, hi in ((0, 3), (3, len(gt_list))):    # a run is cut
            assert _run_pre(host_lib, kind, kernel, core, tgt_geo,
                            gathered[lo:hi].contiguous(), gt[lo:hi], out,
                            group, slots[lo:hi], seg_steps) == 0
            cuda_pairs.exec_pairs_pre_split_torch(
                kernel, tgt_geo, gathered[lo:hi], gt[lo:hi], split,
                seg_steps, core=core, group=group, paired=paired)
        if paired:
            cuda_pairs.exec_pairs_pre_torch_t2(kernel, tgt_geo, gathered, gt,
                                               twin, core=core, group=group)
        else:
            cuda_pairs.exec_pairs_pre_torch(kernel, tgt_geo, gathered, gt,
                                            twin, final=False, core=core,
                                            group=group)
        assert torch.isfinite(out).all()
        for ref in (twin, split):
            rms, mx = _errors(out[2:], ref[2:])
            assert rms <= REL_RMS and mx <= MAX_REL, kind
        assert (out[1] == 7.25).all() and not out[0].any()
        keys = {k for k in gt_list if k}
        rows = ({r for k in keys for r in (2 * k, 2 * k + 1)} if paired
                else keys)
        untouched = torch.tensor([r for r in range(2, 16) if r not in rows])
        assert not out[untouched].any()


def test_host_library_exports_every_entry(host_lib):
    for name, core in INSTANCES:
        for kind in cuda_lib.KINDS + ("occupancy",):
            _entry(host_lib, kind, name, core)
    host_lib.onbody_error_string.restype = ctypes.c_char_p
    assert host_lib.onbody_error_string(0) == b"host"


# the reference's adjacency cases (tests/test_pallas.py:287-290): a full
# ascending run, mixed singles, pairs and pads, last-slot adjacency, the
# greedy triple
ADJACENCY = [[2, 3, 4, 5, 6, 7, 8, 9], [3, 4, 7, 9, 10, 13, 0, 0],
             [5, 9, 11, 2, 6, 8, 14, 15], [4, 5, 6, 1, 12, 2, 0, 0]]


def _adjacent_groups(gt_list):
    gt = torch.tensor(gt_list)
    gs = torch.tensor([ADJACENCY[i % 4] for i in range(len(gt_list))])
    gs[gt == 0] = 0
    return gt, gs


def plan_step(ids):
    """The reference's plan_step (pallas_pairs.py:316-330) in Python:
    (heads, consumed) per slot."""
    heads, cons, consumed = [], [], False
    for j in range(len(ids)):
        adj = (j < len(ids) - 1 and ids[j] != 0
               and ids[j + 1] == ids[j] + 1)
        heads.append(adj and not consumed)
        cons.append(consumed)
        consumed = heads[-1]
    return heads, cons


def _reference_copies(ids):
    """(first slot, blocks) of each copy the reference starts, but for
    the inert id 0, which the port does not copy."""
    heads, cons = plan_step(ids)
    return [(j, 2 if heads[j] else 1) for j in range(len(ids))
            if heads[j] or (not cons[j] and ids[j] != 0)]


def test_host_bundle_planner_matches_reference_scan(host_lib):
    """copy_blocks walked slot by slot gives the reference's bundles, on
    the adjacency cases and on random rows (sorted or not, with zeros);
    bundled_blocks counts the same bundles on the whole list."""
    g = torch.Generator().manual_seed(12)
    rows = [list(r) for r in ADJACENCY]
    for _ in range(200):
        n = int(torch.randint(0, 9, (), generator=g))
        ids = torch.randint(1, 20, (n,), generator=g)
        if torch.rand((), generator=g) < 0.5:
            ids = ids.sort().values
        rows.append(ids.tolist() + [0] * (8 - n))
    fn = host_lib.host_copy_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    bundled = 0
    for ids in rows:
        arr = (ctypes.c_int * 8)(*ids)
        got, j = [], 0
        while j < 8:
            k = fn(ctypes.addressof(arr), j, 8)
            if k:
                got.append((j, k))
            j += max(1, k)
        assert got == _reference_copies(ids), ids
        bundled += 2 * sum(k == 2 for _, k in got)
    assert cuda_pairs.bundled_blocks(torch.tensor(rows)) == bundled
    assert _reference_copies(ADJACENCY[3]) == [(0, 2), (2, 1), (3, 1),
                                               (4, 1), (5, 1)]


# K11's bundles at the edges of a step (G 8): (7, 8) in the last two
# slots; the triple 5, 6, 7 (the bundle (5, 6), then 7) beside an inert
# slot and (14, 15) at the end; 10 in the last slot and 11 in the next
# step's first, which must not bundle across the steps
EDGE_BUNDLES = [[2, 9, 4, 11, 6, 13, 7, 8], [9, 5, 6, 7, 12, 0, 14, 15],
                [1, 3, 8, 12, 0, 2, 5, 10], [11, 4, 13, 9, 3, 0, 0, 0]]


def _fetch_case(case):
    """(B, group_t, group_s) of a K10/K11 case: the adjacency cases at
    B 32; at B 36, a multiple of 4 (as bulk copies need) but not of 8,
    so a row's 18 threads are not a whole warp; at B 516, above 512, so a
    row takes two CTAs (256 threads and 2); one run of 6 steps of
    distinct ids, 48 copies that wrap the 3-stage ring 16 times; and the
    bundles at the edges of a step."""
    if case == "wrap":
        gt = torch.tensor([0, 7, 7, 7, 7, 7, 7, 0, 2])
        gs = torch.arange(1, 9).repeat(9, 1)
        gs[1::2] += 7
        gs[gt == 0] = 0
        return 32, gt, gs
    if case == "edges":
        gt = torch.tensor([3, 3, 3, 3, 0, 5, 5, 0])
        gs = torch.tensor([EDGE_BUNDLES[i % 4] for i in range(8)])
        gs[gt == 0] = 0
        return 32, gt, gs
    b, gt_list = {"b32": (32, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0, 0]),
                  "b36": (36, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0, 0]),
                  "b516": (516, [5, 0])}[case]
    return (b,) + _adjacent_groups(gt_list)


@pytest.mark.parametrize("case", ["b32", "b36", "b516", "wrap", "edges"])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k10_k11_equal_k1(host_lib, name, core, case):
    """K10 and K11 on lists with pads between and after the runs (the
    cases of _fetch_case): K1's result exactly (the same blocks summed in
    the same order), its twin's within the kernel limits, rows without a
    run untouched."""
    kernel = get_kernel(name)
    b, gt, gs = _fetch_case(case)
    src_fm, tgt_geo = _blocks(kernel, b=b, seed=13)
    k1 = torch.zeros((16, cuda_pairs.od8(kernel), b))
    assert _run_exec(host_lib, "exec", kernel, core, tgt_geo, src_fm, gt,
                     gs, k1) == 0
    twin = cuda_pairs.exec_pairs_torch(kernel, tgt_geo, src_fm, gt, gs,
                                       final=False, core=core)
    rms, mx = _errors(k1, twin)
    assert rms <= REL_RMS and mx <= MAX_REL
    if case == "edges":
        assert cuda_pairs.bundled_blocks(gs) == 10   # 5 bundles
    for kind in ("exec_dma", "exec_dmap"):
        out = torch.zeros_like(k1)
        assert _run_exec(host_lib, kind, kernel, core, tgt_geo, src_fm, gt,
                         gs, out) == 0
        assert torch.equal(out, k1), kind
    keys = set(gt.tolist())
    assert not k1[torch.tensor([r for r in range(16)
                                if r not in keys])].any()


def _front_packed(gt, gs, tail: int):
    """The list's real steps front-packed, then `tail` pad steps: the
    layout group_pairs leaves at the list's static capacity."""
    keep = gt != 0
    return (torch.cat([gt[keep], gt.new_zeros(tail)]),
            torch.cat([gs[keep], gs.new_zeros((tail, gs.shape[1]))]))


# (kind, block width, target keys) of the capped launches: K1 at B 32 and
# the ragged 577, K2 on parent keys at B 32 and 577, K10/K11 at B 36
CAPPED_CASES = {
    "exec-b32": ("exec", 32, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0]),
    "exec-b577": ("exec", RAGGED_B, [3, 0, 5, 5, 9, 0]),
    "exec_t2-b32": ("exec_t2", 32, [1, 1, 2, 0, 3, 5, 0, 7]),
    "exec_t2-b577": ("exec_t2", RAGGED_B, [2, 0, 3, 3, 7, 0]),
    "exec_dma-b36": ("exec_dma", 36, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0, 0]),
    "exec_dmap-b36": ("exec_dmap", 36, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0, 0])}


@pytest.mark.parametrize("case", list(CAPPED_CASES))
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_capped_launch_equals_trimmed(host_lib, name, core, case):
    """K1, K2, K10 and K11 as the fused solve launches them (the list at
    a capacity of twice its real steps, the run table made by
    capped_runs, the count read from memory, one CTA per step slot): the
    trimmed launch's output bit for bit, the CTAs past the count writing
    nothing (K2's root rows untouched)."""
    kind, b, gt_list = CAPPED_CASES[case]
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(kernel, b=b, seed=41)
    gt, gs = (_adjacent_groups(gt_list) if kind.startswith("exec_dma")
              else _ragged_groups(gt_list, 42))
    out0 = torch.zeros((16, cuda_pairs.od8(kernel), b))
    out0[1] = 7.25
    trimmed, capped = out0.clone(), out0.clone()
    assert _run_exec(host_lib, kind, kernel, core, tgt_geo, src_fm, gt, gs,
                     trimmed) == 0
    cgt, cgs = _front_packed(gt, gs, int((gt != 0).sum()))
    assert _run_capped(host_lib, kind, kernel, core, tgt_geo, src_fm, cgt,
                       cgs, capped) == 0
    assert torch.equal(capped, trimmed)
    assert (trimmed != out0).any()


# K12's cases (rows, block width, target keys): runs of 1, 2 and 10 steps
# with pads between and after them at B 32, on lean rows and rows padded
# to 8; at B 36, whose half-row of 18 threads is no whole warp, the last
# step a run of its own; at B 516, a row over two CTAs (runs of 1, 2 and
# 3 steps)
K12_RUNS = [3, 0, 5, 5] + [1] * 10 + [0, 9, 0]
K12_CASES = {"lean-b32": (False, 32, K12_RUNS),
             "pad8-b32": (True, 32, K12_RUNS),
             "lean-b36": (False, 36, K12_RUNS[:-1]),
             "lean-b516": (False, 516, [5, 5, 0, 3, 7, 7, 7, 0])}


@pytest.mark.parametrize("case", list(K12_CASES))
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k12_matches_twin(host_lib, name, core, case):
    """K12 on a gathered chunk as its wrapper runs it: the plan at one
    step per segment, one CTA per step, then the reduction of the runs of
    more than one step, with n_slots below G on some steps: K8's result
    at one step per segment bit for bit, its twin's within the kernel
    limits (and K1's at B 32), rows without a run untouched."""
    kernel = get_kernel(name)
    pad8, b, gt_list = K12_CASES[case]
    group = 8
    src_fm, tgt_geo = _blocks(kernel, b=b, seed=14)
    lean = src_fm[:, :cuda_pairs.FM_ROWS[name]].contiguous()
    gt, gs = _groups(gt_list, seed=15)
    gs[2:, group // 2:] = torch.where(gs[2:, group // 2:] % 3 == 0, 0,
                                      gs[2:, group // 2:])
    gs[gt == 0] = 0
    slots = cuda_pairs.n_real_slots(gs)
    assert (slots[gt != 0] < group).any()
    gathered = cuda_pairs._pregather(name, src_fm if pad8 else lean, gs, b,
                                     pad8=False)
    plan = cuda_pairs.plan_chunk("exec_static", kernel, core, gt, slots)
    assert plan.seg_run.numel() == (gt != 0).sum()
    od8 = cuda_pairs.od8(kernel)
    out = torch.zeros((16, od8, b))
    assert _launch_plan(host_lib, plan, tgt_geo, gathered, out, group) == 0
    k8 = torch.zeros_like(out)
    assert _run_pre(host_lib, "exec_pre", kernel, core, tgt_geo, gathered,
                    gt, k8, group, slots, seg_steps=1) == 0
    assert torch.equal(out, k8)
    refs = [cuda_pairs.exec_pairs_static_torch(kernel, tgt_geo, gathered, gt,
                                               final=False, core=core,
                                               group=group)]
    if b == 32:
        refs.append(torch.zeros_like(out))
        assert _run_exec(host_lib, "exec", kernel, core, tgt_geo, src_fm, gt,
                         gs, refs[-1]) == 0
    assert torch.isfinite(out).all()
    for ref in refs:
        rms, mx = _errors(out, ref)
        assert rms <= REL_RMS and mx <= MAX_REL
    keys = set(gt_list)
    assert not out[torch.tensor([r for r in range(16)
                                 if r not in keys])].any()
    assert not out[:, kernel.od:].any()


# keys with runs of 1-7 steps, a pad tail of 11 step slots; 14 runs of 2
# steps (more split runs than the reduction's 8 grid rows: rows walk)
CAPPED_PRE_KEYS = [3] * 7 + [1, 6, 6] + [2] * 5 + [7] * 3 + [0] * 11
CAPPED_PAIRS_KEYS = [k for k in range(1, 15) for _ in (0, 1)] + [0] * 4
# (kind, S, keys): K8 at 2 and 3 steps a segment, K9 at 2, K12 (one step
# a segment)
CAPPED_PRE = {"k8-s2": ("exec_pre", 2, CAPPED_PRE_KEYS),
              "k8-s3": ("exec_pre", 3, CAPPED_PRE_KEYS),
              "k9-s2": ("exec_pre_t2", 2, CAPPED_PRE_KEYS),
              "k12": ("exec_static", 1, CAPPED_PRE_KEYS),
              "k12-walk": ("exec_static", 1, CAPPED_PAIRS_KEYS)}


@pytest.mark.parametrize("case", list(CAPPED_PRE))
@pytest.mark.parametrize("name,core", INSTANCES[:2] + INSTANCES[-2:],
                         ids=IDS[:2] + IDS[-2:])
def test_host_capped_pre_equals_trimmed(host_lib, name, core, case):
    """K8, K9 and K12 with the reduction as the fused solve launches them
    (the plan made by capped_segments, the counts read from memory, the
    segment grid at the chunk's capacity, the reduction's rows walking
    the split runs) give the eager launches' bits on the trimmed plan
    (CTAs past the counts touch nothing, NaN partials included)."""
    kind, s, keys = CAPPED_PRE[case]
    kernel = get_kernel(name)
    group = 8
    src_fm, tgt_geo = _blocks(kernel, b=32, seed=16)
    gt, gs = _groups(keys, seed=17)
    slots = cuda_pairs.n_real_slots(gs)
    gathered = cuda_pairs._pregather(name, src_fm, gs, 32, pad8=False)
    out0 = torch.zeros((16, cuda_pairs.od8(kernel), 32))
    out0[1] = 7.25
    trimmed, capped = out0.clone(), out0.clone()
    steps, run_tgt, run_off = cuda_pairs._run_table(gt)
    plan = cuda_pairs._seg_plan(
        "exec_static" if kind == "exec_static" else kind + "_seg", kernel,
        core, steps, run_tgt, run_off, slots, s, gt.device)
    assert plan.split_runs.numel() > 0
    assert _launch_plan(host_lib, plan, tgt_geo, gathered, trimmed,
                        group) == 0
    assert _run_pre_capped(host_lib, kind, kernel, core, tgt_geo, gathered,
                           gt, gs, capped, group, s) == 0
    assert torch.equal(capped, trimmed)
    assert torch.isfinite(capped).all()


# runs of 1, 3, 9, 12, 1, 17, 18 and 37 segments: the 4-load groups with
# and without a tail, single segments before, between and after them
REDUCE_SEGS = [1, 3, 9, 12, 1, 17, 18, 1, 37]


@pytest.mark.parametrize("b", [256, 30], ids=["b256", "b30"])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_reduction_matches_twin(host_lib, name, core, rows, b):
    """The ordered reduction on the split runs' list alone, rows 1 (K8,
    K12) and 2 (K9), at B 256 and B 30 (not a multiple of 4): the twin's
    sums bit for bit (the same order per value), the rows of one-segment
    runs untouched though their partials are NaN (no CTA reads them)."""
    kernel = get_kernel(name)
    g = torch.Generator().manual_seed(22)
    n_runs = len(REDUCE_SEGS)
    run_seg = torch.tensor([0] + REDUCE_SEGS).cumsum(0).int()
    run_tgt = torch.arange(1, n_runs + 1).int()
    partials = torch.randn((int(run_seg[-1]), rows, kernel.od, b),
                           generator=g)
    single = torch.tensor([s == 1 for s in REDUCE_SEGS])
    partials[run_seg[:-1][single].long()] = float("nan")
    od8 = cuda_pairs.od8(kernel)
    out = torch.randn((2 * 16, od8, b), generator=g)
    twin = out.clone()
    split = torch.nonzero(~single).squeeze(1).int()
    assert _entry(host_lib, "exec_pre_reduce", name, core)(
        out.data_ptr(), partials.data_ptr(), run_tgt.data_ptr(),
        run_seg.data_ptr(), split.data_ptr(), None, split.numel(), rows, b,
        od8, None) == 0
    cuda_pairs.reduce_segments_torch(twin, partials, run_tgt, run_seg,
                                     paired=rows == 2)
    assert torch.equal(out, twin)
    assert torch.isfinite(out).all()


def _ablate_entry(lib, kind, mode):
    fn = getattr(lib, f"onbody_{kind}_ablate_{mode}")
    fn.argtypes = (cuda_lib._ARGTYPES["exec_ablate"] if kind == "exec"
                   else cuda_lib._ARGTYPES["occupancy"][1:])
    fn.restype = ctypes.c_int
    return fn


def _run_ablate(lib, mode, tgt_geo, src_fm, gt, gs, out):
    run_tgt, run_off, pair_s = cuda_pairs._runs(gt, gs)
    _, c, b = src_fm.shape
    return _ablate_entry(lib, "exec", mode)(
        tgt_geo.data_ptr(), src_fm.data_ptr(), out.data_ptr(),
        run_tgt.data_ptr(), run_off.data_ptr(), pair_s.data_ptr(),
        run_tgt.numel(), b, c, pair_s.shape[1], out.shape[1], None)


def _ablate_rows(seed, b=32):
    """exp_kernel's rows (uniform [0, 1), row 3 read as sr) at B b."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((16, 8, b), generator=g),
            torch.rand((16, 8, b), generator=g))


# K13's widths: K10's at B 32, a row's 18 threads at B 36, two CTAs of a
# row at B 516 (the dma mode's lanes are the two points each thread owns)
ABLATE_B = [32, 36, 516]


@pytest.mark.parametrize("b", ABLATE_B)
@pytest.mark.parametrize("mode", cuda_lib.ABLATE_MODES)
def test_host_k13_matches_twin(host_lib, mode, b):
    """K13 in each mode on a list with pads between and after the runs
    and inert slots: its twin within the kernel limits, rows without a
    run untouched, the rows beyond the mode's outputs zero."""
    tgt_geo, src_fm = _ablate_rows(16, b)
    gt, gs = _groups([3, 3, 0, 5, 1, 1, 1, 0, 9, 0], seed=17)
    out = torch.zeros((16, 8, b))
    assert _run_ablate(host_lib, mode, tgt_geo, src_fm, gt, gs, out) == 0
    twin = cuda_pairs.exec_ablate_torch(mode, tgt_geo, src_fm, gt, gs)
    assert torch.isfinite(out).all()
    rms, mx = _errors(out, twin)
    assert rms <= REL_RMS and mx <= MAX_REL
    assert not out[torch.tensor([0, 2, 4, 6, 7, 8])].any()
    assert not out[:, 1 if mode == "d2" else 3:].any()


@pytest.mark.parametrize("b", ABLATE_B)
def test_host_k13_full_is_k10_on_squared_rows(host_lib, b):
    """'full' squares row 3 once per source as it stages the block; on
    rows that store sr^2 there, as the production rows do, K10 with the
    grav3d body gives the same result bit for bit."""
    tgt_geo, src_fm = _ablate_rows(18, b)
    gt, gs = _adjacent_groups([3, 3, 0, 5, 1, 1, 1, 0, 9, 0, 0])
    full = torch.zeros((16, 8, b))
    assert _run_ablate(host_lib, "full", tgt_geo, src_fm, gt, gs, full) == 0
    squared = src_fm.clone()
    squared[:, 3] = src_fm[:, 3] * src_fm[:, 3]
    k10 = torch.zeros_like(full)
    assert _run_exec(host_lib, "exec_dma", get_kernel("grav3d"), "rm",
                     tgt_geo, squared, gt, gs, k10) == 0
    assert torch.equal(full, k10)


def test_host_library_exports_k13_entries(host_lib):
    for mode in cuda_lib.ABLATE_MODES:
        for kind in ("exec", "occupancy"):
            _ablate_entry(host_lib, kind, mode)


# K1-f64 and K4-f64 (csrc/fp64.cuh) against their float64 twins: max
# error / max |twin|, the limit chip_smoke.py holds them to on the card
F64_MAX_REL = 1e-12


def _f64_errors(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


# (block width, seed, target keys, group) of K1-f64's cases: B 32; the
# ragged B 577 (289 threads of two points, three CTAs of 128, the last
# thread one point); B 33 (17 threads, the last one point); a run of 9
# steps of 4 slots that wraps the 2-stage ring (slots of id 0 inside it)
K1_F64_CASES = {
    "b32": (32, 0, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0], 8),
    "b577": (RAGGED_B, 30, [3, 0, 5, 5, 9, 0], 4),
    "b33": (33, 5, [2, 2, 0, 7, 0, 4, 4, 4], 8),
    "wrap": (32, 9, [0, 6] + [11] * 9 + [0, 3, 3], 4)}


@pytest.mark.parametrize("case", list(K1_F64_CASES))
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k1_f64_matches_twin(host_lib, name, core, case):
    """K1-f64 on K1_F64_CASES, on double rows: the float64 twin's sums
    within F64_MAX_REL, rows without a run untouched; launched as the
    fused solve launches it (the list at its capacity, the count read by
    the kernel), the trimmed launch's output bit for bit."""
    kernel = get_kernel(name)
    b, seed, gt_list, group = K1_F64_CASES[case]
    src_fm, tgt_geo = (a.double() for a in _blocks(kernel, b=b,
                                                   seed=seed))
    gt, gs = _ragged_groups(gt_list, seed + 1, group)
    out = torch.zeros((16, cuda_pairs.od8(kernel), b), dtype=torch.float64)
    capped = out.clone()
    assert _run_exec(host_lib, "exec64", kernel, core, tgt_geo, src_fm,
                     gt, gs, out) == 0
    twin = cuda_pairs.exec_pairs_torch(kernel, tgt_geo, src_fm, gt, gs,
                                       final=False, core=core)
    assert torch.isfinite(out).all()
    assert _f64_errors(out, twin) <= F64_MAX_REL
    assert not out[torch.tensor([r for r in range(16)
                                 if r not in gt_list])].any()
    cgt, cgs = _front_packed(gt, gs, int((gt != 0).sum()))
    assert _run_capped(host_lib, "exec64", kernel, core, tgt_geo,
                       src_fm, cgt, cgs, capped) == 0
    assert torch.equal(capped, out)


# distances over the core radius on both sides of the exp core's
# thresholds (reld 0.001 at d = 0.1 sr in 3D, 16 at 2.52 sr; 2D: d^2 + 1e-6
# = 0.001 and 16 times sr^2 + tr^2), each at least 0.3% from it, and d = 0
EXP_RATIOS = np.array([0.0, 0.03, 0.0997, 0.1003, 0.4, 1.0, 2.51, 2.53,
                       4.0, 30.0])
EXP_RATIOS_2D = np.array([0.0, 3e-4, 0.000997, 0.001003, 0.05, 1.0, 15.95,
                          16.05, 40.0, 900.0])


def _f32(x):
    return np.ascontiguousarray(np.asarray(x, np.float64).astype(np.float32))


def _core_exp(lib, which, a, b, c=None, d=None):
    n = a.shape[0]
    out, out2 = np.zeros(n, np.float32), np.zeros(n, np.float32)
    c = a if c is None else c
    d = a if d is None else d
    ptr = lambda v: v.ctypes.data_as(ctypes.c_void_p)
    lib.host_core_exp(ctypes.c_int(which), ctypes.c_int(n), ptr(a), ptr(b),
                      ptr(c), ptr(d), ptr(out), ptr(out2))
    return out, out2


@pytest.mark.parametrize("which", ["c3", "c3g", "c2"])
def test_host_exp_core_matches_reference(host_lib, which):
    """The exp core (csrc/core.cuh CoreExp, its MUFU operations as
    HOST_STUB's exact forms) against the reference's exp_3d, exp_3d_grads
    and exp_2d (onbody_tpu/ops/core_funcs.py) on points made in float64
    from a numpy seed and cast to float32: d = 0, and on both sides of
    reld = 0.001 and 16; each value within 2e-6 of the reference's,
    relative (a pair across reld = 0.001 from the reference's branch
    would differ by 5e-4)."""
    rng = np.random.default_rng(18)
    sr = rng.uniform(0.01, 0.2, (4, 1))
    if which == "c2":
        tr = rng.uniform(0.0, 0.2, (4, 1))
        s2 = sr * sr + tr * tr
        d2 = np.maximum(EXP_RATIOS_2D * s2 - 1e-6, 0.0)
        d2[:, 0] = 0.0
        ang = rng.uniform(0.0, 2 * np.pi, d2.shape)
        dx, dy = (_f32(np.sqrt(d2) * np.cos(ang)).ravel(),
                  _f32(np.sqrt(d2) * np.sin(ang)).ravel())
        srf = _f32(np.broadcast_to(sr, d2.shape)).ravel()
        trf = _f32(np.broadcast_to(tr, d2.shape)).ravel()
        got, _ = _core_exp(host_lib, 2, dx, dy, srf * srf, trf * trf)
        ref = np.asarray(JC.exp_2d(jnp.asarray(dx * dx + dy * dy),
                                   jnp.asarray(srf), jnp.asarray(trf)))
        refs, gots = [ref], [got]
    else:
        d2 = (EXP_RATIOS * sr) ** 2
        d2f = _f32(d2).ravel()
        srf = _f32(np.broadcast_to(sr, d2.shape)).ravel()
        got, got2 = _core_exp(host_lib, 0 if which == "c3" else 1, d2f, srf)
        if which == "c3":
            refs = [np.asarray(JC.exp_3d(jnp.asarray(d2f), jnp.asarray(srf)))]
            gots = [got]
        else:
            r3, bbb = JC.exp_3d_grads(jnp.asarray(d2f), jnp.asarray(srf))
            refs, gots = [np.asarray(r3), np.asarray(bbb)], [got, got2]
    for g, r in zip(gots, refs):
        assert g.dtype == r.dtype == np.float32
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=2e-6, atol=0.0)


# K4-f64's cases: K4's (its tile is 512 targets, 256 for vort2d's RM
# body and the exp and v2 cores, and its chunk 256 sources, so 301 and
# 777 leave a tile partly empty, 2500 sources make ten chunks, the last
# short); one chunk of 200 sources, fewer than the ring's 2 stages,
# against 257 targets (a 256-target tile and one); three chunks in 3
# splits, each split one
# chunk; 513 targets (a tile and one) against 5000 sources (20 chunks,
# the last short) in 2 splits; 300 targets against 4700 sources (19
# chunks) in 7 splits of two or three
K4_F64_CASES = K4_CASES + [(257, 200, 1), (300, 600, 3), (513, 5000, 2),
                           (300, 4700, 7)]


@pytest.mark.parametrize("m,s,splits", K4_F64_CASES,
                         ids=[f"{m}x{s}-{k}" for m, s, k in K4_F64_CASES])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_host_k4_f64_matches_twin(host_lib, name, core, m, s, splits):
    """K4-f64 as the wrapper runs it, on K4_F64_CASES in double: one
    launch writing the output, or one partial slab per split (each
    against the float64 twin on its split's sources; the scratch starts
    as NaN) and the ordered reduction, equal to the slabs summed in split
    order bit for bit; the whole against the twin within F64_MAX_REL."""
    kernel = get_kernel(name)
    g = torch.Generator().manual_seed(4)
    tx = torch.rand((m, kernel.pd), generator=g, dtype=torch.float64)
    tr = torch.full((m,), 0.03, dtype=torch.float64)
    sx = torch.cat([tx[:40], torch.rand((s - 40, kernel.pd), generator=g,
                                        dtype=torch.float64)])
    sr = 0.02 + 0.03 * torch.rand((s,), generator=g, dtype=torch.float64)
    ss = torch.randn((s, kernel.sd), generator=g, dtype=torch.float64) / s
    tgt, src = cuda_direct.layout(kernel, tx, tr, sx, sr, ss)
    out = torch.full((m, kernel.od), float("nan"), dtype=torch.float64)
    dst = out if splits == 1 else torch.full(
        (splits, m, kernel.od), float("nan"), dtype=torch.float64)
    assert _entry(host_lib, "direct64", name, core)(
        tgt.data_ptr(), src.data_ptr(), dst.data_ptr(), m, s, splits,
        None) == 0
    if splits > 1:
        for part, (lo, hi) in zip(dst, cuda_direct.split_bounds(
                s, splits, cuda_direct.CHUNK_S64)):
            ref = cuda_direct.direct_torch(kernel, tx, tr, sx[lo:hi],
                                           sr[lo:hi], ss[lo:hi], core)
            assert _f64_errors(part, ref) <= F64_MAX_REL, (lo, hi)
        assert _entry(host_lib, "direct64_reduce", name, core)(
            out.data_ptr(), dst.data_ptr(), m, splits, None) == 0
        assert torch.equal(out, cuda_direct.reduce_splits_torch(dst))
    twin = cuda_direct.direct_torch(kernel, tx, tr, sx, sr, ss, core)
    assert _f64_errors(out, twin) <= F64_MAX_REL


def test_host_direct64_tile(host_lib):
    """K4-f64's targets a CTA, as the library reports them to the split
    planner (cuda_direct.geometry): the RM bodies two a thread, 256
    threads a CTA but vort2d's 128; the exp and v2 cores one a thread of
    256."""
    for name, core in INSTANCES:
        fn = getattr(host_lib, cuda_lib.entry(
            "direct64_tile", cuda_lib.instance(name, core)))
        want = 256 if core != "rm" or name == "vort2d" else 512
        assert fn() == want, (name, core)


# The split reduction's shapes, (workload, M): grav3d's 777 x 3 values
# (odd: one value a load; the staged pass, tiles of 8 values),
# vortgrad3d's 41 x 12 (16-byte copies, tiles of one vector) and grav3d's
# 50000 x 3 (the streaming pass: 37500 vectors of 4 floats, 75000 of 2
# doubles; 40 splits in two rounds of 16 loads and 7 more)
REDUCE_SHAPES = (("grav3d", 777), ("vortgrad3d", 41), ("grav3d", 50000))


@pytest.mark.parametrize("splits", list(range(1, 10)) + [40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float", "double"])
def test_host_split_reduce_matches_twin(host_lib, dtype, splits):
    """The ordered split reduction (csrc/direct.cuh split_reduce and
    split_reduce_stream, K4's entry on floats, K4-f64's on doubles) at
    REDUCE_SHAPES, 1-9 splits and 40: the slabs summed in split order,
    bit for bit reduce_splits_torch; the output starts as NaN, so a value
    it should have written and did not shows."""
    kind = "direct64_reduce" if dtype == torch.float64 else "direct_reduce"
    g = torch.Generator().manual_seed(splits)
    for name, m in REDUCE_SHAPES:
        od = get_kernel(name).od
        partials = torch.randn((splits, m, od), generator=g, dtype=dtype)
        partials *= torch.logspace(-3, 3, m * od, dtype=dtype).view(m, od)
        out = torch.full((m, od), float("nan"), dtype=dtype)
        assert _entry(host_lib, kind, name, "rm")(
            out.data_ptr(), partials.data_ptr(), m, splits, None) == 0
        twin = cuda_direct.reduce_splits_torch(partials)
        assert torch.equal(out, twin), (name, m)
        assert out.view(torch.int32 if dtype == torch.float32
                        else torch.int64).equal(
            twin.view(torch.int32 if dtype == torch.float32
                      else torch.int64)), (name, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float", "double"])
def test_host_split_reduce_passes_match_twin(host_lib, dtype):
    """The staged pass alone with 4 KB a CTA (host_split_reduce_staged_*):
    tiles of 512 floats or 256 doubles, two splits a pass, so 3, 9 and 40
    splits take 2, 5 and 20 passes with the running sums in shared
    memory; bit for bit reduce_splits_torch."""
    ty = "double" if dtype == torch.float64 else "float"
    fn = getattr(host_lib, f"host_split_reduce_staged_{ty}")
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    g = torch.Generator().manual_seed(40)
    n = 150000
    for splits in (3, 9, 40):
        partials = torch.randn((splits, n), generator=g, dtype=dtype)
        out = torch.full((n,), float("nan"), dtype=dtype)
        assert fn(out.data_ptr(), partials.data_ptr(), n, splits) == 0
        assert torch.equal(out, cuda_direct.reduce_splits_torch(partials))
