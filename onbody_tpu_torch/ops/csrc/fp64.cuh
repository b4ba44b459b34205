// The fp64 executors of the accuracy tier, templated on a double body
// (body64.cuh): K1-f64, the grouped executor fetching source blocks by
// id (exec64_runs), and K4-f64, the direct sum over target tiles x
// source splits (direct64_kernel) with its ordered reduction
// (direct64_reduce).
//
// They replace the jnp forms the reference runs at accum_dtype=float64:
// onbody_tpu/traverse/exec.py:exec_pairs_jnp, to which every fetch is
// routed there (exec.py:151-152, "Mosaic has no fp64"), in place of the
// Pallas executor onbody_tpu/ops/pallas_pairs.py:_exec_chunk (:623); and
// onbody_tpu/traverse/direct.py:direct (:65-102) in fp64, in place of
// onbody_tpu/ops/pallas_direct.py:direct_pallas (:70). d, |d|^2, the core
// and every sum are double, on double rows: the wrappers
// (ops/cuda_pairs.py, ops/cuda_direct.py) promote fp32-stored rows to
// double once, which is exact.
//
// What bounds them: the pairs' FP64 operations (body64.cuh's header) over
// the SMs' FP64 pipes (64 lanes an SM, half the FP32 lanes), and the
// double rsqrt's MUFU.RSQ64H. Bytes are no limit: a staged block serves a
// whole row of targets. The design is the simple one: one CTA per run
// (K1-f64) or per (target tile, split) (K4-f64), each thread owning its
// targets' sums in registers, each source block (chunk) staged
// synchronously into shared memory as kRows double rows, then summed by
// every thread. No ring, no asynchronous copies, no atomics and no
// warp-level code, so the host emulation (tests/test_torch_csrc_host.py)
// checks them as it checks the fp32 kernels. The order of sums is the
// fp32 kernels': per target a block's (chunk's) partial in source order,
// partials added in block order, K4-f64's splits added in split order
// by the reduction, so two calls agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "body64.cuh"

namespace onbody {

constexpr int kExec64Threads = 256;

// Threads per CTA, CTAs per row (the grid's y: one target point per
// thread) and dynamic shared memory (one staged block, kRows x B doubles)
// of a K1-f64 launch at B.
template <class Body>
void exec64_config(int B, int* threads, int* grid_y, size_t* smem) {
  *threads = B < kExec64Threads ? B : kExec64Threads;
  *grid_y = (B + *threads - 1) / *threads;
  *smem = sizeof(double) * Body::kRows * B;
}

// K1-f64: CTA `run` sums the blocks of its run's steps, slot by slot (id
// 0, the inert row, skipped), into the row run_tgt[run] of out (NN_t,
// od8, B). Arguments are K1's (pairs.cuh exec_runs), over doubles,
// n_runs_dev included: with the run count in device memory (the fused
// solve's list at its static capacity) a CTA at or past it exits at once.
template <class Body>
__global__ void __launch_bounds__(kExec64Threads)
    exec64_runs(const double* __restrict__ tgt_geo,
                const double* __restrict__ src_fm, double* __restrict__ out,
                const int* __restrict__ run_tgt,
                const int* __restrict__ run_off,
                const int* __restrict__ pair_s,
                const int* __restrict__ n_runs_dev, int B, int C, int G,
                int od8) {
  extern __shared__ __align__(16) float smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);  // row r at sm + r * B
  const int run = blockIdx.x;
  if (n_runs_dev != nullptr && run >= *n_runs_dev) return;  // past the list
  const int64_t row = run_tgt[run];
  const int i = blockIdx.y * blockDim.x + threadIdx.x;  // the target point
  typename Body::Tgt t{};
  if (i < B) t = Body::load_tgt(tgt_geo + row * 8 * B + i, B);
  double acc[Body::kOut];
  for (int o = 0; o < Body::kOut; ++o) acc[o] = 0.0;
  const int64_t q_end = (int64_t)run_off[run + 1] * G;
  for (int64_t q = (int64_t)run_off[run] * G; q < q_end; ++q) {
    const int id = pair_s[q];  // uniform across the CTA
    if (id == 0) continue;
    const double* blk = src_fm + (int64_t)id * C * B;
    __syncthreads();  // the previous block is read
    for (int r = 0; r < Body::kRows; ++r) {
      for (int s = threadIdx.x; s < B; s += blockDim.x) {
        sm[r * B + s] = Body::staged(r, blk[r * B + s]);
      }
    }
    __syncthreads();
    if (i < B) {
      double part[Body::kOut];
      for (int o = 0; o < Body::kOut; ++o) part[o] = 0.0;
      for (int s = 0; s < B; ++s) {
        Body::pair(Body::load_src(sm + s, B), t, part);
      }
      for (int o = 0; o < Body::kOut; ++o) acc[o] += part[o];
    }
  }
  if (i >= B) return;
  double* o0 = out + row * od8 * B + i;
  for (int o = 0; o < Body::kOut; ++o) o0[o * B] += acc[o];
}

template <class Body>
int launch_exec64(const double* tgt_geo, const double* src_fm, double* out,
                  const int* run_tgt, const int* run_off, const int* pair_s,
                  const int* n_runs_dev, int n_runs, int B, int C, int G,
                  int od8, void* stream) {
  if (n_runs <= 0) return (int)cudaSuccess;
  int threads, grid_y;
  size_t smem;
  exec64_config<Body>(B, &threads, &grid_y, &smem);
  // always: an occupancy query at another B may have set another limit
  const cudaError_t err = cudaFuncSetAttribute(
      exec64_runs<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_runs, grid_y);
  exec64_runs<Body><<<grid, threads, smem, (cudaStream_t)stream>>>(
      tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs_dev, B, C, G,
      od8);
  return (int)cudaGetLastError();
}

// K4-f64: K4's grid and split plan (direct.cuh: target tiles of
// kDirect64Tile x source splits of whole chunks of kDirect64Chunk, split
// fastest; ops/cuda_direct.py plan_splits), two targets per thread,
// each chunk staged synchronously as kRows double rows. Inputs targets
// (PD+1, M) and sources (C, S) feature-major in double; output (M, OD),
// or with splits the scratch (splits, M, OD) that direct64_reduce sums.
constexpr int kDirect64Threads = 256;
constexpr int kDirect64Tgts = 2;
constexpr int kDirect64Tile = kDirect64Threads * kDirect64Tgts;
constexpr int kDirect64Chunk = 512;

template <class Body>
constexpr size_t direct64_smem() {
  return sizeof(double) * Body::kRows * kDirect64Chunk;
}

template <class Body>
__global__ void __launch_bounds__(kDirect64Threads)
    direct64_kernel(const double* __restrict__ tgt,
                    const double* __restrict__ src,
                    double* __restrict__ dst, int M, int S, int splits) {
  extern __shared__ __align__(16) float smem_raw[];
  double* st = reinterpret_cast<double*>(smem_raw);  // row r: st + r * chunk
  const int split = blockIdx.x % splits;
  const int64_t tile = blockIdx.x / splits;
  const int64_t i0 = tile * blockDim.x * kDirect64Tgts + threadIdx.x;
  typename Body::Tgt t[kDirect64Tgts];
  double acc[kDirect64Tgts][Body::kOut];
  for (int k = 0; k < kDirect64Tgts; ++k) {
    const int64_t i = i0 + k * blockDim.x;
    t[k] = typename Body::Tgt{};
    if (i < M) t[k] = Body::load_tgt(tgt + i, M);
    for (int o = 0; o < Body::kOut; ++o) acc[k][o] = 0.0;
  }
  const int64_t chunks = ((int64_t)S + kDirect64Chunk - 1) / kDirect64Chunk;
  const int64_t s0 = split * chunks / splits * kDirect64Chunk;
  const int64_t s_end = (split + 1) * chunks / splits * kDirect64Chunk;
  const int64_t s1 = s_end < S ? s_end : S;
  for (int64_t c0 = s0; c0 < s1; c0 += kDirect64Chunk) {
    const int n = s1 - c0 < kDirect64Chunk ? (int)(s1 - c0) : kDirect64Chunk;
    __syncthreads();  // the previous chunk is read
    for (int r = 0; r < Body::kRows; ++r) {
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
        st[r * kDirect64Chunk + q] = Body::staged(r, src[r * S + c0 + q]);
      }
    }
    __syncthreads();
    if (i0 >= M) continue;
    double part[kDirect64Tgts][Body::kOut];
    for (int k = 0; k < kDirect64Tgts; ++k) {
      for (int o = 0; o < Body::kOut; ++o) part[k][o] = 0.0;
    }
    for (int q = 0; q < n; ++q) {
      const typename Body::Src s = Body::load_src(st + q, kDirect64Chunk);
      for (int k = 0; k < kDirect64Tgts; ++k) Body::pair(s, t[k], part[k]);
    }
    for (int k = 0; k < kDirect64Tgts; ++k) {
      for (int o = 0; o < Body::kOut; ++o) acc[k][o] += part[k][o];
    }
  }
  double* d = dst + (int64_t)split * M * Body::kOut;
  for (int k = 0; k < kDirect64Tgts; ++k) {
    const int64_t i = i0 + k * blockDim.x;
    if (i >= M) continue;
    for (int o = 0; o < Body::kOut; ++o) d[i * Body::kOut + o] = acc[k][o];
  }
}

template <class Body>
int launch_direct64(const double* tgt, const double* src, double* dst,
                    int M, int S, int splits, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int tiles = (M + kDirect64Tile - 1) / kDirect64Tile;
  const size_t smem = direct64_smem<Body>();
  const cudaError_t err = cudaFuncSetAttribute(
      direct64_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = tiles * splits;
  direct64_kernel<Body><<<blocks, kDirect64Threads, smem,
                          (cudaStream_t)stream>>>(tgt, src, dst, M, S,
                                                  splits);
  return (int)cudaGetLastError();
}

// K4-f64's ordered reduction: out[e] = the sum over splits of
// partials[s][e] in split order, one thread per output value. Bound by
// bytes: the slabs read once, the output written once.
template <class Body>
__global__ void direct64_reduce(double* __restrict__ out,
                                const double* __restrict__ partials, int M,
                                int splits) {
  const int64_t n = (int64_t)M * Body::kOut;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double v = partials[e];
  for (int s = 1; s < splits; ++s) v += partials[s * n + e];
  out[e] = v;
}

constexpr int kDirect64ReduceThreads = 256;

template <class Body>
int launch_direct64_reduce(double* out, const double* partials, int M,
                           int splits, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int64_t n = (int64_t)M * Body::kOut;
  const int blocks = (int)((n + kDirect64ReduceThreads - 1) /
                           kDirect64ReduceThreads);
  direct64_reduce<Body><<<blocks, kDirect64ReduceThreads, 0,
                          (cudaStream_t)stream>>>(out, partials, M, splits);
  return (int)cudaGetLastError();
}

}  // namespace onbody
