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
// the SMs' FP64 pipes (64 lanes an SM, half the FP32 lanes). Bytes are no
// limit: a staged block serves a whole row of targets.
//
// K1-f64 is K1's tile (pairs.cuh exec_tile) in double. One CTA per run;
// each thread owns kExec64Tgts = 2 target points of the row (i and i +
// ceil(B/2)), so every source read from shared memory serves two
// targets; each block is staged source by source (its kRows doubles
// padded to whole 16-byte pairs, aos64), so a source comes in aos64 / 2
// broadcast loads (LDS.128) for both; the staging is asynchronous, a
// cp.async ring of kExec64Stages blocks copied a double at a time
// (async_copy.cuh copy8_async), so the next block lands while the
// current one is summed. The pairs take the RM core's double rsqrt and
// reciprocal as one MUFU and Newton's steps (body64.cuh MufuF64,
// mufu.cuh), with no range check and no slow-path call. CTAs of at most
// kExec64Threads threads (a row of B 256 is one CTA of 128). A block's
// pairs take far longer than its copy, so two stages hide it, and
// against three they take a third less shared memory, so more CTAs fit
// an SM (vort3d's 6, not 4).
// K4-f64 is the simple design: one CTA per (target tile, split), two
// targets a thread, each chunk staged synchronously as kRows double rows,
// the library's rsqrt and division (IeeeF64).
//
// No atomics and no warp-level code, so the host emulation
// (tests/test_torch_csrc_host.py, which swaps async_copy.cuh for
// synchronous copies) checks them as it checks the fp32 kernels. The
// order of sums is the fp32 kernels': per target a block's (chunk's)
// partial in source order, partials added in block order, K4-f64's
// splits added in split order by the reduction, so two calls agree bit
// for bit, and K1-f64 at a list's static capacity gives the trimmed
// launch's bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "body64.cuh"

namespace onbody {

constexpr int kExec64Threads = 128;  // threads a CTA at most
constexpr int kExec64Tgts = 2;       // target points a thread
constexpr int kExec64Stages = 2;     // blocks in flight a CTA

// Doubles a source takes in K1-f64's staged layout: its kRows values side
// by side, padded to whole 16-byte pairs.
template <class Body>
__host__ __device__ constexpr int aos64() {
  return (Body::kRows + 1) / 2 * 2;
}

// Threads per CTA, CTAs per row (the grid's y: a row needs ceil(B / 2)
// threads) and dynamic shared memory (the ring of kExec64Stages staged
// blocks) of a K1-f64 launch at B.
template <class Body>
void exec64_config(int B, int* threads, int* grid_y, size_t* smem) {
  const int nthr = (B + kExec64Tgts - 1) / kExec64Tgts;
  *threads = nthr < kExec64Threads ? nthr : kExec64Threads;
  *grid_y = (nthr + *threads - 1) / *threads;
  *smem = sizeof(double) * kExec64Stages * B * aos64<Body>();
}

// The pair loop of K1-f64: the B sources of a block staged source by
// source (aos64 doubles each, 16-byte aligned) against kN targets, each
// target's block partial in source order added onto acc once.
template <class Body, int kN>
__device__ __forceinline__ void block64(const double* __restrict__ sm, int n,
                                        const typename Body::Tgt (&t)[kN],
                                        double (&acc)[kN][Body::kOut]) {
  constexpr int kVec = aos64<Body>() / 2;
  double part[kN][Body::kOut];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) part[k][o] = 0.0;
  }
  for (int q = 0; q < n; ++q) {
    const double2* p = reinterpret_cast<const double2*>(sm) + q * kVec;
    double v[2 * kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const double2 f = p[c];
      v[2 * c] = f.x;
      v[2 * c + 1] = f.y;
    }
    const typename Body::Src s = Body::load_src(v, 1);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      Body::template pair<MufuF64>(s, t[k], part[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[k][o] += part[k][o];
  }
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
  double* ring = reinterpret_cast<double*>(smem_raw);  // kExec64Stages blocks
  constexpr int kAos = aos64<Body>();
  constexpr int kN = kExec64Tgts;
  const int run = blockIdx.x;
  if (n_runs_dev != nullptr && run >= *n_runs_dev) return;  // past the list
  const int64_t row = run_tgt[run];
  const int nthr = (B + kN - 1) / kN;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;  // points i + k nthr
  typename Body::Tgt t[kN];
  double acc[kN][Body::kOut];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int pt = i + k * nthr;
    t[k] = typename Body::Tgt{};
    if (i < nthr && pt < B) {
      t[k] = Body::load_tgt(tgt_geo + row * 8 * B + pt, B);
    }
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[k][o] = 0.0;
  }
  // the run's slots in order, id 0 skipped: q_rd the block to sum next,
  // q_wr the next to copy; uniform across the CTA
  const int64_t q_end = (int64_t)run_off[run + 1] * G;
  auto settle = [&](int64_t q) {
    while (q < q_end && pair_s[q] == 0) ++q;
    return q;
  };
  int64_t q_rd = settle((int64_t)run_off[run] * G), q_wr = q_rd;
  auto issue = [&](int f) {  // the block at q_wr into stage f % stages
    if (q_wr < q_end) {
      const double* blk = src_fm + (int64_t)pair_s[q_wr] * C * B;
      double* st = ring + (f % kExec64Stages) * B * kAos;
#pragma unroll
      for (int r = 0; r < Body::kRows; ++r) {
        for (int q = threadIdx.x; q < B; q += blockDim.x) {
          copy8_async(st + q * kAos + r, blk + r * B + q);
        }
      }
      q_wr = settle(q_wr + 1);
    }
    copy_commit();  // one group per block, empty past the end
  };
  for (int f = 0; f < kExec64Stages - 1; ++f) issue(f);
  for (int f = 0; q_rd < q_end; ++f) {
    issue(f + kExec64Stages - 1);  // its stage was read in iteration f - 1
    copy_wait<kExec64Stages - 1>();  // block f has landed
    __syncthreads();
    double* st = ring + (f % kExec64Stages) * B * kAos;
    if (!Body::kRawStage) {  // restage the rows whose staged value differs
      for (int q = threadIdx.x; q < B; q += blockDim.x) {
#pragma unroll
        for (int r = 0; r < Body::kRows; ++r) {
          st[q * kAos + r] = Body::staged(r, st[q * kAos + r]);
        }
      }
      __syncthreads();
    }
    if (i < nthr) block64<Body, kN>(st, B, t, acc);
    __syncthreads();  // the block is read
    q_rd = settle(q_rd + 1);
  }
  if (i >= nthr) return;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int pt = i + k * nthr;
    if (pt >= B) continue;
    double* o0 = out + row * od8 * B + pt;
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) o0[o * B] += acc[k][o];
  }
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
