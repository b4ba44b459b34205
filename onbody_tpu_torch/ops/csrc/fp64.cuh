// The fp64 executors of the accuracy tier, templated on a double body
// (body64.cuh): K1-f64, the grouped executor fetching source blocks by
// id (exec64_runs), and K4-f64, the direct sum over target tiles x
// source splits (direct64_kernel), whose splits direct.cuh's
// split_reduce adds in split order.
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
// reciprocal as one MUFU and Newton's steps (body64.cuh, mufu.cuh), with
// no range check and no slow-path call. CTAs of at most
// kExec64Threads threads (a row of B 256 is one CTA of 128). A block's
// pairs take far longer than its copy, so two stages hide it, and
// against three they take a third less shared memory, so more CTAs fit
// an SM (vort3d's 6, not 4).
// K4-f64 is K4's grid and ring on K1-f64's pair loop (below).
//
// No atomics and no warp-level code, so the host emulation
// (tests/test_torch_csrc_host.py, which swaps async_copy.cuh for
// synchronous copies) checks them as it checks the fp32 kernels. The
// order of sums is the fp32 kernels': per target a block's (chunk's)
// partial in source order, partials added in block order, K4-f64's
// splits added in split order by split_reduce, so two calls agree bit
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
      Body::pair(s, t[k], part[k]);
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

// K4-f64: K4 (direct.cuh direct_kernel) carried into double. K4's grid
// and split plan (target tiles of kThreads x kTgts x source splits of
// whole chunks of kChunk, split fastest; ops/cuda_direct.py plan_splits,
// splits_for(..., "direct64")); K1-f64's pair loop: each thread owns kTgts
// targets (i, i + blockDim.x, ... of its tile), the chunk is staged
// source by source in the aos64 layout and summed by block64 (LDS.128
// broadcasts, each read serving all of a thread's targets); the chunks
// come through a cp.async ring of kDirect64Stages, a double a copy (the
// copy transposes the feature-major rows), so chunk f + 1 lands while
// chunk f is summed; a body whose staged rows differ rewrites them after
// the copy lands, as exec64_runs does. Inputs targets (PD+1, M) and
// sources (C, S) feature-major in double; output (M, OD), or with splits
// the scratch (splits, M, OD) that split_reduce (direct.cuh) sums in
// split order.
//
// What held the first form back, and what this one does: a chunk
// staged synchronously as kRows double rows (a barrier, the loads, a
// barrier, then the pairs; kRows scalar shared loads a source), the
// library's rsqrt (a range check and a slow-path call a pair) and
// division (5 DFMA and a call), sr^2 added after |d|^2, and 8 bytes of
// spill in grav3d. Now the ring overlaps the copies with the pairs, a
// source is aos64 / 2 broadcast loads, the RM core is one MUFU and
// Newton's DFMA with the radii in the FMA chain (body64.cuh). The tile
// (Direct64Tile, by body) was measured at 128 and 256 threads, one and
// two targets a thread and 256 and 512 sources a chunk
// (scripts/k4_sweep.py; PERF.md, the K4-f64 redesign): 256 sources
// (512 cost the vortex bodies resident CTAs); two targets a thread of 256
// for the RM bodies but vort2d's, which spills 16 bytes at 256 threads
// and takes 128; one target a thread of 256 for the exp and v2 cores,
// whose library calls hold twice the accumulators' registers at two (162
// registers, one CTA an SM, for vortgrad3d).
constexpr int kDirect64Chunk = 256;
constexpr int kDirect64Stages = 2;

// A K4-f64 tile: threads a CTA, targets a thread, sources a chunk
template <int kThreads_, int kTgts_, int kChunk_ = kDirect64Chunk>
struct Direct64TileOf {
  static constexpr int kThreads = kThreads_;
  static constexpr int kTgts = kTgts_;
  static constexpr int kChunk = kChunk_;
};

// The tile of each body (the library reports its targets a CTA to the
// wrapper's split planner: onbody_direct64_tile_<INST>)
template <class Body>
struct Direct64Tile : Direct64TileOf<256, 2> {};
template <>
struct Direct64Tile<Vort2dF64<CoreRmF64>> : Direct64TileOf<128, 2> {};
template <template <class> class B>
struct Direct64Tile<B<CoreExpF64>> : Direct64TileOf<256, 1> {};
template <template <class> class B>
struct Direct64Tile<B<CoreV2F64>> : Direct64TileOf<256, 1> {};

// Dynamic shared memory of a K4-f64 launch: the ring of staged chunks.
template <class Body, class Tile = Direct64Tile<Body>>
constexpr size_t direct64_smem() {
  return sizeof(double) * kDirect64Stages * Tile::kChunk * aos64<Body>();
}

template <class Body, class Tile = Direct64Tile<Body>>
__global__ void __launch_bounds__(Tile::kThreads)
    direct64_kernel(const double* __restrict__ tgt,
                    const double* __restrict__ src,
                    double* __restrict__ dst, int M, int S, int splits) {
  constexpr int kAos = aos64<Body>();
  constexpr int kChunk = Tile::kChunk;
  constexpr int kStage = kChunk * kAos;  // doubles of one ring stage
  constexpr int kN = Tile::kTgts;
  extern __shared__ __align__(16) float smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);  // kDirect64Stages
  const int split = blockIdx.x % splits;
  const int64_t tile = blockIdx.x / splits;
  const int64_t i0 = tile * blockDim.x * kN + threadIdx.x;
  typename Body::Tgt t[kN];
  double acc[kN][Body::kOut];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int64_t i = i0 + k * blockDim.x;
    t[k] = typename Body::Tgt{};
    if (i < M) t[k] = Body::load_tgt(tgt + i, M);
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[k][o] = 0.0;
  }
  // split j sums chunks [j * chunks / splits, (j + 1) * chunks / splits)
  const int64_t chunks = ((int64_t)S + kChunk - 1) / kChunk;
  const int64_t s0 = split * chunks / splits * kChunk;
  const int64_t s_end = (split + 1) * chunks / splits * kChunk;
  const int64_t s1 = s_end < S ? s_end : S;
  const int n_chunks = s1 > s0 ? (int)((s1 - s0 + kChunk - 1) / kChunk) : 0;
  auto chunk_len = [&](int f) {
    const int64_t left = s1 - s0 - (int64_t)f * kChunk;
    return left < kChunk ? (int)left : kChunk;
  };
  auto issue = [&](int f) {  // chunk f into stage f % kDirect64Stages
    if (f < n_chunks) {
      const double* c0 = src + s0 + (int64_t)f * kChunk;
      double* st = ring + (f % kDirect64Stages) * kStage;
      const int n = chunk_len(f);
#pragma unroll
      for (int r = 0; r < Body::kRows; ++r) {
        for (int q = threadIdx.x; q < n; q += blockDim.x) {
          copy8_async(st + q * kAos + r, c0 + (int64_t)r * S + q);
        }
      }
    }
    copy_commit();  // one group per chunk, empty past the end
  };
  for (int f = 0; f < kDirect64Stages - 1; ++f) issue(f);
  for (int f = 0; f < n_chunks; ++f) {  // uniform across the CTA
    issue(f + kDirect64Stages - 1);  // its stage was read in iteration f - 1
    copy_wait<kDirect64Stages - 1>();  // chunk f has landed
    __syncthreads();
    double* st = ring + (f % kDirect64Stages) * kStage;
    const int n = chunk_len(f);
    if (!Body::kRawStage) {  // restage the rows whose staged value differs
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
#pragma unroll
        for (int r = 0; r < Body::kRows; ++r) {
          st[q * kAos + r] = Body::staged(r, st[q * kAos + r]);
        }
      }
      __syncthreads();
    }
    if (i0 < M) block64<Body, kN>(st, n, t, acc);
    __syncthreads();  // the stage is read: it may be refilled
  }
  double* d = dst + (int64_t)split * M * Body::kOut;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int64_t i = i0 + k * blockDim.x;
    if (i >= M) continue;
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) d[i * Body::kOut + o] = acc[k][o];
  }
}

template <class Body, class Tile = Direct64Tile<Body>>
int launch_direct64(const double* tgt, const double* src, double* dst,
                    int M, int S, int splits, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  constexpr int kTile = Tile::kThreads * Tile::kTgts;
  const int tiles = (M + kTile - 1) / kTile;
  const size_t smem = direct64_smem<Body, Tile>();
  // always: an occupancy query may have set another limit
  const cudaError_t err = cudaFuncSetAttribute(
      direct64_kernel<Body, Tile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = tiles * splits;
  direct64_kernel<Body, Tile><<<blocks, Tile::kThreads, smem,
                                (cudaStream_t)stream>>>(tgt, src, dst, M, S,
                                                        splits);
  return (int)cudaGetLastError();
}

}  // namespace onbody
