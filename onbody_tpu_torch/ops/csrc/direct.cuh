// Direct all-pairs sum, kernel K4, templated on the per-pair body
// (body.cuh): one instantiation per (workload, core). A CTA sums one tile
// of targets over one split of the sources (direct_kernel); when the
// sources were split, direct_reduce adds the splits' partial sums in
// split order.
//
// Replaces onbody_tpu/ops/pallas_direct.py:direct_pallas (_body, its
// pallas_call at :70). The TPU kernel walks a (targets/256) x
// (sources/1024) grid and carries each target tile's sum in VMEM along
// the sequential source axis, over inputs padded to whole tiles. Ragged
// edges are masked here instead (targets past M do no work, the last
// chunk stops at the split's end).
//
// Inputs are feature-major, as the executors read them: targets (PD+1, M)
// [pos | radius] and sources (C, S) in the reference's lean featurize rows;
// the wrapper (ops/cuda_direct.py) lays them out. Output is point-major
// (M, OD); with splits, each split writes its own (M, OD) slab of a
// scratch (splits, M, OD) that direct_reduce sums into the output.
//
// What bounds it: S*M evaluations of the body, each needing the FP32 and
// MUFU operations counted in the body's header (grav3d 12 + 1, vort3d
// 17 + 1, vortgrad3d 37 + 1, vort2d 8 + 1 with the RM core), over the
// SMs' FP32 (128 lanes) and MUFU (16 lanes) rates. Bytes are no limit: a
// staged source serves a whole tile of targets, so device memory sees
// about kRows * 4 / kDirectTile bytes per pair.
//
// What the design does about what held the first K4 (one CTA of 256
// targets, one target per thread, a synchronous source loop) back:
// 1. Too few CTAs. M / 256 CTAs left most SMs idle at the check's M
//    (33 CTAs for 132 SMs at M = 8224). The grid is now (target tiles x
//    source splits), split fastest: when the tiles cannot fill two waves
//    of resident CTAs, the wrapper cuts the sources into splits of whole
//    chunks (the smallest count that gives two waves, capped by the
//    scratch), each CTA sums its split into registers and writes a
//    partial slab, and direct_reduce adds the slabs in split order. One
//    split writes the output directly, with no scratch and no second
//    launch. The order of sums is fixed (within a chunk, across the
//    chunks of a split, across splits), so the result is deterministic
//    on a card and shape; no atomics.
// 2. Too many shared loads per pair. block() read each staged row with a
//    scalar load per pair (kRows loads). The pair loop is now K8/K9's
//    block_aos<Body, kDirectTgts>: sources staged source by source in
//    float4s (aos_floats<Body>() floats each), one or two 16-byte
//    broadcast loads per source, each serving both targets of a thread.
// 3. No overlap of loads and work. Chunks are staged by 4-byte cp.async
//    (the copy also transposes them to the staged layout) into a ring of
//    kDirectStages chunks, so the next chunk lands while this one is
//    summed; a body whose staged rows differ rewrites them in place after
//    the copy lands (Body::staged), as K8 does.
// Two targets per thread and the transposing copy were measured against
// four targets per thread and a source-major copy made by the wrapper,
// and kept (PERF.md section 6, the K4 redesign).
// No warp-level code, so the host emulation
// (tests/test_torch_csrc_host.py) still checks these kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "body.cuh"

namespace onbody {

constexpr int kDirectThreads = 256;
constexpr int kDirectTgts = 2;  // targets per thread
constexpr int kDirectTile = kDirectThreads * kDirectTgts;  // targets per CTA
constexpr int kDirectChunk = 512;  // sources per staged chunk
constexpr int kDirectStages = 2;   // chunks in flight per CTA

// Starts the asynchronous copy of sources [c0, c0 + n) from their
// feature-major rows (S floats apart) into the staged layout at st:
// source q's row r at st[q * aos_floats + r]. Every thread copies its
// share, one float a copy, consecutive threads on consecutive sources.
template <class Body>
__device__ __forceinline__ void stage_chunk_async(
    const float* __restrict__ src, int64_t S, int64_t c0, int n, float* st) {
  constexpr int kAos = aos_floats<Body>();
#pragma unroll
  for (int r = 0; r < Body::kRows; ++r) {
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      copy4_async(st + q * kAos + r, src + r * S + c0 + q);
    }
  }
}

template <class Body>
__global__ void __launch_bounds__(kDirectThreads)
    direct_kernel(const float* __restrict__ tgt,
                  const float* __restrict__ src, float* __restrict__ dst,
                  int M, int S, int splits) {
  constexpr int kAos = aos_floats<Body>();
  constexpr int kStage = kDirectChunk * kAos;  // floats of one ring stage
  extern __shared__ __align__(16) float ring[];  // kDirectStages chunks
  const int split = blockIdx.x % splits;
  const int64_t tile = blockIdx.x / splits;
  // thread i owns targets i + k * blockDim.x (k < kDirectTgts) of its
  // tile
  const int64_t i0 = tile * blockDim.x * kDirectTgts + threadIdx.x;
  typename Body::Tgt t[kDirectTgts];
  float acc[kDirectTgts][Body::kOut];
#pragma unroll
  for (int k = 0; k < kDirectTgts; ++k) {
    const int64_t i = i0 + k * blockDim.x;
    t[k] = typename Body::Tgt{};
    if (i < M) t[k] = Body::load_tgt(tgt + i, M);
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[k][o] = 0.f;
  }
  // split j sums chunks [j * chunks / splits, (j + 1) * chunks / splits)
  const int64_t chunks = ((int64_t)S + kDirectChunk - 1) / kDirectChunk;
  const int64_t s0 = split * chunks / splits * kDirectChunk;
  const int64_t s_end = (split + 1) * chunks / splits * kDirectChunk;
  const int64_t s1 = s_end < S ? s_end : S;
  const int n_chunks =
      s1 > s0 ? (int)((s1 - s0 + kDirectChunk - 1) / kDirectChunk) : 0;
  auto chunk_len = [&](int f) {
    const int64_t left = s1 - s0 - (int64_t)f * kDirectChunk;
    return left < kDirectChunk ? (int)left : kDirectChunk;
  };
  auto issue = [&](int f) {  // chunk f into stage f % kDirectStages
    if (f < n_chunks) {
      stage_chunk_async<Body>(
          src, S, s0 + (int64_t)f * kDirectChunk, chunk_len(f),
          ring + (f % kDirectStages) * kStage);
    }
    copy_commit();  // one group per chunk, empty past the end
  };
  for (int f = 0; f < kDirectStages - 1; ++f) issue(f);
  for (int f = 0; f < n_chunks; ++f) {  // uniform across the CTA
    issue(f + kDirectStages - 1);  // its stage was read in iteration f - 1
    copy_wait<kDirectStages - 1>();  // chunk f has landed
    __syncthreads();
    float* st = ring + (f % kDirectStages) * kStage;
    const int n = chunk_len(f);
    if (!Body::kRawStage) {
      for (int q = threadIdx.x; q < n; q += blockDim.x) {
#pragma unroll
        for (int r = 0; r < Body::kRows; ++r) {
          st[q * kAos + r] = Body::staged(r, st[q * kAos + r]);
        }
      }
      __syncthreads();
    }
    if (i0 < M) block_aos<Body, kDirectTgts>(st, n, t, acc);
    __syncthreads();  // the stage is read: it may be refilled
  }
  float* d = dst + (int64_t)split * M * Body::kOut;
#pragma unroll
  for (int k = 0; k < kDirectTgts; ++k) {
    const int64_t i = i0 + k * blockDim.x;
    if (i >= M) continue;
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) d[i * Body::kOut + o] = acc[k][o];
  }
}

// Dynamic shared memory of a K4 launch: the ring of staged chunks.
template <class Body>
constexpr size_t direct_smem() {
  return sizeof(float) * kDirectStages * kDirectChunk * aos_floats<Body>();
}

// One launch over M targets and S sources cut into `splits` splits of
// whole chunks (their chunk counts differ by one at most): dst is the
// output (M, OD) for one split, else the scratch (splits, M, OD).
template <class Body>
int launch_direct(const float* tgt, const float* src, float* dst, int M,
                  int S, int splits, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int tiles = (M + kDirectTile - 1) / kDirectTile;
  const size_t smem = direct_smem<Body>();
  // always: an occupancy query may have set another limit
  const cudaError_t err = cudaFuncSetAttribute(
      direct_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = tiles * splits;
  direct_kernel<Body><<<blocks, kDirectThreads, smem,
                        (cudaStream_t)stream>>>(tgt, src, dst, M, S, splits);
  return (int)cudaGetLastError();
}

// K4's ordered reduction: out[e] = the sum over splits of partials[s][e]
// in split order, one thread per output value (M * kOut of them). Bound by
// bytes: the partial slabs read once, the output written once.
template <class Body>
__global__ void direct_reduce(float* __restrict__ out,
                              const float* __restrict__ partials, int M,
                              int splits) {
  const int64_t n = (int64_t)M * Body::kOut;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float* p = partials + e;
  float v = p[0];
  int s = 1;
  for (; s + 4 <= splits; s += 4) {  // four loads in flight, added in order
    const float a = p[s * n], b = p[(s + 1) * n];
    const float c = p[(s + 2) * n], d = p[(s + 3) * n];
    v += a;
    v += b;
    v += c;
    v += d;
  }
  for (; s < splits; ++s) v += p[s * n];
  out[e] = v;
}

constexpr int kDirectReduceThreads = 256;

template <class Body>
int launch_direct_reduce(float* out, const float* partials, int M,
                         int splits, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int64_t n = (int64_t)M * Body::kOut;
  const int blocks = (int)((n + kDirectReduceThreads - 1) /
                           kDirectReduceThreads);
  direct_reduce<Body><<<blocks, kDirectReduceThreads, 0,
                        (cudaStream_t)stream>>>(out, partials, M, splits);
  return (int)cudaGetLastError();
}

}  // namespace onbody
