// Direct all-pairs sum, kernel K4, templated on the per-pair body
// (body.cuh): one instantiation per (workload, core). A CTA sums one tile
// of targets over one split of the sources (direct_kernel); when the
// sources were split, split_reduce adds the splits' partial sums in
// split order (it serves K4-f64 too, on doubles).
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
// scratch (splits, M, OD) that split_reduce sums into the output.
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
//    partial slab, and split_reduce adds the slabs in split order. One
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

// The ordered split reduction of K4 and K4-f64 (fp64.cuh): out[e] = the
// sum over splits of partials[s][e] (the scratch (splits, M, OD), n = M *
// OD values a slab) in split order, p[0] + p[1] + ... added one by one,
// so it is bit for bit ops/cuda_direct.py reduce_splits_torch. No TPU
// kernel of its own: it is the carry of direct_pallas's sum along its
// sequential source axis, which K4's grid runs in parallel.
//
// What bounds it: bytes, the slabs read once and the output written once.
// Reaching the card's rate takes some 2 MB in flight (3.35 TB/s at ~0.6
// us); one thread a value, as the first form did, had at most 4 loads in
// flight and one CTA for every 256 values (65-386 CTAs at K4's check
// shapes), a few hundred KB in all. Here a CTA takes a tile of `cols`
// values and all their splits: its threads copy the tile's rows, every
// split's, into shared memory with 16-byte cp.async copies (4 floats or
// 2 doubles; one value a copy where a slab's rows are not 16-byte
// aligned), all in flight at once, then thread c adds vector c's column
// in split order from shared memory (split_reduce). The tile is the
// widest (one vector a thread) whose grid still has kSplitReduceCtas
// CTAs, so the grid fills the SMs even where the slabs are few values
// and many splits (K4-f64's check: 8000-12000 values, 99-149 splits,
// tiles of 16-32 doubles; K4's (a): 16448-24672 values). Splits past the
// rows a CTA stages (kSplitReduceSmem) take further passes, the running
// sums kept in shared memory (`carry`). Where the slabs hold at least
// kSplitReduceStreamCols vectors (the 1e6 checks' 2 or 3 slabs of 1-1.5M
// values; K4's (a) and K4-f64's check for vortgrad3d; the 1e7 row's),
// enough threads own a vector each for the plain streaming pass
// (split_reduce_stream): each thread loads its vector of
// kSplitReduceUnroll splits at once, 16-byte loads, and adds them in
// order. No atomics and no warp-level code. At every shape chip_smoke.py
// times it (K4's (a)-(c), K4-f64's checks) it is no slower than
// torch.sum(partials, 0) on the same slabs (PERF.md, the reduction's row).
constexpr int kSplitReduceThreads = 128;
constexpr int kSplitReduceSmem = 64 * 1024;  // staged bytes a CTA at most
constexpr int kSplitReduceCtas = 264;        // 2 CTAs a SM of 132
constexpr int kSplitReduceStreamCols = 16384;
constexpr int kSplitReduceUnroll = 16;

// kVec values of T, 16-byte aligned when they make 16 bytes
template <class T, int kVec>
struct alignas(sizeof(T) * kVec) SplitPack {
  T v[kVec];
};

template <class T, int kVec>
__global__ void __launch_bounds__(kSplitReduceThreads)
    split_reduce(T* __restrict__ out, const T* __restrict__ partials,
                 int64_t n, int splits, int cols, int rows) {
  using Pack = SplitPack<T, kVec>;
  extern __shared__ __align__(16) float smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // rows x cols staged values
  T* carry = st + (int64_t)rows * cols;     // the running sums, cols
  const int64_t e0 = (int64_t)blockIdx.x * cols;
  if (e0 >= n) return;
  const int nv = (int)((n - e0 < cols ? n - e0 : cols) / kVec);  // vectors
  const int vc = cols / kVec;  // vectors a staged row
  for (int s0 = 0; s0 < splits; s0 += rows) {
    const int nr = splits - s0 < rows ? splits - s0 : rows;
    __syncthreads();  // the previous pass's rows are read
    for (int i = threadIdx.x; i < nr * vc; i += blockDim.x) {
      const int r = i / vc, c = i - r * vc;
      if (c < nv) {
        copy_bytes_async<sizeof(Pack)>(
            st + r * cols + c * kVec,
            partials + (int64_t)(s0 + r) * n + e0 + c * kVec);
      }
    }
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      const Pack* col = reinterpret_cast<const Pack*>(st) + c;
      Pack acc = s0 == 0 ? col[0] : reinterpret_cast<Pack*>(carry)[c];
      // unrolled so that the shared loads run ahead of the chain of adds
#pragma unroll 8
      for (int r = s0 == 0 ? 1 : 0; r < nr; ++r) {
        const Pack p = col[r * vc];
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc.v[k] += p.v[k];
      }
      if (s0 + nr < splits) {
        reinterpret_cast<Pack*>(carry)[c] = acc;
      } else {
        reinterpret_cast<Pack*>(out + e0)[c] = acc;
      }
    }
  }
}

// One thread a vector of the n values: its kSplitReduceUnroll splits'
// loads at once, then their adds in split order.
template <class T, int kVec>
__global__ void __launch_bounds__(kSplitReduceThreads)
    split_reduce_stream(T* __restrict__ out,
                        const T* __restrict__ partials, int64_t n,
                        int splits) {
  using Pack = SplitPack<T, kVec>;
  const int64_t nv = n / kVec;  // vectors a slab
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nv) return;
  const Pack* p = reinterpret_cast<const Pack*>(partials) + c;
  Pack acc = p[0];
  int s = 1;
  constexpr int kUnroll = kSplitReduceUnroll;
  for (; s + kUnroll <= splits; s += kUnroll) {
    Pack v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = p[(s + u) * nv];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc.v[k] += v[u].v[k];
    }
  }
  for (; s < splits; ++s) {
    const Pack v = p[s * nv];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc.v[k] += v.v[k];
  }
  reinterpret_cast<Pack*>(out)[c] = acc;
}

template <class T, int kVec, int kStreamCols, int kSmem>
int launch_split_reduce_as(T* out, const T* partials, int64_t n, int splits,
                           void* stream) {
  constexpr int kThreads = kSplitReduceThreads;
  if (n / kVec >= kStreamCols) {
    const int blocks = (int)((n / kVec + kThreads - 1) / kThreads);
    split_reduce_stream<T, kVec><<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(out, partials, n,
                                                           splits);
    return (int)cudaGetLastError();
  }
  int cols = kVec * kThreads;
  while (cols > kVec && (n + cols - 1) / cols < kSplitReduceCtas) cols /= 2;
  const int fit = kSmem / (int)(cols * sizeof(T));
  const int rows = splits < fit ? splits : fit;
  const size_t smem = sizeof(T) * (size_t)(rows + 1) * cols;
  const int blocks = (int)((n + cols - 1) / cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_reduce<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  split_reduce<T, kVec><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      out, partials, n, splits, cols, rows);
  return (int)cudaGetLastError();
}

// One launch over the (splits, M, kOut) slabs of T: 16-byte loads where
// every slab row starts 16-byte aligned, else one value a load.
// kStreamCols is the vectors a slab from which the streaming pass runs
// and kSmem the staged pass's bytes a CTA at most (the host tests force
// the staged pass's several passes with them).
template <class T, int kOut, int kStreamCols = kSplitReduceStreamCols,
          int kSmem = kSplitReduceSmem>
int launch_split_reduce(T* out, const T* partials, int M, int splits,
                        void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  const int64_t n = (int64_t)M * kOut;
  if (n % kVec == 0 &&
      ((uintptr_t)out | (uintptr_t)partials) % 16 == 0) {
    return launch_split_reduce_as<T, kVec, kStreamCols, kSmem>(
        out, partials, n, splits, stream);
  }
  return launch_split_reduce_as<T, 1, kStreamCols, kSmem>(out, partials, n,
                                                          splits, stream);
}

}  // namespace onbody
