// The per-pair bodies' common contract and the block loops built on it.
//
// A body (grav3d_body.cuh, vort2d_body.cuh, vort3d_body.cuh,
// vortgrad3d_body.cuh) is a struct that provides
//   kRows            rows of a source block it stages in shared memory
//                    (the reference's lean feature-major rows,
//                    ops/kernels.py featurize);
//   kOut             outputs per target (the workload's OD);
//   Tgt load_tgt(g, stride)  a target from a feature-major column
//                    [pos | radius] whose rows lie `stride` floats apart;
//   staged(r, v)     the staged value of fm row r, with any per-source
//                    term of the core precomputed; kRawStage when it is
//                    v for every row;
//   Src load_src(v, stride)  one staged source, its rows `stride` apart;
//   pair(src, tgt, acc)  adds the pair's contribution into acc[kOut].
// Everything is fp32 FMA work per pair (no factored moments): there is
// no precision tier to choose, and every sum is a plain fp32 sum.
#pragma once

#include <stdint.h>

#include "core.cuh"

namespace onbody {

// Floats a source takes in the staged layout of the K1/K2 and K8/K9 tile
// (pairs.cuh exec_tile): its kRows values side by side, padded to whole
// float4s.
template <class Body>
__host__ __device__ constexpr int aos_floats() {
  return (Body::kRows + 3) / 4 * 4;
}

// The pair loop of K1/K2, K8/K9, K12 and K4: the first n sources of a
// block staged source by source (aos_floats<Body>() each, 16-byte aligned)
// against kN targets.
// One source is brought in by one 16-byte broadcast load per four rows
// (one for vort2d's 4 rows, two for the 5 and 7 of the 3D bodies) and
// serves all kN targets, so the shared loads per pair fall from kRows to
// (kRows / 4 rounded up) / kN. Each target sums the block into its own
// partial in source order and adds it onto acc once, so long runs are
// summed two-level (within a block, then across blocks) rather than in
// one long fp32 chain: the executors' order of sums.
template <class Body, int kN>
__device__ __forceinline__ void block_aos(const float* __restrict__ sm, int n,
                                          const typename Body::Tgt (&t)[kN],
                                          float (&acc)[kN][Body::kOut]) {
  constexpr int kVec = aos_floats<Body>() / 4;
  float part[kN][Body::kOut];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) part[k][o] = 0.f;
  }
#pragma unroll 2
  for (int q = 0; q < n; ++q) {
    const float4* p = reinterpret_cast<const float4*>(sm) + q * kVec;
    float v[4 * kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float4 f = p[c];
      v[4 * c] = f.x;
      v[4 * c + 1] = f.y;
      v[4 * c + 2] = f.z;
      v[4 * c + 3] = f.w;
    }
    const typename Body::Src s = Body::load_src(v, 1);
#pragma unroll
    for (int k = 0; k < kN; ++k) Body::pair(s, t[k], part[k]);
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[k][o] += part[k][o];
  }
}

// The pair loop of K10/K11 (pairs.cuh exec_fetch_runs): the B sources of a
// block as a bulk copy lands it, kRows rows of B floats (row r of source q at
// sm[r * B + q]; B a multiple of 4, sm 16-byte aligned), against kN targets.
// Rather than transpose the block into block_aos's layout, each row is read
// where it lies: one broadcast float4 load per row brings four whole sources,
// and each serves all kN targets, so the shared loads per pair fall from
// kRows (one load a row) to kRows / (4 * kN) (kRows / 8 for the executors'
// two targets). Four sources a load spill in no body, and two measured
// slower; the loop is unrolled twice, so the next four sources' loads issue
// while these are summed (faster than once, or than prefetching them by hand;
// PERF.md §6). Each target sums the block into its own partial in source
// order and adds it onto acc once: per target, block_aos's order of sums, so
// K10 and K11 give K1's bits.
template <class Body, int kN>
__device__ __forceinline__ void block_rows(const float* __restrict__ sm,
                                           int B,
                                           const typename Body::Tgt (&t)[kN],
                                           float (&acc)[kN][Body::kOut]) {
  float part[kN][Body::kOut];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) part[k][o] = 0.f;
  }
#pragma unroll 2
  for (int q = 0; q < B; q += 4) {
    float v[4][Body::kRows];  // v[c][r]: row r of source q + c
#pragma unroll
    for (int r = 0; r < Body::kRows; ++r) {
      const float4 f = *reinterpret_cast<const float4*>(sm + r * B + q);
      v[0][r] = f.x;
      v[1][r] = f.y;
      v[2][r] = f.z;
      v[3][r] = f.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const typename Body::Src s = Body::load_src(v[c], 1);
#pragma unroll
      for (int k = 0; k < kN; ++k) Body::pair(s, t[k], part[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) acc[k][o] += part[k][o];
  }
}

}  // namespace onbody
