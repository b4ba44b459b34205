// Direct all-pairs sum, kernel K4, templated on the per-pair body
// (body.cuh): one instantiation per (workload, core).
//
// Replaces onbody_tpu/ops/pallas_direct.py:direct_pallas (_body). The TPU
// kernel walks a (targets/256) x (sources/1024) grid and carries each
// target tile's sum in VMEM along the sequential source axis, over
// inputs padded to whole tiles. Here one CTA owns 256 targets, keeps their
// sums in registers and loops over the sources itself, staging 1024 at a
// time in shared memory (Body::kRows rows). Ragged edges are masked in the
// kernel (targets past M do no work, the last chunk stops at S) instead of
// padded.
//
// Inputs are feature-major, as the executors read them: targets (PD+1, M)
// [pos | radius] and sources (C, S) in the reference's lean featurize rows;
// the wrapper (ops/cuda_direct.py) lays them out. Output is point-major
// (M, OD).
//
// What bounds it: S*M pair evaluations of the body; sources are read once
// per CTA (M/256 times in all), so the kernel is bound by the SM's
// FP32/MUFU rates. Each chunk is summed into a local partial first
// (block<Body>), which keeps the fp32 chain short at S = 1e6.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "body.cuh"

namespace onbody {

constexpr int kDirectThreads = 256;
constexpr int kDirectChunk = 1024;

template <class Body>
__global__ void __launch_bounds__(kDirectThreads)
    direct_kernel(const float* __restrict__ tgt,
                  const float* __restrict__ src, float* __restrict__ out,
                  int M, int S) {
  __shared__ float sm[Body::kRows * kDirectChunk];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool act = i < M;
  typename Body::Tgt t{};
  if (act) t = Body::load_tgt(tgt + i, M);
  float acc[Body::kOut];
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o) acc[o] = 0.f;
  for (int c0 = 0; c0 < S; c0 += kDirectChunk) {
    const int n = (S - c0) < kDirectChunk ? (S - c0) : kDirectChunk;
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      Body::stage(src + c0 + k, S, sm + k, kDirectChunk);
    }
    __syncthreads();
    if (act) block<Body>(sm, kDirectChunk, n, t, acc);
  }
  if (act) {
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) out[i * Body::kOut + o] = acc[o];
  }
}

template <class Body>
int launch_direct(const float* tgt, const float* src, float* out, int M,
                  int S, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int blocks = (M + kDirectThreads - 1) / kDirectThreads;
  direct_kernel<Body><<<blocks, kDirectThreads, 0, (cudaStream_t)stream>>>(
      tgt, src, out, M, S);
  return (int)cudaGetLastError();
}

}  // namespace onbody
