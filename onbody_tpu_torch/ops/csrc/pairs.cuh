// Grouped pair executors, templated on the per-pair body (body.cuh), one
// instantiation per (workload, core): K1 (unpaired) and K2 (sibling-paired)
// fetch their source blocks by id; K8 and K9 (further down) compute the
// same sums from source blocks gathered contiguous per step.
//
// Replace onbody_tpu/ops/pallas_pairs.py:_exec_chunk with
// _body_interleaved (K1) and :_exec_chunk_t2 with _body_interleaved_t2
// (K2). The TPU kernels walk the step list sequentially on one core,
// keep the current target row resident in VMEM across a run of steps and
// hide the scalar-issued source DMAs behind the MXU work. Hopper runs
// blocks in parallel and in no order, so the sequential grid becomes one
// CTA per RUN of equal target rows (computed on the host side by the
// wrapper): each CTA owns its output row outright, keeps the sums in
// registers and writes the row once, with no atomics and a deterministic
// result.
//
// Inside a CTA each thread owns one target point of the row (two in K2:
// the same point of rows 2q and 2q+1). The CTA loops over its steps and
// their G source ids, stages each source block's rows in shared memory
// (Body::kRows * B floats) and every thread sums it. Source id 0 is the
// inert pad row and contributes exactly zero, so it is skipped; pad steps
// never form a run and are never visited (in K2 this is what keeps rows 0
// and 1, the root accumulator, untouched, for every body).
//
// What bounds it: a block of B sources is reused by B targets (2B in K2),
// so device-memory traffic is ~kRows*4/B bytes per pair and the kernel is
// bound by the SM's FP32/MUFU rates over the operations each pair needs
// (counted in the body's header; PERF.md gives the bound). This
// first version stages with plain loads and a barrier per block (no
// cp.async/TMA double buffering yet) and leaves the occupancy to the run
// count; both are later work.
//
// Offsets into the (NN, rows, B) arrays are 64-bit: at N = 1e8 NN*C*B
// reaches 2^31, and row*od8*B doubles again for vortgrad3d (od8 = 16).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "body.cuh"

namespace onbody {

template <class Body, bool kPaired>
__global__ void exec_runs(const float* __restrict__ tgt_geo,
                          const float* __restrict__ src_fm,
                          float* __restrict__ out,
                          const int* __restrict__ run_tgt,
                          const int* __restrict__ run_off,
                          const int* __restrict__ pair_s, int B, int C,
                          int G, int od8) {
  extern __shared__ float sm[];  // Body::kRows * B
  const int run = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool act = i < B;
  // K2 keys are parent ids q: the run covers rows 2q and 2q+1
  const int64_t row0 =
      kPaired ? 2 * (int64_t)run_tgt[run] : (int64_t)run_tgt[run];
  typename Body::Tgt t0{}, t1{};
  if (act) {
    const float* g0 = tgt_geo + row0 * 8 * B + i;
    t0 = Body::load_tgt(g0, B);
    if (kPaired) t1 = Body::load_tgt(g0 + 8 * (int64_t)B, B);
  }
  float a0[Body::kOut], a1[Body::kOut];
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o) a0[o] = a1[o] = 0.f;
  const int p_end = run_off[run + 1];
  for (int p = run_off[run]; p < p_end; ++p) {
    for (int j = 0; j < G; ++j) {
      const int s = pair_s[(int64_t)p * G + j];
      if (s == 0) continue;  // uniform across the CTA
      const float* src = src_fm + (int64_t)s * C * B;
      __syncthreads();  // the previous block's readers are done
      for (int k = threadIdx.x; k < B; k += blockDim.x) {
        Body::stage(src + k, B, sm + k, B);
      }
      __syncthreads();
      if (act) {
        if (kPaired) {
          block2<Body>(sm, B, B, t0, t1, a0, a1);
        } else {
          block<Body>(sm, B, B, t0, a0);
        }
      }
    }
  }
  if (act) {
    float* o0 = out + row0 * od8 * B + i;
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) o0[o * B] += a0[o];
    if (kPaired) {
      float* o1 = o0 + (int64_t)od8 * B;
#pragma unroll
      for (int o = 0; o < Body::kOut; ++o) o1[o * B] += a1[o];
    }
  }
}

constexpr int kExecMaxThreads = 256;

template <class Body, bool kPaired>
int launch_exec(const float* tgt_geo, const float* src_fm, float* out,
                const int* run_tgt, const int* run_off, const int* pair_s,
                int n_runs, int B, int C, int G, int od8, void* stream) {
  if (n_runs <= 0) return (int)cudaSuccess;
  const int threads = B < kExecMaxThreads ? B : kExecMaxThreads;
  const dim3 grid(n_runs, (B + threads - 1) / threads);
  const size_t smem = sizeof(float) * Body::kRows * B;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        exec_runs<Body, kPaired>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  exec_runs<Body, kPaired><<<grid, threads, smem, (cudaStream_t)stream>>>(
      tgt_geo, src_fm, out, run_tgt, run_off, pair_s, B, C, G, od8);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// K8 (unpaired) and K9 (sibling-paired): the executors on PRE-GATHERED
// sources. Replace onbody_tpu/ops/pallas_pairs.py:_exec_chunk_pre with
// _body_pre (K8) and :_exec_chunk_pre_t2 with _body_pre_t2 (K9).
//
// A torch row gather (ops/cuda_pairs.py:_pregather) has laid step p's G
// source blocks side by side at src_gathered + p*G*C*B, C rows of B
// floats each. The TPU kernels take that buffer as one pipelined block
// per sequential grid step; here, as in K1/K2, one CTA owns one RUN of
// equal target keys, keeps the sums in registers and adds them onto the
// output row once (a run cut by a chunk boundary continues in the next
// launch from that partial sum). What differs from K1/K2 is the fetch:
// the CTA is given the STEP indices of its run, not source ids, so the
// address of every block follows from the step alone (no dependent id
// load), a step's blocks are one contiguous stretch read coalesced, and
// several blocks are staged per barrier pair (as many as fit kPreStage
// bytes of shared memory). Each staged block is still summed into its own
// partial and added onto the row's sum in slot order, which is K1/K2's
// order: on the same groups K8 gives K1's result and K9 gives K2's.
//
// The kernels have no source ids, so they cannot see the inert pad row:
// n_slots[p] (or G when the pointer is null) says how many leading slots
// of step p to evaluate; the wrapper sets it to the last real slot, and a
// skipped slot holds the inert row, whose contribution is exactly zero.
// Bodies read rows 0..kRows-1 at row stride B inside a block of C rows, so
// the lean layout (C = kRows) and the layout padded to 8 rows both work.
//
// What bounds it: per step G*B*B pairs (twice that in K9) against
// G*C*B*4 gathered bytes read once, plus the gather pass outside that
// wrote them; at B = 128 the byte time of a light body (vort2d) is of the
// order of its operation time (PERF.md states both per instantiation).
// Offsets are 64-bit as above: a chunk stays under 2^31 floats, the
// row*od8*B output offsets at 1e8 do not.

constexpr int kPreStageBytes = 32 * 1024;

template <class Body, bool kPaired>
__global__ void exec_pre_runs(const float* __restrict__ tgt_geo,
                              const float* __restrict__ src_gathered,
                              float* __restrict__ out,
                              const int* __restrict__ run_tgt,
                              const int* __restrict__ run_off,
                              const int* __restrict__ steps,
                              const int* __restrict__ n_slots, int B, int C,
                              int G, int od8, int stage) {
  extern __shared__ float sm[];  // Body::kRows rows of stage * B floats
  const int run = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool act = i < B;
  const int64_t row0 =
      kPaired ? 2 * (int64_t)run_tgt[run] : (int64_t)run_tgt[run];
  typename Body::Tgt t0{}, t1{};
  if (act) {
    const float* g0 = tgt_geo + row0 * 8 * B + i;
    t0 = Body::load_tgt(g0, B);
    if (kPaired) t1 = Body::load_tgt(g0 + 8 * (int64_t)B, B);
  }
  float a0[Body::kOut], a1[Body::kOut];
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o) a0[o] = a1[o] = 0.f;
  const int sm_stride = stage * B;
  const int p_end = run_off[run + 1];
  for (int p = run_off[run]; p < p_end; ++p) {
    const float* src = src_gathered + (int64_t)steps[p] * G * C * B;
    const int n = n_slots ? n_slots[p] : G;  // uniform across the CTA
    for (int j0 = 0; j0 < n; j0 += stage) {
      const int cnt = (n - j0) < stage ? (n - j0) : stage;
      __syncthreads();  // the previous blocks' readers are done
      for (int k = threadIdx.x; k < cnt * B; k += blockDim.x) {
        const int j = k / B;
        const int col = k - j * B;
        Body::stage(src + (int64_t)(j0 + j) * C * B + col, B, sm + k,
                    sm_stride);
      }
      __syncthreads();
      if (act) {
        for (int j = 0; j < cnt; ++j) {
          if (kPaired) {
            block2<Body>(sm + j * B, sm_stride, B, t0, t1, a0, a1);
          } else {
            block<Body>(sm + j * B, sm_stride, B, t0, a0);
          }
        }
      }
    }
  }
  if (act) {
    float* o0 = out + row0 * od8 * B + i;
#pragma unroll
    for (int o = 0; o < Body::kOut; ++o) o0[o * B] += a0[o];
    if (kPaired) {
      float* o1 = o0 + (int64_t)od8 * B;
#pragma unroll
      for (int o = 0; o < Body::kOut; ++o) o1[o * B] += a1[o];
    }
  }
}

template <class Body, bool kPaired>
int launch_exec_pre(const float* tgt_geo, const float* src_gathered,
                    float* out, const int* run_tgt, const int* run_off,
                    const int* steps, const int* n_slots, int n_runs, int B,
                    int C, int G, int od8, void* stream) {
  if (n_runs <= 0) return (int)cudaSuccess;
  const int threads = B < kExecMaxThreads ? B : kExecMaxThreads;
  const dim3 grid(n_runs, (B + threads - 1) / threads);
  // blocks staged per barrier pair: what fits kPreStageBytes, 1..G
  const int block_bytes = (int)sizeof(float) * Body::kRows * B;
  int stage = kPreStageBytes / block_bytes;
  stage = stage < 1 ? 1 : (stage > G ? G : stage);
  const size_t smem = (size_t)stage * block_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        exec_pre_runs<Body, kPaired>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  exec_pre_runs<Body, kPaired><<<grid, threads, smem, (cudaStream_t)stream>>>(
      tgt_geo, src_gathered, out, run_tgt, run_off, steps, n_slots, B, C, G,
      od8, stage);
  return (int)cudaGetLastError();
}

}  // namespace onbody
