// The asynchronous copies of the executors (pairs.cuh), of K4 and K4-f64
// and of their split reduction (direct.cuh, fp64.cuh). K10 and K11: one
// thread starts a 1D bulk copy (Hopper's copy engine, cp.async.bulk) of
// contiguous global memory into shared memory, and the copy reports its
// bytes to an mbarrier in shared memory that the readers wait on. The
// K1/K2 and K8/K9 tile (and K4, direct.cuh; K1-f64 and K4-f64, fp64.cuh,
// a double a copy): every thread copies single floats with cp.async (4
// bytes, so a copy can transpose a block into its staged layout),
// commits them as one group per staged block and waits until at most N
// groups are pending; the split reduction copies 16 bytes a cp.async.
// Nothing else lives here: the host emulation of the sources
// (tests/test_torch_csrc_host.py) swaps this one header for a
// synchronous version.
//
// Contract: addresses and sizes are multiples of 16 bytes; each mbarrier
// is initialised with an arrival count of 1, and each use of it is one
// expect_copy() (the arrival, with the bytes to come) plus the copies of
// those bytes, waited on once with the parity of that use.
#pragma once

#include <stdint.h>

namespace onbody {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread, before any use; then a __syncthreads() publishes it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The arrival of this use of `bar`, announcing `bytes` to come.
__device__ __forceinline__ void expect_copy(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Orders this CTA's earlier ordinary accesses of shared memory before
// later copies into it (the copy engine is another memory proxy).
__device__ __forceinline__ void fence_before_copy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst_smem,
                                          const float* src_gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst_smem)),
      "l"(src_gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Blocks until the use of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One float from global to shared memory, asynchronously (LDGSTS).
__device__ __forceinline__ void copy4_async(float* dst_smem,
                                            const float* src_gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst_smem)),
               "l"(src_gmem)
               : "memory");
}

// One double from global to shared memory, asynchronously (LDGSTS.64;
// K1-f64 and K4-f64, fp64.cuh).
__device__ __forceinline__ void copy8_async(double* dst_smem,
                                            const double* src_gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst_smem)),
               "l"(src_gmem)
               : "memory");
}

// kBytes (4, 8 or 16) from global to shared memory, asynchronously, both
// addresses aligned to kBytes (the split reduction, direct.cuh); 16
// bytes bypass L1 (LDGSTS.128 .cg: the slabs are read once).
template <int kBytes>
__device__ __forceinline__ void copy_bytes_async(void* dst_smem,
                                                 const void* src_gmem) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst_smem)),
                 "l"(src_gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst_smem)),
                 "l"(src_gmem), "n"(kBytes)
                 : "memory");
  }
}

// Closes this thread's copies started since the last commit into a group.
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Blocks until at most kPending of this thread's groups are incomplete;
// a __syncthreads() after it makes every thread's copies visible.
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace onbody
