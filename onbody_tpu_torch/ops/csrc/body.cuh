// The per-pair bodies' common contract and the block loops built on it.
//
// A body (grav3d_body.cuh, vort2d_body.cuh, vort3d_body.cuh,
// vortgrad3d_body.cuh) is a struct that provides
//   kRows            rows of a source block it stages in shared memory;
//   kOut             outputs per target (the workload's OD);
//   kUnroll/kUnroll2 unroll of block() and block2();
//   Tgt load_tgt(g, stride)  a target from a feature-major column
//                    [pos | radius] whose rows lie `stride` floats apart;
//   staged(r, v)     the staged value of fm row r, with any per-source
//                    term of the core precomputed; kRawStage when it is
//                    v for every row;
//   stage(col, stride, sm, sm_stride)  one source point: reads the
//                    reference's lean feature-major rows (ops/kernels.py
//                    featurize) at `col` and writes its kRows staged rows;
//   Src load_src(sm, stride)  one staged source from shared memory;
//   pair(src, tgt, acc)  adds the pair's contribution into acc[kOut].
// Everything is fp32 FMA work per pair (no factored moments): there is
// no precision tier to choose, and every sum is a plain fp32 sum.
#pragma once

#include <stdint.h>

#include "core.cuh"

namespace onbody {

// Sum of the first n staged sources on one target. The block's sum is kept
// in a local partial and added onto `acc` once, so long runs are summed
// two-level (within a block, then across blocks) rather than in one long
// fp32 chain.
template <class Body>
__device__ __forceinline__ void block(const float* __restrict__ sm,
                                      int stride, int n,
                                      const typename Body::Tgt& t,
                                      float (&acc)[Body::kOut]) {
  float part[Body::kOut];
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o) part[o] = 0.f;
#pragma unroll (Body::kUnroll)
  for (int q = 0; q < n; ++q) {
    Body::pair(Body::load_src(sm + q, stride), t, part);
  }
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o) acc[o] += part[o];
}

// The same on two targets at once: each staged source is read once from
// shared memory and serves both (the sibling-paired executor).
template <class Body>
__device__ __forceinline__ void block2(const float* __restrict__ sm,
                                       int stride, int n,
                                       const typename Body::Tgt& t0,
                                       const typename Body::Tgt& t1,
                                       float (&acc0)[Body::kOut],
                                       float (&acc1)[Body::kOut]) {
  float p0[Body::kOut], p1[Body::kOut];
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o) p0[o] = p1[o] = 0.f;
#pragma unroll (Body::kUnroll2)
  for (int q = 0; q < n; ++q) {
    const typename Body::Src s = Body::load_src(sm + q, stride);
    Body::pair(s, t0, p0);
    Body::pair(s, t1, p1);
  }
#pragma unroll
  for (int o = 0; o < Body::kOut; ++o) {
    acc0[o] += p0[o];
    acc1[o] += p1[o];
  }
}

}  // namespace onbody
