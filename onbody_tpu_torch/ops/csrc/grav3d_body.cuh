// grav3d per-pair body (see body.cuh for the contract).
//
// Replaces the tile body onbody_tpu/ops/kernels.py:_grav3d_tile_fm (with
// _d2_fm "outer"). The reference factors the source sum into MXU
// contractions over mass-premultiplied rows; on Hopper the pair chain is
// plain fp32 FMA work on the SM cores, so the body evaluates d = s - t
// per pair directly (ongrav3d.cpp:44-58):
//     w = m * rsqrt(|d|^2 + sr^2)^3,   acc += w * d.
// Per pair the arithmetic needs 12 FP32-pipe operations and 1 MUFU: 3 FADD
// for d, 3 FFMA for |d|^2 + sr^2, 3 FMUL for m * rinv^3, 3 FFMA into the
// sums, and the rsqrt. The kernels are bound by the SM's FP32 rate, not
// by memory, once a source block sits in shared memory. (The compiler
// issues more: chip_smoke.py prints the SASS counts beside these.)
// Gravity hard-codes the RM denominator, so there is no core parameter.
#pragma once

#include "body.cuh"

namespace onbody {

struct Grav3d {
  // staged rows: x, y, z, sr^2, m (featurize already stores sr^2)
  static constexpr int kRows = 5;
  static constexpr int kOut = 3;

  struct Tgt {
    float x, y, z;
  };
  struct Src {
    float x, y, z, sr2, m;
  };

  __device__ static Tgt load_tgt(const float* g, int64_t stride) {
    return {g[0], g[stride], g[2 * stride]};
  }

  // the staged value of fm row r: the rows are staged as they are
  static constexpr bool kRawStage = true;
  __device__ static float staged(int, float v) { return v; }

  __device__ static Src load_src(const float* sm, int stride) {
    return {sm[0], sm[stride], sm[2 * stride], sm[3 * stride],
            sm[4 * stride]};
  }

  __device__ static void pair(const Src& s, const Tgt& t,
                              float (&acc)[kOut]) {
    const float dx = s.x - t.x;
    const float dy = s.y - t.y;
    const float dz = s.z - t.z;
    const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, s.sr2)));
    const float rinv = rsqrtf(r2);
    const float w = s.m * rinv * rinv * rinv;
    acc[0] = fmaf(w, dx, acc[0]);
    acc[1] = fmaf(w, dy, acc[1]);
    acc[2] = fmaf(w, dz, acc[2]);
  }
};

}  // namespace onbody
