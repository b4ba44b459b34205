// vortgrad3d per-pair body, kernel K7 (see body.cuh for the contract).
//
// Replaces the tile body onbody_tpu/ops/kernels.py:_vortgrad3d_tile_fm
// with _vortgrad_combine_2d. The reference contracts 6 velocity and 24
// gradient moment rows on the MXU and recombines them per target; that
// gradient contraction cancels across sources, so it is clamped to the
// full-mantissa '6xt' tier (kernels.py:727-732). Here every pair is
// evaluated as the reference scalar kernel writes it
// (onvortgrad3d.cpp:45-79), d = t - s, in plain fp32:
//     (r3, bbb) = core_3d_grads(|d|^2, sr),   o = w x d,
//     vel += r3 o,   A[a][b] += bbb o_a d_b  (+ the r3 epsilon terms),
// laid out out[3 + 3b + a] = A[a][b]. Twelve sums per target (24 per
// thread in the paired executor, plus the per-block partials). With the
// RM core a pair needs 37 FP32-pipe operations and 1 MUFU: 3 FADD for d,
// 3 FFMA for |d|^2 + sr^2, 4 FMUL for r3 and bbb, 6 for o, 3 FFMA into
// vel, 3 FMUL for bbb o_a, 9 FFMA into A, 6 FFMA for the epsilon terms,
// and the rsqrt; bound by the FP32 rate. With the exponential core
// (CoreExp, ops/core_funcs.py:exp_3d_grads) a pair needs 56 FP32-pipe
// operations and 4 MUFU: 3 FADD for d, 3 for |d|^2, 1 FMUL and 1 FMNMX
// for d3, 1 FMUL for reld3, 1 FMNMX for max(|d|^2, TINY), 1 FMNMX for
// min(reld3, 87), expf's range reduction (5, vort3d_body.cuh) and its
// FMUL by 2^n (e is used twice), 1 FADD and 1 FMUL for r3_mid (far keeps
// dm3: a predicated write), 2 FSETP for the thresholds and 1 FSEL for
// r3's close branch, 7 for bbb (3 FMUL close, 1 far, an FFMA and an FMUL
// mid, and one FMUL by dm2 for far and mid alike, the branches taken by
// predicated writes), 6 for o, 3 FFMA into vel, 3 FMUL for bbb o_a, 9
// FFMA into A and 6 FFMA for the epsilon terms; the sqrt, two
// reciprocals and expf's EX2.
#pragma once

#include "body.cuh"

namespace onbody {

template <class Core>
struct Vortgrad3d {
  // staged rows: x, y, z, Core::aux3(sr), wx, wy, wz
  static constexpr int kRows = 7;
  static constexpr int kOut = 12;

  struct Tgt {
    float x, y, z;
  };
  struct Src {
    float x, y, z, aux, wx, wy, wz;
  };

  __device__ static Tgt load_tgt(const float* g, int64_t stride) {
    return {g[0], g[stride], g[2 * stride]};
  }

  // the staged value of fm row r (rows x, y, z, sr, wx, wy, wz)
  static constexpr bool kRawStage = false;
  __device__ static float staged(int r, float v) {
    return r == 3 ? Core::aux3(v) : v;
  }

  __device__ static Src load_src(const float* sm, int stride) {
    return {sm[0],          sm[stride],     sm[2 * stride], sm[3 * stride],
            sm[4 * stride], sm[5 * stride], sm[6 * stride]};
  }

  __device__ static void pair(const Src& s, const Tgt& t,
                              float (&acc)[kOut]) {
    const float d[3] = {t.x - s.x, t.y - s.y, t.z - s.z};
    const float d2 = fmaf(d[2], d[2], fmaf(d[1], d[1], d[0] * d[0]));
    float r3, bbb;
    Core::c3g(d2, s.aux, r3, bbb);
    const float o[3] = {fmaf(s.wy, d[2], -s.wz * d[1]),
                        fmaf(s.wz, d[0], -s.wx * d[2]),
                        fmaf(s.wx, d[1], -s.wy * d[0])};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc[a] = fmaf(r3, o[a], acc[a]);
      const float bo = bbb * o[a];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        acc[3 + 3 * b + a] = fmaf(bo, d[b], acc[3 + 3 * b + a]);
      }
    }
    // epsilon terms (reference kernels.py:234-243): A[a][b] gains
    // -eps_abc r3 w_c
    const float rx = r3 * s.wx, ry = r3 * s.wy, rz = r3 * s.wz;
    acc[3 + 0 + 1] += rz;   // A[1][0]
    acc[3 + 0 + 2] -= ry;   // A[2][0]
    acc[3 + 3 + 0] -= rz;   // A[0][1]
    acc[3 + 3 + 2] += rx;   // A[2][1]
    acc[3 + 6 + 0] += ry;   // A[0][2]
    acc[3 + 6 + 1] -= rx;   // A[1][2]
  }
};

}  // namespace onbody
