// vort2d per-pair body, kernel K5 (see body.cuh for the contract).
//
// Replaces the tile body onbody_tpu/ops/kernels.py:_vort2d_tile_fm. The
// reference folds the strength multiply into an MXU contraction over
// premultiplied rows and recombines; here every pair is evaluated as the
// reference scalar kernel writes it (onvort2d.cpp:44-57), d = t - s:
//     w = ss * core_2d(|d|^2, sr, tr),   u -= w * dy,   v += w * dx.
// vort2d is the one kernel that reads the target radius: tr sits in row
// 2 (= pd) of the target column. With the RM core a pair needs 8
// FP32-pipe operations and 1 MUFU: 2 FADD for d, 1 FADD for sr^2 + tr^2,
// 2 FFMA for |d|^2 + that, 1 FMUL for ss * rcp, 2 FFMA into the sums, and
// the reciprocal; the two pipes take the same time. CoreRm::c2 issues
// just that (core.cuh): the FMA chain and one MUFU.RCP. With the
// exponential core (CoreExp, ops/core_funcs.py:exp_2d) a pair needs 21
// FP32-pipe operations and 3 MUFU: 2 FADD for d, 2 for |d|^2, 1 FADD for
// |d|^2 + 1e-6, 1 FADD and 1 FMNMX for max(sr^2 + tr^2, TINY), 1 FMUL for
// reld2, expf's range reduction (5) and 1 FFMA for 1 - e with its
// product by 2^n (vort3d_body.cuh), 1 FMUL for ood2 (1 - e) (far keeps
// ood2: a predicated write), 2 FSETP for the thresholds and 1 FSEL for
// the close branch, 1 FMUL for ss c and 2 FFMA into the sums; two
// reciprocals and expf's EX2: bound by the MUFU rate, 3 / 16 against 21 /
// 128 a lane.
#pragma once

#include "body.cuh"

namespace onbody {

template <class Core>
struct Vort2d {
  // staged rows: x, y, sr^2, ss
  static constexpr int kRows = 4;
  static constexpr int kOut = 2;

  struct Tgt {
    float x, y, tr2;
  };
  struct Src {
    float x, y, sr2, ss;
  };

  __device__ static Tgt load_tgt(const float* g, int64_t stride) {
    const float tr = g[2 * stride];
    return {g[0], g[stride], tr * tr};
  }

  // the staged value of fm row r (rows x, y, sr, ss)
  static constexpr bool kRawStage = false;
  __device__ static float staged(int r, float v) {
    return r == 2 ? v * v : v;
  }

  __device__ static Src load_src(const float* sm, int stride) {
    return {sm[0], sm[stride], sm[2 * stride], sm[3 * stride]};
  }

  __device__ static void pair(const Src& s, const Tgt& t,
                              float (&acc)[kOut]) {
    const float dx = t.x - s.x;
    const float dy = t.y - s.y;
    const float w = s.ss * Core::c2(dx, dy, s.sr2, t.tr2);
    acc[0] = fmaf(-w, dy, acc[0]);
    acc[1] = fmaf(w, dx, acc[1]);
  }
};

}  // namespace onbody
