// K13: the grav3d body ablated step by step, for cost attribution inside
// K10's executor (see body.cuh for the contract).
//
// Replaces scripts/exp_kernel.py:run with make_variant(mode): K10's
// schedule (pallas_pairs.py:_body, both banks of G async copies) with the
// grav3d body stubbed by mode. Here each mode is exec_fetch_runs<Body,
// false> (pairs.cuh) on one of the bodies below, so the attribution is
// taken on the port's real executor: the same run table, the same ring of
// bulk copies, the same shared-memory staging. Every mode stages the same
// five rows (x, y, z, sr, m), so every mode fetches the same bytes and
// the differences between modes are arithmetic. With d = s - t and sr =
// row 3 read the way the script reads it (it squares the row; the
// production grav3d rows already store sr^2 there):
//   AblateFull     sum m * (|d|^2 + sr^2)^(-3/2) * d  into rows 0-2;
//   AblateNoRsqrt  sum m * (|d|^2 + sr^2) * d         into rows 0-2;
//   AblateD2       sum |d|^2                           into row 0;
//   AblateDma      no pair loop: each thread adds the lanes of its two
//                  target points in rows 0-2 of every staged block into
//                  rows 0-2.
// The script's dma and d2 overwrite the output with prev + ... on every
// step; here every mode is a sum over the run's steps, so kernel and twin
// (cuda_pairs.exec_ablate_torch) have one exact meaning.
//
// Operations a pair needs, FP32 pipe + MUFU (the bounds in chip_smoke.py
// ABLATE_OPS read these lines):
//   full:    needs 12 FP32-pipe operations and 1 MUFU (Grav3d's count;
//            sr^2 is squared once per source when the block is staged);
//   norsqrt: needs 10 FP32-pipe operations and 0 MUFU: 3 FADD for d,
//            3 FFMA for |d|^2 + sr^2, 1 FMUL for m * r2, 3 FFMA into the
//            sums;
//   d2:      needs 6 FP32-pipe operations and 0 MUFU: 3 FADD for d,
//            3 FFMA chained into the sum;
//   dma:     needs 0 FP32-pipe operations and 0 MUFU per pair; its bound
//            is the bytes it moves.
#pragma once

#include "grav3d_body.cuh"

namespace onbody {

// The staging all four modes share: the five rows as they are, row 3
// squared by the modes that read sr^2 (kRawStage false: K10 squares it in
// the staged block once per source).
template <bool kSquareSr>
struct AblateStage {
  static constexpr int kRows = 5;
  static constexpr bool kRawStage = !kSquareSr;

  using Tgt = Grav3d::Tgt;
  using Src = Grav3d::Src;

  __device__ static Tgt load_tgt(const float* g, int64_t stride) {
    return Grav3d::load_tgt(g, stride);
  }
  __device__ static float staged(int r, float v) {
    return (kSquareSr && r == 3) ? v * v : v;
  }
  __device__ static Src load_src(const float* sm, int stride) {
    return Grav3d::load_src(sm, stride);
  }
};

struct AblateFull : AblateStage<true> {
  static constexpr int kOut = 3;
  __device__ static void pair(const Src& s, const Tgt& t,
                              float (&acc)[kOut]) {
    Grav3d::pair(s, t, acc);
  }
};

struct AblateNoRsqrt : AblateStage<true> {
  static constexpr int kOut = 3;
  __device__ static void pair(const Src& s, const Tgt& t,
                              float (&acc)[kOut]) {
    const float dx = s.x - t.x;
    const float dy = s.y - t.y;
    const float dz = s.z - t.z;
    const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, s.sr2)));
    const float w = s.m * r2;
    acc[0] = fmaf(w, dx, acc[0]);
    acc[1] = fmaf(w, dy, acc[1]);
    acc[2] = fmaf(w, dz, acc[2]);
  }
};

struct AblateD2 : AblateStage<false> {
  static constexpr int kOut = 1;
  __device__ static void pair(const Src& s, const Tgt& t,
                              float (&acc)[kOut]) {
    const float dx = s.x - t.x;
    const float dy = s.y - t.y;
    const float dz = s.z - t.z;
    acc[0] = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, acc[0])));
  }
};

// no pair(): block_rows<AblateDma, 2> below replaces the pair loop
struct AblateDma : AblateStage<false> {
  static constexpr int kOut = 3;
};

// The dma mode's block: no pair loop, the lanes of the thread's own two
// target points in rows 0-2 of the staged block (K10's thread i of a
// row's B / 2 owns points i and i + B / 2, pairs.cuh exec_fetch_runs),
// each into its point's sums.
template <>
__device__ __forceinline__ void block_rows<AblateDma, 2>(
    const float* __restrict__ sm, int B, const AblateDma::Tgt (&)[2],
    float (&acc)[2][AblateDma::kOut]) {
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int o = 0; o < AblateDma::kOut; ++o) {
      acc[j][o] += sm[o * B + i + j * (B / 2)];
    }
  }
}

}  // namespace onbody
