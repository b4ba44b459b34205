// Regularized core functions of the vortex bodies, one struct per
// core_func value; a body takes its core as a template parameter, so each
// (body, core) pair is its own instantiation.
//
// The same branches as onbody_tpu/ops/core_funcs.py (and the port's copy,
// ops/core_funcs.py), evaluated as selects over safe operands: the guards
// keep the d2 = 0 self-interaction of a leaf against itself finite, and a
// branch that is not selected never reaches the result.
//
// A per-source term that does not depend on the target is computed once
// when the source block is staged (aux3), not per pair: sr^2 for RM,
// corefac = 1/max(sr^3, TINY) for the exponential core, sr^4 for
// Vatistas (3D only). The 2D cores take d = t - s, sr^2 and tr^2 (both
// cores need the radii; RM folds them into |d|^2 by FMA).
//
// K5 (vort2d's RM core), K6-v2 (the Vatistas core) and the exponential
// core take their per-pair reciprocals and square roots from mufu.cuh:
// one MUFU each, no IEEE fix-up and no slow-path branch in the pair loop.
// The 3D RM core keeps the build's rsqrtf, and the exponential core its
// expf (its range reduction and MUFU.EX2, no branch) and its once-a-source
// aux3.
#pragma once

#include "mufu.cuh"

namespace onbody {

constexpr float kTiny = 1e-30f;

// Rosenhead-Moore (CoreFunc2d.hpp:24-36, CoreFunc3d.hpp:27-41).
struct CoreRm {
  __device__ static float aux3(float sr) { return sr * sr; }

  // (d^2 + sr^2)^-3/2
  __device__ static float c3(float d2, float sr2) {
    const float rinv = rsqrtf(d2 + sr2);
    return rinv * rinv * rinv;
  }

  // r3 and bbb = -3 r3 / r2, the division as a product with rinv^2
  __device__ static void c3g(float d2, float sr2, float& r3, float& bbb) {
    const float rinv = rsqrtf(d2 + sr2);
    const float rinv2 = rinv * rinv;
    r3 = rinv2 * rinv;
    bbb = -3.f * r3 * rinv2;
  }

  // 1/(|d|^2 + sr^2 + tr^2), K5: 1 FADD, 2 FFMA and one MUFU.RCP
  // (rcp_approx). The operand is a sum of squares, so >= 0; it is
  // subnormal only for radii and a distance all below 1.1e-19, where the
  // flush gives 1/0 = inf, the division's own result at d = 0 with zero
  // radii.
  __device__ static float c2(float dx, float dy, float sr2, float tr2) {
    return rcp_approx(fmaf(dy, dy, fmaf(dx, dx, sr2 + tr2)));
  }
};

// Compact exponential (CoreFunc2d.hpp:85-103, CoreFunc3d.hpp:136-177).
// Each reciprocal and square root of a pair is one MUFU (mufu.cuh), on
// operands its guards keep normal: d3 = max(d^3, TINY), max(d^2, TINY),
// d^2 + 1e-6 and max(sr^2 + tr^2, TINY) are at least 1e-30, and the
// square root of d^2 reads a subnormal d^2 as 0 (d = 0 where the IEEE
// form gives 1e-19 or less; d3 is TINY either way, and only the close
// branch's bbb, -1.5 dist corefac^2, sees dist). The 2D core takes reld2
// = corefac (d^2 + 1e-6), the reference's corefac * d^2
// (onbody_tpu/ops/core_funcs.py:38) up to the 1e-6, for its corefac /
// ood2: the two round differently by an ulp or two, and the MUFU's 1 ulp
// (2^-22.9 relative for the square root) moves reld by as much, so a pair
// within a few ulp of a threshold (reld 0.001 or 16) can take the other
// branch, which differs by 5e-4 of its term at 0.001 and by exp(-16) at
// 16. The reference's selects are kept: at d^2 = 0 the close branch
// returns corefac whatever the others hold.
struct CoreExp {
  __device__ static float aux3(float sr) {
    return 1.f / fmaxf(sr * sr * sr, kTiny);
  }

  // MUFU.SQRT, MUFU.RCP and expf's MUFU.EX2
  __device__ static float c3(float d2, float corefac) {
    const float dist = sqrt_approx(d2);
    const float d3 = fmaxf(d2 * dist, kTiny);
    const float ood3 = rcp_approx(d3);
    const float reld3 = d3 * corefac;
    const float mid = ood3 * (1.f - expf(-fminf(reld3, 87.f)));
    const float out = reld3 > 16.f ? ood3 : mid;
    return reld3 < 0.001f ? corefac : out;
  }

  // MUFU.SQRT, 2 MUFU.RCP and expf's MUFU.EX2
  __device__ static void c3g(float d2, float corefac, float& r3,
                             float& bbb) {
    const float dist = sqrt_approx(d2);
    const float d3 = fmaxf(d2 * dist, kTiny);
    const float reld3 = d3 * corefac;
    const float dm3 = rcp_approx(d3);
    const float dm2 = rcp_approx(fmaxf(d2, kTiny));
    const float e = expf(-fminf(reld3, 87.f));
    const float r3_mid = (1.f - e) * dm3;
    const bool far = reld3 > 16.f;
    const bool close = reld3 < 0.001f;
    r3 = close ? corefac : (far ? dm3 : r3_mid);
    bbb = close ? -1.5f * dist * corefac * corefac
                : (far ? -3.f * dm3 * dm2
                       : 3.f * (corefac * e - r3_mid) * dm2);
  }

  // 2 MUFU.RCP and expf's MUFU.EX2
  __device__ static float c2(float dx, float dy, float sr2, float tr2) {
    const float d2e = fmaf(dy, dy, dx * dx) + 1e-6f;
    const float ood2 = rcp_approx(d2e);
    const float corefac = rcp_approx(fmaxf(sr2 + tr2, kTiny));
    const float reld2 = corefac * d2e;
    const float mid = ood2 * (1.f - expf(-reld2));
    const float out = reld2 > 16.f ? ood2 : mid;
    return reld2 < 0.001f ? corefac : out;
  }
};

// Vatistas n = 2 (CoreFunc3d.hpp:185-198), the 3D velocity core only, K6-v2:
// (d^4 + sr^4)^-3/4 as rsqd * sqrt(rsqd), rsqd = rsqrt(max(d^4 + sr^4,
// TINY)), the guard of v2_3d, so the d2 = 0 self-interaction stays finite
// for any radius. One MUFU.RSQ and one MUFU.SQRT (mufu.cuh): the guard
// keeps the rsqrt's operand normal, and rsqd lies in [5.4e-20, 1e15] (0
// when d^4 overflows, whose sqrt is 0 as before), so neither flush acts.
struct CoreV2 {
  __device__ static float aux3(float sr) {
    const float s2 = sr * sr;
    return s2 * s2;
  }

  __device__ static float c3(float d2, float s4) {
    const float rsqd = rsqrt_approx(fmaxf(fmaf(d2, d2, s4), kTiny));
    return rsqd * sqrt_approx(rsqd);
  }
};

}  // namespace onbody
