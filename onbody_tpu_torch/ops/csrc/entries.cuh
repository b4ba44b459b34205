// The plain C entry points of one (workload, core) instantiation:
//   onbody_exec_<INST>     K1, the unpaired grouped executor (pairs.cuh)
//   onbody_exec_t2_<INST>  K2, the sibling-paired executor (pairs.cuh)
//   onbody_direct_<INST>   K4, the direct sum over one split of the
//                          sources per CTA (direct.cuh)
//   onbody_direct_reduce_<INST>  K4's ordered reduction of the splits'
//                                partial sums (direct.cuh split_reduce
//                                on floats)
//   onbody_exec_pre_seg_<INST>     K8's segment kernel: the unpaired
//                                  executor on pre-gathered sources, one
//                                  CTA per segment of a run (pairs.cuh)
//   onbody_exec_pre_t2_seg_<INST>  K9's, its sibling-paired form
//   onbody_exec_pre_reduce_<INST>  K8/K9's and K12's ordered reduction of
//                                  the split runs' partial rows (rows 1
//                                  or 2), over the list of split runs
//   onbody_exec_dma_<INST>     K10, K1's sum with source blocks fetched
//                              by bulk asynchronous copies (pairs.cuh)
//   onbody_exec_dmap_<INST>    K11, K10 with adjacent ids bundled into
//                              one copy (pairs.cuh)
//   onbody_exec_static_<INST>  K12, K8's segment kernel with one step per
//                              segment (pairs.cuh)
//   onbody_occupancy_<INST>    K1/K2's, K10/K11/K12's and K8/K9's
//                              segment kernels' shared memory per CTA,
//                              resident CTAs per SM, ring stages,
//                              registers and local bytes per thread
//   onbody_direct_occupancy_<INST>  the same of K4's direct kernel
//   onbody_exec64_<INST>   K1-f64, K1 on double rows and sums (fp64.cuh),
//                          K1's arguments over doubles
//   onbody_direct64_<INST>         K4-f64, K4 in double (fp64.cuh)
//   onbody_direct64_tile_<INST>    K4-f64's targets a CTA (its split
//                                  planner's tile)
//   onbody_direct64_reduce_<INST>  K4-f64's ordered reduction
//                                  (split_reduce on doubles)
// The occupancy entry also reports K1-f64 (kind 7) and K4-f64 (kind 8).
// An instantiation is a (workload, core): BODY its fp32 body, BODY64 the
// same body in double (body64.cuh).
// K1, K2, K10 and K11 take the run count twice: n_runs_dev, the count in
// device memory (null: the eager wrappers' trimmed tables, n_runs runs),
// and n_runs, the grid (with n_runs_dev: the list's static capacity; CTAs
// at or past the count exit at once). The segment kernels of K8, K9 and
// K12 take their segment count so (n_seg_dev, n_seg), and the reduction
// its split-run count (n_split_dev, n_split; with n_split_dev, n_split is
// the grid's rows, which walk the count).
// Each returns cudaGetLastError() after its launch (0 on success); the
// ctypes wrappers (ops/cuda_lib.py) raise on anything else.
#pragma once

#include "direct.cuh"
#include "fp64.cuh"
#include "pairs.cuh"

namespace onbody {

// occupancy_of K1-f64 at B (kind 7) or of K4-f64 (kind 8)
template <class Body64>
int occupancy64(int kind, int B, int* info) {
  if (kind == 8) {
    return occupancy_of((const void*)direct64_kernel<Body64>,
                        Direct64Tile<Body64>::kThreads,
                        direct64_smem<Body64>(), kDirect64Stages, info);
  }
  int threads, grid_y;
  size_t smem;
  exec64_config<Body64>(B, &threads, &grid_y, &smem);
  return occupancy_of((const void*)exec64_runs<Body64>, threads, smem, 1,
                      info);
}

}  // namespace onbody

#define ONBODY_ENTRIES(INST, BODY, BODY64)                                 \
  extern "C" int onbody_exec_##INST(                                       \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      const int* n_runs_dev, int n_runs, int B, int C, int G,              \
      int od8, void* stream) {                                             \
    return onbody::launch_exec<BODY, false>(                               \
        tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs_dev,        \
        n_runs, B, C, G, od8, stream);                                     \
  }                                                                        \
  extern "C" int onbody_exec_t2_##INST(                                    \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      const int* n_runs_dev, int n_runs, int B, int C, int G,              \
      int od8, void* stream) {                                             \
    return onbody::launch_exec<BODY, true>(                                \
        tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs_dev,        \
        n_runs, B, C, G, od8, stream);                                     \
  }                                                                        \
  extern "C" int onbody_exec_pre_seg_##INST(                               \
      const float* tgt_geo, const float* src_gathered, float* out,         \
      float* partials, const int* run_tgt, const int* run_seg,             \
      const int* seg_run, const int* seg_off, const int* steps,            \
      const int* n_slots, const int* n_seg_dev, int n_seg, int B, int C,   \
      int G, int od8, void* stream) {                                      \
    return onbody::launch_exec_pre_seg<BODY, false>(                       \
        tgt_geo, src_gathered, out, partials, run_tgt, run_seg, seg_run,   \
        seg_off, steps, n_slots, n_seg_dev, n_seg, B, C, G, od8, stream);  \
  }                                                                        \
  extern "C" int onbody_exec_pre_t2_seg_##INST(                            \
      const float* tgt_geo, const float* src_gathered, float* out,         \
      float* partials, const int* run_tgt, const int* run_seg,             \
      const int* seg_run, const int* seg_off, const int* steps,            \
      const int* n_slots, const int* n_seg_dev, int n_seg, int B, int C,   \
      int G, int od8, void* stream) {                                      \
    return onbody::launch_exec_pre_seg<BODY, true>(                        \
        tgt_geo, src_gathered, out, partials, run_tgt, run_seg, seg_run,   \
        seg_off, steps, n_slots, n_seg_dev, n_seg, B, C, G, od8, stream);  \
  }                                                                        \
  extern "C" int onbody_exec_pre_reduce_##INST(                            \
      float* out, const float* partials, const int* run_tgt,               \
      const int* run_seg, const int* split_runs, const int* n_split_dev,   \
      int n_split, int rows, int B, int od8, void* stream) {               \
    return onbody::launch_reduce_segs<BODY>(out, partials, run_tgt,        \
                                            run_seg, split_runs,           \
                                            n_split_dev, n_split, rows, B, \
                                            od8, stream);                  \
  }                                                                        \
  extern "C" int onbody_exec_dma_##INST(                                   \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      const int* n_runs_dev, int n_runs, int B, int C, int G,              \
      int od8, void* stream) {                                             \
    return onbody::launch_exec_fetch<BODY, false>(                         \
        tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs_dev,        \
        n_runs, B, C, G, od8, stream);                                     \
  }                                                                        \
  extern "C" int onbody_exec_dmap_##INST(                                  \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      const int* n_runs_dev, int n_runs, int B, int C, int G,              \
      int od8, void* stream) {                                             \
    return onbody::launch_exec_fetch<BODY, true>(                          \
        tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs_dev,        \
        n_runs, B, C, G, od8, stream);                                     \
  }                                                                        \
  extern "C" int onbody_exec_static_##INST(                                \
      const float* tgt_geo, const float* src_gathered, float* out,         \
      float* partials, const int* run_tgt, const int* run_seg,             \
      const int* seg_run, const int* seg_off, const int* steps,            \
      const int* n_slots, const int* n_seg_dev, int n_seg, int B, int C,   \
      int G, int od8, void* stream) {                                      \
    return onbody::launch_exec_pre_seg<BODY, false>(                       \
        tgt_geo, src_gathered, out, partials, run_tgt, run_seg, seg_run,   \
        seg_off, steps, n_slots, n_seg_dev, n_seg, B, C, G, od8, stream);  \
  }                                                                        \
  extern "C" int onbody_occupancy_##INST(int kind, int B, int C, int G,    \
                                         int* info) {                      \
    return kind >= 7 ? onbody::occupancy64<BODY64>(kind, B, info)          \
                     : onbody::occupancy<BODY>(kind, B, C, G, info);       \
  }                                                                        \
  extern "C" int onbody_direct_##INST(const float* tgt, const float* src,  \
                                      float* dst, int M, int S,            \
                                      int splits, void* stream) {          \
    return onbody::launch_direct<BODY>(tgt, src, dst, M, S, splits,        \
                                       stream);                            \
  }                                                                        \
  extern "C" int onbody_direct_reduce_##INST(float* out,                   \
                                             const float* partials, int M, \
                                             int splits, void* stream) {   \
    return onbody::launch_split_reduce<float, BODY::kOut>(                 \
        out, partials, M, splits, stream);                                 \
  }                                                                        \
  extern "C" int onbody_direct_occupancy_##INST(int* info) {               \
    return onbody::occupancy_of((const void*)onbody::direct_kernel<BODY>,  \
                                onbody::kDirectThreads,                    \
                                onbody::direct_smem<BODY>(),               \
                                onbody::kDirectStages, info);              \
  }                                                                        \
  extern "C" int onbody_exec64_##INST(                                     \
      const double* tgt_geo, const double* src_fm, double* out,            \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      const int* n_runs_dev, int n_runs, int B, int C, int G,              \
      int od8, void* stream) {                                             \
    return onbody::launch_exec64<BODY64>(tgt_geo, src_fm, out, run_tgt,    \
                                         run_off, pair_s, n_runs_dev,      \
                                         n_runs, B, C, G, od8, stream);    \
  }                                                                        \
  extern "C" int onbody_direct64_##INST(const double* tgt,                 \
                                        const double* src, double* dst,    \
                                        int M, int S, int splits,          \
                                        void* stream) {                    \
    return onbody::launch_direct64<BODY64>(tgt, src, dst, M, S, splits,    \
                                           stream);                        \
  }                                                                        \
  extern "C" int onbody_direct64_tile_##INST() {                          \
    return onbody::Direct64Tile<BODY64>::kThreads *                       \
           onbody::Direct64Tile<BODY64>::kTgts;                            \
  }                                                                        \
  extern "C" int onbody_direct64_reduce_##INST(double* out,                \
                                               const double* partials,     \
                                               int M, int splits,          \
                                               void* stream) {             \
    return onbody::launch_split_reduce<double, BODY64::kOut>(              \
        out, partials, M, splits, stream);                                 \
  }
