// The plain C entry points of one (workload, core) instantiation:
//   onbody_exec_<INST>     K1, the unpaired grouped executor (pairs.cuh)
//   onbody_exec_t2_<INST>  K2, the sibling-paired executor (pairs.cuh)
//   onbody_direct_<INST>   K4, the direct sum (direct.cuh)
//   onbody_exec_pre_<INST>     K8, the unpaired executor on pre-gathered
//                              sources (pairs.cuh)
//   onbody_exec_pre_t2_<INST>  K9, its sibling-paired form (pairs.cuh)
//   onbody_exec_dma_<INST>     K10, K1's sum with source blocks fetched
//                              by bulk asynchronous copies (pairs.cuh)
//   onbody_exec_dmap_<INST>    K11, K10 with adjacent ids bundled into
//                              one copy (pairs.cuh)
//   onbody_exec_static_<INST>  K12, one output row per pre-gathered step
//                              (pairs.cuh)
//   onbody_occupancy_<INST>    K10/K11/K12's shared memory per CTA,
//                              resident CTAs per SM and ring stages
// Each returns cudaGetLastError() after its launch (0 on success); the
// ctypes wrappers (ops/cuda_lib.py) raise on anything else.
#pragma once

#include "direct.cuh"
#include "pairs.cuh"

#define ONBODY_ENTRIES(INST, BODY)                                         \
  extern "C" int onbody_exec_##INST(                                       \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      int n_runs, int B, int C, int G, int od8, void* stream) {            \
    return onbody::launch_exec<BODY, false>(tgt_geo, src_fm, out, run_tgt, \
                                            run_off, pair_s, n_runs, B, C, \
                                            G, od8, stream);               \
  }                                                                        \
  extern "C" int onbody_exec_t2_##INST(                                    \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      int n_runs, int B, int C, int G, int od8, void* stream) {            \
    return onbody::launch_exec<BODY, true>(tgt_geo, src_fm, out, run_tgt,  \
                                           run_off, pair_s, n_runs, B, C,  \
                                           G, od8, stream);                \
  }                                                                        \
  extern "C" int onbody_exec_pre_##INST(                                   \
      const float* tgt_geo, const float* src_gathered, float* out,         \
      const int* run_tgt, const int* run_off, const int* steps,            \
      const int* n_slots, int n_runs, int B, int C, int G, int od8,        \
      void* stream) {                                                      \
    return onbody::launch_exec_pre<BODY, false>(                           \
        tgt_geo, src_gathered, out, run_tgt, run_off, steps, n_slots,      \
        n_runs, B, C, G, od8, stream);                                     \
  }                                                                        \
  extern "C" int onbody_exec_pre_t2_##INST(                                \
      const float* tgt_geo, const float* src_gathered, float* out,         \
      const int* run_tgt, const int* run_off, const int* steps,            \
      const int* n_slots, int n_runs, int B, int C, int G, int od8,        \
      void* stream) {                                                      \
    return onbody::launch_exec_pre<BODY, true>(                            \
        tgt_geo, src_gathered, out, run_tgt, run_off, steps, n_slots,      \
        n_runs, B, C, G, od8, stream);                                     \
  }                                                                        \
  extern "C" int onbody_exec_dma_##INST(                                   \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      int n_runs, int B, int C, int G, int od8, void* stream) {            \
    return onbody::launch_exec_fetch<BODY, false>(                         \
        tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs, B, C, G,   \
        od8, stream);                                                      \
  }                                                                        \
  extern "C" int onbody_exec_dmap_##INST(                                  \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      int n_runs, int B, int C, int G, int od8, void* stream) {            \
    return onbody::launch_exec_fetch<BODY, true>(                          \
        tgt_geo, src_fm, out, run_tgt, run_off, pair_s, n_runs, B, C, G,   \
        od8, stream);                                                      \
  }                                                                        \
  extern "C" int onbody_exec_static_##INST(                                \
      const float* tgt_geo, const float* src_gathered, float* rows,        \
      const int* step_tgt, const int* steps, const int* n_slots,           \
      int n_steps, int B, int C, int G, int od8, void* stream) {           \
    return onbody::launch_exec_static<BODY>(tgt_geo, src_gathered, rows,   \
                                            step_tgt, steps, n_slots,      \
                                            n_steps, B, C, G, od8,         \
                                            stream);                       \
  }                                                                        \
  extern "C" int onbody_occupancy_##INST(int kind, int B, int C, int G,    \
                                         int* info) {                      \
    return onbody::occupancy<BODY>(kind, B, C, G, info);                   \
  }                                                                        \
  extern "C" int onbody_direct_##INST(const float* tgt, const float* src,  \
                                      float* out, int M, int S,            \
                                      void* stream) {                      \
    return onbody::launch_direct<BODY>(tgt, src, out, M, S, stream);       \
  }
