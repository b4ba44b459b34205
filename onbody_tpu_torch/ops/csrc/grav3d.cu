// K1, K2, K4, K8-K12 with the grav3d body and their fp64 forms K1-f64
// and K4-f64 (one translation unit per workload, so the build compiles
// the workloads in parallel), and K13:
// K10 on the four ablated grav3d bodies of grav3d_ablate_body.cuh, entry
// points onbody_exec_ablate_<mode> (K10's arguments but the device run
// count: K13 runs on trimmed tables, so its launch passes null) and
// onbody_occupancy_ablate_<mode> (K10's occupancy report).
#include "entries.cuh"
#include "grav3d_ablate_body.cuh"
#include "grav3d_body.cuh"

ONBODY_ENTRIES(grav3d, onbody::Grav3d, onbody::Grav3dF64)

#define ONBODY_ABLATE(MODE, BODY)                                          \
  extern "C" int onbody_exec_ablate_##MODE(                                \
      const float* tgt_geo, const float* src_fm, float* out,               \
      const int* run_tgt, const int* run_off, const int* pair_s,           \
      int n_runs, int B, int C, int G, int od8, void* stream) {            \
    return onbody::launch_exec_fetch<BODY, false>(                         \
        tgt_geo, src_fm, out, run_tgt, run_off, pair_s, nullptr, n_runs, B,\
        C, G, od8, stream);                                                \
  }                                                                        \
  extern "C" int onbody_occupancy_ablate_##MODE(int B, int C, int G,       \
                                                int* info) {               \
    return onbody::fetch_occupancy<BODY, false>(B, C, info);               \
  }

ONBODY_ABLATE(dma, onbody::AblateDma)
ONBODY_ABLATE(d2, onbody::AblateD2)
ONBODY_ABLATE(norsqrt, onbody::AblateNoRsqrt)
ONBODY_ABLATE(full, onbody::AblateFull)

// Message for a code returned by any entry point of this library.
extern "C" const char* onbody_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
