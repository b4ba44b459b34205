// K1, K2, K4, K8-K12 with the grav3d body (one translation unit per
// workload, so the build compiles the workloads in parallel).
#include "entries.cuh"
#include "grav3d_body.cuh"

ONBODY_ENTRIES(grav3d, onbody::Grav3d)

// Message for a code returned by any entry point of this library.
extern "C" const char* onbody_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
