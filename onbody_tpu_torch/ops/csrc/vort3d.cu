// K1, K2, K4, K8-K12 with the vort3d body K6, for the RM, exp and
// Vatistas (v2, K6-v2) cores, and their fp64 forms K1-f64 and K4-f64.
#include "entries.cuh"
#include "vort3d_body.cuh"

ONBODY_ENTRIES(vort3d_rm, onbody::Vort3d<onbody::CoreRm>,
               onbody::Vort3dF64<onbody::CoreRmF64>)
ONBODY_ENTRIES(vort3d_exp, onbody::Vort3d<onbody::CoreExp>,
               onbody::Vort3dF64<onbody::CoreExpF64>)
ONBODY_ENTRIES(vort3d_v2, onbody::Vort3d<onbody::CoreV2>,
               onbody::Vort3dF64<onbody::CoreV2F64>)
