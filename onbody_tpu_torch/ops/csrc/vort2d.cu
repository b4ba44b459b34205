// K1, K2, K4, K8-K12 with the vort2d body K5, for the RM and exp cores,
// and their fp64 forms K1-f64 and K4-f64.
#include "entries.cuh"
#include "vort2d_body.cuh"

ONBODY_ENTRIES(vort2d_rm, onbody::Vort2d<onbody::CoreRm>,
               onbody::Vort2dF64<onbody::CoreRmF64>)
ONBODY_ENTRIES(vort2d_exp, onbody::Vort2d<onbody::CoreExp>,
               onbody::Vort2dF64<onbody::CoreExpF64>)
