// K1, K2, K4, K8-K12 with the vort3d body K6, for the RM and exp cores.
#include "entries.cuh"
#include "vort3d_body.cuh"

ONBODY_ENTRIES(vort3d_rm, onbody::Vort3d<onbody::CoreRm>)
ONBODY_ENTRIES(vort3d_exp, onbody::Vort3d<onbody::CoreExp>)
