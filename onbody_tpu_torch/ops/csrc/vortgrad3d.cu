// K1, K2, K4, K8-K12 with the vortgrad3d body K7, for the RM and exp
// cores, and their fp64 forms K1-f64 and K4-f64.
#include "entries.cuh"
#include "vortgrad3d_body.cuh"

ONBODY_ENTRIES(vortgrad3d_rm, onbody::Vortgrad3d<onbody::CoreRm>,
               onbody::Vortgrad3dF64<onbody::CoreRmF64>)
ONBODY_ENTRIES(vortgrad3d_exp, onbody::Vortgrad3d<onbody::CoreExp>,
               onbody::Vortgrad3dF64<onbody::CoreExpF64>)
