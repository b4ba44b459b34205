"""CLI driver mirroring the reference's onvortgrad3d executable
(onvortgrad3d.cpp).

Usage: python -m onbody_tpu_torch.drivers.onvortgrad3d -n=100000 -t=1.0 -o=4 -b=128
"""

import sys

from onbody_tpu_torch.drivers.common import run_driver

# the reference vortgrad driver ships with the DTT stage disabled
# (onvortgrad3d.cpp:264 test_iterations={1,1,1,1,0}) and a single theta
# default of 1.0 (:271); the DTT stage runs here, as in the JAX package
# (onbody_tpu/drivers/onvortgrad3d.py), which implements it for every
# workload
DEFAULTS = {"theta1": 1.0, "theta2": 1.0, "theta3": 1.0, "theta4": 1.0}


def main(argv=None, device=None):
    run_driver("vortgrad3d", "onvortgrad3d",
               sys.argv[1:] if argv is None else argv, defaults=DEFAULTS,
               device=device)


if __name__ == "__main__":
    main()
