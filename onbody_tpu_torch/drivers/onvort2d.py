"""CLI driver mirroring the reference's onvort2d executable (onvort2d.cpp).

Usage: python -m onbody_tpu_torch.drivers.onvort2d -n=100000 -t=1.0 -o=4 -b=128
"""

import sys

from onbody_tpu_torch.drivers.common import run_driver

DEFAULTS = None


def main(argv=None, device=None):
    run_driver("vort2d", "onvort2d", sys.argv[1:] if argv is None else argv,
               defaults=DEFAULTS, device=device)


if __name__ == "__main__":
    main()
