"""Regularized core functions for the vortex kernels (port of
onbody_tpu/ops/core_funcs.py; CoreFunc2d.hpp / CoreFunc3d.hpp).

Rosenhead-Moore (default), compact-exponential and Vatistas n=2
regularizations, with the 3D gradient variants returning (r3, bbb). Every
piecewise branch is a `torch.where` over safe operands, as in the
reference, so self-interactions (d2 == 0) stay finite: RM whenever the
radius is positive, the exponential forms through the _TINY guards. The
CUDA bodies (csrc/core.cuh) evaluate the same branches as selects.

This is the port's own copy; it imports nothing of the JAX package.
"""

from __future__ import annotations

import torch

_TINY = 1e-30


# ---------------------------------------------------------------- 2D cores

def rm_2d(d2, sr, tr=None):
    """Rosenhead-Moore: 1/(d^2 + sr^2 [+ tr^2]) — CoreFunc2d.hpp:24-36."""
    r2 = d2 + sr * sr
    if tr is not None:
        r2 = r2 + tr * tr
    return 1.0 / r2


def exp_2d(d2, sr, tr=None):
    """Compact exponential 2D core — CoreFunc2d.hpp:85-103.

    ood2 = 1/(d^2+1e-6); corefac = 1/(sr^2[+tr^2]); reld2 = corefac*d^2;
    piecewise: far -> ood2, close -> corefac, mid -> ood2*(1-exp(-reld2)).
    """
    ood2 = 1.0 / (d2 + 1e-6)
    s2 = sr * sr
    if tr is not None:
        s2 = s2 + tr * tr
    corefac = 1.0 / torch.clamp(s2, min=_TINY)
    reld2 = corefac / ood2
    mid = ood2 * (1.0 - torch.exp(-reld2))
    out = torch.where(reld2 > 16.0, ood2, mid)
    return torch.where(reld2 < 0.001, corefac, out)


# ---------------------------------------------------------------- 3D cores

def rm_3d(d2, sr):
    """RM 3D: (d^2 + sr^2)^-1.5 — CoreFunc3d.hpp:27-31."""
    rinv = torch.rsqrt(d2 + sr * sr)
    return rinv * rinv * rinv


def rm_3d_grads(d2, sr):
    """RM 3D with gradient factor: r3 and bbb = -3*r3/r2 —
    CoreFunc3d.hpp:34-41."""
    r2 = d2 + sr * sr
    rinv = torch.rsqrt(r2)
    r3 = rinv * rinv * rinv
    return r3, -3.0 * r3 / r2


def exp_3d(d2, sr):
    """Compact exponential 3D core — CoreFunc3d.hpp:136-150."""
    dist = torch.sqrt(d2)
    corefac = 1.0 / torch.clamp(sr * sr * sr, min=_TINY)
    d3 = torch.clamp(d2 * dist, min=_TINY)
    ood3 = 1.0 / d3
    reld3 = d3 * corefac
    mid = ood3 * (1.0 - torch.exp(-torch.clamp(reld3, max=87.0)))
    out = torch.where(reld3 > 16.0, ood3, mid)
    return torch.where(reld3 < 0.001, corefac, out)


def exp_3d_grads(d2, sr):
    """Exponential 3D core with gradients — CoreFunc3d.hpp:152-177."""
    dist = torch.sqrt(d2)
    corefac = 1.0 / torch.clamp(sr * sr * sr, min=_TINY)
    d3 = torch.clamp(d2 * dist, min=_TINY)
    reld3 = d3 * corefac
    dm3 = 1.0 / d3
    dm2 = 1.0 / torch.clamp(d2, min=_TINY)
    expreld3 = torch.exp(-torch.clamp(reld3, max=87.0))

    r3_far = dm3
    bbb_far = -3.0 * dm3 * dm2
    r3_mid = (1.0 - expreld3) * dm3
    bbb_mid = 3.0 * (corefac * expreld3 - r3_mid) * dm2
    r3_close = corefac
    bbb_close = -1.5 * dist * corefac * corefac

    r3 = torch.where(reld3 > 16.0, r3_far, r3_mid)
    bbb = torch.where(reld3 > 16.0, bbb_far, bbb_mid)
    r3 = torch.where(reld3 < 0.001, r3_close, r3)
    bbb = torch.where(reld3 < 0.001, bbb_close, bbb)
    return r3, bbb


def v2_3d(d2, sr):
    """Vatistas n=2: (d^4 + sr^4)^-0.75 — CoreFunc3d.hpp:185-198
    (off by default in the reference as well)."""
    s2 = sr * sr
    rsqd = torch.rsqrt(torch.clamp(d2 * d2 + s2 * s2, min=_TINY))
    return rsqd * torch.sqrt(rsqd)


# ----------------------------------------------------------------- registry

_CORES_2D = {"rm": rm_2d, "exp": exp_2d}
_CORES_3D = {"rm": rm_3d, "exp": exp_3d, "v2": v2_3d}
_CORES_3D_GRADS = {"rm": rm_3d_grads, "exp": exp_3d_grads}

# the reference's flop weights per core (its benchmark's accounting); the
# port's bounds count operations per body instead (csrc/*_body.cuh)
FLOPS = {
    ("rm", "2d"): 3, ("rm", "2d_tr"): 5,
    ("rm", "3d"): 5, ("rm", "3d_grads"): 8,
    ("exp", "2d"): 9, ("exp", "2d_tr"): 11,
    ("exp", "3d"): 9, ("exp", "3d_grads"): 15,
    ("v2", "3d"): 7,
}


def core_2d(name: str):
    return _CORES_2D[name]


def core_3d(name: str):
    return _CORES_3D[name]


def core_3d_grads(name: str):
    return _CORES_3D_GRADS[name]
