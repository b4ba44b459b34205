"""Python side of the C ABI shim (cabi/onbody_c.cpp; port of
onbody_tpu/api/cabi_bridge.py).

Receives raw memoryviews over the caller's float32 buffers, runs the
port's solver (api/solver.py: treecode3 for the solver symbols, the
direct sum K4 for the direct ones), and writes results in place. Returns
a flop estimate like the reference's entry points
(interface2dvort.cpp:306-316).

Where it runs: the CUDA device, raising (the shim then returns -1)
where there is none, unless ONBODY_CABI_DEVICE names a device (for
example "cpu", which runs the kernels' plain twins). The variable is
read on every call.
"""

from __future__ import annotations

import os

import numpy as np

from onbody_tpu_torch.api import solver


def _device():
    return os.environ.get("ONBODY_CABI_DEVICE") or None


def _arr(mv, n):
    # a copy: the caller's input buffers are read-only views, which torch
    # would share on the CPU
    return np.frombuffer(mv, dtype=np.float32, count=n).copy()


def _write(outs, cols, n):
    for mv, col in zip(outs, cols, strict=True):
        np.frombuffer(mv, np.float32, n)[:] = col


def solve_2d(nsrc, sx, sy, ss, sr, ntarg, tx, ty, tu, tv):
    cols = solver.vel_solver_2d(_arr(sx, nsrc), _arr(sy, nsrc),
                                _arr(ss, nsrc), _arr(sr, nsrc),
                                _arr(tx, ntarg), _arr(ty, ntarg),
                                device=_device())
    _write((tu, tv), cols, ntarg)
    return float(nsrc) * ntarg * 12.0


def solve_2d_tr(nsrc, sx, sy, ss, sr, ntarg, tx, ty, tr, tu, tv):
    cols = solver.vel_solver_2d(_arr(sx, nsrc), _arr(sy, nsrc),
                                _arr(ss, nsrc), _arr(sr, nsrc),
                                _arr(tx, ntarg), _arr(ty, ntarg),
                                tr=_arr(tr, ntarg), device=_device())
    _write((tu, tv), cols, ntarg)
    return float(nsrc) * ntarg * 12.0


def direct_2d(nsrc, sx, sy, ss, sr, ntarg, tx, ty, tu, tv):
    cols = solver.vel_direct_2d(_arr(sx, nsrc), _arr(sy, nsrc),
                                _arr(ss, nsrc), _arr(sr, nsrc),
                                _arr(tx, ntarg), _arr(ty, ntarg),
                                device=_device())
    _write((tu, tv), cols, ntarg)
    return float(nsrc) * ntarg * 12.0


def direct_2d_tr(nsrc, sx, sy, ss, sr, ntarg, tx, ty, tr, tu, tv):
    cols = solver.vel_direct_2d(_arr(sx, nsrc), _arr(sy, nsrc),
                                _arr(ss, nsrc), _arr(sr, nsrc),
                                _arr(tx, ntarg), _arr(ty, ntarg),
                                tr=_arr(tr, ntarg), device=_device())
    _write((tu, tv), cols, ntarg)
    return float(nsrc) * ntarg * 12.0


def _in_3d(nsrc, sx, sy, sz, ssx, ssy, ssz, sr, ntarg, tx, ty, tz):
    return ([_arr(a, nsrc) for a in (sx, sy, sz, ssx, ssy, ssz, sr)]
            + [_arr(a, ntarg) for a in (tx, ty, tz)])


def solve_3dvg(nsrc, sx, sy, sz, ssx, ssy, ssz, sr, ntarg, tx, ty, tz,
               *outs):
    cols = solver.vel_solver_3dvortgrads(
        *_in_3d(nsrc, sx, sy, sz, ssx, ssy, ssz, sr, ntarg, tx, ty, tz),
        device=_device())
    _write(outs, cols, ntarg)
    return float(nsrc) * ntarg * 64.0


def direct_3dvg(nsrc, sx, sy, sz, ssx, ssy, ssz, sr, ntarg, tx, ty, tz,
                *outs):
    cols = solver.vel_direct_3dvortgrads(
        *_in_3d(nsrc, sx, sy, sz, ssx, ssy, ssz, sr, ntarg, tx, ty, tz),
        device=_device())
    _write(outs, cols, ntarg)
    return float(nsrc) * ntarg * 64.0
