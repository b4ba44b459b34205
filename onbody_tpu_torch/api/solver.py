"""Embeddable solver API (port of onbody_tpu/api/solver.py).

Function-for-function equivalents of the reference library's entry
points (interface2dvort.cpp:182-374, interface2dvorttr.cpp:177-373,
interface3dvortgrads.cpp:247-500): arrays in, numpy arrays out, float32,
with the same production tuning (2D: theta 1.3, order 4, block 128; 3D:
theta 1.5, order 4) and the same blockwise (treecode3) evaluation.
Targets may alias sources (self-interaction is regularized).

Inputs are numpy arrays or tensors. `device=None` runs on the CUDA
device and raises when there is none; pass `device="cpu"` to run the
plain twins on the CPU. C and Fortran hosts reach these functions
through the C ABI shim (api/cabi/onbody_c.cpp, api/cabi_bridge.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.parts import Parts, from_arrays
from onbody_tpu_torch.traverse import direct as direct_mod
from onbody_tpu_torch.traverse import treecode
from onbody_tpu_torch.utils.device import resolve

_CFG_2D = SolverConfig(block_size=128, order=4, theta_boxwise=1.3)
_CFG_3D = SolverConfig(block_size=128, order=4, theta_boxwise=1.5)
# the overflow retry widens the capacities this many times at most
_RETRIES = 3


def _device(device) -> torch.device:
    return resolve(device, "onbody_tpu_torch.api")


def _column(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(device)


def _parts(cols, device, r=None, s=None) -> Parts:
    """Parts on `device` from coordinate columns, radii and strength
    columns (each a 1-D array)."""
    x = torch.stack([_column(c, device) for c in cols], dim=1)
    r = None if r is None else _column(r, device)
    if s is not None:
        s = torch.stack([_column(c, device) for c in s], dim=1)
    return from_arrays(x, r=r, s=s)


def _solve_boxwise(kernel_name: str, cfg: SolverConfig, srcs: Parts,
                  targs: Parts, theta: float, stats: Optional[dict] = None
                  ) -> torch.Tensor:
    """prepare + solve_treecode3 with two-phase count/fill recovery: on
    overflow ALL FOUR static capacities are widened fourfold (frontier
    and list widths bound the list construction, cap_groups_* the grouped
    executor), at most three times; a truncated sum is never returned.
    `stats`, when given, receives the number of retries and the final
    configuration."""
    kernel = get_kernel(kernel_name)
    wide = cfg
    for attempt in range(_RETRIES + 1):
        plan = treecode.prepare(kernel, wide, srcs, targs)
        out, info = treecode.solve_treecode3(kernel, wide, plan, theta=theta)
        if int(info.overflow) == 0:
            break
        wide = wide.replace(
            frontier_width=wide.frontier_width * 4,
            list_width=wide.list_width * 4,
            cap_groups_dtt=wide.cap_groups_dtt * 4,
            cap_groups_treecode=wide.cap_groups_treecode * 4)
    else:
        raise RuntimeError("interaction lists kept overflowing")
    if stats is not None:
        stats.update(retries=attempt, cfg=wide)
    return out


def _columns(out: torch.Tensor):
    out = out.cpu().numpy()
    return tuple(out[:, d] for d in range(out.shape[1]))


def vel_solver_2d(sx, sy, ss, sr, tx, ty, tr=None, theta: float = 1.3,
                  order: int = 4, device=None, stats: Optional[dict] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """2D vortex Biot-Savart, treecode3 path: external_vel_solver_f_
    (interface2dvort.cpp:182) with tr=None, external_vel_solver_tr_f_
    (interface2dvorttr.cpp:177) with target radii. Returns (tu, tv)."""
    dev = _device(device)
    srcs = _parts([sx, sy], dev, r=sr, s=[ss])
    targs = _parts([tx, ty], dev, r=tr)
    return _columns(_solve_boxwise("vort2d", _CFG_2D.replace(order=order),
                                  srcs, targs, theta, stats))


def vel_direct_2d(sx, sy, ss, sr, tx, ty, tr=None, device=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """2D direct sum (external_vel_direct_f_, interface2dvort.cpp:324)."""
    dev = _device(device)
    srcs = _parts([sx, sy], dev, r=sr, s=[ss])
    targs = _parts([tx, ty], dev, r=tr)
    return _columns(direct_mod.direct(get_kernel("vort2d"), srcs, targs))


def vel_solver_3dvortgrads(sx, sy, sz, ssx, ssy, ssz, sr, tx, ty, tz,
                           theta: float = 1.5, order: int = 4, device=None,
                           stats: Optional[dict] = None):
    """3D vortex velocity + 9 gradients, treecode3 path
    (external_vel_solver_f_, interface3dvortgrads.cpp:247). Returns 12
    arrays: (tu, tv, tw, tux, tvx, twx, tuy, tvy, twy, tuz, tvz, twz)."""
    dev = _device(device)
    srcs = _parts([sx, sy, sz], dev, r=sr, s=[ssx, ssy, ssz])
    targs = _parts([tx, ty, tz], dev)
    return _columns(_solve_boxwise("vortgrad3d", _CFG_3D.replace(order=order),
                                  srcs, targs, theta, stats))


def vel_direct_3dvortgrads(sx, sy, sz, ssx, ssy, ssz, sr, tx, ty, tz,
                           device=None):
    """3D vortgrads direct sum (interface3dvortgrads.cpp:422)."""
    dev = _device(device)
    srcs = _parts([sx, sy, sz], dev, r=sr, s=[ssx, ssy, ssz])
    targs = _parts([tx, ty, tz], dev)
    return _columns(direct_mod.direct(get_kernel("vortgrad3d"), srcs, targs))
