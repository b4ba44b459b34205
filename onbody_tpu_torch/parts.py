"""Particle sets as structure-of-arrays tensors (port of onbody_tpu/parts.py).

Padding clones real particles with zero strength one domain diameter
past the max corner, so padded slots are numerically inert and sort
after every real particle on every axis (the invariant the tree build
and the list builder rely on).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class Parts:
    """x (n, pd) positions, r (n,) radii, s (n, sd) strengths or None
    for pure targets; n_real counts the un-padded particles."""

    x: torch.Tensor
    r: torch.Tensor
    s: Optional[torch.Tensor]
    n_real: int

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def pd(self) -> int:
        return self.x.shape[1]

    @property
    def sd(self) -> int:
        return 0 if self.s is None else self.s.shape[1]

    @property
    def are_sources(self) -> bool:
        return self.s is not None

    @property
    def device(self) -> torch.device:
        return self.x.device


def random_in_cube(gen: torch.Generator, n: int, pd: int, sd: int,
                   are_sources: bool = True,
                   dtype: torch.dtype = torch.float32) -> Parts:
    """Uniform positions in [-1,1]^pd, strengths in [-1,1]/n, radius
    n^(-1/pd), on the generator's device (Parts.hpp:100-109)."""
    dev = gen.device
    x = torch.rand((n, pd), generator=gen, device=dev, dtype=dtype) * 2 - 1
    r = torch.full((n,), float(n) ** (-1.0 / pd), device=dev, dtype=dtype)
    s = None
    if are_sources:
        s = (torch.rand((n, sd), generator=gen, device=dev, dtype=dtype)
             * 2 - 1) / float(n)
    return Parts(x=x, r=r, s=s, n_real=n)


def random_in_disk(gen: torch.Generator, n: int, pd: int, sd: int,
                   are_sources: bool = True,
                   dtype: torch.dtype = torch.float32) -> Parts:
    """Central star + low-mass orbiters in a disk, on the generator's
    device (Parts.hpp:112-134): particle i at radius 0.1 + 5 i / n and a
    uniform angle in the plane of the first two axes, particle 0 at the
    origin with strength 1, the others 0.1 / n."""
    dev = gen.device
    theta = torch.rand((n,), generator=gen, device=dev,
                       dtype=dtype) * (2.0 * math.pi)
    rad = 0.1 + 5.0 * torch.arange(n, device=dev, dtype=dtype) / float(n)
    x = torch.zeros((n, pd), device=dev, dtype=dtype)
    x[:, 0] = rad * torch.cos(theta)
    x[:, 1] = rad * torch.sin(theta)
    x[0] = 0.0
    s = None
    if are_sources:
        s = torch.zeros((n, sd), device=dev, dtype=dtype)
        s[:, 0] = 0.1 / float(n)
        s[0, 0] = 1.0
    r = torch.full((n,), (0.1 / float(n)) ** 2, device=dev, dtype=dtype)
    r[0] = 0.00465
    return Parts(x=x, r=r, s=s, n_real=n)


def _with_strengths(p: Parts, v: torch.Tensor) -> Parts:
    """p with every strength component set to the per-particle v."""
    s = v[:, None].expand(p.s.shape).to(p.s.dtype).contiguous()
    return dataclasses.replace(p, s=s)


def smooth_strengths(p: Parts) -> Parts:
    """s[d] = (x - y)/n (Parts.hpp:137-145)."""
    if p.s is None:
        return p
    return _with_strengths(p, (p.x[:, 0] - p.x[:, 1]) / float(p.n_real))


def central_strengths(p: Parts) -> Parts:
    """Radially-modulated cosine strengths (Parts.hpp:159-168)."""
    if p.s is None:
        return p
    dist = torch.sqrt(((p.x - 0.5) ** 2).sum(dim=1))
    return _with_strengths(p, torch.cos(30.0 * torch.sqrt(dist))
                           / (5.0 * dist + 1.0) / float(p.n_real))


def wave_strengths(p: Parts) -> Parts:
    """s[d] = cos((d+0.7)*10*x[d])/n (Parts.hpp:171-177)."""
    if p.s is None:
        return p
    d = torch.arange(p.sd, device=p.device, dtype=p.x.dtype)
    xs = (p.x[:, :p.sd] if p.sd <= p.pd else
          torch.nn.functional.pad(p.x, (0, p.sd - p.pd)))
    s = torch.cos((d + 0.7) * 10.0 * xs) / float(p.n_real)
    return dataclasses.replace(p, s=s.to(p.s.dtype))


def randomize_radii(gen: torch.Generator, p: Parts) -> Parts:
    """r *= U(0.5, 1.5), on the generator's device (Parts.hpp:152-156)."""
    f = torch.rand(p.r.shape, generator=gen, device=gen.device,
                   dtype=p.r.dtype) + 0.5
    return dataclasses.replace(p, r=p.r * f)


def pad_to(p: Parts, n_pad: int) -> Parts:
    """Pad to n_pad slots with zero-strength clones of the real cloud,
    translated one diameter past its max corner (reference pad_to)."""
    n = p.n
    if n_pad == n:
        return p
    assert n_pad > n
    lo = p.x.min(dim=0).values
    hi = p.x.max(dim=0).values
    offset = (hi - lo) + 1.0
    idx = torch.arange(n, n_pad, device=p.device) % n
    x = torch.cat([p.x, p.x[idx] + offset[None, :]], dim=0)
    rfill = torch.clamp(p.r.mean(), min=1e-6)
    r = torch.cat([p.r, rfill.expand(n_pad - n).to(p.r.dtype)], dim=0)
    s = None
    if p.s is not None:
        s = torch.cat([p.s, p.s.new_zeros((n_pad - n, p.sd))], dim=0)
    return Parts(x=x, r=r, s=s, n_real=p.n_real)


def astype(p: Parts, dtype: torch.dtype) -> Parts:
    """Cast to a storage dtype (SolverConfig.storage_dtype)."""
    if p.x.dtype == dtype:
        return p
    return Parts(x=p.x.to(dtype), r=p.r.to(dtype),
                 s=None if p.s is None else p.s.to(dtype), n_real=p.n_real)


def from_arrays(x: torch.Tensor, r: Optional[torch.Tensor] = None,
                s: Optional[torch.Tensor] = None) -> Parts:
    """Build a Parts from plain tensors (library-API entry)."""
    n = x.shape[0]
    if r is None:
        r = x.new_zeros((n,))
    if s is not None and s.ndim == 1:
        s = s[:, None]
    return Parts(x=x, r=r, s=s, n_real=n)
