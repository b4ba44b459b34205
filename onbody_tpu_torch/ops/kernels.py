"""Physics kernels in plain PyTorch (port of onbody_tpu/ops/kernels.py).

Sign conventions follow the reference exactly (kernels.py:19-23):
  grav3d:     d = s - t, u += m*(d2+sr^2)^-1.5 * d   (RM only)
  vort2d:     d = t - s, u -= ss*cf*dy ; v += ss*cf*dx (cf uses sr and tr)
  vort3d:     d = s - t, u += cf * (omega x d)
  vortgrad3d: d = t - s, u += r3*(omega x d); 9 gradients via bbb,
              out[3 + 3*b + a] = A[a, b] = d u_a / d x_b

The reference's tile forms factor the source sum into MXU contractions
(premultiplied rows, tile-centered moments, a bf16-split '3xt' tier,
permutation-matmul cross products). Those exist for the TPU matrix unit
and Mosaic's layout limits and are not reproduced: every form here
evaluates the per-pair d directly in the storage dtype, which is also
what the CUDA bodies (csrc/*_body.cuh) compute, so the `d2_mode` and
`precision` arguments have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from onbody_tpu_torch.ops import core_funcs as cf


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One physics workload: dims, cores, pairwise + tile forms."""

    name: str
    pd: int
    sd: int
    od: int
    uses_tr: bool
    cores: Tuple[str, ...]  # core_func values it evaluates (grav3d: none)
    pairwise: Callable  # (tx,tr,sx,sr,ss,core) -> (T,S,OD)
    # (tx,tr,sx,sr,ss,core,accum_dtype) -> (T,OD); the reference's
    # point-major tile entry, kept only for the parity tests
    tile: Callable
    tile_fm: Callable   # (tpos,trad,srcT,core) -> (...,B_t,OD)
    # (core_name) -> flops per source-target pair, the reference drivers'
    # counts (ongrav3d.cpp:44-58 and its siblings) for GFlop/s reports
    flops_fn: Callable


def _cross(a, b):
    """Cross product over the last axis of broadcastable (..., 3)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ------------------------------------------------------------ pairwise forms
# direct broadcast transliterations of the reference scalar kernels
# (ongrav3d.cpp:44-58, onvort2d.cpp:44-57, onvort3d.cpp:44-62,
# onvortgrad3d.cpp:45-79); the fp64 oracle evaluates these

def _grav3d_pairwise(tx, tr, sx, sr, ss, core="rm"):
    # the gravity driver hard-codes the RM denominator: core is ignored
    d = sx[None, :, :] - tx[:, None, :]          # (T,S,3)
    d2 = (d * d).sum(-1)
    r2 = d2 + (sr * sr)[None, :]
    r3 = ss[None, :, 0] * torch.rsqrt(r2) ** 3
    return r3[:, :, None] * d


def _vort2d_pairwise(tx, tr, sx, sr, ss, core="rm"):
    d = tx[:, None, :] - sx[None, :, :]
    d2 = (d * d).sum(-1)
    c = cf.core_2d(core)(d2, sr[None, :], tr[:, None])
    w = ss[None, :, 0] * c
    return torch.stack([-w * d[:, :, 1], w * d[:, :, 0]], dim=-1)


def _vort3d_pairwise(tx, tr, sx, sr, ss, core="rm"):
    d = sx[None, :, :] - tx[:, None, :]
    d2 = (d * d).sum(-1)
    c = cf.core_3d(core)(d2, sr[None, :])
    return c[:, :, None] * _cross(ss[None, :, :], d)


def _vortgrad3d_pairwise(tx, tr, sx, sr, ss, core="rm"):
    d = tx[:, None, :] - sx[None, :, :]          # (T,S,3)
    d2 = (d * d).sum(-1)
    r3, bbb = cf.core_3d_grads(core)(d2, sr[None, :])
    oxd = _cross(ss[None, :, :], d)              # (T,S,3)
    vel = r3[:, :, None] * oxd
    # A[a,b] = bbb * oxd_a * d_b, plus the epsilon terms r3*omega
    # (reference kernels.py:234-243)
    A = bbb[:, :, None, None] * oxd[:, :, :, None] * d[:, :, None, :]
    rw = r3[:, :, None] * ss[None, :, :]         # (T,S,3)
    A[:, :, 1, 0] += rw[:, :, 2]
    A[:, :, 2, 0] -= rw[:, :, 1]
    A[:, :, 0, 1] -= rw[:, :, 2]
    A[:, :, 2, 1] += rw[:, :, 0]
    A[:, :, 0, 2] += rw[:, :, 1]
    A[:, :, 1, 2] -= rw[:, :, 0]
    T, S = d2.shape
    grads = A.transpose(2, 3).reshape(T, S, 9)
    return torch.cat([vel, grads], dim=-1)


# ---------------------------------------------------- feature-major forms

FM_ROWS = {  # used rows of the feature-major source block, per kernel
    "grav3d": 5,        # x, y, z, sr2, m (pad8 adds m*x, m*y, m*z)
    "vort2d": 4,        # x, y, sr, ss (pad8 adds ss*x, ss*y)
    "vort3d": 7,        # x, y, z, r, w(3)
    "vortgrad3d": 7,    # x(3), r, w(3)
}


def featurize(name: str, pos, rad, s, pad8: bool = True):
    """(..., B, PD)/(..., B)/(..., B, SD) -> feature-major (..., C, B).

    The reference's rows (kernels.py:312-351): grav3d x, y, z, sr^2, m
    (pad8 appends m*x, m*y, m*z); vort2d x, y, sr, ss (pad8 appends
    ss*x, ss*y and two zero rows); vort3d/vortgrad3d x(3), sr, w(3)
    (pad8 appends one zero row). The port's bodies read only the lean
    rows; the padded layout is kept so the arrays compare like with
    like."""
    if name == "grav3d":
        rows = [pos.transpose(-1, -2), (rad * rad).unsqueeze(-2),
                s.transpose(-1, -2)]
    elif name in ("vort2d", "vort3d", "vortgrad3d"):
        rows = [pos.transpose(-1, -2), rad.unsqueeze(-2),
                s.transpose(-1, -2)]
    else:
        raise KeyError(name)
    if pad8 and name in ("grav3d", "vort2d"):
        rows.append((s * pos).transpose(-1, -2))
    out = torch.cat(rows, dim=-2)
    pad = -out.shape[-2] % 8
    if pad and pad8:
        out = torch.cat([out, out.new_zeros(out.shape[:-2]
                                            + (pad, out.shape[-1]))], -2)
    return out


def featurize_flat(name: str, pos, rad, s):
    """The lean feature rows of blocks (reference featurize_flat): grav3d
    x, y, z, sr^2, m; the vortex bodies x(pd), sr, s(sd). The reference
    flattens each block to one (C*B,) vector because (NN, C, B) with C 5
    tiles badly on the TPU; the port keeps (..., C, B), the layout K8/K9
    read at any row stride, so reshape(-1) of a block is the reference's
    vector."""
    return featurize(name, pos, rad, s, pad8=False)


def pad_fm_rows(name: str, blocks):
    """Pad lean (..., C, B) blocks to a multiple of 8 rows with the
    DERIVED rows of the padded layout (grav3d m*pos, vort2d ss*pos),
    never zeros where featurize puts a product; zeros elsewhere."""
    c = blocks.shape[-2]
    c8 = -(-c // 8) * 8
    if c8 == c:
        return blocks
    if name == "grav3d" and c == 5:
        extra = blocks[..., 4:5, :] * blocks[..., 0:3, :]
    elif name == "vort2d" and c == 4:
        sspos = blocks[..., 3:4, :] * blocks[..., 0:2, :]
        extra = torch.cat([sspos, torch.zeros_like(sspos)], dim=-2)
    else:
        extra = blocks.new_zeros(blocks.shape[:-2]
                                 + (c8 - c, blocks.shape[-1]))
    return torch.cat([blocks, extra], dim=-2)


def _d2_fm(tpos, srcT, pd: int):
    """(..., B_t, B_s) squared distances from a feature-major block, the
    per-dimension broadcast sum ('outer'; the only mode of the port)."""
    d2 = None
    for d in range(pd):
        diff = tpos[..., :, d:d + 1] - srcT[..., d:d + 1, :]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _grav3d_tile_fm(tpos, srcT):
    """(..., B_t, 3) sum over a feature-major source block (..., C, B_s).

    Reads rows x, y, z, sr^2, m of either layout (pad8 or lean) and
    evaluates w = m * rsqrt(|d|^2 + sr^2)^3, out = sum w * d with
    d = s - t per pair — the arithmetic of the CUDA body. The
    temporaries are reused in place (the same operations in the same
    order: ((d0^2 + d1^2) + d2^2) + sr^2, ((rinv rinv) rinv) m)."""
    d = [srcT[..., k:k + 1, :] - tpos[..., :, k:k + 1] for k in range(3)]
    d2 = d[0] * d[0]
    t = d[1] * d[1]
    d2 += t
    torch.mul(d[2], d[2], out=t)
    d2 += t
    d2 += srcT[..., 3:4, :]
    rinv = d2.rsqrt_()
    w = torch.mul(rinv, rinv, out=t).mul_(rinv).mul_(srcT[..., 4:5, :])
    return torch.stack([torch.mul(w, dk, out=dk).sum(-1) for dk in d],
                       dim=-1)


def _vort2d_tile_fm(tpos, trad, srcT, core="rm"):
    """(..., B_t, 2) over rows x, y, sr, ss: d = t - s per pair,
    u -= ss*cf*dy, v += ss*cf*dx with cf = core_2d(d2, sr, tr)."""
    dx = tpos[..., :, 0:1] - srcT[..., 0:1, :]
    dy = tpos[..., :, 1:2] - srcT[..., 1:2, :]
    d2 = dx * dx + dy * dy
    c = cf.core_2d(core)(d2, srcT[..., 2:3, :], trad[..., :, None])
    w = srcT[..., 3:4, :] * c
    return torch.stack([-(w * dy).sum(-1), (w * dx).sum(-1)], dim=-1)


def _oxd_fm(d, srcT):
    """Rows of omega x d for per-pair d components over a
    (x(3), r, w(3)) block."""
    w = [srcT[..., 4 + k:5 + k, :] for k in range(3)]
    return [w[1] * d[2] - w[2] * d[1],
            w[2] * d[0] - w[0] * d[2],
            w[0] * d[1] - w[1] * d[0]]


def _vort3d_tile_fm(tpos, trad, srcT, core="rm"):
    """(..., B_t, 3) over rows x(3), sr, w(3): d = s - t per pair,
    vel += core_3d(d2, sr) * (w x d)."""
    d = [srcT[..., k:k + 1, :] - tpos[..., :, k:k + 1] for k in range(3)]
    oxd = _oxd_fm(d, srcT)
    c = cf.core_3d(core)(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                         srcT[..., 3:4, :])
    return torch.stack([(c * v).sum(-1) for v in oxd], dim=-1)


def _vortgrad3d_tile_fm(tpos, trad, srcT, core="rm"):
    """(..., B_t, 12) over rows x(3), sr, w(3): d = t - s per pair,
    (r3, bbb) = core_3d_grads(d2, sr), vel += r3 (w x d),
    A[a,b] += bbb (w x d)_a d_b plus the r3 epsilon terms, laid out
    out[3 + 3b + a] = A[a, b]. Every pair term is summed in full fp32
    (the reference clamps this contraction to its full-mantissa '6xt'
    tier, kernels.py:727-732)."""
    d = [tpos[..., :, k:k + 1] - srcT[..., k:k + 1, :] for k in range(3)]
    oxd = _oxd_fm(d, srcT)
    r3, bbb = cf.core_3d_grads(core)(
        d[0] * d[0] + d[1] * d[1] + d[2] * d[2], srcT[..., 3:4, :])
    vel = [(r3 * v).sum(-1) for v in oxd]
    bo = [bbb * v for v in oxd]
    rw = [(r3 * srcT[..., 4 + k:5 + k, :]).sum(-1) for k in range(3)]
    A = [[(bo[a] * d[b]).sum(-1) for b in range(3)] for a in range(3)]
    A[1][0] = A[1][0] + rw[2]
    A[2][0] = A[2][0] - rw[1]
    A[0][1] = A[0][1] - rw[2]
    A[2][1] = A[2][1] + rw[0]
    A[0][2] = A[0][2] + rw[1]
    A[1][2] = A[1][2] - rw[0]
    return torch.stack(vel + [A[a][b] for b in range(3) for a in range(3)],
                       dim=-1)


def _tile_via_fm(name: str):
    """The point-major tile form (tx,tr,sx,sr,ss,core,accum_dtype) of a
    kernel: featurize the sources and evaluate its feature-major form."""
    def tile(tx, tr, sx, sr, ss, core="rm", accum_dtype=torch.float32):
        srcT = featurize(name, sx.to(accum_dtype), sr.to(accum_dtype),
                         ss.to(accum_dtype), pad8=False)
        return KERNELS[name].tile_fm(tx.to(accum_dtype),
                                     tr.to(accum_dtype), srcT, core)
    return tile


KERNELS = {
    "grav3d": Kernel(
        name="grav3d", pd=3, sd=1, od=3, uses_tr=False, cores=(),
        pairwise=_grav3d_pairwise, tile=_tile_via_fm("grav3d"),
        tile_fm=lambda tpos, trad, srcT, core="rm": _grav3d_tile_fm(
            tpos, srcT),
        flops_fn=lambda core: 19),
    "vort2d": Kernel(
        name="vort2d", pd=2, sd=1, od=2, uses_tr=True,
        cores=tuple(cf._CORES_2D), pairwise=_vort2d_pairwise,
        tile=_tile_via_fm("vort2d"), tile_fm=_vort2d_tile_fm,
        flops_fn=lambda core: 10 + cf.FLOPS[(core, "2d_tr")]),
    "vort3d": Kernel(
        name="vort3d", pd=3, sd=3, od=3, uses_tr=False,
        cores=tuple(cf._CORES_3D), pairwise=_vort3d_pairwise,
        tile=_tile_via_fm("vort3d"), tile_fm=_vort3d_tile_fm,
        flops_fn=lambda core: 23 + cf.FLOPS[(core, "3d")]),
    "vortgrad3d": Kernel(
        name="vortgrad3d", pd=3, sd=3, od=12, uses_tr=False,
        cores=tuple(cf._CORES_3D_GRADS), pairwise=_vortgrad3d_pairwise,
        tile=_tile_via_fm("vortgrad3d"), tile_fm=_vortgrad3d_tile_fm,
        flops_fn=lambda core: 56 + cf.FLOPS[(core, "3d_grads")]),
}


def get_kernel(name: str) -> Kernel:
    return KERNELS[name]
