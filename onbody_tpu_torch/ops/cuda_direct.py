"""Direct O(N^2) summation: kernel K4 and its plain twins (port of
onbody_tpu/ops/pallas_direct.py), for every workload.

`direct_cuda` launches csrc/direct.cuh's instantiation for the kernel
and core on CUDA tensors and returns the plain PyTorch twin
`direct_torch` for CPU tensors; it never moves work between devices.
Both read the sources in the reference's lean feature-major rows
(`featurize`) and evaluate each pair with the kernel's per-pair form.

K4 is a kernel over (target tiles x source splits) and, when the sources
were split, an ordered reduction of the splits' partial sums
(`direct_reduce`). The wrapper picks the split count on the host
(`plan_splits`, from the occupancy query: `splits_for`);
`direct_split_torch` is the plain twin of the split path.

K4-f64 (accum_dtype float64, csrc/fp64.cuh: "direct64" and
"direct64_reduce") is K4's plan in double, on its own tile and chunk
(`geometry`): the inputs promoted once (exact), double partials
added in split order. Both reductions are one kernel
(csrc/direct.cuh split_reduce, on floats or doubles).
"""

from __future__ import annotations

import collections
import functools

import torch

from onbody_tpu_torch.ops import cuda_lib
from onbody_tpu_torch.ops.cuda_pairs import PREGATHER_BYTES
from onbody_tpu_torch.ops.kernels import Kernel, featurize

# kernel launches by the wrapper, keyed (kind, instance) with kind
# "direct" (the kernel) or "direct_reduce" (its reduction), or their fp64
# forms "direct64" and "direct64_reduce", and the instance as
# cuda_lib.instance names it (reset by callers that count a run)
LAUNCHES = collections.Counter()
# the twin's (targets, sources) tile: bounds its (T, S) temporaries; on
# the CPU 64 targets a tile keep them in cache (~3x faster than 1024; the
# target tiling does not change the result, the source tiling would)
_TILE_T, _TILE_S = 1024, 4096
_TILE_T_CPU = 64
# csrc/direct.cuh's targets per CTA (kDirectThreads * kDirectTgts) and
# sources per staged chunk (kDirectChunk)
TILE_T, CHUNK_S = 512, 512
# K4-f64's sources per staged chunk (csrc/fp64.cuh kDirect64Chunk); its
# targets per CTA depend on the body, and the library reports them
# (geometry)
CHUNK_S64 = 256
# waves of resident CTAs the split grid should fill
SPLIT_WAVES = 2
# bytes of the split partials' scratch, at most: the pregather buffer's
SCRATCH_BYTES = PREGATHER_BYTES


def _check_shapes(kernel: Kernel, tx, tr, sx, sr, ss):
    m, s = tx.shape[0], sx.shape[0]
    for name, t, shape in (("tx", tx, (m, kernel.pd)), ("tr", tr, (m,)),
                           ("sx", sx, (s, kernel.pd)), ("sr", sr, (s,)),
                           ("ss", ss, (s, kernel.sd))):
        if tuple(t.shape) != shape:
            raise ValueError(f"direct {kernel.name}: {name} must be "
                             f"{shape}, got {tuple(t.shape)}")


def direct_torch(kernel: Kernel, tx, tr, sx, sr, ss, core: str = "rm",
                 accum_dtype=None):
    """Plain twin of K4 (and K4-f64): tx (M, PD), tr (M,), sx (S, PD),
    sr (S,), ss (S, SD) -> (M, OD), tiled so memory stays bounded,
    computed in the inputs' type or, when given, in accum_dtype (the
    inputs promoted to it, as the reference's jnp direct does). tr is
    read only by kernels that use target radii (vort2d)."""
    _check_shapes(kernel, tx, tr, sx, sr, ss)
    if accum_dtype is not None:
        tx, tr, sx, sr, ss = (a.to(accum_dtype) for a in (tx, tr, sx, sr,
                                                          ss))
    srcT = featurize(kernel.name, sx, sr, ss, pad8=False)
    out = tx.new_zeros((tx.shape[0], kernel.od))
    tile_t = _TILE_T if tx.device.type == "cuda" else _TILE_T_CPU
    for t0 in range(0, tx.shape[0], tile_t):
        t, r = tx[t0:t0 + tile_t], tr[t0:t0 + tile_t]
        acc = torch.zeros_like(out[t0:t0 + tile_t])
        for s0 in range(0, sx.shape[0], _TILE_S):
            acc += kernel.tile_fm(t, r, srcT[:, s0:s0 + _TILE_S], core)
        out[t0:t0 + tile_t] = acc
    return out


# ------------------------------------------------------------ the split plan

def split_bounds(s: int, splits: int, chunk: int = CHUNK_S):
    """The [lo, hi) source range of each of `splits` splits, in split
    order, as K4 (K4-f64 at chunk CHUNK_S64) cuts them: split j takes the
    chunks of `chunk` sources [j * C / splits, (j + 1) * C / splits) of
    the C = ceil(S / chunk) (whole chunks, counts differing by one at
    most; the last chunk may be short)."""
    chunks = -(-s // chunk)
    return [(min(s, j * chunks // splits * chunk),
             min(s, (j + 1) * chunks // splits * chunk))
            for j in range(splits)]


def plan_splits(m: int, s: int, od: int, ctas_per_sm: int, sms: int,
                scratch_bytes: int = SCRATCH_BYTES,
                itemsize: int = 4, tile: int = TILE_T,
                chunk: int = CHUNK_S) -> int:
    """K4's (and K4-f64's, at its geometry) split planner: the number of
    source splits for M targets and S sources. The smallest count whose
    grid (target tiles of `tile` x splits) fills SPLIT_WAVES waves of
    ctas_per_sm resident CTAs on `sms` SMs, at most one split per chunk
    of `chunk` sources and capped so that the partial slabs (splits x M x
    OD values of itemsize bytes) fit in scratch_bytes; 1 when the tiles
    alone fill the waves."""
    chunks = -(-s // chunk)
    tiles = -(-m // tile)
    want = -(-SPLIT_WAVES * sms * max(ctas_per_sm, 1) // max(tiles, 1))
    cap = scratch_bytes // (itemsize * max(m, 1) * od)
    return max(1, min(want, chunks, cap))


@functools.cache
def geometry(kind: str, inst: str) -> tuple:
    """(targets per CTA, sources per chunk) of K4 (kind "direct") or of
    instantiation inst's K4-f64 ("direct64", its tile from the library:
    csrc/fp64.cuh Direct64Tile)."""
    if kind == "direct":
        return TILE_T, CHUNK_S
    tile = getattr(cuda_lib.lib(), cuda_lib.entry("direct64_tile", inst))()
    return int(tile), CHUNK_S64


@functools.cache
def _resident(kind: str, inst: str, device_index: int):
    with torch.cuda.device(device_index):
        ctas = cuda_lib.occupancy(kind, inst, 0, 0, 0)["ctas_per_sm"]
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return ctas, sms


def splits_for(kernel: Kernel, core: str, m: int, s: int, device,
               kind: str = "direct"):
    """plan_splits with the card's SMs and the resident CTAs per SM (the
    CUDA occupancy calculator) of K4 (kind "direct") or K4-f64
    ("direct64"), at its geometry."""
    inst = cuda_lib.instance(kernel.name, core)
    ctas, sms = _resident(kind, inst, device.index or 0)
    tile, chunk = geometry(kind, inst)
    return plan_splits(m, s, kernel.od, ctas, sms,
                       itemsize=8 if kind == "direct64" else 4, tile=tile,
                       chunk=chunk)


def reduce_splits_torch(partials):
    """Plain twin of K4's (and K4-f64's) reduction: the (splits, M, OD)
    partial slabs summed in split order."""
    out = partials[0].clone()
    for p in partials[1:]:
        out += p
    return out


def direct_split_torch(kernel: Kernel, tx, tr, sx, sr, ss, core: str = "rm",
                       splits: int = 1):
    """Plain twin of K4's split path: direct_torch over each split's
    sources (split_bounds), then the partials summed in split order."""
    parts = [direct_torch(kernel, tx, tr, sx[lo:hi], sr[lo:hi], ss[lo:hi],
                          core)
             for lo, hi in split_bounds(sx.shape[0], splits)]
    return reduce_splits_torch(torch.stack(parts))


# --------------------------------------------------------------- the kernel

def layout(kernel: Kernel, tx, tr, sx, sr, ss):
    """K4's inputs: targets feature-major (PD+1, M) [pos | radius] and
    sources in the lean feature-major rows (C, S), as the executors read
    them."""
    tgt = torch.cat([tx.T, tr[None, :]], dim=0).contiguous()
    src = featurize(kernel.name, sx, sr, ss, pad8=False).contiguous()
    return tgt, src


def _kind(base: str, dtype) -> str:
    """K4's kind ("direct", "direct_reduce") for inputs of `dtype`: the
    fp64 form's for float64."""
    if dtype == torch.float64:
        return base.replace("direct", "direct64")
    return base


def launch_kernel(kernel: Kernel, core: str, tgt, src, dst,
                  splits: int) -> None:
    """K4's kernel alone on laid-out inputs (`layout`), K4-f64's on
    float64 ones: dst is the output (M, OD) for one split, else the
    scratch (splits, M, OD)."""
    inst = cuda_lib.instance(kernel.name, core)
    m, s = tgt.shape[1], src.shape[1]
    kind = _kind("direct", tgt.dtype)
    name = cuda_lib.entry(kind, inst)
    rc = getattr(cuda_lib.lib(), name)(
        tgt.data_ptr(), src.data_ptr(), dst.data_ptr(), m, s, splits,
        cuda_lib.stream_ptr(dst.device))
    cuda_lib.check(rc, name)
    LAUNCHES[(kind, inst)] += 1


def reduce_splits_cuda(kernel: Kernel, core: str, out, partials) -> None:
    """K4's (K4-f64's, on float64) ordered reduction: out (M, OD) = the
    partial slabs (splits, M, OD) summed in split order."""
    inst = cuda_lib.instance(kernel.name, core)
    kind = _kind("direct_reduce", out.dtype)
    name = cuda_lib.entry(kind, inst)
    rc = getattr(cuda_lib.lib(), name)(
        out.data_ptr(), partials.data_ptr(), out.shape[0],
        partials.shape[0], cuda_lib.stream_ptr(out.device))
    cuda_lib.check(rc, name)
    LAUNCHES[(kind, inst)] += 1


def direct_cuda(kernel: Kernel, tx, tr, sx, sr, ss, core: str = "rm",
                splits: int = None, accum_dtype=torch.float32):
    """Direct sum, shapes as direct_torch, in accum_dtype. CUDA tensors
    launch K4 (float32: the inputs must be float32) or K4-f64 (float64:
    the inputs promoted once, exact); CPU tensors take the twin in
    accum_dtype; anything else raises. `splits` forces the number of
    source splits (None: splits_for's).

    K4 replaces onbody_tpu/ops/pallas_direct.py:direct_pallas. It is
    bound by the SM's FP32/MUFU rates over the operations each pair
    needs (counted in the body's header; PERF.md has the bound), not by
    memory: a CTA keeps 512 target sums in registers (two per thread)
    and stages its split's sources through shared memory, so a source
    is read from device memory once per 512 targets. When the target
    tiles cannot fill the card, the sources are split over CTAs and the
    splits' partial sums are added in split order by a second kernel
    (csrc/direct.cuh). K4-f64 is the same plan in double
    (csrc/fp64.cuh: K4's ring on K1-f64's pair loop), replacing the
    reference's fp64 direct,
    traverse/direct.py:direct (:65-102) at accum_dtype=float64; bound by
    the pairs' FP64 operations."""
    devs = {t.device for t in (tx, tr, sx, sr, ss)}
    if len(devs) != 1:
        raise ValueError(f"direct: tensors on several devices {devs}")
    dev = devs.pop()
    if accum_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"direct: accum_dtype {accum_dtype}")
    if dev.type == "cpu":
        return direct_torch(kernel, tx, tr, sx, sr, ss, core, accum_dtype)
    if dev.type != "cuda":
        raise ValueError(f"direct: no kernel for device {dev}")
    cuda_lib.instance(kernel.name, core)  # raises for a core without one
    _check_shapes(kernel, tx, tr, sx, sr, ss)
    if accum_dtype == torch.float64:
        tx, tr, sx, sr, ss = (a.double() for a in (tx, tr, sx, sr, ss))
    for name, t in (("tx", tx), ("tr", tr), ("sx", sx), ("sr", sr),
                    ("ss", ss)):
        if t.dtype != accum_dtype:
            raise ValueError(f"direct: {name} must be {accum_dtype}, got "
                             f"{t.dtype}")
    m, s = tx.shape[0], sx.shape[0]
    if max(m, s) >= 2 ** 31:
        raise ValueError("direct: sizes must fit in int32")
    out = torch.empty((m, kernel.od), dtype=accum_dtype, device=dev)
    if m == 0:
        return out
    if splits is None:
        splits = splits_for(kernel, core, m, s, dev,
                            _kind("direct", accum_dtype))
    elif splits < 1:
        raise ValueError(f"direct: {splits} splits, need >= 1")
    tile = geometry(_kind("direct", accum_dtype),
                    cuda_lib.instance(kernel.name, core))[0]
    if -(-m // tile) * splits >= 2 ** 31:
        raise ValueError("direct: the grid must fit in int32")
    tgt, src = layout(kernel, tx, tr, sx, sr, ss)
    if splits == 1:
        launch_kernel(kernel, core, tgt, src, out, 1)
        return out
    partials = torch.empty((splits, m, kernel.od), dtype=accum_dtype,
                           device=dev)
    launch_kernel(kernel, core, tgt, src, partials, splits)
    reduce_splits_cuda(kernel, core, out, partials)
    return out
