"""Direct O(N^2) summation: kernel K4 and its plain twin (port of
onbody_tpu/ops/pallas_direct.py), for every workload.

`direct_cuda` launches csrc/direct.cuh's instantiation for the kernel
and core on CUDA tensors and returns the plain PyTorch twin
`direct_torch` for CPU tensors; it never moves work between devices.
Both read the sources in the reference's lean feature-major rows
(`featurize`) and evaluate each pair with the kernel's per-pair form.
"""

from __future__ import annotations

import collections

import torch

from onbody_tpu_torch.ops import cuda_lib
from onbody_tpu_torch.ops.kernels import Kernel, featurize

# kernel launches by the wrapper, keyed ("direct", instance) with the
# instance as cuda_lib.instance names it (reset by callers that count a run)
LAUNCHES = collections.Counter()
# the twin's (targets, sources) tile: bounds its (T, S) temporaries
_TILE_T, _TILE_S = 1024, 4096


def _check_shapes(kernel: Kernel, tx, tr, sx, sr, ss):
    m, s = tx.shape[0], sx.shape[0]
    for name, t, shape in (("tx", tx, (m, kernel.pd)), ("tr", tr, (m,)),
                           ("sx", sx, (s, kernel.pd)), ("sr", sr, (s,)),
                           ("ss", ss, (s, kernel.sd))):
        if tuple(t.shape) != shape:
            raise ValueError(f"direct {kernel.name}: {name} must be "
                             f"{shape}, got {tuple(t.shape)}")


def direct_torch(kernel: Kernel, tx, tr, sx, sr, ss, core: str = "rm"):
    """Plain twin of K4: tx (M, PD), tr (M,), sx (S, PD), sr (S,),
    ss (S, SD) -> (M, OD), tiled so memory stays bounded. tr is read
    only by kernels that use target radii (vort2d)."""
    _check_shapes(kernel, tx, tr, sx, sr, ss)
    srcT = featurize(kernel.name, sx, sr, ss, pad8=False)
    out = tx.new_zeros((tx.shape[0], kernel.od))
    for t0 in range(0, tx.shape[0], _TILE_T):
        t, r = tx[t0:t0 + _TILE_T], tr[t0:t0 + _TILE_T]
        acc = torch.zeros_like(out[t0:t0 + _TILE_T])
        for s0 in range(0, sx.shape[0], _TILE_S):
            acc += kernel.tile_fm(t, r, srcT[:, s0:s0 + _TILE_S], core)
        out[t0:t0 + _TILE_T] = acc
    return out


def direct_cuda(kernel: Kernel, tx, tr, sx, sr, ss, core: str = "rm"):
    """Direct sum, shapes as direct_torch. CUDA tensors launch K4; CPU
    tensors take the twin; anything else raises.

    K4 replaces onbody_tpu/ops/pallas_direct.py:direct_pallas. It is
    bound by the SM's FP32/MUFU rates over the operations each pair
    needs (counted in the body's header; PERF.md has the bound), not by
    memory: each CTA keeps 256 target sums in registers and stages the
    sources 1024 at a time in shared memory, so a source is read from
    device memory once per 256 targets (csrc/direct.cuh)."""
    devs = {t.device for t in (tx, tr, sx, sr, ss)}
    if len(devs) != 1:
        raise ValueError(f"direct: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return direct_torch(kernel, tx, tr, sx, sr, ss, core)
    if dev.type != "cuda":
        raise ValueError(f"direct: no kernel for device {dev}")
    inst = cuda_lib.instance(kernel.name, core)
    _check_shapes(kernel, tx, tr, sx, sr, ss)
    for name, t in (("tx", tx), ("tr", tr), ("sx", sx), ("sr", sr),
                    ("ss", ss)):
        if t.dtype != torch.float32:
            raise ValueError(f"direct: {name} must be float32, got "
                             f"{t.dtype}")
    m, s = tx.shape[0], sx.shape[0]
    if max(m, s) >= 2 ** 31:
        raise ValueError("direct: sizes must fit in int32")
    out = torch.empty((m, kernel.od), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    # feature-major inputs, as the executors read them
    tgt = torch.cat([tx.T, tr[None, :]], dim=0).contiguous()
    src = featurize(kernel.name, sx, sr, ss, pad8=False).contiguous()
    name = cuda_lib.entry("direct", inst)
    rc = getattr(cuda_lib.lib(), name)(
        tgt.data_ptr(), src.data_ptr(), out.data_ptr(), m, s,
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, name)
    LAUNCHES[("direct", inst)] += 1
    return out
