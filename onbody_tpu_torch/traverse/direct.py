"""Direct O(N^2) summation (port of onbody_tpu/traverse/direct.py).

* ``direct_oracle`` — fp64 pairwise broadcast chunked over targets: the
  accuracy oracle every fast method is validated against.
* ``direct`` — the production path in accum_dtype: kernel K4 (fp32) or
  K4-f64 (the accuracy tier's, the inputs promoted to double) on CUDA
  tensors, their plain twin on CPU tensors (ops/cuda_direct.py). Both
  evaluate every kernel per pair (the reference routes the 3D vortex
  kernels through its per-pair form for the same reason,
  direct.py:114-133).
"""

from __future__ import annotations

from typing import Optional

import torch

from onbody_tpu_torch.ops import cuda_direct
from onbody_tpu_torch.ops.kernels import Kernel
from onbody_tpu_torch.parts import Parts


def _target_radii(kernel: Kernel, targs: Parts, dtype):
    if kernel.uses_tr:
        return targs.r.to(dtype)
    return torch.zeros_like(targs.r, dtype=dtype)


# bytes of one (targets, sources, OD) fp64 temporary of direct_oracle; on
# the CPU a cache-sized one (the chunking does not change the result, and
# temporaries that stay in cache run the forms about twice as fast)
ORACLE_BYTES = 1 << 30
ORACLE_CPU_BYTES = 1 << 22


def direct_oracle(kernel: Kernel, srcs: Parts, targs: Parts,
                  core: str = "rm", tskip: int = 1,
                  chunk: Optional[int] = None) -> torch.Tensor:
    """fp64 direct sum over every tskip-th target: (ceil(M/tskip), OD).
    Targets go `chunk` at a time; by default at most 256, fewer where a
    (chunk, S, OD) temporary would pass ORACLE_BYTES (ORACLE_CPU_BYTES on
    the CPU; the pairwise forms keep several of them: at 1e6 sources 256
    targets would take 6-25 GB each). The chunking does not change the
    result."""
    if chunk is None:
        per_target = srcs.n * kernel.od * 8
        budget = (ORACLE_BYTES if srcs.x.device.type == "cuda"
                  else ORACLE_CPU_BYTES)
        chunk = max(1, min(256, budget // per_target))
    f64 = torch.float64
    tx = targs.x[::tskip].to(f64)
    tr = _target_radii(kernel, targs, f64)[::tskip]
    sx, sr, ss = srcs.x.to(f64), srcs.r.to(f64), srcs.s.to(f64)
    out = tx.new_empty((tx.shape[0], kernel.od))
    for t0 in range(0, tx.shape[0], chunk):
        out[t0:t0 + chunk] = kernel.pairwise(
            tx[t0:t0 + chunk], tr[t0:t0 + chunk], sx, sr, ss, core).sum(1)
    return out


def direct(kernel: Kernel, srcs: Parts, targs: Parts, core: str = "rm",
           accum_dtype=torch.float32) -> torch.Tensor:
    """Direct sum in accum_dtype (float32 or float64, mycast semantics:
    the inputs promoted, every pair term and sum in accum_dtype): (M,
    OD). Runs kernel K4 (K4-f64) when the particles are on a CUDA
    device, its plain twin when they are on the CPU. Strengths are (S,
    SD)."""
    tr = _target_radii(kernel, targs, accum_dtype)
    return cuda_direct.direct_cuda(
        kernel, *(a.to(accum_dtype).contiguous() for a in (
            targs.x, tr, srcs.x, srcs.r, srcs.s)), core,
        accum_dtype=accum_dtype)
