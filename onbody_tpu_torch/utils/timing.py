"""Per-phase wall-clock timing and flop accounting (port of
onbody_tpu/utils/timing.py).

The reference drivers' phase timers with cumulative tree-time
attribution (ongrav3d.cpp:606-614) and their flop-count GFlop/s
(ongrav3d.cpp:747). On a CUDA device each phase starts and ends with a
synchronize, so a phase's time is the device work enqueued inside it.
The synchronizes remove overlap between phases: time a whole run without
a timer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch


class PhaseTimer:
    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.phases: Dict[str, float] = {}

    def sync(self):
        """Wait for the timer's CUDA device (no-op elsewhere)."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.phases[name] = (self.phases.get(name, 0.0)
                             + time.perf_counter() - t0)

    def time(self, name: str, fn, *args, **kw):
        """fn(*args, **kw) timed as phase `name`; returns its result."""
        with self.phase(name):
            return fn(*args, **kw)

    def report(self, printer=print):
        """One line per phase, in the order the phases first ran."""
        for name, t in self.phases.items():
            printer(f"  {name}:\t[{t:.4f}] seconds")

    def total(self, *names) -> float:
        """Seconds of the named phases (every phase with no names)."""
        if not names:
            return sum(self.phases.values())
        return sum(self.phases.get(n, 0.0) for n in names)


def phase(timer: Optional[PhaseTimer], name: str):
    """timer.phase(name), or a no-op context when there is no timer."""
    return timer.phase(name) if timer is not None else contextlib.nullcontext()


def pair_flops(n_pairs_valid: int, block_size: int,
               kernel_flops: int) -> float:
    """UPPER-BOUND flop estimate: every pair charged a full BxB tile,
    padded slots included. block_real_counts + interaction_flops give
    the numbers comparable with the reference's per-interaction counters
    (barneshut.hpp:131, ongrav3d.cpp:60)."""
    return float(n_pairs_valid) * block_size * block_size * kernel_flops


def block_real_counts(levels: int, block_size: int, n_real: int,
                      order: int, pd: int, n_rows: int,
                      width: int = 0) -> np.ndarray:
    """Per-row REAL slot counts of a Blocks array, for honest flop
    accounting (the reference's, copied). Rows [nleaf, 2*nleaf) are leaf
    blocks, [1, nleaf) interior proxy blocks, >= 2*nleaf extension parts
    of split proxy grids.

      * leaf row: pad clones sort past every real particle, so leaf i
        holds clip(n_real - i*bs, 0, bs) reals.
      * interior row, order >= 0: min((order+1)^pd, width) proxies for a
        node holding a real particle, 0 for dead nodes; extension part j
        holds the next `width` of the grid. `width` is the row width
        (plan.src_fm.shape[-1]); defaults to block_size.
      * interior row, order < 0 (pair-merge): min(real particles of the
        node, bs) (barneshut.hpp:986-1008).
    """
    bs = block_size
    W = width or bs
    nleaf = 1 << levels
    n_pad = nleaf * bs
    rows = np.arange(n_rows, dtype=np.int64)
    cnt = np.zeros(n_rows, dtype=np.int64)
    m_eq = bs if order < 0 else (order + 1) ** pd

    leaf = (rows >= nleaf) & (rows < 2 * nleaf)
    cnt[leaf] = np.clip(n_real - (rows[leaf] - nleaf) * bs, 0, bs)

    interior = (rows >= 1) & (rows < nleaf)
    ri = rows[interior]
    lvl = np.frexp(ri.astype(np.float64))[1] - 1     # floor(log2 r)
    span = n_pad >> lvl
    nreal_node = np.clip(n_real - (ri - (1 << lvl)) * span, 0, span)
    if order < 0:
        cnt[interior] = np.minimum(nreal_node, bs)
    else:
        cnt[interior] = np.where(nreal_node > 0, min(m_eq, W), 0)

    ext = rows >= 2 * nleaf
    if ext.any() and order >= 0:
        j = rows[ext] // nleaf - 1                   # extension part
        node = rows[ext] - (j + 1) * nleaf
        lvl = np.frexp(np.maximum(node, 1).astype(np.float64))[1] - 1
        span = n_pad >> lvl
        nreal_node = np.clip(n_real - (node - (1 << lvl)) * span, 0, span)
        cnt[ext] = np.where((node > 0) & (nreal_node > 0),
                            np.clip(m_eq - j * W, 0, W), 0)
    cnt[0] = 0
    return cnt


def interaction_flops(info, cnt_t, cnt_s, kernel_flops: int) -> float:
    """Real interactions x kernel flops of an executed pair list.

    info: the executor's PairGroups (src (P, G)) or a PairList (src
    (P,)); cnt_t / cnt_s: per-row real slot counts (block_real_counts).
    Summed on the list's device in int64, so the count is exact (the
    reference sums in float32); one scalar comes back."""
    dev = info.tgt.device
    ct = torch.as_tensor(cnt_t, dtype=torch.int64, device=dev)
    cs = torch.as_tensor(cnt_s, dtype=torch.int64, device=dev)
    src = info.src if info.src.ndim == 2 else info.src[:, None]
    per_tgt = torch.where(src != 0, cs[src], 0).sum(dim=1)
    return float(int((ct[info.tgt] * per_tgt).sum())) * kernel_flops
