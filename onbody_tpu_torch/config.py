"""Typed configuration for the solver (port of onbody_tpu/config.py).

Every `SolverConfig` field of the reference keeps its name and default,
so a configuration written for one package reads the same in the other.

Keys that are TPU schedules of the same result are accepted and run the
one torch path: `tree_paired`, `tree_defer_rs`, `tree_fuse`, the
`tree_span_top` prefix slicing, `tree_bisect_group`, `group_compact`,
`pair_tile_g`, `d2_mode` and `mxu_precision` (distances and
contractions are always full fp32, the result of the reference's
"highest"). `mac_geometry` is the reference's: "quant" (the source
geometry quantized onto a shared 16-bit grid) or "f32" (exact); it
decides the DTT's pair lists.

`accum_dtype` float64 is the reference's accuracy tier (mycast
semantics): the pair chain runs in double through the fp64 kernels
K1-f64 (every `pair_fetch`, as the reference routes every fetch to its
one fp64 executor; the sibling-paired leaf list is off) and K4-f64;
`storage_dtype` float64 also keeps the particles, trees and proxies in
double. Orders whose grids are wider than a block row (order 6 and 7
in 3D at block 256, order 5 at block 128) split the proxies over
extension rows (`tree/equivalents.py` n_eq_parts), as the reference
does.

`list_compact` orders the rows of the DTT lists as the reference does:
`"scatter"` and `"sort"` keep each row's entries in order (the two
movers give identical rows), `"idsort"` sorts them by ascending id, so
sibling blocks sit in adjacent slots for the bundled fetch `"dma_p"`.

`pair_fetch` chooses the executor kernel as it does in the reference:
`"pregather"` (the default) gathers each chunk of steps contiguous and
runs K8 (K9 for the sibling-paired leaf list); `"dma_i"` runs K1 (K2),
which fetches source blocks by id with plain loads; `"dma"` runs K10
(bulk asynchronous copies by id) and `"dma_p"` K11 (the same, adjacent
ids bundled into one copy), both with K2 for the paired leaf list;
`"static"` gathers each chunk, runs K12 (one CTA per step, per-step
rows segment-added into the accumulator) and refuses a paired list.
`lean_plan` builds the feature-major arrays directly, without
point-major Blocks; with a dma-family fetch it stores the rows padded
to 8, otherwise the lean rows (reference treecode.py:112-125).

Keys that change the result, or belong to paths this port does not run
yet, raise NotImplementedError naming their ROADMAP item
(`check_supported`). They never fall back to something else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# pair_backend values of the port; the reference's "pallas" maps to "cuda"
PAIR_BACKENDS = ("auto", "cuda", "torch")
PAIR_FETCHES = ("pregather", "dma", "dma_i", "dma_p", "static")
LIST_COMPACTS = ("scatter", "sort", "idsort")
# "level": simultaneous descent (one MAC round a target level); "refine":
# the reference's refine-the-larger walk (traverse/lists.py
# build_dtt_pairs), lists list_width slots wide
DTT_TRAVERSALS = ("level", "refine")
MAC_GEOMETRIES = ("quant", "f32")
FLOAT_DTYPES = (torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """All tunables for one solve; field meanings as in the reference
    (onbody_tpu/config.py), defaults mirror the reference drivers."""

    block_size: int = 128
    order: int = -1
    theta_treecode1: float = 2.0
    theta_pointwise: float = 1.05
    theta_boxwise: float = 1.0
    theta_dtt: float = 1.35
    core_func: str = "rm"
    tree_mode: str = "median"
    tree_span: int = 2
    tree_span_top: int = 6
    tree_fuse: int = 1
    tree_span_bot: Optional[int] = None
    tree_bisect_group: int = 4
    tree_paired: bool = False
    tree_defer_rs: bool = False
    tree_quant: str = "off"
    storage_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32
    frontier_width: int = 512
    list_width: int = 2048
    list_compact: str = "scatter"
    group_compact: str = "scatter"
    # 'auto' (the CUDA kernel for CUDA tensors, the torch twin for CPU
    # tensors), 'cuda' (kernel; raises on CPU tensors) or 'torch' (twin)
    pair_backend: str = "auto"
    dtt_traversal: str = "level"
    dtt_leaf_pair2: bool = False
    dtt_lists: str = "rows"
    flat_row_cap: int = 128
    pair_group: int = 8
    pair_fetch: str = "pregather"
    pair_tile_g: int = 4
    cap_groups_dtt: int = 16
    cap_groups_treecode: int = 48
    d2_mode: str = "exact"
    mxu_precision: str = "highest"
    mac_geometry: str = "quant"
    lean_plan: bool = False

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)

    @property
    def ncp(self) -> int:
        """Chebyshev points per dimension (order+1)."""
        return self.order + 1


def pair_backend(cfg: SolverConfig) -> str:
    """The port's executor backend for cfg.pair_backend."""
    b = "cuda" if cfg.pair_backend == "pallas" else cfg.pair_backend
    if b not in PAIR_BACKENDS:
        raise ValueError(f"pair_backend {cfg.pair_backend!r}: the port "
                         f"takes one of {PAIR_BACKENDS} (or 'pallas')")
    return b


def check_supported(cfg: SolverConfig, kernel=None) -> None:
    """Raise NotImplementedError for keys whose paths are not ported.

    With a kernel, cfg.core_func must be one of its cores (vort2d and
    vortgrad3d: rm, exp; vort3d also v2); grav3d ignores core_func, as
    the reference does."""
    def no(what, item):
        raise NotImplementedError(
            f"{what} is not ported: measurement rejected it "
            f"(onbody_tpu_torch/PARITY.md; ROADMAP.md Queue 1 item {item})")
    if kernel is not None and kernel.cores \
            and cfg.core_func not in kernel.cores:
        raise ValueError(f"core_func {cfg.core_func!r}: {kernel.name} "
                         f"takes one of {kernel.cores}")
    if cfg.tree_mode not in ("median", "span"):
        no(f"tree_mode={cfg.tree_mode!r}", 17)
    if cfg.tree_span_bot is not None:
        no("tree_span_bot", 17)
    if cfg.tree_quant != "off":
        no("tree_quant", 17)
    if cfg.pair_fetch not in PAIR_FETCHES:
        raise ValueError(f"pair_fetch {cfg.pair_fetch!r}: one of "
                         f"{PAIR_FETCHES}")
    if cfg.list_compact not in LIST_COMPACTS:
        raise ValueError(f"list_compact {cfg.list_compact!r}: one of "
                         f"{LIST_COMPACTS}")
    if cfg.dtt_traversal not in DTT_TRAVERSALS:
        raise ValueError(f"dtt_traversal {cfg.dtt_traversal!r}: one of "
                         f"{DTT_TRAVERSALS}")
    if cfg.dtt_lists != "rows":
        no(f"dtt_lists={cfg.dtt_lists!r}", 17)
    for key in ("accum_dtype", "storage_dtype"):
        if getattr(cfg, key) not in FLOAT_DTYPES:
            raise ValueError(f"{key} {getattr(cfg, key)!r}: one of "
                             f"{FLOAT_DTYPES}")
    if cfg.mac_geometry not in MAC_GEOMETRIES:
        raise ValueError(f"mac_geometry {cfg.mac_geometry!r}: one of "
                         f"{MAC_GEOMETRIES}")
    pair_backend(cfg)


def tuned_config(n: int, kernel: str = "grav3d") -> SolverConfig:
    """The reference's per-N full-evaluation (DTT) table, unchanged.

    These settings were tuned on one TPU v5e (onbody_tpu/config.py
    tuned_config); ROADMAP item 12 re-tunes them on the H100. Every
    row's keys run through prepare + solve_dtt; the >= 4e7 row (lean
    rows, pregather fetch) is meant for the routine the reference runs
    it with, traverse/chunked.solve_dtt_chunked (16 chunks in
    bench.py), which keeps one target subtree's arrays on the card at a
    time."""
    cfg = _tuned_config_n(n)
    if kernel == "vort2d":
        cfg = cfg.replace(theta_dtt=max(cfg.theta_dtt, 1.4))
    if kernel == "vortgrad3d" and n >= 4_000_000:
        cfg = cfg.replace(lean_plan=True)
    return cfg


def _tuned_config_n(n: int) -> SolverConfig:
    if n >= 40_000_000:
        return SolverConfig(block_size=256, order=5, theta_dtt=1.15,
                            frontier_width=128, cap_groups_dtt=16,
                            tree_mode="span", pair_backend="pallas",
                            pair_group=16, pair_fetch="pregather",
                            mxu_precision="3xt", lean_plan=True,
                            tree_defer_rs=True, tree_fuse=1,
                            list_compact="sort")
    if n >= 4_000_000:
        return SolverConfig(block_size=256, order=5, theta_dtt=1.15,
                            frontier_width=128, list_width=320,
                            cap_groups_dtt=16, pair_backend="pallas",
                            pair_group=16, pair_fetch="dma_i",
                            pair_tile_g=4, dtt_leaf_pair2=True,
                            tree_mode="span", mxu_precision="3xt",
                            tree_paired=True, tree_defer_rs=True,
                            list_compact="sort", tree_fuse=8)
    if n <= 300_000:
        return SolverConfig(block_size=256, order=5, theta_dtt=1.2,
                            frontier_width=256, list_width=1024,
                            cap_groups_dtt=32, tree_mode="span",
                            pair_backend="pallas", pair_group=32,
                            pair_fetch="dma_i", pair_tile_g=4,
                            mxu_precision="3xt", tree_paired=True,
                            tree_defer_rs=True, tree_fuse=8,
                            list_compact="sort")
    return SolverConfig(block_size=256, order=5, theta_dtt=1.2,
                        frontier_width=128, list_width=320,
                        cap_groups_dtt=16, tree_mode="span",
                        pair_backend="pallas", pair_group=16,
                        pair_fetch="dma_i", pair_tile_g=4,
                        dtt_leaf_pair2=True,
                        mxu_precision="3xt", tree_paired=True,
                        tree_defer_rs=True, tree_fuse=8,
                        list_compact="sort")
