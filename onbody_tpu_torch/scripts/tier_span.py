"""Span mode in the capacity tiers: the port's median subtrees against the
reference's span-mode subtrees, on one problem.

Usage: python -m onbody_tpu_torch.scripts.tier_span TIER N SPLIT
           [--rule port|reference] [--theta T] [--frontier W] [--seed S]
           [--device D]

TIER "outofcore" runs traverse/outofcore.py at tuned_config(1e8)
(frontier 128) on a uniform cube made in chunks of 2^16; "stratified"
runs traverse/bigN.py at scripts/bign.py's configuration on its
stratified cube. Both configurations are span mode, tree_span_top 6;
--theta and --frontier replace their theta_dtt and frontier_width. The
port builds every subtree in median mode; --rule reference builds them
with the configuration's span settings, as the JAX package's tiers do.
The same particles also go through the monolithic solve
(treecode.prepare + dtt.solve_dtt) at the configuration. Prints one JSON
line: the tier's overflow and n_valid, the monolithic solve's overflow,
and the rel-RMS of both against the float64 direct sum, and of the tier
against the monolithic solve, on every N // 2000-th target (the
stratified tier: its own 2000-target subsample). Runs on the CUDA device
unless --device names another.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import tuned_config
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.scripts import bign as bign_script
from onbody_tpu_torch.traverse import bigN, direct, dtt, outofcore, treecode
from onbody_tpu_torch.tree import build
from onbody_tpu_torch.utils.device import resolve

N_VAL = 2000
M_CHUNK = 1 << 16


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cube_chunks(dev, n: int, seed: int, sources: bool):
    """gen(c): chunk c of the uniform cube, one torch.Generator a chunk:
    positions U(-1, 1)^3, radius n^(-1/3), strengths U(-1, 1) / n."""
    def gen(c: int) -> P.Parts:
        g = torch.Generator(device=dev).manual_seed(
            seed * 4096 + 2 * c + int(sources))
        m = min(M_CHUNK, n - c * M_CHUNK)
        x = torch.rand((m, 3), generator=g, device=dev) * 2 - 1
        r = torch.full((m,), n ** (-1 / 3), device=dev)
        s = ((torch.rand((m, 1), generator=g, device=dev) * 2 - 1) / n
             if sources else None)
        return P.Parts(x=x, r=r, s=s, n_real=m)
    return gen


def _cat(parts) -> P.Parts:
    s = None if parts[0].s is None else torch.cat([p.s for p in parts])
    return P.Parts(x=torch.cat([p.x for p in parts]),
                   r=torch.cat([p.r for p in parts]), s=s,
                   n_real=sum(p.n_real for p in parts))


def _monolithic(kernel, cfg, srcs: P.Parts, targs: P.Parts):
    out, info = dtt.solve_dtt(kernel, cfg,
                              treecode.prepare(kernel, cfg, srcs, targs))
    return out.double().cpu().numpy(), int(info.overflow)


def outofcore_row(kernel, cfg, n: int, split: int, seed: int, dev):
    n_chunks = -(-n // M_CHUNK)
    gs, gt = (_cube_chunks(dev, n, seed, True),
              _cube_chunks(dev, n, seed, False))
    res, info = outofcore.solve_dtt_outofcore(
        kernel, cfg, n, gs, gt, m_chunk=M_CHUNK, split=split, device=dev)
    gidx = res["gidx"]
    real = gidx < n
    out = np.zeros((n, kernel.od), np.float64)
    out[gidx[real]] = res["out"][real]
    srcs = _cat([gs(c) for c in range(n_chunks)])
    targs = _cat([gt(c) for c in range(n_chunks)])
    skip = max(1, n // N_VAL)
    ref = direct.direct_oracle(kernel, srcs, targs, tskip=skip).cpu().numpy()
    mono, mono_ovf = _monolithic(kernel, cfg, srcs, targs)
    got = out[::skip]
    return dict(overflow=info["overflow"], n_valid=info["n_valid"],
                mono_overflow=mono_ovf, tier_vs_oracle=_rel(got, ref),
                mono_vs_oracle=_rel(mono[::skip], ref),
                tier_vs_mono=_rel(got, mono[::skip]))


def stratified_row(kernel, cfg, n: int, split: int, seed: int, dev):
    dbg = {}
    stats, info = bigN.solve_dtt_stratified(
        kernel, cfg, n, seed, split=split, slab_cache=1 << split,
        n_val=N_VAL, profile=False, debug_out=dbg, device=dev)
    ndev, m = 1 << split, n >> split
    srcs = _cat([bigN.make_stratified_gen(seed, n, split, kernel.sd, True,
                                          dev)(t) for t in range(ndev)])
    targs = _cat([bigN.make_stratified_gen(seed, n, split, 0, False,
                                           dev)(t) for t in range(ndev)])
    mono, mono_ovf = _monolithic(kernel, cfg, srcs, targs)
    # the tier's subsample: every tskip-th target of each stratum, the
    # strata in its chunk order (reversed)
    tskip = max(1, n // N_VAL)
    idx = np.concatenate([t * m + np.arange(0, m, tskip)
                          for t in range(ndev - 1, -1, -1)])
    mono = mono[idx]
    return dict(overflow=info["overflow"], n_valid=info["n_valid"],
                mono_overflow=mono_ovf,
                tier_vs_oracle=stats["val_rel_rms"],
                mono_vs_oracle=_rel(mono, dbg["val_ref"]),
                tier_vs_mono=_rel(dbg["val_got"], mono))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tier", choices=("outofcore", "stratified"))
    ap.add_argument("n", type=float)
    ap.add_argument("split", type=int)
    ap.add_argument("--rule", choices=("port", "reference"), default="port")
    ap.add_argument("--theta", type=float, default=None)
    ap.add_argument("--frontier", type=int, default=None)
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = resolve(a.device, "tier_span")
    kernel = get_kernel("grav3d")
    if a.tier == "outofcore":
        # the 1e8 row's keys; "auto" lets the wrappers choose by device
        run, cfg = (outofcore_row,
                    tuned_config(1e8).replace(pair_backend="auto"))
    else:
        run, cfg = stratified_row, bign_script.config(a.split)
    if a.theta is not None:
        cfg = cfg.replace(theta_dtt=a.theta)
    if a.frontier is not None:
        cfg = cfg.replace(frontier_width=a.frontier)
    keep = build.build_tree

    def span_subtrees(p, block_size, **kw):
        """build_tree with the configuration's span settings for the
        tiers' subtrees (the only callers that force a plan)."""
        if kw.get("force_plan") is not None:
            kw.update(mode=cfg.tree_mode, span=cfg.tree_span,
                      span_top=cfg.tree_span_top)
        return keep(p, block_size, **kw)

    if a.rule == "reference":
        build.build_tree = span_subtrees
    try:
        row = run(kernel, cfg, int(a.n), a.split, a.seed, dev)
    finally:
        build.build_tree = keep
    row = {"tier": a.tier, "n": int(a.n), "split": a.split,
           "rule": a.rule, "theta": cfg.theta_dtt,
           "frontier": cfg.frontier_width, **row}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
