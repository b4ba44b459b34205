"""Multi-device dry run and rank jobs (the port's analogue of
__graft_entry__.py's dryrun_multichip).

    python -m onbody_tpu_torch.scripts.multichip N [--backend nccl|gloo]

starts N ranks (parallel/launch.py: NCCL with one rank per card, the
default, which raises without N cards; gloo on the CPU when asked for
by name) and runs, at the reference dry run's shapes and limits:

  1. grav3d, block 16, order 2, n = 16 max(4N, 16): the streamed sharded
     DTT (mesh.solve_dtt_sharded_stream) against the port's monolithic
     solve_dtt on the same plan, rel-diff < 1e-5, overflow 0;
  2. grav3d, block 128, order 4, theta 1.3, pregather, n = 2048 max(N,
     4): prepare_and_solve_sharded against the direct sum (K4 on the
     card, its twin on the CPU), rel-RMS < 3e-4, overflow 0.

The reference's bar (MULTICHIP_r05.json, 8 TPU devices): 4.59e-7 and
5.91e-5. `solve_cases` is the rank job the multi-device tests start.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.parallel import launch, shard_prepare
from onbody_tpu_torch.parallel import mesh as pmesh
from onbody_tpu_torch.traverse import direct, dtt, treecode
from onbody_tpu_torch.tree import hsplit

SOLVES = {"dtt": pmesh.solve_dtt_sharded,
          "stream": pmesh.solve_dtt_sharded_stream,
          "treecode3": pmesh.solve_treecode3_sharded}
STREAM_TOL = 1e-5
PREPARE_TOL = 3e-4


def _mesh(shape: Optional[Sequence[int]], device, group=None):
    if shape is None:
        return pmesh.make_mesh(group=group, device=device)
    return pmesh.make_mesh_2level(*shape, group=group, device=device)


def solve_cases(cases: list, device=None) -> list:
    """Rank job: each case a dict with "method" (a key of SOLVES,
    "prepare" for shard_prepare.prepare_and_solve_sharded or "split" for
    _split_case), "kernel", "cfg", "inputs" (sx, sr, ss, tx, tr float32
    numpy arrays, the same on every rank), optionally "shape"
    (make_mesh_2level's (slices, chips); a flat mesh without) and "ranks"
    (the global ranks of the case's process group, made with
    dist.new_group by every rank; all ranks without). Cases on disjoint
    groups run side by side. A plan is prepared from the inputs for
    SOLVES. device: the meshes' (None: this rank's CUDA device; "cpu"
    for gloo ranks). Returns per case (out (n, OD) numpy, overflow,
    n_valid or None), or None where this rank is not in the case's
    group."""
    groups = {}
    for case in cases:
        ranks = case.get("ranks")
        if ranks is not None and ranks not in groups:
            groups[ranks] = dist.new_group(list(ranks))
    res = []
    for case in cases:
        ranks = case.get("ranks")
        if ranks is not None and dist.get_rank() not in ranks:
            res.append(None)
            continue
        mesh = _mesh(case.get("shape"), device, groups.get(ranks))
        if case["method"] == "split":
            res.append(_split_case(mesh, case))
            continue
        kernel = get_kernel(case["kernel"])
        cfg = case["cfg"]
        sx, sr, ss, tx, tr = (torch.from_numpy(a).to(mesh.device)
                              for a in case["inputs"])
        srcs = P.Parts(x=sx, r=sr, s=ss, n_real=sx.shape[0])
        targs = P.Parts(x=tx, r=tr, s=None, n_real=tx.shape[0])
        if case["method"] == "prepare":
            out, ov = shard_prepare.prepare_and_solve_sharded(
                kernel, cfg, mesh, srcs, targs)
            res.append((out.cpu().numpy(), ov, None))
            continue
        plan = treecode.prepare(kernel, cfg, srcs, targs)
        out, info = SOLVES[case["method"]](kernel, cfg, mesh, plan)
        res.append((out.cpu().numpy(), int(info.overflow),
                    int(info.n_valid)))
    return res


def _split_case(mesh, case) -> dict:
    """Rank job of one side's top split and exchange: case "inputs" (x,
    r, s or None, oid) over all ranks, "n_pad" the global tree's slots,
    "cap_b" the exchange's bucket rows; this rank takes its share of the
    rows. Returns the box, the split's per-particle owners, planes, axes
    and this rank's tie quotas, and the received slab (x, orig ids,
    count, overflow) as numpy."""
    x, r, s, oid = (None if a is None else torch.from_numpy(a).to(
        mesh.device) for a in case["inputs"])
    n = x.shape[0]
    m = n // mesh.size
    rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
    split = mesh.size.bit_length() - 1
    n_pad = case["n_pad"]
    lo, hi = shard_prepare._global_box(mesh, x[rows])
    nid, planes, axes, quotas = shard_prepare._top_split(
        mesh, hsplit.box_codes(x[rows], lo, hi), split, n_pad,
        n_pad - n, lo, hi)
    xs, _, _, orig, count, ov = shard_prepare._split_exchange_fn(
        mesh, x[rows], r[rows], None if s is None else s[rows], oid[rows],
        split, n, n_pad, case["cap_b"])
    return dict(lo=lo, hi=hi, nid=nid.cpu().numpy(), planes=planes,
                axes=axes, quotas=quotas, x=xs.cpu().numpy(),
                orig=orig.cpu().numpy(), count=count, overflow=ov)


def _problem(n: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    srcs = P.random_in_cube(gen, n, 3, 1, True)
    targs = P.random_in_cube(gen, n, 3, 0, False)
    return srcs, targs


def _rel(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm())


def dryrun_rank(n_ranks: int, device=None) -> dict:
    """Rank job of dryrun_multichip: both checks on this rank; rank 0
    also computes the direct reference. Returns the errors and
    overflows (the direct sum's rel-RMS on rank 0 only)."""
    mesh = pmesh.make_mesh(n_ranks, device=device)
    dev = mesh.device
    kernel = get_kernel("grav3d")
    bs = 16
    cfg = SolverConfig(block_size=bs, order=2, frontier_width=128,
                       list_width=256)
    n = bs * max(4 * n_ranks, 16)
    srcs, targs = _problem(n, 0, dev)
    plan = treecode.prepare(kernel, cfg, srcs, targs)
    out, pl = pmesh.solve_dtt_sharded_stream(kernel, cfg, mesh, plan)
    ref, _ = dtt.solve_dtt(kernel, cfg, plan)
    res = {"n": n, "rel_diff": _rel(out, ref),
           "overflow": int(pl.overflow)}

    n2 = 128 * 16 * max(n_ranks, 4)
    cfg2 = SolverConfig(block_size=128, order=4, theta_dtt=1.3,
                        frontier_width=192, list_width=512,
                        cap_groups_dtt=64, pair_fetch="pregather")
    srcs2, targs2 = _problem(n2, 7, dev)
    out2, ov2 = shard_prepare.prepare_and_solve_sharded(
        kernel, cfg2, mesh, srcs2, targs2)
    res.update(n2=n2, overflow2=ov2, finite2=bool(torch.isfinite(out2).all()))
    if mesh.rank == 0:
        res["rel_direct"] = _rel(out2, direct.direct(kernel, srcs2, targs2))
    return res


def dryrun_multichip(n_ranks: int, backend: str = "nccl") -> dict:
    """Start n_ranks ranks, run dryrun_rank in each, check the limits and
    print one line a check; returns rank 0's result. Raises on a failed
    check. backend "nccl" runs one rank per card; "gloo" CPU ranks."""
    device = "cpu" if backend == "gloo" else None
    res = launch.run_ranks(dryrun_rank, n_ranks, n_ranks, device,
                           backend=backend)
    r0 = res[0]
    for r in res:
        if r["overflow"] or r["overflow2"] or not r["finite2"]:
            raise AssertionError(f"dryrun_multichip({n_ranks}): {r}")
        if r["rel_diff"] >= STREAM_TOL:
            raise AssertionError(f"sharded/unsharded mismatch: {r}")
    if r0["rel_direct"] >= PREPARE_TOL:
        raise AssertionError(f"sharded-prepare error {r0['rel_direct']}")
    print(f"dryrun_multichip({n_ranks}, {backend}): OK  n={r0['n']}  "
          f"rel-diff={r0['rel_diff']:.2e}")
    print(f"dryrun_multichip({n_ranks}, {backend}) sharded-prepare: OK  "
          f"n={r0['n2']}  rel-vs-direct={r0['rel_direct']:.2e}")
    return r0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--backend", choices=launch.BACKENDS, default="nccl")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
