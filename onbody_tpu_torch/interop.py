"""Carry the JAX reference's data structures into the port.

Each function takes the reference's object (any object with the same
fields whose arrays `np.asarray` accepts, so this module needs no jax)
and returns the port's counterpart with tensors on `device`. Stage tests
use it to feed the reference's upstream outputs into a port stage, so a
divergence shows where it starts.
"""

from __future__ import annotations

import numpy as np
import torch

from onbody_tpu_torch.parts import Parts
from onbody_tpu_torch.traverse.lists import PairGroups, PairList
from onbody_tpu_torch.traverse.treecode import Plan
from onbody_tpu_torch.tree.build import Tree
from onbody_tpu_torch.tree.equivalents import Blocks


def tensor(a, device="cpu") -> torch.Tensor:
    """One array as a tensor (integer ids widen to int64, the port's
    index type; bool and floats keep their type)."""
    arr = np.asarray(a)
    if arr.dtype.kind in "iu":
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr)).to(device)


def _opt(a, device):
    return None if a is None else tensor(a, device)


def parts_from_numpy(p, device="cpu") -> Parts:
    return Parts(x=tensor(p.x, device), r=tensor(p.r, device),
                 s=_opt(p.s, device), n_real=int(p.n_real))


def tree_from_numpy(t, device="cpu") -> Tree:
    return Tree(nc=tensor(t.nc, device), ns=tensor(t.ns, device),
                nr=tensor(t.nr, device), x=tensor(t.x, device),
                s=tensor(t.s, device), pr=tensor(t.pr, device),
                alive=tensor(t.alive, device), levels=int(t.levels),
                block_size=int(t.block_size))


def blocks_from_numpy(b, device="cpu"):
    """Blocks, or None for the lean plan's absent Blocks."""
    if b is None:
        return None
    return Blocks(pos=tensor(b.pos, device), rad=tensor(b.rad, device),
                  s=_opt(b.s, device))


def pairlist_from_numpy(pl, device="cpu") -> PairList:
    return PairList(tgt=tensor(pl.tgt, device), src=tensor(pl.src, device),
                    n_valid=tensor(pl.n_valid, device),
                    overflow=tensor(pl.overflow, device))


def pairgroups_from_numpy(pg, device="cpu") -> PairGroups:
    return PairGroups(tgt=tensor(pg.tgt, device), src=tensor(pg.src, device),
                      n_valid=tensor(pg.n_valid, device),
                      overflow=tensor(pg.overflow, device))


def plan_from_numpy(p, device="cpu") -> Plan:
    """A reference Plan, full or lean (no Blocks; src_fm then holds the
    lean feature rows)."""
    return Plan(stree=tree_from_numpy(p.stree, device),
                ttree=tree_from_numpy(p.ttree, device),
                src_sorted=parts_from_numpy(p.src_sorted, device),
                tgt_sorted=parts_from_numpy(p.tgt_sorted, device),
                src_blocks=blocks_from_numpy(p.src_blocks, device),
                tgt_blocks=blocks_from_numpy(p.tgt_blocks, device),
                src_gidx=tensor(p.src_gidx, device),
                tgt_gidx=tensor(p.tgt_gidx, device),
                src_fm=tensor(p.src_fm, device),
                tgt_geo=tensor(p.tgt_geo, device),
                tgt_inv=_opt(p.tgt_inv, device))
