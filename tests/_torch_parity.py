"""Shared inputs for the port-vs-reference parity tests (test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages as
float32 arrays. Coordinates are drawn without repeats per axis, so no
two particles tie on a split axis and the reference's unstable sort and
the port's stable one give the same permutation.

jax is imported only where a reference object is built, so the GPU-only
tests (test_torch_cuda.py) use this module on machines without jax.
"""

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from onbody_tpu_torch import parts as TP

# the slice at test size: tuned_config(1e6)'s knobs at block 32 / order 3
SLICE_KW = dict(block_size=32, order=3, theta_dtt=1.2, frontier_width=256,
                list_width=1024, cap_groups_dtt=16, tree_mode="span",
                pair_group=8, pair_fetch="dma_i", pair_tile_g=4,
                dtt_leaf_pair2=True, mxu_precision="highest",
                tree_paired=True, tree_defer_rs=True)


def unique_coords(rng, n: int, pd: int = 3) -> np.ndarray:
    """(n, pd) float32 in [-1, 1), no value repeated within a column."""
    cols = [rng.choice(1 << 23, n, replace=False) / float(1 << 22) - 1.0
            for _ in range(pd)]
    return np.stack(cols, axis=1).astype(np.float32)


def make_inputs(seed: int, n: int, m: int = None, pd: int = 3,
                sd: int = 1):
    """Sources (x, r, s) and targets (x, r) as float32 numpy arrays in
    pd dimensions with sd strength components (radius n^(-1/pd), as
    parts.random_in_cube)."""
    m = n if m is None else m
    rng = np.random.default_rng(seed)
    sx = unique_coords(rng, n, pd)
    ss = (rng.uniform(-1, 1, (n, sd)) / n).astype(np.float32)
    sr = np.full((n,), n ** (-1 / pd), np.float32)
    tx = unique_coords(rng, m, pd)
    tr = np.full((m,), m ** (-1 / pd), np.float32)
    return sx, sr, ss, tx, tr


def kernel_inputs(kernel, seed: int, n: int, m: int = None):
    """make_inputs at a kernel's pd and sd."""
    return make_inputs(seed, n, m, kernel.pd, kernel.sd)


def jax_parts(x, r, s=None):
    import jax.numpy as jnp
    from onbody_tpu import parts as JP
    return JP.Parts(x=jnp.asarray(x), r=jnp.asarray(r),
                    s=None if s is None else jnp.asarray(s),
                    n_real=x.shape[0])


def torch_parts(x, r, s=None):
    return TP.Parts(x=torch.from_numpy(x), r=torch.from_numpy(r),
                    s=None if s is None else torch.from_numpy(s),
                    n_real=x.shape[0])


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def scale_rel_max(a, b) -> float:
    """max |a - b| / max |b| (the reference executor tests' bound)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))



def jax_array(t):
    """A port tensor as the reference's array (int64 ids as int32)."""
    import jax.numpy as jnp
    a = t.numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def jax_tree(t):
    """A port Tree as the reference's (the inverse of interop)."""
    from onbody_tpu.tree import build as JB
    return JB.Tree(nc=jax_array(t.nc), ns=jax_array(t.ns),
                   nr=jax_array(t.nr), x=jax_array(t.x), s=jax_array(t.s),
                   pr=jax_array(t.pr), alive=jax_array(t.alive),
                   levels=t.levels, block_size=t.block_size)


class PairedSpy:
    """Wraps cuda_pairs.exec_pairs_t2 (the chunked solve's paired leaf
    pass, traverse/chunked.py): for each paired launch, records the
    view's offset into its slab (in rows) and whether its rows 0/1 (slab
    rows 1-2 on the shifted view), set to a sentinel just before the
    launch, came out unchanged; then puts their values back."""

    def __init__(self, run):
        self.run, self.calls = run, []

    def __call__(self, kernel, tgt_geo, src_fm, group_t, group_s, out_fm,
                 *a, **kw):
        kept = out_fm[:2].clone()
        sentinel = torch.full_like(kept, 7.0)
        out_fm[:2] = sentinel
        res = self.run(kernel, tgt_geo, src_fm, group_t, group_s, out_fm,
                       *a, **kw)
        row = out_fm.shape[1] * out_fm.shape[2]
        self.calls.append((out_fm.storage_offset() // row,
                           torch.equal(out_fm[:2], sentinel)))
        out_fm[:2] = kept
        return res


@contextlib.contextmanager
def jax_x64():
    """The reference's fp64 tier needs jax_enable_x64 (without it
    float64 arrays silently stay float32): set it for the block and put
    the previous value back after it."""
    import jax
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


# ops that read the device back (or size their output from its data), and
# lift_fresh, a tensor made from host values (on the card: a copy to it)
SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.unique",
            "aten._unique", "aten.unique_consecutive", "aten.masked_select",
            "aten.lift_fresh")


class SyncGuard(TorchDispatchMode):
    """Records every op that would wait on the host: SYNC_OPS and
    boolean-mask indexing (index / index_put with a bool index), except
    while `exempt` is set."""

    def __init__(self):
        super().__init__()
        self.hits, self.exempt = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        bad = name.startswith(SYNC_OPS)
        if name in ("aten.index", "aten.index_put", "aten.index_put_",
                    "aten._index_put_impl_"):
            bad = any(i is not None and i.dtype == torch.bool
                      for i in args[1])
        if bad and not self.exempt:
            self.hits.append(name)
        return func(*args, **(kwargs or {}))


def exempt(guard, fn):
    """fn with `guard` not recording while it runs (a kernel's twin)."""
    def run(*a, **k):
        guard.exempt += 1
        try:
            return fn(*a, **k)
        finally:
            guard.exempt -= 1
    return run
