"""The subtree-chunked DTT (traverse/chunked.py) and its owner-major
helpers (parallel/mesh.py, tree/equivalents.target_geo_slab,
lists._dtt_lists_top/_sub) against the JAX package on the CPU, and the
mirrors of the reference's own chunked tests (tests/test_traverse.py:
270-372) against the port's monolithic solve.

The JAX side runs its XLA executor (pair_backend "xla") at
mxu_precision "highest"; the port runs its twins. Inputs come from
_torch_parity (no coordinate repeated within an axis, so both tree
builds give the same permutation); the stage tests carry the
reference's trees into the port (interop). Tolerances: lists, counts and
overflow exact; target_geo_slab and _downward_local 1e-6 of the largest
value (fp32, the same arithmetic in another order); the solve 1e-5
rel-RMS against the JAX package's chunked solve, and rtol 1e-4 / atol
1e-6 against the port's monolithic one (the reference's own bar).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PairedSpy, jax_parts, kernel_inputs, rel_rms,
                           scale_rel_max, torch_parts)
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops.kernels import get_kernel as jget_kernel
from onbody_tpu.parallel import mesh as jmesh
from onbody_tpu.traverse import chunked as jchunked
from onbody_tpu.traverse import lists as jlists
from onbody_tpu.tree import build as jbuild
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch import interop
from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import cuda_pairs
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.parallel import mesh
from onbody_tpu_torch.traverse import chunked, dtt, lists, treecode
from onbody_tpu_torch.tree import build
from onbody_tpu_torch.tree import equivalents as eq

torch.set_num_threads(1)

# the reference's chunked-test configuration (tests/test_traverse.py:276)
KW = dict(block_size=64, order=3, frontier_width=192, list_width=512,
          cap_groups_dtt=32, mxu_precision="highest")
CFG = SolverConfig(**KW)
W = KW["frontier_width"]


def _parts(name: str, n: int, seed: int = 7, m: int = None):
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, seed, n, m)
    return kernel, (sx, sr, ss, tx, tr)


@functools.cache
def _ref_trees(name: str, n: int, m: int = None, block: int = 64):
    """The reference's trees (sources, targets) and sorted parts."""
    kernel, (sx, sr, ss, tx, tr) = _parts(name, n, m=m)
    stree, sp, _ = jbuild.build_tree(jax_parts(sx, sr, ss), block)
    ttree, tp, _ = jbuild.build_tree(jax_parts(tx, tr), block)
    return kernel, stree, sp, ttree, tp


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------- local_rows

@pytest.mark.parametrize("ndev", [2, 4, 16])
@pytest.mark.parametrize("levels", [5, 6, 7, 8, 9])
def test_local_rows_exact(levels, ndev):
    glob, loc = mesh.local_rows(levels, ndev)
    rglob, rloc = jmesh.local_rows(levels, ndev)
    np.testing.assert_array_equal(glob, rglob)
    np.testing.assert_array_equal(loc, rloc)
    assert glob.dtype == rglob.dtype and loc.dtype == rloc.dtype


# ------------------------------------------------------ top / sub lists

LIST_CASES = {
    # (workload, n sources, n targets, chunks)
    "grav3d-4": ("grav3d", 4096, None, 4),
    # a source tree deeper than the target tree: the leaf level refines
    "grav3d-deep-src": ("grav3d", 4096, 1024, 2),
}


@pytest.mark.parametrize("case", list(LIST_CASES))
def test_top_and_sub_lists_exact(case):
    """_dtt_lists_top, then _dtt_lists_sub for every chunk root, plain
    and (where the source tree is no deeper) with leaf_pair2, on the
    reference's trees: every id, n_valid and overflow equal."""
    name, n, m, n_chunks = LIST_CASES[case]
    _, stree, _, ttree, _ = _ref_trees(name, n, m)
    s_t, t_t = interop.tree_from_numpy(stree), interop.tree_from_numpy(ttree)
    theta = 1.2
    split = n_chunks.bit_length() - 1
    ls, lt = stree.levels, ttree.levels
    rt, rs, rcand, rov = jlists._dtt_lists_top(stree, ttree, theta, ls,
                                               split, W)
    tt, ts_, cand, ov = lists._dtt_lists_top(s_t, t_t, theta, ls, split, W)
    for got, ref in ((tt, rt), (ts_, rs), (cand, rcand)):
        _eq(got, ref)
    assert int(ov) == int(rov)
    pairs = [False, True] if ls <= lt else [False]
    for c in range(n_chunks):
        root = n_chunks + c
        for p2 in pairs:
            ref = jlists._dtt_lists_sub(stree, ttree, theta,
                                        rcand[c:c + 1], jnp.int32(root), ls,
                                        lt, split, W, leaf_pair2=p2)
            got = lists._dtt_lists_sub(s_t, t_t, theta, cand[c:c + 1], root,
                                       ls, lt, split, W, leaf_pair2=p2)
            assert len(got) == len(ref)
            for g, r in zip(got[:-2], ref[:-2]):
                _eq(g, r)
            assert int(got[-2]) == int(ref[-2])
            assert int(got[-1]) == int(ref[-1])


def test_sub_lists_refuse_pairs_on_a_deep_source_tree():
    _, stree, _, ttree, _ = _ref_trees("grav3d", 4096, 1024)
    s_t, t_t = interop.tree_from_numpy(stree), interop.tree_from_numpy(ttree)
    _, _, cand, _ = lists._dtt_lists_top(s_t, t_t, 1.2, s_t.levels, 1, W)
    with pytest.raises(ValueError, match="leaf_pair2"):
        lists._dtt_lists_sub(s_t, t_t, 1.2, cand[:1], 2, s_t.levels,
                             t_t.levels, 1, W, leaf_pair2=True)


# ---------------------------------------- target_geo_slab, _downward_local

@pytest.mark.parametrize("name,n_chunks", [("grav3d", 4), ("vort2d", 2)])
def test_target_geo_slab_matches_reference(name, n_chunks):
    _, _, _, ttree, tp = _ref_trees(name, 4096)
    t_t = interop.tree_from_numpy(ttree)
    t_p = interop.parts_from_numpy(tp)
    split = n_chunks.bit_length() - 1
    for c in range(n_chunks):
        root = n_chunks + c
        ref = np.asarray(jeq.target_geo_slab(ttree, tp, root, 3, split))
        got = eq.target_geo_slab(t_t, t_p, root, 3, split).numpy()
        assert got.shape == ref.shape
        assert scale_rel_max(got, ref) <= 1e-6


# one program per shape (the reference calls it inside its jitted step)
_jax_downward = jax.jit(jmesh._downward_local, static_argnames=(
    "order", "levels", "split", "block_size"))


@pytest.mark.parametrize("name,n_chunks", [("grav3d", 4), ("vort2d", 2)])
def test_downward_local_matches_reference(name, n_chunks):
    """The same slab accumulator (random, seeded), boxes and points
    through both prolongations, for every owner."""
    kernel, _, _, ttree, tp = _ref_trees(name, 4096)
    t_t = interop.tree_from_numpy(ttree)
    t_p = interop.parts_from_numpy(tp)
    split = n_chunks.bit_length() - 1
    glob, _ = mesh.local_rows(ttree.levels, n_chunks)
    rng = np.random.default_rng(3)
    for c in range(n_chunks):
        geo = eq.target_geo_slab(t_t, t_p, n_chunks + c, 3, split)
        R, _, b = geo.shape
        out0 = rng.standard_normal((R, b, kernel.od)).astype(np.float32)
        pos = geo[:, :kernel.pd, :].transpose(1, 2)
        nc, ns = t_t.nc[glob[c]], t_t.ns[glob[c]]
        got = mesh._downward_local(torch.from_numpy(out0.copy()), nc, ns,
                                   pos, 3, ttree.levels, split, b, c)
        ref = _jax_downward(
            jnp.asarray(out0), jnp.asarray(nc.numpy()),
            jnp.asarray(ns.numpy()), jnp.asarray(pos.numpy()), order=3,
            levels=ttree.levels, split=split, block_size=b,
            dev=jnp.int32(c))
        assert scale_rel_max(got.numpy(), np.asarray(ref)) <= 1e-6


def test_prolong_sliced_equals_unsliced(monkeypatch):
    """_prolong_sliced's slices give the whole contraction's rows."""
    g = torch.Generator().manual_seed(0)
    rows, p, m = 10, 16, 64
    pts = torch.rand((rows, p, 3), generator=g)
    nc = torch.rand((rows, 3), generator=g)
    ns = torch.rand((rows, 3), generator=g) + 0.5
    u = torch.randn((rows, m, 4), generator=g)
    whole = eq.prolong_factored(pts, nc, ns, 3, u)
    monkeypatch.setattr(mesh, "_PROLONG_SLICE_ROWS", 4)
    sliced = mesh._prolong_sliced(pts, nc, ns, 3, u)
    assert torch.allclose(sliced, whole, rtol=1e-6, atol=0)


def test_anterp_batches_equal_one_batch(monkeypatch):
    """barycentric_fm anterpolates _ANTERP_NODES nodes at a time (which
    bounds the featurize's temporaries at 1e8): batches of 3 nodes give
    the whole level's rows bit for bit."""
    g = torch.Generator().manual_seed(1)
    parts = P.random_in_cube(g, 5000, 3, 3, True)
    tree, sp, _ = build.build_tree(parts, 64)
    whole = eq.barycentric_fm(tree, sp, 3, "vortgrad3d", pad8=False)
    monkeypatch.setattr(eq, "_ANTERP_NODES", 3)
    assert torch.equal(eq.barycentric_fm(tree, sp, 3, "vortgrad3d",
                                         pad8=False), whole)


# -------------------------------------------- the solve vs the JAX package

@pytest.mark.parametrize("name,n_chunks", [("grav3d", 4), ("vort2d", 2)])
def test_chunked_matches_reference_chunked(name, n_chunks):
    """The same numpy inputs through both packages' solve_dtt_chunked:
    n_valid and overflow exact, outputs within rel-RMS 1e-5, in both
    output forms (the tree-order leaves and the permutation exact)."""
    kernel, (sx, sr, ss, tx, tr) = _parts(name, 4096)
    jk = jget_kernel(name)
    jcfg = JConfig(**KW, pair_backend="xla")
    (rleaf, rtg), rinfo = jchunked.solve_dtt_chunked(
        jk, jcfg, jax_parts(sx, sr, ss), jax_parts(tx, tr),
        n_chunks=n_chunks, unscramble=False)
    ref = np.zeros((tx.shape[0], kernel.od), np.float32)
    rtg = np.asarray(rtg)
    real = rtg < tx.shape[0]
    ref[rtg[real]] = np.asarray(rleaf)[real]
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    out, info = chunked.solve_dtt_chunked(kernel, CFG, srcs, targs,
                                          n_chunks=n_chunks)
    (leaf, tg), info2 = chunked.solve_dtt_chunked(
        kernel, CFG, srcs, targs, n_chunks=n_chunks, unscramble=False)
    for got in (info, info2):
        assert int(got.n_valid) == int(rinfo.n_valid)
        assert int(got.overflow) == int(rinfo.overflow) == 0
    _eq(tg, rtg)
    assert rel_rms(out.numpy(), ref) <= 1e-5
    assert rel_rms(leaf.numpy()[real], np.asarray(rleaf)[real]) <= 1e-5
    assert torch.equal(out[tg[torch.from_numpy(real)]],
                       leaf[torch.from_numpy(real)])


# -------------------------- mirrors of tests/test_traverse.py:270-372

def _mono(kernel, cfg, srcs, targs):
    plan = treecode.prepare(kernel, cfg, srcs, targs)
    return dtt.solve_dtt(kernel, cfg, plan)


def test_chunked_solve_matches_plain():
    """Chunked against the port's monolithic solve (rtol 1e-4 / atol
    1e-6); the ownership paths (make_problem, make_srcs/make_targs) give
    the same output bit for bit."""
    kernel, (sx, sr, ss, tx, tr) = _parts("grav3d", 4096, seed=2)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    ref, rinfo = _mono(kernel, CFG, srcs, targs)
    assert int(rinfo.overflow) == 0
    out, info = chunked.solve_dtt_chunked(kernel, CFG, srcs, targs,
                                          n_chunks=4)
    assert int(info.overflow) == 0
    assert int(info.n_valid) == int(rinfo.n_valid)
    out2, _ = chunked.solve_dtt_chunked(
        kernel, CFG, make_problem=lambda: (torch_parts(sx, sr, ss),
                                           torch_parts(tx, tr)), n_chunks=4)
    out3, _ = chunked.solve_dtt_chunked(
        kernel, CFG, make_srcs=lambda: torch_parts(sx, sr, ss),
        make_targs=lambda: torch_parts(tx, tr), n_chunks=4)
    assert torch.equal(out2, out) and torch.equal(out3, out)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("fetch", ["dma_i", "pregather"])
def test_chunked_solve_fetch_matches(fetch):
    """Block 128, the dma_i fetch (rows padded to 8) and pregather (lean
    rows, K8's twin) against the default chunked run."""
    kernel, (sx, sr, ss, tx, tr) = _parts("grav3d", 4096, seed=4)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = CFG.replace(block_size=128)
    ref, rinfo = chunked.solve_dtt_chunked(kernel, cfg, srcs, targs,
                                           n_chunks=4)
    out, info = chunked.solve_dtt_chunked(
        kernel, cfg.replace(pair_fetch=fetch, pair_group=8), srcs, targs,
        n_chunks=4)
    assert int(rinfo.overflow) == int(info.overflow) == 0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("fetch", ["dma_i", "pregather"])
@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunked_solve_leaf_pair2_matches(n_chunks, fetch, monkeypatch):
    """The paired leaf pass (K2's / K9's twin on the shifted views)
    against the plain chunked run: n_valid equal, rtol 1e-4 / atol
    1e-6; every paired launch ran on a view one row into its slab and
    left that view's rows 0/1 as they were: slab rows 1-2, top rows
    whose sums the downward pass reads."""
    kernel, (sx, sr, ss, tx, tr) = _parts("grav3d", 4096, seed=5)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = CFG.replace(block_size=128, pair_fetch=fetch, pair_group=8)
    ref, rinfo = chunked.solve_dtt_chunked(kernel, cfg, srcs, targs,
                                           n_chunks=n_chunks)
    spy = PairedSpy(cuda_pairs.exec_pairs_t2)
    monkeypatch.setattr(cuda_pairs, "exec_pairs_t2", spy)
    out, info = chunked.solve_dtt_chunked(
        kernel, cfg.replace(dtt_leaf_pair2=True), srcs, targs,
        n_chunks=n_chunks)
    assert int(rinfo.overflow) == int(info.overflow) == 0
    assert int(info.n_valid) == int(rinfo.n_valid)
    assert spy.calls == [(1, True)] * n_chunks
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_chunked_solve_dead_chunk_skipped(monkeypatch):
    """Ragged N with a whole level-`split` subtree of padding: 6144 at
    block 64 is 96 live leaves of 128, so of 4 chunks the last is dead.
    It is skipped (no chunk step) and the result is the monolithic
    solve's."""
    kernel, (sx, sr, ss, tx, tr) = _parts("grav3d", 6144, seed=6)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    ref, rinfo = _mono(kernel, CFG, srcs, targs)
    assert int(rinfo.overflow) == 0
    steps = []
    step = chunked._chunk_step

    def spy(*a, **kw):
        steps.append(a[9])
        return step(*a, **kw)

    monkeypatch.setattr(chunked, "_chunk_step", spy)
    out, info = chunked.solve_dtt_chunked(kernel, CFG, srcs, targs,
                                          n_chunks=4)
    assert steps == [0, 1, 2]
    assert int(info.overflow) == 0
    assert int(info.n_valid) == int(rinfo.n_valid)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_chunked_solve_profile_prints_phases(capsys):
    kernel, (sx, sr, ss, tx, tr) = _parts("grav3d", 2048, seed=8)
    chunked.solve_dtt_chunked(kernel, CFG, torch_parts(sx, sr, ss),
                              torch_parts(tx, tr), n_chunks=2, profile=True)
    labels = [ln.split()[1] for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[chunked]")]
    assert labels == ["tgt", "src", "lists_top", "featurize", "chunk",
                      "chunk"]


# ---------------------------------------------------------------- refusals

REFUSALS = {
    "order<0": (dict(order=-1), 2, 4096, "order must be >= 0"),
    "split-rows": (dict(block_size=32, order=6), 2, 4096,
                   "split equivalent rows"),
    "chunks>=leaves": ({}, 64, 4096, "more target leaves than chunks"),
    "chunks-not-pow2": ({}, 3, 4096, "power of two"),
    "accum-fp64": (dict(accum_dtype=torch.float64), 2, 4096,
                   "fp32 executors"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_chunked_refusals(case):
    kw, n_chunks, n, msg = REFUSALS[case]
    kernel, (sx, sr, ss, tx, tr) = _parts("grav3d", n, seed=9)
    with pytest.raises(ValueError, match=msg):
        chunked.solve_dtt_chunked(kernel, CFG.replace(**kw),
                                  torch_parts(sx, sr, ss),
                                  torch_parts(tx, tr), n_chunks=n_chunks)


def test_chunked_cuda_backend_refuses_cpu_tensors():
    """pair_backend 'cuda' with CPU particles raises: no chunk step
    quietly runs the twins in the kernels' place."""
    kernel, (sx, sr, ss, tx, tr) = _parts("grav3d", 4096, seed=9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        chunked.solve_dtt_chunked(kernel, CFG.replace(pair_backend="cuda"),
                                  torch_parts(sx, sr, ss),
                                  torch_parts(tx, tr), n_chunks=2)
