"""The out-of-core DTT (traverse/outofcore.py) and the stages the capacity
tiers add (build_tree's force_plan, target_geo_slab's x_base) against the
JAX package on the CPU.

Both packages get one numpy-backed chunk generator (coordinates drawn
without repeats per axis, so both trees sort alike) at split 2 with four
chunks, the last ragged, in the reference test's configuration (block
128, order 4, theta 1.3, frontier 192, cap 64, pregather). The reference
solve compiles its jits inside the call (~30 s here), so it runs once
per module, in a thread started with the fixture `solved`, while this
process runs the port's solve and the tests that read only the port;
test_outofcore_matches_reference, the one test that reads the
reference's solve, comes last. Tolerances: the
partition, gidx, n_valid and overflow exact; the leaf outputs within 1e-5
rel-RMS of the reference's on the real target slots (pad slots hold
extrapolated junk in both packages); < 3e-4 against the fp64 oracle, as
tests/test_outofcore.py asserts; tree and slab floats within 1e-6 of the
largest value.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from _torch_parity import (jax_parts, jax_tree, kernel_inputs, rel_rms,
                           scale_rel_max, torch_parts, unique_coords)
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops.kernels import get_kernel as jget_kernel
from onbody_tpu.traverse import outofcore as jooc
from onbody_tpu.tree import build as jbuild
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import direct, dtt, outofcore, treecode
from onbody_tpu_torch.tree import build
from onbody_tpu_torch.tree import equivalents as eq

torch.set_num_threads(1)

# the reference test's configuration (tests/test_outofcore.py:33-36)
KW = dict(block_size=128, order=4, theta_dtt=1.3, frontier_width=192,
          list_width=512, cap_groups_dtt=64, pair_fetch="pregather")
N = 30_000            # 4 subtrees of 8192 slots, every one with reals
M_CHUNK = 1 << 13     # 4 chunks, the last of 5424
SPLIT = 2
ORACLE_SKIP = 25


def _problem(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    sx = unique_coords(rng, n)
    ss = (rng.uniform(-1, 1, (n, 1)) / n).astype(np.float32)
    sr = np.full(n, n ** (-1 / 3), np.float32)
    tx = unique_coords(rng, n)
    tr = np.full(n, n ** (-1 / 3), np.float32)
    return sx, sr, ss, tx, tr


def _chunks(n: int, make):
    def gen(c):
        sl = slice(c * M_CHUNK, min(n, (c + 1) * M_CHUNK))
        return make(sl)
    return gen


def _gens(n: int, parts, arrays):
    sx, sr, ss, tx, tr = arrays
    return (_chunks(n, lambda s: parts(sx[s], sr[s], ss[s])),
            _chunks(n, lambda s: parts(tx[s], tr[s])))


@pytest.fixture(scope="module")
def solved():
    """(the arrays, the reference's solve as a future, the port's
    solve); the reference solves in a thread, joined at the module's
    end at the latest."""
    arrays = _problem(N)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(
            jooc.solve_dtt_outofcore, jget_kernel("grav3d"),
            JConfig(**KW, tree_defer_rs=True), N,
            *_gens(N, jax_parts, arrays), m_chunk=M_CHUNK, split=SPLIT)
        got = outofcore.solve_dtt_outofcore(
            get_kernel("grav3d"), SolverConfig(**KW), N,
            *_gens(N, torch_parts, arrays), m_chunk=M_CHUNK, split=SPLIT,
            device="cpu")
        yield arrays, ref, got


@pytest.fixture(scope="module")
def oracle(solved):
    """The fp64 oracle on every ORACLE_SKIP-th target (the whole 3e4 x 3e4
    sum takes ~100 s here)."""
    sx, sr, ss, tx, tr = solved[0]
    return direct.direct_oracle(get_kernel("grav3d"),
                                torch_parts(sx, sr, ss), torch_parts(tx, tr),
                                tskip=ORACLE_SKIP).numpy()


def _by_original(res, n: int, od: int):
    """The tier's leaf outputs in original target order; asserts that
    every real target slot is produced exactly once."""
    gidx = res["gidx"]
    real = gidx < n
    np.testing.assert_array_equal(np.bincount(gidx[real], minlength=n),
                                  np.ones(n))
    out = np.zeros((n, od), np.float32)
    out[gidx[real]] = res["out"][real]
    return out


def test_partition_side_identical(solved):
    """_partition_side of the source side: per-subtree stores, original
    indices and counts identical (the chunk sort is stable in both)."""
    arrays = solved[0]
    sizes = [M_CHUNK] * 3 + [N - 3 * M_CHUNK]
    n_pad = build.plan(N, KW["block_size"])[1]
    jgen, _ = _gens(N, jax_parts, arrays)
    tgen, _ = _gens(N, torch_parts, arrays)

    def jcols(c):
        p = jgen(c)
        return (p.x[:, 0], p.x[:, 1], p.x[:, 2], p.r, p.s[:, 0]), p.x

    def tcols(c):
        p = tgen(c)
        return (p.x[:, 0], p.x[:, 1], p.x[:, 2], p.r, p.s[:, 0]), p.x

    ref = jooc._partition_side(jcols, sizes, SPLIT, n_pad, 5)
    got = outofcore._partition_side(tcols, sizes, SPLIT, n_pad, 5)
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.lo, ref.lo)
    np.testing.assert_array_equal(got.hi, ref.hi)
    for t in range(1 << SPLIT):
        np.testing.assert_array_equal(got.store[t], ref.store[t])
        np.testing.assert_array_equal(got.idx[t], ref.idx[t])
        assert got.idx[t].dtype == ref.idx[t].dtype


def test_outofcore_matches_oracle(solved, oracle):
    _, _, (res, info) = solved
    assert info["overflow"] == 0
    # every real target slot produced exactly once
    out = _by_original(res, N, get_kernel("grav3d").od)
    assert rel_rms(out[::ORACLE_SKIP], oracle) < 3e-4
    assert info["h2d_bytes"] > 0 and info["d2h_bytes"] > 0
    assert [c["chunk"] for c in info["chunks"]] == [0, 1, 2, 3]


def test_outofcore_span_mode(solved, oracle):
    """The tier at a span-mode configuration (tree_span_top 4 > split 2)
    builds its subtrees in median mode, so it gives the median-mode solve
    of `solved` bit for bit (which the tests above hold against the JAX
    package): overflow 0, < 3e-4 against the fp64 oracle, and within 3e-4
    rel-RMS of the monolithic span-mode solve (prepare + solve_dtt),
    which also meets the oracle."""
    arrays, _, (med, med_info) = solved
    kernel = get_kernel("grav3d")
    cfg = SolverConfig(**KW, tree_mode="span", tree_span_top=4)
    res, info = outofcore.solve_dtt_outofcore(
        kernel, cfg, N, *_gens(N, torch_parts, arrays), m_chunk=M_CHUNK,
        split=SPLIT, device="cpu")
    np.testing.assert_array_equal(res["gidx"], med["gidx"])
    np.testing.assert_array_equal(res["out"], med["out"])
    assert (info["n_valid"], info["overflow"]) == (med_info["n_valid"], 0)
    out = _by_original(res, N, kernel.od)
    sx, sr, ss, tx, tr = arrays
    mono, minfo = dtt.solve_dtt(kernel, cfg, treecode.prepare(
        kernel, cfg, torch_parts(sx, sr, ss), torch_parts(tx, tr)))
    mono = mono.numpy()
    assert int(minfo.overflow) == 0
    print(f"out-of-core, span configuration: tier vs oracle "
          f"{rel_rms(out[::ORACLE_SKIP], oracle):.3e}, monolithic vs oracle "
          f"{rel_rms(mono[::ORACLE_SKIP], oracle):.3e}, tier vs monolithic "
          f"{rel_rms(out, mono):.3e}")
    assert rel_rms(out[::ORACLE_SKIP], oracle) < 3e-4
    assert rel_rms(mono[::ORACLE_SKIP], oracle) < 3e-4
    assert rel_rms(out, mono) < 3e-4


def test_padding_only_subtree_contributes_nothing():
    """n = 10000 fills 3 of the 4 subtrees (4096 slots each, the third
    in part): the top lists reference the padding-only subtree's nodes,
    which have no rows (the reference asserts there); the port gathers
    the inert row for them, and the solve still meets the oracle."""
    n = 10_000
    arrays = _problem(n, seed=9)
    kernel = get_kernel("grav3d")
    res, info = outofcore.solve_dtt_outofcore(
        kernel, SolverConfig(**KW), n, *_gens(n, torch_parts, arrays),
        m_chunk=M_CHUNK, split=SPLIT, device="cpu")
    assert info["overflow"] == 0
    sx, sr, ss, tx, tr = arrays
    ref = direct.direct_oracle(kernel, torch_parts(sx, sr, ss),
                               torch_parts(tx, tr), tskip=5).numpy()
    gidx = res["gidx"]
    real = gidx < n
    out = np.zeros((n, kernel.od), np.float32)
    out[gidx[real]] = res["out"][real]
    assert rel_rms(out[::5], ref) < 3e-4
    assert info["chunks"][-1]["chunk"] == 2     # the dead subtree skipped
    assert np.isfinite(res["out"][real]).all()


def test_force_plan_tree_matches_reference():
    """build_tree(force_plan=(levels, n_pad)) builds the fixed shape the
    tiers build every subtree at: 1000 particles in 32 leaves of 64 where
    plan() gives 16; the tree and the sorted parts equal the
    reference's."""
    kernel = get_kernel("grav3d")
    sx, sr, ss, _, _ = kernel_inputs(kernel, 4, 1000)
    forced = (5, 32 * 64)
    assert build.plan(1000, 64) != forced
    rtree, rsp, rg = jbuild.build_tree(jax_parts(sx, sr, ss), 64,
                                       force_plan=forced)
    tree, sp, g = build.build_tree(torch_parts(sx, sr, ss), 64,
                                   force_plan=forced)
    assert (tree.levels, sp.x.shape[0]) == forced
    np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(sp.x.numpy(), np.asarray(rsp.x))
    for f in ("nc", "ns", "alive"):
        np.testing.assert_array_equal(getattr(tree, f).numpy(),
                                      np.asarray(getattr(rtree, f)))
    for f in ("nr", "x", "s", "pr"):
        assert scale_rel_max(getattr(tree, f).numpy(),
                             np.asarray(getattr(rtree, f))) < 1e-6, f
    with pytest.raises(ValueError):
        build.build_tree(torch_parts(sx, sr, ss), 64, force_plan=(3, 512))


def test_target_geo_slab_x_base():
    """_target_geo_slab_impl on one subtree's slots with x_base equals the
    slab made from the whole array (the leaf and grid rows; the top rows'
    radius is the mean over the arrays given, as in the reference) and
    the reference's with the same x_base on the same tree."""
    kernel = get_kernel("grav3d")
    _, _, _, tx, tr = kernel_inputs(kernel, 6, 4096)
    ttree, tsp, _ = build.build_tree(torch_parts(tx, tr), 64)
    split, order = 2, 3
    per = tsp.x.shape[0] >> split
    rtree = jax_tree(ttree)
    for c in range(1 << split):
        root = (1 << split) + c
        whole = eq._target_geo_slab_impl(ttree, tsp.x, tsp.r, root, order,
                                         ttree.levels, split, 64)
        xs, rs = tsp.x[c * per:(c + 1) * per], tsp.r[c * per:(c + 1) * per]
        part = eq._target_geo_slab_impl(ttree, xs, rs, root, order,
                                        ttree.levels, split, 64,
                                        x_base=c * per)
        ndev = 1 << split
        np.testing.assert_array_equal(part[ndev:].numpy(),
                                      whole[ndev:].numpy())
        np.testing.assert_array_equal(part[:ndev, :3].numpy(),
                                      whole[:ndev, :3].numpy())
        ref = jeq._target_geo_slab_impl(
            rtree, xs.numpy(), rs.numpy(), root, order, ttree.levels,
            split, 64, x_base=c * per)
        assert scale_rel_max(part.numpy(), np.asarray(ref)) < 1e-6


def test_outofcore_matches_reference(solved):
    _, ref, (res, info) = solved
    rres, rinfo = ref.result()
    np.testing.assert_array_equal(res["gidx"], rres["gidx"])
    assert (info["n_valid"], info["overflow"]) == (rinfo["n_valid"],
                                                   rinfo["overflow"])
    real = res["gidx"] < N
    assert rel_rms(res["out"][real], rres["out"][real]) < 1e-5
