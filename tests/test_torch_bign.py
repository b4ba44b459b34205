"""The stratified DTT (traverse/bigN.py) and the stages it adds to the
equivalents and kernels (barycentric_fm's return_root, featurize_flat)
against the JAX package on the CPU.

Both packages' make_stratified_gen is replaced by one numpy-backed
generator: each stratum's coordinates drawn without repeats per axis
inside stratum_box, so both trees sort alike. The reference's
configuration (tests/test_bign.py: block 128, order 4, theta 1.3,
frontier 192, list_width 512, cap 64, pregather) runs at split 2 with
slab_cache 1, so every deep owner visit but the repeated one misses and
rebuilds. The reference solve compiles its jits inside the call (~30 s
here), so it runs once per module, in a thread started with the fixture
`solved`, while this process runs the port's solve and the tests that
read only the port; the two tests that read the reference's solve come
last. Tolerances: alive, n_valid,
overflow and the cache's hits and misses exact; tree floats within 1e-6
of the largest value; the subsample's outputs within 1e-5 rel-RMS of the
reference's; val_rel_rms within 1% of the reference's and < 3e-4 (the
reference test's bound).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_parts, jax_tree, kernel_inputs, rel_rms,
                           scale_rel_max, torch_parts)
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as jkernels
from onbody_tpu.ops.kernels import get_kernel as jget_kernel
from onbody_tpu.traverse import bigN as jbign
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import cuda_pairs
from onbody_tpu_torch.ops.kernels import featurize_flat, get_kernel
from onbody_tpu_torch.traverse import bigN, dtt, treecode
from onbody_tpu_torch.tree import build
from onbody_tpu_torch.tree import equivalents as eq

torch.set_num_threads(1)

KW = dict(block_size=128, order=4, theta_dtt=1.3, frontier_width=192,
          list_width=512, cap_groups_dtt=64, pair_fetch="pregather")
N = 12_000            # 4 strata of 3000 in 4096 slots each
SPLIT = 2
RUN = dict(split=SPLIT, slab_cache=1, n_val=256, profile=False)


def _stratum(n: int, split: int, sd: int, sources: bool, t: int):
    m = n >> split
    rng = np.random.default_rng(1000 * int(sources) + t)
    lo, hi = bigN.stratum_box(t, split)
    u = np.stack([rng.choice(1 << 22, m, replace=False) / float(1 << 22)
                  for _ in range(3)], 1)
    x = (lo + u * (hi - lo)).astype(np.float32)
    r = np.full(m, (1.0 / n) ** (1 / 3), np.float32)
    s = ((rng.uniform(-1, 1, (m, sd)) / n).astype(np.float32)
         if sources and sd else None)
    return x, r, s


def _jgen(key, n, split, sd, sources):
    return lambda t: jax_parts(*_stratum(n, split, sd, sources, t))


def _tgen(seed, n, split, sd, sources, device="cpu"):
    return lambda t: torch_parts(*_stratum(n, split, sd, sources, t))


class _NumpySpy:
    """numpy for the reference module, recording np.concatenate's results
    (its last one is the subsample's outputs)."""

    def __init__(self):
        self.cat = []

    def __getattr__(self, name):
        return getattr(np, name)

    def concatenate(self, *a, **kw):
        out = np.concatenate(*a, **kw)
        self.cat.append(out)
        return out


def _port(exec_groups: int = 4096):
    dbg = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bigN, "make_stratified_gen", _tgen)
        stats, info = bigN.solve_dtt_stratified(
            get_kernel("grav3d"), SolverConfig(**KW), N, 9,
            exec_groups=exec_groups, debug_out=dbg, device="cpu", **RUN)
    return stats, info, dbg


def _reference():
    """The reference's solve on the same strata: its (stats, info), its
    debug_out and the subsample's outputs. Its module's np is the spy
    while it runs: no other call into that module may concatenate
    meanwhile (test_slab_cache_matches_reference's _SlabCache does
    not)."""
    spy, dbg = _NumpySpy(), {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbign, "make_stratified_gen", _jgen)
        mp.setattr(jbign, "np", spy)
        ref = jbign.solve_dtt_stratified(
            jget_kernel("grav3d"), JConfig(**KW, tree_defer_rs=True), N,
            jax.random.PRNGKey(9), exec_groups=4096, debug_out=dbg, **RUN)
    return ref, dbg, spy.cat[-1]


@pytest.fixture(scope="module")
def solved():
    """(_reference as a future, the port's solve); the reference solves
    in a thread, joined at the module's end at the latest."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_reference)
        yield ref, _port()


def test_exec_groups_slices_agree(solved):
    """exec_groups 32 cuts every pass's groups (40-150 here) into several
    executor calls, where 4096 (and 1024: the port slices the trimmed
    groups, the reference its power-of-two capacity) makes one; the
    outputs agree within 1e-6."""
    _, (stats, info, dbg) = solved
    calls = []
    keep = bigN._exec_groups_slab

    def count(*a, **kw):
        calls.append(a[4].shape[0])
        return keep(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bigN, "_exec_groups_slab", count)
        s32, i32, d32 = _port(32)
    assert max(calls) == 32 and len(calls) > 20
    assert i32 == info
    assert rel_rms(d32["val_got"], dbg["val_got"]) < 1e-6


def test_stratified_span_mode(solved):
    """The tier at a span-mode configuration (tree_span_top 4 > split 2)
    builds its strata in median mode, so it gives the median-mode solve
    of `solved` bit for bit (which the tests above hold against the JAX
    package): overflow 0, no NaN, val_rel_rms < 3e-4, and the subsample
    within 3e-4 rel-RMS of the monolithic span-mode solve (prepare +
    solve_dtt on all strata at once), which also meets the reference
    sum."""
    _, (med, med_info, med_dbg) = solved
    kernel = get_kernel("grav3d")
    cfg = SolverConfig(**KW, tree_mode="span", tree_span_top=4)
    dbg = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bigN, "make_stratified_gen", _tgen)
        stats, info = bigN.solve_dtt_stratified(
            kernel, cfg, N, 9, debug_out=dbg, device="cpu", **RUN)
    assert info == med_info and info["overflow"] == 0
    np.testing.assert_array_equal(dbg["val_got"], med_dbg["val_got"])
    assert stats["val_rel_rms"] == med["val_rel_rms"] < 3e-4
    assert stats["out_nan"] == 0
    ndev, m = 1 << SPLIT, N >> SPLIT
    src = [_stratum(N, SPLIT, 1, True, t) for t in range(ndev)]
    tgt = [_stratum(N, SPLIT, 0, False, t) for t in range(ndev)]
    srcs = torch_parts(*(np.concatenate(a) for a in zip(*src)))
    targs = torch_parts(np.concatenate([x for x, _, _ in tgt]),
                        np.concatenate([r for _, r, _ in tgt]))
    mono, minfo = dtt.solve_dtt(kernel, cfg,
                                treecode.prepare(kernel, cfg, srcs, targs))
    assert int(minfo.overflow) == 0
    # the subsample: every tskip-th target of each stratum, the strata in
    # the tier's chunk order (reversed)
    tskip = N // RUN["n_val"]
    idx = np.concatenate([t * m + np.arange(0, m, tskip)
                          for t in range(ndev - 1, -1, -1)])
    mono = mono.numpy()[idx]
    print(f"stratified, span configuration: val_rel_rms "
          f"{stats['val_rel_rms']:.3e}, monolithic vs reference sum "
          f"{rel_rms(mono, dbg['val_ref']):.3e}, tier vs monolithic "
          f"{rel_rms(dbg['val_got'], mono):.3e}")
    assert rel_rms(mono, dbg["val_ref"]) < 3e-4
    assert rel_rms(dbg["val_got"], mono) < 3e-4


def test_slab_cache_matches_reference():
    """_SlabCache on a scripted sequence of puts and gets: the same
    builds, order, hits and misses as the reference's class."""
    script = [("put", 0), ("put", 1), ("put", 2), ("get", 1), ("get", 0),
              ("get", 3), ("get", 1), ("put", 3), ("get", 2), ("get", 2),
              ("put", 0), ("get", 3), ("get", 0)]
    logs = []
    for cls in (jbign._SlabCache, bigN._SlabCache):
        built = []
        c = cls(lambda t: built.append(t) or f"slab{t}", 2)
        got = []
        for op, t in script:
            got.append(c.put(t, f"seed{t}") if op == "put" else c.get(t))
        logs.append((got, built, list(c.order), c.hits, c.misses))
    assert logs[0] == logs[1]


def test_stratified_generator_regenerates_bits():
    """The real make_stratified_gen: a stratum drawn twice is the same
    bits, inside its box, and strata and sides differ."""
    gs = bigN.make_stratified_gen(12345, 4096, 3, 1, True)
    gt = bigN.make_stratified_gen(12345, 4096, 3, 0, False)
    for t in (0, 5, 7):
        a, b = gs(t), gs(t)
        assert torch.equal(a.x, b.x) and torch.equal(a.s, b.s)
        lo, hi = bigN.stratum_box(t, 3)
        assert (a.x.numpy() >= lo).all() and (a.x.numpy() <= hi).all()
        assert a.x.shape == (512, 3) and gt(t).s is None
        assert not torch.equal(a.x, gt(t).x)
    assert not torch.equal(gs(0).x - torch.tensor(bigN.stratum_box(0, 3)[0],
                                                  dtype=torch.float32),
                           gs(1).x - torch.tensor(bigN.stratum_box(1, 3)[0],
                                                  dtype=torch.float32))
    with pytest.raises(ValueError):
        bigN.make_stratified_gen(0, 1001, 3, 1, True)


def test_barycentric_fm_return_root():
    """return_root=True: the same rows and the root's raw grid and
    strengths, against the reference's on the same tree; out= writes the
    same rows into a given view."""
    kernel = get_kernel("grav3d")
    sx, sr, ss, _, _ = kernel_inputs(kernel, 2, 2048)
    tree, sp, _ = build.build_tree(torch_parts(sx, sr, ss), 64)
    rsp = jax_parts(sp.x.numpy(), sp.r.numpy(), sp.s.numpy())
    rfm, rgrid, req = jeq.barycentric_fm(jax_tree(tree), rsp, 3, "grav3d",
                                         pad8=False, flat=True,
                                         return_root=True)
    fm, grid, eqs = eq.barycentric_fm(tree, sp, 3, "grav3d", pad8=False,
                                      return_root=True)
    assert torch.equal(fm, eq.barycentric_fm(tree, sp, 3, "grav3d",
                                             pad8=False))
    # written in place into a view of a larger slab, as the tiers do
    slab = torch.full((fm.shape[0] + 3,) + fm.shape[1:], 7.0)
    eq.barycentric_fm(tree, sp, 3, "grav3d", pad8=False, out=slab[3:])
    assert torch.equal(slab[3:], fm) and (slab[:3] == 7.0).all()
    with pytest.raises(ValueError, match="out"):
        eq.barycentric_fm(tree, sp, 3, "grav3d", pad8=False, out=slab[2:])
    assert grid.shape == (64, 3) and eqs.shape == (64, 1)
    assert scale_rel_max(grid.numpy(), np.asarray(rgrid)) < 1e-6
    assert scale_rel_max(eqs.numpy(), np.asarray(req)) < 1e-6
    assert scale_rel_max(fm.reshape(fm.shape[0], -1).numpy(),
                         np.asarray(rfm)) < 1e-6


@pytest.mark.parametrize("name", ["grav3d", "vort2d", "vort3d"])
def test_featurize_flat_matches_reference(name):
    """The port's (C, B) lean rows are the reference's flat vector after
    reshape(-1), value for value."""
    kernel = get_kernel(name)
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (64, kernel.pd)).astype(np.float32)
    rad = rng.uniform(0.1, 1, 64).astype(np.float32)
    s = rng.uniform(-1, 1, (64, kernel.sd)).astype(np.float32)
    got = featurize_flat(name, *map(torch.from_numpy, (pos, rad, s)))
    ref = jkernels.featurize_flat(name, jnp.asarray(pos), jnp.asarray(rad),
                                  jnp.asarray(s))
    np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(ref))


def test_inert_pad_row_is_featurized_safe():
    """The reference's 1e9 NaN case (tests/test_traverse.py:481): lean row
    0 is position 0, radius 1 (rad^2 = 1), strength 0, and a target block
    exactly at the origin with zero radii, fed only pad entries (source
    row 0), comes back finite and exactly zero."""
    kernel = get_kernel("grav3d")
    sx, sr, ss, _, _ = kernel_inputs(kernel, 3, 256)
    tree, sp, _ = build.build_tree(torch_parts(sx, sr, ss), 64)
    fm = eq.barycentric_fm(tree, sp, 3, "grav3d", pad8=False)
    row0 = fm[0].numpy()
    assert row0.shape == (5, 64)
    assert (row0[:3] == 0).all() and (row0[3] == 1).all() \
        and (row0[4] == 0).all()
    np.testing.assert_array_equal(
        row0, featurize_flat("grav3d", torch.zeros((64, 3)),
                             torch.ones(64), torch.zeros((64, 1))).numpy())
    tgt_geo = cuda_pairs.build_tgt_geo(torch.zeros((2, 64, 3)),
                                       torch.zeros((2, 64)))
    gt = torch.tensor([1])
    gs = torch.zeros((1, 8), dtype=torch.int64)
    out = cuda_pairs.exec_pairs(kernel, tgt_geo, fm, gt, gs,
                                fetch="pregather")
    got = out[1].numpy()
    assert np.isfinite(got).all() and np.abs(got).max() == 0.0


def test_global_trees_match_reference(solved):
    ref, (_, _, dbg) = solved
    _, rdbg, _ = ref.result()
    for side in ("stree", "ttree"):
        ref, got = rdbg[side], dbg[side]
        np.testing.assert_array_equal(got.alive.numpy(),
                                      np.asarray(ref.alive))
        for f in ("nc", "ns", "nr", "x", "s", "pr"):
            assert scale_rel_max(getattr(got, f).numpy(),
                                 np.asarray(getattr(ref, f))) < 1e-6, \
                (side, f)


def test_stratified_matches_reference(solved):
    ref, (stats, info, dbg) = solved
    (rstats, rinfo), _, rgot = ref.result()
    assert info == rinfo
    assert info["overflow"] == 0 and stats["out_nan"] == 0
    for k in ("cache_hits", "cache_misses", "n_val", "got_nan", "ref_nan"):
        assert stats[k] == rstats[k], k
    # slab_cache 1 forces rebuilds (the warm seed makes one get hit)
    assert stats["cache_misses"] >= 3
    assert rel_rms(dbg["val_got"], rgot) < 1e-5
    assert stats["val_rel_rms"] < 3e-4
    assert abs(stats["val_rel_rms"] - rstats["val_rel_rms"]) \
        < 0.01 * rstats["val_rel_rms"]
