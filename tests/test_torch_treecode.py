"""Port vs reference: the treecode path — the lean plan's feature-major
arrays (tree/equivalents.py) on the reference's own trees, and
solve_treecode{1,2,3} (traverse/treecode.py) on the same numpy inputs.
The MACs and the lists are in test_torch_treecode_lists.py.

Counts and overflow must be identical. Floats: the arrays rtol 1e-5 (other
einsum order); solver outputs within 5e-6 rel-RMS of the reference's
(fp32 sums in another order; vortgrad3d gradients 5e-5, the reference's
moment form of that body) and inside the reference's own bounds against
the fp64 oracle.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_parts, kernel_inputs, rel_rms, torch_parts)
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as JK
from onbody_tpu.traverse import direct as jdirect
from onbody_tpu.traverse import treecode as jtc
from onbody_tpu.tree import build as jbuild
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch import interop
from onbody_tpu_torch.config import SolverConfig, check_supported
from onbody_tpu_torch.ops import cuda_pairs as tpp
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.traverse import treecode as ttc
from onbody_tpu_torch.tree import equivalents as teq

torch.set_num_threads(1)

WORKLOADS = ["grav3d", "vort2d", "vort3d", "vortgrad3d"]
# the reference's treecode test configuration (tests/test_traverse.py)
CFG_KW = dict(block_size=64, order=4, frontier_width=256, list_width=512)
N = 2048


def _same(got, ref, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), what)


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


# -------------------------------------------------------- lean plan arrays

@pytest.fixture(scope="module", params=["grav3d", "vort2d", "vortgrad3d"])
def lean_trees(request):
    """Reference trees and sorted parts at block 128 (rows as wide as
    the Blocks path's, so the two layouts compare row for row)."""
    name = request.param
    k = TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(k, 70, 1500, 1300)
    st, sp, _ = jbuild.build_tree(jax_parts(sx, sr, ss), 128)
    tt, tp, _ = jbuild.build_tree(jax_parts(tx, tr), 128,
                                  need_r=k.uses_tr)
    return name, st, sp, tt, tp


@pytest.mark.parametrize("pad8", [False, True], ids=["lean", "pad8"])
def test_barycentric_fm_matches_reference_and_full_plan(lean_trees, pad8):
    name, st, sp, _, _ = lean_trees
    order = 4
    ref = np.asarray(jeq.barycentric_fm(st, sp, order, name, pad8=pad8))
    tree, parts = interop.tree_from_numpy(st), interop.parts_from_numpy(sp)
    got = teq.barycentric_fm(tree, parts, order, name, pad8=pad8)
    _close(got, ref)
    assert got.shape[1] == (8 if pad8 else TK.FM_ROWS[name])
    # row for row the full plan's featurized Blocks, chunked leaves or not
    blocks = teq.barycentric_blocks(tree, parts, order)
    full = TK.featurize(name, blocks.pos, blocks.rad, blocks.s, pad8=pad8)
    assert torch.equal(got, full)
    chunked = teq.barycentric_fm(tree, parts, order, name, pad8=pad8,
                                 leaf_chunk=3)
    assert torch.equal(chunked, got)
    flat = teq.barycentric_fm(tree, parts, order, name, pad8=pad8,
                              flat=True)
    assert flat.shape == (got.shape[0], got.shape[1] * 128)
    assert torch.equal(flat.view(got.shape), got)
    # the inert row is featurized (radius 1), never all-zero
    pd = TK.KERNELS[name].pd
    assert not got[0, :pd].any() and (got[0, pd] == 1).all()
    assert not got[0, pd + 1:].any()


def test_target_geo_fm_matches_reference_and_full_plan(lean_trees):
    name, _, _, tt, tp = lean_trees
    ref = np.asarray(jeq.target_geo_fm(tt, tp, 4))
    tree, parts = interop.tree_from_numpy(tt), interop.parts_from_numpy(tp)
    got = teq.target_geo_fm(tree, parts, 4)
    _close(got, ref)
    blocks = teq.target_blocks(tree, parts, 4)
    full = tpp.build_tgt_geo(blocks.pos, blocks.rad)
    assert torch.equal(got[1:], full[1:])
    assert not got[0].any() and not ref[0].any()   # row 0: all zero in both


def test_lean_rows_are_block_size_wide():
    """Lean rows are block_size wide (the Blocks path rounds up to 128):
    a grid wider than the block splits over extension rows, as in the
    reference (M <= block_size * parts): order 4's 125 proxies take two
    rows of 64."""
    sx, sr, ss, _, _ = kernel_inputs(TK.KERNELS["grav3d"], 71, 500)
    st, sp, _ = jbuild.build_tree(jax_parts(sx, sr, ss), 64)
    tree, parts = interop.tree_from_numpy(st), interop.parts_from_numpy(sp)
    got = teq.barycentric_fm(tree, parts, 3, "grav3d", pad8=False)
    assert got.shape == (2 * tree.nleaf, 5, 64)
    _close(got, jeq.barycentric_fm(st, sp, 3, "grav3d", pad8=False))
    got = teq.barycentric_fm(tree, parts, 4, "grav3d")
    assert got.shape == (3 * tree.nleaf, 8, 64)
    _close(got, jeq.barycentric_fm(st, sp, 4, "grav3d"))


# ---------------------------------------------------------------- solvers

@functools.lru_cache(maxsize=None)
def _problem(name):
    """One problem per workload: numpy inputs, both packages' plans at
    the reference's treecode test configuration, and the fp64 oracle."""
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 74, N)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    jcfg, tcfg = JConfig(**CFG_KW), SolverConfig(**CFG_KW)
    jplan = jtc.prepare(jk, jcfg, js, jt)
    tplan = ttc.prepare(tk, tcfg, torch_parts(sx, sr, ss),
                        torch_parts(tx, tr))
    orc = np.asarray(jdirect.direct_oracle(jk, js, jt))
    return dict(name=name, jk=jk, tk=tk, jcfg=jcfg, tcfg=tcfg, jplan=jplan,
                tplan=tplan, orc=orc)


def _apart(name, got, ref):
    """Port against the reference: 5e-6 (gradients 5e-5)."""
    assert rel_rms(got[:, :3], ref[:, :3]) <= 5e-6
    if got.shape[1] > 3:
        assert rel_rms(got[:, 3:], ref[:, 3:]) <= 5e-5


@pytest.mark.parametrize("name", WORKLOADS)
def test_treecode3_matches_reference(name):
    p = _problem(name)
    ref, rinfo = jtc.solve_treecode3(p["jk"], p["jcfg"], p["jplan"])
    got, info = ttc.solve_treecode3(p["tk"], p["tcfg"], p["tplan"])
    got, ref = got.numpy(), np.asarray(ref)
    assert int(info.overflow) == int(rinfo.overflow) == 0
    assert int(info.n_valid) == int(rinfo.n_valid)
    _apart(p["name"], got, ref)
    # the reference's bound (tests/test_traverse.py:46)
    assert rel_rms(got, p["orc"]) < 3e-3


@pytest.mark.parametrize("name", WORKLOADS)
def test_treecode3_reference_plan_and_fetches_agree(name):
    """The port's solver on the reference's own plan (interop), and the
    dma-family fetch against the default pregather: the same sums."""
    p = _problem(name)
    got, _ = ttc.solve_treecode3(p["tk"], p["tcfg"], p["tplan"])
    plan = interop.plan_from_numpy(p["jplan"])
    on_ref, _ = ttc.solve_treecode3(p["tk"], p["tcfg"], plan)
    assert rel_rms(on_ref.numpy(), got.numpy()) <= 5e-6
    dma, _ = ttc.solve_treecode3(p["tk"], p["tcfg"].replace(
        pair_fetch="dma_i"), p["tplan"])
    assert rel_rms(dma.numpy(), got.numpy()) <= 1e-6


@pytest.mark.parametrize("name", ["grav3d", "vort2d"])
def test_treecode2_matches_reference(name):
    p = _problem(name)
    ref, rinfo = jtc.solve_treecode2(p["jk"], p["jcfg"], p["jplan"])
    got, info = ttc.solve_treecode2(p["tk"], p["tcfg"], p["tplan"])
    assert int(info.overflow) == int(rinfo.overflow) == 0
    assert int(info.n_valid) == int(rinfo.n_valid)
    _apart(p["name"], got.numpy(), np.asarray(ref))
    assert rel_rms(got.numpy(), p["orc"]) < 3e-3


@pytest.mark.parametrize("name", ["grav3d", "vort2d"])
def test_treecode1_matches_reference(name):
    p = _problem(name)
    ref, rinfo = jtc.solve_treecode1(p["jk"], p["jcfg"], p["jplan"])
    got, info = ttc.solve_treecode1(p["tk"], p["tcfg"], p["tplan"])
    assert int(info.overflow) == int(rinfo.overflow) == 0
    assert int(info.n_valid) == int(rinfo.n_valid)
    _apart(p["name"], got.numpy(), np.asarray(ref))
    # monopoles at theta 2.0: coarse but bounded (test_traverse.py:67)
    assert rel_rms(got.numpy(), p["orc"]) < 5e-2


def test_monopole_eval_slices_agree(monkeypatch):
    """The sliced monopole evaluation equals the unsliced one."""
    tk = TK.KERNELS["vort3d"]
    g = torch.Generator().manual_seed(0)
    args = (torch.rand((7, 16, 3), generator=g), torch.zeros((7, 16)),
            torch.rand((7, 5, 3), generator=g) + 2.0,
            torch.rand((7, 5), generator=g),
            torch.randn((7, 5, 3), generator=g))
    one = ttc._monopole_eval(tk, *args, "rm")
    monkeypatch.setattr(ttc, "_MONO_ELEMS", 16 * 5 * 2)
    assert torch.equal(ttc._monopole_eval(tk, *args, "rm"), one)
    assert one.shape == (7, 16, 3)


# ----------------------------------------------------- lean plan end to end

@pytest.mark.parametrize("name,fetch", [("grav3d", "pregather"),
                                        ("grav3d", "dma_i"),
                                        ("vort2d", "pregather"),
                                        ("vortgrad3d", "pregather")])
def test_lean_plan_matches_full(name, fetch):
    """The reference's test_lean_plan_matches_full on the port: the lean
    plan (no Blocks; lean rows under pregather, rows padded to 8 under a
    dma fetch) gives the full plan's DTT and treecode3 results, with the
    sibling-paired leaf pass on (K8 + K9's twins under pregather)."""
    tk = TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 75, 3000)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = SolverConfig(block_size=128, order=4, frontier_width=256,
                       list_width=512, pair_fetch=fetch,
                       dtt_leaf_pair2=True)
    check_supported(cfg.replace(lean_plan=True), tk)
    full = ttc.prepare(tk, cfg, srcs, targs)
    lean = ttc.prepare(tk, cfg.replace(lean_plan=True), srcs, targs)
    assert lean.src_blocks is None and lean.tgt_blocks is None
    rows = 8 if fetch == "dma_i" else TK.FM_ROWS[name]
    assert lean.src_fm.shape[1] == rows and full.src_fm.shape[1] == 8
    for solve in (tdtt.solve_dtt, ttc.solve_treecode3):
        ref, rinfo = solve(tk, cfg, full)
        got, info = solve(tk, cfg.replace(lean_plan=True), lean)
        assert int(info.overflow) == int(rinfo.overflow) == 0
        assert torch.equal(got, ref)


def test_reference_lean_plan_and_groups_carry_across():
    """interop carries the reference's lean Plan (no Blocks) and its
    PairGroups across: the port's treecode3 on the reference's lean plan
    equals its own, and exec_groups on the reference's groups of the
    reference's list gives that solve's leaf rows."""
    from onbody_tpu.traverse import lists as jl
    from onbody_tpu_torch.traverse import exec as texec
    name = "grav3d"
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 76, 1500)
    kw = dict(block_size=128, order=4, frontier_width=256, list_width=512,
              lean_plan=True)
    jplan = jtc.prepare(jk, JConfig(**kw), jax_parts(sx, sr, ss),
                        jax_parts(tx, tr))
    assert jplan.src_blocks is None and jplan.src_fm.shape[1] == 5
    cfg = SolverConfig(**kw)
    plan = interop.plan_from_numpy(jplan)
    assert plan.src_blocks is None and plan.tgt_blocks is None
    own = ttc.prepare(tk, cfg, torch_parts(sx, sr, ss), torch_parts(tx, tr))
    got, info = ttc.solve_treecode3(tk, cfg, plan)
    ref, _ = ttc.solve_treecode3(tk, cfg, own)
    assert int(info.overflow) == 0
    assert rel_rms(got.numpy(), ref.numpy()) <= 5e-6
    jpl = jl.build_treecode_pairs(jplan.stree, jplan.ttree, 1.0, "boxwise",
                                  256, 512)
    jpg = jl.group_pairs(jpl, 1024, 8, 512)
    pg = interop.pairgroups_from_numpy(jpg)
    assert pg.src.shape == (1024, 8) and pg.src.dtype == torch.int64
    out, _ = texec.exec_groups(tk, cfg, plan, pg)
    leaf = ttc._leaf_outputs(out, plan, tk, 1500)
    assert torch.equal(leaf, got)
