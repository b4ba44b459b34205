"""Port vs reference: the vortex workloads (vort2d, vort3d, vortgrad3d) —
feature-major layouts and tile forms, the executor twins of K1/K2 and the
direct path, the 2D tree, lists and equivalents of vort2d, and the whole
slice (treecode.prepare + dtt.solve_dtt) per workload, on the same numpy
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (SLICE_KW, jax_parts, kernel_inputs, rel_rms,
                           scale_rel_max, torch_parts)
from test_torch_tree import _assert_sorted, _assert_tree
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as JK
from onbody_tpu.ops import pallas_pairs as jpp
from onbody_tpu.traverse import direct as jdirect
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu.traverse import lists as jl
from onbody_tpu.traverse import treecode as jtc
from onbody_tpu.tree import build as jbuild
from onbody_tpu.tree import equivalents as jeq
from onbody_tpu_torch import interop
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import cuda_direct, cuda_pairs
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import direct as tdirect
from onbody_tpu_torch.traverse import dtt as tdtt
from onbody_tpu_torch.traverse import lists as tl
from onbody_tpu_torch.traverse import treecode as ttc
from onbody_tpu_torch.tree import build as tbuild
from onbody_tpu_torch.tree import equivalents as teq

torch.set_num_threads(1)

VORTEX = ["vort2d", "vort3d", "vortgrad3d"]
CORES = ["rm", "exp"]
RTOL = 1e-5


def _close(got, ref, rtol=RTOL):
    """Elementwise rtol, with an absolute floor at rtol of the largest
    magnitude (entries that cancel to ~0 carry the fp32 chain's
    absolute error)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _tile_inputs(kernel, seed, T=64, S=96):
    rng = np.random.default_rng(seed)
    tx = rng.uniform(-1, 1, (T, kernel.pd)).astype(np.float32)
    tr = rng.uniform(0.01, 0.05, (T,)).astype(np.float32)
    sx = rng.uniform(-1, 1, (S, kernel.pd)).astype(np.float32)
    sr = rng.uniform(0.01, 0.05, (S,)).astype(np.float32)
    ss = (rng.uniform(-1, 1, (S, kernel.sd)) / S).astype(np.float32)
    return tx, tr, sx, sr, ss


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


# ------------------------------------------------------------ tile forms

@pytest.mark.parametrize("pad8", [True, False])
@pytest.mark.parametrize("name", VORTEX)
def test_featurize_identical(name, pad8):
    _, _, sx, sr, ss = _tile_inputs(TK.KERNELS[name], 1)
    ref = np.asarray(JK.featurize(name, *_j(sx, sr, ss), pad8=pad8))
    got = TK.featurize(name, *_t(sx, sr, ss), pad8=pad8).numpy()
    assert got.shape == ref.shape
    assert ref.shape[0] == (8 if pad8 else JK.FM_ROWS[name])
    np.testing.assert_array_equal(got, ref)
    # batched blocks, as build_fm_blocks calls it
    bat = TK.featurize(name, *_t(np.stack([sx] * 2), np.stack([sr] * 2),
                                 np.stack([ss] * 2)), pad8=pad8)
    np.testing.assert_array_equal(bat[1].numpy(), ref)


@pytest.mark.parametrize("name", VORTEX)
def test_pad_fm_rows_identical(name):
    _, _, sx, sr, ss = _tile_inputs(TK.KERNELS[name], 2)
    lean = np.stack([np.array(JK.featurize(name, *_j(sx, sr, ss),
                                             pad8=False))] * 2)
    ref = np.asarray(JK.pad_fm_rows(name, jnp.asarray(lean)))
    got = TK.pad_fm_rows(name, torch.from_numpy(lean)).numpy()
    assert got.shape == ref.shape == (2, 8, sx.shape[0])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("name", VORTEX)
def test_tile_fm_matches_reference(name, core):
    """The per-pair twin body vs the reference's factored tile form at
    mxu_precision='highest'. In fp64 they agree to 1e-8 (the bound of
    the reference's own tile-form test). In fp32 the port sits at the
    fp32 floor (1e-6 of the fp64 pairwise sum), while the reference's
    factored moments recombine across a tile that spans the whole
    domain: its vortgrad3d gradients are ~2e-5 from the fp64 sum here.
    So the port is held to 1e-5 of the reference, or to twice the
    reference's own fp32 error where that is larger."""
    kernel = TK.KERNELS[name]
    a = _tile_inputs(kernel, 3)
    a64 = [x.astype(np.float64) for x in a]
    true = kernel.pairwise(*_t(*a64), core).sum(1).numpy()
    for arrs, dtype in ((a64, jnp.float64), (a, jnp.float32)):
        tx, tr, sx, sr, ss = arrs
        srcT = np.array(JK.featurize(name, *_j(sx, sr, ss)))
        ref = np.asarray(JK.TILE_FM[name](
            *_j(tx, tr, srcT), core, dtype, "outer", precision="highest"))
        got = kernel.tile_fm(*_t(tx, tr, srcT), core)
        assert got.shape == ref.shape == (tx.shape[0], kernel.od)
        # the point-major tile form is the same arithmetic
        assert torch.equal(kernel.tile(*_t(tx, tr, sx, sr, ss), core,
                                       got.dtype), got)
        got = got.numpy()
        if dtype == jnp.float64:
            assert scale_rel_max(got, ref) <= 1e-8
    # fp32, the last pass
    print(f"{name} {core} fp32 tile rel-RMS from the fp64 pairwise sum: "
          f"port {rel_rms(got, true):.3e}, reference "
          f"{rel_rms(ref, true):.3e}")
    assert rel_rms(got, true) <= 1e-6
    assert rel_rms(got, ref) <= max(1e-5, 2 * rel_rms(ref, true))


@pytest.mark.parametrize("name", ["vort3d", "vortgrad3d"])
def test_tile_fm_off_origin_f32_floor(name):
    """Tiles far from the origin (offset 5, extent 0.05) stay at the fp32
    floor against the fp64 pairwise sum: the per-pair form has no
    domain-scale moments to cancel (the reference's own bound, 5e-6)."""
    kernel = TK.KERNELS[name]
    rng = np.random.default_rng(7)
    B, off = 64, 5.0
    tx = (rng.random((B, 3), np.float32) * 0.05 + off)
    tr = rng.random((B,), np.float32) * 0.01
    sx = (rng.random((B, 3), np.float32) * 0.05 + off + 0.1)
    sr = rng.random((B,), np.float32) * 0.01 + 0.01
    ss = rng.random((B, 3), np.float32) - 0.5
    ref = kernel.pairwise(*(torch.from_numpy(a).double()
                            for a in (tx, tr, sx, sr, ss))).sum(1)
    srcT = TK.featurize(name, *_t(sx, sr, ss))
    out = kernel.tile_fm(*_t(tx, tr), srcT, "rm")
    assert rel_rms(out, ref) < 5e-6


# ------------------------------------------------------------- executors

B, NN = 32, 8
PATTERNS = ([1, 1, 2, 3, 3, 0, 0, 0], [1, 1, 0, 2, 2, 0, 3, 0])


def _blocks(kernel, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (NN, B, kernel.pd)).astype(np.float32)
    rad = rng.uniform(0.03, 0.07, (NN, B)).astype(np.float32)
    s = (rng.normal(size=(NN, B, kernel.sd)) / B).astype(np.float32)
    rad[0], s[0], pos[0] = 1.0, 0.0, 0.0             # inert row 0
    jk = JK.KERNELS[kernel.name]
    src_fm = np.array(jpp.build_fm_blocks(jk, *_j(pos, rad, s)))
    tgt_geo = np.array(jpp.build_tgt_geo(*_j(pos, rad)))
    return src_fm, tgt_geo


def _groups(seed, gt_list):
    rng = np.random.default_rng(seed)
    gt = np.array(gt_list, np.int32)
    gs = rng.integers(1, NN, (len(gt_list), jpp.GROUP)).astype(np.int32)
    gs[:, -2:] = np.where(rng.random((len(gt_list), 2)) < 0.5, 0,
                          gs[:, -2:])
    gs[gt == 0] = 0
    return gt, gs


@pytest.mark.parametrize("name,core,gt_list", [
    ("vort2d", "rm", PATTERNS[0]), ("vort2d", "exp", PATTERNS[1]),
    ("vort3d", "rm", PATTERNS[1]), ("vort3d", "exp", PATTERNS[0]),
    ("vortgrad3d", "rm", PATTERNS[0]), ("vortgrad3d", "exp", PATTERNS[1])])
def test_unpaired_twin_matches_pallas(name, core, gt_list):
    """K1's twin vs the Pallas executor in interpret mode (fetch dma_i,
    the reference's test_dma_i_vortex_kernels shapes), source blocks that
    contain the targets themselves (the d2 = 0 diagonal)."""
    kernel = TK.KERNELS[name]
    src_fm, tgt_geo = _blocks(kernel, 11)
    gt, gs = _groups(12, gt_list)
    ref = np.asarray(jpp.exec_pairs_pallas(
        JK.KERNELS[name], *_j(tgt_geo, src_fm, gt, gs), core=core,
        interpret=True, fetch="dma_i", tile_g=2))
    got = cuda_pairs.exec_pairs_cuda(kernel, *_t(tgt_geo, src_fm, gt, gs),
                                     core=core).numpy()
    assert got.shape == ref.shape == (NN, B, kernel.od)
    assert np.isfinite(got).all()
    assert scale_rel_max(got[1:], ref[1:]) < 1e-4


@pytest.mark.parametrize("name", VORTEX)
def test_paired_twin_matches_pallas_and_keeps_root(name):
    kernel = TK.KERNELS[name]
    src_fm, tgt_geo = _blocks(kernel, 13)
    gt2, gs2 = _groups(14, [1, 1, 2, 3, 0, 0, 0, 0])
    out0 = np.zeros((NN, cuda_pairs.od8(kernel), B), np.float32)
    out0[1] = 7.25
    ref = np.asarray(jpp.exec_pairs_pallas_t2(
        JK.KERNELS[name], *_j(tgt_geo, src_fm, gt2, gs2, out0),
        interpret=True, tile_g=2))
    got = cuda_pairs.exec_pairs_cuda_t2(
        kernel, *_t(tgt_geo, src_fm, gt2, gs2, out0)).numpy()
    assert got.shape == ref.shape
    assert scale_rel_max(got[2:], ref[2:]) < 1e-4
    assert (got[1] == 7.25).all() and (ref[1] == 7.25).all()
    assert not got[0].any()


def test_executor_checks_rows_and_accumulator():
    """The executors check the body's staged rows and od8 per kernel
    (vortgrad3d's accumulator has 16 rows)."""
    kernel = TK.KERNELS["vortgrad3d"]
    assert cuda_pairs.od8(kernel) == 16
    src_fm, tgt_geo = (torch.from_numpy(a) for a in _blocks(kernel, 15))
    gt, gs = (torch.from_numpy(a) for a in _groups(16, PATTERNS[0]))
    with pytest.raises(ValueError, match="C>=7"):
        cuda_pairs._check_exec(kernel, tgt_geo, src_fm[:, :5], gt, gs,
                               torch.zeros((NN, 16, B)), False)
    with pytest.raises(ValueError, match="out_fm"):
        cuda_pairs._check_exec(kernel, tgt_geo, src_fm, gt, gs,
                               torch.zeros((NN, 8, B)), False)


# ---------------------------------------------------------------- direct

@pytest.mark.parametrize("core", CORES)
@pytest.mark.parametrize("name", VORTEX)
def test_direct_matches_reference(name, core):
    """fp32 direct (K4's twin on CPU tensors) and the fp64 oracle vs the
    reference's, at ragged sizes; (S, SD) strengths go in as they are."""
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 20, 700, 333)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    ts, tt = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    orc = np.asarray(jdirect.direct_oracle(jk, js, jt, core))
    got_orc = tdirect.direct_oracle(tk, ts, tt, core).numpy()
    np.testing.assert_allclose(got_orc, orc, rtol=1e-12,
                               atol=1e-12 * np.abs(orc).max())
    before = dict(cuda_direct.LAUNCHES)
    got = tdirect.direct(tk, ts, tt, core=core).numpy()
    assert dict(cuda_direct.LAUNCHES) == before
    assert got.shape == (333, tk.od)
    assert rel_rms(got, np.asarray(jdirect.direct(jk, js, jt, core))) < 2e-5
    assert rel_rms(got, orc) < 2e-6


def test_direct_checks_strength_shape():
    tk = TK.KERNELS["vort3d"]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 21, 50, 20)
    args = _t(tx, tr, sx, sr, ss)
    with pytest.raises(ValueError, match="ss must be"):
        cuda_direct.direct_cuda(tk, *args[:4], args[4].reshape(-1, 1))


# ---------------------------------------------- 2D tree, lists, equivalents

K2D = TK.KERNELS["vort2d"]


@pytest.fixture(scope="module", params=[(3000, 3000), (1500, 2048)],
                ids=["equal", "ragged"])
def trees_2d(request):
    """Reference 2D trees (sources with strengths, targets with radii)."""
    ns_, nt_ = request.param
    sx, sr, ss, _, _ = kernel_inputs(K2D, 30, ns_)
    _, _, _, tx, tr = kernel_inputs(K2D, 31, 16, nt_)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    src = jbuild.build_tree(js, 32, mode="span")
    tgt = jbuild.build_tree(jt, 32, mode="span", need_r=True)
    return dict(src=src, tgt=tgt, sargs=(sx, sr, ss), targs=(tx, tr),
                n_live=nt_)


def test_build_tree_2d_matches_reference(trees_2d):
    for key, args in (("src", trees_2d["sargs"]), ("tgt", trees_2d["targs"])):
        ref_tree, ref_parts, ref_g = trees_2d[key]
        tree, parts, g = tbuild.build_tree(torch_parts(*args), 32,
                                           mode="span")
        _assert_tree(tree, ref_tree)
        _assert_sorted(parts, ref_parts, g, ref_g)


@pytest.mark.parametrize("theta", [1.4, 0.9])
def test_dtt_lists_2d_identical(trees_2d, theta):
    st, tt = trees_2d["src"][0], trees_2d["tgt"][0]
    n_live = trees_2d["n_live"]
    ts, tt_ = interop.tree_from_numpy(st), interop.tree_from_numpy(tt)
    ref = jl.build_dtt_pairs_level(st, tt, theta, 256, "quant",
                                   n_live=n_live)
    got = tl.build_dtt_pairs_level(ts, tt_, theta, 256, n_live=n_live)
    for f in ("tgt", "src", "n_valid", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    refs = jl.build_dtt_pairs_level2(st, tt, theta, 256, "quant",
                                     n_live=n_live)
    gots = tl.build_dtt_pairs_level2(ts, tt_, theta, 256, n_live=n_live)
    for g, r in zip(gots, refs):
        for f in ("tgt", "src", "n_valid", "overflow"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(r, f)), f)
        rg = jl.group_pairs(r, 2048, 8, 256, "sort")
        gg = tl.group_pairs(interop.pairlist_from_numpy(r), 2048, 8, 256)
        np.testing.assert_array_equal(gg.src.numpy(), np.asarray(rg.src))
        np.testing.assert_array_equal(gg.tgt.numpy(), np.asarray(rg.tgt))


@pytest.mark.parametrize("order", [3, 5])
def test_equivalents_2d_match_reference(trees_2d, order):
    st, sp, _ = trees_2d["src"]
    tt, tp, _ = trees_2d["tgt"]
    ref = jeq.barycentric_blocks(st, sp, order)
    got = teq.barycentric_blocks(interop.tree_from_numpy(st),
                                 interop.parts_from_numpy(sp), order)
    for f in ("pos", "rad", "s"):
        _close(getattr(got, f), getattr(ref, f))
    ref_t = jeq.target_blocks(tt, tp, order)
    got_t = teq.target_blocks(interop.tree_from_numpy(tt),
                              interop.parts_from_numpy(tp), order)
    _close(got_t.pos, ref_t.pos)
    _close(got_t.rad, ref_t.rad)
    # the vort2d feature rows and target geometry (radius in row pd = 2)
    ref_fm = jpp.build_fm_blocks(JK.KERNELS["vort2d"], ref.pos, ref.rad,
                                 ref.s)
    got_fm = cuda_pairs.build_fm_blocks(K2D, got.pos, got.rad, got.s)
    _close(got_fm, ref_fm)
    geo = cuda_pairs.build_tgt_geo(got_t.pos, got_t.rad)
    _close(geo, jpp.build_tgt_geo(ref_t.pos, ref_t.rad))
    _close(geo[:, 2], got_t.rad)


def test_anterp_and_prolong_2d_match_reference():
    rng = np.random.default_rng(32)
    nc = rng.uniform(-1, 1, (6, 2)).astype(np.float32)
    ns = rng.uniform(0.1, 0.5, (6, 2)).astype(np.float32)
    pts = (nc[:, None, :] + ns[:, None, :]
           * rng.uniform(-0.5, 0.5, (6, 50, 2))).astype(np.float32)
    s = rng.uniform(-1, 1, (6, 50, 1)).astype(np.float32)
    U = rng.uniform(-1, 1, (6, 36, 2)).astype(np.float32)
    j = _j(pts, nc, ns)
    t = _t(pts, nc, ns)
    _close(teq.anterp_factored(*t, 5, torch.from_numpy(s)),
           jeq.anterp_factored(*j, 5, jnp.asarray(s)))
    _close(teq.prolong_factored(*t, 5, torch.from_numpy(U)),
           jeq.prolong_factored(*j, 5, jnp.asarray(U)))


# ----------------------------------------------------------------- slice

N_SLICE = 3000


@pytest.fixture(scope="module", params=VORTEX)
def slice_run(request):
    """The reference (jnp executors, full-fp32 contractions, unpaired
    leaves: its paired leaves need the Pallas backend) and the port
    (twins, sibling-paired leaves) on one input set per workload."""
    name = request.param
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 70, N_SLICE)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    jcfg = JConfig(pair_backend="jnp", **SLICE_KW).replace(
        dtt_leaf_pair2=False)
    jout, jinfo = jdtt.solve_dtt(jk, jcfg, jtc.prepare(jk, jcfg, js, jt))
    ts, tt = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    tcfg = SolverConfig(**SLICE_KW)
    tout, tinfo = tdtt.solve_dtt(tk, tcfg, ttc.prepare(tk, tcfg, ts, tt))
    oracle = np.asarray(jdirect.direct_oracle(jk, js, jt))
    return dict(name=name, jout=np.asarray(jout), jinfo=jinfo,
                tout=tout.numpy(), tinfo=tinfo, oracle=oracle, ts=ts,
                tt=tt, kernel=tk)


def test_vortex_slice_matches_reference(slice_run):
    """Port vs JAX rel-RMS 1e-5. vortgrad3d's nine gradient outputs are
    the exception: the reference contracts factored moments that cancel
    across sources, so its fp32 gradient tiles sit ~2e-5 from the fp64
    pairwise sum where the port's sit at ~2e-7
    (test_tile_fm_matches_reference prints both). The port's slice
    gradients measured 2.0e-5 from the JAX package's; its velocities
    keep 1e-5 and its gradients are held to 5e-5."""
    r = slice_run
    od = r["kernel"].od
    assert r["tout"].shape == r["jout"].shape == (N_SLICE, od)
    print(f"{r['name']} slice: port vs JAX rel-RMS velocity "
          f"{rel_rms(r['tout'][:, :3], r['jout'][:, :3]):.3e}"
          + (f", gradients {rel_rms(r['tout'][:, 3:], r['jout'][:, 3:]):.3e}"
             if od > 3 else "")
          + f"; vs the fp64 oracle: port {rel_rms(r['tout'], r['oracle']):.3e}"
          f", JAX {rel_rms(r['jout'], r['oracle']):.3e}")
    assert rel_rms(r["tout"][:, :3], r["jout"][:, :3]) <= 1e-5
    if od > 3:
        assert rel_rms(r["tout"][:, 3:], r["jout"][:, 3:]) <= 5e-5


def test_vortex_slice_accuracy_and_overflow(slice_run):
    r = slice_run
    assert rel_rms(r["jout"], r["oracle"]) <= 3e-3
    assert rel_rms(r["tout"], r["oracle"]) <= 3e-3
    assert int(r["tinfo"].overflow) == int(r["jinfo"].overflow) == 0
    assert int(r["tinfo"].n_valid) == int(r["jinfo"].n_valid)
    np.testing.assert_allclose(
        tdirect.direct_oracle(r["kernel"], r["ts"], r["tt"]).numpy(),
        r["oracle"], rtol=1e-12, atol=1e-12 * np.abs(r["oracle"]).max())


def test_core_func_is_checked_per_kernel():
    """core_func selects the body's core; a value the kernel has no core
    for raises; grav3d ignores it, as the reference does."""
    sx, sr, ss, tx, tr = kernel_inputs(TK.KERNELS["vort3d"], 71, 300)
    cfg = SolverConfig(**SLICE_KW)
    for name, core in (("vort2d", "v2"), ("vortgrad3d", "v2"),
                       ("vort3d", "tanh")):
        k = TK.KERNELS[name]
        a = kernel_inputs(k, 71, 300)
        with pytest.raises(ValueError, match="core_func"):
            ttc.prepare(k, cfg.replace(core_func=core),
                        torch_parts(*a[:3]), torch_parts(*a[3:]))
    g = TK.KERNELS["grav3d"]
    ga = kernel_inputs(g, 72, 300)
    plan = ttc.prepare(g, cfg.replace(core_func="exp"),
                       torch_parts(*ga[:3]), torch_parts(*ga[3:]))
    out_exp, _ = tdtt.solve_dtt(g, cfg.replace(core_func="exp"), plan)
    out_rm, _ = tdtt.solve_dtt(g, cfg, plan)
    assert torch.equal(out_exp, out_rm)
    # vort3d's v2 core runs on the torch path
    k = TK.KERNELS["vort3d"]
    cv2 = cfg.replace(core_func="v2")
    plan = ttc.prepare(k, cv2, torch_parts(sx, sr, ss), torch_parts(tx, tr))
    out, info = tdtt.solve_dtt(k, cv2, plan)
    orc = tdirect.direct_oracle(k, torch_parts(sx, sr, ss),
                                torch_parts(tx, tr), "v2")
    assert int(info.overflow) == 0 and rel_rms(out, orc) < 3e-3
