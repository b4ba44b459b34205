"""Port vs reference: the executors of the fetch schedules 'dma'
(kernel K10), 'dma_p' (K11) and 'static' (K12) through the front door
`cuda_pairs.exec_pairs(fetch=...)` on CPU tensors (the plain twins),
against the reference's `pallas_pairs.exec_pairs_pallas(fetch=...)` with
Pallas in interpret mode, on the reference's own executor cases: pad
steps at the tail, between targets and everywhere ('dma'), the adjacency
patterns of the bundled fetch ('dma_p'), both source row layouts
('static'). Tolerance 1e-5 rel-RMS (gradients 5e-5), the executor parity
of tests/test_torch_pregather.py, whose docstring gives the reason: the
reference's fp32 moment forms. The whole slices under these fetches are
in tests/test_torch_fetch_slice.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SLICE_KW, kernel_inputs, rel_rms, torch_parts
from onbody_tpu.ops import kernels as JK
from onbody_tpu.ops import pallas_pairs as jpp
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import cuda_pairs as tpp
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import treecode as ttc

torch.set_num_threads(1)

WORKLOADS = ["grav3d", "vort2d", "vort3d", "vortgrad3d"]
B, NN, G = 32, 16, 8
TOL, TOL_GRAD = 1e-5, 5e-5
# reference tests/test_pallas.py:192-194 and :287-290
PAD_LISTS = ([1, 1, 2, 3, 3, 0, 0, 0], [1, 1, 0, 2, 2, 0, 3, 0], [0] * 8)
ADJACENCY = ([[2, 3, 4, 5, 6, 7, 8, 9]], [[3, 4, 7, 9, 10, 13, 0, 0]],
             [[5, 9, 11, 2, 6, 8, 14, 15]], [[4, 5, 6, 1, 12, 2, 0, 0]])


def _blocks(name, seed, pad8=True):
    """Block tables as in tests/test_torch_pregather.py: compact
    clusters, the targets are the sources, inert row 0."""
    kernel = TK.KERNELS[name]
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-1, 1, (NN, 1, kernel.pd))
           + rng.uniform(-0.15, 0.15, (NN, B, kernel.pd))).astype(np.float32)
    rad = rng.uniform(0.03, 0.07, (NN, B)).astype(np.float32)
    s = (rng.normal(size=(NN, B, kernel.sd)) / B).astype(np.float32)
    rad[0], s[0], pos[0] = 1.0, 0.0, 0.0
    src_fm = TK.featurize(name, *(torch.from_numpy(a) for a in
                                  (pos, rad, s)), pad8=pad8).numpy()
    tgt_geo = np.array(jpp.build_tgt_geo(jnp.asarray(pos),
                                         jnp.asarray(rad)))
    return src_fm, tgt_geo


def _check(name, got, ref):
    od = TK.KERNELS[name].od
    got, ref = np.asarray(got)[1:], np.asarray(ref)[1:]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert rel_rms(got[..., :3], ref[..., :3]) <= TOL
    if od > 3:
        assert rel_rms(got[..., 3:], ref[..., 3:]) <= TOL_GRAD


def _both(name, fetch, src_fm, tgt_geo, gt, gs, core="rm"):
    """(port front door on CPU tensors, reference in interpret mode)."""
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    ref = jpp.exec_pairs_pallas(jk, jnp.asarray(tgt_geo),
                                jnp.asarray(src_fm), jnp.asarray(gt),
                                jnp.asarray(gs), core=core, interpret=True,
                                fetch=fetch, group=gs.shape[1])
    got = tpp.exec_pairs(tk, torch.from_numpy(tgt_geo),
                         torch.from_numpy(src_fm),
                         torch.from_numpy(gt.astype(np.int64)),
                         torch.from_numpy(gs.astype(np.int64)), core=core,
                         fetch=fetch)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name", WORKLOADS)
def test_dma_front_door_pad_steps(name):
    """fetch='dma' (K10's twin) on tail pads, pads between targets and
    an all-pad list (the reference's test_dma_kernel_pad_steps_skipped)."""
    src_fm, tgt_geo = _blocks(name, 1)
    rng = np.random.default_rng(2)
    for gt_list in PAD_LISTS:
        gt = np.array(gt_list, np.int32)
        gs = rng.integers(1, NN, (8, G)).astype(np.int32)
        gs[gt == 0] = 0
        got, ref = _both(name, "dma", src_fm, tgt_geo, gt, gs)
        if not gt.any():
            assert not got.any() and not ref.any()
            continue
        _check(name, got, ref)


@pytest.mark.parametrize("name", WORKLOADS)
def test_dma_p_front_door_adjacency(name):
    """fetch='dma_p' (K11's twin) on the reference's adjacency cases
    (test_dma_pair_bundled_kernel): full ascending runs, mixed singles,
    pairs and pads, last-slot adjacency, the greedy triple."""
    src_fm, tgt_geo = _blocks(name, 3)
    gt = np.array([1, 2, 3, 3], np.int32)
    for rows in ADJACENCY:
        gs = np.array(rows * 4, np.int32)
        got, ref = _both(name, "dma_p", src_fm, tgt_geo, gt, gs)
        _check(name, got, ref)


@pytest.mark.parametrize("pad8", [False, True], ids=["lean", "pad8"])
@pytest.mark.parametrize("name", ["grav3d", "vort3d"])
def test_static_front_door_row_layouts(name, pad8):
    """fetch='static' (K12's twin: chunked gather, per-step rows,
    index_add_) with lean rows and rows padded to 8, against the
    reference's static kernel _exec_chunk_static on its own gathered
    rows (padded to 8 with the derived rows) followed by its segment add
    (pallas_pairs.py:876-890). The kernel is called on the 16 steps
    directly: its front door pads every list to a 1024-step chunk,
    minutes in interpret mode. (The gravity body and one vortex body:
    each costs 5-20 s of interpret-mode compilation, and K12's twin is
    K8's, held to the reference for every body in
    tests/test_torch_pregather.py.)"""
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    src_fm, tgt_geo = _blocks(name, 4, pad8)
    rng = np.random.default_rng(5)
    gt = np.array([1, 1, 0, 2, 2, 2, 0, 5, 7, 9, 9, 9, 9, 9, 0, 0],
                  np.int32)
    gs = rng.integers(1, NN, (gt.shape[0], G)).astype(np.int32)
    gs[:, -2:] = np.where(rng.random((gt.shape[0], 2)) < 0.5, 0, gs[:, -2:])
    gs[gt == 0] = 0
    rows = jpp._exec_chunk_static(
        jk, jnp.asarray(tgt_geo)[jnp.asarray(gt)],
        jpp._pregather(name, jnp.asarray(src_fm), jnp.asarray(gs), B),
        "rm", jnp.float32, True, "outer", G)
    od8 = tpp.od8(tk)
    ref = jnp.zeros((NN, od8, B), jnp.float32).at[jnp.asarray(gt)].add(rows)
    got = tpp.exec_pairs(tk, torch.from_numpy(tgt_geo),
                         torch.from_numpy(src_fm),
                         torch.from_numpy(gt.astype(np.int64)),
                         torch.from_numpy(gs.astype(np.int64)),
                         fetch="static", final=False)
    _check(name, got.numpy()[:, :tk.od].transpose(0, 2, 1),
           np.asarray(ref)[:, :tk.od].transpose(0, 2, 1))


def test_fetch_wrappers_take_twins_on_cpu():
    """On CPU tensors the K10/K11/K12 wrappers run their plain twins and
    count no launch."""
    tk = TK.KERNELS["vort3d"]
    src_fm, tgt_geo = (torch.from_numpy(a) for a in _blocks("vort3d", 6))
    gt = torch.tensor([1, 1, 2, 0])
    gs = torch.tensor(ADJACENCY[0] * 4)
    gs[3] = 0
    before = dict(tpp.LAUNCHES)
    k1 = tpp.exec_pairs_torch(tk, tgt_geo, src_fm, gt, gs)
    for fn in (tpp.exec_pairs_dma_cuda, tpp.exec_pairs_dmap_cuda):
        assert torch.equal(fn(tk, tgt_geo, src_fm, gt, gs), k1)
    gathered = tpp._pregather("vort3d", src_fm, gs, B, pad8=False)
    got = tpp.exec_pairs_static_cuda(tk, tgt_geo, gathered, gt, group=G)
    assert rel_rms(got.numpy(), k1.numpy()) <= 1e-6
    assert dict(tpp.LAUNCHES) == before


def test_unknown_list_compact_raises():
    tk = TK.KERNELS["grav3d"]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 7, 200)
    cfg = SolverConfig(**SLICE_KW).replace(list_compact="radix")
    with pytest.raises(ValueError, match="list_compact"):
        ttc.prepare(tk, cfg, torch_parts(sx, sr, ss), torch_parts(tx, tr))
