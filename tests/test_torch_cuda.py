"""The port's CUDA kernels on the card (K1, K2 pair executors, also at a
ragged block width; K8, K9 the same on pre-gathered sources; K10, K11
fetching by bulk copies; K12, K8 at one step per segment; K13, K10 on
the ablated grav3d bodies; K4 direct, its source splits and their
reduction; the accuracy tier's K1-f64 and K4-f64)
against their plain twins and the fp64 oracle, for every (workload,
core) instantiation, and the slice on the card against the slice on the
CPU for every workload and fetch; the multi-device solves over NCCL at
world size 1 and the C ABI shim on the card against the CPU. Every test
needs a CUDA device and skips without one.
This file imports no jax, so on the GPU machine it runs without the
reference package's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from _torch_parity import (SLICE_KW, PairedSpy, kernel_inputs, rel_rms,
                           scale_rel_max, torch_parts)
from onbody_tpu_torch import parts as P
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import cuda_direct, cuda_lib, cuda_pairs
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.parts import Parts
from onbody_tpu_torch.traverse import (bigN, chunked, direct, dtt, outofcore,
                                       treecode)

pytestmark = pytest.mark.cuda

KER = get_kernel("grav3d")
B = 128
# (workload, core) of every compiled instantiation
INSTANCES = list(cuda_lib.INSTANCE_CORES)
IDS = [f"{k}-{c}" for k, c in INSTANCES]
WORKLOADS = ["grav3d", "vort3d", "vortgrad3d", "vort2d"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)


def _to(p: Parts, device) -> Parts:
    return Parts(x=p.x.to(device), r=p.r.to(device),
                 s=None if p.s is None else p.s.to(device), n_real=p.n_real)


def _blocks(dev, kernel=KER, nn=16, seed=0, b=B):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((nn, b, kernel.pd), generator=g)
    rad = 0.03 + 0.04 * torch.rand((nn, b), generator=g)
    s = torch.randn((nn, b, kernel.sd), generator=g) / b
    pos[0], rad[0], s[0] = 0.0, 1.0, 0.0
    src_fm = cuda_pairs.build_fm_blocks(kernel, pos, rad, s).contiguous()
    tgt_geo = cuda_pairs.build_tgt_geo(pos, rad).contiguous()
    return src_fm.to(dev), tgt_geo.to(dev)


def _groups(dev, gt_list, nn=16, seed=1, group=8):
    g = torch.Generator().manual_seed(seed)
    gt = torch.tensor(gt_list)
    gs = torch.randint(1, nn, (len(gt_list), group), generator=g)
    gs[:, -2:] = torch.where(torch.rand((len(gt_list), 2), generator=g)
                             < 0.5, 0, gs[:, -2:])
    gs[gt == 0] = 0
    return gt.to(dev), gs.to(dev)


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
@pytest.mark.parametrize("gt_list", ([1, 1, 2, 3, 3, 0, 0, 0],
                                     [1, 1, 0, 2, 2, 0, 3, 0], [0] * 8))
def test_k1_matches_twin(dev, gt_list, name, core):
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel)
    gt, gs = _groups(dev, gt_list)
    key = ("exec", cuda_lib.instance(name, core))
    before = cuda_pairs.LAUNCHES[key]
    got = cuda_pairs.exec_pairs_cuda(kernel, tgt_geo, src_fm, gt, gs,
                                     core=core)
    ref = cuda_pairs.exec_pairs_torch(kernel, tgt_geo, src_fm, gt, gs,
                                      core=core)
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[key] == before + int(any(gt_list))
    assert got.shape == (16, B, kernel.od)
    if any(gt_list):
        assert torch.isfinite(got).all()
        assert scale_rel_max(got[1:].cpu(), ref[1:].cpu()) < 1e-4
    else:
        assert not got.any()


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k2_matches_twin_and_keeps_root(dev, name, core):
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel)
    gt, gs = _groups(dev, [1, 1, 2, 3, 5, 0, 7, 0])
    out = torch.zeros((16, cuda_pairs.od8(kernel), B), device=dev)
    out[1] = 7.25
    twin = out.clone()
    key = ("exec_t2", cuda_lib.instance(name, core))
    before = cuda_pairs.LAUNCHES[key]
    cuda_pairs.exec_pairs_cuda_t2(kernel, tgt_geo, src_fm, gt, gs, out,
                                  core=core)
    cuda_pairs.exec_pairs_torch_t2(kernel, tgt_geo, src_fm, gt, gs, twin,
                                   core=core)
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[key] == before + 1
    assert scale_rel_max(out[2:].cpu(), twin[2:].cpu()) < 1e-4
    assert bool((out[1] == 7.25).all()) and not out[0].any()


# an odd block width above 512: a row takes two CTAs in K1 (289 threads
# of two points) and three in K2 (577 threads of one point on two rows)
RAGGED_B = 577


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k1_k2_ragged_match_twins(dev, name, core):
    """K1 and K2 at the ragged block width 577, with pad steps between
    and after the runs and id-0 slots inside steps as well as at their
    end: their twins within 1e-5 rel-RMS and 1e-4 max-rel, two launches
    bit identical, rows without a run and K2's rows 0/1 untouched; the
    occupancy report answers for both kinds at that width, with the ring
    of three staged blocks and no spill."""
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel, seed=3, b=RAGGED_B)
    inst = cuda_lib.instance(name, core)
    od8 = cuda_pairs.od8(kernel)
    aos = -(-cuda_pairs.FM_ROWS[name] // 4) * 4
    for kind, gt_list in (("exec", [3, 3, 0, 5, 1, 1, 1, 0, 9, 0]),
                          ("exec_t2", [1, 1, 2, 0, 3, 5, 0, 7])):
        paired = kind == "exec_t2"
        gt, gs = _groups(dev, gt_list, seed=4)
        gs[1, 2] = 0
        gs[4, 0:3] = 0
        out0 = torch.zeros((16, od8, RAGGED_B), device=dev)
        out0[1] = 7.25 if paired else 0.0
        if paired:
            run = cuda_pairs.exec_pairs_cuda_t2
            twin = cuda_pairs.exec_pairs_torch_t2(kernel, tgt_geo, src_fm,
                                                  gt, gs, out0.clone(),
                                                  core=core)
            rows = {2 * k + r for k in gt_list if k for r in (0, 1)}
        else:
            run = functools.partial(cuda_pairs.exec_pairs_cuda, final=False)
            twin = cuda_pairs.exec_pairs_torch(kernel, tgt_geo, src_fm, gt,
                                               gs, out0.clone(), final=False,
                                               core=core)
            rows = set(gt_list) - {0}
        before = cuda_pairs.LAUNCHES[(kind, inst)]
        outs = [run(kernel, tgt_geo, src_fm, gt, gs, out0.clone(),
                    core=core) for _ in range(2)]
        torch.cuda.synchronize()
        assert cuda_pairs.LAUNCHES[(kind, inst)] == before + 2
        assert torch.equal(outs[0], outs[1]), kind
        got = outs[0]
        assert torch.isfinite(got).all()
        lo = 2 if paired else 1
        assert rel_rms(got[lo:].cpu(), twin[lo:].cpu()) <= 1e-5, kind
        assert scale_rel_max(got[lo:].cpu(), twin[lo:].cpu()) <= 1e-4, kind
        if paired:
            assert bool((got[1] == 7.25).all())
        untouched = [r for r in range(lo, 16) if r not in rows] + [0]
        assert not got[torch.tensor(untouched, device=dev)].any(), kind
        occ = cuda_lib.occupancy(kind, inst, RAGGED_B, src_fm.shape[1], 8)
        assert occ["ctas_per_sm"] >= 1 and occ["stages"] == 3, occ
        assert occ["smem"] == 3 * RAGGED_B * aos * 4, occ
        assert occ["local_bytes"] == 0, occ


@pytest.mark.parametrize("pad8", [False, True], ids=["lean", "pad8"])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k8_matches_twin_and_k1(dev, name, core, pad8):
    """K8 on lean rows and rows padded to 8, through the chunked front
    door with the list cut inside a run: its twin's result within the
    kernel limit, K1's on the same groups (bit for bit where a run is one
    segment: the one-step runs here, whose order of sums is K1's, and
    every run when nothing is split)."""
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel)
    if not pad8:
        src_fm = src_fm[:, :cuda_pairs.FM_ROWS[name]].contiguous()
    gt, gs = _groups(dev, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0])
    key = ("exec_pre_seg", cuda_lib.instance(name, core))
    before = cuda_pairs.LAUNCHES[key]
    one = cuda_pairs.exec_pairs(kernel, tgt_geo, src_fm, gt, gs, core=core,
                                fetch="pregather")
    assert cuda_pairs.LAUNCHES[key] == before + 1
    twin = cuda_pairs.exec_pairs(kernel, tgt_geo, src_fm, gt, gs, core=core,
                                 fetch="pregather", twin=True)
    k1 = cuda_pairs.exec_pairs(kernel, tgt_geo, src_fm, gt, gs, core=core,
                               fetch="dma_i")
    gathered = cuda_pairs._pregather(name, src_fm, gs, B, pad8=False)
    two = torch.zeros((16, cuda_pairs.od8(kernel), B), device=dev)
    for lo, hi in ((0, 6), (6, 10)):            # target 1's run is cut
        cuda_pairs.exec_pairs_pre_cuda(kernel, tgt_geo, gathered[lo:hi],
                                       gt[lo:hi], two, final=False,
                                       core=core)
    whole = cuda_pairs.exec_pairs_pre_cuda(
        kernel, tgt_geo, gathered, gt, final=False, core=core,
        n_slots=cuda_pairs.n_real_slots(gs), seg_steps=1 << 30)
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[key] == before + 4
    assert torch.isfinite(one).all()
    assert scale_rel_max(one[1:].cpu(), twin[1:].cpu()) < 1e-4
    assert scale_rel_max(one[1:].cpu(), k1[1:].cpu()) < 1e-4
    single = torch.tensor([5, 9], device=dev)
    assert torch.equal(one[single], k1[single])
    assert torch.equal(whole[:, :kernel.od].transpose(1, 2), k1)
    two = two[:, :kernel.od].transpose(1, 2)
    assert scale_rel_max(two[1:].cpu(), twin[1:].cpu()) < 1e-4
    assert not one[torch.tensor([0, 2, 4, 6, 7, 8], device=dev)].any()


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k9_matches_twin_and_keeps_root(dev, name, core):
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel)
    src_fm = src_fm[:, :cuda_pairs.FM_ROWS[name]].contiguous()
    gt, gs = _groups(dev, [1, 1, 2, 3, 5, 0, 7, 0])
    out = torch.zeros((16, cuda_pairs.od8(kernel), B), device=dev)
    out[1] = 7.25
    twin, k2, whole = out.clone(), out.clone(), out.clone()
    key = ("exec_pre_t2_seg", cuda_lib.instance(name, core))
    before = cuda_pairs.LAUNCHES[key]
    cuda_pairs.exec_pairs_t2(kernel, tgt_geo, src_fm, gt, gs, out, core=core,
                             fetch="pregather")
    cuda_pairs.exec_pairs_t2(kernel, tgt_geo, src_fm, gt, gs, twin,
                             core=core, fetch="pregather", twin=True)
    cuda_pairs.exec_pairs_t2(kernel, tgt_geo, src_fm, gt, gs, k2, core=core,
                             fetch="dma_i")
    cuda_pairs.exec_pairs_pre_cuda_t2(
        kernel, tgt_geo, cuda_pairs._pregather(name, src_fm, gs, B,
                                               pad8=False),
        gt, whole, core=core, n_slots=cuda_pairs.n_real_slots(gs),
        seg_steps=1 << 30)
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[key] == before + 2
    assert scale_rel_max(out[2:].cpu(), twin[2:].cpu()) < 1e-4
    assert scale_rel_max(out[2:].cpu(), k2[2:].cpu()) < 1e-4
    assert torch.equal(out[4:], k2[4:])         # one-step runs
    assert torch.equal(whole, k2)
    assert bool((out[1] == 7.25).all()) and not out[0].any()


def _long_runs(dev, keys, seed=2, group=8, nn=16):
    """Runs of 27-77 steps for `keys` (a treecode leaf's list), pads
    between some runs and at the tail, inert slots at the end of some
    steps."""
    g = torch.Generator().manual_seed(seed)
    gt = []
    for k in keys:
        gt += [k] * int(torch.randint(27, 78, (), generator=g))
        if torch.rand((), generator=g) < 0.5:
            gt.append(0)
    gt = torch.tensor(gt + [0, 0])
    gs = torch.randint(1, nn, (gt.shape[0], group), generator=g)
    n_real = torch.randint(1, group + 1, (gt.shape[0],), generator=g)
    gs = torch.where(torch.arange(group)[None, :] < n_real[:, None], gs, 0)
    gs[gt == 0] = 0
    return gt.to(dev), gs.to(dev)


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k8_k9_long_runs_split_match_twins(dev, name, core):
    """K8 and K9 on runs of 27-77 steps, lean rows, with the runs forced
    into segments of 1 and 2 steps, at the wrapper's S and unsplit:
    their twins within 1e-5 rel-RMS and 1e-4 max-rel; the segment and
    reduction kernels counted, K1/K2 not launched; two launches bit
    identical, one planned from the wrapper's own host copy of the keys
    and one from the caller's; K9's rows 0/1 untouched."""
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel)
    lean = src_fm[:, :cuda_pairs.FM_ROWS[name]].contiguous()
    inst = cuda_lib.instance(name, core)
    for paired, keys in ((False, [3, 9, 12]), (True, [2, 5, 7])):
        gt, gs = _long_runs(dev, keys)
        gathered = cuda_pairs._pregather(name, lean, gs, B, pad8=False)
        slots = cuda_pairs.n_real_slots(gs)
        out0 = torch.zeros((16, cuda_pairs.od8(kernel), B), device=dev)
        out0[1] = 7.25
        twin = out0.clone()
        if paired:
            run = cuda_pairs.exec_pairs_pre_cuda_t2
            cuda_pairs.exec_pairs_pre_torch_t2(kernel, tgt_geo, gathered, gt,
                                               twin, core=core)
        else:
            run = functools.partial(cuda_pairs.exec_pairs_pre_cuda,
                                    final=False)
            cuda_pairs.exec_pairs_pre_torch(kernel, tgt_geo, gathered, gt,
                                            twin, final=False, core=core)
        kinds = ("exec_pre_t2_seg" if paired else "exec_pre_seg",
                 "exec_pre_reduce")
        for seg_steps in (1, 2, None, 1 << 30):
            cuda_pairs.LAUNCHES.clear()
            # planned from a host copy the wrapper makes, then from the
            # caller's (the chunked front door's way)
            outs = [run(kernel, tgt_geo, gathered, gt, out0.clone(),
                        core=core, n_slots=slots, seg_steps=seg_steps,
                        gt_host=host)
                    for host in (None, gt.cpu())]
            torch.cuda.synchronize()
            split = seg_steps != 1 << 30
            assert dict(cuda_pairs.LAUNCHES) == {
                (k, inst): 2 for k in kinds[:1 + split]}, seg_steps
            assert torch.equal(outs[0], outs[1]), seg_steps
            got = outs[0]
            assert torch.isfinite(got).all()
            assert rel_rms(got[2:].cpu(), twin[2:].cpu()) <= 1e-5
            assert scale_rel_max(got[2:].cpu(), twin[2:].cpu()) <= 1e-4
            assert bool((got[1] == 7.25).all()) and not got[0].any()


@pytest.mark.parametrize("paired", [False, True], ids=["k8", "k9"])
def test_k8_k9_chunk_cut_inside_split_run(dev, paired):
    """The chunked front door with chunks of 16 steps on runs of 27-77
    steps, so chunk boundaries cut split runs: each chunk's reduction
    adds onto what the earlier chunks left in the accumulator, within
    the kernel limit of the twin through the same chunks."""
    kernel = get_kernel("vortgrad3d")
    src_fm, tgt_geo = _blocks(dev, kernel)
    lean = src_fm[:, :cuda_pairs.FM_ROWS["vortgrad3d"]].contiguous()
    gt, gs = _long_runs(dev, [2, 5, 7] if paired else [3, 9, 12], seed=3)
    out = torch.zeros((16, cuda_pairs.od8(kernel), B), device=dev)
    twin = out.clone()
    default = cuda_pairs.pregather_chunk
    try:
        cuda_pairs.pregather_chunk = lambda g, c, b: 16
        cuda_pairs.LAUNCHES.clear()
        if paired:
            cuda_pairs.exec_pairs_t2(kernel, tgt_geo, lean, gt, gs, out,
                                     fetch="pregather")
            cuda_pairs.exec_pairs_t2(kernel, tgt_geo, lean, gt, gs, twin,
                                     fetch="pregather", twin=True)
        else:
            cuda_pairs.exec_pairs(kernel, tgt_geo, lean, gt, gs,
                                  fetch="pregather", out_fm=out, final=False)
            cuda_pairs.exec_pairs(kernel, tgt_geo, lean, gt, gs,
                                  fetch="pregather", out_fm=twin,
                                  final=False, twin=True)
    finally:
        cuda_pairs.pregather_chunk = default
    torch.cuda.synchronize()
    inst = cuda_lib.instance("vortgrad3d", "rm")
    n_chunks = sum(bool((gt[i:i + 16] != 0).any())
                   for i in range(0, gt.shape[0], 16))
    seg = "exec_pre_t2_seg" if paired else "exec_pre_seg"
    assert cuda_pairs.LAUNCHES[(seg, inst)] == n_chunks
    assert cuda_pairs.LAUNCHES[("exec_pre_reduce", inst)] >= 1
    assert cuda_pairs.LAUNCHES[("exec", inst)] == 0
    assert rel_rms(out[2:].cpu(), twin[2:].cpu()) <= 1e-5
    assert scale_rel_max(out[2:].cpu(), twin[2:].cpu()) <= 1e-4


def test_pre_kernels_refuse_bad_input(dev):
    src_fm, tgt_geo = _blocks(dev)
    gt, gs = _groups(dev, [1, 1, 0, 1])
    gathered = cuda_pairs._pregather("grav3d", src_fm, gs, B, pad8=False)
    with pytest.raises(ValueError, match="two separate runs"):
        cuda_pairs.exec_pairs_pre_cuda(KER, tgt_geo, gathered, gt)
    with pytest.raises(ValueError, match="out of range"):
        cuda_pairs.exec_pairs_pre_cuda_t2(
            KER, tgt_geo, gathered, torch.tensor([8, 0, 0, 0], device=dev),
            torch.zeros((16, 8, B), device=dev))
    with pytest.raises(ValueError, match="is not"):
        cuda_pairs.exec_pairs_pre_cuda(KER, tgt_geo, gathered[:, :-1],
                                       torch.tensor([1, 0, 0, 0],
                                                    device=dev))
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_pairs.exec_pairs_pre_cuda(KER, tgt_geo, gathered, gt.cpu())


def test_kernels_refuse_bad_lists(dev):
    src_fm, tgt_geo = _blocks(dev)
    gs = torch.ones((4, 8), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="two separate runs"):
        cuda_pairs.exec_pairs_cuda(KER, tgt_geo, src_fm,
                                   torch.tensor([1, 1, 0, 1], device=dev),
                                   gs)
    with pytest.raises(ValueError, match="out of range"):
        cuda_pairs.exec_pairs_cuda_t2(
            KER, tgt_geo, src_fm, torch.tensor([8, 0, 0, 0], device=dev),
            gs, torch.zeros((16, 8, B), device=dev))
    # a core the workload has no CUDA body for (v2 is vort3d's only)
    # raises instead of falling back
    vk = get_kernel("vort2d")
    vsrc, vgeo = _blocks(dev, vk)
    with pytest.raises(ValueError, match="core_func"):
        cuda_pairs.exec_pairs_cuda(vk, vgeo, vsrc,
                                   torch.tensor([1, 0, 0, 0], device=dev),
                                   gs, core="v2")


# the cores whose reciprocals and square roots are one MUFU each
# (csrc/mufu.cuh): K5 (vort2d's RM core), K6-v2 (vort3d's v2 core) and
# the exp core of each vortex body; the front door's fetch of each
# executor kind on them
ONE_MUFU = [("vort2d", "rm"), ("vort3d", "v2"), ("vort2d", "exp"),
            ("vort3d", "exp"), ("vortgrad3d", "exp")]
ONE_MUFU_FETCH = {"exec": "dma_i", "exec_t2": "dma_i",
                  "exec_pre_seg": "pregather",
                  "exec_pre_t2_seg": "pregather", "exec_dma": "dma",
                  "exec_dmap": "dma_p", "exec_static": "static"}


def _edge_points(kernel, core, nn=16, b=B, seed=7):
    """Points at the one-MUFU cores' edges, (pos, source radii, target
    radii, strengths) as blocks: every source also a target (d2 = 0 on a
    block against itself), the inert row 0; vort2d's target radii 0,
    with the v2 core every other source radius 0 (its guard at d2 =
    0)."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((nn, b, kernel.pd), generator=g)
    rad = 0.03 + 0.04 * torch.rand((nn, b), generator=g)
    s = torch.randn((nn, b, kernel.sd), generator=g) / b
    pos[0], rad[0], s[0] = 0.0, 1.0, 0.0
    trad = rad.clone()
    if kernel.name == "vort2d":
        trad[1:] = 0.0
    elif core == "v2":
        rad[1:, ::2] = 0.0
    return pos, rad, trad, s


@pytest.mark.parametrize("kind", list(ONE_MUFU_FETCH) + ["direct"])
@pytest.mark.parametrize("name,core", ONE_MUFU,
                         ids=[f"{k}-{c}" for k, c in ONE_MUFU])
def test_one_mufu_cores_at_their_edges(dev, name, core, kind):
    """K1, K2, K8-K12 through the front door and K4, with K5, K6-v2 and
    the exp cores, on _edge_points with a self pair in every step: finite
    where the twin is, within chip_smoke.py's kernel limits of it (1e-5
    rel-RMS, 1e-4 max-rel), one launch at least, the inert row 0 (and
    K2's root row 1) untouched."""
    kernel = get_kernel(name)
    pos, rad, trad, s = _edge_points(kernel, core)
    inst = cuda_lib.instance(name, core)
    before = cuda_pairs.LAUNCHES[(kind, inst)] + cuda_direct.LAUNCHES[
        (kind, inst)]
    if kind == "direct":
        args = [pos.reshape(-1, kernel.pd), trad.reshape(-1),
                pos.reshape(-1, kernel.pd), rad.reshape(-1),
                s.reshape(-1, kernel.sd)]
        if not kernel.uses_tr:
            args[1] = torch.zeros_like(args[1])
        got = cuda_direct.direct_cuda(kernel, *(a.to(dev) for a in args),
                                      core)
        twin = cuda_direct.direct_torch(kernel, *args, core)
        lo = 0
    else:
        src_fm = cuda_pairs.build_fm_blocks(kernel, pos, rad, s).to(dev)
        if kind in ("exec_pre_seg", "exec_pre_t2_seg", "exec_static"):
            src_fm = src_fm[:, :cuda_pairs.FM_ROWS[name]]
        src_fm = src_fm.contiguous()
        tgt_geo = cuda_pairs.build_tgt_geo(pos, trad).contiguous().to(dev)
        paired = kind in ("exec_t2", "exec_pre_t2_seg")
        fetch = ONE_MUFU_FETCH[kind]
        if paired:
            gt, gs = _groups(dev, [1, 1, 2, 3, 5, 0, 7, 0])
            gs[:, 0] = 2 * gt                   # row 2q against itself
            got = torch.zeros((16, cuda_pairs.od8(kernel), B), device=dev)
            got[1] = 7.25
            twin = got.clone()
            for out, tw in ((got, False), (twin, True)):
                cuda_pairs.exec_pairs_t2(kernel, tgt_geo, src_fm, gt, gs,
                                         out, core=core, fetch=fetch,
                                         twin=tw)
            assert bool((got[1] == 7.25).all())
            lo = 2
        else:
            gt, gs = _groups(dev, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0])
            gs[:, 0] = gt                       # a block against itself
            got, twin = (cuda_pairs.exec_pairs(
                kernel, tgt_geo, src_fm, gt, gs, core=core, fetch=fetch,
                twin=tw) for tw in (False, True))
            lo = 1
        assert not got[0].any()
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[(kind, inst)] + cuda_direct.LAUNCHES[
        (kind, inst)] > before
    assert torch.isfinite(twin).all()
    assert torch.isfinite(got).all()
    got, twin = got[lo:].cpu(), twin[lo:].cpu()
    assert rel_rms(got, twin) <= 1e-5
    assert scale_rel_max(got, twin) <= 1e-4


@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k4_matches_twin_and_oracle(dev, name, core):
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 5, 20000, 3000)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    key = ("direct", cuda_lib.instance(name, core))
    before = cuda_direct.LAUNCHES[key]
    got = direct.direct(kernel, _to(srcs, dev), _to(targs, dev), core=core)
    torch.cuda.synchronize()
    assert cuda_direct.LAUNCHES[key] == before + 1
    twin = direct.direct(kernel, srcs, targs, core=core)
    assert rel_rms(got.cpu(), twin) < 1e-5
    orc = direct.direct_oracle(kernel, srcs, targs, core=core)
    assert rel_rms(got.cpu(), orc) < 1e-5


# K4's forced split counts: one launch writing the output, and the
# sources cut into 2 and 7 splits of whole chunks plus the reduction
K4_SPLITS = [1, 2, 7]


@pytest.mark.parametrize("splits", K4_SPLITS)
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k4_forced_splits_match_twins(dev, name, core, splits):
    """K4 at a forced split count, on 1500 targets (a tile and a ragged
    one) against 9000 sources (17 chunks of 512 and a short one): the
    twin within chip_smoke.py's kernel limits (1e-5 rel-RMS, 1e-4
    max-rel), the split path's twin, two calls bit identical, and the
    launches of the kernel and its reduction (none for one split)."""
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 6, 9000, 1500)
    args = [torch.from_numpy(a) for a in (tx, tr, sx, sr, ss)]
    if not kernel.uses_tr:
        args[1] = torch.zeros_like(args[1])
    cargs = [a.to(dev) for a in args]
    inst = cuda_lib.instance(name, core)
    kinds = ("direct", "direct_reduce")
    before = {k: cuda_direct.LAUNCHES[(k, inst)] for k in kinds}
    got = cuda_direct.direct_cuda(kernel, *cargs, core, splits=splits)
    again = cuda_direct.direct_cuda(kernel, *cargs, core, splits=splits)
    torch.cuda.synchronize()
    assert {k: cuda_direct.LAUNCHES[(k, inst)] - before[k]
            for k in kinds} == {"direct": 2,
                                "direct_reduce": 2 * (splits > 1)}
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    for ref in (cuda_direct.direct_torch(kernel, *args, core),
                cuda_direct.direct_split_torch(kernel, *args, core,
                                               splits)):
        assert rel_rms(got.cpu(), ref) <= 1e-5
        assert scale_rel_max(got.cpu(), ref) <= 1e-4


@pytest.mark.parametrize("name", WORKLOADS)
def test_k4_plan_launches_and_bits(dev, name):
    """K4 at the wrapper's own plan: a few targets against many sources
    split (the kernel and one reduction), targets that fill two waves
    of the most CTAs an SM holds (8 of 256 threads) not (the kernel
    alone); each twice, bit identical."""
    kernel = get_kernel(name)
    inst = cuda_lib.instance(name, "rm")
    for m, s in ((700, 40_000), (1_100_000, 600)):
        sx, sr, ss, tx, tr = kernel_inputs(kernel, 8, s, m)
        args = [torch.from_numpy(a).to(dev) for a in (tx, tr, sx, sr, ss)]
        splits = cuda_direct.splits_for(kernel, "rm", m, s, dev)
        assert (splits > 1) == (m == 700)
        before = {k: cuda_direct.LAUNCHES[(k, inst)]
                  for k in ("direct", "direct_reduce")}
        got = cuda_direct.direct_cuda(kernel, *args)
        again = cuda_direct.direct_cuda(kernel, *args)
        torch.cuda.synchronize()
        assert cuda_direct.LAUNCHES[("direct", inst)] == before["direct"] + 2
        assert cuda_direct.LAUNCHES[("direct_reduce", inst)] == (
            before["direct_reduce"] + 2 * (splits > 1))
        assert torch.equal(got, again)
        rows = slice(0, m, max(1, m // 500))
        twin = cuda_direct.direct_torch(kernel, *(a.cpu() for a in (
            args[0][rows], args[1][rows], *args[2:])))
        assert rel_rms(got[rows].cpu(), twin) <= 1e-5
        assert scale_rel_max(got[rows].cpu(), twin) <= 1e-4


@pytest.mark.parametrize("name", ["vort2d", "vortgrad3d"])
def test_api_on_card_matches_cpu(dev, name):
    """The library API on the card (device=None) against device='cpu':
    K8's segment kernel launched, K1 not."""
    from onbody_tpu_torch.api import solver
    kernel = get_kernel(name)
    sx, sr, ss, _, _ = kernel_inputs(kernel, 61, 3000)
    if name == "vort2d":
        args, kw = (sx[:, 0], sx[:, 1], ss[:, 0], sr, sx[:, 0],
                    sx[:, 1]), dict(tr=sr)
        fn = solver.vel_solver_2d
    else:
        args, kw = (*sx.T, *ss.T, sr, *sx.T), {}
        fn = solver.vel_solver_3dvortgrads
    inst = cuda_lib.instance(name, "rm")
    before = dict(cuda_pairs.LAUNCHES)
    got = fn(*args, **kw)
    assert cuda_pairs.LAUNCHES[("exec_pre_seg", inst)] > before.get(
        ("exec_pre_seg", inst), 0)
    assert cuda_pairs.LAUNCHES[("exec", inst)] == before.get(("exec", inst),
                                                             0)
    ref = fn(*args, **kw, device="cpu")
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and rel_rms(g, r) <= 1e-5


@pytest.mark.parametrize("method", ["solve_treecode3", "solve_treecode2",
                                    "solve_treecode1"])
def test_treecodes_on_card_match_cpu(dev, method):
    sx, sr, ss, tx, tr = kernel_inputs(KER, 62, 3000)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = SolverConfig(block_size=64, order=4, frontier_width=256,
                       list_width=512)
    solve = getattr(treecode, method)
    cpu_out, cpu_info = solve(KER, cfg, treecode.prepare(KER, cfg, srcs,
                                                         targs))
    out, info = solve(KER, cfg, treecode.prepare(KER, cfg, _to(srcs, dev),
                                                 _to(targs, dev)))
    assert int(info.overflow) == int(cpu_info.overflow) == 0
    assert int(info.n_valid) == int(cpu_info.n_valid)
    assert rel_rms(out.cpu(), cpu_out) <= 1e-5


@pytest.mark.parametrize("name", WORKLOADS)
def test_slice_on_card_matches_cpu(dev, name):
    """prepare + solve_dtt through K1/K2 on the card vs the twins on the
    CPU, N = 3000 at the test slice configuration."""
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 60, 3000)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = SolverConfig(**SLICE_KW)
    cpu_out, cpu_info = dtt.solve_dtt(
        kernel, cfg, treecode.prepare(kernel, cfg, srcs, targs))
    inst = cuda_lib.instance(name, cfg.core_func)
    keys = [("exec", inst), ("exec_t2", inst)]
    before = [cuda_pairs.LAUNCHES[k] for k in keys]
    gcfg = cfg.replace(pair_backend="cuda")
    out, info = dtt.solve_dtt(
        kernel, gcfg, treecode.prepare(kernel, gcfg, _to(srcs, dev),
                                       _to(targs, dev)))
    torch.cuda.synchronize()
    assert all(cuda_pairs.LAUNCHES[k] > b for k, b in zip(keys, before))
    assert int(info.overflow) == int(cpu_info.overflow) == 0
    assert rel_rms(out.cpu(), cpu_out) <= 1e-5


# the reference's adjacency cases (tests/test_pallas.py:287-290)
ADJACENCY = [[2, 3, 4, 5, 6, 7, 8, 9], [3, 4, 7, 9, 10, 13, 0, 0],
             [5, 9, 11, 2, 6, 8, 14, 15], [4, 5, 6, 1, 12, 2, 0, 0]]


def _adjacent_groups(dev, gt_list):
    gt = torch.tensor(gt_list)
    gs = torch.tensor([ADJACENCY[i % 4] for i in range(len(gt_list))])
    gs[gt == 0] = 0
    return gt.to(dev), gs.to(dev)


# K10/K11's block widths: the main tests' B; 36, a multiple of 4 (as bulk
# copies need) whose 18 threads a row are not a whole warp; 516, above
# 512, where a row takes two CTAs (256 threads and 2)
FETCH_B = [B, 36, 516]


@pytest.mark.parametrize("b", FETCH_B)
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k10_k11_equal_k1_and_match_twin(dev, name, core, b):
    """K10 and K11 on runs of 1-3 steps with pads between and after them
    and the adjacency cases in every step: K1's result bit for bit, its
    twin's within the kernel limit, one launch each."""
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel, b=b)
    gt, gs = _adjacent_groups(dev, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0, 0])
    inst = cuda_lib.instance(name, core)
    k1 = cuda_pairs.exec_pairs_cuda(kernel, tgt_geo, src_fm, gt, gs,
                                    final=False, core=core)
    twin = cuda_pairs.exec_pairs_torch(kernel, tgt_geo, src_fm, gt, gs,
                                       final=False, core=core)
    for kind, fn in (("exec_dma", cuda_pairs.exec_pairs_dma_cuda),
                     ("exec_dmap", cuda_pairs.exec_pairs_dmap_cuda)):
        before = cuda_pairs.LAUNCHES[(kind, inst)]
        out = fn(kernel, tgt_geo, src_fm, gt, gs, final=False, core=core)
        torch.cuda.synchronize()
        assert cuda_pairs.LAUNCHES[(kind, inst)] == before + 1
        assert torch.equal(out, k1), kind
        assert scale_rel_max(out[1:].cpu(), twin[1:].cpu()) < 1e-4
    occ = {k: cuda_lib.occupancy(k, inst, b, src_fm.shape[1], 8)
           for k in cuda_lib.OCCUPANCY_KINDS}
    assert all(o["ctas_per_sm"] >= 1 and o["smem"] > 0
               for o in occ.values()), occ


@pytest.mark.parametrize("kind", ["exec_dma", "exec_dmap"])
def test_k10_k11_launch_after_smaller_occupancy_query(dev, kind):
    """An occupancy query at B 32 sets the kernel's shared-memory limit to
    that B's ring; a launch at B 516 (K11's ring above the 48 KiB a launch
    gets without the attribute) then sets its own and gives K1's
    result."""
    src_fm, tgt_geo = _blocks(dev, b=516)
    gt, gs = _adjacent_groups(dev, [3, 3, 0, 5, 1, 1, 1, 0, 9, 0, 0])
    c = src_fm.shape[1]
    small = cuda_lib.occupancy(kind, "grav3d", 32, c, 8)
    big = cuda_lib.occupancy(kind, "grav3d", 516, c, 8)
    small = cuda_lib.occupancy(kind, "grav3d", 32, c, 8)
    assert small["smem"] < big["smem"]
    fn = {"exec_dma": cuda_pairs.exec_pairs_dma_cuda,
          "exec_dmap": cuda_pairs.exec_pairs_dmap_cuda}[kind]
    before = cuda_pairs.LAUNCHES[(kind, "grav3d")]
    got = fn(KER, tgt_geo, src_fm, gt, gs, final=False)
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[(kind, "grav3d")] == before + 1
    k1 = cuda_pairs.exec_pairs_cuda(KER, tgt_geo, src_fm, gt, gs,
                                    final=False)
    assert torch.equal(got, k1)


@pytest.mark.parametrize("b", FETCH_B)
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k12_matches_twin_and_k1(dev, name, core, b):
    """K12 through the front door (fetch='static': the gather, one CTA
    per step, the reduction of the runs of 2 and 3 steps) with lean rows
    at B 128, 36 and 516: two launches bit identical and K8's sums at
    one step per segment bit for bit; its twin's result and K1's on the
    same groups within 1.1e-6 rel-RMS (other orders of the same fp32
    sums); rows without a run untouched."""
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel, b=b)
    lean = src_fm[:, :cuda_pairs.FM_ROWS[name]].contiguous()
    gt, gs = _groups(dev, [1, 1, 0, 2, 2, 2, 0, 5, 7, 9, 9, 9, 0])
    inst = cuda_lib.instance(name, core)
    before = {k: cuda_pairs.LAUNCHES[(k, inst)]
              for k in ("exec_static", "exec_pre_reduce")}
    got = cuda_pairs.exec_pairs(kernel, tgt_geo, lean, gt, gs, core=core,
                                fetch="static")
    torch.cuda.synchronize()
    assert {k: cuda_pairs.LAUNCHES[(k, inst)] - v
            for k, v in before.items()} == {"exec_static": 1,
                                            "exec_pre_reduce": 1}
    again = cuda_pairs.exec_pairs(kernel, tgt_geo, lean, gt, gs, core=core,
                                  fetch="static")
    assert torch.equal(got, again)
    k8 = cuda_pairs.exec_pairs_pre_cuda(
        kernel, tgt_geo, cuda_pairs._pregather(name, lean, gs, b,
                                               pad8=False),
        gt, core=core, n_slots=cuda_pairs.n_real_slots(gs), seg_steps=1)
    assert torch.equal(got, k8)
    twin = cuda_pairs.exec_pairs(kernel, tgt_geo, lean, gt, gs, core=core,
                                 fetch="static", twin=True)
    k1 = cuda_pairs.exec_pairs_cuda(kernel, tgt_geo, src_fm, gt, gs,
                                    core=core)
    for ref in (twin, k1):
        assert rel_rms(got[1:].cpu(), ref[1:].cpu()) <= 1.1e-6
    assert not got[torch.tensor([0, 3, 4, 6, 8], device=dev)].any()


def test_k12_launch_after_smaller_occupancy_query(dev):
    """An occupancy query at a small B sets K12's shared-memory limit to
    that B's size; the launch at a larger B then sets its own (it used
    to set it only above 48 KiB, and was refused) and matches its
    twin."""
    src_fm, tgt_geo = _blocks(dev)
    lean = src_fm[:, :cuda_pairs.FM_ROWS["grav3d"]].contiguous()
    gt, gs = _groups(dev, [1, 1, 0, 2, 2, 2, 0, 5, 7, 9, 9, 9, 0])
    c = lean.shape[1]
    big = cuda_lib.occupancy("exec_static", "grav3d", B, c, 8)
    small = cuda_lib.occupancy("exec_static", "grav3d", 32, c, 8)
    assert small["smem"] < big["smem"] <= 48 * 1024
    before = cuda_pairs.LAUNCHES[("exec_static", "grav3d")]
    got = cuda_pairs.exec_pairs(KER, tgt_geo, lean, gt, gs, fetch="static")
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[("exec_static", "grav3d")] == before + 1
    twin = cuda_pairs.exec_pairs(KER, tgt_geo, lean, gt, gs, fetch="static",
                                 twin=True)
    assert rel_rms(got[1:].cpu(), twin[1:].cpu()) <= 1.1e-6


def test_fetch_kernels_refuse_unaligned_blocks(dev):
    """Bulk copies need 16-byte aligned blocks: B = 30 raises, and
    nothing falls back to another kernel."""
    g = torch.Generator().manual_seed(3)
    pos = torch.rand((4, 30, 3), generator=g)
    rad = torch.full((4, 30), 0.05)
    s = torch.rand((4, 30, 1), generator=g)
    src_fm = cuda_pairs.build_fm_blocks(KER, pos, rad, s).contiguous()
    tgt_geo = cuda_pairs.build_tgt_geo(pos, rad).contiguous()
    gt = torch.tensor([1, 2], device=dev)
    gs = torch.tensor([[1, 2], [3, 0]], device=dev)
    before = dict(cuda_pairs.LAUNCHES)
    for fetch in ("dma", "dma_p"):
        with pytest.raises(ValueError, match="16-byte"):
            cuda_pairs.exec_pairs(KER, tgt_geo.to(dev), src_fm.to(dev), gt,
                                  gs, fetch=fetch)
    assert dict(cuda_pairs.LAUNCHES) == before


@pytest.mark.parametrize("fetch", ["dma", "dma_p", "static"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_fetch_slice_on_card_matches_cpu(dev, name, fetch):
    """prepare + solve_dtt under S-dma (K10 + K2), S-dma_p (K11 + K2 on
    idsort lists) and S-static (K12) on the card vs the twins on the
    CPU, N = 3000; K1 is not launched."""
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 60, 3000)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = SolverConfig(**SLICE_KW).replace(pair_fetch=fetch)
    if fetch == "dma_p":
        cfg = cfg.replace(list_compact="idsort")
    cpu_out, cpu_info = dtt.solve_dtt(
        kernel, cfg, treecode.prepare(kernel, cfg, srcs, targs))
    inst = cuda_lib.instance(name, cfg.core_func)
    kind = {"dma": "exec_dma", "dma_p": "exec_dmap",
            "static": "exec_static"}[fetch]
    before = dict(cuda_pairs.LAUNCHES)
    gcfg = cfg.replace(pair_backend="cuda")
    out, info = dtt.solve_dtt(
        kernel, gcfg, treecode.prepare(kernel, gcfg, _to(srcs, dev),
                                       _to(targs, dev)))
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[(kind, inst)] > before.get((kind, inst), 0)
    assert cuda_pairs.LAUNCHES[("exec", inst)] == before.get(("exec", inst),
                                                             0)
    assert int(info.overflow) == int(cpu_info.overflow) == 0
    assert rel_rms(out.cpu(), cpu_out) <= 1e-5


@pytest.mark.parametrize("mode", cuda_lib.ABLATE_MODES)
def test_k13_matches_twin(dev, mode):
    """K13 in each mode on exp_kernel's list at a small size (wrapping
    target ids, sorted into one run per target) against its twin on the
    same tensors; launches counted; 'full' equals K10 grav3d on rows
    that store sr^2."""
    from onbody_tpu_torch.scripts import exp_kernel
    tgt_geo, src_fm, gt, gs = exp_kernel.make_problem(
        128, 16, dev, nn=512, p=4096)
    cuda_pairs.LAUNCHES.clear()
    got = exp_kernel.run(mode, tgt_geo, src_fm, gt, gs)
    twin = cuda_pairs.exec_ablate_torch(mode, tgt_geo, src_fm, gt, gs)
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[(f"exec_ablate_{mode}", "grav3d")] == 1
    assert torch.isfinite(got).all()
    assert rel_rms(got.cpu(), twin.cpu()) <= 1e-5
    assert scale_rel_max(got.cpu(), twin.cpu()) <= 1e-4
    occ = cuda_lib.occupancy(f"ablate_{mode}", "grav3d", 128, 8, 16)
    assert occ["ctas_per_sm"] >= 1 and occ["stages"] >= 2
    if mode == "full":
        squared = src_fm.clone()
        squared[:, 3] = src_fm[:, 3] * src_fm[:, 3]
        k10 = cuda_pairs.exec_pairs_dma_cuda(KER, tgt_geo, squared, gt, gs,
                                             final=False)
        assert torch.equal(got, k10)


def test_k13_refuses_two_runs_of_one_target(dev):
    """The script's list unsorted: a target in two runs would be two
    CTAs racing on one row; the wrapper raises."""
    from onbody_tpu_torch.scripts import exp_kernel
    tgt_geo, src_fm, _, _ = exp_kernel.make_problem(128, 16, dev, nn=512,
                                                    p=4096)
    gt, gs = exp_kernel.make_list(512, 4096, 16,
                                  torch.Generator(device=dev).manual_seed(0))
    with pytest.raises(ValueError, match="two separate runs"):
        cuda_pairs.exec_ablate("full", tgt_geo, src_fm, gt, gs)


# ------------------------------------------------ the fused solve's route

CAPPED_KINDS = {"exec": False, "exec_t2": True, "exec_dma": False,
                "exec_dmap": False}


@pytest.mark.parametrize("kind", list(CAPPED_KINDS))
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_capped_kernels_equal_trimmed(dev, name, core, kind):
    """K1, K2, K10 and K11 at static capacity (the run table from
    capped_runs on the card, the count read from device memory, a CTA per
    step slot): the trimmed launch's output bit for bit, one launch."""
    kernel = get_kernel(name)
    src_fm, tgt_geo = _blocks(dev, kernel)
    paired = CAPPED_KINDS[kind]
    keys = [1, 1, 2, 3, 3, 5, 5, 5, 7] + [0] * 23
    gt, gs = _adjacent_groups(dev, keys)
    fetch = {"exec": "dma_i", "exec_t2": "dma_i", "exec_dma": "dma",
             "exec_dmap": "dma_p"}[kind]
    out0 = torch.zeros((16, cuda_pairs.od8(kernel), B), device=dev)
    out0[1] = 7.25
    trimmed = out0.clone()
    if paired:
        cuda_pairs.exec_pairs_t2(kernel, tgt_geo, src_fm, gt, gs, trimmed,
                                 core, fetch=fetch)
    else:
        cuda_pairs.exec_pairs(kernel, tgt_geo, src_fm, gt, gs, core,
                              fetch=fetch, out_fm=trimmed, final=False)
    inst = cuda_lib.instance(name, core)
    before = cuda_pairs.LAUNCHES[(kind, inst)]
    checks = cuda_pairs.RunChecks()
    capped = cuda_pairs.exec_pairs_capped(kernel, tgt_geo, src_fm, gt, gs,
                                          checks, core, fetch, out0.clone(),
                                          paired=paired)
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[(kind, inst)] == before + 1
    assert checks.word(dev).tolist() == [0]
    assert torch.equal(capped, trimmed)


# the fetch of each kernel on pre-gathered sources at static capacity
CAPPED_PRE = {"exec_pre": "pregather", "exec_pre_t2": "pregather",
              "exec_static": "static"}


def _two_chunk_list(dev, paired: bool, seed=63):
    """A list whose real steps span two pregather chunks at B 128 / G 8
    (8192 steps a chunk): runs of 1-40 steps of distinct keys, one cut by
    the chunk boundary, then pad steps up to 12000 step slots; the
    trimmed list and the list at its capacity."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, 41, (440,), generator=g)
    keys = torch.randperm(440, generator=g) + 1
    gt = torch.repeat_interleave(keys, lens)[:9000]
    assert gt[8191] == gt[8192]
    gs = torch.randint(1, 16, (gt.shape[0], 8), generator=g)
    gs[torch.rand(gs.shape, generator=g) < 0.25] = 0
    cap_t = torch.cat([gt, gt.new_zeros(3000)])
    cap_s = torch.cat([gs, gs.new_zeros((3000, 8))])
    nn = 2 * 441 + 2 if paired else 441
    return nn, (gt.to(dev), gs.to(dev)), (cap_t.to(dev), cap_s.to(dev))


@pytest.mark.parametrize("kind", list(CAPPED_PRE))
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_capped_pre_kernels_equal_trimmed(dev, name, core, kind):
    """K8, K9 and K12 with their reduction at static capacity (each gather
    chunk's plan made on the card by capped_segments, the segment and
    split-run counts read from device memory, the segment grid at the
    chunk's capacity), on a list whose runs cross a chunk boundary: the
    eager front door's output on the trimmed list bit for bit, one
    segment launch and one reduction per chunk, no error."""
    kernel = get_kernel(name)
    paired = kind == "exec_pre_t2"
    nn, (gt, gs), (cgt, cgs) = _two_chunk_list(dev, paired)
    src_fm, tgt_geo = _blocks(dev, kernel, nn=nn)
    fetch = CAPPED_PRE[kind]
    out0 = torch.zeros((nn, cuda_pairs.od8(kernel), B), device=dev)
    out0[1] = 7.25
    trimmed = out0.clone()
    if paired:
        cuda_pairs.exec_pairs_t2(kernel, tgt_geo, src_fm, gt, gs, trimmed,
                                 core, fetch=fetch)
    else:
        cuda_pairs.exec_pairs(kernel, tgt_geo, src_fm, gt, gs, core,
                              fetch=fetch, out_fm=trimmed, final=False)
    inst = cuda_lib.instance(name, core)
    seg = kind if kind == "exec_static" else kind + "_seg"
    before = [cuda_pairs.LAUNCHES[(k, inst)]
              for k in (seg, "exec_pre_reduce")]
    checks = cuda_pairs.RunChecks()
    capped = cuda_pairs.exec_pairs_capped(kernel, tgt_geo, src_fm, cgt, cgs,
                                          checks, core, fetch, out0.clone(),
                                          paired=paired)
    torch.cuda.synchronize()
    assert [cuda_pairs.LAUNCHES[(k, inst)] - n for k, n in zip(
        (seg, "exec_pre_reduce"), before)] == [2, 2]
    assert checks.word(dev).tolist() == [0, 0]
    assert torch.equal(capped, trimmed)
    assert bool((capped[1] == 7.25).all()) or not paired


def _fused_problem(dev, name="grav3d", n=3000, seed=61):
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, seed, n)
    return (kernel, _to(torch_parts(sx, sr, ss), dev),
            _to(torch_parts(tx, tr), dev))


# the fused solve's keys by fetch: the slice's (dma_i), pregather (K8 +
# K9), static (K12, no paired list)
FUSED_KW = {"dma_i": SLICE_KW,
            "pregather": dict(SLICE_KW, pair_fetch="pregather"),
            "static": dict(SLICE_KW, pair_fetch="static",
                           dtt_leaf_pair2=False)}


@pytest.mark.parametrize("fetch", list(FUSED_KW))
@pytest.mark.parametrize("name", WORKLOADS)
def test_fused_graph_equals_split(dev, name, fetch):
    """solve_dtt_fused on the card: one CUDA graph, captured after a
    warm-up under sync debug mode "error"; its output bit for bit
    prepare + solve_dtt's, in both forms; a replay on new inputs bit for
    bit the split path on them; the first call's result untouched by the
    second."""
    dtt.clear_fused_cache()
    kernel, srcs, targs = _fused_problem(dev, name)
    cfg = SolverConfig(**FUSED_KW[fetch])
    out, info = dtt.solve_dtt_fused(kernel, cfg, srcs, targs)
    graph = dtt.fused_graph(kernel, cfg, srcs, targs)
    assert isinstance(graph.graph, torch.cuda.CUDAGraph)
    assert len(dtt._FUSED) == 1
    plan = treecode.prepare(kernel, cfg, srcs, targs)
    ref, rinfo = dtt.solve_dtt(kernel, cfg, plan)
    assert torch.equal(out, ref)
    assert int(info.overflow) == int(rinfo.overflow) == 0
    first = out.clone()
    _, srcs2, targs2 = _fused_problem(dev, name, seed=62)
    out2, _ = dtt.solve_dtt_fused(kernel, cfg, srcs2, targs2)
    ref2, _ = dtt.solve_dtt(kernel, cfg, treecode.prepare(kernel, cfg,
                                                          srcs2, targs2))
    assert len(dtt._FUSED) == 1
    assert torch.equal(out2, ref2)
    assert torch.equal(out, first)
    (tree, inv), _ = dtt.solve_dtt_fused(kernel, cfg, srcs, targs,
                                         unscramble=False)
    rtree, _ = dtt.solve_dtt(kernel, cfg, plan, unscramble=False)
    assert torch.equal(tree, rtree) and torch.equal(inv, plan.tgt_inv)
    dtt.clear_fused_cache()


@pytest.mark.parametrize("fetch", list(FUSED_KW))
def test_fused_graph_raises_after_replay(dev, monkeypatch, fetch):
    """A list corrupted inside the captured route (a target key out of
    range) launches no work and raises the eager text after each
    replay."""
    from onbody_tpu_torch.traverse import exec as pexec, lists
    dtt.clear_fused_cache()
    kernel, srcs, targs = _fused_problem(dev, n=2000)
    cfg = SolverConfig(**FUSED_KW[fetch])

    def corrupted(pl, cap, group, slot_width):
        pg = lists.group_pairs(pl, cap, group, slot_width)
        return pg._replace(tgt=pg.tgt + 100000 * (pg.tgt != 0))
    monkeypatch.setattr(pexec, "group_pairs", corrupted)
    for _ in range(2):
        with pytest.raises(ValueError, match="out of range"):
            dtt.solve_dtt_fused(kernel, cfg, srcs, targs)
    dtt.clear_fused_cache()


# the chunked solve's executors by pair_fetch: the unpaired kernel, the
# paired one
CHUNKED_KINDS = {"pregather": ("exec_pre_seg", "exec_pre_t2_seg"),
                 "dma_i": ("exec", "exec_t2")}


@pytest.mark.parametrize("n_chunks", [2, 4])
@pytest.mark.parametrize("fetch", list(CHUNKED_KINDS))
def test_chunked_on_card_matches_cpu(dev, fetch, n_chunks, monkeypatch):
    """solve_dtt_chunked on the card (K8 + K9 for pregather, K1 + K2 for
    dma_i, the paired kernel on views one row into each slab) against
    the same solve on the CPU's twins, N = 8192, block 128: rel-RMS
    1e-5, n_valid and overflow equal; each paired launch left the view's
    rows 0/1 (slab rows 1-2) as they were; no other executor launched."""
    kernel = KER
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 64, 8192)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = SolverConfig(block_size=128, order=3, frontier_width=192,
                       list_width=512, cap_groups_dtt=32, pair_group=8,
                       pair_fetch=fetch, dtt_leaf_pair2=True)
    cpu_out, cpu_info = chunked.solve_dtt_chunked(kernel, cfg, srcs, targs,
                                                  n_chunks=n_chunks)
    spy = PairedSpy(cuda_pairs.exec_pairs_t2)
    monkeypatch.setattr(cuda_pairs, "exec_pairs_t2", spy)
    cuda_pairs.LAUNCHES.clear()
    out, info = chunked.solve_dtt_chunked(
        kernel, cfg.replace(pair_backend="cuda"), _to(srcs, dev),
        _to(targs, dev), n_chunks=n_chunks)
    torch.cuda.synchronize()
    inst = cuda_lib.instance("grav3d", "rm")
    kinds = CHUNKED_KINDS[fetch]
    assert all(cuda_pairs.LAUNCHES[(k, inst)] > 0 for k in kinds)
    assert {k for (k, _), v in cuda_pairs.LAUNCHES.items() if v} <= \
        set(kinds) | {"exec_pre_reduce"}
    assert spy.calls == [(1, True)] * n_chunks
    assert int(info.overflow) == int(cpu_info.overflow) == 0
    assert int(info.n_valid) == int(cpu_info.n_valid)
    assert rel_rms(out.cpu(), cpu_out) <= 1e-5


# ------------------------------------------------ the capacity tiers

TIER_KW = dict(block_size=128, order=4, theta_dtt=1.3, frontier_width=192,
               list_width=512, cap_groups_dtt=64, pair_fetch="pregather")


_STRATIFIED_GEN = bigN.make_stratified_gen


def _cpu_strata(seed, n, split, sd, sources, device="cpu"):
    """make_stratified_gen's signature, its strata drawn on the CPU and
    moved to `device`, so the card and the CPU see the same bits."""
    gen = _STRATIFIED_GEN(seed, n, split, sd, sources, "cpu")
    return lambda t: _to(gen(t), device)


def test_stratified_on_card_matches_cpu(dev, monkeypatch):
    """solve_dtt_stratified on the card (K8 + reduction on each slab, K4
    for the validation) against the CPU's twins on the same strata,
    N = 24000 at split 2 with slab_cache 1 (rebuilds forced): the
    subsample's outputs within 1e-5 rel-RMS, n_valid, overflow, hits and
    misses equal, val_rel_rms < 3e-4."""
    monkeypatch.setattr(bigN, "make_stratified_gen", _cpu_strata)
    cfg = SolverConfig(**TIER_KW)
    run = dict(split=2, slab_cache=1, n_val=256, profile=False)
    cpu_dbg, dbg = {}, {}
    cpu_stats, cpu_info = bigN.solve_dtt_stratified(
        KER, cfg, 24000, 3, debug_out=cpu_dbg, device="cpu", **run)
    cuda_pairs.LAUNCHES.clear()
    cuda_direct.LAUNCHES.clear()
    stats, info = bigN.solve_dtt_stratified(
        KER, cfg.replace(pair_backend="cuda"), 24000, 3, debug_out=dbg,
        device=dev, **run)
    inst = cuda_lib.instance("grav3d", "rm")
    assert cuda_pairs.LAUNCHES[("exec_pre_seg", inst)] > 0
    assert cuda_direct.LAUNCHES[("direct", inst)] >= 4
    assert info == cpu_info and info["overflow"] == 0
    for k in ("cache_hits", "cache_misses", "got_nan", "ref_nan",
              "out_nan"):
        assert stats[k] == cpu_stats[k], k
    assert stats["cache_misses"] >= 3
    assert rel_rms(dbg["val_got"], cpu_dbg["val_got"]) <= 1e-5
    assert stats["val_rel_rms"] < 3e-4
    assert stats["peak_alloc_gb"] > 0


def test_stratified_generator_regenerates_on_card(dev):
    """make_stratified_gen on the card: one stratum drawn twice is the
    same bits (a slab rebuild and the validation regenerate strata)."""
    gen = bigN.make_stratified_gen(12345, 1 << 20, 4, 1, True, dev)
    a, b = gen(9), gen(9)
    assert a.x.is_cuda and torch.equal(a.x, b.x) and torch.equal(a.s, b.s)
    assert not torch.equal(a.x, gen(10).x)


def test_outofcore_on_card_matches_cpu(dev):
    """solve_dtt_outofcore on the card against the CPU's twins on the same
    chunks (drawn on the CPU), N = 30000 at split 2, 4 chunks: gidx,
    n_valid and overflow equal, the leaf outputs within 1e-5 rel-RMS on
    the real slots, K8 launched."""
    n, m_chunk = 30_000, 1 << 13

    def gens(device):
        def side(sources):
            def gen(c):
                g = torch.Generator().manual_seed(2 * c + int(sources))
                m = min(m_chunk, n - c * m_chunk)
                p = P.random_in_cube(g, m, 3, 1 if sources else 0, sources)
                return _to(p, device)
            return gen
        return side(True), side(False)
    cfg = SolverConfig(**TIER_KW)
    cpu_res, cpu_info = outofcore.solve_dtt_outofcore(
        KER, cfg, n, *gens("cpu"), m_chunk=m_chunk, split=2, device="cpu")
    cuda_pairs.LAUNCHES.clear()
    res, info = outofcore.solve_dtt_outofcore(
        KER, cfg.replace(pair_backend="cuda"), n, *gens(dev),
        m_chunk=m_chunk, split=2, device=dev)
    inst = cuda_lib.instance("grav3d", "rm")
    assert cuda_pairs.LAUNCHES[("exec_pre_seg", inst)] > 0
    assert (info["n_valid"], info["overflow"]) == (cpu_info["n_valid"],
                                                   cpu_info["overflow"])
    assert info["overflow"] == 0
    assert (res["gidx"] == cpu_res["gidx"]).all()
    real = res["gidx"] < n
    assert rel_rms(res["out"][real], cpu_res["out"][real]) <= 1e-5


# ------------------------------------------------ the accuracy tier (fp64)

# K1-f64 and K4-f64 against their float64 twins: max error / max |twin|
F64_MAX_REL = 1e-12


def _f64_rel(got, ref):
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


# (block width, target keys) of K1-f64's cases: B 128; a run of 12 steps
# that wraps its 2-stage ring again and again; the ragged B 577 (289
# threads of two points, three CTAs of 128, the last thread one point)
K1_F64_CASES = {"b128": (B, [1, 1, 2, 3, 3, 0, 5, 0]),
                "wrap": (B, [2] + [6] * 12 + [0, 9]),
                "b577": (577, [3, 0, 5, 5, 9, 0])}


@pytest.mark.parametrize("case", list(K1_F64_CASES))
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k1_f64_matches_twin(dev, name, core, case):
    """K1-f64 on double rows (K1_F64_CASES) against its float64 twin on
    the CPU within F64_MAX_REL; two calls bit for bit; fp32 rows promoted
    by the wrapper give the same bits; every fetch of the front door runs
    it on double rows; at static capacity (the fused solve's launch) the
    trimmed launch's bits."""
    kernel = get_kernel(name)
    b, keys = K1_F64_CASES[case]
    src32, geo32 = _blocks(dev, kernel, b=b)
    src_fm, tgt_geo = src32.double(), geo32.double()
    gt, gs = _groups(dev, keys)
    inst = cuda_lib.instance(name, core)
    before = cuda_pairs.LAUNCHES[("exec64", inst)]
    got = cuda_pairs.exec_pairs64_cuda(kernel, tgt_geo, src_fm, gt, gs,
                                       final=False, core=core)
    again = cuda_pairs.exec_pairs64_cuda(kernel, tgt_geo, src_fm, gt, gs,
                                         final=False, core=core)
    promoted = cuda_pairs.exec_pairs64_cuda(kernel, geo32, src32, gt, gs,
                                            final=False, core=core)
    fetched = [cuda_pairs.exec_pairs(kernel, tgt_geo, src_fm, gt, gs, core,
                                     fetch=f, final=False)
               for f in ("pregather", "dma", "static")]
    torch.cuda.synchronize()
    assert cuda_pairs.LAUNCHES[("exec64", inst)] == before + 6
    twin = cuda_pairs.exec_pairs_torch(kernel, tgt_geo.cpu(), src_fm.cpu(),
                                       gt.cpu(), gs.cpu(), final=False,
                                       core=core)
    assert got.dtype == torch.float64
    assert _f64_rel(got, twin) <= F64_MAX_REL
    assert all(torch.equal(o, got) for o in [again, promoted] + fetched)
    keys = torch.cat([gt[gt != 0], gt.new_zeros(24)])
    steps = torch.cat([gs[gt != 0], gs.new_zeros((24, gs.shape[1]))])
    checks = cuda_pairs.RunChecks()
    capped = cuda_pairs.exec_pairs_capped(kernel, tgt_geo, src_fm, keys,
                                          steps, checks, core, "dma_i")
    assert checks.word(dev).tolist() == [0]
    assert torch.equal(capped, got)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k4_f64_matches_twin_and_oracle(dev, name, core, splits):
    """K4-f64 (direct at accum_dtype float64) at one split and at 2, 3 and
    7 plus the reduction (1500 targets, whole tiles and a partial one;
    9000 sources, 36 chunks, so 7 splits of five or six): the
    float64 twin within F64_MAX_REL, the fp64 oracle, two calls bit
    identical, its launches."""
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 7, 9000, 1500)
    args = [torch.from_numpy(a) for a in (tx, tr, sx, sr, ss)]
    if not kernel.uses_tr:
        args[1] = torch.zeros_like(args[1])
    cargs = [a.to(dev) for a in args]
    inst = cuda_lib.instance(name, core)
    kinds = ("direct64", "direct64_reduce")
    before = {k: cuda_direct.LAUNCHES[(k, inst)] for k in kinds}
    f64 = torch.float64
    got = cuda_direct.direct_cuda(kernel, *cargs, core, splits=splits,
                                  accum_dtype=f64)
    again = cuda_direct.direct_cuda(kernel, *cargs, core, splits=splits,
                                    accum_dtype=f64)
    torch.cuda.synchronize()
    assert {k: cuda_direct.LAUNCHES[(k, inst)] - before[k]
            for k in kinds} == {"direct64": 2,
                                "direct64_reduce": 2 * (splits > 1)}
    assert got.dtype == f64 and torch.equal(got, again)
    twin = cuda_direct.direct_torch(kernel, *args, core, accum_dtype=f64)
    assert _f64_rel(got, twin) <= F64_MAX_REL
    orc = direct.direct_oracle(kernel, torch_parts(sx, sr, ss),
                               torch_parts(tx, tr), core=core)
    assert _f64_rel(got, orc) <= F64_MAX_REL


# (M, S, splits) of K4-f64 beside the test above: one chunk of 200
# sources (fewer than the ring's 2 stages) against 257 targets (a
# 256-target tile and one); three chunks in 3 splits of one; 513 targets
# (a tile and one) against 5000 sources in 2 splits
K4_F64_EDGES = [(257, 200, 1), (300, 600, 3), (513, 5000, 2)]


@pytest.mark.parametrize("m,s,splits", K4_F64_EDGES,
                         ids=[f"{m}x{s}-{k}" for m, s, k in K4_F64_EDGES])
@pytest.mark.parametrize("name,core", INSTANCES, ids=IDS)
def test_k4_f64_edges_match_twin(dev, name, core, m, s, splits):
    """K4-f64 at K4_F64_EDGES: the float64 twin within F64_MAX_REL."""
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 8, s, m)
    args = [torch.from_numpy(a).double() for a in (tx, tr, sx, sr, ss)]
    if not kernel.uses_tr:
        args[1] = torch.zeros_like(args[1])
    got = cuda_direct.direct_cuda(kernel, *(a.to(dev) for a in args), core,
                                  splits=splits,
                                  accum_dtype=torch.float64)
    twin = cuda_direct.direct_torch(kernel, *args, core)
    assert _f64_rel(got, twin) <= F64_MAX_REL


# the split reduction's shapes on the card, (workload, M): the host
# test's (test_torch_csrc_host.py REDUCE_SHAPES); the staged pass on
# grav3d's 10000 x 3 (doubles: tiles of 64, 128 splits a pass, so 132
# splits take two) and 20000 x 3 (floats: tiles of 128, the same); the
# streaming pass on 200000 x 3 and on the 1e6 checks' 5e5 targets of
# vort2d (1e6 values)
REDUCE_SHAPES = (("grav3d", 777), ("vortgrad3d", 41), ("grav3d", 10000),
                 ("grav3d", 20000), ("grav3d", 50000), ("grav3d", 200000),
                 ("vort2d", 500000))


@pytest.mark.parametrize("splits", [1, 2, 5, 9, 132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float", "double"])
def test_split_reduce_matches_twin_on_card(dev, dtype, splits):
    """K4's and K4-f64's ordered split reduction (reduce_splits_cuda) on
    the card at REDUCE_SHAPES: bit for bit reduce_splits_torch, one
    launch each."""
    g = torch.Generator(device=dev).manual_seed(splits)
    for name, m in REDUCE_SHAPES:
        kernel = get_kernel(name)
        partials = torch.randn((splits, m, kernel.od), generator=g,
                               dtype=dtype, device=dev)
        out = torch.full((m, kernel.od), float("nan"), dtype=dtype,
                         device=dev)
        kind = ("direct64_reduce" if dtype == torch.float64
                else "direct_reduce")
        before = cuda_direct.LAUNCHES[(kind, cuda_lib.instance(name, "rm"))]
        cuda_direct.reduce_splits_cuda(kernel, "rm", out, partials)
        torch.cuda.synchronize()
        assert cuda_direct.LAUNCHES[(kind, cuda_lib.instance(
            name, "rm"))] == before + 1
        assert torch.equal(out, cuda_direct.reduce_splits_torch(partials))


@pytest.mark.parametrize("name", WORKLOADS)
def test_f64_slice_on_card_matches_cpu(dev, name):
    """prepare + solve_dtt at accum_dtype float64 with split equivalent
    rows (order 5 at block 32: two rows a grid) through K1-f64 on the
    card (and nothing else of the executors) vs the twins on the CPU:
    the fp32 proxies may differ in their last bits between the two, so
    1e-6; overflow 0 and the same pair count."""
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 60, 3000)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = SolverConfig(**SLICE_KW).replace(order=5,
                                           accum_dtype=torch.float64)
    cpu_out, cpu_info = dtt.solve_dtt(
        kernel, cfg, treecode.prepare(kernel, cfg, srcs, targs))
    before = dict(cuda_pairs.LAUNCHES)
    gcfg = cfg.replace(pair_backend="cuda")
    out, info = dtt.solve_dtt(
        kernel, gcfg, treecode.prepare(kernel, gcfg, _to(srcs, dev),
                                       _to(targs, dev)))
    torch.cuda.synchronize()
    ran = {k for k, v in cuda_pairs.LAUNCHES.items() if v > before.get(k, 0)}
    assert ran == {("exec64", cuda_lib.instance(name, cfg.core_func))}
    assert out.dtype == torch.float64
    assert int(info.overflow) == int(cpu_info.overflow) == 0
    assert int(info.n_valid) == int(cpu_info.n_valid)
    assert rel_rms(out.cpu(), cpu_out) <= 1e-6


def test_fused_graph_f64_equals_split(dev):
    """solve_dtt_fused at accum_dtype float64 with split rows: K1-f64 at
    the list's static capacity inside the captured graph, bit for bit
    prepare + solve_dtt."""
    dtt.clear_fused_cache()
    kernel, srcs, targs = _fused_problem(dev)
    cfg = SolverConfig(**SLICE_KW).replace(order=5,
                                           accum_dtype=torch.float64)
    out, info = dtt.solve_dtt_fused(kernel, cfg, srcs, targs)
    ref, rinfo = dtt.solve_dtt(kernel, cfg, treecode.prepare(
        kernel, cfg, srcs, targs))
    assert torch.equal(out, ref)
    assert int(info.overflow) == int(rinfo.overflow) == 0
    dtt.clear_fused_cache()


# ------------------------------------- multi-device (NCCL) and the C ABI

@pytest.fixture
def nccl1(dev, tmp_path):
    """A one-rank NCCL process group in this process (the card's machine
    has one GPU; NCCL refuses two ranks on it)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("method", ["dtt", "stream", "treecode3", "prepare"])
def test_sharded_on_card_matches_cpu(dev, nccl1, method):
    """The sharded solves over NCCL at world size 1 on the card
    (scripts/multichip.solve_cases on the card's mesh; "prepare" is
    prepare_and_solve_sharded) against the port's monolithic solve on the
    CPU's twins on the same inputs (on the CPU the sharded solves at
    world size 1 equal it bit for bit, tests/test_torch_mesh.py): within
    1e-5 rel-RMS, overflow 0, kernels launched."""
    from onbody_tpu_torch.scripts import multichip
    from onbody_tpu_torch.traverse import dtt, treecode
    kernel = KER
    n = 8192
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 3, n)
    cfg = SolverConfig(block_size=128, order=4, theta_dtt=1.3,
                       frontier_width=192, list_width=512,
                       cap_groups_dtt=64, pair_fetch="pregather",
                       tree_mode="median")
    case = dict(method=method, kernel="grav3d", cfg=cfg,
                inputs=(sx, sr, ss, tx, tr))
    cuda_pairs.LAUNCHES.clear()
    out, ov, _ = multichip.solve_cases([case])[0]
    assert ov == 0 and sum(cuda_pairs.LAUNCHES.values()) > 0
    plan = treecode.prepare(kernel, cfg, torch_parts(sx, sr, ss),
                            torch_parts(tx, tr))
    solve = treecode.solve_treecode3 if method == "treecode3" else \
        dtt.solve_dtt
    ref = solve(kernel, cfg, plan)[0].numpy()
    assert rel_rms(out, ref) <= 1e-5


@pytest.mark.parametrize("method", ["dtt", "stream", "treecode3"])
def test_sharded_f64_on_card_matches_cpu(dev, nccl1, method):
    """The accuracy tier through the sharded solves over NCCL at world
    size 1 (accum_dtype float64: K1-f64 for every fetch): within 1e-12
    rel-RMS of the port's fp64 monolithic solve on the same plan on the
    card (bit for bit on the CPU, tests/test_torch_mesh.py), and within
    1e-6 of the monolithic solve on the CPU's twins on the same inputs
    (the fp32 proxies differ in their last bits between the two, as in
    test_f64_slice_on_card_matches_cpu); float64 out, overflow 0,
    K1-f64 launched."""
    from onbody_tpu_torch.parallel import mesh as pmesh
    from onbody_tpu_torch.traverse import dtt, treecode
    kernel = KER
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 3, 8192)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = SolverConfig(block_size=128, order=4, theta_dtt=1.3,
                       frontier_width=192, list_width=512,
                       cap_groups_dtt=64, pair_fetch="pregather",
                       tree_mode="median", accum_dtype=torch.float64)
    sharded = {"dtt": pmesh.solve_dtt_sharded,
               "stream": pmesh.solve_dtt_sharded_stream,
               "treecode3": pmesh.solve_treecode3_sharded}[method]
    solve = treecode.solve_treecode3 if method == "treecode3" else \
        dtt.solve_dtt
    plan = treecode.prepare(kernel, cfg, _to(srcs, dev), _to(targs, dev))
    cuda_pairs.LAUNCHES.clear()
    out, info = sharded(kernel, cfg, pmesh.make_mesh(), plan)
    torch.cuda.synchronize()
    assert sum(v for (k, _), v in cuda_pairs.LAUNCHES.items()
               if k == "exec64") > 0, cuda_pairs.LAUNCHES
    assert int(info.overflow) == 0 and out.dtype == torch.float64
    mono = solve(kernel, cfg, plan)[0]
    assert rel_rms(out.cpu(), mono.cpu()) <= 1e-12
    cpu = solve(kernel, cfg, treecode.prepare(kernel, cfg, srcs, targs))[0]
    assert rel_rms(out.cpu(), cpu) <= 1e-6


def test_cabi_on_card_matches_cpu(dev, tmp_path):
    """The C ABI shim (scripts/cabi_driver.py in a fresh interpreter) on
    the card (ONBODY_CABI_DEVICE unset) against the same calls on the
    CPU: every symbol within 1e-5 rel-RMS, the solvers within the API's
    limits of the direct symbols, K8 and K4 launched on the card."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]

    def drive(out, device):
        env = dict(os.environ, ONBODY_TPU_TORCH_ROOT=str(root))
        env.pop("ONBODY_CABI_DEVICE", None)
        if device:
            env["ONBODY_CABI_DEVICE"] = device
        out.mkdir()
        res = subprocess.run(
            [sys.executable, "-m", "onbody_tpu_torch.scripts.cabi_driver",
             str(out), "--n", "6000", "--n3", "4000", "--reps", "1"],
            capture_output=True, text=True, env=env, cwd=root, timeout=600)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("CABI ")]
        assert res.returncode == 0 and len(line) == 1, res.stderr[-3000:]
        calls = json.loads(line[0][5:])["calls"]
        return calls, {s: np.load(out / f"{s}.npy") for s in calls}

    calls, card = drive(tmp_path / "card", None)
    _, cpu = drive(tmp_path / "cpu", "cpu")
    for sym, c in calls.items():
        assert rel_rms(card[sym], cpu[sym]) <= 1e-5, sym
        want = "exec_pre_seg" if "solver" in sym else "direct"
        assert c["launches"].get(want, 0) > 0, (sym, c["launches"])
    for kind, pd in (("f", 2), ("tr_f", 2), ("3dvg_f", 3)):
        a = card[f"external_vel_solver_{kind}_"]
        b = card[f"external_vel_direct_{kind}_"]
        assert rel_rms(a[:, :pd], b[:, :pd]) < 1e-3
        if pd == 3:
            assert rel_rms(a[:, 3:], b[:, 3:]) < 2e-2
