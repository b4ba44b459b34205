"""K4's split of the sources over CTAs (ops/cuda_direct.py): the split
planner, and the plain twin of the split path (per-split partials, then
an ordered sum) against direct_torch and against the reference's Pallas
direct kernel in interpret mode, on the same numpy inputs."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import kernel_inputs, rel_rms, torch_parts
from onbody_tpu.ops import kernels as JK
from onbody_tpu.ops import pallas_direct
from onbody_tpu_torch.ops import cuda_direct, cuda_lib
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import direct as tdirect

torch.set_num_threads(1)

CHUNK = cuda_direct.CHUNK_S
# (M, S, resident CTAs per SM) on 132 SMs: the three shapes K4 is
# measured at (chip_smoke.py: (a) the kernel table's, (b) the 1e6 rows'
# check, (c) the 1e7 row's), a tile count just short of two waves, one
# chunk, fewer chunks than the waves want, and an empty source set
PLAN_CASES = [(8224, 10 ** 6, 4), (500_000, 10 ** 6, 4),
              (500_000, 10 ** 6, 3), (40_000, 10 ** 7, 2),
              (40_000, 10 ** 7, 4), (1000, 10 ** 6, 1), (301, 2500, 4),
              (300, 512, 4), (777, 1537, 8), (5, 0, 4)]


def _cover(s, splits):
    """K4's split bounds: consecutive, covering [0, S) once, each split a
    whole number of chunks (the last may end in a short chunk at S),
    their chunk counts differing by one at most."""
    bounds = cuda_direct.split_bounds(s, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2 and lo % CHUNK == 0
    sizes = [-(-(hi - lo) // CHUNK) for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1
    return bounds


@pytest.mark.parametrize("m,s,ctas", PLAN_CASES,
                         ids=[f"{m}x{s}-c{c}" for m, s, c in PLAN_CASES])
def test_plan_covers_sources_in_whole_chunks(m, s, ctas):
    sms, od = 132, 3
    splits = cuda_direct.plan_splits(m, s, od, ctas, sms)
    bounds = _cover(s, splits)
    assert all(hi > lo for lo, hi in bounds) or s == 0
    tiles = -(-m // cuda_direct.TILE_T)
    waves = cuda_direct.SPLIT_WAVES * sms * ctas
    chunks = -(-s // CHUNK)
    if tiles >= waves or chunks <= 1:
        assert splits == 1
    else:
        # the smallest count that fills the waves, unless the sources run
        # out of chunks first
        assert tiles * splits >= waves or splits == chunks
        assert tiles * (splits - 1) < waves
    assert splits * m * od * 4 <= max(cuda_direct.SCRATCH_BYTES,
                                      m * od * 4)


def test_plan_one_split_when_tiles_fill_two_waves():
    # 1056 tiles of 512 targets = two waves of 4 CTAs on 132 SMs
    m = 2 * 132 * 4 * cuda_direct.TILE_T
    assert cuda_direct.plan_splits(m, 10 ** 6, 3, 4, 132) == 1
    assert cuda_direct.plan_splits(m - cuda_direct.TILE_T, 10 ** 6, 3, 4,
                                   132) == 2


@pytest.mark.parametrize("scratch", [1 << 20, 6 << 20, 64 << 20])
def test_plan_scratch_stays_under_its_cap(scratch):
    """A few targets against many sources want many splits; the partial
    slabs (splits x M x OD floats) stay within the scratch."""
    m, s, od = 2000, 10 ** 7, 12
    splits = cuda_direct.plan_splits(m, s, od, 4, 132,
                                     scratch_bytes=scratch)
    _cover(s, splits)
    assert 1 < splits * m * od * 4 <= scratch
    assert (splits + 1) * m * od * 4 > scratch or splits == 264


@pytest.mark.parametrize("s,splits", [(2500, 1), (2500, 3), (2561, 3),
                                      (8 * 512, 7), (100, 1),
                                      (9 * 512 + 1, 7)])
def test_split_bounds(s, splits):
    _cover(s, splits)


def test_constants_follow_direct_cuh():
    """The planner's tile and chunk are direct.cuh's."""
    text = (cuda_lib.CSRC / "direct.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (kDirect\w+) = (\d+);", text)}
    assert cuda_direct.TILE_T == const["kDirectThreads"] * const[
        "kDirectTgts"]
    assert cuda_direct.CHUNK_S == const["kDirectChunk"]


def test_constants_follow_fp64_cuh():
    """K4-f64's chunk is fp64.cuh's; its tile comes from the library
    (test_torch_csrc_host.py checks that entry); K4's geometry is its
    constants."""
    text = (cuda_lib.CSRC / "fp64.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (kDirect64\w+) = (\d+);", text)}
    assert cuda_direct.CHUNK_S64 == const["kDirect64Chunk"]
    assert cuda_direct.geometry("direct", "grav3d") == (
        cuda_direct.TILE_T, cuda_direct.CHUNK_S)


# (workload, core) of every compiled instantiation
INSTANCES = list(cuda_lib.INSTANCE_CORES)


@pytest.mark.parametrize("name,core", INSTANCES,
                         ids=[f"{k}-{c}" for k, c in INSTANCES])
def test_split_twin_matches_twin_and_pallas(name, core):
    """The split path's twin at ragged M and S (300 targets: a partial
    Pallas tile of 256 and a partial K4 tile of 512; 1100 sources: two
    chunks of 512 and a short one, in 2 and 3 splits) against
    direct_torch (rel-RMS 1e-6), the fp64 oracle (2e-6, as
    test_torch_vortex.py's direct) and the reference's direct_pallas in
    interpret mode (rel-RMS 2e-5, the reference's own bound), and the
    wrapper taking the twin for CPU tensors at a forced split count."""
    kernel = get_kernel(name)
    sx, sr, ss, tx, tr = kernel_inputs(kernel, 7, 1100, 300)
    if not kernel.uses_tr:
        tr = np.zeros_like(tr)
    args = [torch.from_numpy(a) for a in (tx, tr, sx, sr, ss)]
    twin = cuda_direct.direct_torch(kernel, *args, core)
    ref = np.asarray(pallas_direct.direct_pallas(
        JK.KERNELS[name], *(jnp.asarray(a) for a in (tx, tr, sx, sr, ss)),
        core=core, interpret=True))
    assert ref.shape == tuple(twin.shape) == (300, kernel.od)
    orc = tdirect.direct_oracle(kernel, *(torch_parts(*a) for a in (
        (sx, sr, ss), (tx, tr))), core).numpy()
    for splits in (2, 3):
        got = cuda_direct.direct_split_torch(kernel, *args, core,
                                             splits).numpy()
        assert np.isfinite(got).all()
        assert rel_rms(got, twin.numpy()) < 1e-6
        assert rel_rms(got, orc) < 2e-6
        assert rel_rms(got[:, :3], ref[:, :3]) < 2e-5
        if kernel.od > 3:
            # vortgrad3d's gradients: the reference contracts factored
            # moments that cancel across sources, so its fp32 gradient
            # tiles sit ~2e-5 or more from the fp64 sum
            # (tests/test_torch_vortex.py; about 8e-5 here). The tight
            # check of these columns is the oracle's above (2e-6); this
            # one holds the port to the reference within the reference's
            # own error, and that error to a fixed cap
            ref_err = rel_rms(ref[:, 3:], orc[:, 3:])
            assert ref_err < 1e-4
            assert rel_rms(got[:, 3:], ref[:, 3:]) <= ref_err + 2e-6
    assert torch.equal(cuda_direct.direct_cuda(kernel, *args, core,
                                               splits=3), twin)


def test_reduce_twin_sums_in_split_order():
    g = torch.Generator().manual_seed(0)
    parts = torch.randn((5, 7, 3), generator=g) * torch.tensor(
        [1e8, 1.0, -1e8, 1e-3, 3.0])[:, None, None]
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    assert torch.equal(cuda_direct.reduce_splits_torch(parts), want)
    assert torch.equal(cuda_direct.reduce_splits_torch(parts[:1]), parts[0])
