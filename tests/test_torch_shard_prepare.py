"""The fully sharded prepare + solve (onbody_tpu_torch/parallel/
shard_prepare.py) over gloo on the CPU.

One start of 6 ranks (parallel/launch.py, scripts/multichip.solve_cases)
runs the 2- and 4-rank cases side by side on subgroups; it starts with
the file's first test and runs while this process computes the
references. World size 1 runs in this process.

  * The distributed top split at 2 and 4 ranks plans the planes, axes,
    tie quotas and per-particle owners that hsplit.run_top_split plans on
    the concatenated input (each rank's shard a chunk; the first split
    axis drawn from 300 values, so planes tie), integer for integer; the 4-rank
    case also against the JAX package's run_top_split.
  * The exchange: every rank's slab holds exactly its owner's points, in
    input order, ids carried as int64 beyond 2^24 (the reference carries
    them as float32); a forced small cap_b reports the rows it dropped.
  * prepare_and_solve_sharded at 1, 2 and 4 ranks, a few thousand
    points: < 3e-4 rel-RMS against the fp64 direct sum, overflow 0, the
    same output on every rank; at 4 ranks the last subtree holds only
    padding; at 2 ranks with pair_fetch "dma_i" (rows padded to 8).
  * The reference's zeroed top-slab row (rsqrt(0) * 0 for a target at
    the origin): a target placed at the origin gives a finite output.
  * scripts/multichip.py's dry run at 2 gloo ranks through its CLI; its
    default, NCCL, raises without the cards.

The JAX package's prepare_and_solve_sharded is not called (its own test
takes minutes on the CPU); its stages are held through hsplit and the
fp64 direct sum.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import make_inputs, rel_rms, torch_parts
from onbody_tpu.tree import hsplit as jhsplit
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.parallel import launch, shard_prepare
from onbody_tpu_torch.parallel import mesh as pmesh
from onbody_tpu_torch.scripts import multichip
from onbody_tpu_torch.traverse import direct
from onbody_tpu_torch.tree import build, hsplit

torch.set_num_threads(1)

# the reference dry run's configuration (__graft_entry__.py:119-121)
CFG = SolverConfig(block_size=128, order=4, theta_dtt=1.3,
                   frontier_width=192, list_width=512, cap_groups_dtt=64,
                   pair_fetch="pregather")
D2, D4 = (0, 1), (2, 3, 4, 5)
N_SPLIT = 4000
ID_BASE = 1 << 40


@functools.cache
def _split_inputs():
    """Sources with ties on axis 0 (every level's first split axis), and
    ids past 2^24."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (N_SPLIT, 3)).astype(np.float32)
    x[:, 0] = rng.integers(0, 300, N_SPLIT) / 149.5 - 1.0   # span 2
    r = np.full(N_SPLIT, 0.05, np.float32)
    s = (rng.uniform(-1, 1, (N_SPLIT, 1)) / N_SPLIT).astype(np.float32)
    oid = np.arange(N_SPLIT, dtype=np.int64) + ID_BASE
    return x, r, s, oid


@functools.cache
def _prepare_inputs(n: int, origin: bool = False):
    sx, sr, ss, tx, tr = make_inputs(5, n)
    if origin:
        tx = tx.copy()
        tx[n // 3] = 0.0
    return sx, sr, ss, tx, tr


N_PAD = build.plan(N_SPLIT, 128)[1]
CASES = {
    "split-2": dict(method="split", inputs=_split_inputs(), n_pad=N_PAD,
                    cap_b=4096, ranks=D2),
    "split-4": dict(method="split", inputs=_split_inputs(), n_pad=N_PAD,
                    cap_b=4096, ranks=D4),
    "split-4-cap": dict(method="split", inputs=_split_inputs(),
                        n_pad=N_PAD, cap_b=200, ranks=D4),
    "prepare-2": dict(method="prepare", kernel="grav3d", cfg=CFG,
                      inputs=_prepare_inputs(4096, True), ranks=D2),
    "prepare-2-dma_i": dict(method="prepare", kernel="grav3d",
                            cfg=CFG.replace(pair_fetch="dma_i"),
                            inputs=_prepare_inputs(4096), ranks=D2),
    # 4100 points in 8192 slots: subtree 3 holds padding only
    "prepare-4": dict(method="prepare", kernel="grav3d", cfg=CFG,
                      inputs=_prepare_inputs(4100, True), ranks=D4),
}


def _start():
    return launch.start_ranks(multichip.solve_cases, 6,
                              list(CASES.values()), "cpu", backend="gloo")


_started = []


@pytest.fixture(scope="module", autouse=True)
def _rank_start(request):
    """Start the 6 ranks with the file's first test when a case of
    theirs is selected."""
    if any(i.name.startswith(("test_top_split", "test_exchange",
                              "test_prepare_and_solve_sharded["))
           for i in request.session.items):
        _started.append(_start())
    yield


@functools.cache
def _ranks():
    res = (_started.pop() if _started else _start()).join()
    return {k: [r[i] for r in res if r[i] is not None]
            for i, k in enumerate(CASES)}


@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A one-rank gloo process group in this process."""
    init = tmp_path_factory.mktemp("group1") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_prepare_and_solve_sharded_one_rank(group1):
    """World size 1 (split 0: the one subtree is the whole tree), a
    target at the origin; and the refusals."""
    inputs = _prepare_inputs(4096, True)
    case = dict(method="prepare", kernel="grav3d", cfg=CFG, inputs=inputs)
    _check_prepare(inputs, multichip.solve_cases([case], "cpu"))
    m = pmesh.make_mesh(device="cpu")
    sx, sr, ss, tx, tr = inputs
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    kernel = get_kernel("grav3d")
    for cfg, what in ((CFG.replace(order=-1), "barycentric"),
                      (CFG.replace(accum_dtype=torch.float64), "fp32")):
        with pytest.raises(ValueError, match=what):
            shard_prepare.prepare_and_solve_sharded(kernel, cfg, m, srcs,
                                                    targs)
    with pytest.raises(ValueError, match="equal source and target"):
        shard_prepare.prepare_and_solve_sharded(
            kernel, CFG, m, srcs, torch_parts(tx[:4000], tr[:4000]))


def test_dryrun_multichip_cli(capsys):
    """scripts/multichip.py's dry run at 2 gloo ranks, through its CLI:
    the streamed solve within 1e-5 of solve_dtt, the sharded prepare
    within 3e-4 of the direct sum, overflow 0. Its default is NCCL, one
    rank per card, which raises without them (no fall back to gloo)."""
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            multichip.main(["2"])
    assert multichip.main(["2", "--backend", "gloo"]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip(2, gloo): OK" in out
    assert "dryrun_multichip(2, gloo) sharded-prepare: OK" in out


def _run_top_split(ndev: int):
    """The port's hsplit.run_top_split on the concatenated input, the
    ranks' shards as chunks, with the codes the ranks make."""
    x = _split_inputs()[0]
    m = N_SPLIT // ndev
    lo, hi = x.min(axis=0), x.max(axis=0)
    codes = [hsplit.box_codes(torch.from_numpy(x[c * m:(c + 1) * m]),
                                  lo, hi) for c in range(ndev)]
    return codes, lo, hi, hsplit.run_top_split(
        lambda c: codes[c], ndev, m, ndev.bit_length() - 1, lo, hi,
        virtual_pad_slots=N_PAD - N_SPLIT)


@pytest.mark.parametrize("ndev", [2, 4])
def test_top_split_equals_run_top_split(ndev):
    codes, lo, hi, (planes, quotas, axes, nids) = _run_top_split(ndev)
    got = _ranks()[f"split-{ndev}"]
    for d, g in enumerate(got):
        np.testing.assert_array_equal(g["lo"], lo)
        np.testing.assert_array_equal(g["hi"], hi)
        for l in range(ndev.bit_length() - 1):
            np.testing.assert_array_equal(g["planes"][l], planes[l])
            np.testing.assert_array_equal(g["axes"][l], axes[l])
            np.testing.assert_array_equal(g["quotas"][l], quotas[l][d])
        np.testing.assert_array_equal(g["nid"], nids[d].numpy())
    # the ties were real: some level handed out a partial quota
    assert any(0 < q.sum() for lvl in quotas for q in lvl)
    if ndev == 4:
        ref = jhsplit.run_top_split(
            lambda c: jnp.asarray(codes[c].numpy()), ndev, 0, 2, lo, hi,
            virtual_pad_slots=N_PAD - N_SPLIT,
            chunk_sizes=[len(c) for c in codes])
        for l in range(2):
            np.testing.assert_array_equal(planes[l], ref[0][l])
            np.testing.assert_array_equal(axes[l], ref[2][l])
        for d in range(ndev):
            np.testing.assert_array_equal(nids[d].numpy(),
                                          np.asarray(ref[3][d]))


@pytest.mark.parametrize("ndev", [2, 4])
def test_exchange_moves_each_point_to_its_owner(ndev):
    got = _ranks()[f"split-{ndev}"]
    x, _, _, oid = _split_inputs()
    owner = np.concatenate([g["nid"] for g in got])
    assert sum(g["count"] for g in got) == N_SPLIT
    for d, g in enumerate(got):
        want = oid[owner == d]
        assert g["orig"].dtype == np.int64
        np.testing.assert_array_equal(g["orig"], want)
        np.testing.assert_array_equal(g["x"], x[g["orig"] - ID_BASE])
        assert g["count"] == len(want) <= N_PAD // ndev
        assert g["overflow"] == 0


def test_exchange_small_buckets_report_overflow():
    """cap_b 200 < the 1000-point shards' buckets: each rank reports the
    rows it could not send, and each owner receives the first cap_b of
    every sender's bucket."""
    got = _ranks()["split-4-cap"]
    oid = _split_inputs()[3]
    m = N_SPLIT // 4
    cnt = np.stack([np.bincount(g["nid"], minlength=4) for g in got])
    assert [g["overflow"] for g in got] == list(
        np.maximum(cnt - 200, 0).sum(1))
    assert cnt.max() > 200
    for d, g in enumerate(got):
        want = np.concatenate([oid[s * m:(s + 1) * m][got[s]["nid"] == d]
                               [:200] for s in range(4)])
        np.testing.assert_array_equal(g["orig"], want)
        assert g["count"] == len(want)


def _check_prepare(inputs, per_rank):
    out, ov, _ = per_rank[0]
    for o, v, _ in per_rank[1:]:
        np.testing.assert_array_equal(o, out)
        assert v == ov
    assert ov == 0
    assert np.isfinite(out).all()
    sx, sr, ss, tx, tr = inputs
    ref = direct.direct_oracle(get_kernel("grav3d"), torch_parts(sx, sr, ss),
                               torch_parts(tx, tr)).numpy()
    assert rel_rms(out, ref) < 3e-4


@pytest.mark.parametrize("key", ["prepare-2", "prepare-2-dma_i",
                                 "prepare-4"])
def test_prepare_and_solve_sharded(key):
    _check_prepare(CASES[key]["inputs"], _ranks()[key])
