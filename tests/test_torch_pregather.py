"""Port vs reference: the pregather pass and the executors on
pre-gathered sources (ops/cuda_pairs.py: `_pregather`, the plain twins of
kernels K8/K9, the chunked front doors) against the reference's
`_pregather`, `_exec_chunk_pre`, `_exec_chunk_pre_t2` and
`exec_pairs_pallas(fetch="pregather")` with Pallas in interpret mode, for
every workload, with lean rows and rows padded to 8; and the routing of
`pair_fetch` to the executors.

Tolerances (rel-RMS). The port's per-pair fp32 form against the same
twin evaluated in float64: <= 1e-6 (measured 0.9e-7 to 1.9e-7). Port
against the reference: <= 1e-5, and vortgrad3d's gradients <= 5e-5; the
reference's fp32 tile bodies factor the source sum into moments
(grav3d's sum(w s) - t sum(w) is not centered) and sit 0.9e-6 to 6.6e-6
from float64 on these blocks (gradients 4.6e-6), which is all of the
difference: a 2e-6 bound holds for vort2d and vort3d only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_rms
from onbody_tpu.ops import kernels as JK
from onbody_tpu.ops import pallas_pairs as jpp
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops import cuda_pairs as tpp
from onbody_tpu_torch.ops import kernels as TK
from onbody_tpu_torch.traverse import exec as texec
from onbody_tpu_torch.traverse.lists import PairList

torch.set_num_threads(1)

WORKLOADS = ["grav3d", "vort2d", "vort3d", "vortgrad3d"]
LAYOUTS = [False, True]
LAYOUT_IDS = ["lean", "pad8"]
B, NN, G = 32, 12, jpp.GROUP
TOL, TOL_GRAD, TOL_F64 = 1e-5, 5e-5, 1e-6


def _blocks(name, seed, pad8):
    """Random block tables, each block a compact cluster in [-1, 1]^pd
    as a leaf is; the targets are the sources (the d2 = 0 diagonal);
    inert row 0; src_fm lean or padded to 8 rows."""
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


def _groups(seed, gt_list, nn=NN):
    rng = np.random.default_rng(seed)
    gt = np.array(gt_list, np.int32)
    gs = rng.integers(1, nn, (len(gt_list), G)).astype(np.int32)
    gs[:, -2:] = np.where(rng.random((len(gt_list), 2)) < 0.5, 0,
                          gs[:, -2:])      # inert slots in real groups
    gs[gt == 0] = 0
    return gt, gs


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _check(name, got, ref, f64=None):
    """got (NN', od8, B) feature-major rows against the reference's and,
    when given, against the float64 evaluation of the same twin."""
    od = TK.KERNELS[name].od
    got, ref = np.asarray(got)[:, :od], np.asarray(ref)[:, :od]
    assert np.isfinite(got).all()
    assert rel_rms(got[:, :3], ref[:, :3]) <= TOL
    if od > 3:
        assert rel_rms(got[:, 3:], ref[:, 3:]) <= TOL_GRAD
    if f64 is not None:
        assert rel_rms(got, np.asarray(f64)[:, :od]) <= TOL_F64


UNPAIRED = [1, 1, 0, 2, 2, 2, 0, 5, 7, 0, 0]
PAIRED = [1, 1, 2, 0, 3, 5, 5, 0]


@pytest.mark.parametrize("name", WORKLOADS)
def test_pad_fm_rows_matches_reference(name):
    lean, _ = _blocks(name, 1, False)
    ref = np.asarray(JK.pad_fm_rows(name, jnp.asarray(lean)))
    got = TK.pad_fm_rows(name, torch.from_numpy(lean)).numpy()
    np.testing.assert_array_equal(got, ref)
    full, _ = _blocks(name, 1, True)
    np.testing.assert_array_equal(got, full)    # the derived rows


@pytest.mark.parametrize("pad8", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", WORKLOADS)
def test_pregather_matches_reference(name, pad8):
    """The reference's pass (derived rows appended) bit for bit; the
    port's own pass (pad8=False) is the plain gather, into a buffer."""
    src_fm, _ = _blocks(name, 2, pad8)
    _, gs = _groups(3, UNPAIRED)
    ref = np.asarray(jpp._pregather(name, jnp.asarray(src_fm),
                                    jnp.asarray(gs), B))
    fm, ids = _t(src_fm, gs.astype(np.int64))
    got = tpp._pregather(name, fm, ids, B)
    assert got.shape == (len(UNPAIRED), G * 8, B)
    np.testing.assert_array_equal(got.numpy(), ref)
    c = src_fm.shape[1]
    buf = torch.full((len(UNPAIRED) * G + 5, c, B), float("nan"))
    own = tpp._pregather(name, fm, ids, B, pad8=False, out=buf)
    assert own.shape == (len(UNPAIRED), G * c, B)
    assert own.data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(
        own.numpy(), src_fm[gs.reshape(-1)].reshape(len(UNPAIRED), -1, B))


@pytest.mark.parametrize("pad8", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", WORKLOADS)
def test_k8_twin_matches_exec_chunk_pre(name, pad8):
    """exec_pairs_pre_torch on the port's gathered buffer (C lean or 8)
    vs the reference's _exec_chunk_pre on its own (always 8 rows)."""
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    src_fm, tgt_geo = _blocks(name, 4, pad8)
    gt, gs = _groups(5, UNPAIRED)
    od8 = tpp.od8(tk)
    jsrc = jpp._pregather(name, *_j(src_fm, gs), B)
    ref = np.asarray(jpp._exec_chunk_pre(
        jk, jnp.asarray(tgt_geo), jsrc, jnp.asarray(gt),
        jnp.zeros((NN, od8, B), jnp.float32), "rm", jnp.float32, True,
        "outer", G))
    fm, ids = _t(src_fm, gs.astype(np.int64))
    gathered = tpp._pregather(name, fm, ids, B, pad8=False)
    got = tpp.exec_pairs_pre_cuda(tk, torch.from_numpy(tgt_geo), gathered,
                                  torch.from_numpy(gt.astype(np.int64)),
                                  final=False, group=G)
    assert got.shape == (NN, od8, B)
    f64 = tpp.exec_pairs_pre_torch(
        tk, torch.from_numpy(tgt_geo).double(), gathered.double(),
        torch.from_numpy(gt.astype(np.int64)), final=False, group=G)
    _check(name, got[1:], ref[1:], f64[1:])
    untouched = [r for r in range(NN) if r not in UNPAIRED]
    assert not got[untouched].any()


@pytest.mark.parametrize("pad8", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", WORKLOADS)
def test_k9_twin_matches_exec_chunk_pre_t2(name, pad8):
    """exec_pairs_pre_torch_t2 vs _exec_chunk_pre_t2; rows 0/1 (the
    root accumulator) stay as they were in both."""
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    src_fm, tgt_geo = _blocks(name, 6, pad8)
    gt, gs = _groups(7, PAIRED)
    od8 = tpp.od8(tk)
    out0 = np.zeros((NN, od8, B), np.float32)
    out0[1] = 7.25
    jsrc = jpp._pregather(name, *_j(src_fm, gs), B)
    ref = np.asarray(jpp._exec_chunk_pre_t2(
        jk, jnp.asarray(tgt_geo), jsrc, jnp.asarray(gt), jnp.asarray(out0),
        "rm", jnp.float32, True, "outer", G))
    fm, ids = _t(src_fm, gs.astype(np.int64))
    gathered = tpp._pregather(name, fm, ids, B, pad8=False)
    got = tpp.exec_pairs_pre_cuda_t2(
        tk, torch.from_numpy(tgt_geo), gathered,
        torch.from_numpy(gt.astype(np.int64)), torch.from_numpy(out0.copy()),
        group=G).numpy()
    f64 = tpp.exec_pairs_pre_torch_t2(
        tk, torch.from_numpy(tgt_geo).double(), gathered.double(),
        torch.from_numpy(gt.astype(np.int64)),
        torch.from_numpy(out0).double(), group=G)
    _check(name, got[2:], ref[2:], f64[2:])
    assert (got[1] == 7.25).all() and (ref[1] == 7.25).all()
    assert not got[0].any()


@pytest.mark.parametrize("core", ["rm", "exp"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_front_door_matches_pallas_pregather(name, core, monkeypatch):
    """exec_pairs / exec_pairs_t2 with fetch='pregather', the list cut
    into chunks of 4 steps (inside the runs of targets 2 and 5), chained
    through one accumulator, vs the reference's two pregather executors
    in one chunk each. Lean rows, as the lean plan stores them."""
    if name == "grav3d" and core == "exp":
        core = "rm"                             # gravity has no core
    jk, tk = JK.KERNELS[name], TK.KERNELS[name]
    src_fm, tgt_geo = _blocks(name, 8, False)
    gt, gs = _groups(9, UNPAIRED)
    gt2, gs2 = _groups(10, PAIRED)
    jargs = _j(tgt_geo, src_fm)
    ref = jpp.exec_pairs_pallas(jk, *jargs, *_j(gt, gs), core=core,
                                interpret=True, fetch="pregather",
                                final=False)
    ref = np.asarray(jpp.exec_pairs_pallas_t2(
        jk, *jargs, *_j(gt2, gs2), ref, core=core, interpret=True,
        fetch="pregather"))
    monkeypatch.setattr(tpp, "pregather_chunk", lambda g, c, b: 4)
    tg, fm = _t(tgt_geo, src_fm)
    out = tpp.exec_pairs(tk, tg, fm, *_t(gt.astype(np.int64),
                                         gs.astype(np.int64)), core=core,
                         fetch="pregather", final=False)
    got = tpp.exec_pairs_t2(tk, tg, fm, *_t(gt2.astype(np.int64),
                                            gs2.astype(np.int64)), out,
                            core=core, fetch="pregather").numpy()
    _check(name, got[2:], ref[2:])


def test_chunked_run_resumes_and_equals_one_chunk(monkeypatch):
    """A run cut by a chunk boundary resumes from its partial sum: every
    chunk size gives the one-chunk result up to the order of the sums,
    and pad steps between chunks change nothing."""
    tk = TK.KERNELS["vort2d"]
    src_fm, tgt_geo = _blocks("vort2d", 11, False)
    gt, gs = _groups(12, [3, 3, 3, 3, 3, 0, 4, 4, 0, 0, 9])
    args = _t(tgt_geo, src_fm, gt.astype(np.int64), gs.astype(np.int64))
    one = tpp.exec_pairs(tk, *args, fetch="pregather")
    for chunk in (1, 2, 3, 5):
        monkeypatch.setattr(tpp, "pregather_chunk",
                            lambda g, c, b, n=chunk: n)
        got = tpp.exec_pairs(tk, *args, fetch="pregather")
        assert rel_rms(got.numpy(), one.numpy()) <= TOL
        assert torch.equal(got[9], one[9])      # a one-step run


@pytest.mark.parametrize("g,c,b", [(8, 4, 128), (8, 7, 128), (16, 5, 256),
                                   (16, 8, 256), (32, 5, 64)])
def test_pregather_chunk_is_the_references(g, c, b):
    """Gathered buffer <= 256 MiB at C padded to 8, a power of two, at
    least 1024 steps (pallas_pairs.py:894-897)."""
    c8 = -(-c // 8) * 8
    ref = max(1024, (256 << 20) // (g * c8 * b * 4))
    ref = 1 << (ref.bit_length() - 1)
    assert tpp.pregather_chunk(g, c, b) == ref


def test_inert_pad_row_is_safe_through_pregather():
    """The reference's test_inert_pad_row_is_featurized_safe on the
    port: a target block exactly at the origin with zero radii, fed only
    the inert row 0, comes back finite and exactly zero, for the two
    workloads whose bodies divide by d2 + sr2 alone."""
    for name in ("grav3d", "vort2d"):
        tk = TK.KERNELS[name]
        src_fm, _ = _blocks(name, 13, False)
        assert (src_fm[0, :tk.pd] == 0).all() and (src_fm[0, tk.pd] == 1).all()
        geo = tpp.build_tgt_geo(torch.zeros((2, B, tk.pd)),
                                torch.zeros((2, B)))
        gt = torch.tensor([1] + [0] * 7)
        gs = torch.zeros((8, G), dtype=torch.int64)
        out = tpp.exec_pairs(tk, geo, torch.from_numpy(src_fm), gt, gs,
                             fetch="pregather")
        assert torch.isfinite(out).all() and not out.any()


def test_n_real_slots():
    gs = torch.tensor([[3, 0, 0, 0], [0, 0, 0, 0], [1, 0, 2, 0],
                       [1, 2, 3, 4]])
    assert tpp.n_real_slots(gs).tolist() == [1, 0, 3, 4]


# ----------------------------------------------------------------- routing

@pytest.fixture
def counted(monkeypatch):
    """Counts calls of the executors' wrappers."""
    calls = {}
    for fn in ("exec_pairs_cuda", "exec_pairs_cuda_t2",
               "exec_pairs_pre_cuda", "exec_pairs_pre_cuda_t2",
               "exec_pairs_dma_cuda", "exec_pairs_dmap_cuda",
               "exec_pairs_static_cuda"):
        real = getattr(tpp, fn)

        def wrapped(*a, _fn=fn, _real=real, **kw):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(tpp, fn, wrapped)
    return calls


def _raw_lists(w=16):
    gen = torch.Generator().manual_seed(0)
    tgt = torch.arange(2, 8).repeat_interleave(w)
    src = torch.randint(0, NN, (6 * w,), generator=gen)
    raw = PairList(tgt=tgt, src=src, n_valid=(src != 0).sum(),
                   overflow=torch.tensor(0))
    tgt2 = torch.arange(1, 5).repeat_interleave(w)
    src2 = torch.randint(0, NN, (4 * w,), generator=gen)
    raw2 = PairList(tgt=tgt2, src=src2, n_valid=(src2 != 0).sum(),
                    overflow=torch.tensor(0))
    return raw, raw2


@pytest.mark.parametrize("fetch,want", [
    ("pregather", ["exec_pairs_pre_cuda", "exec_pairs_pre_cuda_t2"]),
    ("dma", ["exec_pairs_cuda_t2", "exec_pairs_dma_cuda"]),
    ("dma_i", ["exec_pairs_cuda", "exec_pairs_cuda_t2"]),
    ("dma_p", ["exec_pairs_cuda_t2", "exec_pairs_dmap_cuda"])])
def test_pair_fetch_routes_to_its_executors(fetch, want, counted):
    """cfg.pair_fetch decides the executor in traverse/exec.py:
    'pregather' the K8/K9 wrappers, 'dma_i' K1's, 'dma' K10's and
    'dma_p' K11's, the dma family's paired list K2's; all of them give
    the same sums."""
    src_fm, tgt_geo = _blocks("grav3d", 14, True)
    plan = type("P", (), dict(tgt_geo=torch.from_numpy(tgt_geo),
                              src_fm=torch.from_numpy(src_fm)))
    raw, raw2 = _raw_lists()
    cfg = SolverConfig(pair_group=8, pair_fetch=fetch)
    out, info = texec.exec_pairs(TK.KERNELS["grav3d"], cfg, plan, raw, 16,
                                 4, raw2=raw2)
    assert sorted(counted) == sorted(want)
    ref, _ = texec.exec_pairs(TK.KERNELS["grav3d"],
                              cfg.replace(pair_fetch="dma_i",
                                          pair_backend="torch"),
                              plan, raw, 16, 4, raw2=raw2)
    assert rel_rms(out.numpy()[2:], ref.numpy()[2:]) <= TOL
    assert int(info.overflow) == 0


def test_static_fetch_runs_k1_and_refuses_paired_lists(counted):
    """pair_fetch='static' runs K12's wrapper (it ran K1's before K12
    was ported) with K1's sums, and refuses a paired list."""
    src_fm, tgt_geo = _blocks("grav3d", 15, True)
    plan = type("P", (), dict(tgt_geo=torch.from_numpy(tgt_geo),
                              src_fm=torch.from_numpy(src_fm)))
    raw, raw2 = _raw_lists()
    cfg = SolverConfig(pair_group=8, pair_fetch="static")
    out, _ = texec.exec_pairs(TK.KERNELS["grav3d"], cfg, plan, raw, 16, 4)
    assert list(counted) == ["exec_pairs_static_cuda"]
    ref, _ = texec.exec_pairs(TK.KERNELS["grav3d"],
                              cfg.replace(pair_fetch="dma_i"), plan, raw,
                              16, 4)
    assert rel_rms(out.numpy()[2:], ref.numpy()[2:]) <= TOL
    with pytest.raises(ValueError, match="sibling-paired"):
        texec.exec_pairs(TK.KERNELS["grav3d"], cfg, plan, raw, 16, 4,
                         raw2=raw2)
    with pytest.raises(ValueError, match="pair_fetch"):
        texec.exec_pairs(TK.KERNELS["grav3d"],
                         cfg.replace(pair_fetch="tma"), plan, raw, 16, 4)


def test_exec_groups_runs_pregrouped_input(counted):
    """exec_groups (reference exec.py:exec_groups): pre-grouped input
    with a padding tail gives exec_pairs' result on the same groups."""
    from onbody_tpu_torch.traverse.lists import group_pairs
    src_fm, tgt_geo = _blocks("vort3d", 16, True)
    plan = type("P", (), dict(tgt_geo=torch.from_numpy(tgt_geo),
                              src_fm=torch.from_numpy(src_fm)))
    raw, _ = _raw_lists()
    tk = TK.KERNELS["vort3d"]
    pg = group_pairs(raw, 64, 8, 16)
    assert int((pg.tgt == 0).sum()) > 0          # a padding tail
    for fetch in ("pregather", "dma_i"):
        cfg = SolverConfig(pair_group=8, pair_fetch=fetch)
        out, info = texec.exec_groups(tk, cfg, plan, pg)
        ref, _ = texec.exec_pairs(tk, cfg, plan, raw, 16, 4)
        assert torch.equal(out, ref) and info is pg
    assert sorted(counted) == ["exec_pairs_cuda", "exec_pairs_pre_cuda"]


@pytest.mark.parametrize("name", ["grav3d", "vort2d", "vortgrad3d"])
def test_solve_dtt_pregather_runs_k8_and_k9(name, counted):
    """solve_dtt passes the paired leaf list for pair_fetch='pregather'
    too: the slice configuration with that fetch and the lean plan goes
    through the K8 and K9 wrappers only and gives the dma_i result."""
    from _torch_parity import SLICE_KW, kernel_inputs, torch_parts
    from onbody_tpu_torch.traverse import dtt, treecode
    tk = TK.KERNELS[name]
    sx, sr, ss, tx, tr = kernel_inputs(tk, 77, 3000)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    cfg = SolverConfig(**SLICE_KW).replace(block_size=128, order=4)
    ref, rinfo = dtt.solve_dtt(tk, cfg, treecode.prepare(tk, cfg, srcs,
                                                         targs))
    assert sorted(counted) == ["exec_pairs_cuda", "exec_pairs_cuda_t2"]
    counted.clear()
    pcfg = cfg.replace(pair_fetch="pregather", lean_plan=True)
    plan = treecode.prepare(tk, pcfg, srcs, targs)
    assert plan.src_fm.shape[1] == TK.FM_ROWS[name]
    got, info = dtt.solve_dtt(tk, pcfg, plan)
    assert sorted(counted) == ["exec_pairs_pre_cuda",
                               "exec_pairs_pre_cuda_t2"]
    assert int(info.overflow) == int(rinfo.overflow) == 0
    assert int(info.n_valid) == int(rinfo.n_valid)
    # the same lists, the same order of sums per target
    assert torch.equal(got, ref)
