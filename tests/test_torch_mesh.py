"""The multi-device decomposition (onbody_tpu_torch/parallel/mesh.py)
against the JAX package's parallel/mesh.py on the CPU.

Integers without a process group: node_owner, local_rows, _node_level,
top_prefix_len, partition_pairs and partition_groups_device (with its
overflow) equal the JAX functions' on the same level list, id for id.
_downward_copy_local at order -1 matches the reference's on the same
slab for every owner.

The solves over gloo: world size 1 in this process; 2, 4 and 8 in one
start of 8 ranks by parallel/launch.py (scripts/multichip.solve_cases),
the 2- and 4-rank cases side by side on subgroups of it. The ranks start
with the file's first test, and so do the JAX references, each compiled
and solved in a thread of this process (JAX_THREADS) while it runs the
port's side. The cases are tests/test_sharding.py's: grav3d
solve_dtt_sharded, solve_dtt_sharded_stream and
solve_treecode3_sharded; vort3d and vortgrad3d streamed; the order -1
copy prolongation; the 2 x 2 two-level mesh. Every rank returns the same
output, overflow 0. Each is held against the port's monolithic
solve_dtt / solve_treecode3 on the same plan at test_sharding.py's own
limits (rtol 1e-5 with atol 1e-8 for the solves that add each target's
pairs in the monolithic order, 1e-6 streamed; vortgrad3d 1e-4 and
rel-RMS 1e-4), and against the JAX package's monolithic solve on the
same inputs at rtol 1e-5 with atol 1e-6 (vortgrad3d as above): the two
packages' executors add the same fp32 terms in another order (the
port's monolithic solve is itself up to 2.0e-7 from the JAX package's
here, test_sharding.py:103-106's reason for 1e-6). The JAX side runs
its jnp executor at mxu_precision "highest"; the port its twins.

fp64 accumulation (accum_dtype float64, fp32 storage): the streamed,
replicated and treecode3 solves at world size 1 equal the port's fp64
monolithic solves bit for bit, and the 4-rank stream is within 1e-12 of
it; the port's fp64 monolithic solve is held against the JAX package's
in test_torch_precision_ref.py.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import jax_parts, kernel_inputs, rel_rms, torch_parts
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops.kernels import get_kernel as jget_kernel
from onbody_tpu.parallel import mesh as jmesh
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu.traverse import lists as jlists
from onbody_tpu.traverse import treecode as jtreecode
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.parallel import launch
from onbody_tpu_torch.parallel import mesh
from onbody_tpu_torch.scripts import multichip
from onbody_tpu_torch.traverse import dtt, lists, treecode

torch.set_num_threads(1)

# tests/test_sharding.py's configuration and size
KW = dict(block_size=32, order=3, frontier_width=256, list_width=512)
N = 1024
# (rtol, atol) against the port's monolithic solve, test_sharding.py's
LIMITS = {"dtt": (1e-5, 1e-8), "treecode3": (1e-5, 1e-8),
          "stream": (1e-5, 1e-6)}
JAX_ATOL = 1e-6
F64 = dict(accum_dtype=torch.float64)
F64_RTOL = 1e-12


def _cfg(order=3, f64=False):
    return SolverConfig(**{**KW, "order": order, **(F64 if f64 else {})})


@functools.cache
def _inputs(name: str, seed: int = 0):
    return kernel_inputs(get_kernel(name), seed, N)


# the JAX package's solves that _check reads, by _jax_reference's
# arguments, and the threads that solve them with the file's first test
JAX_KEYS = [("grav3d", "dtt", 3), ("grav3d", "treecode3", 3),
            ("vort3d", "dtt", 3), ("vortgrad3d", "dtt", 3),
            ("grav3d", "dtt", -1)]
JAX_THREADS = 2
_jax_started = {}


def _jax_reference(name: str, method: str, order: int = 3):
    """The JAX package's monolithic solve on _inputs(name): the thread's
    result where _rank_start started one."""
    fut = _jax_started.get((name, method, order))
    return _jax_solve(name, method, order) if fut is None else fut.result()


@functools.cache
def _jax_solve(name: str, method: str, order: int = 3):
    """The JAX package's monolithic solve on _inputs(name)."""
    sx, sr, ss, tx, tr = _inputs(name)
    jcfg = JConfig(**{**KW, "order": order}, pair_backend="jnp",
                   mxu_precision="highest")
    jk = jget_kernel(name)
    plan = jtreecode.prepare(jk, jcfg, jax_parts(sx, sr, ss),
                             jax_parts(tx, tr))
    solve = (jtreecode.solve_treecode3 if method == "treecode3"
             else jdtt.solve_dtt)
    return np.asarray(solve(jk, jcfg, plan)[0])


@functools.cache
def _reference(name: str, method: str, order: int = 3, f64: bool = False):
    """The port's monolithic solve on _inputs(name)."""
    sx, sr, ss, tx, tr = _inputs(name)
    kernel = get_kernel(name)
    cfg = _cfg(order, f64)
    plan = treecode.prepare(kernel, cfg, torch_parts(sx, sr, ss),
                            torch_parts(tx, tr))
    solve = (treecode.solve_treecode3 if method == "treecode3"
             else dtt.solve_dtt)
    return solve(kernel, cfg, plan)[0].numpy()


def _case(method: str, name: str = "grav3d", order: int = 3, shape=None,
          ranks=None, f64=False):
    return dict(method=method, kernel=name, cfg=_cfg(order, f64),
                inputs=_inputs(name), shape=shape, order=order, ranks=ranks,
                f64=f64)


def _check(case, per_rank):
    """Every rank's result equal, and within the case's limits of the
    port's and the JAX package's monolithic solves (fp64: of the port's
    fp64 monolithic solve)."""
    out, ov, nv = per_rank[0]
    for o, v, n in per_rank[1:]:
        np.testing.assert_array_equal(o, out)
        assert (v, n) == (ov, nv)
    assert ov == 0
    method = "treecode3" if case["method"] == "treecode3" else "dtt"
    name, order = case["kernel"], case["order"]
    ref = _reference(name, method, order, case["f64"])
    if case["f64"]:
        assert out.dtype == np.float64
        np.testing.assert_allclose(out, ref, rtol=F64_RTOL, atol=0)
        return
    jref = _jax_reference(name, method, order)
    if name == "vortgrad3d":
        # gradients amplify fp32 summation-order noise
        # (tests/test_sharding.py:156-172)
        for r in (ref, jref):
            np.testing.assert_allclose(out, r, rtol=1e-5, atol=1e-4)
            assert rel_rms(out, r) < 1e-4
        return
    rtol, atol = LIMITS[case["method"]]
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(out, jref, rtol=1e-5, atol=JAX_ATOL)


# ------------------------------------------------ integers, no group

@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_node_owner_and_local_rows_exact(ndev):
    split = ndev.bit_length() - 1
    for levels in range(max(split, 1), 7):
        ids = np.arange(2 << levels)
        np.testing.assert_array_equal(
            mesh.node_owner(ids, levels, split),
            jmesh.node_owner(ids, levels, split))
        glob, loc = mesh.local_rows(levels, ndev)
        rglob, rloc = jmesh.local_rows(levels, ndev)
        np.testing.assert_array_equal(glob, rglob)
        np.testing.assert_array_equal(loc, rloc)


def test_node_level_and_top_prefix_len_exact():
    ids = np.concatenate([np.arange(1, 70), (1 << np.arange(31)) - 1,
                          1 << np.arange(31),
                          np.random.default_rng(0).integers(
                              1, 1 << 31, 500)]).clip(1, (1 << 31) - 1)
    got = mesh._node_level(torch.from_numpy(ids))
    ref = jmesh._node_level(jnp.asarray(ids, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for split in range(5):
        for W in (8, 128, 256):
            assert (lists.top_prefix_len(split, 9, W)
                    == jlists.top_prefix_len(split, 9, W))


@functools.cache
def _level_lists():
    """The port's level list on _inputs("grav3d"), and the same ids as
    the JAX package's PairList (tests/test_torch_lists.py holds the two
    packages' lists equal id for id)."""
    sx, sr, ss, tx, tr = _inputs("grav3d")
    cfg = _cfg()
    plan = treecode.prepare(get_kernel("grav3d"), cfg, torch_parts(sx, sr, ss),
                            torch_parts(tx, tr))
    pl = lists.build_dtt_pairs_level(plan.stree, plan.ttree, cfg.theta_dtt,
                                     cfg.frontier_width, cfg.mac_geometry)
    jpl = jlists.PairList(tgt=jnp.asarray(pl.tgt.numpy(), jnp.int32),
                          src=jnp.asarray(pl.src.numpy(), jnp.int32),
                          n_valid=jnp.int32(0), overflow=jnp.int32(0))
    return plan, pl, jpl


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_partition_pairs_exact(ndev):
    plan, pl, jpl = _level_lists()
    got = mesh.partition_pairs(pl, plan.ttree.levels, ndev)
    ref = jmesh.partition_pairs(jpl, plan.ttree.levels, ndev)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype


@pytest.mark.parametrize("ndev,cap", [(1, 4096), (2, 4096), (8, 4096),
                                      (8, 2)])
def test_partition_groups_device_exact(ndev, cap):
    """Top groups, per-(owner, stage) groups and the overflow id for id;
    cap 2 overflows the stage buckets."""
    plan, pl, jpl = _level_lists()
    args = (plan.ttree.levels, plan.stree.levels, ndev, KW["frontier_width"],
            8, (cap,) * ndev)
    got = mesh.partition_groups_device(pl.tgt, pl.src, *args)
    ref = jmesh.partition_groups_device(jpl.tgt, jpl.src, *args)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if cap == 2:
        assert int(got[-1]) > 0
    else:
        # every valid pair once: the owned ones per owner, the top ones
        # in the replicated top groups
        src = pl.src.numpy()
        n_top = lists.top_prefix_len(ndev.bit_length() - 1, 0,
                                     KW["frontier_width"])
        assert int(got[-1]) == 0
        assert int((got[1] != 0).sum()) == int((src[:n_top] != 0).sum())
        assert int((got[3] != 0).sum()) == int((src[n_top:] != 0).sum())


_jax_downward_copy = jax.jit(jmesh._downward_copy_local,
                             static_argnums=(1, 2, 3))


@pytest.mark.parametrize("ndev", [2, 4])
def test_downward_copy_local_matches_reference(ndev):
    levels, bs, od = 5, 16, 3
    split = ndev.bit_length() - 1
    R = mesh.local_rows(levels, ndev)[0].shape[1]
    rng = np.random.default_rng(ndev)
    for d in range(ndev):
        out0 = rng.standard_normal((R, bs, od)).astype(np.float32)
        got = mesh._downward_copy_local(torch.from_numpy(out0.copy()),
                                        levels, split, bs, d)
        ref = _jax_downward_copy(jnp.asarray(out0), levels, split, bs,
                                 jnp.int32(d))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gather_local_exact():
    glob, _ = mesh.local_rows(4, 4)
    a = np.arange(32 * 3, dtype=np.float32).reshape(32, 3)
    np.testing.assert_array_equal(
        mesh._gather_local(torch.from_numpy(a), glob).numpy(),
        np.asarray(jmesh._gather_local(jnp.asarray(a), glob)))


# ------------------------------------------- the solves over gloo

@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A one-rank gloo process group in this process."""
    init = tmp_path_factory.mktemp("group1") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_mesh_objects_and_refusals(group1):
    m = mesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.shape, m.device.type) == (1, 0, (1,), "cpu")
    assert mesh._mesh_axis(m) == "tgt"
    m2 = mesh.make_mesh_2level(1, 1, device="cpu")
    assert mesh._mesh_axis(m2) == ("dcn", "ici") and m2.shape == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        # no fall back to the CPU: a mesh on the card or none
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()
    sx, sr, ss, tx, tr = _inputs("grav3d")
    lean = _cfg(order=2).replace(lean_plan=True)
    plan = treecode.prepare(get_kernel("grav3d"), lean,
                            torch_parts(sx, sr, ss), torch_parts(tx, tr))
    with pytest.raises(ValueError, match="Blocks plan"):
        mesh.solve_treecode3_sharded(get_kernel("grav3d"), lean, m, plan)
    # the lean plan's rows are the block's 32 slots: order 3's 64-point
    # grids split over two rows, which the sharded solves refuse
    plan = treecode.prepare(get_kernel("grav3d"),
                            _cfg().replace(lean_plan=True),
                            torch_parts(sx, sr, ss), torch_parts(tx, tr))
    with pytest.raises(ValueError, match="split equivalent rows"):
        mesh.solve_dtt_sharded_stream(get_kernel("grav3d"), _cfg(), m, plan)


@pytest.mark.parametrize("method", ["dtt", "stream", "treecode3"])
def test_world_size_1_matches_reference(group1, method):
    case = _case(method)
    _check(case, multichip.solve_cases([case], "cpu"))


@pytest.mark.parametrize("method", ["dtt", "stream", "treecode3"])
def test_world_size_1_f64_equals_monolithic(group1, method):
    """fp64 accumulation through the sharded solve is the monolithic
    fp64 solve, bit for bit."""
    case = _case(method, f64=True)
    (out, ov, _), = multichip.solve_cases([case], "cpu")
    assert ov == 0 and out.dtype == np.float64
    ref = _reference("grav3d", "treecode3" if method == "treecode3"
                     else "dtt", 3, True)
    np.testing.assert_array_equal(out, ref)


# one start of 8 ranks: ranks 0-1 and 2-5 run the 2- and 4-rank cases
# on subgroups side by side, then all 8 the 8-rank case
D2, D4 = (0, 1), (2, 3, 4, 5)
RANK_CASES = {
    "2-dtt": _case("dtt", ranks=D2),
    "2-stream": _case("stream", ranks=D2),
    "2-treecode3": _case("treecode3", ranks=D2),
    "4-dtt": _case("dtt", ranks=D4),
    "4-stream": _case("stream", ranks=D4),
    "4-treecode3": _case("treecode3", ranks=D4),
    "4-vort3d-stream": _case("stream", "vort3d", ranks=D4),
    "4-vortgrad3d-stream": _case("stream", "vortgrad3d", ranks=D4),
    "4-order-1-stream": _case("stream", order=-1, ranks=D4),
    "4-2level-stream": _case("stream", shape=(2, 2), ranks=D4),
    "4-fp64-stream": _case("stream", ranks=D4, f64=True),
    "8-stream": _case("stream"),
}


@pytest.fixture(scope="module", autouse=True)
def _rank_start(request):
    """Start the 8 ranks with the file's first test when the sharded
    cases are selected, so they run while the references compile; and
    the JAX references (JAX_KEYS) in JAX_THREADS threads when a test
    that reads them is selected."""
    names = [i.name for i in request.session.items]
    if any(n.startswith("test_sharded_solves_match_reference")
           for n in names):
        _started.append(launch.start_ranks(
            multichip.solve_cases, 8, list(RANK_CASES.values()), "cpu",
            backend="gloo"))
    with concurrent.futures.ThreadPoolExecutor(JAX_THREADS) as pool:
        if any(n.startswith(("test_sharded_solves_match_reference",
                             "test_world_size_1_matches_reference"))
               for n in names):
            for key in JAX_KEYS:
                _inputs(key[0])
                _jax_started[key] = pool.submit(_jax_solve, *key)
        yield


_started = []


@functools.cache
def _ranks():
    res = (_started.pop() if _started else launch.start_ranks(
        multichip.solve_cases, 8, list(RANK_CASES.values()), "cpu",
        backend="gloo")).join()
    return {k: [r[i] for r in res if r[i] is not None]
            for i, k in enumerate(RANK_CASES)}


@pytest.mark.parametrize("key", list(RANK_CASES))
def test_sharded_solves_match_reference(key):
    case = RANK_CASES[key]
    per_rank = _ranks()[key]
    assert len(per_rank) == len(case["ranks"] or range(8))
    _check(case, per_rank)
