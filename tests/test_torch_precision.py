"""The storage/accumulation precision contract in the port (mirror of
tests/test_precision.py): fp32 storage + fp64 accumulation (mycast
semantics: every pair term and sum in double, through the fp64 twins of
K1-f64 and K4-f64 on the CPU) reaches the reference's ~4e-7 tier
(README.md:107-110) and full fp64 goes below it; the port's fp64 DTT
against the reference's is in test_torch_precision_ref.py. mxu_precision
keys are accepted and change nothing: the port's sums are always full
fp32."""

import torch

from _torch_parity import make_inputs, rel_rms, torch_parts
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import direct, dtt, treecode

torch.set_num_threads(1)

KER = get_kernel("grav3d")
F64 = torch.float64
# the reference's tier configuration (tests/test_precision.py:54-57)
TIER_KW = dict(block_size=64, order=7, theta_dtt=2.5, frontier_width=512,
               list_width=1024, cap_groups_dtt=128)


def _problem(n: int, seed: int = 7):
    sx, sr, ss, tx, tr = make_inputs(seed, n)
    srcs, targs = torch_parts(sx, sr, ss), torch_parts(tx, tr)
    return (sx, sr, ss, tx, tr), srcs, targs, direct.direct_oracle(
        KER, srcs, targs)


def test_direct_accum_tiers():
    """direct at accum_dtype float64 (K4-f64's twin) over fp32 storage
    lands at the oracle; fp32 accumulation shows its rounding floor."""
    _, srcs, targs, ref = _problem(4096)
    e32 = rel_rms(direct.direct(KER, srcs, targs), ref)
    out64 = direct.direct(KER, srcs, targs, accum_dtype=F64)
    assert out64.dtype == F64
    e64 = rel_rms(out64, ref)
    assert e64 < 1e-6, e64
    assert e64 < e32 / 10.0, (e32, e64)


def test_dtt_fp64_accum_tier():
    """The whole DTT at order 7 (512 proxies: 4 rows of 128 at block 64)
    and theta 2.5: fp32 storage + fp64 accumulation <= 1e-6 rel-RMS with
    no overflow, the same solve at fp32 accumulation worse."""
    _, srcs, targs, ref = _problem(4096)
    cfg = SolverConfig(accum_dtype=F64, **TIER_KW)
    plan = treecode.prepare(KER, cfg, srcs, targs)
    assert plan.src_fm.dtype == F64 and plan.tgt_geo.dtype == torch.float32
    out64, info = dtt.solve_dtt(KER, cfg, plan)
    assert int(info.overflow) == 0 and out64.dtype == F64
    e64 = rel_rms(out64, ref)
    assert e64 <= 1e-6, e64
    cfg32 = cfg.replace(accum_dtype=torch.float32)
    out32, _ = dtt.solve_dtt(KER, cfg32,
                             treecode.prepare(KER, cfg32, srcs, targs))
    assert e64 < rel_rms(out32, ref)


def test_storage_dtype_wired():
    """storage_dtype float64: prepare casts the inputs, the plan's trees,
    Blocks and rows are double, and the full-fp64 solve beats the
    fp32-storage tier (< 3e-7)."""
    _, srcs, targs, ref = _problem(2048)
    cfg = SolverConfig(storage_dtype=F64, accum_dtype=F64, **TIER_KW)
    plan = treecode.prepare(KER, cfg, srcs, targs)
    assert plan.src_sorted.x.dtype == F64
    assert plan.src_blocks.pos.dtype == F64
    assert plan.src_fm.dtype == plan.tgt_geo.dtype == F64
    out, info = dtt.solve_dtt(KER, cfg, plan)
    assert int(info.overflow) == 0
    assert rel_rms(out, ref) < 3e-7, rel_rms(out, ref)


def test_mxu_precision_end_to_end():
    """Every mxu_precision key gives the 'highest' result bit for bit (the
    port has no reduced-pass tier), and the reference's bounds
    (tests/test_precision.py:122-141) hold."""
    _, srcs, targs, ref = _problem(4096)
    outs, errs = {}, {}
    for prec in ("highest", "3x", "3xt", "w2x", "default"):
        cfg = SolverConfig(block_size=64, order=4, mxu_precision=prec)
        out, info = dtt.solve_dtt(KER, cfg,
                                  treecode.prepare(KER, cfg, srcs, targs))
        assert int(info.overflow) == 0
        outs[prec], errs[prec] = out, rel_rms(out, ref)
    assert all(torch.equal(o, outs["highest"]) for o in outs.values())
    assert errs["3x"] < errs["highest"] + 3e-5, errs
    assert errs["3x"] < 3e-4, errs
    assert errs["w2x"] < 4e-4, errs
