"""The port's fp64 DTT against the reference's fp64 DTT on the same
numpy inputs (the precision contract itself is in
test_torch_precision.py). The reference's fp64 tier needs
jax_enable_x64, set for its solve only (_torch_parity.jax_x64)."""

import numpy as np
import pytest
import torch

from _torch_parity import (jax_parts, jax_x64, make_inputs, rel_rms,
                           torch_parts)
from onbody_tpu.config import SolverConfig as JConfig
from onbody_tpu.ops import kernels as JK
from onbody_tpu.traverse import dtt as jdtt
from onbody_tpu.traverse import treecode as jtc
from onbody_tpu_torch.config import SolverConfig
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import dtt, treecode

torch.set_num_threads(1)

KER = get_kernel("grav3d")
F64 = torch.float64
# the reference's tier configuration (tests/test_precision.py:54-57)
TIER_KW = dict(block_size=64, order=7, theta_dtt=2.5, frontier_width=512,
               list_width=1024, cap_groups_dtt=128)


@pytest.mark.parametrize("storage,theta", [(torch.float32, 2.5),
                                           (F64, 1.6)],
                         ids=["fp32-storage", "fp64-storage"])
def test_fp64_dtt_matches_reference(storage, theta):
    """The port's fp64 DTT and the reference's (jax_enable_x64 on for
    its solve only) on the same numpy inputs, order 7 at block 64: 1e-9
    rel-RMS. At fp32 storage the tier's theta 2.5; at fp64 storage theta
    1.6, which carries a far field: fp32-stored proxies are fp32 sums
    whose last bits differ between the two packages' contraction orders
    (~1e-7 relative), and at theta 1.6 their far field carries that to
    ~3e-9; double proxies agree to rounding."""
    arrays = make_inputs(11, 3000)
    srcs, targs = torch_parts(*arrays[:3]), torch_parts(*arrays[3:])
    kw = dict(TIER_KW, theta_dtt=theta)
    cfg = SolverConfig(storage_dtype=storage, accum_dtype=F64, **kw)
    out, info = dtt.solve_dtt(KER, cfg,
                              treecode.prepare(KER, cfg, srcs, targs))
    sx, sr, ss, tx, tr = arrays
    with jax_x64():
        import jax.numpy as jnp
        jst = jnp.float64 if storage == F64 else jnp.float32
        jcfg = JConfig(storage_dtype=jst, accum_dtype=jnp.float64, **kw)
        jk = JK.KERNELS["grav3d"]
        jplan = jtc.prepare(jk, jcfg, jax_parts(sx, sr, ss),
                            jax_parts(tx, tr))
        jout, jinfo = jdtt.solve_dtt(jk, jcfg, jplan)
        jout = np.asarray(jout)
    assert jout.dtype == np.float64
    assert int(info.overflow) == int(jinfo.overflow) == 0
    assert int(info.n_valid) > 0
    assert rel_rms(out, jout) <= 1e-9
