"""Port vs reference: direct summation (traverse/direct.py) and kernel
K4's wrapper and twin (ops/cuda_direct.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_parts, make_inputs, rel_rms,
                           torch_parts)
from onbody_tpu.ops import kernels as JK
from onbody_tpu.ops import pallas_direct
from onbody_tpu.traverse import direct as jdirect
from onbody_tpu_torch.ops import cuda_direct
from onbody_tpu_torch.ops.kernels import get_kernel
from onbody_tpu_torch.traverse import direct as tdirect

torch.set_num_threads(1)

JKER = JK.KERNELS["grav3d"]
TKER = get_kernel("grav3d")


def test_direct_oracle_fp64_matches_reference():
    sx, sr, ss, tx, tr = make_inputs(0, 400, 257)
    ref = np.asarray(jdirect.direct_oracle(JKER, jax_parts(sx, sr, ss),
                                           jax_parts(tx, tr)))
    got = tdirect.direct_oracle(TKER, torch_parts(sx, sr, ss),
                                torch_parts(tx, tr))
    assert got.dtype == torch.float64 and ref.dtype == np.float64
    # rtol 1e-12, with that floor relative to the largest magnitude for
    # entries that cancel to ~0 (summation order differs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("m,s", [(211, 300), (1024, 2048), (1500, 1037)])
def test_direct_matches_reference(m, s):
    """fp32 production direct (the twin on CPU tensors) vs the
    reference's tiled direct and its fp64 oracle."""
    sx, sr, ss, tx, tr = make_inputs(1, s, m)
    js, jt = jax_parts(sx, sr, ss), jax_parts(tx, tr)
    ref = np.asarray(jdirect.direct(JKER, js, jt))
    got = tdirect.direct(TKER, torch_parts(sx, sr, ss),
                         torch_parts(tx, tr)).numpy()
    assert rel_rms(got, ref) < 2e-5
    orc = np.asarray(jdirect.direct_oracle(JKER, js, jt))
    assert rel_rms(got, orc) < 2e-6


@pytest.mark.parametrize("m,s", [(211, 300), (257, 1025)])
def test_direct_twin_matches_pallas_interpret(m, s):
    """direct_torch vs the Pallas direct kernel in interpret mode, at
    ragged sizes (rel 2e-5, the reference's own bound)."""
    sx, sr, ss, tx, tr = make_inputs(2, s, m)
    tr0 = np.zeros_like(tr)
    ref = np.asarray(pallas_direct.direct_pallas(
        JKER, jnp.asarray(tx), jnp.asarray(tr0), jnp.asarray(sx),
        jnp.asarray(sr), jnp.asarray(ss), interpret=True))
    got = cuda_direct.direct_torch(
        TKER, *(torch.from_numpy(a) for a in (tx, tr0, sx, sr, ss)))
    assert got.shape == ref.shape == (m, 3)
    assert rel_rms(got.numpy(), ref) < 2e-5


def test_k4_wrapper_takes_twin_on_cpu():
    sx, sr, ss, tx, tr = make_inputs(3, 300, 100)
    args = [torch.from_numpy(a) for a in (tx, np.zeros_like(tr), sx, sr,
                                           ss)]
    before = dict(cuda_direct.LAUNCHES)
    got = cuda_direct.direct_cuda(TKER, *args)
    assert dict(cuda_direct.LAUNCHES) == before
    assert torch.equal(got, cuda_direct.direct_torch(TKER, *args))


def test_k4_wrapper_rejects_mixed_devices():
    sx, sr, ss, tx, tr = make_inputs(4, 50, 20)
    args = [torch.from_numpy(a) for a in (tx, tr, sx, sr, ss)]
    args[2] = args[2].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        cuda_direct.direct_cuda(TKER, *args)

