"""Port vs reference: grav3d kernel forms (ops/kernels.py); the vortex
forms are held in test_torch_vortex.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onbody_tpu.ops import kernels as JK
from onbody_tpu_torch.ops import kernels as TK

torch.set_num_threads(1)

RTOL = 1e-5


def _tile_inputs(seed, T=64, S=96):
    rng = np.random.default_rng(seed)
    tx = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    tr = rng.uniform(0.01, 0.05, (T,)).astype(np.float32)
    sx = rng.uniform(-1, 1, (S, 3)).astype(np.float32)
    sr = rng.uniform(0.01, 0.05, (S,)).astype(np.float32)
    ss = (rng.uniform(-1, 1, (S, 1)) / S).astype(np.float32)
    return tx, tr, sx, sr, ss


def _close(got, ref, rtol=RTOL):
    """Elementwise rtol, with an absolute floor at rtol of the largest
    magnitude (entries that cancel to ~0 carry the fp32 chain's
    absolute error)."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.from_numpy(x) for x in a]


def test_pairwise_matches_reference():
    a = _tile_inputs(0)
    ref = JK.KERNELS["grav3d"].pairwise(*_j(*a))
    got = TK.get_kernel("grav3d").pairwise(*_t(*a))
    _close(got, ref)


def test_tile_matches_reference():
    a = _tile_inputs(1)
    ref = JK.KERNELS["grav3d"].tile(*_j(*a), "rm", jnp.float32, "exact")
    got = TK.get_kernel("grav3d").tile(*_t(*a),
                                       accum_dtype=torch.float32)
    _close(got, ref)


@pytest.mark.parametrize("pad8", [True, False])
def test_featurize_matches_reference(pad8):
    _, _, sx, sr, ss = _tile_inputs(2)
    ref = JK.featurize("grav3d", *_j(sx, sr, ss), pad8=pad8)
    got = TK.featurize("grav3d", *_t(sx, sr, ss), pad8=pad8)
    assert got.shape == ref.shape == ((8 if pad8 else 5), sx.shape[0])
    _close(got, ref)


def test_pad_fm_rows_matches_reference():
    _, _, sx, sr, ss = _tile_inputs(3)
    lean = np.stack([np.array(JK.featurize("grav3d", *_j(sx, sr, ss),
                                             pad8=False))] * 2)
    ref = JK.pad_fm_rows("grav3d", jnp.asarray(lean))
    got = TK.pad_fm_rows("grav3d", torch.from_numpy(lean))
    assert got.shape == ref.shape == (2, 8, sx.shape[0])
    _close(got, ref)
    # the derived rows equal the pad8 layout
    full = TK.featurize("grav3d", *_t(sx, sr, ss), pad8=True)
    _close(got[0], full)


@pytest.mark.parametrize("pad8", [True, False])
def test_tile_fm_matches_reference(pad8):
    tx, tr, sx, sr, ss = _tile_inputs(4)
    srcT = np.array(JK.featurize("grav3d", *_j(sx, sr, ss), pad8=pad8))
    ref = JK._grav3d_tile_fm(jnp.asarray(tx), jnp.asarray(tr),
                             jnp.asarray(srcT), "rm", jnp.float32,
                             "outer", precision="highest")
    got = TK._grav3d_tile_fm(torch.from_numpy(tx), torch.from_numpy(srcT))
    _close(got, ref)


def test_d2_fm_matches_reference():
    tx, _, sx, sr, ss = _tile_inputs(5)
    srcT = np.array(JK.featurize("grav3d", *_j(sx, sr, ss)))
    ref = JK._d2_fm(jnp.asarray(tx), jnp.asarray(srcT), 3, "outer")
    got = TK._d2_fm(torch.from_numpy(tx), torch.from_numpy(srcT), 3)
    _close(got, ref)


def test_fm_rows_and_unported_kernels():
    """All four kernels are ported: the registry's dims and row layout
    equal the reference's."""
    assert TK.FM_ROWS == JK.FM_ROWS
    assert set(TK.KERNELS) == set(JK.KERNELS)
    for name, jk in JK.KERNELS.items():
        k = TK.get_kernel(name)
        assert (k.pd, k.sd, k.od, k.uses_tr) == (jk.pd, jk.sd, jk.od,
                                                 jk.uses_tr), name
