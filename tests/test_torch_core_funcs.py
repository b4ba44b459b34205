"""Port vs reference: the regularized core functions (ops/core_funcs.py)
in fp32 and fp64, their branch limits and self-interaction guards, and
the vortgrad3d gradient outputs against torch.autograd."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onbody_tpu.ops import core_funcs as JC
from onbody_tpu.ops import kernels as JK
from onbody_tpu_torch.ops import core_funcs as TC
from onbody_tpu_torch.ops import kernels as TK

torch.set_num_threads(1)

CORES_2D = ["rm_2d", "exp_2d"]
CORES_3D = ["rm_3d", "exp_3d", "v2_3d"]
CORES_3D_GRADS = ["rm_3d_grads", "exp_3d_grads"]


def _args(dtype, n=4000, seed=0):
    """d2 over twelve decades (exact zeros included) against radii that
    put every exp branch in reach: close (reld < 1e-3), mid, far (> 16)."""
    rng = np.random.default_rng(seed)
    d2 = 10.0 ** rng.uniform(-9, 3, n)
    d2[:20] = 0.0
    sr = rng.uniform(0.01, 0.1, n)
    tr = rng.uniform(0.01, 0.1, n)
    return [a.astype(dtype) for a in (d2, sr, tr)]


def _compare(got, ref, dtype, true=None):
    """fp64: elementwise to 1e-9 (the cancelling exp bbb branch turns
    the two libraries' last-bit exp differences into ~2e-10; everything
    else agrees to 1e-12). fp32: rel-RMS 1e-6 against the
    reference, where the core is well conditioned. The exp cores' mid
    branch cancels (1 - exp(-reld), and in bbb corefac*e - r3), so one
    ulp of exp, which XLA and torch may round differently, is amplified
    there: the reference's own fp32 result is then ~1e-3 rel-RMS from
    its fp64 value (bbb). There the port must agree with the reference
    to a twentieth of that distance, and elementwise be no further from
    the fp64 value than twice the reference's error plus 1e-6."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    if dtype == np.float64:
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
        return
    true = np.asarray(true, np.float64)
    ref_err = np.linalg.norm(ref - true) / np.linalg.norm(true)
    rms = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rms <= max(1e-6, 0.05 * ref_err), (rms, ref_err)
    assert np.all(np.abs(got - true)
                  <= 2 * np.abs(ref - true) + 1e-6 * np.abs(true))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fn", CORES_2D + CORES_3D + CORES_3D_GRADS)
def test_cores_match_reference(fn, dtype):
    d2, sr, tr = _args(dtype)
    a = [d2, sr] + ([tr] if fn.endswith("_2d") else [])
    ref = getattr(JC, fn)(*map(jnp.asarray, a))
    true = getattr(JC, fn)(*(jnp.asarray(x.astype(np.float64)) for x in a))
    got = getattr(TC, fn)(*map(torch.from_numpy, a))
    if not fn.endswith("_grads"):
        got, ref, true = (got,), (ref,), (true,)
    for g, r, t in zip(got, ref, true):
        assert g.dtype == torch.from_numpy(d2).dtype
        _compare(g, r, dtype, t)


@pytest.mark.parametrize("fn", CORES_2D)
def test_2d_cores_without_target_radius(fn):
    d2, sr, _ = _args(np.float64, seed=1)
    ref = getattr(JC, fn)(jnp.asarray(d2), jnp.asarray(sr))
    got = getattr(TC, fn)(torch.from_numpy(d2), torch.from_numpy(sr))
    _compare(got, ref, np.float64)


def test_core_registry_and_flops():
    assert TC.FLOPS == JC.FLOPS
    for name in ("rm", "exp"):
        assert TC.core_2d(name).__name__ == JC.core_2d(name).__name__
        assert (TC.core_3d_grads(name).__name__
                == JC.core_3d_grads(name).__name__)
    for name in ("rm", "exp", "v2"):
        assert TC.core_3d(name).__name__ == JC.core_3d(name).__name__
    with pytest.raises(KeyError):
        TC.core_3d_grads("v2")


def test_core_funcs_self_interaction_finite():
    for dtype in (torch.float32, torch.float64):
        z = torch.zeros((4,), dtype=dtype)
        sr = torch.full((4,), 0.05, dtype=dtype)
        for fn in (TC.rm_2d, TC.exp_2d):
            assert torch.isfinite(fn(z, sr, sr)).all()
        for fn in (TC.rm_3d, TC.exp_3d, TC.v2_3d):
            assert torch.isfinite(fn(z, sr)).all()
        for fn in (TC.rm_3d_grads, TC.exp_3d_grads):
            r3, bbb = fn(z, sr)
            assert torch.isfinite(r3).all() and torch.isfinite(bbb).all()


def test_exp_core_branches():
    """Far branch ~ 1/d^k, close branch ~ corefac."""
    f64 = torch.float64
    sr = torch.tensor([0.1], dtype=f64)
    far = torch.tensor([100.0], dtype=f64)
    close = torch.tensor([1e-9], dtype=f64)
    np.testing.assert_allclose(float(TC.exp_2d(far, sr)[0]), 1.0 / 100.0,
                               rtol=1e-5)
    np.testing.assert_allclose(float(TC.exp_2d(close, sr)[0]), 100.0,
                               rtol=1e-3)
    np.testing.assert_allclose(float(TC.exp_3d(far, sr)[0]), 0.001,
                               rtol=1e-5)
    np.testing.assert_allclose(float(TC.exp_3d(close, sr)[0]), 1000.0,
                               rtol=1e-3)


@pytest.mark.parametrize("core", ["rm", "exp"])
def test_gradients_match_autodiff(core):
    """The 9 gradient outputs of vortgrad3d are d(vel)/d(target
    position): check against torch.autograd's Jacobian of the velocity
    sum (the reference checks its rm form with jax.jacfwd)."""
    kg = TK.get_kernel("vortgrad3d")
    rng = np.random.default_rng(3)
    f64 = torch.float64
    tx = torch.from_numpy(rng.uniform(-1, 1, (5, 3))).to(f64)
    tr = torch.from_numpy(rng.uniform(0.01, 0.05, (5,))).to(f64)
    sx = torch.from_numpy(rng.uniform(-1, 1, (11, 3))).to(f64)
    sr = torch.from_numpy(rng.uniform(0.01, 0.05, (11,))).to(f64)
    ss = torch.from_numpy(rng.uniform(-1, 1, (11, 3)) / 11).to(f64)

    def vel(one_t):
        return kg.pairwise(one_t[None, :], tr[:1], sx, sr, ss,
                           core).sum(1)[0, :3]

    full = kg.pairwise(tx, tr, sx, sr, ss, core).sum(1)
    for i in range(tx.shape[0]):
        jac = torch.autograd.functional.jacobian(vel, tx[i])
        grads = full[i, 3:].reshape(3, 3)      # grads[b, a] = A[a, b]
        np.testing.assert_allclose(grads.T.numpy(), jac.numpy(),
                                   rtol=1e-7, atol=1e-10)
    # the velocity part is vort3d's with the opposite d convention
    vv = TK.get_kernel("vort3d").pairwise(tx, tr, sx, sr, ss, core).sum(1)
    np.testing.assert_allclose(full[:, :3].numpy(), -vv.numpy(),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("name", ["vort2d", "vort3d", "vortgrad3d"])
@pytest.mark.parametrize("core", ["rm", "exp"])
def test_pairwise_matches_reference(name, core):
    """The fp64 oracle's per-pair forms against the reference's."""
    jk, tk = JK.KERNELS[name], TK.get_kernel(name)
    rng = np.random.default_rng(4)
    tx = rng.uniform(-1, 1, (37, jk.pd))
    tr = rng.uniform(0.01, 0.05, (37,))
    sx = rng.uniform(-1, 1, (53, jk.pd))
    sr = rng.uniform(0.01, 0.05, (53,))
    ss = rng.uniform(-1, 1, (53, jk.sd)) / 53
    a = (tx, tr, sx, sr, ss)
    ref = np.asarray(jk.pairwise(*map(jnp.asarray, a), core))
    got = tk.pairwise(*map(torch.from_numpy, a), core).numpy()
    assert got.shape == ref.shape == (37, 53, jk.od)
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())
