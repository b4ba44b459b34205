"""The port's benchmark drivers on the CPU (the mirror of
tests/test_drivers.py): flag parsing, stage toggles, just_build_trees,
the galaxy initial condition, the overflow -> wider-lists retry, and
one run of each of the six drivers at its default flags (order -1,
pair-merge), all with device="cpu". Without a CUDA device and without
a CPU request a driver raises.
"""

import contextlib
import io

import pytest
import torch

from onbody_tpu.drivers import common as jcommon
from onbody_tpu_torch.drivers import (common, ongrav3d, onvort2d, onvort3d,
                                      onvortgrad3d, run2dvort,
                                      run3dvortgrads)

torch.set_num_threads(1)


def _capture(fn, *a, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **kw)
    return buf.getvalue()


def _run(argv, kernel="grav3d", toggles=(1, 0, 0, 1, 1), **kw):
    return _capture(common.run_driver, kernel, "test_driver", argv,
                    test_iterations=toggles, device="cpu", **kw)


def _errors(out: str) -> dict:
    """{method: rms} from the report's 'error in' lines."""
    return {ln.split()[2]: float(ln.split("/")[-1])
            for ln in out.splitlines() if ln.startswith("error in")}


def test_driver_end_to_end_report():
    out = _run(["-n=2000", "-b=64", "-o=4"])
    errs = _errors(out)
    assert set(errs) == {"treecode3", "fast"}
    # rms errors parse and sit inside the order-4 envelope
    assert all(rms < 3e-3 for rms in errs.values()), errs
    for line in ("Running test_driver with 2000 sources and 2000 targets",
                 "  init parts time:", "  build trees+equivs:",
                 "[test_driver naive]:", "[test_driver treecode3]:",
                 "[treecode3 total]:", "[test_driver fast]:",
                 "  GFlop: ", "  particle 0 vel ", "Done."):
        assert line in out, line


@pytest.mark.parametrize("order", [6, 7])
def test_driver_high_order_split_rows(order):
    """-o=6 and -o=7 (343 and 512 proxies: their grids span 3 and 4 rows
    of 128) run, as in the reference, inside the envelope of the orders
    below them."""
    out = _run(["-n=2000", "-b=64", f"-o={order}"])
    errs = _errors(out)
    assert set(errs) == {"treecode3", "fast"}
    assert all(rms < 3e-3 for rms in errs.values()), errs


def test_driver_stage_toggle_flag():
    """-test= selects stages exactly (test_iterations fixture)."""
    out = _run(["-n=1000", "-b=64", "-test=1,0,0,1,0"])
    assert "treecode3" in out
    assert "fast" not in out
    assert "treecode2" not in out


def test_driver_just_build_trees():
    out = _run(["-n=1000", "-b=64", "-justtrees"])
    assert "Done (just_build_trees)" in out
    assert "error in" not in out


def test_driver_galaxy_flag():
    """-g: random_in_disk sources (ongrav3d.cpp:579-583) run end to end.
    Every particle of the disk sits at z = 0, a tied axis, so only the
    envelope is held here."""
    out = _run(["-n=2000", "-b=64", "-o=4", "-g", "-test=1,0,0,1,0"])
    errs = _errors(out)
    assert set(errs) == {"treecode3"}
    assert errs["treecode3"] < 1e-2


def test_driver_overflow_retries_wider():
    """Forced-tiny group capacity overflows; the driver recovers with
    the 4x-wider retry and reports errors from a COMPLETE sum. The
    port's executor always groups (the reference's CPU path counts
    pairs), and a list of at most 1024 groups never overflows, so the
    blocks are 32 wide here, not 64."""
    out = _run(["-n=4000", "-b=32", "-o=4", "-t=1.4", "-test=1,0,0,0,1"],
               cfg_overrides=dict(cap_groups_dtt=2))
    assert "retrying with 4x widths" in out
    assert _errors(out)["fast"] < 3e-3


@pytest.mark.parametrize("argv", [
    ["-n", "5e3", "-t", "1.4", "-o=5", "-b", "64", "-radii", "-charges",
     "0", "-test", "1,0,0,0,1"],
    ["-t=1.2", "-t2=0.9", "-charges=1"],
    ["-n"], ["-bogus=1"], ["-h"]])
def test_flag_parsing_matches_reference(argv):
    """Both flag forms parse as the reference's parser does; a missing
    value or an unknown flag is a usage error in both."""
    base = dict(n=1, order=-1, block_size=128, iters=1,
                theta1=2.0, theta2=1.05, theta3=1.0, theta4=1.35,
                galaxy=False, test_iterations=(1, 1, 1, 1, 1),
                just_build_trees=False, use_charges=True,
                random_radii=False)
    try:
        ref = jcommon._parse_flags(argv, "p", base)
    except SystemExit:
        with pytest.raises(SystemExit):
            common._parse_flags(argv, "p", base)
        return
    assert common._parse_flags(argv, "p", base) == ref


def test_driver_radii_and_charges_flags():
    """-radii and -charges=0 (abs-mass gravity) run end to end within
    the envelope."""
    out = _run(["-n=1500", "-b=64", "-o=4", "-radii", "-charges=0",
                "-test=1,0,0,1,0"])
    assert "gravitational simulation" in out
    assert _errors(out)["treecode3"] < 3e-3


# the envelope of each method at order -1: the reference's
# test_pairmerge_treecode_and_dtt for treecode2 (3e-2) and the DTT
# (5e-2); treecode3 shares treecode2's, treecode1 (monopoles, no
# equivalents) keeps its order >= 0 limit (tests/test_traverse.py:67)
ORDER_M1 = {"treecode": 5e-2, "treecode2": 3e-2, "treecode3": 3e-2,
            "fast": 5e-2}


@pytest.mark.parametrize("mod", [ongrav3d, onvort2d, onvort3d,
                                 onvortgrad3d])
def test_cli_driver_default_flags(mod):
    """Each CLI driver at its defaults (order -1, block 128, all five
    stages) at n = 2000: every method reports an error inside the
    pair-merge envelope."""
    out = _capture(mod.main, ["-n=2000"], device="cpu")
    assert "with equivalent particles" in out
    errs = _errors(out)
    assert set(errs) == set(ORDER_M1), out
    for method, rms in errs.items():
        assert rms < ORDER_M1[method], (method, rms)


@pytest.mark.parametrize("mod", [run2dvort, run3dvortgrads])
def test_library_driver_default_flags(mod):
    out = _capture(mod.main, ["-n=2000"], device="cpu")
    assert "Done." in out and "error in" in out


def test_drivers_without_a_cuda_device_raise(monkeypatch):
    """No device named, no ONBODY_DRIVER_PLATFORM, no CUDA device: the
    drivers raise instead of running on the CPU; the environment switch
    selects the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("ONBODY_DRIVER_PLATFORM", raising=False)
    for fn in (ongrav3d.main, run2dvort.main, run3dvortgrads.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _capture(fn, ["-n=200"])
    monkeypatch.setenv("ONBODY_DRIVER_PLATFORM", "cpu")
    out = _capture(ongrav3d.main, ["-n=300", "-b=64", "-justtrees"])
    assert "Done (just_build_trees)" in out


def test_parts_generators_match_reference():
    """The strength patterns on the same positions equal the reference's;
    random_in_disk's layout (central star, radii 0.1 + 5 i / n in the
    first two axes, z = 0) and randomize_radii's factor range as in
    Parts.hpp:112-156."""
    import numpy as np
    from _torch_parity import jax_parts, make_inputs, torch_parts
    from onbody_tpu import parts as JP
    from onbody_tpu_torch import parts as TP
    sx, sr, _, _, _ = make_inputs(95, 500)
    ss = np.ones((500, 3), np.float32)
    for fn in ("smooth_strengths", "central_strengths", "wave_strengths"):
        got = getattr(TP, fn)(torch_parts(sx, sr, ss)).s.numpy()
        ref = np.asarray(getattr(JP, fn)(jax_parts(sx, sr, ss)).s)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9,
                                   err_msg=fn)
    n = 1000
    disk = TP.random_in_disk(torch.Generator().manual_seed(1), n, 3, 1)
    rad = torch.linalg.norm(disk.x[:, :2], dim=1)
    want = 0.1 + 5.0 * torch.arange(n, dtype=torch.float32) / n
    assert torch.allclose(rad[1:], want[1:], rtol=1e-5)
    assert not disk.x[:, 2].any() and not disk.x[0].any()
    assert float(disk.s[0, 0]) == 1.0 and disk.r[0] == np.float32(0.00465)
    assert torch.all(disk.s[1:, 0] == np.float32(0.1 / n))
    p = TP.random_in_cube(torch.Generator().manual_seed(2), n, 3, 1)
    q = TP.randomize_radii(torch.Generator().manual_seed(3), p)
    f = q.r / p.r
    assert float(f.min()) >= 0.5 and float(f.max()) < 1.5
