"""The port's C ABI (onbody_tpu_torch/api/cabi/onbody_c.cpp +
api/cabi_bridge.py): the shim built from source with the host's g++,
dlopen'ed in a fresh interpreter and called through its six
Fortran-style pointer symbols exactly as an external host would (the
mirror of tests/test_cabi.py), on the CPU (ONBODY_CABI_DEVICE=cpu);
and the port's bridge functions against the JAX package's, called on the
same memoryviews.

Tolerances: each solver symbol within the API's limits of its direct
symbol (velocities 1e-3, vortgrad3d gradients 2e-2; PERF.md §2); bridge
against bridge as tests/test_torch_api.py holds the API (solvers 5e-6,
vortgrad3d gradients 5e-5, direct sums 2e-5).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import rel_rms
from onbody_tpu.api import cabi_bridge as jbridge
from onbody_tpu_torch.api import cabi_bridge as tbridge
from onbody_tpu_torch.api import cabi_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]

# a C++ host program: dlopen the shim and call the 2D direct symbol;
# with a second argument, set ONBODY_CABI_DEVICE to it first (the
# embedded interpreter reads its environment when it starts, at the
# first call) and call the 2D solver too; prints the flop estimates,
# whether the output was written and the solver's rel-RMS
HOST = r"""
#include <dlfcn.h>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>
typedef float (*Fn)(const int*, const float*, const float*, const float*,
                    const float*, const int*, const float*, const float*,
                    float*, float*);
int main(int argc, char** argv) {
    void* h = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
    if (!h) { std::fprintf(stderr, "%s\n", dlerror()); return 2; }
    Fn solver = (Fn)dlsym(h, "external_vel_solver_f_");
    Fn direct = (Fn)dlsym(h, "external_vel_direct_f_");
    int n = 600;
    std::vector<float> x(n), y(n), s(n), r(n), u(n), v(n), du(n), dv(n);
    unsigned st = 12345u;
    auto rnd = [&]() {
        st = st * 1664525u + 1013904223u;
        return (st >> 8) / float(1 << 24) * 2.0f - 1.0f;
    };
    for (int i = 0; i < n; ++i) {
        x[i] = rnd(); y[i] = rnd(); s[i] = rnd() / n;
        r[i] = std::sqrt(1.0f / n);
    }
    if (argc > 2) setenv("ONBODY_CABI_DEVICE", argv[2], 1);
    float f2 = direct(&n, x.data(), y.data(), s.data(), r.data(), &n,
                      x.data(), y.data(), du.data(), dv.data());
    double touched = 0;
    for (int i = 0; i < n; ++i) touched += std::fabs(du[i]);
    if (argc <= 2) {
        std::printf("DIRECT %g %g\n", f2, touched);
        return 0;
    }
    float f1 = solver(&n, x.data(), y.data(), s.data(), r.data(), &n,
                      x.data(), y.data(), u.data(), v.data());
    double num = 0, den = 0;
    for (int i = 0; i < n; ++i) {
        num += (u[i] - du[i]) * (u[i] - du[i])
               + (v[i] - dv[i]) * (v[i] - dv[i]);
        den += du[i] * du[i] + dv[i] * dv[i];
    }
    std::printf("DIRECT %g %g\nSOLVER %g\nREL %g\n", f2, touched, f1,
                std::sqrt(num / den));
    return 0;
}
"""


def _mv(a):
    return memoryview(a).cast("B")


def _inputs_2d(seed=5, n=400, m=300):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    src = [rng.uniform(-1, 1, n).astype(f32),
           rng.uniform(-1, 1, n).astype(f32),
           (rng.uniform(-1, 1, n) / n).astype(f32),
           np.full(n, (1.0 / n) ** 0.5, f32)]
    tgt = [rng.uniform(-1, 1, m).astype(f32) for _ in range(2)]
    tr = rng.uniform(0.5, 1.5, m).astype(f32) * (1.0 / m) ** 0.5
    return src, tgt, tr


def _call(bridge, fn, n, src, m, tgt, n_out):
    outs = [np.zeros(m, np.float32) for _ in range(n_out)]
    fl = getattr(bridge, fn)(n, *map(_mv, src), m, *map(_mv, tgt),
                             *map(_mv, outs))
    return np.stack(outs, 1), fl


@pytest.mark.parametrize("fn,radii", [("solve_2d", False),
                                      ("solve_2d_tr", True),
                                      ("direct_2d", False),
                                      ("direct_2d_tr", True)])
def test_bridge_2d_matches_reference(monkeypatch, fn, radii):
    monkeypatch.setenv("ONBODY_CABI_DEVICE", "cpu")
    src, tgt, tr = _inputs_2d()
    tgt = tgt + [tr] if radii else tgt
    got, fl = _call(tbridge, fn, 400, src, 300, tgt, 2)
    ref, jfl = _call(jbridge, fn, 400, src, 300, tgt, 2)
    assert fl == jfl == 400 * 300 * 12.0
    assert np.isfinite(got).all()
    assert rel_rms(got, ref) <= (2e-5 if fn.startswith("direct") else 5e-6)


@pytest.mark.parametrize("fn", ["solve_3dvg", "direct_3dvg"])
def test_bridge_3dvg_matches_reference(monkeypatch, fn):
    monkeypatch.setenv("ONBODY_CABI_DEVICE", "cpu")
    rng = np.random.default_rng(11)
    n = 300
    f32 = np.float32
    x3 = [rng.uniform(-1, 1, n).astype(f32) for _ in range(3)]
    w3 = [(np.cos(c * 10 * x) / n).astype(f32)
          for c, x in zip((0.7, 1.7, 2.7), x3)]
    r3 = np.full(n, (1.0 / n) ** (1 / 3), f32)
    got, fl = _call(tbridge, fn, n, x3 + w3 + [r3], n, x3, 12)
    ref, jfl = _call(jbridge, fn, n, x3 + w3 + [r3], n, x3, 12)
    assert fl == jfl == n * n * 64.0
    assert np.isfinite(got).all()
    if fn.startswith("direct"):
        assert rel_rms(got, ref) <= 2e-5
    else:
        assert rel_rms(got[:, :3], ref[:, :3]) <= 5e-6
        assert rel_rms(got[:, 3:], ref[:, 3:]) <= 5e-5


def test_bridge_raises_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.delenv("ONBODY_CABI_DEVICE", raising=False)
    src, tgt, _ = _inputs_2d(n=64, m=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _call(tbridge, "direct_2d", 64, src, 32, tgt, 2)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return cabi_lib.build(tmp_path_factory.mktemp("cabi"))


class _Run:
    """A subprocess started at once; result() waits for it and returns
    (returncode, stdout, stderr)."""

    def __init__(self, args, **kw):
        self.p = subprocess.Popen(args, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, **kw)

    def result(self):
        out, err = self.p.communicate(timeout=300)
        return self.p.returncode, out, err


@pytest.fixture(scope="module", autouse=True)
def runs(shim, tmp_path_factory):
    """The shim's callers in their own processes, started with the
    file's first test so that they run while this process compiles the
    JAX package's bridge: scripts/cabi_driver.py (a fresh interpreter
    that dlopens the shim) on the CPU, and the C++ host without a device
    request (where there is no card) and with ONBODY_CABI_DEVICE=cpu."""
    tmp = tmp_path_factory.mktemp("cabi_runs")
    env = dict(os.environ, ONBODY_TPU_TORCH_ROOT=str(ROOT),
               ONBODY_CABI_DEVICE="cpu", OMP_NUM_THREADS="1")
    res = {"out": tmp / "driver"}
    res["out"].mkdir()
    res["driver"] = _Run(
        [sys.executable, "-m", "onbody_tpu_torch.scripts.cabi_driver",
         str(res["out"]), "--lib", str(shim), "--n", "700", "--m", "500",
         "--n3", "600", "--reps", "1"], env=env, cwd=ROOT)
    src = tmp / "host.cpp"
    src.write_text(HOST)
    exe = tmp / "host"
    subprocess.run(["g++", "-std=c++17", "-O1", str(src), "-o", str(exe),
                    "-ldl"], check=True, capture_output=True, timeout=120)
    site = [p for p in sys.path if p.endswith("-packages")]
    env = dict(os.environ, ONBODY_TPU_TORCH_ROOT=str(ROOT),
               PYTHONPATH=os.pathsep.join(site), OMP_NUM_THREADS="1")
    env.pop("ONBODY_CABI_DEVICE", None)
    if not torch.cuda.is_available():
        res["host"] = _Run([str(exe), str(shim)], env=env)
    res["host-cpu"] = _Run([str(exe), str(shim), "cpu"], env=env)
    yield res
    for r in res.values():
        if isinstance(r, _Run) and r.p.poll() is None:
            r.p.kill()
            r.p.communicate()


def test_shim_exports_the_six_symbols(shim):
    syms = subprocess.run(["nm", "-D", "--defined-only", str(shim)],
                          capture_output=True, text=True, check=True).stdout
    for s in cabi_lib.SYMBOLS:
        assert f" T {s}\n" in syms, s
    # rebuilt only when the source or flags change
    assert cabi_lib.build(shim.parent) == shim


def test_shim_solvers_match_direct_symbols(runs):
    """scripts/cabi_driver.py (a fresh interpreter that dlopens the
    shim) calls all six symbols on the CPU: 2D targets apart from the
    sources, vortgrad3d targets the sources."""
    rc, stdout, stderr = runs["driver"].result()
    line = [ln for ln in stdout.splitlines() if ln.startswith("CABI ")]
    assert rc == 0 and len(line) == 1, stderr[-3000:]
    calls = json.loads(line[0][5:])["calls"]
    got = {s: np.load(runs["out"] / f"{s}.npy") for s in calls}
    for kind, n, m, fl in (("f", 700, 500, 12.0), ("tr_f", 700, 500, 12.0),
                           ("3dvg_f", 600, 600, 64.0)):
        a = got[f"external_vel_solver_{kind}_"]
        b = got[f"external_vel_direct_{kind}_"]
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        pd = 3 if kind == "3dvg_f" else 2
        assert rel_rms(a[:, :pd], b[:, :pd]) < 1e-3, kind
        if pd == 3:
            assert rel_rms(a[:, 3:], b[:, 3:]) < 2e-2, kind
        for role in ("solver", "direct"):
            c = calls[f"external_vel_{role}_{kind}_"]
            assert c["flops"] == np.float32(n * m * fl)
            assert c["launches"] == {}       # the CPU runs the twins
    # target radii change the 2D result
    assert rel_rms(got["external_vel_direct_f_"],
                   got["external_vel_direct_tr_f_"]) > 1e-3


def test_c_host_embeds_python(runs):
    """A C++ program (no Python of its own) dlopens the shim, which
    starts an embedded interpreter. Without a device request and without
    a card a call returns -1 and writes nothing (no fall back to the
    CPU); with ONBODY_CABI_DEVICE=cpu the solver is within 1e-3 of the
    direct sum."""

    def host(key):
        rc, stdout, stderr = runs[key].result()
        assert rc == 0, stderr[-3000:]
        return dict(ln.split(" ", 1) for ln in stdout.splitlines()), stderr

    if not torch.cuda.is_available():
        out, err = host("host")
        assert list(map(float, out["DIRECT"].split())) == [-1.0, 0.0]
        assert "RuntimeError: onbody_tpu_torch.api: no CUDA device" in err
    out, _ = host("host-cpu")
    flops, touched = map(float, out["DIRECT"].split())
    assert flops == float(out["SOLVER"]) == np.float32(600 * 600 * 12.0)
    assert touched > 0 and float(out["REL"]) < 1e-3
