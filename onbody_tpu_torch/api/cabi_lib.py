"""Build the C ABI shim (cabi/onbody_c.cpp) with the host's C++ compiler.

`build()` compiles it at first use into
`build/onbody_tpu_torch/libonbody_torch_c.so` under the repository root
(or into `out_dir`), rebuilt when a hash of the source, the flags and the
interpreter's paths changes. Python's include and library directories
come from `sysconfig`, so the shim links the interpreter that runs this
module. A host program links or dlopens the library and calls its six
`external_vel_*_f_` symbols; the shim finds the package through
ONBODY_TPU_TORCH_ROOT or, in the default layout, its own path.

    python -m onbody_tpu_torch.api.cabi_lib      # prints the library path
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
from typing import Optional

SOURCE = pathlib.Path(__file__).resolve().parent / "cabi" / "onbody_c.cpp"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "onbody_tpu_torch")
LIB_NAME = "libonbody_torch_c.so"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")
SYMBOLS = ("external_vel_solver_f_", "external_vel_direct_f_",
           "external_vel_solver_tr_f_", "external_vel_direct_tr_f_",
           "external_vel_solver_3dvg_f_", "external_vel_direct_3dvg_f_")


def _python_flags() -> list:
    """-I/-L/-l flags for the running interpreter, from sysconfig. Raises
    where the interpreter ships no Python.h or no shared libpython."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"no Python.h in {inc}: the C ABI shim embeds "
                           "CPython and needs the interpreter's headers")
    libdir = sysconfig.get_config_var("LIBDIR")
    ldver = sysconfig.get_config_var("LDVERSION")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError(f"{sys.executable} has no shared libpython: "
                           "the C ABI shim links libpython" + ldver)
    return [f"-I{inc}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{ldver}", "-ldl"]


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) for the C ABI "
                           "shim")
    return cxx


def build(out_dir: Optional[os.PathLike] = None) -> pathlib.Path:
    """Compile the shim unless an up-to-date one exists; returns its
    path."""
    out = pathlib.Path(out_dir) if out_dir is not None else BUILD_DIR
    cmd_tail = [*CXX_FLAGS, *_python_flags()]
    h = hashlib.sha256(" ".join(cmd_tail).encode())
    h.update(SOURCE.read_bytes())
    digest = h.hexdigest()
    lib = out / LIB_NAME
    stamp = out / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    out.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent builders never
    # load a half-written library
    tmp = out / f".{LIB_NAME}.{os.getpid()}"
    cmd = [_cxx(), str(SOURCE), "-o", str(tmp), *cmd_tail]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"the C ABI shim failed to build (exit "
                               f"{res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
        tmp_stamp = out / f".stamp.{os.getpid()}"
        tmp_stamp.write_text(digest)
        os.replace(tmp_stamp, stamp)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


if __name__ == "__main__":
    print(build())
