/*
 * onbody_c.cpp — C ABI shim for the onbody_tpu_torch solver library (the
 * port's copy of onbody_tpu/api/cabi/onbody_c.cpp).
 *
 * Exports the same Fortran-callable pointer API as the reference's
 * static libraries (interface2dvort.cpp:182/324, interface2dvorttr.cpp:
 * 177/321, interface3dvortgrads.cpp:247/422):
 *
 *   external_vel_solver_f_ / external_vel_direct_f_          (2D vortex)
 *   external_vel_solver_tr_f_ / external_vel_direct_tr_f_    (2D + radii)
 *   external_vel_solver_3dvg_f_ / external_vel_direct_3dvg_f_ (3D+grads)
 *
 * Implementation: embeds CPython (or joins the interpreter of a Python
 * host) and forwards the raw pointers as zero-copy memoryviews to
 * onbody_tpu_torch.api.cabi_bridge, which runs the PyTorch/CUDA solver
 * and writes results straight into the caller's output buffers. No numpy
 * C API dependency; the GIL is taken per call, so the shim is safe from
 * multithreaded hosts. A call that fails prints the Python traceback to
 * stderr and returns -1.
 *
 * The Python package is found through ONBODY_TPU_TORCH_ROOT or, failing
 * that, the shared library's own path in the default build layout
 * (<root>/build/onbody_tpu_torch/libonbody_torch_c.so, made by
 * onbody_tpu_torch/api/cabi_lib.py).
 */

#include <Python.h>

#include <dlfcn.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::once_flag g_init_flag;

std::string library_root() {
    const char* env = std::getenv("ONBODY_TPU_TORCH_ROOT");
    if (env != nullptr) return std::string(env);
    Dl_info info;
    if (dladdr(reinterpret_cast<void*>(&library_root), &info) &&
        info.dli_fname != nullptr) {
        std::string p(info.dli_fname);
        // strip /build/onbody_tpu_torch/libonbody_torch_c.so
        for (int up = 0; up < 3; ++up) {
            size_t pos = p.find_last_of('/');
            if (pos == std::string::npos) break;
            p.erase(pos);
        }
        return p;
    }
    return std::string(".");
}

void ensure_python() {
    std::call_once(g_init_flag, []() {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
            // Python >= 3.7 starts with the GIL held by this thread;
            // release it so per-call PyGILState_Ensure works.
            PyEval_SaveThread();
        }
        PyGILState_STATE gil = PyGILState_Ensure();
        std::string root = library_root();
        PyObject* sys_path = PySys_GetObject("path");
        PyObject* entry = PyUnicode_FromString(root.c_str());
        if (sys_path != nullptr && entry != nullptr) {
            PyList_Insert(sys_path, 0, entry);
        }
        Py_XDECREF(entry);
        PyGILState_Release(gil);
    });
}

// A memoryview over n floats at p; nullptr (with the error set) on
// failure.
PyObject* view(const float* p, int n, int flags) {
    return PyMemoryView_FromMemory(
        reinterpret_cast<char*>(const_cast<float*>(p)),
        static_cast<Py_ssize_t>(n) * sizeof(float), flags);
}

// Call bridge.<func>(n_src, <views...>, n_targ, <views...>) where views
// wrap the raw float buffers (read-only inputs, writable outputs).
float call_bridge(const char* func, int nsrc, const float** src_arrs,
                  int n_src_arrs, int ntarg, const float** targ_in,
                  int n_targ_in, float** targ_out, int n_targ_out) {
    ensure_python();
    PyGILState_STATE gil = PyGILState_Ensure();
    float flops = -1.0f;

    PyObject* mod = PyImport_ImportModule("onbody_tpu_torch.api.cabi_bridge");
    if (mod == nullptr) {
        PyErr_Print();
        PyGILState_Release(gil);
        return flops;
    }
    PyObject* fn = PyObject_GetAttrString(mod, func);
    Py_DECREF(mod);
    if (fn == nullptr) {
        PyErr_Print();
        PyGILState_Release(gil);
        return flops;
    }

    int argc = 2 + n_src_arrs + n_targ_in + n_targ_out;
    PyObject* args = PyTuple_New(argc);
    bool ok = args != nullptr;
    int k = 0;
    auto put = [&](PyObject* item) {
        // PyTuple_SET_ITEM steals the reference; a failed item leaves
        // the tuple slot NULL, which Py_DECREF of the tuple tolerates
        if (item == nullptr) ok = false;
        else PyTuple_SET_ITEM(args, k, item);
        ++k;
    };
    if (ok) {
        put(PyLong_FromLong(nsrc));
        for (int i = 0; i < n_src_arrs; ++i)
            put(view(src_arrs[i], nsrc, PyBUF_READ));
        put(PyLong_FromLong(ntarg));
        for (int i = 0; i < n_targ_in; ++i)
            put(view(targ_in[i], ntarg, PyBUF_READ));
        for (int i = 0; i < n_targ_out; ++i)
            put(view(targ_out[i], ntarg, PyBUF_WRITE));
    }
    if (ok) {
        PyObject* res = PyObject_CallObject(fn, args);
        if (res == nullptr) {
            PyErr_Print();
        } else {
            double v = PyFloat_AsDouble(res);
            if (v == -1.0 && PyErr_Occurred()) PyErr_Print();
            else flops = static_cast<float>(v);
            Py_DECREF(res);
        }
    } else {
        PyErr_Print();
    }
    Py_XDECREF(args);
    Py_DECREF(fn);
    PyGILState_Release(gil);
    return flops;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------- 2D

float external_vel_solver_f_(const int* nsrc, const float* sx,
                             const float* sy, const float* ss,
                             const float* sr, const int* ntarg,
                             const float* tx, const float* ty,
                             float* tu, float* tv) {
    const float* s[] = {sx, sy, ss, sr};
    const float* ti[] = {tx, ty};
    float* to[] = {tu, tv};
    return call_bridge("solve_2d", *nsrc, s, 4, *ntarg, ti, 2, to, 2);
}

float external_vel_direct_f_(const int* nsrc, const float* sx,
                             const float* sy, const float* ss,
                             const float* sr, const int* ntarg,
                             const float* tx, const float* ty,
                             float* tu, float* tv) {
    const float* s[] = {sx, sy, ss, sr};
    const float* ti[] = {tx, ty};
    float* to[] = {tu, tv};
    return call_bridge("direct_2d", *nsrc, s, 4, *ntarg, ti, 2, to, 2);
}

float external_vel_solver_tr_f_(const int* nsrc, const float* sx,
                                const float* sy, const float* ss,
                                const float* sr, const int* ntarg,
                                const float* tx, const float* ty,
                                const float* tr, float* tu, float* tv) {
    const float* s[] = {sx, sy, ss, sr};
    const float* ti[] = {tx, ty, tr};
    float* to[] = {tu, tv};
    return call_bridge("solve_2d_tr", *nsrc, s, 4, *ntarg, ti, 3, to, 2);
}

float external_vel_direct_tr_f_(const int* nsrc, const float* sx,
                                const float* sy, const float* ss,
                                const float* sr, const int* ntarg,
                                const float* tx, const float* ty,
                                const float* tr, float* tu, float* tv) {
    const float* s[] = {sx, sy, ss, sr};
    const float* ti[] = {tx, ty, tr};
    float* to[] = {tu, tv};
    return call_bridge("direct_2d_tr", *nsrc, s, 4, *ntarg, ti, 3, to, 2);
}

// ------------------------------------------------------- 3D + gradients

float external_vel_solver_3dvg_f_(
    const int* nsrc, const float* sx, const float* sy, const float* sz,
    const float* ssx, const float* ssy, const float* ssz, const float* sr,
    const int* ntarg, const float* tx, const float* ty, const float* tz,
    float* tu, float* tv, float* tw, float* tux, float* tvx, float* twx,
    float* tuy, float* tvy, float* twy, float* tuz, float* tvz,
    float* twz) {
    const float* s[] = {sx, sy, sz, ssx, ssy, ssz, sr};
    const float* ti[] = {tx, ty, tz};
    float* to[] = {tu, tv, tw, tux, tvx, twx, tuy, tvy, twy,
                   tuz, tvz, twz};
    return call_bridge("solve_3dvg", *nsrc, s, 7, *ntarg, ti, 3, to, 12);
}

float external_vel_direct_3dvg_f_(
    const int* nsrc, const float* sx, const float* sy, const float* sz,
    const float* ssx, const float* ssy, const float* ssz, const float* sr,
    const int* ntarg, const float* tx, const float* ty, const float* tz,
    float* tu, float* tv, float* tw, float* tux, float* tvx, float* twx,
    float* tuy, float* tvy, float* twy, float* tuz, float* tvz,
    float* twz) {
    const float* s[] = {sx, sy, sz, ssx, ssy, ssz, sr};
    const float* ti[] = {tx, ty, tz};
    float* to[] = {tu, tv, tw, tux, tvx, twx, tuy, tvy, twy,
                   tuz, tvz, twz};
    return call_bridge("direct_3dvg", *nsrc, s, 7, *ntarg, ti, 3, to, 12);
}

}  // extern "C"
