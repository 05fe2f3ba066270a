// pwicp_capi — drop-in C ABI of the PyTorch port, matching the reference
// DLL surface.
//
// The reference ships a DLL exposing two C symbols (include/Registration.h:
// 36,49) consumed via ctypes (python/main.py:15-18):
//
//     bool PiecewiseICP_pair_call(const char* confile, const char* outfile);
//     bool PiecewiseICP_4D_call(const char* confile, int startEpoch,
//                               int epochNum, int pairMode, float overlapThd);
//
// This library exposes the SAME symbols, delegating to piecewise_icp_torch
// through an embedded (or already-running) CPython interpreter, so an
// existing C/C++/ctypes caller of the reference DLL can switch by swapping
// the library path.
//
// The symbols take no device.  The device is read from the environment
// variable PWICP_TORCH_DEVICE at each call ("cuda" where it is unset or
// empty, "cpu" for the plain versions of the kernels) and handed to the
// Python entry point as its `device` argument.
//
// Build (piecewise_icp_torch.native.build_capi does this at first use):
//     g++ -O2 -shared -fPIC pwicp_capi.cpp -I<python include> \
//         -L<python libdir> -lpython3.X -o libpwicp_torch_capi.so

#include <Python.h>

#include <cstdlib>

namespace {

bool ensure_python() {
    if (!Py_IsInitialized()) {
        Py_Initialize();
    }
    return Py_IsInitialized();
}

const char* device_name() {
    const char* dev = std::getenv("PWICP_TORCH_DEVICE");
    return (dev && *dev) ? dev : "cuda";
}

// Call piecewise_icp_torch.<func>(*args, device=...); the GIL is held by
// the caller.  Steals the reference to `args`.
bool call_entry(const char* func, PyObject* args) {
    bool ok = false;
    PyObject* kwargs = Py_BuildValue("{s:s}", "device", device_name());
    PyObject* mod = args && kwargs
        ? PyImport_ImportModule("piecewise_icp_torch") : nullptr;
    if (mod) {
        PyObject* fn = PyObject_GetAttrString(mod, func);
        if (fn) {
            PyObject* res = PyObject_Call(fn, args, kwargs);
            if (res) {
                ok = PyObject_IsTrue(res) == 1;
                Py_DECREF(res);
            }
            Py_DECREF(fn);
        }
        Py_DECREF(mod);
    }
    if (PyErr_Occurred()) PyErr_Print();
    Py_XDECREF(kwargs);
    Py_XDECREF(args);
    return ok;
}

}  // namespace

extern "C" {

bool PiecewiseICP_pair_call(const char* confile, const char* outfile) {
    if (!ensure_python()) return false;
    PyGILState_STATE gil = PyGILState_Ensure();
    bool ok = call_entry("piecewise_icp_pair_call",
                         Py_BuildValue("(ss)", confile, outfile));
    PyGILState_Release(gil);
    return ok;
}

bool PiecewiseICP_4D_call(const char* confile, int startEpoch, int epochNum,
                          int pairMode, float overlapThd) {
    if (!ensure_python()) return false;
    PyGILState_STATE gil = PyGILState_Ensure();
    bool ok = call_entry("piecewise_icp_4d_call",
                         Py_BuildValue("(siiif)", confile, startEpoch,
                                       epochNum, pairMode,
                                       static_cast<double>(overlapThd)));
    PyGILState_Release(gil);
    return ok;
}

}  // extern "C"
