// CPython C-extension binding of the native core's host build.
//
// The port's copy of the single solves of lbfgspp_tpu/native/fastcall.cpp:
// a builtin single solve is bound through the CPython C API, with the
// interpreter lock released while the core runs, because a ctypes call's
// argument marshalling is a large share of a small solve (chip_smoke.py
// phase 26 times one solve both ways).  Python-callback objectives and the
// threaded batches stay on the ctypes binding of host.cpp.
//
// Compiled together with host.cpp by cuda_build.host_library; the params
// argument is the *address* of the ctypes Params struct that
// native/__init__.py builds, so its layout is defined in one place.
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cstdint>

typedef double (*Obj)(const double*, double*, int, void*);
extern "C" int lbfgspp_native_minimize(
    Obj, void*, int, int, double*, const void*, int,
    double*, double*, int*, int*);
extern "C" int lbfgspp_native_minimize_b(
    Obj, void*, int, int, double*, const double*, const double*,
    const void*, double*, double*, int*, int*);

static PyObject* fast_minimize(PyObject*, PyObject* args)
{
    int builtin_id, ls;
    Py_buffer xb;
    unsigned long long paddr;
    if (!PyArg_ParseTuple(args, "iw*Ki", &builtin_id, &xb, &paddr, &ls))
        return NULL;
    int n = (int)(xb.len / (Py_ssize_t)sizeof(double));
    double fx = 0.0, gn = 0.0;
    int nit = 0, nfev = 0, status;
    Py_BEGIN_ALLOW_THREADS
    status = lbfgspp_native_minimize(
        NULL, NULL, builtin_id, n, (double*)xb.buf,
        (const void*)(uintptr_t)paddr, ls, &fx, &gn, &nit, &nfev);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&xb);
    return Py_BuildValue("iddii", status, fx, gn, nit, nfev);
}

static PyObject* fast_minimize_b(PyObject*, PyObject* args)
{
    int builtin_id;
    Py_buffer xb, lbb, ubb;
    unsigned long long paddr;
    if (!PyArg_ParseTuple(args, "iw*y*y*K", &builtin_id, &xb, &lbb, &ubb,
                          &paddr))
        return NULL;
    int n = (int)(xb.len / (Py_ssize_t)sizeof(double));
    if (lbb.len != xb.len || ubb.len != xb.len) {
        PyBuffer_Release(&xb);
        PyBuffer_Release(&lbb);
        PyBuffer_Release(&ubb);
        PyErr_SetString(PyExc_ValueError, "lb and ub must be as long as x");
        return NULL;
    }
    double fx = 0.0, pg = 0.0;
    int nit = 0, nfev = 0, status;
    Py_BEGIN_ALLOW_THREADS
    status = lbfgspp_native_minimize_b(
        NULL, NULL, builtin_id, n, (double*)xb.buf,
        (const double*)lbb.buf, (const double*)ubb.buf,
        (const void*)(uintptr_t)paddr, &fx, &pg, &nit, &nfev);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&xb);
    PyBuffer_Release(&lbb);
    PyBuffer_Release(&ubb);
    return Py_BuildValue("iddii", status, fx, pg, nit, nfev);
}

static PyMethodDef Methods[] = {
    {"minimize", fast_minimize, METH_VARARGS,
     "minimize(builtin_id, x, params_addr, ls) -> "
     "(status, fx, gnorm, niter, nfev); x solved in place"},
    {"minimize_b", fast_minimize_b, METH_VARARGS,
     "minimize_b(builtin_id, x, lb, ub, params_addr) -> "
     "(status, fx, pgnorm, niter, nfev); x solved in place"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef Module = {
    PyModuleDef_HEAD_INIT, "_lbfgspp_torch_fastcall",
    "C-API binding of lbfgspp_tpu_torch.native's host build", -1, Methods};

PyMODINIT_FUNC PyInit__lbfgspp_torch_fastcall(void)
{
    return PyModule_Create(&Module);
}
