// CPython extension binding for the native SeldonMessage wire codec.
//
// The ctypes binding (native/fastcodec.py of this package) costs a few us
// per call in argument marshalling alone — more than the C++ parse itself for
// typical payloads.  This module exposes the same two entry points through
// the CPython C API, whose per-call overhead is far smaller:
//
//   parse(bytes|str)  -> None | (envelope_bytes, kind:int, float64 ndarray|None)
//   format(ndarray_f64_contig, kind:int) -> bytes | None
//
// kind codes match fastcodec.cpp: 0 = no numeric payload, 1 = tensor,
// 2 = ndarray.  None always means "caller falls back to a slower path".
//
// Built standalone by native/fastcodec.py of this package (g++ -shared with
// the CPython + numpy include dirs); fastcodec.cpp is included directly so
// the codec core stays in one file.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include "fastcodec.cpp"

namespace {

PyObject* py_parse(PyObject*, PyObject* arg) {
  const char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_Check(arg)) {
    buf = PyBytes_AS_STRING(arg);
    len = PyBytes_GET_SIZE(arg);
  } else if (PyUnicode_Check(arg)) {
    buf = PyUnicode_AsUTF8AndSize(arg, &len);
    if (buf == nullptr) return nullptr;
  } else {
    Py_RETURN_NONE;
  }

  SMView view;
  Parse* p = sm_parse_view(buf, (long long)len, &view);
  if (p == nullptr) Py_RETURN_NONE;
  if (view.status != SM_OK || view.ndim > 32) {
    sm_free(p);
    Py_RETURN_NONE;
  }

  PyObject* env = view.envelope
                      ? PyBytes_FromStringAndSize((const char*)view.envelope,
                                                  (Py_ssize_t)view.envelope_len)
                      : PyBytes_FromStringAndSize("{}", 2);
  if (env == nullptr) {
    sm_free(p);
    return nullptr;
  }

  PyObject* result = nullptr;
  if (view.kind == KIND_NONE) {
    result = Py_BuildValue("(NiO)", env, (int)KIND_NONE, Py_None);
    if (result == nullptr) Py_DECREF(env);
  } else {
    npy_intp dims[32];
    long long prod = 1;
    for (int i = 0; i < view.ndim; ++i) {
      dims[i] = (npy_intp)view.shape[i];
      prod *= view.shape[i];
    }
    if (prod != view.nvalues) {  // defensive: never hand back a bad view
      Py_DECREF(env);
      sm_free(p);
      Py_RETURN_NONE;
    }
    PyObject* arr = PyArray_SimpleNew(view.ndim, dims, NPY_FLOAT64);
    if (arr == nullptr) {
      Py_DECREF(env);
      sm_free(p);
      return nullptr;
    }
    if (view.nvalues > 0) {
      memcpy(PyArray_DATA((PyArrayObject*)arr), view.values,
             (size_t)view.nvalues * sizeof(double));
    }
    result = Py_BuildValue("(NiN)", env, (int)view.kind, arr);
    if (result == nullptr) {
      Py_DECREF(env);
      Py_DECREF(arr);
    }
  }
  sm_free(p);
  return result;
}

PyObject* py_format(PyObject*, PyObject* args) {
  PyObject* obj = nullptr;
  int kind = KIND_NDARRAY;
  if (!PyArg_ParseTuple(args, "Oi", &obj, &kind)) return nullptr;
  if (!PyArray_Check(obj)) Py_RETURN_NONE;
  PyArrayObject* arr = (PyArrayObject*)obj;
  if (PyArray_TYPE(arr) != NPY_FLOAT64 ||
      !PyArray_IS_C_CONTIGUOUS(arr) || PyArray_NDIM(arr) < 1) {
    Py_RETURN_NONE;
  }
  int ndim = PyArray_NDIM(arr);
  long long shape[32];
  if (ndim > 32) Py_RETURN_NONE;
  for (int i = 0; i < ndim; ++i) shape[i] = (long long)PyArray_DIM(arr, i);
  long long out_len = 0;
  char* out = sm_format((const double*)PyArray_DATA(arr), shape, ndim, kind,
                        &out_len);
  if (out == nullptr) Py_RETURN_NONE;
  PyObject* bytes = PyBytes_FromStringAndSize(out, (Py_ssize_t)out_len);
  sm_buf_free(out);
  return bytes;
}

PyMethodDef kMethods[] = {
    {"parse", py_parse, METH_O,
     "parse(raw) -> None | (envelope_bytes, kind, float64 array|None)"},
    {"format", (PyCFunction)py_format, METH_VARARGS,
     "format(f64_c_contig_array, kind) -> bytes | None"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_fastcodec",
    "Native SeldonMessage wire codec (CPython binding)", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastcodec(void) {
  import_array();
  return PyModule_Create(&kModule);
}
