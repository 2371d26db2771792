// Native host-side kernels for the data pipeline hot path.
//
// The reference SegMamba feeds its trainer from 18 batchgenerators worker
// processes whose cost is dominated by per-sample 3-D resampling
// (SpatialTransform) and patch crop+pad (light_training/trainer.py and
// light_training/dataloading/base_data_loader.py). This module provides
// those two kernels in C++ (OpenMP-parallel, cache-friendly loops):
//
//   affine_transform_3d(input, matrix, offset, order, cval) -> output
//       order 0: nearest, 1: trilinear, 3: tricubic (Catmull-Rom)
//   crop_pad(input_CZYX, lb, patch, cval) -> (C, *patch) patch
//
// The code is the JAX package's segmamba_tpu/native/augment_native.cpp.
// Built with plain g++ by segmamba_tpu_torch.native.build (no pybind11;
// raw CPython C API + numpy C API).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cmath>
#include <cstring>

namespace {

inline float cubic_w(float t) {
  // Catmull-Rom kernel (a = -0.5)
  const float a = -0.5f;
  t = std::fabs(t);
  if (t <= 1.0f) return ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
  if (t < 2.0f) return (((t - 5.0f) * t + 8.0f) * t - 4.0f) * a;
  return 0.0f;
}

inline float sample_nearest(const float* in, int Z, int Y, int X, float z,
                            float y, float x, float cval) {
  int zi = (int)std::lround(z), yi = (int)std::lround(y),
      xi = (int)std::lround(x);
  if (zi < 0 || zi >= Z || yi < 0 || yi >= Y || xi < 0 || xi >= X)
    return cval;
  return in[((size_t)zi * Y + yi) * X + xi];
}

inline float at(const float* in, int Z, int Y, int X, int z, int y, int x,
                float cval) {
  if (z < 0 || z >= Z || y < 0 || y >= Y || x < 0 || x >= X) return cval;
  return in[((size_t)z * Y + y) * X + x];
}

inline float sample_linear(const float* in, int Z, int Y, int X, float z,
                           float y, float x, float cval) {
  int z0 = (int)std::floor(z), y0 = (int)std::floor(y),
      x0 = (int)std::floor(x);
  float fz = z - z0, fy = y - y0, fx = x - x0;
  float acc = 0.0f;
  for (int dz = 0; dz < 2; ++dz)
    for (int dy = 0; dy < 2; ++dy)
      for (int dx = 0; dx < 2; ++dx) {
        float w = (dz ? fz : 1 - fz) * (dy ? fy : 1 - fy) *
                  (dx ? fx : 1 - fx);
        if (w != 0.0f)
          acc += w * at(in, Z, Y, X, z0 + dz, y0 + dy, x0 + dx, cval);
      }
  return acc;
}

inline float sample_cubic(const float* in, int Z, int Y, int X, float z,
                          float y, float x, float cval) {
  int z0 = (int)std::floor(z), y0 = (int)std::floor(y),
      x0 = (int)std::floor(x);
  float wz[4], wy[4], wx[4];
  for (int i = 0; i < 4; ++i) {
    wz[i] = cubic_w(z - (z0 - 1 + i));
    wy[i] = cubic_w(y - (y0 - 1 + i));
    wx[i] = cubic_w(x - (x0 - 1 + i));
  }
  float acc = 0.0f;
  for (int dz = 0; dz < 4; ++dz) {
    if (wz[dz] == 0.0f) continue;
    float accy = 0.0f;
    for (int dy = 0; dy < 4; ++dy) {
      if (wy[dy] == 0.0f) continue;
      float accx = 0.0f;
      for (int dx = 0; dx < 4; ++dx)
        accx += wx[dx] *
                at(in, Z, Y, X, z0 - 1 + dz, y0 - 1 + dy, x0 - 1 + dx, cval);
      accy += wy[dy] * accx;
    }
    acc += wz[dz] * accy;
  }
  return acc;
}

PyObject* affine_transform_3d(PyObject*, PyObject* args) {
  PyArrayObject *in_obj, *mat_obj, *off_obj;
  int order;
  double cval;
  if (!PyArg_ParseTuple(args, "O!O!O!id", &PyArray_Type, &in_obj,
                        &PyArray_Type, &mat_obj, &PyArray_Type, &off_obj,
                        &order, &cval))
    return nullptr;

  PyArrayObject* in = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)in_obj, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS);
  PyArrayObject* mat = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)mat_obj, NPY_FLOAT64, NPY_ARRAY_C_CONTIGUOUS);
  PyArrayObject* off = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)off_obj, NPY_FLOAT64, NPY_ARRAY_C_CONTIGUOUS);
  if (!in || !mat || !off) return nullptr;
  if (PyArray_NDIM(in) != 3 || PyArray_DIM(mat, 0) != 3 ||
      PyArray_DIM(mat, 1) != 3 || PyArray_DIM(off, 0) != 3) {
    PyErr_SetString(PyExc_ValueError,
                    "expect input (Z,Y,X), matrix (3,3), offset (3,)");
    Py_XDECREF(in); Py_XDECREF(mat); Py_XDECREF(off);
    return nullptr;
  }
  const int Z = (int)PyArray_DIM(in, 0), Y = (int)PyArray_DIM(in, 1),
            X = (int)PyArray_DIM(in, 2);
  npy_intp dims[3] = {Z, Y, X};
  PyArrayObject* out =
      (PyArrayObject*)PyArray_SimpleNew(3, dims, NPY_FLOAT32);
  if (!out) { Py_DECREF(in); Py_DECREF(mat); Py_DECREF(off); return nullptr; }

  const float* ip = (const float*)PyArray_DATA(in);
  const double* m = (const double*)PyArray_DATA(mat);
  const double* o = (const double*)PyArray_DATA(off);
  float* op = (float*)PyArray_DATA(out);
  const float cv = (float)cval;

  Py_BEGIN_ALLOW_THREADS
#pragma omp parallel for collapse(2) schedule(static)
  for (int z = 0; z < Z; ++z) {
    for (int y = 0; y < Y; ++y) {
      float* row = op + ((size_t)z * Y + y) * X;
      for (int x = 0; x < X; ++x) {
        // scipy affine_transform convention: in_coord = M @ out_coord + off
        float iz = (float)(m[0] * z + m[1] * y + m[2] * x + o[0]);
        float iy = (float)(m[3] * z + m[4] * y + m[5] * x + o[1]);
        float ix = (float)(m[6] * z + m[7] * y + m[8] * x + o[2]);
        float v;
        // scipy 'constant' mode: a sample point outside the input extent
        // is cval outright (no edge blending)
        if (iz < 0.0f || iz > Z - 1 || iy < 0.0f || iy > Y - 1 ||
            ix < 0.0f || ix > X - 1)
          v = cv;
        else if (order == 0)
          v = sample_nearest(ip, Z, Y, X, iz, iy, ix, cv);
        else if (order == 1)
          v = sample_linear(ip, Z, Y, X, iz, iy, ix, cv);
        else
          v = sample_cubic(ip, Z, Y, X, iz, iy, ix, cv);
        row[x] = v;
      }
    }
  }
  Py_END_ALLOW_THREADS

  Py_DECREF(in); Py_DECREF(mat); Py_DECREF(off);
  return (PyObject*)out;
}

PyObject* crop_pad(PyObject*, PyObject* args) {
  PyArrayObject* in_obj;
  int lb0, lb1, lb2, p0, p1, p2;
  double cval;
  if (!PyArg_ParseTuple(args, "O!(iii)(iii)d", &PyArray_Type, &in_obj, &lb0,
                        &lb1, &lb2, &p0, &p1, &p2, &cval))
    return nullptr;
  PyArrayObject* in = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)in_obj, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS);
  if (!in) return nullptr;
  if (PyArray_NDIM(in) != 4) {
    PyErr_SetString(PyExc_ValueError, "expect input (C,Z,Y,X)");
    Py_DECREF(in);
    return nullptr;
  }
  const int C = (int)PyArray_DIM(in, 0), Z = (int)PyArray_DIM(in, 1),
            Y = (int)PyArray_DIM(in, 2), X = (int)PyArray_DIM(in, 3);
  npy_intp dims[4] = {C, p0, p1, p2};
  PyArrayObject* out =
      (PyArrayObject*)PyArray_SimpleNew(4, dims, NPY_FLOAT32);
  if (!out) { Py_DECREF(in); return nullptr; }
  const float* ip = (const float*)PyArray_DATA(in);
  float* op = (float*)PyArray_DATA(out);
  const float cv = (float)cval;

  Py_BEGIN_ALLOW_THREADS
#pragma omp parallel for collapse(2) schedule(static)
  for (int c = 0; c < C; ++c) {
    for (int z = 0; z < p0; ++z) {
      int zi = lb0 + z;
      for (int y = 0; y < p1; ++y) {
        int yi = lb1 + y;
        float* row = op + (((size_t)c * p0 + z) * p1 + y) * p2;
        if (zi < 0 || zi >= Z || yi < 0 || yi >= Y) {
          for (int x = 0; x < p2; ++x) row[x] = cv;
          continue;
        }
        const float* irow = ip + (((size_t)c * Z + zi) * Y + yi) * X;
        for (int x = 0; x < p2; ++x) {
          int xi = lb2 + x;
          row[x] = (xi < 0 || xi >= X) ? cv : irow[xi];
        }
      }
    }
  }
  Py_END_ALLOW_THREADS

  Py_DECREF(in);
  return (PyObject*)out;
}

PyMethodDef methods[] = {
    {"affine_transform_3d", affine_transform_3d, METH_VARARGS,
     "affine_transform_3d(input, matrix, offset, order, cval)"},
    {"crop_pad", crop_pad, METH_VARARGS,
     "crop_pad(input_CZYX, lb, patch, cval)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_augment_native",
                         "native augmentation kernels", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__augment_native(void) {
  PyObject* mod = PyModule_Create(&moduledef);
  if (!mod) return nullptr;
  import_array();
  return mod;
}
