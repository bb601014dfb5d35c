// Native UMI parse for the PyTorch port's pass 1
// (humid_tpu_torch.io._cumi).
//
// gather_umi reads each record's header span straight out of the batch
// buffer and writes its UMI, cut or padded with 'N' to umi_size, into a
// strided char matrix (the word's first columns), with the interpreter
// lock released.  The rule is humid_tpu_torch.words.extract_umi's
// (fastq.cc:72-93, 122-129): cut the header at its first space; take the
// last '_' field if it is non-empty and all of ACGT, else the last ':'
// field under the same test, else the empty string.
//
// That rule needs one backward scan.  Let j be the last byte before the
// cut that is not A, C, G or T.  Every byte after j is a base, so:
//   * byte j is '_': the last '_' field is [j+1, cut);
//   * byte j is ':': any '_' lies before j, so the last '_' field holds
//     byte j and fails; the last ':' field is [j+1, cut);
//   * otherwise (or no such j): the last '_' and ':' fields, where they
//     exist, hold byte j and fail.
// The UMI is therefore [j+1, cut) when byte j is '_' or ':' and the
// field is non-empty, and empty in every other case.  Spans, not
// strings: a header may hold any byte (NUL, '\r', tab), none of which is
// a base or a separator.
//
// Kept out of csrc/fastqio.cpp, which also builds the JAX package's
// extension: this parse exists for the port alone.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

inline bool is_base(unsigned char c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

// The UMI field of header [p, p + len): writes its start offset and
// length (0 for no UMI).
inline void umi_field(const unsigned char* p, int64_t len, int64_t* start,
                      int64_t* flen) {
  const void* sp = memchr(p, ' ', size_t(len));
  const int64_t cut =
      sp ? static_cast<const unsigned char*>(sp) - p : len;
  int64_t j = cut - 1;
  while (j >= 0 && is_base(p[j])) --j;
  if (j >= 0 && j + 1 < cut && (p[j] == '_' || p[j] == ':')) {
    *start = j + 1;
    *flen = cut - (j + 1);
  } else {
    *start = 0;
    *flen = 0;
  }
}

PyObject* gather_umi(PyObject* /*self*/, PyObject* args) {
  Py_buffer data_b, starts_b, ends_b, out_b;
  Py_ssize_t stride, col_off, k;
  if (!PyArg_ParseTuple(args, "y*y*y*w*nnn", &data_b, &starts_b, &ends_b,
                        &out_b, &stride, &col_off, &k)) {
    return nullptr;
  }
  const Py_ssize_t n = starts_b.len / 8;
  bool ok = k >= 0 && col_off >= 0 && stride >= col_off + k &&
            ends_b.len / 8 >= n &&
            out_b.len >= (n > 0 ? (n - 1) * stride + col_off + k : 0);
  if (ok) {
    const unsigned char* base =
        static_cast<const unsigned char*>(data_b.buf);
    const int64_t size = data_b.len;
    const int64_t* st = static_cast<const int64_t*>(starts_b.buf);
    const int64_t* en = static_cast<const int64_t*>(ends_b.buf);
    char* out = static_cast<char*>(out_b.buf);
    Py_BEGIN_ALLOW_THREADS;
    for (Py_ssize_t i = 0; i < n; ++i) {
      if (st[i] < 0 || en[i] < st[i] || en[i] > size) {
        ok = false;
        break;
      }
      int64_t start, flen;
      umi_field(base + st[i], en[i] - st[i], &start, &flen);
      char* row = out + i * stride + col_off;
      const int64_t c = flen < k ? flen : k;
      memcpy(row, base + st[i] + start, size_t(c));
      if (c < k) memset(row + c, 'N', size_t(k - c));
    }
    Py_END_ALLOW_THREADS;
  }
  PyBuffer_Release(&data_b);
  PyBuffer_Release(&starts_b);
  PyBuffer_Release(&ends_b);
  PyBuffer_Release(&out_b);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError,
                    "gather_umi: bad buffer sizes or a span outside buf");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"gather_umi", gather_umi, METH_VARARGS,
     "gather_umi(buf, starts, ends, out, stride, col_off, umi_size): the "
     "UMI of each header span, cut or padded with 'N' to umi_size, into "
     "out[i, col_off:col_off + umi_size] of a strided matrix."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_cumi",
    "Native UMI parse of the port's pass 1.", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__cumi(void) { return PyModule_Create(&module); }
