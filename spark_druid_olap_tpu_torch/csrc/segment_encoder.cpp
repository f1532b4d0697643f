// Native segment-ingest kernels.
//
// The ingest tier's hot loop — global sorted-dictionary encoding of string
// columns — implemented as a CPython extension (the image has no pybind11;
// plain C API). This is the framework's "batch index task" compute
// (reference: Druid's indexing service, driven via
// client/DruidOverlordClient.scala — the actual columnarization ran inside
// Druid's JVM; here it is in-tree C++).
//
// Contract (see spark_druid_olap_tpu_torch/segment/native.py; this file is
// a copy of native/segment_encoder.cpp, built by the PyTorch port):
//   encode_utf8(data: buffer, offsets: int32 buffer[n+1])
//     -> (codes: bytes[n*4],          # int32 little-endian
//         dict_data: bytes,           # concatenated sorted unique strings
//         dict_offsets: bytes[(k+1)*4])
//
// The GIL is released for the whole sort/unique pass, so Python-side thread
// pools encode many columns in parallel.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <string_view>
#include <vector>

namespace {

struct EncodeResult {
  std::vector<int32_t> codes;
  std::vector<int32_t> dict_offsets;
  std::vector<char> dict_data;
};

EncodeResult encode_impl(const char* data, const int32_t* offsets,
                         int64_t n) {
  // hash-then-sort-uniques: O(n) interning + O(k log k) dictionary sort —
  // far cheaper than sorting all n rows when cardinality k << n (the
  // common case for BI dimensions)
  EncodeResult r;
  r.codes.resize(static_cast<size_t>(n));
  if (n == 0) {
    r.dict_offsets.push_back(0);
    return r;
  }
  auto view = [&](int64_t i) {
    return std::string_view(data + offsets[i],
                            static_cast<size_t>(offsets[i + 1] - offsets[i]));
  };
  std::unordered_map<std::string_view, int32_t> intern;
  intern.reserve(static_cast<size_t>(n / 4 + 16));
  std::vector<std::string_view> uniques;
  for (int64_t i = 0; i < n; ++i) {
    std::string_view v = view(i);
    auto [it, inserted] =
        intern.emplace(v, static_cast<int32_t>(uniques.size()));
    if (inserted) uniques.push_back(v);
    r.codes[static_cast<size_t>(i)] = it->second;
  }
  const int32_t k = static_cast<int32_t>(uniques.size());
  std::vector<int32_t> perm(static_cast<size_t>(k));
  for (int32_t j = 0; j < k; ++j) perm[static_cast<size_t>(j)] = j;
  std::sort(perm.begin(), perm.end(), [&](int32_t a, int32_t b) {
    return uniques[static_cast<size_t>(a)] < uniques[static_cast<size_t>(b)];
  });
  std::vector<int32_t> remap(static_cast<size_t>(k));  // temp code -> sorted
  for (int32_t pos = 0; pos < k; ++pos)
    remap[static_cast<size_t>(perm[static_cast<size_t>(pos)])] = pos;
  for (int64_t i = 0; i < n; ++i)
    r.codes[static_cast<size_t>(i)] =
        remap[static_cast<size_t>(r.codes[static_cast<size_t>(i)])];
  r.dict_offsets.reserve(static_cast<size_t>(k) + 1);
  r.dict_offsets.push_back(0);
  size_t total = 0;
  for (int32_t j : perm) total += uniques[static_cast<size_t>(j)].size();
  r.dict_data.reserve(total);
  for (int32_t j : perm) {
    std::string_view v = uniques[static_cast<size_t>(j)];
    r.dict_data.insert(r.dict_data.end(), v.begin(), v.end());
    r.dict_offsets.push_back(static_cast<int32_t>(r.dict_data.size()));
  }
  return r;
}

PyObject* encode_utf8(PyObject*, PyObject* args) {
  Py_buffer data_buf, off_buf;
  if (!PyArg_ParseTuple(args, "y*y*", &data_buf, &off_buf)) return nullptr;
  const int64_t n = static_cast<int64_t>(off_buf.len / sizeof(int32_t)) - 1;
  if (n < 0) {
    PyBuffer_Release(&data_buf);
    PyBuffer_Release(&off_buf);
    PyErr_SetString(PyExc_ValueError, "offsets buffer too small");
    return nullptr;
  }
  EncodeResult r;
  const char* data = static_cast<const char*>(data_buf.buf);
  const int32_t* offsets = static_cast<const int32_t*>(off_buf.buf);
  Py_BEGIN_ALLOW_THREADS
  r = encode_impl(data, offsets, n);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&data_buf);
  PyBuffer_Release(&off_buf);

  PyObject* codes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(r.codes.data()),
      static_cast<Py_ssize_t>(r.codes.size() * sizeof(int32_t)));
  PyObject* dict_data = PyBytes_FromStringAndSize(
      r.dict_data.data(), static_cast<Py_ssize_t>(r.dict_data.size()));
  PyObject* dict_offsets = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(r.dict_offsets.data()),
      static_cast<Py_ssize_t>(r.dict_offsets.size() * sizeof(int32_t)));
  if (!codes || !dict_data || !dict_offsets) {
    Py_XDECREF(codes);
    Py_XDECREF(dict_data);
    Py_XDECREF(dict_offsets);
    return nullptr;
  }
  PyObject* out = PyTuple_Pack(3, codes, dict_data, dict_offsets);
  Py_DECREF(codes);
  Py_DECREF(dict_data);
  Py_DECREF(dict_offsets);
  return out;
}

// lookup codes for a batch of strings against an existing sorted dictionary
// (incremental ingest); absent values get code -1
PyObject* lookup_utf8(PyObject*, PyObject* args) {
  Py_buffer data_buf, off_buf, ddata_buf, doff_buf;
  if (!PyArg_ParseTuple(args, "y*y*y*y*", &data_buf, &off_buf, &ddata_buf,
                        &doff_buf))
    return nullptr;
  const int64_t n = static_cast<int64_t>(off_buf.len / sizeof(int32_t)) - 1;
  const int64_t k = static_cast<int64_t>(doff_buf.len / sizeof(int32_t)) - 1;
  const char* data = static_cast<const char*>(data_buf.buf);
  const int32_t* offsets = static_cast<const int32_t*>(off_buf.buf);
  const char* ddata = static_cast<const char*>(ddata_buf.buf);
  const int32_t* doffsets = static_cast<const int32_t*>(doff_buf.buf);
  std::vector<int32_t> codes(static_cast<size_t>(n > 0 ? n : 0));
  Py_BEGIN_ALLOW_THREADS
  auto dview = [&](int64_t i) {
    return std::string_view(ddata + doffsets[i],
                            static_cast<size_t>(doffsets[i + 1] -
                                                doffsets[i]));
  };
  for (int64_t i = 0; i < n; ++i) {
    std::string_view v(data + offsets[i],
                       static_cast<size_t>(offsets[i + 1] - offsets[i]));
    int64_t lo = 0, hi = k;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (dview(mid) < v) lo = mid + 1; else hi = mid;
    }
    codes[static_cast<size_t>(i)] =
        (lo < k && dview(lo) == v) ? static_cast<int32_t>(lo) : -1;
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&data_buf);
  PyBuffer_Release(&off_buf);
  PyBuffer_Release(&ddata_buf);
  PyBuffer_Release(&doff_buf);
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(codes.data()),
      static_cast<Py_ssize_t>(codes.size() * sizeof(int32_t)));
}

// ---------------------------------------------------------------------------
// Result-set JSON encoder — the serving tier's hot loop (the reference's
// wire-encoding analog: its data plane serialized results as JSON or Smile
// binary inside Druid/Jackson; here the row -> JSON bytes pass is in-tree
// C++ with the GIL released).
//
// encode_json_rows(names: tuple[bytes], cols: tuple[tuple], n_rows: int)
//   names: per-column pre-encoded JSON b'"name":' prefixes
//   cols:  (kind, buf_a, buf_b, valid) per column, kinds:
//          0 = f64 values    (buf_a doubles; NaN -> null)
//          1 = i64 values    (buf_a int64)
//          2 = utf8 strings  (buf_a data, buf_b int32 offsets[n+1])
//          3 = bool          (buf_a uint8)
//          4 = timestamp ms  (buf_a int64 epoch millis -> ISO-8601)
//          valid: uint8[n] (empty = all valid); 0 -> null
// Returns the b'{"columns":[...],"rows":[...],"numRows":N}' payload body
// starting at "rows" content; the Python wrapper frames it.

namespace jsonenc {

void append_escaped(std::string& out, std::string_view v) {
  out.push_back('"');
  for (unsigned char c : v) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out.push_back(static_cast<char>(c));
        }
    }
  }
  out.push_back('"');
}

void append_double(std::string& out, double d) {
  if (d != d) { out += "null"; return; }
  char buf[32];
  auto res = std::to_chars(buf, buf + sizeof(buf), d);
  out.append(buf, res.ptr);
}

void append_i64(std::string& out, int64_t v) {
  char buf[24];
  auto res = std::to_chars(buf, buf + sizeof(buf), v);
  out.append(buf, res.ptr);
}

// epoch millis -> "YYYY-MM-DDTHH:MM:SS[.ffffff]" (civil-from-days per
// Howard Hinnant's algorithm)
void append_timestamp(std::string& out, int64_t ms) {
  int64_t days = ms / 86400000;
  int64_t rem = ms % 86400000;
  if (rem < 0) { rem += 86400000; days -= 1; }
  int64_t z = days + 719468;
  int64_t era = (z >= 0 ? z : z - 146096) / 146097;
  int64_t doe = z - era * 146097;
  int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  int64_t y = yoe + era * 400;
  int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  int64_t mp = (5 * doy + 2) / 153;
  int64_t d = doy - (153 * mp + 2) / 5 + 1;
  int64_t m = mp < 10 ? mp + 3 : mp - 9;
  if (m <= 2) y += 1;
  int64_t secs = rem / 1000;
  int64_t msec = rem % 1000;
  char buf[40];
  int n = std::snprintf(buf, sizeof(buf),
                        "\"%04lld-%02lld-%02lldT%02lld:%02lld:%02lld",
                        static_cast<long long>(y), static_cast<long long>(m),
                        static_cast<long long>(d),
                        static_cast<long long>(secs / 3600),
                        static_cast<long long>((secs / 60) % 60),
                        static_cast<long long>(secs % 60));
  out.append(buf, static_cast<size_t>(n));
  if (msec != 0) {
    n = std::snprintf(buf, sizeof(buf), ".%06lld",
                      static_cast<long long>(msec * 1000));
    out.append(buf, static_cast<size_t>(n));
  }
  out.push_back('"');
}

struct Col {
  int kind;
  Py_buffer a{}, b{}, valid{};
  bool has_a = false, has_b = false, has_valid = false;
};

}  // namespace jsonenc

PyObject* encode_json_rows(PyObject*, PyObject* args) {
  PyObject* names_tup;
  PyObject* cols_tup;
  Py_ssize_t n_rows;
  if (!PyArg_ParseTuple(args, "O!O!n", &PyTuple_Type, &names_tup,
                        &PyTuple_Type, &cols_tup, &n_rows))
    return nullptr;
  const Py_ssize_t n_cols = PyTuple_GET_SIZE(names_tup);
  if (PyTuple_GET_SIZE(cols_tup) != n_cols) {
    PyErr_SetString(PyExc_ValueError, "names/cols length mismatch");
    return nullptr;
  }
  std::vector<std::string_view> names(static_cast<size_t>(n_cols));
  std::vector<jsonenc::Col> cols(static_cast<size_t>(n_cols));
  bool ok = true;
  for (Py_ssize_t i = 0; i < n_cols && ok; ++i) {
    PyObject* nb = PyTuple_GET_ITEM(names_tup, i);
    char* nd;
    Py_ssize_t nl;
    if (PyBytes_AsStringAndSize(nb, &nd, &nl) < 0) { ok = false; break; }
    names[static_cast<size_t>(i)] = std::string_view(nd,
                                                     static_cast<size_t>(nl));
    PyObject* ct = PyTuple_GET_ITEM(cols_tup, i);
    if (!PyTuple_Check(ct) || PyTuple_GET_SIZE(ct) != 4) {
      PyErr_SetString(PyExc_ValueError, "column tuple must be "
                      "(kind, a, b, valid)");
      ok = false;
      break;
    }
    jsonenc::Col& c = cols[static_cast<size_t>(i)];
    c.kind = static_cast<int>(PyLong_AsLong(PyTuple_GET_ITEM(ct, 0)));
    auto get = [&](int j, Py_buffer* buf, bool* has) {
      PyObject* o = PyTuple_GET_ITEM(ct, j);
      if (o == Py_None) return true;
      if (PyObject_GetBuffer(o, buf, PyBUF_SIMPLE) < 0) return false;
      *has = true;
      return true;
    };
    if (!get(1, &c.a, &c.has_a) || !get(2, &c.b, &c.has_b) ||
        !get(3, &c.valid, &c.has_valid))
      ok = false;
  }
  std::string out;
  if (ok) {
    Py_BEGIN_ALLOW_THREADS
    out.reserve(static_cast<size_t>(n_rows) *
                static_cast<size_t>(n_cols + 1) * 16 + 64);
    for (Py_ssize_t r = 0; r < n_rows; ++r) {
      out.push_back(r == 0 ? '[' : ',');
      out.push_back('{');
      for (Py_ssize_t ci = 0; ci < n_cols; ++ci) {
        const jsonenc::Col& c = cols[static_cast<size_t>(ci)];
        if (ci) out.push_back(',');
        out.append(names[static_cast<size_t>(ci)]);
        if (c.has_valid &&
            static_cast<const uint8_t*>(c.valid.buf)[r] == 0) {
          out += "null";
          continue;
        }
        switch (c.kind) {
          case 0:
            jsonenc::append_double(
                out, static_cast<const double*>(c.a.buf)[r]);
            break;
          case 1:
            jsonenc::append_i64(
                out, static_cast<const int64_t*>(c.a.buf)[r]);
            break;
          case 2: {
            const int32_t* off = static_cast<const int32_t*>(c.b.buf);
            const char* data = static_cast<const char*>(c.a.buf);
            jsonenc::append_escaped(
                out, std::string_view(data + off[r],
                                      static_cast<size_t>(off[r + 1] -
                                                          off[r])));
            break;
          }
          case 3:
            out += static_cast<const uint8_t*>(c.a.buf)[r] ? "true"
                                                           : "false";
            break;
          case 4:
            jsonenc::append_timestamp(
                out, static_cast<const int64_t*>(c.a.buf)[r]);
            break;
          default:
            out += "null";
        }
      }
      out.push_back('}');
    }
    if (n_rows == 0) out.push_back('[');
    out.push_back(']');
    Py_END_ALLOW_THREADS
  }
  for (auto& c : cols) {
    if (c.has_a) PyBuffer_Release(&c.a);
    if (c.has_b) PyBuffer_Release(&c.b);
    if (c.has_valid) PyBuffer_Release(&c.valid);
  }
  if (!ok) return nullptr;
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

PyMethodDef kMethods[] = {
    {"encode_utf8", encode_utf8, METH_VARARGS,
     "Sorted-dictionary-encode a UTF-8 column (arrow-style buffers)."},
    {"lookup_utf8", lookup_utf8, METH_VARARGS,
     "Binary-search codes for strings against a sorted dictionary."},
    {"encode_json_rows", encode_json_rows, METH_VARARGS,
     "Encode typed column buffers as a JSON rows array."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_sdot_native",
    "Native segment-ingest kernels for spark_druid_olap_tpu.", -1, kMethods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__sdot_native(void) {
  return PyModule_Create(&kModule);
}
