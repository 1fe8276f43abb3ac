// Host runtime: FASTA ingestion data-loader (C++).
//
// Native equivalent of the reference's kseq.h + zlib layer
// (/root/reference/include/kseq.h, src/ref_builder.cpp:211-314): streams a
// plain or gzipped FASTA, uppercases, concatenates records into one document
// and packs the engine's "fwd$" / "fwd$rc$" byte layout in one pass, so the
// Python layer never touches per-line Python objects on the hot ingest path.
//
// Exposed as the CPython module `mumemto_tpu._native`:
//   load_fasta_doc(path, use_revcomp) -> (doc_bytes, names, contig_lengths)
//   revcomp(seq_bytes) -> bytes
//   version() -> str
//
// Built by native/build.py (g++ -O3, links -lz). No third-party code.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Complement table from seqtk (mirrors ref_builder.cpp:29-38); identity
// for any byte without a defined complement.
struct CompTable {
  unsigned char t[256];
  CompTable() {
    for (int i = 0; i < 256; ++i) t[i] = static_cast<unsigned char>(i);
    const char* from = "ABCDGHKMNRSTUVWXY";
    const char* to = "TVGHCDMKNYSAABWXR";
    for (int i = 0; from[i]; ++i) {
      t[static_cast<unsigned char>(from[i])] =
          static_cast<unsigned char>(to[i]);
      t[static_cast<unsigned char>(from[i]) + 32] =
          static_cast<unsigned char>(to[i]) + 32;
    }
  }
};
const CompTable kComp;

struct UpperTable {
  unsigned char t[256];
  UpperTable() {
    for (int i = 0; i < 256; ++i) t[i] = static_cast<unsigned char>(i);
    for (int c = 'a'; c <= 'z'; ++c) t[c] = static_cast<unsigned char>(c - 32);
  }
};
const UpperTable kUpper;

constexpr unsigned char kDollar = '$';
constexpr size_t kChunk = 1 << 20;

// Streaming FASTA parse out of a gzFile (zlib reads plain files too).
// Appends uppercased sequence bytes to `seq`, records names and per-contig
// lengths. Returns false + sets `err` on IO failure.
bool parse_fasta(const char* path, std::string* seq,
                 std::vector<std::string>* names,
                 std::vector<int64_t>* contig_lengths, std::string* err) {
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) {
    *err = std::string("cannot open: ") + path;
    return false;
  }
  gzbuffer(f, 1 << 20);
  std::vector<char> buf(kChunk);
  enum State { LINE_START, IN_HEADER_NAME, IN_HEADER_REST, IN_SEQ, IN_COMMENT };
  State st = LINE_START;
  bool seen_header = false;
  std::string name;
  int64_t cur_len = 0;
  auto close_record = [&]() {
    if (seen_header) contig_lengths->push_back(cur_len);
    cur_len = 0;
  };
  for (;;) {
    int n = gzread(f, buf.data(), static_cast<unsigned>(buf.size()));
    if (n < 0) {
      int zerr = 0;
      const char* msg = gzerror(f, &zerr);
      *err = std::string("read error: ") + (msg ? msg : "?");
      gzclose(f);
      return false;
    }
    if (n == 0) break;
    for (int i = 0; i < n; ++i) {
      unsigned char c = static_cast<unsigned char>(buf[i]);
      if (c == '\r') continue;
      switch (st) {
        case LINE_START:
          if (c == '>') {
            close_record();
            seen_header = true;
            name.clear();
            st = IN_HEADER_NAME;
          } else if (c == ';') {
            st = IN_COMMENT;
          } else if (c == '\n') {
            // empty line
          } else if (seen_header) {
            seq->push_back(static_cast<char>(kUpper.t[c]));
            ++cur_len;
            st = IN_SEQ;
          }
          break;
        case IN_HEADER_NAME:
          if (c == '\n') {
            names->push_back(name);
            st = LINE_START;
          } else if (c == ' ' || c == '\t') {
            // skip leading whitespace ("> name desc" -> "name", matching
            // the Python reader's line[1:].split()[0] semantics)
            if (!name.empty()) st = IN_HEADER_REST;
          } else {
            name.push_back(static_cast<char>(c));
          }
          break;
        case IN_HEADER_REST:
          if (c == '\n') {
            names->push_back(name);
            st = LINE_START;
          }
          break;
        case IN_SEQ:
          if (c == '\n') {
            st = LINE_START;
          } else {
            seq->push_back(static_cast<char>(kUpper.t[c]));
            ++cur_len;
          }
          break;
        case IN_COMMENT:
          if (c == '\n') st = LINE_START;
          break;
      }
    }
  }
  if (st == IN_HEADER_NAME || st == IN_HEADER_REST) names->push_back(name);
  close_record();
  gzclose(f);
  return true;
}

PyObject* py_load_fasta_doc(PyObject*, PyObject* args) {
  const char* path = nullptr;
  int use_revcomp = 1;
  if (!PyArg_ParseTuple(args, "s|p", &path, &use_revcomp)) return nullptr;

  std::string seq;
  std::vector<std::string> names;
  std::vector<int64_t> contig_lengths;
  std::string err;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = parse_fasta(path, &seq, &names, &contig_lengths, &err);
  Py_END_ALLOW_THREADS
  if (!ok) {
    PyErr_SetString(PyExc_OSError, err.c_str());
    return nullptr;
  }

  const size_t n = seq.size();
  const size_t doc_len = use_revcomp ? 2 * (n + 1) : (n + 1);
  PyObject* doc = PyBytes_FromStringAndSize(nullptr, static_cast<Py_ssize_t>(doc_len));
  if (doc == nullptr) return nullptr;
  unsigned char* out =
      reinterpret_cast<unsigned char*>(PyBytes_AS_STRING(doc));
  Py_BEGIN_ALLOW_THREADS
  std::memcpy(out, seq.data(), n);
  out[n] = kDollar;
  if (use_revcomp) {
    const unsigned char* s =
        reinterpret_cast<const unsigned char*>(seq.data());
    unsigned char* rc = out + n + 1;
    for (size_t i = 0; i < n; ++i) rc[i] = kComp.t[s[n - 1 - i]];
    out[doc_len - 1] = kDollar;
  }
  Py_END_ALLOW_THREADS

  PyObject* pynames = PyList_New(static_cast<Py_ssize_t>(names.size()));
  if (pynames == nullptr) { Py_DECREF(doc); return nullptr; }
  for (size_t i = 0; i < names.size(); ++i) {
    PyObject* s = PyUnicode_FromStringAndSize(names[i].data(),
                                              static_cast<Py_ssize_t>(names[i].size()));
    if (s == nullptr) { Py_DECREF(doc); Py_DECREF(pynames); return nullptr; }
    PyList_SET_ITEM(pynames, static_cast<Py_ssize_t>(i), s);
  }
  PyObject* pylens = PyList_New(static_cast<Py_ssize_t>(contig_lengths.size()));
  if (pylens == nullptr) { Py_DECREF(doc); Py_DECREF(pynames); return nullptr; }
  for (size_t i = 0; i < contig_lengths.size(); ++i) {
    PyObject* v = PyLong_FromLongLong(contig_lengths[i]);
    if (v == nullptr) {
      Py_DECREF(doc); Py_DECREF(pynames); Py_DECREF(pylens); return nullptr;
    }
    PyList_SET_ITEM(pylens, static_cast<Py_ssize_t>(i), v);
  }
  return Py_BuildValue("(NNN)", doc, pynames, pylens);
}

PyObject* py_revcomp(PyObject*, PyObject* args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return nullptr;
  PyObject* out = PyBytes_FromStringAndSize(nullptr, view.len);
  if (out == nullptr) { PyBuffer_Release(&view); return nullptr; }
  const unsigned char* src = static_cast<const unsigned char*>(view.buf);
  unsigned char* dst = reinterpret_cast<unsigned char*>(PyBytes_AS_STRING(out));
  const Py_ssize_t n = view.len;
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; ++i) dst[i] = kComp.t[src[n - 1 - i]];
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  return out;
}

// sort_phrases(ext_bytes, st_i32, ln_i32) -> (order_i32_bytes, grp_i32_bytes)
//
// Lexicographic argsort of PFP phrase records (byte spans of `ext`) plus
// dense equal-content group ids — the native twin of
// mumemto_tpu/ops/pfp.sort_phrases (the reference's std::sort over word
// strings, newscan.hpp:367-380). Record count is m ~ n/mod; memcmp
// early-exits at the first differing byte, so this is milliseconds where
// the CPython sort costs hundreds of ms at pangenome scale.
PyObject* py_sort_phrases(PyObject*, PyObject* args) {
  Py_buffer ext, st, ln;
  if (!PyArg_ParseTuple(args, "y*y*y*", &ext, &st, &ln)) return nullptr;
  const unsigned char* e = static_cast<const unsigned char*>(ext.buf);
  const int32_t* stp = static_cast<const int32_t*>(st.buf);
  const int32_t* lnp = static_cast<const int32_t*>(ln.buf);
  const size_t m = static_cast<size_t>(st.len) / sizeof(int32_t);
  PyObject* order_b = PyBytes_FromStringAndSize(nullptr,
      static_cast<Py_ssize_t>(m * sizeof(int32_t)));
  PyObject* grp_b = PyBytes_FromStringAndSize(nullptr,
      static_cast<Py_ssize_t>(m * sizeof(int32_t)));
  if (order_b == nullptr || grp_b == nullptr) {
    Py_XDECREF(order_b); Py_XDECREF(grp_b);
    PyBuffer_Release(&ext); PyBuffer_Release(&st); PyBuffer_Release(&ln);
    return nullptr;
  }
  int32_t* order = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(order_b));
  int32_t* grp = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(grp_b));
  Py_BEGIN_ALLOW_THREADS
  for (size_t i = 0; i < m; ++i) order[i] = static_cast<int32_t>(i);
  auto less = [&](int32_t a, int32_t b) {
    const int32_t la = lnp[a], lb = lnp[b];
    const int c = std::memcmp(e + stp[a], e + stp[b],
                              static_cast<size_t>(la < lb ? la : lb));
    if (c != 0) return c < 0;
    if (la != lb) return la < lb;
    return a < b;  // deterministic order among identical phrases
  };
  std::sort(order, order + m, less);
  int32_t g = -1;
  for (size_t r = 0; r < m; ++r) {
    if (r == 0) {
      g = 0;
    } else {
      const int32_t a = order[r - 1], b = order[r];
      const bool eq = lnp[a] == lnp[b] &&
          std::memcmp(e + stp[a], e + stp[b],
                      static_cast<size_t>(lnp[a])) == 0;
      if (!eq) ++g;
    }
    grp[r] = g;
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&ext); PyBuffer_Release(&st); PyBuffer_Release(&ln);
  return Py_BuildValue("(NN)", order_b, grp_b);
}

PyObject* py_version(PyObject*, PyObject*) {
  return PyUnicode_FromString("1.1");
}

PyMethodDef kMethods[] = {
    {"load_fasta_doc", py_load_fasta_doc, METH_VARARGS,
     "load_fasta_doc(path, use_revcomp=True) -> (doc_bytes, names, "
     "contig_lengths): stream a plain/gzip FASTA into the engine's "
     "'fwd$[rc$]' document byte layout."},
    {"revcomp", py_revcomp, METH_VARARGS,
     "revcomp(seq) -> bytes: reverse complement (seqtk table)."},
    {"sort_phrases", py_sort_phrases, METH_VARARGS,
     "sort_phrases(ext, st_i32, ln_i32) -> (order_i32, grp_i32) bytes: "
     "lexicographic argsort + dense group ids of phrase byte spans."},
    {"version", py_version, METH_NOARGS, "native module version"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_native",
    "mumemto_tpu native host runtime (FASTA data-loader)", -1, kMethods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&kModule); }
