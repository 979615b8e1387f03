// slamio — native I/O runtime for orb_slam2_comment_tpu.
//
// The reference gets image decoding, dataset loading and the vocabulary
// parser from native code (OpenCV imread in the Examples/* drivers,
// DBoW2's TemplatedVocabulary::loadFromTextFile for the ~1M-line
// ORBvoc.txt). This module provides the same substrate for the JAX
// framework: libpng decode with the GIL released, a C++ thread-pool
// prefetcher that keeps the per-frame host loop free of I/O stalls, and
// a vocabulary text parser ~50x faster than a Python tokenizer.
//
// Reference parity notes:
//  - gray conversion uses ITU-R 601 coefficients, matching the
//    cv::cvtColor(BGR2GRAY) the reference applies per frame
//    (src/Tracking.cc:172-197).
//  - 16-bit PNGs return raw sample values (TUM depth maps; scaling by
//    DepthMapFactor stays in Python, mirroring Tracking.cc:222-231).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decode (full libpng API; the simplified API applies gamma handling we
// must not have for raw 16-bit depth data)
// ---------------------------------------------------------------------------

struct Decoded {
  std::vector<uint8_t> data;  // row-major samples
  uint32_t h = 0, w = 0;
  int channels = 0;   // 1 or 3
  int bit_depth = 0;  // 8 or 16
  std::string error;
};

struct MemReader {
  const uint8_t* p;
  size_t len, off;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  MemReader* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->off + n > r->len) {
    png_error(png, "truncated PNG stream");
  }
  std::memcpy(out, r->p + r->off, n);
  r->off += n;
}

bool decode_png_mem(const uint8_t* buf, size_t len, Decoded* out) {
  if (len < 8 || png_sig_cmp(buf, 0, 8) != 0) {
    out->error = "not a PNG stream";
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) {
    out->error = "png_create_read_struct failed";
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    out->error = "png_create_info_struct failed";
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    if (out->error.empty()) out->error = "libpng decode error";
    return false;
  }
  MemReader reader{buf, len, 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // PNG is big-endian on the wire

  png_read_update_info(png, info);
  bit_depth = png_get_bit_depth(png, info);
  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);

  out->h = h;
  out->w = w;
  out->channels = channels;
  out->bit_depth = bit_depth;
  out->data.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool read_file(const std::string& path, std::vector<uint8_t>* buf,
               std::string* err) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(n > 0 ? static_cast<size_t>(n) : 0);
  size_t got = n > 0 ? std::fread(buf->data(), 1, buf->size(), f) : 0;
  std::fclose(f);
  if (got != buf->size()) {
    *err = "short read on " + path;
    return false;
  }
  return true;
}

// Frame payload: decoded planes converted to their final host dtype.
struct Plane {
  std::vector<uint8_t> bytes;
  uint32_t h = 0, w = 0;
  char dtype = 0;  // 'B' u8 gray, 'H' u16 raw, 'f' f32 gray
};

// kind: 0 = f32 grayscale 0..255 (ITU-601 from RGB), 1 = u16 raw (depth),
//       2 = u8 grayscale
bool load_plane(const std::string& path, int kind, Plane* out,
                std::string* err) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf, err)) return false;
  Decoded d;
  if (!decode_png_mem(buf.data(), buf.size(), &d)) {
    *err = path + ": " + d.error;
    return false;
  }
  out->h = d.h;
  out->w = d.w;
  size_t n = static_cast<size_t>(d.h) * d.w;
  if (kind == 1) {
    if (d.bit_depth != 16 || d.channels != 1) {
      *err = path + ": expected 16-bit gray depth PNG";
      return false;
    }
    out->dtype = 'H';
    out->bytes = std::move(d.data);
    return true;
  }
  // grayscale output (f32 or u8)
  std::vector<float> gray(n);
  if (d.bit_depth == 8 && d.channels == 1) {
    for (size_t i = 0; i < n; ++i) gray[i] = d.data[i];
  } else if (d.bit_depth == 8 && d.channels == 3) {
    const uint8_t* p = d.data.data();
    for (size_t i = 0; i < n; ++i) {
      gray[i] = 0.299f * p[3 * i] + 0.587f * p[3 * i + 1] +
                0.114f * p[3 * i + 2];
    }
  } else if (d.bit_depth == 16 && d.channels == 1) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(d.data.data());
    for (size_t i = 0; i < n; ++i) gray[i] = p[i];
  } else {
    *err = path + ": unsupported PNG layout";
    return false;
  }
  if (kind == 2) {
    out->dtype = 'B';
    out->bytes.resize(n);
    for (size_t i = 0; i < n; ++i) {
      float v = gray[i];
      out->bytes[i] =
          static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
    }
  } else {
    out->dtype = 'f';
    out->bytes.resize(n * 4);
    std::memcpy(out->bytes.data(), gray.data(), n * 4);
  }
  return true;
}

PyObject* plane_to_array(Plane& p) {
  npy_intp dims[2] = {static_cast<npy_intp>(p.h), static_cast<npy_intp>(p.w)};
  int typenum = p.dtype == 'H' ? NPY_UINT16
                               : (p.dtype == 'B' ? NPY_UINT8 : NPY_FLOAT32);
  PyObject* arr = PyArray_SimpleNew(2, dims, typenum);
  if (!arr) return nullptr;
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(arr)),
              p.bytes.data(), p.bytes.size());
  return arr;
}

// ---------------------------------------------------------------------------
// module functions
// ---------------------------------------------------------------------------

PyObject* py_read_image(PyObject*, PyObject* args, PyObject* kwargs) {
  const char* path;
  int kind = 0;
  static const char* kwlist[] = {"path", "kind", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|i",
                                   const_cast<char**>(kwlist), &path, &kind))
    return nullptr;
  Plane p;
  std::string err;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = load_plane(path, kind, &p, &err);
  Py_END_ALLOW_THREADS;
  if (!ok) {
    PyErr_SetString(PyExc_IOError, err.c_str());
    return nullptr;
  }
  return plane_to_array(p);
}

PyObject* py_decode_png(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  Decoded d;
  bool ok;
  Py_BEGIN_ALLOW_THREADS;
  ok = decode_png_mem(static_cast<const uint8_t*>(buf.buf), buf.len, &d);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  if (!ok) {
    PyErr_SetString(PyExc_ValueError, d.error.c_str());
    return nullptr;
  }
  npy_intp dims[3] = {d.h, d.w, d.channels};
  int nd = d.channels == 1 ? 2 : 3;
  PyObject* arr = PyArray_SimpleNew(
      nd, dims, d.bit_depth == 16 ? NPY_UINT16 : NPY_UINT8);
  if (!arr) return nullptr;
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(arr)),
              d.data.data(), d.data.size());
  return arr;
}

// ---------------------------------------------------------------------------
// ORB vocabulary text parser (TemplatedVocabulary::loadFromTextFile,
// Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:241)
// Format: header "k L s1 s2"; then per node: parent is_leaf d0..d31 weight
// ---------------------------------------------------------------------------

PyObject* py_parse_orb_vocab(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

  std::vector<int32_t> parents;
  std::vector<uint8_t> leaves;
  std::vector<uint8_t> descs;
  std::vector<float> weights;
  int k = 0, L = 0;
  std::string err;
  bool ok = true;

  Py_BEGIN_ALLOW_THREADS;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    ok = false;
  } else {
    if (std::fscanf(f, "%d %d", &k, &L) != 2) {
      err = "bad vocabulary header";
      ok = false;
    } else {
      // skip the two scoring/weighting ids on the header line
      int s1, s2;
      if (std::fscanf(f, "%d %d", &s1, &s2) != 2) { /* tolerated */ }
      parents.reserve(1 << 20);
      weights.reserve(1 << 20);
      for (;;) {
        int parent, is_leaf;
        if (std::fscanf(f, "%d %d", &parent, &is_leaf) != 2) break;
        int d[32];
        bool row_ok = true;
        for (int i = 0; i < 32; ++i) {
          if (std::fscanf(f, "%d", &d[i]) != 1) {
            row_ok = false;
            break;
          }
        }
        double wgt = 0.0;
        if (!row_ok || std::fscanf(f, "%lf", &wgt) != 1) {
          err = "truncated vocabulary node line";
          ok = false;
          break;
        }
        parents.push_back(parent);
        leaves.push_back(is_leaf != 0);
        for (int i = 0; i < 32; ++i) descs.push_back(static_cast<uint8_t>(d[i]));
        weights.push_back(static_cast<float>(wgt));
      }
    }
    std::fclose(f);
  }
  Py_END_ALLOW_THREADS;

  if (!ok) {
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }
  npy_intp n = static_cast<npy_intp>(parents.size());
  npy_intp dd[2] = {n, 32};
  PyObject* a_par = PyArray_SimpleNew(1, &n, NPY_INT32);
  PyObject* a_leaf = PyArray_SimpleNew(1, &n, NPY_UINT8);
  PyObject* a_desc = PyArray_SimpleNew(2, dd, NPY_UINT8);
  PyObject* a_w = PyArray_SimpleNew(1, &n, NPY_FLOAT32);
  if (!a_par || !a_leaf || !a_desc || !a_w) {
    Py_XDECREF(a_par);
    Py_XDECREF(a_leaf);
    Py_XDECREF(a_desc);
    Py_XDECREF(a_w);
    return nullptr;
  }
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(a_par)),
              parents.data(), parents.size() * 4);
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(a_leaf)),
              leaves.data(), leaves.size());
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(a_desc)),
              descs.data(), descs.size());
  std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(a_w)),
              weights.data(), weights.size() * 4);
  return Py_BuildValue("(iiNNNN)", k, L, a_par, a_leaf, a_desc, a_w);
}

// ---------------------------------------------------------------------------
// Prefetcher: C++ thread pool decoding frames ahead of consumption.
// Mirrors the role of the reference drivers' synchronous cv::imread inside
// the tracking loop (Examples/Stereo/stereo_kitti.cc:69-78) but without
// charging decode latency to the frame budget.
// ---------------------------------------------------------------------------

struct FrameSpec {
  std::vector<std::pair<std::string, int>> planes;  // (path, kind)
};

struct Prefetcher {
  PyObject_HEAD
  std::vector<FrameSpec>* specs;
  std::map<size_t, std::vector<Plane>>* ready;
  std::string* error;
  std::mutex* mu;
  std::condition_variable* cv;
  std::vector<std::thread>* workers;
  std::atomic<size_t>* next_job;
  std::atomic<size_t>* consumed;
  std::atomic<bool>* stop;
  size_t lookahead;
};

void prefetch_worker(Prefetcher* self) {
  for (;;) {
    if (self->stop->load()) return;
    size_t job = self->next_job->fetch_add(1);
    if (job >= self->specs->size()) return;
    // bound the window: wait until the consumer is close enough
    {
      std::unique_lock<std::mutex> lk(*self->mu);
      self->cv->wait(lk, [&] {
        return self->stop->load() ||
               job < self->consumed->load() + self->lookahead;
      });
      if (self->stop->load()) return;
    }
    std::vector<Plane> planes((*self->specs)[job].planes.size());
    std::string err;
    for (size_t i = 0; i < planes.size(); ++i) {
      auto& [path, kind] = (*self->specs)[job].planes[i];
      if (!load_plane(path, kind, &planes[i], &err)) {
        std::lock_guard<std::mutex> lk(*self->mu);
        if (self->error->empty()) *self->error = err;
        self->cv->notify_all();
        return;
      }
    }
    std::lock_guard<std::mutex> lk(*self->mu);
    (*self->ready)[job] = std::move(planes);
    self->cv->notify_all();
  }
}

PyObject* Prefetcher_new(PyTypeObject* type, PyObject*, PyObject*) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(type->tp_alloc(type, 0));
  if (self) {
    self->specs = nullptr;
    self->ready = nullptr;
    self->error = nullptr;
    self->mu = nullptr;
    self->cv = nullptr;
    self->workers = nullptr;
    self->next_job = nullptr;
    self->consumed = nullptr;
    self->stop = nullptr;
    self->lookahead = 8;
  }
  return reinterpret_cast<PyObject*>(self);
}

int Prefetcher_init(PyObject* raw, PyObject* args, PyObject* kwargs) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(raw);
  PyObject* frames;
  int lookahead = 8, threads = 4;
  static const char* kwlist[] = {"frames", "lookahead", "threads", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|ii",
                                   const_cast<char**>(kwlist), &frames,
                                   &lookahead, &threads))
    return -1;
  PyObject* seq = PySequence_Fast(frames, "frames must be a sequence");
  if (!seq) return -1;
  auto* specs = new std::vector<FrameSpec>();
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  specs->reserve(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* fr = PySequence_Fast_GET_ITEM(seq, i);
    PyObject* fseq = PySequence_Fast(fr, "frame must be a sequence");
    if (!fseq) {
      delete specs;
      Py_DECREF(seq);
      return -1;
    }
    FrameSpec spec;
    for (Py_ssize_t j = 0; j < PySequence_Fast_GET_SIZE(fseq); ++j) {
      PyObject* pl = PySequence_Fast_GET_ITEM(fseq, j);
      const char* path;
      int kind;
      if (!PyArg_ParseTuple(pl, "si", &path, &kind)) {
        delete specs;
        Py_DECREF(fseq);
        Py_DECREF(seq);
        return -1;
      }
      spec.planes.emplace_back(path, kind);
    }
    specs->push_back(std::move(spec));
    Py_DECREF(fseq);
  }
  Py_DECREF(seq);

  self->specs = specs;
  self->ready = new std::map<size_t, std::vector<Plane>>();
  self->error = new std::string();
  self->mu = new std::mutex();
  self->cv = new std::condition_variable();
  self->next_job = new std::atomic<size_t>(0);
  self->consumed = new std::atomic<size_t>(0);
  self->stop = new std::atomic<bool>(false);
  self->lookahead = static_cast<size_t>(lookahead > 1 ? lookahead : 1);
  self->workers = new std::vector<std::thread>();
  int nthreads = threads > 0 ? threads : 1;
  for (int t = 0; t < nthreads; ++t)
    self->workers->emplace_back(prefetch_worker, self);
  return 0;
}

void Prefetcher_dealloc(PyObject* raw) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(raw);
  if (self->stop) {
    self->stop->store(true);
    self->cv->notify_all();
    Py_BEGIN_ALLOW_THREADS;
    for (auto& t : *self->workers)
      if (t.joinable()) t.join();
    Py_END_ALLOW_THREADS;
  }
  delete self->workers;
  delete self->specs;
  delete self->ready;
  delete self->error;
  delete self->mu;
  delete self->cv;
  delete self->next_job;
  delete self->consumed;
  delete self->stop;
  Py_TYPE(raw)->tp_free(raw);
}

PyObject* Prefetcher_get(PyObject* raw, PyObject* args) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(raw);
  Py_ssize_t idx;
  if (!PyArg_ParseTuple(args, "n", &idx)) return nullptr;
  if (idx < 0 || static_cast<size_t>(idx) >= self->specs->size()) {
    PyErr_SetString(PyExc_IndexError, "frame index out of range");
    return nullptr;
  }
  std::vector<Plane> planes;
  std::string err;
  Py_BEGIN_ALLOW_THREADS;
  {
    std::unique_lock<std::mutex> lk(*self->mu);
    // advance the window before waiting so workers may reach idx even if
    // the consumer skipped ahead
    if (static_cast<size_t>(idx) > self->consumed->load())
      self->consumed->store(static_cast<size_t>(idx));
    self->cv->notify_all();
    self->cv->wait(lk, [&] {
      return !self->error->empty() ||
             self->ready->count(static_cast<size_t>(idx)) > 0 ||
             // frame already handed out: its planes were moved, waiting
             // would deadlock
             (static_cast<size_t>(idx) < self->consumed->load() &&
              self->ready->count(static_cast<size_t>(idx)) == 0);
    });
    if (!self->error->empty()) {
      err = *self->error;
    } else if (self->ready->count(static_cast<size_t>(idx)) == 0) {
      err = "frame already consumed (Prefetcher frames are single-read)";
    } else {
      auto it = self->ready->find(static_cast<size_t>(idx));
      planes = std::move(it->second);
      self->ready->erase(it);
    }
  }
  if (err.empty()) {
    size_t c = self->consumed->load();
    if (static_cast<size_t>(idx) + 1 > c)
      self->consumed->store(static_cast<size_t>(idx) + 1);
    self->cv->notify_all();
  }
  Py_END_ALLOW_THREADS;
  if (!err.empty()) {
    PyErr_SetString(PyExc_IOError, err.c_str());
    return nullptr;
  }
  PyObject* tup = PyTuple_New(planes.size());
  if (!tup) return nullptr;
  for (size_t i = 0; i < planes.size(); ++i) {
    PyObject* arr = plane_to_array(planes[i]);
    if (!arr) {
      Py_DECREF(tup);
      return nullptr;
    }
    PyTuple_SET_ITEM(tup, i, arr);
  }
  return tup;
}

PyObject* Prefetcher_len(PyObject* raw, PyObject*) {
  Prefetcher* self = reinterpret_cast<Prefetcher*>(raw);
  return PyLong_FromSize_t(self->specs->size());
}

PyMethodDef Prefetcher_methods[] = {
    {"get", Prefetcher_get, METH_VARARGS,
     "get(i) -> tuple of arrays for frame i (blocks until decoded)"},
    {"size", Prefetcher_len, METH_NOARGS, "number of frames"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject PrefetcherType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

PyMethodDef module_methods[] = {
    {"read_image", reinterpret_cast<PyCFunction>(py_read_image),
     METH_VARARGS | METH_KEYWORDS,
     "read_image(path, kind=0) -> ndarray. kind: 0 f32 gray 0..255, "
     "1 u16 raw (depth), 2 u8 gray."},
    {"decode_png", py_decode_png, METH_VARARGS,
     "decode_png(bytes) -> ndarray (u8 [H,W]/[H,W,3] or u16 [H,W])"},
    {"parse_orb_vocab", py_parse_orb_vocab, METH_VARARGS,
     "parse_orb_vocab(path) -> (k, L, parents i32[n], is_leaf u8[n], "
     "desc u8[n,32], weight f32[n])"},
    {nullptr, nullptr, 0, nullptr},
};

struct PyModuleDef slamio_module = {
    PyModuleDef_HEAD_INIT, "slamio",
    "Native I/O runtime: PNG codec, prefetching dataset loader, "
    "ORB vocabulary parser.",
    -1, module_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit_slamio(void) {
  import_array();
  PrefetcherType.tp_name = "slamio.Prefetcher";
  PrefetcherType.tp_basicsize = sizeof(Prefetcher);
  PrefetcherType.tp_flags = Py_TPFLAGS_DEFAULT;
  PrefetcherType.tp_doc = "Threaded decode-ahead frame loader";
  PrefetcherType.tp_new = Prefetcher_new;
  PrefetcherType.tp_init = Prefetcher_init;
  PrefetcherType.tp_dealloc = Prefetcher_dealloc;
  PrefetcherType.tp_methods = Prefetcher_methods;
  if (PyType_Ready(&PrefetcherType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&slamio_module);
  if (!m) return nullptr;
  Py_INCREF(&PrefetcherType);
  if (PyModule_AddObject(m, "Prefetcher",
                         reinterpret_cast<PyObject*>(&PrefetcherType)) < 0) {
    Py_DECREF(&PrefetcherType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
