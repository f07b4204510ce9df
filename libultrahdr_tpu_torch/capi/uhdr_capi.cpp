// C ABI shim of the PyTorch/CUDA port: implements ultrahdr_tpu.h (beside
// this file) by embedding CPython and dispatching into
// libultrahdr_tpu_torch.api through libultrahdr_tpu_torch.capi_bridge,
// which owns all numpy/layout marshaling.
//
// Mirrors the reference's stable C API behavior (ultrahdr_api.h:286-890,
// impl lib/src/ultrahdr_api.cpp): opaque handles, uhdr_error_info_t
// returns, getters that hand out pointers owned by the handle and valid
// until the next encode/decode/reset/release on it.  Every Python
// exception, a CUDA error raised during uhdr_encode / uhdr_decode among
// them, comes back as a non-OK uhdr_error_info_t with its detail.
//
// Built by `python -m libultrahdr_tpu_torch.capi.build` in two variants
// from this one source: linked against libpython, for stand-alone C
// programs; and without it, its Python symbols resolved from the process
// that loads it (ctypes.CDLL in a running interpreter; ctypes releases the
// GIL around each foreign call and every entry point takes it back with
// PyGILState_Ensure).  A stand-alone program's interpreter is initialized
// lazily on first use; PYTHONPATH must reach the repo root (or the
// installed package) and the site-packages that hold torch and numpy.

#include "ultrahdr_tpu.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <dlfcn.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Handle {
  PyObject* obj = nullptr;  // UhdrEncoder / UhdrDecoder
  bool is_encoder = false;
  // storage backing pointers handed to C (valid until next call family)
  std::string enc_stream;
  uhdr_compressed_image_t enc_stream_desc{};
  std::string exif, icc, base_img, gm_img;
  uhdr_mem_block_t exif_desc{}, icc_desc{}, base_desc{}, gm_desc{};
  uhdr_gainmap_metadata_t meta{};
  std::vector<std::string> dec_planes, gm_planes;
  uhdr_raw_image_t dec_img{}, gm_raw{};
};

PyObject* g_bridge = nullptr;
std::once_flag g_init_once;

// Initialize the embedded interpreter exactly once, import the bridge, and
// RELEASE the GIL before returning: the initializing thread would otherwise
// hold it forever while running C code, deadlocking every PyGILState_Ensure
// from other threads.  After this, all entry points acquire/release the GIL
// per call via PyGILState_Ensure, so the shim is usable from any thread —
// same contract as the reference C API.
//
// A host that loads this library with dlopen(RTLD_LOCAL) (a JVM loading the
// JNI binding) keeps libpython's symbols out of the global scope, where the
// extension modules that torch and numpy load look for them; libpython is
// made global before the interpreter starts.
void init_python_once() {
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Dl_info info;
    if (dladdr(reinterpret_cast<void*>(&Py_InitializeEx), &info) &&
        info.dli_fname)
      (void)dlopen(info.dli_fname, RTLD_NOW | RTLD_GLOBAL | RTLD_NOLOAD);
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE st = PyGILState_Ensure();
  g_bridge = PyImport_ImportModule("libultrahdr_tpu_torch.capi_bridge");
  if (!g_bridge) PyErr_Print();
  PyGILState_Release(st);
  if (we_initialized) {
    // Py_InitializeEx leaves the calling thread holding the GIL (its
    // PyGILState_Ensure above was a no-op recursion); hand it back.
    (void)PyEval_SaveThread();
  }
}

bool ensure_python() {
  std::call_once(g_init_once, init_python_once);
  return g_bridge != nullptr;
}

uhdr_error_info_t ok_status() {
  uhdr_error_info_t e;
  e.error_code = UHDR_CODEC_OK;
  e.has_detail = 0;
  e.detail[0] = 0;
  return e;
}

uhdr_error_info_t make_error(uhdr_codec_err_t code, const char* msg) {
  uhdr_error_info_t e;
  e.error_code = code;
  e.has_detail = msg && msg[0];
  std::snprintf(e.detail, sizeof(e.detail), "%s", msg ? msg : "");
  return e;
}

// Convert the pending Python exception into uhdr_error_info_t through
// bridge.error_tuple (maps UhdrError.code; anything else UNKNOWN_ERROR).
uhdr_error_info_t error_from_pyexc() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  uhdr_error_info_t e = make_error(UHDR_CODEC_UNKNOWN_ERROR, "python error");
  if (value && g_bridge) {
    PyObject* t = PyObject_CallMethod(g_bridge, "error_tuple", "(O)", value);
    if (t && PyTuple_Check(t) && PyTuple_Size(t) == 2) {
      long code = PyLong_AsLong(PyTuple_GetItem(t, 0));
      const char* d = PyUnicode_AsUTF8(PyTuple_GetItem(t, 1));
      e = make_error(static_cast<uhdr_codec_err_t>(code), d ? d : "");
    } else {
      PyErr_Clear();
    }
    Py_XDECREF(t);
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return e;
}

// Call a no-result method on the handle's Python object.
uhdr_error_info_t call_void(Handle* h, const char* name, const char* fmt,
                            ...) {
  if (!h || !h->obj) return make_error(UHDR_CODEC_INVALID_PARAM, "null handle");
  PyGILState_STATE st = PyGILState_Ensure();
  va_list va;
  va_start(va, fmt);
  PyObject* args = Py_VaBuildValue(fmt, va);
  va_end(va);
  uhdr_error_info_t e = ok_status();
  if (!args) {
    e = error_from_pyexc();
  } else {
    PyObject* m = PyObject_GetAttrString(h->obj, name);
    if (!m) {
      e = error_from_pyexc();
    } else {
      PyObject* r = PyObject_CallObject(m, args);
      if (!r) e = error_from_pyexc();
      Py_XDECREF(r);
      Py_DECREF(m);
    }
    Py_DECREF(args);
  }
  PyGILState_Release(st);
  return e;
}

// The torch device of every codec: UHDR_TPU_TORCH_DEVICE, a torch device
// string, or the card ("cuda") when it is unset or empty.  The ABI has no
// device argument; this is how a C caller asks for the CPU.
const char* device_name() {
  const char* d = std::getenv("UHDR_TPU_TORCH_DEVICE");
  return d && d[0] ? d : "cuda";
}

// bridge.<ctor>(device=device_name()); NULL, with the Python error printed
// (a UhdrError `unsupported` when the device has no implementation, such
// as "cuda" with no GPU), when the constructor raises.  The error is
// printed under the same thread state that raised it: a C thread's state
// ends with its PyGILState_Release, and the error with it.
Handle* new_handle(const char* ctor, bool is_enc) {
  if (!ensure_python()) return nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* obj = nullptr;
  PyObject* fn = PyObject_GetAttrString(g_bridge, ctor);
  PyObject* args = PyTuple_New(0);
  PyObject* kwargs = Py_BuildValue("{s:s}", "device", device_name());
  if (fn && args && kwargs) obj = PyObject_Call(fn, args, kwargs);
  Py_XDECREF(fn);
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  if (!obj) PyErr_Print();
  PyGILState_Release(st);
  if (!obj) return nullptr;
  Handle* h = new Handle();
  h->obj = obj;
  h->is_encoder = is_enc;
  return h;
}

void release_handle(Handle* h) {
  if (!h) return;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_XDECREF(h->obj);
  PyGILState_Release(st);
  delete h;
}

Handle* as_handle(uhdr_codec_private_t* p) {
  return reinterpret_cast<Handle*>(p);
}

// Fetch a bytes-returning getter into `store`; returns 1 if non-None.
int fetch_bytes(Handle* h, const char* name, std::string* store,
                uhdr_mem_block_t* desc) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(h->obj, name, nullptr);
  int got = 0;
  if (r && PyBytes_Check(r)) {
    store->assign(PyBytes_AsString(r), PyBytes_Size(r));
    desc->data = store->empty() ? nullptr : store->data();
    desc->data_sz = store->size();
    desc->capacity = store->size();
    got = 1;
  } else if (!r) {
    PyErr_Clear();
  }
  Py_XDECREF(r);
  PyGILState_Release(st);
  return got;
}

// Unpack a bridge _image_out tuple into (desc, plane storage).
int fetch_image(Handle* h, const char* bridge_fn, uhdr_raw_image_t* img,
                std::vector<std::string>* planes) {
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_bridge, bridge_fn, "(O)", h->obj);
  int got = 0;
  if (r && r != Py_None && PyTuple_Check(r) && PyTuple_Size(r) == 8) {
    img->fmt = static_cast<uhdr_img_fmt_t>(PyLong_AsLong(PyTuple_GetItem(r, 0)));
    img->cg = static_cast<uhdr_color_gamut_t>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
    img->ct = static_cast<uhdr_color_transfer_t>(PyLong_AsLong(PyTuple_GetItem(r, 2)));
    img->range = static_cast<uhdr_color_range_t>(PyLong_AsLong(PyTuple_GetItem(r, 3)));
    img->w = static_cast<unsigned>(PyLong_AsLong(PyTuple_GetItem(r, 4)));
    img->h = static_cast<unsigned>(PyLong_AsLong(PyTuple_GetItem(r, 5)));
    PyObject* pl = PyTuple_GetItem(r, 6);
    PyObject* sl = PyTuple_GetItem(r, 7);
    Py_ssize_t n = PyTuple_Size(pl);
    planes->assign(3, std::string());
    for (int i = 0; i < 3; i++) {
      img->planes[i] = nullptr;
      img->stride[i] = 0;
    }
    got = 1;
    for (Py_ssize_t i = 0; i < n && i < 3; i++) {
      PyObject* b = PyTuple_GetItem(pl, i);
      PyObject* s = PyTuple_GetItem(sl, i);
      if (!b || !PyBytes_Check(b) || !s || !PyLong_Check(s)) {
        got = 0;
        break;
      }
      (*planes)[i].assign(PyBytes_AsString(b), PyBytes_Size(b));
      img->planes[i] = (*planes)[i].data();
      img->stride[i] = static_cast<unsigned>(PyLong_AsLong(s));
    }
  } else if (!r) {
    PyErr_Clear();
  }
  Py_XDECREF(r);
  PyGILState_Release(st);
  return got;
}

}  // namespace

/* ---- encoder ---- */

extern "C" uhdr_codec_private_t* uhdr_create_encoder(void) {
  return reinterpret_cast<uhdr_codec_private_t*>(new_handle("enc_new", true));
}

extern "C" void uhdr_release_encoder(uhdr_codec_private_t* enc) {
  release_handle(as_handle(enc));
}

extern "C" uhdr_error_info_t uhdr_enc_set_raw_image(uhdr_codec_private_t* enc,
                                                    uhdr_raw_image_t* img,
                                                    uhdr_img_label_t intent) {
  Handle* h = as_handle(enc);
  if (!h || !img) return make_error(UHDR_CODEC_INVALID_PARAM, "null arg");
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(
      g_bridge, "enc_set_raw_image", "(Oiiiiii(KKK)(III)i)", h->obj,
      (int)img->fmt, (int)img->cg, (int)img->ct, (int)img->range,
      (int)img->w, (int)img->h,
      (unsigned long long)(uintptr_t)img->planes[0],
      (unsigned long long)(uintptr_t)img->planes[1],
      (unsigned long long)(uintptr_t)img->planes[2],
      img->stride[0], img->stride[1], img->stride[2], (int)intent);
  uhdr_error_info_t e = r ? ok_status() : error_from_pyexc();
  Py_XDECREF(r);
  PyGILState_Release(st);
  return e;
}

extern "C" uhdr_error_info_t uhdr_enc_set_compressed_image(
    uhdr_codec_private_t* enc, uhdr_compressed_image_t* img,
    uhdr_img_label_t intent) {
  Handle* h = as_handle(enc);
  if (!h || !img || !img->data)
    return make_error(UHDR_CODEC_INVALID_PARAM, "null arg");
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(
      g_bridge, "enc_set_compressed_image", "(Oy#iiii)", h->obj,
      (const char*)img->data, (Py_ssize_t)img->data_sz, (int)img->cg,
      (int)img->ct, (int)img->range, (int)intent);
  uhdr_error_info_t e = r ? ok_status() : error_from_pyexc();
  Py_XDECREF(r);
  PyGILState_Release(st);
  return e;
}

extern "C" uhdr_error_info_t uhdr_enc_set_gainmap_image(
    uhdr_codec_private_t* enc, uhdr_compressed_image_t* img,
    uhdr_gainmap_metadata_t* metadata) {
  Handle* h = as_handle(enc);
  if (!h || !img || !img->data || !metadata)
    return make_error(UHDR_CODEC_INVALID_PARAM, "null arg");
  const uhdr_gainmap_metadata_t* m = metadata;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(
      g_bridge, "enc_set_gainmap_image", "(Oy#iii(fffffffffffffffffi))",
      h->obj, (const char*)img->data, (Py_ssize_t)img->data_sz, (int)img->cg,
      (int)img->ct, (int)img->range, m->max_content_boost[0],
      m->max_content_boost[1], m->max_content_boost[2],
      m->min_content_boost[0], m->min_content_boost[1],
      m->min_content_boost[2], m->gamma[0], m->gamma[1], m->gamma[2],
      m->offset_sdr[0], m->offset_sdr[1], m->offset_sdr[2], m->offset_hdr[0],
      m->offset_hdr[1], m->offset_hdr[2], m->hdr_capacity_min,
      m->hdr_capacity_max, m->use_base_cg);
  uhdr_error_info_t e = r ? ok_status() : error_from_pyexc();
  Py_XDECREF(r);
  PyGILState_Release(st);
  return e;
}

extern "C" uhdr_error_info_t uhdr_enc_set_quality(uhdr_codec_private_t* enc,
                                                  int quality,
                                                  uhdr_img_label_t intent) {
  return call_void(as_handle(enc), "set_quality", "(ii)", quality,
                   (int)intent);
}

extern "C" uhdr_error_info_t uhdr_enc_set_exif_data(uhdr_codec_private_t* enc,
                                                    uhdr_mem_block_t* exif) {
  Handle* h = as_handle(enc);
  if (!h || !exif || !exif->data)
    return make_error(UHDR_CODEC_INVALID_PARAM, "null arg");
  return call_void(h, "set_exif_data", "(y#)", (const char*)exif->data,
                   (Py_ssize_t)exif->data_sz);
}

extern "C" uhdr_error_info_t uhdr_enc_set_using_multi_channel_gainmap(
    uhdr_codec_private_t* enc, int use) {
  return call_void(as_handle(enc), "set_using_multi_channel_gainmap", "(i)",
                   use);
}

extern "C" uhdr_error_info_t uhdr_enc_set_gainmap_scale_factor(
    uhdr_codec_private_t* enc, int factor) {
  return call_void(as_handle(enc), "set_gainmap_scale_factor", "(i)", factor);
}

extern "C" uhdr_error_info_t uhdr_enc_set_gainmap_gamma(
    uhdr_codec_private_t* enc, float gamma) {
  return call_void(as_handle(enc), "set_gainmap_gamma", "(f)", gamma);
}

extern "C" uhdr_error_info_t uhdr_enc_set_min_max_content_boost(
    uhdr_codec_private_t* enc, float min_boost, float max_boost) {
  return call_void(as_handle(enc), "set_min_max_content_boost", "(ff)",
                   min_boost, max_boost);
}

extern "C" uhdr_error_info_t uhdr_enc_set_target_display_peak_brightness(
    uhdr_codec_private_t* enc, float nits) {
  return call_void(as_handle(enc), "set_target_display_peak_brightness",
                   "(f)", nits);
}

extern "C" uhdr_error_info_t uhdr_enc_set_preset(uhdr_codec_private_t* enc,
                                                 uhdr_enc_preset_t preset) {
  return call_void(as_handle(enc), "set_preset", "(i)", (int)preset);
}

extern "C" uhdr_error_info_t uhdr_enc_set_output_format(
    uhdr_codec_private_t* enc, uhdr_codec_t media_type) {
  return call_void(as_handle(enc), "set_output_format", "(i)",
                   (int)media_type);
}

extern "C" uhdr_error_info_t uhdr_encode(uhdr_codec_private_t* enc) {
  return call_void(as_handle(enc), "encode", "()");
}

extern "C" uhdr_compressed_image_t* uhdr_get_encoded_stream(
    uhdr_codec_private_t* enc) {
  Handle* h = as_handle(enc);
  if (!h) return nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_bridge, "enc_get_stream", "(O)",
                                    h->obj);
  int got = 0;
  if (r && PyBytes_Check(r)) {
    h->enc_stream.assign(PyBytes_AsString(r), PyBytes_Size(r));
    h->enc_stream_desc.data = h->enc_stream.data();
    h->enc_stream_desc.data_sz = h->enc_stream.size();
    h->enc_stream_desc.capacity = h->enc_stream.size();
    h->enc_stream_desc.cg = UHDR_CG_UNSPECIFIED;
    h->enc_stream_desc.ct = UHDR_CT_UNSPECIFIED;
    h->enc_stream_desc.range = UHDR_CR_UNSPECIFIED;
    got = 1;
  } else if (!r) {
    PyErr_Clear();
  }
  Py_XDECREF(r);
  PyGILState_Release(st);
  return got ? &h->enc_stream_desc : nullptr;
}

extern "C" void uhdr_reset_encoder(uhdr_codec_private_t* enc) {
  call_void(as_handle(enc), "reset", "()");
}

/* ---- decoder ---- */

extern "C" int is_uhdr_image(void* data, int size) {
  if (!data || size <= 0 || !ensure_python()) return 0;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_bridge, "is_uhdr_image", "(y#)",
                                    (const char*)data, (Py_ssize_t)size);
  int v = r ? PyObject_IsTrue(r) : (PyErr_Clear(), 0);
  Py_XDECREF(r);
  PyGILState_Release(st);
  return v == 1;
}

extern "C" uhdr_codec_private_t* uhdr_create_decoder(void) {
  return reinterpret_cast<uhdr_codec_private_t*>(new_handle("dec_new", false));
}

extern "C" void uhdr_release_decoder(uhdr_codec_private_t* dec) {
  release_handle(as_handle(dec));
}

extern "C" uhdr_error_info_t uhdr_dec_set_image(uhdr_codec_private_t* dec,
                                                uhdr_compressed_image_t* img) {
  Handle* h = as_handle(dec);
  if (!h || !img || !img->data)
    return make_error(UHDR_CODEC_INVALID_PARAM, "null arg");
  return call_void(h, "set_image", "(y#)", (const char*)img->data,
                   (Py_ssize_t)img->data_sz);
}

extern "C" uhdr_error_info_t uhdr_dec_set_out_img_format(
    uhdr_codec_private_t* dec, uhdr_img_fmt_t fmt) {
  return call_void(as_handle(dec), "set_out_img_format", "(i)", (int)fmt);
}

extern "C" uhdr_error_info_t uhdr_dec_set_out_color_transfer(
    uhdr_codec_private_t* dec, uhdr_color_transfer_t ct) {
  return call_void(as_handle(dec), "set_out_color_transfer", "(i)", (int)ct);
}

extern "C" uhdr_error_info_t uhdr_dec_set_out_max_display_boost(
    uhdr_codec_private_t* dec, float display_boost) {
  return call_void(as_handle(dec), "set_out_max_display_boost", "(f)",
                   display_boost);
}

extern "C" uhdr_error_info_t uhdr_dec_probe(uhdr_codec_private_t* dec) {
  return call_void(as_handle(dec), "probe", "()");
}

static int int_getter(uhdr_codec_private_t* dec, const char* name) {
  Handle* h = as_handle(dec);
  if (!h) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(h->obj, name, nullptr);
  int v = -1;
  if (r && PyLong_Check(r)) v = (int)PyLong_AsLong(r);
  else PyErr_Clear();
  Py_XDECREF(r);
  PyGILState_Release(st);
  return v;
}

extern "C" int uhdr_dec_get_image_width(uhdr_codec_private_t* dec) {
  return int_getter(dec, "get_image_width");
}
extern "C" int uhdr_dec_get_image_height(uhdr_codec_private_t* dec) {
  return int_getter(dec, "get_image_height");
}
extern "C" int uhdr_dec_get_gainmap_width(uhdr_codec_private_t* dec) {
  return int_getter(dec, "get_gainmap_width");
}
extern "C" int uhdr_dec_get_gainmap_height(uhdr_codec_private_t* dec) {
  return int_getter(dec, "get_gainmap_height");
}

extern "C" uhdr_mem_block_t* uhdr_dec_get_exif(uhdr_codec_private_t* dec) {
  Handle* h = as_handle(dec);
  if (!h) return nullptr;
  return fetch_bytes(h, "get_exif", &h->exif, &h->exif_desc) ? &h->exif_desc
                                                             : nullptr;
}
extern "C" uhdr_mem_block_t* uhdr_dec_get_icc(uhdr_codec_private_t* dec) {
  Handle* h = as_handle(dec);
  if (!h) return nullptr;
  return fetch_bytes(h, "get_icc", &h->icc, &h->icc_desc) ? &h->icc_desc
                                                          : nullptr;
}
extern "C" uhdr_mem_block_t* uhdr_dec_get_base_image(
    uhdr_codec_private_t* dec) {
  Handle* h = as_handle(dec);
  if (!h) return nullptr;
  return fetch_bytes(h, "get_base_image", &h->base_img, &h->base_desc)
             ? &h->base_desc
             : nullptr;
}
extern "C" uhdr_mem_block_t* uhdr_dec_get_gainmap_image(
    uhdr_codec_private_t* dec) {
  Handle* h = as_handle(dec);
  if (!h) return nullptr;
  return fetch_bytes(h, "get_gainmap_image", &h->gm_img, &h->gm_desc)
             ? &h->gm_desc
             : nullptr;
}

extern "C" uhdr_gainmap_metadata_t* uhdr_dec_get_gainmap_metadata(
    uhdr_codec_private_t* dec) {
  Handle* h = as_handle(dec);
  if (!h) return nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* r = PyObject_CallMethod(g_bridge, "dec_get_gainmap_metadata_flat",
                                    "(O)", h->obj);
  int got = 0;
  if (r && PyTuple_Check(r) && PyTuple_Size(r) == 18) {
    float v[17];
    for (int i = 0; i < 17; i++)
      v[i] = (float)PyFloat_AsDouble(PyTuple_GetItem(r, i));
    for (int i = 0; i < 3; i++) {
      h->meta.max_content_boost[i] = v[i];
      h->meta.min_content_boost[i] = v[3 + i];
      h->meta.gamma[i] = v[6 + i];
      h->meta.offset_sdr[i] = v[9 + i];
      h->meta.offset_hdr[i] = v[12 + i];
    }
    h->meta.hdr_capacity_min = v[15];
    h->meta.hdr_capacity_max = v[16];
    h->meta.use_base_cg = (int)PyLong_AsLong(PyTuple_GetItem(r, 17));
    got = 1;
  } else if (!r) {
    PyErr_Clear();
  }
  Py_XDECREF(r);
  PyGILState_Release(st);
  return got ? &h->meta : nullptr;
}

extern "C" uhdr_error_info_t uhdr_decode(uhdr_codec_private_t* dec) {
  return call_void(as_handle(dec), "decode", "()");
}

extern "C" uhdr_raw_image_t* uhdr_get_decoded_image(
    uhdr_codec_private_t* dec) {
  Handle* h = as_handle(dec);
  if (!h) return nullptr;
  return fetch_image(h, "dec_get_decoded_image", &h->dec_img, &h->dec_planes)
             ? &h->dec_img
             : nullptr;
}

extern "C" uhdr_raw_image_t* uhdr_get_decoded_gainmap_image(
    uhdr_codec_private_t* dec) {
  Handle* h = as_handle(dec);
  if (!h) return nullptr;
  return fetch_image(h, "dec_get_gainmap_image_raw", &h->gm_raw,
                     &h->gm_planes)
             ? &h->gm_raw
             : nullptr;
}

extern "C" void uhdr_reset_decoder(uhdr_codec_private_t* dec) {
  call_void(as_handle(dec), "reset", "()");
}

/* ---- effects + misc ---- */

extern "C" uhdr_error_info_t uhdr_enable_gpu_acceleration(
    uhdr_codec_private_t* codec, int enable) {
  return call_void(as_handle(codec), "enable_gpu_acceleration", "(i)",
                   enable);
}

extern "C" uhdr_error_info_t uhdr_add_effect_mirror(
    uhdr_codec_private_t* codec, uhdr_mirror_direction_t direction) {
  return call_void(as_handle(codec), "add_effect_mirror", "(i)",
                   (int)direction);
}

extern "C" uhdr_error_info_t uhdr_add_effect_rotate(
    uhdr_codec_private_t* codec, int degrees) {
  return call_void(as_handle(codec), "add_effect_rotate", "(i)", degrees);
}

extern "C" uhdr_error_info_t uhdr_add_effect_crop(uhdr_codec_private_t* codec,
                                                  int left, int right, int top,
                                                  int bottom) {
  return call_void(as_handle(codec), "add_effect_crop", "(iiii)", left, right,
                   top, bottom);
}

extern "C" uhdr_error_info_t uhdr_add_effect_resize(
    uhdr_codec_private_t* codec, int width, int height) {
  return call_void(as_handle(codec), "add_effect_resize", "(ii)", width,
                   height);
}
