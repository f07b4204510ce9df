// JNI shim of the PyTorch/CUDA port's Java binding.
//
// Bridges com.google.media.codecs.ultrahdr.{UltraHDRCommon,UltraHDREncoder,
// UltraHDRDecoder} onto the port's C ABI, ultrahdr_tpu.h of
// libultrahdr_tpu_torch/capi (the reference's Java binding plays the same
// role over ultrahdr_api.h, java/jni/ultrahdr-jni.cpp).  Each Java native
// method is a distinctly-named export (the Java classes avoid overloading
// natives, so no JNI signature mangling is needed) that:
//   1. reads the instance's `handle` (jlong) field -> uhdr_codec_private_t*,
//   2. pins the Java arrays, fills the C structs, calls the C API,
//   3. converts a non-OK uhdr_error_info_t into a thrown java.io.IOException
//      carrying the detail string.
//
// Build: python -m libultrahdr_tpu_torch.java.build (a JDK for the real
// jni.h; --syntax-only and --link-stub need none).

#include <jni.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "ultrahdr_tpu.h"

namespace {

void throw_io(JNIEnv* env, const char* msg) {
  jclass cls = env->FindClass("java/io/IOException");
  if (cls) env->ThrowNew(cls, msg && msg[0] ? msg : "unknown error");
}

// Returns true when err is OK; otherwise throws IOException and returns
// false so the caller can bail out.
bool check(JNIEnv* env, const uhdr_error_info_t& err) {
  if (err.error_code == UHDR_CODEC_OK) return true;
  throw_io(env, err.has_detail ? err.detail : "codec call failed");
  return false;
}

uhdr_codec_private_t* get_handle(JNIEnv* env, jobject thiz) {
  jclass cls = env->GetObjectClass(thiz);
  if (!cls) return nullptr;
  jfieldID fid = env->GetFieldID(cls, "handle", "J");
  if (!fid) return nullptr;
  jlong h = env->GetLongField(thiz, fid);
  if (!h) {
    throw_io(env, "codec instance not initialized (handle is null)");
    return nullptr;
  }
  return reinterpret_cast<uhdr_codec_private_t*>(static_cast<intptr_t>(h));
}

void set_handle(JNIEnv* env, jobject thiz, uhdr_codec_private_t* p) {
  jclass cls = env->GetObjectClass(thiz);
  if (!cls) return;
  jfieldID fid = env->GetFieldID(cls, "handle", "J");
  if (!fid) return;
  env->SetLongField(thiz, fid,
                    static_cast<jlong>(reinterpret_cast<intptr_t>(p)));
}

void set_int_field(JNIEnv* env, jobject thiz, const char* name, jint v) {
  jclass cls = env->GetObjectClass(thiz);
  if (!cls) return;
  jfieldID fid = env->GetFieldID(cls, name, "I");
  if (fid) env->SetIntField(thiz, fid, v);
}

jbyteArray bytes_to_jarray(JNIEnv* env, const void* data, size_t n) {
  jbyteArray out = env->NewByteArray(static_cast<jsize>(n));
  if (out && n) {
    env->SetByteArrayRegion(out, 0, static_cast<jsize>(n),
                            reinterpret_cast<const jbyte*>(data));
  }
  return out;
}

jbyteArray mem_block_to_jarray(JNIEnv* env, uhdr_mem_block_t* blk) {
  if (!blk || !blk->data || !blk->data_sz) return nullptr;
  return bytes_to_jarray(env, blk->data, blk->data_sz);
}

size_t bytes_per_pixel(uhdr_img_fmt_t fmt) {
  switch (fmt) {
    case UHDR_IMG_FMT_64bppRGBAHalfFloat:
      return 8;
    case UHDR_IMG_FMT_32bppRGBA8888:
    case UHDR_IMG_FMT_32bppRGBA1010102:
      return 4;
    case UHDR_IMG_FMT_24bppRGB888:
      return 3;
    default:
      return 1;
  }
}

}  // namespace

/* ======================= UltraHDRCommon ======================= */

extern "C" JNIEXPORT jstring JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRCommon_getVersionStringNative(
    JNIEnv* env, jclass) {
  return env->NewStringUTF(UHDR_LIB_VERSION_STR);
}

extern "C" JNIEXPORT jint JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRCommon_getVersionNative(JNIEnv*,
                                                                      jclass) {
  return UHDR_LIB_VERSION;
}

/* ======================= UltraHDREncoder ======================= */

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_init(JNIEnv* env,
                                                           jobject thiz) {
  uhdr_codec_private_t* enc = uhdr_create_encoder();
  if (!enc) {
    throw_io(env, "failed to create encoder instance");
    return;
  }
  set_handle(env, thiz, enc);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_destroy(JNIEnv* env,
                                                              jobject thiz) {
  jclass cls = env->GetObjectClass(thiz);
  jfieldID fid = cls ? env->GetFieldID(cls, "handle", "J") : nullptr;
  if (!fid) return;
  jlong h = env->GetLongField(thiz, fid);
  if (h) {
    uhdr_release_encoder(
        reinterpret_cast<uhdr_codec_private_t*>(static_cast<intptr_t>(h)));
    env->SetLongField(thiz, fid, 0);
  }
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setRawImageNativeInt(
    JNIEnv* env, jobject thiz, jintArray rgb, jint w, jint h, jint stride,
    jint cg, jint ct, jint range, jint fmt, jint intent) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  jsize n = env->GetArrayLength(rgb);
  if (static_cast<long long>(stride) * h > n) {
    throw_io(env, "image buffer smaller than stride * height");
    return;
  }
  jint* buf = env->GetIntArrayElements(rgb, nullptr);
  if (!buf) return;
  uhdr_raw_image_t img{};
  img.fmt = static_cast<uhdr_img_fmt_t>(fmt);
  img.cg = static_cast<uhdr_color_gamut_t>(cg);
  img.ct = static_cast<uhdr_color_transfer_t>(ct);
  img.range = static_cast<uhdr_color_range_t>(range);
  img.w = static_cast<unsigned>(w);
  img.h = static_cast<unsigned>(h);
  img.planes[UHDR_PLANE_PACKED] = buf;
  img.stride[UHDR_PLANE_PACKED] = static_cast<unsigned>(stride);
  uhdr_error_info_t err = uhdr_enc_set_raw_image(
      enc, &img, static_cast<uhdr_img_label_t>(intent));
  env->ReleaseIntArrayElements(rgb, buf, JNI_ABORT);
  check(env, err);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setRawImageNativeLong(
    JNIEnv* env, jobject thiz, jlongArray rgb, jint w, jint h, jint stride,
    jint cg, jint ct, jint range, jint fmt, jint intent) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  jsize n = env->GetArrayLength(rgb);
  if (static_cast<long long>(stride) * h > n) {
    throw_io(env, "image buffer smaller than stride * height");
    return;
  }
  jlong* buf = env->GetLongArrayElements(rgb, nullptr);
  if (!buf) return;
  uhdr_raw_image_t img{};
  img.fmt = static_cast<uhdr_img_fmt_t>(fmt);
  img.cg = static_cast<uhdr_color_gamut_t>(cg);
  img.ct = static_cast<uhdr_color_transfer_t>(ct);
  img.range = static_cast<uhdr_color_range_t>(range);
  img.w = static_cast<unsigned>(w);
  img.h = static_cast<unsigned>(h);
  img.planes[UHDR_PLANE_PACKED] = buf;
  img.stride[UHDR_PLANE_PACKED] = static_cast<unsigned>(stride);
  uhdr_error_info_t err = uhdr_enc_set_raw_image(
      enc, &img, static_cast<uhdr_img_label_t>(intent));
  env->ReleaseLongArrayElements(rgb, buf, JNI_ABORT);
  check(env, err);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setRawImageNativeP010(
    JNIEnv* env, jobject thiz, jshortArray y, jshortArray uv, jint w, jint h,
    jint y_stride, jint uv_stride, jint cg, jint ct, jint range, jint fmt,
    jint intent) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  if (static_cast<long long>(y_stride) * h > env->GetArrayLength(y) ||
      static_cast<long long>(uv_stride) * (h / 2) > env->GetArrayLength(uv)) {
    throw_io(env, "plane buffer smaller than stride * rows");
    return;
  }
  jshort* yb = env->GetShortArrayElements(y, nullptr);
  if (!yb) return;
  jshort* uvb = env->GetShortArrayElements(uv, nullptr);
  if (!uvb) {
    env->ReleaseShortArrayElements(y, yb, JNI_ABORT);
    return;
  }
  uhdr_raw_image_t img{};
  img.fmt = static_cast<uhdr_img_fmt_t>(fmt);
  img.cg = static_cast<uhdr_color_gamut_t>(cg);
  img.ct = static_cast<uhdr_color_transfer_t>(ct);
  img.range = static_cast<uhdr_color_range_t>(range);
  img.w = static_cast<unsigned>(w);
  img.h = static_cast<unsigned>(h);
  img.planes[UHDR_PLANE_Y] = yb;
  img.planes[UHDR_PLANE_UV] = uvb;
  img.stride[UHDR_PLANE_Y] = static_cast<unsigned>(y_stride);
  img.stride[UHDR_PLANE_UV] = static_cast<unsigned>(uv_stride);
  uhdr_error_info_t err = uhdr_enc_set_raw_image(
      enc, &img, static_cast<uhdr_img_label_t>(intent));
  env->ReleaseShortArrayElements(uv, uvb, JNI_ABORT);
  env->ReleaseShortArrayElements(y, yb, JNI_ABORT);
  check(env, err);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setRawImageNativeYuv420(
    JNIEnv* env, jobject thiz, jbyteArray y, jbyteArray u, jbyteArray v,
    jint w, jint h, jint y_stride, jint u_stride, jint v_stride, jint cg,
    jint ct, jint range, jint fmt, jint intent) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  if (static_cast<long long>(y_stride) * h > env->GetArrayLength(y) ||
      static_cast<long long>(u_stride) * (h / 2) > env->GetArrayLength(u) ||
      static_cast<long long>(v_stride) * (h / 2) > env->GetArrayLength(v)) {
    throw_io(env, "plane buffer smaller than stride * rows");
    return;
  }
  jbyte* yb = env->GetByteArrayElements(y, nullptr);
  jbyte* ub = yb ? env->GetByteArrayElements(u, nullptr) : nullptr;
  jbyte* vb = ub ? env->GetByteArrayElements(v, nullptr) : nullptr;
  if (!vb) {
    if (ub) env->ReleaseByteArrayElements(u, ub, JNI_ABORT);
    if (yb) env->ReleaseByteArrayElements(y, yb, JNI_ABORT);
    return;
  }
  uhdr_raw_image_t img{};
  img.fmt = static_cast<uhdr_img_fmt_t>(fmt);
  img.cg = static_cast<uhdr_color_gamut_t>(cg);
  img.ct = static_cast<uhdr_color_transfer_t>(ct);
  img.range = static_cast<uhdr_color_range_t>(range);
  img.w = static_cast<unsigned>(w);
  img.h = static_cast<unsigned>(h);
  img.planes[UHDR_PLANE_Y] = yb;
  img.planes[UHDR_PLANE_U] = ub;
  img.planes[UHDR_PLANE_V] = vb;
  img.stride[UHDR_PLANE_Y] = static_cast<unsigned>(y_stride);
  img.stride[UHDR_PLANE_U] = static_cast<unsigned>(u_stride);
  img.stride[UHDR_PLANE_V] = static_cast<unsigned>(v_stride);
  uhdr_error_info_t err = uhdr_enc_set_raw_image(
      enc, &img, static_cast<uhdr_img_label_t>(intent));
  env->ReleaseByteArrayElements(v, vb, JNI_ABORT);
  env->ReleaseByteArrayElements(u, ub, JNI_ABORT);
  env->ReleaseByteArrayElements(y, yb, JNI_ABORT);
  check(env, err);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setCompressedImageNative(
    JNIEnv* env, jobject thiz, jbyteArray data, jint size, jint cg, jint ct,
    jint range, jint intent) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  if (size > env->GetArrayLength(data)) {
    throw_io(env, "size exceeds buffer length");
    return;
  }
  jbyte* buf = env->GetByteArrayElements(data, nullptr);
  if (!buf) return;
  uhdr_compressed_image_t img{};
  img.data = buf;
  img.data_sz = static_cast<size_t>(size);
  img.capacity = static_cast<size_t>(size);
  img.cg = static_cast<uhdr_color_gamut_t>(cg);
  img.ct = static_cast<uhdr_color_transfer_t>(ct);
  img.range = static_cast<uhdr_color_range_t>(range);
  uhdr_error_info_t err = uhdr_enc_set_compressed_image(
      enc, &img, static_cast<uhdr_img_label_t>(intent));
  env->ReleaseByteArrayElements(data, buf, JNI_ABORT);
  check(env, err);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setGainMapImageInfoNative(
    JNIEnv* env, jobject thiz, jbyteArray data, jint size,
    jfloatArray max_boost, jfloatArray min_boost, jfloatArray gamma,
    jfloatArray offset_sdr, jfloatArray offset_hdr, jfloat cap_min,
    jfloat cap_max, jboolean use_base_cg) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  if (size > env->GetArrayLength(data)) {
    throw_io(env, "size exceeds buffer length");
    return;
  }
  uhdr_gainmap_metadata_t meta{};
  env->GetFloatArrayRegion(max_boost, 0, 3, meta.max_content_boost);
  env->GetFloatArrayRegion(min_boost, 0, 3, meta.min_content_boost);
  env->GetFloatArrayRegion(gamma, 0, 3, meta.gamma);
  env->GetFloatArrayRegion(offset_sdr, 0, 3, meta.offset_sdr);
  env->GetFloatArrayRegion(offset_hdr, 0, 3, meta.offset_hdr);
  if (env->ExceptionCheck()) return;
  meta.hdr_capacity_min = cap_min;
  meta.hdr_capacity_max = cap_max;
  meta.use_base_cg = use_base_cg ? 1 : 0;
  jbyte* buf = env->GetByteArrayElements(data, nullptr);
  if (!buf) return;
  uhdr_compressed_image_t img{};
  img.data = buf;
  img.data_sz = static_cast<size_t>(size);
  img.capacity = static_cast<size_t>(size);
  img.cg = UHDR_CG_UNSPECIFIED;
  img.ct = UHDR_CT_UNSPECIFIED;
  img.range = UHDR_CR_UNSPECIFIED;
  uhdr_error_info_t err = uhdr_enc_set_gainmap_image(enc, &img, &meta);
  env->ReleaseByteArrayElements(data, buf, JNI_ABORT);
  check(env, err);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setExifDataNative(
    JNIEnv* env, jobject thiz, jbyteArray data, jint size) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  if (size > env->GetArrayLength(data)) {
    throw_io(env, "size exceeds buffer length");
    return;
  }
  jbyte* buf = env->GetByteArrayElements(data, nullptr);
  if (!buf) return;
  uhdr_mem_block_t blk{buf, static_cast<size_t>(size),
                       static_cast<size_t>(size)};
  uhdr_error_info_t err = uhdr_enc_set_exif_data(enc, &blk);
  env->ReleaseByteArrayElements(data, buf, JNI_ABORT);
  check(env, err);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setQualityFactorNative(
    JNIEnv* env, jobject thiz, jint quality, jint intent) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_enc_set_quality(enc, quality,
                                  static_cast<uhdr_img_label_t>(intent)));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setMultiChannelGainMapEncodingNative(
    JNIEnv* env, jobject thiz, jboolean enable) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_enc_set_using_multi_channel_gainmap(enc, enable ? 1 : 0));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setGainMapScaleFactorNative(
    JNIEnv* env, jobject thiz, jint factor) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_enc_set_gainmap_scale_factor(enc, factor));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setGainMapGammaNative(
    JNIEnv* env, jobject thiz, jfloat gamma) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_enc_set_gainmap_gamma(enc, gamma));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setEncPresetNative(
    JNIEnv* env, jobject thiz, jint preset) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_enc_set_preset(enc, static_cast<uhdr_enc_preset_t>(preset)));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setOutputFormatNative(
    JNIEnv* env, jobject thiz, jint media_type) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_enc_set_output_format(
                 enc, static_cast<uhdr_codec_t>(media_type)));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setMinMaxContentBoostNative(
    JNIEnv* env, jobject thiz, jfloat min_boost, jfloat max_boost) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_enc_set_min_max_content_boost(enc, min_boost, max_boost));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_setTargetDisplayPeakBrightnessNative(
    JNIEnv* env, jobject thiz, jfloat nits) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_enc_set_target_display_peak_brightness(enc, nits));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_encodeNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  check(env, uhdr_encode(enc));
}

extern "C" JNIEXPORT jbyteArray JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_getOutputNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return nullptr;
  uhdr_compressed_image_t* out = uhdr_get_encoded_stream(enc);
  if (!out || !out->data || !out->data_sz) {
    throw_io(env, "no encoded output; call encode() first");
    return nullptr;
  }
  return bytes_to_jarray(env, out->data, out->data_sz);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDREncoder_resetNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* enc = get_handle(env, thiz);
  if (!enc) return;
  uhdr_reset_encoder(enc);
}

/* ======================= UltraHDRDecoder ======================= */

extern "C" JNIEXPORT jint JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_isUHDRImageNative(
    JNIEnv* env, jclass, jbyteArray data, jint size) {
  if (size > env->GetArrayLength(data)) {
    throw_io(env, "size exceeds buffer length");
    return 0;
  }
  jbyte* buf = env->GetByteArrayElements(data, nullptr);
  if (!buf) return 0;
  int v = is_uhdr_image(buf, size);
  env->ReleaseByteArrayElements(data, buf, JNI_ABORT);
  return v;
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_init(JNIEnv* env,
                                                           jobject thiz) {
  uhdr_codec_private_t* dec = uhdr_create_decoder();
  if (!dec) {
    throw_io(env, "failed to create decoder instance");
    return;
  }
  set_handle(env, thiz, dec);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_destroy(JNIEnv* env,
                                                              jobject thiz) {
  jclass cls = env->GetObjectClass(thiz);
  jfieldID fid = cls ? env->GetFieldID(cls, "handle", "J") : nullptr;
  if (!fid) return;
  jlong h = env->GetLongField(thiz, fid);
  if (h) {
    uhdr_release_decoder(
        reinterpret_cast<uhdr_codec_private_t*>(static_cast<intptr_t>(h)));
    env->SetLongField(thiz, fid, 0);
  }
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_setCompressedImageNative(
    JNIEnv* env, jobject thiz, jbyteArray data, jint size, jint cg, jint ct,
    jint range) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return;
  if (size > env->GetArrayLength(data)) {
    throw_io(env, "size exceeds buffer length");
    return;
  }
  jbyte* buf = env->GetByteArrayElements(data, nullptr);
  if (!buf) return;
  uhdr_compressed_image_t img{};
  img.data = buf;
  img.data_sz = static_cast<size_t>(size);
  img.capacity = static_cast<size_t>(size);
  img.cg = static_cast<uhdr_color_gamut_t>(cg);
  img.ct = static_cast<uhdr_color_transfer_t>(ct);
  img.range = static_cast<uhdr_color_range_t>(range);
  uhdr_error_info_t err = uhdr_dec_set_image(dec, &img);
  env->ReleaseByteArrayElements(data, buf, JNI_ABORT);
  check(env, err);
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_setOutputFormatNative(
    JNIEnv* env, jobject thiz, jint fmt) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return;
  check(env,
        uhdr_dec_set_out_img_format(dec, static_cast<uhdr_img_fmt_t>(fmt)));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_setColorTransferNative(
    JNIEnv* env, jobject thiz, jint ct) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return;
  check(env, uhdr_dec_set_out_color_transfer(
                 dec, static_cast<uhdr_color_transfer_t>(ct)));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_setMaxDisplayBoostNative(
    JNIEnv* env, jobject thiz, jfloat boost) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return;
  check(env, uhdr_dec_set_out_max_display_boost(dec, boost));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_enableGpuAccelerationNative(
    JNIEnv* env, jobject thiz, jint enable) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return;
  check(env, uhdr_enable_gpu_acceleration(dec, enable));
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_probeNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return;
  check(env, uhdr_dec_probe(dec));
}

extern "C" JNIEXPORT jint JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getImageWidthNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  return dec ? uhdr_dec_get_image_width(dec) : -1;
}

extern "C" JNIEXPORT jint JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getImageHeightNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  return dec ? uhdr_dec_get_image_height(dec) : -1;
}

extern "C" JNIEXPORT jint JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getGainMapWidthNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  return dec ? uhdr_dec_get_gainmap_width(dec) : -1;
}

extern "C" JNIEXPORT jint JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getGainMapHeightNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  return dec ? uhdr_dec_get_gainmap_height(dec) : -1;
}

extern "C" JNIEXPORT jbyteArray JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getExifNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  return dec ? mem_block_to_jarray(env, uhdr_dec_get_exif(dec)) : nullptr;
}

extern "C" JNIEXPORT jbyteArray JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getIccNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  return dec ? mem_block_to_jarray(env, uhdr_dec_get_icc(dec)) : nullptr;
}

extern "C" JNIEXPORT jbyteArray JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getBaseImageNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  return dec ? mem_block_to_jarray(env, uhdr_dec_get_base_image(dec))
             : nullptr;
}

extern "C" JNIEXPORT jbyteArray JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getGainMapImageNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  return dec ? mem_block_to_jarray(env, uhdr_dec_get_gainmap_image(dec))
             : nullptr;
}

extern "C" JNIEXPORT jfloatArray JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getGainmapMetadataNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return nullptr;
  uhdr_gainmap_metadata_t* m = uhdr_dec_get_gainmap_metadata(dec);
  if (!m) {
    throw_io(env, "gainmap metadata unavailable; call probe() first");
    return nullptr;
  }
  float flat[18];
  std::memcpy(flat + 0, m->max_content_boost, 3 * sizeof(float));
  std::memcpy(flat + 3, m->min_content_boost, 3 * sizeof(float));
  std::memcpy(flat + 6, m->gamma, 3 * sizeof(float));
  std::memcpy(flat + 9, m->offset_sdr, 3 * sizeof(float));
  std::memcpy(flat + 12, m->offset_hdr, 3 * sizeof(float));
  flat[15] = m->hdr_capacity_min;
  flat[16] = m->hdr_capacity_max;
  flat[17] = m->use_base_cg ? 1.0f : 0.0f;
  jfloatArray out = env->NewFloatArray(18);
  if (out) env->SetFloatArrayRegion(out, 0, 18, flat);
  return out;
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_decodeNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return;
  check(env, uhdr_decode(dec));
}

extern "C" JNIEXPORT jbyteArray JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getDecodedImageNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return nullptr;
  uhdr_raw_image_t* img = uhdr_get_decoded_image(dec);
  if (!img || !img->planes[0]) {
    throw_io(env, "no decoded image; call decode() first");
    return nullptr;
  }
  size_t bpp = bytes_per_pixel(img->fmt);
  size_t n = static_cast<size_t>(img->stride[0]) * img->h * bpp;
  jbyteArray out = bytes_to_jarray(env, img->planes[0], n);
  set_int_field(env, thiz, "imgWidth", static_cast<jint>(img->w));
  set_int_field(env, thiz, "imgHeight", static_cast<jint>(img->h));
  set_int_field(env, thiz, "imgStride", static_cast<jint>(img->stride[0]));
  set_int_field(env, thiz, "imgFormat", img->fmt);
  set_int_field(env, thiz, "imgGamut", img->cg);
  set_int_field(env, thiz, "imgTransfer", img->ct);
  set_int_field(env, thiz, "imgRange", img->range);
  return out;
}

extern "C" JNIEXPORT jbyteArray JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_getDecodedGainMapImageNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return nullptr;
  uhdr_raw_image_t* img = uhdr_get_decoded_gainmap_image(dec);
  if (!img || !img->planes[0]) {
    throw_io(env, "no decoded gain map; call decode() first");
    return nullptr;
  }
  jbyteArray out;
  int fmt = img->fmt;
  unsigned stride = img->stride[0];
  if (img->fmt == UHDR_IMG_FMT_24bppRGB888) {
    // the reference binding surfaces multi-channel gain maps as packed
    // RGBA8888 (UltraHDRDecoder.java:447-456); expand 3 -> 4 channels
    const uint8_t* src = static_cast<const uint8_t*>(img->planes[0]);
    size_t px = static_cast<size_t>(img->stride[0]) * img->h;
    std::vector<uint8_t> rgba(px * 4);
    for (size_t i = 0; i < px; i++) {
      rgba[4 * i + 0] = src[3 * i + 0];
      rgba[4 * i + 1] = src[3 * i + 1];
      rgba[4 * i + 2] = src[3 * i + 2];
      rgba[4 * i + 3] = 0xFF;
    }
    out = bytes_to_jarray(env, rgba.data(), rgba.size());
    fmt = UHDR_IMG_FMT_32bppRGBA8888;
  } else {
    size_t n = static_cast<size_t>(img->stride[0]) * img->h *
               bytes_per_pixel(img->fmt);
    out = bytes_to_jarray(env, img->planes[0], n);
  }
  set_int_field(env, thiz, "gainmapWidth", static_cast<jint>(img->w));
  set_int_field(env, thiz, "gainmapHeight", static_cast<jint>(img->h));
  set_int_field(env, thiz, "gainmapStride", static_cast<jint>(stride));
  set_int_field(env, thiz, "gainmapFormat", fmt);
  return out;
}

extern "C" JNIEXPORT void JNICALL
Java_com_google_media_codecs_ultrahdr_UltraHDRDecoder_resetNative(
    JNIEnv* env, jobject thiz) {
  uhdr_codec_private_t* dec = get_handle(env, thiz);
  if (!dec) return;
  uhdr_reset_decoder(dec);
}
