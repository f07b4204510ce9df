/*
 * ultrahdr_tpu.h — C ABI of the PyTorch/CUDA port (libultrahdr_tpu_torch).
 *
 * The same ABI as the JAX package's C ABI, which mirrors the reference
 * library's stable C API surface (ultrahdr_api.h:85-890): the enum values,
 * struct layouts and function names/signatures match, so a C program
 * written against libuhdr's walkthrough compiles and links against this
 * build unchanged.  The implementation dispatches into the port's engine
 * (libultrahdr_tpu_torch.api, through libultrahdr_tpu_torch.capi_bridge)
 * in an embedded CPython interpreter (uhdr_capi.cpp beside this header).
 *
 * The ABI has no device argument.  Every codec runs on the card (torch
 * device "cuda") unless the environment variable UHDR_TPU_TORCH_DEVICE
 * names another torch device string (for example "cpu"); with no usable
 * GPU and the variable unset, uhdr_create_encoder() and
 * uhdr_create_decoder() return NULL and print the error: nothing falls
 * back to the CPU.
 *
 * Differences from the reference, by design:
 *   - uhdr_enable_gpu_acceleration(codec, 0) takes the port's general path
 *     (the host entropy coder and decoder, the pixel stages still on the
 *     codec's device); 1, the default, the fused path.
 *   - UHDR_CODEC_HEIF / UHDR_CODEC_AVIF are validated but unsupported, as
 *     in the reference (ultrahdr_api.cpp uhdr_enc_set_output_format).
 */

#ifndef ULTRAHDR_TPU_H
#define ULTRAHDR_TPU_H

#include <stddef.h>

#ifdef __cplusplus
#define UHDR_EXTERN extern "C"
#else
#define UHDR_EXTERN extern
#endif

/* ---- version (mirrors ultrahdr_api.h:74-84; tracks the reference API
   surface this build implements) ---- */

#define UHDR_LIB_VER_MAJOR 1
#define UHDR_LIB_VER_MINOR 4
#define UHDR_LIB_VER_PATCH 0

#define UHDR_LIB_VERSION \
  ((UHDR_LIB_VER_MAJOR * 10000) + (UHDR_LIB_VER_MINOR * 100) + UHDR_LIB_VER_PATCH)

#define UHDR_XSTR(s) UHDR_STR(s)
#define UHDR_STR(s) #s
#define UHDR_LIB_VERSION_STR \
  UHDR_XSTR(UHDR_LIB_VER_MAJOR) "." UHDR_XSTR(UHDR_LIB_VER_MINOR) "." UHDR_XSTR(UHDR_LIB_VER_PATCH)

/* ---- enums (values match ultrahdr_api.h:85-198) ---- */

typedef enum uhdr_img_fmt {
  UHDR_IMG_FMT_UNSPECIFIED = -1,
  UHDR_IMG_FMT_24bppYCbCrP010 = 0,
  UHDR_IMG_FMT_12bppYCbCr420 = 1,
  UHDR_IMG_FMT_8bppYCbCr400 = 2,
  UHDR_IMG_FMT_32bppRGBA8888 = 3,
  UHDR_IMG_FMT_64bppRGBAHalfFloat = 4,
  UHDR_IMG_FMT_32bppRGBA1010102 = 5,
  UHDR_IMG_FMT_24bppYCbCr444 = 6,
  UHDR_IMG_FMT_16bppYCbCr422 = 7,
  UHDR_IMG_FMT_16bppYCbCr440 = 8,
  UHDR_IMG_FMT_12bppYCbCr411 = 9,
  UHDR_IMG_FMT_10bppYCbCr410 = 10,
  UHDR_IMG_FMT_24bppRGB888 = 11,
  UHDR_IMG_FMT_30bppYCbCr444 = 12,
} uhdr_img_fmt_t;

typedef enum uhdr_color_gamut {
  UHDR_CG_UNSPECIFIED = -1,
  UHDR_CG_BT_709 = 0,
  UHDR_CG_DISPLAY_P3 = 1,
  UHDR_CG_BT_2100 = 2,
} uhdr_color_gamut_t;

typedef enum uhdr_color_transfer {
  UHDR_CT_UNSPECIFIED = -1,
  UHDR_CT_LINEAR = 0,
  UHDR_CT_HLG = 1,
  UHDR_CT_PQ = 2,
  UHDR_CT_SRGB = 3,
} uhdr_color_transfer_t;

typedef enum uhdr_color_range {
  UHDR_CR_UNSPECIFIED = -1,
  UHDR_CR_LIMITED_RANGE = 0,
  UHDR_CR_FULL_RANGE = 1,
} uhdr_color_range_t;

typedef enum uhdr_codec {
  UHDR_CODEC_JPG,
  UHDR_CODEC_HEIF,
  UHDR_CODEC_AVIF,
} uhdr_codec_t;

typedef enum uhdr_img_label {
  UHDR_HDR_IMG,
  UHDR_SDR_IMG,
  UHDR_BASE_IMG,
  UHDR_GAIN_MAP_IMG,
} uhdr_img_label_t;

typedef enum uhdr_enc_preset {
  UHDR_USAGE_REALTIME,
  UHDR_USAGE_BEST_QUALITY,
} uhdr_enc_preset_t;

typedef enum uhdr_codec_err {
  UHDR_CODEC_OK,
  UHDR_CODEC_ERROR,
  UHDR_CODEC_UNKNOWN_ERROR,
  UHDR_CODEC_INVALID_PARAM,
  UHDR_CODEC_MEM_ERROR,
  UHDR_CODEC_INVALID_OPERATION,
  UHDR_CODEC_UNSUPPORTED_FEATURE,
  UHDR_CODEC_LIST_END,
} uhdr_codec_err_t;

typedef enum uhdr_mirror_direction {
  UHDR_MIRROR_VERTICAL,
  UHDR_MIRROR_HORIZONTAL,
} uhdr_mirror_direction_t;

/* ---- structs (layouts match ultrahdr_api.h:204-268) ---- */

typedef struct uhdr_error_info {
  uhdr_codec_err_t error_code;
  int has_detail;
  char detail[256];
} uhdr_error_info_t;

typedef struct uhdr_raw_image {
  uhdr_img_fmt_t fmt;
  uhdr_color_gamut_t cg;
  uhdr_color_transfer_t ct;
  uhdr_color_range_t range;
  unsigned int w;
  unsigned int h;
#define UHDR_PLANE_PACKED 0
#define UHDR_PLANE_Y 0
#define UHDR_PLANE_U 1
#define UHDR_PLANE_UV 1
#define UHDR_PLANE_V 2
  void* planes[3];
  unsigned int stride[3]; /* in pixels */
} uhdr_raw_image_t;

typedef struct uhdr_compressed_image {
  void* data;
  size_t data_sz;
  size_t capacity;
  uhdr_color_gamut_t cg;
  uhdr_color_transfer_t ct;
  uhdr_color_range_t range;
} uhdr_compressed_image_t;

typedef struct uhdr_mem_block {
  void* data;
  size_t data_sz;
  size_t capacity;
} uhdr_mem_block_t;

typedef struct uhdr_gainmap_metadata {
  float max_content_boost[3];
  float min_content_boost[3];
  float gamma[3];
  float offset_sdr[3];
  float offset_hdr[3];
  float hdr_capacity_min;
  float hdr_capacity_max;
  int use_base_cg;
} uhdr_gainmap_metadata_t;

typedef struct uhdr_codec_private uhdr_codec_private_t;

/* ---- encoder (ultrahdr_api.h:286-545) ---- */

UHDR_EXTERN uhdr_codec_private_t* uhdr_create_encoder(void);
UHDR_EXTERN void uhdr_release_encoder(uhdr_codec_private_t* enc);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_raw_image(uhdr_codec_private_t* enc,
                                                     uhdr_raw_image_t* img,
                                                     uhdr_img_label_t intent);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_compressed_image(uhdr_codec_private_t* enc,
                                                            uhdr_compressed_image_t* img,
                                                            uhdr_img_label_t intent);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_gainmap_image(uhdr_codec_private_t* enc,
                                                         uhdr_compressed_image_t* img,
                                                         uhdr_gainmap_metadata_t* metadata);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_quality(uhdr_codec_private_t* enc, int quality,
                                                   uhdr_img_label_t intent);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_exif_data(uhdr_codec_private_t* enc,
                                                     uhdr_mem_block_t* exif);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_using_multi_channel_gainmap(
    uhdr_codec_private_t* enc, int use_multi_channel_gainmap);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_gainmap_scale_factor(uhdr_codec_private_t* enc,
                                                                int gainmap_scale_factor);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_gainmap_gamma(uhdr_codec_private_t* enc, float gamma);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_min_max_content_boost(uhdr_codec_private_t* enc,
                                                                 float min_boost, float max_boost);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_target_display_peak_brightness(
    uhdr_codec_private_t* enc, float nits);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_preset(uhdr_codec_private_t* enc,
                                                  uhdr_enc_preset_t preset);
UHDR_EXTERN uhdr_error_info_t uhdr_enc_set_output_format(uhdr_codec_private_t* enc,
                                                         uhdr_codec_t media_type);
UHDR_EXTERN uhdr_error_info_t uhdr_encode(uhdr_codec_private_t* enc);
UHDR_EXTERN uhdr_compressed_image_t* uhdr_get_encoded_stream(uhdr_codec_private_t* enc);
UHDR_EXTERN void uhdr_reset_encoder(uhdr_codec_private_t* enc);

/* ---- decoder (ultrahdr_api.h:547-830) ---- */

UHDR_EXTERN int is_uhdr_image(void* data, int size);
UHDR_EXTERN uhdr_codec_private_t* uhdr_create_decoder(void);
UHDR_EXTERN void uhdr_release_decoder(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_error_info_t uhdr_dec_set_image(uhdr_codec_private_t* dec,
                                                 uhdr_compressed_image_t* img);
UHDR_EXTERN uhdr_error_info_t uhdr_dec_set_out_img_format(uhdr_codec_private_t* dec,
                                                          uhdr_img_fmt_t fmt);
UHDR_EXTERN uhdr_error_info_t uhdr_dec_set_out_color_transfer(uhdr_codec_private_t* dec,
                                                              uhdr_color_transfer_t ct);
UHDR_EXTERN uhdr_error_info_t uhdr_dec_set_out_max_display_boost(uhdr_codec_private_t* dec,
                                                                 float display_boost);
UHDR_EXTERN uhdr_error_info_t uhdr_dec_probe(uhdr_codec_private_t* dec);
UHDR_EXTERN int uhdr_dec_get_image_width(uhdr_codec_private_t* dec);
UHDR_EXTERN int uhdr_dec_get_image_height(uhdr_codec_private_t* dec);
UHDR_EXTERN int uhdr_dec_get_gainmap_width(uhdr_codec_private_t* dec);
UHDR_EXTERN int uhdr_dec_get_gainmap_height(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_mem_block_t* uhdr_dec_get_exif(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_mem_block_t* uhdr_dec_get_icc(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_mem_block_t* uhdr_dec_get_base_image(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_mem_block_t* uhdr_dec_get_gainmap_image(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_gainmap_metadata_t* uhdr_dec_get_gainmap_metadata(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_error_info_t uhdr_decode(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_raw_image_t* uhdr_get_decoded_image(uhdr_codec_private_t* dec);
UHDR_EXTERN uhdr_raw_image_t* uhdr_get_decoded_gainmap_image(uhdr_codec_private_t* dec);
UHDR_EXTERN void uhdr_reset_decoder(uhdr_codec_private_t* dec);

/* ---- effects + misc (ultrahdr_api.h:832-890) ---- */

UHDR_EXTERN uhdr_error_info_t uhdr_enable_gpu_acceleration(uhdr_codec_private_t* codec,
                                                           int enable);
UHDR_EXTERN uhdr_error_info_t uhdr_add_effect_mirror(uhdr_codec_private_t* codec,
                                                     uhdr_mirror_direction_t direction);
UHDR_EXTERN uhdr_error_info_t uhdr_add_effect_rotate(uhdr_codec_private_t* codec,
                                                     int degrees);
UHDR_EXTERN uhdr_error_info_t uhdr_add_effect_crop(uhdr_codec_private_t* codec, int left,
                                                   int right, int top, int bottom);
UHDR_EXTERN uhdr_error_info_t uhdr_add_effect_resize(uhdr_codec_private_t* codec, int width,
                                                     int height);

#endif /* ULTRAHDR_TPU_H */
