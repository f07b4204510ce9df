/*
 * C round-trip test of the PyTorch/CUDA port's C ABI (ultrahdr_tpu.h).
 *
 * Follows the reference API walkthrough (ultrahdr_api.h:286-890): create an
 * encoder, describe a raw P010 HDR image, encode, check the stream with
 * is_uhdr_image(), then decode it back and verify dimensions, metadata and
 * output format.  Exit code 0 = pass; prints the failing step otherwise.
 * Runs on the card unless UHDR_TPU_TORCH_DEVICE names another torch device.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "ultrahdr_tpu.h"

#define CHECK(cond, msg)                        \
  do {                                          \
    if (!(cond)) {                              \
      fprintf(stderr, "FAIL: %s\n", msg);       \
      return 1;                                 \
    }                                           \
  } while (0)

#define CHECK_OK(err, msg)                                              \
  do {                                                                  \
    uhdr_error_info_t e_ = (err);                                       \
    if (e_.error_code != UHDR_CODEC_OK) {                               \
      fprintf(stderr, "FAIL: %s: code=%d detail=%s\n", msg,             \
              (int)e_.error_code, e_.has_detail ? e_.detail : "");      \
      return 1;                                                         \
    }                                                                   \
  } while (0)

int main(void) {
  const unsigned w = 64, h = 48;
  unsigned short* y = (unsigned short*)malloc(w * h * 2);
  unsigned short* uv = (unsigned short*)malloc(w * (h / 2) * 2);
  CHECK(y && uv, "alloc");
  /* synthetic HDR ramp in P010 (10 MSB carry data) */
  for (unsigned r = 0; r < h; r++)
    for (unsigned c = 0; c < w; c++)
      y[r * w + c] = (unsigned short)((((r * 1023u) / h) & 0x3FF) << 6);
  for (unsigned r = 0; r < h / 2; r++)
    for (unsigned c = 0; c < w; c += 2) {
      uv[r * w + c] = (unsigned short)(512u << 6);
      uv[r * w + c + 1] = (unsigned short)(512u << 6);
    }

  uhdr_codec_private_t* enc = uhdr_create_encoder();
  CHECK(enc != NULL, "uhdr_create_encoder");

  uhdr_raw_image_t img;
  memset(&img, 0, sizeof(img));
  img.fmt = UHDR_IMG_FMT_24bppYCbCrP010;
  img.cg = UHDR_CG_BT_2100;
  img.ct = UHDR_CT_HLG;
  img.range = UHDR_CR_FULL_RANGE;
  img.w = w;
  img.h = h;
  img.planes[UHDR_PLANE_Y] = y;
  img.planes[UHDR_PLANE_UV] = uv;
  img.stride[UHDR_PLANE_Y] = w;
  img.stride[UHDR_PLANE_UV] = w;

  CHECK_OK(uhdr_enc_set_raw_image(enc, &img, UHDR_HDR_IMG),
           "uhdr_enc_set_raw_image");
  CHECK_OK(uhdr_enc_set_quality(enc, 92, UHDR_BASE_IMG),
           "uhdr_enc_set_quality");
  CHECK_OK(uhdr_enc_set_gainmap_scale_factor(enc, 2),
           "uhdr_enc_set_gainmap_scale_factor");
  CHECK_OK(uhdr_enc_set_preset(enc, UHDR_USAGE_REALTIME),
           "uhdr_enc_set_preset");

  /* invalid parameter must be rejected, not crash */
  uhdr_error_info_t bad = uhdr_enc_set_gainmap_scale_factor(enc, 0);
  CHECK(bad.error_code == UHDR_CODEC_INVALID_PARAM, "bad scale rejected");

  CHECK_OK(uhdr_encode(enc), "uhdr_encode");
  uhdr_compressed_image_t* out = uhdr_get_encoded_stream(enc);
  CHECK(out != NULL && out->data_sz > 100, "uhdr_get_encoded_stream");
  CHECK(((const unsigned char*)out->data)[0] == 0xFF &&
            ((const unsigned char*)out->data)[1] == 0xD8,
        "stream starts with SOI");

  CHECK(is_uhdr_image(out->data, (int)out->data_sz) == 1, "is_uhdr_image");

  /* stride-bearing raw images: a padded layout (stride > width) must be
     honored and produce a byte-identical stream (reference validates and
     honors strides, ultrahdr_api.cpp:815-1031; invariance contract
     jpegr_test.cpp:1537-1558) */
  {
    unsigned pad = 24, ls = w + pad;
    unsigned short* yp = (unsigned short*)calloc((size_t)ls * h, 2);
    unsigned short* uvp = (unsigned short*)calloc((size_t)ls * (h / 2), 2);
    CHECK(yp && uvp, "padded alloc");
    for (unsigned r = 0; r < h; r++)
      memcpy(yp + (size_t)r * ls, y + (size_t)r * w, (size_t)w * 2);
    for (unsigned r = 0; r < h / 2; r++)
      memcpy(uvp + (size_t)r * ls, uv + (size_t)r * w, (size_t)w * 2);
    uhdr_codec_private_t* enc2 = uhdr_create_encoder();
    CHECK(enc2 != NULL, "create_encoder (padded)");
    uhdr_raw_image_t img2 = img;
    img2.planes[UHDR_PLANE_Y] = yp;
    img2.planes[UHDR_PLANE_UV] = uvp;
    img2.stride[UHDR_PLANE_Y] = ls;
    img2.stride[UHDR_PLANE_UV] = ls;
    CHECK_OK(uhdr_enc_set_raw_image(enc2, &img2, UHDR_HDR_IMG),
             "set_raw_image (padded stride)");
    CHECK_OK(uhdr_enc_set_quality(enc2, 92, UHDR_BASE_IMG),
             "set_quality (padded)");
    CHECK_OK(uhdr_enc_set_gainmap_scale_factor(enc2, 2),
             "set_gainmap_scale_factor (padded)");
    CHECK_OK(uhdr_enc_set_preset(enc2, UHDR_USAGE_REALTIME),
             "set_preset (padded)");
    CHECK_OK(uhdr_encode(enc2), "uhdr_encode (padded stride)");
    uhdr_compressed_image_t* out2 = uhdr_get_encoded_stream(enc2);
    CHECK(out2 != NULL && out2->data_sz == out->data_sz,
          "padded-stride stream size matches");
    CHECK(memcmp(out2->data, out->data, out->data_sz) == 0,
          "padded-stride stream bit-identical");

    /* stride < width must be rejected, not crash */
    img2.stride[UHDR_PLANE_Y] = w - 2;
    uhdr_error_info_t bad_stride = uhdr_enc_set_raw_image(enc2, &img2,
                                                          UHDR_HDR_IMG);
    CHECK(bad_stride.error_code == UHDR_CODEC_INVALID_PARAM,
          "stride < width rejected");
    uhdr_release_encoder(enc2);
    free(yp);
    free(uvp);
  }

  /* decode it back */
  uhdr_codec_private_t* dec = uhdr_create_decoder();
  CHECK(dec != NULL, "uhdr_create_decoder");
  uhdr_compressed_image_t in;
  memset(&in, 0, sizeof(in));
  in.data = out->data;
  in.data_sz = out->data_sz;
  in.capacity = out->data_sz;
  CHECK_OK(uhdr_dec_set_image(dec, &in), "uhdr_dec_set_image");
  CHECK_OK(uhdr_dec_set_out_color_transfer(dec, UHDR_CT_HLG),
           "uhdr_dec_set_out_color_transfer");
  CHECK_OK(uhdr_dec_set_out_img_format(dec, UHDR_IMG_FMT_32bppRGBA1010102),
           "uhdr_dec_set_out_img_format");
  CHECK_OK(uhdr_dec_probe(dec), "uhdr_dec_probe");
  CHECK(uhdr_dec_get_image_width(dec) == (int)w, "probe width");
  CHECK(uhdr_dec_get_image_height(dec) == (int)h, "probe height");
  CHECK(uhdr_dec_get_gainmap_width(dec) == (int)(w / 2), "gainmap width");

  uhdr_gainmap_metadata_t* meta = uhdr_dec_get_gainmap_metadata(dec);
  CHECK(meta != NULL, "uhdr_dec_get_gainmap_metadata");
  CHECK(meta->max_content_boost[0] > 1.0f, "metadata max boost > 1");

  CHECK_OK(uhdr_decode(dec), "uhdr_decode");
  uhdr_raw_image_t* hdr = uhdr_get_decoded_image(dec);
  CHECK(hdr != NULL, "uhdr_get_decoded_image");
  CHECK(hdr->fmt == UHDR_IMG_FMT_32bppRGBA1010102, "decoded fmt");
  CHECK(hdr->w == w && hdr->h == h, "decoded dims");
  CHECK(hdr->planes[0] != NULL, "decoded plane");

  /* decoded pixels: top of the ramp must be brighter than the bottom */
  {
    const unsigned* px = (const unsigned*)hdr->planes[0];
    unsigned r_top = px[(h - 1) * hdr->stride[0]] & 0x3FF;
    unsigned r_bot = px[0] & 0x3FF;
    CHECK(r_top > r_bot + 100, "decoded ramp increases");
  }

  uhdr_release_decoder(dec);
  uhdr_release_encoder(enc);
  free(y);
  free(uv);
  printf("capi round-trip OK\n");
  return 0;
}
