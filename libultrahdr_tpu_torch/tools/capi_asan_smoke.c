/*
 * Sanitized C-ABI marshaling smoke (run by tools/sanitize_replay.py).
 *
 * Exercises the shim's C++ surface under ASan/UBSan on the paths that
 * dispatch no codec: interpreter bring-up, handle lifecycle, every setter's
 * validation-error marshaling (Python exception -> uhdr_error_info_t),
 * is_uhdr_image on garbage, probe on a non-uhdr stream, and reset/release.
 * The full encode/decode flow is test_capi.c's and capi_roundtrip.c's,
 * which the replay also runs sanitized, on the CPU.
 */
#include <stdio.h>
#include <string.h>

#include "ultrahdr_tpu.h"

static int failures = 0;
#define CHECK(cond, msg)                                   \
  do {                                                     \
    if (!(cond)) {                                         \
      fprintf(stderr, "FAIL: %s\n", msg);                  \
      failures++;                                          \
    }                                                      \
  } while (0)

int main(void) {
  /* garbage input never counts as a uhdr image */
  unsigned char junk[64];
  memset(junk, 0xAB, sizeof junk);
  CHECK(is_uhdr_image(junk, sizeof junk) == 0, "garbage is not uhdr");
  CHECK(is_uhdr_image(NULL, 10) == 0, "null data rejected");

  uhdr_codec_private_t* enc = uhdr_create_encoder();
  CHECK(enc != NULL, "create encoder");
  if (enc) {
    uhdr_error_info_t e;
    e = uhdr_enc_set_quality(enc, 500, UHDR_BASE_IMG);
    CHECK(e.error_code != UHDR_CODEC_OK, "quality 500 rejected");
    CHECK(e.has_detail, "error detail marshaled");
    e = uhdr_enc_set_gainmap_scale_factor(enc, -3);
    CHECK(e.error_code != UHDR_CODEC_OK, "negative scale rejected");
    e = uhdr_enc_set_gainmap_gamma(enc, -1.0f);
    CHECK(e.error_code != UHDR_CODEC_OK, "negative gamma rejected");
    e = uhdr_enc_set_min_max_content_boost(enc, 8.0f, 2.0f);
    CHECK(e.error_code != UHDR_CODEC_OK, "min>max boost rejected");
    e = uhdr_enc_set_output_format(enc, UHDR_CODEC_HEIF);
    CHECK(e.error_code != UHDR_CODEC_OK, "heif unsupported");
    e = uhdr_enc_set_raw_image(enc, NULL, UHDR_HDR_IMG);
    CHECK(e.error_code == UHDR_CODEC_INVALID_PARAM, "null image rejected");
    e = uhdr_encode(enc);
    CHECK(e.error_code != UHDR_CODEC_OK, "encode without resources fails");
    CHECK(uhdr_get_encoded_stream(enc) == NULL, "no stream before encode");
    uhdr_reset_encoder(enc);
    e = uhdr_add_effect_rotate(enc, 45);
    CHECK(e.error_code != UHDR_CODEC_OK, "rotate 45 rejected");
    e = uhdr_add_effect_mirror(enc, (uhdr_mirror_direction_t)9);
    CHECK(e.error_code != UHDR_CODEC_OK, "bad mirror rejected");
    uhdr_release_encoder(enc);
  }

  uhdr_codec_private_t* dec = uhdr_create_decoder();
  CHECK(dec != NULL, "create decoder");
  if (dec) {
    uhdr_error_info_t e;
    uhdr_compressed_image_t img;
    memset(&img, 0, sizeof img);
    img.data = junk;
    img.data_sz = sizeof junk;
    img.capacity = sizeof junk;
    img.cg = UHDR_CG_UNSPECIFIED;
    img.ct = UHDR_CT_UNSPECIFIED;
    img.range = UHDR_CR_UNSPECIFIED;
    e = uhdr_dec_set_image(dec, &img);
    CHECK(e.error_code == UHDR_CODEC_OK, "set_image accepts bytes");
    e = uhdr_dec_probe(dec);
    CHECK(e.error_code != UHDR_CODEC_OK, "probe of garbage fails");
    CHECK(uhdr_dec_get_exif(dec) == NULL, "no exif for garbage");
    CHECK(uhdr_dec_get_gainmap_metadata(dec) == NULL,
          "no metadata for garbage");
    e = uhdr_dec_set_out_img_format(dec, (uhdr_img_fmt_t)99);
    CHECK(e.error_code != UHDR_CODEC_OK, "bad out fmt rejected");
    e = uhdr_dec_set_out_max_display_boost(dec, 0.5f);
    CHECK(e.error_code != UHDR_CODEC_OK, "boost < 1 rejected");
    uhdr_reset_decoder(dec);
    uhdr_release_decoder(dec);
  }

  if (failures) {
    fprintf(stderr, "%d failures\n", failures);
    return 1;
  }
  printf("capi asan smoke OK\n");
  return 0;
}
