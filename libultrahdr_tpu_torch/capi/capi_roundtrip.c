/*
 * capi_roundtrip: one API-0 encode and two decodes through ultrahdr_tpu.h.
 *
 *   capi_roundtrip <in.p010> <w> <h> <map scale> <multichannel 0|1>
 *                  <quality> <out prefix> [threads]
 *
 * Reads a P010 file (the Y plane, then the interleaved UV plane, 16-bit
 * little-endian samples, no padding; BT.2100 HLG, full range), encodes it
 * with the given gain-map scale, map channels and base quality into
 * <prefix>.jpg, then decodes that stream to HLG RGBA1010102
 * (<prefix>.hlg.raw) and to LINEAR RGBAF16 (<prefix>.linear.raw), each a
 * packed w x h image without row padding.
 *
 * Prints each call's host-clock milliseconds on a line of its own,
 * "ms <step> <ms>": "init" (the first call, is_uhdr_image on the file's
 * first bytes: the embedded interpreter starts and imports the port),
 * "create_encoder", "create_decoder", and for the requests "encode",
 * "decode_hlg" and "decode_linear" each call from the raw image or stream
 * in to the output out ("encode.uhdr_encode" and so on), then the request
 * as a whole ("encode").
 *
 * With threads > 1, as many threads first encode the image at once, each
 * through its own encoder, into <prefix>.t<i>.jpg; each file must equal
 * the sequential encode's.
 *
 * Runs on the card unless UHDR_TPU_TORCH_DEVICE names another torch device.
 * Exit codes: 0 done; 1 a call failed or the files differ; 2 a codec could
 * not be created (uhdr_create_encoder or uhdr_create_decoder returned NULL);
 * 3 bad arguments or I/O.
 */

#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "ultrahdr_tpu.h"

typedef struct {
  const unsigned short* y;
  const unsigned short* uv;
  unsigned w, h;
  int scale, multichannel, quality;
  const char* step; /* timing prefix, NULL for none */
  /* out */
  void* data;
  size_t size;
  int failed;
} job_t;

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static void report(const char* step, const char* call, double t0) {
  if (step && call)
    printf("ms %s.%s %.3f\n", step, call, now_ms() - t0);
  else if (step)
    printf("ms %s %.3f\n", step, now_ms() - t0);
}

static int failed(uhdr_error_info_t e, const char* what) {
  if (e.error_code == UHDR_CODEC_OK) return 0;
  fprintf(stderr, "capi_roundtrip: %s: code=%d detail=%s\n", what,
          (int)e.error_code, e.has_detail ? e.detail : "");
  return 1;
}

#define CALL(step, call, expr)                   \
  do {                                           \
    double t_ = now_ms();                        \
    uhdr_error_info_t e_ = (expr);               \
    report(step, #call, t_);                     \
    if (failed(e_, #call)) return 1;             \
  } while (0)

/* One encode through `enc`; the stream is copied into job->data. */
static int encode_with(uhdr_codec_private_t* enc, job_t* job) {
  uhdr_raw_image_t img;
  memset(&img, 0, sizeof(img));
  img.fmt = UHDR_IMG_FMT_24bppYCbCrP010;
  img.cg = UHDR_CG_BT_2100;
  img.ct = UHDR_CT_HLG;
  img.range = UHDR_CR_FULL_RANGE;
  img.w = job->w;
  img.h = job->h;
  img.planes[UHDR_PLANE_Y] = (void*)job->y;
  img.planes[UHDR_PLANE_UV] = (void*)job->uv;
  img.stride[UHDR_PLANE_Y] = job->w;
  img.stride[UHDR_PLANE_UV] = job->w;
  const char* s = job->step;
  double t0 = now_ms();
  CALL(s, uhdr_enc_set_raw_image,
       uhdr_enc_set_raw_image(enc, &img, UHDR_HDR_IMG));
  CALL(s, uhdr_enc_set_gainmap_scale_factor,
       uhdr_enc_set_gainmap_scale_factor(enc, job->scale));
  CALL(s, uhdr_enc_set_using_multi_channel_gainmap,
       uhdr_enc_set_using_multi_channel_gainmap(enc, job->multichannel));
  CALL(s, uhdr_enc_set_quality,
       uhdr_enc_set_quality(enc, job->quality, UHDR_BASE_IMG));
  CALL(s, uhdr_encode, uhdr_encode(enc));
  double t1 = now_ms();
  uhdr_compressed_image_t* out = uhdr_get_encoded_stream(enc);
  report(s, "uhdr_get_encoded_stream", t1);
  if (!out || !out->data_sz || !(job->data = malloc(out->data_sz))) {
    fprintf(stderr, "capi_roundtrip: no encoded stream\n");
    return 1;
  }
  memcpy(job->data, out->data, out->data_sz);
  job->size = out->data_sz;
  report(s, NULL, t0);
  return 0;
}

/* One encode through a new encoder of its own. */
static int encode(job_t* job) {
  uhdr_codec_private_t* enc = uhdr_create_encoder();
  if (!enc) {
    fprintf(stderr, "capi_roundtrip: uhdr_create_encoder returned NULL\n");
    return 1;
  }
  int rc = encode_with(enc, job);
  uhdr_release_encoder(enc);
  return rc;
}

static void* encode_thread(void* arg) {
  job_t* job = (job_t*)arg;
  job->failed = encode(job);
  return NULL;
}

static int write_file(const char* path, const void* data, size_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  size_t wrote = fwrite(data, 1, n, f);
  return fclose(f) != 0 || wrote != n;
}

/* Decode `data` to (fmt, ct) through `dec` (reset first) into path. */
static int decode(uhdr_codec_private_t* dec, void* data, size_t size,
                  uhdr_img_fmt_t fmt, uhdr_color_transfer_t ct,
                  const char* step, const char* path) {
  uhdr_compressed_image_t in;
  memset(&in, 0, sizeof(in));
  in.data = data;
  in.data_sz = size;
  in.capacity = size;
  in.cg = UHDR_CG_UNSPECIFIED;
  in.ct = UHDR_CT_UNSPECIFIED;
  in.range = UHDR_CR_UNSPECIFIED;
  uhdr_reset_decoder(dec);
  double t0 = now_ms();
  CALL(step, uhdr_dec_set_image, uhdr_dec_set_image(dec, &in));
  CALL(step, uhdr_dec_set_out_img_format,
       uhdr_dec_set_out_img_format(dec, fmt));
  CALL(step, uhdr_dec_set_out_color_transfer,
       uhdr_dec_set_out_color_transfer(dec, ct));
  CALL(step, uhdr_decode, uhdr_decode(dec));
  double t1 = now_ms();
  uhdr_raw_image_t* img = uhdr_get_decoded_image(dec);
  report(step, "uhdr_get_decoded_image", t1);
  report(step, NULL, t0);
  if (!img || img->fmt != fmt || !img->planes[0]) {
    fprintf(stderr, "capi_roundtrip: %s: no decoded image\n", step);
    return 1;
  }
  size_t bpp = fmt == UHDR_IMG_FMT_64bppRGBAHalfFloat ? 8 : 4;
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  int bad = 0;
  for (unsigned r = 0; r < img->h && !bad; r++)
    bad = fwrite((const char*)img->planes[0] + (size_t)r * img->stride[0] * bpp,
                 bpp, img->w, f) != img->w;
  return (fclose(f) != 0) | bad;
}

int main(int argc, char** argv) {
  if (argc < 8) {
    fprintf(stderr,
            "usage: %s <in.p010> <w> <h> <map scale> <multichannel 0|1> "
            "<quality> <out prefix> [threads]\n",
            argv[0]);
    return 3;
  }
  job_t job;
  memset(&job, 0, sizeof(job));
  job.w = (unsigned)atoi(argv[2]);
  job.h = (unsigned)atoi(argv[3]);
  job.scale = atoi(argv[4]);
  job.multichannel = atoi(argv[5]);
  job.quality = atoi(argv[6]);
  const char* prefix = argv[7];
  int threads = argc > 8 ? atoi(argv[8]) : 1;
  size_t ny = (size_t)job.w * job.h, nuv = (size_t)job.w * (job.h / 2);
  unsigned short* p010 = (unsigned short*)malloc(2 * (ny + nuv));
  FILE* f = fopen(argv[1], "rb");
  if (!p010 || !f || fread(p010, 2, ny + nuv, f) != ny + nuv) {
    fprintf(stderr, "capi_roundtrip: cannot read %zu bytes of %s\n",
            2 * (ny + nuv), argv[1]);
    return 3;
  }
  fclose(f);
  job.y = p010;
  job.uv = p010 + ny;

  double t0 = now_ms();
  (void)is_uhdr_image(p010, 16);
  report("init", NULL, t0);
  t0 = now_ms();
  uhdr_codec_private_t* enc = uhdr_create_encoder();
  report("create_encoder", NULL, t0);
  t0 = now_ms();
  uhdr_codec_private_t* dec = uhdr_create_decoder();
  report("create_decoder", NULL, t0);
  if (!enc || !dec) {
    fprintf(stderr, "capi_roundtrip:%s%s returned NULL\n",
            enc ? "" : " uhdr_create_encoder", dec ? "" : " uhdr_create_decoder");
    uhdr_release_encoder(enc);
    uhdr_release_decoder(dec);
    return 2;
  }
  uhdr_release_encoder(enc);

  char path[4096];
  job_t* jobs = NULL;
  pthread_t* tids = NULL;
  if (threads > 1) {
    jobs = (job_t*)calloc((size_t)threads, sizeof(job_t));
    tids = (pthread_t*)calloc((size_t)threads, sizeof(pthread_t));
    if (!jobs || !tids) return 3;
    for (int i = 0; i < threads; i++) {
      jobs[i] = job;
      jobs[i].step = NULL;
      if (pthread_create(&tids[i], NULL, encode_thread, &jobs[i])) return 3;
    }
    for (int i = 0; i < threads; i++) pthread_join(tids[i], NULL);
  }

  job.step = "encode";
  if (encode(&job)) return 1;
  snprintf(path, sizeof(path), "%s.jpg", prefix);
  if (write_file(path, job.data, job.size)) return 3;
  for (int i = 0; i < threads && jobs; i++) {
    if (jobs[i].failed) return 1;
    snprintf(path, sizeof(path), "%s.t%d.jpg", prefix, i);
    if (write_file(path, jobs[i].data, jobs[i].size)) return 3;
    if (jobs[i].size != job.size ||
        memcmp(jobs[i].data, job.data, job.size) != 0) {
      fprintf(stderr, "capi_roundtrip: thread %d's file differs\n", i);
      return 1;
    }
  }
  if (jobs) printf("threads: %d files equal the sequential one\n", threads);

  snprintf(path, sizeof(path), "%s.hlg.raw", prefix);
  if (decode(dec, job.data, job.size, UHDR_IMG_FMT_32bppRGBA1010102,
             UHDR_CT_HLG, "decode_hlg", path))
    return 1;
  snprintf(path, sizeof(path), "%s.linear.raw", prefix);
  if (decode(dec, job.data, job.size, UHDR_IMG_FMT_64bppRGBAHalfFloat,
             UHDR_CT_LINEAR, "decode_linear", path))
    return 1;
  uhdr_release_decoder(dec);
  for (int i = 0; i < threads && jobs; i++) free(jobs[i].data);
  free(jobs);
  free(tids);
  free(job.data);
  free(p010);
  return 0;
}
