// The PyTorch port's own copy of the JAX package's jpeg/_native/host_decode.cpp,
// identical in code (process_restart's known fault included, ROADMAP.md
// Queue 3), so that the host stages of both packages agree bit for bit.
// Built by libultrahdr_tpu_torch/jpeg/native.py.
//
// Host (CPU) decode fast path: fused IDCT + gain-map apply.
//
// Role: the reference's decode contract delivers the HDR frame into HOST
// memory (decodeJPEGR, reference lib/src/jpegr.cpp:1384-1699).  On a
// host whose device link is orders slower than PCIe, shipping a 33 MB
// RGBA1010102 frame down from the TPU loses to a pure-CPU pipeline, so the
// framework keeps a native decode engine for host-resident outputs — the
// same architectural split as the reference's CPU path vs its GLES path.
//
// Design (not a translation): one pass per row group, staged into small
// float rows so the compiler autovectorizes (AVX-512 here), with the
// reference's own LUT discretizations (gainmapmath.h:274-342,449-450)
// reproduced so results match the XLA path's grid-quantized math:
//   - sRGB inverse OETF: 1024-entry LUT (gainmapmath.cpp:127-134)
//   - gain factor: 1024-entry per-channel LUT over the post-gamma gain
//     (GainLUT, gainmapmath.h:452-495)
//   - HLG/PQ OETF: 65536-entry LUT composed with the inverse OOTF
//     (hlgInverseOotfApprox per-channel pow(1/1.2), gainmapmath.cpp:304)
//     and the 10-bit quantizer, so the hot loop's transfer step is one
//     u16 table fetch.
//   - IDCT: AAN (Arai-Agui-Nakajima) float 8x8 with the dequant scale
//     folded into the quant table.
//   - gain map upsampling: Shepard's IDW with the reference's per-phase
//     weight tables (fillShepardsIDW, gainmapmath.cpp:43-80), evaluated
//     per k-phase so weights are compile-time-invariant in the inner loop.
//
// Numeric contract: matches the device path within the 1e-4 / >=60 dB
// gates (tests/test_host_decode.py); not bit-identical (libm vs XLA
// transcendentals).

#include <cmath>
#include <cstdint>
#include <cstring>
#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// IDCT: separable 8x8 basis multiply (s = B . F . B^T) with the dequant
// folded into the coefficient load.  Straight-line 8-wide inner loops
// autovectorize; ~16 fma/pixel is ~35 ms for a 4K Y plane here.

const uint8_t kZigzagToNatural[64] = {
    // zigzag position -> natural (row-major) index (T.81 Figure A.6)
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The 1-D 'islow' pass as an exact integer matrix.  libjpeg's
// jpeg_idct_islow (the decoder every libultrahdr build links) is two
// passes of one Loeffler-Ligtenberg-Moshovitz butterfly in CONST_BITS=13
// fixed point; each pass is exactly linear in its inputs with a single
// DESCALE rounding at the end, so the whole pass collapses to
//     out = (M @ x + 2^(s-1)) >> s
// with s=11 (column pass, PASS1_BITS=2 left in) and s=18 (+128 recenter,
// clamp) for the row pass.  M below is derived by pushing unit vectors
// through the butterfly (tools/derive_islow.py); matching it makes the
// host engine's YCbCr planes BIT-IDENTICAL to libjpeg's, which is what
// the reference's decode contract actually produces
// (reference lib/src/jpegdecoderhelper.cpp:206-351).
static const int32_t kIslowM[8][8] = {
    {8192, 11363, 10703, 9633, 8192, 6437, 4433, 2260},
    {8192, 9633, 4433, -2259, -8192, -11362, -10704, -6436},
    {8192, 6437, -4433, -11362, -8192, 2261, 10704, 9633},
    {8192, 2260, -10703, -6436, 8192, 9633, -4433, -11363},
    {8192, -2260, -10703, 6436, 8192, -9633, -4433, 11363},
    {8192, -6437, -4433, 11362, -8192, -2261, 10704, -9633},
    {8192, -9633, 4433, 2259, -8192, 11362, -10704, 6436},
    {8192, -11363, 10703, -9633, 8192, -6437, 4433, -2260},
};

inline uint8_t clamp_u8i(int32_t v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// libjpeg's post-IDCT range_limit table (jdmaster.c
// prepare_range_limit_table) as a closed form over v = IDCT output + 128:
// index m = v & RANGE_MASK(1023), then m<256 -> m, m<640 -> 255, else 0.
// Identical to clamp_u8i for in-range samples; on corrupt streams whose
// IDCT outputs leave [-128, 511] it reproduces libjpeg's wrap exactly
// (mapping verified empirically against libjpeg-turbo's C islow across
// all 1024 residues).  jdcolor's sample_range_limit indexing stays pure
// saturation — only IDCT outputs go through this table.
inline uint8_t idct_range_limit(int32_t v) {
  int32_t m = v & 1023;
  return (uint8_t)(m < 256 ? m : (m < 640 ? 255 : 0));
}

// Wrapping scalar islow block IDCT over natural-order dequantized D
// (exact integers held in f64).  int64 accumulate then int32 cast =
// mod-2^32 wrap, exactly libjpeg's int arithmetic on overflow — this is
// both the non-AVX2 engine and the AVX2 path's overflow fallback (the
// vector path's cvtpd_epi32 would saturate instead of wrap).
inline void idct_block_scalar_i(const double* D, const int32_t M[8][8],
                                int umax, int vmax, uint8_t* dst,
                                int64_t out_stride) {
  int32_t T[64];
  for (int n = 0; n < 8; n++)
    for (int v = 0; v < 8; v++) {
      int64_t acc = 0;
      for (int u = 0; u <= umax; u++)
        acc += (int64_t)M[n][u] * (int64_t)D[u * 8 + v];
      T[n * 8 + v] = (int32_t)(acc + (1 << 10)) >> 11;
    }
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) {
      int64_t acc = 0;
      for (int v = 0; v <= vmax; v++)
        acc += (int64_t)M[x][v] * (int64_t)T[y * 8 + v];
      dst[y * out_stride + x] =
          idct_range_limit(((int32_t)(acc + (1 << 17)) >> 18) + 128);
    }
}

}  // namespace

// libjpeg jdcolor.c ycc_rgb_convert fixed point, SCALEBITS=16: the exact
// integers behind every libjpeg(-turbo) RGB decode, so the native engine's
// gain-map / base RGB bytes are identical to the reference's
// (reference lib/src/jpegdecoderhelper.cpp:353-375).
struct YccTabs {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTabs() {
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = (int32_t)((91881LL * x + 32768) >> 16);   // FIX(1.40200)
      cb_b[i] = (int32_t)((116130LL * x + 32768) >> 16);  // FIX(1.77200)
      cr_g[i] = -46802 * x;                               // -FIX(0.71414)
      cb_g[i] = -22554 * x + 32768;                       // -FIX(0.34414)
    }
  }
};
static const YccTabs kYcc;

// Full-range Rec.601 YCbCr planes -> interleaved RGB888 (the RGB-coded
// multichannel gain map's color decode; JCS_RGB path of
// reference lib/src/jpegdecoderhelper.cpp:353-375 for the map).
// y/cb/cr: (h, w) u8, own stride each; out: (h, w, 3) u8.
extern "C" void uhdr_ycbcr_to_rgb888(const uint8_t* y, int64_t y_stride,
                                     const uint8_t* cb, const uint8_t* cr,
                                     int64_t c_stride, int64_t w, int64_t h,
                                     uint8_t* out) {
  for (int64_t r = 0; r < h; r++) {
    const uint8_t* yr = y + r * y_stride;
    const uint8_t* br = cb + r * c_stride;
    const uint8_t* rr = cr + r * c_stride;
    uint8_t* o = out + r * w * 3;
    for (int64_t x = 0; x < w; x++) {
      int32_t yy = yr[x];
      int pr = yy + kYcc.cr_r[rr[x]];
      int pg = yy + ((kYcc.cb_g[br[x]] + kYcc.cr_g[rr[x]]) >> 16);
      int pb = yy + kYcc.cb_b[br[x]];
      o[x * 3 + 0] = (uint8_t)(pr < 0 ? 0 : (pr > 255 ? 255 : pr));
      o[x * 3 + 1] = (uint8_t)(pg < 0 ? 0 : (pg > 255 ? 255 : pg));
      o[x * 3 + 2] = (uint8_t)(pb < 0 ? 0 : (pb > 255 ? 255 : pb));
    }
  }
}

// Planar variant: r/g/b written as three (h, w) planes (the host decode
// engine keeps the RGB-coded gain map planar so the apply stage gathers
// straight from u8 rows with no interleave round trip).  Same jdcolor
// fixed point as above; AVX-512 does the table math inline (mullo/srai)
// 16-wide with a scalar tail — identical integers either way.
extern "C" void uhdr_ycbcr_to_rgb_planar(const uint8_t* y, int64_t y_stride,
                                         const uint8_t* cb, const uint8_t* cr,
                                         int64_t c_stride, int64_t w,
                                         int64_t h, uint8_t* ro, uint8_t* go,
                                         uint8_t* bo) {
#if defined(__AVX512F__) && defined(__AVX512BW__)
  const int64_t wsimd = w & ~(int64_t)15;
#else
  const int64_t wsimd = 0;
#endif
  for (int64_t r = 0; r < h; r++) {
    const uint8_t* yr = y + r * y_stride;
    const uint8_t* br = cb + r * c_stride;
    const uint8_t* rr = cr + r * c_stride;
    uint8_t* orow = ro + r * w;
    uint8_t* grow_ = go + r * w;
    uint8_t* brow_ = bo + r * w;
#if defined(__AVX512F__) && defined(__AVX512BW__)
    {
      const __m512i c128 = _mm512_set1_epi32(128);
      const __m512i kCrR = _mm512_set1_epi32(91881),
                    kCbB = _mm512_set1_epi32(116130),
                    kCrG = _mm512_set1_epi32(-46802),
                    kCbG = _mm512_set1_epi32(-22554);
      const __m512i half = _mm512_set1_epi32(32768);
      const __m512i z = _mm512_setzero_si512(),
                    m255 = _mm512_set1_epi32(255);
      auto st = [&](uint8_t* dst, int64_t x, __m512i i) {
        i = _mm512_min_epi32(_mm512_max_epi32(i, z), m255);
        _mm_storeu_si128((__m128i*)(dst + x), _mm512_cvtepi32_epi8(i));
      };
      for (int64_t x = 0; x < wsimd; x += 16) {
        __m512i yy = _mm512_cvtepu8_epi32(
            _mm_loadu_si128((const __m128i*)(yr + x)));
        __m512i u = _mm512_sub_epi32(_mm512_cvtepu8_epi32(_mm_loadu_si128(
                                         (const __m128i*)(br + x))),
                                     c128);
        __m512i v = _mm512_sub_epi32(_mm512_cvtepu8_epi32(_mm_loadu_si128(
                                         (const __m128i*)(rr + x))),
                                     c128);
        __m512i pr = _mm512_add_epi32(
            yy, _mm512_srai_epi32(
                    _mm512_add_epi32(_mm512_mullo_epi32(kCrR, v), half), 16));
        __m512i pg = _mm512_add_epi32(
            yy, _mm512_srai_epi32(
                    _mm512_add_epi32(
                        _mm512_add_epi32(_mm512_mullo_epi32(kCbG, u), half),
                        _mm512_mullo_epi32(kCrG, v)),
                    16));
        __m512i pb = _mm512_add_epi32(
            yy, _mm512_srai_epi32(
                    _mm512_add_epi32(_mm512_mullo_epi32(kCbB, u), half), 16));
        st(orow, x, pr);
        st(grow_, x, pg);
        st(brow_, x, pb);
      }
    }
#endif
    for (int64_t x = wsimd; x < w; x++) {
      int32_t yy = yr[x];
      int pr = yy + kYcc.cr_r[rr[x]];
      int pg = yy + ((kYcc.cb_g[br[x]] + kYcc.cr_g[rr[x]]) >> 16);
      int pb = yy + kYcc.cb_b[br[x]];
      orow[x] = (uint8_t)(pr < 0 ? 0 : (pr > 255 ? 255 : pr));
      grow_[x] = (uint8_t)(pg < 0 ? 0 : (pg > 255 ? 255 : pg));
      brow_[x] = (uint8_t)(pb < 0 ? 0 : (pb > 255 ? 255 : pb));
    }
  }
}

// Zigzag int16 coefficient blocks -> u8 plane, bit-identical to libjpeg's
// jpeg_idct_islow (see kIslowM above).  Exactness argument: every product
// |M|<2^15 x |dequant|<2^31 < 2^46 and each 8-term sum < 2^49 is an exact
// integer in f64 (< 2^53), so the AVX2 double FMAs below compute the same
// integers libjpeg's int32 arithmetic does; DESCALE is then done in real
// int32.  coeffs: (bh, bw, 64); out: (bh*8, out_stride) buffer.
extern "C" void uhdr_idct_plane(const int16_t* coeffs, int64_t bh, int64_t bw,
                                const int32_t* qt_natural, uint8_t* out,
                                int64_t out_stride) {
  int32_t dq[64];  // dequant multipliers in zigzag load order
  for (int zz = 0; zz < 64; zz++)
    dq[zz] = qt_natural[kZigzagToNatural[zz]];
#if defined(__AVX2__) && defined(__FMA__)
  double Md[64];  // M as doubles for the f64 FMA form
  for (int i = 0; i < 64; i++) Md[i] = (double)kIslowM[i / 8][i % 8];
#endif

  double D[64];
  int32_t T[64];
  for (int64_t by = 0; by < bh; by++) {
    for (int64_t bx = 0; bx < bw; bx++) {
      const int16_t* src = coeffs + (by * bw + bx) * 64;
      uint8_t* dst = out + (by * 8) * out_stride + bx * 8;
      // Sparsity fast paths: photographic content at q95 measures ~95%
      // DC-only luma blocks; track the last nonzero zigzag index and
      // bound the transform to the frequencies actually present.
      int last = 63;
      while (last > 0 && src[last] == 0) last--;
      if (last == 0) {
        // DC-only: both passes collapse to DESCALE(dc*q, 3) + 128 (pass1
        // shortcut dcval<<2, flat row through pass2).
        uint8_t v8 =
            idct_range_limit((((int32_t)src[0] * dq[0] + 4) >> 3) + 128);
        for (int r = 0; r < 8; r++) memset(dst + r * out_stride, v8, 8);
        continue;
      }
      int umax = 0, vmax = 0;  // max nonzero natural row / col frequency
      for (int zz = 0; zz <= last; zz++) {
        if (src[zz] == 0) continue;
        int nat = kZigzagToNatural[zz];
        int u = nat >> 3, v = nat & 7;
        if (u > umax) umax = u;
        if (v > vmax) vmax = v;
      }
      for (int i = 0; i < 64; i++) D[i] = 0.0;
      double max_abs_d = 0.0;
      for (int zz = 0; zz <= last; zz++) {
        double d = (double)((int32_t)src[zz] * dq[zz]);
        D[kZigzagToNatural[zz]] = d;
        double a = d < 0.0 ? -d : d;
        if (a > max_abs_d) max_abs_d = a;
      }
#if defined(__AVX2__) && defined(__FMA__)
      {
        // |row sum| <= max|D| * max_n sum_u|M[n][u]| (= 61219 for islow).
        // cvtpd_epi32 saturates outside int32 while every integer engine
        // wraps mod 2^32; route blocks whose exact f64 sums could leave
        // int32 (adversarial streams only — valid JPEG never gets close)
        // through the wrapping scalar path so all builds stay bit-equal.
        const double bound1 = max_abs_d * 61219.0;
        const double tbound = bound1 / 2048.0 + 2.0;
        if (bound1 >= 2146000000.0 || tbound * 61219.0 >= 2146000000.0) {
          idct_block_scalar_i(D, kIslowM, umax, vmax, dst, out_stride);
          continue;
        }
        // pass 1 (columns): T[n][v] = (sum_u M[n][u] * D[u][v] + 2^10)>>11
        const __m128i r1 = _mm_set1_epi32(1 << 10);
        for (int n = 0; n < 8; n++) {
          __m256d lo = _mm256_mul_pd(_mm256_set1_pd(Md[n * 8]),
                                     _mm256_loadu_pd(D));
          __m256d hi = _mm256_mul_pd(_mm256_set1_pd(Md[n * 8]),
                                     _mm256_loadu_pd(D + 4));
          for (int u = 1; u <= umax; u++) {
            __m256d m = _mm256_set1_pd(Md[n * 8 + u]);
            lo = _mm256_fmadd_pd(m, _mm256_loadu_pd(D + u * 8), lo);
            hi = _mm256_fmadd_pd(m, _mm256_loadu_pd(D + u * 8 + 4), hi);
          }
          __m128i ilo = _mm256_cvtpd_epi32(lo);   // exact ints, RNE = exact
          __m128i ihi = _mm256_cvtpd_epi32(hi);
          ilo = _mm_srai_epi32(_mm_add_epi32(ilo, r1), 11);
          ihi = _mm_srai_epi32(_mm_add_epi32(ihi, r1), 11);
          _mm_storeu_si128((__m128i*)(T + n * 8), ilo);
          _mm_storeu_si128((__m128i*)(T + n * 8 + 4), ihi);
        }
        // pass 2 (rows): out[y][x] = ((sum_v M[x][v]*T[y][v] + 2^17)>>18)+128
        const __m128i r2 = _mm_set1_epi32(1 << 17);
        const __m128i c128 = _mm_set1_epi32(128);
        const __m128i max4 = _mm_set1_epi32(255);
        for (int y = 0; y < 8; y++) {
          // vectorize over x: acc[x] += T[y][v] * M[x][v] -> needs M^T rows
          __m256d lo = _mm256_setzero_pd(), hi = _mm256_setzero_pd();
          for (int v = 0; v <= vmax; v++) {
            __m256d t = _mm256_set1_pd((double)T[y * 8 + v]);
            // Mt[v][x] = Md[x*8+v]: gather as a strided load done scalar —
            // build once per v into a stack row
            double mt[8];
            for (int x = 0; x < 8; x++) mt[x] = Md[x * 8 + v];
            lo = _mm256_fmadd_pd(t, _mm256_loadu_pd(mt), lo);
            hi = _mm256_fmadd_pd(t, _mm256_loadu_pd(mt + 4), hi);
          }
          __m128i ilo = _mm256_cvtpd_epi32(lo);
          __m128i ihi = _mm256_cvtpd_epi32(hi);
          ilo = _mm_add_epi32(_mm_srai_epi32(_mm_add_epi32(ilo, r2), 18),
                              c128);
          ihi = _mm_add_epi32(_mm_srai_epi32(_mm_add_epi32(ihi, r2), 18),
                              c128);
          // idct_range_limit, vectorized: m = v & 1023;
          // m<256 -> m, m<640 -> 255, else 0
          const __m128i mask = _mm_set1_epi32(1023);
          const __m128i c256 = _mm_set1_epi32(256), c640 = _mm_set1_epi32(640);
          __m128i mlo = _mm_and_si128(ilo, mask);
          __m128i mhi = _mm_and_si128(ihi, mask);
          __m128i slo = _mm_and_si128(_mm_cmplt_epi32(mlo, c640), max4);
          __m128i shi = _mm_and_si128(_mm_cmplt_epi32(mhi, c640), max4);
          ilo = _mm_blendv_epi8(slo, mlo, _mm_cmplt_epi32(mlo, c256));
          ihi = _mm_blendv_epi8(shi, mhi, _mm_cmplt_epi32(mhi, c256));
          __m128i p16 = _mm_packus_epi32(ilo, ihi);
          __m128i p8 = _mm_packus_epi16(p16, p16);
          _mm_storel_epi64((__m128i*)(dst + y * out_stride), p8);
        }
      }
#else
      idct_block_scalar_i(D, kIslowM, umax, vmax, dst, out_stride);
#endif
    }
  }
}

namespace {

// ---------------------------------------------------------------------------
// apply LUTs

struct ApplyLuts {
  float srgb_inv[1024];      // sRGB EOTF on the 1024 grid
  float gainf[3][1024];      // per-channel gain factor over post-gamma gain
  uint16_t oetf10[65536];    // [scaled linear 65536 grid] -> 10-bit code
  bool oetf_valid = false;
};

float srgb_inv_oetf(float e) {
  return e <= 0.04045f ? e / 12.92f : powf((e + 0.055f) / 1.055f, 2.4f);
}

float hlg_oetf(float e) {
  // ITU-R BT.2100-2 Table 5 (gainmapmath.cpp:238-247)
  return e <= 1.0f / 12.0f ? sqrtf(3.0f * e)
                           : 0.17883277f * logf(12.0f * e - 0.28466892f) +
                                 0.55991073f;
}

float pq_oetf(float e) {
  // ITU-R BT.2100-2 Table 4 (gainmapmath.cpp:313-318)
  if (e <= 0.0f) return 0.0f;
  const float m1 = 2610.0f / 16384.0f, m2 = 2523.0f / 4096.0f * 128.0f;
  const float c1 = 3424.0f / 4096.0f, c2 = 2413.0f / 4096.0f * 32.0f,
              c3 = 2392.0f / 4096.0f * 32.0f;
  float ep = powf(e, m1);
  return powf((c1 + c2 * ep) / (1.0f + c3 * ep), m2);
}

void build_luts(ApplyLuts& L, const float* meta, float weight, int out_ct) {
  for (int i = 0; i < 1024; i++)
    L.srgb_inv[i] = srgb_inv_oetf((float)i / 1023.0f);
  const float* gamma = meta + 0;
  const float* minb = meta + 3;
  const float* maxb = meta + 6;
  (void)gamma;
  for (int c = 0; c < 3; c++) {
    float lmin = log2f(minb[c]), lmax = log2f(maxb[c]);
    for (int i = 0; i < 1024; i++) {
      float g = (float)i / 1023.0f;  // post-gamma gain on the LUT grid
      L.gainf[c][i] = exp2f((lmin * (1.0f - g) + lmax * g) * weight);
    }
  }
  if (out_ct == 1) {  // HLG: inverse OOTF (pow 1/1.2) folded with OETF.
    // Indexed on sqrt(x) so the grid is dense where the composite is steep
    // (near black) — tighter than the reference's own linear-grid
    // hlgOetfLUT there.  Entry j covers x = (j/65535)^2.
    for (int i = 0; i < 65536; i++) {
      float s = (float)i / 65535.0f;
      float v = hlg_oetf(powf(s * s, 1.0f / 1.2f));
      L.oetf10[i] = (uint16_t)lrintf(fminf(fmaxf(v, 0.0f), 1.0f) * 1023.0f);
    }
    L.oetf_valid = true;
  } else if (out_ct == 2) {  // PQ
    for (int i = 0; i < 65536; i++) {
      float v = pq_oetf((float)i / 65535.0f);
      L.oetf10[i] = (uint16_t)lrintf(fminf(fmaxf(v, 0.0f), 1.0f) * 1023.0f);
    }
    L.oetf_valid = true;
  }
}

// Shepard's IDW weight tables (fillShepardsIDW, gainmapmath.cpp:43-80):
// tables[t][phase_y][phase_x][4 neighbors], t = 0 interior, 1 right edge
// (no-right), 2 bottom edge (no-bottom), 3 corner.
void build_shepard(int k, std::vector<float>& out) {
  out.assign(4 * k * k * 4, 0.0f);
  const int inc[4][2] = {{1, 1}, {0, 1}, {1, 0}, {0, 0}};  // (right, bottom)
  for (int t = 0; t < 4; t++) {
    for (int y = 0; y < k; y++)
      for (int x = 0; x < k; x++) {
        float px = (float)x / k, py = (float)y / k;
        float* w = &out[((t * k + y) * k + x) * 4];
        float d1 = hypotf(px, py);
        if (d1 == 0.0f) {
          w[0] = 1.0f;
          continue;
        }
        float nx = (float)inc[t][0], ny = (float)inc[t][1];
        float ws[4] = {1.0f / d1, 1.0f / hypotf(px, py - ny),
                       1.0f / hypotf(px - nx, py),
                       1.0f / hypotf(px - nx, py - ny)};
        float s = ws[0] + ws[1] + ws[2] + ws[3];
        for (int j = 0; j < 4; j++) w[j] = ws[j] / s;
      }
  }
}

inline int lut1024(float x) {
  int i = (int)(x * 1023.0f + 0.5f);
  return i < 0 ? 0 : (i > 1023 ? 1023 : i);
}

inline int lut65536(float x) {
  int i = (int)(x * 65535.0f + 0.5f);
  return i < 0 ? 0 : (i > 65535 ? 65535 : i);
}

}  // namespace

// Fused apply-gainmap on host.
//
// yp/up/vp: full-range YCbCr planes (up/vp subsampled by hf/vf, own stride).
// gm: gain map, gm_channels in {1,3}, dims (mh, mw), integer upsample
//     factor k (w <= mw*k, h <= mh*k); when 3-channel, interleaved
//     (c fastest) unless gm_planar != 0 (three consecutive mh*mw planes).
// meta: 15 floats [gamma[3], min_boost[3], max_boost[3], off_sdr[3],
//       off_hdr[3]]; weight: gain application weight (jpegr.cpp:1556-1568).
// out_ct: 0 linear (F16 u64 out), 1 HLG, 2 PQ (RGBA1010102 u32 out).
// gamut_m: row-major 3x3 or nullptr; gamut_pre: apply before gain
//     (use_base_cg == false) vs after (jpegr.cpp:1490-1505).
// Returns 0 on success.
extern "C" int uhdr_apply_gainmap_host(
    const uint8_t* yp, int64_t y_stride, const uint8_t* up, const uint8_t* vp,
    int64_t c_stride, int hf, int vf, int64_t w, int64_t h, const uint8_t* gm,
    int gm_channels, int64_t mw, int64_t mh, int k, int gm_planar,
    const float* meta, float weight, int out_ct, const float* gamut_m,
    int gamut_pre, void* out_buf) {
  if (k < 1 || (gm_channels != 1 && gm_channels != 3)) return -1;
  if (out_ct < 0 || out_ct > 2) return -2;

  ApplyLuts* L = new ApplyLuts();
  build_luts(*L, meta, weight, out_ct);
  std::vector<float> shep;
  build_shepard(k, shep);

  const float* gamma = meta + 0;
  const float* off_sdr = meta + 9;
  const float* off_hdr = meta + 12;
  bool unit_gamma = gamma[0] == 1.0f && gamma[1] == 1.0f && gamma[2] == 1.0f;

  // Display-P3 YUV uses BT.601 coefficients (gainmapmath.cpp:166-168);
  // JPEG-decoded base is always treated this way (jpegr.cpp:1592).
  const float cb_b = 2.0f * (1.0f - 0.114f);          // 1.772
  const float cr_r = 2.0f * (1.0f - 0.299f);          // 1.402
  const float g_u = -0.114f * cb_b / 0.587f;
  const float g_v = -0.299f * cr_r / 0.587f;

  const float out_scale = out_ct == 1 ? 203.0f / 1000.0f
                        : out_ct == 2 ? 203.0f / 10000.0f
                                      : 1.0f;
  const float lin_max = 10000.0f / 203.0f;

  // planar work rows (f32 chroma expanded per output row; planar gain rows
  // so stage 3 reads contiguously)
  std::vector<float> rrow(w), grow(w), brow(w);
  std::vector<float> ubuf(w), vbuf(w);
  std::vector<float> gp[3] = {std::vector<float>(w), std::vector<float>(w),
                              std::vector<float>(w)};
  std::vector<uint8_t> mexp[3] = {std::vector<uint8_t>(w),
                                  std::vector<uint8_t>(w),
                                  std::vector<uint8_t>(w)};

  uint32_t* out32 = (uint32_t*)out_buf;
  uint64_t* out64 = (uint64_t*)out_buf;

  // k == 1 (the library's default map scale): the map sample feeds the
  // gain directly, so gamma, the 1024-grid quantize, and the gain LUT
  // compose into one exact 256-entry LUT per channel — stages 2+3 become
  // a single u8-indexed load.
  float gain8[3][256];
  if (k == 1) {
    for (int c = 0; c < 3; c++)
      for (int e = 0; e < 256; e++) {
        float gv = (float)e * (1.0f / 255.0f);
        if (!unit_gamma) gv = powf(fmaxf(gv, 0.0f), 1.0f / gamma[c]);
        gain8[c][e] = L->gainf[c][lut1024(gv)];
      }
  }

#if defined(__AVX512F__)
  // 32-bit copy of the 10-bit OETF table so vpgatherdd applies (stage 4 is
  // the hot stage: 3 sqrt + 3 64K-table gathers per pixel; the scalar loop
  // measured ~92 ms/4K frame, the gather version ~15 ms)
  std::vector<uint32_t> oetf32;
  if (L->oetf_valid) oetf32.assign(L->oetf10, L->oetf10 + 65536);
  const int64_t wsimd = w & ~(int64_t)15;
#else
  const int64_t wsimd = 0;
#endif

  for (int64_t y = 0; y < h; y++) {
    const uint8_t* yr = yp + y * y_stride;
    const uint8_t* ur = up + (y / vf) * c_stride;
    const uint8_t* vr = vp + (y / vf) * c_stride;

    // expand chroma to planar f32 (128-biased: gainmapmath.cpp:354-388)
    if (hf == 2) {
      for (int64_t cx = 0; cx < w / 2; cx++) {
        float uu = (float)ur[cx] - 128.0f, vv = (float)vr[cx] - 128.0f;
        ubuf[2 * cx] = uu; ubuf[2 * cx + 1] = uu;
        vbuf[2 * cx] = vv; vbuf[2 * cx + 1] = vv;
      }
      if (w & 1) {
        ubuf[w - 1] = (float)ur[(w - 1) / 2] - 128.0f;
        vbuf[w - 1] = (float)vr[(w - 1) / 2] - 128.0f;
      }
    } else {
      for (int64_t x = 0; x < w; x++) {
        ubuf[x] = (float)ur[x / hf] - 128.0f;
        vbuf[x] = (float)vr[x / hf] - 128.0f;
      }
    }

    // stage 1: YCbCr -> linear SDR RGB through the 1024-grid sRGB EOTF
    auto stage1_scalar = [&](int64_t x0, int64_t x1) {
      for (int64_t x = x0; x < x1; x++) {
        float yy = yr[x] * (1.0f / 255.0f);
        float uu = ubuf[x] * (1.0f / 255.0f);
        float vv = vbuf[x] * (1.0f / 255.0f);
        float r = yy + cr_r * vv;
        float g = yy + g_u * uu + g_v * vv;
        float b = yy + cb_b * uu;
        rrow[x] = L->srgb_inv[lut1024(fminf(fmaxf(r, 0.0f), 1.0f))];
        grow[x] = L->srgb_inv[lut1024(fminf(fmaxf(g, 0.0f), 1.0f))];
        brow[x] = L->srgb_inv[lut1024(fminf(fmaxf(b, 0.0f), 1.0f))];
      }
    };
#if defined(__AVX512F__)
    {
      const __m512 inv255 = _mm512_set1_ps(1.0f / 255.0f);
      const __m512 vcr = _mm512_set1_ps(cr_r), vgu = _mm512_set1_ps(g_u),
                   vgv = _mm512_set1_ps(g_v), vcb = _mm512_set1_ps(cb_b);
      const __m512 z = _mm512_setzero_ps(), one = _mm512_set1_ps(1.0f),
                   k1023 = _mm512_set1_ps(1023.0f), half = _mm512_set1_ps(0.5f);
      const __m512i imax = _mm512_set1_epi32(1023), iz = _mm512_setzero_si512();
      auto idx1024 = [&](__m512 v) {
        v = _mm512_min_ps(_mm512_max_ps(v, z), one);
        __m512i i = _mm512_cvttps_epi32(_mm512_fmadd_ps(v, k1023, half));
        return _mm512_min_epi32(_mm512_max_epi32(i, iz), imax);
      };
      for (int64_t x = 0; x < wsimd; x += 16) {
        __m512 yy = _mm512_mul_ps(_mm512_cvtepi32_ps(_mm512_cvtepu8_epi32(
            _mm_loadu_si128((const __m128i*)(yr + x)))), inv255);
        __m512 uu = _mm512_mul_ps(_mm512_loadu_ps(&ubuf[x]), inv255);
        __m512 vv = _mm512_mul_ps(_mm512_loadu_ps(&vbuf[x]), inv255);
        __m512 r = _mm512_fmadd_ps(vcr, vv, yy);
        __m512 g = _mm512_fmadd_ps(vgu, uu, _mm512_fmadd_ps(vgv, vv, yy));
        __m512 b = _mm512_fmadd_ps(vcb, uu, yy);
        _mm512_storeu_ps(&rrow[x],
            _mm512_i32gather_ps(idx1024(r), L->srgb_inv, 4));
        _mm512_storeu_ps(&grow[x],
            _mm512_i32gather_ps(idx1024(g), L->srgb_inv, 4));
        _mm512_storeu_ps(&brow[x],
            _mm512_i32gather_ps(idx1024(b), L->srgb_inv, 4));
      }
    }
#endif
    stage1_scalar(wsimd, w);

    auto gamut_pass = [&](int64_t x0, int64_t x1) {
      for (int64_t x = x0; x < x1; x++) {
        float r = rrow[x], g = grow[x], b = brow[x];
        rrow[x] = gamut_m[0] * r + gamut_m[1] * g + gamut_m[2] * b;
        grow[x] = gamut_m[3] * r + gamut_m[4] * g + gamut_m[5] * b;
        brow[x] = gamut_m[6] * r + gamut_m[7] * g + gamut_m[8] * b;
      }
    };
#if defined(__AVX512F__)
    auto gamut_simd = [&]() {
      __m512 m0 = _mm512_set1_ps(gamut_m[0]), m1 = _mm512_set1_ps(gamut_m[1]),
             m2 = _mm512_set1_ps(gamut_m[2]), m3 = _mm512_set1_ps(gamut_m[3]),
             m4 = _mm512_set1_ps(gamut_m[4]), m5 = _mm512_set1_ps(gamut_m[5]),
             m6 = _mm512_set1_ps(gamut_m[6]), m7 = _mm512_set1_ps(gamut_m[7]),
             m8 = _mm512_set1_ps(gamut_m[8]);
      for (int64_t x = 0; x < wsimd; x += 16) {
        __m512 r = _mm512_loadu_ps(&rrow[x]), g = _mm512_loadu_ps(&grow[x]),
               b = _mm512_loadu_ps(&brow[x]);
        _mm512_storeu_ps(&rrow[x], _mm512_fmadd_ps(m0, r,
            _mm512_fmadd_ps(m1, g, _mm512_mul_ps(m2, b))));
        _mm512_storeu_ps(&grow[x], _mm512_fmadd_ps(m3, r,
            _mm512_fmadd_ps(m4, g, _mm512_mul_ps(m5, b))));
        _mm512_storeu_ps(&brow[x], _mm512_fmadd_ps(m6, r,
            _mm512_fmadd_ps(m7, g, _mm512_mul_ps(m8, b))));
      }
    };
#endif
    if (gamut_m && gamut_pre) {
#if defined(__AVX512F__)
      gamut_simd();
#endif
      gamut_pass(wsimd, w);
    }

    // stages 2+3: gain factor per pixel, then (v + off_sdr)*gain - off_hdr.
    // k == 1 composes the whole gain chain into gain8 (see build above);
    // k > 1 runs the cell-hoisted Shepard IDW into planar gp rows, then
    // the 1024-grid gain LUT.
    if (k == 1) {
      int64_t my = y < mh ? y : mh - 1;
      // map sample rows as planar u8 (w <= mw at k == 1, so no right
      // clamp on the planar path; interleaved maps de-interleave here)
      const uint8_t* m0;
      const uint8_t* m1;
      const uint8_t* m2;
      if (gm_channels == 3 && gm_planar) {
        m0 = gm + my * mw;
        m1 = gm + mw * mh + my * mw;
        m2 = gm + 2 * mw * mh + my * mw;
      } else if (gm_channels == 3) {
        const uint8_t* mrow = gm + my * mw * 3;
        for (int64_t x = 0; x < w; x++) {
          int64_t mx = x < mw ? x : mw - 1;
          mexp[0][x] = mrow[mx * 3 + 0];
          mexp[1][x] = mrow[mx * 3 + 1];
          mexp[2][x] = mrow[mx * 3 + 2];
        }
        m0 = mexp[0].data();
        m1 = mexp[1].data();
        m2 = mexp[2].data();
      } else {
        m0 = m1 = m2 = gm + my * mw;
      }
      auto gain_scalar = [&](int64_t x0, int64_t x1) {
        for (int64_t x = x0; x < x1; x++) {
          rrow[x] = (rrow[x] + off_sdr[0]) * gain8[0][m0[x]] - off_hdr[0];
          grow[x] = (grow[x] + off_sdr[1]) * gain8[1][m1[x]] - off_hdr[1];
          brow[x] = (brow[x] + off_sdr[2]) * gain8[2][m2[x]] - off_hdr[2];
        }
      };
#if defined(__AVX512F__)
      {
        const __m512 os0 = _mm512_set1_ps(off_sdr[0]),
                     os1 = _mm512_set1_ps(off_sdr[1]),
                     os2 = _mm512_set1_ps(off_sdr[2]),
                     oh0 = _mm512_set1_ps(off_hdr[0]),
                     oh1 = _mm512_set1_ps(off_hdr[1]),
                     oh2 = _mm512_set1_ps(off_hdr[2]);
        for (int64_t x = 0; x < wsimd; x += 16) {
          __m512 gr = _mm512_i32gather_ps(_mm512_cvtepu8_epi32(
              _mm_loadu_si128((const __m128i*)(m0 + x))), gain8[0], 4);
          __m512 gg = _mm512_i32gather_ps(_mm512_cvtepu8_epi32(
              _mm_loadu_si128((const __m128i*)(m1 + x))), gain8[1], 4);
          __m512 gb = _mm512_i32gather_ps(_mm512_cvtepu8_epi32(
              _mm_loadu_si128((const __m128i*)(m2 + x))), gain8[2], 4);
          _mm512_storeu_ps(&rrow[x], _mm512_fmsub_ps(
              _mm512_add_ps(_mm512_loadu_ps(&rrow[x]), os0), gr, oh0));
          _mm512_storeu_ps(&grow[x], _mm512_fmsub_ps(
              _mm512_add_ps(_mm512_loadu_ps(&grow[x]), os1), gg, oh1));
          _mm512_storeu_ps(&brow[x], _mm512_fmsub_ps(
              _mm512_add_ps(_mm512_loadu_ps(&brow[x]), os2), gb, oh2));
        }
      }
#endif
      gain_scalar(wsimd, w);
    } else {
      // stage 2: IDW gain row into planar gp (gathers hoisted per k-wide
      // map cell — loop invariants of the cell's output pixels)
      int64_t my = y / k;
      int py = (int)(y % k);
      bool bottom = my >= mh - 1;
      int64_t my1 = bottom ? mh - 1 : my + 1;
      for (int64_t x = 0; x < w;) {
        int64_t mx = x / k;
        bool right = mx >= mw - 1;
        int64_t mx1 = right ? mw - 1 : mx + 1;
        int64_t xe = (mx + 1) * k;
        if (xe > w) xe = w;
        int t = (bottom ? 2 : 0) + (right ? 1 : 0);
        const float* wrow = &shep[((int64_t)(t * k + py) * k) * 4];
        for (int c = 0; c < gm_channels; c++) {
          const uint8_t* base = gm_planar ? gm + (int64_t)c * mw * mh : gm;
          int64_t stride = gm_planar ? 1 : gm_channels;
          int64_t coff = gm_planar ? 0 : c;
          float e1 = base[(my * mw + mx) * stride + coff];
          float e2 = base[(my1 * mw + mx) * stride + coff];
          float e3 = base[(my * mw + mx1) * stride + coff];
          float e4 = base[(my1 * mw + mx1) * stride + coff];
          for (int64_t xx = x; xx < xe; xx++) {
            const float* wt = &wrow[(xx - mx * k) * 4];
            float gv = (wt[0] * e1 + wt[1] * e2 + wt[2] * e3 + wt[3] * e4) *
                       (1.0f / 255.0f);
            if (!unit_gamma) gv = powf(fmaxf(gv, 0.0f), 1.0f / gamma[c]);
            gp[c][xx] = gv;
          }
        }
        if (gm_channels == 1) {
          for (int64_t xx = x; xx < xe; xx++) {
            gp[1][xx] = gp[0][xx];
            gp[2][xx] = gp[0][xx];
          }
        }
        x = xe;
      }
      // stage 3: the 1024-grid gain LUT (applyGainLUT,
      // gainmapmath.cpp:849-855) + offsets
      auto stage3_scalar = [&](int64_t x0, int64_t x1) {
        for (int64_t x = x0; x < x1; x++) {
          float gr = L->gainf[0][lut1024(gp[0][x])];
          float gg = L->gainf[1][lut1024(gp[1][x])];
          float gb = L->gainf[2][lut1024(gp[2][x])];
          rrow[x] = (rrow[x] + off_sdr[0]) * gr - off_hdr[0];
          grow[x] = (grow[x] + off_sdr[1]) * gg - off_hdr[1];
          brow[x] = (brow[x] + off_sdr[2]) * gb - off_hdr[2];
        }
      };
#if defined(__AVX512F__)
      {
        const __m512 z = _mm512_setzero_ps(), one = _mm512_set1_ps(1.0f),
                     k1023 = _mm512_set1_ps(1023.0f),
                     half = _mm512_set1_ps(0.5f);
        const __m512i imax = _mm512_set1_epi32(1023),
                      iz = _mm512_setzero_si512();
        const __m512 os0 = _mm512_set1_ps(off_sdr[0]),
                     os1 = _mm512_set1_ps(off_sdr[1]),
                     os2 = _mm512_set1_ps(off_sdr[2]),
                     oh0 = _mm512_set1_ps(off_hdr[0]),
                     oh1 = _mm512_set1_ps(off_hdr[1]),
                     oh2 = _mm512_set1_ps(off_hdr[2]);
        auto gidx = [&](const float* src, int64_t x) {
          __m512 v = _mm512_loadu_ps(src + x);
          v = _mm512_min_ps(_mm512_max_ps(v, z), one);
          __m512i i = _mm512_cvttps_epi32(_mm512_fmadd_ps(v, k1023, half));
          return _mm512_min_epi32(_mm512_max_epi32(i, iz), imax);
        };
        for (int64_t x = 0; x < wsimd; x += 16) {
          __m512 gr = _mm512_i32gather_ps(gidx(gp[0].data(), x),
                                          L->gainf[0], 4);
          __m512 gg = _mm512_i32gather_ps(gidx(gp[1].data(), x),
                                          L->gainf[1], 4);
          __m512 gb = _mm512_i32gather_ps(gidx(gp[2].data(), x),
                                          L->gainf[2], 4);
          _mm512_storeu_ps(&rrow[x], _mm512_fmsub_ps(
              _mm512_add_ps(_mm512_loadu_ps(&rrow[x]), os0), gr, oh0));
          _mm512_storeu_ps(&grow[x], _mm512_fmsub_ps(
              _mm512_add_ps(_mm512_loadu_ps(&grow[x]), os1), gg, oh1));
          _mm512_storeu_ps(&brow[x], _mm512_fmsub_ps(
              _mm512_add_ps(_mm512_loadu_ps(&brow[x]), os2), gb, oh2));
        }
      }
#endif
      stage3_scalar(wsimd, w);
    }

    if (gamut_m && !gamut_pre) {
#if defined(__AVX512F__)
      gamut_simd();
#endif
      gamut_pass(wsimd, w);
    }

    // stage 4: output transfer + pack
    if (out_ct == 0) {  // LINEAR -> RGBA F16 (clampPixelFloatLinear)
      auto s4_lin_scalar = [&](int64_t x0, int64_t x1) {
        for (int64_t x = x0; x < x1; x++) {
          float r = fminf(fmaxf(rrow[x], 0.0f), lin_max);
          float g = fminf(fmaxf(grow[x], 0.0f), lin_max);
          float b = fminf(fmaxf(brow[x], 0.0f), lin_max);
          uint16_t hr, hg, hb;
          _Float16 fr = (_Float16)r, fg = (_Float16)g, fb = (_Float16)b;
          memcpy(&hr, &fr, 2);
          memcpy(&hg, &fg, 2);
          memcpy(&hb, &fb, 2);
          out64[y * w + x] = (uint64_t)hr | ((uint64_t)hg << 16) |
                             ((uint64_t)hb << 32) | ((uint64_t)0x3C00 << 48);
        }
      };
#if defined(__AVX512F__)
      {
        const __m512 z = _mm512_setzero_ps(), vmax = _mm512_set1_ps(lin_max);
        auto halves = [&](const float* src, int64_t x) {
          __m512 v = _mm512_loadu_ps(src + x);
          v = _mm512_min_ps(_mm512_max_ps(v, z), vmax);
          // RNE, matching the scalar _Float16 cast
          return _mm512_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT
                                    | _MM_FROUND_NO_EXC);
        };
        for (int64_t x = 0; x < wsimd; x += 16) {
          __m256i hr = halves(rrow.data(), x);
          __m256i hg = halves(grow.data(), x);
          __m256i hb = halves(brow.data(), x);
          // rg = r | g<<16, ba = b | 0x3C00<<16 as u32 lanes, then widen
          __m512i rg = _mm512_or_si512(_mm512_cvtepu16_epi32(hr),
              _mm512_slli_epi32(_mm512_cvtepu16_epi32(hg), 16));
          __m512i ba = _mm512_or_si512(_mm512_cvtepu16_epi32(hb),
              _mm512_set1_epi32((int)0x3C000000u));
          __m512i lo64 = _mm512_or_si512(
              _mm512_cvtepu32_epi64(_mm512_castsi512_si256(rg)),
              _mm512_slli_epi64(_mm512_cvtepu32_epi64(
                  _mm512_castsi512_si256(ba)), 32));
          __m512i hi64 = _mm512_or_si512(
              _mm512_cvtepu32_epi64(_mm512_extracti64x4_epi64(rg, 1)),
              _mm512_slli_epi64(_mm512_cvtepu32_epi64(
                  _mm512_extracti64x4_epi64(ba, 1)), 32));
          _mm512_storeu_si512(out64 + y * w + x, lo64);
          _mm512_storeu_si512(out64 + y * w + x + 8, hi64);
        }
      }
#endif
      s4_lin_scalar(wsimd, w);
    } else {
      const bool hlg = out_ct == 1;
      auto s4_scalar = [&](int64_t x0, int64_t x1) {
        for (int64_t x = x0; x < x1; x++) {
          float r = fminf(fmaxf(rrow[x] * out_scale, 0.0f), 1.0f);
          float g = fminf(fmaxf(grow[x] * out_scale, 0.0f), 1.0f);
          float b = fminf(fmaxf(brow[x] * out_scale, 0.0f), 1.0f);
          if (hlg) { r = sqrtf(r); g = sqrtf(g); b = sqrtf(b); }
          uint32_t pr = L->oetf10[lut65536(r)];
          uint32_t pg = L->oetf10[lut65536(g)];
          uint32_t pb = L->oetf10[lut65536(b)];
          out32[y * w + x] = pr | (pg << 10) | (pb << 20) | (0x3u << 30);
        }
      };
#if defined(__AVX512F__)
      {
        const __m512 vsc = _mm512_set1_ps(out_scale), z = _mm512_setzero_ps(),
                     one = _mm512_set1_ps(1.0f),
                     k65535 = _mm512_set1_ps(65535.0f),
                     half = _mm512_set1_ps(0.5f);
        const __m512i imax = _mm512_set1_epi32(65535),
                      iz = _mm512_setzero_si512();
        auto chan = [&](const float* src, int64_t x) {
          __m512 v = _mm512_loadu_ps(src + x);
          v = _mm512_min_ps(_mm512_max_ps(_mm512_mul_ps(v, vsc), z), one);
          if (hlg) v = _mm512_sqrt_ps(v);
          __m512i i = _mm512_cvttps_epi32(_mm512_fmadd_ps(v, k65535, half));
          i = _mm512_min_epi32(_mm512_max_epi32(i, iz), imax);
          return _mm512_i32gather_epi32(i, oetf32.data(), 4);
        };
        const __m512i alpha = _mm512_set1_epi32((int)(0x3u << 30));
        for (int64_t x = 0; x < wsimd; x += 16) {
          __m512i pr = chan(rrow.data(), x);
          __m512i pg = _mm512_slli_epi32(chan(grow.data(), x), 10);
          __m512i pb = _mm512_slli_epi32(chan(brow.data(), x), 20);
          _mm512_storeu_si512(out32 + y * w + x, _mm512_or_si512(
              _mm512_or_si512(pr, pg), _mm512_or_si512(pb, alpha)));
        }
      }
#endif
      s4_scalar(wsimd, w);
    }
  }
  delete L;
  return 0;
}

// ---------------------------------------------------------------------------
// Fused fancy-upsample + YCbCr->packed-RGBA8888 for the SDR/base decode
// (the reference's SRGB output, jpegdecoderhelper.cpp DECODE_TO_RGB_CS):
// libjpeg jdsample.c h2v2/h2v1/h1v2 fancy (triangular) chroma upsample and
// jdcolor.c fixed-point conversion (kYcc tables above), emitting the
// library's packed little-endian RGBA (R lowest byte, A=255).  Bit-exact
// twin of decoder.py _ycc_to_rgb_np, SIMD'd: the vertical 3:1 blend and
// the horizontal (3*cs[c] + cs[c +- 1] + bias) >> sh run 16-wide in i16
// lanes; the color convert runs 8-wide in i32 lanes.
//
// sampling: 0=444, 1=420(h2v2), 2=422(h2v1), 3=440(h1v2),
//           4=411(1:4 int replication), 5=410(2x4 int replication).

namespace {

// out[2c]   = (3*cs[c] + cs[c-1] + be) >> sh
// out[2c+1] = (3*cs[c] + cs[c+1] + bo) >> sh     (cs: u16 column sums)
void h_fancy_row(const uint16_t* cs, int64_t cw, int64_t out_w,
                 int be, int bo, int sh, uint8_t* out) {
  int64_t c = 0;
#if defined(__AVX2__)
  const __m256i vbe = _mm256_set1_epi16((short)be);
  const __m256i vbo = _mm256_set1_epi16((short)bo);
  const __m256i v3 = _mm256_set1_epi16(3);
  if (cw > 1) {                     // c=0 scalar (left edge clamps)
    out[0] = (uint8_t)((3 * cs[0] + cs[0] + be) >> sh);
    if (out_w > 1) out[1] = (uint8_t)((3 * cs[0] + cs[1] + bo) >> sh);
    c = 1;
  }
  // vector body needs cs[c-1] (>=0 from c=1) and cs[c+16] (< cw)
  for (; c + 17 <= cw; c += 16) {
    __m256i cur = _mm256_loadu_si256((const __m256i*)(cs + c));
    __m256i left = _mm256_loadu_si256((const __m256i*)(cs + c - 1));
    __m256i right = _mm256_loadu_si256((const __m256i*)(cs + c + 1));
    __m256i t3 = _mm256_mullo_epi16(cur, v3);
    __m256i e = _mm256_srl_epi16(_mm256_add_epi16(_mm256_add_epi16(t3, left),
                                                  vbe),
                                 _mm_cvtsi32_si128(sh));
    __m256i o = _mm256_srl_epi16(_mm256_add_epi16(_mm256_add_epi16(t3, right),
                                                  vbo),
                                 _mm_cvtsi32_si128(sh));
    // interleave e/o pairs: out bytes [e0,o0,e1,o1,...].  packus works
    // per 128-bit lane, which recombines unpacklo/unpackhi into exactly
    // byte order e0o0..e7o7 | e8o8..e15o15.
    __m256i lo = _mm256_unpacklo_epi16(e, o);   // pairs 0-3 / 8-11
    __m256i hi = _mm256_unpackhi_epi16(e, o);   // pairs 4-7 / 12-15
    __m256i p = _mm256_packus_epi16(lo, hi);
    if (2 * c + 32 <= out_w) {
      _mm256_storeu_si256((__m256i*)(out + 2 * c), p);
    } else {
      alignas(32) uint8_t tmp[32];
      _mm256_store_si256((__m256i*)tmp, p);
      memcpy(out + 2 * c, tmp, (size_t)(out_w - 2 * c));
    }
  }
#endif
  for (; c < cw; c++) {
    int32_t t3 = 3 * cs[c];
    int32_t left = cs[c > 0 ? c - 1 : 0];
    int32_t right = cs[c + 1 < cw ? c + 1 : cw - 1];
    if (2 * c < out_w) out[2 * c] = (uint8_t)((t3 + left + be) >> sh);
    if (2 * c + 1 < out_w) out[2 * c + 1] = (uint8_t)((t3 + right + bo) >> sh);
  }
}

// column sums 3*near + far into a u16 row buffer (h2v2 vertical stage)
void v_sums_row(const uint8_t* nearr, const uint8_t* farr, int64_t cw,
                uint16_t* cs) {
  int64_t c = 0;
#if defined(__AVX2__)
  const __m256i v3 = _mm256_set1_epi16(3);
  for (; c + 16 <= cw; c += 16) {
    __m256i n = _mm256_cvtepu8_epi16(
        _mm_loadu_si128((const __m128i*)(nearr + c)));
    __m256i f = _mm256_cvtepu8_epi16(
        _mm_loadu_si128((const __m128i*)(farr + c)));
    _mm256_storeu_si256((__m256i*)(cs + c),
                        _mm256_add_epi16(_mm256_mullo_epi16(n, v3), f));
  }
#endif
  for (; c < cw; c++) cs[c] = (uint16_t)(3 * nearr[c] + farr[c]);
}

}  // namespace

extern "C" void uhdr_ycc_to_rgba32(const uint8_t* y, int64_t y_stride,
                                   const uint8_t* cb, const uint8_t* cr,
                                   int64_t c_stride, int64_t cw, int64_t ch,
                                   int64_t w, int64_t h, int sampling,
                                   uint32_t* out) {
  std::vector<uint8_t> cbu((size_t)w), cru((size_t)w);
  std::vector<uint16_t> cs((size_t)cw + 2);
  for (int64_t r = 0; r < h; r++) {
    const uint8_t* yr = y + r * y_stride;
    uint8_t* ub = cbu.data();
    uint8_t* vb = cru.data();
    for (int plane = 0; plane < 2; plane++) {
      const uint8_t* cp = plane ? cr : cb;
      uint8_t* dst = plane ? vb : ub;
      if (sampling == 0) {                     // 444
        dst = nullptr;                         // direct row below
      } else if (sampling == 1) {              // 420 h2v2 fancy
        int64_t crow = r >> 1;
        int64_t farrow = (r & 1) ? crow + 1 : crow - 1;
        if (farrow < 0) farrow = 0;
        if (farrow >= ch) farrow = ch - 1;
        v_sums_row(cp + crow * c_stride, cp + farrow * c_stride, cw,
                   cs.data());
        h_fancy_row(cs.data(), cw, w, 8, 7, 4, dst);
      } else if (sampling == 2) {              // 422 h2v1 fancy
        const uint8_t* src = cp + r * c_stride;
        for (int64_t c = 0; c < cw; c++) cs[(size_t)c] = src[c];
        h_fancy_row(cs.data(), cw, w, 1, 2, 2, dst);
      } else if (sampling == 3) {              // 440 h1v2 fancy (turbo)
        int64_t crow = r >> 1;
        int64_t farrow = (r & 1) ? crow + 1 : crow - 1;
        if (farrow < 0) farrow = 0;
        if (farrow >= ch) farrow = ch - 1;
        const uint8_t* nearr = cp + crow * c_stride;
        const uint8_t* farr = cp + farrow * c_stride;
        int bias = (r & 1) ? 2 : 1;
        for (int64_t c = 0; c < w; c++)
          dst[c] = (uint8_t)((3 * nearr[c] + farr[c] + bias) >> 2);
      } else if (sampling == 4) {              // 411: 1:4 replication
        const uint8_t* src = cp + r * c_stride;
        for (int64_t c = 0; c < w; c++) dst[c] = src[c >> 2];
      } else {                                 // 410: 2x4 replication
        const uint8_t* src = cp + (r >> 1) * c_stride;
        for (int64_t c = 0; c < w; c++) dst[c] = src[c >> 2];
      }
    }
    const uint8_t* ur = sampling == 0 ? cb + r * c_stride : ub;
    const uint8_t* vr = sampling == 0 ? cr + r * c_stride : vb;
    uint32_t* o = out + r * w;
    int64_t x = 0;
#if defined(__AVX2__)
    {
      const __m256i c128 = _mm256_set1_epi32(128);
      const __m256i kCrR = _mm256_set1_epi32(91881),
                    kCbB = _mm256_set1_epi32(116130),
                    kCrG = _mm256_set1_epi32(-46802),
                    kCbG = _mm256_set1_epi32(-22554);
      const __m256i half = _mm256_set1_epi32(32768);
      const __m256i z = _mm256_setzero_si256(), m255 = _mm256_set1_epi32(255);
      const __m256i alpha = _mm256_set1_epi32((int)0xFF000000u);
      for (; x + 8 <= w; x += 8) {
        __m256i yy = _mm256_cvtepu8_epi32(
            _mm_loadl_epi64((const __m128i*)(yr + x)));
        __m256i u = _mm256_sub_epi32(_mm256_cvtepu8_epi32(_mm_loadl_epi64(
                                         (const __m128i*)(ur + x))),
                                     c128);
        __m256i v = _mm256_sub_epi32(_mm256_cvtepu8_epi32(_mm_loadl_epi64(
                                         (const __m128i*)(vr + x))),
                                     c128);
        __m256i pr = _mm256_add_epi32(
            yy, _mm256_srai_epi32(
                    _mm256_add_epi32(_mm256_mullo_epi32(kCrR, v), half), 16));
        __m256i pg = _mm256_add_epi32(
            yy, _mm256_srai_epi32(
                    _mm256_add_epi32(
                        _mm256_add_epi32(_mm256_mullo_epi32(kCbG, u), half),
                        _mm256_mullo_epi32(kCrG, v)),
                    16));
        __m256i pb = _mm256_add_epi32(
            yy, _mm256_srai_epi32(
                    _mm256_add_epi32(_mm256_mullo_epi32(kCbB, u), half), 16));
        pr = _mm256_min_epi32(_mm256_max_epi32(pr, z), m255);
        pg = _mm256_min_epi32(_mm256_max_epi32(pg, z), m255);
        pb = _mm256_min_epi32(_mm256_max_epi32(pb, z), m255);
        __m256i px = _mm256_or_si256(
            _mm256_or_si256(pr, _mm256_slli_epi32(pg, 8)),
            _mm256_or_si256(_mm256_slli_epi32(pb, 16), alpha));
        _mm256_storeu_si256((__m256i*)(o + x), px);
      }
    }
#endif
    for (; x < w; x++) {
      int32_t yy = yr[x];
      int pr = yy + kYcc.cr_r[vr[x]];
      int pg = yy + ((kYcc.cb_g[ur[x]] + kYcc.cr_g[vr[x]]) >> 16);
      int pb = yy + kYcc.cb_b[ur[x]];
      pr = pr < 0 ? 0 : (pr > 255 ? 255 : pr);
      pg = pg < 0 ? 0 : (pg > 255 ? 255 : pg);
      pb = pb < 0 ? 0 : (pb > 255 ? 255 : pb);
      o[x] = (uint32_t)pr | ((uint32_t)pg << 8) | ((uint32_t)pb << 16)
             | 0xFF000000u;
    }
  }
}
