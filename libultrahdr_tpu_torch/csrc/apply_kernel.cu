// Apply-gainmap on Hopper (sm_90a), hand-written in CUDA C++: the decode's
// device hot op, from SDR YUV and a full-resolution gain to packed HDR
// pixels.
//
// Replaces the Pallas TPU kernel libultrahdr_tpu/ops/pallas_apply.py
// apply_gainmap_pallas, both branches: _kernel_1010102 (HLG and PQ output,
// RGBA1010102) and _kernel_f16 (LINEAR output, RGBA half floats), whose
// per-pixel math is _apply_tile_channels.  Per pixel:
//   1. Rec.601 YUV -> RGB (the P3 matrix), clip to [0, 1];
//   2. the sRGB inverse OETF at the 1024-entry LUT grid;
//   3. the gamut matrix, unless use_base_cg;
//   4. per channel: gamma (pow 1/gamma where gamma != 1), the 1024-grid
//      snap, the log2 lerp between min and max boost, times
//      exp2(weight * ...), with the SDR and HDR offsets;
//   5. LINEAR: the post-gamut (the gamut matrix when use_base_cg, else the
//      identity), a clip to [0, 10000/203] and half floats with alpha
//      half(1.0); HLG: scale by 203/1000, post-gamut, clip, pow 1/1.2 (the
//      inverse OOTF approximation) and the HLG OETF at the 65536 grid; PQ:
//      scale by 203/10000, post-gamut, clip and the PQ OETF at the 65536
//      grid;
//   6. HLG/PQ: round(x * 1023) half to even, packed with alpha 0x3 << 30.
//
// What bounds it on the H100: device memory.  It is elementwise with about
// a dozen transcendentals per pixel; at 3840x2160 it reads six f32 planes
// (3 SDR + 3 gain, 199 MB; a 1-channel gain is read once for all three
// channels) and writes 33 MB (RGBA1010102) or 66 MB (RGBAF16).  Design:
// one thread per output pixel on a 2-D grid of 32x8 blocks over (H, W), so
// a warp reads 128 contiguous bytes of each plane; the ragged edge is
// masked, nothing is padded (the TPU kernel padded to 256x512 tiles).  The
// gain is addressed with a channel stride, 0 for a single-channel map, so
// its broadcast is never materialised.  The metadata rows, the weight and
// the matrices are kernel arguments (the TPU kernel's SMEM scalars), the
// output transfer a template parameter.  LINEAR stores one 8-byte
// (r, g, b, a) half quadruple per pixel, so the TPU's lo/hi u32 pair and
// its host-side stack disappear.  Reading the u8 planes directly and
// folding the IDW upsample in would cut the bytes further; that is later
// work.
//
// Rounding follows the plain PyTorch version (ops/apply_kernel.py
// apply_gainmap_plain) as it runs on the card: every product, sum and
// quotient is written with the _rn intrinsics, which nvcc never contracts
// into an FMA (PyTorch runs each of those as a separate kernel); the
// transcendentals are the CUDA math library's powf/log2f/exp2f/logf/sqrtf
// that PyTorch's CUDA kernels call; a division by a Python constant is a
// multiplication by its reciprocal, as PyTorch's CUDA true-divide by a host
// scalar is (so on the card the plain version and the kernel differ from
// the CPU's true division by an ulp now and then); rintf rounds half to
// even like torch.round, and
// __float2half_rn converts like Tensor.to(float16).

#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

// Kernel arguments; the layout matches ops/apply_kernel.py _ApplyParams.
// Outside the anonymous namespace: the exported C entry point takes it.
struct ApplyParams {
  float yuv2rgb[9];  // row-major Rec.601 (P3) YUV -> RGB
  float gamut[9];    // row-major SDR gamut -> HDR gamut
  float meta[15];    // rows gamma, min boost, max boost, offset SDR,
                     // offset HDR, each with 3 channels
  float weight;
  int use_base_cg;
};

namespace {

// the output transfer, ColorTransfer's values in types.py
constexpr int kLinear = 0;
constexpr int kHlg = 1;
constexpr int kPq = 2;

__device__ __forceinline__ float f_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float f_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float f_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float f_div(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// lut_parity.lut_quantize: snap x to the N-entry LUT grid (round half up)
template <int N>
__device__ __forceinline__ float lut_quantize(float x) {
  const float n1 = static_cast<float>(N - 1);
  const float idx = clamp(floorf(f_add(f_mul(x, n1), 0.5f)), 0.0f, n1);
  return f_mul(idx, static_cast<float>(1.0 / (N - 1)));
}

// (a*x0 + b*x1) + c*x2 for each row of a row-major 3x3 matrix
__device__ __forceinline__ void mat3(const float* m, float* c) {
  float r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = f_add(f_add(f_mul(m[3 * i], c[0]), f_mul(m[3 * i + 1], c[1])),
               f_mul(m[3 * i + 2], c[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = r[i];
}

// the gamut matrix when use_base_cg, else the identity, which is multiplied
// out too (1*x + 0*y + 0*z), as the plain version does
__device__ __forceinline__ void post_gamut(const ApplyParams& p, float* c) {
  if (p.use_base_cg) {
    mat3(p.gamut, c);
  } else {
    const float identity[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    mat3(identity, c);
  }
}

// PyTorch's CUDA true-divide by a Python float c multiplies by the float
// rounding of the double 1/c (which differs from 1.0f / 1.055f)
__device__ __forceinline__ float srgb_inv_oetf(float e) {
  constexpr float inv_12_92 = static_cast<float>(1.0 / 12.92);
  constexpr float inv_1_055 = static_cast<float>(1.0 / 1.055);
  const float lo = f_mul(e, inv_12_92);
  const float hi = powf(clamp_min(f_mul(f_add(e, 0.055f), inv_1_055), 0.0f),
                        2.4f);
  return e <= 0.04045f ? lo : hi;
}

__device__ __forceinline__ float hlg_oetf(float e) {
  constexpr float a = static_cast<float>(0.17883277);
  constexpr float b = static_cast<float>(0.28466892);
  constexpr float c = static_cast<float>(0.55991073);
  const float lo = sqrtf(clamp_min(f_mul(3.0f, e), 0.0f));
  const float hi = f_add(f_mul(a, logf(clamp_min(f_sub(f_mul(12.0f, e), b),
                                             1e-37f))), c);
  return e <= static_cast<float>(1.0 / 12.0) ? lo : hi;
}

__device__ __forceinline__ float pq_oetf(float e) {
  constexpr float m1 = static_cast<float>(2610.0 / 16384.0);
  constexpr float m2 = static_cast<float>(2523.0 / 4096.0 * 128.0);
  constexpr float c1 = static_cast<float>(3424.0 / 4096.0);
  constexpr float c2 = static_cast<float>(2413.0 / 4096.0 * 32.0);
  constexpr float c3 = static_cast<float>(2392.0 / 4096.0 * 32.0);
  const float ep = powf(clamp_min(e, 0.0f), m1);
  const float v = powf(f_div(f_add(c1, f_mul(c2, ep)),
                             f_add(1.0f, f_mul(c3, ep))),
                       m2);
  return e <= 0.0f ? 0.0f : v;
}

__device__ __forceinline__ uint32_t code10(float x) {
  return static_cast<uint32_t>(static_cast<int>(
      rintf(f_mul(clamp(x, 0.0f, 1.0f), 1023.0f))));
}

template <int kCt>
__global__ void __launch_bounds__(256)
apply_gainmap_kernel(const float* __restrict__ sdr,
                     const float* __restrict__ gain, int64_t gain_cstride,
                     int h, int w, ApplyParams p, void* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t i = static_cast<int64_t>(y) * w + x;

  float rgb[3] = {sdr[i], sdr[plane + i], sdr[2 * plane + i]};
  mat3(p.yuv2rgb, rgb);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[c] = srgb_inv_oetf(lut_quantize<1024>(clamp(rgb[c], 0.0f, 1.0f)));
  if (!p.use_base_cg) mat3(p.gamut, rgb);

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gamma = p.meta[c], min_b = p.meta[3 + c];
    const float max_b = p.meta[6 + c], off_s = p.meta[9 + c];
    const float off_h = p.meta[12 + c];
    float g = gain[c * gain_cstride + i];
    if (gamma != 1.0f) g = powf(clamp_min(g, 0.0f), f_div(1.0f, gamma));
    g = lut_quantize<1024>(clamp(g, 0.0f, 1.0f));
    const float log_boost = f_add(f_mul(log2f(min_b), f_sub(1.0f, g)),
                                f_mul(log2f(max_b), g));
    const float factor = exp2f(f_mul(log_boost, p.weight));
    rgb[c] = f_sub(f_mul(f_add(rgb[c], off_s), factor), off_h);
  }

  if (kCt == kLinear) {
    post_gamut(p, rgb);
    const float hi_lim = static_cast<float>(10000.0 / 203.0);
    ushort4 px;
    px.x = __half_as_ushort(__float2half_rn(clamp(rgb[0], 0.0f, hi_lim)));
    px.y = __half_as_ushort(__float2half_rn(clamp(rgb[1], 0.0f, hi_lim)));
    px.z = __half_as_ushort(__float2half_rn(clamp(rgb[2], 0.0f, hi_lim)));
    px.w = 0x3C00;  // half(1.0)
    static_cast<ushort4*>(out)[i] = px;
    return;
  }
  const float scale = kCt == kHlg ? static_cast<float>(203.0 / 1000.0)
                                  : static_cast<float>(203.0 / 10000.0);
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = f_mul(rgb[c], scale);
  post_gamut(p, rgb);
  uint32_t packed = 0x3u << 30;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = clamp(rgb[c], 0.0f, 1.0f);
    if (kCt == kHlg) {
      v = powf(clamp_min(v, 0.0f), static_cast<float>(1.0 / 1.2));
      v = hlg_oetf(lut_quantize<65536>(v));
    } else {
      v = pq_oetf(lut_quantize<65536>(v));
    }
    packed |= code10(v) << (10 * c);
  }
  static_cast<uint32_t*>(out)[i] = packed;
}

}  // namespace

// Plain C interface for ctypes.  `sdr` is (3, h, w) f32, `gain` (C, h, w)
// f32 with channel stride `gain_cstride` elements (0 when C == 1), `out`
// (h, w) u32 for HLG/PQ or (h, w, 4) u16 for LINEAR, all device pointers;
// `params` is a host pointer, copied into the launch; `stream` is the
// caller's cudaStream_t.  Returns cudaGetLastError() right after the launch
// (0 when it was accepted), or cudaErrorInvalidValue for an unknown
// transfer.
extern "C" int uhdr_apply_gainmap(const float* sdr, const float* gain,
                                  int64_t gain_cstride, int h, int w,
                                  const ApplyParams* params, int out_ct,
                                  void* out, void* cuda_stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  const auto s = static_cast<cudaStream_t>(cuda_stream);
  switch (out_ct) {
    case kLinear:
      apply_gainmap_kernel<kLinear><<<grid, block, 0, s>>>(
          sdr, gain, gain_cstride, h, w, *params, out);
      break;
    case kHlg:
      apply_gainmap_kernel<kHlg><<<grid, block, 0, s>>>(
          sdr, gain, gain_cstride, h, w, *params, out);
      break;
    case kPq:
      apply_gainmap_kernel<kPq><<<grid, block, 0, s>>>(
          sdr, gain, gain_cstride, h, w, *params, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
