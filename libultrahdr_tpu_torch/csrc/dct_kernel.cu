// Scan build on Hopper (sm_90a), hand-written in CUDA C++: one launch turns
// a JPEG scan's unpadded uint8 source planes into the pack kernel's inputs
// (csrc/pack_kernel.cu): the MCU edge pad, the RGB -> YCbCr conversion of a
// 3-channel gain map, the level shift, 8x8 FDCT, quantisation and zigzag of
// every block, the MCU interleave and the DC differences.
//
// The JAX package computes the DCT as two HIGHEST-precision matrix products
// (libultrahdr_tpu/jpeg/dct.py forward_plane, libultrahdr_tpu/fused.py
// _scan_coeffs) and the stream glue as XLA ops
// (libultrahdr_tpu/jpeg/pack_kernel.py _stream_inputs); it reaches no Pallas
// kernel.  The port needs each coefficient to be the same rounded float32
// sequence whatever the plane's size: a row shard of an image must get its
// blocks' coefficients bit for bit (parallel/batch.py), and a batched matrix
// product does not give that.  The plain version (jpeg/dct.py
// scan_inputs_plain) is the composition pad_edge -> rgb_to_ycbcr ->
// forward_plane_plain -> device_entropy.stream_inputs -> concatenation in
// elementwise tensor ops; this kernel computes the same bits.
//
// Arithmetic, each operation rounded on its own (the _rn intrinsics: a
// contracted multiply-add would round once where the plain version rounds
// twice), in the plain version's order:
//   RGB source: y  = (0.299 r + 0.587 g) + 0.114 b,
//               cb = ((-0.168735892 r - 0.331264108 g) + 0.5 b) + 128,
//               cr = ((0.5 r - 0.418687589 g) - 0.081312411 b) + 128,
//               each rounded half to even and clamped to [0, 255];
//   x = sample - 128;
//   t[u][c] = sum over k = 0..7, in order, of D[u][k] * x[k][c];
//   y[u][v] = sum over k = 0..7, in order, of t[u][k] * D[v][k];
//   q[u][v] = rint(y[u][v] / Q[u][v]) (a correctly rounded division, then
//             half to even), as int16 at its zigzag position.
// Exact steps take cheap forms: a byte becomes a float as the bits of
// 2^23 + byte less 2^23 (no conversion instruction), and rint(v) for
// |v| < 2^22 is (v + 1.5 * 2^23) - 1.5 * 2^23, whose integer is the low
// bits of the sum.  No tensor cores: a wgmma product sums in its own order.
//
// Outputs, for block i of the scan in MCU stream order (T.81 A.2.3): the
// 64 coefficients at stream[i], dc_diff[i] (its DC less the DC of the
// previous block of its component in that order, 0 for the first block of
// an MCU row: one restart interval per MCU row) and is_luma[i].
//
// What bounds it on the H100: device memory and the float32 issue rate
// about equally.  A block moves 64 source bytes (a 3-channel map's: 64 per
// channel and component) and 136 output bytes; it costs 1,920 separate
// float32 multiplies and adds (no FMA allowed), 64 divisions and ~30
// more operations a sample for an RGB source's conversion.  Measured
// (PERF.md), neither binds: the work around the arithmetic inside the SM
// (the transpose and the zigzag staging through shared memory, four warp
// barriers a block, the stores) costs about as much as the arithmetic,
// and the two do not overlap.
//
// Design.  A CTA of 256 threads is 32 groups of 8; each group takes one MCU
// of one MCU row and runs its blocks in turn, so a warp holds four
// neighbouring MCUs and its loads of a source row are contiguous.  Group 0
// takes the MCU left of the CTA's 31 and writes nothing: it computes only
// the DCs its right neighbour's first blocks need, so no second pass and no
// cross-CTA dependency.  Per block, thread c loads column c of the block
// (coordinates clamped to the component's plane: the edge pad costs no
// pass) and runs the column pass; the group transposes t through shared
// memory (a 72-float row per group, so the four groups of a warp start in
// distinct banks, each half-row swizzled so that the row reads are free of
// conflicts); thread u runs the row pass for row u, divides and rounds, and
// writes each coefficient at its zigzag position in a 64-half staging row,
// which the 8 threads then store as one 128-byte line of 16-byte vectors.
// An RGB source's three channels are loaded and converted once per MCU.
// After one CTA barrier, each group writes its blocks' DC differences and
// luma flags.  Each thread holds 8 values a pass, not a block's 64.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 32;             // groups of 8 threads a CTA
constexpr int kThreads = kGroups * 8;
constexpr int kStrip = kGroups - 1;     // MCUs a CTA writes
constexpr int kMaxBlocks = 10;          // blocks an MCU (T.81 B.2.3)
constexpr int kTRow = 72;               // floats of a group's t buffer

}  // namespace

// By value in the kernel's parameters.  Outside the anonymous namespace:
// the C entry point takes it, and a type of internal linkage would make
// that symbol internal too.
struct ScanParams {
  float d[64];                   // D row-major: D[u][k] at u * 8 + k
  float q[3][64];                // each component's table, natural order
  int pos[64];                   // each natural index's zigzag position
  const uint8_t* src[3];         // Y, Cb, Cr planes, or R, G, B
  int64_t stride[3];             // row strides in bytes
  int h[3], w[3];                // each source plane's size
  int hs[3], vs[3];              // sampling factors
  int comp_of[kMaxBlocks];       // an MCU's block -> its component,
  int prev_of[kMaxBlocks];       //    the MCU block before it in its
                                 //    component's order (in the MCU to the
                                 //    left when first_of)
  int first_of[kMaxBlocks];
  int n_comp, mcus_w, mcus_h, bpm, bpr;
};

namespace {

__device__ __forceinline__ float byte_value(uint32_t b) {
  return __fsub_rn(__int_as_float(0x4B000000u | b), 8388608.0f);
}

__device__ __forceinline__ float level_shifted(uint32_t b) {
  return __fsub_rn(__int_as_float(0x4B000000u | b), 8388736.0f);
}

// rint(v), half to even, for |v| < 2^22
__device__ __forceinline__ float round_even(float v) {
  return __fsub_rn(__fadd_rn(v, 12582912.0f), 12582912.0f);
}

__device__ __forceinline__ int round_to_int(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;
}

// rgb_to_ycbcr's sample of component c, level-shifted
__device__ __forceinline__ float ycc_level_shifted(int c, float r, float g,
                                                   float b) {
  float v;
  if (c == 0) {
    v = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                  __fmul_rn(0.114f, b));
  } else if (c == 1) {
    v = __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(-0.168735892f, r),
                                      __fmul_rn(0.331264108f, g)),
                            __fmul_rn(0.5f, b)), 128.0f);
  } else {
    v = __fadd_rn(__fsub_rn(__fsub_rn(__fmul_rn(0.5f, r),
                                      __fmul_rn(0.418687589f, g)),
                            __fmul_rn(0.081312411f, b)), 128.0f);
  }
  return __fsub_rn(fminf(fmaxf(round_even(v), 0.0f), 255.0f), 128.0f);
}

struct Comp {
  const uint8_t* src;
  int64_t stride;
  int h, w, hs, vs;
};

template <bool kRgb>
__global__ void __launch_bounds__(kThreads, 4)
scan_kernel(const ScanParams p, int16_t* __restrict__ stream,
            int32_t* __restrict__ dc_diff, int32_t* __restrict__ is_luma) {
  __shared__ __align__(16) float tbuf[kGroups * kTRow];
  __shared__ __align__(16) int16_t obuf[kGroups * 64];
  __shared__ float qs[3 * 64];
  __shared__ int zzs[64];
  __shared__ int dcs[kGroups * kMaxBlocks];
  __shared__ Comp comps[3];
  __shared__ int blk[3][kMaxBlocks];

  for (int i = threadIdx.x; i < 3 * 64; i += kThreads)
    qs[i] = p.q[i >> 6][i & 63];
  if (threadIdx.x < 64) zzs[threadIdx.x] = p.pos[threadIdx.x];
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    comps[c] = Comp{p.src[c], p.stride[c], p.h[c], p.w[c], p.hs[c], p.vs[c]};
  }
  if (threadIdx.x < kMaxBlocks) {
    blk[0][threadIdx.x] = p.comp_of[threadIdx.x];
    blk[1][threadIdx.x] = p.prev_of[threadIdx.x];
    blk[2][threadIdx.x] = p.first_of[threadIdx.x];
  }
  __syncthreads();

  // group g takes MCU j of MCU row m; group 0 the one left of the strip
  const int g = threadIdx.x >> 3, lane = threadIdx.x & 7;
  const unsigned mask = 0xFFu << (threadIdx.x & 24);
  const int m = blockIdx.y;
  const int j = static_cast<int>(blockIdx.x) * kStrip + g - 1;
  const bool live = j >= 0 && j < p.mcus_w;
  const bool writes = live && g > 0;
  const int64_t first = static_cast<int64_t>(m) * p.bpr
                        + static_cast<int64_t>(j) * p.bpm;
  float* tb = tbuf + g * kTRow;
  int16_t* ob = obuf + g * 64;
  int zz[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) zz[v] = zzs[lane * 8 + v];

  if (live) {
    float rgb[3][8];
    if constexpr (kRgb) {
      // a 3-channel map: 4:4:4, one block a component, one plane size
      const Comp& c0 = comps[0];
      const int64_t col = min(j * 8 + lane, c0.w - 1);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int64_t at = min(m * 8 + k, c0.h - 1) * c0.stride + col;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          rgb[ch][k] = byte_value(__ldg(comps[ch].src + at));
      }
    }
    int b = 0;
    for (int c = 0; c < p.n_comp; ++c) {
      const Comp& cp = comps[c];
      const float* q = qs + c * 64 + lane * 8;
      for (int v = 0; v < cp.vs; ++v) {
        for (int h = 0; h < cp.hs; ++h, ++b) {
          // column `lane` of the block, level-shifted
          float x[8];
          if constexpr (kRgb) {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              x[k] = ycc_level_shifted(c, rgb[0][k], rgb[1][k], rgb[2][k]);
          } else {
            const int y0 = (m * cp.vs + v) * 8;
            const int64_t col = min((j * cp.hs + h) * 8 + lane, cp.w - 1);
#pragma unroll
            for (int k = 0; k < 8; ++k)
              x[k] = level_shifted(__ldg(
                  cp.src + min(y0 + k, cp.h - 1) * cp.stride + col));
          }
          // column pass: t[u][lane] = sum_k D[u][k] x[k][lane], into the
          // group's buffer at row u, half-rows swapped on rows 4-7
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            float acc = __fmul_rn(p.d[u * 8], x[0]);
#pragma unroll
            for (int k = 1; k < 8; ++k)
              acc = __fadd_rn(acc, __fmul_rn(p.d[u * 8 + k], x[k]));
            tb[u * 8 + ((((lane >> 2) ^ (u >> 2)) & 1) << 2) + (lane & 3)] =
                acc;
          }
          __syncwarp(mask);
          float t[8];
          const int swap = (lane >> 2) & 1;
          const float4 lo = *reinterpret_cast<const float4*>(
              tb + lane * 8 + (swap << 2));
          const float4 hi = *reinterpret_cast<const float4*>(
              tb + lane * 8 + ((swap ^ 1) << 2));
          t[0] = lo.x; t[1] = lo.y; t[2] = lo.z; t[3] = lo.w;
          t[4] = hi.x; t[5] = hi.y; t[6] = hi.z; t[7] = hi.w;
          __syncwarp(mask);
          // row pass for row u = lane: y[u][v] = sum_k t[u][k] D[v][k]
#pragma unroll
          for (int v2 = 0; v2 < 8; ++v2) {
            float acc = __fmul_rn(t[0], p.d[v2 * 8]);
#pragma unroll
            for (int k = 1; k < 8; ++k)
              acc = __fadd_rn(acc, __fmul_rn(t[k], p.d[v2 * 8 + k]));
            const int qv = round_to_int(__fdiv_rn(acc, q[v2]));
            ob[zz[v2]] = static_cast<int16_t>(qv);
            if (v2 == 0 && lane == 0) dcs[g * kMaxBlocks + b] = qv;
          }
          __syncwarp(mask);
          if (writes)
            reinterpret_cast<int4*>(stream + (first + b) * 64)[lane] =
                reinterpret_cast<const int4*>(ob)[lane];
          __syncwarp(mask);
        }
      }
    }
  }
  if (dc_diff == nullptr) return;
  __syncthreads();
  if (writes) {
    for (int b = lane; b < p.bpm; b += 8) {
      const int prev = blk[1][b];
      int before = 0;
      if (!blk[2][b])
        before = dcs[g * kMaxBlocks + prev];
      else if (j > 0)
        before = dcs[(g - 1) * kMaxBlocks + prev];
      dc_diff[first + b] = dcs[g * kMaxBlocks + b] - before;
      is_luma[first + b] = blk[0][b] == 0;
    }
  }
}

}  // namespace

// uhdr_build_scan: `params` a host pointer to the ScanParams (copied into
// the launch), `rgb` nonzero when the three sources are R, G, B (4:4:4);
// `stream` (mcus_h * bpr, 64) int16, 16-byte aligned, `dc_diff` and
// `is_luma` (mcus_h * bpr,) int32 on the device, at the scan's first block
// (the last two may both be null: the coefficients alone); `cuda_stream`
// the caller's cudaStream_t.  Returns a cudaError_t code, 0 on success.
extern "C" int uhdr_build_scan(const ScanParams* params, int rgb,
                               int16_t* stream, int32_t* dc_diff,
                               int32_t* is_luma, void* cuda_stream) {
  const ScanParams& p = *params;
  if (p.mcus_w == 0 || p.mcus_h == 0) return 0;
  const dim3 grid((p.mcus_w + kStrip - 1) / kStrip, p.mcus_h);
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (rgb)
    scan_kernel<true><<<grid, kThreads, 0, s>>>(p, stream, dc_diff, is_luma);
  else
    scan_kernel<false><<<grid, kThreads, 0, s>>>(p, stream, dc_diff,
                                                 is_luma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
