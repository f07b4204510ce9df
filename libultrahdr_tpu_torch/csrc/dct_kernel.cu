// Forward DCT on Hopper (sm_90a), hand-written in CUDA C++: the encode's
// level shift, 8x8 FDCT, quantisation and zigzag of one uint8 plane.
//
// The JAX package computes this as two HIGHEST-precision matrix products
// (libultrahdr_tpu/jpeg/dct.py forward_plane); it reaches no Pallas kernel.
// The port needs each coefficient to be the same rounded float32 sequence
// whatever the plane's size: a row shard of an image must get its blocks'
// coefficients bit for bit (parallel/batch.py), and a batched matrix
// product does not give that, since the library picks its kernel, and with
// it the summation order, by the batch size.  The plain version
// (jpeg/dct.forward_plane_plain) fixes the order with elementwise tensor
// ops, about 30 launches with full-size float32 temporaries; this kernel
// does the same arithmetic in one launch.
//
// Per 8x8 block, with x = sample - 128 and D the orthonormal DCT-II matrix:
//   t[u][c] = sum over k = 0..7, in order, of D[u][k] * x[k][c]
//   y[u][v] = sum over k = 0..7, in order, of t[u][k] * D[v][k]
//   q[u][v] = rint(y[u][v] / Q[u][v])  (half to even), as int16
// every product and sum rounded on its own (__fmul_rn / __fadd_rn: no
// fused multiply-add, which would round once where the plain version
// rounds twice) and the division correctly rounded (nvcc's default
// -prec-div=true), so the result equals the plain version's bit for bit on
// the CPU and on the card.  The output is (H/8, W/8, 64) int16, each
// block's coefficients in zigzag order.
//
// What bounds it on the H100: device memory.  A plane of n blocks reads
// 64 n bytes and writes 128 n; the arithmetic, 1,024 multiplies and adds
// and 64 divisions a block, is far under the float32 peak.
//
// Design.  A thread per block and 128 blocks a CTA.  A thread loads its
// block as eight 8-byte rows (adjacent threads read adjacent rows of
// pixels, so a warp's loads are contiguous), runs the column pass one
// column at a time from the packed bytes, then the row pass, and writes
// each quantised coefficient at its zigzag position in a shared-memory
// row of 66 halves (33 words: consecutive threads' rows start in
// consecutive banks).  The CTA's 128 blocks are 16 KB contiguous in the
// output, which its threads then store word by word, coalesced.

#include <cstdint>

#include <cuda_runtime.h>

// By value in the kernel's parameters: D row-major (D[u][k] at u * 8 + k),
// the quantisation table in natural order, and each natural index's zigzag
// position.  Outside the anonymous namespace: the C entry point takes it,
// and a type of internal linkage would make that symbol internal too.
struct DctParams {
  float d[64];
  float q[64];
  int pos[64];
};

namespace {

constexpr int kThreads = 128;
constexpr int kRowHalves = 66;     // 64 coefficients + 2 halves of padding

__global__ void __launch_bounds__(kThreads)
forward_dct_kernel(const uint8_t* __restrict__ plane, int64_t width,
                   int64_t blocks_w, int64_t n_blocks, const DctParams p,
                   int16_t* __restrict__ out) {
  __shared__ int16_t stage[kThreads * kRowHalves];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t b = first + threadIdx.x;
  if (b < n_blocks) {
    const int64_t by = b / blocks_w;
    const int64_t bx = b - by * blocks_w;
    const uint8_t* src = plane + by * 8 * width + bx * 8;
    uint2 rows[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      rows[r] = __ldg(reinterpret_cast<const uint2*>(src + r * width));
    // column pass: t[u][c] = sum_k D[u][k] x[k][c]
    float t[8][8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t word = c < 4 ? rows[k].x : rows[k].y;
        x[k] = static_cast<float>((word >> (8 * (c & 3))) & 0xFFu) - 128.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float acc = __fmul_rn(p.d[u * 8], x[0]);
#pragma unroll
        for (int k = 1; k < 8; ++k)
          acc = __fadd_rn(acc, __fmul_rn(p.d[u * 8 + k], x[k]));
        t[u][c] = acc;
      }
    }
    // row pass, quantisation, zigzag: y[u][v] = sum_k t[u][k] D[v][k]
    int16_t* row = stage + threadIdx.x * kRowHalves;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float acc = __fmul_rn(t[u][0], p.d[v * 8]);
#pragma unroll
        for (int k = 1; k < 8; ++k)
          acc = __fadd_rn(acc, __fmul_rn(t[u][k], p.d[v * 8 + k]));
        const int n = u * 8 + v;
        row[p.pos[n]] = static_cast<int16_t>(rintf(acc / p.q[n]));
      }
    }
  }
  __syncthreads();
  // the CTA's blocks, 32 words each, stored word by word
  const int64_t live = n_blocks - first < kThreads ? n_blocks - first
                                                   : kThreads;
  const uint32_t* stage32 = reinterpret_cast<const uint32_t*>(stage);
  uint32_t* out32 = reinterpret_cast<uint32_t*>(out) + first * 32;
  for (int i = threadIdx.x; i < live * 32; i += kThreads)
    out32[i] = stage32[(i >> 5) * (kRowHalves / 2) + (i & 31)];
}

}  // namespace

// uhdr_forward_dct: `plane` is an (h, w) uint8 plane on the device,
// contiguous and 8-byte aligned, h and w multiples of 8; `params` a host
// pointer to the DctParams (copied into the launch); `out` (h/8, w/8, 64)
// int16 on the device; `cuda_stream` the caller's cudaStream_t.  Returns a
// cudaError_t code, 0 on success.
extern "C" int uhdr_forward_dct(const uint8_t* plane, int64_t h, int64_t w,
                                const DctParams* params, int16_t* out,
                                void* cuda_stream) {
  const int64_t n_blocks = (h / 8) * (w / 8);
  if (n_blocks == 0) return 0;
  const int64_t grid = (n_blocks + kThreads - 1) / kThreads;
  forward_dct_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
      plane, w, w / 8, n_blocks, *params, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
