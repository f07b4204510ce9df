// The wire codecs' device halves on Hopper (sm_90a), hand-written in CUDA
// C++: two kernels, bound by ops/wire_kernel.py.
//
// The JAX package computes both with XLA ops (libultrahdr_tpu/fused.py) and
// reaches no Pallas kernel for them.  In eager PyTorch each is 30-60 launches
// over 50-100 MB at 4K, so each is one kernel here (two launches for the
// second), equal bit for bit to its plain version (ops/wire_kernel.py).
//
// 1. uhdr_wire_unslice: the un-slicing of every bit-sliced upload wire
//    (fused.py _vw_unslice, the unslice of _delta_decode_plane, which the
//    P010, RGB and API-1 rungs share, and _unpack_one_n).  Group g of 32
//    samples has a width w_g and a word offset o_g into the payload; its
//    word o_g + j holds bit j of all 32 samples, one lane each.  Sample
//    32 g + l is  sum_j ((payload[o_g + j] >> l) & 1) << j  less the bias:
//    1 << (w_g - 1) for a fixed rung (w_g = bits, o_g = g * bits), and for
//    the variable-width wire the same when w_g > 0, else 0 (at most 12 words
//    are read, word indices clamped to the payload, as the JAX gather
//    clips them).  A warp is a group: lane l computes sample l from the
//    group's w_g words, which every lane of the warp reads at one address
//    (one broadcast load a word), and the warp stores 32 consecutive int32.
//    Bound on the H100: device memory.  The payload is read once (4 bytes
//    a word, w_g words a group), the widths and offsets once (8 bytes a
//    group), the output written once (4 bytes a sample); there is no
//    arithmetic to speak of.
//
// 2. uhdr_down_pack: the device half of the download wire
//    (fused.py _down_delta_sections, _pack_down_wire_1010102 / _f16).  Per
//    output channel c (RGBA1010102: (packed >> 10c) & 0x3FF; RGBAF16: the
//    u16 half-float pattern of channel c), the 2D delta from base:
//      t[r][x] = v[r][x] - (r ? v[r-1][x] : base),
//      d[r][x] = t[r][x] - (x ? t[r][x-1] : 0),
//    code = d + half (half = 1 << (bits - 1)); a code outside [0, 2^bits) is
//    an escape and becomes half.  Channel c's section of the one wire buffer
//    is [words: bits u32 a group of 32 samples, word j bit j of the group's
//    codes (pad samples code half)][cap escape indices][cap escape values];
//    then the three channels' escape counts.  The escape list holds the
//    first `cap` escapes in ascending sample order, padded with index n and
//    value 0; a count may exceed cap (the host then downloads raw).
//    Two launches, because the escapes are written in order:
//    (a) down_words: a CTA of 256 threads takes a tile of 8192 samples in 32
//        steps of 256 consecutive samples; each warp's 32 samples are one
//        group, whose bits words are `bits` warp ballots (lane j stores
//        word j); the CTA's escape count of each channel goes to
//        block_counts;
//    (b) down_escapes: each CTA sums the counts of the CTAs before it (its
//        exclusive prefix) and of all CTAs (the total, which the last CTA
//        writes to the count tail), fills its share of the padding
//        [total, cap), and, if it has escapes below cap, walks its tile
//        again in the same order, ranking each escape by warp ballot and a
//        scan of the eight warps' counts, and stores it at prefix + rank.
//    Bound on the H100: device memory.  The packed output is read once (4
//    bytes a pixel for RGBA1010102, 8 for RGBAF16: every channel of a pixel
//    comes from one load; the neighbours' loads hit the caches), and the
//    wire written once (3 * (bits / 8 bytes a sample + 8 cap bytes) + 12).
//    Launch (b) rereads only the tiles that hold escapes below cap.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8192;                    // samples a CTA of down_pack
constexpr int kSteps = kTile / kThreads;
constexpr int kVwMaxWidth = 12;                // fused.py _VW_MAXW
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
unslice_kernel(const int32_t* __restrict__ payload, int64_t n_payload,
               const int32_t* __restrict__ widths,
               const int32_t* __restrict__ offsets, int fixed_bits,
               int64_t groups, int64_t n, int32_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t g = t >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= groups) return;
  int w, words;
  int64_t o;
  int32_t bias;
  if (widths != nullptr) {
    w = widths[g];
    o = offsets[g];
    words = w < kVwMaxWidth ? w : kVwMaxWidth;
    bias = w > 0 ? (1 << (w - 1)) : 0;
  } else {
    w = words = fixed_bits;
    o = g * fixed_bits;
    bias = 1 << (fixed_bits - 1);
  }
  uint32_t s = 0;
  for (int j = 0; j < words; ++j) {
    int64_t idx = o + j;
    idx = idx < 0 ? 0 : (idx >= n_payload ? n_payload - 1 : idx);
    const uint32_t word = static_cast<uint32_t>(__ldg(payload + idx));
    s |= ((word >> lane) & 1u) << j;
  }
  const int64_t i = g * 32 + lane;
  if (i < n) out[i] = static_cast<int32_t>(s) - bias;
}

struct DownParams {
  const void* packed;   // (h, w) int32 RGBA1010102 or (h, w, 4) int16 RGBAF16
  int32_t* wire;        // 3 sections of section_words, then 3 counts
  int32_t* block_counts;  // 3 x n_blocks
  int64_t h, w, n, groups, section_words, cap;
  int f16, bits, base, n_blocks;
};

// the three channels of pixel p (0 <= p < n)
__device__ __forceinline__ void channels(const DownParams& q, int64_t p,
                                         int32_t v[3]) {
  if (q.f16) {
    const uint2 px = __ldg(static_cast<const uint2*>(q.packed) + p);
    v[0] = static_cast<int32_t>(px.x & 0xFFFFu);
    v[1] = static_cast<int32_t>(px.x >> 16);
    v[2] = static_cast<int32_t>(px.y & 0xFFFFu);
  } else {
    const uint32_t px = static_cast<uint32_t>(
        __ldg(static_cast<const int32_t*>(q.packed) + p));
    v[0] = static_cast<int32_t>(px & 0x3FFu);
    v[1] = static_cast<int32_t>((px >> 10) & 0x3FFu);
    v[2] = static_cast<int32_t>((px >> 20) & 0x3FFu);
  }
}

// the 2D deltas of sample p's three channels
__device__ __forceinline__ void deltas(const DownParams& q, int64_t p,
                                       int32_t d[3]) {
  const int64_t r = p / q.w, x = p - r * q.w;
  int32_t cur[3], up[3], left[3], upleft[3];
  channels(q, p, cur);
  if (r) {
    channels(q, p - q.w, up);
  } else {
    up[0] = up[1] = up[2] = q.base;
  }
  if (x) {
    channels(q, p - 1, left);
    if (r) {
      channels(q, p - q.w - 1, upleft);
    } else {
      upleft[0] = upleft[1] = upleft[2] = q.base;
    }
  }
  for (int c = 0; c < 3; ++c)
    d[c] = (cur[c] - up[c]) - (x ? left[c] - upleft[c] : 0);
}

__global__ void __launch_bounds__(kThreads) down_words(DownParams q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t half = 1 << (q.bits - 1), lim = 1 << q.bits;
  int count[3] = {0, 0, 0};
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int step = 0; step < kSteps; ++step) {
    const int64_t first = tile0 + step * kThreads + warp * 32;
    const int64_t g = first >> 5;
    if (g >= q.groups) break;             // uniform over the warp
    const int64_t p = first + lane;
    int32_t d[3] = {0, 0, 0};
    const bool live = p < q.n;
    if (live) deltas(q, p, d);
    for (int c = 0; c < 3; ++c) {
      int32_t code = d[c] + half;
      const bool esc = live && (code < 0 || code >= lim);
      if (!live || esc) code = half;
      count[c] += esc;
      uint32_t mine = 0;
      for (int j = 0; j < q.bits; ++j) {
        const uint32_t b = __ballot_sync(kFull, (code >> j) & 1);
        if (lane == j) mine = b;
      }
      if (lane < q.bits)
        q.wire[c * q.section_words + g * q.bits + lane] =
            static_cast<int32_t>(mine);
    }
  }
  __shared__ int sums[3][kThreads / 32];
  for (int c = 0; c < 3; ++c) {
    int v = count[c];
    for (int off = 16; off; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) sums[c][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += sums[threadIdx.x][k];
    q.block_counts[threadIdx.x * q.n_blocks + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kThreads) down_escapes(DownParams q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ int64_t red[2][3][kThreads / 32];
  __shared__ int wcount[3][kThreads / 32];
  // exclusive prefix and total of each channel's CTA counts
  int64_t pre[3] = {0, 0, 0}, tot[3] = {0, 0, 0};
  for (int64_t k = threadIdx.x; k < q.n_blocks; k += kThreads)
    for (int c = 0; c < 3; ++c) {
      const int v = q.block_counts[c * q.n_blocks + k];
      tot[c] += v;
      if (k < blockIdx.x) pre[c] += v;
    }
  for (int c = 0; c < 3; ++c) {
    for (int off = 16; off; off >>= 1) {
      pre[c] += __shfl_down_sync(kFull, pre[c], off);
      tot[c] += __shfl_down_sync(kFull, tot[c], off);
    }
    if (lane == 0) {
      red[0][c][warp] = pre[c];
      red[1][c][warp] = tot[c];
    }
  }
  __syncthreads();
  int64_t prefix[3], total[3], own[3];
  for (int c = 0; c < 3; ++c) {
    prefix[c] = total[c] = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
      prefix[c] += red[0][c][k];
      total[c] += red[1][c][k];
    }
    own[c] = q.block_counts[c * q.n_blocks + blockIdx.x];
  }
  int32_t* counts = q.wire + 3 * q.section_words;
  if (blockIdx.x == q.n_blocks - 1 && threadIdx.x < 3)
    counts[threadIdx.x] = static_cast<int32_t>(total[threadIdx.x]);
  // padding: indices n, values 0, from the total to cap
  const int64_t stride = static_cast<int64_t>(q.n_blocks) * kThreads;
  for (int c = 0; c < 3; ++c) {
    int32_t* idx = q.wire + c * q.section_words + q.groups * q.bits;
    for (int64_t e = total[c] + static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
         e < q.cap; e += stride) {
      idx[e] = static_cast<int32_t>(q.n);
      idx[q.cap + e] = 0;
    }
  }
  bool work = false;
  for (int c = 0; c < 3; ++c) work |= own[c] > 0 && prefix[c] < q.cap;
  if (!work) return;                      // uniform over the CTA
  const int32_t half = 1 << (q.bits - 1), lim = 1 << q.bits;
  int64_t running[3] = {prefix[0], prefix[1], prefix[2]};
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int step = 0; step < kSteps; ++step) {
    const int64_t p = tile0 + step * kThreads + threadIdx.x;
    int32_t d[3] = {0, 0, 0};
    if (p < q.n) deltas(q, p, d);
    bool esc[3];
    uint32_t mask[3];
    for (int c = 0; c < 3; ++c) {
      const int32_t code = d[c] + half;
      esc[c] = p < q.n && (code < 0 || code >= lim);
      mask[c] = __ballot_sync(kFull, esc[c]);
      if (lane == 0) wcount[c][warp] = __popc(mask[c]);
    }
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
      int64_t before = running[c], step_total = 0;
      for (int k = 0; k < kThreads / 32; ++k) {
        if (k < warp) before += wcount[c][k];
        step_total += wcount[c][k];
      }
      if (esc[c]) {
        const int64_t pos = before + __popc(mask[c] & ((1u << lane) - 1u));
        if (pos < q.cap) {
          int32_t* idx = q.wire + c * q.section_words + q.groups * q.bits;
          idx[pos] = static_cast<int32_t>(p);
          idx[q.cap + pos] = d[c];
        }
      }
      running[c] += step_total;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int uhdr_wire_unslice(const int32_t* payload, int64_t n_payload,
                                 const int32_t* widths,
                                 const int32_t* offsets, int fixed_bits,
                                 int64_t groups, int64_t n, int32_t* out,
                                 void* cuda_stream) {
  if (groups == 0 || n == 0) return 0;
  const int64_t blocks = (groups * 32 + kThreads - 1) / kThreads;
  unslice_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(cuda_stream)>>>(
      payload, n_payload, widths, offsets, fixed_bits, groups, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uhdr_down_pack(const void* packed, int f16, int64_t h,
                              int64_t w, int bits, int64_t cap, int base,
                              int32_t* wire, int32_t* block_counts,
                              void* cuda_stream) {
  DownParams q;
  q.packed = packed;
  q.wire = wire;
  q.block_counts = block_counts;
  q.h = h;
  q.w = w;
  q.n = h * w;
  q.groups = (q.n + 31) / 32;
  q.cap = cap;
  q.section_words = q.groups * bits + 2 * cap;
  q.f16 = f16;
  q.bits = bits;
  q.base = base;
  q.n_blocks = static_cast<int>((q.groups * 32 + kTile - 1) / kTile);
  if (q.n_blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  down_words<<<q.n_blocks, kThreads, 0, s>>>(q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down_escapes<<<q.n_blocks, kThreads, 0, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
