// The wire codecs' device halves on Hopper (sm_90a), hand-written in CUDA
// C++: two kernels, bound by ops/wire_kernel.py.
//
// The JAX package computes both with XLA ops (libultrahdr_tpu/fused.py) and
// reaches no Pallas kernel for them.  In eager PyTorch each is 30-60 launches
// over 50-100 MB at 4K; here each is hand-written, equal bit for bit to its
// plain version (ops/wire_kernel.py).  Both stage each CTA's input in
// shared memory with 16-byte cp.async copies and write 16-byte or
// whole-sector runs.  The first design of each (a warp a 32-sample group,
// each word a broadcast load from device memory; see 2. for the download
// pack's) was bound by instruction issue and load latency.
//
// 1. uhdr_wire_unslice: the un-slicing of every bit-sliced upload wire
//    (fused.py _vw_unslice, the unslice of _delta_decode_plane, which the
//    P010, RGB and API-1 rungs share, and _unpack_one_n).  Group g of 32
//    samples has a width w_g and a word offset o_g into the payload; its
//    word o_g + j holds bit j of all 32 samples, one lane each.  Sample
//    32 g + l is  sum_j ((payload[o_g + j] >> l) & 1) << j  less the bias:
//    1 << (w_g - 1) for a fixed rung (w_g = bits, o_g = g * bits), and for
//    the variable-width wire the same when w_g > 0, else 0 (at most 12 words
//    are read, word indices clamped to [0, n_payload), as the JAX gather
//    clips them, so the last group may repeat the final word).
//    Design: a CTA of 256 threads takes a run of 256 consecutive groups.
//    - Thread t loads group t's width and offset (coalesced) and clamps the
//      offset to [-16, n_payload] (the same words after the index clamp); a
//      CTA-wide min / max gives the run's word span [lo, hi].
//    - The span is staged in shared memory with 16-byte cp.async copies of
//      the aligned middle and 4-byte loads of at most three words at each
//      end; words of the span outside the payload hold the clamped word
//      (payload[0] below, payload[n_payload - 1] above), so no index is
//      clamped afterwards and nothing outside the payload is read.  A span
//      longer than the CTA's room (offsets that are no prefix sum of the
//      widths) is read from device memory instead, with the clamp.
//    - Eight threads build a group, four consecutive samples each: for each
//      of the group's words one shared load (the eight threads read the same
//      address, a warp's four groups four addresses) and two operations a
//      sample.  A warp stores its four groups as 16-byte vectors, 512
//      consecutive bytes.
//    The 4K P010 vw wire: 388,800 groups, 2.3 M payload words, 62.2 MB
//    read and written; device memory bounds it on the H100.
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
//    Design: tiles of 8,192 consecutive samples (256 whole groups), three
//    launches, none of which waits on another CTA.
//    - The tile is a run of the flat sample order and not a 2-D block: the
//      escapes are ranked in flat order, and a block of columns would
//      interleave its escapes with its row neighbours' row by row.  Its
//      halo is the w + 1 samples before it (the row above and the pixel to
//      the left).  A row too wide for the halo's room (RGBAF16 past ~17,000
//      pixels, RGBA1010102 past ~42,000) reads the row above from device
//      memory instead.
//    - Launch 1 (down_words), a CTA of 512 threads a tile: the tile and its
//      halo are staged in shared memory with 16-byte cp.async copies, one
//      commit group a step of 2,048 samples (the halo with the first),
//      issued two steps ahead of the coding.  In a step each warp codes
//      four groups, a lane one sample of each, its column kept by adding
//      32 (mod w), so there is no division.  A tile past row 0 with every
//      sample live (all but the first and last) loads left and upper-left
//      unconditionally (column 0 takes upper-left as its left) and tests
//      nothing.  RGBA1010102 forms the three deltas in two registers
//      (channels 0 and 2 in one, 12-bit fields with a bias of 2048, so no
//      borrow crosses a field).  A channel's four codes go into a lane's
//      four bytes; a 32 x 32 bit transpose over the warp (five rounds of a
//      rotate, a shuffle-xor and a merge) gives lane 8 s + j word j of
//      group s, one shuffle packs the 4 x bits words to the lanes' front,
//      and the warp stores them as one run: each step writes each
//      channel's section as 64 x bits consecutive words.  Each group's
//      escape mask (ballot) is kept; the tile writes its masks and counts.
//    - Launch 2 (down_scan), one CTA: the exclusive prefix sums of the
//      tiles' counts, the three channels side by side, and the totals.
//    - Launch 3 (down_escapes), a CTA a tile: its share of the padding
//      [total, cap); where the tile's prefix is below cap, its first
//      escapes below cap, ranked by a scan of its groups' mask counts and
//      spread over the threads, each delta recomputed from the output.
//    What bounds it on the H100 is not device memory but the SM's
//    instructions in launch 1, many of them on the shared-memory pipe
//    (pixel loads, mask stores, the transposes' shuffles); PERF.md gives
//    each part's cost.  Slower designs: the first (a CTA's tile walked in
//    256-sample steps with a 64-bit division and four device loads a
//    pixel, then a second launch whose every CTA summed all CTAs' counts),
//    and one launch ranking by decoupled look-back, whose tiles waited on
//    slower neighbours while holding their slots.
//    The 4K outputs: 8,294,400 samples, 45.8 MB (HLG, 4 bits) / 91.4 MB
//    (LINEAR, 8 bits) read and written, 1,013 tiles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ---- uhdr_wire_unslice -----------------------------------------------------
constexpr int kRun = 256;            // groups a CTA
constexpr int kVwMaxWidth = 12;      // fused.py _VW_MAXW
constexpr int kRunWords = 16;        // staged words a group (u4 widths <= 15)

// ---- uhdr_down_pack ---------------------------------------------------------
constexpr int kTile = 8192;                  // samples a tile
constexpr int kTileGroups = kTile / 32;
constexpr int kWordsThreads = 512;           // a CTA of launch 1
constexpr int kWordsWarps = kWordsThreads / 32;
constexpr int kStep = kWordsWarps * 4 * 32;  // samples a step: 4 groups a warp
constexpr int kSteps = kTile / kStep;
constexpr int kHaloSmemLimit = 200 * 1024;   // dynamic shared bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// wait until at most the two newest of this thread's commit groups are in
// flight
__device__ __forceinline__ void cp_wait_all_but_two() {
  asm volatile("cp.async.wait_group 2;" ::: "memory");
}

// Samples l0..l0+3 of a group from its `words` words (word(j) gives word
// j): sample l's bit j is bit l of word j.
template <class Word>
__device__ __forceinline__ uint4 build4(Word word, int words, int l0) {
  uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
  for (int j = 0; j < kVwMaxWidth; ++j) {
    if (j >= words) break;
    const uint32_t x = word(j) >> l0;
    s0 |= (x & 1u) << j;
    s1 |= ((x >> 1) & 1u) << j;
    s2 |= ((x >> 2) & 1u) << j;
    s3 |= ((x >> 3) & 1u) << j;
  }
  for (int j = kVwMaxWidth; j < words; ++j) {   // fixed rungs past 12 bits
    const uint32_t x = word(j) >> l0;
    s0 |= (x & 1u) << j;
    s1 |= ((x >> 1) & 1u) << j;
    s2 |= ((x >> 2) & 1u) << j;
    s3 |= ((x >> 3) & 1u) << j;
  }
  return make_uint4(s0, s1, s2, s3);
}

__global__ void __launch_bounds__(kThreads)
unslice_kernel(const int32_t* __restrict__ payload, int np,
               const int32_t* __restrict__ widths,
               const int32_t* __restrict__ offsets, int fixed_bits,
               int64_t groups, int64_t n, int room,
               int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t span[];
  __shared__ int s_w[kRun], s_o[kRun];
  __shared__ int s_lo[kWarps], s_hi[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kRun;

  // the run's widths and offsets; live groups hold samples below n
  {
    const int64_t g = g0 + t;
    int w = 0, words = 0, o = 0;
    if (g < groups && g * 32 < n) {
      int64_t o64;
      if (widths != nullptr) {
        w = widths[g];
        words = w < 0 ? 0 : (w < kVwMaxWidth ? w : kVwMaxWidth);
        o64 = offsets[g];
      } else {
        w = words = fixed_bits;
        o64 = g * fixed_bits;
      }
      o = static_cast<int>(o64 < -16 ? -16 : (o64 > np ? np : o64));
    }
    s_w[t] = w;
    s_o[t] = o;
    int lo = words > 0 ? o : INT32_MAX;
    int hi = words > 0 ? o + words - 1 : INT32_MIN;
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
  }
  __syncthreads();
  int lo = s_lo[0], hi = s_hi[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    lo = min(lo, s_lo[k]);
    hi = max(hi, s_hi[k]);
  }
  // words lo..hi at span[k - lo + shift], aligned so that 16-byte copies of
  // the payload land on 16-byte shared addresses
  const int64_t base4 = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(payload) >> 2);
  const int shift = static_cast<int>((base4 + lo) & 3);
  const bool staged = hi >= lo && hi - lo + 1 + shift <= room;
  if (staged) {
    const int a = max(lo, 0), b = min(hi + 1, np);
    int av = hi + 1, bv = hi + 1;         // the 16-byte middle [av, bv)
    if (a < b) {
      const int va = a + static_cast<int>((4 - ((base4 + a) & 3)) & 3);
      const int vb = b - static_cast<int>((base4 + b) & 3);
      if (va < vb) {
        av = va;
        bv = vb;
      }
    }
    const int units = (bv - av) >> 2;
    for (int u = t; u < units; u += kThreads)
      cp16(&span[av + 4 * u - lo + shift], payload + av + 4 * u);
    // the ends [lo, av) and [bv, hi]: a few words, clamped into the payload
    const int head = av - lo, ends = head + (hi + 1 - bv);
    for (int k = t; k < ends; k += kThreads) {
      const int idx = k < head ? lo + k : bv + (k - head);
      span[idx - lo + shift] = static_cast<uint32_t>(
          __ldg(payload + min(max(idx, 0), np - 1)));
    }
    cp_wait_all();
  }
  __syncthreads();

  const int l0 = (t & 7) * 4;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int pass = 0; pass < kRun / 32; ++pass) {
    const int lg = pass * 32 + (t >> 3);
    const int64_t g = g0 + lg;
    if (g >= groups || g * 32 >= n) continue;
    const int w = s_w[lg], o = s_o[lg];
    int words;
    int32_t bias;
    if (widths != nullptr) {
      words = w < 0 ? 0 : (w < kVwMaxWidth ? w : kVwMaxWidth);
      bias = w > 0 ? (1 << (w - 1)) : 0;
    } else {
      words = fixed_bits;
      bias = 1 << (fixed_bits - 1);
    }
    uint4 s;
    if (staged) {
      const uint32_t* src = span + (o - lo + shift);
      s = build4([&](int j) { return src[j]; }, words, l0);
    } else {
      s = build4(
          [&](int j) {
            return static_cast<uint32_t>(
                __ldg(payload + min(max(o + j, 0), np - 1)));
          },
          words, l0);
    }
    const int4 v = make_int4(static_cast<int32_t>(s.x) - bias,
                             static_cast<int32_t>(s.y) - bias,
                             static_cast<int32_t>(s.z) - bias,
                             static_cast<int32_t>(s.w) - bias);
    const int64_t i = g * 32 + l0;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<int4*>(out + i) = v;
    } else {
      if (i < n) out[i] = v.x;
      if (i + 1 < n) out[i + 1] = v.y;
      if (i + 2 < n) out[i + 2] = v.z;
      if (i + 3 < n) out[i + 3] = v.w;
    }
  }
}

// ---- the download pack ------------------------------------------------------

struct DownParams {
  const void* packed;   // (h, w) int32 RGBA1010102 or (h, w, 4) int16 RGBAF16
  int32_t* wire;        // 3 sections of `section` words, then 3 counts
  uint32_t* masks;      // [3][n_tiles][kTileGroups] groups' escape masks
  int32_t* counts;      // [3][n_tiles] tiles' escape counts
  int32_t* prefix;      // [3][n_tiles] their exclusive prefix sums
  int64_t section;
  int n, w, groups, n_tiles, cap, bits, step32, step_rest;
  uint32_t base_x, base_y;      // base as a pixel (f16: base_y channel 2)
};

// A 32 x 32 bit transpose over the warp: lane j returns the word whose bit
// l is bit j of lane l's x.  Round s swaps, between lanes l and l ^ s, the
// s-bit halves of every 2s-bit block: each lane sends its word rotated left
// by s (its low halves into the high ones) when lane & s, else right by s,
// and keeps its own low halves (lane & s clear) or high halves, taking the
// others from what it receives.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t m = s == 16 ? 0x0000FFFFu
                       : s == 8 ? 0x00FF00FFu
                       : s == 4 ? 0x0F0F0F0Fu
                       : s == 2 ? 0x33333333u
                                : 0x55555555u;
    const bool high = lane & s;
    const uint32_t keep = high ? ~m : m;
    const uint32_t got =
        __shfl_xor_sync(kFull, __funnelshift_l(x, x, high ? s : 32 - s), s);
    x = (x & keep) | (got & ~keep);
  }
  return x;
}

template <bool kF16> struct PixelOf { using T = uint32_t; };
template <> struct PixelOf<true> { using T = uint2; };

// d + add, d = (cur - up) - (left - upleft), of the three channels.
// RGBA1010102: the 10-bit channels 0 and 2 as 12-bit fields of one register
// and channel 1 of another, each plus a bias of 2048, so no field borrows
// from the next (the bias and `add` then cost one operation a channel).
__device__ __forceinline__ void deltas3(uint32_t cur, uint32_t up,
                                        uint32_t left, uint32_t ul,
                                        int32_t add, int32_t d[3]) {
  constexpr uint32_t kE = 0x3FF003FFu, kO = 0x000FFC00u;
  const uint32_t de =
      (cur & kE) + (ul & kE) + 0x80000800u - (up & kE) - (left & kE);
  const uint32_t dn =
      (cur & kO) + (ul & kO) + (2048u << 10) - (up & kO) - (left & kO);
  const int32_t a = add - 2048;
  d[0] = static_cast<int32_t>(de & 0xFFFu) + a;
  d[1] = static_cast<int32_t>(dn >> 10) + a;
  d[2] = static_cast<int32_t>(de >> 20) + a;
}

__device__ __forceinline__ void deltas3(uint2 cur, uint2 up, uint2 left,
                                        uint2 ul, int32_t add, int32_t d[3]) {
  d[0] = add + static_cast<int32_t>(cur.x & 0xFFFFu) +
         static_cast<int32_t>(ul.x & 0xFFFFu) -
         static_cast<int32_t>(up.x & 0xFFFFu) -
         static_cast<int32_t>(left.x & 0xFFFFu);
  d[1] = add + static_cast<int32_t>(cur.x >> 16) +
         static_cast<int32_t>(ul.x >> 16) - static_cast<int32_t>(up.x >> 16) -
         static_cast<int32_t>(left.x >> 16);
  d[2] = add + static_cast<int32_t>(cur.y & 0xFFFFu) +
         static_cast<int32_t>(ul.y & 0xFFFFu) -
         static_cast<int32_t>(up.y & 0xFFFFu) -
         static_cast<int32_t>(left.y & 0xFFFFu);
}

__device__ __forceinline__ uint32_t make_pixel(uint32_t x, uint32_t,
                                               uint32_t*) {
  return x;
}
__device__ __forceinline__ uint2 make_pixel(uint32_t x, uint32_t y, uint2*) {
  return make_uint2(x, y);
}

// The deltas of sample p, whose column is x, anywhere in the output: the
// pixel and its left neighbour from `px` (pixel p at px[p - s0]), the row
// above from `above` (pixel p at above[p - a0]); row 0 against base, column
// 0 without the left term.
template <bool kF16>
__device__ __forceinline__ void deltas_at(
    const DownParams& q, const typename PixelOf<kF16>::T* px, int s0,
    const typename PixelOf<kF16>::T* above, int a0, int p, uint32_t x,
    int32_t d[3]) {
  using Px = typename PixelOf<kF16>::T;
  const Px base = make_pixel(q.base_x, q.base_y, static_cast<Px*>(nullptr));
  const Px zero = make_pixel(0u, 0u, static_cast<Px*>(nullptr));
  const bool first_row = p < q.w;
  Px up = base, left = zero, ul = zero;   // left == ul: no left term
  if (!first_row) up = above[p - q.w - a0];
  if (x != 0) {
    left = px[p - 1 - s0];
    ul = first_row ? base : above[p - q.w - 1 - a0];
  }
  deltas3(px[p - s0], up, left, ul, 0, d);
}

// The staging of a tile: pixels [s0, e) of the output into shared memory
// `stage` (pixel p at tile_px[p - s0], tile_px = stage + shift), by 16-byte
// cp.async units where the words are 16-byte aligned and 4-byte copies of
// the few words at each end.  Step k's commit group holds the units whose
// first word lies in step k's samples (the halo's in step 0's).
struct Staging {
  const uint32_t* gw;
  int p0, w0, w1, shift, av, bv, units, head, ends, words_px;

  __device__ Staging(const void* packed, int tile_p0, int s0, int e,
                     int px_words) {
    gw = static_cast<const uint32_t*>(packed);
    p0 = tile_p0;
    words_px = px_words;
    const int64_t base4 = static_cast<int64_t>(
        reinterpret_cast<uintptr_t>(packed) >> 2);
    w0 = s0 * words_px;
    w1 = e * words_px;
    shift = static_cast<int>((base4 + w0) & 3);
    av = w0 + static_cast<int>((4 - ((base4 + w0) & 3)) & 3);
    bv = w1 - static_cast<int>((base4 + w1) & 3);
    if (av >= bv) av = bv = w1;
    units = (bv - av) >> 2;
    head = av - w0;
    ends = head + (w1 - bv);
  }

  // issues step k's copies as one commit group (empty past the tile)
  __device__ void step(uint32_t* stage, int k) const {
    const int lo_w = k == 0 ? w0 : (p0 + k * kStep) * words_px;
    const int hi_w = (p0 + (k + 1) * kStep) * words_px;
    const int u0 = lo_w <= av ? 0 : (lo_w - av + 3) >> 2;
    const int u1 = hi_w <= av ? 0 : min(units, (hi_w - av + 3) >> 2);
    for (int u = u0 + threadIdx.x; u < u1; u += blockDim.x)
      cp16(&stage[av + 4 * u - w0 + shift], gw + av + 4 * u);
    for (int j = threadIdx.x; j < ends; j += blockDim.x) {
      const int wi = j < head ? w0 + j : bv + (j - head);
      if (wi >= lo_w && wi < hi_w) cp4(&stage[wi - w0 + shift], gw + wi);
    }
    cp_commit();
  }
};

// Steps of one tile: per step of kStep samples, each warp codes four groups
// (a lane one sample of each), keeps their escape masks in `masks` and
// stores each channel's 4 x bits words as one run.  kInterior: every sample
// of the tile is live and below row 0, so left and upper-left load
// unconditionally (column 0 then takes upper-left as its left: no left
// term) and no sample is tested.
template <bool kF16, bool kHalo, bool kInterior>
__device__ __forceinline__ void code_steps(
    const DownParams& q, const Staging& staging, uint32_t* stage,
    const typename PixelOf<kF16>::T* tile_px, int s0, int p0, int e,
    uint32_t (*masks)[kTileGroups]) {
  using Px = typename PixelOf<kF16>::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Px* above = kHalo ? tile_px : static_cast<const Px*>(q.packed);
  const int a0 = kHalo ? s0 : 0;
  const int half = 1 << (q.bits - 1);
  const uint32_t lim = 1u << q.bits;
  // lane L of a step's 4 x bits words takes word L % bits of group L / bits
  // from the transpose's lane 8 (L / bits) + L % bits
  const int src = ((lane / q.bits) * 8 + lane % q.bits) & 31;
  const bool stores = lane < 4 * q.bits;
  uint32_t x = static_cast<uint32_t>(p0 + 128 * warp + lane) %
               static_cast<uint32_t>(q.w);
#pragma unroll 1
  for (int k = 0; k < kSteps; ++k) {
    if (k + 2 < kSteps) {
      staging.step(stage, k + 2);
    } else {
      cp_commit();                        // steps k - 1 and k in flight
    }
    cp_wait_all_but_two();
    __syncthreads();
    if (p0 + k * kStep >= e) break;       // uniform over the CTA
    uint32_t codes[3] = {0u, 0u, 0u};     // a byte a group
    // the warp's first sample this step, and its pixel and the one above
    const int p_warp = p0 + (k * (kStep / 32) + warp * 4) * 32 + lane;
    const Px* cur_px = tile_px + (p_warp - s0);
    const Px* up_px = above + (p_warp - q.w - a0);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int lg = k * (kStep / 32) + warp * 4 + s;
      const int p = p_warp + 32 * s;
      bool live = true;
      int32_t d[3] = {0, 0, 0};
      if (kInterior) {
        Px left = cur_px[32 * s - 1];
        const Px ul = up_px[32 * s - 1];
        if (x == 0) left = ul;
        deltas3(cur_px[32 * s], up_px[32 * s], left, ul, half, d);
      } else {
        live = p < e;
        if (live) {
          deltas_at<kF16>(q, tile_px, s0, above, a0, p, x, d);
          for (int c = 0; c < 3; ++c) d[c] += half;
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint32_t code = static_cast<uint32_t>(d[c]);  // d + half
        const bool esc = live && code >= lim;
        const uint32_t m = __ballot_sync(kFull, esc);
        if (lane == 0) masks[c][lg] = m;
        codes[c] += ((live && !esc) ? code : static_cast<uint32_t>(half))
                    << (8 * s);
      }
      x += q.step32;
      if (x >= static_cast<uint32_t>(q.w)) x -= q.w;
    }
    x += q.step_rest;
    if (x >= static_cast<uint32_t>(q.w)) x -= q.w;
    const int64_t gq =
        static_cast<int64_t>(p0 / 32) + k * (kStep / 32) + warp * 4;
    const bool store =
        stores && (kInterior || gq * q.bits + lane <
                                    static_cast<int64_t>(q.groups) * q.bits);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint32_t word =
          __shfl_sync(kFull, transpose32(codes[c], lane), src);
      if (store)
        q.wire[c * q.section + gq * q.bits + lane] =
            static_cast<int32_t>(word);
    }
  }
}

// Launch 1: a CTA a tile of kTile samples; stages the tile and its halo,
// codes every group's words, and writes the groups' escape masks and the
// tile's escape counts.
template <bool kF16, bool kHalo>
__global__ void __launch_bounds__(kWordsThreads) down_words(DownParams q) {
  using Px = typename PixelOf<kF16>::T;
  constexpr int kWordsPx = kF16 ? 2 : 1;
  extern __shared__ __align__(16) uint32_t stage[];
  __shared__ uint32_t masks[3][kTileGroups];
  __shared__ int warp_count[3][kTileGroups / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x;
  const int p0 = tile * kTile;
  const int e = min(p0 + kTile, q.n);
  const int s0 = kHalo ? max(0, p0 - q.w - 1) : max(0, p0 - 1);

  // stage pixels [s0, e), two steps ahead of the coding
  const Staging staging(q.packed, p0, s0, e, kWordsPx);
  staging.step(stage, 0);
  staging.step(stage, 1);
  const Px* tile_px = reinterpret_cast<const Px*>(stage + staging.shift);
  if (p0 >= q.w + 1 && p0 + kTile <= q.n)
    code_steps<kF16, kHalo, true>(q, staging, stage, tile_px, s0, p0, e,
                                  masks);
  else
    code_steps<kF16, kHalo, false>(q, staging, stage, tile_px, s0, p0, e,
                                   masks);
  cp_wait_all();
  __syncthreads();                         // the last step's masks

  // the groups' masks (0 past the output) and the tile's counts, group t
  // by thread t
  if (t < kTileGroups) {
    const bool in_tile = p0 + 32 * t < e;
    for (int c = 0; c < 3; ++c) {
      const uint32_t m = in_tile ? masks[c][t] : 0u;
      q.masks[(static_cast<int64_t>(c) * q.n_tiles + tile) * kTileGroups +
              t] = m;
      int v = __popc(m);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      if (lane == 0) warp_count[c][warp] = v;
    }
  }
  __syncthreads();
  if (t < 3) {
    int total = 0;
    for (int k = 0; k < kTileGroups / 32; ++k) total += warp_count[t][k];
    q.counts[t * q.n_tiles + tile] = total;
  }
}

// Launch 2, one CTA of kScanThreads: each channel's exclusive prefix sums of
// the tiles' counts, the three channels side by side, and its total into
// the wire's count tail.
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads) down_scan(DownParams q) {
  __shared__ int sums[3][kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry[3] = {0, 0, 0};
  for (int k0 = 0; k0 < q.n_tiles; k0 += kScanThreads) {
    const int k = k0 + t;
    int own[3], incl[3];
    for (int c = 0; c < 3; ++c) {
      own[c] = k < q.n_tiles ? q.counts[c * q.n_tiles + k] : 0;
      incl[c] = own[c];
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      for (int c = 0; c < 3; ++c) {
        const int v = __shfl_up_sync(kFull, incl[c], d);
        if (lane >= d) incl[c] += v;
      }
    if (lane == 31)
      for (int c = 0; c < 3; ++c) sums[c][warp] = incl[c];
    __syncthreads();
    if (warp < 3) {
      int v = sums[warp][lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += u;
      }
      sums[warp][lane] = v;                 // inclusive over the warps
    }
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
      if (k < q.n_tiles)
        q.prefix[c * q.n_tiles + k] =
            carry[c] + (warp ? sums[c][warp - 1] : 0) + incl[c] - own[c];
      carry[c] += sums[c][kScanThreads / 32 - 1];
    }
    __syncthreads();                        // sums is reused
  }
  if (t < 3) q.wire[3 * q.section + t] = carry[t];
}

// Launch 3: a CTA a tile.  Its share of the padding [total, cap) of each
// channel's escape list; then, where the tile's prefix is below cap, its
// first escapes below cap: a scan of its groups' mask counts ranks them,
// thread t takes ranks t, t + 256, ... (the group by a binary search of
// the scan, the lane by clearing the mask's lower set bits), each delta
// recomputed from the output in device memory, the loads of kBatch escapes
// issued together.  (Staging the tile again costs more: on RGBAF16 outputs
// most tiles hold a few escapes of channels 1-2 below cap.)
constexpr int kBatch = 8;

template <bool kF16>
__global__ void __launch_bounds__(kThreads) down_escapes(DownParams q) {
  static_assert(kTileGroups == kThreads, "a thread a group");
  using Px = typename PixelOf<kF16>::T;
  __shared__ uint32_t s_mask[kTileGroups];
  __shared__ int s_before[kTileGroups];       // escapes of the groups before
  __shared__ int s_warp[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x;
  const Px* px = static_cast<const Px*>(q.packed);
  for (int c = 0; c < 3; ++c) {
    int32_t* idx = q.wire + c * q.section +
                   static_cast<int64_t>(q.groups) * q.bits;
    const int total = q.wire[3 * q.section + c];
    for (int64_t j = total + static_cast<int64_t>(tile) * kThreads + t;
         j < q.cap; j += static_cast<int64_t>(q.n_tiles) * kThreads) {
      idx[j] = q.n;
      idx[q.cap + j] = 0;
    }
    const int64_t pre = q.prefix[c * q.n_tiles + tile];
    const int count = q.counts[c * q.n_tiles + tile];
    if (pre >= q.cap || count == 0) continue;   // uniform over the CTA
    const uint32_t mask =
        q.masks[(static_cast<int64_t>(c) * q.n_tiles + tile) * kTileGroups +
                t];
    const int own = __popc(mask);
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    s_mask[t] = mask;
    __syncthreads();
    int before = incl - own;
    for (int k = 0; k < warp; ++k) before += s_warp[k];
    s_before[t] = before;
    __syncthreads();
    const int n_out = static_cast<int>(
        min(static_cast<int64_t>(count), q.cap - pre));
    for (int r0 = t; r0 < n_out; r0 += kBatch * kThreads) {
      int p[kBatch];
      int32_t d[kBatch][3];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int r = r0 + b * kThreads;
        p[b] = -1;
        if (r < n_out) {
          int lo = 0, hi = kTileGroups - 1;   // the last group starting <= r
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_before[mid] <= r) lo = mid; else hi = mid - 1;
          }
          uint32_t m = s_mask[lo];
          for (int k = r - s_before[lo]; k > 0; --k) m &= m - 1;
          p[b] = tile * kTile + 32 * lo + __ffs(m) - 1;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (p[b] >= 0)
          deltas_at<kF16>(
              q, px, 0, px, 0, p[b],
              static_cast<uint32_t>(p[b]) % static_cast<uint32_t>(q.w), d[b]);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (p[b] >= 0) {
          const int64_t pos = pre + r0 + b * kThreads;
          idx[pos] = p[b];
          idx[q.cap + pos] = d[b][c];
        }
    }
    __syncthreads();                       // the shared arrays are reused
  }
}

// The largest shared-memory carveout, so that as many CTAs fit an SM as
// their shared memory allows (the CUDA default may choose less), and
// `smem` bytes of dynamic shared memory allowed (past 48 KB with the static
// shared memory only on request).
template <class Kernel>
cudaError_t prefer_shared(Kernel* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  return err;
}

template <bool kF16, bool kHalo>
int launch_down(const DownParams& q, size_t smem, cudaStream_t s) {
  cudaError_t err = prefer_shared(down_words<kF16, kHalo>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  down_words<kF16, kHalo><<<q.n_tiles, kWordsThreads, smem, s>>>(q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  down_scan<<<1, kScanThreads, 0, s>>>(q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  down_escapes<kF16><<<q.n_tiles, kThreads, 0, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int uhdr_wire_unslice(const int32_t* payload, int64_t n_payload,
                                 const int32_t* widths,
                                 const int32_t* offsets, int fixed_bits,
                                 int64_t groups, int64_t n, int32_t* out,
                                 void* cuda_stream) {
  if (groups == 0 || n == 0) return 0;
  const int64_t blocks = (groups + kRun - 1) / kRun;
  const int per_group = widths != nullptr || fixed_bits < kRunWords
                            ? kRunWords
                            : fixed_bits;
  const int room = kRun * per_group + 8;
  const cudaError_t err = prefer_shared(unslice_kernel, room * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  unslice_kernel<<<static_cast<unsigned>(blocks), kThreads,
                   room * sizeof(uint32_t),
                   static_cast<cudaStream_t>(cuda_stream)>>>(
      payload, static_cast<int>(n_payload), widths, offsets, fixed_bits,
      groups, n, room, out);
  return static_cast<int>(cudaGetLastError());
}

// scratch: 3 * ceil(h * w / 8192) * (256 + 2) int32 words
extern "C" int uhdr_down_pack(const void* packed, int f16, int64_t h,
                              int64_t w, int bits, int64_t cap, int base,
                              int32_t* wire, void* scratch,
                              void* cuda_stream) {
  const int64_t n = h * w;
  if (n == 0) return 0;
  DownParams q;
  q.packed = packed;
  q.wire = wire;
  q.n = static_cast<int>(n);
  q.w = static_cast<int>(w);
  q.groups = static_cast<int>((n + 31) / 32);
  q.n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  q.masks = static_cast<uint32_t*>(scratch);
  q.counts = reinterpret_cast<int32_t*>(q.masks) +
             3 * static_cast<int64_t>(q.n_tiles) * kTileGroups;
  q.prefix = q.counts + 3 * q.n_tiles;
  q.cap = static_cast<int>(cap);
  q.bits = bits;
  q.section = static_cast<int64_t>(q.groups) * bits + 2 * cap;
  q.step32 = static_cast<int>(32 % w);
  q.step_rest = static_cast<int>((kStep - 128) % w);
  const uint32_t b = static_cast<uint32_t>(base);
  q.base_x = f16 ? (b | b << 16) : (b | b << 10 | b << 20);
  q.base_y = b;
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const int words_px = f16 ? 2 : 1;
  const size_t halo = ((static_cast<size_t>(kTile) + w + 1) * words_px + 4) *
                      sizeof(uint32_t);
  const size_t plain = ((static_cast<size_t>(kTile) + 1) * words_px + 4) *
                       sizeof(uint32_t);
  if (halo <= kHaloSmemLimit)
    return f16 ? launch_down<true, true>(q, halo, s)
               : launch_down<false, true>(q, halo, s);
  return f16 ? launch_down<true, false>(q, plain, s)
             : launch_down<false, false>(q, plain, s);
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
