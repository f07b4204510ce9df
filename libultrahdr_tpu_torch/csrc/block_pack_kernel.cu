// Block pack and tile pack of baseline-JPEG Huffman slots on Hopper
// (sm_90a), hand-written in CUDA C++.
//
// Replaces two Pallas TPU kernels of libultrahdr_tpu/jpeg/pack_kernel.py:
//
// - pack_blocks_pallas (kernel _pack_tile_kernel): every block's 72
//   (payload, length) slots -> one MSB-aligned 54-word buffer per block in
//   the blocks-in-lanes layout (54, n), plus the block's bit length;
// - pack_tiles_pallas (kernel _pack_compact_tile_kernel): the same buffers,
//   then each tile of 2048 blocks compacts its blocks' live words
//   (ceil(blen/32) each) to the front of the tile's budget of
//   2048 * budget words.
//
// It computes what those kernels compute, not how.  The TPU kernels combine
// the 72 slots in a shift-or tree over 128-lane vectors and compact with
// one-hot MXU contractions; here one thread walks its block's slots in order
// with a 64-bit bit accumulator (as csrc/pack_kernel.cu does), so every
// word is emitted once, in registers, and stored where it belongs.  Slot
// payloads are below 2^length (length <= 26; the row pad slot <= 7), so a
// slot of length 0 adds nothing and no 32-bit value is ever shifted by 32:
// the accumulator is 64 bits wide and the final partial word is shifted by
// 32 - pending with 0 < pending < 32.  Bits past blen in a block's last word
// are zero.
//
// What bounds them on the H100: device memory.  Each block reads 576 bytes
// of slots (two 288-byte rows, 16-byte vector loads) and does ~72 shift-ors;
// the block pack writes 216 bytes per block, the tile pack only the live
// words (about 3-4 per block on photographic content).
//
// Design.
// - uhdr_pack_blocks: one thread per block.  Word k of block b goes to
//   bb_t[k * n + b], so the 32 threads of a warp store 32 neighbouring words
//   of one row (coalesced); the rows past the block's words are zero-filled
//   the same way.  A block never needs more than 54 words (at most 1,701
//   bits); words from the 54th on would be dropped, never written out of
//   bounds.
// - uhdr_pack_tiles: one thread block (CTA) of 1024 threads per tile, two
//   neighbouring blocks per thread.  Each thread sums its blocks' slot
//   lengths (writing blen), the CTA takes an exclusive scan of the word
//   lengths (warp shuffles, then the 32 warp totals in shared memory), and
//   each thread writes its blocks' words at their offsets in the tile while
//   they are below the tile's budget: an overflowing tile loses its tail
//   exactly as the TPU kernel's does (the host's check_tile_budgets detects
//   it).  As on the TPU, the rest of the tile is left unwritten.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 72;  // slots per block
constexpr int kCap = 54;    // words per block buffer
constexpr int kTile = 2048;  // blocks per compacted tile
constexpr int kTileThreads = 1024;
constexpr int kPerThread = kTile / kTileThreads;

// Walks one block's 72 slots MSB-first and hands each finished 32-bit word
// to store(k, word), k = 0, 1, ...; returns the block's bit length.
template <class Store>
__device__ __forceinline__ int pack_block(const uint32_t* pays,
                                          const int32_t* lens, Store store) {
  const int4* p4 = reinterpret_cast<const int4*>(pays);
  const int4* l4 = reinterpret_cast<const int4*>(lens);
  uint64_t acc = 0;  // low `pending` bits are not yet stored, MSB first
  int pending = 0;
  int bits = 0;
  int k = 0;
  for (int i = 0; i < kSlots / 4; ++i) {
    const int4 p = p4[i];
    const int4 l = l4[i];
    const uint32_t pv[4] = {static_cast<uint32_t>(p.x),
                            static_cast<uint32_t>(p.y),
                            static_cast<uint32_t>(p.z),
                            static_cast<uint32_t>(p.w)};
    const int lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = (acc << lv[j]) | pv[j];
      pending += lv[j];
      bits += lv[j];
      if (pending >= 32) {
        pending -= 32;
        store(k++, static_cast<uint32_t>(acc >> pending));
      }
    }
  }
  if (pending > 0) store(k, static_cast<uint32_t>(acc << (32 - pending)));
  return bits;
}

// Sum of one block's 72 slot lengths.
__device__ __forceinline__ int block_bits(const int32_t* lens) {
  const int4* l4 = reinterpret_cast<const int4*>(lens);
  int bits = 0;
  for (int i = 0; i < kSlots / 4; ++i) {
    const int4 l = l4[i];
    bits += l.x + l.y + l.z + l.w;
  }
  return bits;
}

__global__ void pack_blocks_kernel(const uint32_t* __restrict__ pays,
                                   const int32_t* __restrict__ lens,
                                   uint32_t* __restrict__ bb_t,
                                   int32_t* __restrict__ blen, int64_t n) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= n) return;
  int words = 0;
  blen[b] = pack_block(pays + b * kSlots, lens + b * kSlots,
                       [&](int k, uint32_t w) {
                         if (k < kCap) bb_t[k * n + b] = w;
                         words = k + 1;
                       });
  for (int k = words; k < kCap; ++k) bb_t[k * n + b] = 0;
}

// Exclusive prefix sum of v over the CTA's kTileThreads threads in thread
// order.
__device__ __forceinline__ int cta_exclusive_scan(int v) {
  __shared__ int warp_sums[kTileThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over the warps
  }
  __syncthreads();
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(kTileThreads)
    pack_tiles_kernel(const uint32_t* __restrict__ pays,
                      const int32_t* __restrict__ lens,
                      uint32_t* __restrict__ tiles,
                      int32_t* __restrict__ blen, int64_t n,
                      int64_t tile_words) {
  const int64_t first = blockIdx.x * static_cast<int64_t>(kTile)
                        + threadIdx.x * static_cast<int64_t>(kPerThread);
  int wlen[kPerThread];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int64_t b = first + i;
    wlen[i] = 0;
    if (b < n) {
      const int bits = block_bits(lens + b * kSlots);
      blen[b] = bits;
      wlen[i] = (bits + 31) >> 5;
    }
    sum += wlen[i];
  }
  int64_t dest = cta_exclusive_scan(sum);
  uint32_t* out = tiles + blockIdx.x * tile_words;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int64_t b = first + i;
    if (wlen[i] > 0 && dest < tile_words) {
      pack_block(pays + b * kSlots, lens + b * kSlots,
                 [&](int k, uint32_t w) {
                   if (dest + k < tile_words) out[dest + k] = w;
                 });
    }
    dest += wlen[i];
  }
}

constexpr int kBlockThreads = 128;

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers (pays and lens
// (n, 72) row-major and 16-byte aligned); `cuda_stream` is the caller's
// cudaStream_t.  Each returns cudaGetLastError() right after its launch (0
// when the launch was accepted).
extern "C" int uhdr_pack_blocks(const uint32_t* pays, const int32_t* lens,
                                uint32_t* bb_t, int32_t* blen, int64_t n,
                                void* cuda_stream) {
  if (n <= 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((n + kBlockThreads - 1) / kBlockThreads);
  pack_blocks_kernel<<<grid, kBlockThreads, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
      pays, lens, bb_t, blen, n);
  return static_cast<int>(cudaGetLastError());
}

// tiles: (ceil(n / 2048), tile_words) words, tile_words = 2048 * budget.
extern "C" int uhdr_pack_tiles(const uint32_t* pays, const int32_t* lens,
                               uint32_t* tiles, int32_t* blen, int64_t n,
                               int64_t tile_words, void* cuda_stream) {
  if (n <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((n + kTile - 1) / kTile);
  pack_tiles_kernel<<<grid, kTileThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      pays, lens, tiles, blen, n, tile_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
