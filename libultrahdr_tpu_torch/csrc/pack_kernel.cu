// Baseline-JPEG Huffman symbol generation, bit packing and compaction on
// Hopper (sm_90a), hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernel libultrahdr_tpu/jpeg/pack_kernel.py
// _pack_tiles_v3 (kernel body _sym_pack_tile_kernel with
// _slot_lists_in_kernel).  It computes what that kernel computes, not how:
// for every 8x8 block in MCU stream order, the DC category and Huffman
// code, the AC (run, size) symbols, a ZRL for each run of 16 zeros before a
// later nonzero, an EOB when coefficient 63 is zero, and the value bits,
// packed MSB-first into u32 words.  Each block starts on a word boundary at
// the exclusive prefix sum of ceil(blen/32) over all blocks, its bits past
// blen in its last word are zero, and blen carries no restart-row pad (the
// host joiner uhdr_join_blocks byte-aligns every row).  Output words and
// blen are bit-identical to the v3 kernel's stitched stream.
//
// What bounds it on the H100: integer ALU work and scattered 4-byte
// stores, about 0.6 M blocks per 4K image in the library's default
// configuration (4:2:0 base plus a full-resolution 4:4:4 gain map).  The
// 128-byte coefficient row of a block is read once per pass with 16-byte
// vector loads, and each thread keeps a 64-bit bit accumulator in
// registers, so no per-symbol intermediate ever reaches device memory.
//
// Design: two passes of one thread per block.  Pass 1 (uhdr_pack_blen)
// runs the symbol coder with a bit counter and writes blen.  The wrapper
// then takes wlen = (blen + 31) >> 5 and its exclusive scan with
// torch.cumsum (plain glue, as the JAX package takes its cross-tile
// offsets in XLA, pack_kernel.stitch_tiles) and sizes the output from the
// real total.  Pass 2 (uhdr_pack_words) runs the same coder with a bit
// writer that stores the block's words at its offset.  Because the output
// is sized from the real lengths it cannot overflow, so neither the TPU
// port's static word budget (PackOverflowError) nor its general-path
// fallback exists here.  The Huffman tables (code << 5 | length, Annex K)
// are built by the wrapper from jpeg/tables.py, uploaded once per device,
// and copied into shared memory by every thread block.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// [DC luma 16][DC chroma 16][AC luma 256][AC chroma 256]
constexpr int kLutWords = 2 * 16 + 2 * 256;

// JPEG magnitude category, capped at 15 like the TPU kernel's
// _bit_size_vec (15 compares).
__device__ __forceinline__ int bit_size(int v) {
  const unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  const int s = 32 - __clz(a);
  return s > 15 ? 15 : s;
}

// One's-complement style extra bits (T.81 F.1.2.1).
__device__ __forceinline__ uint32_t value_bits(int v, int s) {
  const int x = v < 0 ? v + (1 << s) - 1 : v;
  return static_cast<uint32_t>(x) & ((1u << s) - 1u);
}

struct BitCounter {
  int bits = 0;
  __device__ __forceinline__ void put(uint32_t, int n) { bits += n; }
};

struct BitWriter {
  uint32_t* out;
  uint64_t acc = 0;  // low `nacc` bits are pending, MSB first
  int nacc = 0;
  __device__ __forceinline__ void put(uint32_t code, int n) {  // n <= 27
    acc = (acc << n) | code;
    nacc += n;
    if (nacc >= 32) {
      nacc -= 32;
      *out++ = static_cast<uint32_t>(acc >> nacc);
    }
  }
  __device__ __forceinline__ void flush() {
    if (nacc > 0) *out++ = static_cast<uint32_t>(acc << (32 - nacc));
  }
};

// Emits one block's symbols in stream order: DC, then per nonzero AC
// coefficient its pending ZRLs and its (run, size) code with value bits,
// then EOB when the block ends in zeros.
template <class Sink>
__device__ __forceinline__ void code_block(const int16_t* coeffs, int dc_diff,
                                           bool luma, const uint32_t* lut,
                                           Sink& sink) {
  const uint32_t* dc = lut + (luma ? 0 : 16);
  const uint32_t* ac = lut + 32 + (luma ? 0 : 256);
  const int ds = bit_size(dc_diff);
  const uint32_t de = dc[ds];
  sink.put(((de >> 5) << ds) | value_bits(dc_diff, ds),
           static_cast<int>(de & 31) + ds);
  const uint32_t zrl = ac[0xF0];
  int run = 0;
  const int4* src = reinterpret_cast<const int4*>(coeffs);
  for (int i = 0; i < 8; ++i) {
    const int4 q = src[i];
    const uint32_t w[4] = {static_cast<uint32_t>(q.x),
                           static_cast<uint32_t>(q.y),
                           static_cast<uint32_t>(q.z),
                           static_cast<uint32_t>(q.w)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (i == 0 && j == 0) continue;  // the DC slot
      const int v = static_cast<int16_t>(w[j >> 1] >> (16 * (j & 1)));
      if (v == 0) {
        ++run;
        continue;
      }
      while (run >= 16) {
        sink.put(zrl >> 5, static_cast<int>(zrl & 31));
        run -= 16;
      }
      const int s = bit_size(v);
      const uint32_t e = ac[(run << 4) | s];
      sink.put(((e >> 5) << s) | value_bits(v, s),
               static_cast<int>(e & 31) + s);
      run = 0;
    }
  }
  if (run > 0) {
    const uint32_t eob = ac[0x00];
    sink.put(eob >> 5, static_cast<int>(eob & 31));
  }
}

__device__ __forceinline__ void load_lut(const uint32_t* lut_g,
                                         uint32_t* lut) {
  for (int i = threadIdx.x; i < kLutWords; i += blockDim.x) lut[i] = lut_g[i];
  __syncthreads();
}

__global__ void pack_blen_kernel(const int16_t* __restrict__ stream,
                                 const int32_t* __restrict__ dc_diff,
                                 const int32_t* __restrict__ is_luma,
                                 const uint32_t* __restrict__ lut_g,
                                 int32_t* __restrict__ blen, int64_t n) {
  __shared__ uint32_t lut[kLutWords];
  load_lut(lut_g, lut);
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= n) return;
  BitCounter cnt;
  code_block(stream + b * 64, dc_diff[b], is_luma[b] != 0, lut, cnt);
  blen[b] = cnt.bits;
}

__global__ void pack_words_kernel(const int16_t* __restrict__ stream,
                                  const int32_t* __restrict__ dc_diff,
                                  const int32_t* __restrict__ is_luma,
                                  const uint32_t* __restrict__ lut_g,
                                  const int64_t* __restrict__ dest,
                                  uint32_t* __restrict__ words, int64_t n) {
  __shared__ uint32_t lut[kLutWords];
  load_lut(lut_g, lut);
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= n) return;
  BitWriter wr;
  wr.out = words + dest[b];
  code_block(stream + b * 64, dc_diff[b], is_luma[b] != 0, lut, wr);
  wr.flush();
}

constexpr int kThreads = 128;

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers; `stream` is
// the caller's cudaStream_t.  Each returns cudaGetLastError() right after
// its launch (0 when the launch was accepted).
extern "C" int uhdr_pack_blen(const int16_t* stream, const int32_t* dc_diff,
                              const int32_t* is_luma, const uint32_t* lut,
                              int32_t* blen, int64_t n, void* cuda_stream) {
  if (n <= 0) return 0;
  pack_blen_kernel<<<grid_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(cuda_stream)>>>(
      stream, dc_diff, is_luma, lut, blen, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uhdr_pack_words(const int16_t* stream, const int32_t* dc_diff,
                               const int32_t* is_luma, const uint32_t* lut,
                               const int64_t* dest, uint32_t* words,
                               int64_t n, void* cuda_stream) {
  if (n <= 0) return 0;
  pack_words_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      stream, dc_diff, is_luma, lut, dest, words, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
