// The restart-row join of a fused encode's scans on Hopper (sm_90a),
// hand-written in CUDA C++.
//
// Replaces no TPU kernel: the JAX package, like the port's other encode
// routes, joins on the host, in uhdr_join_blocks (csrc/host/jpeg_entropy.cpp,
// through jpeg/native.join_blocks): one sequential byte loop a scan.  It
// takes the pack kernel's output as it stands (csrc/pack_kernel.cu: block
// b's MSB-first bits word-aligned at the exclusive prefix sum of
// ceil(blen/32), blen with no restart-row pad) and writes each scan's final
// entropy-coded bytes, equal byte for byte to uhdr_join_blocks on the same
// words: the blocks of a restart row (an MCU row) concatenated bit by bit,
// the row padded to a byte with 1-bits (T.81 F.1.2.3), 0x00 stuffed after
// every 0xFF byte, the pad byte included (F.1.2.3), and FF D0+(r & 7)
// between rows, none after a scan's last.  Several scans packed back to back
// in one launch of the pack are joined in one pass of launches, into one
// buffer, each scan after the one before; `sizes` gives each one's bytes.
//
// What bounds it on the H100: device memory, in principle.  An 8192x4320
// encode at the library's defaults reads about 34 MB of live words and 10 MB
// of block lengths and writes about 29 MB: some 0.02 ms at 3.35 TB/s.  The
// restart rows are byte-aligned and independent, so the work is parallel
// over rows; inside a row each output byte depends only on the bit offset
// of its block, and its stuffed position only on the 0xFF bytes before it.
//
// Design: five launches on the caller's stream, no host read between them.
// - join_sums, a CTA a row: the row's bits and words (sums of blen and
//   ceil(blen/32)), CUB block reductions.
// - join_first_words, one CTA: the exclusive prefix of the rows' words,
//   each row's first word (the scans' words follow each other, so one prefix
//   over all rows serves every scan).
// - join_count, a CTA a row: the row's block bit offsets and word offsets
//   (a CUB block scan of (bits << 32 | words), a thread a run of blocks) into
//   shared memory, then every output word (4 bytes, 1-bits past the row's
//   end) gathered by its thread from the blocks that cover it, the block
//   found by a binary search over the row's offsets; the row's 0xFF bytes
//   counted.  Rows need not fit in shared memory, only their offsets (8
//   bytes a block: 24 KB for the widest row of an 8192-pixel image, 3,072
//   blocks).
// - join_layout, one CTA: each row's stuffed length (bytes + 0xFF bytes +
//   the marker after it), their exclusive prefix (the row's place in the
//   output) and each scan's size.
// - join_write, a CTA a row: the row's output words gathered again, a tile
//   of 256 at a time; each thread's stuffed byte count (its bytes and their
//   0xFF bytes) scanned across the CTA gives its bytes' places; then the
//   marker.  The output is read by the host after one wait for the stream.
// The output is sized by the caller from the block count (8 bytes a word of
// the pack's room, plus 2 a row): the bytes of a row are at most 4 a word,
// and stuffing at most doubles them.  A row that would pass `capacity` is
// not written; the caller refuses sizes whose sum passes it.

#include <cstdint>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // a CTA a restart row
constexpr int kRowsThreads = 512;   // the one-CTA passes over the rows
constexpr int kMaxScans = 8;
constexpr int kMaxBpr = 8192;       // blocks a row: 64 KB of offsets

// The scans joined, rows numbered across all of them in packing order.
struct Scans {
  int n;
  int64_t row0[kMaxScans + 1];  // first row of each scan; row0[n] = rows
  int64_t block0[kMaxScans];    // first block of each scan
  int bpr[kMaxScans];           // blocks a row
};

// Per-row scratch, R int64 words each, in this order.
enum Field { kBits, kWords, kFirstWord, kFF, kOutPos, kFields };

struct Row {
  int64_t index;        // among all rows
  int64_t in_scan;      // among its scan's rows
  int64_t first_block;
  int bpr;
  bool last;            // its scan's last row: no marker after it
};

__device__ __forceinline__ Row row_of(const Scans& s, int64_t r) {
  int k = 0;
  while (k + 1 < s.n && r >= s.row0[k + 1]) ++k;
  Row row;
  row.index = r;
  row.in_scan = r - s.row0[k];
  row.bpr = s.bpr[k];
  row.first_block = s.block0[k] + row.in_scan * s.bpr[k];
  row.last = r + 1 == s.row0[k + 1];
  return row;
}

__global__ void __launch_bounds__(kThreads)
join_sums(const int32_t* __restrict__ blen, Scans s, int64_t rows,
          int64_t* __restrict__ scratch) {
  const Row row = row_of(s, blockIdx.x);
  long long bits = 0, words = 0;
  for (int i = threadIdx.x; i < row.bpr; i += kThreads) {
    const int b = blen[row.first_block + i];
    bits += b;
    words += (b + 31) >> 5;
  }
  using Reduce = cub::BlockReduce<long long, kThreads>;
  __shared__ typename Reduce::TempStorage tmp[2];
  bits = Reduce(tmp[0]).Sum(bits);
  words = Reduce(tmp[1]).Sum(words);
  if (threadIdx.x == 0) {
    scratch[kBits * rows + row.index] = bits;
    scratch[kWords * rows + row.index] = words;
  }
}

// The exclusive prefix of value(r) over r < rows, stored by store(r, prefix),
// kRowsThreads rows a round; returns the total to every thread.
template <class Value, class Store>
__device__ long long scan_rows(int64_t rows, Value value, Store store) {
  using Scan = cub::BlockScan<long long, kRowsThreads>;
  __shared__ typename Scan::TempStorage tmp;
  long long carry = 0;
  for (int64_t base = 0; base < rows; base += kRowsThreads) {
    const int64_t r = base + threadIdx.x;
    long long excl, total;
    Scan(tmp).ExclusiveSum(r < rows ? value(r) : 0ll, excl, total);
    if (r < rows) store(r, carry + excl);
    carry += total;
    __syncthreads();  // tmp is reused
  }
  return carry;
}

__global__ void __launch_bounds__(kRowsThreads)
join_first_words(int64_t rows, int64_t* __restrict__ scratch) {
  scan_rows(
      rows, [&](int64_t r) { return scratch[kWords * rows + r]; },
      [&](int64_t r, long long v) { scratch[kFirstWord * rows + r] = v; });
}

// The row's block bit offsets bofs[0..bpr] (bofs[bpr] its bits) and word
// offsets wofs[0..bpr) in shared memory; thread t takes a run of blocks.
__device__ void row_offsets(const int32_t* __restrict__ blen, const Row& row,
                            int* bofs, int* wofs) {
  const int run = (row.bpr + kThreads - 1) / kThreads;
  const int lo = min(row.bpr, static_cast<int>(threadIdx.x) * run);
  const int hi = min(row.bpr, lo + run);
  long long sum = 0;  // bits << 32 | words: a row's words stay below 2^32
  for (int i = lo; i < hi; ++i) {
    const int b = blen[row.first_block + i];
    sum += (static_cast<long long>(b) << 32) + ((b + 31) >> 5);
  }
  using Scan = cub::BlockScan<long long, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  long long excl;
  Scan(tmp).ExclusiveSum(sum, excl);
  int bits = static_cast<int>(excl >> 32);
  int words = static_cast<int>(excl & 0xffffffffll);
  for (int i = lo; i < hi; ++i) {
    const int b = blen[row.first_block + i];
    bofs[i] = bits;
    wofs[i] = words;
    bits += b;
    words += (b + 31) >> 5;
  }
  if (lo < hi && hi == row.bpr) bofs[row.bpr] = bits;
  __syncthreads();
}

// n bits (1..32) of a block's MSB-first stream from bit t on, right-aligned;
// w is the block's first word.  The second word is read only when the bits
// reach into it.
__device__ __forceinline__ uint32_t take_bits(const uint32_t* __restrict__ w,
                                              int t, int n) {
  const int i = t >> 5, sh = t & 31;
  uint64_t v = static_cast<uint64_t>(w[i]) << 32;
  if (sh + n > 32) v |= w[i + 1];
  return static_cast<uint32_t>((v << sh) >> (64 - n));
}

// The row's 32 bits from bit q on (q a multiple of 32), MSB first, 1-bits
// past the row's end: the blocks that cover them, the first found by a
// binary search over the offsets (the last block whose offset is <= q, so a
// block of no bits is passed over).
__device__ __forceinline__ uint32_t row_word(
    const uint32_t* __restrict__ words, int64_t first_word, const int* bofs,
    const int* wofs, int bpr, int q) {
  const int end = bofs[bpr];
  int lo = 0, hi = bpr - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bofs[mid] <= q)
      lo = mid;
    else
      hi = mid - 1;
  }
  uint64_t acc = 0;
  int got = 0;
  for (int k = lo; got < 32 && q < end; ++k) {
    const int t = q - bofs[k];
    const int avail = bofs[k + 1] - bofs[k] - t;
    if (avail <= 0) continue;
    const int n = min(avail, 32 - got);
    acc = (acc << n) | take_bits(words + first_word + wofs[k], t, n);
    got += n;
    q += n;
  }
  const int pad = 32 - got;
  return static_cast<uint32_t>((acc << pad) | ((1ull << pad) - 1));
}

// 0xFF bytes among the first `valid` (1..4) bytes of v, MSB first.
__device__ __forceinline__ int count_ff(uint32_t v, int valid) {
  const uint32_t keep =
      valid >= 4 ? 0xffffffffu : ~(0xffffffffu >> (8 * valid));
  return __popc(__vcmpeq4(v, 0xffffffffu) & keep) >> 3;
}

__global__ void __launch_bounds__(kThreads)
join_count(const uint32_t* __restrict__ words,
           const int32_t* __restrict__ blen, Scans s, int64_t rows,
           int64_t* __restrict__ scratch) {
  extern __shared__ int offsets[];
  const Row row = row_of(s, blockIdx.x);
  int* bofs = offsets;
  int* wofs = offsets + row.bpr + 1;
  row_offsets(blen, row, bofs, wofs);
  const int nbytes = (bofs[row.bpr] + 7) >> 3;
  const int nwords = (nbytes + 3) >> 2;
  const int64_t first = scratch[kFirstWord * rows + row.index];
  int ff = 0;
  for (int i = threadIdx.x; i < nwords; i += kThreads)
    ff += count_ff(row_word(words, first, bofs, wofs, row.bpr, 32 * i),
                   min(4, nbytes - 4 * i));
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  ff = Reduce(tmp).Sum(ff);
  if (threadIdx.x == 0) scratch[kFF * rows + row.index] = ff;
}

__global__ void __launch_bounds__(kRowsThreads)
join_layout(Scans s, int64_t rows, int64_t* __restrict__ scratch,
            int64_t* __restrict__ sizes) {
  const long long total = scan_rows(
      rows,
      [&](int64_t r) {
        const long long bytes = (scratch[kBits * rows + r] + 7) >> 3;
        return bytes + scratch[kFF * rows + r] + (row_of(s, r).last ? 0 : 2);
      },
      [&](int64_t r, long long v) { scratch[kOutPos * rows + r] = v; });
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < s.n) {
    const int k = threadIdx.x;
    const auto at = [&](int64_t r) {
      return r < rows ? scratch[kOutPos * rows + r] : total;
    };
    sizes[k] = at(s.row0[k + 1]) - at(s.row0[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
join_write(const uint32_t* __restrict__ words,
           const int32_t* __restrict__ blen, Scans s, int64_t rows,
           const int64_t* __restrict__ scratch, uint8_t* __restrict__ out,
           int64_t capacity) {
  extern __shared__ int offsets[];
  const Row row = row_of(s, blockIdx.x);
  int* bofs = offsets;
  int* wofs = offsets + row.bpr + 1;
  const int64_t bits = scratch[kBits * rows + row.index];
  const int nbytes = static_cast<int>((bits + 7) >> 3);
  int64_t pos = scratch[kOutPos * rows + row.index];
  if (pos + nbytes + scratch[kFF * rows + row.index] + (row.last ? 0 : 2) >
      capacity)
    return;  // the whole CTA: the caller refuses sizes past capacity
  row_offsets(blen, row, bofs, wofs);
  const int nwords = (nbytes + 3) >> 2;
  const int64_t first = scratch[kFirstWord * rows + row.index];
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  for (int base = 0; base < nwords; base += kThreads) {
    const int i = base + threadIdx.x;
    uint32_t v = 0;
    int valid = 0;
    if (i < nwords) {
      v = row_word(words, first, bofs, wofs, row.bpr, 32 * i);
      valid = min(4, nbytes - 4 * i);
    }
    const int n = valid + (valid ? count_ff(v, valid) : 0);
    int excl, total;
    Scan(tmp).ExclusiveSum(n, excl, total);
    uint8_t* o = out + pos + excl;
    for (int j = 0; j < valid; ++j) {
      const uint8_t c = static_cast<uint8_t>(v >> (24 - 8 * j));
      *o++ = c;
      if (c == 0xff) *o++ = 0;
    }
    pos += total;
    __syncthreads();  // tmp is reused
  }
  if (!row.last && threadIdx.x == 0) {
    out[pos] = 0xff;
    out[pos + 1] = static_cast<uint8_t>(0xd0 + (row.in_scan & 7));
  }
}

}  // namespace

// Plain C interface for ctypes.  `words` and `blen` are the pack's device
// outputs (blen int32, one a block of every scan in packing order); the
// host arrays scan_blocks[n_scans] and scan_bpr[n_scans] give each scan's
// blocks (a multiple of its blocks a row) and blocks a row (1..kMaxBpr).
// `scratch` holds scratch_words int64 device words, at least 5 a row;
// `out` has `capacity` bytes; `sizes` (n_scans int64, device) receives each
// scan's bytes.  Returns cudaErrorInvalidValue when the sizes do not hold,
// else the first launch error (0 when all five were accepted).
extern "C" int uhdr_join_scans(const uint32_t* words, const int32_t* blen,
                               int n_scans, const int64_t* scan_blocks,
                               const int64_t* scan_bpr, int64_t scratch_words,
                               int64_t* scratch, uint8_t* out,
                               int64_t capacity, int64_t* sizes,
                               void* cuda_stream) {
  if (n_scans < 1 || n_scans > kMaxScans)
    return static_cast<int>(cudaErrorInvalidValue);
  Scans s{};
  s.n = n_scans;
  int max_bpr = 1;
  int64_t rows = 0, blocks = 0;
  for (int k = 0; k < n_scans; ++k) {
    if (scan_bpr[k] < 1 || scan_bpr[k] > kMaxBpr || scan_blocks[k] < 0 ||
        scan_blocks[k] % scan_bpr[k] != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    s.row0[k] = rows;
    s.block0[k] = blocks;
    s.bpr[k] = static_cast<int>(scan_bpr[k]);
    if (s.bpr[k] > max_bpr) max_bpr = s.bpr[k];
    rows += scan_blocks[k] / scan_bpr[k];
    blocks += scan_blocks[k];
  }
  s.row0[n_scans] = rows;
  if (scratch_words < kFields * rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  const size_t smem = (2 * static_cast<size_t>(max_bpr) + 1) * sizeof(int);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(join_count,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(join_write,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto grid = static_cast<unsigned>(rows);
  join_sums<<<grid, kThreads, 0, stream>>>(blen, s, rows, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  join_first_words<<<1, kRowsThreads, 0, stream>>>(rows, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  join_count<<<grid, kThreads, smem, stream>>>(words, blen, s, rows, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  join_layout<<<1, kRowsThreads, 0, stream>>>(s, rows, scratch, sizes);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  join_write<<<grid, kThreads, smem, stream>>>(words, blen, s, rows, scratch,
                                               out, capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
