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
// word is emitted once, in registers.  Slot payloads are below 2^length
// (length <= 26; the row pad slot <= 7), so a slot of length 0 adds nothing
// and no 32-bit value is ever shifted by 32: the accumulator is 64 bits wide
// and the final partial word is shifted by 32 - pending with
// 0 < pending < 32.  Bits past blen in a block's last word are zero.
//
// What bounds them on the H100: device memory.  Each block reads 576 bytes
// of slots (two 288-byte rows) and does ~72 shift-ors (about 0.015 ms of
// instructions for the whole 4K default request); the block pack writes
// 216 bytes per block, the tile pack only the live words (about 3-4 per
// block on photographic content).  Both kernels stage their slots in
// shared memory with Hopper's bulk copy (cp.async.bulk, completing on an
// mbarrier): a block's rows are contiguous in device memory, so a few bulk
// copies move a whole group of blocks in full 128-byte lines, with no
// address arithmetic and no registers spent on the copy.  A thread then
// reads its block's rows out of shared memory.  The 72-word row stride
// puts the 16-byte reads of 8 neighbouring lanes on 2 banks each (2-way
// conflicts): 288 wavefronts for a group of 32 blocks, about 0.04 ms for
// the 4K default request spread over the SMs, well under the memory
// bound, so the rows stay unswizzled.
//
// uhdr_pack_blocks.
// - Before (one thread per block, 128-thread CTAs): a warp's 16-byte loads
//   hit 32 rows 288 bytes apart, using half of each 32-byte sector, and the
//   live rows of an SM's resident CTAs (over 1 MB) do not fit in L1, so
//   every sector was fetched twice; the 18-step slot loop was not unrolled
//   (two loads in flight a thread); word k of a block was stored by
//   whichever slot filled it, so each store instruction ran with part of
//   the warp and wrote as many 128-byte rows as it had active lanes; the
//   zero fill was a second store loop.  It reached 20% of its bound.
// - Now: a warp owns groups of 32 consecutive blocks, whose slots are two
//   contiguous 9,216-byte ranges.  A persistent grid (as many CTAs of
//   kPackWarps warps as fit on the SMs) walks the groups; each warp keeps a
//   ring of kStages groups in shared memory, so that the bulk copy of the
//   next group is in flight while a group is packed.  Each lane writes its
//   block's words into its own column of a shared (54, 32) tile; the warp
//   then stores row k of bb_t for its 32 blocks as one coalesced 128-byte
//   store, zeros included, which removes the divergent stores and the
//   separate zero fill.  Bound: device memory, with 74 KB of copies in
//   flight per SM (far more than the card's bandwidth-delay product needs);
//   it reaches 74-80% of that bound at the 4K shapes on an H100 SXM at
//   700 W.
//
// uhdr_pack_tiles.
// - Before (one CTA of 1024 threads per 2048-block tile, two blocks a
//   thread): the 4K default request's 285 tiles ran in 2-3 waves on 132
//   SMs with a last wave of 8-16%, and the benchmark's 99 tiles filled 75%
//   of one; lens was read from device memory twice (864 bytes a block
//   against 576), with the same strided per-thread loads as the block pack;
//   no load was in flight during the CTA-wide scan.  It reached 13% of its
//   bound (default) and 31% (benchmark).
// - Now: a tile is split over a thread block cluster of kCluster CTAs, one
//   kSub-block sub-tile each, one block a thread.  Each CTA bulk-copies its
//   sub-tile's lens and pays into shared memory at once (two barriers: the
//   lens arrive first), sums each block's bits from the staged lens (blen),
//   takes the CTA's exclusive scan of the word lengths and publishes its
//   word total in its shared memory.  After one cluster barrier each CTA
//   reads the totals of the lower ranks of its cluster over distributed
//   shared memory: their sum is the sub-tile's offset in the tile.  No
//   global flag, no look-back, no second pass.  It then packs its blocks
//   from the staged slots, writing the live words at their offsets and
//   dropping every word at or past tile_words, so an overflowing tile loses
//   exactly the tail its plain version drops, whichever sub-tile the
//   overflow begins in.  The grid is n_tiles * kCluster CTAs of 73.7 KB
//   each, three resident on an SM: while one waits on its copies, another
//   scans or packs.  Bound: device memory; it reaches 56-68% of it at the
//   4K shapes on an H100 SXM at 700 W, held back by each CTA's serial
//   phases (copy, scan, cluster barrier, pack) and by the last, part-empty
//   round of resident clusters.  The rest of a tile is left unwritten, as
//   on the TPU.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 72;                 // slots per block
constexpr int kRowBytes = kSlots * 4;      // one block's pays or lens row
constexpr int kCap = 54;                   // words per block buffer
constexpr int kTile = 2048;                // blocks per compacted tile

// uhdr_pack_blocks: groups of kGroup blocks (a lane each), kPackWarps warps
// per CTA, a ring of kStages groups per warp.
constexpr int kGroup = 32;
constexpr int kPackWarps = 4;
constexpr int kStages = 2;

// uhdr_pack_tiles: kSub blocks per CTA (a thread each), kCluster CTAs per
// tile (a cluster; above 8 the size is non-portable, at most 16 on H100).
constexpr int kSub = 128;
constexpr int kCluster = kTile / kSub;
static_assert(kTile % kSub == 0 && kSub % 32 == 0 && kCluster <= 16,
              "a tile is at most 16 CTAs of whole warps");

// ---- PTX helpers: mbarriers, bulk copies, the cluster ---------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier that completes a phase on one arrival and its bulk copies.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(1) : "memory");
}

// Makes the mbarrier inits visible to the bulk-copy (async) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The barrier's one arrival of a phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into this CTA's shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// *p in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ int ld_cluster(const int* p, int rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];"
               : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// ---- the slot walk ----------------------------------------------------------

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
#pragma unroll
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
#pragma unroll
  for (int i = 0; i < kSlots / 4; ++i) {
    const int4 l = l4[i];
    bits += l.x + l.y + l.z + l.w;
  }
  return bits;
}

// ---- uhdr_pack_blocks -------------------------------------------------------

// One warp's shared memory: the ring of slot groups, the output tile (word
// k of the lane's block at words[k][lane]) and the ring's barriers.
struct alignas(16) PackWarpSmem {
  uint32_t pays[kStages][kGroup * kSlots];
  int32_t lens[kStages][kGroup * kSlots];
  uint32_t words[kCap][kGroup];
  uint64_t bar[kStages];
};
constexpr int kPackSmem = kPackWarps * static_cast<int>(sizeof(PackWarpSmem));
static_assert(sizeof(PackWarpSmem) % 16 == 0, "16-byte aligned stages");

// Lane 0: start the copies of group g (if it exists) into ring stage st.
__device__ __forceinline__ void load_group(PackWarpSmem& s, int st, int64_t g,
                                           const uint32_t* pays,
                                           const int32_t* lens, int64_t n) {
  const int64_t b0 = g * kGroup;
  if (b0 >= n) return;
  const uint32_t bytes =
      static_cast<uint32_t>(n - b0 < kGroup ? n - b0 : kGroup) * kRowBytes;
  mbar_expect(&s.bar[st], 2 * bytes);
  bulk_load(s.pays[st], pays + b0 * kSlots, bytes, &s.bar[st]);
  bulk_load(s.lens[st], lens + b0 * kSlots, bytes, &s.bar[st]);
}

__global__ void __launch_bounds__(kPackWarps * 32)
    pack_blocks_kernel(const uint32_t* __restrict__ pays,
                       const int32_t* __restrict__ lens,
                       uint32_t* __restrict__ bb_t,
                       int32_t* __restrict__ blen, int64_t n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  PackWarpSmem& s = reinterpret_cast<PackWarpSmem*>(smem)[threadIdx.x >> 5];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kPackWarps;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kPackWarps + (threadIdx.x >> 5);
  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&s.bar[st]);
    mbar_fence_init();
    for (int st = 0; st < kStages; ++st)
      load_group(s, st, first + st * stride, pays, lens, n);
  }
  __syncwarp();
  int i = 0;
  for (int64_t g = first; g * kGroup < n; g += stride, ++i) {
    const int st = i % kStages;
    mbar_wait(&s.bar[st], (i / kStages) & 1);
    const int64_t b = g * kGroup + lane;
    int words = 0;
    if (b < n) {
      const int bits = pack_block(s.pays[st] + lane * kSlots,
                                  s.lens[st] + lane * kSlots,
                                  [&](int k, uint32_t w) {
                                    if (k < kCap) s.words[k][lane] = w;
                                  });
      blen[b] = bits;
      words = (bits + 31) >> 5;
    }
    __syncwarp();  // every lane is done reading stage st: refill it
    if (lane == 0) load_group(s, st, g + kStages * stride, pays, lens, n);
    if (b < n) {
#pragma unroll 6
      for (int k = 0; k < kCap; ++k)
        bb_t[k * n + b] = k < words ? s.words[k][lane] : 0u;
    }
  }
}

// ---- uhdr_pack_tiles --------------------------------------------------------

constexpr int kTileSmem = 2 * kSub * kRowBytes;  // the sub-tile's pays, lens

// Exclusive prefix sum of v over the CTA's kSub threads in thread order.
__device__ __forceinline__ int cta_exclusive_scan(int v, int* warp_sums) {
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
    int s = lane < kSub / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kSub / 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kSub / 32) warp_sums[lane] = s;  // inclusive over the warps
  }
  __syncthreads();
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(kSub)
    pack_tiles_kernel(const uint32_t* __restrict__ pays,
                      const int32_t* __restrict__ lens,
                      uint32_t* __restrict__ tiles,
                      int32_t* __restrict__ blen, int64_t n,
                      int64_t tile_words) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* pays_s = reinterpret_cast<uint32_t*>(smem);
  int32_t* lens_s = reinterpret_cast<int32_t*>(smem + kSub * kRowBytes);
  __shared__ uint64_t bar[2];  // [0] the lens, [1] the pays
  __shared__ int warp_sums[kSub / 32];
  __shared__ int sub_words;    // this sub-tile's live words
  const int t = threadIdx.x;
  const int rank = cluster_rank();
  const int64_t tile = blockIdx.x / kCluster;
  const int64_t first = tile * kTile + static_cast<int64_t>(rank) * kSub;
  const int nb = n - first >= kSub ? kSub
                 : n > first       ? static_cast<int>(n - first)
                                   : 0;
  if (t == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    mbar_fence_init();
    if (nb > 0) {
      const uint32_t bytes = static_cast<uint32_t>(nb) * kRowBytes;
      mbar_expect(&bar[0], bytes);
      bulk_load(lens_s, lens + first * kSlots, bytes, &bar[0]);
      mbar_expect(&bar[1], bytes);
      bulk_load(pays_s, pays + first * kSlots, bytes, &bar[1]);
    }
  }
  __syncthreads();
  int wlen = 0;
  if (nb > 0) {
    mbar_wait(&bar[0], 0);
    if (t < nb) {
      const int bits = block_bits(lens_s + t * kSlots);
      blen[first + t] = bits;
      wlen = (bits + 31) >> 5;
    }
  }
  const int excl = cta_exclusive_scan(wlen, warp_sums);
  if (t == kSub - 1) sub_words = excl + wlen;
  cluster_arrive_release();
  cluster_wait();
  // the sub-tile's offset in its tile: the words of the lower ranks
  const int lane = t & 31;
  const int below = __reduce_add_sync(
      0xffffffffu, lane < rank ? ld_cluster(&sub_words, lane) : 0);
  cluster_arrive_relaxed();  // done reading the other CTAs' shared memory
  if (nb > 0) mbar_wait(&bar[1], 0);
  const int64_t dest = static_cast<int64_t>(below) + excl;
  if (t < nb && wlen > 0 && dest < tile_words) {
    uint32_t* out = tiles + tile * tile_words;
    pack_block(pays_s + t * kSlots, lens_s + t * kSlots,
               [&](int k, uint32_t w) {
                 if (dest + k < tile_words) out[dest + k] = w;
               });
  }
  cluster_wait();  // no CTA leaves while another may read its sub_words
}

// ---- per-device set-up ------------------------------------------------------

struct DeviceSetup {
  bool ready;
  int pack_ctas;  // resident pack_blocks_kernel CTAs on the whole card
};
constexpr int kMaxDevices = 64;
DeviceSetup g_setup[kMaxDevices];

// The current device's set-up: the kernels' shared-memory attributes set
// once, and the size of the block pack's persistent grid.
cudaError_t device_setup(const DeviceSetup** out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceSetup& d = g_setup[dev];
  if (!d.ready) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(
             pack_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kPackSmem)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(
             pack_blocks_kernel,
             cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, pack_blocks_kernel, kPackWarps * 32, kPackSmem)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(
             pack_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kTileSmem)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(
             pack_tiles_kernel,
             cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (kCluster > 8 &&
         (e = cudaFuncSetAttribute(
              pack_tiles_kernel,
              cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
             cudaSuccess))
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    d.pack_ctas = sms * per_sm;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers (pays and lens
// (n, 72) row-major and 16-byte aligned); `cuda_stream` is the caller's
// cudaStream_t.  Each returns the CUDA error of its set-up, or
// cudaGetLastError() right after its launch (0 when the launch was
// accepted).
extern "C" int uhdr_pack_blocks(const uint32_t* pays, const int32_t* lens,
                                uint32_t* bb_t, int32_t* blen, int64_t n,
                                void* cuda_stream) {
  if (n <= 0) return 0;
  const DeviceSetup* d;
  const cudaError_t e = device_setup(&d);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t warps = (n + kGroup - 1) / kGroup;
  const int64_t ctas = (warps + kPackWarps - 1) / kPackWarps;
  const unsigned grid =
      static_cast<unsigned>(ctas < d->pack_ctas ? ctas : d->pack_ctas);
  pack_blocks_kernel<<<grid, kPackWarps * 32, kPackSmem,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
      pays, lens, bb_t, blen, n);
  return static_cast<int>(cudaGetLastError());
}

// tiles: (ceil(n / 2048), tile_words) words, tile_words = 2048 * budget.
extern "C" int uhdr_pack_tiles(const uint32_t* pays, const int32_t* lens,
                               uint32_t* tiles, int32_t* blen, int64_t n,
                               int64_t tile_words, void* cuda_stream) {
  if (n <= 0) return 0;
  const DeviceSetup* d;
  cudaError_t e = device_setup(&d);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + kTile - 1) / kTile) *
                     kCluster);
  cfg.blockDim = dim3(kSub);
  cfg.dynamicSmemBytes = kTileSmem;
  cfg.stream = static_cast<cudaStream_t>(cuda_stream);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, pack_tiles_kernel, pays, lens, tiles, blen, n,
                         tile_words);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
