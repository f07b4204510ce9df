// Entropy decode of one baseline JPEG scan without restart markers on
// Hopper (sm_90a), hand-written in CUDA C++, bound by
// jpeg/huffman_kernel.py.
//
// It replaces no Pallas kernel: the JAX package Huffman-decodes every scan
// on the host (libultrahdr_tpu/jpeg/native.py:565, decode_scan, over the
// C++ of csrc/host/jpeg_entropy.cpp).  The port's fused decode sent the
// host's int16 coefficient planes up instead, 9-12 times the scan's bytes;
// with this decoder only the scan goes up and the card makes the planes.
//
// The output is what uhdr_decode_scan writes for the same stream: the
// (mcus_h * v, mcus_w * h, 64) int16 zigzag planes of each component,
// MCU-padded, the DC the low 16 bits of the running sum of its
// differences.  A stream the host decodes only by its corrupt-data rules
// (an invalid code, a run past coefficient 63, bits that end before the
// last block) sets a bit of the status word instead, and the caller decodes
// it again on the host.  No write leaves the planes, whatever the stream
// holds.
//
// A scan without restart markers has no point where a decoder can start
// but its first bit.  Self-synchronisation (Weissenberger and Schmidt,
// "Massively Parallel Huffman Decoding on GPUs", ICPP 2018, and
// "Accelerating JPEG Decompression on GPUs", HiPC 2021) makes one anyway:
// a decoder started at an arbitrary bit falls into step with the true
// symbol boundaries, and with the block and coefficient it is in, after a
// few dozen codewords.  So:
//
//  1. unstuff (two launches over 4,096-byte tiles): the end of the data is
//     its first marker (an FF followed by anything but 00); every 00 after
//     an FF before it goes, each tile's count of them first, then each
//     tile's bytes written at the prefix of the counts before it.  The
//     bytes after the data are zeroed, so a read past the end sees zeros.
//  2. sync (kRounds launches at most): the bit string is cut into
//     subsequences of S bits, one thread each, kLanes a CTA.  A thread
//     decodes from a start state (the bit, the block's place in the MCU,
//     the coefficient index) on past its end, to the first symbol that
//     starts in the next subsequence, and records that exit state with the
//     blocks whose DC it decoded and the sum of their DC differences per
//     component.  Within a CTA, each thread takes its left neighbour's exit
//     as its start and decodes again while any start changes (shared
//     memory, __syncthreads_or).  Across CTAs, each launch is a round: a
//     CTA whose first thread's start differs from the previous CTA's exit
//     of the round before decodes again, and marks the round.  A round that
//     marks nothing ends the sync: every start is then the true state,
//     since the first subsequence starts at the true one.  The later
//     launches see that and return at once.  A thread that meets an
//     invalid code or a run past coefficient 63 before it syncs stops and
//     hands its neighbour the default start, as it would be guessed.
//  3. scan (one CTA): the exclusive prefix of the block counts and of the
//     DC sums over the subsequences gives each its first block and the DC
//     predictor of each component there.
//  4. write: each thread decodes again from its synced state, skips the
//     tail of the block that started to its left, and decodes the blocks
//     whose DC starts in its subsequence whole, past its end if they run
//     on, into shared memory; each block goes out as eight 16-byte stores
//     at the plane row and column of its MCU, zeros included, so the
//     planes need no fill.
//
// What bounds it on the H100.  The bytes are few: the scan read and the
// coefficients written once, 43.5 MB for a 12 MP 4:2:0 base, 13 us at
// 3.35 TB/s.  The work is not: each thread's symbols depend one on the
// next (the length of one code gives the start of the next), a lookup in
// shared memory and a few integer operations each, and the sync decodes a
// subsequence again each time its start changes (a 4:2:0 scan takes about
// ten agreements within a CTA before its threads hold the true state).
// The design keeps the chains many (a thread a 1,024-bit subsequence:
// 34k threads for the 12 MP base) and the tables in shared memory (a
// 10-bit lookahead of length and symbol a table, the canonical limits for
// codes of 11-16 bits), with a rolling 64-bit window of the bits in
// registers, one 4-byte load per 32 bits consumed.  It sits two orders
// below the byte bound (1.6 ms for that base), the sync rounds more than
// half of it, the one-CTA scan a fifth: PERF.md gives the split.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;            // threads of a sync or write CTA
constexpr int kTileBytes = 4096;       // bytes of an unstuff CTA
constexpr int kTileThreads = 256;      // 16 bytes a thread
constexpr int kMaxSlots = 8;           // Huffman tables a scan references
constexpr int kMaxBlocksPerMcu = 16;
constexpr int kHeaderBytes = 4096;
constexpr int kScanThreads = 1024;
constexpr int kRounds = 16;          // sync rounds across CTAs, at most

// status bits (jpeg/huffman_kernel.py repeats them)
constexpr int kNotSynced = 1;     // the last round still changed a start
constexpr int kBadCode = 2;       // no code matches, in a block written
constexpr int kPast63 = 4;        // a run past coefficient 63
constexpr int kOutOfBits = 8;     // a symbol runs past the data
constexpr int kBlockCount = 16;   // blocks found != mcus * blocks an MCU
constexpr int kStopped = 32;      // a subsequence stopped before the end
constexpr int kPhase = 64;        // a block's place disagrees with its MCU

// One Huffman table as the decoder reads it.
struct Dtab {
  uint16_t look[1024];   // 10-bit lookahead: length << 8 | symbol, 0 a miss
  int32_t maxcode[18];
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t vals[256];
};
static_assert(sizeof(Dtab) % 16 == 0, "Dtab copies in 16-byte words");

// The wrapper's header, kHeaderBytes ahead of the scan's bytes.
struct Header {
  int32_t nslots, bpm, num_comps, mcus_w, mcus_h, pad0[3];
  int32_t comp_h[4], comp_v[4], comp_bw[4], pad1[12];
  int32_t u_dc[kMaxBlocksPerMcu], u_ac[kMaxBlocksPerMcu],
      u_ci[kMaxBlocksPerMcu], u_by[kMaxBlocksPerMcu], u_bx[kMaxBlocksPerMcu];
  int32_t pad2[16];
  uint8_t bits[kMaxSlots][16];
  uint8_t vals[kMaxSlots][256];
};
static_assert(sizeof(Header) <= kHeaderBytes, "header too large");

struct Layout {
  int64_t tiles, lanes, ctas;
  int64_t dtab, ctrl, drops, bytes, st, ex, cnt, first, err, dcs, bexit,
      total;
};

Layout layout_of(int64_t n, int sub_bits) {
  Layout L{};
  L.tiles = n > 0 ? (n + kTileBytes - 1) / kTileBytes : 1;
  L.lanes = n > 0 ? (n * 8 + sub_bits - 1) / sub_bits : 1;
  L.ctas = (L.lanes + kLanes - 1) / kLanes;
  int64_t off = 0;
  auto take = [&off](int64_t b) {
    const int64_t o = off;
    off += (b + 15) & ~int64_t{15};
    return o;
  };
  L.dtab = take(kMaxSlots * sizeof(Dtab));
  L.ctrl = take(4 * (4 + kRounds));
  L.drops = take(4 * L.tiles);
  L.bytes = take(n + 32);
  L.st = take(8 * L.lanes);
  L.ex = take(8 * L.lanes);
  L.cnt = take(4 * L.lanes);
  L.first = take(4 * L.lanes);
  L.err = take(4 * L.lanes);
  L.dcs = take(16 * L.lanes);
  L.bexit = take(16 * L.ctas);
  L.total = off;
  return L;
}

// ctrl words: the first marker's offset, the data's bytes, the status
// before the write pass, then one changed-flag a round.
struct Ctrl {
  int32_t end, nbytes, status_before_write, pad;
  int32_t changed[kRounds];
};

struct Params {
  const Header* hdr;
  const uint8_t* src;   // the scan's bytes
  int64_t n;
  int sub_bits;
  int64_t lanes;
  int expected;         // mcus_w * mcus_h * bpm
  uint8_t* scratch;
  Layout L;
  int32_t* status;
  int16_t* planes[4];
};

__device__ __forceinline__ Ctrl* ctrl_of(const Params& P) {
  return reinterpret_cast<Ctrl*>(P.scratch + P.L.ctrl);
}

// A state: the bit, the block's place in the MCU and the coefficient index
// (0: the next symbol is a DC), packed so that one compare tells two
// states apart.
__device__ __forceinline__ uint64_t pack_state(uint32_t p, int u, int k) {
  return (uint64_t(p) << 16) | (uint64_t(u) << 8) | uint64_t(k);
}

struct Units {            // the block places of an MCU, in shared memory
  uint8_t dc[kMaxBlocksPerMcu], ac[kMaxBlocksPerMcu], ci[kMaxBlocksPerMcu];
};

// Bits [base, base + 64) of the de-stuffed string in a register, base a
// multiple of 32; the bytes are read as big-endian words.
struct Bits {
  const uint32_t* w;
  uint64_t buf;
  uint32_t base;

  __device__ __forceinline__ static uint32_t be(uint32_t x) {
    return __byte_perm(x, 0, 0x0123);
  }
  __device__ __forceinline__ void seek(uint32_t p) {
    base = p & ~31u;
    buf = (uint64_t(be(w[base >> 5])) << 32) | be(w[(base >> 5) + 1]);
  }
  // 32 bits from p; p never moves back and by at most 31 bits a symbol
  __device__ __forceinline__ uint32_t peek(uint32_t p) {
    if (p - base >= 32) {
      base += 32;
      buf = (buf << 32) | be(w[(base >> 5) + 1]);
    }
    return uint32_t((buf << (p - base)) >> 32);
  }
};

__device__ __forceinline__ int extend(uint32_t v, int s) {
  return s == 0 ? 0
                : (int(v) < (1 << (s - 1)) ? int(v) - (1 << s) + 1 : int(v));
}

// One symbol from state (p, u, k): its code (10-bit lookahead, else the
// canonical limits of codes of 11-16 bits, as jpeg_entropy.cpp
// decode_symbol), its extra bits and the move.  Returns 0 or a status bit;
// `val` is the DC difference (k was 0) or the coefficient at `at` (at < 0:
// none, an EOB or a run of 16 zeros).
__device__ __forceinline__ int step(Bits& br, uint32_t nbits,
                                    const Dtab* tabs, const Units& un,
                                    int bpm, uint32_t& p, int& u, int& k,
                                    int& val, int& at) {
  if (p >= nbits) return kOutOfBits;
  const uint32_t w = br.peek(p);
  const Dtab& t = tabs[k == 0 ? un.dc[u] : un.ac[u]];
  int len = 0, sym = 0;
  const uint32_t e = t.look[w >> 22];
  if (e) {
    len = int(e >> 8);
    sym = int(e & 0xFF);
  } else {
    for (int l = 11; l <= 16; ++l) {
      const int c = int(w >> (32 - l));
      if (t.maxcode[l] >= 0 && c <= t.maxcode[l] && c >= t.mincode[l]) {
        len = l;
        sym = t.vals[(t.valptr[l] + (c - t.mincode[l])) & 0xFF];
        break;
      }
    }
    if (len == 0) return kBadCode;
  }
  const int s = k == 0 ? sym : (sym & 15);
  const uint32_t np = p + uint32_t(len + s);
  if (np > nbits) return kOutOfBits;
  val = s ? extend((w << len) >> (32 - s), s) : 0;
  p = np;
  at = -1;
  if (k == 0) {
    k = 1;
    return 0;
  }
  const int r = sym >> 4;
  if (s == 0) {
    if (r == 15) {
      k += 16;
      if (k > 64) return kPast63;
    } else {
      k = 64;   // EOB
    }
  } else {
    k += r;
    if (k > 63) return kPast63;
    at = k;
    ++k;
  }
  if (k >= 64) {
    k = 0;
    u = u + 1 == bpm ? 0 : u + 1;
  }
  return 0;
}

// The tables and the MCU's block places into shared memory.
__device__ void load_tables(const Params& P, Dtab* tabs, Units& un) {
  const int nslots = P.hdr->nslots;
  const uint4* g =
      reinterpret_cast<const uint4*>(P.scratch + P.L.dtab);
  uint4* s = reinterpret_cast<uint4*>(tabs);
  const int words = nslots * int(sizeof(Dtab) / 16);
  for (int i = threadIdx.x; i < words; i += blockDim.x) s[i] = g[i];
  if (threadIdx.x < kMaxBlocksPerMcu) {
    un.dc[threadIdx.x] = uint8_t(P.hdr->u_dc[threadIdx.x]);
    un.ac[threadIdx.x] = uint8_t(P.hdr->u_ac[threadIdx.x]);
    un.ci[threadIdx.x] = uint8_t(P.hdr->u_ci[threadIdx.x]);
  }
  __syncthreads();
}

// ---- set-up: the decoder's tables, the control words ------------------
__global__ void __launch_bounds__(256) setup_kernel(Params P) {
  Ctrl* c = ctrl_of(P);
  if (threadIdx.x == 0) {
    *P.status = 0;
    c->end = int32_t(P.n);
    c->nbytes = 0;
    c->status_before_write = 0;
  }
  for (int r = threadIdx.x; r < kRounds; r += blockDim.x)
    c->changed[r] = 0;
  __shared__ int32_t maxc[18], minc[17], vptr[17];
  Dtab* out = reinterpret_cast<Dtab*>(P.scratch + P.L.dtab);
  for (int slot = 0; slot < P.hdr->nslots; ++slot) {
    const uint8_t* bits = P.hdr->bits[slot];
    const uint8_t* vals = P.hdr->vals[slot];
    if (threadIdx.x == 0) {   // jpeg_entropy.cpp build_dec_table
      int code = 0, k = 0;
      for (int len = 1; len <= 16; ++len) {
        minc[len] = 0;
        vptr[len] = 0;
        if (bits[len - 1] > 0) {
          vptr[len] = k;
          minc[len] = code;
          k += bits[len - 1];
          code += bits[len - 1];
          maxc[len] = code - 1;
        } else {
          maxc[len] = -1;
        }
        code <<= 1;
      }
      maxc[0] = -1;
      minc[0] = 0;
      vptr[0] = 0;
      maxc[17] = 0x7FFFFFFF;
    }
    __syncthreads();
    Dtab& t = out[slot];
    for (int i = threadIdx.x; i < 18; i += blockDim.x) t.maxcode[i] = maxc[i];
    for (int i = threadIdx.x; i < 17; i += blockDim.x) {
      t.mincode[i] = minc[i];
      t.valptr[i] = vptr[i];
    }
    for (int i = threadIdx.x; i < 256; i += blockDim.x) t.vals[i] = vals[i];
    // the code (if any) of 10 bits or fewer that prefixes each entry
    for (int e = threadIdx.x; e < 1024; e += blockDim.x) {
      uint16_t v = 0;
      for (int len = 1; len <= 10; ++len) {
        const int cd = e >> (10 - len);
        if (maxc[len] >= 0 && cd <= maxc[len] && cd >= minc[len]) {
          v = uint16_t((len << 8) | vals[(vptr[len] + cd - minc[len]) & 0xFF]);
          break;
        }
      }
      t.look[e] = v;
    }
    __syncthreads();
  }
}

// ---- unstuff ------------------------------------------------------------
__device__ __forceinline__ void load16(const uint8_t* src, int64_t n,
                                       int64_t at, uint8_t b[16]) {
  if (at + 16 <= n && (reinterpret_cast<uintptr_t>(src + at) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + at);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = uint8_t(w[i >> 2] >> (8 * (i & 3)));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i] = at + i < n ? src[at + i] : 0;
  }
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  for (int i = 0; i < int(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

__global__ void __launch_bounds__(kTileThreads) unstuff_count_kernel(
    Params P) {
  __shared__ int red[kTileThreads / 32];
  const int64_t at =
      int64_t(blockIdx.x) * kTileBytes + int64_t(threadIdx.x) * 16;
  uint8_t b[16];
  load16(P.src, P.n, at, b);
  uint8_t prev = at > 0 && at - 1 < P.n ? P.src[at - 1] : 0;
  const uint8_t next = at + 16 < P.n ? P.src[at + 16] : 0;
  int drops = 0;
  int64_t marker = P.n;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int64_t idx = at + i;
    if (idx < P.n) {
      if (idx > 0 && prev == 0xFF && b[i] == 0) ++drops;
      const bool last = idx + 1 >= P.n;
      const uint8_t nb = i < 15 ? b[i + 1] : next;
      if (b[i] == 0xFF && (last || nb != 0) && marker == P.n) marker = idx;
    }
    prev = b[i];
  }
  if (marker < P.n) atomicMin(&ctrl_of(P)->end, int32_t(marker));
  const int total = block_sum(drops, red);
  if (threadIdx.x == 0)
    reinterpret_cast<int32_t*>(P.scratch + P.L.drops)[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kTileThreads) unstuff_write_kernel(
    Params P) {
  __shared__ int red[kTileThreads / 32];
  __shared__ int scan[kTileThreads / 32];
  Ctrl* c = ctrl_of(P);
  const int64_t end = c->end;
  const int64_t last = end == 0 ? 0 : (end - 1) / kTileBytes;
  if (int64_t(blockIdx.x) > last) return;
  const int32_t* drops = reinterpret_cast<const int32_t*>(P.scratch + P.L.drops);
  int before = 0;
  for (int i = threadIdx.x; i < int(blockIdx.x); i += blockDim.x)
    before += drops[i];
  before = block_sum(before, red);
  const int64_t tile0 = int64_t(blockIdx.x) * kTileBytes;
  const int64_t at = tile0 + int64_t(threadIdx.x) * 16;
  uint8_t b[16];
  load16(P.src, P.n, at, b);
  uint8_t prev = at > 0 && at - 1 < P.n ? P.src[at - 1] : 0;
  uint32_t keep = 0;
  int kept = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int64_t idx = at + i;
    if (idx < end && !(idx > 0 && prev == 0xFF && b[i] == 0)) {
      keep |= 1u << i;
      ++kept;
    }
    prev = b[i];
  }
  // exclusive prefix of `kept` over the CTA
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = kept;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int wbase = 0, tile_kept = 0;
  for (int i = 0; i < kTileThreads / 32; ++i) {
    if (i < warp) wbase += scan[i];
    tile_kept += scan[i];
  }
  uint8_t* out = P.scratch + P.L.bytes;
  int64_t o = tile0 - before + wbase + incl - kept;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (keep >> i & 1) out[o++] = b[i];
  if (int64_t(blockIdx.x) == last) {
    const int64_t nbytes = tile0 - before + tile_kept;
    if (threadIdx.x == 0) c->nbytes = int32_t(nbytes);
    if (threadIdx.x < 16) out[nbytes + threadIdx.x] = 0;
  }
}

// ---- sync -----------------------------------------------------------------
// Decode from `start` to the first symbol at or past `end`: the exit state,
// the blocks whose DC was decoded and their DC sums per component.  A
// symbol that fails stops the subsequence (err 1) and hands on the default
// start of the next one.
__device__ void run_lane(const Params& P, const Dtab* tabs, const Units& un,
                         uint32_t nbits, uint64_t start, uint32_t end,
                         uint64_t& exit, int& cnt, uint32_t dcs[4],
                         int& err) {
  uint32_t p = uint32_t(start >> 16);
  int u = int(start >> 8) & 0xFF, k = int(start & 0xFF);
  const int bpm = P.hdr->bpm;
  cnt = 0;
  err = 0;
  dcs[0] = dcs[1] = dcs[2] = dcs[3] = 0;
  Bits br{reinterpret_cast<const uint32_t*>(P.scratch + P.L.bytes), 0, 0};
  if (p < nbits) br.seek(p);
  while (p < end) {
    const int dc = k == 0, ci = un.ci[u];
    int val, at;
    if (step(br, nbits, tabs, un, bpm, p, u, k, val, at)) {
      err = 1;
      exit = pack_state(end, 0, 0);
      return;
    }
    if (dc) {
      ++cnt;
      dcs[ci] += uint32_t(val);
    }
  }
  exit = pack_state(p, u, k);
}

__global__ void __launch_bounds__(kLanes) sync_kernel(Params P, int round) {
  __shared__ Dtab tabs[kMaxSlots];
  __shared__ Units un;
  __shared__ uint64_t sh_exit[kLanes];
  __shared__ int redo;
  Ctrl* c = ctrl_of(P);
  if (round > 0 && c->changed[round - 1] == 0) return;   // converged
  const int t = threadIdx.x;
  const int64_t j = int64_t(blockIdx.x) * kLanes + t;
  const bool active = j < P.lanes;
  uint64_t* st = reinterpret_cast<uint64_t*>(P.scratch + P.L.st);
  uint64_t* ex = reinterpret_cast<uint64_t*>(P.scratch + P.L.ex);
  int32_t* cnt_g = reinterpret_cast<int32_t*>(P.scratch + P.L.cnt);
  int32_t* err_g = reinterpret_cast<int32_t*>(P.scratch + P.L.err);
  uint32_t* dcs_g = reinterpret_cast<uint32_t*>(P.scratch + P.L.dcs);
  uint64_t* bexit = reinterpret_cast<uint64_t*>(P.scratch + P.L.bexit);
  const int64_t last = int64_t(blockIdx.x) * kLanes + kLanes - 1;
  uint64_t incoming = 0;
  if (round > 0) {
    if (t == 0) {
      incoming = blockIdx.x == 0
                     ? 0
                     : bexit[((round - 1) & 1) * P.L.ctas + blockIdx.x - 1];
      redo = incoming != st[j];
    }
    __syncthreads();
    if (!redo) {   // unchanged: hand the same exit to the next round
      if (t == kLanes - 1 && active)
        bexit[(round & 1) * P.L.ctas + blockIdx.x] = ex[last];
      return;
    }
  }
  load_tables(P, tabs, un);
  const uint32_t nbits = uint32_t(c->nbytes) * 8u;
  const uint32_t S = uint32_t(P.sub_bits);
  const uint32_t end = uint32_t(j + 1) * S;
  uint64_t start = 0, exit = 0;
  int cnt = 0, err = 0;
  uint32_t dcs[4] = {0, 0, 0, 0};
  if (active) {
    if (round == 0) {
      start = pack_state(uint32_t(j) * S, 0, 0);
      run_lane(P, tabs, un, nbits, start, end, exit, cnt, dcs, err);
    } else {
      start = st[j];
      exit = ex[j];
      cnt = cnt_g[j];
      err = err_g[j];
      for (int i = 0; i < 4; ++i) dcs[i] = dcs_g[j * 4 + i];
      if (t == 0) {
        start = incoming;
        run_lane(P, tabs, un, nbits, start, end, exit, cnt, dcs, err);
        c->changed[round] = 1;
      }
    }
  }
  for (;;) {
    sh_exit[t] = exit;
    __syncthreads();
    bool moved = false;
    if (t > 0 && active && sh_exit[t - 1] != start) {
      start = sh_exit[t - 1];
      run_lane(P, tabs, un, nbits, start, end, exit, cnt, dcs, err);
      moved = true;
    }
    if (!__syncthreads_or(moved)) break;
  }
  if (active) {
    st[j] = start;
    ex[j] = exit;
    cnt_g[j] = cnt;
    err_g[j] = err;
    for (int i = 0; i < 4; ++i) dcs_g[j * 4 + i] = dcs[i];
  }
  if (t == kLanes - 1 && active)
    bexit[(round & 1) * P.L.ctas + blockIdx.x] = exit;
  if (round == 0 && blockIdx.x == 0 && t == 0) c->changed[0] = 1;
}

// ---- scan -----------------------------------------------------------------
__global__ void __launch_bounds__(kScanThreads) scan_kernel(Params P) {
  __shared__ int32_t sc[kScanThreads];
  __shared__ uint32_t sd[4][kScanThreads];
  const int t = threadIdx.x;
  const int32_t* cnt = reinterpret_cast<const int32_t*>(P.scratch + P.L.cnt);
  const int32_t* err = reinterpret_cast<const int32_t*>(P.scratch + P.L.err);
  int32_t* first = reinterpret_cast<int32_t*>(P.scratch + P.L.first);
  uint32_t* dcs = reinterpret_cast<uint32_t*>(P.scratch + P.L.dcs);
  const int64_t chunk = (P.lanes + kScanThreads - 1) / kScanThreads;
  const int64_t lo = t * chunk;
  const int64_t hi = lo + chunk < P.lanes ? lo + chunk : P.lanes;
  int32_t c = 0;
  uint32_t d[4] = {0, 0, 0, 0};
  for (int64_t j = lo; j < hi; ++j) {
    c += cnt[j];
    for (int i = 0; i < 4; ++i) d[i] += dcs[j * 4 + i];
  }
  sc[t] = c;
  for (int i = 0; i < 4; ++i) sd[i][t] = d[i];
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {   // inclusive, Hillis-Steele
    int32_t vc = 0;
    uint32_t vd[4] = {0, 0, 0, 0};
    if (t >= o) {
      vc = sc[t - o];
      for (int i = 0; i < 4; ++i) vd[i] = sd[i][t - o];
    }
    __syncthreads();
    sc[t] += vc;
    for (int i = 0; i < 4; ++i) sd[i][t] += vd[i];
    __syncthreads();
  }
  int32_t run = sc[t] - c;
  uint32_t rd[4];
  for (int i = 0; i < 4; ++i) rd[i] = sd[i][t] - d[i];
  bool stopped = false;
  for (int64_t j = lo; j < hi; ++j) {
    first[j] = run;
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = dcs[j * 4 + i];
      dcs[j * 4 + i] = rd[i];
      rd[i] += v;
    }
    if (err[j] && run + cnt[j] < P.expected) stopped = true;
    run += cnt[j];
  }
  if (stopped) atomicOr(P.status, kStopped);
  __syncthreads();
  if (t == kScanThreads - 1) {
    Ctrl* cc = ctrl_of(P);
    int bits = 0;
    if (sc[t] != P.expected) bits |= kBlockCount;
    if (cc->changed[kRounds - 1]) bits |= kNotSynced;
    if (bits) atomicOr(P.status, bits);
  }
}

// ---- write ----------------------------------------------------------------
constexpr int kBufPitch = 72;   // int16 a thread's block: 144 bytes, so a
                                // quarter warp's 16-byte reads hit 8 banks

__global__ void __launch_bounds__(kLanes) write_kernel(Params P) {
  __shared__ Dtab tabs[kMaxSlots];
  __shared__ Units un;
  __shared__ __align__(16) int16_t buf[kLanes * kBufPitch];
  Ctrl* c = ctrl_of(P);
  if (c->status_before_write) return;
  load_tables(P, tabs, un);
  const int t = threadIdx.x;
  const int64_t j = int64_t(blockIdx.x) * kLanes + t;
  if (j >= P.lanes) return;
  const int32_t n = reinterpret_cast<const int32_t*>(P.scratch + P.L.cnt)[j];
  if (n == 0) return;
  const uint64_t start =
      reinterpret_cast<const uint64_t*>(P.scratch + P.L.st)[j];
  const int64_t first =
      reinterpret_cast<const int32_t*>(P.scratch + P.L.first)[j];
  uint32_t pred[4];
  for (int i = 0; i < 4; ++i)
    pred[i] = reinterpret_cast<const uint32_t*>(P.scratch + P.L.dcs)[j * 4 + i];
  const Header& h = *P.hdr;
  const int bpm = h.bpm;
  const uint32_t nbits = uint32_t(c->nbytes) * 8u;
  uint32_t p = uint32_t(start >> 16);
  int u = int(start >> 8) & 0xFF, k = int(start & 0xFF);
  Bits br{reinterpret_cast<const uint32_t*>(P.scratch + P.L.bytes), 0, 0};
  if (p < nbits) br.seek(p);
  int val, at, e = 0;
  while (k != 0 && !e)   // the tail of the block started to the left
    e = step(br, nbits, tabs, un, bpm, p, u, k, val, at);
  int16_t* my = buf + t * kBufPitch;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int b = 0; b < n && !e; ++b) {
    const int64_t gb = first + b;
    if (gb >= P.expected) break;
    const int64_t m = gb / bpm;
    const int ub = int(gb - m * bpm);
    if (ub != u) {
      e = kPhase;
      break;
    }
    for (int i = 0; i < 8; ++i) reinterpret_cast<uint4*>(my)[i] = zero;
    const int ci = un.ci[u];
    e = step(br, nbits, tabs, un, bpm, p, u, k, val, at);   // the DC
    if (e) break;
    pred[ci] += uint32_t(val);
    my[0] = int16_t(pred[ci] & 0xFFFF);
    while (k != 0) {
      e = step(br, nbits, tabs, un, bpm, p, u, k, val, at);
      if (e) break;
      if (at >= 0) my[at] = int16_t(val);
    }
    if (e) break;
    const int64_t my_ = m / h.mcus_w, mx = m - my_ * h.mcus_w;
    const int64_t row = my_ * h.comp_v[ci] + h.u_by[ub];
    const int64_t col = mx * h.comp_h[ci] + h.u_bx[ub];
    uint4* dst = reinterpret_cast<uint4*>(
        P.planes[ci] + (row * h.comp_bw[ci] + col) * 64);
    for (int i = 0; i < 8; ++i) dst[i] = reinterpret_cast<const uint4*>(my)[i];
  }
  if (e) atomicOr(P.status, e);
}

// status after the scan, read by the write pass: a stream already refused
// is not written (the caller discards it), and every thread of the write
// pass sees the same word
__global__ void freeze_status_kernel(Params P) {
  ctrl_of(P)->status_before_write = *P.status;
}

}  // namespace

extern "C" int64_t uhdr_huffman_scratch_bytes(int64_t scan_bytes,
                                              int sub_bits) {
  if (scan_bytes < 0 || sub_bits < 32) return -1;
  return layout_of(scan_bytes, sub_bits).total;
}

// staged: the header (kHeaderBytes) then the scan's `scan_bytes` bytes, on
// the card; planes: one int16 pointer a component (16-byte aligned);
// status: one int32 on the card; scratch: uhdr_huffman_scratch_bytes bytes.
extern "C" int uhdr_huffman_decode(const void* staged, int64_t scan_bytes,
                                   int expected, void* plane0, void* plane1,
                                   void* plane2, void* plane3, void* scratch,
                                   void* status, int sub_bits,
                                   void* cuda_stream) {
  if (scan_bytes < 0 || scan_bytes * 8 + sub_bits >= (int64_t{1} << 32) ||
      sub_bits < 32 || expected < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  Params P{};
  P.hdr = static_cast<const Header*>(staged);
  P.src = static_cast<const uint8_t*>(staged) + kHeaderBytes;
  P.n = scan_bytes;
  P.sub_bits = sub_bits;
  P.L = layout_of(scan_bytes, sub_bits);
  P.lanes = P.L.lanes;
  P.expected = expected;
  P.scratch = static_cast<uint8_t*>(scratch);
  P.status = static_cast<int32_t*>(status);
  P.planes[0] = static_cast<int16_t*>(plane0);
  P.planes[1] = static_cast<int16_t*>(plane1);
  P.planes[2] = static_cast<int16_t*>(plane2);
  P.planes[3] = static_cast<int16_t*>(plane3);
  setup_kernel<<<1, 256, 0, s>>>(P);
  unstuff_count_kernel<<<unsigned(P.L.tiles), kTileThreads, 0, s>>>(P);
  unstuff_write_kernel<<<unsigned(P.L.tiles), kTileThreads, 0, s>>>(P);
  for (int r = 0; r < kRounds; ++r)
    sync_kernel<<<unsigned(P.L.ctas), kLanes, 0, s>>>(P, r);
  scan_kernel<<<1, kScanThreads, 0, s>>>(P);
  freeze_status_kernel<<<1, 1, 0, s>>>(P);
  write_kernel<<<unsigned(P.L.ctas), kLanes, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
