// The K-batch stitch of the pipelined encode on Hopper (sm_90a),
// hand-written in CUDA C++, bound by ops/stitch_kernel.py.
//
// It replaces no Pallas kernel: the JAX package stitches with XLA ops
// (libultrahdr_tpu/fused.py:2608, _stitch_image_streams, one
// dynamic_update_slice an image).  A K-batch of the pipelined encode packs
// each of its k images into a row of one room (the pack kernel's output:
// row i holds image i's words, its live prefix the pack's own word count);
// the stitch lays those live prefixes back to back in one buffer, so that
// the host downloads the whole batch with one copy.  The counts are on the
// card (each image's pack scratch), so the offsets are formed here: slicing
// at them with PyTorch ops would read every count back to the host first.
// The block lengths need no stitch: each pack writes its image's lengths
// into a row of one (k, n) tensor, already back to back.
//
// uhdr_stitch(src, pitch, counts, count_stride, k, out):
//   row i of src starts at src + i * pitch and holds c_i = clamp(counts[i *
//   count_stride], 0, pitch) live words; out[P_i + j] = src[i * pitch + j]
//   for j < c_i, where P_i = c_0 + ... + c_{i-1}.  Words of out at and past
//   P_k are not written.
//
// Design: a persistent grid (8 CTAs an SM) of 256 threads.
// - Each CTA loads the k counts into shared memory and forms their
//   exclusive prefix (k is at most kMaxImages; a serial pass of thread 0,
//   k adds, is nothing beside the copy).
// - The output is cut into 16-byte groups of four words; a thread takes one
//   group at a time, grid-stride.  It finds the image of the group's first
//   word by a binary search over the prefix, loads the four words (4-byte
//   loads: a row's live prefix starts at any word of out, so source and
//   destination are aligned differently; neighbouring threads read
//   neighbouring words, so a warp's loads are whole sectors), moving to
//   the next image where a word crosses into it (an image of 0 live words
//   is stepped over), and writes the group with one 16-byte store; the last
//   group, when P_k is no multiple of four, word by word.
// The work is the live words read once and written once: 2.5-10 MB an image
// at 4K, bound by device memory on the H100.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kMaxImages = 1024;

__global__ void __launch_bounds__(kThreads)
    stitch_kernel(const uint32_t* __restrict__ src, int64_t pitch,
                  const long long* __restrict__ counts, int64_t count_stride,
                  int k, uint32_t* __restrict__ out) {
  __shared__ long long prefix[kMaxImages + 1];
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    long long c = counts[i * count_stride];
    prefix[i + 1] = c < 0 ? 0 : (c > pitch ? pitch : c);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    prefix[0] = 0;
    for (int i = 1; i <= k; ++i) prefix[i] += prefix[i - 1];
  }
  __syncthreads();
  const long long total = prefix[k];
  const long long groups = (total + 3) >> 2;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long d0 = g << 2;
    // the image of word d0: the last i with prefix[i] <= d0 (< k, as d0 <
    // total = prefix[k])
    int lo = 0, hi = k - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (prefix[mid] <= d0) lo = mid; else hi = mid - 1;
    }
    int img = lo;
    uint32_t v[4];
    const int n = total - d0 < 4 ? static_cast<int>(total - d0) : 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) {
        const long long d = d0 + j;
        while (d >= prefix[img + 1]) ++img;
        v[j] = src[img * pitch + (d - prefix[img])];
      }
    }
    if (n == 4) {
      *reinterpret_cast<uint4*>(out + d0) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < n; ++j) out[d0 + j] = v[j];
    }
  }
}

}  // namespace

// out must be 16-byte aligned; k in [0, kMaxImages].
extern "C" int uhdr_stitch(const int32_t* src, int64_t pitch,
                           const int64_t* counts, int64_t count_stride, int k,
                           int32_t* out, void* cuda_stream) {
  if (k <= 0) return 0;
  if (k > kMaxImages) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  stitch_kernel<<<sms * kCtasPerSm, kThreads, 0,
                  static_cast<cudaStream_t>(cuda_stream)>>>(
      reinterpret_cast<const uint32_t*>(src), pitch,
      reinterpret_cast<const long long*>(counts), count_stride, k,
      reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* uhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
