// Guard-page device allocator for PyTorch's CUDAPluggableAllocator.
//
// tools/sanitize_kernels.py --guard installs it before the first CUDA
// allocation, so that every tensor of the run (inputs, outputs, the
// wrappers' scratch and tables) gets device memory of its own, mapped
// through CUDA's virtual memory management (cuMemCreate, cuMemMap):
//
//   UHDR_GUARD_SIDE=right  the buffer ends where its mapping ends (its size
//                          rounded up to 16 bytes); the next granule of
//                          address space is reserved and never mapped, so
//                          a read or write past the end faults;
//   UHDR_GUARD_SIDE=left   the buffer starts where its mapping starts, after
//                          an unmapped granule: an access before the start
//                          faults.
//
// UHDR_GUARD_FILL (a byte, default 0xA5) fills every new mapping, so that a
// kernel that reads memory no one wrote gives results that change with the
// fill.  A freed buffer is unmapped at once (after the context has
// synchronised): a use after free faults too.  The caching allocator is
// gone for the run, so every allocation costs a map and every free a
// synchronisation: a tool for checks, never for the paths users run.
//
// libcuda is opened with dlopen; only the CUDA headers are needed to build.

#include <cuda.h>
#include <dlfcn.h>
#include <sys/types.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <unordered_map>

namespace {

struct Api {
  CUresult (*DeviceGet)(CUdevice*, int);
  CUresult (*MemGetAllocationGranularity)(size_t*, const CUmemAllocationProp*,
                                          CUmemAllocationGranularity_flags);
  CUresult (*MemAddressReserve)(CUdeviceptr*, size_t, size_t, CUdeviceptr,
                                unsigned long long);
  CUresult (*MemAddressFree)(CUdeviceptr, size_t);
  CUresult (*MemCreate)(CUmemGenericAllocationHandle*, size_t,
                        const CUmemAllocationProp*, unsigned long long);
  CUresult (*MemRelease)(CUmemGenericAllocationHandle);
  CUresult (*MemMap)(CUdeviceptr, size_t, size_t,
                     CUmemGenericAllocationHandle, unsigned long long);
  CUresult (*MemUnmap)(CUdeviceptr, size_t);
  CUresult (*MemSetAccess)(CUdeviceptr, size_t, const CUmemAccessDesc*,
                           size_t);
  CUresult (*MemsetD8Async)(CUdeviceptr, unsigned char, size_t, CUstream);
  CUresult (*CtxSynchronize)();
  bool ok = false;
};

template <typename F>
bool bind(void* lib, const char* name, F* fn) {
  *fn = reinterpret_cast<F>(dlsym(lib, name));
  if (!*fn) std::fprintf(stderr, "guard_alloc: no %s in libcuda\n", name);
  return *fn != nullptr;
}

Api load() {
  Api a{};
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!lib) {
    std::fprintf(stderr, "guard_alloc: dlopen libcuda.so.1: %s\n", dlerror());
    return a;
  }
  a.ok = bind(lib, "cuDeviceGet", &a.DeviceGet) &&
         bind(lib, "cuMemGetAllocationGranularity",
              &a.MemGetAllocationGranularity) &&
         bind(lib, "cuMemAddressReserve", &a.MemAddressReserve) &&
         bind(lib, "cuMemAddressFree", &a.MemAddressFree) &&
         bind(lib, "cuMemCreate", &a.MemCreate) &&
         bind(lib, "cuMemRelease", &a.MemRelease) &&
         bind(lib, "cuMemMap", &a.MemMap) &&
         bind(lib, "cuMemUnmap", &a.MemUnmap) &&
         bind(lib, "cuMemSetAccess", &a.MemSetAccess) &&
         bind(lib, "cuMemsetD8Async", &a.MemsetD8Async) &&
         bind(lib, "cuCtxSynchronize", &a.CtxSynchronize);
  return a;
}

const Api& api() {
  static Api a = load();
  return a;
}

struct Block {
  CUdeviceptr base;      // the reservation
  size_t reserved;       // its size
  CUdeviceptr mapped_at; // the mapping
  size_t mapped;         // its size
  CUmemGenericAllocationHandle handle;
};

std::mutex mu;
std::unordered_map<uintptr_t, Block> blocks;
long long n_allocs = 0, n_frees = 0, failures = 0;

bool check(CUresult rc, const char* what) {
  if (rc == CUDA_SUCCESS) return true;
  std::fprintf(stderr, "guard_alloc: %s failed: CUresult %d\n", what, (int)rc);
  failures++;
  return false;
}

size_t round_up(size_t x, size_t to) { return (x + to - 1) / to * to; }

}  // namespace

extern "C" void* uhdr_guard_alloc(ssize_t size, int device, CUstream stream) {
  const Api& a = api();
  if (!a.ok) return nullptr;
  const char* side = std::getenv("UHDR_GUARD_SIDE");
  const bool left = side && std::strcmp(side, "left") == 0;
  const char* fill_s = std::getenv("UHDR_GUARD_FILL");
  const unsigned char fill =
      (unsigned char)(fill_s ? std::strtol(fill_s, nullptr, 0) : 0xA5);

  std::lock_guard<std::mutex> lock(mu);
  CUdevice dev;
  if (!check(a.DeviceGet(&dev, device), "cuDeviceGet")) return nullptr;
  CUmemAllocationProp prop;
  std::memset(&prop, 0, sizeof prop);
  prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  prop.location.id = dev;
  size_t gran = 0;
  if (!check(a.MemGetAllocationGranularity(&gran, &prop,
                                           CU_MEM_ALLOC_GRANULARITY_MINIMUM),
             "cuMemGetAllocationGranularity"))
    return nullptr;
  const size_t bytes = round_up(size > 0 ? (size_t)size : 1, 16);
  Block b{};
  b.mapped = round_up(bytes, gran);
  b.reserved = b.mapped + gran;
  if (!check(a.MemAddressReserve(&b.base, b.reserved, gran, 0, 0),
             "cuMemAddressReserve"))
    return nullptr;
  b.mapped_at = left ? b.base + gran : b.base;
  if (!check(a.MemCreate(&b.handle, b.mapped, &prop, 0), "cuMemCreate")) {
    a.MemAddressFree(b.base, b.reserved);
    return nullptr;
  }
  CUmemAccessDesc acc;
  std::memset(&acc, 0, sizeof acc);
  acc.location = prop.location;
  acc.flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
  if (!check(a.MemMap(b.mapped_at, b.mapped, 0, b.handle, 0), "cuMemMap") ||
      !check(a.MemSetAccess(b.mapped_at, b.mapped, &acc, 1),
             "cuMemSetAccess") ||
      !check(a.MemsetD8Async(b.mapped_at, fill, b.mapped, stream),
             "cuMemsetD8Async")) {
    a.MemUnmap(b.mapped_at, b.mapped);
    a.MemRelease(b.handle);
    a.MemAddressFree(b.base, b.reserved);
    return nullptr;
  }
  const CUdeviceptr ptr = left ? b.mapped_at : b.mapped_at + b.mapped - bytes;
  blocks[(uintptr_t)ptr] = b;
  n_allocs++;
  return (void*)ptr;
}

extern "C" void uhdr_guard_free(void* ptr, ssize_t size, int device,
                                CUstream stream) {
  (void)size, (void)device, (void)stream;
  const Api& a = api();
  std::lock_guard<std::mutex> lock(mu);
  auto it = blocks.find((uintptr_t)ptr);
  if (it == blocks.end()) {
    std::fprintf(stderr, "guard_alloc: free of an unknown pointer %p\n", ptr);
    failures++;
    return;
  }
  Block b = it->second;
  blocks.erase(it);
  // kernels in flight may still use the buffer: unmap only after them
  check(a.CtxSynchronize(), "cuCtxSynchronize");
  check(a.MemUnmap(b.mapped_at, b.mapped), "cuMemUnmap");
  check(a.MemRelease(b.handle), "cuMemRelease");
  check(a.MemAddressFree(b.base, b.reserved), "cuMemAddressFree");
  n_frees++;
}

// 0: allocations, 1: frees, 2: CUDA calls that failed
extern "C" long long uhdr_guard_stat(int which) {
  std::lock_guard<std::mutex> lock(mu);
  switch (which) {
    case 0: return n_allocs;
    case 1: return n_frees;
    default: return failures;
  }
}
