// The map axis's all-reduce over peer memory (parallel/peer.py): JAX's
// lax.psum and lax.pmin over the map axis (kinematic_icp_tpu/parallel/
// sharded.py), written as one plain kernel so that a captured frame can
// hold it inside a conditional body (the GN loop's later trips and its
// re-associations, utils/cuda_graph.py:when).  NCCL's collectives cannot
// live there: on four H100s (NCCL 2.28.9) such a capture failed at
// instantiation under NCCL's default graph-mixing support, whose event
// nodes a conditional body refuses (PERF.md, section 6).
//
// Each rank of a map group owns one region of device memory, allocated
// here and mapped into every other rank's process once, when the mesh is
// made (cudaIpcGetMemHandle / cudaIpcOpenMemHandle):
//
//   [0, 8)            the rank's epoch: reductions this rank has run
//   [64, 64 + 8 * 32) flags: flags[j] is the last epoch rank j reached
//   [512, ...)        two slots of slot_bytes, used by alternate epochs
//
// A reduction of n elements, epoch e = the rank's epoch + 1 (every rank of
// the group runs the same reductions in the same order, so e is the same
// on all of them):
//   1. the CTA copies the rank's data into its own slot e % 2;
//   2. thread j < m publishes (release, system scope) e into rank j's
//      flags[rank], then waits (acquire, system scope) until its own
//      flags[j] >= e: every rank's slot e % 2 is written;
//   3. every rank reads the m slots in rank order and combines them, so
//      every rank gets the same bits, and writes them over its data.
// A rank overwrites slot e % 2 again only at epoch e + 2, after every
// rank has published e + 1, which each does only after its reads of epoch
// e (stream order): two slots need one barrier a reduction.
//
// A launch reduces at most a slot; the wrapper (PeerGroup.all_reduce)
// runs a larger reduction as a launch a slot, in order, each with its own
// epoch and barrier.
//
// One CTA: a reduction is 6 floats a sequence (the normal equations) or an
// int32 a query (the packed nearest-neighbour keys), a few KB over NVLink;
// its time is the launch and the barrier's round trip, not bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRanks = 32;
constexpr size_t kFlagsOffset = 64;
constexpr size_t kSlotsOffset = 512;
constexpr int kThreads = 1024;
// a barrier that waits longer than this (~17 s at the H100's 1.98 GHz)
// traps: a rank that never arrives is a fault, reported, not a hang
constexpr long long kSpinCycles = 1LL << 35;

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

struct Sum {
  template <typename T>
  __device__ static T apply(T a, T b) { return a + b; }
};

struct Min {
  template <typename T>
  __device__ static T apply(T a, T b) { return b < a ? b : a; }
};

// rank's part in the slot at byte offset `slot` of its region at `base`
template <typename T>
__device__ __forceinline__ const T* part(uint64_t base, size_t slot) {
  return reinterpret_cast<const T*>(
      reinterpret_cast<const char*>(static_cast<uintptr_t>(base)) + slot);
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
    peer_all_reduce(T* data, int n, const uint64_t* peers, int m, int rank,
                    size_t slot_bytes) {
  __shared__ uint64_t epoch_s;
  char* own = reinterpret_cast<char*>(static_cast<uintptr_t>(peers[rank]));
  uint64_t* epoch = reinterpret_cast<uint64_t*>(own);
  if (threadIdx.x == 0) epoch_s = *epoch + 1;
  __syncthreads();
  const uint64_t e = epoch_s;
  const size_t slot = kSlotsOffset + (e & 1) * slot_bytes;

  T* mine = reinterpret_cast<T*>(own + slot);
  for (int i = threadIdx.x; i < n; i += kThreads) mine[i] = data[i];
  __syncthreads();
  if (threadIdx.x < m) {
    char* peer =
        reinterpret_cast<char*>(static_cast<uintptr_t>(peers[threadIdx.x]));
    __threadfence_system();
    store_release(
        reinterpret_cast<uint64_t*>(peer + kFlagsOffset) + rank, e);
    const uint64_t* arrived =
        reinterpret_cast<const uint64_t*>(own + kFlagsOffset) + threadIdx.x;
    const long long t0 = clock64();
    while (load_acquire(arrived) < e) {
      if (clock64() - t0 > kSpinCycles) __trap();
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += kThreads) {
    T acc = __ldcv(part<T>(peers[0], slot) + i);
    for (int j = 1; j < m; ++j)
      acc = Op::apply(acc, __ldcv(part<T>(peers[j], slot) + i));
    data[i] = acc;
  }
  if (threadIdx.x == 0) *epoch = e;
}

template <typename T, typename Op>
int launch(cudaStream_t stream, void* data, int n, const uint64_t* peers,
           int m, int rank, size_t slot_bytes) {
  peer_all_reduce<T, Op><<<1, kThreads, 0, stream>>>(
      static_cast<T*>(data), n, peers, m, rank, slot_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// The region's bytes for two slots of slot_bytes.
extern "C" size_t kicp_peer_region_bytes(size_t slot_bytes) {
  return kSlotsOffset + 2 * slot_bytes;
}

// A zeroed region of `bytes` on the current device, and its IPC handle
// (cudaIpcMemHandle_t, 64 bytes) in handle_out.
extern "C" int kicp_peer_alloc(size_t bytes, void** ptr, void* handle_out) {
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcGetMemHandle(
      static_cast<cudaIpcMemHandle_t*>(handle_out), *ptr);
}

// Another process's region, mapped into this one (peer access enabled).
extern "C" int kicp_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h = *static_cast<const cudaIpcMemHandle_t*>(handle);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int kicp_peer_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int kicp_peer_free(void* ptr) { return (int)cudaFree(ptr); }

// `data` (n elements) reduced over the m ranks whose regions' base
// pointers are the device array `peers` (this rank's at `rank`), in
// place, on `stream`.  kind: 0 float32 sum, 1 float64 sum, 2 int32 sum,
// 3 int32 min.  Returns the launch's error code.
extern "C" int kicp_peer_all_reduce(void* stream, void* data, int n,
                                    int kind, const uint64_t* peers, int m,
                                    int rank, size_t slot_bytes) {
  if (m < 1 || m > kMaxRanks || rank < 0 || rank >= m || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      if (n * sizeof(float) > slot_bytes) break;
      return launch<float, Sum>(st, data, n, peers, m, rank, slot_bytes);
    case 1:
      if (n * sizeof(double) > slot_bytes) break;
      return launch<double, Sum>(st, data, n, peers, m, rank, slot_bytes);
    case 2:
      if (n * sizeof(int) > slot_bytes) break;
      return launch<int, Sum>(st, data, n, peers, m, rank, slot_bytes);
    case 3:
      if (n * sizeof(int) > slot_bytes) break;
      return launch<int, Min>(st, data, n, peers, m, rank, slot_bytes);
  }
  return (int)cudaErrorInvalidValue;
}
