// The map axis's all-reduce over peer memory (parallel/peer.py): JAX's
// lax.pmin and lax.psum over the map axis (kinematic_icp_tpu/parallel/
// sharded.py:80, 121, 134, 155, 251), XLA's all-reduce there.  No Pallas
// kernel corresponds: the port needs its own because a captured frame
// holds these reductions inside conditional bodies (the GN loop's later
// trips and its re-associations, utils/cuda_graph.py:when), and NCCL's
// collectives cannot live there: on four H100s (NCCL 2.28.9) such a
// capture failed at instantiation under NCCL's default graph-mixing
// support, whose event nodes a conditional body refuses (PERF.md, section
// 6).  So the kernel is a plain launch: no cooperative launch, no
// grid-wide barrier.
//
// What bounds it.  A reduction of n bytes over m ranks must read each
// rank's part once and write each rank's result once.  On one card that
// all ranks share, that is 2 m n bytes of HBM at 3.35 TB/s.  Across
// cards each rank must receive at least 2 (m - 1) / m n bytes over NVLink
// (450 GB/s each way): 44 us for 13.1 MB at m = 4.  Below some tens of KB
// no byte count matters: the launch and one barrier's round trip are the
// time.
//
// Each rank of a map group owns one region of device memory, allocated
// here and mapped into every other rank's process once, when the mesh is
// made (cudaIpcGetMemHandle / cudaIpcOpenMemHandle):
//
//   [0, 8 kMaxCtas)        epochs[c]: the reductions CTA c of this rank
//                          has run
//   [kFlagsOffset, ...)    flags[c][j]: the last barrier value CTA c of
//                          rank j reached (kMaxCtas x kMaxRanks words)
//   [kSlotsOffset, ...)    two slots of slot_bytes, used by alternate
//                          epochs of each CTA
//
// The design (the one-CTA kernel before it reached ~45 GB/s, 1 % of its
// bound beyond a slot):
//
// 1. G CTAs of kThreads a rank, G fixed per group when the group is made
//    (peer.attach, peer.local_groups): the occupancy API's blocks per SM
//    times the SM count, divided by the ranks of the group that share a
//    card, so every CTA of every rank on one card is resident at once (a
//    CTA spins on a peer CTA, which must be running), and at most
//    kMaxCtas.  A launch of n elements runs min(G, tiles) CTAs.
// 2. A byte b of a reduction lies in tile t = b / kTileBytes, and tile t
//    belongs to CTA t % G on every rank for every n: CTA c of each rank
//    writes and reads only its own tiles of every slot, so CTA c
//    publishes to, and waits on, CTA c of the other ranks alone, with its
//    own flags and its own epoch.
// 3. 16-byte accesses, thread i of a tile on bytes [16 i, 16 i + 16): a
//    tile is one vector a thread.  The tail of a reduction (and a
//    tensor whose start is not 16-byte aligned) goes element by element.
//    Peers' slots are read with ld.global.cv (__ldcv), so no stale L1
//    line is used.
// 4. Two algorithms, both combining ranks 0..m-1 in rank order, so every
//    rank gets the bits of peer.reference:
//    one-shot (one barrier): every rank folds all m parts of its CTAs'
//      tiles;
//    two-shot (reduce-scatter, then all-gather; two barriers): tile t is
//      folded by rank (t % G + t / G) % m alone, which writes the result
//      over its own part in its slot and into its data; after the second
//      barrier every other rank copies it.  A rank then pulls about
//      2 (m - 1) / m n bytes instead of (m - 1) n.
//    The wrapper picks one per launch from (bytes, m) alone
//    (peer.algorithm), so every rank of the group picks alike.
// 5. A launch reduces at most a slot; the wrapper runs a larger reduction
//    as a launch a slot, in order (peer.chunks).
//
// A reduction of CTA c at its epoch e = epochs[c] + 1 (every rank runs the
// same reductions in the same order, and which CTAs run is a function of
// n alone, so e is the same on every rank):
//   1. CTA c copies the rank's part of its tiles into its slot e % 2;
//   2. barrier: thread j < m publishes (release, system scope) the
//      barrier's value into rank j's flags[c][rank], then waits (acquire,
//      system scope) until its own flags[c][j] reaches it;
//   3. one-shot: it reads tile by tile the m parts in rank order (its own
//      from its data) and writes the result over its data; two-shot: the
//      folds of the tiles it owns, a second barrier, the copies of the
//      others' results.
// Barrier values grow: one-shot publishes 2e, two-shot 2e - 1 then 2e.
// CTA c of a rank overwrites slot e % 2 again only at its epoch e + 2,
// after CTA c of every rank has published at its epoch e + 1, which each
// does only after its reads of epoch e (program order in the CTA): two
// slots need one barrier a reduction.  This holds because a tile's CTA
// does not depend on n: with ownership by n, CTA c' could overwrite a tile
// that CTA c of a slower rank has still to read.
//
// Hazards.  A CTA that waits on a CTA that cannot be scheduled never
// returns: the grid bound of 1., and a barrier that waits longer than
// kSpinCycles (~17 s at the H100's 1.98 GHz) traps, so a rank that never
// arrives is a fault, reported, not a hang.  Every rank must launch the
// same chunks with the same G and the same algorithm, in the same order,
// eager launches and graph replays alike (each launch reads and bumps the
// epochs on the device).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRanks = 32;
constexpr int kMaxCtas = 512;
constexpr int kThreads = 512;
constexpr int kVecBytes = 16;
constexpr long long kTileBytes = (long long)kThreads * kVecBytes;
constexpr size_t kFlagsOffset = 8 * kMaxCtas;
constexpr size_t kSlotsOffset =
    kFlagsOffset + 8 * (size_t)kMaxCtas * kMaxRanks;
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

// elements of T in one 16-byte access
template <typename T>
__host__ __device__ constexpr int width() {
  return kVecBytes / sizeof(T);
}

// kVecBytes of T, as one 16-byte access or element by element
template <typename T>
union Vec {
  uint4 raw;
  T v[width<T>()];
};

// The k elements at p (all width<T>() of them as one access where
// `whole`); `peer` reads another rank's memory, bypassing L1.
template <typename T>
__device__ __forceinline__ Vec<T> load(const T* p, int k, bool whole,
                                       bool peer) {
  Vec<T> r;
  if (whole) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    r.raw = peer ? __ldcv(q) : *q;
  } else {
#pragma unroll
    for (int i = 0; i < width<T>(); ++i)
      if (i < k) r.v[i] = peer ? __ldcv(p + i) : p[i];
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store(T* p, const Vec<T>& x, int k,
                                      bool whole) {
  if (whole) {
    *reinterpret_cast<uint4*>(p) = x.raw;
  } else {
#pragma unroll
    for (int i = 0; i < width<T>(); ++i)
      if (i < k) p[i] = x.v[i];
  }
}

template <typename T, typename Op>
__device__ __forceinline__ void fold(Vec<T>& acc, const Vec<T>& x, int k) {
#pragma unroll
  for (int i = 0; i < width<T>(); ++i)
    if (i < k) acc.v[i] = Op::apply(acc.v[i], x.v[i]);
}

// The m parts of elements [e, e + k) folded in rank order: the rank's own
// from `data`, the others' from their slots at byte offset `slot`.
template <typename T, typename Op>
__device__ __forceinline__ Vec<T> fold_ranks(const T* data, char* const* base,
                                             size_t slot, int m, int rank,
                                             int e, int k, bool whole) {
  auto part = [&](int j) {
    return j == rank
               ? load(data + e, k, whole, false)
               : load(reinterpret_cast<const T*>(base[j] + slot) + e, k,
                      whole, true);
  };
  Vec<T> acc = part(0);
  for (int j = 1; j < m; ++j) fold<T, Op>(acc, part(j), k);
  return acc;
}

__device__ __forceinline__ uint64_t* flag(char* region, int cta, int rank) {
  return reinterpret_cast<uint64_t*>(region + kFlagsOffset) +
         (size_t)cta * kMaxRanks + rank;
}

// CTA `cta` of every rank reaches barrier value v: this CTA's writes
// before it are visible to CTA `cta` of every rank after it, and theirs
// to this one.  The release store is the only fence: after
// __syncthreads the CTA's writes precede it (PTX's release is cumulative),
// and a fence.sc.sys before it cost ~1.5 us a barrier across four H100s.
__device__ __forceinline__ void barrier(char* const* base, int m, int rank,
                                        int cta, uint64_t v) {
  __syncthreads();
  if (threadIdx.x < m) {
    store_release(flag(base[threadIdx.x], cta, rank), v);
    const uint64_t* arrived = flag(base[rank], cta, threadIdx.x);
    const long long t0 = clock64();
    while (load_acquire(arrived) < v) {
      if (clock64() - t0 > kSpinCycles) __trap();
    }
  }
  __syncthreads();
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
    peer_all_reduce(T* data, int n, const uint64_t* peers, int m, int rank,
                    size_t slot_bytes, int grid, int two_shot) {
  constexpr int kWidth = width<T>();
  constexpr int kTileElems = (int)(kTileBytes / sizeof(T));
  __shared__ char* base[kMaxRanks];
  __shared__ uint64_t epoch_s;
  const int cta = blockIdx.x;
  if (threadIdx.x < m)
    base[threadIdx.x] =
        reinterpret_cast<char*>(static_cast<uintptr_t>(peers[threadIdx.x]));
  __syncthreads();
  char* own = base[rank];
  uint64_t* epoch = reinterpret_cast<uint64_t*>(own) + cta;
  if (threadIdx.x == 0) epoch_s = *epoch + 1;
  __syncthreads();
  const uint64_t e = epoch_s;
  const size_t slot = kSlotsOffset + (e & 1) * slot_bytes;
  T* mine = reinterpret_cast<T*>(own + slot);
  // 32-bit tile arithmetic (a launch is at most a slot: n < 2^31), which
  // ptxas keeps inline where 64-bit division is a call
  const int tiles = (n + kTileElems - 1) / kTileElems;
  const bool aligned =
      reinterpret_cast<uintptr_t>(data) % kVecBytes == 0;
  // this thread's elements [first, first + k) of tile t
  auto span = [&](int t, int& first) {
    first = t * kTileElems + (int)threadIdx.x * kWidth;
    const int left = n - first;
    return left <= 0 ? 0 : (left < kWidth ? left : kWidth);
  };

  for (int t = cta; t < tiles; t += grid) {
    int i;
    const int k = span(t, i);
    if (k) store(mine + i, load(data + i, k, aligned && k == kWidth, false),
                 k, k == kWidth);
  }

  if (!two_shot) {
    barrier(base, m, rank, cta, 2 * e);
    for (int t = cta; t < tiles; t += grid) {
      int i;
      const int k = span(t, i);
      const bool whole = aligned && k == kWidth;
      if (k)
        store(data + i,
              fold_ranks<T, Op>(data, base, slot, m, rank, i, k, whole), k,
              whole);
    }
  } else {
    barrier(base, m, rank, cta, 2 * e - 1);
    for (int t = cta; t < tiles; t += grid) {
      if ((t % grid + t / grid) % m != rank) continue;
      int i;
      const int k = span(t, i);
      const bool whole = aligned && k == kWidth;
      if (!k) continue;
      const Vec<T> r =
          fold_ranks<T, Op>(data, base, slot, m, rank, i, k, whole);
      store(mine + i, r, k, k == kWidth);
      store(data + i, r, k, whole);
    }
    barrier(base, m, rank, cta, 2 * e);
    for (int t = cta; t < tiles; t += grid) {
      const int owner = (t % grid + t / grid) % m;
      if (owner == rank) continue;
      int i;
      const int k = span(t, i);
      const bool whole = aligned && k == kWidth;
      if (k)
        store(data + i,
              load(reinterpret_cast<const T*>(base[owner] + slot) + i, k,
                   k == kWidth, true),
              k, whole);
    }
  }
  if (threadIdx.x == 0) *epoch = e;
}

template <typename T, typename Op>
int launch(cudaStream_t stream, void* data, int n, const uint64_t* peers,
           int m, int rank, size_t slot_bytes, int grid, int two_shot) {
  if ((size_t)n * sizeof(T) > slot_bytes) return (int)cudaErrorInvalidValue;
  const long long tiles =
      ((long long)n * (long long)sizeof(T) + kTileBytes - 1) / kTileBytes;
  if (tiles == 0) return (int)cudaSuccess;
  const int ctas = tiles < grid ? (int)tiles : grid;
  peer_all_reduce<T, Op><<<ctas, kThreads, 0, stream>>>(
      static_cast<T*>(data), n, peers, m, rank, slot_bytes, grid, two_shot);
  return (int)cudaGetLastError();
}

template <typename T, typename Op>
int blocks_per_sm(int* out) {
  int b = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, peer_all_reduce<T, Op>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (b < *out) *out = b;
  return (int)cudaSuccess;
}

}  // namespace

// The kernel's fixed geometry: threads a CTA, bytes a tile, most CTAs a
// rank (parallel/peer.py holds the same numbers and checks them).
extern "C" void kicp_peer_geometry(int* threads, long long* tile_bytes,
                                   int* max_ctas) {
  *threads = kThreads;
  *tile_bytes = kTileBytes;
  *max_ctas = kMaxCtas;
}

// The fewest CTAs of any instance an SM of the current device holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int kicp_peer_blocks_per_sm(int* out) {
  *out = 1 << 30;
  int rc;
  if ((rc = blocks_per_sm<float, Sum>(out))) return rc;
  if ((rc = blocks_per_sm<double, Sum>(out))) return rc;
  if ((rc = blocks_per_sm<int, Sum>(out))) return rc;
  return blocks_per_sm<int, Min>(out);
}

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

// `data` (n elements, at most a slot) reduced over the m ranks whose
// regions' base pointers are the device array `peers` (this rank's at
// `rank`), in place, on `stream`, by min(grid, tiles) CTAs of the group's
// grid `grid`, one-shot or two-shot.  kind: 0 float32 sum, 1 float64 sum,
// 2 int32 sum, 3 int32 min.  Returns the launch's error code.
extern "C" int kicp_peer_all_reduce(void* stream, void* data, int n,
                                    int kind, const uint64_t* peers, int m,
                                    int rank, size_t slot_bytes, int grid,
                                    int two_shot) {
  if (m < 1 || m > kMaxRanks || rank < 0 || rank >= m || n < 0 ||
      grid < 1 || grid > kMaxCtas)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<float, Sum>(st, data, n, peers, m, rank, slot_bytes,
                                grid, two_shot);
    case 1:
      return launch<double, Sum>(st, data, n, peers, m, rank, slot_bytes,
                                 grid, two_shot);
    case 2:
      return launch<int, Sum>(st, data, n, peers, m, rank, slot_bytes, grid,
                              two_shot);
    case 3:
      return launch<int, Min>(st, data, n, peers, m, rank, slot_bytes, grid,
                              two_shot);
  }
  return (int)cudaErrorInvalidValue;
}
