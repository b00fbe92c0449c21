// The full-27 nearest-neighbour search of the exact modes, one launch a
// batch: for every live query, the closest point stored in the 27 voxels
// around it (the reference's GetClosestNeighbor, Registration.cpp:69-79).
//
// It replaces no Pallas kernel.  The JAX package computes this search with
// XLA's fused gathers (kinematic_icp_tpu/ops/hashmap.py:nearest_neighbor,
// nearest_neighbor_native), and the port's plain version,
// ops/hashmap.py:gather_candidates at V = 27 then nn_from_candidates, is
// eager PyTorch: every call writes the (B, 27, N, G*R) fat bucket rows,
// four (B, 27, N, K) selections, three float planes, an int64 key plane
// and their reductions to device memory, ~10-13 GB at B = 8, N = 8,192,
// G = 4, K = 20, though ~9 % of the query slots hold a live source.  The
// full-27 fallback loop of the certified exact mode (ops/registration.py:
// compute_robot_motion) calls it once an association, several times a
// fallback frame.  Here nothing but the outputs reaches device memory.
//
// What bounds it.  A live query reads the G meta lanes of 27 bucket rows
// and the K words of each voxel it finds: at most 27 (4 G + K) words, 3.9
// KB at G = 4, K = 20, most of them shared with the queries around it and
// served from L1/L2; a dead query reads its coordinates and mask.  Every
// query writes 16 bytes.  At ~740 live queries a lane and B = 8 that is
// well under a microsecond of HBM time: the launch, the dependent loads of
// a query (the mask, then the 27 bucket rows' meta lanes, then the words)
// and the tail of the last warps set the time.
//
// Design: one warp a query, 8 queries a CTA.  Lane r < 27 takes neighbour
// offset r (hashmap._rel_to_offsets: r / 9 - 1, r / 3 % 3 - 1, r % 3 - 1)
// of the query's voxel, computes its bucket and fingerprint in u32
// arithmetic (hashmap.bucket_of, hashmap.fingerprint), matches the G slots
// of the bucket row (the last matching slot wins, as _voxel_words' selects
// do; a voxel holds at most one), unpacks each stored word of the voxel
// (hashmap.unpack_offsets) and keeps the least packed key
//   (bits(d2) & ~0x3FF) | (r << 5) | entry lane
// with nn_from_candidates' d2 = (dx dx + dy dy) + dz dz.  The keys of a
// query are unique, so the warp's minimum (one __reduce_min_sync) is the
// plain version's winner, and lane r = key >> 5 & 31 holds its point and
// d2.  -fmad=false keeps each multiply and add rounded on its own, as
// PyTorch's elementwise kernels round them, so the winner's coordinates
// and dist = sqrt(d2) are the plain version's bits.  One instance takes
// float32 queries, one float64 (a float64 state): there every product,
// sum and the root are float64, and the key holds d2 rounded to float32,
// as nn_from_candidates' key does.  A live query with no stored point in
// its 27 voxels gets what the plain version's sums give: the sentinel
// words summed over the 27 K entries (wrapping in u32), at offset id 31,
// and an infinite dist.  A dead query (mask clear) reads no bucket: its
// nearest point is the query itself, its dist infinite.
//
// The launch is a plain one on the caller's stream, so a capture can hold
// it inside a conditional body (the GN loop's re-associations).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // queries a CTA
constexpr int kMetaLanes = 4;    // fingerprint + 3 key components a slot
constexpr int kNeighbours = 27;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t bucket_hash(uint32_t x, uint32_t y,
                                                uint32_t z) {
  uint32_t h = x * 0x85297A4Du + y * 0x68E31DA4u + z * 0xB5297A4Du;
  h ^= h >> 16;
  h *= 0x45D9F3B3u;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ uint32_t fingerprint(uint32_t x, uint32_t y,
                                                uint32_t z) {
  uint32_t h = x * 0x9E3779B1u + y * 0x85EBCA77u + z * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h | 0x80000000u;
}

// one multiply or add, rounded on its own, in the queries' precision
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
// float(floor(v)) as int32, as torch's .to(torch.int32) truncates it
__device__ __forceinline__ int floor_int(float v) {
  return __float2int_rz(floorf(v));
}
__device__ __forceinline__ int floor_int(double v) {
  return __double2int_rz(floor(v));
}
__device__ __forceinline__ float root(float v) { return __fsqrt_rn(v); }
__device__ __forceinline__ double root(double v) { return __dsqrt_rn(v); }
// the float32 bits that the packed key takes (a no-op for float32 d2;
// torch's .to(torch.float32) of a float64 d2 rounds to nearest)
__device__ __forceinline__ uint32_t key_bits(float d2) {
  return __float_as_uint(d2);
}
__device__ __forceinline__ uint32_t key_bits(double d2) {
  return __float_as_uint(__double2float_rn(d2));
}

// hashmap.unpack_offsets of one 10-bit field: voxel * size + (o + 0.5) *
// step, each product and the sum rounded on its own
template <typename T>
__device__ __forceinline__ T unpack(int voxel, uint32_t field, T vs, T step) {
  return add(mul((T)voxel, vs), mul(add((T)field, (T)0.5), step));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
nn27_kernel(const int* __restrict__ table, int num_buckets, int slots,
            int k, const T* __restrict__ qx, const T* __restrict__ qy,
            const T* __restrict__ qz, const unsigned char* __restrict__ mask,
            int n, long long total, T inv, T vs, T step,
            T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= total) return;
  const T x = qx[i], y = qy[i], z = qz[i];
  if (!mask[i]) {
    if (lane == 0) {
      out[i] = x;
      out[total + i] = y;
      out[2 * total + i] = z;
      out[3 * total + i] = (T)INFINITY;
    }
    return;
  }
  // voxel_coords_planar: floor(p * (1 / voxel_size)) as int32
  const int cx = floor_int(mul(x, inv));
  const int cy = floor_int(mul(y, inv));
  const int cz = floor_int(mul(z, inv));

  uint32_t best = kFull;
  T bx = 0, by = 0, bz = 0, bd2 = 0;
  if (lane < kNeighbours) {
    // int32 adds that wrap, as torch's do
    const int vx = (int)((uint32_t)cx + (uint32_t)(lane / 9 - 1));
    const int vy = (int)((uint32_t)cy + (uint32_t)(lane / 3 % 3 - 1));
    const int vz = (int)((uint32_t)cz + (uint32_t)(lane % 3 - 1));
    const uint32_t bucket =
        bucket_hash(vx, vy, vz) & (uint32_t)(num_buckets - 1);
    const int r = k + kMetaLanes;
    const int* row = table + ((long long)(i / n) * num_buckets + bucket) *
                                 (long long)(slots * r);
    const int fp = (int)fingerprint(vx, vy, vz);
    int hit = -1;
    for (int g = 0; g < slots; ++g) {
      const int* meta = row + g * r + k;
      if (meta[0] == fp && meta[1] == vx && meta[2] == vy && meta[3] == vz)
        hit = g;
    }
    if (hit >= 0) {
      const int* words = row + hit * r;
      const uint32_t tag = (uint32_t)lane << 5;
      for (int e = 0; e < k; ++e) {
        const int w = words[e];
        if (w == -1) continue;  // an unused entry
        const T px = unpack(vx, w & 1023, vs, step);
        const T py = unpack(vy, (w >> 10) & 1023, vs, step);
        const T pz = unpack(vz, (w >> 20) & 1023, vs, step);
        const T dx = px - x, dy = py - y, dz = pz - z;
        const T d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
        const uint32_t key = (key_bits(d2) & ~0x3FFu) | tag | (uint32_t)e;
        if (key < best) {
          best = key;
          bx = px;
          by = py;
          bz = pz;
          bd2 = d2;
        }
      }
    }
  }
  const uint32_t least = __reduce_min_sync(kFull, best);
  const int src = (int)((least >> 5) & 31);  // the winner's offset id
  bx = __shfl_sync(kFull, bx, src);
  by = __shfl_sync(kFull, by, src);
  bz = __shfl_sync(kFull, bz, src);
  bd2 = __shfl_sync(kFull, bd2, src);
  if (lane != 0) return;
  T dist = root(bd2);
  if (least == kFull) {
    // no stored point: the plain version's u32 sum of all 27 K sentinel
    // words, unpacked at offset id 31 (+2, 0, 0)
    const uint32_t word = 0u - (uint32_t)(kNeighbours * k);
    bx = unpack((int)((uint32_t)cx + 2u), word & 1023, vs, step);
    by = unpack(cy, (word >> 10) & 1023, vs, step);
    bz = unpack(cz, (word >> 20) & 1023, vs, step);
    dist = (T)INFINITY;
  }
  out[i] = bx;
  out[total + i] = by;
  out[2 * total + i] = bz;
  out[3 * total + i] = dist;
}

template <typename T>
int launch(void* stream, const int* table, int batch, int num_buckets,
           int slots, int k, const void* qx, const void* qy, const void* qz,
           const unsigned char* mask, int n, double inv, double voxel_size,
           double step, void* out) {
  const long long total = (long long)batch * n;
  const long long blocks = (total + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  nn27_kernel<T><<<(unsigned)blocks, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      table, num_buckets, slots, k, static_cast<const T*>(qx),
      static_cast<const T*>(qy), static_cast<const T*>(qz), mask, n, total,
      (T)inv, (T)voxel_size, (T)step, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The nearest stored point of each of the B * n queries (qx, qy, qz, (B,
// n) float32, or float64 where `f64`; mask (B, n) bool) in its sequence's
// table (B, num_buckets, slots * (k + 4)) int32, on `stream`: out (4, B, n)
// in the queries' type holds the point's x, y, z and its distance.  `inv`,
// `voxel_size` and `step` are rounded to the queries' type, as torch rounds
// a Python scalar in an elementwise op.  Returns the launch's error code.
extern "C" int kicp_nn27(void* stream, const int* table, int batch,
                         int num_buckets, int slots, int k, int f64,
                         const void* qx, const void* qy, const void* qz,
                         const unsigned char* mask, int n, double inv,
                         double voxel_size, double step, void* out) {
  if (batch < 1 || n < 1 || slots < 1 || k < 1 || k > 32 ||
      num_buckets < 1 || (num_buckets & (num_buckets - 1)))
    return (int)cudaErrorInvalidValue;
  return f64 ? launch<double>(stream, table, batch, num_buckets, slots, k,
                              qx, qy, qz, mask, n, inv, voxel_size, step, out)
             : launch<float>(stream, table, batch, num_buckets, slots, k, qx,
                             qy, qz, mask, n, inv, voxel_size, step, out);
}
