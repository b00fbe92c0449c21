// Candidate-cached Gauss-Newton solve of Kinematic-ICP: B frames per launch.
//
// Replaces kinematic_icp_tpu/ops/pallas_gn.py:_kernel (the Pallas TPU kernel
// called by pallas_gn.gn_solve; the batched runner puts a batch axis on it
// with jax.vmap).  Same function, for each of B independent frames: per
// selection pass the nearest cached candidate of every query (packed-key
// tie-break), the tau gate, the 2x2 normal equations, and optionally the
// window-margin certificate; between passes the adaptive-beta 2x2 solve and
// the closed-form unicycle step; the whole `while (it < max_it && !conv)`
// loop of every frame runs in this one launch.  A single frame is B = 1.
//
// Design for Hopper (sm_90a):
//
//   * Work mapping.  A tile is 32 consecutive queries of one frame, one per
//     lane.  A CTA of kWarps warps takes one tile at a time, and warp w
//     scans a fixed contiguous slice of the V*K candidate rows
//     (row = v*K + k), so each load is words[b, v, k, q0:q0+32]: one
//     coalesced 128-byte line.  The packed CandidateSet words (4 B per
//     candidate, the 10/10/10-bit offset word) are unpacked in registers
//     with hashmap.unpack_offsets' arithmetic.  Each lane keeps the minimum
//     of the packed key (bits(d2) & ~0x3FF) | (rel << 5 | k) over its slice
//     with the word that gave it; warp 0 combines the warps' minima through
//     shared memory in warp order.  Every key of a query is unique (rel
//     differs between its V rows, k between entries), so the minimum does
//     not depend on the split, and iterations, correspondences and
//     `crossed` stay equal to the plain version's.  Warp 0 rebuilds the
//     winner from its key (rel) and word and adds the query's gate,
//     normal-equation and certificate terms in the plain version's order.
//   * Persistent cooperative grid over (frame, tile).  Each frame gets
//     Gb = min(tiles, co_resident / B) CTAs (co_resident = occupancy x SM
//     count): CTA blockIdx.x = b * Gb + j walks the tiles j, j + Gb, ... of
//     frame b in a fixed assignment.  A launch takes B <= co_resident
//     frames; the wrapper splits a larger batch into launches of at most
//     co_resident frames (kicp_gn_capacity reports the count), which
//     changes no bit (see the next point).
//   * Bits that depend only on the frame's N.  Per pass, warp 0 reduces
//     each tile's 7 sums (lane terms, then warp shuffles) into that TILE's
//     slot, partials[pass & 1][b][tile]; after the frame's barrier every
//     CTA of the frame sums the tiles' slots in one fixed order (lane l the
//     tiles l, l + 32, ..., then shuffles), gets the same totals and runs
//     the same solve, motion_delta and pose update in its own shared
//     memory.  The order of the sums depends on the tile count only, never
//     on Gb or B, so a frame solved in a batch is bit-equal to the same
//     frame solved alone, and two launches on the same inputs give the same
//     bits.  No broadcast from a leader, no float atomics.
//   * One barrier per frame and pass.  The frames of a batch converge at
//     different passes, so a grid-wide barrier with one shared loop
//     decision cannot hold.  Two designs were open: a
//     per-frame barrier inside the cooperative grid, or one thread-block
//     cluster per frame (cluster.sync(), partials through distributed
//     shared memory, no cooperative launch).  This kernel takes the first:
//     it keeps the proven single-frame design (any Gb up to the tile count,
//     so a lone frame at N = 8192 still spreads over 256 CTAs, where a
//     cluster caps a frame at 8-16 SMs).  The barrier is one arrival word
//     per frame in global memory (128 bytes apart), used as
//     cooperative_groups' grid barrier uses its word: thread 0 of each CTA
//     fences its CTA's slot writes and adds 1 with atomicAdd, CTA j = 0
//     adds 2^31 - (Gb - 1) instead, so the word's top bit flips exactly
//     when the frame's last CTA arrives; each spins on an ld.acquire of
//     the word until the bit differs from the one its add saw.  No reset,
//     no second atomic: one L2 round trip a CTA and pass.  The words are
//     zeroed by CTA j = 0 of each frame before the first selection pass,
//     whose barrier is the grid-wide one (cooperative_groups
//     this_grid().sync()): every frame takes that pass, before any can
//     stop.  Waiting on CTAs of the same launch is safe because the
//     cooperative launch guarantees that all CTAs are resident.
//   * Built with -fmad=false, so each multiply and add rounds like the plain
//     PyTorch version (kinematic_icp_tpu_torch/ops/gn.py:gn_solve_reference);
//     only the order of the sums differs.
//
// Hazards, and what the code does about them:
//
//   * Every CTA of a frame must take the same loop decision (it, conv,
//     used), or that frame's barrier deadlocks.  The decision reads only the
//     frame's totals, pose and by-value constants; the totals come from the
//     same slots summed by the same code in the same order, and -fmad=false
//     leaves the compiler no contraction to choose, so every CTA of the
//     frame computes the same bits.  CTAs of different frames never wait on
//     each other after the first pass.
//   * Slots are double-buffered by pass parity.  A CTA that is ahead may
//     write pass p+1 while a slow CTA of its frame still reads pass p: they
//     are in different halves.  It cannot write pass p+2 (pass p's half)
//     before every CTA of the frame has arrived at barrier p+1, which each
//     does only after it has read pass p.  The slots are read with
//     ld.global.cg (L2), so a line of the same half left in L1 two passes
//     ago is never used.
//   * A cooperative launch larger than the co-resident count is refused:
//     the entry point computes Gb from the occupancy API, reports the
//     capacity, and returns the launch's error code, on which the wrapper
//     raises; the wrapper never asks for more frames than the capacity.
//   * Masked and ragged queries (mask 0, q >= N) add nothing, but their
//     lanes take part in every shuffle, __syncthreads and barrier; the tile
//     loop's trip count is the same for all threads of a CTA.
//   * max_it = 0 is one selection pass and no loop.
//
// Bound on this card: each pass reads V*K*N*4 + V*N*4 + ~20*N bytes a frame
// and does ~17 float ops per candidate.  The words stay in device memory:
// after the first pass they sit in the 50 MB L2 (0.8 MB a frame at
// V*K = 200, N = 1024; 6.5 MB at N = 8192; 2.2 MB at V = 27), so a pass is
// bound by L2 latency, the barrier and the launch, not by HBM: each warp
// keeps eight word loads in flight, and reads the slots two 16-byte loads a
// tile, all issued before any is summed.  Nothing here is a matrix product
// (a gather, an argmin and 7 sums), so there is no work for wgmma; each
// warp's row is one 128-byte line, so there is no tile worth a TMA copy.
// A batch fills the SMs a single frame leaves idle (32 of 132 at N = 1024).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSums = 7;  // n, a01, a11, b0, b1, sse, viol
constexpr int kSlot = 8;  // floats per tile and pass in `partials`
constexpr int kBarrierStride = 32;  // uint32 words between frames' barriers
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kNoKey = 0x7FFFFFFF;  // above every real key (tag <= 863)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float min_f(float a, float b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The barrier of one frame's `ctas` CTAs on its arrival word `bar`; CTA
// j = 0 of the frame is the `master`.  Called by every thread of each of
// those CTAs.
__device__ __forceinline__ void frame_sync(uint32_t* bar, uint32_t ctas,
                                           bool master) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t add = master ? 0x80000000u - (ctas - 1u) : 1u;
    __threadfence();  // release the CTA's slot writes (ordered by bar.sync)
    const uint32_t old = atomicAdd(bar, add);
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0u) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The read-only inputs of one frame's solve (loaded through the read-only
// cache).
struct Inputs {
  const int32_t* words;
  const int32_t* rel;
  const int32_t* bxs;
  const int32_t* bys;
  const int32_t* bzs;
  const float* sxs;
  const float* sys;
  const float* szs;
  const uint8_t* mask;
  float tau, vs, step;
  int V, K, N;
};

// Candidate word w (entry k of neighbour voxel r, whose corner is c*f)
// against the running minimum of query (wx, wy, wz).
__device__ __forceinline__ void consider(uint32_t w, int r, int k, float cxf,
                                         float cyf, float czf, float step,
                                         float wx, float wy, float wz,
                                         int& best, uint32_t& best_w) {
  const float kFar = (float)1e18;
  float px, py, pz;
  if (w != kSentinel) {
    px = cxf + ((float)(w & 1023u) + 0.5f) * step;
    py = cyf + ((float)((w >> 10) & 1023u) + 0.5f) * step;
    pz = czf + ((float)((w >> 20) & 1023u) + 0.5f) * step;
  } else {
    px = py = pz = kFar;
  }
  const float dx = px - wx, dy = py - wy, dz = pz - wz;
  const float d2 = dx * dx + dy * dy + dz * dz;
  const int key =
      (int)((__float_as_uint(d2) & ~0x3FFu) | (uint32_t)((r << 5) | k));
  if (key < best) {
    best = key;
    best_w = w;
  }
}

// Packed-key minimum of query q over candidate rows [r0, r1).  The words
// are loaded kBatch at a time before any is used, so that many L2 reads
// are in flight for each warp; they are taken in row order all the same.
__device__ __forceinline__ void scan_rows(const Inputs& in, int q, int r0,
                                          int r1, int bx, int by, int bz,
                                          float wx, float wy, float wz,
                                          int& best, uint32_t& best_w) {
  constexpr int kBatch = 8;
  const int K = in.K, N = in.N;
  for (int v = r0 / K; v * K < r1; ++v) {
    const int kb = r0 > v * K ? r0 - v * K : 0;
    const int ke = r1 - v * K < K ? r1 - v * K : K;
    const int r = __ldg(in.rel + v * N + q);
    const float cxf = (float)(bx + r / 9 - 1) * in.vs;
    const float cyf = (float)(by + (r / 3) % 3 - 1) * in.vs;
    const float czf = (float)(bz + r % 3 - 1) * in.vs;
    const int32_t* wrow = in.words + (size_t)v * K * N + q;
    int k = kb;
    for (; k + kBatch <= ke; k += kBatch) {
      uint32_t w[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        w[j] = (uint32_t)__ldg(wrow + (size_t)(k + j) * N);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        consider(w[j], r, k + j, cxf, cyf, czf, in.step, wx, wy, wz, best,
                 best_w);
    }
    for (; k < ke; ++k)
      consider((uint32_t)__ldg(wrow + (size_t)k * N), r, k, cxf, cyf, czf,
               in.step, wx, wy, wz, best, best_w);
  }
}

// One selection pass of one frame at pose p (12 floats in shared memory: R
// row-major, t): each of this CTA's tiles' sums into its slot of `half`
// (this pass's half of the frame's slots), the frame's barrier (the grid's
// on the `first` pass), then the totals of all the frame's tiles in tot[]
// (valid in thread 0).
template <bool CHECK>
__device__ __forceinline__ void select_pass(
    const float* p, const Inputs& in, int (*s_key)[32],
    uint32_t (*s_word)[32], float* half, uint32_t* bar, int j, int ctas,
    bool first, float (&tot)[kSums]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float r00 = p[0], r01 = p[1], r02 = p[2];
  const float r10 = p[3], r11 = p[4], r12 = p[5];
  const float r20 = p[6], r21 = p[7], r22 = p[8];
  const float t0 = p[9], t1 = p[10], t2 = p[11];
  const float kFar = (float)1e18;

  const int rows = in.V * in.K;
  const int per_warp = (rows + kWarps - 1) / kWarps;
  const int r0 = warp * per_warp < rows ? warp * per_warp : rows;
  const int r1 = r0 + per_warp < rows ? r0 + per_warp : rows;
  const int tiles = (in.N + 31) / 32;

  for (int tile = j; tile < tiles; tile += ctas) {
    const int q = tile * 32 + lane;
    const bool live = q < in.N && __ldg(in.mask + q) != 0;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, wx = 0.0f, wy = 0.0f, wz = 0.0f;
    int bx = 0, by = 0, bz = 0;
    int best = kNoKey;
    uint32_t best_w = kSentinel;
    if (live) {
      sx = __ldg(in.sxs + q);
      sy = __ldg(in.sys + q);
      sz = __ldg(in.szs + q);
      wx = r00 * sx + r01 * sy + r02 * sz + t0;
      wy = r10 * sx + r11 * sy + r12 * sz + t1;
      wz = r20 * sx + r21 * sy + r22 * sz + t2;
      bx = __ldg(in.bxs + q);
      by = __ldg(in.bys + q);
      bz = __ldg(in.bzs + q);
      scan_rows(in, q, r0, r1, bx, by, bz, wx, wy, wz, best, best_w);
    }
    s_key[warp][lane] = best;
    s_word[warp][lane] = best_w;
    __syncthreads();
    if (warp == 0) {
      float acc[kSums];
#pragma unroll
      for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
      if (live) {
        // warp order and a strict `<`: the earliest row wins, as in argmin
        for (int w = 1; w < kWarps; ++w) {
          const int key = s_key[w][lane];
          if (key < best) {
            best = key;
            best_w = s_word[w][lane];
          }
        }
        const int r = (best >> 5) & 31;
        float nx, ny, nz;
        if (best_w != kSentinel) {
          const float cxf = (float)(bx + r / 9 - 1) * in.vs;
          const float cyf = (float)(by + (r / 3) % 3 - 1) * in.vs;
          const float czf = (float)(bz + r % 3 - 1) * in.vs;
          nx = cxf + ((float)(best_w & 1023u) + 0.5f) * in.step;
          ny = cyf + ((float)((best_w >> 10) & 1023u) + 0.5f) * in.step;
          nz = czf + ((float)((best_w >> 20) & 1023u) + 0.5f) * in.step;
        } else {
          nx = ny = nz = kFar;
        }
        const float ex = nx - wx, ey = ny - wy, ez = nz - wz;
        const float dw2 = ex * ex + ey * ey + ez * ez;
        const float dist = sqrtf(dw2);
        const float corr = dist < in.tau ? 1.0f : 0.0f;  // mask is 1 here

        // normal-equation terms at this pose
        // (registration.partial_normal_equations)
        const float rx = wx - nx, ry = wy - ny, rz = wz - nz;
        const float j1x = -sy * r00 + sx * r01;
        const float j1y = -sy * r10 + sx * r11;
        const float j1z = -sy * r20 + sx * r21;
        const float j1_dot_j0 = j1x * r00 + j1y * r10 + j1z * r20;
        const float j1_dot_j1 = j1x * j1x + j1y * j1y + j1z * j1z;
        const float r_dot_j0 = rx * r00 + ry * r10 + rz * r20;
        const float r_dot_j1 = rx * j1x + ry * j1y + rz * j1z;
        acc[0] += corr;
        acc[1] += corr * j1_dot_j0;
        acc[2] += corr * j1_dot_j1;
        acc[3] += corr * r_dot_j0;
        acc[4] += corr * r_dot_j1;
        acc[5] += corr * (rx * rx + ry * ry + rz * rz);

        if (CHECK) {
          // Window-margin certificate (pallas_gn.py:142-169): the cached
          // candidates cover [vs*(b-1), vs*(b+2)) around the gather-time
          // voxel b.
          const float vs = in.vs;
          const float fbx = (float)bx, fby = (float)by, fbz = (float)bz;
          const float mx =
              min_f(wx - (fbx - 1.0f) * vs, (fbx + 2.0f) * vs - wx);
          const float my =
              min_f(wy - (fby - 1.0f) * vs, (fby + 2.0f) * vs - wy);
          const float mz =
              min_f(wz - (fbz - 1.0f) * vs, (fbz + 2.0f) * vs - wz);
          float margin = min_f(min_f(min_f(mx, my), mz), vs);
          margin = margin > 0.0f ? margin : 0.0f;
          float cap2 = min_f(dw2, in.tau * in.tau);
          cap2 = __uint_as_float((__float_as_uint(cap2) | 0x3FFu) + 0x400u);
          acc[6] += cap2 >= margin * margin ? 1.0f : 0.0f;
        }
      }
      // the tile's sums; its slot is 8 floats, 32-byte aligned: two
      // 16-byte stores
#pragma unroll
      for (int s = 0; s < kSums; ++s) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[s] += __shfl_down_sync(0xFFFFFFFFu, acc[s], off);
      }
      if (lane == 0) {
        float4* slot = reinterpret_cast<float4*>(half + tile * kSlot);
        __stcg(slot, make_float4(acc[0], acc[1], acc[2], acc[3]));
        __stcg(slot + 1, make_float4(acc[4], acc[5], acc[6], 0.0f));
      }
    }
    __syncthreads();  // s_key and s_word are rewritten by the next tile
  }

  // the one barrier of the pass (fences memory first)
  if (first)
    cg::this_grid().sync();
  else
    frame_sync(bar, (uint32_t)ctas, j == 0);
  if (warp == 0) {
    float x[kSlot];
#pragma unroll
    for (int s = 0; s < kSlot; ++s) x[s] = 0.0f;
    // lane l sums the tiles l, l + 32, ... in order, each sum on its own
    for (int t = lane; t < tiles; t += 32) {
      const float4* slot = reinterpret_cast<const float4*>(half + t * kSlot);
      const float4 lo = __ldcg(slot), hi = __ldcg(slot + 1);
      x[0] += lo.x;
      x[1] += lo.y;
      x[2] += lo.z;
      x[3] += lo.w;
      x[4] += hi.x;
      x[5] += hi.y;
      x[6] += hi.z;
    }
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x[s] += __shfl_down_sync(0xFFFFFFFFu, x[s], off);
      tot[s] = x[s];
    }
  }
}

// Unicycle delta of pallas_gn._motion_delta: (d00, d01, d10, d11, tx, ty).
__device__ void motion_delta(float rho, float theta, float* d) {
  const float t2 = theta * theta;
  const bool big = fabsf(theta) >= (float)1e-3;
  const float safe = big ? theta : 1.0f;
  const float sinc = big ? sinf(safe) / safe : 1.0f - t2 / 6.0f;
  const float sh = sinf(0.5f * safe);
  const float verc =
      big ? 2.0f * sh * sh / safe : theta / 2.0f - t2 * theta / 24.0f;
  const float vx = rho * sinc;
  const float vy = rho * verc;
  const float ct = big ? cosf(safe) : 1.0f - t2 / 2.0f + t2 * t2 / 24.0f;
  const float st = big ? sinf(safe) : theta - t2 * theta / 6.0f;
  const float b_c = 0.5f - t2 / 24.0f + t2 * t2 / 720.0f;
  const float c_c = (float)(1.0 / 6.0) - t2 / 120.0f + t2 * t2 / 5040.0f;
  const float bb = big ? 2.0f * (sh / safe) * sh : b_c * theta;
  const float cc = big ? (1.0f - sinc) / safe : c_c * theta;
  const float v00 = 1.0f - cc * theta;
  d[0] = ct;
  d[1] = -st;
  d[2] = st;
  d[3] = ct;
  d[4] = v00 * vx - bb * vy;
  d[5] = bb * vx + v00 * vy;
}

// `partials` holds 2 * B * tiles * kSlot floats of slots (pass parity,
// frame, tile), then B * kBarrierStride uint32 words, the first of each
// stride a frame's arrival word.
template <bool CHECK>
__global__ void __launch_bounds__(kThreads)
    gn_solve_kernel(const float* __restrict__ guess,
                    const float* __restrict__ tau,
                    const int32_t* __restrict__ words,
                    const int32_t* __restrict__ rel,
                    const int32_t* __restrict__ bxs,
                    const int32_t* __restrict__ bys,
                    const int32_t* __restrict__ bzs,
                    const float* __restrict__ sxs,
                    const float* __restrict__ sys,
                    const float* __restrict__ szs,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ pose_out,
                    int32_t* __restrict__ stats_out,
                    float* __restrict__ err_out, float* partials, int B,
                    int V, int K, int N, int max_it, float crit, int adaptive,
                    float fixed_reg, float voxel_size, float max_range) {
  __shared__ float s_guess[12];
  __shared__ float s_pose[12];
  __shared__ int s_key[kWarps][32];
  __shared__ uint32_t s_word[kWarps][32];
  __shared__ int s_continue;

  const int ctas = gridDim.x / B;  // Gb, the CTAs of each frame
  const int b = blockIdx.x / ctas;
  const int j = blockIdx.x % ctas;
  const int tiles = (N + 31) / 32;
  const size_t bn = (size_t)b * N;
  const int half_size = B * tiles * kSlot;
  float* slots = partials + (size_t)b * tiles * kSlot;
  uint32_t* bar = reinterpret_cast<uint32_t*>(partials + 2 * half_size) +
                  b * kBarrierStride;

  // the frame's arrival word, first used after the first pass's grid
  // barrier
  if (j == 0 && threadIdx.x == 0) *bar = 0u;

  Inputs in{words + (size_t)b * V * K * N,
            rel + (size_t)b * V * N,
            bxs + bn,
            bys + bn,
            bzs + bn,
            sxs + bn,
            sys + bn,
            szs + bn,
            mask + bn,
            tau[b],
            voxel_size,
            voxel_size * (1.0f / 1024.0f),  // exact: a power-of-two scale
            V,
            K,
            N};
  const float kEps = (float)1e-30;
  const float* g16 = guess + (size_t)b * 16;

  if (threadIdx.x < 12) {
    // R row-major from the (4, 4) guess, then t
    const int i = threadIdx.x;
    const float g = i < 9 ? g16[(i / 3) * 4 + i % 3] : g16[(i - 9) * 4 + 3];
    s_guess[i] = g;
    s_pose[i] = g;
  }
  __syncthreads();

  float tot[kSums];
  int pass = 0;
  select_pass<CHECK>(s_pose, in, s_key, s_word, slots, bar, j, ctas, true,
                     tot);
  ++pass;

  // Thread 0's loop state; every CTA of the frame computes the same values.
  float beta = 0.0f, crossed = 0.0f;
  int it = 0;
  bool conv = false;
  if (threadIdx.x == 0) {
    if (adaptive) {
      const float n0 = tot[0];
      const float mean = tot[5] / (n0 > 1.0f ? n0 : 1.0f);
      beta = n0 > 0.0f ? 1.0f / (mean + kEps) : 0.0f;
    } else {
      beta = fixed_reg;
    }
    crossed = tot[6];
    s_continue = max_it > 0;
  }
  __syncthreads();

  while (s_continue) {
    if (threadIdx.x == 0) {
      const float r00 = s_pose[0], r01 = s_pose[1];
      const float r10 = s_pose[3], r11 = s_pose[4];
      const float r20 = s_pose[6], r21 = s_pose[7];
      const float t0 = s_pose[9], t1 = s_pose[10], t2 = s_pose[11];
      const float n = tot[0];
      float a00 = n * (r00 * r00 + r10 * r10 + r20 * r20);
      const float nsafe = n > 1.0f ? n : 1.0f;
      a00 = a00 / nsafe + beta;
      const float a01 = tot[1] / nsafe;
      const float a11 = tot[2] / nsafe;
      const float b0 = tot[3] / nsafe;
      const float b1 = tot[4] / nsafe;
      const float det = a00 * a11 - a01 * a01;
      const bool det_ok = fabsf(det) > kEps;
      const float safe_det = det_ok ? det : 1.0f;
      float dx0 = -(a11 * b0 - a01 * b1) / safe_det;
      float dx1 = -(a00 * b1 - a01 * b0) / safe_det;
      if (!(n > 0.0f && det_ok)) dx0 = dx1 = 0.0f;
      float d[6];
      motion_delta(dx0, dx1, d);
      s_pose[0] = r00 * d[0] + r01 * d[2];
      s_pose[1] = r00 * d[1] + r01 * d[3];
      s_pose[3] = r10 * d[0] + r11 * d[2];
      s_pose[4] = r10 * d[1] + r11 * d[3];
      s_pose[6] = r20 * d[0] + r21 * d[2];
      s_pose[7] = r20 * d[1] + r21 * d[3];
      s_pose[9] = r00 * d[4] + r01 * d[5] + t0;
      s_pose[10] = r10 * d[4] + r11 * d[5] + t1;
      s_pose[11] = r20 * d[4] + r21 * d[5] + t2;
      ++it;
      conv = sqrtf(dx0 * dx0 + dx1 * dx1) < crit;
    }
    __syncthreads();
    select_pass<CHECK>(s_pose, in, s_key, s_word,
                       slots + (pass & 1) * half_size, bar, j, ctas, false,
                       tot);
    ++pass;
    if (threadIdx.x == 0) {
      // only a selection that feeds a further iteration counts
      const bool used = !conv && it < max_it;
      if (used) crossed += tot[6];
      s_continue = used;
    }
    __syncthreads();
  }

  if (j == 0 && threadIdx.x == 0) {
    const float* p = s_pose;
    const float* g = s_guess;
    float* po = pose_out + (size_t)b * 16;
    const float z = 0.0f * p[9];
    po[0] = p[0];
    po[1] = p[1];
    po[2] = p[2];
    po[3] = p[9];
    po[4] = p[3];
    po[5] = p[4];
    po[6] = p[5];
    po[7] = p[10];
    po[8] = p[6];
    po[9] = p[7];
    po[10] = p[8];
    po[11] = p[11];
    po[12] = z;
    po[13] = z;
    po[14] = z;
    po[15] = 1.0f + z;
    stats_out[b * 3 + 0] = it;
    stats_out[b * 3 + 1] = (int32_t)tot[0];
    stats_out[b * 3 + 2] = crossed > 0.0f ? 1 : 0;
    // point-space odometry error of guess^-1 @ pose (pallas_gn.py:285-299)
    const float dtx = p[9] - g[9];
    const float dty = p[10] - g[10];
    const float dtz = p[11] - g[11];
    const float dt = sqrtf(dtx * dtx + dty * dty + dtz * dtz);
    const float frob = p[0] * g[0] + p[1] * g[1] + p[2] * g[2] +
                       p[3] * g[3] + p[4] * g[4] + p[5] * g[5] +
                       p[6] * g[6] + p[7] * g[7] + p[8] * g[8];
    float c = (frob - 1.0f) * 0.5f;
    c = c < -1.0f ? -1.0f : (c > 1.0f ? 1.0f : c);
    const float h = (1.0f - c) * 0.5f;
    err_out[b] = dt + 2.0f * max_range * sqrtf(h > 0.0f ? h : 0.0f);
  }
}

// Co-resident CTAs of gn_solve_kernel<CHECK> on `device` (SMs x occupancy),
// computed once per device; 0 where cooperative launch is unsupported.
template <bool CHECK>
cudaError_t co_resident(int device, int* count) {
  static int cache[kMaxDevices];
  if (device >= 0 && device < kMaxDevices && cache[device] > 0) {
    *count = cache[device];
    return cudaSuccess;
  }
  int sms = 0, coop = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gn_solve_kernel<CHECK>, kThreads, 0);
  if (e != cudaSuccess) return e;
  *count = coop ? sms * per_sm : 0;
  if (device >= 0 && device < kMaxDevices) cache[device] = *count;
  return cudaSuccess;
}

template <bool CHECK>
cudaError_t launch(const float* guess, const float* tau,
                   const int32_t* words, const int32_t* rel,
                   const int32_t* bx, const int32_t* by, const int32_t* bz,
                   const float* sx, const float* sy, const float* sz,
                   const uint8_t* mask, float* pose_out, int32_t* stats_out,
                   float* err_out, float* partials, int B, int V, int K,
                   int N, int max_it, float crit, int adaptive,
                   float fixed_reg, float voxel_size, float max_range,
                   int* ctas_out, int* capacity_out, cudaStream_t stream) {
  int device = 0, capacity = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = co_resident<CHECK>(device, &capacity);
  if (e != cudaSuccess) return e;
  *capacity_out = capacity;
  const int tiles = (N + 31) / 32;
  const int share = B >= 1 ? capacity / B : 0;
  const int G = tiles < share ? tiles : share;
  if (G < 1) return cudaErrorCooperativeLaunchTooLarge;
  *ctas_out = G;
  void* args[] = {&guess,     &tau,       &words,      &rel,
                  &bx,        &by,        &bz,         &sx,
                  &sy,        &sz,        &mask,       &pose_out,
                  &stats_out, &err_out,   &partials,   &B,
                  &V,         &K,         &N,          &max_it,
                  &crit,      &adaptive,  &fixed_reg,  &voxel_size,
                  &max_range};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&gn_solve_kernel<CHECK>), dim3(B * G),
      dim3(kThreads), args, 0, stream);
}

}  // namespace

// Launches the solve of B frames on `stream` as one cooperative grid of
// B * Gb CTAs; Gb (CTAs a frame) is written to *ctas_out and the
// co-resident CTA count to *capacity_out.  `partials` holds
// 2 * B * ceil(N / 32) * 8 floats of slots, then B * 32 uint32 words of
// barriers.  Returns the launch's CUDA error code (0 on success).
extern "C" int kicp_gn_solve(const float* guess, const float* tau,
                             const int32_t* words, const int32_t* rel,
                             const int32_t* bx, const int32_t* by,
                             const int32_t* bz, const float* sx,
                             const float* sy, const float* sz,
                             const uint8_t* mask, float* pose_out,
                             int32_t* stats_out, float* err_out,
                             float* partials, int B, int V, int K, int N,
                             int max_it, float crit, int adaptive,
                             float fixed_reg, float voxel_size,
                             float max_range, int check_crossing,
                             int* ctas_out, int* capacity_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      check_crossing
          ? launch<true>(guess, tau, words, rel, bx, by, bz, sx, sy, sz,
                         mask, pose_out, stats_out, err_out, partials, B, V,
                         K, N, max_it, crit, adaptive, fixed_reg, voxel_size,
                         max_range, ctas_out, capacity_out, st)
          : launch<false>(guess, tau, words, rel, bx, by, bz, sx, sy, sz,
                          mask, pose_out, stats_out, err_out, partials, B, V,
                          K, N, max_it, crit, adaptive, fixed_reg,
                          voxel_size, max_range, ctas_out, capacity_out, st);
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(e != cudaSuccess ? e : last);
}

// Writes to *capacity_out the co-resident CTA count of the instance that
// kicp_gn_solve launches for `check_crossing` on the current device: the
// most frames one launch takes (one CTA a frame at least).  Returns the
// CUDA error code of the query.
extern "C" int kicp_gn_capacity(int check_crossing, int* capacity_out) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = check_crossing ? co_resident<true>(device, capacity_out)
                       : co_resident<false>(device, capacity_out);
  return (int)e;
}
