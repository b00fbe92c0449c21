// Candidate-cached Gauss-Newton solve of Kinematic-ICP, one frame per launch.
//
// Replaces kinematic_icp_tpu/ops/pallas_gn.py:_kernel (the Pallas TPU kernel
// called by pallas_gn.gn_solve).  Same function, re-thought for Hopper:
//
//   * The packed CandidateSet is read directly (4 B per candidate: the
//     10/10/10-bit offset word) and unpacked in registers with
//     hashmap.unpack_offsets' arithmetic, instead of 16 B of f32 planes.
//   * One CTA of 1024 threads solves the frame.  Thread t owns the queries
//     q = t (mod 1024).  Each selection pass fuses the nearest-candidate pick
//     (packed key (bits(d2) & ~0x3FF) | (rel << 5 | lane), min-reduced as
//     signed int32), the tau gate and the per-thread partial sums of the 2x2
//     normal equations at the same pose.  A fixed-order block reduction
//     (warp shuffles, then one warp; no atomics) makes every run give the
//     same bits.  Thread 0 solves the 2x2 system with the adaptive beta,
//     composes the closed-form unicycle delta and broadcasts the pose through
//     shared memory; the `while (it < max_it && !conv)` loop runs in-kernel.
//   * Built with -fmad=false, so each multiply and add rounds like the plain
//     PyTorch version (kinematic_icp_tpu_torch/ops/gn.py:gn_solve_reference);
//     only the order of the sums differs.
//
// Bound on this card: each selection pass reads V*K*N*4 + V*N*4 + ~20*N
// bytes.  At N = 1024 and V*K = 200 that is about 0.8 MB, which sits in L2
// after the first pass, so the solve is bound by latency and launch, not by
// HBM bandwidth.  A single CTA uses 1 of the 132 SMs; spreading the queries
// over CTAs (grid-wide reduction or a cluster) is a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 7;  // n, a01, a11, b0, b1, sse (first pass), viol
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

__device__ __forceinline__ float min_f(float a, float b) {
  return a < b ? a : b;
}

struct Params {
  float tau, vs, step, max_range;
};

// One selection + partial-sum pass at pose p (12 floats: R row-major, t).
template <bool CHECK>
__device__ void select_pass(const float* __restrict__ p, const Params& prm,
                            const int32_t* __restrict__ words,
                            const int32_t* __restrict__ rel,
                            const int32_t* __restrict__ bxs,
                            const int32_t* __restrict__ bys,
                            const int32_t* __restrict__ bzs,
                            const float* __restrict__ sxs,
                            const float* __restrict__ sys,
                            const float* __restrict__ szs,
                            const float* __restrict__ sms, int V, int K, int N,
                            float (&acc)[kSums]) {
  const float r00 = p[0], r01 = p[1], r02 = p[2];
  const float r10 = p[3], r11 = p[4], r12 = p[5];
  const float r20 = p[6], r21 = p[7], r22 = p[8];
  const float t0 = p[9], t1 = p[10], t2 = p[11];
  const float kFar = (float)1e18;
  for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;

  for (int q = threadIdx.x; q < N; q += kThreads) {
    const float sm = sms[q];
    if (sm == 0.0f) continue;  // a masked query adds nothing to any sum
    const float sx = sxs[q], sy = sys[q], sz = szs[q];
    const float wx = r00 * sx + r01 * sy + r02 * sz + t0;
    const float wy = r10 * sx + r11 * sy + r12 * sz + t1;
    const float wz = r20 * sx + r21 * sy + r22 * sz + t2;
    const int bx = bxs[q], by = bys[q], bz = bzs[q];

    int best = 0x7FFFFFFF;
    bool have = false;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    for (int v = 0; v < V; ++v) {
      const int r = rel[v * N + q];
      const float cxf = (float)(bx + r / 9 - 1) * prm.vs;
      const float cyf = (float)(by + (r / 3) % 3 - 1) * prm.vs;
      const float czf = (float)(bz + r % 3 - 1) * prm.vs;
      const int32_t* wrow = words + (size_t)v * K * N + q;
      for (int k = 0; k < K; ++k) {
        const uint32_t w = (uint32_t)wrow[(size_t)k * N];
        float px, py, pz;
        if (w != kSentinel) {
          px = cxf + ((float)(w & 1023u) + 0.5f) * prm.step;
          py = cyf + ((float)((w >> 10) & 1023u) + 0.5f) * prm.step;
          pz = czf + ((float)((w >> 20) & 1023u) + 0.5f) * prm.step;
        } else {
          px = py = pz = kFar;
        }
        const float dx = px - wx, dy = py - wy, dz = pz - wz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const int key = (int)((__float_as_uint(d2) & ~0x3FFu) |
                              (uint32_t)((r << 5) | k));
        if (!have || key < best) {
          have = true;
          best = key;
          nx = px;
          ny = py;
          nz = pz;
        }
      }
    }
    const float ex = nx - wx, ey = ny - wy, ez = nz - wz;
    const float dw2 = ex * ex + ey * ey + ez * ez;
    const float dist = sqrtf(dw2);
    const float corr = sm * (dist < prm.tau ? 1.0f : 0.0f);

    // normal-equation terms at this pose (registration.partial_normal_equations)
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
      // candidates cover [vs*(b-1), vs*(b+2)) around the gather-time voxel b.
      const float vs = prm.vs;
      const float fbx = (float)bx, fby = (float)by, fbz = (float)bz;
      const float mx = min_f(wx - (fbx - 1.0f) * vs, (fbx + 2.0f) * vs - wx);
      const float my = min_f(wy - (fby - 1.0f) * vs, (fby + 2.0f) * vs - wy);
      const float mz = min_f(wz - (fbz - 1.0f) * vs, (fbz + 2.0f) * vs - wz);
      float margin = min_f(min_f(min_f(mx, my), mz), vs);
      margin = margin > 0.0f ? margin : 0.0f;
      float cap2 = min_f(dw2, prm.tau * prm.tau);
      cap2 = __uint_as_float((__float_as_uint(cap2) | 0x3FFu) + 0x400u);
      acc[6] += sm * (cap2 >= margin * margin ? 1.0f : 0.0f);
    }
  }
}

// Fixed-order block sum of kSums values; the totals land in tot[] for all.
__device__ void block_sum(float (&acc)[kSums], float (*red)[kSums],
                          float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    float x = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xFFFFFFFFu, x, off);
    if (lane == 0) red[warp][s] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      float x = red[lane][s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xFFFFFFFFu, x, off);
      if (lane == 0) tot[s] = x;
    }
  }
  __syncthreads();
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

template <bool CHECK>
__global__ void __launch_bounds__(kThreads, 1)
    gn_solve_kernel(const float* __restrict__ params,
                    const int32_t* __restrict__ words,
                    const int32_t* __restrict__ rel,
                    const int32_t* __restrict__ bxs,
                    const int32_t* __restrict__ bys,
                    const int32_t* __restrict__ bzs,
                    const float* __restrict__ sxs,
                    const float* __restrict__ sys,
                    const float* __restrict__ szs,
                    const float* __restrict__ sms, float* __restrict__ pose_out,
                    int32_t* __restrict__ stats_out,
                    float* __restrict__ err_out, int V, int K, int N,
                    int max_it, float crit, int adaptive, float fixed_reg) {
  __shared__ float s_pose[12];
  __shared__ float s_red[kWarps][kSums];
  __shared__ float s_tot[kSums];
  __shared__ int s_continue;

  Params prm;
  prm.tau = params[12];
  prm.max_range = params[13];
  prm.vs = params[15];
  prm.step = prm.vs * (1.0f / 1024.0f);  // exact: a power-of-two scale
  const float kEps = (float)1e-30;

  if (threadIdx.x < 12) s_pose[threadIdx.x] = params[threadIdx.x];
  __syncthreads();

  float acc[kSums];
  select_pass<CHECK>(s_pose, prm, words, rel, bxs, bys, bzs, sxs, sys, szs,
                     sms, V, K, N, acc);
  block_sum(acc, s_red, s_tot);

  // Thread 0's loop state.
  float beta = 0.0f, crossed = 0.0f;
  int it = 0;
  bool conv = false;
  if (threadIdx.x == 0) {
    if (adaptive) {
      const float n0 = s_tot[0];
      const float mean = s_tot[5] / (n0 > 1.0f ? n0 : 1.0f);
      beta = n0 > 0.0f ? 1.0f / (mean + kEps) : 0.0f;
    } else {
      beta = fixed_reg;
    }
    crossed = s_tot[6];
    s_continue = max_it > 0;
  }
  __syncthreads();

  while (s_continue) {
    if (threadIdx.x == 0) {
      const float r00 = s_pose[0], r01 = s_pose[1], r02 = s_pose[2];
      const float r10 = s_pose[3], r11 = s_pose[4], r12 = s_pose[5];
      const float r20 = s_pose[6], r21 = s_pose[7], r22 = s_pose[8];
      const float t0 = s_pose[9], t1 = s_pose[10], t2 = s_pose[11];
      const float n = s_tot[0];
      float a00 = n * (r00 * r00 + r10 * r10 + r20 * r20);
      const float nsafe = n > 1.0f ? n : 1.0f;
      a00 = a00 / nsafe + beta;
      const float a01 = s_tot[1] / nsafe;
      const float a11 = s_tot[2] / nsafe;
      const float b0 = s_tot[3] / nsafe;
      const float b1 = s_tot[4] / nsafe;
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
      (void)r02;
      (void)r12;
      (void)r22;
      ++it;
      conv = sqrtf(dx0 * dx0 + dx1 * dx1) < crit;
    }
    __syncthreads();
    select_pass<CHECK>(s_pose, prm, words, rel, bxs, bys, bzs, sxs, sys, szs,
                       sms, V, K, N, acc);
    block_sum(acc, s_red, s_tot);
    if (threadIdx.x == 0) {
      // only a selection that feeds a further iteration counts
      const bool used = !conv && it < max_it;
      if (used) crossed += s_tot[6];
      s_continue = used;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const float* p = s_pose;
    const float z = 0.0f * p[9];
    pose_out[0] = p[0];
    pose_out[1] = p[1];
    pose_out[2] = p[2];
    pose_out[3] = p[9];
    pose_out[4] = p[3];
    pose_out[5] = p[4];
    pose_out[6] = p[5];
    pose_out[7] = p[10];
    pose_out[8] = p[6];
    pose_out[9] = p[7];
    pose_out[10] = p[8];
    pose_out[11] = p[11];
    pose_out[12] = z;
    pose_out[13] = z;
    pose_out[14] = z;
    pose_out[15] = 1.0f + z;
    stats_out[0] = it;
    stats_out[1] = (int32_t)s_tot[0];
    stats_out[2] = crossed > 0.0f ? 1 : 0;
    // point-space odometry error of guess^-1 @ pose (pallas_gn.py:285-299)
    const float dtx = p[9] - params[9];
    const float dty = p[10] - params[10];
    const float dtz = p[11] - params[11];
    const float dt = sqrtf(dtx * dtx + dty * dty + dtz * dtz);
    const float frob = p[0] * params[0] + p[1] * params[1] +
                       p[2] * params[2] + p[3] * params[3] +
                       p[4] * params[4] + p[5] * params[5] +
                       p[6] * params[6] + p[7] * params[7] +
                       p[8] * params[8];
    float c = (frob - 1.0f) * 0.5f;
    c = c < -1.0f ? -1.0f : (c > 1.0f ? 1.0f : c);
    const float h = (1.0f - c) * 0.5f;
    err_out[0] = dt + 2.0f * prm.max_range * sqrtf(h > 0.0f ? h : 0.0f);
  }
}

}  // namespace

// Launches the solve on `stream`; returns cudaGetLastError() of the launch.
extern "C" int kicp_gn_solve(const float* params, const int32_t* words,
                             const int32_t* rel, const int32_t* bx,
                             const int32_t* by, const int32_t* bz,
                             const float* sx, const float* sy, const float* sz,
                             const float* sm, float* pose_out,
                             int32_t* stats_out, float* err_out, int V, int K,
                             int N, int max_it, float crit, int adaptive,
                             float fixed_reg, int check_crossing,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (check_crossing) {
    gn_solve_kernel<true><<<1, kThreads, 0, st>>>(
        params, words, rel, bx, by, bz, sx, sy, sz, sm, pose_out, stats_out,
        err_out, V, K, N, max_it, crit, adaptive, fixed_reg);
  } else {
    gn_solve_kernel<false><<<1, kThreads, 0, st>>>(
        params, words, rel, bx, by, bz, sx, sy, sz, sm, pose_out, stats_out,
        err_out, V, K, N, max_it, crit, adaptive, fixed_reg);
  }
  return (int)cudaGetLastError();
}
