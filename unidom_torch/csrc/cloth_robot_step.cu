// Cloth robot step: n_substeps mass-spring substeps for every env (forward),
// and its vector-Jacobian product (backward).
//
// Replaces the TPU kernels of unidom_tpu/ops/pallas/cloth_kernel.py
// (build_cloth_robot_step_kernel): `fwd_kernel` (pallas_call at :331) and
// `bwd_kernel` (pallas_call at :354). Both compute what the plain PyTorch step
// computes (unidom_torch/engine/cloth.py, ClothSimulator._robot_step_plain),
// the backward its exact adjoint, written by hand.
//
// Forward design. One thread block of kThreads threads per env. The env's x
// and v (6*HW floats) and the per-link constants rest and valid (16*HW
// floats, the same for every env, made once on the host) are staged in shared
// memory; at HW = 512 that is 44 KB, and above 48 KB the launch asks for
// dynamic shared memory. Each thread owns particles p = tid, tid + kThreads,
// ...; the block size is fixed and __launch_bounds__ caps the registers to
// fit it, so the launch is never refused for registers, and the cloth's size
// is bounded by shared memory alone (2641 bbox cells). A substep has three
// phases:
//   1. read the 8 neighbours of each own particle from shared x, sum the
//      spring forces, add gravity, ground friction and damping -> new v;
//   2. __syncthreads() (x must not change while neighbours read it);
//   3. both suction grippers, the clips and x += dt*v on own particles,
//      then __syncthreads() before the next substep reads x.
// Neighbours are (i+di, j+dj) clamped to the bbox; a clamped or off-mask
// neighbour has valid = 0, which zeroes its force exactly as the oracle's
// edge padding does. The gripper states live in registers, and every thread
// updates its own copy from the pre-update state, as the oracle does.
//
// Backward design. Also one block per env, running the same substep code.
//   1. Recompute the forward from the inputs and store every substep's input
//      (x, v: 6*HW floats; both grippers: 8) in a history buffer in device
//      memory that the caller allocates: 50 x (6*512 + 8) floats = 616 KB per
//      env at HW = 512, far more than shared memory holds.
//   2. Walk the substeps in reverse. A reversed substep reloads its input x
//      into shared memory (the spring adjoint reads the neighbours), reads
//      its own v from the history, recomputes the forces, the damped v and
//      both grippers' results for its own particles, and applies the adjoint
//      of each operation in reverse order:
//        normalize_grad on the outputs' cotangents (x and v: one norm over
//        the env's HW*3 entries each, a block reduction; the grippers: 4
//        entries each) -> gripper-position clip -> x += dt*v and the x and v
//        clips -> normalize_grad -> gripper 1 -> normalize_grad -> gripper 0
//        -> damping -> ground friction -> springs.
//      The spring adjoint sends -J^T g to the particle and +J^T g to the
//      neighbour; a neighbour can be reached by two links of one particle
//      where the bbox meets the global grid's border, so the neighbour terms
//      go through shared-memory atomicAdd into a buffer that is added after a
//      barrier (the order of at most 8 adds per particle varies run to run).
//   The cotangents of the per-substep actions, stiffness and mu are linear
//   in their terms: each thread sums its terms over all substeps, in double
//   (the stiffness terms, 8 per particle and substep, largely cancel), and
//   one block reduction at the end gives the env's values.
// Shared memory of the backward: 18*HW floats (37 KB at HW = 512). The
// per-link constants are read from device memory (they stay in L1/L2).
//
// d clip(a, lo, hi)/da is 1 inside the bounds, 1/2 at a tie with a bound and
// 0 outside, as jnp.clip (and the plain step's min(max(.))) differentiate it:
// ties happen on the main path (the reset cloth lies at y = 0, and the idle
// gripper 1 sits on the upper bound 1).
//
// What bounds it. State is read once and written once per robot step
// (24 bytes per particle each way), so both kernels are bound by arithmetic
// over the 50 substeps: per particle and substep 8 links of a square root
// and a division, plus the friction and gripper terms, with block barriers
// between phases. The backward adds the history (written once and read once
// per substep, 48 bytes per particle and substep: at B = 1024 about 1.3 GB,
// 0.4 ms at 3.35 TB/s), one more pass of forward arithmetic (the recompute
// of each reversed substep) and the adjoint arithmetic. No part is a matrix
// product: tensor cores, wgmma and TMA do not apply. The math uses IEEE
// sqrtf and division (no fast math), so the forward differs from the plain
// version only by rounding: the spring coefficient is written
// stiffness * valid * (|d| - rest) / (|d| * rest), whose difference |d| - rest
// is exact while |d| is within a factor 2 of rest (as in the plain step's
// (|d| - rest) / rest); the form 1/rest - 1/|d| would carry the rounding of
// 1/rest, the same in every substep, into the stiffness cotangent's sum.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kLinks = 8;
constexpr int kThreads = 512;  // threads per block, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 10;  // per-env sums of the backward: a0[4], a1[4], k, mu

struct Params {
  int H, W, n_sub;
  float dt, gravity, damping, small, max_v, scale;
};

// Link l is (di, dj) of LINKS in unidom_torch/engine/cloth.py:
// [[-1,0],[1,0],[0,-1],[0,1],[-1,-1],[1,-1],[-1,1],[1,1]]
__device__ __forceinline__ int link_di(int l) {
  return (l == 0 || l == 4 || l == 6) ? -1 : ((l == 1 || l == 5 || l == 7) ? 1 : 0);
}
__device__ __forceinline__ int link_dj(int l) {
  return (l == 2 || l == 4 || l == 5) ? -1 : ((l == 3 || l == 6 || l == 7) ? 1 : 0);
}

// Index of the neighbour of particle (i, j) along link l, clamped to the bbox.
__device__ __forceinline__ int neighbour(int i, int j, int l, int H, int W) {
  const int ni = min(max(i + link_di(l), 0), H - 1);
  const int nj = min(max(j + link_dj(l), 0), W - 1);
  return ni * W + nj;
}

// clip that keeps a NaN, like jnp.clip / torch.minimum(torch.maximum(...))
__device__ __forceinline__ float clip(float a, float lo, float hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// d clip(a, lo, hi) / da: 1 inside, 1/2 at a tie with a bound, 0 outside
__device__ __forceinline__ float clip_grad(float a, float lo, float hi) {
  return (a > lo && a < hi) ? 1.0f : ((a == lo || a == hi) ? 0.5f : 0.0f);
}

__device__ __forceinline__ bool in_ball(float x0, float x1, float x2, const float* ps) {
  const float d0 = x0 - ps[0], d1 = x1 - ps[1], d2 = x2 - ps[2];
  return sqrtf(d0 * d0 + d1 * d1 + d2 * d2) <= ps[3];
}

// One suction gripper on one particle: inside the ball, v *= suction and
// x += d * (1 - suction). ps = [px, py, pz, r], act = [dx, dy, dz, suction].
__device__ __forceinline__ void suction(float& x0, float& x1, float& x2, float& v0,
                                        float& v1, float& v2, const float* ps,
                                        const float* act) {
  if (in_ball(x0, x1, x2, ps)) {
    const float s = act[3];
    v0 = s * v0;
    v1 = s * v1;
    v2 = s * v2;
    x0 = x0 + act[0] * (1.0f - s);
    x1 = x1 + act[1] * (1.0f - s);
    x2 = x2 + act[2] * (1.0f - s);
  }
}

// Spring force on particle p from its 8 neighbours in sx ([3][HW]), plus
// gravity on the y component.
__device__ __forceinline__ void spring_force(const float* sx, const float* rest,
                                             const float* valid, int p, float k,
                                             const Params& pr, float f[3]) {
  const int H = pr.H, W = pr.W, HW = H * W;
  const int i = p / W, j = p - i * W;
  const float x0 = sx[p], x1 = sx[HW + p], x2 = sx[2 * HW + p];
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
#pragma unroll
  for (int l = 0; l < kLinks; ++l) {
    const int q = neighbour(i, j, l, H, W);
    const float r0 = sx[q] - x0, r1 = sx[HW + q] - x1, r2 = sx[2 * HW + q] - x2;
    float d2 = r0 * r0 + r1 * r1 + r2 * r2;
    d2 = d2 < 1e-12f ? 1e-12f : d2;
    const float cur = sqrtf(d2), rl = rest[l * HW + p];
    const float coef = k * valid[l * HW + p] * (cur - rl) / (cur * rl);
    f0 += coef * r0;
    f1 += coef * r1;
    f2 += coef * r2;
  }
  f[0] = f0;
  f[1] = f1 - pr.gravity;
  f[2] = f2;
}

// Velocity after a substep's forces: gravity on v, ground friction (dynamic
// then static) on the force f (spring + gravity), then v += f*dt and
// damping. x1 is the particle's height.
__device__ __forceinline__ void apply_forces(float x1, const float v[3], const float f[3],
                                             float m, const Params& pr, float vd[3]) {
  const float dt = pr.dt, small = pr.small;
  float f0 = f[0], f2 = f[2];
  const float f1 = f[1];
  const float v0 = v[0], v1 = v[1] - pr.gravity * dt, v2 = v[2];
  const bool on_ground = x1 <= small;
  const float muF = m * (f1 > 0.0f ? 0.0f : f1) * -1.0f;
  const float sV = sqrtf(v0 * v0 + v2 * v2 + small);
  if (on_ground && sV > small) {
    f0 = f0 + -muF * v0 / sV;
    f2 = f2 + -muF * v2 / sV;
  }
  if (on_ground && sV <= small) {
    const float sF = sqrtf(f0 * f0 + f2 * f2 + small);
    if (muF > sF) {
      f0 = 0.0f;
      f2 = 0.0f;
    } else {
      const float R = 1.0f - muF / sF;
      f0 = R * f0;
      f2 = R * f2;
    }
  }
  vd[0] = (v0 + f0 * dt) * pr.damping;
  vd[1] = (v1 + f1 * dt) * pr.damping;
  vd[2] = (v2 + f2 * dt) * pr.damping;
}

// One forward substep of the block's env on shared sx, sv ([3][HW] each).
// Starts and ends at a barrier-consistent state.
__device__ __forceinline__ void forward_substep(float* sx, float* sv, const float* rest,
                                                const float* valid, float p0[4], float p1[4],
                                                const float act0[4], const float act1[4],
                                                float k, float m, const Params& pr) {
  const int HW = pr.H * pr.W, tid = threadIdx.x, nt = blockDim.x;
  // phase 1: forces -> v
  for (int p = tid; p < HW; p += nt) {
    float f[3], vd[3];
    const float v[3] = {sv[p], sv[HW + p], sv[2 * HW + p]};
    spring_force(sx, rest, valid, p, k, pr, f);
    apply_forces(sx[HW + p], v, f, m, pr, vd);
    sv[p] = vd[0];
    sv[HW + p] = vd[1];
    sv[2 * HW + p] = vd[2];
  }
  __syncthreads();

  // phase 3: grippers, clips, advect
  const float dt = pr.dt, max_v = pr.max_v;
  for (int p = tid; p < HW; p += nt) {
    float x0 = sx[p], x1 = sx[HW + p], x2 = sx[2 * HW + p];
    float v0 = sv[p], v1 = sv[HW + p], v2 = sv[2 * HW + p];
    suction(x0, x1, x2, v0, v1, v2, p0, act0);
    suction(x0, x1, x2, v0, v1, v2, p1, act1);
    v0 = clip(v0, -max_v, max_v);
    v1 = clip(v1, -max_v, max_v);
    v2 = clip(v2, -max_v, max_v);
    sx[p] = clip(x0, 0.0f, 1.0f) + dt * v0;
    sx[HW + p] = clip(x1, 0.0f, 1.0f) + dt * v1;
    sx[2 * HW + p] = clip(x2, 0.0f, 1.0f) + dt * v2;
    sv[p] = v0;
    sv[HW + p] = v1;
    sv[2 * HW + p] = v2;
  }
  // grippers move by their action; the radius is clipped as well
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    p0[c] = clip(p0[c] + (c < 3 ? act0[c] : 0.0f), 0.0f, 1.0f);
    p1[c] = clip(p1[c] + (c < 3 ? act1[c] : 0.0f), 0.0f, 1.0f);
  }
  __syncthreads();
}

// Stage the env's x and v ((HW, 3) rows in device memory) as [3][HW] in
// shared memory.
__device__ __forceinline__ void load_soa(const float* x, const float* v, float* sx, float* sv,
                                         int HW) {
  for (int e = threadIdx.x; e < 3 * HW; e += blockDim.x) {
    const int p = e / 3, c = e - 3 * p;
    sx[c * HW + p] = x[e];
    sv[c * HW + p] = v[e];
  }
}

__device__ __forceinline__ void load_small(const float* src, float dst[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) dst[c] = src[c];
}

__global__ void __launch_bounds__(kThreads) cloth_robot_step_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,      // (B, HW, 3)
    const float* __restrict__ ps0, const float* __restrict__ ps1,  // (B, 4)
    const float* __restrict__ a0, const float* __restrict__ a1,    // (B, 4)
    const float* __restrict__ stiff, const float* __restrict__ mu,  // (B,)
    const float* __restrict__ rest, const float* __restrict__ valid,  // (8, HW)
    float* __restrict__ ox, float* __restrict__ ov,                // (B, HW, 3)
    float* __restrict__ ops0, float* __restrict__ ops1,            // (B, 4)
    Params pr) {
  extern __shared__ float smem[];
  const int HW = pr.H * pr.W;
  float* sx = smem;                // [3][HW], SoA
  float* sv = sx + 3 * HW;         // [3][HW]
  float* s_rest = sv + 3 * HW;       // [8][HW] rest length
  float* s_val = s_rest + kLinks * HW;  // [8][HW] valid

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(b) * HW * 3;

  load_soa(x + base, v + base, sx, sv, HW);
  for (int e = tid; e < kLinks * HW; e += nt) {
    s_rest[e] = rest[e];
    s_val[e] = valid[e];
  }
  float p0[4], p1[4], act0[4], act1[4];
  load_small(ps0 + b * 4, p0);
  load_small(ps1 + b * 4, p1);
  load_small(a0 + b * 4, act0);
  load_small(a1 + b * 4, act1);
  const float k = stiff[b];
  const float m = mu[b];
  __syncthreads();

  for (int t = 0; t < pr.n_sub; ++t) {
    forward_substep(sx, sv, s_rest, s_val, p0, p1, act0, act1, k, m, pr);
  }

  for (int e = tid; e < 3 * HW; e += nt) {
    const int p = e / 3, c = e - 3 * p;
    ox[base + e] = sx[c * HW + p];
    ov[base + e] = sv[c * HW + p];
  }
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ops0[b * 4 + c] = p0[c];
      ops1[b * 4 + c] = p1[c];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// nan_to_num of float32: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float q) {
  if (q != q) return 0.0f;
  return q > FLT_MAX ? FLT_MAX : (q < -FLT_MAX ? -FLT_MAX : q);
}

// normalize_grad's backward on one entry of a cotangent with norm `norm`
__device__ __forceinline__ float norm_grad(float g, float norm, float scale) {
  return nan_to_num(g / norm) / scale;
}

// normalize_grad's backward on a gripper state's cotangent (4 entries)
__device__ __forceinline__ void norm_grad4(float g[4], float scale) {
  const float n = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2] + g[3] * g[3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) g[c] = norm_grad(g[c], n, scale);
}

// Sums of `n` per-thread values over the block, the same in every thread.
// red holds n * kWarps values; consecutive calls must use different buffers
// (a call's barrier orders the previous call's reads before the next writes).
template <int n, class T>
__device__ __forceinline__ void block_sum(T val[n], T* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) val[i] += __shfl_xor_sync(0xffffffffu, val[i], o);
    if (lane == 0) red[i * kWarps + warp] = val[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < n; ++i) {
    T s = 0;
    for (int w = 0; w < n_warps; ++w) s += red[i * kWarps + w];
    val[i] = s;
  }
}

// Norms over the block from each thread's sums of squares qx and qv.
__device__ __forceinline__ void block_norms(float qx, float qv, float* red, float& nx,
                                            float& nv) {
  float q[2] = {qx, qv};
  block_sum<2, float>(q, red);
  nx = sqrtf(q[0]);
  nv = sqrtf(q[1]);
}

__global__ void __launch_bounds__(kThreads) cloth_robot_step_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,      // (B, HW, 3)
    const float* __restrict__ ps0, const float* __restrict__ ps1,  // (B, 4)
    const float* __restrict__ a0, const float* __restrict__ a1,    // (B, 4)
    const float* __restrict__ stiff, const float* __restrict__ mu,  // (B,)
    const float* __restrict__ rest, const float* __restrict__ valid,  // (8, HW)
    const float* __restrict__ gx, const float* __restrict__ gv,    // (B, HW, 3) output cotangents
    const float* __restrict__ gps0, const float* __restrict__ gps1,  // (B, 4)
    float* __restrict__ dx, float* __restrict__ dv,                // (B, HW, 3) input cotangents
    float* __restrict__ dps0, float* __restrict__ dps1,            // (B, 4)
    float* __restrict__ da0, float* __restrict__ da1,              // (B, 4)
    float* __restrict__ dk, float* __restrict__ dmu,               // (B,)
    float* __restrict__ hist,  // (B, n_sub, 6*HW + 8) scratch: each substep's input
    Params pr) {
  extern __shared__ float smem[];
  __shared__ float red[2][2 * kWarps];
  __shared__ double red_acc[kAcc * kWarps];
  const int H = pr.H, W = pr.W, HW = H * W;
  const float dt = pr.dt, max_v = pr.max_v, scale = pr.scale, small = pr.small;
  float* sx = smem;          // [3][HW] input x of the substep at hand
  float* sv = sx + 3 * HW;   // [3][HW] v in the recompute, then v's cotangent
  float* sgx = sv + 3 * HW;  // [3][HW] x's cotangent
  float* ssc = sgx + 3 * HW;  // [3][HW] spring-adjoint terms sent to neighbours
  float* sf = ssc + 3 * HW;  // [3][HW] spring force + gravity of the substep at hand
  float* svd = sf + 3 * HW;  // [3][HW] its damped v, before the grippers

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(b) * HW * 3;
  const size_t h_stride = 6 * static_cast<size_t>(HW) + 8;
  float* h_env = hist + static_cast<size_t>(b) * pr.n_sub * h_stride;

  float p0[4], p1[4], act0[4], act1[4];
  load_small(ps0 + b * 4, p0);
  load_small(ps1 + b * 4, p1);
  load_small(a0 + b * 4, act0);
  load_small(a1 + b * 4, act1);
  const float k = stiff[b];
  const float m = mu[b];
  const float s0 = act0[3], s1 = act1[3];

  // 1. recompute the forward, keeping each substep's input
  load_soa(x + base, v + base, sx, sv, HW);
  __syncthreads();
  for (int t = 0; t < pr.n_sub; ++t) {
    float* h = h_env + t * h_stride;
    // by owner: phase 1 of forward_substep overwrites sv[p] right after
    for (int p = tid; p < HW; p += nt) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        h[c * HW + p] = sx[c * HW + p];
        h[(3 + c) * HW + p] = sv[c * HW + p];
      }
    }
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        h[6 * HW + c] = p0[c];
        h[6 * HW + 4 + c] = p1[c];
      }
    }
    forward_substep(sx, sv, rest, valid, p0, p1, act0, act1, k, m, pr);
  }

  // 2. reverse sweep
  load_soa(gx + base, gv + base, sgx, sv, HW);
  for (int e = tid; e < 3 * HW; e += nt) ssc[e] = 0.0f;
  float g0[4], g1[4];  // cotangents of the gripper states
  load_small(gps0 + b * 4, g0);
  load_small(gps1 + b * 4, g1);
  // this thread's terms of da0, da1, dk, dmu, summed in double: dk gathers
  // 8 * n_sub terms per particle that largely cancel
  double acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0;
  __syncthreads();

  for (int t = pr.n_sub - 1; t >= 0; --t) {
    const float* h = h_env + t * h_stride;
    // R1: fold in the neighbour terms of the substep reversed last, load
    // this substep's x, norms of the output cotangents. Each particle's
    // entries of sgx, sv, sf, svd belong to the thread that owns it; the
    // barrier of block_norms also orders the loads of sx before the
    // neighbour reads.
    float qx = 0.0f, qv = 0.0f, nx, nv;
    for (int p = tid; p < HW; p += nt) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int e = c * HW + p;
        sgx[e] += ssc[e];
        ssc[e] = 0.0f;
        sx[e] = h[e];
        qx += sgx[e] * sgx[e];
        qv += sv[e] * sv[e];
      }
    }
    block_norms(qx, qv, red[0], nx, nv);

    // the gripper states: normalize_grad, then ps' = clip(ps + [a, 0], 0, 1)
    float pp0[4], pp1[4];
    load_small(h + 6 * HW, pp0);
    load_small(h + 6 * HW + 4, pp1);
    norm_grad4(g0, scale);
    norm_grad4(g1, scale);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float c0 = clip_grad(pp0[c] + (c < 3 ? act0[c] : 0.0f), 0.0f, 1.0f);
      const float c1 = clip_grad(pp1[c] + (c < 3 ? act1[c] : 0.0f), 0.0f, 1.0f);
      if (c < 3 && tid == 0) {  // one per-env term, counted once
        acc[c] += g0[c] * c0;
        acc[4 + c] += g1[c] * c1;
      }
      g0[c] *= c0;
      g1[c] *= c1;
    }

    // R2: recompute forces and grippers; adjoint of normalize_grad,
    // x = clip(x, 0, 1) + dt * clip(v, -max_v, max_v)
    qx = 0.0f;
    qv = 0.0f;
    for (int p = tid; p < HW; p += nt) {
      float f[3], vd[3];
      const float xp[3] = {sx[p], sx[HW + p], sx[2 * HW + p]};
      const float vp[3] = {h[3 * HW + p], h[4 * HW + p], h[5 * HW + p]};
      spring_force(sx, rest, valid, p, k, pr, f);
      apply_forces(xp[1], vp, f, m, pr, vd);
      float y[3] = {xp[0], xp[1], xp[2]}, w[3] = {vd[0], vd[1], vd[2]};
      suction(y[0], y[1], y[2], w[0], w[1], w[2], pp0, act0);
      suction(y[0], y[1], y[2], w[0], w[1], w[2], pp1, act1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int e = c * HW + p;
        sf[e] = f[c];
        svd[e] = vd[c];
        const float gxn = norm_grad(sgx[e], nx, scale);
        const float gvn = norm_grad(sv[e], nv, scale) + dt * gxn;
        sgx[e] = gxn * clip_grad(y[c], 0.0f, 1.0f);
        sv[e] = gvn * clip_grad(w[c], -max_v, max_v);
        qx += sgx[e] * sgx[e];
        qv += sv[e] * sv[e];
      }
    }
    block_norms(qx, qv, red[1], nx, nv);

    // R3: adjoint of normalize_grad and gripper 1
    qx = 0.0f;
    qv = 0.0f;
    for (int p = tid; p < HW; p += nt) {
      float y[3] = {sx[p], sx[HW + p], sx[2 * HW + p]};
      float w[3] = {svd[p], svd[HW + p], svd[2 * HW + p]};
      suction(y[0], y[1], y[2], w[0], w[1], w[2], pp0, act0);
      const bool inside = in_ball(y[0], y[1], y[2], pp1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int e = c * HW + p;
        const float gxc = norm_grad(sgx[e], nx, scale);
        const float gvc = norm_grad(sv[e], nv, scale);
        if (inside) {
          // v' = s * v, x' = x + d * (1 - s)
          acc[7] += gvc * w[c] - gxc * act1[c];
          acc[4 + c] += gxc * (1.0f - s1);
        }
        sgx[e] = gxc;
        sv[e] = inside ? s1 * gvc : gvc;
        qx += sgx[e] * sgx[e];
        qv += sv[e] * sv[e];
      }
    }
    block_norms(qx, qv, red[0], nx, nv);

    // R4: adjoint of normalize_grad, gripper 0, damping, friction, springs
    for (int p = tid; p < HW; p += nt) {
      const int i = p / W, j = p - i * W;
      const float xp[3] = {sx[p], sx[HW + p], sx[2 * HW + p]};
      const float vp[3] = {h[3 * HW + p], h[4 * HW + p], h[5 * HW + p]};
      const bool inside = in_ball(xp[0], xp[1], xp[2], pp0);
      float gx_p[3], gf[3], gv_p[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int e = c * HW + p;
        gx_p[c] = norm_grad(sgx[e], nx, scale);
        float gvc = norm_grad(sv[e], nv, scale);
        if (inside) {
          acc[3] += gvc * svd[e] - gx_p[c] * act0[c];
          acc[c] += gx_p[c] * (1.0f - s0);
          gvc = s0 * gvc;
        }
        // vd = (v - [0, g dt, 0] + f dt) * damping
        gv_p[c] = gvc * pr.damping;
        gf[c] = gv_p[c] * dt;
      }

      // ground friction: muF = mu * clip(f1, -inf, 0) * -1, on the ground
      // f0 -= muF v0 / sV (dynamic) or the static rule on (f0, f2)
      const float f0 = sf[p], f1 = sf[HW + p], f2 = sf[2 * HW + p];
      const float v0 = vp[0], v2 = vp[2];
      const bool on_ground = xp[1] <= small;
      const float min_f1 = f1 > 0.0f ? 0.0f : f1;
      const float muF = m * min_f1 * -1.0f;
      const float sV = sqrtf(v0 * v0 + v2 * v2 + small);
      float g_muF = 0.0f;
      if (on_ground && sV > small) {
        const float dot = gf[0] * v0 + gf[2] * v2;
        const float s2 = sV * sV;
        g_muF = -dot / sV;
        gv_p[0] += -muF / sV * (gf[0] - v0 * dot / s2);
        gv_p[2] += -muF / sV * (gf[2] - v2 * dot / s2);
      }
      if (on_ground && sV <= small) {
        // static friction; sV >= sqrt(small) > small, so no input reaches
        // this branch (nor does any test)
        const float sF = sqrtf(f0 * f0 + f2 * f2 + small);
        if (muF > sF) {
          gf[0] = 0.0f;
          gf[2] = 0.0f;
        } else {
          const float R = 1.0f - muF / sF;
          const float dot = gf[0] * f0 + gf[2] * f2;
          const float t3 = muF * dot / (sF * sF * sF);
          g_muF = -dot / sF;
          gf[0] = R * gf[0] + t3 * f0;
          gf[2] = R * gf[2] + t3 * f2;
        }
      }
      acc[9] += g_muF * min_f1 * -1.0f;
      gf[1] += g_muF * m * -1.0f * (f1 < 0.0f ? 1.0f : (f1 == 0.0f ? 0.5f : 0.0f));

      // springs: f += k * valid * (|d| - rest) / (|d| * rest) * d, d = x[q] - x[p],
      // |d| = sqrt(clip(d.d, 1e-12, inf))
      float own[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int l = 0; l < kLinks; ++l) {
        const float val = valid[l * HW + p];
        if (val == 0.0f) continue;
        const int q = neighbour(i, j, l, H, W);
        const float r[3] = {sx[q] - xp[0], sx[HW + q] - xp[1], sx[2 * HW + q] - xp[2]};
        const float d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
        const float cg = d2 > 1e-12f ? 1.0f : (d2 == 1e-12f ? 0.5f : 0.0f);
        const float cur = sqrtf(d2 < 1e-12f ? 1e-12f : d2), rl = rest[l * HW + p];
        const float inv = 1.0f / cur;
        const float c = val * (cur - rl) / (cur * rl);
        const float rg = r[0] * gf[0] + r[1] * gf[1] + r[2] * gf[2];
        const float t = k * val * cg * rg * inv * inv * inv;
        acc[8] += c * rg;
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          const float gr = k * c * gf[cc] + t * r[cc];
          own[cc] -= gr;
          atomicAdd(&ssc[cc * HW + q], gr);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sgx[c * HW + p] = gx_p[c] + own[c];
        sv[c * HW + p] = gv_p[c];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < 3 * HW; e += nt) {
    const int p = e / 3, c = e - 3 * p;
    dx[base + e] = sgx[c * HW + p] + ssc[c * HW + p];
    dv[base + e] = sv[c * HW + p];
  }
  block_sum<kAcc, double>(acc, red_acc);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dps0[b * 4 + c] = g0[c];
      dps1[b * 4 + c] = g1[c];
      da0[b * 4 + c] = static_cast<float>(acc[c]);
      da1[b * 4 + c] = static_cast<float>(acc[4 + c]);
    }
    dk[b] = static_cast<float>(acc[8]);
    dmu[b] = static_cast<float>(acc[9]);
  }
}

// Allows `bytes` of dynamic shared memory for `kernel` where it exceeds the
// default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernels need for a cloth of hw bbox cells.
size_t cloth_robot_step_smem_bytes(int hw) {
  return static_cast<size_t>(6 + 2 * kLinks) * hw * sizeof(float);
}
size_t cloth_robot_step_bwd_smem_bytes(int hw) {
  return static_cast<size_t>(18) * hw * sizeof(float);
}

// Launch on `stream` (a cudaStream_t) of CUDA device `device`. Each returns
// the cudaError_t of the attribute call or of the launch (0 = ok).
int cloth_robot_step_fwd(const float* x, const float* v, const float* ps0, const float* ps1,
                         const float* a0, const float* a1, const float* stiff, const float* mu,
                         const float* rest, const float* valid, float* ox, float* ov,
                         float* ops0, float* ops1, int B, int H, int W, int n_sub,
                         float dt, float gravity, float damping, float small, float max_v,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = cloth_robot_step_smem_bytes(H * W);
  err = allow_smem(cloth_robot_step_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params pr{H, W, n_sub, dt, gravity, damping, small, max_v, 0.0f};
  cloth_robot_step_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, v, ps0, ps1, a0, a1, stiff, mu, rest, valid, ox, ov, ops0, ops1, pr);
  return static_cast<int>(cudaGetLastError());
}

// hist: B * n_sub * (6*H*W + 8) floats of scratch; scale: normalize_grad's
// divisor (the cloth mask's particle count).
int cloth_robot_step_bwd(const float* x, const float* v, const float* ps0, const float* ps1,
                         const float* a0, const float* a1, const float* stiff, const float* mu,
                         const float* rest, const float* valid, const float* gx,
                         const float* gv, const float* gps0, const float* gps1, float* dx,
                         float* dv, float* dps0, float* dps1, float* da0, float* da1, float* dk,
                         float* dmu, float* hist, int B, int H, int W, int n_sub, float dt,
                         float gravity, float damping, float small, float max_v, float scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = cloth_robot_step_bwd_smem_bytes(H * W);
  err = allow_smem(cloth_robot_step_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params pr{H, W, n_sub, dt, gravity, damping, small, max_v, scale};
  cloth_robot_step_bwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, v, ps0, ps1, a0, a1, stiff, mu, rest, valid, gx, gv, gps0, gps1, dx, dv, dps0,
      dps1, da0, da1, dk, dmu, hist, pr);
  return static_cast<int>(cudaGetLastError());
}

const char* unidom_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
