// Cloth robot step: n_substeps mass-spring substeps for every env (forward),
// and its vector-Jacobian product (backward).
//
// Replaces the TPU kernels of unidom_tpu/ops/pallas/cloth_kernel.py
// (build_cloth_robot_step_kernel): `fwd_kernel` (pallas_call at :331) and
// `bwd_kernel` (pallas_call at :354). Both compute what the plain PyTorch step
// computes (unidom_torch/engine/cloth.py, ClothSimulator._robot_step_plain),
// the backward its exact adjoint, written by hand.
//
// What bounds it. State is read once and written once per robot step (24
// bytes per particle each way), so both kernels are bound by arithmetic over
// the 50 substeps: per particle and substep 8 links of a square root and a
// division, plus friction and the grippers. No part is a matrix product:
// tensor cores and wgmma do not apply. What holds a kernel back on the card is
// the chain of one env: its substeps run one after another, each ending at a
// block barrier, so the time is the number of waves of blocks times the
// length of one block's chain. The design keeps that chain short and puts
// several envs on every SM.
//
// Layout. One block of T threads per env; thread `tid` owns the particles
// p = tid + k*T, k < n_slots. Shared memory holds only what a neighbour
// reads: the positions x, as three planes of HWp = HW rounded up to 4 floats
// (the spring force reads the 8 neighbours), and in the backward the buffer
// of spring-adjoint terms sent to neighbours. Everything a particle owns (its
// v; in the backward also its x and v cotangents, its input v and force, its
// damped v, and the input v and force of the next reversed substep) lives in
// its owner's registers: the first R slots of each thread (a template
// parameter), and on a cloth with more than R*T cells the further slots in a
// private device-memory scratch laid out [slot][field][thread] (per env),
// never in shared memory. The per-link constants are not in shared memory
// either: each cell's 8 links pack into one 32-bit code (ClothSimulator.
// link_code, a nibble per link: the neighbour's offset (di+1)*4 + (dj+1)
// after the global-grid clip, or 5 for no spring), and the rest length is
// one of two floats by whether the offset is diagonal; the code of a
// register slot is read once per launch. T and R come from the wrapper
// (unidom_torch/ops/cuda/cloth_kernel.py, launch_config), which also sizes
// the shared memory and raises for a cloth beyond a block's 232,448 bytes:
// forward 24 B per cell (two x buffers), backward 36 B per cell (two x
// buffers and the neighbour terms) plus 32 B per substep (gripper states).
// On an H100, fold_cloth3's 16 x 32 cloth runs both kernels as T = 256,
// R = 2: the forward at 64 registers and 4 blocks per SM, the backward at
// 128 and 2 (chip_smoke.py's [k1-design] prints each variant's registers,
// blocks per SM and time).
//
// Forward. x is double-buffered: a substep reads every neighbour from x_old
// and fuses forces, ground friction, damping, both suction grippers, the
// clips and advection into one pass over the thread's own particles, writes
// x_new, and passes one block barrier. The gripper states live in registers,
// and every thread updates its own copy from the pre-update state, as the
// oracle does.
//
// Backward. Also one block per env, running the same substep code.
//   1. Recompute the forward from the inputs and store every substep's input
//      x and v and each particle's spring force + gravity (9*HWp floats; the
//      stride is a multiple of 16 bytes) in a history buffer in device memory
//      that the caller allocates, and both gripper states (8 floats per
//      substep) in shared memory.
//   2. Walk the substeps in reverse. The history is read ahead of its use,
//      never by a dependent load on the chain: while substep t's adjoint
//      runs, one thread has Hopper's bulk asynchronous copy (cp.async.bulk,
//      completing on that buffer's mbarrier) bring substep t-1's x into the
//      other x buffer, and each thread loads its own particles' v and force
//      of substep t-1 into registers during t's longest phase (a barrier
//      waits for a thread's loads); the last substep's x is still in shared
//      memory from the recompute. A reversed substep recomputes the damped v
//      and both grippers' results of its own particles from the stored force
//      and applies the adjoint of each operation in reverse order:
//        normalize_grad on the outputs' cotangents (x and v: one norm over
//        the env's HW*3 entries each, a block reduction) -> x += dt*v and
//        the x and v clips -> normalize_grad -> gripper 1 -> normalize_grad
//        -> gripper 0 -> damping -> ground friction -> springs.
//      The three reductions keep their places (the plain step's
//      normalize_grad calls, operator for operator); normalize_grad's two
//      divisions per entry become one per block (NormGrad). The spring
//      adjoint sends -J^T g to the particle and +J^T g to the neighbour; a
//      neighbour can be reached by two links of one particle where the bbox
//      meets the global grid's border, so the neighbour terms go through
//      shared-memory atomicAdd into a buffer that the owner folds in after a
//      barrier (the order of at most 8 adds per particle varies run to run).
//      A thread's register slots take their links together, independent
//      chains for the scheduler.
//   3. The gripper states' cotangents take nothing from the particles', so
//      their chain (normalize_grad over 4 entries, the position clip) runs
//      after the sweep, on 8 lanes.
//   The cotangents of the per-substep actions, stiffness and mu are linear
//   in their terms: each thread sums its stiffness and mu terms over all
//   substeps in double (the stiffness terms, 8 per particle and substep,
//   largely cancel), and one block reduction at the end gives the env's
//   values; the actions' terms, from the few particles in a gripper's ball,
//   go to double atomics in shared memory.
//
// d clip(a, lo, hi)/da is 1 inside the bounds, 1/2 at a tie with a bound and
// 0 outside, as jnp.clip (and the plain step's min(max(.))) differentiate it:
// ties happen on the main path (the reset cloth lies at y = 0, and the idle
// gripper 1 sits on the upper bound 1).
//
// The math uses IEEE sqrtf and division (no fast math), so the forward
// differs from the plain version only by rounding: the spring coefficient is
// written stiffness * (|d| - rest) / (|d| * rest), whose difference |d| - rest
// is exact while |d| is within a factor 2 of rest (as in the plain step's
// (|d| - rest) / rest); the form 1/rest - 1/|d| would carry the rounding of
// 1/rest, the same in every substep, into the stiffness cotangent's sum.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLinks = 8;
constexpr int kNoSpring = 5;  // a link's nibble for offset (0, 0)
constexpr unsigned kNoLinks = 0x55555555u;  // the code of a cell without springs
constexpr int kOwnFloats = 21;  // the backward's per-particle values (struct Own)
constexpr int kMaxSmem = 232448;  // shared memory one block may have

struct Params {
  int H, W, HWp, n_sub, n_slots;
  float dt, gravity, damping, small, max_v, scale, rest_axis, rest_diag;
};

// The neighbour of link l in a cell's code: false for no spring; else its
// offset in the bbox's row-major order and whether the link is diagonal.
__device__ __forceinline__ bool link(unsigned code, int l, int W, int& dq, bool& diag) {
  const int c = (code >> (4 * l)) & 15;
  if (c == kNoSpring) return false;
  const int di = (c >> 2) - 1, dj = (c & 3) - 1;
  dq = di * W + dj;
  diag = di != 0 && dj != 0;
  return true;
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

// Spring force on particle p at (x0, x1, x2) from its neighbours in sx (three
// planes of stride HWp), plus gravity on the y component.
__device__ __forceinline__ void spring_force(const float* __restrict__ sx, int p, float x0,
                                             float x1, float x2, unsigned code, float k,
                                             const Params& pr, float f[3]) {
  const int HWp = pr.HWp;
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
#pragma unroll
  for (int l = 0; l < kLinks; ++l) {
    int dq;
    bool diag;
    if (!link(code, l, pr.W, dq, diag)) continue;
    const int q = p + dq;
    const float r0 = sx[q] - x0, r1 = sx[HWp + q] - x1, r2 = sx[2 * HWp + q] - x2;
    float d2 = r0 * r0 + r1 * r1 + r2 * r2;
    d2 = d2 < 1e-12f ? 1e-12f : d2;
    const float cur = sqrtf(d2), rl = diag ? pr.rest_diag : pr.rest_axis;
    const float coef = k * (cur - rl) / (cur * rl);
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

// The per-env state every thread holds: the gripper states, the actions of
// this robot step, stiffness and mu.
struct Env {
  float p0[4], p1[4], act0[4], act1[4];
  float k, m;
};

__device__ __forceinline__ void load_small(const float* src, float dst[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) dst[c] = src[c];
}

__device__ __forceinline__ Env load_env(const float* ps0, const float* ps1, const float* a0,
                                        const float* a1, const float* stiff, const float* mu,
                                        int b) {
  Env e;
  load_small(ps0 + b * 4, e.p0);
  load_small(ps1 + b * 4, e.p1);
  load_small(a0 + b * 4, e.act0);
  load_small(a1 + b * 4, e.act1);
  e.k = stiff[b];
  e.m = mu[b];
  return e;
}

// The grippers move by their action; the radius is clipped as well.
__device__ __forceinline__ void move_grippers(Env& e) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    e.p0[c] = clip(e.p0[c] + (c < 3 ? e.act0[c] : 0.0f), 0.0f, 1.0f);
    e.p1[c] = clip(e.p1[c] + (c < 3 ? e.act1[c] : 0.0f), 0.0f, 1.0f);
  }
}

// One forward substep of particle p: reads x_old (xo), writes x_new (xn),
// updates its v in place; f receives its spring force + gravity.
__device__ __forceinline__ void forward_particle(const float* __restrict__ xo,
                                                 float* __restrict__ xn, int p, unsigned code,
                                                 float v[3], const Env& e, const Params& pr,
                                                 float f[3]) {
  const int HWp = pr.HWp;
  float x0 = xo[p], x1 = xo[HWp + p], x2 = xo[2 * HWp + p];
  float vd[3];
  spring_force(xo, p, x0, x1, x2, code, e.k, pr, f);
  apply_forces(x1, v, f, e.m, pr, vd);
  float v0 = vd[0], v1 = vd[1], v2 = vd[2];
  suction(x0, x1, x2, v0, v1, v2, e.p0, e.act0);
  suction(x0, x1, x2, v0, v1, v2, e.p1, e.act1);
  const float dt = pr.dt, max_v = pr.max_v;
  v[0] = clip(v0, -max_v, max_v);
  v[1] = clip(v1, -max_v, max_v);
  v[2] = clip(v2, -max_v, max_v);
  xn[p] = clip(x0, 0.0f, 1.0f) + dt * v[0];
  xn[HWp + p] = clip(x1, 0.0f, 1.0f) + dt * v[1];
  xn[2 * HWp + p] = clip(x2, 0.0f, 1.0f) + dt * v[2];
}

// The env's x ((HW, 3) rows in device memory) as three planes in shared memory.
__device__ __forceinline__ void load_planes(const float* __restrict__ x, float* sx, int HW,
                                            int HWp) {
  for (int e = threadIdx.x; e < 3 * HW; e += blockDim.x) {
    const int p = e / 3, c = e - 3 * p;
    sx[c * HWp + p] = x[e];
  }
}

// The values of overflow slot k (k >= R) of this thread in its scratch,
// laid out [slot][field][thread].
template <int T, class V>
__device__ __forceinline__ void load_slot(const float* scratch, int k, V& val) {
  constexpr int nf = sizeof(V) / sizeof(float);
  const float* s = scratch + static_cast<size_t>(k) * nf * T + threadIdx.x;
  float* f = reinterpret_cast<float*>(&val);
#pragma unroll
  for (int i = 0; i < nf; ++i) f[i] = s[i * T];
}
template <int T, class V>
__device__ __forceinline__ void store_slot(float* scratch, int k, const V& val) {
  constexpr int nf = sizeof(V) / sizeof(float);
  float* s = scratch + static_cast<size_t>(k) * nf * T + threadIdx.x;
  const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
  for (int i = 0; i < nf; ++i) s[i * T] = f[i];
}

// Calls body(values, p, code) for each particle p that the thread owns:
// slots k < R hold their values in `regs` (registers once unrolled), the
// further slots in `scratch`, loaded before the call and stored after it.
template <int T, int R, class V, class Body>
__device__ __forceinline__ void for_own(V (&regs)[R], const unsigned (&codes_r)[R],
                                        float* scratch, const unsigned* __restrict__ codes,
                                        int HW, int n_slots, Body&& body) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int p = tid + k * T;
    if (p < HW) body(regs[k], p, codes_r[k]);
  }
  for (int k = R; k < n_slots; ++k) {
    const int p = tid + k * T;
    if (p >= HW) break;
    V val;
    load_slot<T>(scratch, k - R, val);
    body(val, p, __ldg(codes + p));
    store_slot<T>(scratch, k - R, val);
  }
}

struct V3 {
  float v[3];
};

template <int T, int R>
__device__ __forceinline__ void load_codes(const unsigned* __restrict__ codes, int HW,
                                           unsigned (&codes_r)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int p = threadIdx.x + k * T;
    codes_r[k] = p < HW ? __ldg(codes + p) : kNoLinks;
  }
}

template <int T, int R>
__global__ void __launch_bounds__(T, 1024 / T) cloth_robot_step_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,      // (B, HW, 3)
    const float* __restrict__ ps0, const float* __restrict__ ps1,  // (B, 4)
    const float* __restrict__ a0, const float* __restrict__ a1,    // (B, 4)
    const float* __restrict__ stiff, const float* __restrict__ mu,  // (B,)
    const unsigned* __restrict__ codes,                            // (HW,) link codes
    float* __restrict__ ox, float* __restrict__ ov,                // (B, HW, 3)
    float* __restrict__ ops0, float* __restrict__ ops1,            // (B, 4)
    float* __restrict__ scratch,  // (B, n_slots - R, 3, T) values of slots >= R
    Params pr) {
  extern __shared__ __align__(16) float smem[];
  const int HW = pr.H * pr.W, HWp = pr.HWp;
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * HW * 3;
  float* scr = scratch + static_cast<size_t>(b) * (pr.n_slots > R ? pr.n_slots - R : 0) * 3 * T;

  load_planes(x + base, smem, HW, HWp);  // x_old / x_new: by substep parity
  unsigned codes_r[R];
  load_codes<T, R>(codes, HW, codes_r);
  V3 vr[R];
  for_own<T, R>(vr, codes_r, scr, codes, HW, pr.n_slots, [&](V3& o, int p, unsigned) {
#pragma unroll
    for (int c = 0; c < 3; ++c) o.v[c] = v[base + 3 * p + c];
  });
  Env e = load_env(ps0, ps1, a0, a1, stiff, mu, b);
  __syncthreads();

  for (int t = 0; t < pr.n_sub; ++t) {
    const float* xo = smem + (t & 1) * 3 * HWp;
    float* xn = smem + ((t & 1) ^ 1) * 3 * HWp;
    for_own<T, R>(vr, codes_r, scr, codes, HW, pr.n_slots, [&](V3& o, int p, unsigned code) {
      float f[3];
      forward_particle(xo, xn, p, code, o.v, e, pr, f);
    });
    move_grippers(e);
    __syncthreads();  // x_new complete before the next substep reads it
  }

  const float* xf = smem + (pr.n_sub & 1) * 3 * HWp;
  for (int i = tid; i < 3 * HW; i += T) {
    const int p = i / 3, c = i - 3 * p;
    ox[base + i] = xf[c * HWp + p];
  }
  for_own<T, R>(vr, codes_r, scr, codes, HW, pr.n_slots, [&](V3& o, int p, unsigned) {
#pragma unroll
    for (int c = 0; c < 3; ++c) ov[base + 3 * p + c] = o.v[c];
  });
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ops0[b * 4 + c] = e.p0[c];
      ops1[b * 4 + c] = e.p1[c];
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

// The same over a block's cotangent: for a norm in [1e-30, 1e30] (every
// one the chain meets but an all-zero cotangent), g * (1 / (norm * scale)),
// one division per block instead of two per entry, equal to the two
// divisions up to rounding (and g / norm lies in [-1, 1], so nan_to_num has
// nothing to do); any other norm takes the two divisions.
struct NormGrad {
  float norm, scale, inv;
  bool exact;
  __device__ __forceinline__ float operator()(float g) const {
    return exact ? norm_grad(g, norm, scale) : g * inv;
  }
};

__device__ __forceinline__ NormGrad make_norm_grad(float norm, float scale) {
  const bool exact = !(norm >= 1e-30f && norm <= 1e30f);
  return NormGrad{norm, scale, exact ? 0.0f : 1.0f / (norm * scale), exact};
}


// Sums of `n` per-thread values over the block of T threads, the same in
// every thread. red holds n * T/32 values; consecutive calls must use
// different buffers (a call's barrier orders the previous call's reads
// before the next writes).
template <int T, int n, class Tv>
__device__ __forceinline__ void block_sum(Tv val[n], Tv* red) {
  constexpr int kWarps = T / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) val[i] += __shfl_xor_sync(0xffffffffu, val[i], o);
    if (lane == 0) red[i * kWarps + warp] = val[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < n; ++i) {
    Tv s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[i * kWarps + w];
    val[i] = s;
  }
}

// normalize_grad's backward for x's and v's cotangents, from each thread's
// sums of their squares qx and qv: norms over the block.
template <int T>
__device__ __forceinline__ void block_norms(float qx, float qv, float* red, float scale,
                                            NormGrad& nx, NormGrad& nv) {
  float q[2] = {qx, qv};
  block_sum<T, 2, float>(q, red);
  nx = make_norm_grad(sqrtf(q[0]), scale);
  nv = make_norm_grad(sqrtf(q[1]), scale);
}

// The mbarrier and bulk copy of the history's x, in PTX (sm_90).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Every thread, after its last generic write to memory that a bulk copy
// reads or overwrites (the history, the x buffers), and before a block
// barrier: orders those writes before the copies.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// One thread: copy `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every thread: wait for the completion of the barrier's phase `parity`. A
// copy completes within microseconds; one that never does traps (a launch
// error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The springs' adjoint for N particles p at xp, whose forces have the
// cotangents gf: f += k * (|d| - rest) / (|d| * rest) * d, d = x[q] - x[p],
// |d| = sqrt(clip(d.d, 1e-12, inf)). Returns each particle's own terms in
// own_t, adds the neighbours' to ssc (shared-memory atomics: two links of a
// particle can reach one neighbour) and the stiffness terms to acc_k. The N
// particles' links interleave, independent chains for the scheduler; xs and
// ssc do not overlap, so the neighbours' loads need not wait for the
// atomics. One division, 1 / (|d| rest), gives both (|d| - rest) / (|d| rest)
// and 1 / |d|.
template <int N>
__device__ __forceinline__ void spring_adjoint(const float* __restrict__ xs,
                                               float* __restrict__ ssc, const int (&p)[N],
                                               const unsigned (&code)[N],
                                               const float (&xp)[N][3], const float (&gf)[N][3],
                                               float k, const Params& pr, double& acc_k,
                                               float (&own_t)[N][3]) {
  const int HWp = pr.HWp;
#pragma unroll
  for (int n = 0; n < N; ++n) own_t[n][0] = own_t[n][1] = own_t[n][2] = 0.0f;
#pragma unroll
  for (int l = 0; l < kLinks; ++l) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      int dq;
      bool diag;
      if (!link(code[n], l, pr.W, dq, diag)) continue;
      const int q = p[n] + dq;
      const float r[3] = {xs[q] - xp[n][0], xs[HWp + q] - xp[n][1], xs[2 * HWp + q] - xp[n][2]};
      const float d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      const float cg = d2 > 1e-12f ? 1.0f : (d2 == 1e-12f ? 0.5f : 0.0f);
      const float cur = sqrtf(d2 < 1e-12f ? 1e-12f : d2);
      const float rl = diag ? pr.rest_diag : pr.rest_axis;
      const float qr = 1.0f / (cur * rl);
      const float inv = rl * qr;
      const float c = (cur - rl) * qr;
      const float rg = r[0] * gf[n][0] + r[1] * gf[n][1] + r[2] * gf[n][2];
      const float tt = k * cg * rg * inv * inv * inv;
      acc_k += c * rg;
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float gr = k * c * gf[n][cc] + tt * r[cc];
        own_t[n][cc] -= gr;
        atomicAdd(&ssc[cc * HWp + q], gr);
      }
    }
  }
}

// spring_adjoint for the particles of a thread's slots: the register slots
// together, then each overflow slot. gf comes in, and own_t goes out, through
// vd and gx of struct V.
template <int T, int R, class V>
__device__ __forceinline__ void springs_of_own(const float* __restrict__ xs,
                                               float* __restrict__ ssc, V (&regs)[R],
                                               const unsigned (&codes_r)[R], float* scratch,
                                               const unsigned* __restrict__ codes, int HW,
                                               int n_slots, float k, const Params& pr,
                                               double& acc_k) {
  const int tid = threadIdx.x, HWp = pr.HWp;
  {
    int p[R];
    float xp[R][3], gf[R][3], own_t[R][3];
#pragma unroll
    for (int n = 0; n < R; ++n) {
      p[n] = min(tid + n * T, HW - 1);  // a slot beyond the cloth has no links
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xp[n][c] = xs[c * HWp + p[n]];
        gf[n][c] = regs[n].vd[c];
      }
    }
    spring_adjoint<R>(xs, ssc, p, codes_r, xp, gf, k, pr, acc_k, own_t);
#pragma unroll
    for (int n = 0; n < R; ++n)
#pragma unroll
      for (int c = 0; c < 3; ++c) regs[n].gx[c] += own_t[n][c];
  }
  for (int j = R; j < n_slots; ++j) {
    const int p1[1] = {tid + j * T};
    if (p1[0] >= HW) break;
    V val;
    load_slot<T>(scratch, j - R, val);
    const unsigned code[1] = {__ldg(codes + p1[0])};
    float xp[1][3], gf[1][3], own_t[1][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xp[0][c] = xs[c * HWp + p1[0]];
      gf[0][c] = val.vd[c];
    }
    spring_adjoint<1>(xs, ssc, p1, code, xp, gf, k, pr, acc_k, own_t);
#pragma unroll
    for (int c = 0; c < 3; ++c) val.gx[c] += own_t[0][c];
    store_slot<T>(scratch, j - R, val);
  }
}

// The backward's history keeps, per substep, the input x and v and the
// spring force + gravity of every particle (9 planes of HWp floats), so that a
// reversed substep reads the force instead of recomputing the springs.
constexpr int kHistPlanes = 9;

// What the backward keeps of one particle: its x and v cotangents (carried
// from substep to substep), and of the substep at hand its input v, its
// spring force + gravity and its damped v before the grippers, and the
// prefetched input v and force of the next reversed substep.
struct Own {
  float gx[3], gv[3], v[3], f[3], vd[3], vn[3], fn[3];
};
static_assert(sizeof(Own) == kOwnFloats * sizeof(float), "Own is packed floats");

template <int T, int R>
__global__ void __launch_bounds__(T, 512 / T) cloth_robot_step_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,      // (B, HW, 3)
    const float* __restrict__ ps0, const float* __restrict__ ps1,  // (B, 4)
    const float* __restrict__ a0, const float* __restrict__ a1,    // (B, 4)
    const float* __restrict__ stiff, const float* __restrict__ mu,  // (B,)
    const unsigned* __restrict__ codes,                            // (HW,) link codes
    const float* __restrict__ gx, const float* __restrict__ gv,    // (B, HW, 3) output cotangents
    const float* __restrict__ gps0, const float* __restrict__ gps1,  // (B, 4)
    float* __restrict__ dx, float* __restrict__ dv,                // (B, HW, 3) input cotangents
    float* __restrict__ dps0, float* __restrict__ dps1,            // (B, 4)
    float* __restrict__ da0, float* __restrict__ da1,              // (B, 4)
    float* __restrict__ dk, float* __restrict__ dmu,               // (B,)
    float* __restrict__ hist,  // (B, n_sub, kHistPlanes*HWp): each substep's x, v, force
    float* __restrict__ scratch,  // (B, n_slots - R, kOwnFloats, T)
    Params pr) {
  constexpr int kWarps = T / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][2 * kWarps];
  __shared__ double red_acc[2 * kWarps];
  __shared__ double s_act[8];  // the cotangents of both grippers' actions
  __shared__ float s_g[8];     // the cotangents of both gripper states
  __shared__ float s_a[8];     // both grippers' actions
  __shared__ uint64_t bar[2];  // completion of the copy into x buffer 0, 1
  const int HW = pr.H * pr.W, HWp = pr.HWp, n_sub = pr.n_sub;
  const float dt = pr.dt, max_v = pr.max_v, scale = pr.scale, small = pr.small;
  // x of substep t in smem + (t & 1) * 3 * HWp; then the neighbour terms
  // [3][HWp] and both gripper states per substep [n_sub][8]
  float* ssc = smem + 6 * HWp;
  float* sps = ssc + 3 * HWp;

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * HW * 3;
  const size_t h_stride = kHistPlanes * static_cast<size_t>(HWp);
  float* h_env = hist + static_cast<size_t>(b) * n_sub * h_stride;
  float* scr = scratch + static_cast<size_t>(b) * (pr.n_slots > R ? pr.n_slots - R : 0) *
                             kOwnFloats * T;

  Env e = load_env(ps0, ps1, a0, a1, stiff, mu, b);
  const float s0 = e.act0[3], s1 = e.act1[3];
  unsigned codes_r[R];
  load_codes<T, R>(codes, HW, codes_r);
  Own own[R] = {};
  auto each = [&](auto&& body) {
    for_own<T, R>(own, codes_r, scr, codes, HW, pr.n_slots, body);
  };

  // 1. recompute the forward, keeping each substep's input and force
  load_planes(x + base, smem, HW, HWp);
  each([&](Own& o, int p, unsigned) {
#pragma unroll
    for (int c = 0; c < 3; ++c) o.v[c] = v[base + 3 * p + c];
  });
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_g[c] = gps0[b * 4 + c];
      s_g[4 + c] = gps1[b * 4 + c];
      s_a[c] = e.act0[c];
      s_a[4 + c] = e.act1[c];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) s_act[c] = 0.0;
  }
  __syncthreads();
  for (int t = 0; t < n_sub; ++t) {
    const float* xo = smem + (t & 1) * 3 * HWp;
    float* xn = smem + ((t & 1) ^ 1) * 3 * HWp;
    float* h = h_env + t * h_stride;
    each([&](Own& o, int p, unsigned code) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        h[c * HWp + p] = xo[c * HWp + p];
        h[(3 + c) * HWp + p] = o.v[c];
      }
      float f[3];
      forward_particle(xo, xn, p, code, o.v, e, pr, f);
#pragma unroll
      for (int c = 0; c < 3; ++c) h[(6 + c) * HWp + p] = f[c];
    });
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sps[8 * t + c] = e.p0[c];
        sps[8 * t + 4 + c] = e.p1[c];
      }
    }
    move_grippers(e);
    if (t == n_sub - 1) fence_async_proxy();  // the history and x buffers, for the copies
    __syncthreads();
  }

  // 2. reverse sweep. Substep n_sub-1's input x is still in shared memory
  // from the recompute; its v and force come from the history.
  each([&](Own& o, int p, unsigned) {
    const float* h = h_env + (n_sub - 1) * h_stride;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o.gx[c] = gx[base + 3 * p + c];
      o.gv[c] = gv[base + 3 * p + c];
      o.vn[c] = h[(3 + c) * HWp + p];
      o.fn[c] = h[(6 + c) * HWp + p];
    }
  });
  for (int i = tid; i < 3 * HWp; i += T) ssc[i] = 0.0f;
  // this thread's terms of dk and dmu, summed in double: dk gathers 8 *
  // n_sub terms per particle that largely cancel; the action's terms (from
  // the few particles in a gripper's ball) go to s_act
  double acc_k = 0.0, acc_mu = 0.0;
  __syncthreads();

  uint32_t phases = 0;  // bit j: the parity of bar[j]'s next phase
  for (int t = n_sub - 1; t >= 0; --t) {
    const float* xs = smem + (t & 1) * 3 * HWp;
    const float* h_prev = h_env + (t > 0 ? t - 1 : 0) * h_stride;
    // the other buffer held substep t+1's x, read by nobody since the
    // barrier that ended substep t+1, before which every thread also saw
    // its barrier's last copy complete
    if (t > 0 && tid == 0) {
      bulk_copy(smem + ((t - 1) & 1) * 3 * HWp, h_prev, 12u * HWp, &bar[(t - 1) & 1]);
    }
    const float* pp0 = sps + 8 * t;
    const float* pp1 = pp0 + 4;

    // R1: fold in the neighbour terms of the substep reversed last, take
    // the v and force prefetched during the last one; norms of the output
    // cotangents.
    float qx = 0.0f, qv = 0.0f;
    NormGrad nx, nv;
    each([&](Own& o, int p, unsigned) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o.v[c] = o.vn[c];
        o.f[c] = o.fn[c];
        const int i = c * HWp + p;
        o.gx[c] += ssc[i];
        ssc[i] = 0.0f;
        qx += o.gx[c] * o.gx[c];
        qv += o.gv[c] * o.gv[c];
      }
    });
    block_norms<T>(qx, qv, red[0], scale, nx, nv);
    if (t < n_sub - 1) {  // substep t's x, copied during substep t+1
      const int j = t & 1;
      mbar_wait(&bar[j], (phases >> j) & 1u);
      phases ^= 1u << j;
    }

    // R2: the damped v and both grippers from the input and the force;
    // adjoint of normalize_grad, x = clip(x, 0, 1) + dt * clip(v, -max_v, max_v)
    qx = 0.0f;
    qv = 0.0f;
    each([&](Own& o, int p, unsigned) {
      const float xp[3] = {xs[p], xs[HWp + p], xs[2 * HWp + p]};
      apply_forces(xp[1], o.v, o.f, e.m, pr, o.vd);
      float y[3] = {xp[0], xp[1], xp[2]}, w[3] = {o.vd[0], o.vd[1], o.vd[2]};
      suction(y[0], y[1], y[2], w[0], w[1], w[2], pp0, e.act0);
      suction(y[0], y[1], y[2], w[0], w[1], w[2], pp1, e.act1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gxn = nx(o.gx[c]);
        const float gvn = nv(o.gv[c]) + dt * gxn;
        o.gx[c] = gxn * clip_grad(y[c], 0.0f, 1.0f);
        o.gv[c] = gvn * clip_grad(w[c], -max_v, max_v);
        qx += o.gx[c] * o.gx[c];
        qv += o.gv[c] * o.gv[c];
      }
    });
    block_norms<T>(qx, qv, red[1], scale, nx, nv);

    // R3: adjoint of normalize_grad and gripper 1
    qx = 0.0f;
    qv = 0.0f;
    each([&](Own& o, int p, unsigned) {
      float y[3] = {xs[p], xs[HWp + p], xs[2 * HWp + p]};
      float w[3] = {o.vd[0], o.vd[1], o.vd[2]};
      suction(y[0], y[1], y[2], w[0], w[1], w[2], pp0, e.act0);
      const bool inside = in_ball(y[0], y[1], y[2], pp1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gxc = nx(o.gx[c]);
        const float gvc = nv(o.gv[c]);
        if (inside) {
          // v' = s * v, x' = x + d * (1 - s)
          atomicAdd(&s_act[7], static_cast<double>(gvc * w[c] - gxc * e.act1[c]));
          atomicAdd(&s_act[4 + c], static_cast<double>(gxc * (1.0f - s1)));
        }
        o.gx[c] = gxc;
        o.gv[c] = inside ? s1 * gvc : gvc;
        qx += o.gx[c] * o.gx[c];
        qv += o.gv[c] * o.gv[c];
      }
    });
    block_norms<T>(qx, qv, red[0], scale, nx, nv);

    // R4: adjoint of normalize_grad, gripper 0, damping, friction, springs.
    // It is the longest phase: the prefetch of the next reversed substep's
    // v and force, issued first, completes within it (a barrier waits for
    // the loads before it).
    each([&](Own& o, int p, unsigned) {
      if (t > 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o.vn[c] = h_prev[(3 + c) * HWp + p];
          o.fn[c] = h_prev[(6 + c) * HWp + p];
        }
      }
      const float xp[3] = {xs[p], xs[HWp + p], xs[2 * HWp + p]};
      const bool inside = in_ball(xp[0], xp[1], xp[2], pp0);
      float gx_p[3], gf[3], gv_p[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gx_p[c] = nx(o.gx[c]);
        float gvc = nv(o.gv[c]);
        if (inside) {
          atomicAdd(&s_act[3], static_cast<double>(gvc * o.vd[c] - gx_p[c] * e.act0[c]));
          atomicAdd(&s_act[c], static_cast<double>(gx_p[c] * (1.0f - s0)));
          gvc = s0 * gvc;
        }
        // vd = (v - [0, g dt, 0] + f dt) * damping
        gv_p[c] = gvc * pr.damping;
        gf[c] = gv_p[c] * dt;
      }

      // ground friction: muF = mu * clip(f1, -inf, 0) * -1, on the ground
      // f0 -= muF v0 / sV (dynamic) or the static rule on (f0, f2)
      const float f0 = o.f[0], f1 = o.f[1], f2 = o.f[2];
      const float v0 = o.v[0], v2 = o.v[2];
      const bool on_ground = xp[1] <= small;
      const float min_f1 = f1 > 0.0f ? 0.0f : f1;
      const float muF = e.m * min_f1 * -1.0f;
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
          const float R_ = 1.0f - muF / sF;
          const float dot = gf[0] * f0 + gf[2] * f2;
          const float t3 = muF * dot / (sF * sF * sF);
          g_muF = -dot / sF;
          gf[0] = R_ * gf[0] + t3 * f0;
          gf[2] = R_ * gf[2] + t3 * f2;
        }
      }
      acc_mu += g_muF * min_f1 * -1.0f;
      gf[1] += g_muF * e.m * -1.0f * (f1 < 0.0f ? 1.0f : (f1 == 0.0f ? 0.5f : 0.0f));

#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o.gx[c] = gx_p[c];
        o.gv[c] = gv_p[c];
        o.vd[c] = gf[c];  // vd's last use was above: it carries gf to the springs
      }
    });
    springs_of_own<T, R>(xs, ssc, own, codes_r, scr, codes, HW, pr.n_slots, e.k, pr, acc_k);
    __syncthreads();  // the neighbour terms complete before R1 folds them
  }

  // The gripper states' cotangents take nothing from the particles' (a
  // particle's test against a ball has no derivative), so their chain runs
  // here, off the substeps' critical path: normalize_grad, then
  // ps' = clip(ps + [a, 0], 0, 1), substep by substep. Lane i of warp 0 takes
  // entry i % 4 of gripper i / 4; the per-env action terms are counted once.
  if (tid < 8) {
    const bool pos = (tid & 3) < 3;  // the radius takes no action
    float g = s_g[tid];
    double ga = 0.0;
    for (int t = n_sub - 1; t >= 0; --t) {
      float sq = g * g;
      sq += __shfl_xor_sync(0xffu, sq, 1);
      sq += __shfl_xor_sync(0xffu, sq, 2);
      g = make_norm_grad(sqrtf(sq), scale)(g);
      const float cg = clip_grad(sps[8 * t + tid] + (pos ? s_a[tid] : 0.0f), 0.0f, 1.0f);
      if (pos) ga += g * cg;
      g *= cg;
    }
    s_g[tid] = g;
    if (pos) s_act[tid] += ga;
  }
  each([&](Own& o, int p, unsigned) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dx[base + 3 * p + c] = o.gx[c] + ssc[c * HWp + p];
      dv[base + 3 * p + c] = o.gv[c];
    }
  });
  double acc[2] = {acc_k, acc_mu};
  block_sum<T, 2, double>(acc, red_acc);  // its barrier also completes s_act
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dps0[b * 4 + c] = s_g[c];
      dps1[b * 4 + c] = s_g[4 + c];
      da0[b * 4 + c] = static_cast<float>(s_act[c]);
      da1[b * 4 + c] = static_cast<float>(s_act[4 + c]);
    }
    dk[b] = static_cast<float>(acc[0]);
    dmu[b] = static_cast<float>(acc[1]);
  }
}

// Dynamic shared memory of each kernel; the wrapper's launch_config computes
// the same.
size_t fwd_smem(int HWp) { return 6 * static_cast<size_t>(HWp) * sizeof(float); }
size_t bwd_smem(int HWp, int n_sub) {
  return (9 * static_cast<size_t>(HWp) + 8 * static_cast<size_t>(n_sub)) * sizeof(float);
}

// Allows `bytes` of dynamic shared memory for `kernel`.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The instantiated (threads, register slots) variants; launch_config picks one.
#define K1_VARIANTS(X) X(256, 2) X(512, 2)

// The kernel of variant (T, R): the forward (bwd = 0) or the backward.
template <int T, int R>
const void* kernel_of(int bwd) {
  return bwd ? reinterpret_cast<const void*>(&cloth_robot_step_bwd_kernel<T, R>)
             : reinterpret_cast<const void*>(&cloth_robot_step_fwd_kernel<T, R>);
}

const void* find_kernel(int bwd, int threads, int regs) {
#define K1_FIND(T, R) \
  if (threads == T && regs == R) return kernel_of<T, R>(bwd);
  K1_VARIANTS(K1_FIND)
#undef K1_FIND
  return nullptr;
}

int hw_padded(int H, int W) { return (H * W + 3) / 4 * 4; }

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t) of CUDA device `device`, as variant
// (threads, regs) with n_slots particles per thread and smem bytes of dynamic
// shared memory. Each returns the cudaError_t of the attribute call or of
// the launch (0 = ok); cudaErrorInvalidValue for a variant that is not
// built or shared memory other than the kernel needs.
int cloth_robot_step_fwd(const float* x, const float* v, const float* ps0, const float* ps1,
                         const float* a0, const float* a1, const float* stiff, const float* mu,
                         const unsigned* codes, float* ox, float* ov, float* ops0, float* ops1,
                         float* scratch, int B, int H, int W, int n_sub, int threads, int regs,
                         int n_slots, long long smem, float dt, float gravity, float damping,
                         float small, float max_v, float rest_axis, float rest_diag, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HWp = hw_padded(H, W);
  const void* kernel = find_kernel(0, threads, regs);
  if (kernel == nullptr || static_cast<size_t>(smem) != fwd_smem(HWp) ||
      n_slots * threads < H * W)
    return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params pr{H, W, HWp, n_sub, n_slots, dt, gravity, damping, small, max_v, 0.0f,
                  rest_axis, rest_diag};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_LAUNCH(T, R)                                                                     \
  if (threads == T && regs == R)                                                            \
    cloth_robot_step_fwd_kernel<T, R><<<B, T, smem, s>>>(x, v, ps0, ps1, a0, a1, stiff, mu, \
                                                         codes, ox, ov, ops0, ops1,         \
                                                         scratch, pr);
  K1_VARIANTS(K1_LAUNCH)
#undef K1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// hist: B * n_sub * 9*HWp floats of scratch (HWp = H*W rounded up to 4), 16-byte
// aligned; scale: normalize_grad's divisor (the cloth mask's particle count).
int cloth_robot_step_bwd(const float* x, const float* v, const float* ps0, const float* ps1,
                         const float* a0, const float* a1, const float* stiff, const float* mu,
                         const unsigned* codes, const float* gx, const float* gv,
                         const float* gps0, const float* gps1, float* dx, float* dv,
                         float* dps0, float* dps1, float* da0, float* da1, float* dk,
                         float* dmu, float* hist, float* scratch, int B, int H, int W,
                         int n_sub, int threads, int regs, int n_slots, long long smem,
                         float dt, float gravity, float damping, float small, float max_v,
                         float scale, float rest_axis, float rest_diag, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HWp = hw_padded(H, W);
  const void* kernel = find_kernel(1, threads, regs);
  if (kernel == nullptr || static_cast<size_t>(smem) != bwd_smem(HWp, n_sub) ||
      n_slots * threads < H * W || n_sub < 1 || reinterpret_cast<uintptr_t>(hist) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params pr{H, W, HWp, n_sub, n_slots, dt, gravity, damping, small, max_v, scale,
                  rest_axis, rest_diag};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_LAUNCH(T, R)                                                                  \
  if (threads == T && regs == R)                                                         \
    cloth_robot_step_bwd_kernel<T, R><<<B, T, smem, s>>>(                                \
        x, v, ps0, ps1, a0, a1, stiff, mu, codes, gx, gv, gps0, gps1, dx, dv, dps0, dps1, \
        da0, da1, dk, dmu, hist, scratch, pr);
  K1_VARIANTS(K1_LAUNCH)
#undef K1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of variant (threads, regs) of the forward (bwd = 0)
// or backward kernel with smem bytes of dynamic shared memory: out[0]
// registers per thread, out[1] local memory per thread in bytes (spills and
// stack), out[2] static shared memory, out[3] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a cudaError_t.
int cloth_robot_step_kernel_info(int bwd, int threads, int regs, long long smem, int device,
                                 int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernel = find_kernel(bwd, threads, regs);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, threads, smem));
}

const char* unidom_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
