// Cloth robot step, forward: n_substeps mass-spring substeps for every env.
//
// Replaces the TPU kernel `fwd_kernel` of
// unidom_tpu/ops/pallas/cloth_kernel.py (build_cloth_robot_step_kernel), and
// computes what the plain PyTorch step computes
// (unidom_torch/engine/cloth.py, ClothSimulator._robot_step_plain).
//
// Design. One thread block per env. The env's x and v (6*HW floats) and the
// per-link constants valid/rest and valid (16*HW floats, the same for every
// env, made once on the host) are staged in shared memory; at HW = 512 that
// is 44 KB, and above 48 KB the launch asks for dynamic shared memory. Each
// thread owns particles p = tid, tid + blockDim, ..., so any cloth size
// works. A substep has three phases:
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
// What bounds it. State is read once and written once per robot step
// (24 bytes per particle each way); everything in between stays on chip, so
// the kernel is bound by arithmetic over the 50 substeps: per particle and
// substep 8 links of a square root and a division, plus the friction and
// gripper terms, with two block barriers. Tensor cores, wgmma and TMA do not
// apply. The math uses IEEE sqrtf and division (no fast math), so it differs
// from the plain version only by rounding and by the spring coefficient
// being written stiffness * (valid/rest - valid/|d|).

#include <cuda_runtime.h>

namespace {

constexpr int kLinks = 8;

// Link l is (di, dj) of LINKS in unidom_torch/engine/cloth.py:
// [[-1,0],[1,0],[0,-1],[0,1],[-1,-1],[1,-1],[-1,1],[1,1]]
__device__ __forceinline__ int link_di(int l) {
  return (l == 0 || l == 4 || l == 6) ? -1 : ((l == 1 || l == 5 || l == 7) ? 1 : 0);
}
__device__ __forceinline__ int link_dj(int l) {
  return (l == 2 || l == 4 || l == 5) ? -1 : ((l == 3 || l == 6 || l == 7) ? 1 : 0);
}

// clip that keeps a NaN, like jnp.clip / torch.minimum(torch.maximum(...))
__device__ __forceinline__ float clip(float a, float lo, float hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// One suction gripper on one particle: inside the ball, v *= suction and
// x += d * (1 - suction). ps = [px, py, pz, r], act = [dx, dy, dz, suction].
__device__ __forceinline__ void suction(float& x0, float& x1, float& x2, float& v0,
                                        float& v1, float& v2, const float* ps,
                                        const float* act) {
  const float d0 = x0 - ps[0], d1 = x1 - ps[1], d2 = x2 - ps[2];
  if (sqrtf(d0 * d0 + d1 * d1 + d2 * d2) <= ps[3]) {
    const float s = act[3];
    v0 = s * v0;
    v1 = s * v1;
    v2 = s * v2;
    x0 = x0 + act[0] * (1.0f - s);
    x1 = x1 + act[1] * (1.0f - s);
    x2 = x2 + act[2] * (1.0f - s);
  }
}

__global__ void cloth_robot_step_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ v,      // (B, HW, 3)
    const float* __restrict__ ps0, const float* __restrict__ ps1,  // (B, 4)
    const float* __restrict__ a0, const float* __restrict__ a1,    // (B, 4)
    const float* __restrict__ stiff, const float* __restrict__ mu,  // (B,)
    const float* __restrict__ inv_rest, const float* __restrict__ valid,  // (8, HW)
    float* __restrict__ ox, float* __restrict__ ov,                // (B, HW, 3)
    float* __restrict__ ops0, float* __restrict__ ops1,            // (B, 4)
    int H, int W, int n_sub, float dt, float gravity, float damping, float small,
    float max_v) {
  extern __shared__ float smem[];
  const int HW = H * W;
  float* sx = smem;                // [3][HW], SoA
  float* sv = sx + 3 * HW;         // [3][HW]
  float* s_ir = sv + 3 * HW;       // [8][HW] valid / rest
  float* s_val = s_ir + kLinks * HW;  // [8][HW] valid

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(b) * HW * 3;

  for (int e = tid; e < 3 * HW; e += nt) {
    const int p = e / 3, c = e - 3 * p;
    sx[c * HW + p] = x[base + e];
    sv[c * HW + p] = v[base + e];
  }
  for (int e = tid; e < kLinks * HW; e += nt) {
    s_ir[e] = inv_rest[e];
    s_val[e] = valid[e];
  }
  float p0[4], p1[4], act0[4], act1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    p0[c] = ps0[b * 4 + c];
    p1[c] = ps1[b * 4 + c];
    act0[c] = a0[b * 4 + c];
    act1[c] = a1[b * 4 + c];
  }
  const float k = stiff[b];
  const float m = mu[b];
  __syncthreads();

  for (int t = 0; t < n_sub; ++t) {
    // phase 1: forces -> v
    for (int p = tid; p < HW; p += nt) {
      const int i = p / W, j = p - i * W;
      const float x0 = sx[p], x1 = sx[HW + p], x2 = sx[2 * HW + p];
      float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
#pragma unroll
      for (int l = 0; l < kLinks; ++l) {
        const int ni = min(max(i + link_di(l), 0), H - 1);
        const int nj = min(max(j + link_dj(l), 0), W - 1);
        const int q = ni * W + nj;
        const float r0 = sx[q] - x0, r1 = sx[HW + q] - x1, r2 = sx[2 * HW + q] - x2;
        float d2 = r0 * r0 + r1 * r1 + r2 * r2;
        d2 = d2 < 1e-12f ? 1e-12f : d2;
        const float coef = k * (s_ir[l * HW + p] - s_val[l * HW + p] / sqrtf(d2));
        f0 += coef * r0;
        f1 += coef * r1;
        f2 += coef * r2;
      }
      f1 = f1 - gravity;

      float v0 = sv[p], v1 = sv[HW + p] - gravity * dt, v2 = sv[2 * HW + p];

      // ground friction, dynamic then static
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

      sv[p] = (v0 + f0 * dt) * damping;
      sv[HW + p] = (v1 + f1 * dt) * damping;
      sv[2 * HW + p] = (v2 + f2 * dt) * damping;
    }
    __syncthreads();

    // phase 3: grippers, clips, advect
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

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for a cloth of hw bbox cells.
size_t cloth_robot_step_smem_bytes(int hw) {
  return static_cast<size_t>(6 + 2 * kLinks) * hw * sizeof(float);
}

// Launches the kernel on `stream` (a cudaStream_t) of CUDA device `device`.
// Returns the cudaError_t of the attribute call or of the launch (0 = ok).
int cloth_robot_step_fwd(const float* x, const float* v, const float* ps0, const float* ps1,
                         const float* a0, const float* a1, const float* stiff, const float* mu,
                         const float* inv_rest, const float* valid, float* ox, float* ov,
                         float* ops0, float* ops1, int B, int H, int W, int n_sub,
                         float dt, float gravity, float damping, float small, float max_v,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hw = H * W;
  const size_t smem = cloth_robot_step_smem_bytes(hw);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cloth_robot_step_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((hw + 31) / 32) * 32;
  threads = threads > 1024 ? 1024 : threads;
  cloth_robot_step_fwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, v, ps0, ps1, a0, a1, stiff, mu, inv_rest, valid, ox, ov, ops0, ops1, H, W, n_sub,
      dt, gravity, damping, small, max_v);
  return static_cast<int>(cudaGetLastError());
}

const char* unidom_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
