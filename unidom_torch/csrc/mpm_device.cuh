// Device code shared by the MLS-MPM macro-step kernels of Hopper (sm_90a):
// K2 (mpm_step.cu, one block per env) and K3-fwd (mpm_big_step.cu, many
// blocks per env). It computes what unidom_torch/engine/mpm.py's plain
// _substep computes: the forward's arguments, the primitives' frames and
// forward kinematics (fk_rows, load_prims), the SDFs with their normals in
// jax.grad's tie conventions, the Jacobi SVD of ops/svd3.py, the materials'
// return maps and the stress (chain_fwd), the quadratic B-spline stencil
// with out-of-range nodes dropped (node_cell), the grid ops of one cell
// (grid_op), the scatter of a node's shares (one atomic each, or summed
// over a warp's lanes that share a bin first), and each particle's share of
// a substep: the clearing of its stencil, its P2G and its G2P with
// advection; then the adjoints (below).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_PRIM = 4;
constexpr int PRIM_FRAME = 12;  // position 3, rotation 4, size 3, friction, softness
// a carry (the particle state), structure of arrays: component c of particle
// p at c * P + p (K2: in a block's shared memory; K3: per env in device memory)
constexpr int N_COMP = 25;
constexpr int IX = 0, IV = 3, IC = 6, IF = 15, IJ = 24;
constexpr int ROW = 7;  // a primitive's frame: position 3, rotation 4

struct Args {
  const float *x, *v, *C, *F, *J;
  const float *mu, *lamda, *ys;
  int mu_sb, mu_sp, la_sb, la_sp, ys_sb, ys_sp;
  const float* ground_friction;
  int gf_sb;
  const float* hardness;
  const int* material;
  const float* prim_frame;  // (B, n_prim, PRIM_FRAME)
  const float* prim_vw;     // (B, n_prim, steps, 6)
  float *x_out, *v_out, *C_out, *F_out, *J_out;
  float *traj_pos, *traj_rot;  // (B, n_prim, steps + 1, 3 / 4)
  float4* grid;                // (B, cells): momentum xyz, mass
  int* mark;                   // (B, cells)
  float* hist;                 // (B, n_ckpt, N_COMP, P): the carry every K substeps, or null
  int K;                       // checkpoint stride
  int P, n_prim, steps, rx, ry, rz, n_grid, use_pc, sdf_kinds;
  float dt, dx, inv_dx, stress_c1, dx2, p_mass, gx, gy, gz;
};

struct Prim {
  float p[3], q[4];    // frame of this substep (position[f], rotation[f])
  float p1[3], q1[4];  // frame after it (position[f + 1], rotation[f + 1])
  float vstep[3];      // v[f]
  float size[3], fric, soft;
  int kind;
};

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float x) {
  return (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
}

// ---------------------------------------------------------------- quaternions

__device__ void qmul(const float* a, const float* b, float* out) {
  float o0 = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float o1 = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float o2 = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float o3 = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  float n = fmaxf(sqrtf(o0 * o0 + o1 * o1 + o2 * o2 + o3 * o3), 1e-12f);
  out[0] = o0 / n; out[1] = o1 / n; out[2] = o2 / n; out[3] = o3 / n;
}

__device__ void w2quat(const float* a, float* out) {
  float w = sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]) + 1e-12f;
  float s = sinf(w / 2.f);
  out[0] = cosf(w / 2.f);
  out[1] = (a[0] / w) * s; out[2] = (a[1] / w) * s; out[3] = (a[2] / w) * s;
}

__device__ void qinv(const float* q, float* out) {
  float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12f;
  out[0] = q[0] / n; out[1] = -q[1] / n; out[2] = -q[2] / n; out[3] = -q[3] / n;
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ void qrot(const float* q, const float* v, float* out) {
  float uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int i = 0; i < 3; ++i) out[i] = v[i] + 2.f * (q[0] * uv[i] + uuv[i]);
}

// ------------------------------------------------------------------- SDFs
// Gradients in jax.grad's conventions at kinks: abs'(0) = +1 (jax.lax.abs's
// derivative is +1 for x >= 0); maximum and clip split 1/2 and 1/2 at a tie;
// max over an axis shares equally among ties.

__device__ __forceinline__ float abs_grad(float x) { return x >= 0.f ? 1.f : -1.f; }

__device__ float sdf_box(const float* size, const float* p, float* grad) {
  float q[3], qc[3];
  for (int i = 0; i < 3; ++i) {
    q[i] = fabsf(p[i]) - size[i];
    qc[i] = fmaxf(q[i], 0.f);
  }
  float len = sqrtf(qc[0] * qc[0] + qc[1] * qc[1] + qc[2] * qc[2] + 1e-12f);
  float m = fmaxf(fmaxf(q[0], q[1]), q[2]);
  float inner = fminf(m, 0.f);
  if (grad) {
    float cnt = (q[0] == m) + (q[1] == m) + (q[2] == m);
    float c_min = (m < 0.f) ? 1.f : ((m == 0.f) ? 0.5f : 0.f);
    for (int i = 0; i < 3; ++i) {
      float tie = (q[i] == m) ? 1.f : 0.f;
      grad[i] = abs_grad(p[i]) * (qc[i] / len + c_min * tie / cnt);
    }
  }
  return len + inner;
}

__device__ float sdf_container(const float* size, const float* p, float* grad) {
  float r = size[0], h = size[1], t = size[2];
  float w = sqrtf(fmaxf(r * r - h * h, 1e-12f));
  float q0 = sqrtf(p[0] * p[0] + p[2] * p[2] + 1e-12f), q1 = p[1];
  bool cut = h * q0 < w * q1;
  float l_rim = sqrtf((q0 - w) * (q0 - w) + (q1 - h) * (q1 - h) + 1e-12f);
  float l_shell = sqrtf(q0 * q0 + q1 * q1 + 1e-12f);
  if (grad) {
    float s = abs_grad(l_shell - r);
    float g0 = cut ? (q0 - w) / l_rim : s * q0 / l_shell;
    float g1 = cut ? (q1 - h) / l_rim : s * q1 / l_shell;
    grad[0] = g0 * p[0] / q0;
    grad[1] = g1;
    grad[2] = g0 * p[2] / q0;
  }
  return cut ? l_rim - t : fabsf(l_shell - r) - t;
}

// sphere of radius size[0]; its gradient p / |p| is 0 at p = 0
__device__ float sdf_sphere(const float* size, const float* p, float* grad) {
  float len = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + 1e-12f);
  if (grad)
    for (int i = 0; i < 3; ++i) grad[i] = p[i] / len;
  return len - size[0];
}

// d max(lhs, rhs) / d lhs, as jnp.maximum and torch.maximum take it: 1,
// 1/2 at a tie, 0 (so d min(x, y) / dx = tie_half(y, x))
__device__ __forceinline__ float tie_half(float lhs, float rhs) {
  return lhs > rhs ? 1.f : (lhs == rhs ? 0.5f : 0.f);
}

// a capsule along axis A (1: the capsule, vertical; 0: the rolling pin):
// radius size[0], half-length size[1]. q = p with q[A] = p[A] less its clip
// to [-size[1], size[1]]; the gradient q / |q| with q[A]'s entry times
// 1 - clip' (clip' = 1 inside, 1/2 at a bound, 0 outside)
template <int A>
__device__ float sdf_capsule_axis(const float* size, const float* p, float* grad) {
  const float s1 = size[1];
  const float y = fmaxf(p[A], -s1);
  float q[3] = {p[0], p[1], p[2]};
  q[A] = p[A] - fminf(y, s1);
  const float len = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + 1e-12f);
  if (grad) {
    for (int i = 0; i < 3; ++i) grad[i] = q[i] / len;
    grad[A] = grad[A] * (1.f - tie_half(p[A], -s1) * tie_half(s1, y));
  }
  return len - size[0];
}

// vertical cylinder: radius size[0], half-height size[1]; d = (|p_xz| -
// size[0], |p_y| - size[1]), the distance |max(d, 0)| + min(max(d), 0)
__device__ float sdf_cylinder(const float* size, const float* p, float* grad) {
  const float lxz = sqrtf(p[0] * p[0] + p[2] * p[2] + 1e-12f);
  const float d[2] = {lxz - size[0], fabsf(p[1]) - size[1]};
  const float dc[2] = {fmaxf(d[0], 0.f), fmaxf(d[1], 0.f)};
  const float lo = sqrtf(dc[0] * dc[0] + dc[1] * dc[1] + 1e-12f);
  const float m = fmaxf(d[0], d[1]);
  if (grad) {
    const float cmin = tie_half(0.f, m), cnt = (d[0] == m) + (d[1] == m);
    float gd[2];
    for (int i = 0; i < 2; ++i)
      gd[i] = dc[i] / lo * tie_half(d[i], 0.f) + cmin * (d[i] == m ? 1.f : 0.f) / cnt;
    const float gxz = gd[0] / lxz;
    grad[0] = gxz * p[0];
    grad[1] = gd[1] * abs_grad(p[1]);
    grad[2] = gxz * p[2];
  }
  return lo + fminf(m, 0.f);
}

// torus in the xz-plane: major radius size[0], minor radius size[1]
__device__ float sdf_torus(const float* size, const float* p, float* grad) {
  const float lxz = sqrtf(p[0] * p[0] + p[2] * p[2] + 1e-12f);
  const float q0 = lxz - size[0], q1 = p[1];
  const float lq = sqrtf(q0 * q0 + q1 * q1 + 1e-12f);
  if (grad) {
    const float gxz = q0 / lq / lxz;
    grad[0] = gxz * p[0];
    grad[1] = q1 / lq;
    grad[2] = gxz * p[2];
  }
  return lq - size[1];
}

// chopsticks: the nearer of two vertical capsules at x = -size[2] and
// +size[2]; minimum's derivative 1, 1/2 at a tie (the midplane x = 0,
// where the two gradients' x-components cancel), 0
__device__ float sdf_chopsticks(const float* size, const float* p, float* grad) {
  const float pa[3] = {p[0] - size[2], p[1], p[2]}, pb[3] = {p[0] + size[2], p[1], p[2]};
  float ga[3], gb[3];
  const float ca = sdf_capsule_axis<1>(size, pa, grad ? ga : nullptr);
  const float cb = sdf_capsule_axis<1>(size, pb, grad ? gb : nullptr);
  if (grad) {
    const float wa = tie_half(cb, ca), wb = tie_half(ca, cb);
    for (int i = 0; i < 3; ++i) grad[i] = wa * ga[i] + wb * gb[i];
  }
  return fminf(ca, cb);
}

// the SDF of kind `kind` (SDF_KINDS in ops/cuda/mpm_kernel.py: 0 box,
// 1 container, 2 sphere, 3 capsule, 4 cylinder, 5 torus, 6 rolling pin,
// 7 chopsticks; Python refuses any other)
__device__ __forceinline__ float sdf_eval(int kind, const float* size, const float* p,
                                          float* grad) {
  switch (kind) {
    case 1:
      return sdf_container(size, p, grad);
    case 2:
      return sdf_sphere(size, p, grad);
    case 3:
      return sdf_capsule_axis<1>(size, p, grad);
    case 4:
      return sdf_cylinder(size, p, grad);
    case 5:
      return sdf_torus(size, p, grad);
    case 6:
      return sdf_capsule_axis<0>(size, p, grad);
    case 7:
      return sdf_chopsticks(size, p, grad);
    default:
      return sdf_box(size, p, grad);
  }
}

// ------------------------------------------------------------- 3x3 SVD
// unidom_torch/ops/svd3.py svd3_soa_fwd, operation for operation.

template <int P_, int Q_>
__device__ __forceinline__ void jacobi(float (&S)[3][3], float (&V)[3][3]) {
  float app = S[P_][P_], aqq = S[Q_][Q_], apq = S[P_][Q_];
  bool small = fabsf(apq) < 1e-30f;
  float safe_apq = small ? 1.f : apq;
  float tau = (aqq - app) / (2.f * safe_apq);
  float t = signf(tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
  if (small) t = 0.f;
  float c = 1.f / sqrtf(1.f + t * t);
  float s = t * c;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float rp = S[P_][j], rq = S[Q_][j];
    S[P_][j] = c * rp - s * rq;
    S[Q_][j] = s * rp + c * rq;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float cp = S[i][P_], cq = S[i][Q_];
    S[i][P_] = c * cp - s * cq;
    S[i][Q_] = s * cp + c * cq;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float vp = V[i][P_], vq = V[i][Q_];
    V[i][P_] = c * vp - s * vq;
    V[i][Q_] = s * vp + c * vq;
  }
}

template <int A_, int B_>
__device__ __forceinline__ void cswap(float (&sig)[3], float (&V)[3][3]) {
  if (sig[A_] < sig[B_]) {
    float t = sig[A_]; sig[A_] = sig[B_]; sig[B_] = t;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float u = V[i][A_]; V[i][A_] = V[i][B_]; V[i][B_] = u;
    }
  }
}

__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ void svd3(const float (&A)[3][3], float (&U)[3][3], float (&sig)[3],
                     float (&V)[3][3]) {
  float S[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      S[i][j] = A[0][i] * A[0][j] + A[1][i] * A[1][j] + A[2][i] * A[2][j];
      V[i][j] = (i == j) ? 1.f : 0.f;
    }
#pragma unroll 1
  for (int sweep = 0; sweep < 6; ++sweep) {
    jacobi<0, 1>(S, V);
    jacobi<0, 2>(S, V);
    jacobi<1, 2>(S, V);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) sig[i] = sqrtf(fmaxf(S[i][i], 0.f));
  cswap<0, 1>(sig, V);
  cswap<0, 2>(sig, V);
  cswap<1, 2>(sig, V);

  float AV[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) AV[i][j] = A[i][0] * V[0][j] + A[i][1] * V[1][j] + A[i][2] * V[2][j];
  float safe[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) safe[j] = sig[j] / (sig[j] * sig[j] + 1e-30f);

  float u0[3], u1[3], u2[3];
  {
    float c0[3] = {AV[0][0] * safe[0], AV[1][0] * safe[0], AV[2][0] * safe[0]};
    float n = norm3(c0);
    bool ok = n > 1e-6f;
    float ns = ok ? n : 1.f;
    u0[0] = ok ? c0[0] / ns : 1.f;
    u0[1] = ok ? c0[1] / ns : 0.f;
    u0[2] = ok ? c0[2] / ns : 0.f;
  }
  {
    float c1[3] = {AV[0][1] * safe[1], AV[1][1] * safe[1], AV[2][1] * safe[1]};
    float d = c1[0] * u0[0] + c1[1] * u0[1] + c1[2] * u0[2];
    for (int i = 0; i < 3; ++i) u1[i] = c1[i] - d * u0[i];
    float rolled[3] = {u0[2] + 0.5f, u0[0], u0[1]};
    float alt[3];
    cross3(u0, rolled, alt);
    float den = fmaxf(norm3(alt), 1e-12f);
    float n = norm3(u1);
    bool ok = n > 1e-6f;
    float ns = ok ? n : 1.f;
    for (int i = 0; i < 3; ++i) u1[i] = ok ? u1[i] / ns : alt[i] / den;
  }
  cross3(u0, u1, u2);
  float sgn = signf(u2[0] * AV[0][2] + u2[1] * AV[1][2] + u2[2] * AV[2][2]);
  if (fabsf(sgn) < 0.5f) sgn = 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[i][0] = u0[i];
    U[i][1] = u1[i];
    U[i][2] = u2[i] * sgn;
  }
}

// U diag(s) V^T
__device__ __forceinline__ void usvt(const float (&U)[3][3], const float* s,
                                     const float (&V)[3][3], float (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = U[i][0] * s[0] * V[j][0] + U[i][1] * s[1] * V[j][1] + U[i][2] * s[2] * V[j][2];
}

// ------------------------------------------------------------ B-spline stencil

struct Stencil {
  float base[3];   // floor(x inv_dx - 0.5), as floats (NaN-safe range tests)
  float w[3][3];   // w[d][o]: weight of node base + o along axis d
  float t[3][3];   // t[d][o] = base + o - x inv_dx
};

__device__ __forceinline__ void stencil(const float* x, float inv_dx, Stencil& st) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float xd = x[d] * inv_dx;
    st.base[d] = floorf(xd - 0.5f);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      float t = (st.base[d] + (float)o) - xd;
      float at = fabsf(t);
      st.t[d][o] = t;
      st.w[d][o] = at < 0.5f ? 0.75f - t * t : (at < 1.5f ? 0.5f * (1.5f - at) * (1.5f - at) : 0.f);
    }
  }
}

// flat index of node (a, b, c) of the stencil, or -1 when it lies outside the grid
__device__ __forceinline__ int node_cell(const Stencil& st, int a, int b, int c, const Args& g) {
  float i = st.base[0] + a, j = st.base[1] + b, k = st.base[2] + c;
  if (!(i >= 0.f && i < (float)g.rx && j >= 0.f && j < (float)g.ry && k >= 0.f &&
        k < (float)g.rz))
    return -1;
  return ((int)i * g.ry + (int)j) * g.rz + (int)k;
}

// ------------------------------------------------------------------ grid ops

// a node's coordinate: the float32 product of its index and dx, never fused
// into a later add, as the plain step (and unidom_tpu's) computes it
__device__ __forceinline__ float node_pos(float idx, float dx) { return __fmul_rn(idx, dx); }

// SDF collision of primitive pr with the velocity v (in place) of the grid
// node at gp: softness-weighted influence, the collider's velocity and
// Coulomb friction on the tangential part
__device__ __forceinline__ void collide_fwd(const Prim& pr, const float* gp, float* v, float dt) {
  float qi[4], rel[3], local[3];
  qinv(pr.q, qi);
  for (int d = 0; d < 3; ++d) rel[d] = gp[d] - pr.p[d];
  qrot(qi, rel, local);
  float gl[3], n[3], D[3], np[3], cv[3], in[3], vt[3];
  float dist = sdf_eval(pr.kind, pr.size, local, gl);
  float influence = fminf(expf(-dist * pr.soft), 1.f);
  float gn = sqrtf(gl[0] * gl[0] + gl[1] * gl[1] + gl[2] * gl[2] + 1e-12f);
  for (int d = 0; d < 3; ++d) n[d] = gl[d] / gn;
  qrot(pr.q, n, D);
  qrot(pr.q1, local, np);
  for (int d = 0; d < 3; ++d) {
    cv[d] = (np[d] + pr.p1[d] - gp[d]) / dt;
    in[d] = v[d] - cv[d];
  }
  float nc = in[0] * D[0] + in[1] * D[1] + in[2] * D[2];
  float ncl = fminf(nc, 0.f);
  for (int d = 0; d < 3; ++d) vt[d] = in[d] - ncl * D[d];
  float vt_dot = vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2];
  float vt_norm = sqrtf(vt_dot + 1e-12f);
  bool flag = nc < 0.f && sqrtf(vt_dot) > 1e-12f;
  float fr = fmaxf(vt_norm + nc * pr.fric, 1e-12f);
  for (int d = 0; d < 3; ++d) {
    float t = flag ? vt[d] / vt_norm * fr : vt[d];
    v[d] = cv[d] + in[d] * (1.f - influence) + t * influence;
  }
}

// the grid ops of one cell: from its momentum and mass gv to its velocity
// after them, with the mass kept in w
__device__ __forceinline__ float4 grid_op_value(int cell, float4 gv, const Prim* prims, float gf,
                                                const Args& g) {
  float v[3] = {gv.x, gv.y, gv.z};
  float m = gv.w;
  if (m > 1e-10f) {
    v[0] = v[0] / m; v[1] = v[1] / m; v[2] = v[2] / m;
  }
  v[0] = v[0] + g.dt * g.gx;
  v[1] = v[1] + g.dt * g.gy;
  v[2] = v[2] + g.dt * g.gz;

  int ci = cell / (g.ry * g.rz), cj = (cell / g.rz) % g.ry, ck = cell % g.rz;
  float idx[3] = {(float)ci, (float)cj, (float)ck};
  float gp[3] = {node_pos(idx[0], g.dx), node_pos(idx[1], g.dx), node_pos(idx[2], g.dx)};

  for (int ip = 0; ip < g.n_prim; ++ip) {
    const Prim& pr = prims[ip];
    if (g.use_pc) {
      float qi[4], rel[3], local[3];
      qinv(pr.q, qi);
      for (int d = 0; d < 3; ++d) rel[d] = gp[d] - pr.p[d];
      qrot(qi, rel, local);
      float dist = sdf_eval(pr.kind, pr.size, local, nullptr);
      if (dist < pr.size[0] * 1.5f)
        for (int d = 0; d < 3; ++d) v[d] = pr.vstep[d] / g.dt;
    } else {
      collide_fwd(pr, gp, v, g.dt);
    }
  }

  // ground friction on the bottom 3 layers, while the cell does not move up
  if (cj < 3 && v[1] <= 0.f) {
    float lin = v[1] + 1e-30f;
    float vit[3] = {v[0] - idx[0] * 1e-30f, v[1] - lin - idx[1] * 1e-30f,
                    v[2] - idx[2] * 1e-30f};
    float a = vit[0] + 1e-12f, b = vit[1] + 1e-12f, c = vit[2] + 1e-12f;
    float lit = sqrtf(a * a + b * b + c * c);
    float coef = fmaxf(1.f + gf * lin / lit, 0.f);
    v[0] = coef * (vit[0] + idx[0] * 1e-30f);
    v[1] = 0.f;
    v[2] = coef * (vit[2] + idx[2] * 1e-30f);
  }
  // walls: no outgoing velocity within 3 cells of the box (upper wall at n_grid)
  for (int d = 0; d < 3; ++d) {
    if ((idx[d] < 3.f && v[d] < 0.f) || (idx[d] > (float)(g.n_grid - 3) && v[d] > 0.f))
      v[d] = 0.f;
  }
  return make_float4(v[0], v[1], v[2], m);
}

// the grid ops of one cell in place; pre, when not null, keeps its momentum
// and mass before them
__device__ __forceinline__ void grid_op(int cell, float4* grid, const Prim* prims, float gf,
                                        const Args& g, float4* pre) {
  float4 gv = grid[cell];
  if (pre) *pre = gv;
  grid[cell] = grid_op_value(cell, gv, prims, gf, g);
}

// ------------------------------------------------- primitive frames of a macro step
// rows[(f * n_prim + ip) * ROW + k]: position (k < 3) and rotation (k >= 3) of
// primitive ip's frame f, f = 0 .. steps, as the forward kinematics writes
// them: row 0 is the input row clipped to [-2, 2] (the first step clips the
// whole buffer), row f + 1 = (clip(p_f + v_f, -2, 2), qmul(w2quat(w_f), q_f)),
// where substep 0 reads the input row 0 before that clip. One thread.

__device__ void fk_rows(const Args& g, int b, float* rows) {
  const int np = g.n_prim;
  for (int ip = 0; ip < np; ++ip) {
    const float* fr = g.prim_frame + ((size_t)b * np + ip) * PRIM_FRAME;
    float p[3], q[4];
    float* r0 = rows + ip * ROW;
    for (int d = 0; d < 3; ++d) {
      p[d] = fr[d];
      r0[d] = clipf(fr[d], -2.f, 2.f);
    }
    for (int d = 0; d < 4; ++d) q[d] = r0[3 + d] = fr[3 + d];
    for (int f = 0; f < g.steps; ++f) {
      const float* vw = g.prim_vw + (((size_t)b * np + ip) * g.steps + f) * 6;
      float* r1 = rows + ((size_t)(f + 1) * np + ip) * ROW;
      float dq[4];
      for (int d = 0; d < 3; ++d) p[d] = r1[d] = clipf(p[d] + vw[d], -2.f, 2.f);
      w2quat(vw + 3, dq);
      qmul(dq, q, r1 + 3);
      for (int d = 0; d < 4; ++d) q[d] = r1[3 + d];
    }
  }
}

// the primitives of substep f, from the rows; one thread
__device__ void load_prims(const Args& g, int b, int f, const float* rows, Prim* prims) {
  for (int ip = 0; ip < g.n_prim; ++ip) {
    const float* fr = g.prim_frame + ((size_t)b * g.n_prim + ip) * PRIM_FRAME;
    const float* r0 = rows + ((size_t)f * g.n_prim + ip) * ROW;
    const float* r1 = r0 + g.n_prim * ROW;
    const float* vw = g.prim_vw + (((size_t)b * g.n_prim + ip) * g.steps + f) * 6;
    Prim& pr = prims[ip];
    for (int d = 0; d < 3; ++d) {
      pr.p[d] = r0[d];
      pr.p1[d] = r1[d];
      pr.vstep[d] = vw[d];
      pr.size[d] = fr[7 + d];
    }
    for (int d = 0; d < 4; ++d) {
      pr.q[d] = r0[3 + d];
      pr.q1[d] = r1[3 + d];
    }
    pr.fric = fr[10];
    pr.soft = fr[11];
    pr.kind = (g.sdf_kinds >> (4 * ip)) & 15;  // four bits per primitive
  }
}

// ------------------------------------------------------- one particle's stress
// The chain from a carry (x, v, C, F, J; component c of particle p at
// carry[c * P + p]) to the affine momentum of P2G. K2-fwd keeps Ff and aff;
// K2-bwd also keeps the SVD and the singular values in use.

struct Chain {
  float x[3], v[3], Cm[3][3], F[3][3];
  float Fn[3][3];                    // (I + dt C) F
  float U[3][3], sig[3], V[3][3];    // svd3(Fn)
  float s[3];                        // singular values of Ff
  float Ff[3][3];                    // F after the material's return map
  float Jd, mu, la, h, ys;
  int mat;
  float aff[3][3];
};

__device__ __forceinline__ void vm_project(const float* sig, float ys, float mu, float* sp) {
  float sv[3], eps[3], eh[3];
  for (int d = 0; d < 3; ++d) {
    sv[d] = fmaxf(sig[d], 0.05f);
    eps[d] = logf(sv[d]);
  }
  float mean = (eps[0] + eps[1] + eps[2]) / 3.f;
  for (int d = 0; d < 3; ++d) eh[d] = eps[d] - mean;
  float ehn = sqrtf(eh[0] * eh[0] + eh[1] * eh[1] + eh[2] * eh[2] + 1e-12f);
  float dg = ehn - ys / (2.f * mu + 1e-12f);
  float dgp = fmaxf(dg, 0.f);
  for (int d = 0; d < 3; ++d) sp[d] = dg > 0.f ? expf(eps[d] - (dgp / ehn) * eh[d]) : sv[d];
}

__device__ __forceinline__ void chain_fwd(const float* c, int P, int p, const Args& g, int b,
                                          Chain& ch) {
  for (int d = 0; d < 3; ++d) {
    ch.x[d] = c[(IX + d) * P + p];
    ch.v[d] = c[(IV + d) * P + p];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      ch.Cm[i][j] = c[(IC + 3 * i + j) * P + p];
      ch.F[i][j] = c[(IF + 3 * i + j) * P + p];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float a0 = (i == 0 ? 1.f : 0.f) + g.dt * ch.Cm[i][0];
      float a1 = (i == 1 ? 1.f : 0.f) + g.dt * ch.Cm[i][1];
      float a2 = (i == 2 ? 1.f : 0.f) + g.dt * ch.Cm[i][2];
      ch.Fn[i][j] = a0 * ch.F[0][j] + a1 * ch.F[1][j] + a2 * ch.F[2][j];
    }
  ch.mat = g.material[p];
  ch.h = clipf(g.hardness[p], 0.1f, 5.f);
  ch.mu = g.mu[(size_t)b * g.mu_sb + (size_t)p * g.mu_sp] * ch.h;
  ch.la = g.lamda[(size_t)b * g.la_sb + (size_t)p * g.la_sp] * ch.h;
  if (ch.mat == 0) {
    ch.mu = 0.f;
    ch.la = 1.f;
  }
  svd3(ch.Fn, ch.U, ch.sig, ch.V);
  for (int d = 0; d < 3; ++d) ch.s[d] = ch.sig[d];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) ch.Ff[i][j] = ch.Fn[i][j];
  if (ch.mat == 2) {
    for (int d = 0; d < 3; ++d) ch.s[d] = clipf(ch.sig[d], 1.f - 2.5e-2f * 10.f, 1.f + 4.5e-3f * 100.f);
    usvt(ch.U, ch.s, ch.V, ch.Ff);
  }
  ch.Jd = ch.s[0] * ch.s[1] * ch.s[2];
  ch.ys = 0.f;
  if (ch.mat == 3) {
    ch.ys = g.ys[(size_t)b * g.ys_sb + (size_t)p * g.ys_sp];
    vm_project(ch.sig, ch.ys, ch.mu, ch.s);
    usvt(ch.U, ch.s, ch.V, ch.Ff);
  }
  // fixed-corotated stress: 2 mu (F - R) F^T + la J (J - 1) I, R = U V^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = 0.f;
      for (int k = 0; k < 3; ++k) {
        float Rik = ch.U[i][0] * ch.V[k][0] + ch.U[i][1] * ch.V[k][1] + ch.U[i][2] * ch.V[k][2];
        s += 2.f * ch.mu * (ch.Ff[i][k] - Rik) * ch.Ff[j][k];
      }
      if (i == j) s += ch.la * ch.Jd * (ch.Jd - 1.f);
      ch.aff[i][j] = g.stress_c1 * s / g.dx2 + g.p_mass * ch.Cm[i][j];
    }
}

// ------------------------------------------------------- P2G's accumulators
// K2 and K3's rollout add P2G's momentum and mass into a float4 per cell; K3
// with a gradient into four doubles per cell (GridAcc), so that the sum does
// not depend on the order of the atomics at float32's precision (K3-bwd then
// recomputes the grid that the forward saw).

struct alignas(32) GridAcc {
  double m[4];  // momentum xyz, mass
};

// the type a scatter into G sums in
template <class G>
struct SumOf {
  using T = float;
};
template <>
struct SumOf<GridAcc> {
  using T = double;
};

__device__ __forceinline__ void grid_zero(float4* grid, int cell) {
  grid[cell] = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void grid_zero(GridAcc* grid, int cell) {
  for (int k = 0; k < 4; ++k) grid[cell].m[k] = 0.0;
}
__device__ __forceinline__ void grid_add(float4* grid, int cell, int k, float v) {
  atomicAdd((float*)(grid + cell) + k, v);
}
__device__ __forceinline__ void grid_add(GridAcc* grid, int cell, int k, double v) {
  atomicAdd(grid[cell].m + k, v);
}
__device__ __forceinline__ float4 grid_load(const float4* grid, int cell) { return grid[cell]; }
__device__ __forceinline__ float4 grid_load(const GridAcc* grid, int cell) {
  const double* m = grid[cell].m;
  return make_float4((float)m[0], (float)m[1], (float)m[2], (float)m[3]);
}

// ---------------------------------------------------- the scatter of one node
// P2G and G2P's adjoint hand each stencil node's share of a particle to a
// scatter: node(cell, 4 values) adds momentum xyz and mass and marks the
// cell (the first mark appends it to the touched list), node3(cell, 3
// values) adds a cotangent of momentum. cell < 0 is a node outside the grid,
// whose values are 0. Every lane of a warp calls them for every node.
//
// AtomicScatter adds each particle's share of a momentum cotangent by an
// atomic (K2's G2P adjoint).
// WarpScatter sums over runs of a warp's consecutive lanes whose particles
// share a bin (the stencil's base node, bin_key): such lanes share all 27
// nodes, so each node's shares are summed over the run by a segmented
// reduction of shuffles, and the run's first lane adds the sums by one
// atomic each, into G's sums: in double for GridAcc (K3 with a gradient: the
// result then does not depend on the order at float32's precision), in
// float for the float4 grid (K2; K3's rollout). K3 sorts the particles by
// bin, so that a bin is one run; K2 takes them in their own order, where
// neighbours along a rope or a box's rows mostly share a bin.

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int DEAD_KEY = -2;  // a lane without a particle

// The bin of a stencil: its base node (i, j, k), each in [-2, r - 1] (else
// no node of the stencil lies in the grid and the bin is the last one,
// n_bins(g) - 1), numbered over (rx + 2) x (ry + 2) x (rz + 2).
__device__ __forceinline__ int n_bins(const Args& g) {
  return (g.rx + 2) * (g.ry + 2) * (g.rz + 2) + 1;
}
__device__ __forceinline__ int bin_key(const Stencil& st, const Args& g) {
  const float i = st.base[0], j = st.base[1], k = st.base[2];
  if (!(i >= -2.f && i < (float)g.rx && j >= -2.f && j < (float)g.ry && k >= -2.f &&
        k < (float)g.rz))
    return n_bins(g) - 1;
  return (((int)i + 2) * (g.ry + 2) + ((int)j + 2)) * (g.rz + 2) + ((int)k + 2);
}

struct AtomicScatter {
  float4* grid;
  __device__ __forceinline__ void begin(const Stencil&, const Args&, bool) {}
  __device__ __forceinline__ void node3(int cell, const float (&v)[3]) {
    if (cell < 0) return;
    for (int k = 0; k < 3; ++k) grid_add(grid, cell, k, v[k]);
  }
};

template <class G>
struct WarpScatter {
  using T = typename SumOf<G>::T;
  G* grid;
  int* mark;  // null: no marks (G2P's adjoint)
  int* touched;
  int* n_touched;
  unsigned same;  // bit s: lane + 2^s lies in this lane's run
  bool head;      // the run's first lane
  __device__ __forceinline__ void begin(const Stencil& st, const Args& g, bool live) {
    const int key = live ? bin_key(st, g) : DEAD_KEY;
    const int lane = threadIdx.x & 31;
    // every lane shuffles and votes, before any lane-dependent branch
    const int next = __shfl_down_sync(FULL_MASK, key, 1);
    const int up = __shfl_up_sync(FULL_MASK, key, 1);
    // bit j: lane j is the last of its run; this run's last lane
    const unsigned last = __ballot_sync(FULL_MASK, lane == 31 || next != key);
    const int end = __ffs(last & (FULL_MASK << lane)) - 1;
    same = 0;
#pragma unroll
    for (int s = 0; s < 5; ++s)
      if (lane + (1 << s) <= end) same |= 1u << s;
    head = lane == 0 || up != key;
  }
  // each lane's values become the sum over its own and the later lanes of
  // its run; the head's, the run's sum
  template <int N>
  __device__ __forceinline__ void reduce(T (&v)[N]) const {
#pragma unroll
    for (int s = 0; s < 5; ++s)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const T o = __shfl_down_sync(FULL_MASK, v[k], 1 << s);
        if (same & (1u << s)) v[k] += o;
      }
  }
  __device__ __forceinline__ void node(int cell, const float (&v)[4]) {
    T d[4] = {v[0], v[1], v[2], v[3]};
    reduce(d);
    if (!head || cell < 0) return;
    for (int k = 0; k < 4; ++k) grid_add(grid, cell, k, d[k]);
    if (atomicCAS(mark + cell, 0, 1) == 0) touched[atomicAdd(n_touched, 1)] = cell;
  }
  __device__ __forceinline__ void node3(int cell, const float (&v)[3]) {
    T d[3] = {v[0], v[1], v[2]};
    reduce(d);
    if (!head || cell < 0) return;
    for (int k = 0; k < 3; ++k) grid_add(grid, cell, k, d[k]);
  }
};

// ------------------------------------------------------- one particle's phases
// A substep, particle by particle: K2 loops over a block's particles, K3 runs
// one thread per particle. Kernel launches or the caller's barriers separate
// the phases.

// zero the grid (and its cotangent) and the marks under the stencil at x
template <class G, class D>
__device__ __forceinline__ void zero_stencil(const float* x, const Args& g, G* grid, int* mark,
                                             D* dgrid) {
  Stencil st;
  stencil(x, g.inv_dx, st);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        int cell = node_cell(st, a, bb, cc, g);
        if (cell >= 0) {
          grid_zero(grid, cell);
          mark[cell] = 0;
          if (dgrid) grid_zero(dgrid, cell);
        }
      }
}

// stress and P2G of particle p of the carry c (stride P) through the scatter
// s; F_out (may be c itself) takes F after the return map when not null. A
// lane that is not live (no particle) runs the chain of particle p (any
// valid index) all the same and hands s 0 at every node: a chain behind a
// branch on `live` made K2-bwd spill (2,656 B of spill loads at its 168
// registers, K2-bwd 17% slower on whip_rope at K = 1; H100).
template <class S>
__device__ __forceinline__ void p2g_particle(const float* c, float* F_out, int P, int p,
                                             bool live, const Args& g, int b, S& s) {
  Chain ch;
  Stencil st;
  chain_fwd(c, P, p, g, b, ch);
  if (F_out && live)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) F_out[(IF + 3 * i + j) * P + p] = ch.Ff[i][j];
  stencil(ch.x, g.inv_dx, st);
  s.begin(st, g, live);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const int cell = live ? node_cell(st, a, bb, cc, g) : -1;
        float val[4] = {0.f, 0.f, 0.f, 0.f};
        if (cell >= 0) {
          float w = st.w[0][a] * st.w[1][bb] * st.w[2][cc];
          float dp[3] = {st.t[0][a] * g.dx, st.t[1][bb] * g.dx, st.t[2][cc] * g.dx};
          for (int i = 0; i < 3; ++i) {
            float mom = g.p_mass * ch.v[i] +
                        (ch.aff[i][0] * dp[0] + ch.aff[i][1] * dp[1] + ch.aff[i][2] * dp[2]);
            val[i] = w * mom;
          }
          val[3] = w * g.p_mass;
        }
        s.node(cell, val);
      }
}

// G2P at x: the new velocity and the new affine C (scaled by 4 inv_dx)
__device__ __forceinline__ void g2p_gather(const float* x, const float4* grid, const Args& g,
                                           float (&nv)[3], float (&nC)[3][3]) {
  Stencil st;
  stencil(x, g.inv_dx, st);
  for (int i = 0; i < 3; ++i) {
    nv[i] = 0.f;
    for (int j = 0; j < 3; ++j) nC[i][j] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        int cell = node_cell(st, a, bb, cc, g);
        if (cell < 0) continue;
        float w = st.w[0][a] * st.w[1][bb] * st.w[2][cc];
        float4 gv = grid[cell];
        float gg[3] = {gv.x, gv.y, gv.z};
        float t[3] = {st.t[0][a], st.t[1][bb], st.t[2][cc]};
        for (int i = 0; i < 3; ++i) {
          nv[i] += w * gg[i];
          for (int j = 0; j < 3; ++j) nC[i][j] += w * gg[i] * t[j];
        }
      }
  const float s = 4.f * g.inv_dx;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) nC[i][j] = s * nC[i][j];
}

// G2P and advection of particle p of the carry ps, in place
__device__ __forceinline__ void g2p_advect_particle(float* ps, int P, int p, const Args& g,
                                                    const float4* grid) {
  float x[3] = {ps[IX * P + p], ps[(IX + 1) * P + p], ps[(IX + 2) * P + p]};
  float nv[3], nC[3][3];
  g2p_gather(x, grid, g, nv, nC);
  for (int i = 0; i < 3; ++i) {
    ps[(IX + i) * P + p] = x[i] + g.dt * nv[i];
    ps[(IV + i) * P + p] = nv[i];
    for (int j = 0; j < 3; ++j) ps[(IC + 3 * i + j) * P + p] = nC[i][j];
  }
  ps[IJ * P + p] = ps[IJ * P + p] * (1.f + g.dt * (nC[0][0] + nC[1][1] + nC[2][2]));
}


// ================================================================= adjoints
// The macro step's adjoint, stage by stage, shared by K2-bwd (mpm_step.cu,
// one block per env) and K3-bwd (mpm_big_step.cu, many blocks per env). Each
// function differentiates what unidom_torch/engine/mpm.py's plain _substep
// computes, in the conventions of autograd on it: max, min and clip
// (ops/gradops.clip) give 1/2 to each side at a tie; torch.clamp passes the
// whole cotangent at its bound; the SDFs' abs has jax.lax.abs's derivative,
// +1 at 0 (ops/sdf.py _abs); a max over an axis gives it to the first
// maximum.

constexpr float SVD_EPS = 1e-12f;  // svd3_soa_bwd's DEFAULT_EPS

// A primitive's cotangents of one substep, per primitive at ip * NPA: its
// frame f (position, rotation), frame f + 1, the per-substep velocity
// (position control); slots from PA_SIZE on sum over the substeps.
constexpr int PA_P = 0, PA_Q = 3, PA_P1 = 7, PA_Q1 = 10, PA_VS = 14, PA_SIZE = 17,
              PA_FRIC = 20, PA_SOFT = 21, NPA = 22;
constexpr int ACC_GF = MAX_PRIM * NPA;  // the ground friction's, after the primitives'
constexpr int N_ACC = ACC_GF + 1;

// One thread's sums of the primitives' and the ground friction's cotangents
// (grid_op_bwd's acc) over the touched cells it takes, in double; flush
// sums each slot over the warp by shuffles and lane 0 adds it to out by
// one atomic, where the cells of every thread would otherwise contend for
// the same words one by one. Every lane of the warp calls flush.
struct ThreadAcc {
  double a[N_ACC];
  __device__ __forceinline__ void zero(int n_prim) {
    for (int k = 0; k < n_prim * NPA; ++k) a[k] = 0.0;
    a[ACC_GF] = 0.0;
  }
  __device__ __forceinline__ void add(int k, double v) { a[k] += v; }
  __device__ __forceinline__ void flush(int n_prim, double* out) const {
    for (int k = 0; k <= n_prim * NPA; ++k) {
      const int slot = k < n_prim * NPA ? k : ACC_GF;
      double v = a[slot];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
      if ((threadIdx.x & 31) == 0 && v != 0.0) atomicAdd(out + slot, v);
    }
  }
};

// d/dx of jnp.clip(x, lo, hi)
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  float a = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  float m = fmaxf(x, lo);
  return a * (m < hi ? 1.f : (m == hi ? 0.5f : 0.f));
}

// d/dx of max(x, lo)
__device__ __forceinline__ float max_grad(float x, float lo) {
  return x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
}

// d/dx of min(x, hi)
__device__ __forceinline__ float min_grad(float x, float hi) {
  return x < hi ? 1.f : (x == hi ? 0.5f : 0.f);
}

// derivative of the quadratic B-spline weight at t (cells)
__device__ __forceinline__ float spline_grad(float t) {
  float at = fabsf(t);
  if (at < 0.5f) return -2.f * t;
  if (at < 1.5f) return -(1.5f - at) * (t >= 0.f ? 1.f : -1.f);
  return 0.f;
}

__device__ __forceinline__ float safe_inverse(float x) { return x / (x * x + SVD_EPS); }

// C = A B (or with transposes), 3x3
__device__ __forceinline__ void mm(const float (&A)[3][3], const float (&B)[3][3],
                                   float (&C)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}
__device__ __forceinline__ void mm_tn(const float (&A)[3][3], const float (&B)[3][3],
                                      float (&C)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j];
}
__device__ __forceinline__ void mm_nt(const float (&A)[3][3], const float (&B)[3][3],
                                      float (&C)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[i][0] * B[j][0] + A[i][1] * B[j][1] + A[i][2] * B[j][2];
}

// unidom_torch/ops/svd3.py svd3_soa_bwd, term for term: dA += the adjoint of
// A = U diag(S) V^T for the cotangents (dU, dS, dV)
__device__ void svd3_bwd(const float (&U)[3][3], const float (&S)[3], const float (&V)[3][3],
                         const float (&dU)[3][3], const float (&dS)[3], const float (&dV)[3][3],
                         float (&dA)[3][3]) {
  float UtdU[3][3], VtdV[3][3], JJt[3][3], KKt[3][3], S2[3], Sinv[3];
  mm_tn(U, dU, UtdU);
  mm_tn(V, dV, VtdV);
  for (int k = 0; k < 3; ++k) {
    S2[k] = S[k] * S[k];
    Sinv[k] = safe_inverse(S[k]);
  }
  {
    float J[3][3], K[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float Fm = i == j ? 0.f : safe_inverse(S2[j] - S2[i]);
        J[i][j] = Fm * UtdU[i][j];
        K[i][j] = Fm * VtdV[i][j];
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        JJt[i][j] = J[i][j] + J[j][i];
        KKt[i][j] = K[i][j] + K[j][i];
      }
  }
  float Vh[3][3], T[3][3], T2[3][3], T3[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Vh[i][j] = V[j][i];
  // term 1: (U * dS) @ Vh
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T[i][j] = U[i][j] * dS[j];
  mm(T, Vh, T2);
  float out[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i][j] = T2[i][j];
  // term 2: U @ ((J + J^T) * S_row) @ Vh
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T[i][j] = JJt[i][j] * S[j];
  mm(T, Vh, T2);
  mm(U, T2, T3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i][j] = out[i][j] + T3[i][j];
  // term 3: (U * S) @ (K + K^T) @ Vh
  mm(KKt, Vh, T2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T[i][j] = U[i][j] * S[j];
  mm(T, T2, T3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i][j] = out[i][j] + T3[i][j];
  // term 4: (I - U U^T) @ (dU * S_inv) @ Vh
  float Pj[3][3];
  mm_nt(U, U, Pj);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Pj[i][j] = (i == j ? 1.f : 0.f) - Pj[i][j];
      T[i][j] = dU[i][j] * Sinv[j];
    }
  mm(T, Vh, T2);
  mm(Pj, T2, T3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i][j] = out[i][j] + T3[i][j];
  // term 5: (U * S_inv) @ dV^T @ (I - V V^T)
  mm_nt(V, V, Pj);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Pj[i][j] = (i == j ? 1.f : 0.f) - Pj[i][j];
      T[i][j] = dV[j][i];  // dV^T
    }
  mm(T, Pj, T2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T[i][j] = U[i][j] * Sinv[j];
  mm(T, T2, T3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) dA[i][j] += out[i][j] + T3[i][j];
}

// ------------------------------------------------------ collide's adjoint

template <class T>
__device__ __forceinline__ void cross3t(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// out = qrot(q, v) = v + 2 (w u x v + u x (u x v)), u = q[1:]: dq and dv
// take the adjoint of dout, in T
template <class T>
__device__ void qrot_bwd(const float* q, const T* v, const T* dout, T* dq, T* dv) {
  const T w = q[0];
  const T u[3] = {q[1], q[2], q[3]};
  T uv[3], ud[3], t[3], t2[3];
  cross3t(u, v, uv);
  cross3t(dout, u, t);   // dout x u
  cross3t(u, dout, ud);  // u x dout
  cross3t(u, ud, t2);    // u x (u x dout)
  for (int d = 0; d < 3; ++d) dv[d] += dout[d] + T(2) * (w * t[d] + t2[d]);
  dq[0] += T(2) * (dout[0] * uv[0] + dout[1] * uv[1] + dout[2] * uv[2]);
  T a[3], b[3], c[3];
  cross3t(v, dout, a);   // v x dout
  cross3t(uv, dout, b);  // (u x v) x dout
  cross3t(v, ud, c);     // v x (u x dout)
  for (int d = 0; d < 3; ++d) dq[1 + d] += T(2) * (w * a[d] + b[d] - c[d]);
}

// out = qinv(q) = (q0, -q1, -q2, -q3) / (|q| + 1e-12): dq takes the adjoint
// of dout, in T
template <class T>
__device__ void qinv_bwd(const float* q, const T* dout, T* dq) {
  float nrm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  T n = (T)(nrm + 1e-12f);
  T dot = dout[0] * q[0] - dout[1] * q[1] - dout[2] * q[2] - dout[3] * q[3];
  T dn = -dot / (n * n);
  dq[0] += dout[0] / n + dn * q[0] / nrm;
  for (int d = 1; d < 4; ++d) dq[d] += -dout[d] / n + dn * q[d] / nrm;
}

// The adjoint of the box SDF and its gradient (ops/sdf.py sdf_box and
// _grad_box) at the local point p: ddist is the distance's cotangent, dg the
// gradient's; dp and dsize take theirs. _grad_box's tie terms are constant;
// its qc / |qc| carries the second derivative.
__device__ void sdf_box_bwd(const float* size, const float* p, float ddist, const float* dg,
                            float* dp, float* dsize) {
  float q[3], qc[3];
  int arg = 0;
  for (int i = 0; i < 3; ++i) {
    q[i] = fabsf(p[i]) - size[i];
    qc[i] = fmaxf(q[i], 0.f);
    if (i > 0 && q[i] > q[arg]) arg = i;
  }
  float len = sqrtf(qc[0] * qc[0] + qc[1] * qc[1] + qc[2] * qc[2] + 1e-12f);
  float dgo[3], s = 0.f;
  for (int i = 0; i < 3; ++i) {
    dgo[i] = dg[i] * abs_grad(p[i]);
    s += dgo[i] * qc[i];
  }
  for (int i = 0; i < 3; ++i) {
    float dq = ddist * (i == arg && q[arg] <= 0.f ? 1.f : 0.f);
    if (q[i] >= 0.f) dq += ddist * qc[i] / len + dgo[i] / len - qc[i] * s / (len * len * len);
    dp[i] += abs_grad(p[i]) * dq;
    dsize[i] -= dq;
  }
}

// The same for the container SDF (sdf_container, _grad_container); size is
// (r, h, t).
__device__ void sdf_container_bwd(const float* size, const float* p, float ddist,
                                  const float* dg, float* dp, float* dsize) {
  const float r = size[0], h = size[1];
  const float wa = r * r - h * h;
  const float w = sqrtf(fmaxf(wa, 1e-12f));
  const float q0 = sqrtf(p[0] * p[0] + p[2] * p[2] + 1e-12f), q1 = p[1];
  const bool cut = h * q0 < w * q1;
  const float A = q0 - w, Bv = q1 - h;
  const float L = sqrtf(A * A + Bv * Bv + 1e-12f);
  const float S = sqrtf(q0 * q0 + q1 * q1 + 1e-12f);
  const float sh = abs_grad(S - r);
  const float g0 = cut ? A / L : sh * q0 / S;
  float dq0 = 0.f, dq1 = 0.f, dw = 0.f, dh = 0.f, dr = 0.f;
  float dL = 0.f, dS = 0.f;
  if (cut) {
    dL = ddist;
  } else {
    dS = ddist * sh;
    dr -= ddist * sh;
  }
  // the gradient (g0 p0 / q0, g1, g0 p2 / q0)
  const float dg0 = (dg[0] * p[0] + dg[2] * p[2]) / q0, dg1 = dg[1];
  dp[0] += dg[0] * g0 / q0;
  dp[2] += dg[2] * g0 / q0;
  dq0 -= (dg[0] * p[0] + dg[2] * p[2]) * g0 / (q0 * q0);
  if (cut) {
    float dA = dg0 / L, dB = dg1 / L;
    dL += -(dg0 * A + dg1 * Bv) / (L * L);
    dA += dL * A / L;
    dB += dL * Bv / L;
    dq0 += dA;
    dw -= dA;
    dq1 += dB;
    dh -= dB;
  } else {
    dq0 += sh * dg0 / S;
    dq1 += sh * dg1 / S;
    dS += -sh * (dg0 * q0 + dg1 * q1) / (S * S);
    dq0 += dS * q0 / S;
    dq1 += dS * q1 / S;
  }
  dp[0] += dq0 * p[0] / q0;
  dp[2] += dq0 * p[2] / q0;
  dp[1] += dq1;
  if (wa >= 1e-12f) {
    dr += dw * r / w;
    dh -= dw * h / w;
  }
  dsize[0] += dr;
  dsize[1] += dh;
  dsize[2] -= ddist;
}

// The same for the sphere SDF (sdf_sphere, _grad_sphere): the distance
// L - size[0] and the gradient p / L, L = sqrt(|p|^2 + 1e-12).
__device__ void sdf_sphere_bwd(const float* size, const float* p, float ddist, const float* dg,
                               float* dp, float* dsize) {
  const float L = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + 1e-12f);
  const float pd = p[0] * dg[0] + p[1] * dg[1] + p[2] * dg[2];
  for (int i = 0; i < 3; ++i) dp[i] += ddist * p[i] / L + (dg[i] - p[i] * pd / (L * L)) / L;
  dsize[0] -= ddist;
}

// The same for a capsule along axis A (sdf_capsule_axis; ops/sdf.py
// _capsule_q, _grad_capsule_axis): the gradient u = q / |q| with u[A] times
// the constant 1 - clip'; q[A] = p[A] - min(max(p[A], -size[1]), size[1]),
// whose max and min give 1/2 to each side at a tie.
template <int A>
__device__ void sdf_capsule_axis_bwd(const float* size, const float* p, float ddist,
                                     const float* dg, float* dp, float* dsize) {
  const float s1 = size[1];
  const float y = fmaxf(p[A], -s1);
  const float mx = tie_half(p[A], -s1), mn = tie_half(s1, y);
  float q[3] = {p[0], p[1], p[2]};
  q[A] = p[A] - fminf(y, s1);
  const float L = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + 1e-12f);
  float du[3] = {dg[0], dg[1], dg[2]};
  du[A] = du[A] * (1.f - mx * mn);
  const float s = du[0] * q[0] + du[1] * q[1] + du[2] * q[2];
  float dq[3];
  for (int i = 0; i < 3; ++i) {
    dq[i] = du[i] / L - q[i] * s / (L * L * L) + ddist * q[i] / L;
    dp[i] += dq[i];
  }
  dsize[0] -= ddist;
  const float dc = -dq[A];
  const float dy = dc * mn;
  dsize[1] += dc * (1.f - mn);  // the upper bound, size[1]
  dp[A] += dy * mx;
  dsize[1] -= dy * (1.f - mx);  // the lower bound, -size[1]
}

// The same for the cylinder (sdf_cylinder, _grad_cylinder): the gradient's
// tie factors (max's with 0, the shares of the tied maxima, min's with 0)
// are constants.
__device__ void sdf_cylinder_bwd(const float* size, const float* p, float ddist, const float* dg,
                                 float* dp, float* dsize) {
  const float lxz = sqrtf(p[0] * p[0] + p[2] * p[2] + 1e-12f);
  const float d[2] = {lxz - size[0], fabsf(p[1]) - size[1]};
  const float dc[2] = {fmaxf(d[0], 0.f), fmaxf(d[1], 0.f)};
  const float h[2] = {tie_half(d[0], 0.f), tie_half(d[1], 0.f)};
  const float lo = sqrtf(dc[0] * dc[0] + dc[1] * dc[1] + 1e-12f);
  const float m = fmaxf(d[0], d[1]);
  const float cmin = tie_half(0.f, m), cnt = (d[0] == m) + (d[1] == m);
  const float share[2] = {d[0] == m ? cmin / cnt : 0.f, d[1] == m ? cmin / cnt : 0.f};
  const float gd0 = dc[0] / lo * h[0] + share[0];
  // the gradient (gd0 / lxz p0, gd1 abs'(p1), gd0 / lxz p2)
  const float gxz = gd0 / lxz, dgxz = dg[0] * p[0] + dg[2] * p[2];
  dp[0] += dg[0] * gxz;
  dp[2] += dg[2] * gxz;
  float dlxz = -dgxz * gd0 / (lxz * lxz);
  const float dv[2] = {dgxz / lxz * h[0], dg[1] * abs_grad(p[1]) * h[1]};
  const float s = dv[0] * dc[0] + dv[1] * dc[1];
  float dd[2];
  for (int i = 0; i < 2; ++i) {
    const float ddc = dv[i] / lo - dc[i] * s / (lo * lo * lo) + ddist * dc[i] / lo;
    dd[i] = ddc * h[i] + ddist * share[i];
  }
  dlxz += dd[0];
  dsize[0] -= dd[0];
  dp[1] += dd[1] * abs_grad(p[1]);
  dsize[1] -= dd[1];
  dp[0] += dlxz * p[0] / lxz;
  dp[2] += dlxz * p[2] / lxz;
}

// The same for the torus (sdf_torus, _grad_torus).
__device__ void sdf_torus_bwd(const float* size, const float* p, float ddist, const float* dg,
                              float* dp, float* dsize) {
  const float lxz = sqrtf(p[0] * p[0] + p[2] * p[2] + 1e-12f);
  const float q[2] = {lxz - size[0], p[1]};
  const float lq = sqrtf(q[0] * q[0] + q[1] * q[1] + 1e-12f);
  const float u0 = q[0] / lq, gxz = u0 / lxz, dgxz = dg[0] * p[0] + dg[2] * p[2];
  // the gradient (u0 / lxz p0, u1, u0 / lxz p2), u = q / |q|
  dp[0] += dg[0] * gxz;
  dp[2] += dg[2] * gxz;
  float dlxz = -dgxz * u0 / (lxz * lxz);
  const float du[2] = {dgxz / lxz, dg[1]};
  const float s = du[0] * q[0] + du[1] * q[1];
  float dq[2];
  for (int i = 0; i < 2; ++i) dq[i] = du[i] / lq - q[i] * s / (lq * lq * lq) + ddist * q[i] / lq;
  dsize[1] -= ddist;
  dlxz += dq[0];
  dsize[0] -= dq[0];
  dp[1] += dq[1];
  dp[0] += dlxz * p[0] / lxz;
  dp[2] += dlxz * p[2] / lxz;
}

// The same for the chopsticks (sdf_chopsticks, _grad_chopsticks): ddist and
// dg reach each capsule through the minimum's 1, 1/2, 0; the offset size[2]
// takes the x-cotangents of the two capsules' points, p_x - size[2] and
// p_x + size[2].
__device__ void sdf_chopsticks_bwd(const float* size, const float* p, float ddist,
                                   const float* dg, float* dp, float* dsize) {
  const float pa[3] = {p[0] - size[2], p[1], p[2]}, pb[3] = {p[0] + size[2], p[1], p[2]};
  const float ca = sdf_capsule_axis<1>(size, pa, nullptr);
  const float cb = sdf_capsule_axis<1>(size, pb, nullptr);
  const float wa = tie_half(cb, ca), wb = tie_half(ca, cb);
  const float dga[3] = {dg[0] * wa, dg[1] * wa, dg[2] * wa};
  const float dgb[3] = {dg[0] * wb, dg[1] * wb, dg[2] * wb};
  float dpa[3] = {0.f, 0.f, 0.f}, dpb[3] = {0.f, 0.f, 0.f};
  sdf_capsule_axis_bwd<1>(size, pa, ddist * wa, dga, dpa, dsize);
  sdf_capsule_axis_bwd<1>(size, pb, ddist * wb, dgb, dpb, dsize);
  for (int i = 0; i < 3; ++i) dp[i] += dpa[i] + dpb[i];
  dsize[2] += dpb[0] - dpa[0];
}

// Adjoint of collide_fwd for primitive ip: v is the node's velocity before
// it, dv the cotangent of the velocity after it on entry and before it on
// exit; the primitive's cotangents go to acc.add(ip * NPA + slot, value).
// From the collider's velocity cv = (qrot(q1, local) + p1 - gp) / dt on, it
// works in double: the terms of frame f + 1 (through q1 and p1) and of frame
// f (through local = qrot(qinv(q), gp - p)) are 1/dt times the cell's
// cotangent and cancel to a small remainder once the forward kinematics'
// adjoint adds them up; in double they cancel for the inputs as given.
template <class Acc>
__device__ void collide_bwd(const Prim& pr, int ip, const float* gp, const float* v, float* dv,
                            float dt, Acc& acc) {
  float qi[4], rel[3], local[3];
  qinv(pr.q, qi);
  for (int d = 0; d < 3; ++d) rel[d] = gp[d] - pr.p[d];
  qrot(qi, rel, local);
  float gl[3], n[3], D[3], np[3], cv[3], in[3], vt[3], t[3];
  float dist = sdf_eval(pr.kind, pr.size, local, gl);
  float e = expf(-dist * pr.soft);
  float influence = fminf(e, 1.f);
  float gn = sqrtf(gl[0] * gl[0] + gl[1] * gl[1] + gl[2] * gl[2] + 1e-12f);
  for (int d = 0; d < 3; ++d) n[d] = gl[d] / gn;
  qrot(pr.q, n, D);
  qrot(pr.q1, local, np);
  for (int d = 0; d < 3; ++d) {
    cv[d] = (np[d] + pr.p1[d] - gp[d]) / dt;
    in[d] = v[d] - cv[d];
  }
  float nc = in[0] * D[0] + in[1] * D[1] + in[2] * D[2];
  float ncl = fminf(nc, 0.f);
  for (int d = 0; d < 3; ++d) vt[d] = in[d] - ncl * D[d];
  float vt_dot = vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2];
  float vt_norm = sqrtf(vt_dot + 1e-12f);
  bool flag = nc < 0.f && sqrtf(vt_dot) > 1e-12f;
  float fr_arg = vt_norm + nc * pr.fric;
  float fr = fmaxf(fr_arg, 1e-12f);
  for (int d = 0; d < 3; ++d) t[d] = flag ? vt[d] / vt_norm * fr : vt[d];

  // out = cv + in (1 - influence) + t influence
  float dcv[3], din[3], dvt[3], dD[3], dgl[3], dn[3] = {0.f, 0.f, 0.f};
  float dinfl = 0.f;
  for (int d = 0; d < 3; ++d) {
    dcv[d] = dv[d];
    din[d] = dv[d] * (1.f - influence);
    dinfl += dv[d] * (t[d] - in[d]);
  }
  float dvt_norm = 0.f, dnc = 0.f;
  if (flag) {  // t = vt / vt_norm * fr
    float s = 0.f;
    for (int d = 0; d < 3; ++d) s += dv[d] * influence * vt[d];
    for (int d = 0; d < 3; ++d) dvt[d] = dv[d] * influence * fr / vt_norm;
    dvt_norm = -s * fr / (vt_norm * vt_norm);
    float dfa = s / vt_norm * max_grad(fr_arg, 1e-12f);
    dvt_norm += dfa;
    dnc += dfa * pr.fric;
    acc.add(ip * NPA + PA_FRIC, dfa * nc);
  } else {
    for (int d = 0; d < 3; ++d) dvt[d] = dv[d] * influence;
  }
  const float dvd = dvt_norm * 0.5f / vt_norm;  // vt_norm = sqrt(vt . vt + 1e-12)
  float dncl = 0.f;
  for (int d = 0; d < 3; ++d) {
    dvt[d] += 2.f * vt[d] * dvd;
    din[d] += dvt[d];  // vt = in - ncl D
    dncl -= dvt[d] * D[d];
    dD[d] = -ncl * dvt[d];
  }
  dnc += dncl * min_grad(nc, 0.f);
  double dnp[3], dlocal[3] = {0.0, 0.0, 0.0}, dq1[4] = {0.0, 0.0, 0.0, 0.0};
  double dq[4] = {0.0, 0.0, 0.0, 0.0};
  for (int d = 0; d < 3; ++d) {  // nc = in . D; in = v - cv
    din[d] += dnc * D[d];
    dD[d] += dnc * in[d];
    dv[d] = din[d];
    dcv[d] -= din[d];
    dnp[d] = (double)dcv[d] / (double)dt;  // cv = (np + p1 - gp) / dt
    acc.add(ip * NPA + PA_P1 + d, dnp[d]);
  }
  {
    const double ld[3] = {local[0], local[1], local[2]};
    qrot_bwd<double>(pr.q1, ld, dnp, dq1, dlocal);
  }
  for (int d = 0; d < 4; ++d) acc.add(ip * NPA + PA_Q1 + d, dq1[d]);
  {  // D = qrot(q, n)
    const double nd[3] = {n[0], n[1], n[2]}, dDd[3] = {dD[0], dD[1], dD[2]};
    double dnd[3] = {0.0, 0.0, 0.0};
    qrot_bwd<double>(pr.q, nd, dDd, dq, dnd);
    for (int d = 0; d < 3; ++d) dn[d] = (float)dnd[d];
  }
  {  // n = gl / sqrt(|gl|^2 + 1e-12)
    float s = dn[0] * gl[0] + dn[1] * gl[1] + dn[2] * gl[2];
    for (int d = 0; d < 3; ++d) dgl[d] = dn[d] / gn - gl[d] * s / (gn * gn * gn);
  }
  // influence = min(exp(-dist soft), 1)
  const float de = dinfl * min_grad(e, 1.f);
  const float ddist = -de * e * pr.soft;
  acc.add(ip * NPA + PA_SOFT, -de * e * dist);
  float dsize[3] = {0.f, 0.f, 0.f}, dls[3] = {0.f, 0.f, 0.f};
  switch (pr.kind) {
    case 1:
      sdf_container_bwd(pr.size, local, ddist, dgl, dls, dsize);
      break;
    case 2:
      sdf_sphere_bwd(pr.size, local, ddist, dgl, dls, dsize);
      break;
    case 3:
      sdf_capsule_axis_bwd<1>(pr.size, local, ddist, dgl, dls, dsize);
      break;
    case 4:
      sdf_cylinder_bwd(pr.size, local, ddist, dgl, dls, dsize);
      break;
    case 5:
      sdf_torus_bwd(pr.size, local, ddist, dgl, dls, dsize);
      break;
    case 6:
      sdf_capsule_axis_bwd<0>(pr.size, local, ddist, dgl, dls, dsize);
      break;
    case 7:
      sdf_chopsticks_bwd(pr.size, local, ddist, dgl, dls, dsize);
      break;
    default:
      sdf_box_bwd(pr.size, local, ddist, dgl, dls, dsize);
  }
  for (int d = 0; d < 3; ++d) {
    acc.add(ip * NPA + PA_SIZE + d, dsize[d]);
    dlocal[d] += dls[d];
  }
  // local = qrot(qinv(q), gp - p)
  double dqi[4] = {0.0, 0.0, 0.0, 0.0}, drel[3] = {0.0, 0.0, 0.0};
  {
    const double rd[3] = {rel[0], rel[1], rel[2]};
    qrot_bwd<double>(qi, rd, dlocal, dqi, drel);
  }
  for (int d = 0; d < 3; ++d) acc.add(ip * NPA + PA_P + d, -drel[d]);
  qinv_bwd<double>(pr.q, dqi, dq);
  for (int d = 0; d < 4; ++d) acc.add(ip * NPA + PA_Q + d, dq[d]);
}

// Adjoint of grid_op for touched cell `cell`, from its momentum and mass
// before the ops (pre): from the cotangent of the cell's velocity after the
// ops (dsum[cell], rounded to float) to that of its momentum and mass
// (dout[cell]; dout may be dsum). The primitives' cotangents (position
// control: the per-substep velocity; collision: the frames, size, friction
// and softness) and the ground friction's go to acc.
template <class Acc, class D>
__device__ void grid_op_bwd(int cell, float4 pre, const D* dsum, float4* dout, const Prim* prims,
                            float gf, const Args& g, Acc& acc) {
  const float mom[3] = {pre.x, pre.y, pre.z};
  const float m = pre.w;
  const bool norm = m > 1e-10f;
  float v[3];
  for (int d = 0; d < 3; ++d) v[d] = norm ? mom[d] / m : mom[d];
  v[0] = v[0] + g.dt * g.gx;
  v[1] = v[1] + g.dt * g.gy;
  v[2] = v[2] + g.dt * g.gz;
  int ci = cell / (g.ry * g.rz), cj = (cell / g.rz) % g.ry, ck = cell % g.rz;
  float idx[3] = {(float)ci, (float)cj, (float)ck};
  float gp[3] = {node_pos(idx[0], g.dx), node_pos(idx[1], g.dx), node_pos(idx[2], g.dx)};
  unsigned controlled = 0;
  float vin[MAX_PRIM][3];  // each primitive's input velocity (collision)
  for (int ip = 0; ip < g.n_prim; ++ip) {
    const Prim& pr = prims[ip];
    if (g.use_pc) {
      float qi[4], rel[3], local[3];
      qinv(pr.q, qi);
      for (int d = 0; d < 3; ++d) rel[d] = gp[d] - pr.p[d];
      qrot(qi, rel, local);
      if (sdf_eval(pr.kind, pr.size, local, nullptr) < pr.size[0] * 1.5f) {
        controlled |= 1u << ip;
        for (int d = 0; d < 3; ++d) v[d] = pr.vstep[d] / g.dt;
      }
    } else {
      for (int d = 0; d < 3; ++d) vin[ip][d] = v[d];
      collide_fwd(pr, gp, v, g.dt);
    }
  }
  const bool fric = cj < 3 && v[1] <= 0.f;
  float lin = 0.f, vit[3] = {0.f, 0.f, 0.f}, ab[3] = {0.f, 0.f, 0.f}, lit = 1.f, arg = 0.f,
        coef = 0.f, out[3] = {v[0], v[1], v[2]};
  if (fric) {
    lin = v[1] + 1e-30f;
    vit[0] = v[0] - idx[0] * 1e-30f;
    vit[1] = v[1] - lin - idx[1] * 1e-30f;
    vit[2] = v[2] - idx[2] * 1e-30f;
    for (int d = 0; d < 3; ++d) ab[d] = vit[d] + 1e-12f;
    lit = sqrtf(ab[0] * ab[0] + ab[1] * ab[1] + ab[2] * ab[2]);
    arg = 1.f + gf * lin / lit;
    coef = fmaxf(arg, 0.f);
    out[0] = coef * (vit[0] + idx[0] * 1e-30f);
    out[1] = 0.f;
    out[2] = coef * (vit[2] + idx[2] * 1e-30f);
  }
  float4 d4 = grid_load(dsum, cell);
  float dv[3] = {d4.x, d4.y, d4.z};
  for (int d = 0; d < 3; ++d)
    if ((idx[d] < 3.f && out[d] < 0.f) || (idx[d] > (float)(g.n_grid - 3) && out[d] > 0.f))
      dv[d] = 0.f;
  if (fric) {
    float dcoef = dv[0] * (vit[0] + idx[0] * 1e-30f) + dv[2] * (vit[2] + idx[2] * 1e-30f);
    float dvit[3] = {coef * dv[0], 0.f, coef * dv[2]};
    float darg = dcoef * max_grad(arg, 0.f);
    acc.add(ACC_GF, darg * (lin / lit));
    float dlin = darg * gf / lit;
    float dlit = -darg * (gf * lin) / (lit * lit);
    for (int d = 0; d < 3; ++d) dvit[d] += dlit * ab[d] / lit;
    // vit[1] = v[1] - lin: its cotangent reaches v[1] once directly and once,
    // negated, through lin
    dv[0] = dvit[0];
    dv[1] = dlin;
    dv[2] = dvit[2];
  }
  for (int ip = g.n_prim - 1; ip >= 0; --ip) {
    if (g.use_pc) {
      if (controlled & (1u << ip))
        for (int d = 0; d < 3; ++d) {
          acc.add(ip * NPA + PA_VS + d, dv[d] / g.dt);
          dv[d] = 0.f;
        }
    } else {
      collide_bwd(prims[ip], ip, gp, vin[ip], dv, g.dt, acc);
    }
  }
  float dm = 0.f, dmom[3];
  if (norm) {
    for (int d = 0; d < 3; ++d) {
      dmom[d] = dv[d] / m;
      dm += -dv[d] * mom[d] / (m * m);
    }
  } else {
    for (int d = 0; d < 3; ++d) dmom[d] = dv[d];
  }
  dout[cell] = make_float4(dmom[0], dmom[1], dmom[2], dm);
}

// Adjoint of G2P and advection for particle p: from the cotangents of the
// substep's output (cot, in place) and the grid after the grid ops, hand the
// cotangent of each stencil node's velocity to the scatter s (onto float4
// sums in K2, double in K3) and leave the cotangents of the input's x (the
// G2P part) and J in cot. A lane that is not live hands s 0 at every node.
template <class S>
__device__ __forceinline__ void g2p_adjoint_particle(const float* c, float* cot, int P, int p,
                                                     bool live, const Args& g,
                                                     const float4* grid, S& s) {
  const float sc = 4.f * g.inv_dx;
  float dnv[3], sdC[3][3], dx[3];
  Stencil st;
  if (live) {
    float x[3] = {c[IX * P + p], c[(IX + 1) * P + p], c[(IX + 2) * P + p]};
    const float J = c[IJ * P + p];
    float nv[3], nC[3][3];
    g2p_gather(x, grid, g, nv, nC);
    const float dJo = cot[IJ * P + p];
    for (int i = 0; i < 3; ++i) {
      dx[i] = cot[(IX + i) * P + p];
      dnv[i] = cot[(IV + i) * P + p] + g.dt * dx[i];
      for (int j = 0; j < 3; ++j) {
        float d = cot[(IC + 3 * i + j) * P + p];
        if (i == j) d += dJo * J * g.dt;
        sdC[i][j] = sc * d;  // the cotangent of the unscaled sum
      }
    }
    cot[IJ * P + p] = dJo * (1.f + g.dt * (nC[0][0] + nC[1][1] + nC[2][2]));
    stencil(x, g.inv_dx, st);
  }
  s.begin(st, g, live);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const int cell = live ? node_cell(st, a, bb, cc, g) : -1;
        float val[3] = {0.f, 0.f, 0.f};
        if (cell >= 0) {
          const float w0 = st.w[0][a], w1 = st.w[1][bb], w2 = st.w[2][cc];
          const float w = w0 * w1 * w2;
          const float t[3] = {st.t[0][a], st.t[1][bb], st.t[2][cc]};
          const float wd[3] = {spline_grad(t[0]) * w1 * w2, w0 * spline_grad(t[1]) * w2,
                               w0 * w1 * spline_grad(t[2])};
          float4 gv4 = grid[cell];
          const float gv[3] = {gv4.x, gv4.y, gv4.z};
          float acc = 0.f;
          for (int i = 0; i < 3; ++i) {
            float ct = sdC[i][0] * t[0] + sdC[i][1] * t[1] + sdC[i][2] * t[2];
            val[i] = w * dnv[i] + w * ct;
            acc += gv[i] * (dnv[i] + ct);
          }
          for (int d = 0; d < 3; ++d) {
            float cd = gv[0] * sdC[0][d] + gv[1] * sdC[1][d] + gv[2] * sdC[2][d];
            dx[d] += -g.inv_dx * (wd[d] * acc + w * cd);
          }
        }
        s.node3(cell, val);
      }
  if (live)
    for (int i = 0; i < 3; ++i) cot[(IX + i) * P + p] = dx[i];
}

// Adjoint of the stress and P2G for particle p: gathers the cotangents of
// its stencil nodes' momentum and mass and writes the cotangents of the
// input carry's v, C and F, adds P2G's part to x's; the Lame parameters' and
// the yield stress's cotangents gather into acc (3 x P, in double: summed
// over the substeps, the terms cancel to ~1e-2 of their size).
__device__ __forceinline__ void particle_adjoint_particle(const float* c, float* cot, double* acc,
                                                          int P, int p, const Args& g, int b,
                                                          const float4* dgrid) {
  Chain ch;
  chain_fwd(c, P, p, g, b, ch);
  float dv[3] = {0.f, 0.f, 0.f}, daff[3][3], dx[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) daff[i][j] = 0.f;
  Stencil st;
  stencil(ch.x, g.inv_dx, st);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        int cell = node_cell(st, a, bb, cc, g);
        if (cell < 0) continue;
        const float w0 = st.w[0][a], w1 = st.w[1][bb], w2 = st.w[2][cc];
        const float w = w0 * w1 * w2;
        const float t[3] = {st.t[0][a], st.t[1][bb], st.t[2][cc]};
        const float wd[3] = {spline_grad(t[0]) * w1 * w2, w0 * spline_grad(t[1]) * w2,
                             w0 * w1 * spline_grad(t[2])};
        const float dp[3] = {t[0] * g.dx, t[1] * g.dx, t[2] * g.dx};
        float4 d4 = dgrid[cell];
        const float dm[3] = {d4.x, d4.y, d4.z};
        float sdot = d4.w * g.p_mass;
        for (int i = 0; i < 3; ++i) {
          float mom = g.p_mass * ch.v[i] +
                      (ch.aff[i][0] * dp[0] + ch.aff[i][1] * dp[1] + ch.aff[i][2] * dp[2]);
          sdot += dm[i] * mom;
          dv[i] += g.p_mass * (w * dm[i]);
          for (int j = 0; j < 3; ++j) daff[i][j] += w * dm[i] * dp[j];
        }
        for (int d = 0; d < 3; ++d)
          dx[d] += -g.inv_dx * wd[d] * sdot -
                   w * (dm[0] * ch.aff[0][d] + dm[1] * ch.aff[1][d] + dm[2] * ch.aff[2][d]);
      }

  // affine = c1 stress / dx^2 + p_mass C
  float dS[3][3], dCm[3][3], dFf[3][3], dU[3][3], dV[3][3], R[3][3], A[3][3];
  const float sc = g.stress_c1 / g.dx2;
  mm_nt(ch.U, ch.V, R);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      dS[i][j] = daff[i][j] * sc;
      dCm[i][j] = g.p_mass * daff[i][j];
      A[i][j] = ch.Ff[i][j] - R[i][j];
    }
  // stress = 2 mu (Ff - R) Ff^T + la Jd (Jd - 1) I
  float dmu = 0.f;
  {
    float AFt[3][3];
    mm_nt(A, ch.Ff, AFt);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) dmu += dS[i][j] * 2.f * AFt[i][j];
  }
  const float trdS = dS[0][0] + dS[1][1] + dS[2][2];
  const float dla = trdS * (ch.Jd * (ch.Jd - 1.f));
  const float dJd = trdS * ch.la * (2.f * ch.Jd - 1.f);
  {
    float T1[3][3], T2[3][3], dR[3][3];
    mm(dS, ch.Ff, T1);   // dS Ff
    mm_tn(dS, A, T2);    // dS^T (Ff - R)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        dFf[i][j] = 2.f * ch.mu * (T1[i][j] + T2[i][j]) + cot[(IF + 3 * i + j) * P + p];
        dR[i][j] = -2.f * ch.mu * T1[i][j];
      }
    mm(dR, ch.V, dU);     // R = U V^T
    mm_tn(dR, ch.U, dV);
  }
  float dsig[3] = {0.f, 0.f, 0.f}, dFn[3][3];
  float ds[3] = {0.f, 0.f, 0.f};
  if (ch.mat == 2 || ch.mat == 3) {
    // Ff = U diag(s) V^T
    float T1[3][3], T2[3][3];
    mm(dFf, ch.V, T1);
    mm_tn(dFf, ch.U, T2);
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) {
        dU[i][k] += T1[i][k] * ch.s[k];
        dV[i][k] += T2[i][k] * ch.s[k];
      }
    for (int k = 0; k < 3; ++k)
      ds[k] = ch.U[0][k] * T1[0][k] + ch.U[1][k] * T1[1][k] + ch.U[2][k] * T1[2][k];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) dFn[i][j] = 0.f;
  } else {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) dFn[i][j] = dFf[i][j];
  }
  float dys = 0.f;
  if (ch.mat == 2) {
    // Jd = prod(s), s = clip(sig)
    ds[0] += dJd * (ch.s[1] * ch.s[2]);
    ds[1] += dJd * (ch.s[0] * ch.s[2]);
    ds[2] += dJd * (ch.s[0] * ch.s[1]);
    for (int k = 0; k < 3; ++k)
      dsig[k] = ds[k] * clip_grad(ch.sig[k], 1.f - 2.5e-2f * 10.f, 1.f + 4.5e-3f * 100.f);
  } else {
    dsig[0] = dJd * (ch.sig[1] * ch.sig[2]);
    dsig[1] = dJd * (ch.sig[0] * ch.sig[2]);
    dsig[2] = dJd * (ch.sig[0] * ch.sig[1]);
  }
  if (ch.mat == 3) {
    // the von-Mises return map in log-sigma space (vm_project)
    float sv[3], eps[3], eh[3], dsv[3];
    for (int d = 0; d < 3; ++d) {
      sv[d] = fmaxf(ch.sig[d], 0.05f);
      eps[d] = logf(sv[d]);
    }
    float mean = (eps[0] + eps[1] + eps[2]) / 3.f;
    for (int d = 0; d < 3; ++d) eh[d] = eps[d] - mean;
    float ehn = sqrtf(eh[0] * eh[0] + eh[1] * eh[1] + eh[2] * eh[2] + 1e-12f);
    float den = 2.f * ch.mu + 1e-12f;
    float dg = ehn - ch.ys / den;
    if (dg > 0.f) {
      float dgp = fmaxf(dg, 0.f);
      float r = dgp / ehn;
      float dep[3], deps[3], deh[3], dr = 0.f;
      for (int d = 0; d < 3; ++d) {
        dep[d] = ds[d] * ch.s[d];  // s = exp(eps - r eh)
        deps[d] = dep[d];
        deh[d] = -r * dep[d];
        dr -= dep[d] * eh[d];
      }
      float ddgp = dr / ehn;
      float dehn = -dr * dgp / (ehn * ehn);
      float ddg = ddgp * max_grad(dg, 0.f);
      dehn += ddg;
      dys = -ddg / den;
      dmu += ddg * ch.ys * 2.f / (den * den);
      for (int d = 0; d < 3; ++d) deh[d] += dehn * eh[d] / ehn;
      float sdeh = deh[0] + deh[1] + deh[2];
      for (int d = 0; d < 3; ++d) {
        deps[d] += deh[d] - sdeh / 3.f;
        dsv[d] = deps[d] / sv[d];
      }
    } else {
      for (int d = 0; d < 3; ++d) dsv[d] = ds[d];
    }
    for (int d = 0; d < 3; ++d) dsig[d] += dsv[d] * max_grad(ch.sig[d], 0.05f);
  }
  svd3_bwd(ch.U, ch.sig, ch.V, dU, dsig, dV, dFn);
  // Fn = (I + dt C) F
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float dA = dFn[i][0] * ch.F[j][0] + dFn[i][1] * ch.F[j][1] + dFn[i][2] * ch.F[j][2];
      float a0 = (i == 0 ? 1.f : 0.f) + g.dt * ch.Cm[0][i];
      float a1 = (i == 1 ? 1.f : 0.f) + g.dt * ch.Cm[1][i];
      float a2 = (i == 2 ? 1.f : 0.f) + g.dt * ch.Cm[2][i];
      // (I + dt C)^T dFn, row i: column i of I + dt C against column j of dFn
      cot[(IF + 3 * i + j) * P + p] = a0 * dFn[0][j] + a1 * dFn[1][j] + a2 * dFn[2][j];
      cot[(IC + 3 * i + j) * P + p] = dCm[i][j] + g.dt * dA;
    }
  for (int d = 0; d < 3; ++d) {
    cot[(IV + d) * P + p] = dv[d];
    cot[(IX + d) * P + p] += dx[d];
  }
  if (ch.mat != 0) {
    acc[p] += (double)(dmu * ch.h);
    acc[P + p] += (double)(dla * ch.h);
  }
  if (ch.mat == 3) acc[2 * P + p] += (double)dys;
}

// Adjoint of primitive ip's forward kinematics at substep t, one thread.
// rows are the env's frames ((steps + 1), n_prim, ROW); pa holds the
// primitive's cotangents of the substep's grid ops (NPA); dpq (7: position,
// rotation) holds the cotangent of frame t + 1 on entry and of frame t on
// exit. Writes its row t of gvw and, at t = 0, its row of gframe (env b's).
__device__ void fk_adjoint_prim(const Args& g, int b, int t, int ip, const float* rows,
                                const double* pa, const float* dpos, const float* drot,
                                float* gframe, float* gvw_all, float* dpq) {
  const int np = g.n_prim, steps = g.steps;
  {
    float* dP = dpq;
    float* dQ = dP + 3;
    const float* fr = g.prim_frame + ((size_t)b * np + ip) * PRIM_FRAME;
    const float* r = rows + ((size_t)t * np + ip) * ROW;
    const float* vw = g.prim_vw + (((size_t)b * np + ip) * steps + t) * 6;
    float* gvw = gvw_all + (((size_t)b * np + ip) * steps + t) * 6;
    // frame t + 1 as the substep's collision read it
    for (int d = 0; d < 3; ++d) dP[d] += (float)pa[PA_P1 + d];
    for (int d = 0; d < 4; ++d) dQ[d] += (float)pa[PA_Q1 + d];
    // p_{t+1} = clip(p_t + v_t, -2, 2); substep 0 reads the input row 0
    float draw[3];
    for (int d = 0; d < 3; ++d) {
      float pt = t == 0 ? fr[d] : r[d];
      draw[d] = dP[d] * clip_grad(pt + vw[d], -2.f, 2.f);
      gvw[d] = (float)(pa[PA_VS + d] + (double)draw[d]);
    }
    // q_{t+1} = qmul(w2quat(w_t), q_t) = o / max(|o|, 1e-12)
    float qa[4], o[4], dq[4], da[4];
    const float* qb = r + 3;
    w2quat(vw + 3, qa);
    o[0] = qa[0] * qb[0] - qa[1] * qb[1] - qa[2] * qb[2] - qa[3] * qb[3];
    o[1] = qa[0] * qb[1] + qa[1] * qb[0] + qa[2] * qb[3] - qa[3] * qb[2];
    o[2] = qa[0] * qb[2] - qa[1] * qb[3] + qa[2] * qb[0] + qa[3] * qb[1];
    o[3] = qa[0] * qb[3] + qa[1] * qb[2] - qa[2] * qb[1] + qa[3] * qb[0];
    float on = sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
    float n = fmaxf(on, 1e-12f);
    float dO[4];
    if (on > 1e-12f) {
      float dot = 0.f;
      for (int k = 0; k < 4; ++k) dot += dQ[k] * (o[k] / n);
      for (int k = 0; k < 4; ++k) dO[k] = (dQ[k] - (o[k] / n) * dot) / n;
    } else {
      for (int k = 0; k < 4; ++k) dO[k] = dQ[k] / n;
    }
    da[0] = dO[0] * qb[0] + dO[1] * qb[1] + dO[2] * qb[2] + dO[3] * qb[3];
    da[1] = -dO[0] * qb[1] + dO[1] * qb[0] - dO[2] * qb[3] + dO[3] * qb[2];
    da[2] = -dO[0] * qb[2] + dO[1] * qb[3] + dO[2] * qb[0] - dO[3] * qb[1];
    da[3] = -dO[0] * qb[3] - dO[1] * qb[2] + dO[2] * qb[1] + dO[3] * qb[0];
    dq[0] = dO[0] * qa[0] + dO[1] * qa[1] + dO[2] * qa[2] + dO[3] * qa[3];
    dq[1] = -dO[0] * qa[1] + dO[1] * qa[0] + dO[2] * qa[3] - dO[3] * qa[2];
    dq[2] = -dO[0] * qa[2] - dO[1] * qa[3] + dO[2] * qa[0] + dO[3] * qa[1];
    dq[3] = -dO[0] * qa[3] + dO[1] * qa[2] - dO[2] * qa[1] + dO[3] * qa[0];
    // w2quat: wn = |w| + 1e-12, qa = (cos(wn / 2), w / wn sin(wn / 2)); at
    // w = 0 the norm's derivative is NaN, as autograd's
    {
      const float* w = vw + 3;
      float nrm = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
      float wn = nrm + 1e-12f, sh = sinf(wn / 2.f), chh = cosf(wn / 2.f);
      float dwn = -da[0] * sh / 2.f;
      for (int d = 0; d < 3; ++d)
        dwn += da[1 + d] * (-w[d] / (wn * wn) * sh + (w[d] / wn) * chh / 2.f);
      for (int d = 0; d < 3; ++d) gvw[3 + d] = da[1 + d] * sh / wn + dwn * (w[d] / nrm);
    }
    if (t > 0) {
      // frame t's row: the trajectory output's cotangent, through the
      // re-clips of the later substeps (1/2 each at a bound), its use by
      // FK, and its read by the substep's collision after one re-clip
      const size_t row = ((size_t)b * np + ip) * (steps + 1) + t;
      float tie = 1.f;
      for (int k = t; k < steps; ++k) tie *= 0.5f;
      for (int d = 0; d < 3; ++d)
        dP[d] = dpos[row * 3 + d] * (fabsf(r[d]) == 2.f ? tie : 1.f) + draw[d] +
                (float)pa[PA_P + d] * clip_grad(r[d], -2.f, 2.f);
      for (int d = 0; d < 4; ++d) dQ[d] = drot[row * 4 + d] + dq[d] + (float)pa[PA_Q + d];
    } else {
      float* gfr = gframe + ((size_t)b * np + ip) * PRIM_FRAME;
      for (int d = 0; d < 3; ++d)
        gfr[d] = draw[d] + (float)pa[PA_P + d] * clip_grad(fr[d], -2.f, 2.f);
      for (int d = 0; d < 4; ++d) gfr[3 + d] = dq[d] + (float)pa[PA_Q + d];
      // size, friction and softness, summed over the substeps
      for (int d = 0; d < 5; ++d) gfr[7 + d] = (float)pa[PA_SIZE + d];
    }
  }
}

}  // namespace
