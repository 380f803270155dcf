// Device code shared by the MLS-MPM macro-step kernels of Hopper (sm_90a):
// K2 (mpm_step.cu, one block per env) and K3-fwd (mpm_big_step.cu, many
// blocks per env). It computes what unidom_torch/engine/mpm.py's plain
// _substep computes: the forward's arguments, the primitives' frames and
// forward kinematics (fk_rows, load_prims), the SDFs with their normals in
// jax.grad's tie conventions, the Jacobi SVD of ops/svd3.py, the materials'
// return maps and the stress (chain_fwd), the quadratic B-spline stencil
// with out-of-range nodes dropped (node_cell), the grid ops of one cell
// (grid_op), and each particle's share of a substep: the clearing of its
// stencil, its P2G and its G2P with advection.

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

__device__ __forceinline__ float sdf_eval(int kind, const float* size, const float* p,
                                          float* grad) {
  return kind == 1 ? sdf_container(size, p, grad) : sdf_box(size, p, grad);
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

__device__ __forceinline__ void grid_op(int cell, float4* grid, const Prim* prims, float gf,
                                        const Args& g, float4* pre) {
  float4 gv = grid[cell];
  if (pre) *pre = gv;
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
  float gp[3] = {idx[0] * g.dx, idx[1] * g.dx, idx[2] * g.dx};

  for (int ip = 0; ip < g.n_prim; ++ip) {
    const Prim& pr = prims[ip];
    float qi[4], rel[3], local[3];
    qinv(pr.q, qi);
    for (int d = 0; d < 3; ++d) rel[d] = gp[d] - pr.p[d];
    qrot(qi, rel, local);
    if (g.use_pc) {
      float dist = sdf_eval(pr.kind, pr.size, local, nullptr);
      if (dist < pr.size[0] * 1.5f)
        for (int d = 0; d < 3; ++d) v[d] = pr.vstep[d] / g.dt;
    } else {
      float gl[3], n[3], D[3], np[3], cv[3], in[3], vt[3];
      float dist = sdf_eval(pr.kind, pr.size, local, gl);
      float influence = fminf(expf(-dist * pr.soft), 1.f);
      float gn = sqrtf(gl[0] * gl[0] + gl[1] * gl[1] + gl[2] * gl[2] + 1e-12f);
      for (int d = 0; d < 3; ++d) n[d] = gl[d] / gn;
      qrot(pr.q, n, D);
      qrot(pr.q1, local, np);
      for (int d = 0; d < 3; ++d) {
        cv[d] = (np[d] + pr.p1[d] - gp[d]) / g.dt;
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
  grid[cell] = make_float4(v[0], v[1], v[2], m);
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
    pr.kind = (g.sdf_kinds >> ip) & 1;
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

// ------------------------------------------------------- one particle's phases
// A substep, particle by particle: K2 loops over a block's particles, K3 runs
// one thread per particle. Kernel launches or the caller's barriers separate
// the phases.

// zero the grid (and its cotangent) and the marks under the stencil at x
__device__ __forceinline__ void zero_stencil(const float* x, const Args& g, float4* grid,
                                             int* mark, float4* dgrid) {
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
          grid[cell] = make_float4(0.f, 0.f, 0.f, 0.f);
          mark[cell] = 0;
          if (dgrid) dgrid[cell] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
}

// stress and P2G of particle p of the carry c; F_out (may be c itself) takes
// F after the return map when not null; the first mark of a cell appends it
// to touched, counted by n_touched
__device__ __forceinline__ void p2g_particle(const float* c, float* F_out, int P, int p,
                                             const Args& g, int b, float4* grid, int* mark,
                                             int* touched, int* n_touched) {
  Chain ch;
  chain_fwd(c, P, p, g, b, ch);
  if (F_out)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) F_out[(IF + 3 * i + j) * P + p] = ch.Ff[i][j];
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
        float w = st.w[0][a] * st.w[1][bb] * st.w[2][cc];
        float dp[3] = {st.t[0][a] * g.dx, st.t[1][bb] * g.dx, st.t[2][cc] * g.dx};
        float* gc = (float*)(grid + cell);
        for (int i = 0; i < 3; ++i) {
          float mom = g.p_mass * ch.v[i] +
                      (ch.aff[i][0] * dp[0] + ch.aff[i][1] * dp[1] + ch.aff[i][2] * dp[2]);
          atomicAdd(gc + i, w * mom);
        }
        atomicAdd(gc + 3, w * g.p_mass);
        if (atomicCAS(mark + cell, 0, 1) == 0) touched[atomicAdd(n_touched, 1)] = cell;
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

}  // namespace
