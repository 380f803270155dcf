// MLS-MPM macro step for Hopper (sm_90a): kernels K2-fwd, K2-seg and K2-bwd.
//
// Replaces unidom_tpu/ops/pallas/mpm_kernel.py's build_mpm_step_kernel: the
// forward (fwd_call -> fwd_kernel, one macro step of conf.steps substeps per
// env; each substep is make_substep), the segment recompute (seg_hist_call)
// and the backward (bwd_step_call, one substep's VJP, and the reverse scan
// _core_bwd). K2-fwd computes what unidom_torch/engine/mpm.py's plain
// _substep computes, substep by substep: F <- (I + dt C) F; the Jacobi SVD
// of ops/svd3.py (6 sweeps, compare-exchange sort, regularised U with
// Gram-Schmidt fallbacks); the sigma-clip and von-Mises return maps by
// material; fixed-corotated stress plus p_mass C; quadratic B-spline P2G;
// primitive forward kinematics; grid ops (mass normalisation with the 1e-10
// mass mask, gravity, the primitive as position control or as SDF collision
// with the normal in jax.grad's tie conventions, ground friction on the
// bottom 3 layers, 3-cell walls with the upper wall at n_grid); G2P and
// advection. It writes the final x, v, C, F, J and the primitives' steps + 1
// trajectory rows (row t + 1 from substep t, row 0 <- row steps), and, when
// a gradient is wanted, the particle state every K substeps (the history).
// K2-seg re-runs a segment of K substeps from its checkpoint with the same
// device code and writes each substep's input. K2-bwd is the macro step's
// adjoint under position control, written out stage by stage: per substep,
// in reverse, it recomputes the forward up to the grid ops from the
// substep's input, then takes the adjoints of G2P and advection (a scatter
// of the nodes' velocity cotangents with atomics, and the weights'
// derivatives in x), of the grid ops per touched cell, of P2G (a gather),
// of the stress, the materials' return maps, the SVD (svd3_soa_bwd, term for
// term) and F's update, and of the primitives' forward kinematics.
//
// What bounds them on this card: operations. A particle-substep costs 3,397
// float32 operations forward (the SVD 1,414, P2G 837 and G2P 783 over the 27
// stencil nodes; counted in chip_smoke.py, FLOP_MPM_PARTICLE) and 10,071
// for the forward and its adjoint (FLOP_MPM_BWD_PARTICLE); whip_rope at 1024
// envs is about 18 and 51 GFLOP per macro step against tens of MB of state,
// history and cotangents. This first design does not reach that: only 67 of
// a block's 128 threads hold a whip_rope particle, each runs its particle's
// serial chain alone, and the barriers of each substep wait on the slowest.
//
// Design (right and simple first):
//   - One thread block per env, 128 threads, the substep loop inside the
//     kernel. The particle state (25 floats each) lives in shared memory; a
//     thread owns particles tid, tid + 128, ... and keeps each one's SVD in
//     registers while it works on it. K2-bwd also keeps the state's
//     cotangent in shared memory, with the Lame parameters' and yield
//     stress's per particle in double.
//   - The TPU kernel's dense tensor-product transfers (a TPU has no fast
//     scatter) become a scatter: each particle's 27 stencil nodes, base =
//     floor(x inv_dx - 0.5), offsets 0..2, the same nodes and weights as the
//     dense form (w = 0 for |t| >= 1.5); out-of-range nodes are dropped.
//   - The grid: a per-env dense grid (momentum and mass, float4 per cell)
//     and a mark per cell in device memory, from the wrapper's torch.empty
//     (0.5 GB at whip_rope's 32^3 cells and 1024 envs; it does not fit a
//     block's 227 KB of shared memory). Each substep first zeroes the
//     stencil nodes of every particle (so nothing needs zeroing between
//     launches), then P2G adds with atomics and marks each node; the first
//     mark of a node appends it to a shared-memory list of touched cells,
//     and the grid ops run on that list only. G2P reads the same nodes, so
//     cells no stencil touched are never read. K2-bwd adds a grid of
//     cotangents (zeroed the same way) and keeps each touched cell's momentum
//     and mass before the grid ops, by its slot in the list.
//   - The primitives' frames of all substeps (steps + 1 rows) are computed
//     once by one thread into shared memory; each substep reads its two.
//   - The history: K2-fwd writes the input of substeps 0, K, 2K, ...; with
//     K = 1 that is every substep's input and K2-bwd reads it directly;
//     with K > 1 K2-bwd runs K2-seg as the first phase of each segment,
//     into a per-env buffer of K carries in device memory, then walks the
//     segment in reverse. The wrapper picks K (ops/cuda/mpm_kernel.py).
//   - IEEE division and square roots; atomics add in a varying order, so
//     results are not bitwise reproducible from run to run, and K = 1 and
//     K > 1 give slightly different gradients.
//   - The forward's device code (the arguments, SVD, return maps and stress,
//     stencil, grid ops, SDFs, forward kinematics and each particle's share
//     of a substep) lives in mpm_device.cuh, shared with K3-fwd
//     (mpm_big_step.cu); the block-level phases and K2-bwd's adjoints are
//     here.

#include "mpm_device.cuh"

namespace {

constexpr int NT = 128;  // threads per block
constexpr float SVD_EPS = 1e-12f;  // svd3_soa_bwd's DEFAULT_EPS

// What K2-bwd reads and writes beside the forward's Args.
struct BwdArgs {
  const float *dx, *dv, *dC, *dF, *dJ;  // cotangents of the outputs, (B, P, ...)
  const float *dpos, *drot;             // (B, n_prim, steps + 1, 3 / 4)
  float *gx, *gv, *gC, *gF, *gJ;        // cotangents of the inputs, (B, P, ...)
  float *gmu, *gla, *gys;               // as the inputs: (B, 1) or (B, P)
  float* ggf;                           // (B, 1)
  float* gframe;                        // (B, n_prim, PRIM_FRAME)
  float* gvw;                           // (B, n_prim, steps, 6)
  float* seg;                           // (B, K, N_COMP, P): a segment's carries when K > 1
  float4* dgrid;                        // (B, cells): cotangent of momentum xyz and mass
  float4* pre;                          // (B, list_cap): each touched cell before the grid ops
  int list_cap;
};

// ------------------------------------------------------------- substep phases
// Each runs on every thread of the block, a thread taking particles (or
// touched cells) tid, tid + blockDim.x, ...; the caller puts the barriers.

// zero the grid (and its cotangent) under every particle's stencil
__device__ void zero_stencils(const float* c, int P, const Args& g, float4* grid, int* mark,
                              float4* dgrid) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float x[3] = {c[IX * P + p], c[(IX + 1) * P + p], c[(IX + 2) * P + p]};
    zero_stencil(x, g, grid, mark, dgrid);
  }
}

// stress and P2G from the carry c; F_out (may be c itself) takes F after the
// return map when not null; the first mark of a cell appends it to touched
__device__ void p2g(const float* c, float* F_out, int P, const Args& g, int b, float4* grid,
                    int* mark, int* touched, int* n_touched) {
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    p2g_particle(c, F_out, P, p, g, b, grid, mark, touched, n_touched);
}

// the grid ops on the touched cells; pre, when not null, keeps each cell's
// momentum and mass before them (slot i for touched[i])
__device__ void grid_ops(const int* touched, int n, float4* grid, const Prim* prims, float gf,
                         const Args& g, float4* pre) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    grid_op(touched[i], grid, prims, gf, g, pre ? pre + i : nullptr);
}

// G2P and advection of the carry ps, in place
__device__ void g2p_advect(float* ps, int P, const Args& g, const float4* grid) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) g2p_advect_particle(ps, P, p, g, grid);
}

// One forward substep f of the carry ps (shared memory), in place. Thread 0
// loads the primitives of substep f from the rows first.
__device__ void substep_fwd(float* ps, int f, const Args& g, int b, const float* rows,
                            Prim* prims, float4* grid, int* mark, int* touched, int* n_touched,
                            float gf) {
  const int P = g.P;
  if (threadIdx.x == 0) {
    load_prims(g, b, f, rows, prims);
    *n_touched = 0;
  }
  zero_stencils(ps, P, g, grid, mark, nullptr);
  __syncthreads();
  p2g(ps, ps, P, g, b, grid, mark, touched, n_touched);
  __syncthreads();
  grid_ops(touched, *n_touched, grid, prims, gf, g, nullptr);
  __syncthreads();
  g2p_advect(ps, P, g, grid);
  __syncthreads();
}

// copy a carry of N_COMP x P floats, each thread its own particles
__device__ __forceinline__ void copy_carry(const float* src, float* dst, int P) {
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    for (int c = 0; c < N_COMP; ++c) dst[c * P + p] = src[c * P + p];
}

// ------------------------------------------------------------------ K2-fwd

__global__ void __launch_bounds__(NT) mpm_step_fwd_kernel(Args g) {
  extern __shared__ float smem[];
  __shared__ Prim prims[MAX_PRIM];
  __shared__ int n_touched;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int P = g.P, steps = g.steps;
  const size_t cells = (size_t)g.rx * g.ry * g.rz;
  float* ps = smem;                                   // N_COMP * P
  float* rows = ps + (size_t)N_COMP * P;              // (steps + 1) * n_prim * ROW
  int* touched = (int*)(rows + (size_t)(steps + 1) * g.n_prim * ROW);
  float4* grid = g.grid + (size_t)b * cells;
  int* mark = g.mark + (size_t)b * cells;
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];

  for (int p = tid; p < P; p += nt) {
    size_t o = (size_t)b * P + p;
    for (int d = 0; d < 3; ++d) {
      ps[(IX + d) * P + p] = g.x[o * 3 + d];
      ps[(IV + d) * P + p] = g.v[o * 3 + d];
    }
    for (int e = 0; e < 9; ++e) {
      ps[(IC + e) * P + p] = g.C[o * 9 + e];
      ps[(IF + e) * P + p] = g.F[o * 9 + e];
    }
    ps[IJ * P + p] = g.J[o];
  }
  if (tid == 0) fk_rows(g, b, rows);
  __syncthreads();

  const int n_ckpt = (steps + g.K - 1) / g.K;
  for (int f = 0; f < steps; ++f) {
    if (g.hist && f % g.K == 0)
      copy_carry(ps, g.hist + ((size_t)b * n_ckpt + f / g.K) * N_COMP * P, P);
    substep_fwd(ps, f, g, b, rows, prims, grid, mark, touched, &n_touched, gf);
  }

  for (int p = tid; p < P; p += nt) {
    size_t o = (size_t)b * P + p;
    for (int d = 0; d < 3; ++d) {
      g.x_out[o * 3 + d] = ps[(IX + d) * P + p];
      g.v_out[o * 3 + d] = ps[(IV + d) * P + p];
    }
    for (int e = 0; e < 9; ++e) {
      g.C_out[o * 9 + e] = ps[(IC + e) * P + p];
      g.F_out[o * 9 + e] = ps[(IF + e) * P + p];
    }
    g.J_out[o] = ps[IJ * P + p];
  }
  // trajectory rows 1 .. steps, and copy_frame: row 0 <- row steps
  for (int k = tid; k < (steps + 1) * g.n_prim; k += nt) {
    int f = k / g.n_prim, ip = k % g.n_prim;
    const float* r = rows + ((size_t)(f == 0 ? steps : f) * g.n_prim + ip) * ROW;
    size_t row = ((size_t)b * g.n_prim + ip) * (steps + 1) + f;
    for (int d = 0; d < 3; ++d) g.traj_pos[row * 3 + d] = r[d];
    for (int d = 0; d < 4; ++d) g.traj_rot[row * 4 + d] = r[3 + d];
  }
}

// ------------------------------------------------------------------ K2-seg
// Segment s of a macro step: from checkpoint s of the history, re-run the
// segment's substeps with K2-fwd's device code and write each substep's
// input carry, L = min(K, steps - s K) of them, to out (L, N_COMP, P).

__device__ void seg_recompute(const Args& g, int b, int s, float* out, float* ps,
                              const float* rows, Prim* prims, float4* grid, int* mark,
                              int* touched, int* n_touched, float gf) {
  const int P = g.P, t0 = s * g.K;
  const int L = min(g.K, g.steps - t0);
  const int n_ckpt = (g.steps + g.K - 1) / g.K;
  copy_carry(g.hist + ((size_t)b * n_ckpt + s) * N_COMP * P, ps, P);
  __syncthreads();
  for (int j = 0; j < L; ++j) {
    copy_carry(ps, out + (size_t)j * N_COMP * P, P);
    if (j + 1 < L) substep_fwd(ps, t0 + j, g, b, rows, prims, grid, mark, touched, n_touched, gf);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) mpm_step_seg_kernel(Args g, int s, float* out) {
  extern __shared__ float smem[];
  __shared__ Prim prims[MAX_PRIM];
  __shared__ int n_touched;

  const int b = blockIdx.x, P = g.P;
  const size_t cells = (size_t)g.rx * g.ry * g.rz;
  float* ps = smem;
  float* rows = ps + (size_t)N_COMP * P;
  int* touched = (int*)(rows + (size_t)(g.steps + 1) * g.n_prim * ROW);
  const int L = min(g.K, g.steps - s * g.K);
  if (threadIdx.x == 0) fk_rows(g, b, rows);
  __syncthreads();
  seg_recompute(g, b, s, out + (size_t)b * L * N_COMP * P, ps, rows, prims,
                g.grid + (size_t)b * cells, g.mark + (size_t)b * cells, touched, &n_touched,
                g.ground_friction[(size_t)b * g.gf_sb]);
}

// ------------------------------------------------------------------ K2-bwd
// The macro step's adjoint, written out by hand stage by stage in reverse.
// Ties follow jax.grad: max, min and clip give 1/2 to each side.

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

// Adjoint of G2P and advection for each particle: from the cotangents of the
// substep's output (cot, in place) and the grid after the grid ops, scatter
// the cotangent of each stencil node's velocity onto dgrid and leave the
// cotangents of the input's x (the G2P part) and J in cot.
__device__ void g2p_adjoint(const float* c, float* cot, int P, const Args& g,
                            const float4* grid, float4* dgrid) {
  const float s = 4.f * g.inv_dx;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float x[3] = {c[IX * P + p], c[(IX + 1) * P + p], c[(IX + 2) * P + p]};
    const float J = c[IJ * P + p];
    float nv[3], nC[3][3];
    g2p_gather(x, grid, g, nv, nC);
    float dnv[3], sdC[3][3], dx[3];
    const float dJo = cot[IJ * P + p];
    for (int i = 0; i < 3; ++i) {
      dx[i] = cot[(IX + i) * P + p];
      dnv[i] = cot[(IV + i) * P + p] + g.dt * dx[i];
      for (int j = 0; j < 3; ++j) {
        float d = cot[(IC + 3 * i + j) * P + p];
        if (i == j) d += dJo * J * g.dt;
        sdC[i][j] = s * d;  // the cotangent of the unscaled sum
      }
    }
    cot[IJ * P + p] = dJo * (1.f + g.dt * (nC[0][0] + nC[1][1] + nC[2][2]));
    Stencil st;
    stencil(x, g.inv_dx, st);
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
          float4 gv4 = grid[cell];
          const float gv[3] = {gv4.x, gv4.y, gv4.z};
          float* dgc = (float*)(dgrid + cell);
          float acc = 0.f;
          for (int i = 0; i < 3; ++i) {
            float ct = sdC[i][0] * t[0] + sdC[i][1] * t[1] + sdC[i][2] * t[2];
            atomicAdd(dgc + i, w * dnv[i] + w * ct);
            acc += gv[i] * (dnv[i] + ct);
          }
          for (int d = 0; d < 3; ++d) {
            float cd = gv[0] * sdC[0][d] + gv[1] * sdC[1][d] + gv[2] * sdC[2][d];
            dx[d] += -g.inv_dx * (wd[d] * acc + w * cd);
          }
        }
    for (int i = 0; i < 3; ++i) cot[(IX + i) * P + p] = dx[i];
  }
}

// Adjoint of grid_op under position control for touched cell `cell`, from
// its momentum and mass before the ops: dgrid[cell] goes from the cotangent
// of the cell's velocity after the ops to that of its momentum and mass.
// The primitives' per-substep velocity gathers into dvs, the ground
// friction into dgf.
__device__ void grid_op_bwd(int cell, float4 pre, float4* dgrid, const Prim* prims, float gf,
                            const Args& g, double* dvs, double& dgf) {
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
  float gp[3] = {idx[0] * g.dx, idx[1] * g.dx, idx[2] * g.dx};
  unsigned controlled = 0;
  for (int ip = 0; ip < g.n_prim; ++ip) {
    const Prim& pr = prims[ip];
    float qi[4], rel[3], local[3];
    qinv(pr.q, qi);
    for (int d = 0; d < 3; ++d) rel[d] = gp[d] - pr.p[d];
    qrot(qi, rel, local);
    if (sdf_eval(pr.kind, pr.size, local, nullptr) < pr.size[0] * 1.5f) {
      controlled |= 1u << ip;
      for (int d = 0; d < 3; ++d) v[d] = pr.vstep[d] / g.dt;
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
  float4 d4 = dgrid[cell];
  float dv[3] = {d4.x, d4.y, d4.z};
  for (int d = 0; d < 3; ++d)
    if ((idx[d] < 3.f && out[d] < 0.f) || (idx[d] > (float)(g.n_grid - 3) && out[d] > 0.f))
      dv[d] = 0.f;
  if (fric) {
    float dcoef = dv[0] * (vit[0] + idx[0] * 1e-30f) + dv[2] * (vit[2] + idx[2] * 1e-30f);
    float dvit[3] = {coef * dv[0], 0.f, coef * dv[2]};
    float darg = dcoef * max_grad(arg, 0.f);
    dgf += (double)(darg * (lin / lit));
    float dlin = darg * gf / lit;
    float dlit = -darg * (gf * lin) / (lit * lit);
    for (int d = 0; d < 3; ++d) dvit[d] += dlit * ab[d] / lit;
    // vit[1] = v[1] - lin: its cotangent reaches v[1] once directly and once,
    // negated, through lin
    dv[0] = dvit[0];
    dv[1] = dlin;
    dv[2] = dvit[2];
  }
  for (int ip = g.n_prim - 1; ip >= 0; --ip)
    if (controlled & (1u << ip))
      for (int d = 0; d < 3; ++d) {
        atomicAdd(dvs + 3 * ip + d, (double)(dv[d] / g.dt));
        dv[d] = 0.f;
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
  dgrid[cell] = make_float4(dmom[0], dmom[1], dmom[2], dm);
}

// Adjoint of the stress and P2G for each particle: gathers the cotangents
// of its stencil nodes' momentum and mass and writes the cotangents of the
// input carry's v, C and F, adds P2G's part to x's; the Lame parameters' and
// the yield stress's cotangents gather into acc (3 x P, in double: summed
// over the substeps, the terms cancel to ~1e-2 of their size).
__device__ void particle_adjoint(const float* c, float* cot, double* acc, int P, const Args& g,
                                 int b, const float4* dgrid) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
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
}

// Adjoint of the primitives' forward kinematics at substep t (one thread).
// dP, dQ hold the cotangents of frame t + 1; they leave holding frame t's.
__device__ void fk_adjoint(const Args& g, const BwdArgs& a, int b, int t, const float* rows,
                           const double* dvs, float (*dP)[3], float (*dQ)[4]) {
  const int np = g.n_prim, steps = g.steps;
  for (int ip = 0; ip < np; ++ip) {
    const float* fr = g.prim_frame + ((size_t)b * np + ip) * PRIM_FRAME;
    const float* r = rows + ((size_t)t * np + ip) * ROW;
    const float* vw = g.prim_vw + (((size_t)b * np + ip) * steps + t) * 6;
    float* gvw = a.gvw + (((size_t)b * np + ip) * steps + t) * 6;
    // p_{t+1} = clip(p_t + v_t, -2, 2); substep 0 reads the input row 0
    float draw[3];
    for (int d = 0; d < 3; ++d) {
      float pt = t == 0 ? fr[d] : r[d];
      draw[d] = dP[ip][d] * clip_grad(pt + vw[d], -2.f, 2.f);
      gvw[d] = (float)(dvs[3 * ip + d] + (double)draw[d]);
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
      for (int k = 0; k < 4; ++k) dot += dQ[ip][k] * (o[k] / n);
      for (int k = 0; k < 4; ++k) dO[k] = (dQ[ip][k] - (o[k] / n) * dot) / n;
    } else {
      for (int k = 0; k < 4; ++k) dO[k] = dQ[ip][k] / n;
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
      // re-clips of the later substeps (1/2 each at a bound), plus its use
      const size_t row = ((size_t)b * np + ip) * (steps + 1) + t;
      float tie = 1.f;
      for (int k = t; k < steps; ++k) tie *= 0.5f;
      for (int d = 0; d < 3; ++d)
        dP[ip][d] = a.dpos[row * 3 + d] * (fabsf(r[d]) == 2.f ? tie : 1.f) + draw[d];
      for (int d = 0; d < 4; ++d) dQ[ip][d] = a.drot[row * 4 + d] + dq[d];
    } else {
      float* gf = a.gframe + ((size_t)b * np + ip) * PRIM_FRAME;
      for (int d = 0; d < 3; ++d) gf[d] = draw[d];
      for (int d = 0; d < 4; ++d) gf[3 + d] = dq[d];
      for (int d = 7; d < PRIM_FRAME; ++d) gf[d] = 0.f;  // size, friction, softness
    }
  }
}

__global__ void __launch_bounds__(NT) mpm_step_bwd_kernel(Args g, BwdArgs a) {
  extern __shared__ float smem[];
  __shared__ Prim prims[MAX_PRIM];
  __shared__ int n_touched;
  __shared__ double dvs[MAX_PRIM * 3];
  __shared__ double red[NT];
  __shared__ float dP[MAX_PRIM][3], dQ[MAX_PRIM][4];

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int P = g.P, steps = g.steps, K = g.K, np = g.n_prim;
  const size_t cells = (size_t)g.rx * g.ry * g.rz;
  float* ps = smem;                                   // N_COMP * P: a segment's carry
  float* cot = ps + (size_t)N_COMP * P;               // N_COMP * P: the carry's cotangent
  float* rows = cot + (size_t)N_COMP * P;             // (steps + 1) * n_prim * ROW
  int* touched = (int*)(rows + (size_t)(steps + 1) * np * ROW);  // list capacity
  // 3 * P doubles: mu, lamda, yield stress, 8-byte aligned after the list
  double* acc = (double*)(((size_t)(touched + a.list_cap) + 7) & ~(size_t)7);
  float4* grid = g.grid + (size_t)b * cells;
  int* mark = g.mark + (size_t)b * cells;
  float4* dgrid = a.dgrid + (size_t)b * cells;
  float4* pre = a.pre + (size_t)b * a.list_cap;
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  double dgf = 0.0;

  for (int p = tid; p < P; p += nt) {
    size_t o = (size_t)b * P + p;
    for (int d = 0; d < 3; ++d) {
      cot[(IX + d) * P + p] = a.dx[o * 3 + d];
      cot[(IV + d) * P + p] = a.dv[o * 3 + d];
    }
    for (int e = 0; e < 9; ++e) {
      cot[(IC + e) * P + p] = a.dC[o * 9 + e];
      cot[(IF + e) * P + p] = a.dF[o * 9 + e];
    }
    cot[IJ * P + p] = a.dJ[o];
    acc[p] = acc[P + p] = acc[2 * P + p] = 0.0;
  }
  if (tid == 0) {
    fk_rows(g, b, rows);
    // frame steps is output twice: row steps and, by copy_frame, row 0
    for (int ip = 0; ip < np; ++ip) {
      const size_t row = ((size_t)b * np + ip) * (steps + 1);
      for (int d = 0; d < 3; ++d) dP[ip][d] = a.dpos[(row + steps) * 3 + d] + a.dpos[row * 3 + d];
      for (int d = 0; d < 4; ++d) dQ[ip][d] = a.drot[(row + steps) * 4 + d] + a.drot[row * 4 + d];
    }
  }
  __syncthreads();

  const int n_seg = (steps + K - 1) / K;
  for (int s = n_seg - 1; s >= 0; --s) {
    const int t0 = s * K, L = min(K, steps - t0);
    const float* base;  // the segment's L input carries, (L, N_COMP, P)
    if (K == 1) {
      base = g.hist + ((size_t)b * n_seg + s) * N_COMP * P;
    } else {  // K2-seg, as a phase of this launch
      float* out = a.seg + (size_t)b * K * N_COMP * P;
      seg_recompute(g, b, s, out, ps, rows, prims, grid, mark, touched, &n_touched, gf);
      base = out;
    }
    for (int t = t0 + L - 1; t >= t0; --t) {
      const float* c = base + (size_t)(t - t0) * N_COMP * P;
      // recompute the substep up to the grid ops
      if (tid == 0) {
        load_prims(g, b, t, rows, prims);
        n_touched = 0;
        for (int k = 0; k < 3 * MAX_PRIM; ++k) dvs[k] = 0.0;
      }
      zero_stencils(c, P, g, grid, mark, dgrid);
      __syncthreads();
      p2g(c, nullptr, P, g, b, grid, mark, touched, &n_touched);
      __syncthreads();
      const int n = n_touched;
      grid_ops(touched, n, grid, prims, gf, g, pre);
      __syncthreads();
      // then each stage's adjoint in reverse
      g2p_adjoint(c, cot, P, g, grid, dgrid);
      __syncthreads();
      for (int i = tid; i < n; i += nt) grid_op_bwd(touched[i], pre[i], dgrid, prims, gf, g, dvs, dgf);
      __syncthreads();
      particle_adjoint(c, cot, acc, P, g, b, dgrid);
      if (tid == 0) fk_adjoint(g, a, b, t, rows, dvs, dP, dQ);
      __syncthreads();
    }
  }

  for (int p = tid; p < P; p += nt) {
    size_t o = (size_t)b * P + p;
    for (int d = 0; d < 3; ++d) {
      a.gx[o * 3 + d] = cot[(IX + d) * P + p];
      a.gv[o * 3 + d] = cot[(IV + d) * P + p];
    }
    for (int e = 0; e < 9; ++e) {
      a.gC[o * 9 + e] = cot[(IC + e) * P + p];
      a.gF[o * 9 + e] = cot[(IF + e) * P + p];
    }
    a.gJ[o] = cot[IJ * P + p];
    if (g.mu_sp) a.gmu[o] = (float)acc[p];
    if (g.la_sp) a.gla[o] = (float)acc[P + p];
    if (g.ys_sp) a.gys[o] = (float)acc[2 * P + p];
  }
  red[tid] = dgf;
  __syncthreads();
  if (tid == 0) {
    double sgf = 0.0, smu = 0.0, sla = 0.0, sys = 0.0;
    for (int k = 0; k < nt; ++k) sgf += red[k];
    for (int p = 0; p < P; ++p) {
      smu += acc[p];
      sla += acc[P + p];
      sys += acc[2 * P + p];
    }
    a.ggf[b] = (float)sgf;
    if (!g.mu_sp) a.gmu[b] = (float)smu;
    if (!g.la_sp) a.gla[b] = (float)sla;
    if (!g.ys_sp) a.gys[b] = (float)sys;
  }
}

int list_capacity(int P, int cells) {
  long cap = 27L * P;
  return (int)(cap < cells ? cap : cells);
}

// dynamic shared memory: the carry (and, backward, its cotangent), the
// primitive rows, the touched list (and, backward, the three per-particle
// accumulators in double, with 8 bytes of alignment slack)
size_t smem_bytes(int P, int cells, int steps, int n_prim, bool bwd) {
  size_t floats = (size_t)(bwd ? 2 * N_COMP : N_COMP) * P + (size_t)(steps + 1) * n_prim * ROW;
  size_t bytes = sizeof(float) * floats + sizeof(int) * (size_t)list_capacity(P, cells);
  return bwd ? bytes + 8 + sizeof(double) * 3 * (size_t)P : bytes;
}

template <typename Kernel>
cudaError_t prepare_launch(Kernel kernel, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

const char* unidom_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

size_t mpm_step_smem_bytes(int P, int cells, int steps, int n_prim, int bwd) {
  return smem_bytes(P, cells, steps, n_prim, bwd != 0);
}

// The forward's arguments, shared by the three entry points. hist (B,
// ceil(steps / K), N_COMP, P) receives the carry every K substeps (K2-fwd)
// or holds it (K2-seg, K2-bwd); K2-fwd writes no history when it is null.
int mpm_step_launch(const float* x, const float* v, const float* C, const float* F, const float* J,
                 const float* mu, int mu_sb, int mu_sp, const float* lamda, int la_sb, int la_sp,
                 const float* ys, int ys_sb, int ys_sp, const float* ground_friction, int gf_sb,
                 const float* hardness, const int* material, const float* prim_frame,
                 const float* prim_vw, float* x_out, float* v_out, float* C_out, float* F_out,
                 float* J_out, float* traj_pos, float* traj_rot, float* grid, int* mark,
                 float* hist, int K, int B, int P, int n_prim, int steps, int rx, int ry, int rz,
                 int n_grid, int use_pc, int sdf_kinds, float dt, float dx, float stress_c1,
                 float dx2, float p_mass, float gx, float gy, float gz, int device, void* stream,
                 int what, int segment, float* seg_out, const float* const* bwd_in,
                 float* const* bwd_out, float* bwd_scratch, int list_cap) {
  if (B < 1 || P < 1 || n_prim < 0 || n_prim > MAX_PRIM || steps < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  Args g;
  g.x = x; g.v = v; g.C = C; g.F = F; g.J = J;
  g.mu = mu; g.lamda = lamda; g.ys = ys;
  g.mu_sb = mu_sb; g.mu_sp = mu_sp; g.la_sb = la_sb; g.la_sp = la_sp; g.ys_sb = ys_sb; g.ys_sp = ys_sp;
  g.ground_friction = ground_friction; g.gf_sb = gf_sb;
  g.hardness = hardness; g.material = material;
  g.prim_frame = prim_frame; g.prim_vw = prim_vw;
  g.x_out = x_out; g.v_out = v_out; g.C_out = C_out; g.F_out = F_out; g.J_out = J_out;
  g.traj_pos = traj_pos; g.traj_rot = traj_rot;
  g.grid = (float4*)grid; g.mark = mark;
  g.hist = hist; g.K = K;
  g.P = P; g.n_prim = n_prim; g.steps = steps;
  g.rx = rx; g.ry = ry; g.rz = rz; g.n_grid = n_grid; g.use_pc = use_pc; g.sdf_kinds = sdf_kinds;
  g.dt = dt; g.dx = dx; g.inv_dx = (float)n_grid; g.stress_c1 = stress_c1; g.dx2 = dx2;
  g.p_mass = p_mass; g.gx = gx; g.gy = gy; g.gz = gz;
  const int cells = rx * ry * rz;
  cudaError_t err;
  if (what == 0) {  // K2-fwd
    size_t smem = smem_bytes(P, cells, steps, n_prim, false);
    if ((err = prepare_launch(mpm_step_fwd_kernel, smem, device)) != cudaSuccess) return (int)err;
    mpm_step_fwd_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(g);
  } else if (what == 1) {  // K2-seg alone
    if (!hist || segment < 0 || segment * K >= steps) return (int)cudaErrorInvalidValue;
    size_t smem = smem_bytes(P, cells, steps, n_prim, false);
    if ((err = prepare_launch(mpm_step_seg_kernel, smem, device)) != cudaSuccess) return (int)err;
    mpm_step_seg_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(g, segment, seg_out);
  } else {  // K2-bwd, with K2-seg as a phase of each segment when K > 1
    if (!hist || use_pc == 0) return (int)cudaErrorInvalidValue;
    BwdArgs a;
    a.dx = bwd_in[0]; a.dv = bwd_in[1]; a.dC = bwd_in[2]; a.dF = bwd_in[3]; a.dJ = bwd_in[4];
    a.dpos = bwd_in[5]; a.drot = bwd_in[6];
    a.gx = bwd_out[0]; a.gv = bwd_out[1]; a.gC = bwd_out[2]; a.gF = bwd_out[3]; a.gJ = bwd_out[4];
    a.gmu = bwd_out[5]; a.gla = bwd_out[6]; a.gys = bwd_out[7]; a.ggf = bwd_out[8];
    a.gframe = bwd_out[9]; a.gvw = bwd_out[10];
    a.seg = seg_out;
    a.dgrid = (float4*)bwd_scratch;
    a.pre = (float4*)(bwd_scratch + (size_t)B * cells * 4);
    a.list_cap = list_cap;
    if (list_cap < list_capacity(P, cells) || (K > 1 && !seg_out)) return (int)cudaErrorInvalidValue;
    size_t smem = smem_bytes(P, cells, steps, n_prim, true);
    if ((err = prepare_launch(mpm_step_bwd_kernel, smem, device)) != cudaSuccess) return (int)err;
    mpm_step_bwd_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(g, a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
