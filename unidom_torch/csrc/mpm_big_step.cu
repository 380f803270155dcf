// MLS-MPM macro step on big grids for Hopper (sm_90a): kernels K3-fwd,
// K3-seg and K3-bwd.
//
// Replaces unidom_tpu/ops/pallas/mpm_big_kernel.py's forward (fwd_call ->
// fwd_kernel; each substep run_substep = stage1, p2g_chunk, gridop_slab,
// g2p_chunk and fk; with a gradient, _store_ckpt), its segment recompute
// (seg_hist_call -> _make_seg_kernel) and its backward (bwd_step_call ->
// bwd_step_kernel, one substep's adjoint, under the reverse scan _core_bwd).
// K3-fwd runs one macro step of conf.steps substeps for configurations
// that one block cannot hold (pour_soup: 7,694 particles on a 128x64x128
// grid; shape_elasto_plastic: 23,940 particles). It computes what
// unidom_torch/engine/mpm.py's plain _substep computes, conf.steps times, then
// the primitives' buffer roll of _run_substeps (row 0 <- row steps), with the
// device code that K2 uses (mpm_device.cuh): F update, SVD, the return map and
// stress of each particle's material, P2G, the grid ops (mass normalisation,
// gravity, SDF collision or position control of each primitive, ground
// friction, walls), G2P and advection, and the primitives' forward
// kinematics. In a rollout nothing is differentiated, so it writes no
// history; with a gradient wanted it also writes the carry of every K-th
// substep (K from ops/cuda/mpm_big_kernel.py's stride rule). K3-seg re-runs
// a segment of up to K substeps from its checkpoint with K3-fwd's launches
// and writes each substep's input carry. K3-bwd is the macro step's
// adjoint: per substep, in reverse, from the substep's input carry (the
// history at K = 1, else the segment K3-seg wrote) it recomputes the raw
// P2G grid and its touched list, runs the grid ops into the post-op grid
// keeping each cell's momentum and mass, then takes the adjoints of G2P (a
// gather of the post-op grid; the nodes' cotangents scatter into the grid
// cotangent by double atomics), of the grid ops per touched cell (with
// collide's adjoint), of P2G (a gather from the grid cotangent) and the
// stress, return maps, SVD and F update, and of the primitives' forward
// kinematics (one thread per env): the per-particle and per-cell bodies of
// mpm_device.cuh that K2-bwd runs.
//
// What bounds it on this card: operations, as K2-fwd (3,397 float32
// operations per particle-substep and ~78 per touched cell): pour_soup at 32
// envs is 20.9 GFLOP per macro step against ~50 MB of state in and out, so
// ~0.31 ms at 67 TFLOP/s. K3-bwd: 10,071 operations per particle-substep
// (the forward once and its adjoint, as K2-bwd) and the touched cells' grid
// ops and their adjoint. This first design is far from either bound: every
// phase reads and writes the particle state in device memory, P2G and
// G2P's adjoint add with atomics in device memory (in double when a
// gradient is wanted, below), and each substep is four launches forward,
// seven backward. A rollout sums P2G in float: the double sums made K3-fwd
// 30-45% slower (H100, chip_smoke.py's [big-time]).
//
// Design (right and simple first):
//   - Many blocks per env: the particle phases run on a grid of
//     (ceil(P / 256), B) blocks, one thread per particle. The particle state
//     lives in device memory, component-major per env (B, 25, P), so that a
//     warp's loads of one component coalesce; a pack launch copies the
//     inputs in (and computes the primitives' frames), an unpack launch
//     copies the outputs and the trajectory rows out.
//   - Four launches per substep; a launch boundary is the only barrier
//     between the blocks of an env:
//       1. zero the grid and marks under every particle's stencil (and the
//          env's touched-cell count);
//       2. F update, SVD, return map and stress, then P2G by atomicAdd into
//          the env's sums of momentum and mass in device memory (the float4
//          grid itself in a rollout; doubles when a gradient is wanted,
//          below); the first mark of a node appends it to the env's touched
//          list, by an atomic on the env's count in device memory;
//       3. the grid ops, one thread per touched cell (a grid-stride loop over
//          the env's list; each block loads the substep's primitives into
//          shared memory), from the sums (rounded to float) into the float4
//          grid of velocities (and mass) that G2P reads;
//       4. G2P, advection and J.
//     Launches rather than one cooperative kernel: pour_soup at 32 envs is
//     992 blocks, more than the card may hold resident for a grid-wide
//     barrier at this register count.
//   - No sort and no window. The Pallas kernel sorts particles by cell each
//     macro step only so that its x/y windows cover each 128-particle chunk,
//     and drops support outside a window; a scatter needs neither. Nodes
//     outside the grid are dropped as the plain step drops them, and nothing
//     else is. Outputs stay in the particles' order.
//   - The primitives' frames of all substeps (steps + 1 rows) are computed
//     once per env in the pack launch, as K2-fwd does.
//   - Every per-env offset is taken in size_t (pour_soup at 128 envs holds
//     more than 2^31 bytes of grid).
//   - K3-bwd's per-env sums (the primitives' cotangents of a substep, the
//     ground friction's, the Lame parameters' and yield stress's when they
//     are per env) first sum over a block in shared memory in double, then
//     one double atomicAdd per block and component adds into the env's
//     accumulators in device memory; the per-particle Lame and yield
//     cotangents stay in double over the substeps (their terms cancel to
//     ~1e-2 of their size), as in K2-bwd.
//   - When a gradient is wanted (K3-fwd with checkpoints, K3-seg, K3-bwd),
//     P2G sums in double, so that its result does not depend on the order
//     of the atomics at float32's precision: K3-bwd recomputes each
//     substep's grid from the saved carry and so takes the adjoint at the
//     grid the forward used. G2P's adjoint sums the grid cotangent in
//     double too, so the gradient does not depend on the order either. With float sums in another order, shape_elasto_plastic's
//     primitive cotangents, sums of 1/dt-amplified terms that cancel, landed
//     2.3x further from float64 than the float32 plain step's (H100,
//     chip_smoke.py's [big-bwd-parity]).
//   - Scratch per env beside K3-fwd's: P2G's double sums (32 B per cell),
//     the grid cotangent's double sums (32 B) and float4 (16 B),
//     each touched cell's momentum and mass before the grid ops (16 B per
//     list slot), the carry's cotangent and the per-particle accumulators,
//     and with K > 1 a segment of K carries.
//   - IEEE division and square roots; atomics add in a varying order, so
//     a rollout is not bitwise reproducible from run to run, and a
//     gradient's double sums only where one lies at a float's rounding
//     boundary.

#include "mpm_device.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int N_EACC = N_ACC + 3;  // an env's accumulators: the primitives', gf, mu, lamda, ys

// What K3 keeps in device memory beside the forward's Args (g.grid and
// g.mark are the per-env grid and marks, (B, cells)).
struct BigArgs {
  GridAcc* gacc;       // (B, cells): P2G's momentum and mass in double, or null
  float* ps;           // the working carry of env b at ps + b * ps_stride, (N_COMP, P)
  size_t ps_stride;
  float* rows;         // (B, steps + 1, n_prim, ROW): the primitives' frames
  int* touched;        // (B, list_cap): the touched cells of the substep
  int* n_touched;      // (B,): how many
  int list_cap;
  const float* src;    // zero launch: copy env b's carry from src + b * src_stride first
  size_t src_stride;
  float* save;         // zero launch: then copy it to save + b * save_stride
  size_t save_stride;
};

// What K3-bwd reads and writes beside them.
struct BigBwd {
  const float *dx, *dv, *dC, *dF, *dJ;  // cotangents of the outputs, (B, P, ...)
  const float *dpos, *drot;             // (B, n_prim, steps + 1, 3 / 4)
  float *gx, *gv, *gC, *gF, *gJ;        // cotangents of the inputs, (B, P, ...)
  float *gmu, *gla, *gys;               // as the inputs: (B, 1) or (B, P)
  float* ggf;                           // (B, 1)
  float* gframe;                        // (B, n_prim, PRIM_FRAME)
  float* gvw;                           // (B, n_prim, steps, 6)
  float* cot;                           // (B, N_COMP, P): the carry's cotangent
  GridAcc* dsum;                        // (B, cells): G2P's adjoint's sums, in double
  float4* dgrid;                        // (B, cells): cotangent of momentum xyz and mass
  float4* pre;                          // (B, list_cap): each touched cell before the grid ops
  float* dpq;                           // (B, MAX_PRIM, 7): the current frame's cotangent
  double* pacc;                         // (B, 3, P): mu, lamda, yield stress per particle
  double* eacc;                         // (B, N_EACC)
};

__device__ __forceinline__ size_t env_cells(const Args& g) { return (size_t)g.rx * g.ry * g.rz; }

// P2G's sums: in the float4 grid itself (a rollout), or in double (the
// gradient's forward, K3-seg and K3-bwd)
template <class G>
__device__ __forceinline__ G* sums(const Args& g, const BigArgs& a);
template <>
__device__ __forceinline__ float4* sums<float4>(const Args& g, const BigArgs& a) {
  return g.grid;
}
template <>
__device__ __forceinline__ GridAcc* sums<GridAcc>(const Args& g, const BigArgs& a) {
  return a.gacc;
}

__device__ __forceinline__ float* env_carry(const BigArgs& a, int b) {
  return a.ps + (size_t)b * a.ps_stride;
}

__device__ __forceinline__ float* env_rows(const Args& g, const BigArgs& a, int b) {
  return a.rows + (size_t)b * (g.steps + 1) * g.n_prim * ROW;
}

// the inputs into the carry; block 0 of each env computes its frames
__global__ void __launch_bounds__(NT) big_pack_kernel(Args g, BigArgs a) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) fk_rows(g, b, env_rows(g, a, b));
  if (p >= P) return;
  float* ps = env_carry(a, b);
  const size_t o = (size_t)b * P + p;
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

// 1. the carry copied in from a.src and out to a.save where they are set,
// then the grid (and its cotangent's sums, when dsum is set) and marks
// under each particle's stencil to 0
template <class G>
__global__ void __launch_bounds__(NT) big_zero_kernel(Args g, BigArgs a, GridAcc* dsum) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) a.n_touched[b] = 0;
  if (p >= P) return;
  float* ps = env_carry(a, b);
  if (a.src) {
    const float* src = a.src + (size_t)b * a.src_stride;
    for (int c = 0; c < N_COMP; ++c) ps[c * P + p] = src[c * P + p];
  }
  if (a.save) {
    float* save = a.save + (size_t)b * a.save_stride;
    for (int c = 0; c < N_COMP; ++c) save[c * P + p] = ps[c * P + p];
  }
  const float x[3] = {ps[IX * P + p], ps[(IX + 1) * P + p], ps[(IX + 2) * P + p]};
  const size_t cells = env_cells(g);
  zero_stencil(x, g, sums<G>(g, a) + (size_t)b * cells, g.mark + (size_t)b * cells,
               dsum ? dsum + (size_t)b * cells : dsum);
}

// 2. stress and P2G; F after the return map back into the carry when write_F
template <class G>
__global__ void __launch_bounds__(NT) big_p2g_kernel(Args g, BigArgs a, int write_F) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float* ps = env_carry(a, b);
  const size_t cells = env_cells(g);
  p2g_particle(ps, write_F ? ps : nullptr, P, p, g, b, sums<G>(g, a) + (size_t)b * cells,
               g.mark + (size_t)b * cells, a.touched + (size_t)b * a.list_cap, a.n_touched + b);
}

// 3. the grid ops of substep f on the env's touched cells, from P2G's sums
// (rounded to float) into the float4 grid that G2P reads; pre, when set,
// keeps each cell's momentum and mass before them
template <class G>
__global__ void __launch_bounds__(NT) big_grid_kernel(Args g, BigArgs a, int f, float4* pre) {
  __shared__ Prim prims[MAX_PRIM];
  const int b = blockIdx.y;
  if (threadIdx.x == 0) load_prims(g, b, f, env_rows(g, a, b), prims);
  __syncthreads();
  const int n = a.n_touched[b];
  const int* touched = a.touched + (size_t)b * a.list_cap;
  const size_t cells = env_cells(g);
  const G* sum = sums<G>(g, a) + (size_t)b * cells;
  float4* grid = g.grid + (size_t)b * cells;
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int cell = touched[i];
    const float4 gv = grid_load(sum, cell);
    if (pre) pre[(size_t)b * a.list_cap + i] = gv;
    grid[cell] = grid_op_value(cell, gv, prims, gf, g);
  }
}

// 4. G2P, advection and J
__global__ void __launch_bounds__(NT) big_g2p_kernel(Args g, BigArgs a) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  g2p_advect_particle(env_carry(a, b), P, p, g, g.grid + (size_t)b * env_cells(g));
}

// the carry out; block 0 of each env writes the trajectory rows 1 .. steps
// and copy_frame's row 0 <- row steps
__global__ void __launch_bounds__(NT) big_unpack_kernel(Args g, BigArgs a) {
  const int b = blockIdx.y, P = g.P, steps = g.steps, np = g.n_prim;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0) {
    const float* rows = env_rows(g, a, b);
    for (int k = threadIdx.x; k < (steps + 1) * np; k += blockDim.x) {
      int f = k / np, ip = k % np;
      const float* r = rows + ((size_t)(f == 0 ? steps : f) * np + ip) * ROW;
      size_t row = ((size_t)b * np + ip) * (steps + 1) + f;
      for (int d = 0; d < 3; ++d) g.traj_pos[row * 3 + d] = r[d];
      for (int d = 0; d < 4; ++d) g.traj_rot[row * 4 + d] = r[3 + d];
    }
  }
  if (p >= P) return;
  const float* ps = env_carry(a, b);
  const size_t o = (size_t)b * P + p;
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

// ------------------------------------------------------------------ K3-bwd

// the frames of every env, one thread each (K3-seg and K3-bwd)
__global__ void __launch_bounds__(NT) big_rows_kernel(Args g, BigArgs a, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) fk_rows(g, b, env_rows(g, a, b));
}

// the output cotangents into the carry's; the accumulators to 0; frame
// steps is output twice, as row steps and, by copy_frame, as row 0
__global__ void __launch_bounds__(NT) big_bwd_pack_kernel(Args g, BigBwd w) {
  const int b = blockIdx.y, P = g.P, np = g.n_prim, steps = g.steps;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < N_EACC; k += blockDim.x) w.eacc[(size_t)b * N_EACC + k] = 0.0;
    for (int k = threadIdx.x; k < np * 7; k += blockDim.x) {
      const int ip = k / 7, d = k % 7;
      const size_t row = ((size_t)b * np + ip) * (steps + 1);
      w.dpq[(size_t)b * MAX_PRIM * 7 + k] =
          d < 3 ? w.dpos[(row + steps) * 3 + d] + w.dpos[row * 3 + d]
                : w.drot[(row + steps) * 4 + d - 3] + w.drot[row * 4 + d - 3];
    }
  }
  if (p >= P) return;
  float* cot = w.cot + (size_t)b * N_COMP * P;
  double* pacc = w.pacc + (size_t)b * 3 * P;
  const size_t o = (size_t)b * P + p;
  for (int d = 0; d < 3; ++d) {
    cot[(IX + d) * P + p] = w.dx[o * 3 + d];
    cot[(IV + d) * P + p] = w.dv[o * 3 + d];
  }
  for (int e = 0; e < 9; ++e) {
    cot[(IC + e) * P + p] = w.dC[o * 9 + e];
    cot[(IF + e) * P + p] = w.dF[o * 9 + e];
  }
  cot[IJ * P + p] = w.dJ[o];
  pacc[p] = pacc[P + p] = pacc[2 * P + p] = 0.0;
}

// 4'. G2P's and advection's adjoint: a gather of the post-op grid, a
// scatter into the grid cotangent
__global__ void __launch_bounds__(NT) big_g2p_bwd_kernel(Args g, BigArgs a, BigBwd w) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t cells = env_cells(g);
  g2p_adjoint_particle(env_carry(a, b), w.cot + (size_t)b * N_COMP * P, P, p, g,
                       g.grid + (size_t)b * cells, w.dsum + (size_t)b * cells);
}

// the block's sums in shared memory, in double
struct BlockAcc {
  double* a;
  __device__ __forceinline__ void add(int k, double v) {
    if (v != 0.0) atomicAdd(a + k, v);
  }
};

// 3'. the grid ops' adjoint on the env's touched cells; the primitives' and
// the ground friction's cotangents sum over the block, then into the env's
__global__ void __launch_bounds__(NT) big_grid_bwd_kernel(Args g, BigArgs a, BigBwd w, int f) {
  __shared__ Prim prims[MAX_PRIM];
  __shared__ double sacc[N_ACC];
  const int b = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) load_prims(g, b, f, env_rows(g, a, b), prims);
  for (int k = tid; k < N_ACC; k += blockDim.x) sacc[k] = 0.0;
  __syncthreads();
  const int n = a.n_touched[b];
  const int* touched = a.touched + (size_t)b * a.list_cap;
  const float4* pre = w.pre + (size_t)b * a.list_cap;
  const GridAcc* dsum = w.dsum + (size_t)b * env_cells(g);
  float4* dgrid = w.dgrid + (size_t)b * env_cells(g);
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  BlockAcc acc{sacc};
  for (int i = blockIdx.x * blockDim.x + tid; i < n; i += gridDim.x * blockDim.x)
    grid_op_bwd(touched[i], pre[i], dsum, dgrid, prims, gf, g, acc);
  __syncthreads();
  double* eacc = w.eacc + (size_t)b * N_EACC;
  for (int k = tid; k < N_ACC; k += blockDim.x)
    if (sacc[k] != 0.0) atomicAdd(eacc + k, sacc[k]);
}

// 2'. P2G's adjoint (a gather from the grid cotangent) and the stress's,
// the return maps', the SVD's and F's update's
__global__ void __launch_bounds__(NT) big_particle_bwd_kernel(Args g, BigArgs a, BigBwd w) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  particle_adjoint_particle(env_carry(a, b), w.cot + (size_t)b * N_COMP * P,
                            w.pacc + (size_t)b * 3 * P, P, p, g, b,
                            w.dgrid + (size_t)b * env_cells(g));
}

// the forward kinematics' adjoint at substep t, one thread per env; the
// substep's primitive cotangents back to 0
__global__ void __launch_bounds__(NT) big_fk_bwd_kernel(Args g, BigArgs a, BigBwd w, int t,
                                                        int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  double* eacc = w.eacc + (size_t)b * N_EACC;
  fk_adjoint(g, b, t, env_rows(g, a, b), eacc, w.dpos, w.drot, w.gframe, w.gvw,
             w.dpq + (size_t)b * MAX_PRIM * 7);
  for (int k = 0; k < MAX_PRIM * NPA; ++k)
    if (k % NPA < PA_SIZE) eacc[k] = 0.0;
}

// the cotangents out: the carry's, the per-particle Lame and yield ones, and
// their sums over the env's particles (over the block in shared memory)
__global__ void __launch_bounds__(NT) big_bwd_unpack_kernel(Args g, BigBwd w) {
  __shared__ double sums[3];
  const int b = blockIdx.y, P = g.P, tid = threadIdx.x;
  const int p = blockIdx.x * blockDim.x + tid;
  if (tid < 3) sums[tid] = 0.0;
  __syncthreads();
  if (p < P) {
    const float* cot = w.cot + (size_t)b * N_COMP * P;
    const double* pacc = w.pacc + (size_t)b * 3 * P;
    const size_t o = (size_t)b * P + p;
    for (int d = 0; d < 3; ++d) {
      w.gx[o * 3 + d] = cot[(IX + d) * P + p];
      w.gv[o * 3 + d] = cot[(IV + d) * P + p];
    }
    for (int e = 0; e < 9; ++e) {
      w.gC[o * 9 + e] = cot[(IC + e) * P + p];
      w.gF[o * 9 + e] = cot[(IF + e) * P + p];
    }
    w.gJ[o] = cot[IJ * P + p];
    if (g.mu_sp) w.gmu[o] = (float)pacc[p];
    if (g.la_sp) w.gla[o] = (float)pacc[P + p];
    if (g.ys_sp) w.gys[o] = (float)pacc[2 * P + p];
    for (int k = 0; k < 3; ++k)
      if (pacc[k * P + p] != 0.0) atomicAdd(sums + k, pacc[k * P + p]);
  }
  __syncthreads();
  if (tid < 3 && sums[tid] != 0.0) atomicAdd(w.eacc + (size_t)b * N_EACC + N_ACC + tid, sums[tid]);
}

// the per-env cotangents out, one thread per env
__global__ void __launch_bounds__(NT) big_bwd_finish_kernel(Args g, BigBwd w, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double* eacc = w.eacc + (size_t)b * N_EACC;
  w.ggf[b] = (float)eacc[ACC_GF];
  if (!g.mu_sp) w.gmu[b] = (float)eacc[N_ACC];
  if (!g.la_sp) w.gla[b] = (float)eacc[N_ACC + 1];
  if (!g.ys_sp) w.gys[b] = (float)eacc[N_ACC + 2];
}

}  // namespace

extern "C" {

const char* unidom_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// K3's launches on the stream, counted into *n_launches. what 0: K3-fwd,
// one macro step (4 * steps + 2 launches), writing the carry of every K-th
// substep to hist (B, ceil(steps / K), N_COMP, P) and summing P2G in gacc
// (B, cells, 4 doubles), unless hist is null (a rollout: P2G sums in the
// float4 grid; gacc may be null). what 1:
// K3-seg alone, segment `segment` from hist into seg_out (B, L, N_COMP, P).
// what 2: K3-bwd from the history (with K3-seg into seg_out (B, K, N_COMP,
// P) per segment when K > 1), the output cotangents bwd_in (dx, dv, dC, dF,
// dJ, dpos, drot) and into bwd_out (the cotangents of x, v, C, F, J, mu,
// lamda, yield_stress, ground friction, frame, vw). grid (B, cells, 4) and
// mark (B, cells) are scratch that needs no clearing; ps (B, N_COMP, P),
// rows (B, steps + 1, n_prim, ROW), touched (B, list_cap) and n_touched (B)
// likewise; K3-bwd's scratch: bwd_floats, per env 4 cells + 4 list_cap +
// N_COMP P + 7 MAX_PRIM, and bwd_doubles, per env 4 cells + 3 P + N_EACC.
// grid_blocks is the number of blocks per env of the grid-op launches.
int mpm_big_step_launch(const float* x, const float* v, const float* C, const float* F,
                        const float* J, const float* mu, int mu_sb, int mu_sp, const float* lamda,
                        int la_sb, int la_sp, const float* ys, int ys_sb, int ys_sp,
                        const float* ground_friction, int gf_sb, const float* hardness,
                        const int* material, const float* prim_frame, const float* prim_vw,
                        float* x_out, float* v_out, float* C_out, float* F_out, float* J_out,
                        float* traj_pos, float* traj_rot, float* grid, double* gacc, int* mark,
                        float* ps,
                        float* rows, int* touched, int* n_touched, int list_cap, int grid_blocks,
                        int B, int P, int n_prim, int steps, int rx, int ry, int rz, int n_grid,
                        int use_pc, int sdf_kinds, float dt, float dx, float stress_c1, float dx2,
                        float p_mass, float gx, float gy, float gz, int device, void* stream,
                        float* hist, int K, int what, int segment, float* seg_out,
                        const float* const* bwd_in, float* const* bwd_out, float* bwd_floats,
                        double* bwd_doubles, int* n_launches) {
  *n_launches = 0;
  const long cells = (long)rx * ry * rz;
  if (B < 1 || B > 65535 || P < 1 || n_prim < 0 || n_prim > MAX_PRIM || steps < 1 ||
      cells < 1 || cells > 0x7fffffffL || list_cap < 1 || list_cap > cells || grid_blocks < 1 ||
      K < 1 || K > steps || what < 0 || what > 2 || (what > 0 && !hist) || (hist && !gacc))
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
  const size_t carry = (size_t)N_COMP * P;
  const int n_ckpt = (steps + K - 1) / K;
  BigArgs a;
  a.gacc = (GridAcc*)gacc;
  a.ps = ps; a.ps_stride = carry;
  a.rows = rows; a.touched = touched; a.n_touched = n_touched; a.list_cap = list_cap;
  a.src = nullptr; a.src_stride = 0; a.save = nullptr; a.save_stride = 0;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 particles((P + NT - 1) / NT, B), cells_grid(grid_blocks, B);
  const int env_blocks = (B + NT - 1) / NT;
#define UNIDOM_LAUNCHED()                                              \
  do {                                                                 \
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;   \
    ++*n_launches;                                                     \
  } while (0)
  // one forward substep f of the working carry, in place
#define UNIDOM_SUBSTEP(G, f)                                           \
  do {                                                                 \
    big_p2g_kernel<G><<<particles, NT, 0, s>>>(g, a, 1);               \
    UNIDOM_LAUNCHED();                                                 \
    big_grid_kernel<G><<<cells_grid, NT, 0, s>>>(g, a, (f), nullptr);  \
    UNIDOM_LAUNCHED();                                                 \
    big_g2p_kernel<<<particles, NT, 0, s>>>(g, a);                     \
    UNIDOM_LAUNCHED();                                                 \
  } while (0)
  // K3-seg: segment sg's L carries from its checkpoint into out (env
  // stride out_stride), the working carry ps; 4 L - 3 launches
#define UNIDOM_SEGMENT(sg, out, out_stride)                                          \
  do {                                                                               \
    const int t0_ = (sg) * K, L_ = K < steps - t0_ ? K : steps - t0_;                              \
    for (int j = 0; j < L_; ++j) {                                                   \
      a.src = j == 0 ? hist + (size_t)(sg) * carry : nullptr;                        \
      a.src_stride = (size_t)n_ckpt * carry;                                         \
      a.save = (out) + (size_t)j * carry;                                            \
      a.save_stride = (out_stride);                                                  \
      big_zero_kernel<GridAcc><<<particles, NT, 0, s>>>(g, a, (GridAcc*)nullptr);    \
      UNIDOM_LAUNCHED();                                                             \
      a.src = nullptr;                                                               \
      a.save = nullptr;                                                              \
      if (j + 1 < L_) UNIDOM_SUBSTEP(GridAcc, t0_ + j);                              \
    }                                                                                \
  } while (0)

  if (what == 0) {  // K3-fwd
    big_pack_kernel<<<particles, NT, 0, s>>>(g, a);
    UNIDOM_LAUNCHED();
    for (int f = 0; f < steps; ++f) {
      a.save = hist && f % K == 0 ? hist + (size_t)(f / K) * carry : nullptr;
      a.save_stride = (size_t)n_ckpt * carry;
      if (hist)
        big_zero_kernel<GridAcc><<<particles, NT, 0, s>>>(g, a, (GridAcc*)nullptr);
      else
        big_zero_kernel<float4><<<particles, NT, 0, s>>>(g, a, (GridAcc*)nullptr);
      UNIDOM_LAUNCHED();
      a.save = nullptr;
      if (hist)
        UNIDOM_SUBSTEP(GridAcc, f);
      else
        UNIDOM_SUBSTEP(float4, f);
    }
    big_unpack_kernel<<<particles, NT, 0, s>>>(g, a);
    UNIDOM_LAUNCHED();
    return (int)cudaSuccess;
  }
  big_rows_kernel<<<env_blocks, NT, 0, s>>>(g, a, B);
  UNIDOM_LAUNCHED();
  if (what == 1) {  // K3-seg alone
    if (segment < 0 || segment >= n_ckpt || !seg_out) return (int)cudaErrorInvalidValue;
    const int L = K < steps - segment * K ? K : steps - segment * K;
    UNIDOM_SEGMENT(segment, seg_out, (size_t)L * carry);
    return (int)cudaSuccess;
  }
  // K3-bwd
  if (!bwd_in || !bwd_out || !bwd_floats || !bwd_doubles || (K > 1 && !seg_out))
    return (int)cudaErrorInvalidValue;
  BigBwd w;
  w.dx = bwd_in[0]; w.dv = bwd_in[1]; w.dC = bwd_in[2]; w.dF = bwd_in[3]; w.dJ = bwd_in[4];
  w.dpos = bwd_in[5]; w.drot = bwd_in[6];
  w.gx = bwd_out[0]; w.gv = bwd_out[1]; w.gC = bwd_out[2]; w.gF = bwd_out[3]; w.gJ = bwd_out[4];
  w.gmu = bwd_out[5]; w.gla = bwd_out[6]; w.gys = bwd_out[7]; w.ggf = bwd_out[8];
  w.gframe = bwd_out[9]; w.gvw = bwd_out[10];
  w.dgrid = (float4*)bwd_floats;
  w.pre = w.dgrid + (size_t)B * cells;
  w.cot = (float*)(w.pre + (size_t)B * list_cap);
  w.dpq = w.cot + (size_t)B * carry;
  w.dsum = (GridAcc*)bwd_doubles;
  w.pacc = bwd_doubles + (size_t)B * cells * 4;
  w.eacc = w.pacc + (size_t)B * 3 * P;
  big_bwd_pack_kernel<<<particles, NT, 0, s>>>(g, w);
  UNIDOM_LAUNCHED();
  float* ps_work = a.ps;
  for (int sg = n_ckpt - 1; sg >= 0; --sg) {
    const int t0 = sg * K, L = K < steps - t0 ? K : steps - t0;
    const float* base;  // the segment's carries, env b's j-th at base + b * stride + j * carry
    size_t stride;
    if (K == 1) {
      base = hist + (size_t)sg * carry;
      stride = (size_t)n_ckpt * carry;
    } else {
      a.ps = ps_work;
      a.ps_stride = carry;
      UNIDOM_SEGMENT(sg, seg_out, (size_t)K * carry);
      base = seg_out;
      stride = (size_t)K * carry;
    }
    for (int t = t0 + L - 1; t >= t0; --t) {
      a.ps = (float*)(base + (size_t)(t - t0) * carry);  // read only from here on
      a.ps_stride = stride;
      big_zero_kernel<GridAcc><<<particles, NT, 0, s>>>(g, a, w.dsum);
      UNIDOM_LAUNCHED();
      big_p2g_kernel<GridAcc><<<particles, NT, 0, s>>>(g, a, 0);
      UNIDOM_LAUNCHED();
      big_grid_kernel<GridAcc><<<cells_grid, NT, 0, s>>>(g, a, t, w.pre);
      UNIDOM_LAUNCHED();
      big_g2p_bwd_kernel<<<particles, NT, 0, s>>>(g, a, w);
      UNIDOM_LAUNCHED();
      big_grid_bwd_kernel<<<cells_grid, NT, 0, s>>>(g, a, w, t);
      UNIDOM_LAUNCHED();
      big_particle_bwd_kernel<<<particles, NT, 0, s>>>(g, a, w);
      UNIDOM_LAUNCHED();
      big_fk_bwd_kernel<<<env_blocks, NT, 0, s>>>(g, a, w, t, B);
      UNIDOM_LAUNCHED();
    }
  }
  big_bwd_unpack_kernel<<<particles, NT, 0, s>>>(g, w);
  UNIDOM_LAUNCHED();
  big_bwd_finish_kernel<<<env_blocks, NT, 0, s>>>(g, w, B);
  UNIDOM_LAUNCHED();
#undef UNIDOM_SEGMENT
#undef UNIDOM_SUBSTEP
#undef UNIDOM_LAUNCHED
  return (int)cudaSuccess;
}

}  // extern "C"
