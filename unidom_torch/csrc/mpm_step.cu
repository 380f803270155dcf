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
// adjoint under position control or SDF collision, written out stage by
// stage: per substep, in reverse, it rebuilds the grid after the grid ops
// from what the segment's recompute recorded, then takes the adjoints of G2P and
// advection (a scatter of the nodes' velocity cotangents with atomics, and
// the weights' derivatives in x), of the grid ops per touched cell (with
// collide's adjoint: the second derivative of the SDF for the normal), of
// P2G (a gather), of the stress, the materials' return maps, the SVD
// (svd3_soa_bwd, term for term) and F's update, and of the primitives'
// forward kinematics.
//
// What bounds them on this card: operations. A particle-substep costs 3,397
// float32 operations forward (the SVD 1,414, P2G 837 and G2P 783 over the 27
// stencil nodes; counted in chip_smoke.py, FLOP_MPM_PARTICLE) and 10,071
// for the forward and its adjoint (FLOP_MPM_BWD_PARTICLE); whip_rope at 1024
// envs is about 18 and 51 GFLOP per macro step against tens of MB of state,
// history and cotangents. Each thread runs its particles' serial chains and
// every phase of a substep waits at a barrier for the slowest thread, so
// the time is set by the chain of one block (or cluster) when the batch
// fills the card, and by how much of the card the batch reaches when not.
//
// Design:
//   - K2-fwd and K2-bwd: a thread-block cluster per env (fwd_launch_config
//     and launch_config in ops/cuda/mpm_kernel.py pick its size from the
//     batch and the card's 132 SMs: shape_rope's 64 envs take 2 CTAs each,
//     one wave; whip_rope's 1024 envs fill the card with a cluster of 1).
//     The env's particles are split into the cluster's CTAs, ceil(P /
//     cluster) each, up to one particle per thread; each CTA keeps its
//     particles' carry in its own shared memory (and, backward, the carry's
//     cotangent and the Lame parameters' and yield stress's cotangents in
//     double), its own copy of the primitives' frames and its own
//     touched-cell list. Phases that cross particles (through the grid) are
//     separated by cluster.sync() (with a cluster of 1, __syncthreads()).
//     K2-fwd runs every substep with substep_fwd, the device code of K2-bwd's
//     segment recompute: the forward and the recompute are one code path.
//     K2-bwd: each CTA sums the primitives' and the ground
//     friction's cotangents of its cells (each thread in double over its
//     cells, then over the warp by shuffles, then one shared-memory atomic
//     per warp and slot); the cluster's first CTA reads its siblings' sums
//     through distributed shared memory (map_shared_rank) and runs the
//     forward kinematics' adjoint, one thread per primitive, on threads that
//     hold no particle where the block has such threads.
//   - K2-seg launched alone (ops/cuda/mpm_kernel.py mpm_step_seg) is the
//     phase K2-bwd runs: the same clusters, threads and shared memory
//     (launch_config), the same seg_recompute and last-carry head, each CTA
//     recording its grids; it writes the segment's carries and stops.
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
//     mark of a node appends it to the touched list of the CTA that made
//     it, and the grid ops run on those lists only. G2P reads the same
//     nodes, so cells no stencil touched are never read. K2-bwd adds a grid
//     of cotangents (zeroed on each substep's recorded cells, below) and
//     keeps each touched cell's momentum and mass before the grid ops, by
//     its CTA and slot.
//   - The primitives' frames of all substeps (steps + 1 rows) are computed
//     once per CTA by one thread into shared memory; each substep reads
//     its two.
//   - The history: K2-fwd writes the input of substeps 0, K, 2K, ... (each
//     CTA its particles'); with
//     K = 1 that is every substep's input and K2-bwd reads it directly;
//     with K > 1 K2-bwd runs K2-seg as the first phase of each segment,
//     into a per-env buffer of K carries in device memory, then walks the
//     segment in reverse. The wrapper picks K (ops/cuda/mpm_kernel.py).
//     As K2-seg runs a substep inside K2-bwd it records, per CTA, the
//     touched cells and their momentum and mass before the grid ops (and a
//     last P2G and grid ops record the segment's last carry, and with K = 1
//     the one carry); the reversed substep rebuilds the grid after the grid
//     ops on those cells, so it runs no P2G, no SVD and no stencil zeroing
//     of its own.
//   - IEEE division and square roots; atomics add in a varying order, so
//     results are not bitwise reproducible from run to run, and K = 1 and
//     K > 1 give slightly different gradients.
//   - The device code of a particle's or a cell's share of a substep,
//     forward and adjoint (the arguments, SVD and its adjoint, return maps
//     and stress, stencil, grid ops and collide's adjoint, SDFs, forward
//     kinematics), lives in mpm_device.cuh, shared with K3
//     (mpm_big_step.cu); the block-level loops and barriers are here.

#include <cooperative_groups.h>

#include "mpm_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FWD_MAX_NT = 640;   // K2-fwd's most threads per CTA (its register budget)
constexpr int BWD_MAX_NT = 320;   // K2-bwd's most threads per CTA (its register budget)
constexpr int MAX_CLUSTER = 8;    // the portable cluster size

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
  // a segment's grids (Record), per env and CTA K slots of list_cap cells
  float4* pre;                          // (B, cluster, K, list_cap): momentum and mass before the grid ops
  int* rec_cells;                       // (B, cluster, K, list_cap): the touched cells
  int* rec_n;                           // (B, cluster, K): how many
  int list_cap;                         // slots of a CTA's touched list
  int cluster;                          // CTAs per env
  int per_cta;                          // particles per CTA: ceil(P / cluster)
};

// the barrier between phases that cross particles: the cluster's, or with a
// cluster of 1 the block's
struct ClusterSync {
  int cs;
  __device__ __forceinline__ void operator()() const {
    if (cs > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
};
// ClusterSync that also times the phases between its calls on thread 0 of
// the launch's first CTA: clocks[k % 4] += clock64() cycles since the
// previous call (the k-th), clocks[4] the previous stamp and clocks[5] k.
// substep_fwd calls it four times (after the stencils' zeroing, P2G, the
// grid ops and G2P). [k2-design] launches K2-fwd with it; the main path's
// kernel is the ClusterSync instantiation.
struct StampedSync {
  ClusterSync sync;
  long long* clocks;  // (6,) in device memory, 0 on entry
  __device__ __forceinline__ void start() const {
    if (blockIdx.x == 0 && threadIdx.x == 0) clocks[4] = clock64();
  }
  __device__ __forceinline__ void operator()() const {
    sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const long long now = clock64();
      clocks[clocks[5] % 4] += now - clocks[4];
      clocks[4] = now;
      ++clocks[5];
    }
  }
};
__device__ __forceinline__ void start_clock(const ClusterSync&) {}
__device__ __forceinline__ void start_clock(const StampedSync& s) { s.start(); }

// the per-particle inputs of gl (a copy of the kernel's Args) from particle
// p0 on (a CTA's first), in place
__device__ __forceinline__ void from_particle(Args& gl, int p0) {
  gl.material += p0;
  gl.hardness += p0;
  gl.mu += (size_t)p0 * gl.mu_sp;
  gl.lamda += (size_t)p0 * gl.la_sp;
  gl.ys += (size_t)p0 * gl.ys_sp;
}

// ------------------------------------------------------------- substep phases
// Each runs on every thread of the block, a thread taking particles (or
// touched cells) tid, tid + blockDim.x, ...; the caller puts the barriers.
// A block's carry holds n particles at stride P (component c of particle p
// at c * P + p).

// zero the grid (and its cotangent) under every particle's stencil
__device__ void zero_stencils(const float* c, int n, int P, const Args& g, float4* grid,
                              int* mark, float4* dgrid) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float x[3] = {c[IX * P + p], c[(IX + 1) * P + p], c[(IX + 2) * P + p]};
    zero_stencil(x, g, grid, mark, dgrid);
  }
}

// stress and P2G from the carry c; F_out (may be c itself) takes F after the
// return map when not null; the first mark of a cell appends it to touched.
// Each node's shares sum over the warp's runs of particles in one bin before
// one float atomic (WarpScatter): consecutive particles along a rope share
// their bin, and one atomic per particle and node (a thin rope's ~40 shares
// per touched cell) serialised in L2. Every lane of a warp runs the loop to
// its end, a lane past n without a particle.
__device__ void p2g(const float* c, float* F_out, int n, int P, const Args& g, int b,
                    float4* grid, int* mark, int* touched, int* n_touched) {
  WarpScatter<float4> s{grid, mark, touched, n_touched, 0u, false};
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x - lane; q < n; q += blockDim.x) {
    const bool live = q + lane < n;
    p2g_particle(c, F_out, P, live ? q + lane : 0, live, g, b, s);
  }
}

// the grid ops on the touched cells; pre, when not null, keeps each cell's
// momentum and mass before them (slot i for touched[i])
__device__ void grid_ops(const int* touched, int n, float4* grid, const Prim* prims, float gf,
                         const Args& g, float4* pre) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    grid_op(touched[i], grid, prims, gf, g, pre ? pre + i : nullptr);
}

// G2P and advection of the carry ps, in place
__device__ void g2p_advect(float* ps, int n, int P, const Args& g, const float4* grid) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) g2p_advect_particle(ps, P, p, g, grid);
}

// What the grid held in one substep, for K2-bwd's reversed substep: the
// touched cells of one CTA (count, cells) and each one's momentum and mass
// before the grid ops.
struct Record {
  int* n;
  int* cells;
  float4* pre;
  __device__ __forceinline__ Record slot(size_t j, int cap) const {
    return {n + j, cells + j * cap, pre + j * cap};
  }
};

// The head of a forward substep f of the carry ps (shared memory, n
// particles at stride P): its stencils zeroed, P2G (F after the return map
// into F_out when not null) and the grid ops; with rec.n, the CTA's touched
// cells and their momentum and mass before the grid ops into rec. Thread 0
// loads the primitives of substep f from the rows first.
template <class Sync>
__device__ void substep_head(float* ps, float* F_out, int n, int P, int f, const Args& g, int b,
                             const float* rows, Prim* prims, float4* grid, int* mark,
                             int* touched, int* n_touched, float gf, Sync sync, Record rec) {
  if (threadIdx.x == 0) {
    load_prims(g, b, f, rows, prims);
    *n_touched = 0;
  }
  zero_stencils(ps, n, P, g, grid, mark, nullptr);
  sync();
  p2g(ps, F_out, n, P, g, b, grid, mark, touched, n_touched);
  sync();
  const int cells = *n_touched;
  grid_ops(touched, cells, grid, prims, gf, g, rec.pre);
  if (rec.n) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) rec.cells[i] = touched[i];
    if (threadIdx.x == 0) *rec.n = cells;
  }
  sync();
}

// One forward substep f of the carry ps, in place (recorded as above).
template <class Sync>
__device__ void substep_fwd(float* ps, int n, int P, int f, const Args& g, int b,
                            const float* rows, Prim* prims, float4* grid, int* mark, int* touched,
                            int* n_touched, float gf, Sync sync, Record rec = {}) {
  substep_head(ps, ps, n, P, f, g, b, rows, prims, grid, mark, touched, n_touched, gf, sync, rec);
  g2p_advect(ps, n, P, g, grid);
  sync();
}

// copy n particles of a carry from src (stride Ps) to dst (stride Pd), each
// thread its own particles
__device__ __forceinline__ void copy_carry(const float* src, int Ps, float* dst, int Pd, int n) {
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    for (int c = 0; c < N_COMP; ++c) dst[c * Pd + p] = src[c * Ps + p];
}

// ------------------------------------------------------------------ K2-fwd
// B clusters of cs CTAs; CTA `rank` of env b holds particles p0 .. p0 + n - 1,
// p0 = rank * Pc, at stride Pc in its shared memory, and runs the substeps
// with substep_fwd and the cluster's barrier (sync). Each CTA writes its
// particles' checkpoints (g.hist, when set) and outputs; the first writes
// the trajectory rows.

template <class Sync>
__global__ void __launch_bounds__(FWD_MAX_NT) mpm_step_fwd_kernel(Args g, int cs, int Pc,
                                                                  Sync sync) {
  extern __shared__ float smem[];
  __shared__ Prim prims[MAX_PRIM];
  __shared__ int n_touched;

  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / cs, tid = threadIdx.x, nt = blockDim.x;
  const int P = g.P, steps = g.steps;
  const int p0 = rank * Pc, n = max(0, min(Pc, P - p0));  // this CTA's particles
  const size_t cells = (size_t)g.rx * g.ry * g.rz;
  Args gl = g;
  from_particle(gl, p0);
  float* ps = smem;                                   // N_COMP * Pc
  float* rows = ps + (size_t)N_COMP * Pc;             // (steps + 1) * n_prim * ROW
  int* touched = (int*)(rows + (size_t)(steps + 1) * g.n_prim * ROW);
  float4* grid = g.grid + (size_t)b * cells;
  int* mark = g.mark + (size_t)b * cells;
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];

  for (int p = tid; p < n; p += nt) {
    size_t o = (size_t)b * P + p0 + p;
    for (int d = 0; d < 3; ++d) {
      ps[(IX + d) * Pc + p] = g.x[o * 3 + d];
      ps[(IV + d) * Pc + p] = g.v[o * 3 + d];
    }
    for (int e = 0; e < 9; ++e) {
      ps[(IC + e) * Pc + p] = g.C[o * 9 + e];
      ps[(IF + e) * Pc + p] = g.F[o * 9 + e];
    }
    ps[IJ * Pc + p] = g.J[o];
  }
  if (tid == 0) fk_rows(g, b, rows);
  __syncthreads();
  start_clock(sync);

  const int n_ckpt = (steps + g.K - 1) / g.K;
  for (int f = 0; f < steps; ++f) {
    if (g.hist && f % g.K == 0)
      copy_carry(ps, Pc, g.hist + ((size_t)b * n_ckpt + f / g.K) * N_COMP * P + p0, P, n);
    substep_fwd(ps, n, Pc, f, gl, b, rows, prims, grid, mark, touched, &n_touched, gf, sync);
  }

  for (int p = tid; p < n; p += nt) {
    size_t o = (size_t)b * P + p0 + p;
    for (int d = 0; d < 3; ++d) {
      g.x_out[o * 3 + d] = ps[(IX + d) * Pc + p];
      g.v_out[o * 3 + d] = ps[(IV + d) * Pc + p];
    }
    for (int e = 0; e < 9; ++e) {
      g.C_out[o * 9 + e] = ps[(IC + e) * Pc + p];
      g.F_out[o * 9 + e] = ps[(IF + e) * Pc + p];
    }
    g.J_out[o] = ps[IJ * Pc + p];
  }
  if (rank != 0) return;
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
// input carry, L = min(K, steps - s K) of them, to out (L, N_COMP, P). The
// block holds particles p0 .. p0 + n - 1 of the env, at stride Ps in ps, and
// runs the substeps with the barrier sync (g's per-particle inputs start at
// particle p0); with rec.n, substep j's grid is recorded in rec's slot j
// (cap cells each).

template <class Sync>
__device__ void seg_recompute(const Args& g, int b, int s, float* out, float* ps, int n, int Ps,
                              int p0, const float* rows, Prim* prims, float4* grid, int* mark,
                              int* touched, int* n_touched, float gf, Sync sync,
                              Record rec = {}, int cap = 0) {
  const int P = g.P, t0 = s * g.K;
  const int L = min(g.K, g.steps - t0);
  const int n_ckpt = (g.steps + g.K - 1) / g.K;
  copy_carry(g.hist + ((size_t)b * n_ckpt + s) * N_COMP * P + p0, P, ps, Ps, n);
  __syncthreads();
  for (int j = 0; j < L; ++j) {
    copy_carry(ps, Ps, out + (size_t)j * N_COMP * P + p0, P, n);
    if (j + 1 < L)
      substep_fwd(ps, n, Ps, t0 + j, g, b, rows, prims, grid, mark, touched, n_touched, gf, sync,
                  rec.n ? rec.slot(j, cap) : rec);
  }
  __syncthreads();
}

// K2-seg alone, as K2-bwd runs it as the first phase of each segment: B
// clusters of a.cluster CTAs under K2-bwd's launch (launch_config), CTA
// `rank` holding particles p0 .. p0 + n - 1 at stride Pc in shared memory
// laid out as K2-bwd's (the carry, room for its cotangent, the rows, the
// touched list); segment s's L carries into a.seg (B, L, N_COMP, P) and
// their grids into the CTA's K record slots, the last carry's head too.
__global__ void __launch_bounds__(BWD_MAX_NT) mpm_step_seg_kernel(Args g, BwdArgs a, int s) {
  extern __shared__ float smem[];
  __shared__ Prim prims[MAX_PRIM];
  __shared__ int n_touched;

  const int cs = a.cluster, rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / cs, P = g.P, steps = g.steps, K = g.K, Pc = a.per_cta;
  const int p0 = rank * Pc, n = max(0, min(Pc, P - p0));  // this CTA's particles
  const int t0 = s * K, L = min(K, steps - t0);
  const size_t cells = (size_t)g.rx * g.ry * g.rz;
  Args gl = g;
  from_particle(gl, p0);
  float* ps = smem;                                   // N_COMP * Pc
  float* rows = ps + (size_t)2 * N_COMP * Pc;         // (steps + 1) * n_prim * ROW
  int* touched = (int*)(rows + (size_t)(steps + 1) * g.n_prim * ROW);
  float4* grid = g.grid + (size_t)b * cells;
  int* mark = g.mark + (size_t)b * cells;
  const size_t cta = (size_t)b * cs + rank;
  const Record rec{a.rec_n + cta * K, a.rec_cells + cta * K * a.list_cap,
                   a.pre + cta * K * a.list_cap};
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  const ClusterSync sync{cs};
  if (threadIdx.x == 0) fk_rows(g, b, rows);
  __syncthreads();
  seg_recompute(gl, b, s, a.seg + (size_t)b * L * N_COMP * P, ps, n, Pc, p0, rows, prims, grid,
                mark, touched, &n_touched, gf, sync, rec, a.list_cap);
  substep_head(ps, nullptr, n, Pc, t0 + L - 1, gl, b, rows, prims, grid, mark, touched,
               &n_touched, gf, sync, rec.slot(L - 1, a.list_cap));
}

// ------------------------------------------------------------------ K2-bwd
// The macro step's adjoint, stage by stage in reverse, with the per-particle
// and per-cell adjoints of mpm_device.cuh. Ties follow autograd on the plain
// step: max, min and clip give 1/2 to each side.

__global__ void __launch_bounds__(BWD_MAX_NT) mpm_step_bwd_kernel(Args g, BwdArgs a) {
  extern __shared__ float smem[];
  __shared__ Prim prims[MAX_PRIM];
  __shared__ int n_touched;
  __shared__ double pacc[N_ACC];  // this CTA's sums of the primitives' and gf's cotangents
  __shared__ float dpq[MAX_PRIM * 7];
  __shared__ double part[3];      // this CTA's sums of the mu, lamda and ys cotangents

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cluster, rank = cs > 1 ? (int)cluster.block_rank() : 0;
  const int b = blockIdx.x / cs, tid = threadIdx.x, nt = blockDim.x;
  const int P = g.P, steps = g.steps, K = g.K, np = g.n_prim, Pc = a.per_cta;
  const int p0 = rank * Pc, n = max(0, min(Pc, P - p0));  // this CTA's particles
  const ClusterSync sync{cs};
  const size_t cells = (size_t)g.rx * g.ry * g.rz;
  Args gl = g;
  from_particle(gl, p0);
  float* ps = smem;                                   // N_COMP * Pc: the substep's carry
  float* cot = ps + (size_t)N_COMP * Pc;              // N_COMP * Pc: the carry's cotangent
  float* rows = cot + (size_t)N_COMP * Pc;            // (steps + 1) * n_prim * ROW
  int* touched = (int*)(rows + (size_t)(steps + 1) * np * ROW);  // list capacity
  // 3 * Pc doubles: mu, lamda, yield stress, 8-byte aligned after the list
  double* acc = (double*)(((size_t)(touched + a.list_cap) + 7) & ~(size_t)7);
  float4* grid = g.grid + (size_t)b * cells;
  int* mark = g.mark + (size_t)b * cells;
  float4* dgrid = a.dgrid + (size_t)b * cells;
  const size_t cta = (size_t)b * cs + rank;
  const Record rec{a.rec_n + cta * K, a.rec_cells + cta * K * a.list_cap,
                   a.pre + cta * K * a.list_cap};
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  // the forward kinematics' adjoint: primitive ip on thread nt - 1 - ip of
  // the first CTA (the threads past this CTA's particles, where there are)
  const int fk_ip = rank == 0 ? nt - 1 - tid : -1;

  for (int p = tid; p < n; p += nt) {
    size_t o = (size_t)b * P + p0 + p;
    for (int d = 0; d < 3; ++d) {
      cot[(IX + d) * Pc + p] = a.dx[o * 3 + d];
      cot[(IV + d) * Pc + p] = a.dv[o * 3 + d];
    }
    for (int e = 0; e < 9; ++e) {
      cot[(IC + e) * Pc + p] = a.dC[o * 9 + e];
      cot[(IF + e) * Pc + p] = a.dF[o * 9 + e];
    }
    cot[IJ * Pc + p] = a.dJ[o];
    acc[p] = acc[Pc + p] = acc[2 * Pc + p] = 0.0;
  }
  for (int k = tid; k < N_ACC; k += nt) pacc[k] = 0.0;
  if (tid == 0) fk_rows(g, b, rows);
  if (fk_ip >= 0 && fk_ip < np) {
    // frame steps is output twice: row steps and, by copy_frame, row 0
    const size_t row = ((size_t)b * np + fk_ip) * (steps + 1);
    for (int d = 0; d < 3; ++d)
      dpq[fk_ip * 7 + d] = a.dpos[(row + steps) * 3 + d] + a.dpos[row * 3 + d];
    for (int d = 0; d < 4; ++d)
      dpq[fk_ip * 7 + 3 + d] = a.drot[(row + steps) * 4 + d] + a.drot[row * 4 + d];
  }
  __syncthreads();

  const int n_seg = (steps + K - 1) / K;
  for (int s = n_seg - 1; s >= 0; --s) {
    const int t0 = s * K, L = min(K, steps - t0);
    // the segment's L input carries, (L, N_COMP, P), and each substep's
    // grid in rec: K2-seg records substeps t0 .. t0 + L - 2 as it runs them
    // (K > 1), the head of substep t0 + L - 1 the last
    const float* base;
    if (K == 1) {
      base = g.hist + ((size_t)b * n_seg + s) * N_COMP * P;
      copy_carry(base + p0, P, ps, Pc, n);
      __syncthreads();
    } else {  // K2-seg, as a phase of this launch
      float* out = a.seg + (size_t)b * K * N_COMP * P;
      seg_recompute(gl, b, s, out, ps, n, Pc, p0, rows, prims, grid, mark, touched, &n_touched,
                    gf, sync, rec, a.list_cap);
      base = out;
    }
    substep_head(ps, nullptr, n, Pc, t0 + L - 1, gl, b, rows, prims, grid, mark, touched,
                 &n_touched, gf, sync, rec.slot(L - 1, a.list_cap));
    for (int t = t0 + L - 1; t >= t0; --t) {
      const Record r = rec.slot(t - t0, a.list_cap);
      // this CTA's particles of the substep's input carry into shared
      // memory, and its recorded cells' grid after the grid ops and their
      // cotangent's zero
      copy_carry(base + (size_t)(t - t0) * N_COMP * P + p0, P, ps, Pc, n);
      if (tid == 0) load_prims(g, b, t, rows, prims);
      for (int k = tid; k < MAX_PRIM * NPA; k += nt)
        if (k % NPA < PA_SIZE) pacc[k] = 0.0;  // the substep's; size and on sum over all
      __syncthreads();
      const int n_cells = *r.n;
      for (int i = tid; i < n_cells; i += nt) {
        const int cell = r.cells[i];
        grid[cell] = grid_op_value(cell, r.pre[i], prims, gf, gl);
        dgrid[cell] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      sync();
      // then each stage's adjoint in reverse
      {
        AtomicScatter scat{dgrid};
        for (int p = tid; p < n; p += nt)
          g2p_adjoint_particle(ps, cot, Pc, p, true, gl, grid, scat);
      }
      sync();
      {
        ThreadAcc tacc;
        tacc.zero(np);
        for (int i = tid; i < n_cells; i += nt)
          grid_op_bwd(r.cells[i], r.pre[i], dgrid, dgrid, prims, gf, gl, tacc);
        tacc.flush(np, pacc);
      }
      sync();
      for (int p = tid; p < n; p += nt) particle_adjoint_particle(ps, cot, acc, Pc, p, gl, b, dgrid);
      if (fk_ip >= 0 && fk_ip < np) {
        // the cluster's sums of primitive fk_ip's cotangents, CTA by CTA
        double pa[NPA];
        for (int k = 0; k < NPA; ++k) pa[k] = 0.0;
        for (int r2 = 0; r2 < cs; ++r2) {
          const double* rp = r2 == 0 ? pacc : cluster.map_shared_rank(pacc, r2);
          for (int k = 0; k < NPA; ++k) pa[k] += rp[fk_ip * NPA + k];
        }
        fk_adjoint_prim(g, b, t, fk_ip, rows, pa, a.dpos, a.drot, a.gframe, a.gvw,
                        dpq + fk_ip * 7);
      }
      sync();
    }
  }

  for (int p = tid; p < n; p += nt) {
    size_t o = (size_t)b * P + p0 + p;
    for (int d = 0; d < 3; ++d) {
      a.gx[o * 3 + d] = cot[(IX + d) * Pc + p];
      a.gv[o * 3 + d] = cot[(IV + d) * Pc + p];
    }
    for (int e = 0; e < 9; ++e) {
      a.gC[o * 9 + e] = cot[(IC + e) * Pc + p];
      a.gF[o * 9 + e] = cot[(IF + e) * Pc + p];
    }
    a.gJ[o] = cot[IJ * Pc + p];
    if (g.mu_sp) a.gmu[o] = (float)acc[p];
    if (g.la_sp) a.gla[o] = (float)acc[Pc + p];
    if (g.ys_sp) a.gys[o] = (float)acc[2 * Pc + p];
  }
  if (tid == 0) {
    double smu = 0.0, sla = 0.0, sys = 0.0;
    for (int p = 0; p < n; ++p) {
      smu += acc[p];
      sla += acc[Pc + p];
      sys += acc[2 * Pc + p];
    }
    part[0] = smu;
    part[1] = sla;
    part[2] = sys;
  }
  sync();
  if (rank == 0 && tid == 0) {
    double sums[3] = {0.0, 0.0, 0.0}, sgf = 0.0;
    for (int r = 0; r < cs; ++r) {
      const double* rpart = r == 0 ? part : cluster.map_shared_rank(part, r);
      const double* rp = r == 0 ? pacc : cluster.map_shared_rank(pacc, r);
      for (int k = 0; k < 3; ++k) sums[k] += rpart[k];
      sgf += rp[ACC_GF];
    }
    a.ggf[b] = (float)sgf;
    if (!g.mu_sp) a.gmu[b] = (float)sums[0];
    if (!g.la_sp) a.gla[b] = (float)sums[1];
    if (!g.ys_sp) a.gys[b] = (float)sums[2];
  }
  sync();  // every CTA's shared memory stays until the first has read it
}

int list_capacity(int P, int cells) {
  long cap = 27L * P;
  return (int)(cap < cells ? cap : cells);
}

// dynamic shared memory of a block holding P particles (K2-fwd and K2-bwd:
// of a CTA holding per_cta): the carry (and, backward, its cotangent), the
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

// K2-fwd's and K2-bwd's launch: B clusters of `cluster` CTAs of `threads`
// threads
cudaLaunchConfig_t cluster_config(int B, int cluster, int threads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// What the card makes of a cluster kernel at `threads` threads, `smem` bytes
// of dynamic shared memory and clusters of `cluster` CTAs: out = registers
// per thread, local memory per thread (bytes), static shared memory (bytes),
// blocks per SM (the occupancy API) and clusters the card holds at once
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, size_t smem, int cluster, int device,
                        int* out) {
  cudaError_t err = prepare_launch(kernel, smem, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, threads, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute la;
  cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, threads, smem, nullptr, &la);
  return cudaOccupancyMaxActiveClusters(&out[4], kernel, &cfg);
}

// whether a cluster launch of `cluster` CTAs of `threads` threads, each
// holding per_cta of the P particles with a touched list of list_cap slots in
// smem bytes, is one the kernel takes (at most max_threads threads)
bool cluster_launch_ok(int P, int cells, int steps, int n_prim, bool bwd, int list_cap,
                       int cluster, int threads, int max_threads, int per_cta, long long smem) {
  return cluster >= 1 && cluster <= MAX_CLUSTER && per_cta >= 1 && (long)per_cta * cluster >= P &&
         threads >= 32 && threads <= max_threads && threads % 32 == 0 &&
         list_cap >= list_capacity(per_cta, cells) &&
         (size_t)smem == smem_bytes(per_cta, cells, steps, n_prim, bwd);
}

}  // namespace

extern "C" {

const char* unidom_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

size_t mpm_step_smem_bytes(int P, int cells, int steps, int n_prim, int bwd) {
  return smem_bytes(P, cells, steps, n_prim, bwd != 0);
}

// What the card makes of K2-fwd (bwd 0) or K2-bwd (bwd 1) at `threads`
// threads, `smem` bytes of dynamic shared memory and clusters of `cluster`
// CTAs: out = registers per thread, local memory per thread (bytes), static
// shared memory (bytes), blocks per SM (the occupancy API) and clusters the
// card holds at once. Returns a cudaError_t.
int mpm_step_kernel_info(int bwd, int threads, long long smem, int cluster, int device,
                         int* out) {
  if (bwd) return (int)kernel_info(mpm_step_bwd_kernel, threads, (size_t)smem, cluster, device, out);
  return (int)kernel_info(mpm_step_fwd_kernel<ClusterSync>, threads, (size_t)smem, cluster, device,
                          out);
}

// The forward's arguments, shared by the three entry points. hist (B,
// ceil(steps / K), N_COMP, P) receives the carry every K substeps (K2-fwd)
// or holds it (K2-seg, K2-bwd); K2-fwd writes no history when it is null.
// K2-fwd, K2-seg and K2-bwd run B clusters of `cluster` CTAs of `threads` threads,
// each CTA holding per_cta particles and a touched list of list_cap slots in
// smem bytes of dynamic shared memory (ops/cuda/mpm_kernel.py
// fwd_launch_config and launch_config; it must equal smem_bytes(per_cta,
// ...)). clocks, when not null (K2-fwd only), receives the phase split of
// StampedSync: 6 int64, 0 on entry.
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
                 float* const* bwd_out, float* bwd_scratch, int list_cap, int cluster,
                 int threads, int per_cta, long long smem, long long* clocks) {
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
  cudaLaunchAttribute la;
  if (what == 0) {  // K2-fwd
    if (!cluster_launch_ok(P, cells, steps, n_prim, false, list_cap, cluster, threads, FWD_MAX_NT,
                           per_cta, smem))
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = cluster_config(B, cluster, threads, (size_t)smem,
                                            (cudaStream_t)stream, &la);
    const ClusterSync sync{cluster};
    if (clocks) {
      auto kernel = mpm_step_fwd_kernel<StampedSync>;
      if ((err = prepare_launch(kernel, (size_t)smem, device)) != cudaSuccess) return (int)err;
      err = cudaLaunchKernelEx(&cfg, kernel, g, cluster, per_cta, StampedSync{sync, clocks});
    } else {
      auto kernel = mpm_step_fwd_kernel<ClusterSync>;
      if ((err = prepare_launch(kernel, (size_t)smem, device)) != cudaSuccess) return (int)err;
      err = cudaLaunchKernelEx(&cfg, kernel, g, cluster, per_cta, sync);
    }
    if (err != cudaSuccess) return (int)err;
  } else if (what == 1) {  // K2-seg alone, launched as K2-bwd
    if (!hist || !seg_out || !bwd_scratch || segment < 0 || segment * K >= steps ||
        !cluster_launch_ok(P, cells, steps, n_prim, true, list_cap, cluster, threads, BWD_MAX_NT,
                           per_cta, smem))
      return (int)cudaErrorInvalidValue;
    BwdArgs a = {};
    a.seg = seg_out;
    const size_t slots = (size_t)B * cluster * K;
    a.pre = (float4*)bwd_scratch;
    a.rec_cells = (int*)(a.pre + slots * list_cap);
    a.rec_n = a.rec_cells + slots * list_cap;
    a.list_cap = list_cap;
    a.cluster = cluster;
    a.per_cta = per_cta;
    if ((err = prepare_launch(mpm_step_seg_kernel, (size_t)smem, device)) != cudaSuccess)
      return (int)err;
    cudaLaunchConfig_t cfg = cluster_config(B, cluster, threads, (size_t)smem,
                                            (cudaStream_t)stream, &la);
    if ((err = cudaLaunchKernelEx(&cfg, mpm_step_seg_kernel, g, a, segment)) != cudaSuccess)
      return (int)err;
  } else {  // K2-bwd, with K2-seg as a phase of each segment when K > 1
    if (!hist || threads < n_prim || (K > 1 && !seg_out) ||
        !cluster_launch_ok(P, cells, steps, n_prim, true, list_cap, cluster, threads, BWD_MAX_NT,
                           per_cta, smem))
      return (int)cudaErrorInvalidValue;
    BwdArgs a;
    a.dx = bwd_in[0]; a.dv = bwd_in[1]; a.dC = bwd_in[2]; a.dF = bwd_in[3]; a.dJ = bwd_in[4];
    a.dpos = bwd_in[5]; a.drot = bwd_in[6];
    a.gx = bwd_out[0]; a.gv = bwd_out[1]; a.gC = bwd_out[2]; a.gF = bwd_out[3]; a.gJ = bwd_out[4];
    a.gmu = bwd_out[5]; a.gla = bwd_out[6]; a.gys = bwd_out[7]; a.ggf = bwd_out[8];
    a.gframe = bwd_out[9]; a.gvw = bwd_out[10];
    a.seg = seg_out;
    const size_t slots = (size_t)B * cluster * K;
    a.dgrid = (float4*)bwd_scratch;
    a.pre = a.dgrid + (size_t)B * cells;
    a.rec_cells = (int*)(a.pre + slots * list_cap);
    a.rec_n = a.rec_cells + slots * list_cap;
    a.list_cap = list_cap;
    a.cluster = cluster;
    a.per_cta = per_cta;
    if ((err = prepare_launch(mpm_step_bwd_kernel, (size_t)smem, device)) != cudaSuccess)
      return (int)err;
    cudaLaunchConfig_t cfg = cluster_config(B, cluster, threads, (size_t)smem,
                                            (cudaStream_t)stream, &la);
    if ((err = cudaLaunchKernelEx(&cfg, mpm_step_bwd_kernel, g, a)) != cudaSuccess)
      return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
