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
// a segment of L <= K substeps from its checkpoint with a rollout's launches,
// writes each substep's input carry and records each substep's grid (below),
// the segment's last carry's P2G and grid ops included. K3-bwd is the macro
// step's adjoint: per substep, in reverse, from the substep's input carry,
// it rebuilds the post-op grid on the touched cells from what K3-seg
// recorded (with K = 1, the exact history, it recomputes the raw P2G grid
// and its touched list and runs the grid ops, keeping each cell's momentum
// and mass), then takes the adjoints of G2P (a gather of the post-op grid;
// the nodes' cotangents scatter into the grid cotangent's double sums), of
// the grid ops per touched cell (with collide's adjoint), of P2G (a gather
// from the grid cotangent) and the stress, return maps, SVD and F update,
// and of the primitives' forward kinematics: the per-particle and per-cell
// bodies of mpm_device.cuh that K2-bwd runs.
//
// What bounds it on this card: operations, as K2-fwd (3,397 float32
// operations per particle-substep and ~78 per touched cell): pour_soup at 32
// envs is 20.9 GFLOP per macro step against ~50 MB of state in and out, so
// ~0.31 ms at 67 TFLOP/s. K3-bwd: 10,071 operations per particle-substep
// (the forward once and its adjoint, as K2-bwd) and the touched cells' grid
// ops and their adjoint. Every phase reads and writes the particle state in
// device memory and the scatters add with atomics in device memory, whose
// atomics on a crowded cell (shape_elasto_plastic: ~340 particle shares per
// touched cell and substep; pour_soup's water in the bowls) serialise in
// L2, so P2G first sums over the particles of a bin (below).
//
// Design:
//   - Many blocks per env: the particle phases run on a grid of
//     (ceil(P / 256), B) blocks, one thread per particle. The particle state
//     lives in device memory, component-major per env (B, 25, P), so that a
//     warp's loads of one component coalesce; a pack launch copies the
//     inputs in (and computes the primitives' frames), an unpack launch
//     copies the outputs and the trajectory rows out.
//   - Four launches per substep; a launch boundary is the only barrier
//     between the blocks of an env. The particles are sorted by bin, the
//     base node of their stencil (bin_key), each substep: each particle is
//     counted into its bin (an atomic on a (B, bins) counter, whose first
//     count appends the bin to the env's bin list), the pack launch for the
//     first substep, G2P's launch for the next. Then:
//       1. the bins' scan: one block per env turns the listed bins' counts
//          into offsets (an exclusive scan) and writes the permutation;
//       2. F update, SVD, return map and stress, then P2G, the threads
//          taking the particles in bin order: the lanes of a warp that share
//          a bin share all 27 nodes, sum each node's shares over the warp by
//          shuffles (WarpScatter in mpm_device.cuh) and add them by one
//          atomic per bin and warp; the first mark of a node appends it to
//          the env's touched list, by an atomic on the env's count;
//       3. the grid ops, one thread per touched cell (a grid-stride loop over
//          the env's list; each block loads the substep's primitives into
//          shared memory), from the sums into the float4 grid of velocities
//          (and mass) that G2P reads;
//       4. G2P, advection and J, and the next substep's count.
//     The P2G launch resets the counters it read, the scan the bin list, so
//     nothing needs clearing between launches. Launches rather than one
//     cooperative kernel: pour_soup at 32 envs is 992 blocks, more than the
//     card may hold resident for a grid-wide barrier at this register count.
//   - A rollout (no gradient) sums P2G in float into a float4 grid of sums
//     apart from the one G2P reads: pour_soup's water pools in the bowls,
//     and one float atomic per particle and node (the first design)
//     serialised in L2 on the crowded cells; with the bin's sum first, one
//     per bin and warp. The sums and marks start at 0 and the grid ops put
//     each touched cell back to 0 after reading it, so no launch zeroes the
//     27 nodes of every particle's stencil (on pour_soup at 32 envs that
//     zeroing took as long as P2G).
//   - K3-seg sums P2G in float, as a rollout does (the same launches, its
//     sums and marks 0 on entry and on exit; the wrapper keeps them zeroed
//     per simulator): K3-bwd's adjoint of a substep reads the grid that
//     K3-seg's own G2P read, recorded, so nothing has to reproduce a grid.
//     Summed in double in device memory instead, K3-seg's P2G took 0.18 ms
//     per launch against 0.148 in float, and K3-bwd per shape_elasto_plastic
//     call at 16 envs 13.91 against 12.80 ms; over the block in shared memory
//     first (a box of nodes, the bins in key order), 0.25 ms: sm_90a has no
//     shared-memory double atomic add (the SASS holds ATOMS.CAST.SPIN.64
//     loops). Both sums pass [big-bwd-parity] (H100; PERF.md).
//   - K3-fwd with checkpoints and K3-bwd's recompute at K = 1 (the exact
//     history) sum P2G in double, so that the result does not depend on the
//     order of the sums at float32's precision: the recompute takes the
//     adjoint at the grid the forward used (with float sums in another
//     order, shape_elasto_plastic's primitive cotangents, sums of
//     1/dt-amplified terms that cancel, landed 2.3x further from float64
//     than the float32 plain step's; H100, chip_smoke.py's
//     [big-bwd-parity]). shape_elasto_plastic holds ~27 particles per bin,
//     so ~10x fewer double atomics land on each cell. Counting a particle
//     into its bin first zeroes the double sums and marks under its
//     stencil. G2P's adjoint scatters the grid cotangent by the same
//     permutation and scheme.
//   - No windows. The Pallas kernel sorts particles by cell each macro step
//     so that its x/y windows cover each 128-particle chunk, and drops
//     support outside a window; a scatter needs no window. Nodes outside the
//     grid are dropped as the plain step drops them, and nothing else is.
//     Outputs stay in the particles' order.
//   - The primitives' frames of all substeps (steps + 1 rows) are computed
//     once per env in the pack launch, as K2-fwd does.
//   - Every per-env offset is taken in size_t (pour_soup at 128 envs holds
//     more than 2^31 bytes of grid).
//   - K3-seg records, for each substep t0 .. t0 + L - 1 of its segment, what
//     K3-bwd's reversed substep reads of the forward (K slots per env, one
//     per substep of the segment; BigRecord): the touched cells and their
//     count, each touched cell's momentum and mass before the grid ops, and
//     the particles' bin order (the permutation: G2P's adjoint scatters by
//     it, and WarpScatter finds each lane's bin from x itself, so a
//     particle's bin and rank need no slot). Its P2G launches write the
//     cells into the slot's list, the grid ops the momentum and mass, the
//     bins' scan the permutation; a last P2G and grid ops, with no G2P,
//     record the segment's last carry. No later launch writes a slot before
//     K3-bwd has read it: the slots are the record's alone (G2P's launch
//     counts the next substep's particles and the grid ops put the sums
//     back to 0, in storage of their own). A slot holds
//     list_cap cells, the list's own bound, not the substep's touched count:
//     the count is known only on the card, after P2G, and the layout is
//     fixed before the launch sequence, where the wrapper sizes the scratch
//     and refuses a batch that cannot hold it.
//   - K3-bwd's reversed substep with K > 1: the post-op grid rebuilt on the
//     slot's cells from their recorded momentum and mass (grid_op_value, the
//     forward's own code on the same input) and the grid cotangent's double
//     sums zeroed there (exactly the cells G2P's adjoint scatters to: every
//     in-grid node of a particle's stencil was marked), G2P's adjoint, the
//     grid ops' adjoint and the forward kinematics', the particle adjoint:
//     four launches, no zeroing of stencils, no scan and no P2G. With K = 1
//     (the exact history, no K3-seg; the stride rule gives it only to small
//     batches): zero the stencils and count (only where the previous launch
//     has not), the scan, P2G, the grid ops keeping each cell's momentum and
//     mass in slot 0, then the same three adjoints, the particle adjoint
//     with the next reversed substep's zeroing and count: six launches. The
//     per-env sums (the primitives' cotangents of a substep,
//     the ground friction's, the Lame parameters' and yield stress's when
//     they are per env) sum per thread, over a warp by shuffles and over a
//     block in shared memory in double, then one double atomicAdd per block
//     and component into the env's accumulators; the env's last block of
//     the grid ops' adjoint (a counter per env) runs the forward
//     kinematics' adjoint, one thread per primitive. The per-particle Lame
//     and yield cotangents stay in double over the substeps (their terms
//     cancel to ~1e-2 of their size), as in K2-bwd.
//   - Scratch per env: the float4 grid and marks (20 B per cell), the
//     bins' counters (4 B per bin) and list, each particle's bin, rank in
//     its bin and sorted slot (12 B); with a gradient P2G's double sums (32
//     B per cell); K3-bwd's: the grid cotangent's
//     double sums (32 B per cell) and float4 (16 B), the carry's cotangent
//     and the per-particle accumulators, the record (K slots of list_cap
//     cells at 20 B and P particles at 4 B), and with K > 1 a segment of K
//     carries.
//   - IEEE division and square roots; atomics add in a varying order, so
//     a rollout is not bitwise reproducible from run to run, and a
//     gradient's double sums only where one lies at a float's rounding
//     boundary.

#include <type_traits>

#include "mpm_device.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int BIN_NT = 1024;       // threads of the bins' scan, one block per env
constexpr int N_EACC = N_ACC + 3;  // an env's accumulators: the primitives', gf, mu, lamda, ys

// What K3 keeps in device memory beside the forward's Args (g.grid and
// g.mark are the per-env grid and marks, (B, cells)).
struct BigArgs {
  GridAcc* gacc;       // (B, cells): P2G's momentum and mass in double, or null
  float4* fsum;        // (B, cells): a rollout's P2G sums in float, or null
  float* ps;           // the working carry of env b at ps + b * ps_stride, (N_COMP, P)
  size_t ps_stride;
  float* rows;         // (B, steps + 1, n_prim, ROW): the primitives' frames
  int* touched;        // (B, list_cap): the touched cells of the substep
  int* n_touched;      // (B,): how many
  int list_cap;
  const float* src;    // zero launch: copy env b's carry from src + b * src_stride first
  size_t src_stride;
  float* save;         // zero and G2P launches: then copy it to save + b * save_stride
  size_t save_stride;
  // the sort by bin (with a gradient); all 0 before a launch sequence
  int* bins;           // (B, n_keys): particles per bin, then each bin's first slot
  int* bin_list;       // (B, bin_cap): the bins in use
  int* n_bin_list;     // (B,)
  int* key;            // (B, P): each particle's bin
  int* rank;           // (B, P): its place in the bin
  int* perm;           // (B, P): the particles in bin order
  int n_keys, bin_cap;
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
  float4* pre;                          // (B, list_cap): the substep's record slot's momentum and mass
  float* dpq;                           // (B, MAX_PRIM, 7): the current frame's cotangent
  double* pacc;                         // (B, 3, P): mu, lamda, yield stress per particle
  double* eacc;                         // (B, N_EACC)
  int* done;                            // (B,): blocks of the grid ops' adjoint finished
};

// K3-seg's record of a segment's grids for K3-bwd, K slots (one per substep
// of the segment), slot j of env b at j * B + b: what BigArgs' touched list,
// count and permutation and K3-bwd's pre hold for one substep
struct BigRecord {
  float4* pre;  // (K, B, list_cap): each touched cell's momentum and mass before the grid ops
  int* cells;   // (K, B, list_cap): the touched cells
  int* n;       // (K, B): how many
  int* perm;    // (K, B, P): the particles in bin order
};

__device__ __forceinline__ size_t env_cells(const Args& g) { return (size_t)g.rx * g.ry * g.rz; }

// P2G's sums: in float (a rollout), or in double (the gradient's forward,
// K3-seg and K3-bwd); apart from the grid G2P reads, since G2P's launch
// zeroes the next substep's sums while other blocks still read that grid
template <class G>
__device__ __forceinline__ G* sums(const Args& g, const BigArgs& a);
template <>
__device__ __forceinline__ float4* sums<float4>(const Args& g, const BigArgs& a) {
  return a.fsum;
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

// Particle p at x counted into its bin, with a gradient (G = GridAcc) after
// P2G's double sums (and the cotangent's, dsum, when set) and the marks under
// its stencil are set to 0. A rollout's float sums (G = float4) and marks
// start at 0 (the wrapper zeroes them once) and the grid ops put each touched
// cell back to 0 once they have read it: a rollout's substep zeroes each
// touched cell once, not 27 nodes per particle. With a gradient the
// stencils' zeroing stays as K3-bwd's recompute expects it.
template <class G>
__device__ __forceinline__ void zero_and_count(const float* x, int p, const Args& g,
                                               const BigArgs& a, int b, GridAcc* dsum) {
  if constexpr (std::is_same<G, GridAcc>::value) {
    const size_t cells = env_cells(g);
    zero_stencil(x, g, a.gacc + (size_t)b * cells, g.mark + (size_t)b * cells,
                 dsum ? dsum + (size_t)b * cells : dsum);
  }
  Stencil st;
  stencil(x, g.inv_dx, st);
  const int key = bin_key(st, g);
  const int r = atomicAdd(a.bins + (size_t)b * a.n_keys + key, 1);
  if (r == 0) a.bin_list[(size_t)b * a.bin_cap + atomicAdd(a.n_bin_list + b, 1)] = key;
  a.key[(size_t)b * g.P + p] = key;
  a.rank[(size_t)b * g.P + p] = r;
}

__device__ __forceinline__ void save_carry(const float* ps, int P, int p, const BigArgs& a,
                                           int b) {
  float* save = a.save + (size_t)b * a.save_stride;
  for (int c = 0; c < N_COMP; ++c) save[c * P + p] = ps[c * P + p];
}

// the inputs into the carry; block 0 of each env computes its frames. With
// `zero` (K3-fwd's first substep), also save the carry where a.save is set
// and zero and count as zero_and_count<G> does.
template <class G>
__global__ void __launch_bounds__(NT) big_pack_kernel(Args g, BigArgs a, int zero) {
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
  if (!zero) return;
  if (a.save) save_carry(ps, P, p, a, b);
  const float x[3] = {ps[IX * P + p], ps[(IX + 1) * P + p], ps[(IX + 2) * P + p]};
  zero_and_count<G>(x, p, g, a, b, nullptr);
}

// 1. with a gradient: the carry copied in from a.src and out to a.save where
// they are set, then each particle zeroed and counted as zero_and_count<G>
// does (and the grid cotangent's sums under its stencil zeroed, when dsum is
// set)
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
  if (a.save) save_carry(ps, P, p, a, b);
  const float x[3] = {ps[IX * P + p], ps[(IX + 1) * P + p], ps[(IX + 2) * P + p]};
  zero_and_count<G>(x, p, g, a, b, dsum);
}

// 1b. the bins' counts into offsets (an exclusive scan over
// the env's bin list), the permutation of the particles into bin order;
// the bin list and the touched count back to 0. One block per env.
__global__ void __launch_bounds__(BIN_NT) big_bin_kernel(Args g, BigArgs a) {
  __shared__ int warp_sums[BIN_NT / 32];
  const int b = blockIdx.x, tid = threadIdx.x, P = g.P;
  const int lane = tid & 31, warp = tid >> 5;
  int* bins = a.bins + (size_t)b * a.n_keys;
  const int* list = a.bin_list + (size_t)b * a.bin_cap;
  const int n = a.n_bin_list[b];
  const int chunk = (n + BIN_NT - 1) / BIN_NT;
  const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
  int sum = 0;
  for (int s = lo; s < hi; ++s) sum += bins[list[s]];
  int incl = sum;  // inclusive scan over the warp, then over the warps
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL_MASK, wi, off);
      if (lane >= off) wi += o;
    }
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int off = warp_sums[warp] + incl - sum;
  for (int s = lo; s < hi; ++s) {
    const int k = list[s], c = bins[k];
    bins[k] = off;
    off += c;
  }
  __syncthreads();
  const int* key = a.key + (size_t)b * P;
  const int* rank = a.rank + (size_t)b * P;
  int* perm = a.perm + (size_t)b * P;
  for (int p = tid; p < P; p += BIN_NT) perm[bins[key[p]] + rank[p]] = p;
  if (tid == 0) {
    a.n_bin_list[b] = 0;
    a.n_touched[b] = 0;
  }
}

// 2. stress and P2G, the particles in bin order, each node's shares summed
// over a bin's lanes before one atomic into G's sums; F after the return
// map back into the carry when write_F; each particle's bin counter back
// to 0
template <class G>
__global__ void __launch_bounds__(NT) big_p2g_sorted_kernel(Args g, BigArgs a, int write_F) {
  const int b = blockIdx.y, P = g.P;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= P) return;  // a warp without particles
  const bool live = i < P;
  const int p = live ? a.perm[(size_t)b * P + i] : 0;
  if (live) a.bins[(size_t)b * a.n_keys + a.key[(size_t)b * P + p]] = 0;
  float* ps = env_carry(a, b);
  const size_t cells = env_cells(g);
  WarpScatter<G> s{sums<G>(g, a) + (size_t)b * cells, g.mark + (size_t)b * cells,
                   a.touched + (size_t)b * a.list_cap, a.n_touched + b, 0u, false};
  p2g_particle(ps, write_F ? ps : nullptr, P, p, live, g, b, s);
}

// 3. the grid ops of substep f on the env's touched cells, from P2G's sums
// (rounded to float) into the float4 grid that G2P reads; pre, when set,
// keeps each cell's momentum and mass before them; a rollout's float sums
// and marks back to 0 (see zero_and_count)
template <class G>
__global__ void __launch_bounds__(NT) big_grid_kernel(Args g, BigArgs a, int f, float4* pre) {
  __shared__ Prim prims[MAX_PRIM];
  const int b = blockIdx.y;
  if (threadIdx.x == 0) load_prims(g, b, f, env_rows(g, a, b), prims);
  __syncthreads();
  const int n = a.n_touched[b];
  const int* touched = a.touched + (size_t)b * a.list_cap;
  const size_t cells = env_cells(g);
  G* sum = sums<G>(g, a) + (size_t)b * cells;
  int* mark = g.mark + (size_t)b * cells;
  float4* grid = g.grid + (size_t)b * cells;
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int cell = touched[i];
    const float4 gv = grid_load(sum, cell);
    if constexpr (std::is_same<G, float4>::value) {
      sum[cell] = make_float4(0.f, 0.f, 0.f, 0.f);
      mark[cell] = 0;
    }
    if (pre) pre[(size_t)b * a.list_cap + i] = gv;
    grid[cell] = grid_op_value(cell, gv, prims, gf, g);
  }
}

// 4. G2P, advection and J; then the carry to a.save where set, and with
// `next` (a substep that another follows) the next substep's stencils in
// G's sums zeroed and counted
template <class G>
__global__ void __launch_bounds__(NT) big_g2p_kernel(Args g, BigArgs a, int next) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float* ps = env_carry(a, b);
  g2p_advect_particle(ps, P, p, g, g.grid + (size_t)b * env_cells(g));
  if (a.save) save_carry(ps, P, p, a, b);
  if (next) {
    const float x[3] = {ps[IX * P + p], ps[(IX + 1) * P + p], ps[(IX + 2) * P + p]};
    zero_and_count<G>(x, p, g, a, b, nullptr);
  }
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
    if (threadIdx.x == 0) w.done[b] = 0;
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

// 4'. G2P's and advection's adjoint, the particles in the bin order of the
// recomputed P2G: a gather of the post-op grid, a scatter into the grid
// cotangent's double sums by WarpScatter
__global__ void __launch_bounds__(NT) big_g2p_bwd_kernel(Args g, BigArgs a, BigBwd w) {
  const int b = blockIdx.y, P = g.P;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= P) return;  // a warp without particles
  const bool live = i < P;
  const int p = live ? a.perm[(size_t)b * P + i] : 0;
  const size_t cells = env_cells(g);
  WarpScatter<GridAcc> s{w.dsum + (size_t)b * cells, nullptr, nullptr, nullptr, 0u, false};
  g2p_adjoint_particle(env_carry(a, b), w.cot + (size_t)b * N_COMP * P, P, p, live, g,
                       g.grid + (size_t)b * cells, s);
}

// 3'. the grid ops' adjoint on the env's touched cells; the primitives' and
// the ground friction's cotangents sum per thread, over the warp and over
// the block, then into the env's. The env's last block to finish then runs
// the forward kinematics' adjoint at substep f (thread ip for primitive ip)
// and puts the substep's primitive cotangents back to 0.
__global__ void __launch_bounds__(NT) big_grid_bwd_kernel(Args g, BigArgs a, BigBwd w, int f) {
  __shared__ Prim prims[MAX_PRIM];
  __shared__ double sacc[N_ACC];
  __shared__ int last;
  const int b = blockIdx.y, tid = threadIdx.x, np = g.n_prim;
  if (tid == 0) load_prims(g, b, f, env_rows(g, a, b), prims);
  for (int k = tid; k < N_ACC; k += blockDim.x) sacc[k] = 0.0;
  __syncthreads();
  const int n = a.n_touched[b];
  const int* touched = a.touched + (size_t)b * a.list_cap;
  const float4* pre = w.pre + (size_t)b * a.list_cap;
  const GridAcc* dsum = w.dsum + (size_t)b * env_cells(g);
  float4* dgrid = w.dgrid + (size_t)b * env_cells(g);
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  {
    ThreadAcc acc;
    acc.zero(np);
    for (int i = blockIdx.x * blockDim.x + tid; i < n; i += gridDim.x * blockDim.x)
      grid_op_bwd(touched[i], pre[i], dsum, dgrid, prims, gf, g, acc);
    acc.flush(np, sacc);
  }
  __syncthreads();
  double* eacc = w.eacc + (size_t)b * N_EACC;
  for (int k = tid; k < N_ACC; k += blockDim.x)
    if (sacc[k] != 0.0) atomicAdd(eacc + k, sacc[k]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(w.done + b, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < np) {
    double pa[NPA];
    for (int k = 0; k < NPA; ++k) pa[k] = __ldcg(eacc + tid * NPA + k);
    fk_adjoint_prim(g, b, f, tid, env_rows(g, a, b), pa, w.dpos, w.drot, w.gframe, w.gvw,
                    w.dpq + ((size_t)b * MAX_PRIM + tid) * 7);
    for (int k = 0; k < PA_SIZE; ++k) eacc[tid * NPA + k] = 0.0;
  }
  if (tid == 0) w.done[b] = 0;
}

// 3''. K3-bwd with a record: the grid after the grid ops of substep f on the
// slot's touched cells, from their momentum and mass before them, and the
// grid cotangent's double sums there to 0 for G2P's adjoint
__global__ void __launch_bounds__(NT) big_rebuild_kernel(Args g, BigArgs a, BigBwd w, int f) {
  __shared__ Prim prims[MAX_PRIM];
  const int b = blockIdx.y;
  if (threadIdx.x == 0) load_prims(g, b, f, env_rows(g, a, b), prims);
  __syncthreads();
  const int n = a.n_touched[b];
  const int* touched = a.touched + (size_t)b * a.list_cap;
  const float4* pre = w.pre + (size_t)b * a.list_cap;
  const size_t cells = env_cells(g);
  float4* grid = g.grid + (size_t)b * cells;
  GridAcc* dsum = w.dsum + (size_t)b * cells;
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int cell = touched[i];
    grid[cell] = grid_op_value(cell, pre[i], prims, gf, g);
    grid_zero(dsum, cell);
  }
}

// 2''. P2G's adjoint (a gather from the grid cotangent) and the stress's,
// the return maps', the SVD's and F's update's; with `next` (env b's carry
// of the next reversed substep at next + b * next_stride), that carry's
// stencils zeroed (with the cotangent's sums) and counted
__global__ void __launch_bounds__(NT) big_particle_bwd_kernel(Args g, BigArgs a, BigBwd w,
                                                              const float* next,
                                                              size_t next_stride) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  particle_adjoint_particle(env_carry(a, b), w.cot + (size_t)b * N_COMP * P,
                            w.pacc + (size_t)b * 3 * P, P, p, g, b,
                            w.dgrid + (size_t)b * env_cells(g));
  if (next) {
    const float* c = next + (size_t)b * next_stride;
    const float x[3] = {c[IX * P + p], c[(IX + 1) * P + p], c[(IX + 2) * P + p]};
    zero_and_count<GridAcc>(x, p, g, a, b, w.dsum);
  }
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

// K3's kernels by number, for mpm_big_step_kernel_info
template <typename F>
cudaError_t kernel_attributes(int which, F&& with) {
  switch (which) {
    case 0: return with((const void*)big_zero_kernel<GridAcc>);
    case 1: return with((const void*)big_bin_kernel);
    case 2: return with((const void*)big_p2g_sorted_kernel<GridAcc>);
    case 3: return with((const void*)big_grid_kernel<GridAcc>);
    case 4: return with((const void*)big_g2p_kernel<GridAcc>);
    case 5: return with((const void*)big_g2p_bwd_kernel);
    case 6: return with((const void*)big_grid_bwd_kernel);
    case 7: return with((const void*)big_particle_bwd_kernel);
    case 8: return with((const void*)big_p2g_sorted_kernel<float4>);
    case 9: return with((const void*)big_grid_kernel<float4>);
    case 10: return with((const void*)big_g2p_kernel<float4>);
    case 11: return with((const void*)big_rebuild_kernel);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* unidom_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// What the card makes of K3's kernel `which` (0 the zero and count launch,
// 1 the bins' scan, 2 P2G with a gradient, 3 its grid ops, 4 its G2P, 5 G2P's
// adjoint, 6 the grid ops' adjoint, 7 the particle adjoint, 8 a rollout's
// P2G, 9 its grid ops, 10 its G2P, 11 K3-bwd's rebuild of a recorded grid): out = registers per thread, local
// memory per thread (bytes), static
// shared memory (bytes), threads per block and blocks per SM (the
// occupancy API). Returns a cudaError_t.
int mpm_big_step_kernel_info(int which, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)kernel_attributes(which, [&](const void* k) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, k);
    if (e != cudaSuccess) return e;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = (int)attr.sharedSizeBytes;
    out[3] = which == 1 ? BIN_NT : NT;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], k, out[3], 0);
  });
}

// K3's launches on the stream, counted into *n_launches. what 0: K3-fwd,
// one macro step (4 * steps + 2 launches), P2G in bin order, writing the
// carry of every K-th substep to hist (B, ceil(steps / K), N_COMP, P) and
// summing P2G in gacc (B, cells, 4 doubles), unless hist is null (a
// rollout: P2G sums in fsum (B, cells, 4 floats); fsum and mark must be 0
// on entry and are 0 again on exit). what 1:
// K3-seg alone, segment `segment` from hist into seg_out (B, L, N_COMP, P),
// its L grids recorded in record's slots 0 .. L - 1, P2G summed in fsum
// (0 on entry and on exit with mark, as in a rollout).
// what 2: K3-bwd from the history (with K3-seg into seg_out (B, K, N_COMP,
// P), record and fsum per segment when K > 1; with K = 1 the recompute sums
// in gacc), the output cotangents bwd_in (dx, dv, dC, dF,
// dJ, dpos, drot) and into bwd_out (the cotangents of x, v, C, F, J, mu,
// lamda, yield_stress, ground friction, frame, vw). what 3: the gradient's
// P2G of carry `segment` of hist alone, into gacc and mark (the grid of
// K3-fwd with checkpoints). grid (B, cells, 4) is scratch that needs no
// clearing, and so is mark (B, cells) where gacc is used; ps (B, N_COMP, P), rows (B, steps + 1, n_prim,
// ROW), touched (B, list_cap) and n_touched (B) likewise; bin_ints
// (ops/cuda/mpm_big_kernel.py bin_scratch: per env the bins' counters
// n_keys, n_bin_list 1, bin_list bin_cap, key, rank and perm P each): in
// every case its counters (bins, n_bin_list) must be 0 on entry and are 0
// again on exit, and the rest needs no clearing; K3-bwd's scratch:
// bwd_floats, per env 4 cells + N_COMP P + 7 MAX_PRIM, and
// bwd_doubles, per env 4 cells + 3 P + N_EACC, and bwd_ints, one per env;
// record (what 1 and 2), K slots (BigRecord: K B list_cap float4, K B
// list_cap + K B + K B P ints), needs no clearing.
// grid_blocks is the number of blocks per env of the grid-op launches.
int mpm_big_step_launch(const float* x, const float* v, const float* C, const float* F,
                        const float* J, const float* mu, int mu_sb, int mu_sp, const float* lamda,
                        int la_sb, int la_sp, const float* ys, int ys_sb, int ys_sp,
                        const float* ground_friction, int gf_sb, const float* hardness,
                        const int* material, const float* prim_frame, const float* prim_vw,
                        float* x_out, float* v_out, float* C_out, float* F_out, float* J_out,
                        float* traj_pos, float* traj_rot, float* grid, double* gacc, float* fsum, int* mark,
                        float* ps,
                        float* rows, int* touched, int* n_touched, int list_cap, int grid_blocks,
                        int B, int P, int n_prim, int steps, int rx, int ry, int rz, int n_grid,
                        int use_pc, int sdf_kinds, float dt, float dx, float stress_c1, float dx2,
                        float p_mass, float gx, float gy, float gz, int device, void* stream,
                        float* hist, int K, int what, int segment, float* seg_out,
                        const float* const* bwd_in, float* const* bwd_out, float* bwd_floats,
                        double* bwd_doubles, int* bin_ints, int n_keys, int bin_cap,
                        int* bwd_ints, void* record, int* n_launches) {
  *n_launches = 0;
  const long cells = (long)rx * ry * rz;
  if (B < 1 || B > 65535 || P < 1 || n_prim < 0 || n_prim > MAX_PRIM || steps < 1 ||
      cells < 1 || cells > 0x7fffffffL || list_cap < 1 || list_cap > cells || grid_blocks < 1 ||
      K < 1 || K > steps || what < 0 || what > 3 || (what > 0 && !hist) ||
      (((what == 0 && hist) || what == 3 || (what == 2 && K == 1)) && !gacc) ||
      (((what == 0 && !hist) || what == 1 || (what == 2 && K > 1)) && !fsum) ||
      ((what == 1 || what == 2) && !record) ||
      !bin_ints || n_keys != (rx + 2) * (ry + 2) * (rz + 2) + 1 ||
      bin_cap != (P < n_keys ? P : n_keys))
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
  a.fsum = (float4*)fsum;
  a.ps = ps; a.ps_stride = carry;
  a.rows = rows; a.touched = touched; a.n_touched = n_touched; a.list_cap = list_cap;
  a.src = nullptr; a.src_stride = 0; a.save = nullptr; a.save_stride = 0;
  a.n_keys = n_keys; a.bin_cap = bin_cap;
  a.bins = bin_ints;
  a.n_bin_list = a.bins + (size_t)B * n_keys;
  a.bin_list = a.n_bin_list + B;
  a.key = a.bin_list + (size_t)B * bin_cap;
  a.rank = a.key + (size_t)B * P;
  a.perm = a.rank + (size_t)B * P;
  BigRecord rec;
  rec.pre = (float4*)record;
  rec.cells = (int*)(rec.pre + (size_t)K * B * list_cap);
  rec.n = rec.cells + (size_t)K * B * list_cap;
  rec.perm = rec.n + (size_t)K * B;
  float4* pre = nullptr;  // the grid ops' record of momentum and mass, where one is kept
  // the launches from here on read and write record slot j's touched list,
  // count and permutation, and its momentum and mass as pre
  auto use_slot = [&](int j) {
    a.touched = rec.cells + (size_t)j * B * list_cap;
    a.n_touched = rec.n + (size_t)j * B;
    a.perm = rec.perm + (size_t)j * B * P;
    pre = rec.pre + (size_t)j * B * list_cap;
  };

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
  // P2G into G's sums of the working carry, zeroed and counted: the scan,
  // then P2G in bin order
#define UNIDOM_SORTED_P2G(G, write_F)                                           \
  do {                                                                          \
    big_bin_kernel<<<B, BIN_NT, 0, s>>>(g, a);                                  \
    UNIDOM_LAUNCHED();                                                          \
    big_p2g_sorted_kernel<G><<<particles, NT, 0, s>>>(g, a, (write_F));         \
    UNIDOM_LAUNCHED();                                                          \
  } while (0)
  // the head of forward substep f of the working carry, from its zeroed and
  // counted stencils: P2G summed in G (F after the return map back into the
  // carry when write_F) and the grid ops, their input kept in pre where set
#define UNIDOM_HEAD(G, f, write_F)                                              \
  do {                                                                          \
    UNIDOM_SORTED_P2G(G, write_F);                                              \
    big_grid_kernel<G><<<cells_grid, NT, 0, s>>>(g, a, (f), pre);               \
    UNIDOM_LAUNCHED();                                                          \
  } while (0)
  // forward substep f of the working carry, in place; the new carry to
  // a.save where set, and with `next` its stencils zeroed and counted
#define UNIDOM_SUBSTEP(G, f, next)                                              \
  do {                                                                          \
    UNIDOM_HEAD(G, f, 1);                                                       \
    big_g2p_kernel<G><<<particles, NT, 0, s>>>(g, a, (next));                   \
    UNIDOM_LAUNCHED();                                                          \
  } while (0)
  // K3-seg: segment sg's L carries from its checkpoint into out (env
  // stride out_stride), the working carry ps, and each carry's P2G (summed
  // in float into fsum, which with mark is 0 on entry and again on exit, as
  // in a rollout) and grid ops recorded in record slot j: 4 L launches
#define UNIDOM_SEGMENT(sg, out, out_stride)                                          \
  do {                                                                               \
    const int t0_ = (sg) * K, L_ = K < steps - t0_ ? K : steps - t0_;                \
    a.src = hist + (size_t)(sg) * carry;                                             \
    a.src_stride = (size_t)n_ckpt * carry;                                           \
    a.save = (out);                                                                  \
    a.save_stride = (out_stride);                                                    \
    use_slot(0);                                                                     \
    big_zero_kernel<float4><<<particles, NT, 0, s>>>(g, a, (GridAcc*)nullptr);       \
    UNIDOM_LAUNCHED();                                                               \
    a.src = nullptr;                                                                 \
    for (int j = 0; j + 1 < L_; ++j) {                                               \
      use_slot(j);                                                                   \
      a.save = (out) + (size_t)(j + 1) * carry;                                      \
      UNIDOM_SUBSTEP(float4, t0_ + j, 1);                                            \
    }                                                                                \
    a.save = nullptr;                                                                \
    use_slot(L_ - 1);                                                                \
    UNIDOM_HEAD(float4, t0_ + L_ - 1, 0);                                            \
  } while (0)

  if (what == 0 && !hist) {  // K3-fwd in a rollout
    big_pack_kernel<float4><<<particles, NT, 0, s>>>(g, a, 1);
    UNIDOM_LAUNCHED();
    for (int f = 0; f < steps; ++f) UNIDOM_SUBSTEP(float4, f, f + 1 < steps);
    big_unpack_kernel<<<particles, NT, 0, s>>>(g, a);
    UNIDOM_LAUNCHED();
    return (int)cudaSuccess;
  }
  if (what == 0) {  // K3-fwd with checkpoints
    a.save = hist;
    a.save_stride = (size_t)n_ckpt * carry;
    big_pack_kernel<GridAcc><<<particles, NT, 0, s>>>(g, a, 1);
    UNIDOM_LAUNCHED();
    for (int f = 0; f < steps; ++f) {
      a.save = f + 1 < steps && (f + 1) % K == 0 ? hist + (size_t)((f + 1) / K) * carry
                                                   : nullptr;
      UNIDOM_SUBSTEP(GridAcc, f, f + 1 < steps);
    }
    a.save = nullptr;
    big_unpack_kernel<<<particles, NT, 0, s>>>(g, a);
    UNIDOM_LAUNCHED();
    return (int)cudaSuccess;
  }
  if (what == 3) {  // the gradient's P2G of one carry of the history
    if (segment < 0 || segment >= n_ckpt) return (int)cudaErrorInvalidValue;
    a.src = hist + (size_t)segment * carry;
    a.src_stride = (size_t)n_ckpt * carry;
    big_zero_kernel<GridAcc><<<particles, NT, 0, s>>>(g, a, (GridAcc*)nullptr);
    UNIDOM_LAUNCHED();
    a.src = nullptr;
    UNIDOM_SORTED_P2G(GridAcc, 0);
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
  if (!bwd_in || !bwd_out || !bwd_floats || !bwd_doubles || !bwd_ints || (K > 1 && !seg_out))
    return (int)cudaErrorInvalidValue;
  BigBwd w;
  w.dx = bwd_in[0]; w.dv = bwd_in[1]; w.dC = bwd_in[2]; w.dF = bwd_in[3]; w.dJ = bwd_in[4];
  w.dpos = bwd_in[5]; w.drot = bwd_in[6];
  w.gx = bwd_out[0]; w.gv = bwd_out[1]; w.gC = bwd_out[2]; w.gF = bwd_out[3]; w.gJ = bwd_out[4];
  w.gmu = bwd_out[5]; w.gla = bwd_out[6]; w.gys = bwd_out[7]; w.ggf = bwd_out[8];
  w.gframe = bwd_out[9]; w.gvw = bwd_out[10];
  w.dgrid = (float4*)bwd_floats;
  w.cot = (float*)(w.dgrid + (size_t)B * cells);
  w.dpq = w.cot + (size_t)B * carry;
  w.dsum = (GridAcc*)bwd_doubles;
  w.pacc = bwd_doubles + (size_t)B * cells * 4;
  w.eacc = w.pacc + (size_t)B * 3 * P;
  w.done = bwd_ints;
  big_bwd_pack_kernel<<<particles, NT, 0, s>>>(g, w);
  UNIDOM_LAUNCHED();
  float* ps_work = a.ps;
  if (K == 1) use_slot(0);  // the recompute's scratch
  bool counted = false;  // with K = 1, whether the next reversed substep's stencils are zeroed and counted
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
      const float* next = nullptr;  // K = 1: the next reversed substep's carry
      if (K > 1) {  // the grid K3-seg recorded
        use_slot(t - t0);
        w.pre = pre;
        big_rebuild_kernel<<<cells_grid, NT, 0, s>>>(g, a, w, t);
        UNIDOM_LAUNCHED();
      } else {  // the grid recomputed from the history
        if (!counted) {
          big_zero_kernel<GridAcc><<<particles, NT, 0, s>>>(g, a, w.dsum);
          UNIDOM_LAUNCHED();
        }
        w.pre = pre;
        UNIDOM_HEAD(GridAcc, t, 0);
        if (t > 0) next = hist + (size_t)(t - 1) * carry;
      }
      big_g2p_bwd_kernel<<<particles, NT, 0, s>>>(g, a, w);
      UNIDOM_LAUNCHED();
      big_grid_bwd_kernel<<<cells_grid, NT, 0, s>>>(g, a, w, t);
      UNIDOM_LAUNCHED();
      big_particle_bwd_kernel<<<particles, NT, 0, s>>>(g, a, w, next, stride);
      UNIDOM_LAUNCHED();
      counted = next != nullptr;
    }
  }
  big_bwd_unpack_kernel<<<particles, NT, 0, s>>>(g, w);
  UNIDOM_LAUNCHED();
  big_bwd_finish_kernel<<<env_blocks, NT, 0, s>>>(g, w, B);
  UNIDOM_LAUNCHED();
#undef UNIDOM_SEGMENT
#undef UNIDOM_SUBSTEP
#undef UNIDOM_HEAD
#undef UNIDOM_SORTED_P2G
#undef UNIDOM_LAUNCHED
  return (int)cudaSuccess;
}

}  // extern "C"
