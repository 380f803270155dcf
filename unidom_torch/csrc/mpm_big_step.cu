// MLS-MPM macro step on big grids for Hopper (sm_90a): kernel K3-fwd.
//
// Replaces unidom_tpu/ops/pallas/mpm_big_kernel.py's forward (fwd_call ->
// fwd_kernel; each substep run_substep = stage1, p2g_chunk, gridop_slab,
// g2p_chunk and fk): one macro step of conf.steps substeps for configurations
// that one block cannot hold (pour_soup: 7,694 particles on a 128x64x128
// grid; shape_elasto_plastic: 23,940 particles). It computes what
// unidom_torch/engine/mpm.py's plain _substep computes, conf.steps times, then
// the primitives' buffer roll of _run_substeps (row 0 <- row steps), with the
// device code that K2 uses (mpm_device.cuh): F update, SVD, the return map and
// stress of each particle's material, P2G, the grid ops (mass normalisation,
// gravity, SDF collision or position control of each primitive, ground
// friction, walls), G2P and advection, and the primitives' forward
// kinematics. In a rollout nothing is differentiated, so it writes no
// history.
//
// What bounds it on this card: operations, as K2-fwd (3,397 float32
// operations per particle-substep and ~78 per touched cell): pour_soup at 32
// envs is 20.9 GFLOP per macro step against ~50 MB of state in and out, so
// ~0.31 ms at 67 TFLOP/s. This first design is far from that: every phase
// reads and writes the particle state in device memory, P2G adds with float
// atomics in device memory, and each substep is four launches.
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
//       2. F update, SVD, return map and stress, then P2G by float atomicAdd
//          into the env's float4 grid (momentum, mass) in device memory; the
//          first mark of a node appends it to the env's touched list, by an
//          atomic on the env's count in device memory;
//       3. the grid ops, one thread per touched cell (a grid-stride loop over
//          the env's list; each block loads the substep's primitives into
//          shared memory);
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
//   - IEEE division and square roots; atomics add in a varying order, so
//     results are not bitwise reproducible from run to run.

#include "mpm_device.cuh"

namespace {

constexpr int NT = 256;  // threads per block

// What K3-fwd keeps in device memory beside the forward's Args (g.grid and
// g.mark are the per-env grid and marks, (B, cells)).
struct BigArgs {
  float* ps;       // (B, N_COMP, P): the carry
  float* rows;     // (B, steps + 1, n_prim, ROW): the primitives' frames
  int* touched;    // (B, list_cap): the touched cells of the substep
  int* n_touched;  // (B,): how many
  int list_cap;
};

__device__ __forceinline__ size_t env_cells(const Args& g) { return (size_t)g.rx * g.ry * g.rz; }

__device__ __forceinline__ float* env_carry(const Args& g, const BigArgs& a, int b) {
  return a.ps + (size_t)b * N_COMP * g.P;
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
  float* ps = env_carry(g, a, b);
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

// 1. the grid and marks under each particle's stencil to 0
__global__ void __launch_bounds__(NT) big_zero_kernel(Args g, BigArgs a) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) a.n_touched[b] = 0;
  if (p >= P) return;
  const float* ps = env_carry(g, a, b);
  const float x[3] = {ps[IX * P + p], ps[(IX + 1) * P + p], ps[(IX + 2) * P + p]};
  const size_t cells = env_cells(g);
  zero_stencil(x, g, g.grid + (size_t)b * cells, g.mark + (size_t)b * cells, nullptr);
}

// 2. stress and P2G
__global__ void __launch_bounds__(NT) big_p2g_kernel(Args g, BigArgs a) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float* ps = env_carry(g, a, b);
  const size_t cells = env_cells(g);
  p2g_particle(ps, ps, P, p, g, b, g.grid + (size_t)b * cells, g.mark + (size_t)b * cells,
               a.touched + (size_t)b * a.list_cap, a.n_touched + b);
}

// 3. the grid ops of substep f on the env's touched cells
__global__ void __launch_bounds__(NT) big_grid_kernel(Args g, BigArgs a, int f) {
  __shared__ Prim prims[MAX_PRIM];
  const int b = blockIdx.y;
  if (threadIdx.x == 0) load_prims(g, b, f, env_rows(g, a, b), prims);
  __syncthreads();
  const int n = a.n_touched[b];
  const int* touched = a.touched + (size_t)b * a.list_cap;
  float4* grid = g.grid + (size_t)b * env_cells(g);
  const float gf = g.ground_friction[(size_t)b * g.gf_sb];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    grid_op(touched[i], grid, prims, gf, g, nullptr);
}

// 4. G2P, advection and J
__global__ void __launch_bounds__(NT) big_g2p_kernel(Args g, BigArgs a) {
  const int b = blockIdx.y, P = g.P;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  g2p_advect_particle(env_carry(g, a, b), P, p, g, g.grid + (size_t)b * env_cells(g));
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
  const float* ps = env_carry(g, a, b);
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

}  // namespace

extern "C" {

const char* unidom_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One K3-fwd macro step: 4 * steps + 2 launches on the stream, counted into
// *n_launches. grid (B, cells, 4) and mark (B, cells) are scratch that needs
// no clearing; ps (B, N_COMP, P), rows (B, steps + 1, n_prim, ROW), touched
// (B, list_cap) and n_touched (B) likewise. grid_blocks is the number of
// blocks per env of the grid-op launches.
int mpm_big_step_launch(const float* x, const float* v, const float* C, const float* F,
                        const float* J, const float* mu, int mu_sb, int mu_sp, const float* lamda,
                        int la_sb, int la_sp, const float* ys, int ys_sb, int ys_sp,
                        const float* ground_friction, int gf_sb, const float* hardness,
                        const int* material, const float* prim_frame, const float* prim_vw,
                        float* x_out, float* v_out, float* C_out, float* F_out, float* J_out,
                        float* traj_pos, float* traj_rot, float* grid, int* mark, float* ps,
                        float* rows, int* touched, int* n_touched, int list_cap, int grid_blocks,
                        int B, int P, int n_prim, int steps, int rx, int ry, int rz, int n_grid,
                        int use_pc, int sdf_kinds, float dt, float dx, float stress_c1, float dx2,
                        float p_mass, float gx, float gy, float gz, int device, void* stream,
                        int* n_launches) {
  *n_launches = 0;
  const long cells = (long)rx * ry * rz;
  if (B < 1 || B > 65535 || P < 1 || n_prim < 0 || n_prim > MAX_PRIM || steps < 1 ||
      cells < 1 || cells > 0x7fffffffL || list_cap < 1 || list_cap > cells || grid_blocks < 1)
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
  g.hist = nullptr; g.K = 1;
  g.P = P; g.n_prim = n_prim; g.steps = steps;
  g.rx = rx; g.ry = ry; g.rz = rz; g.n_grid = n_grid; g.use_pc = use_pc; g.sdf_kinds = sdf_kinds;
  g.dt = dt; g.dx = dx; g.inv_dx = (float)n_grid; g.stress_c1 = stress_c1; g.dx2 = dx2;
  g.p_mass = p_mass; g.gx = gx; g.gy = gy; g.gz = gz;
  BigArgs a;
  a.ps = ps; a.rows = rows; a.touched = touched; a.n_touched = n_touched; a.list_cap = list_cap;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 particles((P + NT - 1) / NT, B), cells_grid(grid_blocks, B);
#define UNIDOM_LAUNCHED()                                              \
  do {                                                                 \
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;   \
    ++*n_launches;                                                     \
  } while (0)
  big_pack_kernel<<<particles, NT, 0, s>>>(g, a);
  UNIDOM_LAUNCHED();
  for (int f = 0; f < steps; ++f) {
    big_zero_kernel<<<particles, NT, 0, s>>>(g, a);
    UNIDOM_LAUNCHED();
    big_p2g_kernel<<<particles, NT, 0, s>>>(g, a);
    UNIDOM_LAUNCHED();
    big_grid_kernel<<<cells_grid, NT, 0, s>>>(g, a, f);
    UNIDOM_LAUNCHED();
    big_g2p_kernel<<<particles, NT, 0, s>>>(g, a);
    UNIDOM_LAUNCHED();
  }
  big_unpack_kernel<<<particles, NT, 0, s>>>(g, a);
  UNIDOM_LAUNCHED();
#undef UNIDOM_LAUNCHED
  return (int)cudaSuccess;
}

}  // extern "C"
