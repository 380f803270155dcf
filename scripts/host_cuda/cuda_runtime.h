// A host stand-in for the CUDA runtime, so that the kernels of
// unidom_torch/csrc build with g++ and run on the CPU (scripts/host_cuda/
// rehearse.py). Every CUDA thread of a block is a std::thread; __syncthreads
// is a std::barrier of the block, cluster.sync() one of the cluster (see
// cooperative_groups.h), a warp shuffle an exchange through a per-warp buffer
// between two barriers of the warp; a thread that returns drops out of its
// barriers. The blocks of a cluster run at once, clusters (and blocks of a
// launch without clusters) one after another. Atomics are std::atomic_ref.
// Shared memory: each block has an arena; `extern __shared__` arrays are its
// start and each `__shared__` declaration gets a slot at the same offset in
// every block (so that map_shared_rank can find a sibling's), by the
// rewrite rehearse.py makes of the source.
#pragma once

#ifndef HOST_CUDA_SMEM_FILL  // every byte of a block's shared memory at launch
#define HOST_CUDA_SMEM_FILL 0xCD
#endif
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <type_traits>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
// HOST_CUDA_REAL is double in the float64 build, where rehearse.py defines
// float as double after this header
#ifndef HOST_CUDA_REAL
#define HOST_CUDA_REAL float
#endif
struct float4 {
  HOST_CUDA_REAL x, y, z, w;
};
inline float4 make_float4(HOST_CUDA_REAL x, HOST_CUDA_REAL y, HOST_CUDA_REAL z,
                          HOST_CUDA_REAL w) {
  return float4{x, y, z, w};
}

using cudaError_t = int;
using cudaStream_t = void*;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
struct cudaFuncAttributes {
  int numRegs = 0;
  size_t localSizeBytes = 0, sharedSizeBytes = 0;
};

inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "invalid value" : "no error"; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
template <class K>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = cudaFuncAttributes{};
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}

// a float product, also in the float64 build (this header comes before its
// define of float as double), as the card and the plain step round it
inline float __fmul_rn(float a, float b) { return a * b; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// the thread's coordinates, as CUDA's built-in variables
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace host_cuda {

struct Block;
struct Cluster {
  int size = 1;
  std::unique_ptr<std::barrier<>> bar;
  std::vector<Block*> blocks;
};
struct Block {
  dim3 idx;
  int rank = 0;
  Cluster* cluster = nullptr;
  std::vector<unsigned char> arena;  // dynamic shared memory, then the static slots
  size_t dyn = 0;
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  std::vector<std::vector<uint64_t>> warp_buf;
};

// each __shared__ declaration's slot: (offset past the dynamic part, bytes)
inline std::map<const void*, std::pair<size_t, size_t>>& slots() {
  static std::map<const void*, std::pair<size_t, size_t>> m;
  return m;
}
inline std::mutex& slots_mutex() {
  static std::mutex m;
  return m;
}
inline size_t& slots_end() {
  static size_t end = 0;
  return end;
}
constexpr size_t STATIC_BYTES = 1 << 16;

inline thread_local Block* t_block = nullptr;

template <class T>
T& shared_slot(const void* key) {
  size_t off;
  {
    std::lock_guard<std::mutex> lock(slots_mutex());
    auto it = slots().find(key);
    if (it == slots().end()) {
      size_t start = (slots_end() + 31) & ~size_t(31);
      slots_end() = start + sizeof(T);
      if (slots_end() > STATIC_BYTES) std::abort();
      it = slots().emplace(key, std::make_pair(start, sizeof(T))).first;
    }
    off = it->second.first;
  }
  return *reinterpret_cast<T*>(t_block->arena.data() + t_block->dyn + off);
}

template <class T>
T* dynamic_smem() {
  return reinterpret_cast<T*>(t_block->arena.data());
}

inline void drop_out() {
  Block* b = t_block;
  b->bar->arrive_and_drop();
  b->warp_bar[threadIdx.x / 32]->arrive_and_drop();
  if (b->cluster) b->cluster->bar->arrive_and_drop();
}

// run the blocks of one cluster (or one block), every thread a std::thread
template <class Body>
void run_cluster(std::vector<Block*>& blocks, dim3 block, dim3 grid, Body body) {
  const int nt = block.x * block.y * block.z;
  std::vector<std::thread> threads;
  for (Block* b : blocks) {
    b->bar = std::make_unique<std::barrier<>>(nt);
    b->warp_bar.clear();
    b->warp_buf.assign((nt + 31) / 32, std::vector<uint64_t>(32));
    for (int w = 0; w < (nt + 31) / 32; ++w)
      b->warp_bar.push_back(std::make_unique<std::barrier<>>(std::min(32, nt - 32 * w)));
    for (int t = 0; t < nt; ++t)
      threads.emplace_back([=]() {
        t_block = b;
        blockIdx = b->idx;
        blockDim = block;
        gridDim = grid;
        threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
        body();
        drop_out();
      });
  }
  for (auto& th : threads) th.join();
}

template <class K, class... A>
void launch(K kernel, dim3 grid, dim3 block, size_t smem, int cluster, A&&... args) {
  const size_t nb = (size_t)grid.x * grid.y * grid.z;
  const int cs = cluster;
  for (size_t first = 0; first < nb; first += cs) {
    Cluster cl;
    cl.size = cs;
    std::vector<std::unique_ptr<Block>> own;
    std::vector<Block*> blocks;
    for (int r = 0; r < cs; ++r) {
      size_t i = first + r;
      auto b = std::make_unique<Block>();
      b->idx = dim3(i % grid.x, (i / grid.x) % grid.y, i / (grid.x * grid.y));
      b->rank = r;
      b->cluster = cs > 1 ? &cl : nullptr;
      b->dyn = (smem + 31) & ~size_t(31);
      b->arena.assign(b->dyn + STATIC_BYTES, HOST_CUDA_SMEM_FILL);
      blocks.push_back(b.get());
      own.push_back(std::move(b));
    }
    cl.blocks = blocks;
    const int nt = block.x * block.y * block.z;
    if (cs > 1) cl.bar = std::make_unique<std::barrier<>>(cs * nt);
    run_cluster(blocks, block, grid, [&]() { kernel(args...); });
  }
}

}  // namespace host_cuda


// k<<<grid, block, smem, stream>>>(args) is rewritten to this
template <class K, class... A>
void host_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A&&... args) {
  host_cuda::launch(kernel, grid, block, smem, 1, args...);
}

template <class K, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, K kernel, A&&... args) {
  int cs = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cs = cfg->attrs[i].val.clusterDim.x;
  if (cfg->gridDim.x % cs) return cudaErrorInvalidValue;
  host_cuda::launch(kernel, cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cs, args...);
  return cudaSuccess;
}

inline void __syncthreads() { host_cuda::t_block->bar->arrive_and_wait(); }
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T>
T __ldcg(const T* p) {
  return std::atomic_ref<T>(*const_cast<T*>(p)).load();
}

template <class T, class U>
T atomicAdd(T* p, U v) {
  return std::atomic_ref<T>(*p).fetch_add((T)v);
}
inline int atomicCAS(int* p, int cmp, int val) {
  std::atomic_ref<int>(*p).compare_exchange_strong(cmp, val);
  return cmp;
}

// warp shuffles: lane values through the warp's buffer
template <class T>
T shfl_from(T v, int src_lane_fn(int, int, int), int arg) {
  using namespace host_cuda;
  static_assert(sizeof(T) <= 8);
  Block* b = t_block;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  b->warp_buf[w][lane] = bits;
  b->warp_bar[w]->arrive_and_wait();
  const int src = src_lane_fn(lane, arg, 32);
  T out;
  std::memcpy(&out, &b->warp_buf[w][src], sizeof(T));
  b->warp_bar[w]->arrive_and_wait();
  return out;
}
inline int lane_down(int l, int d, int n) { return l + d < n ? l + d : l; }
inline int lane_up(int l, int d, int) { return l - d >= 0 ? l - d : l; }
inline int lane_xor(int l, int m, int) { return l ^ m; }
template <class T>
T __shfl_down_sync(unsigned, T v, int d) { return shfl_from(v, lane_down, d); }
// a vote: every lane's predicate through the warp's buffer
inline unsigned __ballot_sync(unsigned, int pred) {
  using namespace host_cuda;
  Block* b = t_block;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  b->warp_buf[w][lane] = pred != 0;
  b->warp_bar[w]->arrive_and_wait();
  unsigned out = 0;
  const int n = std::min(32, (int)(blockDim.x * blockDim.y * blockDim.z) - 32 * w);
  for (int l = 0; l < n; ++l)
    if (b->warp_buf[w][l]) out |= 1u << l;
  b->warp_bar[w]->arrive_and_wait();
  return out;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
template <class T>
T __shfl_up_sync(unsigned, T v, int d) { return shfl_from(v, lane_up, d); }
template <class T>
T __shfl_xor_sync(unsigned, T v, int m) { return shfl_from(v, lane_xor, m); }
