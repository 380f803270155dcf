// A host stand-in for cooperative_groups' clusters (see cuda_runtime.h):
// sync() is the cluster's std::barrier, map_shared_rank the same offset in a
// sibling block's shared-memory arena.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const {
    host_cuda::Block* b = host_cuda::t_block;
    if (b->cluster)
      b->cluster->bar->arrive_and_wait();
    else
      b->bar->arrive_and_wait();
  }
  unsigned block_rank() const { return host_cuda::t_block->rank; }
  unsigned num_blocks() const {
    return host_cuda::t_block->cluster ? host_cuda::t_block->cluster->size : 1;
  }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    host_cuda::Block* b = host_cuda::t_block;
    const size_t off = reinterpret_cast<unsigned char*>(p) - b->arena.data();
    host_cuda::Block* other = b->cluster ? b->cluster->blocks[rank] : b;
    return reinterpret_cast<T*>(other->arena.data() + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
