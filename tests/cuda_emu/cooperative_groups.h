// cooperative_groups::this_cluster() for the CPU stand-in of cuda_runtime.h
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu::blk->cluster->bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu::blk->rank; }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    char* base = reinterpret_cast<char*>(emu::blk->smem.data());
    const size_t off = reinterpret_cast<char*>(p) - base;
    char* peer = reinterpret_cast<char*>(
        emu::blk->cluster->blocks[rank].smem.data());
    return reinterpret_cast<T*>(peer + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
