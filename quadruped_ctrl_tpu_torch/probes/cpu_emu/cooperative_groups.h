// CPU stand-in for the cluster part of cooperative_groups, for emulate.py:
// the CTAs of a cluster run together (cuda_runtime.h's emu::launch);
// sync() is one barrier over all their threads and map_shared_rank reaches
// the same place in a peer's shared memory arena.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu::self->cluster_rank; }
  void sync() const { emu::self->cluster_bar->arrive_and_wait(); }
  template <typename T>
  T* map_shared_rank(T* p, int rank) const {
    const char* at = reinterpret_cast<const char*>(p);
    return reinterpret_cast<T*>(emu::self->cluster_arenas[rank] + (at - emu::self->arena));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
