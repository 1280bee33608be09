// CPU stand-in for cooperative_groups, enough for ns_cluster.cu to compile
// under emulate.py: its 4-CTA clusters and distributed shared memory are not
// emulated, so nothing here is ever run.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return 0; }
  void sync() const {}
  template <typename T>
  T* map_shared_rank(T* p, int) const { return p; }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
