// A CPU stand-in for the thread-block cluster of cooperative_groups that
// cocodet_tpu_torch/csrc/bn_act.cu's resident kernel uses: the CTAs of a
// cluster run at once, each with its own shared memory; sync() is a barrier
// of all their threads and map_shared_rank() the same offset in another
// CTA's shared memory (cuda_emu/bn_act_emu.cpp runs them).
#pragma once

namespace cooperative_groups {

struct cluster_group {
  void sync() const;
  unsigned block_rank() const;
  unsigned num_blocks() const;
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    return static_cast<T*>(peer(static_cast<void*>(p), rank));
  }
  static void* peer(void* p, unsigned rank);
};

cluster_group this_cluster();

}  // namespace cooperative_groups
