// Runs csrc/bn_act.cu's resident kernel (its source without the host
// launchers, cp.async as a copy: kernels.inc, written by
// tests/torch_cuda_emu.py) on the CPU. A launch's clusters run one after
// another; a cluster's CTAs run at once, each as kResThreads std::threads
// (the same threads for every cluster) with its own shared memory (filled
// with 0xA5 before each cluster, so that a read of what no thread wrote
// shows), its own block barrier and a barrier and an exchange buffer a warp
// for __shfl_xor_sync; cluster.sync() is a barrier of all the cluster's
// threads.
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#include "kernels.inc"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
alignas(16) uint8_t smem[16];

namespace {

struct Cta {
  explicit Cta(int64_t bytes)
      : shared(static_cast<uint8_t*>(::operator new[](bytes, std::align_val_t(16)))),
        block(kResThreads) {
    memset(shared, 0xA5, bytes);
    for (auto& w : warp) w = std::make_unique<std::barrier<>>(32);
  }
  ~Cta() { ::operator delete[](shared, std::align_val_t(16)); }
  uint8_t* shared;
  std::barrier<> block;
  std::unique_ptr<std::barrier<>> warp[kResWarps];
  double lanes[2][kResWarps][32];
};

struct Cluster {
  std::vector<std::unique_ptr<Cta>> ctas;
  std::unique_ptr<std::barrier<>> all;
};

Cluster* g_cluster;
thread_local Cta* t_cta;
thread_local unsigned t_rank;
thread_local int t_shfl;

template <typename T, int kAct, bool kBwd>
int run(const BnActArgs& a) {
  const int ranks = a.grid_x;
  const int64_t chunk = (a.outer + ranks - 1) / ranks;
  const int64_t bytes = kResScratch + chunk * a.groups * 16 * (kBwd ? 2 : 1);
  gridDim = dim3(ranks, a.tiles);
  blockDim = dim3(kResThreads);
  Cluster cluster;
  for (int r = 0; r < ranks; ++r) cluster.ctas.push_back(std::make_unique<Cta>(bytes));
  cluster.all = std::make_unique<std::barrier<>>(ranks * kResThreads);
  g_cluster = &cluster;
  // one thread a CUDA thread of the cluster, for every tile in turn
  std::vector<std::thread> threads;
  for (int r = 0; r < ranks; ++r) {
    for (int t = 0; t < kResThreads; ++t) {
      threads.emplace_back([&, r, t] {
        t_cta = cluster.ctas[r].get();
        t_rank = r;
        threadIdx = dim3(t);
        for (int tile = 0; tile < a.tiles; ++tile) {
          if (t == 0) memset(t_cta->shared, 0xA5, bytes);
          cluster.all->arrive_and_wait();
          blockIdx = dim3(r, tile);
          bn_act_resident_kernel<T, kAct, kBwd>(a);
          cluster.all->arrive_and_wait();
        }
      });
    }
  }
  for (auto& th : threads) th.join();
  return 0;
}

template <typename T>
int run_type(const BnActArgs& a) {
  if (!a.backward)
    return a.act == kIdentity ? run<T, kIdentity, false>(a) : run<T, kHardSwish, false>(a);
  return a.act == kIdentity ? run<T, kIdentity, true>(a) : run<T, kHardSwish, true>(a);
}

}  // namespace

uint8_t* emu_dynamic_smem() { return t_cta->shared; }
void __syncthreads() { t_cta->block.arrive_and_wait(); }
void __syncwarp() { t_cta->warp[threadIdx.x / 32]->arrive_and_wait(); }
// Calls alternate between two exchange buffers, so one barrier a call
// suffices: a lane cannot write a buffer again before every lane has
// passed the next call's barrier, after its read.
double __shfl_xor_sync(unsigned, double v, int lane_mask) {
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* buf = t_cta->lanes[t_shfl][w];
  t_shfl ^= 1;
  buf[lane] = v;
  t_cta->warp[w]->arrive_and_wait();
  return buf[lane ^ static_cast<unsigned>(lane_mask)];
}

namespace cooperative_groups {
void cluster_group::sync() const { g_cluster->all->arrive_and_wait(); }
unsigned cluster_group::block_rank() const { return t_rank; }
unsigned cluster_group::num_blocks() const { return g_cluster->ctas.size(); }
void* cluster_group::peer(void* p, unsigned rank) {
  const int64_t off = static_cast<uint8_t*>(p) - t_cta->shared;
  return g_cluster->ctas[rank]->shared + off;
}
cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

extern "C" {
// One resident launch of plan `a` (the arguments of cocodet_bn_act_resident;
// a.grid_x CTAs a cluster, a.tiles clusters).
int emu_bn_act_resident(const BnActArgs* a) {
  if (a->groups != 1 && a->groups != 2) return 1;
  return a->dtype == 0 ? run_type<float>(*a) : run_type<__nv_bfloat16>(*a);
}
}
