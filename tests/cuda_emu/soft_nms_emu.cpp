// Runs csrc/soft_nms.cu's kernel (its source without the nvcc launcher:
// kernels.inc, written by tests/torch_cuda_emu.py) on the CPU: each block's
// kThreads threads run as std::threads that meet at its barriers, and a
// warp's 32 of them at each __ballot_sync (a rendezvous on an atomic
// generation count, waiters yielding: under a loaded CPU it took a third of
// std::barrier's time, whose sleeping waiters each need a wake-up); blocks
// run one after another, in the order of their index; the kernel's
// __shared__ arrays become function statics, which the block's threads
// share. expf is the C library's, so the results equal the card's only up
// to expf's last bits.
#include <atomic>
#include <cfloat>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#undef __shared__
#define __shared__ static

#include "kernels.inc"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
alignas(16) uint8_t smem[16];

namespace {
// A rendezvous of n threads: the last to arrive opens the next generation;
// the others yield until it does.
struct Rendezvous {
  explicit Rendezvous(int n) : n(n) {}
  void arrive_and_wait() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == n - 1) {
      count.store(0, std::memory_order_relaxed);
      gen.fetch_add(1, std::memory_order_release);
      return;
    }
    while (gen.load(std::memory_order_acquire) == g) std::this_thread::yield();
  }
  const int n;
  std::atomic<int> count{0}, gen{0};
};
Rendezvous* g_block;
std::unique_ptr<Rendezvous> g_warp[kWarps];
unsigned g_votes[2][kWarps][32];
thread_local int t_vote;
}  // namespace

void __syncthreads() { g_block->arrive_and_wait(); }
// Calls alternate between two vote buffers, so one barrier a call suffices:
// a lane cannot write a buffer again before every lane of its warp has
// passed the next call's barrier, after its read.
unsigned __ballot_sync(unsigned, int pred) {
  const unsigned w = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned* votes = g_votes[t_vote][w];
  t_vote ^= 1;
  votes[lane] = pred ? 1u : 0u;
  g_warp[w]->arrive_and_wait();
  unsigned m = 0;
  for (unsigned l = 0; l < 32; ++l) m |= votes[l] << l;
  return m;
}

extern "C" {
// cocodet_soft_decay's arguments: boxes (B, K, 4) f32, valid (B, K) bytes,
// scores (B, K) f32, out (B, K) f32
int emu_soft_decay(const float* boxes, const uint8_t* valid, const float* scores, float* out,
                   int B, int K) {
  const unsigned blocks = B * ((K + kCols - 1) / kCols);
  Rendezvous block(kThreads);
  g_block = &block;
  for (auto& w : g_warp) w = std::make_unique<Rendezvous>(32);
  gridDim = dim3(blocks);
  blockDim = dim3(kThreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned x = 0; x < blocks; ++x) {
        blockIdx = dim3(x);
        block.arrive_and_wait();
        soft_decay_kernel(reinterpret_cast<const float4*>(boxes), valid, scores, out, B, K);
        block.arrive_and_wait();
      }
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}
}
