// Runs csrc/soft_nms.cu's kernel (its source without the nvcc launcher:
// kernels.inc, written by tests/torch_cuda_emu.py) on the CPU: each block's
// 256 threads run as std::threads that meet at its barriers, blocks one
// after another; the kernel's __shared__ arrays become function statics,
// which the block's threads share. expf is the C library's, so the results
// equal the card's only up to expf's last bits.
#include <barrier>
#include <cfloat>
#include <cmath>
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
std::barrier<>* g_block;
}

void __syncthreads() { g_block->arrive_and_wait(); }

extern "C" {
// cocodet_soft_decay's arguments: boxes (B, K, 4) f32, valid (B, K) bytes,
// scores (B, K) f32, out (B, K) f32
int emu_soft_decay(const float* boxes, const uint8_t* valid, const float* scores, float* out,
                   int B, int K) {
  const dim3 grid((K + kThreads - 1) / kThreads, B);
  std::barrier<> block(kThreads);
  g_block = &block;
  gridDim = grid;
  blockDim = dim3(kThreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          blockIdx = dim3(x, y);
          block.arrive_and_wait();
          soft_decay_kernel(reinterpret_cast<const float4*>(boxes), valid, scores, out, K);
          block.arrive_and_wait();
        }
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}
}
