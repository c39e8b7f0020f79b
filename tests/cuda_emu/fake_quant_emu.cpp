// Runs csrc/fake_quant.cu's kernels (their source without the nvcc launcher:
// kernels.inc, written by tests/test_torch_fake_quant.py) on the CPU. The
// kernels have no barriers and no shared memory, so each launch runs its
// blocks and their threads one after another.
#include "cuda_runtime.h"

#include "kernels.inc"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
alignas(16) uint8_t smem[16];

template <typename I>
void run(const float* v, const float* g, float* y, int64_t n, const Args& a, int backward,
         int vec) {
  const I ni = static_cast<I>(n);
  if (vec && backward) fake_quant_kernel<true, I>(v, g, y, ni, a);
  if (vec && !backward) fake_quant_kernel<false, I>(v, g, y, ni, a);
  if (!vec && backward) fake_quant_scalar_kernel<true, I>(v, g, y, ni, a);
  if (!vec && !backward) fake_quant_scalar_kernel<false, I>(v, g, y, ni, a);
}

extern "C" {
// cocodet_fake_quant's arguments; vec 1 takes the vector kernel (the
// pointers must be 16-byte aligned), 0 the scalar one; wide 1 runs the
// 64-bit index instance
int emu_fake_quant(const float* v, const float* g, float* y, int64_t n, const float* scale,
                   const float* bound, int64_t s_inner, int64_t s_count, const float* div,
                   int64_t d_inner, int64_t d_count, int backward, int vec, int wide) {
  const Args a{scale, bound, div, s_inner, s_count, div != nullptr ? d_inner : 1,
               div != nullptr ? d_count : 1};
  const int64_t blocks = fake_quant_blocks(n, vec != 0);
  gridDim = dim3(static_cast<unsigned>(blocks));
  blockDim = dim3(kThreads);
  for (int64_t b = 0; b < blocks; ++b) {
    for (int t = 0; t < kThreads; ++t) {
      blockIdx = dim3(static_cast<unsigned>(b));
      threadIdx = dim3(t);
      // both index widths: the launcher takes 32 bits for every size here
      if (wide) {
        run<int64_t>(v, g, y, n, a, backward, vec);
      } else {
        run<uint32_t>(v, g, y, n, a, backward, vec);
      }
    }
  }
  return 0;
}
}
