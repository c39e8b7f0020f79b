// Hard-swish for NVIDIA Hopper (sm_90a), forward and backward, bound to
// Python with ctypes.
//
// Built by cocodet_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and no --use_fast_math. The arithmetic uses the explicit round-to-nearest
// intrinsics, so it rounds exactly where the plain PyTorch versions
// (ops/cuda/hard_swish.py::hard_swish_plain, hard_swish_grad_plain) and the
// JAX reference do, whatever the flags.
//
// hard_swish_kernel
//   Replaces jax.nn.hard_swish (x * relu6(x + 3.) / 6.), the activation of
//   cocodet_tpu/models/blocks.py::get_activation (:53-54), and its VJP,
//   which JAX leaves to XLA. What the kernel computes is what XLA:CPU
//   computes under jax.jit (jax 0.9.0), read from its optimized HLO:
//   forward, t = x + 3, c = clamp(t, 0, 6):
//     f32:  y = x * (c * f32(1/6))           (XLA turns /6 into * 0x3e2aaaab)
//     bf16: y = x * (c / 6), every op in f32 rounded to bf16; the kernel
//           computes c / 6 as c * f32(1/6), which for every bf16 c in
//           [0, 6] rounds to the same bf16 as the IEEE division of the plain
//           version (all 16,578 values: tests/test_torch_quantize.py::
//           test_bf16_division_by_six_is_a_multiply) at a third of the
//           instructions (an IEEE division made the forward compute-bound);
//   backward (cotangent g), relu6's strict mask m = (0 < t < 6), h = c * f32(1/6):
//     f32:  dx = fma(g, h, m ? (x * g) * f32(1/6) : 0)
//           XLA contracts g * h + s into one fused multiply-add, and /6 is a
//           multiply by f32(1/6); the mask reads t in f32;
//     bf16: dx = bf16(a + s) with t = bf16(x + 3), h = bf16(c * f32(1/6)),
//           a = bf16(g * h), s = m ? bf16(bf16(x * g) * f32(1/6)) : 0; each
//           op is computed in f32 and rounded to bf16 (no contraction across
//           a rounding), and the mask reads the rounded t, so x = 2.999
//           (3.0 in bf16) gives dx = g, and x = -3 gives 0.
//   NaN passes the clamp as it passes torch.clamp; subnormals are kept (no
//   flush to zero), as PyTorch keeps them.
//   Bound on the H100: bytes. One pass over contiguous memory: the forward
//   reads x and writes y, the backward reads x and g and writes dx, each
//   element once, at about 0.25 operations a byte. A thread moves one
//   16-byte vector (4 f32 or 8 bf16), and the grid covers the map in one
//   pass (no cap below it, no grid-stride trip). Timed on the card
//   (PERF.md), several vectors a thread and the streaming cache hints
//   (__ldcs/__stcs) were both slower at the served maps' shapes, the hints
//   most likely because the conv after the activation reads y while it is
//   still in L2. A misaligned pointer takes the scalar loop. The autograd Function saves x
//   only and the backward recomputes t, c and the mask, so no mask tensor is
//   written or read. In training the activation after a BatchNorm is fused
//   into the BN kernels (bn_act.cu); this kernel serves the folded model,
//   where hard-swish follows a conv with a bias.
//   The arithmetic is in hard_swish_ops.cuh, shared with bn_act.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hard_swish_ops.cuh"

namespace {

using namespace hard_swish_ops;

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, bool kBackward>
__device__ __forceinline__ float apply(T x, T g) {
  if constexpr (kBackward) {
    return backward_op(x, g);
  } else {
    return forward_op(x);
  }
}

// y[i] = op(x[i], g[i]) for i < n; g is read only by the backward.
// Vectorized: every pointer is 16-byte aligned; a thread takes one 16-byte
// vector; the last n % V elements take the scalar loop of block 0.
template <typename T, bool kBackward>
__global__ void __launch_bounds__(kThreads)
    hard_swish_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
                      int64_t n) {
  constexpr int V = 16 / sizeof(T);
  const int64_t nvec = n / V;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < nvec) {
    const uint4 xr = __ldg(reinterpret_cast<const uint4*>(x) + i);
    uint4 gr = xr;
    if constexpr (kBackward) gr = __ldg(reinterpret_cast<const uint4*>(g) + i);
    const T* xe = reinterpret_cast<const T*>(&xr);
    const T* ge = reinterpret_cast<const T*>(&gr);
    uint4 out;
    T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) store(oe + j, apply<T, kBackward>(xe[j], ge[j]));
    reinterpret_cast<uint4*>(y)[i] = out;
  }
  // the tail, by the first block
  if (blockIdx.x == 0) {
    for (int64_t k = nvec * V + threadIdx.x; k < n; k += kThreads) {
      store(y + k, apply<T, kBackward>(x[k], kBackward ? g[k] : x[k]));
    }
  }
}

// The scalar loop of a misaligned pointer: one element a thread.
template <typename T, bool kBackward>
__global__ void __launch_bounds__(kThreads)
    hard_swish_scalar_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             T* __restrict__ y, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) store(y + i, apply<T, kBackward>(x[i], kBackward ? g[i] : x[i]));
}

template <typename T, bool kBackward>
int launch(const void* x, const void* g, void* y, int64_t n, cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                    (kBackward ? reinterpret_cast<uintptr_t>(g) : 0)) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* yp = static_cast<T*>(y);
  if (vec) {
    const int64_t per_block = static_cast<int64_t>(kThreads) * (16 / sizeof(T));
    const int64_t blocks = n / per_block + 1;  // one pass; the tail rides on block 0
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    hard_swish_kernel<T, kBackward>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xp, gp, yp, n);
  } else {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    hard_swish_scalar_kernel<T, kBackward>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(xp, gp, yp, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y (and g for the backward) hold n elements each, in one layout, on the
// current device; dtype 0 is f32, 1 is bf16; backward 0 computes y =
// hard_swish(x), 1 computes y = the VJP of hard_swish at x with cotangent
// g. Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int cocodet_hard_swish(const void* x, const void* g, void* y, int64_t n, int dtype,
                       int backward, void* stream) {
  if (n <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || (backward && g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return backward ? launch<float, true>(x, g, y, n, s) : launch<float, false>(x, g, y, n, s);
  }
  return backward ? launch<__nv_bfloat16, true>(x, g, y, n, s)
                  : launch<__nv_bfloat16, false>(x, g, y, n, s);
}

}  // extern "C"
