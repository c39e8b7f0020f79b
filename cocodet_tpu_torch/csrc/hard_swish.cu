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
//   element once, at about 0.25 operations a byte. Each thread moves 16
//   bytes at a time (4 f32 or 8 bf16) through a grid-stride loop; a
//   misaligned pointer takes the scalar loop. The autograd Function saves x
//   only and the backward recomputes t, c and the mask, so no mask tensor is
//   written or read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;       // 16 blocks of 256 threads an SM
constexpr float kSixth = 0x1.555556p-3f;   // f32(1/6), 0x3e2aaaab

__device__ __forceinline__ float clamp06(float t) {
  const float c = t < 0.f ? 0.f : t;  // NaN stays NaN
  return c > 6.f ? 6.f : c;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One element. For bf16 the returned float is rounded to bf16 by store().
__device__ __forceinline__ float forward_op(float x, float) {
  return __fmul_rn(x, __fmul_rn(clamp06(__fadd_rn(x, 3.f)), kSixth));
}

__device__ __forceinline__ float forward_op(__nv_bfloat16 xb, __nv_bfloat16) {
  const float x = __bfloat162float(xb);
  const float t = round_bf16(__fadd_rn(x, 3.f));
  const float h = round_bf16(__fmul_rn(clamp06(t), kSixth));
  return __fmul_rn(x, h);
}

__device__ __forceinline__ float backward_op(float x, float g) {
  const float t = __fadd_rn(x, 3.f);
  const float h = __fmul_rn(clamp06(t), kSixth);
  const float s = (t > 0.f && t < 6.f) ? __fmul_rn(__fmul_rn(x, g), kSixth) : 0.f;
  return __fmaf_rn(g, h, s);
}

__device__ __forceinline__ float backward_op(__nv_bfloat16 xb, __nv_bfloat16 gb) {
  const float x = __bfloat162float(xb), g = __bfloat162float(gb);
  const float t = round_bf16(__fadd_rn(x, 3.f));
  const float h = round_bf16(__fmul_rn(clamp06(t), kSixth));
  const float a = round_bf16(__fmul_rn(g, h));
  const float s = (t > 0.f && t < 6.f)
                      ? round_bf16(__fmul_rn(round_bf16(__fmul_rn(x, g)), kSixth))
                      : 0.f;
  return __fadd_rn(a, s);
}

template <typename T, bool kBackward>
__device__ __forceinline__ float apply(T x, T g) {
  if constexpr (kBackward) {
    return backward_op(x, g);
  } else {
    return forward_op(x, g);
  }
}

// y[i] = op(x[i], g[i]) for i < n; g is read only by the backward. kVec:
// every pointer is 16-byte aligned, and 16 bytes move at a time.
template <typename T, bool kBackward, bool kVec>
__global__ void __launch_bounds__(kThreads)
    hard_swish_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ y,
                      int64_t n) {
  constexpr int V = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if constexpr (kVec) {
    const int64_t nvec = n / V;
    for (int64_t i = first; i < nvec; i += stride) {
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x) + i);
      uint4 gv = xv;
      if constexpr (kBackward) gv = __ldg(reinterpret_cast<const uint4*>(g) + i);
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* ge = reinterpret_cast<const T*>(&gv);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) store(oe + j, apply<T, kBackward>(xe[j], ge[j]));
      reinterpret_cast<uint4*>(y)[i] = out;
    }
    done = nvec * V;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    store(y + i, apply<T, kBackward>(x[i], kBackward ? g[i] : x[i]));
  }
}

template <typename T, bool kBackward>
int launch(const void* x, const void* g, void* y, int64_t n, cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                    (kBackward ? reinterpret_cast<uintptr_t>(g) : 0)) % 16 == 0;
  const int64_t per_thread = vec ? 16 / sizeof(T) : 1;
  const int64_t work = (n + per_thread - 1) / per_thread;
  const int blocks = static_cast<int>(
      work / kThreads + 1 < kMaxBlocks ? work / kThreads + 1 : kMaxBlocks);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* yp = static_cast<T*>(y);
  if (vec) {
    hard_swish_kernel<T, kBackward, true><<<blocks, kThreads, 0, stream>>>(xp, gp, yp, n);
  } else {
    hard_swish_kernel<T, kBackward, false><<<blocks, kThreads, 0, stream>>>(xp, gp, yp, n);
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
