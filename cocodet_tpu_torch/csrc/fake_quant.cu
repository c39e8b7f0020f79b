// Int8 fake-quantization for NVIDIA Hopper (sm_90a), forward and backward,
// bound to Python with ctypes.
//
// Built by cocodet_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and no --use_fast_math. Every f32 operation is an explicit round-to-nearest
// intrinsic, so nothing is contracted into a fused multiply-add and the
// kernel rounds where the plain version (ops/cuda/fake_quant.py::
// fake_quant_plain, fake_quant_grad_plain) and the JAX reference do.
//
// fake_quant_kernel
//   Replaces no Pallas kernel: JAX leaves fake-quant to XLA. It computes
//   cocodet_tpu/models/blocks.py::fake_quant (:140-153) as the quant="qat"
//   conv uses it (:284-319), forward and VJP, with the roundings XLA:CPU
//   gives the jitted QAT step (jax 0.9.0, read from its optimized HLO). Each
//   element v at storage index p has a scale s = scale[cs] and a bound
//   b = bound[cs], cs = (p / s_inner) % s_count (one pair for a per-tensor
//   scale, one per channel otherwise: for any dense layout, the channel of
//   index p along a dimension is (p / its stride) % its size):
//     forward:  m = max(-b, v), vc = min(b, m)          (jnp.clip: max, then min)
//               y = vc + (rint(vc / s) * s - vc)         (two roundings, not rint(vc/s)*s)
//               y = y / div[cd]   where a divisor is given (cd like cs)
//     backward: the gradient of XLA's max and min, which is 1/2 on a tie:
//               gmin = (m == vc) ? ((b == vc) ? 0.5 : 1) : 0
//               gmax = (v == m) ? ((-b == m) ? 0.5 : 1) : 0
//               dx = ((g / div[cd]) * gmin) * gmax
//   rint rounds half to even, the divisions are IEEE, max and min propagate
//   NaN (XLA's), so a NaN input gives a NaN output and a zero gradient.
//   The callers (ops/cuda/fake_quant.py) pass an activation's s and b =
//   s * 127, and a kernel's per-out-channel s = am * f32(1/127) and b = am
//   (am = max(max |w|, 1e-8)): XLA folds 127 * (am / 127) into am and the
//   division by 127 into that multiply, so each out channel's largest weight
//   sits on the bound and takes the gradient 1/2. A per-channel activation
//   scale folded into the kernel is cancelled by the divisor.
//   Bound on the H100: bytes. One pass over contiguous memory: the forward
//   reads v and writes y (4 + 4 bytes an element), the backward reads v and
//   g and writes dx (8 + 4). A thread moves one 16-byte vector (4 f32) and
//   finds the first element's channels by a division and a remainder each
//   (none for a per-tensor scale or no divisor), the next three by
//   counting, in 32-bit integers wherever the tensor's indices fit (64-bit
//   divisions made the first version 2.1x its bound, PERF.md); the grid
//   covers the tensor in one pass. A misaligned pointer takes the scalar
//   loop. Nothing is saved between the passes but v: the backward
//   recomputes the clip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// XLA's maximum and minimum: NaN if either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b != b) ? b : ((a != a || a > b) ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (b != b) ? b : ((a != a || a < b) ? a : b);
}

// the channel of a storage index along one dimension, stepped one index at a
// time: one division and one remainder when it starts, none for one channel
template <typename I>
struct Channel {
  I inner, count, c, r;
  __device__ __forceinline__ void start(I p) {
    c = 0;
    r = 0;
    if (count == 1) return;
    const I q = p / inner;
    r = p - q * inner;
    c = q % count;
  }
  __device__ __forceinline__ void next() {
    if (count == 1) return;
    if (++r == inner) {
      r = 0;
      if (++c == count) c = 0;
    }
  }
};

struct Args {
  const float* scale;
  const float* bound;
  const float* div;  // nullptr: no divisor
  int64_t s_inner, s_count, d_inner, d_count;
};

template <bool kBackward, typename I>
__device__ __forceinline__ float op(float v, float g, const Args& a, I cs, I cd) {
  const float b = a.bound[cs];
  const float m = max_nan(-b, v);
  const float vc = min_nan(b, m);
  if constexpr (kBackward) {
    const float gmin = (m == vc) ? ((b == vc) ? 0.5f : 1.0f) : 0.0f;
    const float gmax = (v == m) ? ((-b == m) ? 0.5f : 1.0f) : 0.0f;
    float t = a.div != nullptr ? __fdiv_rn(g, a.div[cd]) : g;
    t = __fmul_rn(t, gmin);
    return __fmul_rn(t, gmax);
  } else {
    const float s = a.scale[cs];
    const float q = rintf(__fdiv_rn(vc, s));
    const float y = __fadd_rn(vc, __fsub_rn(__fmul_rn(q, s), vc));
    return a.div != nullptr ? __fdiv_rn(y, a.div[cd]) : y;
  }
}

// y[p] = op(v[p], g[p]) for p < n; g is read only by the backward. Every
// pointer is 16-byte aligned; a thread takes one vector of 4; the last n % 4
// elements take the scalar loop of block 0. I indexes: 32 bits wherever n
// fits, 64 otherwise.
template <bool kBackward, typename I>
__global__ void __launch_bounds__(kThreads)
    fake_quant_kernel(const float* __restrict__ v, const float* __restrict__ g,
                      float* __restrict__ y, I n, Args a) {
  const I nvec = n / 4;
  const I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < nvec) {
    const float4 vr = __ldg(reinterpret_cast<const float4*>(v) + i);
    float4 gr = vr;
    if constexpr (kBackward) gr = __ldg(reinterpret_cast<const float4*>(g) + i);
    const float* ve = reinterpret_cast<const float*>(&vr);
    const float* ge = reinterpret_cast<const float*>(&gr);
    float4 out;
    float* oe = reinterpret_cast<float*>(&out);
    Channel<I> cs{static_cast<I>(a.s_inner), static_cast<I>(a.s_count), 0, 0};
    Channel<I> cd{static_cast<I>(a.d_inner), static_cast<I>(a.d_count), 0, 0};
    cs.start(4 * i);
    cd.start(4 * i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      oe[j] = op<kBackward, I>(ve[j], ge[j], a, cs.c, cd.c);
      cs.next();
      cd.next();
    }
    reinterpret_cast<float4*>(y)[i] = out;
  }
  // the tail, by the first block
  if (blockIdx.x == 0) {
    for (I k = nvec * 4 + threadIdx.x; k < n; k += kThreads) {
      Channel<I> cs{static_cast<I>(a.s_inner), static_cast<I>(a.s_count), 0, 0};
      Channel<I> cd{static_cast<I>(a.d_inner), static_cast<I>(a.d_count), 0, 0};
      cs.start(k);
      cd.start(k);
      y[k] = op<kBackward, I>(v[k], kBackward ? g[k] : v[k], a, cs.c, cd.c);
    }
  }
}

// The scalar loop of a misaligned pointer: one element a thread.
template <bool kBackward, typename I>
__global__ void __launch_bounds__(kThreads)
    fake_quant_scalar_kernel(const float* __restrict__ v, const float* __restrict__ g,
                             float* __restrict__ y, I n, Args a) {
  const I k = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (k < n) {
    Channel<I> cs{static_cast<I>(a.s_inner), static_cast<I>(a.s_count), 0, 0};
    Channel<I> cd{static_cast<I>(a.d_inner), static_cast<I>(a.d_count), 0, 0};
    cs.start(k);
    cd.start(k);
    y[k] = op<kBackward, I>(v[k], kBackward ? g[k] : v[k], a, cs.c, cd.c);
  }
}

// the blocks of a launch: one pass over n elements, vectors of 4 when aligned
__host__ __device__ inline int64_t fake_quant_blocks(int64_t n, bool vec) {
  return vec ? n / (4 * kThreads) + 1 : (n + kThreads - 1) / kThreads;
}

}  // namespace

// the kernel of a launch, by its direction, path and index width
template <typename I>
static void launch(const float* v, const float* g, float* y, int64_t n, const Args& a, bool backward,
            bool vec, unsigned grid, cudaStream_t s) {
  const I ni = static_cast<I>(n);
  if (vec) {
    if (backward) {
      fake_quant_kernel<true, I><<<grid, kThreads, 0, s>>>(v, g, y, ni, a);
    } else {
      fake_quant_kernel<false, I><<<grid, kThreads, 0, s>>>(v, g, y, ni, a);
    }
  } else if (backward) {
    fake_quant_scalar_kernel<true, I><<<grid, kThreads, 0, s>>>(v, g, y, ni, a);
  } else {
    fake_quant_scalar_kernel<false, I><<<grid, kThreads, 0, s>>>(v, g, y, ni, a);
  }
}

extern "C" {

// v, y (and g for the backward) hold n f32 elements each, in one dense
// layout, on the current device; scale and bound hold s_count values, div
// d_count (or is null). backward 0 computes y = fake_quant(v), 1 computes y
// = its VJP at v with cotangent g. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
int cocodet_fake_quant(const float* v, const float* g, float* y, int64_t n, const float* scale,
                       const float* bound, int64_t s_inner, int64_t s_count, const float* div,
                       int64_t d_inner, int64_t d_count, int backward, void* stream) {
  if (n <= 0) return 0;
  if ((backward && g == nullptr) || s_inner <= 0 || s_count <= 0 ||
      (div != nullptr && (d_inner <= 0 || d_count <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{scale, bound, div, s_inner, s_count, div != nullptr ? d_inner : 1,
               div != nullptr ? d_count : 1};
  const bool vec = (reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(y) |
                    (backward ? reinterpret_cast<uintptr_t>(g) : 0)) % 16 == 0;
  const int64_t blocks = fake_quant_blocks(n, vec);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  // 32-bit indices while every index, the grid's last thread's included, fits
  if (n + 4 * kThreads < (int64_t{1} << 32)) {
    launch<uint32_t>(v, g, y, n, a, backward != 0, vec, grid, s);
  } else {
    launch<int64_t>(v, g, y, n, a, backward != 0, vec, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
