// Gaussian soft-NMS score decay for NVIDIA Hopper (sm_90a), bound to Python
// with ctypes.
//
// Built by cocodet_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and no --use_fast_math: every operation below rounds as the plain PyTorch
// version (ops/cuda/soft_nms.py::soft_decay_plain) rounds it, with the
// explicit round-to-nearest intrinsics, so nothing is contracted into an FMA
// and the results agree bit for bit.
//
// soft_decay_kernel
//   Replaces the lax.scan of cocodet_tpu/ops/nms.py::_soft_keep_scores
//   (:157-175), which XLA runs as a K-step loop over (K,) vectors. For B
//   images of K score-sorted, class-offset boxes, each row's decayed score is
//     s[j] * d(i0, j) * d(i1, j) * ...   over the valid rows i < j, in i order,
//     d(i, j) = expf(-(iou(i, j) * iou(i, j)) / 0.5),
//   iou as ops/boxes.py::pairwise_iou computes it (row i as its first
//   argument). The decay of a row does not depend on the running scores, so
//   the K products are independent: the scan's sequence lives only in the
//   order of each product's factors. After every multiply a result below
//   FLT_MIN is flushed to zero, as XLA flushes it on the CPU and the TPU
//   (the keep mask s > 0 depends on it in a dense cluster).
//   Bound on the H100: operations. K (K - 1) / 2 pairs an image, each an IoU
//   (~14 f32 operations with the IEEE division), a square, an expf and a
//   multiply: ~20 f32 operations a pair (42 M pairs, 0.84 G operations at
//   B=16, K=2048: 12.5 us at 67 TFLOP/s), against 0.3 MB of boxes, flags and
//   scores.
//   Design: one thread owns one column j of one image (blockIdx.y); the
//   rows i < the block's last column come through shared memory 256 at a
//   time (box, area, valid), and each thread walks them in order. A block
//   reads only the rows before its columns, so the work grows along the
//   grid (the triangle's imbalance is left as it is). Any K: the ragged edge
//   is masked here.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // columns of a block; rows of a staged chunk

// NaN-propagating min/max, as torch.maximum / jnp.maximum (fminf/fmaxf
// alone would drop a NaN). The sign they give a zero does not reach the
// decay: it is squared.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// A result below FLT_MIN becomes a zero of its sign (FTZ).
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

__global__ void __launch_bounds__(kThreads)
soft_decay_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  const float* __restrict__ scores, float* __restrict__ out, int K) {
  __shared__ float4 rbox[kThreads];
  __shared__ float rarea[kThreads];
  __shared__ uint8_t rvalid[kThreads];

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int j = static_cast<int>(blockIdx.x) * kThreads + t;
  const float4* bb = boxes + (size_t)b * K;
  const uint8_t* vb = valid + (size_t)b * K;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const float4 C = j < K ? bb[j] : zero;
  const float area_c = box_area(C);
  float s = j < K ? flush(scores[(size_t)b * K + j]) : 0.f;

  // rows [0, last column of the block)
  const int rows = min(K, static_cast<int>(blockIdx.x + 1) * kThreads) - 1;
  for (int base = 0; base < rows; base += kThreads) {
    const int r = base + t;
    const float4 R = r < K ? bb[r] : zero;
    rbox[t] = R;
    rarea[t] = box_area(R);
    rvalid[t] = r < K ? vb[r] : 0;
    __syncthreads();
    const int end = min(kThreads, j - base);  // rows i < j of this chunk
    for (int q = 0; q < end; ++q) {
      if (!rvalid[q]) continue;
      const float4 Q = rbox[q];
      // pairwise_iou(a = row, b = column), in its order of operations
      const float iw = max_nan(__fsub_rn(min_nan(Q.z, C.z), max_nan(Q.x, C.x)), 0.f);
      const float ih = max_nan(__fsub_rn(min_nan(Q.w, C.w), max_nan(Q.y, C.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = max_nan(__fsub_rn(__fadd_rn(rarea[q], area_c), inter), 1e-12f);
      const float iou = __fdiv_rn(inter, uni);
      const float d = expf(__fdiv_rn(-__fmul_rn(iou, iou), 0.5f));
      s = flush(__fmul_rn(s, d));
    }
    __syncthreads();
  }
  if (j < K) out[(size_t)b * K + j] = s;
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32, valid (B, K) bool bytes, scores (B, K) f32, out (B, K)
// f32; all contiguous on the current device. Returns cudaGetLastError()
// after the launch (0 = cudaSuccess).
int cocodet_soft_decay(const void* boxes, const void* valid, const void* scores, void* out,
                       int B, int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + kThreads - 1) / kThreads, B);
  soft_decay_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(scores), static_cast<float*>(out), K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
