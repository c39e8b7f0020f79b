// NMS kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Built by cocodet_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and no --use_fast_math: the IoU below must round exactly as the plain
// PyTorch version (ops/boxes.py::pairwise_iou) and the JAX reference do, or
// boxes near the threshold flip and the keep masks drift. The arithmetic
// also uses the explicit round-to-nearest intrinsics, so it stays IEEE even
// if the flags change.
//
// overlap_matrix_kernel
//   Replaces the Pallas TPU kernel cocodet_tpu/ops/pallas/nms_kernels.py::
//   overlap_matrix (body _overlap_kernel, pallas_call at line 88). For B
//   images of K score-sorted, class-offset xyxy boxes it writes the (B, K, K)
//   f32 0/1 matrix
//     overlap[r, c] = IoU(r, c) > thr  and  r < c  and  valid[r] and valid[c].
//   Bound on the H100: the f32 output write, 4*B*K*K bytes (64 MiB at B=16,
//   K=1024: about 20 us at 3.35 TB/s); the IoU arithmetic is ~15 f32 ops per
//   element, a sixth of that time at 67 TFLOP/s. Design: one thread per
//   output element, a block is a 4 x 64 tile whose 68 boxes and flags are
//   staged in shared memory, so a warp stores 32 consecutive floats (one
//   128-byte line); batch on blockIdx.z; any K, the ragged edge masked here.
//
// greedy_keep_kernel
//   Replaces the exact greedy keep of cocodet_tpu/ops/nms.py, which JAX left
//   to XLA: the lax.while_loop fixpoint _greedy_keep (:56-99) and the
//   tile-sequential lax.scan _greedy_keep_tiled (:102-154). In PyTorch those
//   loops would cost a host sync per iteration; here the whole walk runs on
//   the device, one block per image:
//     for r in score order: keep[r] = valid[r] and not removed[r];
//                           if keep[r]: removed[c] |= overlap[r, c] (c > r).
//   Bound on the H100: the bytes of the overlap rows it must read (the
//   strictly upper part of each kept row), but in practice the K dependent
//   steps: each step is a __syncthreads plus, for a kept row, one load round
//   trip to L2/HBM, so the time grows with K and with the kept count, not
//   with bytes.
//
// Later work, not in this file yet: a bit-packed overlap matrix (32x fewer
// bytes written and read), and a fused design that builds the overlap rows
// of a tile and resolves its keep mask in one kernel without the matrix in
// device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOvCols = 64;  // output columns per block
constexpr int kOvRows = 4;   // output rows per block
constexpr int kKeepThreads = 256;  // threads of the one block per image

// NaN-propagating min/max, as jnp.maximum / torch.maximum (fminf/fmaxf
// would drop a NaN and could turn a NaN box into an overlap).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void overlap_matrix_kernel(const float4* __restrict__ boxes,
                                      const uint8_t* __restrict__ valid,
                                      float* __restrict__ out, int K,
                                      float thr) {
  __shared__ float4 rbox[kOvRows];
  __shared__ float4 cbox[kOvCols];
  __shared__ uint8_t rval[kOvRows];
  __shared__ uint8_t cval[kOvCols];

  const int b = blockIdx.z;
  const int c0 = blockIdx.x * kOvCols;
  const int r0 = blockIdx.y * kOvRows;
  const int tid = threadIdx.y * kOvCols + threadIdx.x;
  const float4* bb = boxes + (size_t)b * K;
  const uint8_t* vb = valid + (size_t)b * K;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (tid < kOvCols) {
    const int c = c0 + tid;
    cbox[tid] = c < K ? bb[c] : zero;
    cval[tid] = c < K ? vb[c] : 0;
  } else if (tid < kOvCols + kOvRows) {
    const int i = tid - kOvCols;
    const int r = r0 + i;
    rbox[i] = r < K ? bb[r] : zero;
    rval[i] = r < K ? vb[r] : 0;
  }
  __syncthreads();

  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  if (r >= K || c >= K) return;

  const float4 R = rbox[threadIdx.y];  // (x1, y1, x2, y2)
  const float4 C = cbox[threadIdx.x];
  // The order of _overlap_kernel (nms_kernels.py:50-56), op for op.
  const float iw = max_nan(__fsub_rn(min_nan(R.z, C.z), max_nan(R.x, C.x)), 0.f);
  const float ih = max_nan(__fsub_rn(min_nan(R.w, C.w), max_nan(R.y, C.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float area_r = __fmul_rn(__fsub_rn(R.z, R.x), __fsub_rn(R.w, R.y));
  const float area_c = __fmul_rn(__fsub_rn(C.z, C.x), __fsub_rn(C.w, C.y));
  const float uni = max_nan(__fsub_rn(__fadd_rn(area_r, area_c), inter), 1e-12f);
  const float iou = __fdiv_rn(inter, uni);

  const bool hit = iou > thr && r < c && rval[threadIdx.y] && cval[threadIdx.x];
  out[((size_t)b * K + r) * K + c] = hit ? 1.f : 0.f;
}

__global__ void greedy_keep_kernel(const float* __restrict__ overlap,
                                   const uint8_t* __restrict__ valid,
                                   uint8_t* __restrict__ keep, int K) {
  extern __shared__ uint8_t removed[];  // K flags: invalid or suppressed
  const int b = blockIdx.x;
  const float* ov = overlap + (size_t)b * K * K;
  const uint8_t* vb = valid + (size_t)b * K;
  uint8_t* kb = keep + (size_t)b * K;

  for (int c = threadIdx.x; c < K; c += blockDim.x) removed[c] = vb[c] ? 0 : 1;
  __syncthreads();

  for (int r = 0; r < K; ++r) {
    // Every thread reads the same flag after the barrier: the branch is
    // uniform, and the barrier below is reached by all threads.
    const bool take = removed[r] == 0;
    if (threadIdx.x == 0) kb[r] = take ? 1 : 0;
    if (take) {
      const float* row = ov + (size_t)r * K;
      // Only columns after r: the matrix is strictly upper-triangular, and
      // removed[r] itself is read above before anyone can write it.
      for (int c = r + 1 + threadIdx.x; c < K; c += blockDim.x) {
        if (row[c] != 0.f) removed[c] = 1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32, valid (B, K) bool bytes, out (B, K, K) f32; all
// contiguous on the current device. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
int cocodet_overlap_matrix(const void* boxes, const void* valid, void* out,
                           int B, int K, float thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const dim3 block(kOvCols, kOvRows);
  const dim3 grid((K + kOvCols - 1) / kOvCols, (K + kOvRows - 1) / kOvRows, B);
  overlap_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), K, thr);
  return static_cast<int>(cudaGetLastError());
}

// overlap (B, K, K) f32 strictly upper-triangular 0/1, valid (B, K) bool
// bytes, keep (B, K) bool bytes out. K bytes of dynamic shared memory.
int cocodet_greedy_keep(const void* overlap, const void* valid, void* keep,
                        int B, int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  greedy_keep_kernel<<<B, kKeepThreads, K, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(overlap), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
