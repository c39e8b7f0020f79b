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
//   argument). After every multiply a result below FLT_MIN is flushed to
//   zero, as XLA flushes it on the CPU and the TPU (the keep mask s > 0
//   depends on it in a dense cluster).
//
//   Design. The factors d(i, j) do not read the running scores: only the
//   multiplies of a column must follow i order. So a block takes a tile of
//   32 columns of one image and walks the rows before its last column in
//   chunks of 128. Its 8 producer warps compute a chunk's 128 x 32 factors
//   (a warp 32 rows, a lane each, of 16 columns; the next chunk's rows
//   loaded ahead); __ballot_sync marks the factors that are not exactly 1,
//   and factors and marks go to shared memory (two buffers). After one
//   barrier the consumer warp (a lane a column) multiplies its column's
//   marked factors of the chunk in ascending i, while the producers compute
//   the next chunk into the other buffer. At (16, 2048) that is 1,024
//   blocks of 9 warps in place of 32,768 threads. A tile reads only the
//   rows before its columns, so the work grows with the tile index: blocks
//   take the tiles heaviest first (the last tile of every image, then the
//   one before), so the card's last wave is made of the lightest blocks.
//   (Measured on the card at (16, 2048): chunks of 128 rows beat 64, a
//   consumer warp of its own beat a producer that also consumes, and 4 or
//   16 producers lost to 8; chip_smoke.py --soft times the kernel.)
//
//   Exact rewrites, each bit for bit with the plain version:
//   - A factor of exactly 1 is not multiplied: s * 1 == s, and s is
//     already flushed, so the flush changes nothing. Invalid rows (factor
//     1 in the plain version) are skipped the same way.
//   - A pair of finite boxes (coordinates and area) that are apart on an
//     axis (min(x2) <= max(x1): their difference is then <= 0, clamped to
//     0), or whose intersection rounds to 0, has factor 1 and takes neither
//     the division nor the expf: its union a_i + a_j - 0 is no NaN, so iou
//     is a zero and expf(-0) = 1. Without a NaN coordinate fminf/fmaxf equal
//     the NaN-propagating min/max. A pair with a non-finite box takes the
//     full path, whose NaN or inf reaches the product as in the plain
//     version (a NaN coordinate makes iw NaN, never 0; iw 0 with ih inf
//     makes the intersection NaN).
//   - x / 0.5 is computed as x * 2: dividing by a power of two is an exact
//     scaling, so both round the same real number (and overflow alike).
//   The IoU's division stays __fdiv_rn and the exponential expf (the plain
//   version on the card is torch.exp); the flush stays in software.
//
//   Bound on the H100, counted from the data: each valid row i < j is
//   tested for overlap (~10 f32 operations), and each pair whose factor is
//   not 1 adds the union, the IEEE division, the square and scale, the
//   expf, the multiply and the flush (~10 more), over 67 TFLOP/s; against
//   the 25 bytes a row of boxes, flags, scores and output. On the served
//   candidates almost every pair is of two classes (apart under the class
//   offset) or disjoint and stops at the overlap test. The serial floor is
//   the longest column's chain of factors that are not 1, at most K - 1
//   dependent multiplies. chip_smoke.py (phase o3) prints all three counts.
//   Any K: the ragged edge is masked here.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kProducers = 8;                  // warps that compute factors
constexpr int kWarps = kProducers + 1;         // and the one that multiplies them
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;                      // columns of a tile: the last warp's lanes
constexpr int kGroups = 4;                     // 32-row groups of a chunk
constexpr int kRows = 32 * kGroups;            // rows of a chunk
constexpr int kUnits = kCols * kGroups / kProducers;  // columns a producer takes in a chunk
constexpr int kPitch = kRows + 1;              // a column's factors, padded against bank conflicts
constexpr int kNotFinite = 0x40000000;         // flag beside a column's row limit (K < 2^30)
constexpr unsigned kAll = 0xffffffffu;
static_assert(kCols == 32 && kProducers % kGroups == 0, "a tile's columns are one warp's lanes");

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

// Four finite coordinates and a finite area.
__device__ __forceinline__ bool finite_box(float4 b, float area) {
  return fabsf(b.x) <= FLT_MAX && fabsf(b.y) <= FLT_MAX && fabsf(b.z) <= FLT_MAX &&
         fabsf(b.w) <= FLT_MAX && fabsf(area) <= FLT_MAX;
}

// A result below FLT_MIN becomes a zero of its sign (FTZ).
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v;
}

// d(i, j) of row box R and column box C (column area at *cap), as
// pairwise_iou(a = row, b = column) orders it. fin: both boxes finite, where
// fminf/fmaxf equal the NaN-propagating min/max and a pair apart on an axis
// has factor 1 (the rewrite above).
__device__ __forceinline__ float decay(float4 R, float ra, float4 C, const float* cap, bool fin) {
  float inter;
  if (fin) {
    if (fminf(R.z, C.z) <= fmaxf(R.x, C.x) || fminf(R.w, C.w) <= fmaxf(R.y, C.y)) return 1.f;
    const float iw = fmaxf(__fsub_rn(fminf(R.z, C.z), fmaxf(R.x, C.x)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(R.w, C.w), fmaxf(R.y, C.y)), 0.f);
    inter = __fmul_rn(iw, ih);
    if (inter == 0.f) return 1.f;
  } else {
    const float iw = max_nan(__fsub_rn(min_nan(R.z, C.z), max_nan(R.x, C.x)), 0.f);
    const float ih = max_nan(__fsub_rn(min_nan(R.w, C.w), max_nan(R.y, C.y)), 0.f);
    inter = __fmul_rn(iw, ih);
  }
  const float uni = max_nan(__fsub_rn(__fadd_rn(ra, *cap), inter), 1e-12f);
  const float iou = __fdiv_rn(inter, uni);
  return expf(__fmul_rn(-__fmul_rn(iou, iou), 2.0f));
}

__global__ void __launch_bounds__(kThreads)
soft_decay_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  const float* __restrict__ scores, float* __restrict__ out, int B, int K) {
  __shared__ float4 cbox[kCols];
  __shared__ float carea[kCols];
  __shared__ int clim[kCols];  // rows i < clim decay the column (0 past K), | kNotFinite
  __shared__ float fac[2][kCols][kPitch];
  __shared__ uint32_t marks[2][kGroups][kCols];

  const int tiles = (K + kCols - 1) / kCols;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x) / B;  // heaviest first
  const int b = static_cast<int>(blockIdx.x) % B;
  const int j0 = tile * kCols;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const float4* bb = boxes + (size_t)b * K;
  const uint8_t* vb = valid + (size_t)b * K;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (warp == 0) {
    const int j = j0 + lane;
    const float4 C = j < K ? bb[j] : zero;
    const float area = box_area(C);
    const bool fin = finite_box(C, area);
    cbox[lane] = C;
    carea[lane] = area;
    clim[lane] = (j < K ? j : 0) | (fin ? 0 : kNotFinite);
  }
  // the last warp's lane owns column j0 + lane
  const bool owner = warp == kProducers && j0 + lane < K;
  float s = owner ? flush(scores[(size_t)b * K + j0 + lane]) : 0.f;
  __syncthreads();

  const int rows = min(K, j0 + kCols) - 1;  // rows i < the tile's last column
  const int group = warp % kGroups;
  const int c0 = warp / kGroups * kUnits;
  // this warp's row of the chunk, the next chunk's loaded ahead
  int i = group * 32 + lane;
  bool rv = i < rows && vb[i];
  float4 R = rv ? bb[i] : zero;
  for (int base = 0, buf = 0; base < rows; base += kRows, buf ^= 1) {
    const int next = i + kRows;
    const bool next_rv = next < rows && vb[next];
    const float4 next_R = next_rv ? bb[next] : zero;

    // the factors of this chunk: this row against kUnits columns
    const float ra = box_area(R);
    const bool rfin = finite_box(R, ra);
    const int rlim = rv ? i : 0x7fffffff;  // an invalid row decays nothing
    if (warp < kProducers)
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int c = c0 + u;
      const int lim = clim[c];
      const float d = rlim < (lim & (kNotFinite - 1))
                          ? decay(R, ra, cbox[c], &carea[c], rfin && lim < kNotFinite)
                          : 1.f;
      const uint32_t m = __ballot_sync(kAll, d != 1.f);
      fac[buf][c][group * 32 + lane] = d;
      if (lane == 0) marks[buf][group][c] = m;
    }
    i = next;
    rv = next_rv;
    R = next_R;
    __syncthreads();
    // the ordered multiplies of this chunk, while the producers compute
    // the next chunk into the other buffer
    if (warp == kProducers) {
      for (int g = 0; g < kGroups; ++g) {
        uint32_t m = marks[buf][g][lane];
        const float* f = &fac[buf][lane][g * 32];
        if (m == kAll) {
#pragma unroll 8
          for (int r = 0; r < 32; ++r) s = flush(__fmul_rn(s, f[r]));
        } else {
          while (m) {
            const int r = __ffs(m) - 1;
            m &= m - 1;
            s = flush(__fmul_rn(s, f[r]));
          }
        }
      }
    }
  }
  if (owner) out[(size_t)b * K + j0 + lane] = s;
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32, valid (B, K) bool bytes, scores (B, K) f32, out (B, K)
// f32; all contiguous on the current device. Returns cudaGetLastError()
// after the launch (0 = cudaSuccess).
int cocodet_soft_decay(const void* boxes, const void* valid, const void* scores, void* out,
                       int B, int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const long long blocks = static_cast<long long>(B) * ((K + kCols - 1) / kCols);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  soft_decay_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(scores), static_cast<float*>(out), B, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
