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
// The overlap matrix is bit-packed. For B images of K score-sorted boxes,
// mask is a contiguous (B, K, W) array of 64-bit words, W = ceil(K / 64)
// rounded up to an even number (so a row is a multiple of 16 bytes, as a
// bulk copy needs). Bit j of mask[b, r, w] is
//   IoU(r, c) > thr  and  r < c  and  valid[r] and valid[c],   c = 64 w + j.
// Bits past K are 0, and so are the words wholly below the diagonal: every
// word of the array is written. At B=16, K=1024 that is 2 MiB, where an f32
// 0/1 matrix was 64 MiB.
//
// overlap_mask_kernel
//   Replaces the Pallas TPU kernel cocodet_tpu/ops/pallas/nms_kernels.py::
//   overlap_matrix (body _overlap_kernel, pallas_call at line 88).
//   Bound on the H100: operations. B*K*(K-1)/2 upper pairs at ~20 f32 ops
//   each (168 M ops at B=16, K=1024: 2.5 us at 67 TFLOP/s), against 2.4 MB
//   of boxes, flags and packed words (0.7 us at 3.35 TB/s).
//   Design: a block of 64 threads owns one 64 x 64 tile of one image on or
//   above the diagonal; each thread keeps its row box in registers and tests
//   it against the 64 column boxes staged in shared memory, then stores its
//   one 64-bit word. No block computes a tile below the diagonal: each block
//   above it also writes the zero word of the tile mirrored across it. The
//   IEEE division, with its slow-path branch, would split every pair into a
//   block of its own; so a first pass, without branches, marks only the
//   pairs whose IoU can exceed thr (a bound proved at the pass), and the
//   division decides the columns that some lane marked. Any K: the ragged
//   edge is masked here.
//
// greedy_keep_kernel
//   Replaces the exact greedy keep of cocodet_tpu/ops/nms.py, which JAX left
//   to XLA: the lax.while_loop fixpoint _greedy_keep (:56-99) and the
//   tile-sequential lax.scan _greedy_keep_tiled (:102-154):
//     for r in score order: keep[r] = valid[r] and not removed[r];
//                           if keep[r]: removed |= mask row r.
//   Bound on the H100: bytes, the upper words of the kept rows (~0.3 us on
//   the dense scene at B=16, K=1024); in practice the chain of K dependent
//   row decisions and the per-chunk steps below.
//   Design: one warp walks one image, with no __syncthreads. The image's
//   packed rows come into shared memory 64 rows (one chunk) at a time by TMA
//   bulk copies (cp.async.bulk completing on an mbarrier), through a ring of
//   up to four stages, so the next chunks are in flight while one is walked
//   and no row is read from device memory when the walk needs it. The
//   removed bits of the image, one row of W words, stay in shared memory
//   beside the ring. For chunk c the warp takes removed word c, resolves the
//   chunk's 64 rows on their diagonal words (word c) in registers, stepping
//   only through the rows whose diagonal word has a bit (the others remove
//   nothing in the chunk), writes the 64 keep bytes, and ORs the words after
//   c of the kept rows into the removed words, lane l taking words l,
//   l + 32, .... At most 224 words a row (K <= 14336): the removed words and
//   two stages of 64 rows must fit in a block's 227 KB of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;             // rows and columns of a tile; bits of a word
constexpr int kMaxStages = 4;         // depth of greedy_keep's ring of chunks
constexpr int kBarrierBytes = 64;     // the ring's mbarriers, before the chunks
constexpr int kSmemPerBlock = 232448; // H100: the most shared memory a block may take

// NaN-propagating min/max, as jnp.maximum / torch.maximum (fminf/fmaxf
// would drop a NaN and could turn a NaN box into an overlap). They may give
// another NaN payload or sign of zero than a select would, which no
// comparison below can tell apart.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// Intersection and union of boxes R and Q, with the operations of
// _overlap_kernel (nms_kernels.py:50-55) in their order, each rounded to
// nearest; the IoU is RN(inter / uni).
struct InterUnion {
  float inter, uni;
};
__device__ __forceinline__ InterUnion inter_union(float4 R, float area_r, float4 Q,
                                                  float area_q) {
  const float iw = max_nan(__fsub_rn(min_nan(R.z, Q.z), max_nan(R.x, Q.x)), 0.f);
  const float ih = max_nan(__fsub_rn(min_nan(R.w, Q.w), max_nan(R.y, Q.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  return {inter, max_nan(__fsub_rn(__fadd_rn(area_r, area_q), inter), 1e-12f)};
}

__global__ void __launch_bounds__(kTile)
overlap_mask_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid, u64* __restrict__ mask,
                    int K, int W, float thr) {
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  __shared__ unsigned cvalid[kTile / 32];

  // blockIdx.x enumerates the tiles (i, j >= i) of one image, row tile by
  // row tile; a row tile i has W - i of them.
  int i = 0, j = blockIdx.x;
  while (j >= W - i) {
    j -= W - i;
    ++i;
  }
  j += i;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const float4* bb = boxes + (size_t)b * K;
  const uint8_t* vb = valid + (size_t)b * K;
  u64* mb = mask + (size_t)b * K * W;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const int c = j * kTile + t;
  const float4 C = c < K ? bb[c] : zero;
  cbox[t] = C;
  carea[t] = box_area(C);
  const unsigned vbits = __ballot_sync(0xffffffffu, c < K && vb[c] != 0);
  if ((t & 31) == 0) cvalid[t >> 5] = vbits;
  __syncthreads();

  // The word of the mirrored tile (j, i), below the diagonal, is zero.
  const int rz = j * kTile + t;
  if (j > i && rz < K) mb[(size_t)rz * W + i] = 0ull;

  const int r = i * kTile + t;
  const float4 R = r < K ? bb[r] : zero;  // (x1, y1, x2, y2)
  const float area_r = box_area(R);

  // Pass 1, branch-free: mark the columns whose IoU may exceed thr. With thr
  // a positive normal float, thr_lo = RN(thr (1 - 2^-10)) and P =
  // RN(thr_lo uni) <= thr (1 - 2^-10) (1 + 2^-24)^2 uni < thr uni, so a pair
  // with inter < P has inter / uni < thr, and its rounded quotient is at most
  // thr: no hit. Every other pair (NaN and inf included) is marked.
  const bool filter = thr >= 1e-18f;  // P stays a normal float: uni >= 1e-12
  const float thr_lo = __fmul_rn(thr, 1.f - 1.f / 1024.f);
  u64 maybe = 0;
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    const InterUnion iu = inter_union(R, area_r, cbox[q], carea[q]);
    maybe |= (u64) !(iu.inter < __fmul_rn(thr_lo, iu.uni)) << q;
  }
  if (!filter) maybe = ~0ull;
  // Only pairs that can be set: valid row and column, column after the row.
  const bool rv = r < K && vb[r] != 0;
  const u64 keep_bits = rv ? ((u64)cvalid[1] << 32 | cvalid[0]) &
                                 (j > i ? ~0ull : t == kTile - 1 ? 0ull : ~0ull << (t + 1))
                           : 0ull;
  maybe &= keep_bits;

  // Pass 2: the IEEE division decides every column marked by some lane.
  u64 todo = ((u64)__reduce_or_sync(0xffffffffu, (unsigned)(maybe >> 32)) << 32) |
             __reduce_or_sync(0xffffffffu, (unsigned)maybe);
  u64 word = 0;
  while (todo) {
    const int q = __ffsll(static_cast<long long>(todo)) - 1;
    todo &= todo - 1;
    const InterUnion iu = inter_union(R, area_r, cbox[q], carea[q]);
    word |= (u64)(__fdiv_rn(iu.inter, iu.uni) > thr) << q;
  }

  if (r < K) mb[(size_t)r * W + j] = word & keep_bits;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1u) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of the barrier with this parity has completed. A copy
// that never lands fails the launch (a trap) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity);)
    if (++spins == (1u << 26)) __trap();
}

// One TMA bulk copy of `bytes` (a multiple of 16) from device memory into
// shared memory, completing on the barrier, which expects exactly it.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory: the ring's mbarriers, the image's W removed words, then the
// ring of chunks (16-byte aligned, as W is even).
__global__ void __launch_bounds__(32)
greedy_keep_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, int K, int W, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  u64* bars = reinterpret_cast<u64*>(smem);
  u64* removed = reinterpret_cast<u64*>(smem + kBarrierBytes);  // by a kept row
  u64* ring = removed + W;
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int chunks = (K + kTile - 1) / kTile;
  const size_t chunk_words = (size_t)kTile * W;
  const u64* mb = mask + (size_t)b * K * W;
  const uint8_t* vb = valid + (size_t)b * K;
  uint8_t* kb = keep + (size_t)b * K;

  // Lane 0 alone issues the copies: chunk c goes to stage c % stages.
  auto issue = [&](int c) {
    const int s = c % stages;
    const uint32_t rows = min(kTile, K - c * kTile);
    bulk_load(smem_addr(ring + s * chunk_words), mb + c * chunk_words,
              rows * W * (uint32_t)sizeof(u64), smem_addr(bars + s));
  };
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_addr(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < stages && c < chunks; ++c) issue(c);
  }
  for (int w = lane; w < W; w += 32) removed[w] = 0;
  __syncwarp();

  // valid flags of the chunk's rows lane and lane + 32, read a chunk ahead
  uint8_t v0 = lane < K ? vb[lane] : 0;
  uint8_t v1 = lane + 32 < K ? vb[lane + 32] : 0;

  for (int c = 0; c < chunks; ++c) {
    const int s = c % stages;
    // removed word c; an invalid row, or a row past K, counts as removed
    const u64 invalid = ~(((u64)__ballot_sync(0xffffffffu, v1 != 0) << 32) |
                          __ballot_sync(0xffffffffu, v0 != 0));
    const int n0 = (c + 1) * kTile + lane;
    v0 = n0 < K ? vb[n0] : 0;
    v1 = n0 + 32 < K ? vb[n0 + 32] : 0;
    u64 cur = removed[c] | invalid;

    mbar_wait(smem_addr(bars + s), (c / stages) & 1);
    const u64* rows = ring + s * chunk_words;

    // Resolve the chunk's rows in order on their diagonal words (word c),
    // lane l holding rows l and l + 32. Only a row whose diagonal word has a
    // bit after its own can remove a later row of the chunk, so the chain
    // steps through those rows alone, lowest first; each one still standing
    // is kept and removes the rows it overlaps.
    const u64 d0 = rows[lane * W + c] & (~0ull << lane << 1);
    const u64 d1 = lane == 31 ? 0ull : rows[(lane + 32) * W + c] & (~0ull << (lane + 33));
    const u64 live = ((u64)__ballot_sync(0xffffffffu, d1 != 0) << 32) |
                     __ballot_sync(0xffffffffu, d0 != 0);
    for (u64 todo = live & ~cur; todo;) {
      const int r = __ffsll(static_cast<long long>(todo)) - 1;
      cur |= __shfl_sync(0xffffffffu, r < 32 ? d0 : d1, r & 31);
      todo = live & ~cur & (~0ull << r << 1);
    }
    const u64 kept = ~cur;

    const int k0 = c * kTile + lane;
    if (k0 < K) kb[k0] = (kept >> lane) & 1;
    if (k0 + 32 < K) kb[k0 + 32] = (kept >> (lane + 32)) & 1;

    // The kept rows remove what they overlap in the words after c: lane l
    // ORs words l, l + 32, ...; four OR chains, each load masked by AND
    // instead of predicated.
    for (int w = c + 1 + ((lane - c - 1) & 31); w < W; w += 32) {
      u64 part[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < kTile; ++q)
        part[q & 3] |= rows[q * W + w] & (0ull - ((kept >> q) & 1));
      removed[w] |= (part[0] | part[1]) | (part[2] | part[3]);
    }

    // Every lane is done with stage s: refill it with chunk c + stages.
    __syncwarp();
    if (lane == 0 && c + stages < chunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(c + stages);
    }
  }
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32, valid (B, K) bool bytes, mask (B, K, W) int64 out
// (layout above); all contiguous on the current device. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
int cocodet_overlap_mask(const void* boxes, const void* valid, void* mask, int B,
                         int K, int W, float thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int row_tiles = (K + kTile - 1) / kTile;
  if (W < row_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = row_tiles * W - row_tiles * (row_tiles - 1) / 2;
  overlap_mask_kernel<<<dim3(tiles, B), kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<u64*>(mask), K, W, thr);
  return static_cast<int>(cudaGetLastError());
}

// mask (B, K, W) int64 from cocodet_overlap_mask (16-byte aligned), valid
// (B, K) bool bytes, keep (B, K) bool bytes out.
int cocodet_greedy_keep(const void* mask, const void* valid, void* keep, int B,
                        int K, int W, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const int chunks = (K + kTile - 1) / kTile;
  const size_t stage_bytes = (size_t)kTile * W * sizeof(u64);
  const size_t head = kBarrierBytes + (size_t)W * sizeof(u64);
  int stages = static_cast<int>((kSmemPerBlock - std::min<size_t>(head, kSmemPerBlock)) /
                                stage_bytes);
  stages = std::min(std::min(stages, kMaxStages), chunks);
  if (W < chunks || W % 2 || stages < std::min(2, chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = head + stages * stage_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        greedy_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  greedy_keep_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, W, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
