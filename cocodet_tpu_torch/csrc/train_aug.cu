// The device-mosaic training input pipeline for NVIDIA Hopper (sm_90a), bound
// to Python with ctypes: four kernels that take a collated batch of raw uint8
// tiles to the f32 images the train step consumes.
//
// Built by cocodet_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and no --use_fast_math. Every operation uses the explicit round-to-nearest
// intrinsics (IEEE division, no contraction into fused multiply-adds), so each
// kernel rounds exactly where its plain PyTorch version
// (ops/cuda/train_aug.py::*_plain) rounds, and equals it bit for bit. The
// plain versions follow the JAX programs op by op, in f32.
//
// What they replace (XLA programs of the JAX package, not Pallas kernels):
//   mosaic_canvas_kernel  cocodet_tpu/data/device_mosaic.py::compose_canvas
//                         (:160; _tile_rects :108, _sample_tile_to_canvas :132)
//   affine_pass_kernel    device_mosaic.py::affine_warp (:236) with
//                         _shift_scale_pass (:195), launched once per pass
//   mixup_kernel          device_mosaic.py::_mixup_partner (:287) and the
//                         origin select and blend of _mosaic_one (:396-422)
//   train_aug_kernel      cocodet_tpu/data/device_aug.py::_train_aug_one (:202)
//                         with hsv_jitter (:100) and letterbox_resize_one (:137)
// The JAX programs run per item under vmap and lax.map chunks; here the whole
// batch is one launch of each kernel (two of affine_pass_kernel). K2 and K3
// run one thread a pixel, all three channels in the thread; K1 and K4 run one
// block an output tile (below).
//
// Rounding as JAX's: jnp.round is half to even (rintf), the mixup blend is
// floor, the HSV gains are truncated before they arrive; jnp.remainder takes
// the sign of the divisor (pymod below), where fmodf takes the dividend's;
// jnp.select's default branch is sector 5.
//
// Bound on the H100: bytes. Each function reads its inputs and writes its
// output once at a few tens of operations a pixel. At B=16, 768 px: the
// canvas reads the tiles' rectangles (72 MB of uint8) and writes a 2x canvas
// (113 MB); the warp's first pass reads the canvas and writes an f32
// half-width map, which the second pass reads in place, by columns (no
// transpose copy), writing uint8; the mixup reads the warped mosaic, tile 0
// and the partner, and writes the uint8 mid image; the last kernel reads it
// and writes the f32 images the step takes (113 MB). Intermediates that hold
// integers are stored as uint8 (exact), so the only f32 intermediate is the
// warp's unrounded first pass.
//
// K1 and K4 move the most bytes of the four, and one thread a pixel spent
// its instructions, not the bytes, on them: per pixel 64-bit index division,
// four IEEE divisions for the taps (K1 also the rectangles and the where
// chain), twelve byte gathers, three strided stores, and in K4 the HSV round
// trip (four divisions, three remainders) at each of four taps, so every
// source pixel was jittered about four times. So a block owns a tile of its
// output in one item, 64 x 64 pixels (K1) or 32 x 64 (K4), on a 2-D grid
// with 32-bit index math within an item:
//   - its prologue computes the taps of the tile's rows and columns once,
//     into shared memory, while cp.async copies in the source rows they span
//     (16-byte chunks of the aligned byte range);
//   - K1: a block outside every rectangle writes 114 with 16-byte stores and
//     reads nothing; otherwise, tile by tile, it resamples from shared
//     memory into an output tile there, written as 16-byte vectors;
//   - K4: it jitters each source pixel once, in shared memory, into a word
//     of three bytes (the values are integers in [0, 255]; the flipped
//     column of a flipped item, the clean pixel of a fallback item), then
//     blends 4-pixel groups from the words and writes them through a
//     per-warp buffer as coalesced 16-byte vectors;
//   - a tap whose two weights are 0 is the blend's exact value, its first
//     tap, taken without the arithmetic: the pipeline resizes its tiles when
//     it loads them, so on its path every resample is unscaled;
//   - bytes become f32 and rounded f32 becomes bytes by adding 2^23 (exact,
//     and rintf's rounding), on the FMA pipe, not the conversion unit; the
//     HSV remainders take exact short paths (fmod_pos), one division picks
//     its operands, and a zero dividend skips its division.
// A rectangle that does not fit its stage (a downscale) is walked in bands of
// output rows; each stage is sized at launch to hold two whole source rows,
// which one output row needs at most, so every scale takes the same path.
// What still bounds them on this card (PERF.md): K4's HSV arithmetic, about
// half its time (four IEEE divisions and three remainders a source pixel, in
// JAX's order); for both, the per-block steps between barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);  // jnp.clip: minimum(maximum(x, lo), hi)
}

// fmodf(x, y) for y > 0 without fmodf's general reduction where |x| < 4y:
// |x| - 2y and then - y are exact there (Sterbenz's lemma), as fmodf is, and
// the result takes x's sign, zero included, so the bits are fmodf's.
__device__ __forceinline__ float fmod_pos(float x, float y) {
  float a = fabsf(x);
  if (!(a < __fmul_rn(4.f, y))) return fmodf(x, y);
  if (a >= __fmul_rn(2.f, y)) a = __fsub_rn(a, __fmul_rn(2.f, y));
  if (a >= y) a = __fsub_rn(a, y);
  return copysignf(a, x);
}

// jnp.remainder for f32 and y > 0: fmod, then + y where it is negative.
__device__ __forceinline__ float pymod(float x, float y) {
  float r = fmod_pos(x, y);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, y);
  return r;
}

__device__ __forceinline__ float round_u8(float x) { return rintf(clampf(x, 0.f, 255.f)); }

// Byte <-> f32 on the FMA and integer pipes, not the conversion unit: in
// [2^23, 2^24) the f32 spacing is 1, so 2^23 + k holds the integer k in its
// mantissa, and adding 2^23 to x in [0, 2^22) rounds it half to even, as
// rintf does.
constexpr float kTwo23 = 8388608.f;
constexpr uint32_t kTwo23Bits = 0x4B000000u;

__device__ __forceinline__ float u8f(uint32_t k) {  // k < 2^23
  return __fsub_rn(__uint_as_float(kTwo23Bits | k), kTwo23);
}

// byte ch of a word of three bytes, as f32
__device__ __forceinline__ float word_byte(uint32_t w, int ch) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, kTwo23Bits, 0x7540 | ch)), kTwo23);
}

// rintf(clampf(x, 0, 255)) as an integer
__device__ __forceinline__ uint32_t round_byte(float x) {
  return __float_as_uint(__fadd_rn(clampf(x, 0.f, 255.f), kTwo23)) - kTwo23Bits;
}

// One axis of a bilinear sample with cv2.INTER_LINEAR semantics
// (device_aug.py::_lin_weights, device_mosaic.py::_sample_tile_to_canvas):
// position o reads src at (o + 0.5) / scale - 0.5, taps clamped to
// [0, max(src_len - 1, 0)].
struct Tap {
  int i0, i1;
  float w;
};

__device__ __forceinline__ Tap lin_tap(float o, float scale, int src_len) {
  const float p = __fsub_rn(__fdiv_rn(__fadd_rn(o, 0.5f), scale), 0.5f);
  const float f = floorf(p);
  const int hi = max(src_len - 1, 0);
  const int i = static_cast<int>(f);
  Tap t;
  t.w = clampf(__fsub_rn(p, f), 0.f, 1.f);
  t.i0 = min(max(i, 0), hi);
  t.i1 = min(max(i + 1, 0), hi);
  return t;
}

// rows first, then columns, as JAX's separable gathers:
//   r0 = a(y0, x0) (1 - wy) + a(y1, x0) wy, r1 likewise at x1,
//   out = r0 (1 - wx) + r1 wx
// With wy = wx = 0 (an unscaled axis: o + 0.5 - 0.5 is o) it is a(y0, x0)
// exactly for values >= +0: a * 1 + b * 0 is a + (+0), which is a.
__device__ __forceinline__ float bilerp(float a00, float a10, float a01, float a11,
                                        float wy, float wx) {
  const float my = __fsub_rn(1.f, wy), mx = __fsub_rn(1.f, wx);
  const float r0 = __fadd_rn(__fmul_rn(a00, my), __fmul_rn(a10, wy));
  const float r1 = __fadd_rn(__fmul_rn(a01, my), __fmul_rn(a11, wy));
  return __fadd_rn(__fmul_rn(r0, mx), __fmul_rn(r1, wx));
}

__device__ __forceinline__ float div_i(int a, int b) {
  return __fdiv_rn(static_cast<float>(a), static_cast<float>(b));
}

// ---------------------------------------------------------------------------
// The block tiling of K1 and K4
// ---------------------------------------------------------------------------

// A block of K1 or K4 owns one tile of its output in one item, kCanvasRows
// (K1) or kAugRows (K4) rows by kTileCols columns: grid (column strips, row
// bands, items), 32-bit index math within an item. Its prologue computes the
// bilinear taps of the tile's rows and columns once into shared memory (one
// lin_tap each, not two a pixel); the source rectangle those taps read is
// staged into shared memory, in bands of output rows when it does not fit at
// once (a band needs at most two source rows, and each stage holds at least
// two whole source rows).
constexpr int kCanvasRows = 64, kAugRows = 32, kTileCols = 64;
constexpr int kTileThreads = 256;
// registers capped at 48: 5 blocks an SM, not 4 (measured faster, PERF.md)
constexpr int kTileBlocksPerSM = 5;
constexpr int kCanvasStageBytes = 16384;  // K1: the tiles' staged source rows, bytes
constexpr int kAugRawBytes = 12288;       // K4: the mid image's staged source rows, bytes
constexpr int kAugStagePx = 3072;         // K4: the jittered source pixels, one word each

// The last output row rb of the band that starts at row ra, as far as
// ``cap`` source rows reach: rows ra..rb-1 read source rows taps[ra].i0 ..
// taps[rb-1].i1 (monotone in the row). Uniform over the block.
__device__ __forceinline__ int band_end(const Tap* taps, int ra, int rend, int cap) {
  const int base = taps[ra].i0;
  int lo = ra + 1, hi = rend;  // one row always fits: it reads at most two source rows
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (taps[mid - 1].i1 - base < cap) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows r0 .. r0 + n - 1 of a tile into the stage, `pitch` bytes each from
// `src` (the row range's first byte): 16-byte cp.async chunks when the rows
// are aligned (the caller waits for them), else byte copies.
__device__ __forceinline__ void stage_rows(uint8_t* stage, const uint8_t* src, int r0, int n,
                                           int pitch, int rowbytes, bool vec) {
  if (vec) {
    const int chunks = pitch >> 4;
    for (int i = threadIdx.x; i < n * chunks; i += kTileThreads) {
      const int r = i / chunks, k = i - r * chunks;
      cp_async16(stage + r * pitch + 16 * k, src + (r0 + r) * rowbytes + 16 * k);
    }
  } else {
    for (int i = threadIdx.x; i < n * pitch; i += kTileThreads) {
      const int r = i / pitch;
      stage[i] = src[(r0 + r) * rowbytes + i - r * pitch];
    }
  }
}

// ---------------------------------------------------------------------------
// K1: the 2x mosaic canvas
// ---------------------------------------------------------------------------

// tiles (B, 5, sh, sw, 3) uint8; hw5, nhw5 (B, 5, 2) int32; yc, xc (B,) int32;
// canvas (B, 2ih, 2iw, 3) uint8 = round(clip(., 0, 255)) of the where chain
// over the four tile rectangles on a 114 background. The rectangles lie in
// the four quadrants around (xc, yc), so they are disjoint and the chain is
// "the tile whose rectangle holds the pixel". A block that meets no
// rectangle writes 114 and reads no pixel. Otherwise, tile by tile, the block
// stages the source rows its taps read with cp.async (16-byte chunks of the
// aligned byte range), resamples its part of the rectangle into the output
// tile in shared memory (114 elsewhere), and writes the tile's rows as
// 16-byte vectors.
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSM)
    mosaic_canvas_kernel(const uint8_t* __restrict__ tiles, const int* __restrict__ hw5,
                         const int* __restrict__ nhw5, const int* __restrict__ yc_,
                         const int* __restrict__ xc_, uint8_t* __restrict__ canvas, int sh,
                         int sw, int ih, int iw, int stage_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  Tap* rowtap = reinterpret_cast<Tap*>(smem);  // kCanvasRows
  Tap* coltap = rowtap + kCanvasRows;          // kTileCols
  uint8_t* tile_out = reinterpret_cast<uint8_t*>(coltap + kTileCols);  // kCanvasRows x kOutPitch
  uint8_t* stage = tile_out + kCanvasRows * kTileCols * 3;             // stage_bytes
  constexpr int kOutPitch = kTileCols * 3;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int H = 2 * ih, W = 2 * iw;
  const int v0 = blockIdx.y * kCanvasRows, u0 = blockIdx.x * kTileCols;
  const int nrows = min(kCanvasRows, H - v0), ncols = min(kTileCols, W - u0);
  const int yc = yc_[b], xc = xc_[b];
  const int* nhw = nhw5 + b * 10;
  const int* hw = hw5 + b * 10;
  // _tile_rects: rectangles on the canvas
  const int x1[4] = {max(xc - nhw[1], 0), xc, max(xc - nhw[5], 0), xc};
  const int y1[4] = {max(yc - nhw[0], 0), max(yc - nhw[2], 0), yc, yc};
  const int x2[4] = {xc, min(xc + nhw[3], W), xc, min(xc + nhw[7], W)};
  const int y2[4] = {yc, yc, min(H, yc + nhw[4]), min(H, yc + nhw[6])};
  // each rectangle clipped to this block, in block coordinates
  int cr0[4], cr1[4], cc0[4], cc1[4];
  bool any = false;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    cr0[t] = max(y1[t], v0) - v0;
    cr1[t] = min(y2[t], v0 + nrows) - v0;
    cc0[t] = max(x1[t], u0) - u0;
    cc1[t] = min(x2[t], u0 + ncols) - u0;
    any = any || (cr1[t] > cr0[t] && cc1[t] > cc0[t]);
  }

  uint8_t* dst = canvas + static_cast<size_t>(b) * H * W * 3 + (v0 * W + u0) * 3;
  const int seg = ncols * 3;  // bytes of one output row of the tile
  const bool vec_dst = ((W * 3) & 15) == 0 && (seg & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(canvas) & 15) == 0;
  const uint4 fill = make_uint4(0x72727272u, 0x72727272u, 0x72727272u, 0x72727272u);  // 114
  if (!any) {
    if (vec_dst) {
      const int per = seg >> 4;
      for (int i = tid; i < nrows * per; i += kTileThreads) {
        const int r = i / per;
        reinterpret_cast<uint4*>(dst + r * W * 3)[i - r * per] = fill;
      }
    } else {
      for (int i = tid; i < nrows * seg; i += kTileThreads) {
        const int r = i / seg;
        dst[r * W * 3 + i - r * seg] = 114;
      }
    }
    return;
  }
  for (int i = tid; i < kCanvasRows * kOutPitch / 16; i += kTileThreads)
    reinterpret_cast<uint4*>(tile_out)[i] = fill;

  const int rowbytes = sw * 3;
  const bool vec_src = (rowbytes & 15) == 0 && (reinterpret_cast<uintptr_t>(tiles) & 15) == 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (cr1[t] <= cr0[t] || cc1[t] <= cc0[t]) continue;  // uniform
    __syncthreads();  // the previous tile's taps and stage are consumed, the fill is done
    const int nh = nhw[2 * t], nw = nhw[2 * t + 1];
    const int h0 = hw[2 * t], w0 = hw[2 * t + 1];
    const int sx1 = (t == 0 || t == 2) ? nw - (x2[t] - x1[t]) : 0;
    const int sy1 = (t == 0 || t == 1) ? nh - (y2[t] - y1[t]) : 0;
    const float padw = static_cast<float>(x1[t] - sx1), padh = static_cast<float>(y1[t] - sy1);
    const float sy = div_i(nh, h0), sx = div_i(nw, w0);
    // The taps of the clip's corners, in every thread, give the source range
    // before the tables exist. The byte range of a source row is aligned to
    // 16 bytes for cp.async (it stays within the row, whose length is too).
    const int sc0 = lin_tap(__fsub_rn(static_cast<float>(u0 + cc0[t]), padw), sx, w0).i0;
    const int sc1 = lin_tap(__fsub_rn(static_cast<float>(u0 + cc1[t] - 1), padw), sx, w0).i1;
    const int a0 = vec_src ? (sc0 * 3) & ~15 : sc0 * 3;
    const int pitch = vec_src ? ((sc1 * 3 + 3 + 15) & ~15) - a0 : (sc1 - sc0 + 1) * 3;
    const int cap = stage_bytes / pitch;  // >= 2: the stage holds two whole rows
    const uint8_t* src = tiles + static_cast<size_t>(b * 5 + t) * sh * sw * 3 + a0;
    const int first = lin_tap(__fsub_rn(static_cast<float>(v0 + cr0[t]), padh), sy, h0).i0;
    const int last = lin_tap(__fsub_rn(static_cast<float>(v0 + cr1[t] - 1), padh), sy, h0).i1;
    // a rectangle whose rows fit the stage at once is copied in while the
    // tables are computed
    const bool whole = last - first < cap;
    if (whole) stage_rows(stage, src, first, last - first + 1, pitch, rowbytes, vec_src);
    for (int r = cr0[t] + tid; r < cr1[t]; r += kTileThreads)
      rowtap[r] = lin_tap(__fsub_rn(static_cast<float>(v0 + r), padh), sy, h0);
    for (int c = cc0[t] + tid; c < cc1[t]; c += kTileThreads)
      coltap[c] = lin_tap(__fsub_rn(static_cast<float>(u0 + c), padw), sx, w0);
    cp_async_wait_all();
    __syncthreads();
    const int c = tid % kTileCols;
    const bool col_live = c >= cc0[t] && c < cc1[t];
    const Tap tx = coltap[col_live ? c : cc0[t]];
    const int x0b = tx.i0 * 3 - a0, x1b = tx.i1 * 3 - a0;
    for (int ra = cr0[t]; ra < cr1[t];) {
      const int rb = whole ? cr1[t] : band_end(rowtap, ra, cr1[t], cap);
      const int sr0 = rowtap[ra].i0;
      if (!whole) {
        stage_rows(stage, src, sr0, rowtap[rb - 1].i1 - sr0 + 1, pitch, rowbytes, vec_src);
        cp_async_wait_all();
        __syncthreads();
      }
      if (col_live) {
        for (int r = ra + tid / kTileCols; r < rb; r += kTileThreads / kTileCols) {
          const Tap ty = rowtap[r];
          const uint8_t* s0 = stage + (ty.i0 - sr0) * pitch;
          const uint8_t* s1 = stage + (ty.i1 - sr0) * pitch;
          uint8_t* o = tile_out + r * kOutPitch + c * 3;
          if (ty.w == 0.f && tx.w == 0.f) {
            // the blend with both weights 0 is its first tap, a byte
            o[0] = s0[x0b], o[1] = s0[x0b + 1], o[2] = s0[x0b + 2];
            continue;
          }
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float val = bilerp(u8f(s0[x0b + ch]), u8f(s1[x0b + ch]), u8f(s0[x1b + ch]),
                                     u8f(s1[x1b + ch]), ty.w, tx.w);
            o[ch] = static_cast<uint8_t>(round_byte(val));
          }
        }
      }
      ra = rb;
      if (ra < cr1[t]) __syncthreads();  // the band is read before the next one is staged
    }
  }
  __syncthreads();
  if (vec_dst) {
    const int per = seg >> 4;
    for (int i = tid; i < nrows * per; i += kTileThreads) {
      const int r = i / per, k = i - r * per;
      reinterpret_cast<uint4*>(dst + r * W * 3)[k] =
          reinterpret_cast<const uint4*>(tile_out + r * kOutPitch)[k];
    }
  } else {
    for (int i = tid; i < nrows * seg; i += kTileThreads) {
      const int r = i / seg, k = i - r * seg;
      dst[r * W * 3 + k] = tile_out[r * kOutPitch + k];
    }
  }
}

// ---------------------------------------------------------------------------
// K2: one pass of the Catmull-Smith two-pass affine warp
// ---------------------------------------------------------------------------

// Pass 1 resamples each canvas row r at p(j) = scale1 * j + off1[r] into
// H (B, 2ih, iw, 3) f32 (unrounded); pass 2 resamples each column x of H at
// p(y) = d * y + off2[x] into (B, ih, iw, 3) uint8 = round(clip(., 0, 255)).
// The per-line offsets and the matrix guards are affine_warp's f32
// expressions; a tap outside [0, C - 1] reads the border 114. In range
// JAX's doubled-row roll reads img[r, i0], so the tap is indexed directly.
template <int kPass>
__global__ void affine_pass_kernel(const void* __restrict__ in_, void* __restrict__ out_,
                                   const float* __restrict__ m6, int B, int ih, int iw) {
  const int rows = kPass == 1 ? 2 * ih : ih;  // output rows
  const int cols = iw;                         // output columns
  const int C = kPass == 1 ? 2 * iw : 2 * ih;  // positions along a line
  const int64_t total = static_cast<int64_t>(B) * rows * cols;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(idx % cols);
    const int y = static_cast<int>((idx / cols) % rows);
    const int b = static_cast<int>(idx / (static_cast<int64_t>(cols) * rows));
    const float* m = m6 + b * 6;
    const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5];
    const float safe_m00 = fabsf(m00) < 1e-3f ? 1e-3f : m00;
    float scale, off;
    int line, j;
    if (kPass == 1) {
      line = y;
      j = x;
      scale = __fdiv_rn(1.f, safe_m00);
      off = __fdiv_rn(__fsub_rn(-m02, __fmul_rn(m01, static_cast<float>(y))), safe_m00);
    } else {
      line = x;
      j = y;
      const float det = __fsub_rn(__fmul_rn(m00, m11), __fmul_rn(m01, m10));
      const float safe_det = fabsf(det) < 1e-6f ? 1e-6f : det;
      const float c = __fdiv_rn(-m10, safe_det);
      const float d = __fdiv_rn(m00, safe_det);
      scale = d;
      off = __fsub_rn(__fmul_rn(c, __fsub_rn(static_cast<float>(x), m02)), __fmul_rn(d, m12));
    }
    const float q = __fmul_rn(scale, static_cast<float>(j));
    const float qf = floorf(q);
    const float fq = __fsub_rn(q, qf);
    const float of = floorf(off);
    const float fo = __fsub_rn(off, of);
    const float s = __fadd_rn(fq, fo);
    const int carry = s >= 1.f;
    const float w = __fsub_rn(s, static_cast<float>(carry));
    const int i0 = static_cast<int>(of) + static_cast<int>(qf) + carry;
    const bool lo_in = i0 >= 0 && i0 <= C - 1;
    const bool hi_in = i0 + 1 >= 0 && i0 + 1 <= C - 1;
    const float mw = __fsub_rn(1.f, w);
    if (kPass == 1) {
      const uint8_t* row = static_cast<const uint8_t*>(in_) +
                           (static_cast<int64_t>(b) * (2 * ih) + line) * C * 3;
      float* o = static_cast<float*>(out_) + idx * 3;
      for (int c = 0; c < 3; ++c) {
        const float lo = lo_in ? static_cast<float>(row[i0 * 3 + c]) : 114.f;
        const float hi = hi_in ? static_cast<float>(row[(i0 + 1) * 3 + c]) : 114.f;
        o[c] = __fadd_rn(__fmul_rn(lo, mw), __fmul_rn(hi, w));
      }
    } else {
      // H (B, 2ih, iw, 3): position p of line x is H[b, p, x]
      const float* Hb = static_cast<const float*>(in_) + static_cast<int64_t>(b) * C * iw * 3;
      uint8_t* o = static_cast<uint8_t*>(out_) + idx * 3;
      for (int c = 0; c < 3; ++c) {
        const float lo = lo_in ? Hb[(static_cast<int64_t>(i0) * iw + line) * 3 + c] : 114.f;
        const float hi = hi_in ? Hb[(static_cast<int64_t>(i0 + 1) * iw + line) * 3 + c] : 114.f;
        o[c] = static_cast<uint8_t>(round_u8(__fadd_rn(__fmul_rn(lo, mw), __fmul_rn(hi, w))));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the mixup partner, the origin select and the blend
// ---------------------------------------------------------------------------

// The partner's first stage, one pixel of round(letterbox(tile 4)) at (y, x)
// of the (ih, iw) buffer: 114 outside its (nh, nw) extents.
__device__ __forceinline__ void partner_stage1(const uint8_t* tile, int sw, int h0, int w0,
                                               int nh, int nw, int y, int x, float out[3]) {
  if (!(y < nh && x < nw)) {
    out[0] = out[1] = out[2] = 114.f;
    return;
  }
  const Tap ty = lin_tap(static_cast<float>(y), div_i(nh, h0), h0);
  const Tap tx = lin_tap(static_cast<float>(x), div_i(nw, w0), w0);
  const uint8_t* p00 = tile + (static_cast<int64_t>(ty.i0) * sw + tx.i0) * 3;
  const uint8_t* p10 = tile + (static_cast<int64_t>(ty.i1) * sw + tx.i0) * 3;
  const uint8_t* p01 = tile + (static_cast<int64_t>(ty.i0) * sw + tx.i1) * 3;
  const uint8_t* p11 = tile + (static_cast<int64_t>(ty.i1) * sw + tx.i1) * 3;
  for (int c = 0; c < 3; ++c) out[c] = rintf(bilerp(p00[c], p10[c], p01[c], p11[c], ty.w, tx.w));
}

// tiles (B, 5, sh, sw, 3) uint8, hw5/nhw5 (B, 5, 2) int32, warped (B, ih, iw, 3)
// uint8, mrand (B, 16) f32 -> mid (B, sh, sw, 3) uint8: the warped mosaic
// placed top-left on 114 (or the raw tile 0 of a passthrough item), blended
// floor(0.5 mid + 0.5 partner) where mrand[9] > 0. The partner's two
// resamples are fused per output pixel; its first stage is rounded before
// the second reads it, as in JAX.
__global__ void mixup_kernel(const uint8_t* __restrict__ tiles, const int* __restrict__ hw5,
                             const int* __restrict__ nhw5, const uint8_t* __restrict__ warped,
                             const float* __restrict__ mrand, uint8_t* __restrict__ mid,
                             int B, int sh, int sw, int ih, int iw) {
  const int64_t total = static_cast<int64_t>(B) * sh * sw;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(idx % sw);
    const int y = static_cast<int>((idx / sw) % sh);
    const int b = static_cast<int>(idx / (static_cast<int64_t>(sw) * sh));
    const float* mr = mrand + b * 16;
    const int* hw = hw5 + b * 10;
    const bool use_mosaic = mr[0] > 0.f;
    float m[3];
    if (use_mosaic) {
      if (y < ih && x < iw) {
        const uint8_t* p = warped + ((static_cast<int64_t>(b) * ih + y) * iw + x) * 3;
        for (int c = 0; c < 3; ++c) m[c] = p[c];
      } else {
        m[0] = m[1] = m[2] = 114.f;
      }
    } else {
      const uint8_t* p = tiles + ((static_cast<int64_t>(b) * 5 * sh + y) * sw + x) * 3;
      for (int c = 0; c < 3; ++c) m[c] = p[c];
    }
    uint8_t* o = mid + idx * 3;
    if (!(mr[9] > 0.f)) {
      for (int c = 0; c < 3; ++c) o[c] = static_cast<uint8_t>(m[c]);
      continue;
    }
    // _mixup_partner's second stage
    const int oh = use_mosaic ? ih : hw[0], ow = use_mosaic ? iw : hw[1];
    const int tw2 = static_cast<int>(mr[14]), th2 = static_cast<int>(mr[15]);
    float yy = __fadd_rn(static_cast<float>(y), mr[13]);
    float xx = __fadd_rn(static_cast<float>(x), mr[12]);
    if (mr[11] > 0.f) xx = __fsub_rn(static_cast<float>(tw2 - 1), xx);
    const bool live = yy < static_cast<float>(th2) && xx >= 0.f &&
                      xx < static_cast<float>(tw2) && y < oh && x < ow;
    float cp[3] = {114.f, 114.f, 114.f};
    if (live) {
      const Tap ty = lin_tap(yy, div_i(th2, ih), ih);
      const Tap tx = lin_tap(xx, div_i(tw2, iw), iw);
      const uint8_t* tile = tiles + (static_cast<int64_t>(b) * 5 + 4) * sh * sw * 3;
      const int* nhw4 = nhw5 + b * 10 + 8;
      const int h0 = hw[8], w0 = hw[9];
      float a00[3], a10[3], a01[3], a11[3];
      partner_stage1(tile, sw, h0, w0, nhw4[0], nhw4[1], ty.i0, tx.i0, a00);
      partner_stage1(tile, sw, h0, w0, nhw4[0], nhw4[1], ty.i1, tx.i0, a10);
      partner_stage1(tile, sw, h0, w0, nhw4[0], nhw4[1], ty.i0, tx.i1, a01);
      partner_stage1(tile, sw, h0, w0, nhw4[0], nhw4[1], ty.i1, tx.i1, a11);
      for (int c = 0; c < 3; ++c) cp[c] = rintf(bilerp(a00[c], a10[c], a01[c], a11[c], ty.w, tx.w));
    }
    for (int c = 0; c < 3; ++c)
      o[c] = static_cast<uint8_t>(floorf(__fadd_rn(__fmul_rn(0.5f, m[c]), __fmul_rn(0.5f, cp[c]))));
  }
}

// ---------------------------------------------------------------------------
// K4: HSV jitter, flip and letterbox
// ---------------------------------------------------------------------------

// device_aug.py::hsv_jitter on one BGR pixel (bgr_to_hsv, the truncated
// gains g, hsv_to_bgr, then clip(round(.), 0, 255)), as a word of three
// bytes (B, G, R): the values are integers in [0, 255].
__device__ __forceinline__ uint32_t hsv_jitter_word(float b, float gr, float r,
                                                    const float g[3]) {
  float v = fmaxf(fmaxf(b, gr), r);
  const float mn = fminf(fminf(b, gr), r);
  const float diff = __fsub_rn(v, mn);
  const float safe = diff > 0.f ? diff : 1.f;
  // one division, its operands selected (a + 0 is a: the quotient times 30
  // is never -0, as x - x is +0)
  const bool is_r = v == r, is_g = !is_r && v == gr;
  const float num = is_r ? __fsub_rn(gr, b) : is_g ? __fsub_rn(b, r) : __fsub_rn(r, gr);
  // A zero dividend skips its division (0 / d is +0, as is the selected
  // 0: x - x is +0), so only nonzero quotients take the division's path.
  float h = __fadd_rn(__fmul_rn(num != 0.f ? __fdiv_rn(num, safe) : 0.f, 30.f),
                      is_r ? 0.f : is_g ? 60.f : 120.f);
  h = diff > 0.f ? pymod(h, 180.f) : 0.f;
  float s = diff > 0.f ? __fmul_rn(__fdiv_rn(diff, v), 255.f) : 0.f;
  h = pymod(__fadd_rn(h, g[0]), 180.f);
  s = clampf(__fadd_rn(s, g[1]), 0.f, 255.f);
  v = clampf(__fadd_rn(v, g[2]), 0.f, 255.f);
  const float h6 = h != 0.f ? __fdiv_rn(h, 30.f) : h;  // +-0 / 30 is +-0
  const float c = __fmul_rn(v, s != 0.f ? __fdiv_rn(s, 255.f) : s);
  const float x = __fmul_rn(c, __fsub_rn(1.f, fabsf(__fsub_rn(pymod(h6, 2.f), 1.f))));
  const float m = __fsub_rn(v, c);
  // h6 is in [0, 6] (or NaN, which both take to 0): floor is truncation,
  // and 6 is sector 0
  int sector = static_cast<int>(h6);
  if (sector >= 6) sector -= 6;
  // sectors 0-5 (jnp.select's default is 5): R is c in 0 and 5, x in 1 and
  // 4; G is c in 1 and 2, x in 0 and 3; B is c in 3 and 4, x in 2 and 5
  const float rr = (sector == 0 || sector == 5) ? c : (sector == 1 || sector == 4) ? x : 0.f;
  const float gg = (sector == 1 || sector == 2) ? c : (sector == 0 || sector == 3) ? x : 0.f;
  const float bb = (sector == 3 || sector == 4) ? c : (sector == 2 || sector == 5) ? x : 0.f;
  // clip(round(y), 0, 255) and round(clip(y, 0, 255)) are the same byte
  return round_byte(__fadd_rn(bb, m)) | (round_byte(__fadd_rn(gg, m)) << 8) |
         (round_byte(__fadd_rn(rr, m)) << 16);
}

// Three f32 values of a 4-pixel group at p, of which the first npx lie
// inside the row: as three 16-byte vectors when the group is whole and p is
// aligned.
__device__ __forceinline__ void store_group(float* p, const float v[12], int npx, bool vec) {
  if (npx >= 4 && vec) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
    q[2] = make_float4(v[8], v[9], v[10], v[11]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    if (k < 3 * npx) p[k] = v[k];
  }
}

// img (B, sh, sw, 3) uint8, hw/nhw (B, 2) int32, gains (B, 3) f32 (truncated),
// flip/fallback (B,) int32 -> out (B, ih, iw, 3) f32, 114 outside (nh, nw).
// A block copies the source rows its taps span into shared memory with
// cp.async (the flipped column range of a flipped item), jitters each source
// pixel there once into a word of three bytes (the clean pixel for a
// fallback item; the jittered values are integers in [0, 255]), blends each
// thread's 4-pixel groups from those words, and writes them through a
// per-warp buffer as coalesced 16-byte vectors.
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSM)
    train_aug_kernel(const uint8_t* __restrict__ img, const int* __restrict__ hw,
                     const int* __restrict__ nhw, const float* __restrict__ gains,
                     const int* __restrict__ flip, const int* __restrict__ fallback,
                     float* __restrict__ out, int sh, int sw, int ih, int iw, int raw_bytes,
                     int stage_px) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kWarpOut = 2 * 3 * kTileCols;  // floats: the two rows of a warp
  Tap* rowtap = reinterpret_cast<Tap*>(smem);  // kAugRows
  Tap* coltap = rowtap + kAugRows;             // kTileCols
  float* warp_out = reinterpret_cast<float*>(coltap + kTileCols);  // kWarpOut a warp
  uint32_t* stage = reinterpret_cast<uint32_t*>(warp_out + kWarpOut * (kTileThreads / 32));
  uint8_t* raw = reinterpret_cast<uint8_t*>(stage + stage_px);  // raw_bytes

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kAugRows, c0 = blockIdx.x * kTileCols;
  const int nrows = min(kAugRows, ih - r0), ncols = min(kTileCols, iw - c0);
  const int nh = nhw[2 * b], nw = nhw[2 * b + 1];
  const int live_cols = min(max(min(nw, iw) - c0, 0), ncols);
  const int live_rows = live_cols > 0 ? min(max(min(nh, ih) - r0, 0), nrows) : 0;
  float* dst = out + static_cast<size_t>(b) * ih * iw * 3 + (r0 * iw + c0) * 3;
  const bool vec = (iw & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool vec_rows = vec && (ncols & 3) == 0;  // whole rows of 16-byte chunks
  const int g4 = 4 * (tid & 15);  // this thread's 4-pixel group: columns g4..g4+3
  const int rstep = kTileThreads / 16;
  float v[12];

  if (live_rows > 0) {
    const int h = hw[2 * b], w = hw[2 * b + 1];
    const bool fb = fallback[b] != 0, fl = flip[b] != 0 && !fb;
    const float g[3] = {gains[3 * b], gains[3 * b + 1], gains[3 * b + 2]};
    const float sy = div_i(nh, h), sx = div_i(nw, w);
    // the source rectangle from the corner taps, in every thread: its tap
    // columns t0..t0+span-1 read image columns col(t), monotone
    const int t0 = lin_tap(static_cast<float>(c0), sx, w).i0;
    const int span = lin_tap(static_cast<float>(c0 + live_cols - 1), sx, w).i1 - t0 + 1;
    const int ca = fl ? min(max(w - span - t0, 0), sw - 1) : t0;  // col(t0 + span - 1)
    const int cb = fl ? min(max(w - 1 - t0, 0), sw - 1) : t0 + span - 1;  // col(t0)
    const int rowbytes = sw * 3;
    const bool vec_src = (rowbytes & 15) == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0;
    const int a0 = vec_src ? (ca * 3) & ~15 : ca * 3;
    const int pitch = vec_src ? ((cb * 3 + 3 + 15) & ~15) - a0 : (cb - ca + 1) * 3;
    const int cap = min(raw_bytes / pitch, stage_px / span);  // >= 2
    const uint8_t* src = img + static_cast<size_t>(b) * sh * rowbytes + a0;
    const int first = lin_tap(static_cast<float>(r0), sy, h).i0;
    const int last = lin_tap(static_cast<float>(r0 + live_rows - 1), sy, h).i1;
    const bool whole = last - first < cap;
    if (whole) stage_rows(raw, src, first, last - first + 1, pitch, rowbytes, vec_src);
    // i / span as the high word of i * span_m: exact for i * span < 2^32,
    // and i < stage_px, span <= stage_px / 2, stage_px < 2^15 (the launch);
    // span_m wraps to 0 for span 1
    const unsigned span_m = 0xffffffffu / static_cast<unsigned>(span) + 1u;
    for (int r = tid; r < live_rows; r += kTileThreads)
      rowtap[r] = lin_tap(static_cast<float>(r0 + r), sy, h);
    for (int c = tid; c < live_cols; c += kTileThreads)
      coltap[c] = lin_tap(static_cast<float>(c0 + c), sx, w);
    __syncthreads();
    Tap tx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) tx[k] = coltap[min(g4 + k, live_cols - 1)];
    for (int ra = 0; ra < live_rows;) {
      const int rb = whole ? live_rows : band_end(rowtap, ra, live_rows, cap);
      const int sr0 = rowtap[ra].i0;
      const int nsrc = rowtap[rb - 1].i1 - sr0 + 1;
      if (!whole) stage_rows(raw, src, sr0, nsrc, pitch, rowbytes, vec_src);
      cp_async_wait_all();
      __syncthreads();
      for (int i = tid; i < nsrc * span; i += kTileThreads) {
        const int ry = span_m ? __umulhi(static_cast<unsigned>(i), span_m) : i;  // i / span
        const int t = t0 + i - ry * span;  // the tap's column
        const int col = fl ? min(max(w - 1 - t, 0), sw - 1) : t;
        const uint8_t* p = raw + ry * pitch + col * 3 - a0;
        const uint32_t px = p[0] | (p[1] << 8) | (p[2] << 16);
        stage[i] = fb ? px
                      : hsv_jitter_word(word_byte(px, 0), word_byte(px, 1), word_byte(px, 2), g);
      }
      __syncthreads();
      // a warp's two rows at a time, its loop uniform across its lanes
      for (int rw = ra + 2 * (tid >> 5); rw < rb; rw += rstep) {
        const int r = rw + (lane >> 4);
        const bool row_live = r < rb;
        const Tap ty = rowtap[row_live ? r : rw];
        const int y0 = (ty.i0 - sr0) * span - t0, y1 = (ty.i1 - sr0) * span - t0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (row_live && g4 + k < live_cols) {
            const uint32_t a00 = stage[y0 + tx[k].i0];
            if (ty.w == 0.f && tx[k].w == 0.f) {
              // the blend with both weights 0 is its first tap
#pragma unroll
              for (int ch = 0; ch < 3; ++ch) v[3 * k + ch] = word_byte(a00, ch);
              continue;
            }
            const uint32_t a10 = stage[y1 + tx[k].i0];
            const uint32_t a01 = stage[y0 + tx[k].i1], a11 = stage[y1 + tx[k].i1];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              v[3 * k + ch] = bilerp(word_byte(a00, ch), word_byte(a10, ch), word_byte(a01, ch),
                                     word_byte(a11, ch), ty.w, tx[k].w);
            }
          } else {
            v[3 * k] = v[3 * k + 1] = v[3 * k + 2] = 114.f;
          }
        }
        if (vec_rows) {
          // the warp's two rows through its buffer: lane l then stores the
          // 16-byte chunks l, l + 32, l + 64 of their 2 x 3 ncols floats
          float* wb = warp_out + kWarpOut * (tid >> 5);
          float4* mine = reinterpret_cast<float4*>(wb + (lane >> 4) * 3 * kTileCols + 3 * g4);
          mine[0] = make_float4(v[0], v[1], v[2], v[3]);
          mine[1] = make_float4(v[4], v[5], v[6], v[7]);
          mine[2] = make_float4(v[8], v[9], v[10], v[11]);
          __syncwarp();
          const int per = 3 * ncols / 4;  // chunks a row
#pragma unroll
          for (int j = lane; j < 96; j += 32) {
            const int row = j >= 48, k = j - 48 * row;
            if (k < per && rw + row < rb) {
              reinterpret_cast<float4*>(dst + (rw + row) * iw * 3)[k] =
                  reinterpret_cast<const float4*>(wb + row * 3 * kTileCols)[k];
            }
          }
          __syncwarp();
        } else if (row_live) {
          store_group(dst + (r * iw + g4) * 3, v, ncols - g4, vec);
        }
      }
      ra = rb;
      if (ra < live_rows) __syncthreads();  // the band is read before the next one is staged
    }
  }
  // the rows below the letterbox's extents, or the whole tile outside them
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k] = 114.f;
  for (int r = live_rows + (tid >> 4); r < nrows; r += rstep)
    store_group(dst + (r * iw + g4) * 3, v, ncols - g4, vec);
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 132 * 64 ? b : 132 * 64);  // grid-stride past 64 blocks an SM
}

// Shared memory of a K1 / K4 block at tile width sw: each stage holds at
// least two whole source rows.
int canvas_stage_bytes(int sw) {
  const int rows = (2 * 3 * sw + 15) & ~15;
  return rows > kCanvasStageBytes ? rows : kCanvasStageBytes;
}
int aug_raw_bytes(int sw) {
  const int rows = (2 * 3 * sw + 15) & ~15;
  return rows > kAugRawBytes ? rows : kAugRawBytes;
}
int aug_stage_px(int sw) { return 2 * sw > kAugStagePx ? (2 * sw + 3) & ~3 : kAugStagePx; }
constexpr int kTapBytes = static_cast<int>(sizeof(Tap));
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

// Opts `kernel` in to `bytes` of dynamic shared memory where that is above
// the default 48 KB; 0, or the CUDA error.
template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

dim3 tile_grid(int B, int rows, int cols, int tile_rows) {
  return dim3((cols + kTileCols - 1) / kTileCols, (rows + tile_rows - 1) / tile_rows, B);
}

}  // namespace

extern "C" {

// Every pointer is to contiguous memory on the current device, in the
// layouts above; each function launches one kernel on `stream` and returns
// cudaGetLastError() after it (0 = cudaSuccess).

int cocodet_mosaic_canvas(const void* tiles, const void* hw5, const void* nhw5, const void* yc,
                          const void* xc, void* canvas, int B, int sh, int sw, int ih, int iw,
                          void* stream) {
  if (static_cast<int64_t>(B) * ih * iw <= 0) return 0;
  const int stage = canvas_stage_bytes(sw);
  const int smem = kTapBytes * (kCanvasRows + kTileCols) + kCanvasRows * kTileCols * 3 + stage;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);  // sw above ~36,000
  if (const int rc = allow_smem(mosaic_canvas_kernel, smem)) return rc;
  mosaic_canvas_kernel<<<tile_grid(B, 2 * ih, 2 * iw, kCanvasRows), kTileThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tiles), static_cast<const int*>(hw5),
      static_cast<const int*>(nhw5), static_cast<const int*>(yc), static_cast<const int*>(xc),
      static_cast<uint8_t*>(canvas), sh, sw, ih, iw, stage);
  return static_cast<int>(cudaGetLastError());
}

// pass 1: in = canvas (B, 2ih, 2iw, 3) uint8, out = H (B, 2ih, iw, 3) f32;
// pass 2: in = H, out = (B, ih, iw, 3) uint8. m6: (B, 6) f32.
int cocodet_affine_pass(const void* in, void* out, const void* m6, int pass, int B, int ih,
                        int iw, void* stream) {
  const int64_t n = static_cast<int64_t>(B) * (pass == 1 ? 2 * ih : ih) * iw;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 1) {
    affine_pass_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(in, out, static_cast<const float*>(m6),
                                                           B, ih, iw);
  } else if (pass == 2) {
    affine_pass_kernel<2><<<blocks_for(n), kThreads, 0, s>>>(in, out, static_cast<const float*>(m6),
                                                           B, ih, iw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int cocodet_mixup(const void* tiles, const void* hw5, const void* nhw5, const void* warped,
                  const void* mrand, void* mid, int B, int sh, int sw, int ih, int iw,
                  void* stream) {
  const int64_t n = static_cast<int64_t>(B) * sh * sw;
  if (n <= 0) return 0;
  mixup_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tiles), static_cast<const int*>(hw5),
      static_cast<const int*>(nhw5), static_cast<const uint8_t*>(warped),
      static_cast<const float*>(mrand), static_cast<uint8_t*>(mid), B, sh, sw, ih, iw);
  return static_cast<int>(cudaGetLastError());
}

int cocodet_train_aug(const void* img, const void* hw, const void* nhw, const void* gains,
                      const void* flip, const void* fallback, void* out, int B, int sh, int sw,
                      int ih, int iw, void* stream) {
  if (static_cast<int64_t>(B) * ih * iw <= 0) return 0;
  const int raw = aug_raw_bytes(sw), stage = aug_stage_px(sw);
  const int warp_out = 4 * 2 * 3 * kTileCols * (kTileThreads / 32);
  const int smem = kTapBytes * (kAugRows + kTileCols) + warp_out + 4 * stage + raw;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);  // sw above ~15,600
  if (const int rc = allow_smem(train_aug_kernel, smem)) return rc;
  train_aug_kernel<<<tile_grid(B, ih, iw, kAugRows), kTileThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const int*>(hw), static_cast<const int*>(nhw),
      static_cast<const float*>(gains), static_cast<const int*>(flip),
      static_cast<const int*>(fallback), static_cast<float*>(out), sh, sw, ih, iw, raw, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
