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
//   affine_warp_kernel    device_mosaic.py::affine_warp (:236), both of its
//                         _shift_scale_pass (:195) passes in one
//   mixup_kernel          device_mosaic.py::_mixup_partner (:287) and the
//                         origin select and blend of _mosaic_one (:396-422)
//   train_aug_kernel      cocodet_tpu/data/device_aug.py::_train_aug_one (:202)
//                         with hsv_jitter (:100) and letterbox_resize_one (:137)
// The JAX programs run per item under vmap and lax.map chunks; here the whole
// batch is one launch of each kernel, and a block owns a tile of its output in
// one item: 64 x 64 pixels (K1) or 32 x 64 (K2-K4), on a 2-D grid times the
// items, with 32-bit index math within an item.
//
// Rounding as JAX's: jnp.round is half to even (rintf), the mixup blend is
// floor, the HSV gains are truncated before they arrive; jnp.remainder takes
// the sign of the divisor (pymod below), where fmodf takes the dividend's;
// jnp.select's default branch is sector 5.
//
// Bound on the H100: bytes. Each function reads its inputs and writes its
// output once at a few tens of operations a pixel. At B=16, 768 px: the
// canvas reads the tiles' rectangles (72 MB of uint8) and writes a 2x canvas
// (113 MB); the warp reads the canvas pixels its taps reach and writes the
// uint8 warped image; the mixup reads the warped mosaic, tile 0 and the
// partner, and writes the uint8 mid image; the last kernel reads it and
// writes the f32 images the step takes (113 MB). Every intermediate holds
// integers and is stored as uint8 (exact); the warp's unrounded first pass
// never leaves registers.
//
// One thread a pixel spent its instructions, not the bytes: per pixel 64-bit
// index division, IEEE divisions for the taps (four in K1 and K4, the warp's
// matrix terms in each pass, twenty in K3), byte gathers, strided stores,
// K4's HSV round trip at each of four taps, K3's partner stage 1 at each of
// four, and the warp's 453 MB f32 intermediate. So in each kernel:
//   - a block's prologue computes the taps of the tile's rows and columns
//     once, into shared memory (K2: the split positions and offsets, and the
//     offset of each canvas row the tile reaches; K3: stage 2's taps and
//     stage 1's of the S1 rectangle they reach), while cp.async copies in the
//     source rows they span (16-byte chunks of the aligned byte range);
//   - K1: a block outside every rectangle writes 114 with 16-byte stores and
//     reads nothing; otherwise, tile by tile, it resamples from shared
//     memory into an output tile there, written as 16-byte vectors;
//   - K2: an output pixel takes its two pass-1 values from four canvas taps
//     in registers, in the passes' f32 order; each thread walks a column's
//     rows in order and keeps the two pass-1 rows it last computed, so at
//     scale >= 1 neighbouring output rows share them; a block that reads no
//     canvas row writes 114;
//   - K3: the partner's stage 1 is computed once a block, as bytes in shared
//     memory, and stage 2 reads four of them a pixel; the origin is blended
//     in 16-byte vectors (__vhaddu4); a block without mixup copies its
//     origin, one that misses the partner blends with 114;
//   - K4: it jitters each source pixel once, in shared memory, into a word
//     of three bytes (the values are integers in [0, 255]; the flipped
//     column of a flipped item, the clean pixel of a fallback item), then
//     blends 4-pixel groups from the words and writes them through a
//     per-warp buffer as coalesced 16-byte vectors;
//   - a tap whose two weights are 0 is the blend's exact value, its first
//     tap, taken without the arithmetic: the pipeline resizes its tiles when
//     it loads them, so on its path K1's and K4's resamples and most of K3's
//     stage 1 are unscaled;
//   - bytes become f32 and rounded f32 becomes bytes by adding 2^23 (exact,
//     and rintf's rounding), on the FMA pipe, not the conversion unit; the
//     HSV remainders take exact short paths (fmod_pos), one division picks
//     its operands, and a zero dividend skips its division.
// A rectangle that does not fit its stage (a downscale) is walked in bands of
// output rows; each stage is sized at launch to hold two whole source rows,
// which one output row needs at most, so every scale takes the same path.
// What still bounds them on this card (PERF.md): K4's HSV arithmetic, about
// half its time (four IEEE divisions and three remainders a source pixel, in
// JAX's order); K2's dependent chain a pixel (table, tap, table, tap, canvas
// bytes; latency-bound: 6 blocks an SM measured faster than 4); for all, the
// per-block steps between barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr int kOutPitch = kTileCols * 3;  // bytes of an output tile row in shared memory
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
// K2: the affine warp, both passes in one
// ---------------------------------------------------------------------------

// A block owns a kWarpRows x kTileCols tile of the warped image of one item.
// affine_warp's pass 2 blends, for output (y, x), the first pass's map H at
// rows p0 and p0 + 1 of column x (114 outside [0, 2ih - 1]); H[p, x] is pass
// 1's blend of canvas row p at its two taps (114 outside [0, 2iw - 1]). So
// each output pixel computes its two H values in registers from four canvas
// taps, with the f32 operations of the two passes in their order, and no H
// is stored. The split positions and offsets (floor and fraction) are tables
// in shared memory: d * y a row, off2[x] and x / m00 a column, off1[p] a
// canvas row that the tile reaches (one IEEE division each, not two a
// pixel).
//
// The taps are monotone: with the fraction fq of q exact, floor(q) + carry,
// carry = (fq + fo >= 1) rounded, never falls as q grows (nor as the offset
// grows), and d * y, off2[x], x / m00 and off1[p] are each monotone in their
// argument. So the canvas rows a tile reaches are found at its corners.
constexpr int kWarpRows = 32;
// registers capped at 40: 6 blocks an SM, not 4 (latency-bound; measured faster, PERF.md)
constexpr int kWarpBlocksPerSM = 6;

// A value as _shift_scale_pass splits it: its floor as an int32 and v - floor(v) (exact)
struct Split {
  int i;
  float f;
};

__device__ __forceinline__ Split split(float v) {
  const float fl = floorf(v);
  return {static_cast<int>(fl), __fsub_rn(v, fl)};
}

// The lower tap of position q on a line with offset o, and its weight:
// carry = (fq + fo >= 1), w = fq + fo - carry, i0 = floor(o) + floor(q) + carry
struct LineTap {
  int i0;
  float w;
};

__device__ __forceinline__ LineTap line_tap(Split q, Split o) {
  const float s = __fadd_rn(q.f, o.f);
  const int carry = s >= 1.f;
  return {o.i + q.i + carry, __fsub_rn(s, carry ? 1.f : 0.f)};
}

// affine_warp's f32 terms of one item's forward matrix m
struct WarpTerms {
  float inv_m00, safe_m00, c, d, m01, m02, m12;
};

__device__ __forceinline__ WarpTerms warp_terms(const float* m) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5];
  const float det = __fsub_rn(__fmul_rn(m00, m11), __fmul_rn(m01, m10));
  const float safe_det = fabsf(det) < 1e-6f ? 1e-6f : det;
  const float safe_m00 = fabsf(m00) < 1e-3f ? 1e-3f : m00;
  return {__fdiv_rn(1.f, safe_m00), safe_m00, __fdiv_rn(-m10, safe_det),
          __fdiv_rn(m00, safe_det), m01, m02, m12};
}

// pass 1's offset of canvas row p, pass 2's of column x, and their positions
__device__ __forceinline__ Split off1(const WarpTerms& t, int p) {
  return split(__fdiv_rn(__fsub_rn(-t.m02, __fmul_rn(t.m01, static_cast<float>(p))), t.safe_m00));
}
__device__ __forceinline__ Split off2(const WarpTerms& t, int x) {
  return split(__fsub_rn(__fmul_rn(t.c, __fsub_rn(static_cast<float>(x), t.m02)),
                         __fmul_rn(t.d, t.m12)));
}
__device__ __forceinline__ Split pos1(const WarpTerms& t, int x) {
  return split(__fmul_rn(t.inv_m00, static_cast<float>(x)));
}
__device__ __forceinline__ Split pos2(const WarpTerms& t, int y) {
  return split(__fmul_rn(t.d, static_cast<float>(y)));
}

// H at canvas row p of this thread's column (cq: its position x / m00):
// pass 1's blend of the row at its two taps, 114 off the canvas. `src` is
// the item's canvas; only rows plo..phi are read, whose offsets are
// line[p - plo].
__device__ __forceinline__ void h_value(const uint8_t* src, const Split* line, int plo, Split cq,
                                        int R, int C, int p, float h[3]) {
  if (p < 0 || p > R - 1) {
    h[0] = h[1] = h[2] = 114.f;
    return;
  }
  const LineTap u = line_tap(cq, line[p - plo]);
  const uint8_t* row = src + (p * C + u.i0) * 3;
  const float mw = __fsub_rn(1.f, u.w);
  if (u.i0 >= 0 && u.i0 < C - 1) {  // both taps on the canvas
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      h[ch] = __fadd_rn(__fmul_rn(u8f(row[ch]), mw), __fmul_rn(u8f(row[3 + ch]), u.w));
    return;
  }
  const bool lo_in = u.i0 >= 0 && u.i0 <= C - 1;
  const bool hi_in = u.i0 + 1 >= 0 && u.i0 + 1 <= C - 1;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float lo = lo_in ? u8f(row[ch]) : 114.f;
    const float hi = hi_in ? u8f(row[3 + ch]) : 114.f;
    h[ch] = __fadd_rn(__fmul_rn(lo, mw), __fmul_rn(hi, u.w));
  }
}

// The tile's rows, column `col`, into tile_out. A quarter of the threads (a
// warp per 32 columns) walks a quarter of the rows, in order, so an output
// row that reads the H rows of the row before it, or the second of them,
// takes them from registers: pass 1's values are computed once for each H
// row a column reads (at scale >= 1 two output rows or more share an H row).
__device__ __forceinline__ void warp_rows(const uint8_t* src, const Split* rowq,
                                          const Split* line, int plo, Split co, Split cq, int R,
                                          int C, int col, int nrows, uint8_t* tile_out) {
  const int n = (nrows + 3) >> 2;
  const int g = threadIdx.x / kTileCols;
  const int r_end = min((g + 1) * n, nrows);
  float h0[3], h1[3];  // H at rows hp and hp + 1
  int hp = 0;
  bool have = false;
  for (int r = g * n; r < r_end; ++r) {
    const LineTap v = line_tap(rowq[r], co);
    if (!have || v.i0 != hp) {
      if (have && v.i0 == hp + 1) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) h0[ch] = h1[ch];
      } else {
        h_value(src, line, plo, cq, R, C, v.i0, h0);
      }
      h_value(src, line, plo, cq, R, C, v.i0 + 1, h1);
      hp = v.i0;
      have = true;
    }
    const float mw = __fsub_rn(1.f, v.w);
    uint8_t* o = tile_out + r * kOutPitch + col * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      o[ch] = static_cast<uint8_t>(
          round_byte(__fadd_rn(__fmul_rn(h0[ch], mw), __fmul_rn(h1[ch], v.w))));
  }
}

// canvas (B, 2ih, 2iw, 3) uint8, m6 (B, 6) f32 -> out (B, ih, iw, 3) uint8 =
// round(clip(., 0, 255)) of affine_warp. Four threads compute the item's
// terms (1 / safe_m00, c, d, safe_m00) once. A block whose tile reads no canvas row
// writes 114. The taps read the canvas through L1: staging a tile's canvas
// rectangle by cp.async instead (in bands where it overflowed) measured
// slower at every scale, since at a downscale the rectangle holds many more
// pixels than the taps read (PERF.md). The tile is written as 16-byte
// vectors.
__global__ void __launch_bounds__(kTileThreads, kWarpBlocksPerSM)
    affine_warp_kernel(const uint8_t* __restrict__ canvas, const float* __restrict__ m6,
                       uint8_t* __restrict__ out, int ih, int iw) {
  extern __shared__ __align__(16) uint8_t smem[];
  Split* rowq = reinterpret_cast<Split*>(smem);  // kWarpRows: d * y
  Split* colo = rowq + kWarpRows;                // kTileCols: off2[x]
  Split* colq = colo + kTileCols;                // kTileCols: x / m00
  float* terms = reinterpret_cast<float*>(colq + kTileCols);  // 1 / safe_m00, c, d, safe_m00
  uint8_t* tile_out = reinterpret_cast<uint8_t*>(terms + 4);  // kWarpRows x kOutPitch
  Split* line = reinterpret_cast<Split*>(tile_out + kWarpRows * kOutPitch);  // at most 2ih

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int R = 2 * ih, C = 2 * iw;
  const int y0 = blockIdx.y * kWarpRows, x0 = blockIdx.x * kTileCols;
  const int nrows = min(kWarpRows, ih - y0), ncols = min(kTileCols, iw - x0);
  const float* m = m6 + 6 * b;
  if (tid < 4) {
    const WarpTerms w = warp_terms(m);
    terms[tid] = tid == 0 ? w.inv_m00 : tid == 1 ? w.c : tid == 2 ? w.d : w.safe_m00;
  }
  __syncthreads();
  const WarpTerms t = {terms[0], terms[3], terms[1], terms[2], m[1], m[2], m[5]};
  // the canvas rows the tile reaches, from its corners
  const Split qa = pos2(t, y0), qb = pos2(t, y0 + nrows - 1);
  const Split oa = off2(t, x0), ob = off2(t, x0 + ncols - 1);
  const int p00 = line_tap(qa, oa).i0, p01 = line_tap(qa, ob).i0;
  const int p10 = line_tap(qb, oa).i0, p11 = line_tap(qb, ob).i0;
  const int plo = max(min(min(p00, p01), min(p10, p11)), 0);
  const int phi = min(max(max(p00, p01), max(p10, p11)) + 1, R - 1);

  uint8_t* dst = out + (static_cast<size_t>(b) * ih + y0) * iw * 3 + x0 * 3;
  const int seg = ncols * 3;  // bytes of one output row of the tile
  const bool vec_dst = ((iw * 3) & 15) == 0 && (seg & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (plo > phi) {
    // every H row is the border: 114 * (1 - w) + 114 * w rounds to 114
    const uint4 fill = make_uint4(0x72727272u, 0x72727272u, 0x72727272u, 0x72727272u);
    if (vec_dst) {
      const int per = seg >> 4;
      for (int i = tid; i < nrows * per; i += kTileThreads) {
        const int r = i / per;
        reinterpret_cast<uint4*>(dst + r * iw * 3)[i - r * per] = fill;
      }
    } else {
      for (int i = tid; i < nrows * seg; i += kTileThreads) {
        const int r = i / seg;
        dst[r * iw * 3 + i - r * seg] = 114;
      }
    }
    return;
  }

  for (int r = tid; r < nrows; r += kTileThreads) rowq[r] = pos2(t, y0 + r);
  for (int x = tid; x < ncols; x += kTileThreads) {
    colo[x] = off2(t, x0 + x);
    colq[x] = pos1(t, x0 + x);
  }
  for (int p = plo + tid; p <= phi; p += kTileThreads) line[p - plo] = off1(t, p);
  __syncthreads();

  const int col = tid % kTileCols;
  if (col < ncols) {
    warp_rows(canvas + static_cast<size_t>(b) * R * C * 3, rowq, line, plo, colo[col], colq[col],
              R, C, col, nrows, tile_out);
  }
  __syncthreads();
  if (vec_dst) {
    const int per = seg >> 4;
    for (int i = tid; i < nrows * per; i += kTileThreads) {
      const int r = i / per, k = i - r * per;
      reinterpret_cast<uint4*>(dst + r * iw * 3)[k] =
          reinterpret_cast<const uint4*>(tile_out + r * kOutPitch)[k];
    }
  } else {
    for (int i = tid; i < nrows * seg; i += kTileThreads) {
      const int r = i / seg, k = i - r * seg;
      dst[r * iw * 3 + k] = tile_out[r * kOutPitch + k];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the mixup partner, the origin select and the blend
// ---------------------------------------------------------------------------

// A block owns a kMixRows x kTileCols tile of the mid image of one item. The
// partner is two rounded resamples, as in JAX: stage 1, S1 = round(letterbox
// (tile 4)) on the (ih, iw) grid (114 outside its (nh, nw) extents), then
// stage 2, S1 resized by (th2 / ih, tw2 / iw), flipped and cropped at (x_off,
// y_off); the mid pixel is floor((origin + partner) / 2), with the partner
// 114 outside its live region. A block of an item without mixup copies its
// origin; a block whose tile misses the live region blends with 114 and reads
// no partner pixel. Otherwise the block computes the stage-1 bytes of the S1
// rectangle its stage-2 taps reach once, into shared memory (one word of three
// bytes a pixel), from tile 4's source rows staged by cp.async (as K4 stages
// its rows, and with its copy path: most of the pipeline's partners are
// unscaled at stage 1), and resamples each output pixel's partner from four
// of those words into a tile of bytes (114 preset). Bands: the S1 rectangle is taken
// in bands of output rows when it overflows its stage (at least two whole S1
// rows), and each band's source rows in bands of S1 rows when they overflow
// theirs (at least two whole source rows, aug_raw_bytes). Last, the origin is
// read and the mid tile written as 16-byte vectors, the floor average taken
// four bytes an instruction (__vhaddu4).
constexpr int kMixRows = 32;
constexpr int kMixBlocksPerSM = 4;
constexpr int kMixS1Words = 4096;  // stage-1 pixels, one word each
constexpr uint32_t kBorderWord = 0x727272u;  // 114 in each of three bytes

// Row y of an item's origin: the warped mosaic placed top-left on 114, or
// tile 0; its first `valid` bytes are read from `row`, the rest are 114.
struct OriginRow {
  const uint8_t* row;
  int valid;
};

__device__ __forceinline__ uint4 origin16(OriginRow o, int k) {
  if (k + 16 <= o.valid) return *reinterpret_cast<const uint4*>(o.row + k);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t v = k + j < o.valid ? o.row[k + j] : 114u;
    if ((j & 3) == 0) w[j >> 2] = 0;
    w[j >> 2] |= v << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// floor((a + b) / 2) in each byte
__device__ __forceinline__ uint4 half_sum16(uint4 a, uint32_t b) {
  return make_uint4(__vhaddu4(a.x, b), __vhaddu4(a.y, b), __vhaddu4(a.z, b), __vhaddu4(a.w, b));
}

// tiles (B, 5, sh, sw, 3) uint8, hw5/nhw5 (B, 5, 2) int32, warped (B, ih, iw,
// 3) uint8, mrand (B, 16) f32 -> mid (B, sh, sw, 3) uint8.
__global__ void __launch_bounds__(kTileThreads, kMixBlocksPerSM)
    mixup_kernel(const uint8_t* __restrict__ tiles, const int* __restrict__ hw5,
                 const int* __restrict__ nhw5, const uint8_t* __restrict__ warped,
                 const float* __restrict__ mrand, uint8_t* __restrict__ mid, int sh, int sw,
                 int ih, int iw, int s1_words, int raw_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  Tap* rowtap2 = reinterpret_cast<Tap*>(smem);  // kMixRows: stage 2, output rows
  Tap* coltap2 = rowtap2 + kMixRows;            // kTileCols: stage 2, output columns
  uint8_t* tile_out = reinterpret_cast<uint8_t*>(coltap2 + kTileCols);  // kMixRows x kOutPitch
  uint32_t* s1 = reinterpret_cast<uint32_t*>(tile_out + kMixRows * kOutPitch);  // s1_words
  uint8_t* raw = reinterpret_cast<uint8_t*>(s1 + s1_words);                     // raw_bytes
  Tap* tap1r = reinterpret_cast<Tap*>(raw + raw_bytes);  // stage 1, S1 rows: at most ih
  Tap* tap1c = tap1r + ih;                               // stage 1, S1 columns: at most iw
  float* scal = reinterpret_cast<float*>(tap1c + iw);    // the four scales

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kMixRows, c0 = blockIdx.x * kTileCols;
  const int nrows = min(kMixRows, sh - r0), ncols = min(kTileCols, sw - c0);
  const float* mr = mrand + b * 16;
  const int* hw = hw5 + b * 10;
  const bool mosaic = mr[0] > 0.f;
  const int rowbytes = sw * 3;
  const uint8_t* tile0 = tiles + static_cast<size_t>(b) * 5 * sh * rowbytes;
  const uint8_t* warped_b = warped + static_cast<size_t>(b) * ih * iw * 3;
  auto origin = [&](int y) -> OriginRow {
    if (!mosaic) return {tile0 + y * rowbytes, rowbytes};
    if (y < ih) return {warped_b + y * iw * 3, iw * 3};
    return {nullptr, 0};
  };
  uint8_t* dst = mid + (static_cast<size_t>(b) * sh + r0) * rowbytes + c0 * 3;
  const int seg = ncols * 3, k0 = c0 * 3;
  // whole rows of 16-byte chunks, in the origin (a warped row ends on a
  // chunk: iw * 3 is a multiple of 16 too) and in the mid image
  const bool vec = (rowbytes & 15) == 0 && (reinterpret_cast<uintptr_t>(mid) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(tiles) & 15) == 0 &&
                   (!mosaic || (((iw * 3) & 15) == 0 &&
                                (reinterpret_cast<uintptr_t>(warped) & 15) == 0));
  const int per = seg >> 4;

  if (!(mr[9] > 0.f)) {  // no mixup: the origin
    if (vec) {
      for (int i = tid; i < nrows * per; i += kTileThreads) {
        const int r = i / per, k = i - r * per;
        reinterpret_cast<uint4*>(dst + r * rowbytes)[k] = origin16(origin(r0 + r), k0 + 16 * k);
      }
    } else {
      for (int i = tid; i < nrows * seg; i += kTileThreads) {
        const int r = i / seg, k = i - r * seg;
        const OriginRow o = origin(r0 + r);
        dst[r * rowbytes + k] = k0 + k < o.valid ? o.row[k0 + k] : 114;
      }
    }
    return;
  }

  // the live region: rows y with y + y_off < th2 and y < oh (a prefix, as
  // y + y_off grows with y); columns x with 0 <= xx < tw2 and x < ow, where xx
  // is x + x_off, or tw2 - 1 - (x + x_off) for a flipped partner (an
  // interval: xx is monotone in x)
  const int tw2 = static_cast<int>(mr[14]), th2 = static_cast<int>(mr[15]);
  const bool flip = mr[11] > 0.f;
  const float x_off = mr[12], y_off = mr[13];
  const int oh = mosaic ? ih : hw[0], ow = mosaic ? iw : hw[1];
  auto yy = [&](int y) { return __fadd_rn(static_cast<float>(y), y_off); };
  auto xx = [&](int x) {
    const float v = __fadd_rn(static_cast<float>(x), x_off);
    return flip ? __fsub_rn(static_cast<float>(tw2 - 1), v) : v;
  };
  if (tid < 4) {
    const int* nhw = nhw5 + b * 10 + 8;
    scal[tid] = tid == 0 ? div_i(th2, ih) : tid == 1 ? div_i(tw2, iw)
              : tid == 2 ? div_i(nhw[0], hw[8]) : div_i(nhw[1], hw[9]);
  }
  const int nlr = __syncthreads_count(tid < nrows && yy(r0 + tid) < static_cast<float>(th2) &&
                                      r0 + tid < oh);
  // the columns before the interval (the predicate false, then true), and
  // the columns up to its end (true, then false)
  const int ca = __syncthreads_count(
      tid < ncols && !(flip ? xx(c0 + tid) < static_cast<float>(tw2) : xx(c0 + tid) >= 0.f));
  const int cb = max(ca, __syncthreads_count(tid < ncols && c0 + tid < ow &&
                                             (flip ? xx(c0 + tid) >= 0.f
                                                   : xx(c0 + tid) < static_cast<float>(tw2))));
  if (nlr > 0 && ca < cb) {
    // the partner's bytes into tile_out: 114 outside the live region
    for (int i = tid; i < kMixRows * kOutPitch / 16; i += kTileThreads)
      reinterpret_cast<uint4*>(tile_out)[i] =
          make_uint4(0x72727272u, 0x72727272u, 0x72727272u, 0x72727272u);
    const float sy2 = scal[0], sx2 = scal[1], sy1 = scal[2], sx1 = scal[3];
    for (int r = tid; r < nlr; r += kTileThreads) rowtap2[r] = lin_tap(yy(r0 + r), sy2, ih);
    for (int c = ca + tid; c < cb; c += kTileThreads) coltap2[c] = lin_tap(xx(c0 + c), sx2, iw);
    __syncthreads();
    // the S1 rectangle the taps reach (monotone in the row and the column)
    const int s_lo = rowtap2[0].i0, s_hi = rowtap2[nlr - 1].i1;
    const int t_lo = min(coltap2[ca].i0, coltap2[cb - 1].i0);
    const int t_hi = max(coltap2[ca].i1, coltap2[cb - 1].i1);
    const int h0 = hw[8], w0 = hw[9];
    const int nh = nhw5[b * 10 + 8], nw = nhw5[b * 10 + 9];
    const int s_end = min(s_hi, nh - 1), t_end = min(t_hi, nw - 1);  // S1 pixels with a source
    for (int s = s_lo + tid; s <= s_end; s += kTileThreads)
      tap1r[s - s_lo] = lin_tap(static_cast<float>(s), sy1, h0);
    for (int u = t_lo + tid; u <= t_end; u += kTileThreads)
      tap1c[u - t_lo] = lin_tap(static_cast<float>(u), sx1, w0);
    __syncthreads();

    const int s1cols = t_hi - t_lo + 1;
    const int s1cap = s1_words / s1cols;  // S1 rows a band holds, >= 2
    // tile 4's source columns, aligned to 16 bytes for cp.async
    const uint8_t* tile4 = tiles + (static_cast<size_t>(b) * 5 + 4) * sh * rowbytes;
    const bool vec_src = (rowbytes & 15) == 0 && (reinterpret_cast<uintptr_t>(tiles) & 15) == 0;
    int a0 = 0, pitch = 1, rawcap = 0;
    if (t_end >= t_lo) {
      const int sc0 = tap1c[0].i0, sc1 = tap1c[t_end - t_lo].i1;
      a0 = vec_src ? (sc0 * 3) & ~15 : sc0 * 3;
      pitch = vec_src ? ((sc1 * 3 + 3 + 15) & ~15) - a0 : (sc1 - sc0 + 1) * 3;
      rawcap = raw_bytes / pitch;  // >= 2: the stage holds two whole source rows
    }
    // i / s1cols as the high word of i * s1_m: exact for i * s1cols < 2^32
    // (i < s1_words); s1_m wraps to 0 for s1cols 1
    const unsigned s1_m = 0xffffffffu / static_cast<unsigned>(s1cols) + 1u;
    auto s1_row = [&](int i) {
      return s1_m ? static_cast<int>(__umulhi(static_cast<unsigned>(i), s1_m)) : i;
    };
    const int col = tid % kTileCols;
    const bool col_live = col >= ca && col < cb;
    const Tap tx = coltap2[col_live ? col : ca];
    const float mx = __fsub_rn(1.f, tx.w);
    const int x0w = tx.i0 - t_lo, x1w = tx.i1 - t_lo;
    for (int ra = 0; ra < nlr;) {
      const int rb = band_end(rowtap2, ra, nlr, s1cap);
      const int ua = rowtap2[ra].i0, ub = rowtap2[rb - 1].i1;
      // S1 rows ua..ub: pixels without a source are 114
      for (int i = tid; (ub > s_end || t_end < t_lo) && i < (ub - ua + 1) * s1cols;
           i += kTileThreads) {
        if (t_end < t_lo || ua + s1_row(i) > s_end)
          s1[i] = kBorderWord;
      }
      if (t_end >= t_lo && ua <= s_end) {
        const Tap* taps = tap1r + (ua - s_lo);
        const int n = min(ub, s_end) - ua + 1;
        for (int ia = 0; ia < n;) {
          const int ib = band_end(taps, ia, n, rawcap);
          const int sr0 = taps[ia].i0;
          stage_rows(raw, tile4 + a0, sr0, taps[ib - 1].i1 - sr0 + 1, pitch, rowbytes, vec_src);
          cp_async_wait_all();
          __syncthreads();
          for (int i = ia * s1cols + tid; i < ib * s1cols; i += kTileThreads) {
            const int s = s1_row(i);      // the S1 row, from ua
            const int u = i - s * s1cols;  // the S1 column, from t_lo
            if (t_lo + u > t_end) {
              s1[i] = kBorderWord;
              continue;
            }
            const Tap ty = taps[s], tc = tap1c[u];
            const uint8_t* p0 = raw + (ty.i0 - sr0) * pitch + tc.i0 * 3 - a0;
            if (ty.w == 0.f && tc.w == 0.f) {
              // the blend with both weights 0 is its first tap
              s1[i] = p0[0] | (p0[1] << 8) | (p0[2] << 16);
              continue;
            }
            const uint8_t* p1 = raw + (ty.i1 - sr0) * pitch + tc.i0 * 3 - a0;
            const int dx = (tc.i1 - tc.i0) * 3;
            uint32_t w = 0;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              const float v = bilerp(u8f(p0[ch]), u8f(p1[ch]), u8f(p0[dx + ch]), u8f(p1[dx + ch]),
                                     ty.w, tc.w);
              w |= round_byte(v) << (8 * ch);
            }
            s1[i] = w;
          }
          __syncthreads();  // the S1 band is written, the source rows are read
          ia = ib;
        }
      } else {
        __syncthreads();
      }
      // stage 2, output rows ra..rb-1: the partner's bytes
      if (col_live) {
        for (int r = ra + tid / kTileCols; r < rb; r += kTileThreads / kTileCols) {
          const Tap ty = rowtap2[r];
          const uint32_t* w0r = s1 + (ty.i0 - ua) * s1cols;
          const uint32_t a00 = w0r[x0w];
          uint8_t* o = tile_out + r * kOutPitch + col * 3;
          if (ty.w == 0.f && tx.w == 0.f) {
            o[0] = a00 & 255u, o[1] = (a00 >> 8) & 255u, o[2] = (a00 >> 16) & 255u;
            continue;
          }
          const uint32_t* w1r = s1 + (ty.i1 - ua) * s1cols;
          const uint32_t a10 = w1r[x0w], a01 = w0r[x1w], a11 = w1r[x1w];
          const float my = __fsub_rn(1.f, ty.w);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            // bilerp's rows, then columns, with 1 - w computed once a row or column
            const float r0 = __fadd_rn(__fmul_rn(word_byte(a00, ch), my),
                                       __fmul_rn(word_byte(a10, ch), ty.w));
            const float r1 = __fadd_rn(__fmul_rn(word_byte(a01, ch), my),
                                       __fmul_rn(word_byte(a11, ch), ty.w));
            o[ch] = static_cast<uint8_t>(
                round_byte(__fadd_rn(__fmul_rn(r0, mx), __fmul_rn(r1, tx.w))));
          }
        }
      }
      ra = rb;
      if (ra < nlr) __syncthreads();  // the band's S1 rows are read before the next ones
    }
    __syncthreads();
  }
  // floor((origin + partner) / 2); the partner is 114 where the tile misses
  // its live region
  const bool live = nlr > 0 && ca < cb;
  if (vec) {
    for (int i = tid; i < nrows * per; i += kTileThreads) {
      const int r = i / per, k = i - r * per;
      const uint4 o = origin16(origin(r0 + r), k0 + 16 * k);
      if (!live) {
        reinterpret_cast<uint4*>(dst + r * rowbytes)[k] = half_sum16(o, 0x72727272u);
        continue;
      }
      const uint4 p = reinterpret_cast<const uint4*>(tile_out + r * kOutPitch)[k];
      reinterpret_cast<uint4*>(dst + r * rowbytes)[k] =
          make_uint4(__vhaddu4(o.x, p.x), __vhaddu4(o.y, p.y), __vhaddu4(o.z, p.z),
                     __vhaddu4(o.w, p.w));
    }
  } else {
    for (int i = tid; i < nrows * seg; i += kTileThreads) {
      const int r = i / seg, k = i - r * seg;
      const OriginRow o = origin(r0 + r);
      const uint32_t p = live ? tile_out[r * kOutPitch + k] : 114u;
      dst[r * rowbytes + k] = ((k0 + k < o.valid ? o.row[k0 + k] : 114u) + p) >> 1;
    }
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
// K3: the S1 stage holds at least two whole S1 rows
int mix_s1_words(int iw) { return 2 * iw > kMixS1Words ? (2 * iw + 3) & ~3 : kMixS1Words; }
constexpr int kTapBytes = static_cast<int>(sizeof(Tap));
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

// Shared memory of a K2 block (the offsets of at most 2ih canvas rows) and of
// a K3 block (the stage-1 taps of at most ih rows and iw columns)
int warp_smem_bytes(int ih) {
  return static_cast<int>(sizeof(Split)) * (kWarpRows + 2 * kTileCols + 2 * ih) + 16 +
         kWarpRows * kOutPitch;
}
int mix_smem_bytes(int ih, int iw, int s1_words, int raw_bytes) {
  return kTapBytes * (kMixRows + kTileCols + ih + iw) + kMixRows * kOutPitch + 4 * s1_words +
         raw_bytes + 16;
}

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

// canvas (B, 2ih, 2iw, 3) uint8, m6 (B, 6) f32 -> out (B, ih, iw, 3) uint8
int cocodet_affine_warp(const void* canvas, const void* m6, void* out, int B, int ih, int iw,
                        void* stream) {
  if (static_cast<int64_t>(B) * ih * iw <= 0) return 0;
  const int smem = warp_smem_bytes(ih);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);  // ih above ~14,000
  if (const int rc = allow_smem(affine_warp_kernel, smem)) return rc;
  affine_warp_kernel<<<tile_grid(B, ih, iw, kWarpRows), kTileThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(canvas), static_cast<const float*>(m6),
      static_cast<uint8_t*>(out), ih, iw);
  return static_cast<int>(cudaGetLastError());
}

int cocodet_mixup(const void* tiles, const void* hw5, const void* nhw5, const void* warped,
                  const void* mrand, void* mid, int B, int sh, int sw, int ih, int iw,
                  void* stream) {
  if (static_cast<int64_t>(B) * sh * sw <= 0) return 0;
  const int s1 = mix_s1_words(iw), raw = aug_raw_bytes(sw);
  const int smem = mix_smem_bytes(ih, iw, s1, raw);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);  // sw or iw above ~6,000
  if (const int rc = allow_smem(mixup_kernel, smem)) return rc;
  mixup_kernel<<<tile_grid(B, sh, sw, kMixRows), kTileThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tiles), static_cast<const int*>(hw5),
      static_cast<const int*>(nhw5), static_cast<const uint8_t*>(warped),
      static_cast<const float*>(mrand), static_cast<uint8_t*>(mid), sh, sw, ih, iw, s1, raw);
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
