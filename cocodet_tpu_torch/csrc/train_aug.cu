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
// batch is one launch of each kernel (two of affine_pass_kernel), one thread a
// pixel, all three channels in the thread.
//
// Rounding as JAX's: jnp.round is half to even (rintf), the mixup blend is
// floor, the HSV gains are truncated before they arrive; jnp.remainder takes
// the sign of the divisor (pymod below), where fmodf takes the dividend's;
// jnp.select's default branch is sector 5.
//
// Bound on the H100: bytes. Each kernel reads its inputs and writes its
// output once at a few tens of operations a pixel; the bilinear taps re-read
// neighbouring pixels from L1/L2. At B=16, 768 px: the canvas reads 4 tiles
// (113 MB of uint8) and writes a 2x canvas (113 MB); the warp's first pass
// reads the canvas and writes an f32 half-width map (226 MB), which the
// second pass reads in place, by columns (no transpose copy), writing uint8;
// the mixup reads the warped mosaic, tile 0 and the partner, and writes the
// uint8 mid image; the last kernel reads it and writes the f32 images the
// step takes (113 MB). Intermediates that hold integers are stored as uint8
// (exact), so the only f32 intermediate is the warp's unrounded first pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);  // jnp.clip: minimum(maximum(x, lo), hi)
}

// jnp.remainder for f32: fmod, then + divisor where the signs differ.
__device__ __forceinline__ float pymod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.f && ((r < 0.f) != (y < 0.f))) r = __fadd_rn(r, y);
  return r;
}

__device__ __forceinline__ float round_u8(float x) { return rintf(clampf(x, 0.f, 255.f)); }

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
// K1: the 2x mosaic canvas
// ---------------------------------------------------------------------------

// tiles (B, 5, sh, sw, 3) uint8; hw5, nhw5 (B, 5, 2) int32; yc, xc (B,) int32;
// canvas (B, 2ih, 2iw, 3) uint8 = round(clip(., 0, 255)) of the where chain
// over the four tile rectangles on a 114 background.
__global__ void mosaic_canvas_kernel(const uint8_t* __restrict__ tiles,
                                     const int* __restrict__ hw5, const int* __restrict__ nhw5,
                                     const int* __restrict__ yc_, const int* __restrict__ xc_,
                                     uint8_t* __restrict__ canvas, int B, int sh, int sw,
                                     int ih, int iw) {
  const int H = 2 * ih, W = 2 * iw;
  const int64_t total = static_cast<int64_t>(B) * H * W;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int u = static_cast<int>(idx % W);
    const int v = static_cast<int>((idx / W) % H);
    const int b = static_cast<int>(idx / (static_cast<int64_t>(W) * H));
    const int yc = yc_[b], xc = xc_[b];
    const int* nhw = nhw5 + b * 10;
    const int* hw = hw5 + b * 10;
    // _tile_rects: rectangles on the canvas and the source-crop origins
    const int x1[4] = {max(xc - nhw[1], 0), xc, max(xc - nhw[5], 0), xc};
    const int y1[4] = {max(yc - nhw[0], 0), max(yc - nhw[2], 0), yc, yc};
    const int x2[4] = {xc, min(xc + nhw[3], W), xc, min(xc + nhw[7], W)};
    const int y2[4] = {yc, yc, min(H, yc + nhw[4]), min(H, yc + nhw[6])};
    int t = -1;
    for (int k = 3; k >= 0; --k) {  // the where chain: the last live tile wins
      if (v >= y1[k] && v < y2[k] && u >= x1[k] && u < x2[k]) {
        t = k;
        break;
      }
    }
    uint8_t* o = canvas + idx * 3;
    if (t < 0) {
      o[0] = o[1] = o[2] = 114;
      continue;
    }
    const int nh = nhw[2 * t], nw = nhw[2 * t + 1];
    const int h0 = hw[2 * t], w0 = hw[2 * t + 1];
    const int sx1 = (t == 0 || t == 2) ? nw - (x2[t] - x1[t]) : 0;
    const int sy1 = (t == 0 || t == 1) ? nh - (y2[t] - y1[t]) : 0;
    const int padw = x1[t] - sx1, padh = y1[t] - sy1;
    const Tap ty = lin_tap(__fsub_rn(static_cast<float>(v), static_cast<float>(padh)),
                           div_i(nh, h0), h0);
    const Tap tx = lin_tap(__fsub_rn(static_cast<float>(u), static_cast<float>(padw)),
                           div_i(nw, w0), w0);
    const uint8_t* tile = tiles + (static_cast<int64_t>(b) * 5 + t) * sh * sw * 3;
    const uint8_t* p00 = tile + (static_cast<int64_t>(ty.i0) * sw + tx.i0) * 3;
    const uint8_t* p10 = tile + (static_cast<int64_t>(ty.i1) * sw + tx.i0) * 3;
    const uint8_t* p01 = tile + (static_cast<int64_t>(ty.i0) * sw + tx.i1) * 3;
    const uint8_t* p11 = tile + (static_cast<int64_t>(ty.i1) * sw + tx.i1) * 3;
    for (int c = 0; c < 3; ++c) {
      const float val = bilerp(p00[c], p10[c], p01[c], p11[c], ty.w, tx.w);
      o[c] = static_cast<uint8_t>(round_u8(val));
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
// gains g, hsv_to_bgr, then clip(round(.), 0, 255)).
__device__ __forceinline__ void hsv_jitter_px(const float in[3], const float g[3], float out[3]) {
  const float b = in[0], gr = in[1], r = in[2];
  float v = fmaxf(fmaxf(b, gr), r);
  const float mn = fminf(fminf(b, gr), r);
  const float diff = __fsub_rn(v, mn);
  const float safe = diff > 0.f ? diff : 1.f;
  float h;
  if (v == r) {
    h = __fmul_rn(__fdiv_rn(__fsub_rn(gr, b), safe), 30.f);
  } else if (v == gr) {
    h = __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(b, r), safe), 30.f), 60.f);
  } else {
    h = __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(r, gr), safe), 30.f), 120.f);
  }
  h = diff > 0.f ? pymod(h, 180.f) : 0.f;
  float s = v > 0.f ? __fmul_rn(__fdiv_rn(diff, v), 255.f) : 0.f;
  h = pymod(__fadd_rn(h, g[0]), 180.f);
  s = clampf(__fadd_rn(s, g[1]), 0.f, 255.f);
  v = clampf(__fadd_rn(v, g[2]), 0.f, 255.f);
  const float h6 = __fdiv_rn(h, 30.f);
  const float c = __fmul_rn(v, __fdiv_rn(s, 255.f));
  const float x = __fmul_rn(c, __fsub_rn(1.f, fabsf(__fsub_rn(pymod(h6, 2.f), 1.f))));
  const float m = __fsub_rn(v, c);
  int sector = static_cast<int>(floorf(h6)) % 6;
  if (sector < 0) sector += 6;
  float rr, gg, bb;
  switch (sector) {
    case 0: rr = c; gg = x; bb = 0.f; break;
    case 1: rr = x; gg = c; bb = 0.f; break;
    case 2: rr = 0.f; gg = c; bb = x; break;
    case 3: rr = 0.f; gg = x; bb = c; break;
    case 4: rr = x; gg = 0.f; bb = c; break;
    default: rr = c; gg = 0.f; bb = x; break;  // jnp.select's default: sector 5
  }
  out[0] = clampf(rintf(__fadd_rn(bb, m)), 0.f, 255.f);
  out[1] = clampf(rintf(__fadd_rn(gg, m)), 0.f, 255.f);
  out[2] = clampf(rintf(__fadd_rn(rr, m)), 0.f, 255.f);
}

// One tap of the letterbox source: the clean pixel when the item falls back,
// else the HSV-jittered pixel at the flipped column.
__device__ __forceinline__ void aug_tap(const uint8_t* img, int sw, int w, int ty, int tx,
                                        bool flip, bool fallback, const float g[3],
                                        float out[3]) {
  float px[3];
  if (fallback) {
    const uint8_t* p = img + (static_cast<int64_t>(ty) * sw + tx) * 3;
    for (int c = 0; c < 3; ++c) out[c] = p[c];
    return;
  }
  const int col = flip ? min(max(w - 1 - tx, 0), sw - 1) : tx;
  const uint8_t* p = img + (static_cast<int64_t>(ty) * sw + col) * 3;
  for (int c = 0; c < 3; ++c) px[c] = p[c];
  hsv_jitter_px(px, g, out);
}

// img (B, sh, sw, 3) uint8, hw/nhw (B, 2) int32, gains (B, 3) f32 (truncated),
// flip/fallback (B,) int32 -> out (B, ih, iw, 3) f32, 114 outside (nh, nw).
__global__ void train_aug_kernel(const uint8_t* __restrict__ img, const int* __restrict__ hw,
                                 const int* __restrict__ nhw, const float* __restrict__ gains,
                                 const int* __restrict__ flip, const int* __restrict__ fallback,
                                 float* __restrict__ out, int B, int sh, int sw, int ih, int iw) {
  const int64_t total = static_cast<int64_t>(B) * ih * iw;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(idx % iw);
    const int y = static_cast<int>((idx / iw) % ih);
    const int b = static_cast<int>(idx / (static_cast<int64_t>(iw) * ih));
    float* o = out + idx * 3;
    const int nh = nhw[2 * b], nw = nhw[2 * b + 1];
    if (!(y < nh && x < nw)) {
      o[0] = o[1] = o[2] = 114.f;
      continue;
    }
    const int h = hw[2 * b], w = hw[2 * b + 1];
    const Tap ty = lin_tap(static_cast<float>(y), div_i(nh, h), h);
    const Tap tx = lin_tap(static_cast<float>(x), div_i(nw, w), w);
    const uint8_t* im = img + static_cast<int64_t>(b) * sh * sw * 3;
    const bool fl = flip[b] != 0, fb = fallback[b] != 0;
    const float g[3] = {gains[3 * b], gains[3 * b + 1], gains[3 * b + 2]};
    float a00[3], a10[3], a01[3], a11[3];
    aug_tap(im, sw, w, ty.i0, tx.i0, fl, fb, g, a00);
    aug_tap(im, sw, w, ty.i1, tx.i0, fl, fb, g, a10);
    aug_tap(im, sw, w, ty.i0, tx.i1, fl, fb, g, a01);
    aug_tap(im, sw, w, ty.i1, tx.i1, fl, fb, g, a11);
    for (int c = 0; c < 3; ++c) o[c] = bilerp(a00[c], a10[c], a01[c], a11[c], ty.w, tx.w);
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 132 * 64 ? b : 132 * 64);  // grid-stride past 64 blocks an SM
}

}  // namespace

extern "C" {

// Every pointer is to contiguous memory on the current device, in the
// layouts above; each function launches one kernel on `stream` and returns
// cudaGetLastError() after it (0 = cudaSuccess).

int cocodet_mosaic_canvas(const void* tiles, const void* hw5, const void* nhw5, const void* yc,
                          const void* xc, void* canvas, int B, int sh, int sw, int ih, int iw,
                          void* stream) {
  const int64_t n = static_cast<int64_t>(B) * 4 * ih * iw;
  if (n <= 0) return 0;
  mosaic_canvas_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tiles), static_cast<const int*>(hw5),
      static_cast<const int*>(nhw5), static_cast<const int*>(yc), static_cast<const int*>(xc),
      static_cast<uint8_t*>(canvas), B, sh, sw, ih, iw);
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
  const int64_t n = static_cast<int64_t>(B) * ih * iw;
  if (n <= 0) return 0;
  train_aug_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const int*>(hw), static_cast<const int*>(nhw),
      static_cast<const float*>(gains), static_cast<const int*>(flip),
      static_cast<const int*>(fallback), static_cast<float*>(out), B, sh, sw, ih, iw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
