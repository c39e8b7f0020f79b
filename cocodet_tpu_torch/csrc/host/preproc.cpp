// Native host-side image preprocessing for the port's data loaders.
//
// letterbox_u8 is a copy of cocodet_tpu/layers/fast_preproc/src/preproc.cpp,
// unchanged, so the port's letterbox equals the JAX package's native one bit
// for bit (built with the same g++ flags): a bilinear resize + pad + dtype
// convert fused in one pass over the output, threads over output rows.
//
// letterbox_u8: HWC uint8 BGR in -> fixed (out_h, out_w) canvas,
//   ratio-preserving bilinear resize anchored top-left, `fill` elsewhere,
//   float32 output (no normalization).
//
// resize_u8 takes the place of cv2.resize(img, (new_w, new_h),
// interpolation=cv2.INTER_LINEAR) on uint8 images, which the JAX package's
// datasets call (cocodet_tpu/data/coco.py:141, data/folder.py:178). It
// computes what OpenCV's fixed-point path does: coefficients rounded to 11
// bits (2048 = 1.0) from f32 source positions, an exact integer horizontal
// pass, and the vertical pass of OpenCV's SIMD code, which rounds otherwise
// than its scalar formula: ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16),
// then (+2) >> 2. Its plain version is cocodet_tpu_torch/data/transforms.py::
// resize_plain; both equal cv2.resize on every pixel the tests draw.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline void resize_rows(const uint8_t* src, int sh, int sw,
                        float* dst, int out_w, int new_h, int new_w,
                        float fill, int row_begin, int row_end) {
  const float sy_ratio = static_cast<float>(sh) / new_h;
  const float sx_ratio = static_cast<float>(sw) / new_w;
  for (int y = row_begin; y < row_end; ++y) {
    float* out_row = dst + static_cast<size_t>(y) * out_w * 3;
    if (y >= new_h) {
      std::fill(out_row, out_row + static_cast<size_t>(out_w) * 3, fill);
      continue;
    }
    // cv2.INTER_LINEAR pixel-center convention
    const float fy = (y + 0.5f) * sy_ratio - 0.5f;
    const int y0 = std::clamp(static_cast<int>(std::floor(fy)), 0, sh - 1);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = std::clamp(fy - y0, 0.0f, 1.0f);
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * 3;
    int x = 0;
    for (; x < new_w; ++x) {
      const float fx = (x + 0.5f) * sx_ratio - 0.5f;
      const int x0 = std::clamp(static_cast<int>(std::floor(fx)), 0, sw - 1);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = std::clamp(fx - x0, 0.0f, 1.0f);
      for (int c = 0; c < 3; ++c) {
        const float top = row0[x0 * 3 + c] +
                          wx * (row0[x1 * 3 + c] - row0[x0 * 3 + c]);
        const float bot = row1[x0 * 3 + c] +
                          wx * (row1[x1 * 3 + c] - row1[x0 * 3 + c]);
        out_row[x * 3 + c] = top + wy * (bot - top);
      }
    }
    for (; x < out_w; ++x)
      for (int c = 0; c < 3; ++c) out_row[x * 3 + c] = fill;
  }
}

// Source index and 11-bit weights of each destination coordinate, as
// OpenCV's resize sets them up for INTER_LINEAR: fx = f32((d + 0.5) * scale
// - 0.5) with scale = 1 / (double(dst) / src), sx = floor(fx); a position
// before the first or past the last source pixel takes that pixel whole.
struct Taps {
  std::vector<int> s0, s1;
  std::vector<int> w0, w1;
};

// No fused multiply-add here: -march=native may contract (d + 0.5) * scale
// - 0.5 into one, which rounds once where OpenCV rounds twice.
__attribute__((optimize("fp-contract=off")))
Taps linear_taps(int src, int dst, bool clamp_weights) {
  Taps t;
  t.s0.resize(dst); t.s1.resize(dst); t.w0.resize(dst); t.w1.resize(dst);
  const double scale = 1.0 / (static_cast<double>(dst) / src);
  for (int d = 0; d < dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= static_cast<float>(s);
    if (clamp_weights) {  // the horizontal taps: the border pixel whole
      if (s < 0) { f = 0.f; s = 0; }
      if (s >= src - 1) { f = 0.f; s = src - 1; }
    }
    t.s0[d] = std::clamp(s, 0, src - 1);
    t.s1[d] = std::clamp(s + 1, 0, src - 1);
    t.w0[d] = static_cast<int>(std::nearbyint((1.f - f) * 2048.f));
    t.w1[d] = static_cast<int>(std::nearbyint(f * 2048.f));
  }
  return t;
}

void resize_u8_rows(const uint8_t* src, int sw, int cn, uint8_t* dst,
                    int dw, int dh, const Taps& tx, const Taps& ty) {
  const int row = dw * cn;
  std::vector<int32_t> h0(row), h1(row);
  // the horizontal pass of one source row: exact integers, 2048 = 1.0
  auto hpass = [&](int sy, int32_t* out) {
    const uint8_t* s = src + static_cast<size_t>(sy) * sw * cn;
    for (int x = 0; x < dw; ++x)
      for (int c = 0; c < cn; ++c)
        out[x * cn + c] = s[tx.s0[x] * cn + c] * tx.w0[x] +
                          s[tx.s1[x] * cn + c] * tx.w1[x];
  };
  for (int y = 0; y < dh; ++y) {
    hpass(ty.s0[y], h0.data());
    hpass(ty.s1[y], h1.data());
    const int b0 = ty.w0[y], b1 = ty.w1[y];
    uint8_t* out = dst + static_cast<size_t>(y) * row;
    for (int i = 0; i < row; ++i) {
      const int v = (((b0 * (h0[i] >> 4)) >> 16) +
                     ((b1 * (h1[i] >> 4)) >> 16) + 2) >> 2;
      out[i] = static_cast<uint8_t>(std::clamp(v, 0, 255));
    }
  }
}

}  // namespace

extern "C" {

// Returns the resize ratio used.
float letterbox_u8(const uint8_t* src, int src_h, int src_w,
                   float* dst, int out_h, int out_w,
                   float fill, int num_threads) {
  const float r = std::min(static_cast<float>(out_h) / src_h,
                           static_cast<float>(out_w) / src_w);
  const int new_h = static_cast<int>(src_h * r);
  const int new_w = static_cast<int>(src_w * r);

  if (num_threads <= 1) {
    resize_rows(src, src_h, src_w, dst, out_w, new_h, new_w, fill, 0, out_h);
    return r;
  }
  std::vector<std::thread> workers;
  const int rows_per = (out_h + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int b = t * rows_per;
    const int e = std::min(b + rows_per, out_h);
    if (b >= e) break;
    workers.emplace_back(resize_rows, src, src_h, src_w, dst, out_w,
                         new_h, new_w, fill, b, e);
  }
  for (auto& w : workers) w.join();
  return r;
}

// HWC uint8 (src_h, src_w, cn) -> (dst_h, dst_w, cn), cv2.INTER_LINEAR.
void resize_u8(const uint8_t* src, int src_h, int src_w, int cn,
               uint8_t* dst, int dst_h, int dst_w) {
  const Taps tx = linear_taps(src_w, dst_w, true);
  const Taps ty = linear_taps(src_h, dst_h, false);
  resize_u8_rows(src, src_w, cn, dst, dst_w, dst_h, tx, ty);
}

}  // extern "C"
