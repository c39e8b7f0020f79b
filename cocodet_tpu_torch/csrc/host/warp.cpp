// cv2.warpAffine (INTER_LINEAR, constant border) and cv2.cvtColor (BGR<->HSV)
// on uint8 images, for cocodet_tpu_torch/data/transforms.py: the host mosaic
// path's random_affine and augment_hsv (cocodet_tpu/data/transforms.py:40-52,
// 99-107).
//
// OpenCV 5 runs these in float kernels whose results depend on the order of
// operations, on where fused multiply-adds are used, and on which of a row's
// pixels its vector loop covers; this file computes each pixel as those
// kernels do, so its output equals cv2's bit for bit:
//
//  * warp: the 2x3 matrix is inverted in f64 (as warpAffine does) and cast
//    to f32. A row's pixels are taken 16 at a time by the vector loop
//    (source x = fma(M0, x, float(y * M1) + M2)); the rest of the row by a
//    scalar loop whose compiler fused it otherwise (fma(x, M0, y * M1) + M2).
//    Both floor the coordinates, lerp along x and then along y, each lerp
//    p0 + t * (p1 - p0) one fma, taps outside the source taking the border
//    value, and round to nearest even.
//  * BGR->HSV: OpenCV's 12-bit fixed-point division tables (exact).
//  * HSV->BGR: s and v scaled by 1/255, the sector table with
//    v * fma(-s, f, 1) terms; the vector loop (32 pixels at a time) truncates
//    the products by 255, the scalar rest of the row rounds them.
//
// The plain numpy versions, which the tests hold this file against, are
// cocodet_tpu_torch/data/transforms.py::{warp_affine_plain, bgr_to_hsv_plain,
// hsv_to_bgr_plain}.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

const int kWarpLanes = 16;  // pixels a step of cv2's vector warp loop
const int kHsvLanes = 32;   // pixels a step of cv2's vector HSV->BGR loop

inline uint8_t sat_round(float v) {
  const float r = std::nearbyint(v);
  return static_cast<uint8_t>(r < 0.f ? 0 : r > 255.f ? 255 : static_cast<int>(r));
}

inline uint8_t sat_trunc(float v) {
  const float r = std::floor(v);
  return static_cast<uint8_t>(r < 0.f ? 0 : r > 255.f ? 255 : static_cast<int>(r));
}

// OpenCV's 12-bit division tables of RGB2HSV_b (saturate_cast rounds to even)
struct HsvTables {
  int sdiv[256], hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = static_cast<int>(std::nearbyint((255 << 12) / (1. * i)));
      hdiv[i] = static_cast<int>(std::nearbyint((180 << 12) / (6. * i)));
    }
  }
};
const HsvTables kHsvTables;

}  // namespace

extern "C" {

// src (sh, sw, 3) -> dst (dh, dw, 3) through the forward 2x3 matrix m.
void warp_affine_u8(const uint8_t* src, int sh, int sw, const double* m, uint8_t* dst, int dh,
                    int dw, int border) {
  double M[6];
  std::memcpy(M, m, sizeof M);
  double D = M[0] * M[4] - M[1] * M[3];
  D = D != 0 ? 1. / D : 0;
  const double A11 = M[4] * D, A22 = M[0] * D;
  M[0] = A11;
  M[1] *= -D;
  M[3] *= -D;
  M[4] = A22;
  const double b1 = -M[0] * M[2] - M[1] * M[5];
  const double b2 = -M[3] * M[2] - M[4] * M[5];
  M[2] = b1;
  M[5] = b2;
  float F[6];
  for (int i = 0; i < 6; ++i) F[i] = static_cast<float>(M[i]);
  const float bv = static_cast<float>(border);
  const int vend = dw - dw % kWarpLanes;
  for (int y = 0; y < dh; ++y) {
    const float fy = static_cast<float>(y);
    // the products are rounded before the adds: a volatile keeps the
    // compiler from fusing them (g++ contracts a * b + c by default)
    volatile float py = fy * F[1], qy = fy * F[4];
    const float rx = py + F[2], ry = qy + F[5];
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < vend) {
        sx = std::fmaf(F[0], fx, rx);
        sy = std::fmaf(F[3], fx, ry);
      } else {
        sx = std::fmaf(fx, F[0], fy * F[1]) + F[2];
        sy = std::fmaf(fx, F[3], fy * F[4]) + F[5];
      }
      uint8_t* o = out + 3 * x;
      if (!(std::fabs(sx) < 1e9f && std::fabs(sy) < 1e9f)) {
        o[0] = o[1] = o[2] = sat_round(bv);
        continue;
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const int ix = static_cast<int>(flx), iy = static_cast<int>(fly);
      const float a = sx - flx, b = sy - fly;
      const bool x0in = ix >= 0 && ix < sw, x1in = ix + 1 >= 0 && ix + 1 < sw;
      const bool y0in = iy >= 0 && iy < sh, y1in = iy + 1 >= 0 && iy + 1 < sh;
      const uint8_t* r0 = src + (static_cast<long>(iy) * sw + ix) * 3;
      const uint8_t* r1 = r0 + static_cast<long>(sw) * 3;
      for (int c = 0; c < 3; ++c) {
        const float p00 = (y0in && x0in) ? r0[c] : bv;
        const float p01 = (y0in && x1in) ? r0[3 + c] : bv;
        const float p10 = (y1in && x0in) ? r1[c] : bv;
        const float p11 = (y1in && x1in) ? r1[3 + c] : bv;
        const float v0 = std::fmaf(a, p01 - p00, p00);
        const float v1 = std::fmaf(a, p11 - p10, p10);
        o[c] = sat_round(std::fmaf(b, v1 - v0, v0));
      }
    }
  }
}

// cv2.cvtColor(src, COLOR_BGR2HSV) on n pixels (h in 0..179).
void bgr_to_hsv_u8(const uint8_t* src, uint8_t* dst, long n) {
  const int* sdiv = kHsvTables.sdiv;
  const int* hdiv = kHsvTables.hdiv;
  for (long i = 0; i < n; ++i) {
    const int b = src[3 * i], g = src[3 * i + 1], r = src[3 * i + 2];
    const int v = b > g ? (b > r ? b : r) : (g > r ? g : r);
    const int vmin = b < g ? (b < r ? b : r) : (g < r ? g : r);
    const int diff = v - vmin;
    const int s = (diff * sdiv[v] + (1 << 11)) >> 12;
    int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * hdiv[diff] + (1 << 11)) >> 12;
    if (h < 0) h += 180;
    dst[3 * i] = static_cast<uint8_t>(h > 255 ? 255 : h);
    dst[3 * i + 1] = static_cast<uint8_t>(s);
    dst[3 * i + 2] = static_cast<uint8_t>(v);
  }
}

// cv2.cvtColor(src, COLOR_HSV2BGR) on rows rows of w pixels each.
void hsv_to_bgr_u8(const uint8_t* src, uint8_t* dst, int rows, int w) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.0f / 180;
  const int vend = w - w % kHsvLanes;
  for (int y = 0; y < rows; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = (static_cast<size_t>(y) * w + x) * 3;
      float h = src[i];
      const float s = src[i + 1] * (1.0f / 255.0f), v = src[i + 2] * (1.0f / 255.0f);
      float b, g, r;
      if (s == 0) {
        b = g = r = v;
      } else {
        h *= hscale;
        h = std::fmod(h, 6.f);
        int sector = static_cast<int>(std::floor(h));
        h -= sector;
        if (static_cast<unsigned>(sector) >= 6u) {
          sector = 0;
          h = 0.f;
        }
        float tab[4];
        tab[0] = v;
        tab[1] = v * (1.f - s);
        tab[2] = v * std::fmaf(-s, h, 1.f);
        tab[3] = v * std::fmaf(-s, 1.f - h, 1.f);
        b = tab[sector_data[sector][0]];
        g = tab[sector_data[sector][1]];
        r = tab[sector_data[sector][2]];
      }
      if (x < vend) {
        dst[i] = sat_trunc(b * 255.f);
        dst[i + 1] = sat_trunc(g * 255.f);
        dst[i + 2] = sat_trunc(r * 255.f);
      } else {
        dst[i] = sat_round(b * 255.f);
        dst[i + 1] = sat_round(g * 255.f);
        dst[i + 2] = sat_round(r * 255.f);
      }
    }
  }
}

}  // extern "C"
