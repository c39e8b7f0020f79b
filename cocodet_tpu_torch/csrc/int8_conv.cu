// Int8 convolution for NVIDIA Hopper (sm_90a), bound to Python with ctypes:
// the w8a8 conv with the activation quantize fused on its input and the
// rescale and bias fused on its output.
//
// Built by cocodet_tpu_torch/ops/cuda/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and no --use_fast_math: the quantize is an IEEE division (never a multiply
// by the reciprocal) and the epilogue rounds exactly where the plain PyTorch
// version (ops/cuda/int8_conv.py::conv2d_w8a8_plain) and the JAX reference
// do. The arithmetic uses the explicit round-to-nearest intrinsics, so it
// stays IEEE even if the flags change.
//
// int8_conv_kernel
//   Replaces the w8a8 branch of cocodet_tpu/models/blocks.py::Conv2d
//   (:248-283), which JAX left to XLA (conv_general_dilated on int8
//   operands with preferred_element_type=int32):
//     xq  = clip(round_half_even(x / a_scale), -127, 127)      (f32 division)
//     acc = conv(xq, w) in s32
//     y   = (float(acc) * out_scale[o]).to(out dtype) + bias[o].to(out dtype)
//   with out_scale = w_scale if a_scale is a (C,) vector, else
//   a_scale * w_scale. Padding is int8 zero (JAX quantizes, then pads).
//   Takes groups=1, dilation=1, a square kernel of 1 or 3, stride 1 or 2
//   and pad (k-1)/2; x (B, H, W, C) NHWC in f32 or bf16; w (O, k, k, C)
//   int8; y (B, Ho, Wo, O) NHWC in f32 or bf16.
//   Bound on the H100: bytes. At a batch of 16 640 px images the 127 int8
//   convs of the slim YOLOX-M-P6 do 481 G int8 operations (0.24 ms at 1979
//   TOP/s) on 2.92 GB of activations and weights, each read or written once
//   (0.87 ms at 3.35 TB/s; chip_smoke.py phase e counts both).
//   Design: an implicit GEMM, M = B*Ho*Wo output pixels, N = O, K = k*k*C,
//   on the tensor cores by mma.sync.m16n8k32 s8 x s8 -> s32, which is exact.
//   A block of 4 warps computes a 32 x 64 tile of y; each warp a 16 x 32
//   tile of 1 x 4 mma tiles. K goes in steps of 32 through two buffers in
//   shared memory: while the tensor cores work on one step, the threads load
//   the next from device memory into registers, then quantize it (the
//   division, the rounding, the clamp) as they store it to the other buffer,
//   so the int8 activations never go to device memory. The time goes to the
//   loads' latency and to the divisions, not to the tensor cores; the small
//   tile keeps a thread near 70 registers, so that many warps hide both.
//   When C is a multiple of 32 (every conv of the headline but the Focus
//   stem) a step is one kernel tap and 32 consecutive channels: four threads
//   read a pixel's 32 channels as 16-byte vectors. Any other C (the stem's
//   12) takes a general path that decomposes each k into (tap, channel) and
//   guards each element. Shared-memory rows are padded to 48 bytes so that
//   the fragment loads hit 32 distinct banks. The epilogue writes y (and,
//   for the checks, the s32 accumulators) from registers.
//   Each element of x is read and quantized once for every 64-wide tile of
//   O and every tap that covers it: the redesign (wgmma, TMA, the
//   activation quantized once) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;        // output pixels of a block tile
constexpr int kBN = 64;        // output channels of a block tile
constexpr int kBK = 32;        // depth of a step: one mma k-step
constexpr int kThreads = 128;  // warps: 2 over the columns, the rest over the rows
constexpr int kRow = kBK + 16; // bytes of a shared-memory row, padded
constexpr int kWarpsM = kThreads / 64;  // warps over the rows
constexpr int kMI = kBM / kWarpsM / 16; // 16-row mma tiles of a warp
constexpr int kRowsA = kBM * 4 / kThreads;  // rows a thread stages, 8 k-values each
static_assert(kBN == 64 && kThreads >= 2 * kBN && kRowsA >= 1 && kMI >= 1,
              "tile shape");

struct Params {
  const void* x;
  const int8_t* w;
  const float* a_scale;
  const float* w_scale;
  const void* bias;  // nullptr: no bias
  void* y;
  int32_t* acc;      // nullptr, or the s32 accumulators (B, Ho, Wo, O)
  int a_vec;         // a_scale is a (C,) vector (else a scalar)
  int B, H, W, C, O, k, stride, pad, Ho, Wo, M, K;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive channels as float, from a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// clip(round_half_even(v / s), -127, 127) as a byte. A zero numerator
// (hard-swish writes many) would take the division's slow path (FCHK), so
// it divides 1 instead and selects 0 after: 0 / s is 0 exactly.
__device__ __forceinline__ uint32_t quantize(float v, float s) {
  const float d = __fdiv_rn(v == 0.0f ? 1.0f : v, s);
  const float q = v == 0.0f ? 0.0f : fminf(fmaxf(rintf(d), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// v rounded to the output type (round to nearest even), as a float.
__device__ __forceinline__ float round_to(float, float v) { return v; }
__device__ __forceinline__ float round_to(__nv_bfloat16, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_out(float* y, size_t i, float v) { y[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* y, size_t i, float v) {
  y[i] = __float2bfloat16_rn(v);
}

// The epilogue of one output: float(acc) * out_scale rounded to the output
// type, then + bias in the output type, rounded again.
template <typename Tout>
__device__ __forceinline__ float epilogue(int32_t acc, float out_scale,
                                          const Tout* bias, int n) {
  float v = __fmul_rn(__int2float_rn(acc), out_scale);
  if (bias != nullptr) {
    v = __fadd_rn(round_to(Tout(), v), to_float(bias[n]));
  }
  return v;
}

template <typename Tin, typename Tout, bool kFast>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const Params p) {
  __shared__ __align__(16) uint8_t a_smem[2][kBM][kRow];
  __shared__ __align__(16) uint8_t b_smem[2][kBN][kRow];

  const Tin* x = static_cast<const Tin*>(p.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // Loads of A: thread tid owns rows i*kThreads/4 + tid/4 (i < kRowsA) of
  // the tile and the 8 k-values part*8 .. part*8+7 of a step.
  const int part = tid & 3;
  int pix[kRowsA], h0[kRowsA], w0[kRowsA];
  bool row_ok[kRowsA];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const int m = m0 + i * (kThreads / 4) + (tid >> 2);
    row_ok[i] = m < p.M;
    const int mm = row_ok[i] ? m : 0;
    const int b = mm / (p.Ho * p.Wo), rem = mm - b * p.Ho * p.Wo;
    const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
    pix[i] = b * p.H * p.W;
    h0[i] = ho * p.stride - p.pad;
    w0[i] = wo * p.stride - p.pad;
  }
  // Loads of B: thread tid < 2*kBN owns 16 bytes of row tid/2 of the weight tile.
  const int b_row = (tid >> 1) % kBN, b_half = tid & 1;
  const bool b_mine = tid < 2 * kBN, b_ok = b_mine && n0 + b_row < p.O;

  float raw[kRowsA][8];  // 0 outside the image: it quantizes to the int8 zero of the padding
  float scale[8];
  uint4 b_reg;

  auto load_step = [&](int k0) {
    if (kFast) {
      const int tap = k0 / p.C, c = k0 - tap * p.C + part * 8;
      const int r = tap / p.k, s = tap - r * p.k;
#pragma unroll
      for (int j = 0; j < 8; ++j) scale[j] = p.a_scale[p.a_vec ? c + j : 0];
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) {
        const int hi = h0[i] + r, wi = w0[i] + s;
        if (row_ok[i] && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W) {
          load8(x + static_cast<size_t>(pix[i] + hi * p.W + wi) * p.C + c, raw[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) raw[i][j] = 0.0f;
        }
      }
      b_reg = b_ok ? *reinterpret_cast<const uint4*>(
                         p.w + static_cast<size_t>(n0 + b_row) * p.K + k0 + b_half * 16)
                   : make_uint4(0, 0, 0, 0);
    } else {
      int dr[8], ds[8], dc[8];
      bool k_ok[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = k0 + part * 8 + j;
        k_ok[j] = kk < p.K;
        const int tap = kk / p.C;
        dc[j] = kk - tap * p.C;
        dr[j] = tap / p.k;
        ds[j] = tap - dr[j] * p.k;
        scale[j] = p.a_scale[p.a_vec && k_ok[j] ? dc[j] : 0];
      }
#pragma unroll
      for (int i = 0; i < kRowsA; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int hi = h0[i] + dr[j], wi = w0[i] + ds[j];
          const bool ok = row_ok[i] && k_ok[j] && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
          raw[i][j] = ok ? to_float(x[static_cast<size_t>(pix[i] + hi * p.W + wi) * p.C + dc[j]])
                         : 0.0f;
        }
      }
      uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kk = k0 + b_half * 16 + j;
        if (b_ok && kk < p.K) {
          words[j >> 2] |= (static_cast<uint32_t>(
                                p.w[static_cast<size_t>(n0 + b_row) * p.K + kk]) & 0xffu)
                           << (8 * (j & 3));
        }
      }
      b_reg = make_uint4(words[0], words[1], words[2], words[3]);
    }
  };

  auto store_step = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t q = quantize(raw[i][j], scale[j]);
        if (j < 4) lo |= q << (8 * j); else hi |= q << (8 * (j - 4));
      }
      *reinterpret_cast<uint2*>(&a_smem[buf][i * (kThreads / 4) + (tid >> 2)][part * 8]) =
          make_uint2(lo, hi);
    }
    if (b_mine) *reinterpret_cast<uint4*>(&b_smem[buf][b_row][b_half * 16]) = b_reg;
  };

  // Warp tile: rows wm*16*kMI .. +16*kMI, columns wn*32 .. +32 of the block tile.
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  int32_t acc[kMI][4][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int steps = (p.K + kBK - 1) / kBK;
  load_step(0);
  store_step(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load_step((step + 1) * kBK);
    uint32_t a[kMI][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int r = (wm * kMI + mi) * 16 + g;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(&a_smem[buf][r][t * 4]);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(&a_smem[buf][r + 8][t * 4]);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(&a_smem[buf][r][16 + t * 4]);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(&a_smem[buf][r + 8][16 + t * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn * 32 + ni * 8 + g;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(&b_smem[buf][n][t * 4]);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(&b_smem[buf][n][16 + t * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(acc[mi][ni][0]), "+r"(acc[mi][ni][1]), "+r"(acc[mi][ni][2]),
              "+r"(acc[mi][ni][3])
            : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
              "r"(b[ni][0]), "r"(b[ni][1]));
    if (step + 1 < steps) store_step(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: accumulator e of tile (mi, ni) is row g (+8 for e >= 2),
  // column 2t + (e & 1) of that 16 x 8 tile.
  Tout* y = static_cast<Tout*>(p.y);
  const Tout* bias = static_cast<const Tout*>(p.bias);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + 2 * t;
    float out_scale[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nn = n + e < p.O ? n + e : 0;
      out_scale[e] = p.a_vec ? p.w_scale[nn] : __fmul_rn(p.a_scale[0], p.w_scale[nn]);
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + (wm * kMI + mi) * 16 + g + (e >= 2 ? 8 : 0);
        const int nn = n + (e & 1);
        if (m >= p.M || nn >= p.O) continue;
        const size_t i = static_cast<size_t>(m) * p.O + nn;
        store_out(y, i, epilogue(acc[mi][ni][e], out_scale[e & 1], bias, nn));
        if (p.acc != nullptr) p.acc[i] = acc[mi][ni][e];
      }
    }
  }
}

template <typename Tin, typename Tout>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + kBM - 1) / kBM, (p.O + kBN - 1) / kBN);
  if (p.C % kBK == 0) {
    int8_conv_kernel<Tin, Tout, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    int8_conv_kernel<Tin, Tout, false><<<grid, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = w8a8 conv of x (see int8_conv_kernel). x_bf16 / y_bf16: 1 for bf16,
// 0 for f32. bias may be null (else in y's type), acc may be null. Launches
// on `stream` and returns cudaGetLastError() after the launch
// (0 = cudaSuccess); -1 for an argument the kernel does not take.
int cocodet_int8_conv(const void* x, int x_bf16, const int8_t* w,
                      const float* a_scale, int a_vec, const float* w_scale,
                      const void* bias, void* y, int y_bf16, int32_t* acc,
                      int B, int H, int W, int C, int O, int k, int stride,
                      int Ho, int Wo, void* stream) {
  if (!((k == 1 || k == 3) && (stride == 1 || stride == 2)) || B <= 0 || C <= 0 || O <= 0) {
    return -1;
  }
  Params p{x, w, a_scale, w_scale, bias, y, acc, a_vec,
           B, H, W, C, O, k, stride, (k - 1) / 2, Ho, Wo, B * Ho * Wo, k * k * C};
  if (p.M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && y_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(p, s);
  if (x_bf16) return launch<__nv_bfloat16, float>(p, s);
  if (y_bf16) return launch<float, __nv_bfloat16>(p, s);
  return launch<float, float>(p, s);
}

}  // extern "C"
