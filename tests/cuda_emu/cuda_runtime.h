// A CPU stand-in for the subset of CUDA that cocodet_tpu_torch/csrc/
// train_aug.cu's, fake_quant.cu's, bn_act.cu's and soft_nms.cu's kernels
// use, so that g++ can compile them and the tests can run them on the CPU
// (tests/torch_cuda_emu.py): a block is 256 std::threads that meet at a
// barrier, a warp's 32 of them at each warp-level call; shared memory is one buffer (blocks run one after another), or
// for bn_act.cu's resident kernel one a CTA (emu_dynamic_smem; the CTAs of a
// cluster run at once, cooperative_groups.h); cp.async is a plain copy; the
// f32 and f64 intrinsics are IEEE operations (compile with
// -ffp-contract=off). Not a model of the card's timing or of its memory
// ordering beyond what the barriers give.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
struct alignas(8) int2 {
  int x, y;
};
inline int2 make_int2(int a, int b) { return {a, b}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
int cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }

extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__
extern uint8_t smem[];

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline double __drcp_rn(double a) { return 1.0 / a; }
inline float __double2float_rn(double a) { return static_cast<float>(a); }
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p += v;
  return old;
}
inline void __threadfence() {}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<uint64_t>(a) * b) >> 32);
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint8_t b[8];
  for (int i = 0; i < 4; ++i) b[i] = (x >> (8 * i)) & 255, b[4 + i] = (y >> (8 * i)) & 255;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= static_cast<uint32_t>(b[(s >> (4 * i)) & 7]) << (8 * i);
  return r;
}
inline uint32_t __vhaddu4(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= ((((a >> (8 * i)) & 255) + ((b >> (8 * i)) & 255)) >> 1) << (8 * i);
  return r;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
void __syncthreads();
int __syncthreads_count(int pred);
void __syncwarp();
double __shfl_xor_sync(unsigned mask, double v, int lane_mask);
unsigned __ballot_sync(unsigned mask, int pred);
uint8_t* emu_dynamic_smem();
