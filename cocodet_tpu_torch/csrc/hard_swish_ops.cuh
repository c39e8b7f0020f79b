// The element arithmetic of jax.nn.hard_swish and its VJP, shared by
// hard_swish.cu (the standalone kernel) and bn_act.cu (hard-swish fused into
// train-mode BatchNorm), so the two round alike. The roundings are those of
// XLA:CPU under jax.jit (jax 0.9.0); hard_swish.cu's header gives them in
// full, and ops/cuda/hard_swish.py::hard_swish_plain, hard_swish_grad_plain
// are the plain versions. Every op is an explicit round-to-nearest
// intrinsic, so nothing depends on nvcc's contraction flags.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hard_swish_ops {

constexpr float kSixth = 0x1.555556p-3f;  // f32(1/6), 0x3e2aaaab

__device__ __forceinline__ float clamp06(float t) {
  const float c = t < 0.f ? 0.f : t;  // NaN stays NaN
  return c > 6.f ? 6.f : c;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// float value of an element, and an f32 result rounded to the element type
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) { return round_bf16(v); }

// hard_swish(x); for bf16 the result is rounded to bf16 by the caller's store.
__device__ __forceinline__ float forward_op(float x) {
  return __fmul_rn(x, __fmul_rn(clamp06(__fadd_rn(x, 3.f)), kSixth));
}

__device__ __forceinline__ float forward_op(__nv_bfloat16 xb) {
  const float x = __bfloat162float(xb);
  const float t = round_bf16(__fadd_rn(x, 3.f));
  const float h = round_bf16(__fmul_rn(clamp06(t), kSixth));
  return __fmul_rn(x, h);
}

// The VJP at x with cotangent g; for bf16 rounded to bf16 by the caller.
__device__ __forceinline__ float backward_op(float x, float g) {
  const float t = __fadd_rn(x, 3.f);
  const float h = __fmul_rn(clamp06(t), kSixth);
  const float s = (t > 0.f && t < 6.f) ? __fmul_rn(__fmul_rn(x, g), kSixth) : 0.f;
  return __fmaf_rn(g, h, s);
}

__device__ __forceinline__ float backward_op(__nv_bfloat16 xb, __nv_bfloat16 gb) {
  const float x = __bfloat162float(xb), g = __bfloat162float(gb);
  const float t = round_bf16(__fadd_rn(x, 3.f));
  const float h = round_bf16(__fmul_rn(clamp06(t), kSixth));
  const float a = round_bf16(__fmul_rn(g, h));
  const float s = (t > 0.f && t < 6.f)
                      ? round_bf16(__fmul_rn(round_bf16(__fmul_rn(x, g)), kSixth))
                      : 0.f;
  return __fadd_rn(a, s);
}

}  // namespace hard_swish_ops
