// Train-mode BatchNorm fused with the activation after it, forward and
// backward, for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Built by cocodet_tpu_torch/ops/cuda/build.py (nvcc -O3 --fmad=false, no
// --use_fast_math). Every op that rounds is an explicit round-to-nearest
// intrinsic, in the order of the plain PyTorch stages in
// ops/cuda/bn_act.py, so the apply stages and the per-channel vectors equal
// their plain versions bit for bit given the same inputs.
//
// Replaces flax nn.BatchNorm(use_running_average=False, momentum=0.97,
// epsilon=1e-3, dtype) followed by jax.nn.hard_swish (or no activation),
// cocodet_tpu/models/blocks.py:403-415 and :53-54, and their VJP: on the TPU
// XLA fuses them into its own reduction and elementwise loops. The map x is
// (N, C, H, W) in channels-last memory ([N*H*W rows, C]) or contiguous NCHW
// ([N, C, H*W]); f32 or bf16; the per-channel vectors are f32.
//
// Forward, per channel over N*H*W (flax's _compute_stats and _normalize):
//   bn_act_reduce_kernel: S1 = sum x, S2 = sum x^2 (f32), then in the last
//     block: mean = S1 / n, d = S2 / n - mean^2, var = max(d, 0) (flax's fast
//     variance, not Welford: parity with JAX), inv = 1 / sqrt(var + eps)
//     computed in f64 from the f32 var + eps and rounded once (so it is the
//     correctly rounded rsqrt, and the plain version computes the same
//     bits), mul = inv * scale; the running statistics in place,
//     ra = f32(0.97) ra + f32(1 - 0.97) stat, with the biased variance.
//   bn_act_apply_kernel: z = T((x - mean) * mul + bias) (f32 arithmetic,
//     rounded to the map's type as flax's dtype cast rounds it), y = act(z)
//     with hard-swish's own rounding chain (hard_swish_ops.cuh).
// Backward, cotangent g of y:
//   bn_act_reduce_kernel: gz = T(hard_swish_vjp(z, g)), z recomputed from x;
//     A = sum gz, B = sum gz (x - mean); then the last block: the scale and
//     bias gradients B * inv and A, and the coefficients of
//     dx = gz * mul + c1 + c2 * x, the closed form of autograd's chain
//     through the formula above: du = -0.5 (B scale) inv^3, dd = du where
//     d > 0, du / 2 where d == 0 (jnp.maximum splits a tie evenly), else 0;
//     c1 = (-mul A - 2 mean dd) / n, c2 = 2 dd / n.
//   bn_act_apply_kernel: dx = T((gz * mul + c1) + c2 * x), gz recomputed.
// Nothing of the size of the map is saved between the passes: the autograd
// Function keeps x and the C-length vectors.
//
// Bound on the H100: bytes. The forward reads x twice and writes y (6 bytes
// an element in bf16), the backward reads x and g twice and writes dx (10
// bytes), at a few operations a byte. The design:
//   - channels-last: a thread owns V = 16 / sizeof(T) adjacent channels
//     (one 16-byte load) and a block a tile of channel groups times R row
//     lanes, so a thread's channels never change and their vectors (mean,
//     mul, bias, c1, c2) sit in registers; kUnroll rows are loaded before
//     any arithmetic, so several 16-byte loads are in flight a thread;
//   - the reduction: per-thread f32 partials, summed over the block's row
//     lanes in f64 in a fixed order into one partial a block and channel
//     in scratch; the last block of a channel tile (a ticket counter, left
//     at 0 for the next launch) sums the blocks' partials in f64 in a fixed
//     order, so two runs give equal bits, and computes the C-length vectors
//     itself: no per-channel op runs on the host's queue;
//   - the reduce reads with the default cache policy, so a map that fits in
//     the 50 MB L2 is read again from it by the apply;
//   - a data-parallel step sums the statistics over ranks between the two
//     kernels: the reduce then writes the sums only, and
//     bn_act_finish_kernel computes the vectors from the summed ones.
// A misaligned pointer, or C (channels-last) or H*W (NCHW) not a multiple
// of V, takes the same kernels with V = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hard_swish_ops.cuh"

// The arguments of every entry point, mirrored field for field by
// ops/cuda/bn_act.py::_Args (ctypes). At namespace scope with a name of its
// own: the extern "C" entry points take it, and a type of internal linkage
// would give them internal linkage too.
struct BnActArgs {
  const void* x;          // the map
  const void* g;          // the cotangent of y (backward)
  void* y;                // apply: y (forward) or dx (backward)
  const float* fvec;      // forward vectors [mean, d, inv, mul], 4C
  const float* bias;      // C
  const float* bvec;      // backward vectors [c1, c2, dscale, dbias], 4C
  float* partials;        // reduce: grid_x * 2C
  unsigned* counters;     // reduce: one a channel tile, 0 between launches
  float* sums;            // [S1, S2] (2C) and, forward, the count (2C + 1)
  const float* local;     // backward finish: this rank's [A, B]
  const float* weight;    // the BN scale, C
  float* running_mean;    // C, updated in place by the forward finish
  float* running_var;     // C
  const float* count;     // backward finish: the forward's count
  float* vec_out;         // the finish's vectors (fvec or bvec), 4C
  int64_t outer;          // rows (channels-last) or N (NCHW)
  int64_t inner;          // 1 (channels-last) or H*W (NCHW)
  int C;
  int dtype;              // 0 f32, 1 bf16
  int act;                // kIdentity or kHardSwish
  int backward;
  int vec;                // 16-byte loads (else one element a load)
  int nchw;
  int groups;             // channels-last: channel groups a tile
  int lanes;              // channels-last: row lanes a block
  int grid_x;
  int tiles;              // channel tiles (grid y)
  int trips;              // apply, channels-last: trips of kUnroll rows a thread
  int finish;             // reduce: the last block computes the vectors
  float eps;
  float keep;             // f32(0.97)
  float one_minus_keep;   // f32(1 - 0.97)
};

namespace {

using namespace hard_swish_ops;

// The constants were chosen by timing on the card (PERF.md). The wrapper
// reads kMinBlocks and kUnroll from cocodet_bn_act_min_blocks and
// cocodet_bn_act_unroll when it sizes a grid.
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;     // blocks an SM: caps a thread's registers at 80
constexpr int kUnroll = 2;        // 16-byte loads in flight a thread, each operand
constexpr int kFinishLoads = 8;   // values in flight a thread in the reduce's column sums
constexpr int kIdentity = 0;
constexpr int kHardSwish = 1;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements at p; V * sizeof(T) is 16 (one aligned load) or V is 1.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, T (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    v[0] = p[0];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    alignas(16) T e[V];
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_float<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  } else {
    p[0] = from_float<T>(v[0]);
  }
}

// z = T((x - mean) * mul + bias), as a float
template <typename T>
__device__ __forceinline__ float bn_z(float x, float mean, float mul, float bias) {
  return round_to(__fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias), T{});
}

template <typename T, int kAct>
__device__ __forceinline__ float forward_elem(T xe, float mean, float mul, float bias) {
  const float z = bn_z<T>(to_float(xe), mean, mul, bias);
  if constexpr (kAct == kHardSwish) return forward_op(from_float<T>(z));
  return z;
}

// gz = T(act_vjp(z, g)), as a float
template <typename T, int kAct>
__device__ __forceinline__ float grad_z(T xe, T ge, float mean, float mul, float bias) {
  if constexpr (kAct == kHardSwish) {
    const float z = bn_z<T>(to_float(xe), mean, mul, bias);
    return round_to(backward_op(from_float<T>(z), ge), T{});
  }
  return to_float(ge);
}

__device__ __forceinline__ void finish_forward(const BnActArgs& a, int c, float s1,
                                               float s2, float n) {
  const int C = a.C;
  const float mean = __fdiv_rn(s1, n);
  const float d = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;  // NaN stays NaN, as torch.maximum
  const float u = __fadd_rn(var, a.eps);
  const float inv = __double2float_rn(__drcp_rn(__dsqrt_rn(static_cast<double>(u))));
  a.vec_out[c] = mean;
  a.vec_out[C + c] = d;
  a.vec_out[2 * C + c] = inv;
  a.vec_out[3 * C + c] = __fmul_rn(inv, a.weight[c]);
  a.running_mean[c] =
      __fadd_rn(__fmul_rn(a.keep, a.running_mean[c]), __fmul_rn(a.one_minus_keep, mean));
  a.running_var[c] =
      __fadd_rn(__fmul_rn(a.keep, a.running_var[c]), __fmul_rn(a.one_minus_keep, var));
}

// A, B: the sums over every rank (c1, c2); al, bl: this rank's (the
// parameter gradients, which the step sums over ranks itself)
__device__ __forceinline__ void finish_backward(const BnActArgs& a, int c, float A,
                                                float B, float al, float bl, float n) {
  const int C = a.C;
  const float mean = a.fvec[c], d = a.fvec[C + c], inv = a.fvec[2 * C + c],
              mul = a.fvec[3 * C + c];
  const float dinv = __fmul_rn(B, a.weight[c]);
  const float du = __fmul_rn(__fmul_rn(dinv, -0.5f), __fmul_rn(__fmul_rn(inv, inv), inv));
  const float dd = d > 0.f ? du : (d == 0.f ? __fmul_rn(du, 0.5f) : 0.f);
  const float dmean = __fsub_rn(__fmul_rn(-mul, A), __fmul_rn(__fmul_rn(2.f, mean), dd));
  a.vec_out[c] = __fdiv_rn(dmean, n);
  a.vec_out[C + c] = __fdiv_rn(__fmul_rn(2.f, dd), n);
  a.vec_out[2 * C + c] = __fmul_rn(bl, inv);
  a.vec_out[3 * C + c] = al;
}

// One element's contribution to the two sums.
template <typename T, int kAct, bool kBwd>
__device__ __forceinline__ void accumulate(T xe, T ge, float mean, float mul, float bias,
                                           float& sa, float& sb) {
  if constexpr (kBwd) {
    const float gz = grad_z<T, kAct>(xe, ge, mean, mul, bias);
    sa = __fadd_rn(sa, gz);
    sb = __fadd_rn(sb, __fmul_rn(gz, __fsub_rn(to_float(xe), mean)));
  } else {
    const float x = to_float(xe);
    sa = __fadd_rn(sa, x);
    sb = __fadd_rn(sb, __fmul_rn(x, x));
  }
}

// Sums over `n` values of each of `ncols` columns, of two arrays (get(i,
// col) returns the pair), in f64 and in a fixed order, so two runs agree:
// thread t takes column t % ncols and every split-th value from t / ncols,
// kFinishLoads loads in flight; then thread col adds its column's split
// partial sums in order. Returns (for threads below ncols) its column's
// two sums. All threads of the block call it.
template <typename Get>
__device__ __forceinline__ void column_sums(int ncols, int n, Get get, double* sh_a,
                                            double* sh_b, double& out_a, double& out_b) {
  const int split = max(1, int(blockDim.x) / ncols);
  const int col = threadIdx.x % ncols, part = threadIdx.x / ncols;
  __syncthreads();  // sh_a and sh_b may hold an earlier call's values
  if (part < split) {
    double da = 0.0, db = 0.0;
    int i = part;
    for (; i + (kFinishLoads - 1) * split < n; i += kFinishLoads * split) {
      float va[kFinishLoads], vb[kFinishLoads];
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u) get(i + u * split, col, va[u], vb[u]);
#pragma unroll
      for (int u = 0; u < kFinishLoads; ++u) {
        da += va[u];
        db += vb[u];
      }
    }
    for (; i < n; i += split) {
      float va, vb;
      get(i, col, va, vb);
      da += va;
      db += vb;
    }
    sh_a[threadIdx.x] = da;
    sh_b[threadIdx.x] = db;
  }
  __syncthreads();
  out_a = out_b = 0.0;
  if (threadIdx.x < ncols) {
    for (int s = 0; s < split; ++s) {
      out_a += sh_a[s * ncols + threadIdx.x];
      out_b += sh_b[s * ncols + threadIdx.x];
    }
  }
}

// The per-channel sums (and, with a.finish, the vectors) of the map.
// Channels-last: grid (grid_x, tiles); block `groups` * `lanes` threads, a
// thread a group of V channels and every lanes-th row of the block's chunk.
// NCHW: grid (grid_x, C); a block a chunk of one channel's elements.
template <typename T, int kAct, bool kBwd, int V, bool kNCHW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_act_reduce_kernel(const BnActArgs a) {
  __shared__ float sh_a[kThreads * (16 / sizeof(T))];
  __shared__ float sh_b[kThreads * (16 / sizeof(T))];
  __shared__ double sh_da[kThreads], sh_db[kThreads];
  __shared__ bool is_last;
  const int C = a.C;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  float pa[V], pb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) pa[j] = pb[j] = 0.f;

  int cols, rows, col, lane_row, cbeg;
  if constexpr (!kNCHW) {
    const int gt = a.groups, R = a.lanes;
    const int lane = threadIdx.x % gt;
    lane_row = threadIdx.x / gt;
    const int grp = blockIdx.y * gt + lane;
    cols = gt * V;
    rows = R;
    col = lane * V;
    cbeg = blockIdx.y * gt * V;
    if (lane_row < R && grp * V < C) {
      const int c0 = grp * V;
      float mean[V], mul[V], bias[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mean[j] = kBwd ? a.fvec[c0 + j] : 0.f;
        mul[j] = kBwd ? a.fvec[3 * C + c0 + j] : 0.f;
        bias[j] = kBwd ? a.bias[c0 + j] : 0.f;
      }
      const int64_t chunk = (a.outer + gridDim.x - 1) / gridDim.x;
      const int64_t end = min64(a.outer, (blockIdx.x + 1) * chunk);
      for (int64_t r = blockIdx.x * chunk + lane_row; r < end; r += int64_t(R) * kUnroll) {
        alignas(16) T xv[kUnroll][V];
        alignas(16) T gv[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t ru = r + int64_t(u) * R;
          if (ru < end) {
            load<T, V>(x + ru * C + c0, xv[u]);
            if constexpr (kBwd) load<T, V>(g + ru * C + c0, gv[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r + int64_t(u) * R < end) {
#pragma unroll
            for (int j = 0; j < V; ++j)
              accumulate<T, kAct, kBwd>(xv[u][j], kBwd ? gv[u][j] : xv[u][j], mean[j], mul[j],
                                        bias[j], pa[j], pb[j]);
          }
        }
      }
    }
  } else {
    const int c = blockIdx.y;
    cols = 1;
    rows = blockDim.x;
    col = 0;
    lane_row = threadIdx.x;
    cbeg = c;
    const float mean = kBwd ? a.fvec[c] : 0.f, mul = kBwd ? a.fvec[3 * C + c] : 0.f,
                bias = kBwd ? a.bias[c] : 0.f;
    const int64_t per_row = a.inner / V;  // vectors in one (n, c) plane
    const int64_t nvec = a.outer * per_row;
    const int64_t chunk = (nvec + gridDim.x - 1) / gridDim.x;
    const int64_t end = min64(nvec, (blockIdx.x + 1) * chunk);
    for (int64_t q = blockIdx.x * chunk + threadIdx.x; q < end;
         q += int64_t(blockDim.x) * kUnroll) {
      alignas(16) T xv[kUnroll][V];
      alignas(16) T gv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t qu = q + int64_t(u) * blockDim.x;
        if (qu < end) {
          const int64_t off = ((qu / per_row) * C + c) * a.inner + (qu % per_row) * V;
          load<T, V>(x + off, xv[u]);
          if constexpr (kBwd) load<T, V>(g + off, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q + int64_t(u) * blockDim.x < end) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            accumulate<T, kAct, kBwd>(xv[u][j], kBwd ? gv[u][j] : xv[u][j], mean, mul, bias,
                                      pa[j], pb[j]);
        }
      }
    }
#pragma unroll
    for (int j = 1; j < V; ++j) {
      pa[0] = __fadd_rn(pa[0], pa[j]);
      pb[0] = __fadd_rn(pb[0], pb[j]);
    }
  }

  // the block's partial of each column: its row lanes summed in f64, in order
  constexpr int kHeld = kNCHW ? 1 : V;
  if (lane_row < rows) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      sh_a[lane_row * cols + col + j] = pa[j];
      sh_b[lane_row * cols + col + j] = pb[j];
    }
  }
  const int ncols = min(cols, C - cbeg);
  double da, db;
  column_sums(
      ncols, rows,
      [&](int r, int k, float& va, float& vb) {
        va = sh_a[r * cols + k];
        vb = sh_b[r * cols + k];
      },
      sh_da, sh_db, da, db);
  if (threadIdx.x < ncols) {
    a.partials[(2 * int64_t(blockIdx.x)) * C + cbeg + threadIdx.x] = __double2float_rn(da);
    a.partials[(2 * int64_t(blockIdx.x) + 1) * C + cbeg + threadIdx.x] = __double2float_rn(db);
  }

  // the last block of this channel tile sums every block's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.counters + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  column_sums(
      ncols, int(gridDim.x),
      [&](int bx, int k, float& va, float& vb) {
        const int64_t at = 2 * int64_t(bx) * C + cbeg + k;
        va = __ldcg(a.partials + at);
        vb = __ldcg(a.partials + at + C);
      },
      sh_da, sh_db, da, db);
  if (threadIdx.x < ncols) {
    const int c = cbeg + threadIdx.x;
    const float s1 = __double2float_rn(da), s2 = __double2float_rn(db);
    a.sums[c] = s1;
    a.sums[C + c] = s2;
    if (a.finish) {
      if constexpr (kBwd) {
        finish_backward(a, c, s1, s2, s1, s2, *a.count);
      } else {
        finish_forward(a, c, s1, s2, static_cast<float>(a.outer * a.inner));
      }
    }
  }
  if (threadIdx.x == 0) {
    if (!kBwd && blockIdx.y == 0) a.sums[2 * C] = static_cast<float>(a.outer * a.inner);
    a.counters[blockIdx.y] = 0u;
  }
}

// The vectors from sums that were summed over ranks: one thread a channel.
template <bool kBwd>
__global__ void __launch_bounds__(kThreads) bn_act_finish_kernel(const BnActArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const int C = a.C;
  if constexpr (kBwd) {
    finish_backward(a, c, a.sums[c], a.sums[C + c], a.local[c], a.local[C + c], *a.count);
  } else {
    finish_forward(a, c, a.sums[c], a.sums[C + c], a.sums[2 * C]);
  }
}

// y = act(bn(x)) (forward) or dx (backward). Channels-last: grid (grid_x,
// tiles) of `groups` * `lanes` threads as in the reduce, `trips` trips of
// kUnroll * lanes rows a block (a thread's per-channel vectors, read once,
// serve trips * kUnroll rows; the wrapper takes more trips only where the
// map leaves enough blocks). NCHW: kUnroll * kThreads vectors a block, the
// channel read per vector.
template <typename T, int kAct, bool kBwd, int V, bool kNCHW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_act_apply_kernel(const BnActArgs a) {
  const int C = a.C;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* y = static_cast<T*>(a.y);
  if constexpr (!kNCHW) {
    const int gt = a.groups, R = a.lanes;
    const int lane = threadIdx.x % gt, lane_row = threadIdx.x / gt;
    const int c0 = (blockIdx.y * gt + lane) * V;
    if (lane_row >= R || c0 >= C) return;
    float mean[V], mul[V], bias[V], c1[V], c2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mean[j] = a.fvec[c0 + j];
      mul[j] = a.fvec[3 * C + c0 + j];
      bias[j] = a.bias[c0 + j];
      c1[j] = kBwd ? a.bvec[c0 + j] : 0.f;
      c2[j] = kBwd ? a.bvec[C + c0 + j] : 0.f;
    }
    for (int trip = 0; trip < a.trips; ++trip) {
      const int64_t r0 = (int64_t(blockIdx.x) * a.trips + trip) * R * kUnroll + lane_row;
      if (r0 >= a.outer) break;
      alignas(16) T xv[kUnroll][V];
      alignas(16) T gv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + int64_t(u) * R;
        if (r < a.outer) {
          load<T, V>(x + r * C + c0, xv[u]);
          if constexpr (kBwd) load<T, V>(g + r * C + c0, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + int64_t(u) * R;
        if (r < a.outer) {
          float out[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if constexpr (kBwd) {
              const float gz = grad_z<T, kAct>(xv[u][j], gv[u][j], mean[j], mul[j], bias[j]);
              out[j] = __fadd_rn(__fadd_rn(__fmul_rn(gz, mul[j]), c1[j]),
                                 __fmul_rn(c2[j], to_float(xv[u][j])));
            } else {
              out[j] = forward_elem<T, kAct>(xv[u][j], mean[j], mul[j], bias[j]);
            }
          }
          store<T, V>(y + r * C + c0, out);
        }
      }
    }
  } else {
    const int64_t nvec = a.outer * C * a.inner / V;
    const int64_t q0 = int64_t(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
    alignas(16) T xv[kUnroll][V];
    alignas(16) T gv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = q0 + int64_t(u) * kThreads;
      if (q < nvec) {
        load<T, V>(x + q * V, xv[u]);
        if constexpr (kBwd) load<T, V>(g + q * V, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = q0 + int64_t(u) * kThreads;
      if (q < nvec) {
        const int c = static_cast<int>((q * V / a.inner) % C);
        const float mean = a.fvec[c], mul = a.fvec[3 * C + c], bias = a.bias[c];
        float out[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if constexpr (kBwd) {
            const float gz = grad_z<T, kAct>(xv[u][j], gv[u][j], mean, mul, bias);
            out[j] = __fadd_rn(__fadd_rn(__fmul_rn(gz, mul), a.bvec[c]),
                               __fmul_rn(a.bvec[C + c], to_float(xv[u][j])));
          } else {
            out[j] = forward_elem<T, kAct>(xv[u][j], mean, mul, bias);
          }
        }
        store<T, V>(y + q * V, out);
      }
    }
  }
}

template <typename T, int kAct, bool kBwd, int V, bool kNCHW>
int launch(const BnActArgs& a, bool reduce, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(a.grid_x), static_cast<unsigned>(a.tiles));
  const int block = kNCHW ? kThreads : a.groups * a.lanes;
  if (reduce) {
    bn_act_reduce_kernel<T, kAct, kBwd, V, kNCHW><<<grid, block, 0, s>>>(a);
  } else {
    bn_act_apply_kernel<T, kAct, kBwd, V, kNCHW><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kAct, bool kBwd>
int dispatch_layout(const BnActArgs& a, bool reduce, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (a.nchw) {
    return a.vec ? launch<T, kAct, kBwd, kV, true>(a, reduce, s)
                 : launch<T, kAct, kBwd, 1, true>(a, reduce, s);
  }
  return a.vec ? launch<T, kAct, kBwd, kV, false>(a, reduce, s)
               : launch<T, kAct, kBwd, 1, false>(a, reduce, s);
}

template <typename T>
int dispatch_type(const BnActArgs& a, bool reduce, cudaStream_t s) {
  if (!a.backward) {  // the forward's reduce reads x only: one instance
    return (reduce || a.act == kIdentity) ? dispatch_layout<T, kIdentity, false>(a, reduce, s)
                                          : dispatch_layout<T, kHardSwish, false>(a, reduce, s);
  }
  return a.act == kIdentity ? dispatch_layout<T, kIdentity, true>(a, reduce, s)
                            : dispatch_layout<T, kHardSwish, true>(a, reduce, s);
}

int dispatch(const BnActArgs* a, bool reduce, void* stream) {
  if (a == nullptr || (a->dtype != 0 && a->dtype != 1) || (a->act != kIdentity &&
                                                           a->act != kHardSwish))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->outer <= 0 || a->C <= 0 || a->inner <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? dispatch_type<float>(*a, reduce, s)
                       : dispatch_type<__nv_bfloat16>(*a, reduce, s);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = cudaSuccess). The
// wrapper (ops/cuda/bn_act.py) checks devices, types and layouts and plans
// the grid; the pointers are on the current device.
int cocodet_bn_act_reduce(const BnActArgs* a, void* stream) {
  return dispatch(a, true, stream);
}

int cocodet_bn_act_apply(const BnActArgs* a, void* stream) {
  return dispatch(a, false, stream);
}

// The rows a thread of the apply loads before any arithmetic, and the
// blocks an SM that __launch_bounds__ is built for: the wrapper sizes its
// grids by them.
int cocodet_bn_act_unroll() { return kUnroll; }

int cocodet_bn_act_min_blocks() { return kMinBlocks; }

int cocodet_bn_act_finish(const BnActArgs* a, void* stream) {
  if (a == nullptr || a->C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (a->C + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->backward) {
    bn_act_finish_kernel<true><<<blocks, kThreads, 0, s>>>(*a);
  } else {
    bn_act_finish_kernel<false><<<blocks, kThreads, 0, s>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
