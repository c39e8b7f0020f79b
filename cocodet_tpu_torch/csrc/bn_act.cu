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
//   bn_act_apply_kernel: dx = T((gz * mul + c1) + c2 * x), gz recomputed,
//     or (channels-last, a.gz) read back where the reduce wrote it.
// The resident kernel computes the same, with the same roundings: its sums
// in another order (so within a tolerance of the reduce's), its vectors from
// them and y or dx from those by the same functions. Nothing of the size of
// the map is saved between the passes: the autograd Function keeps x and
// the C-length vectors.
//
// Bound on the H100: bytes, at a few operations a byte. A map needs x read
// once and y written (4 bytes an element in bf16), backward x and g read
// and dx written (6). Two designs:
//   - bn_act_resident_kernel, one launch a map each way, for a channels-
//     last map whose channel tile (16 or 32 bytes of a row), over every row,
//     fits the shared memory of a thread-block cluster of up to 16 CTAs
//     (ops/cuda/bn_act.py::resident_plan): each CTA copies its chunk of the
//     rows into shared memory once (cp.async), sums it, the cluster adds its
//     CTAs' partials through distributed shared memory, and each CTA writes
//     y or dx from its copy. The map is read once; nothing of its size, and
//     no partial, goes through device memory between the reduce and the
//     apply. The kernel's comment has the steps.
//   - bn_act_reduce_kernel then bn_act_apply_kernel, for the other maps
//     (the largest: the stem and the 160x160 maps of a 640 px step), NCHW
//     maps and the data-parallel path. The forward reads x twice and writes
//     y (6 bytes an element in bf16), the backward reads x and g twice and
//     writes dx (10 bytes).
// The two-pass design:
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
// of V, takes the two-pass kernels with V = 1.

#include <cooperative_groups.h>
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
  void* gz;               // backward, channels-last, or null: the reduce writes gz, the
                          // apply reads it in place of g (no second VJP)
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
// The resident kernel: threads a CTA (16 warps: an SM holds one CTA of a
// large slab), the widest tile (32 bytes of a row), rows a thread's cp.async
// group, and the scratch at the start of its dynamic shared memory (the
// warps' and the CTA's f64 partials of two sums, two f32 vectors), before
// the slab.
constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;
constexpr int kResMaxTile = 16;
constexpr int kResStage = 4;
constexpr int kResScratch = (2 * kResWarps + 2) * kResMaxTile * 8 + 2 * kResMaxTile * 4;
static_assert(kResScratch % 16 == 0, "the slab starts 16-byte aligned");

namespace cg = cooperative_groups;

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

// The forward's per-channel values from the sums: mean, d = E[x^2] - mean^2,
// var = max(d, 0), inv = 1 / sqrt(var + eps) (f64, rounded once), mul.
struct FwdVec {
  float mean, d, var, inv, mul;
};

__device__ __forceinline__ FwdVec forward_vectors(const BnActArgs& a, int c, float s1, float s2,
                                                  float n) {
  FwdVec v;
  v.mean = __fdiv_rn(s1, n);
  v.d = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(v.mean, v.mean));
  v.var = v.d < 0.f ? 0.f : v.d;  // NaN stays NaN, as torch.maximum
  const float u = __fadd_rn(v.var, a.eps);
  v.inv = __double2float_rn(__drcp_rn(__dsqrt_rn(static_cast<double>(u))));
  v.mul = __fmul_rn(v.inv, a.weight[c]);
  return v;
}

// fvec and the running statistics of channel c
__device__ __forceinline__ void write_forward(const BnActArgs& a, int c, const FwdVec& v) {
  const int C = a.C;
  a.vec_out[c] = v.mean;
  a.vec_out[C + c] = v.d;
  a.vec_out[2 * C + c] = v.inv;
  a.vec_out[3 * C + c] = v.mul;
  a.running_mean[c] =
      __fadd_rn(__fmul_rn(a.keep, a.running_mean[c]), __fmul_rn(a.one_minus_keep, v.mean));
  a.running_var[c] =
      __fadd_rn(__fmul_rn(a.keep, a.running_var[c]), __fmul_rn(a.one_minus_keep, v.var));
}

__device__ __forceinline__ void finish_forward(const BnActArgs& a, int c, float s1,
                                               float s2, float n) {
  write_forward(a, c, forward_vectors(a, c, s1, s2, n));
}

// The backward's per-channel values: dx = gz * mul + c1 + c2 * x, and the
// scale and bias gradients. A, B: the sums over every rank (c1, c2); al,
// bl: this rank's (the parameter gradients, which the step sums over ranks
// itself)
struct BwdVec {
  float c1, c2, dscale, dbias;
};

__device__ __forceinline__ BwdVec backward_vectors(const BnActArgs& a, int c, float A, float B,
                                                   float al, float bl, float n) {
  const int C = a.C;
  const float mean = a.fvec[c], d = a.fvec[C + c], inv = a.fvec[2 * C + c],
              mul = a.fvec[3 * C + c];
  const float dinv = __fmul_rn(B, a.weight[c]);
  const float du = __fmul_rn(__fmul_rn(dinv, -0.5f), __fmul_rn(__fmul_rn(inv, inv), inv));
  const float dd = d > 0.f ? du : (d == 0.f ? __fmul_rn(du, 0.5f) : 0.f);
  const float dmean = __fsub_rn(__fmul_rn(-mul, A), __fmul_rn(__fmul_rn(2.f, mean), dd));
  return {__fdiv_rn(dmean, n), __fdiv_rn(__fmul_rn(2.f, dd), n), __fmul_rn(bl, inv), al};
}

__device__ __forceinline__ void write_backward(const BnActArgs& a, int c, const BwdVec& v) {
  const int C = a.C;
  a.vec_out[c] = v.c1;
  a.vec_out[C + c] = v.c2;
  a.vec_out[2 * C + c] = v.dscale;
  a.vec_out[3 * C + c] = v.dbias;
}

__device__ __forceinline__ void finish_backward(const BnActArgs& a, int c, float A,
                                                float B, float al, float bl, float n) {
  write_backward(a, c, backward_vectors(a, c, A, B, al, bl, n));
}

// One element's contribution to the two sums; backward, returns gz.
template <typename T, int kAct, bool kBwd>
__device__ __forceinline__ float accumulate(T xe, T ge, float mean, float mul, float bias,
                                            float& sa, float& sb) {
  if constexpr (kBwd) {
    const float gz = grad_z<T, kAct>(xe, ge, mean, mul, bias);
    sa = __fadd_rn(sa, gz);
    sb = __fadd_rn(sb, __fmul_rn(gz, __fsub_rn(to_float(xe), mean)));
    return gz;
  } else {
    const float x = to_float(xe);
    sa = __fadd_rn(sa, x);
    sb = __fadd_rn(sb, __fmul_rn(x, x));
    return 0.f;
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
template <typename T, int kAct, bool kBwd, int V, bool kNCHW, bool kGz>
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
          const int64_t ru = r + int64_t(u) * R;
          if (ru < end) {
            float gz[V];
#pragma unroll
            for (int j = 0; j < V; ++j)
              gz[j] = accumulate<T, kAct, kBwd>(xv[u][j], kBwd ? gv[u][j] : xv[u][j], mean[j],
                                                mul[j], bias[j], pa[j], pb[j]);
            if constexpr (kGz) store<T, V>(static_cast<T*>(a.gz) + ru * C + c0, gz);
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
template <typename T, int kAct, bool kBwd, int V, bool kNCHW, bool kGz>
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
          if constexpr (kBwd)
            load<T, V>((kGz ? static_cast<const T*>(a.gz) : g) + r * C + c0, gv[u]);
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
              const float gz = kGz ? to_float(gv[u][j])  // the reduce's gz
                                   : grad_z<T, kAct>(xv[u][j], gv[u][j], mean[j], mul[j], bias[j]);
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

// ---------------------------------------------------------------------------
// The resident kernel: a map's forward or backward in one launch.

// 16-byte copies from device memory to shared memory that bypass the
// registers (cp.async, cached in L2 only); a thread's copies form groups,
// and it waits for its own.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's groups are pending (n above 7 waits
// for all but 7).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ uint8_t* resident_smem() {
  extern __shared__ __align__(16) uint8_t bn_act_resident_smem[];
  return bn_act_resident_smem;
}

template <typename T, int V>
__device__ __forceinline__ void load_shared(const T* p, T (&v)[V]) {
  *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store_shared(T* p, const T (&v)[V]) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
}

// The map's forward (kBwd false: sums, vectors, running statistics and y)
// or backward (sums, vectors and dx) in one launch, for a channels-last map
// whose channel tile, over every row, fits the shared memory of a cluster.
// Grid (cluster size, tiles) in clusters of (cluster size, 1, 1): a cluster
// a tile of a.groups * V channels (a.groups 1 or 2: 16 or 32 bytes of a
// row), each of its CTAs an even chunk of the rows, a thread a group of V
// channels and every lanes-th row of the chunk. The CTA copies its chunk's
// slab (x, and g backward) into shared memory once, by cp.async, in groups
// of kResStage rows a thread, and sums each group as it lands (f32 a
// thread, as the two-pass reduce; backward, gz, computed once, replaces g
// in the slab); the threads' sums in f64 over the warp by
// a butterfly, then over the warps in order, into the CTA's partial in its
// shared memory; a cluster barrier; every CTA then adds the cluster's
// partials through distributed shared memory in rank order, so each holds
// the same bits, and computes the tile's vectors with the finish's own
// arithmetic (rank 0 writes them, the sums and the running statistics); a
// second cluster barrier (no CTA leaves while another reads its partial);
// then y or dx from the slab in shared memory, 16-byte stores. The map is
// read from device memory once and nothing goes through global scratch.
template <typename T, int kAct, bool kBwd>
__global__ void __launch_bounds__(kResThreads, 1) bn_act_resident_kernel(const BnActArgs a) {
  constexpr int V = 16 / sizeof(T);
  uint8_t* smem = resident_smem();
  double* w_a = reinterpret_cast<double*>(smem);  // [warp][channel of the tile]
  double* w_b = w_a + kResWarps * kResMaxTile;
  double* c_a = w_b + kResWarps * kResMaxTile;     // the CTA's partials, read by the cluster
  double* c_b = c_a + kResMaxTile;
  float* v_a = reinterpret_cast<float*>(c_b + kResMaxTile);  // mean, or c1
  float* v_b = v_a + kResMaxTile;                            // mul, or c2
  T* xs = reinterpret_cast<T*>(smem + kResScratch);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int C = a.C, gt = a.groups, tc = gt * V;
  const int grp = threadIdx.x % gt, lane = threadIdx.x / gt, lanes = kResThreads / gt;
  const int cbeg = blockIdx.y * tc, c0 = cbeg + grp * V;
  const int64_t chunk = (a.outer + ranks - 1) / ranks;
  const int64_t r0 = min64(a.outer, rank * chunk);
  const int64_t nrow = min64(a.outer, r0 + chunk) - r0;
  T* xs_me = xs + grp * V;
  T* gs_me = xs + chunk * tc + grp * V;
  // this thread's rows of the chunk: lane, lane + lanes, ...
  const int mine = (c0 < C && lane < nrow) ? static_cast<int>((nrow - 1 - lane) / lanes) + 1 : 0;

  {
    const T* x = static_cast<const T*>(a.x) + r0 * C + c0;
    const T* g = static_cast<const T*>(a.g) + r0 * C + c0;
    for (int i = 0; i < mine; ++i) {
      const int64_t r = lane + int64_t(i) * lanes;
      cp_async16(xs_me + r * tc, x + r * C);
      if constexpr (kBwd) cp_async16(gs_me + r * tc, g + r * C);
      if (i % kResStage == kResStage - 1) cp_async_commit();
    }
    cp_async_commit();
  }
  const int pending = mine / kResStage;  // groups after the first

  float mean[V], mul[V], bias[V], pa[V], pb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool held = kBwd && c0 < C;
    mean[j] = held ? a.fvec[c0 + j] : 0.f;
    mul[j] = held ? a.fvec[3 * C + c0 + j] : 0.f;
    bias[j] = held ? a.bias[c0 + j] : 0.f;
    pa[j] = pb[j] = 0.f;
  }
  for (int i = 0; i < mine; ++i) {
    if (i % kResStage == 0) cp_async_wait(pending - i / kResStage);
    const int64_t r = lane + int64_t(i) * lanes;
    alignas(16) T xv[V];
    load_shared<T, V>(xs_me + r * tc, xv);
    if constexpr (kBwd) {
      // gz, a value of T, takes g's place in the slab: the apply reads it
      // back instead of computing the activation's VJP a second time
      alignas(16) T gv[V];
      load_shared<T, V>(gs_me + r * tc, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gz = grad_z<T, kAct>(xv[j], gv[j], mean[j], mul[j], bias[j]);
        pa[j] = __fadd_rn(pa[j], gz);
        pb[j] = __fadd_rn(pb[j], __fmul_rn(gz, __fsub_rn(to_float(xv[j]), mean[j])));
        gv[j] = from_float<T>(gz);
      }
      store_shared<T, V>(gs_me + r * tc, gv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        accumulate<T, kAct, false>(xv[j], xv[j], 0.f, 0.f, 0.f, pa[j], pb[j]);
    }
  }

  // the CTA's partial of each channel of the tile
  double da[V], db[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    da[j] = pa[j];
    db[j] = pb[j];
  }
  for (int off = gt; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      da[j] += __shfl_xor_sync(0xffffffffu, da[j], off);
      db[j] += __shfl_xor_sync(0xffffffffu, db[j], off);
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < gt) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      w_a[warp * tc + grp * V + j] = da[j];
      w_b[warp * tc + grp * V + j] = db[j];
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < tc) {
    double sa = 0.0, sb = 0.0;
    for (int w = 0; w < kResWarps; ++w) {
      sa += w_a[w * tc + t];
      sb += w_b[w * tc + t];
    }
    c_a[t] = sa;
    c_b[t] = sb;
  }
  cluster.sync();

  // the tile's sums over the cluster, and its vectors
  const int c = cbeg + t;
  if (t < tc && c < C) {
    double sa = 0.0, sb = 0.0;
    for (int q = 0; q < ranks; ++q) {
      sa += cluster.map_shared_rank(c_a, q)[t];
      sb += cluster.map_shared_rank(c_b, q)[t];
    }
    const float s1 = __double2float_rn(sa), s2 = __double2float_rn(sb);
    if constexpr (kBwd) {
      const BwdVec v = backward_vectors(a, c, s1, s2, s1, s2, *a.count);
      v_a[t] = v.c1;
      v_b[t] = v.c2;
      if (rank == 0) write_backward(a, c, v);
    } else {
      const FwdVec v = forward_vectors(a, c, s1, s2, static_cast<float>(a.outer));
      v_a[t] = v.mean;
      v_b[t] = v.mul;
      if (rank == 0) write_forward(a, c, v);
    }
    if (rank == 0) {
      a.sums[c] = s1;
      a.sums[C + c] = s2;
    }
  }
  if (!kBwd && rank == 0 && blockIdx.y == 0 && t == 0)
    a.sums[2 * C] = static_cast<float>(a.outer);
  cluster.sync();

  if (c0 >= C) return;
  // the tile's vectors: mean and mul forward (with the bias), c1 and c2
  // backward (mul as the reduce read it)
  float va[V], vb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    va[j] = v_a[grp * V + j];
    vb[j] = v_b[grp * V + j];
    if constexpr (!kBwd) bias[j] = a.bias[c0 + j];
  }
  T* y = static_cast<T*>(a.y) + r0 * C + c0;
  for (int i = 0; i < mine; ++i) {
    const int64_t r = lane + int64_t(i) * lanes;
    alignas(16) T xv[V];
    alignas(16) T gv[V];
    load_shared<T, V>(xs_me + r * tc, xv);
    if constexpr (kBwd) load_shared<T, V>(gs_me + r * tc, gv);
    float out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (kBwd) {
        const float gz = to_float(gv[j]);  // the reduce's gz
        out[j] = __fadd_rn(__fadd_rn(__fmul_rn(gz, mul[j]), va[j]),
                           __fmul_rn(vb[j], to_float(xv[j])));
      } else {
        out[j] = forward_elem<T, kAct>(xv[j], va[j], vb[j], bias[j]);
      }
    }
    store<T, V>(y + r * C, out);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Launchers (host code).

namespace {

template <typename T, int kAct, bool kBwd, int V, bool kNCHW, bool kGz>
int launch(const BnActArgs& a, bool reduce, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(a.grid_x), static_cast<unsigned>(a.tiles));
  const int block = kNCHW ? kThreads : a.groups * a.lanes;
  if (reduce) {
    bn_act_reduce_kernel<T, kAct, kBwd, V, kNCHW, kGz><<<grid, block, 0, s>>>(a);
  } else {
    bn_act_apply_kernel<T, kAct, kBwd, V, kNCHW, kGz><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kAct, bool kBwd>
int dispatch_layout(const BnActArgs& a, bool reduce, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (a.nchw) {
    return a.vec ? launch<T, kAct, kBwd, kV, true, false>(a, reduce, s)
                 : launch<T, kAct, kBwd, 1, true, false>(a, reduce, s);
  }
  if (kBwd && a.gz != nullptr) {
    return a.vec ? launch<T, kAct, kBwd, kV, false, kBwd>(a, reduce, s)
                 : launch<T, kAct, kBwd, 1, false, kBwd>(a, reduce, s);
  }
  return a.vec ? launch<T, kAct, kBwd, kV, false, false>(a, reduce, s)
               : launch<T, kAct, kBwd, 1, false, false>(a, reduce, s);
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
  if (a->gz != nullptr && (a->nchw || !a->backward))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->outer <= 0 || a->C <= 0 || a->inner <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? dispatch_type<float>(*a, reduce, s)
                       : dispatch_type<__nv_bfloat16>(*a, reduce, s);
}

// The dynamic shared memory of a resident launch: the scratch, then the
// slab (x, and g backward) of a CTA's chunk of rows.
int64_t resident_smem_bytes(const BnActArgs& a, int elem) {
  const int64_t chunk = (a.outer + a.grid_x - 1) / a.grid_x;
  return kResScratch + chunk * a.groups * 16 * (a.backward ? 2 : 1);
}

// Launch the resident kernel, or (clusters non-null) ask how many of its
// clusters the card can hold at once with this plan's shared memory.
template <typename T, int kAct, bool kBwd>
int launch_resident(const BnActArgs& a, cudaStream_t s, int* clusters) {
  auto kernel = bn_act_resident_kernel<T, kAct, kBwd>;
  static int ready[64] = {};  // the kernel's attributes set on this device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static int optin[64] = {};
  if (!ready[dev]) {
    e = cudaDeviceGetAttribute(optin + dev, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin[dev]);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = 1;
  }
  const int64_t smem = resident_smem_bytes(a, sizeof(T));
  if (smem > optin[dev]) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.grid_x), static_cast<unsigned>(a.tiles), 1);
  cfg.blockDim = dim3(kResThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.grid_x);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) {
    // a query the card refuses (a cluster too large) answers 0 clusters;
    // cudaGetLastError() takes its error away from the next launch's check
    e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    cudaGetLastError();
    if (e != cudaSuccess) *clusters = 0;
    return 0;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int resident_type(const BnActArgs& a, cudaStream_t s, int* clusters) {
  if (!a.backward) {
    return a.act == kIdentity ? launch_resident<T, kIdentity, false>(a, s, clusters)
                              : launch_resident<T, kHardSwish, false>(a, s, clusters);
  }
  return a.act == kIdentity ? launch_resident<T, kIdentity, true>(a, s, clusters)
                            : launch_resident<T, kHardSwish, true>(a, s, clusters);
}

int resident(const BnActArgs* a, void* stream, int* clusters) {
  if (a == nullptr || (a->dtype != 0 && a->dtype != 1) ||
      (a->act != kIdentity && a->act != kHardSwish) || a->nchw || !a->vec ||
      (a->groups != 1 && a->groups != 2) || a->grid_x < 1 || a->grid_x > 16 || a->tiles < 1 ||
      a->outer <= 0 || a->inner != 1 || a->C <= 0 ||
      int64_t(a->tiles) * a->groups * (a->dtype == 0 ? 4 : 8) < a->C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 0 ? resident_type<float>(*a, s, clusters)
                       : resident_type<__nv_bfloat16>(*a, s, clusters);
}

}  // namespace

extern "C" {

// The resident kernel (one launch a map and direction); the wrapper plans
// a.groups (channel groups a tile), a.grid_x (CTAs a cluster) and a.tiles.
int cocodet_bn_act_resident(const BnActArgs* a, void* stream) {
  return resident(a, stream, nullptr);
}

// How many clusters of plan `a` the card holds at once (0: it cannot
// launch); returns a CUDA error where the arguments are refused.
int cocodet_bn_act_resident_clusters(const BnActArgs* a, int* clusters) {
  *clusters = 0;
  return resident(a, nullptr, clusters);
}

// The bytes of the resident kernel's shared memory before its slab: the
// wrapper plans slabs against the card's shared memory less these.
int cocodet_bn_act_resident_scratch() { return kResScratch; }

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
