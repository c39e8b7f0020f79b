// Int8 convolution for NVIDIA Hopper (sm_90a), bound to Python with ctypes:
// the w8a8 conv with the activation quantize fused on its input and the
// rescale, bias and (optionally) hard-swish fused on its output.
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
//     y   = hard_swish(y)                               (when the caller asks)
//   with out_scale = w_scale if a_scale is a (C,) vector, else
//   a_scale * w_scale. Padding is int8 zero (JAX quantizes, then pads).
//   hard_swish is ops/cuda/hard_swish.py::hard_swish_plain in the output type: in f32
//   x * (clamp(x + 3, 0, 6) * f32(1/6)), in bf16 x * (clamp(x + 3, 0, 6) / 6)
//   with every op rounded to bf16.
//   Takes groups=1, dilation=1, a square kernel of 1, 3 or 6, stride 1 or 2,
//   and a padding in H and one in W, each below k (pad_h = 0 for a height
//   slab that carries its halo rows); x (B, H, W, C) NHWC in f32 or bf16
//   with C * the element size a multiple of 16 and C a multiple of 16 or at
//   most 32, or C below 16 packed (below); w (O, k, k, C) int8, whose taps
//   may lie w_ld >= C channels apart (one part's slice of a wider kernel);
//   y (B, Ho, Wo, O) NHWC in f32 or bf16.
//   Split-concat parts (cocodet_tpu/models/blocks.py:258-276): the conv of
//   the channel concat of parts is the sum of each part's s32 conv with its
//   slice of the kernel, an up2x part's (1x1, stride 1) taken at its own
//   resolution and read at (h >> 1, w >> 1). A part's launch adds the s32
//   sums of the launches before it (acc_in, read at (h >> up, w >> up)) to
//   its own; every launch but the last writes that sum (partial: the s32
//   buffer, no epilogue), the last applies the epilogue once. Integer sums
//   are exact, so this is bit for bit the concat graph.
//   A small C whose pixels are not 16-byte rows (the 6x6 stem's 3 channels
//   of f32 or bf16) arrives packed: the TMA box reads each patch row as
//   rowb contiguous elements of the (B, H, W * C) view of x, from the
//   16-byte boundary at or before the patch's first column (a box whose
//   inner start is not 16-byte aligned faults), so no channel-padded copy is
//   made: a copy would add two launches and write 4/3 (f32) or 8/3 (bf16)
//   of the stem's input again before the kernel read it, where the packed
//   box reads it once. The consumers quantize it with zeros past C, and copy
//   its weights with zeros past C as they do the Focus stem's (below).
//   Bound on the H100: bytes. At a batch of 16 640 px images the 127 int8
//   convs of the slim YOLOX-M-P6 do 481 G int8 operations (0.24 ms at 1979
//   TOP/s) on 2.92 GB of activations and weights, each read or written once
//   (0.87 ms at 3.35 TB/s; chip_smoke.py phase e counts both).
//   Design, an implicit GEMM (M = output pixels, N = O, K = k*k*C):
//   - A block owns a patch of 8 * MB x 8 output pixels of one image (MB
//     wgmma M tiles of 8 x 8) and a slice of n <= 192 output channels (the
//     wrapper's tile plan, ops/cuda/int8_conv.py::tile_plan), and walks C in
//     chunks of 32 channels. For each chunk the input halo patch,
//     ((8 * MB - 1) * s + k) x (7 * s + k) pixels of 32 channels, arrives by
//     one TMA load (tiled, on the NHWC tensor: coordinates outside the
//     image, negative ones included, and channels past C fill 0.0, which
//     quantizes to the int8 zero of the padding). The consumer threads
//     quantize it once into an int8 copy in shared memory: each activation
//     is read from device memory and divided once per block (1.55x the
//     elements the headline's convs read, against 5.4x for a tile of 32
//     pixels that loaded and divided them again for every tap).
//   - The int8 copy is laid out as 16-byte rows of 16 channels, [channel
//     half][patch row][patch column][16 bytes], with the columns of a
//     stride-2 conv stored even ones first. A tap's operand for 8 x 8 output
//     pixels is then a shifted window of that copy whose 8 pixels of an
//     output row are 8 consecutive 16-byte rows: a no-swizzle K-major core
//     matrix. So every tap is one wgmma descriptor into the same copy, with
//     no data moved.
//   - wgmma.m64n(32 * NW)k32 s8 x s8 -> s32 (exact) on the tensor cores, A
//     and B from shared memory. Two consumer warpgroups split the block's M
//     tiles (a slice of at most 96 columns) or its columns (128 or 192). The
//     weights of one (tap, chunk) arrive as one TMA box of 32-byte rows in
//     the 32-byte swizzle, through a ring of 9 slices on mbarriers, fed by
//     one producer warp that also keeps up to 4 halo patches in flight. The
//     products of a chunk run on while the threads quantize the next one
//     into another of three int8 copies.
//   - C not a multiple of 16 (the Focus stem's 12) takes no other activation
//     path: the chunk is 12 channels and 20 zeros. Only its weights, which a
//     TMA box cannot cut at 12 bytes, are copied by the consumer threads,
//     with zeros past C, every tap's slice at once (36 for the 6x6 stem), as
//     4-byte words or, where the rows do not align to them (3 channels), as
//     bytes.
//   - The epilogue rounds exactly as the plain version and applies
//     hard-swish when asked, with no branch in its unrolled code, then
//     stages a warpgroup's outputs in shared memory for one TMA store (whole
//     lines; stores from the registers wrote half sectors). The s32
//     accumulators (a debug output) are written from registers.
//   Two blocks an SM hide each other's latencies; the time goes to the
//   quantize (an IEEE division per element), the products and the epilogue
//   in about equal parts, not to device memory.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 8;               // output columns of a block; rows: 8 * MB
constexpr int kWarpgroups = 2;          // consumers
constexpr int kChunk = 32;              // input channels a step
constexpr int kMaxN = 256;              // output channels of a block
constexpr int kBStages = 9;             // ring of weight slices: a 3x3 chunk's taps
constexpr int kMaxRawStages = 4;        // ring of halo patches
constexpr int kInFlight = 2;            // wgmma groups (taps) a warpgroup keeps in flight
constexpr int kABufs = kInFlight + 1;   // ring of int8 copies
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup (one warp works)
// Two blocks an SM: 80 registers a thread at launch; setmaxnreg moves the
// producer warpgroup's to the consumers (128 * 24 + 256 * 104 <= 384 * 80),
// without which they spill. A consumer thread holds 48 accumulators, or 64
// with a few spills where that measured faster.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 104;
constexpr int kSmemLimit = 232448;      // H100: the most shared memory a block may take
constexpr int kSmemPerSM = 233472;      // ... and an SM, of which 1 KB a block is reserved
constexpr uint32_t kBarBytes = 256;     // the mbarriers
constexpr uint32_t kTabBytes = 2 * kMaxN * 4;  // out_scale and bias (f32) of the block's N

struct Params {
  const void* x;
  const int8_t* w;
  const float* a_scale;
  const float* w_scale;
  const void* bias;  // nullptr: no bias (else in y's type)
  void* y;
  int32_t* acc;      // nullptr, or the s32 accumulators (B, Ho, Wo, O)
  const int32_t* acc_in;  // nullptr, or the s32 sums of the parts before (B, Ho >> up, Wo >> up, O)
  int up;            // acc_in is at half the resolution (an up2x part's)
  int partial;       // write acc_in + this conv to acc, no epilogue (not the last part)
  int a_vec;         // a_scale is a (C,) vector (else a scalar)
  int x_bf16, y_bf16, act, w_tma, w_bytes, y_tma;
  int packed;        // the halo patch is [row][rowb] elements (C below 16, see the header)
  int C, O, k, stride, pad_h, pad_w, Ho, Wo;
  int w_ld, w_row;   // weight channels between taps, and between output channels
  int b_stages;      // weight slices in shared memory: the ring of kBStages (TMA), or every tap
  int n;             // output channels of a block
  int tiles_w, tiles_h;
  int ph, pw, pwh;   // halo patch rows and columns; even columns (stride 2)
  int rowb;          // elements of a packed patch row as TMA writes it (>= pw * C + 16 bytes)
  int chunks, taps, raw_stages;
  uint32_t raw_tx;                       // bytes of a halo patch
  uint32_t raw_bytes, a_bytes, b_bytes;  // one buffer of each (raw: padded)
  uint32_t off_raw, off_a, off_b;        // byte offsets in shared memory
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma, named barriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the phase of the barrier with this parity has completed. The
// loop is inside one asm statement, so the compiler sees no divergent branch
// between the wgmma of a warpgroup. A copy that never lands fails the launch
// (a trap after ~2^24 polls) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      ".reg .u32 polls;\n"
      "mov.u32 polls, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.lt.u32 P1, polls, 16777216;\n"
      "@P1 bra.uni WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival for the warp, by lane 0: 256 arrivals on one barrier would
// serialize on its shared-memory word. A predicate inside the asm, not a
// branch, so the compiler sees no divergent path near the wgmma. The caller
// makes the warp's lanes converge first.
__device__ __forceinline__ void mbar_arrive_warp(uint32_t bar, int lane) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "setp.eq.u32 P1, %1, 0;\n"
      "@P1 mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A TMA store of a box from shared memory, in the thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor of a K-major operand with no swizzle
// (core matrices of 8 rows of 16 contiguous bytes): lbo = the byte stride
// between the two 16-byte halves of K, sbo = the byte stride between groups
// of 8 rows.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// ... of a K-major operand in the 32-byte swizzle (rows of 32 contiguous
// bytes, the 16-byte halves of row r swapped when bit 2 of r is set, as a
// TMA load with CU_TENSOR_MAP_SWIZZLE_32B writes them): groups of 8 rows
// 256 bytes apart, from a 256-byte aligned address.
__device__ __forceinline__ uint64_t gmma_desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (1ull << 16) | (16ull << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Pins the accumulators: register reads after a wgmma wait stay after it.
__device__ __forceinline__ void fence_regs(int32_t (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32, s8) * B (32 x 32 * NW, s8), both from shared memory: one
// wgmma.m64n(32 * NW)k32, so A is read once for all N columns. d holds the
// 16 * NW accumulators of a thread.
template <int NW>
__device__ __forceinline__ void wgmma_s8(int32_t* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<1>(int32_t* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<2>(int32_t* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<3>(int32_t* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Arithmetic, as the plain version rounds it

// RN(v / s), the IEEE f32 quotient. A zero numerator (hard-swish writes
// many) would take the division's slow path (FCHK), so it divides 1 instead
// and selects 0 after: 0 / s is 0 exactly.
__device__ __forceinline__ float quotient(float v, float s) {
  const float d = __fdiv_rn(v == 0.0f ? 1.0f : v, s);
  return v == 0.0f ? 0.0f : d;
}

// clip(round_half_even(d), -127, 127) as a byte. The clamp comes before the
// rounding (the same result), and adding 1.5 * 2^23 rounds half to even and
// leaves the integer in the low bits: full-rate adds in place of the
// conversions rintf and float -> int, which issue at a quarter of the rate.
__device__ __forceinline__ uint32_t to_int8(float d) {
  const float c = fminf(fmaxf(d, -127.0f), 127.0f);
  return (__float_as_uint(__fadd_rn(c, 12582912.0f)) - 0x4b400000u) & 0xffu;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ops/cuda/hard_swish.py::hard_swish_plain in f32: x * (clamp(x + 3, 0, 6) * f32(1/6)).
__device__ __forceinline__ float hard_swish_f32(float x) {
  const float r = fminf(fmaxf(__fadd_rn(x, 3.0f), 0.0f), 6.0f);
  return __fmul_rn(x, __fmul_rn(r, __int_as_float(0x3e2aaaab)));
}

// ... in bf16: x * (clamp(x + 3, 0, 6) / 6), each op rounded to bf16. For
// every bf16 r in [0, 6], RN_bf16(r / 6) == RN_bf16(r * f32(1/6)) (checked
// over all of them: r / 6 is exact or lies far from a bf16 rounding
// boundary), so the division is a multiply here.
__device__ __forceinline__ float hard_swish_bf16(float x) {
  const float r = fminf(fmaxf(round_bf16(__fadd_rn(x, 3.0f)), 0.0f), 6.0f);
  const float h = round_bf16(__fmul_rn(r, __int_as_float(0x3e2aaaab)));
  return round_bf16(__fmul_rn(x, h));
}

// One output: float(acc) * out_scale, rounded to the output type, + bias in
// it (exact in the output type), rounded again, then the activation in the
// output type. The value is exact in the output type. The choices are
// template arguments, so that the unrolled epilogue has no branch and the
// compiler interleaves the outputs' dependent chains.
template <bool kBf16, bool kBias, bool kAct>
__device__ __forceinline__ float finish(int32_t acc, float out_scale, float bias) {
  float v = __fmul_rn(__int2float_rn(acc), out_scale);
  if (kBf16) {
    v = round_bf16(v);
    if (kBias) v = round_bf16(__fadd_rn(v, bias));
    if (kAct) v = hard_swish_bf16(v);
  } else {
    if (kBias) v = __fadd_rn(v, bias);
    if (kAct) v = hard_swish_f32(v);
  }
  return v;
}

// ---------------------------------------------------------------------------
// The quantize of one chunk: the raw halo patch ([pixel][32 channels] as TMA
// wrote it) into the int8 copy. Consumer thread t takes the 8 channels
// 8*(t%4) .. +7 of pixels t/4, t/4 + 64, ...

template <typename Tin>
__device__ __forceinline__ void load8(const uint8_t* raw, int px, int g, float (&v)[8]);

template <>
__device__ __forceinline__ void load8<float>(const uint8_t* raw, int px, int g, float (&v)[8]) {
  const float4* s = reinterpret_cast<const float4*>(raw + (px * kChunk + g * 8) * 4);
  const float4 a = s[0], b = s[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const uint8_t* raw, int px, int g,
                                                     float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(raw + (px * kChunk + g * 8) * 2);
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The 8 channels 8*g .. of pixel (row, col) of a packed patch ([row][rowb]
// elements, its first pixel lead elements into a row), zero past C.
template <typename Tin>
__device__ __forceinline__ void load8_packed(const Params& p, const uint8_t* raw, int row, int col,
                                             int g, int lead, float (&v)[8]) {
  const Tin* s = reinterpret_cast<const Tin*>(raw) + row * p.rowb + lead + col * p.C;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 8 * g + j < p.C ? to_f32(s[8 * g + j]) : 0.0f;
}

template <typename Tin, bool kPacked>
__device__ __forceinline__ void quantize_patch(const Params& p, const uint8_t* raw, uint8_t* a,
                                               const float (&scale)[8], int ct, int lead) {
  const int g = ct & 3;
  const int npx = p.ph * p.pw;
  const uint32_t inv_pw = 65536u / p.pw + 1;  // px / pw == (px * inv_pw) >> 16 for px < 4096
  uint8_t* plane = a + (g >> 1) * npx * 16 + (g & 1) * 8;
  for (int px = ct >> 2; px < npx; px += kConsumers / 4) {
    float v[8];
    if constexpr (kPacked) {
      const int row = (px * inv_pw) >> 16, col = px - row * p.pw;
      load8_packed<Tin>(p, raw, row, col, g, lead, v);
    } else {
      load8<Tin>(raw, px, g, v);
    }
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= to_int8(quotient(v[j], scale[j])) << (8 * j);
      hi |= to_int8(quotient(v[j + 4], scale[j + 4])) << (8 * j);
    }
    const int row = (px * inv_pw) >> 16, col = px - row * p.pw;
    const int colp = p.stride == 2 ? (col & 1) * p.pwh + (col >> 1) : col;
    *reinterpret_cast<uint2*>(plane + (row * p.pw + colp) * 16) = make_uint2(lo, hi);
  }
}

// The elements of a packed patch row before its first pixel (w_in0 * C):
// the box starts at the 16-byte boundary at or before it.
__device__ __forceinline__ int packed_lead(const Params& p, int w_in0) {
  const int q = p.x_bf16 ? 8 : 4;  // elements in 16 bytes
  return ((w_in0 * p.C) % q + q) % q;
}

// ---------------------------------------------------------------------------
// The epilogue of a consumer warpgroup, which owns M tiles mt0 .. mt0+MBW-1
// and columns nc0 .. nc0+32*NW-1 of its block. Accumulator 4j+e of a thread
// (j < 4, of 32 columns nb) is row 16*warp + lane/4 + 8*(e/2) of its M
// tile's 64, column 8j + 2*(lane%4) + e%2: a pair of neighbouring columns.
// Row m of M tile i is output pixel (ho0 + 8*(mt0 + i) + m/8, wo0 + m%8).
// All the thread's outputs are computed first, in place of the accumulators
// (after the debug copy of those), then stored. With y_tma the warpgroup
// stages its 8*MBW x 8 x 32*NW outputs in shared memory, dense as the box of
// a TMA store, which writes whole lines and drops what falls outside y;
// else (rows of y not a multiple of 16 bytes) they go from the registers.

template <bool kBf16, bool kBias, bool kAct, int NW, int MBW>
__device__ __forceinline__ void epilogue(const Params& p, int32_t (&acc)[MBW][NW][16],
                                         uint8_t* smem, const float* const (&tab)[2],
                                         const int (&at)[7], int wg, int ct,
                                         const CUtensorMap& y_map) {
  const int b = at[0], wo0 = at[2], lane = at[4], nc0 = at[6];
  const int ho0 = at[1] + 8 * at[5], n0 = at[3] + nc0;  // the warpgroup's origin
  const int wwarp = (ct & 127) >> 5;
  constexpr int kCols = 32 * NW;  // the warpgroup's columns
  constexpr int kSize = kBf16 ? 2 : 4;
  if (p.acc != nullptr) {
#pragma unroll
    for (int mb = 0; mb < MBW; ++mb) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int m = 16 * wwarp + (lane >> 2) + 8 * ((e >> 1) & 1);
        const int ho = ho0 + 8 * mb + (m >> 3), wo = wo0 + (m & 7);
#pragma unroll
        for (int nb = 0; nb < NW; ++nb) {
          const int n = n0 + nb * 32 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
          if (ho < p.Ho && wo < p.Wo && n < p.O) {
            p.acc[((static_cast<size_t>(b) * p.Ho + ho) * p.Wo + wo) * p.O + n] = acc[mb][nb][e];
          }
        }
      }
    }
  }
#pragma unroll
  for (int nb = 0; nb < NW; ++nb) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int nl = nc0 + nb * 32 + 8 * j + 2 * (lane & 3) + e1;
        const float scale = tab[0][nl], bias = tab[1][nl];
#pragma unroll
        for (int mb = 0; mb < MBW; ++mb) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int e = 4 * j + 2 * e2 + e1;
            const float v = finish<kBf16, kBias, kAct>(acc[mb][nb][e], scale, bias);
            acc[mb][nb][e] = __float_as_int(v);
          }
        }
      }
    }
  }
  uint8_t* stage = smem + p.off_raw + wg * (64 * MBW * kCols * 4);
#pragma unroll
  for (int mb = 0; mb < MBW; ++mb) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int m = 16 * wwarp + (lane >> 2) + 8 * e2;
      const int ho = ho0 + 8 * mb + (m >> 3), wo = wo0 + (m & 7);
      const bool inside = ho < p.Ho && wo < p.Wo;
      const size_t pix = (static_cast<size_t>(b) * p.Ho + ho) * p.Wo + wo;
#pragma unroll
      for (int nb = 0; nb < NW; ++nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = nb * 32 + 8 * j + 2 * (lane & 3);  // of the warpgroup's
          const int n = n0 + col;
          const float v0 = __int_as_float(acc[mb][nb][4 * j + 2 * e2]);
          const float v1 = __int_as_float(acc[mb][nb][4 * j + 2 * e2 + 1]);
          // exact in y's type: a bf16's bits are the high half of the float's
          const uint32_t u0 = __float_as_uint(v0), u1 = __float_as_uint(v1);
          const size_t i = pix * p.O + n;
          if (p.y_tma) {
            uint8_t* d = stage + ((mb * 64 + m) * kCols + col) * kSize;
            if (kBf16) {
              *reinterpret_cast<uint32_t*>(d) = (u0 >> 16) | (u1 & 0xffff0000u);
            } else {
              *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
            }
          } else if (inside && n < p.O) {
            if (kBf16) {
              uint16_t* y = static_cast<uint16_t*>(p.y) + i;
              y[0] = static_cast<uint16_t>(u0 >> 16);
              if (n + 1 < p.O) y[1] = static_cast<uint16_t>(u1 >> 16);
            } else {
              float* y = static_cast<float*>(p.y) + i;
              y[0] = v0;
              if (n + 1 < p.O) y[1] = v1;
            }
          }
        }
      }
    }
  }
  if (p.y_tma) {
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if ((ct & 127) == 0) {
      tma_store_4d(&y_map, smem_addr(stage), n0, wo0, ho0, b);
      // the block's shared memory stays until the store has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// A split-concat part's launch (see the header): add the s32 sums of the
// parts before it (acc_in, at (ho >> up, wo >> up)) to the thread's
// accumulators, and for a part before the last write them to acc and end
// (partial). Laid out as the epilogue's accumulators.
template <int NW, int MBW>
__device__ __forceinline__ void part_sums(const Params& p, int32_t (&acc)[MBW][NW][16],
                                          const int (&at)[7], int ct) {
  const int b = at[0], wo0 = at[2], lane = at[4], nc0 = at[6];
  const int ho0 = at[1] + 8 * at[5], n0 = at[3] + nc0;
  const int wwarp = (ct & 127) >> 5;
  const int hi = p.Ho >> p.up, wi = p.Wo >> p.up;
#pragma unroll
  for (int mb = 0; mb < MBW; ++mb) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int m = 16 * wwarp + (lane >> 2) + 8 * ((e >> 1) & 1);
      const int ho = ho0 + 8 * mb + (m >> 3), wo = wo0 + (m & 7);
#pragma unroll
      for (int nb = 0; nb < NW; ++nb) {
        const int n = n0 + nb * 32 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (ho < p.Ho && wo < p.Wo && n < p.O) {
          if (p.acc_in != nullptr) {
            acc[mb][nb][e] += p.acc_in[((static_cast<size_t>(b) * hi + (ho >> p.up)) * wi +
                                        (wo >> p.up)) * p.O + n];
          }
          if (p.partial) {
            p.acc[((static_cast<size_t>(b) * p.Ho + ho) * p.Wo + wo) * p.O + n] = acc[mb][nb][e];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel. Each consumer warpgroup owns MBW wgmma M tiles of 64 output
// pixels (8 x 8) and 32 * NW output columns, and issues MBW
// wgmma.m64n(32*NW)k32 a tap. With kSplitM the two warpgroups split the
// block's M tiles and share its N = 32 * NW columns (narrow slices: one
// wide instruction, no columns wasted); else they split N = 64 * NW and
// share its MBW M tiles. The block owns 8 * MB x 8 output pixels, MB =
// 2 * MBW or MBW.
//
// Shared memory (from a 1024-byte aligned base): the mbarriers; the block's
// out_scale and bias as f32; raw_stages halo patches as TMA writes them; two
// int8 copies; kBStages weight slices.

template <int NW, int MBW, bool kSplitM>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap y_map) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = smem_addr(smem);
  const uint32_t raw_full = base, raw_empty = base + 8 * kMaxRawStages,
                 b_full = base + 16 * kMaxRawStages, b_empty = b_full + 8 * kBStages;
  float* tab_scale = reinterpret_cast<float*>(smem + kBarBytes);
  float* tab_bias = tab_scale + kMaxN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int t = blockIdx.x;
  const int tw_i = t % p.tiles_w;
  t /= p.tiles_w;
  const int th_i = t % p.tiles_h, b = t / p.tiles_h;
  const int n0 = blockIdx.y * p.n;
  constexpr int MB = kSplitM ? 2 * MBW : MBW;
  const int ho0 = th_i * 8 * MB, wo0 = tw_i * kTileW;

  if (tid == 0) {
    for (int i = 0; i < kMaxRawStages; ++i) {
      mbar_init(raw_full + 8 * i, 1);
      mbar_init(raw_empty + 8 * i, kConsumers / 32);
    }
    for (int i = 0; i < kBStages; ++i) {
      mbar_init(b_full + 8 * i, 1);
      mbar_init(b_empty + 8 * i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform as the compiler sees it, as wgmma and setmaxnreg need
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == kWarpgroups) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32) return;
    // ---- producer warp: halo patches and weight slices, in consumer order
    const int h_in0 = ho0 * p.stride - p.pad_h, w_in0 = wo0 * p.stride - p.pad_w;
    const int lead = packed_lead(p, w_in0);
    auto issue_raw = [&](int ci) {
      const int st = ci % p.raw_stages;
      mbar_wait(raw_empty + 8 * st, ((ci / p.raw_stages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(raw_full + 8 * st, p.raw_tx);
        if (p.packed) {  // one chunk: rows of rowb elements of the (B, H, W * C) view
          tma_load_3d(base + p.off_raw + st * p.raw_bytes, &x_map, raw_full + 8 * st,
                      w_in0 * p.C - lead, h_in0, b);
        } else {
          tma_load_4d(base + p.off_raw + st * p.raw_bytes, &x_map, raw_full + 8 * st,
                      ci * kChunk, w_in0, h_in0, b);
        }
      }
    };
    for (int ci = 0; ci < p.raw_stages && ci < p.chunks; ++ci) issue_raw(ci);
    for (int ci = 0; ci < p.chunks; ++ci) {
      for (int tap = 0; p.w_tma && tap < p.taps; ++tap) {
        const int gi = ci * p.taps + tap, st = gi % kBStages;
        const uint32_t dst = base + p.off_b + st * p.b_bytes;
        mbar_wait(b_empty + 8 * st, ((gi / kBStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(b_full + 8 * st, p.b_bytes);
          tma_load_3d(dst, &w_map, b_full + 8 * st, ci * kChunk, tap, n0);
        }
      }
      if (ci + p.raw_stages < p.chunks) issue_raw(ci + p.raw_stages);
    }
    return;
  }

  // ---- consumers: two warpgroups, splitting the block's M tiles or columns
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ct = tid, wg = role;
  const int mt0 = kSplitM ? wg * MBW : 0, nc0 = kSplitM ? 0 : wg * 32 * NW;  // the warpgroup's
  // The epilogue's table; the loads land while the main loop runs.
  if (ct < p.n) {
    const int n = n0 + ct < p.O ? n0 + ct : 0;
    tab_scale[ct] = p.a_vec ? p.w_scale[n] : __fmul_rn(p.a_scale[0], p.w_scale[n]);
    tab_bias[ct] = p.bias == nullptr ? 0.0f
                   : p.y_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[n])
                              : static_cast<const float*>(p.bias)[n];
  }
  if (!p.w_tma) {
    // C not a multiple of 16 (then C <= 32: one chunk; the Focus stem's 12,
    // the 6x6 stem's 3), which a TMA box cannot cut: the consumers copy the
    // weights of every tap (b_stages = k*k slices) as 4-byte words of 4
    // channels, or bytes where the rows do not align to words, zero past C
    // and O. The fence and barrier before the first wgmma publish them.
    for (int row = ct; row < p.taps * p.n; row += kConsumers) {
      const int tap = row / p.n, n = row - tap * p.n;
      const int8_t* src = p.w + static_cast<size_t>(n0 + n) * p.w_row + tap * p.w_ld;
      uint32_t words[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t word = 0;
        if (n0 + n < p.O && 4 * i < p.C) {
          if (p.w_bytes) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              word |= 4 * i + j < p.C ? static_cast<uint32_t>(static_cast<uint8_t>(src[4 * i + j]))
                                            << (8 * j)
                                      : 0u;
            }
          } else {
            word = *reinterpret_cast<const uint32_t*>(src + 4 * i);
          }
        }
        words[i] = word;
      }
      // row n of the slice, its 16-byte halves in the 32-byte swizzle
      uint8_t* d = smem + p.off_b + tap * p.b_bytes + n * 32;
      const int swap = (n >> 2) & 1;
      *reinterpret_cast<uint4*>(d + 16 * swap) = make_uint4(words[0], words[1], words[2], words[3]);
      *reinterpret_cast<uint4*>(d + 16 * (swap ^ 1)) =
          make_uint4(words[4], words[5], words[6], words[7]);
    }
  }
  int32_t acc[MBW][NW][16];
#pragma unroll
  for (int mb = 0; mb < MBW; ++mb)
#pragma unroll
    for (int nb = 0; nb < NW; ++nb)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[mb][nb][i] = 0;

  const int npx = p.ph * p.pw;
  const uint32_t a_lbo = npx * 16, a_sbo = p.stride * p.pw * 16;
  for (int ci = 0; ci < p.chunks; ++ci) {
    const int rs = ci % p.raw_stages, ab = ci % kABufs;
    float scale[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = ci * kChunk + (ct & 3) * 8 + j;
      scale[j] = c < p.C ? p.a_scale[p.a_vec ? c : 0] : 1.0f;
    }
    mbar_wait(raw_full + 8 * rs, (ci / p.raw_stages) & 1);
    const uint8_t* raw = smem + p.off_raw + rs * p.raw_bytes;
    uint8_t* a = smem + p.off_a + ab * p.a_bytes;
    if (p.packed) {
      const int lead = packed_lead(p, wo0 * p.stride - p.pad_w);
      if (p.x_bf16) {
        quantize_patch<__nv_bfloat16, true>(p, raw, a, scale, ct, lead);
      } else {
        quantize_patch<float, true>(p, raw, a, scale, ct, lead);
      }
    } else if (p.x_bf16) {
      quantize_patch<__nv_bfloat16, false>(p, raw, a, scale, ct, 0);
    } else {
      quantize_patch<float, false>(p, raw, a, scale, ct, 0);
    }
    fence_proxy_async();
    __syncwarp();
    mbar_arrive_warp(raw_empty + 8 * rs, lane);
    // No wgmma wait here: the products of this warpgroup's previous chunks
    // run on while the next one is quantized. The int8 copy written now was
    // last read kABufs chunks ago, and every warpgroup retired those
    // products (each tap's wait leaves kInFlight - 1 groups) before it
    // reached the previous chunk's barrier.
    named_barrier(1, kConsumers);
    wgmma_fence();
    const uint32_t a_base = base + p.off_a + ab * p.a_bytes;
    for (int tap = 0; tap < p.taps; ++tap) {
      // the TMA ring, or (weights copied by the consumers, one chunk) a slice a tap
      const int gi = ci * p.taps + tap, st = p.w_tma ? gi % kBStages : tap;
      const int r = tap / p.k, s = tap - r * p.k;
      const int col0 = p.stride == 2 ? (s & 1) * p.pwh + (s >> 1) : s;
      const uint32_t a_addr = a_base + (r * p.pw + col0) * 16;
      const uint32_t b_addr = base + p.off_b + st * p.b_bytes + nc0 * 32;
      if (p.w_tma) mbar_wait(b_full + 8 * st, (gi / kBStages) & 1);
#pragma unroll
      for (int mb = 0; mb < MBW; ++mb) {
        const uint64_t da = gmma_desc(a_addr + (mt0 + mb) * 8 * a_sbo, a_lbo, a_sbo);
        if (NW <= 3) {
          wgmma_s8<NW <= 3 ? NW : 1>(&acc[mb][0][0], da, gmma_desc_sw32(b_addr));
        } else {  // 128 columns: two n64 instructions (n128 needs more registers)
          wgmma_s8<2>(&acc[mb][0][0], da, gmma_desc_sw32(b_addr));
          wgmma_s8<2>(&acc[mb][2][0], da, gmma_desc_sw32(b_addr + 64 * 32));
        }
      }
      wgmma_commit();
      // the products of kInFlight taps back are done: free their slice
      wgmma_wait<kInFlight - 1>();
      if (p.w_tma && gi >= kInFlight - 1) {
        mbar_arrive_warp(b_empty + 8 * ((gi - (kInFlight - 1)) % kBStages), lane);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < MBW; ++mb)
#pragma unroll
    for (int nb = 0; nb < NW; ++nb) fence_regs(acc[mb][nb]);

  // ---- epilogue
  const int at[7] = {b, ho0, wo0, n0, lane, mt0, nc0};
  if (p.acc_in != nullptr || p.partial) {  // a split-concat part
    part_sums<NW, MBW>(p, acc, at, ct);
    if (p.partial) return;
  }
  if (p.y_tma) named_barrier(1, kConsumers);  // every product done: the buffers are free
  const float* tab[2] = {tab_scale, tab_bias};
  if (p.y_bf16) {
    if (p.bias != nullptr) {
      if (p.act) epilogue<true, true, true>(p, acc, smem, tab, at, wg, ct, y_map);
      else epilogue<true, true, false>(p, acc, smem, tab, at, wg, ct, y_map);
    } else {
      if (p.act) epilogue<true, false, true>(p, acc, smem, tab, at, wg, ct, y_map);
      else epilogue<true, false, false>(p, acc, smem, tab, at, wg, ct, y_map);
    }
  } else {
    if (p.bias != nullptr) {
      if (p.act) epilogue<false, true, true>(p, acc, smem, tab, at, wg, ct, y_map);
      else epilogue<false, true, false>(p, acc, smem, tab, at, wg, ct, y_map);
    } else {
      if (p.act) epilogue<false, false, true>(p, acc, smem, tab, at, wg, ct, y_map);
      else epilogue<false, false, false>(p, acc, smem, tab, at, wg, ct, y_map);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

uint32_t round_up(uint32_t v, uint32_t m) { return (v + m - 1) / m * m; }

template <int NW, int MBW, bool kSplitM>
int launch(const Params& p, const CUtensorMap& x_map, const CUtensorMap& w_map,
           const CUtensorMap& y_map, dim3 grid, int smem, cudaStream_t stream) {
  static int smem_set = 0;  // the attribute is raised once to each new size
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel<NW, MBW, kSplitM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  int8_conv_kernel<NW, MBW, kSplitM><<<grid, kThreads, smem, stream>>>(p, x_map, w_map, y_map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = w8a8 conv of x (see int8_conv_kernel), then hard-swish if act is 1.
// x_bf16 / y_bf16: 1 for bf16, 0 for f32. w_ld: the weight's channels
// between taps (C, or the whole kernel's for a part's slice). bias may be
// null (else in y's type), acc may be null. acc_in (null, or the s32 sums
// of the parts before, at (Ho >> up, Wo >> up)) is added to the products;
// with partial the sum goes to acc and y is not written (y may be null).
// pad_h, pad_w: the zero padding of each side in H and in W. n: output
// channels of a block, a multiple of 32 up to 256, mb: 8-row blocks of
// output pixels of a block, and split: 1 if the two warpgroups split the
// block's M tiles (then n <= 96 and mb even), 0 if they split its n
// columns (the wrapper's tile plan; the kernel is built for the plans
// tile_plan makes).
int cocodet_int8_conv(const void* x, int x_bf16, const int8_t* w, int w_ld, const float* a_scale,
                      int a_vec, const float* w_scale, const void* bias, void* y, int y_bf16,
                      int32_t* acc, const int32_t* acc_in, int up, int partial, int B, int H,
                      int W, int C, int O, int k, int stride, int pad_h, int pad_w, int Ho,
                      int Wo, int n, int mb, int split, int act, void* stream) {
  const int esize = x_bf16 ? 2 : 4;
  const bool packed = (C * esize) % 16 != 0;
  const bool w_tma = C % 16 == 0;
  if (!((k == 1 || k == 3 || k == 6) && (stride == 1 || stride == 2)) || B <= 0 || C <= 0 ||
      O <= 0 || pad_h < 0 || pad_w < 0 || pad_h >= k || pad_w >= k || w_ld < C ||
      (packed ? C >= 16 || (static_cast<long long>(W) * C * esize) % 16 != 0
              : C % 4 != 0 || (C % 16 != 0 && C > kChunk)) ||
      (w_tma && (w_ld % 16 != 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0)) ||
      n % 32 != 0 || n < 32 || n > kMaxN || (split ? n > 96 || mb % 2 != 0 : n % 64 != 0) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 || (partial && acc == nullptr) ||
      (up && acc_in == nullptr) || (up != 0 && up != 1)) {
    return -1;
  }
  if (Ho <= 0 || Wo <= 0) return 0;
  const int nw = split ? n / 32 : n / 64, mbw = split ? mb / 2 : mb;  // a warpgroup's
  Params p{};
  p.x = x; p.w = w; p.a_scale = a_scale; p.w_scale = w_scale; p.bias = bias; p.y = y;
  p.acc = acc; p.acc_in = acc_in; p.up = up; p.partial = partial;
  p.a_vec = a_vec; p.x_bf16 = x_bf16; p.y_bf16 = y_bf16; p.act = act;
  p.w_tma = w_tma;
  p.w_bytes = !w_tma && (C % 4 != 0 || w_ld % 4 != 0 || (reinterpret_cast<uintptr_t>(w) & 3) != 0);
  p.packed = packed;
  p.C = C; p.O = O; p.k = k; p.stride = stride; p.pad_h = pad_h; p.pad_w = pad_w;
  p.Ho = Ho; p.Wo = Wo; p.n = n;
  p.w_ld = w_ld; p.w_row = k * k * w_ld;
  p.tiles_w = (Wo + kTileW - 1) / kTileW;
  p.tiles_h = (Ho + 8 * mb - 1) / (8 * mb);
  p.ph = (8 * mb - 1) * stride + k;
  p.pw = (kTileW - 1) * stride + k;
  p.pwh = (p.pw + 1) / 2;
  // a packed row: the patch's pw * C elements after a lead of less than 16
  // bytes, rounded up to 16 bytes
  p.rowb = (p.pw * C * esize + 15 + 15) / 16 * 16 / esize;
  if (p.ph > 256 || (packed && p.rowb > 256)) return -1;  // a TMA box's largest extent
  p.chunks = (C + kChunk - 1) / kChunk;
  p.taps = k * k;
  p.b_stages = w_tma ? kBStages : p.taps;
  const uint32_t npx = p.ph * p.pw;
  p.raw_tx = packed ? p.ph * p.rowb * esize : npx * kChunk * esize;
  p.raw_bytes = round_up(p.raw_tx, 128);
  p.a_bytes = round_up(2 * npx * 16, 128);
  p.b_bytes = n * 32;
  p.off_raw = kBarBytes + kTabBytes;
  // The deepest ring of halo patches that leaves two blocks an SM, else
  // the deepest that fits one.
  int smem = 0;
  auto size = [&](int stages) {
    p.raw_stages = stages;
    p.off_a = p.off_raw + stages * p.raw_bytes;
    p.off_b = round_up(p.off_a + kABufs * p.a_bytes, 1024);
    const uint32_t end = p.off_b + p.b_stages * p.b_bytes;
    const uint32_t staging = p.off_raw + kWarpgroups * 64 * mbw * 32 * nw * 4;
    return static_cast<int>((end > staging ? end : staging) + 1024);  // + alignment slack
  };
  int stages = kMaxRawStages;
  while (stages > 1 && size(stages) > kSmemPerSM / 2 - 1024) --stages;
  if (size(stages) > kSmemPerSM / 2 - 1024) {
    stages = kMaxRawStages;
    while (stages > 0 && size(stages) > kSmemLimit) --stages;
    if (stages == 0) return -5;
  }
  smem = size(stages);

  EncodeTiled encode = encoder();
  if (encode == nullptr) return -2;
  CUtensorMap x_map, w_map;
  if (packed) {  // the (B, H, W * C) view: a box of rowb elements by ph rows
    const cuuint64_t dims[3] = {(cuuint64_t)W * C, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)W * C * esize, (cuuint64_t)H * W * C * esize};
    const cuuint32_t box[3] = {(cuuint32_t)p.rowb, (cuuint32_t)p.ph, 1};
    const cuuint32_t one[3] = {1, 1, 1};
    if (encode(&x_map, x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               3, const_cast<void*>(x), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return -3;
    }
  } else {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)C * esize, (cuuint64_t)W * C * esize,
                                   (cuuint64_t)H * W * C * esize};
    const cuuint32_t box[4] = {kChunk, (cuuint32_t)p.pw, (cuuint32_t)p.ph, 1};
    const cuuint32_t one[4] = {1, 1, 1, 1};
    if (encode(&x_map, x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               4, const_cast<void*>(x), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return -3;
    }
  }
  w_map = x_map;  // unused unless the weights come by TMA
  const int ysize = y_bf16 ? 2 : 4;
  p.y_tma = !partial && (O * ysize) % 16 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  CUtensorMap y_map = x_map;  // unused unless y leaves by TMA
  if (p.y_tma) {
    const cuuint64_t dims[4] = {(cuuint64_t)O, (cuuint64_t)Wo, (cuuint64_t)Ho, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)O * ysize, (cuuint64_t)Wo * O * ysize,
                                   (cuuint64_t)Ho * Wo * O * ysize};
    const cuuint32_t box[4] = {(cuuint32_t)(32 * nw), kTileW, (cuuint32_t)(8 * mbw), 1};
    const cuuint32_t one[4] = {1, 1, 1, 1};
    if (encode(&y_map, y_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               4, y, dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return -6;
    }
  }
  if (p.w_tma) {
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)(k * k), (cuuint64_t)O};
    const cuuint64_t strides[2] = {(cuuint64_t)w_ld, (cuuint64_t)p.w_row};
    const cuuint32_t box[3] = {kChunk, 1, (cuuint32_t)n};
    const cuuint32_t one[3] = {1, 1, 1};
    if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(w), dims, strides,
               box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return -4;
    }
  }

  const dim3 grid(B * p.tiles_h * p.tiles_w, (O + n - 1) / n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (split * 100 + nw * 10 + mbw) {
    case 112: return launch<1, 2, true>(p, x_map, w_map, y_map, grid, smem, s);
    case 111: return launch<1, 1, true>(p, x_map, w_map, y_map, grid, smem, s);
    case 121: return launch<2, 1, true>(p, x_map, w_map, y_map, grid, smem, s);
    case 131: return launch<3, 1, true>(p, x_map, w_map, y_map, grid, smem, s);
    case 22: return launch<2, 2, false>(p, x_map, w_map, y_map, grid, smem, s);
    case 21: return launch<2, 1, false>(p, x_map, w_map, y_map, grid, smem, s);
    case 31: return launch<3, 1, false>(p, x_map, w_map, y_map, grid, smem, s);
    case 41: return launch<4, 1, false>(p, x_map, w_map, y_map, grid, smem, s);
    default: return -1;
  }
}

}  // extern "C"
