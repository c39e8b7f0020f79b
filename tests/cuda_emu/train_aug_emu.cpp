// Launches train_aug.cu's kernels (their source, without the nvcc launchers
// and with cp.async as a copy: kernels.inc, written by
// tests/torch_cuda_emu.py) on the CPU: each block's 256 threads run as
// std::threads, blocks one after another, shared memory filled with 0xA5
// before each block so that a read of what no thread wrote shows.
#include <atomic>
#include <barrier>
#include <functional>
#include <thread>
#include <vector>

#include "kernels.inc"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
alignas(16) uint8_t smem[1 << 20];

namespace {
std::barrier<>* g_block;
std::barrier<>* g_warp[8];
std::atomic<int> g_count[2];
thread_local int g_phase;

int launch(dim3 grid, int smem_bytes, const std::function<void()>& body) {
  if (smem_bytes > static_cast<int>(sizeof(smem))) return 1;
  std::barrier<> block(256);
  for (auto& w : g_warp) w = new std::barrier<>(32);
  g_block = &block;
  g_count[0] = 0, g_count[1] = 0;
  gridDim = grid;
  blockDim = dim3(256);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < 256; ++t) {
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      g_phase = 0;
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = dim3(x, y, z);
            if (t == 0) memset(smem, 0xA5, smem_bytes);
            block.arrive_and_wait();
            body();
            block.arrive_and_wait();
          }
    });
  }
  for (auto& th : threads) th.join();
  for (auto& w : g_warp) delete w;
  return 0;
}
}  // namespace

void __syncthreads() { g_block->arrive_and_wait(); }
int __syncthreads_count(int pred) {
  if (pred) g_count[g_phase].fetch_add(1);
  g_block->arrive_and_wait();
  const int v = g_count[g_phase].load();
  if (threadIdx.x == 0) g_count[g_phase ^ 1].store(0);
  g_block->arrive_and_wait();
  g_phase ^= 1;
  return v;
}
void __syncwarp() { g_warp[threadIdx.x / 32]->arrive_and_wait(); }

extern "C" {
int emu_mosaic_canvas(const uint8_t* tiles, const int* hw5, const int* nhw5, const int* yc,
                      const int* xc, uint8_t* canvas, int B, int sh, int sw, int ih, int iw) {
  const int stage = canvas_stage_bytes(sw);
  const int bytes = kTapBytes * (kCanvasRows + kTileCols) + kCanvasRows * kTileCols * 3 + stage;
  return launch(tile_grid(B, 2 * ih, 2 * iw, kCanvasRows), bytes, [&] {
    mosaic_canvas_kernel(tiles, hw5, nhw5, yc, xc, canvas, sh, sw, ih, iw, stage);
  });
}
int emu_affine_warp(const uint8_t* canvas, const float* m6, uint8_t* out, int B, int ih, int iw) {
  return launch(tile_grid(B, ih, iw, kWarpRows), warp_smem_bytes(ih),
                [&] { affine_warp_kernel(canvas, m6, out, ih, iw); });
}
// s1_words, raw_bytes: 0 for the launcher's sizes, or smaller stages (at
// least two whole rows each) that force the kernel's bands
int emu_mixup(const uint8_t* tiles, const int* hw5, const int* nhw5, const uint8_t* warped,
              const float* mrand, uint8_t* mid, int B, int sh, int sw, int ih, int iw,
              int s1_words, int raw_bytes) {
  const int s1 = s1_words > 0 ? s1_words : mix_s1_words(iw);
  const int raw = raw_bytes > 0 ? raw_bytes : aug_raw_bytes(sw);
  return launch(tile_grid(B, sh, sw, kMixRows), mix_smem_bytes(ih, iw, s1, raw), [&] {
    mixup_kernel(tiles, hw5, nhw5, warped, mrand, mid, sh, sw, ih, iw, s1, raw);
  });
}
int emu_train_aug(const uint8_t* img, const int* hw, const int* nhw, const float* gains,
                  const int* flip, const int* fallback, float* out, int B, int sh, int sw,
                  int ih, int iw) {
  const int raw = aug_raw_bytes(sw), stage = aug_stage_px(sw);
  const int warp_out = 4 * 2 * 3 * kTileCols * (kTileThreads / 32);
  const int bytes = kTapBytes * (kAugRows + kTileCols) + warp_out + 4 * stage + raw;
  return launch(tile_grid(B, ih, iw, kAugRows), bytes, [&] {
    train_aug_kernel(img, hw, nhw, gains, flip, fallback, out, sh, sw, ih, iw, raw, stage);
  });
}
}
