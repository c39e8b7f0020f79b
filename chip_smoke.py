#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cocodet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):
  a. build every CUDA kernel from cocodet_tpu_torch/csrc/ with nvcc (one
     process per source, in parallel) into build/kernels/, and the host C++
     libraries of csrc/host/ with g++ into build/host/;
  b. hold each kernel against its plain PyTorch version on the card, on the
     dense scene of tests/test_topk_equivalence.py batched to 16 images, at
     K=1024 (the main path), K=340 (ragged) and K=2048, as it is and widened
     so that the NMS suppresses; on all 8500 anchors of two images; and on
     two images of numpy-drawn boxes at the largest K the keep kernel takes:
     the packed overlap words and the keep masks must be equal bit for bit;
     time kernel and plain version at the main path's shape on the scene as
     it is (every valid row kept) and widened, and the keep kernel's chain
     of row decisions alone (no valid row);
  c. the main path: the full-width YOLOX-M-P6 (depth 0.67, width 0.75) with
     weights drawn from a numpy seed, BN folded, bf16, serves 4 batches of
     16 640x640 requests through Predictor; the launch counts are zeroed just
     before and read just after, and each kernel must have launched (the NMS
     pair and the standalone hard-swish after each conv); then
     each kernel held against its plain version and timed on a batch's
     served candidates (the times of the kernels line), and the device time
     of a batch's parts, the NMS split into class offset, overlap, keep and
     compaction; (c2) the dense batch served twice with cuDNN deterministic
     and no benchmark, then twice with benchmark on, and the detection counts
     of each printed;
  d. check the served output against the plain reference on a small input:
     the f32 model on the card against the unfused f32 model on the CPU, the
     bf16 model against it at a bf16 tolerance, and the NMS on the card
     (kernels) against the NMS on the CPU (plain versions) on the same f32
     candidates, exactly;
  e. the int8 conv of the headline (bench.py's slim w8a8 YOLOX-M-P6, built
     by entry.build_headline: weights from a numpy seed, calibrated and
     quantized on the card): held against its plain version on the card,
     with no activation and with the fused hard-swish, on all 127 w8a8
     convs at their served shapes (inputs collected by forward hooks on one
     served batch of 2 640x640 images) and on ragged cases (cin=12, odd
     sizes at stride 2, a patch cut by the image edge, M not a multiple of
     the tile, O above one slice of the tile plan, scalar and vector
     act_scale, f32 and bf16 in and out): the s32 accumulators and the
     outputs must be equal bit for bit; then timed on each distinct shape
     of a served batch of 16 as served (fused hard-swish), kernel and plain
     version, beside each conv's bound, with the activation elements the
     kernel quantizes (ops/cuda/int8_conv.py::quantized_elements); and the
     port's hard-swish on the card against the CPU, on every non-NaN bf16
     bit pattern and 2^20 f32 values in [-4, 4]: equal;
  f. the main path of the headline: 4 batches of 16 640x640 requests served
     through build_headline's Predictor after two warm-up batches, launch
     counts zeroed just before and read just after (127 int8 convs a batch,
     one launch of each NMS kernel); the device time of the forward and of
     the postprocess, beside the same slim model's bf16 forward through
     cuDNN and phase c's dense numbers; then the headline as served, in f32
     and in bf16, on the card against the plain path on the CPU with the
     same quantized variables;
  g. the training slice: (g1) the hard-swish kernel held against its plain
     version on the card, bit for bit, forward and backward, on every
     non-NaN bf16 pattern (times 16 cotangents) and 2^20 f32 values; (g2)
     one step of entry.build_trainer at depth 0.33, width 0.125, 128 px,
     B=4, f32 on the card against the same step on the CPU (TF32 off, cuDNN
     deterministic): the SimOTA fg mask equal, the losses, parameters and BN
     statistics within stated limits; (g3) the main path of the slice:
     build_trainer at full width (YOLOX-M-P6, f32 parameters, bf16 compute),
     B=16 640 px numpy-seeded images with 5-60 boxes each padded to G=120, 2
     warm-up steps and 5 timed steps (the last with use_l1), the launch
     counts zeroed just before and read just after: train-mode BN and the
     hard-swish after it run as the fused pair of csrc/bn_act.cu, 4 x 127
     launches a step, and the standalone hard-swish never; the device ms of
     a step and of its forward, SimOTA and losses, backward, optimizer and
     EMA, the host's ms to queue a step, img/s, peak memory, the CUDA
     kernels of one step (torch.profiler), every loss and num_fg (finite,
     num_fg > 0), no host sync; then the pair held against its plain stages
     at each of one step's BN+act shapes (bf16 and f32) and on ragged cases
     (the sums within a stated tolerance of f64 sums, the vectors, running
     statistics and both apply stages bit for bit, each reduce equal in two
     runs), and timed on one step's maps beside its bound, its plain stages
     and train-mode F.batch_norm + F.hardswish; (g4, run after phase d)
     phase c's dense forward timed with the standalone hard-swish kernel
     (as served) and with its plain version in its place, in turns, and the
     kernel timed at its activations' shapes beside F.hardswish;
  h. data-parallel training (parallel/ and entry.build_trainer on a Mesh)
     on 2 ranks that share the card over gloo, every collective staged
     through host memory, in one run of ranks: (h1) at depth 0.33, width
     0.125, f32, cuDNN deterministic, one step of the 1-D mesh (B=4, 128 px)
     and one of the (1 data x 2 space) mesh (B=4, 256x128) against the
     single-process step on the card: the fg mask and num_fg equal, the
     losses, parameters and BN statistics within stated limits, and both
     ranks holding one state bit for bit; (h2) the main path of the slice:
     YOLOX-M-P6, f32 parameters, bf16 compute, g3's batch of 16 640 px
     images on 2 data ranks of 8 images and on 1 data x 2 space ranks of 320
     rows, 2 warm-up and 3 timed steps, counts zeroed just before and read
     just after: each rank's device ms a step, host ms in collectives, the
     collectives staged through the host, peak memory and the launches of
     the BN+act kernels (each > 0, with the finish kernels that follow the
     all-reduce of the sums; the standalone hard-swish 0), the losses
     (finite, num_fg > 0, equal on both ranks);
  i. the evaluation family on the port's synthetic val set (128 JPEGs the
     port's encoder writes, variant "default", 256-512 px, generated into a
     temporary directory):
     (i1) a crafted model whose head maps decode to each image's ground
     truth through entry.build_evaluator's COCOEvaluator at 768 px, B=16:
     AP50 = 1.0 and AP >= 0.99, and with every box moved AP50 < 0.2; (i2)
     phase c's dense bf16 model through the same evaluator (K=2000): img/s,
     forward+NMS and host ms an image, peak memory, the launches of the NMS
     pair and hard-swish (one a batch, 127 a batch), the 12 stats finite and
     equal with the plain matcher, the NMS kernels against their plain
     versions on the first batch's candidates, the first two images' f32
     detections on the card and on the CPU the same sets, and the pageable
     copy of a batch; (i3) the headline through it (127 int8 convs a
     batch), img/s; (i4) the harness (cocodet_tpu_torch/harness.py) with
     harness/config/yolox_m_p6.json on the set, 832 px, B=16, K=2048, the
     contrast TTA, --profile: the seconds of each phase, the records, the
     self-evaluation's mAP@0.5, the launches and the distinct batch shapes;
     then the NMS kernels at K=2048 and hard-swish on the stem's activation
     of a bucket batch against their plain versions.

  j. the training runtime (exp, trainer, CLI) with the device-mosaic input
     pipeline, on the port's synthetic train set (64 train and 16 val
     JPEGs, 256-512 px, in a temporary directory): (j1) the four kernels
     of csrc/train_aug.cu (canvas, the warp in one pass, mixup, HSV + flip
     + letterbox) against their plain versions on the card, bit for bit, on
     a collated batch of 16 at 768 px with mosaic and mixup on and on one
     after close_mosaic, then (j1_cases) all four on both batches of an exp
     at each multiscale size 640-832, K1 and K4 on the edge cases of their
     block tiling (B=1 and 3, mosaic centres on and flush with the canvas
     edges, whole blocks of background, one-pixel-wide sources, extents off
     the block grid, flip and fallback items together, the largest tiles,
     downscales whose stages are walked in bands), K2 on B=1 and 3,
     matrices at the draw's extremes, past its two guards, all on the
     border and off the block grid, and K3 with mixup off, passthrough
     origins, flipped partners, crops at each edge, tw2 and th2 either side
     of the input size, a partner walked in bands and extents off the block
     grid, printing the values that differ and the bands a block walks;
     each timed on the first batch beside its plain version and its byte
     bound, K2 also at scale 0.1 and 2.0, K4 also with no HSV jitter, and
     K1, K3 and K4 at 0.9 of the extents (off their copy path); (j2) the
     main path of the slice: the training CLI's main() in process
     (entry.train) with the port's yolox_m_p6 exp at full width,
     B=16, device_mosaic True, --cache, 3 epochs (one warm-up, the last
     without aug), the launch counts zeroed just before and read just after
     (K1-K4 once a step each; the BN+act pair, the NMS pair and
     hard-swish > 0): per epoch the iterations, img/s by the host clock,
     the step's and the input's device ms, the wait for data, the
     multiscale sizes, the L1 switch and peak memory; the evaluations and
     checkpoints; every loss finite, the no-aug switch at epoch 2; (j3)
     --resume from latest_ckpt.msgpack with max_epoch 4: start epoch, best
     AP, parameters, momentum and EMA shadow bit for bit the saved ones, the
     EMA's update count, then one more epoch; (j4) j1's batches through the
     whole preprocessing on the card (kernels) and on the CPU (plain): equal
     bits; the kernels one batch's preprocessing launches (torch.profiler);
     (j5) j2's run cold, without --cache (every tile decoded from its JPEG),
     for 2 epochs. Phase j runs with
     the cuDNN and TF32 flags a new process has (benchmark off), as the
     CLI would, whatever the earlier phases set; a kernel's byte bound
     counts the input pixels its taps read, its small per-item inputs and
     its output (the warp: the canvas pixels its two passes read, composed,
     and the warped image).
  k. the shipped phase-1 exp as it ships: the host mosaic path
     (data/mosaic.py: cv2's decode, resize, warp and HSV as host C++) on a
     64-train / 16-val JPEG set of 256-512 px that the port's encoder
     writes: (k1) the JPEG codec (csrc/host/jpeg.cpp) and csrc/host/warp.cpp
     against their plain versions on the host, bit for bit (the codec on 4
     of the set's images and a 480x640 one, the warp on a 1536x1536 mosaic
     canvas to 768x768, HSV both ways on its result), with the decode and
     encode ms an image (median over the set, and the 480x640 one), the
     encode-then-decode round trip's error, the warp's and the HSV round
     trip's ms, and the exp's host loader alone (ms a batch of 16, with
     mosaic and mixup and after close_mosaic); (k2) tools/train.py's main()
     in process with cocodet_tpu_torch/exps/p6/yolox_m_p6.py unchanged (no
     device_mosaic),
     full width, bf16, B=16, no --cache, 2 epochs of 4 iterations (the
     last without aug), multiscale over the exp's 640-832 at stride 64, the
     counts zeroed just before: per epoch img/s by the host clock, the wait
     for data, the step's device ms, peak memory and the launches of the
     BN+act pair, the NMS pair and hard-swish (each > 0 over the run); every
     loss finite; (k3) the BN+act pair held against its plain stages, as in
     g3, at the BN+act maps of one step at each size k2 trained at, 768 px
     and the largest bucket (its worst errors join the kernels line's). The
     host C++ sources are host code, not kernels: k adds no row to the
     kernels line.
  l. the compression chain at full width (YOLOX-M-P6, bf16), each step
     seeded, its cuts printed first: (l1) the magnitude chain on seeded
     unfused variables (obj and cls biases at logit(0.1), as phase c):
     masks at 0.49 over the conv kernels outside the head, injected,
     merged (BN folded, masks folded) on the host, the kept share, each
     part's effective and total parameters and the seconds; the merged
     tree served dense in bf16 at B=16, 640 px (counts zeroed just before:
     127 hard-swish launches a batch and one of each NMS kernel), and in
     f32 its detections on the card (TF32 off) and on the CPU the same
     sets; (l2) the Pruner through its CLI's build on the port's prune exp,
     64 synthetic train JPEGs at 640 px, B=16, no aug, one epoch of 4
     iterations with prune_interval 0.5 (two prune events of 64 channels),
     prune_score_batches 2, l1's variables the init: each event's count,
     the masks shrinking by it, finite losses, each Pruner step's and score
     step's device ms, host ms to queue and launches, peak memory, the
     run's launches (the BN+act pair, hard-swish forward and backward, the
     NMS pair in the evaluation); then the BN+act pair with ChannelMask
     gates closed in its vectors held against its plain stages at the
     step's BN shapes, and the hard-swish backward kernel at the score
     step's activations, bit for bit, timed beside its plain version and
     aten.hardswish_backward; (l3) the Tuner through its CLI's build from
     l2's checkpoint with distillation (the masked init the teacher), 4
     iterations, its step's numbers; (l4) tools/compress_pipeline.py
     --slim on l3's checkpoint, then entry.build_headline on the spec it
     wrote with its slimmed tree, served at B=16 (127 int8 convs a batch),
     the NMS pair held bit for bit against its plain versions on a served
     batch's candidates, the int8 conv on every conv at the new widths, and
     the headline in f32 on the card (TF32 off) against the plain path on
     the CPU (phase f's limits). Its kernel checks' worst
     errors join the kernels line's rows.

    python3 chip_smoke.py --step TREE

runs phase a and g3's step measurement alone on the cocodet_tpu_torch
package of TREE (an earlier commit unpacked with ``git archive``, or this
checkout) and prints it as one ``step: {...}`` JSON line: two commits are
compared in one call by running both, in turns.

    python3 chip_smoke.py --phase j

runs phase a and phase j alone (its checks and its kernel line, without
the ``ok`` line): the trainer's numbers without the state of phases b-i.

    python3 chip_smoke.py --phase j1

runs phase a and j1 alone (K1-K4's checks on every case, their times and
bounds, as one ``j1: {...}`` JSON line, without the ``ok`` line).

    python3 chip_smoke.py --phase k

runs phase a and phase k alone (without the kernels and ``ok`` lines).

    python3 chip_smoke.py --phase l

runs phase a and phase l alone (without the kernels and ``ok`` lines).

Output: one line per phase, a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
STRIDES = (8, 16, 32, 64)
BATCH = 16
SIZE = 640
N_BATCHES = 4
TRAIN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 on the tensor cores
HOLD_CYCLES = 200_000_000  # ~0.1 s of the card's clock, while cuda_ms queues its calls
CARD_CYCLES_PER_S = 1.98e9  # H100 SXM's highest SM clock
# PR 1's kernel times at B=16, K=1024 on the dense scene (NVIDIA H100 80GB
# HBM3, 700.00 W; this script at commit 20314f9), printed beside this run's
# for comparison and kept out of the kernels line
PR1_DENSE_MS = {"overlap_matrix": 0.0818, "greedy_keep": 0.9188, "steps only": 0.1083}


def _logit(p):
    import numpy as np

    p = np.clip(p, 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


def dense_scene(seed, size=SIZE, n_true=250, widen=0.0):
    """NHWC head maps of tests/test_topk_equivalence.py::_dense_scene (the
    same numpy draws): n_true planted boxes on level 0 and noise everywhere
    else, ~8k candidates above conf 0.001. Its boxes are about one cell
    wide, so no pair reaches IoU 0.55; ``widen`` adds to the log-size
    logits (1.5: ~4.5 cells wide) so that neighbours overlap around the
    threshold and the NMS suppresses."""
    import numpy as np

    rs = np.random.RandomState(seed)
    shapes = [(size // s, size // s) for s in STRIDES]
    h0, w0 = shapes[0]
    cells = rs.choice(h0 * w0, size=n_true, replace=False)
    true_scores = rs.uniform(0.004, 0.9, n_true)
    maps = []
    for li, (h, w) in enumerate(shapes):
        reg = rs.uniform(-0.2, 0.2, (1, h, w, 4)).astype(np.float32)
        reg[..., 2:4] = rs.uniform(-0.3, 0.3, (1, h, w, 2)) + widen
        obj = _logit(rs.uniform(0.0011, 0.02, (1, h, w, 1))).astype(np.float32)
        cls = np.full((1, h, w, 80), _logit(0.999), np.float32)
        if li == 0:
            for cell, sc in zip(cells, true_scores):
                cy, cx = divmod(int(cell), w0)
                obj[0, cy, cx, 0] = _logit(sc)
        maps.append({"reg": reg, "obj": obj, "cls": cls})
    return maps


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, hold=True):
    """Mean device time of ``fn`` in ms over ``iters`` calls, after warm-up.
    With ``hold``, a sleep kernel holds the card while the host queues the
    calls, so that the calls run back to back on the card: a kernel shorter
    than its launch on the host is timed on the card, not at the rate the
    host launches. The hold lasts at least twice the host's time to queue
    the calls (timed on one warm-up call), so a forward of hundreds of
    launches is timed on the card too. Without it, the timer of
    chip_smoke.py before the hold."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    queue_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(max(HOLD_CYCLES, int(2 * iters * queue_s * CARD_CYCLES_PER_S)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from cocodet_tpu_torch.ops import host_build
    from cocodet_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    built = build.build()
    seconds = time.perf_counter() - t0
    # a line a source: its kernels' most registers, shared memory and
    # spilled bytes; the whole ptxas report goes beside the library
    for name, (_, log) in built.items():
        (build.BUILD_DIR / f"ptxas-{name}.log").write_text(log)
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
        smem = [int(v) for v in re.findall(r"(\d+) bytes smem", log)] or [0]
        spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", log))
        print(f"  ptxas {name}: {len(regs)} kernels, at most {max(regs, default=0)} registers "
              f"and {max(smem)} bytes of static shared memory, {spill} bytes spilled")
    print(f"a. build: {len(built)} of {len(build.sources())} CUDA sources compiled "
          f"in {seconds:.2f} s (nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    t0 = time.perf_counter()
    host = host_build.build()
    host_s = time.perf_counter() - t0
    print(f"a. build: {len(host)} of {len(host_build.sources())} host C++ sources compiled in "
          f"{host_s:.2f} s (g++ {' '.join(host_build.CXX_FLAGS)})", flush=True)
    return seconds + host_s


def kernel_inputs(batch_maps, k, device):
    """(class-offset boxes, valid) as batched_nms hands them to the kernels,
    from the dense-scene head maps at pre-NMS top-K ``k``."""
    import torch

    from cocodet_tpu_torch.ops.nms import class_offset_boxes
    from cocodet_tpu_torch.ops.postprocess import PostprocessConfig, _select_topk_fused

    maps = [{key: torch.from_numpy(v).to(device) for key, v in m.items()} for m in batch_maps]
    cfg = PostprocessConfig(conf_threshold=0.001, nms_threshold=0.55, pre_nms_topk=k)
    boxes, _, classes, _, valid = _select_topk_fused(maps, STRIDES, cfg)
    return class_offset_boxes(boxes, classes, valid).contiguous(), valid.contiguous()


def random_candidates(batch, k, seed, device, size=SIZE, n_classes=80):
    """(class-offset boxes, valid) for ``k`` numpy-drawn candidates a image,
    an eighth of them shifted copies of others at IoU near 0.55: the
    largest K the keep kernel takes is more than a 640 px image's 8500
    anchors give."""
    import numpy as np
    import torch

    from cocodet_tpu_torch.ops.nms import class_offset_boxes

    rs = np.random.RandomState(seed)
    centers = rs.rand(batch, k, 2) * size
    wh = rs.rand(batch, k, 2) * 60 + 4
    classes = rs.randint(0, n_classes, (batch, k)).astype(np.int32)
    src, dst = rs.randint(0, k, (2, batch, k // 8))
    for b in range(batch):
        shift = wh[b, src[b], 0] * 0.45 / 1.55 * (1 + rs.uniform(-1e-3, 1e-3, k // 8))
        centers[b, dst[b]] = centers[b, src[b]] + np.stack([shift, 0 * shift], -1)
        wh[b, dst[b]] = wh[b, src[b]]
        classes[b, dst[b]] = classes[b, src[b]]
    boxes = torch.from_numpy(np.concatenate([centers - wh / 2, centers + wh / 2], -1)
                             .astype(np.float32))
    classes = torch.from_numpy(classes)
    valid = torch.from_numpy(rs.rand(batch, k) > 0.15)
    boxes = class_offset_boxes(boxes, classes, valid)
    return boxes.to(device).contiguous(), valid.to(device).contiguous()


def kernel_times(boxes, valid, thr):
    """Device ms of both NMS kernels and of their plain versions on these
    inputs, with each kernel's bound for the work these inputs need."""
    import torch

    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk

    mask = nk.overlap_matrix(boxes, valid, thr)
    keep = nk.greedy_keep(mask, valid)
    b, k = valid.shape
    w = nk.packed_width(k)
    # overlap: each box and flag read once, each packed word written once;
    # ~20 f32 ops for every pair above the diagonal
    ov_bytes = b * k * (16 + 1) + b * k * w * 8
    ov_ops = b * k * (k - 1) // 2 * 20
    # keep: the words from the diagonal on of the kept rows, valid, keep
    kept_rows = keep.nonzero()[:, 1]
    keep_bytes = float(((w - kept_rows // 64) * 8).sum()) + 2 * b * k
    torch.cuda.synchronize()
    return {
        "overlap_matrix": dict(
            ms=cuda_ms(lambda: nk.overlap_matrix(boxes, valid, thr), 50),
            plain_ms=cuda_ms(lambda: nk.overlap_matrix_plain(boxes, valid, thr), 10),
            bound_ms=max(ov_bytes / HBM_BYTES_PER_S, ov_ops / F32_OPS_PER_S) * 1e3,
            bound_by="bytes" if ov_bytes / HBM_BYTES_PER_S >= ov_ops / F32_OPS_PER_S
            else "operations"),
        "greedy_keep": dict(
            ms=cuda_ms(lambda: nk.greedy_keep(mask, valid), 50),
            plain_ms=cuda_ms(lambda: nk.greedy_keep_plain(mask, valid), 3),
            bound_ms=keep_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes"),
    }


def check_kernels(label, boxes, valid, thr):
    """Hold both kernels against their plain versions on these inputs, bit
    for bit; the max abs error of each (0/1 outputs: 1 if any bit differs)."""
    import torch

    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk

    mask = nk.overlap_matrix(boxes, valid, thr)
    mask_plain = nk.overlap_matrix_plain(boxes, valid, thr)
    keep = nk.greedy_keep(mask, valid)
    keep_plain = nk.greedy_keep_plain(mask_plain, valid)
    torch.cuda.synchronize()
    err = {"overlap_matrix": float(((mask ^ mask_plain) != 0).any()),
           "greedy_keep": float((keep != keep_plain).any())}
    ones = int(sum(int(((mask >> j) & 1).sum()) for j in range(64)))
    print(f"{label}: mask {tuple(mask.shape)} int64, overlap_matrix max_abs_err="
          f"{err['overlap_matrix']} (overlapping pairs={ones}), greedy_keep max_abs_err="
          f"{err['greedy_keep']} (valid={int(valid.sum())}, kept={int(keep.sum())})", flush=True)
    if not (torch.equal(mask, mask_plain) and torch.equal(keep, keep_plain)):
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return err


def phase_kernels(device):
    import numpy as np
    import torch

    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk

    def batched(widen, batch=BATCH):
        scenes = [dense_scene(seed, widen=widen) for seed in range(batch)]
        return [{key: np.concatenate([s[i][key] for s in scenes]) for key in ("reg", "obj", "cls")}
                for i in range(len(STRIDES))]

    thr = 0.55
    worst = {"overlap_matrix": 0.0, "greedy_keep": 0.0}
    scenes = [(f"dense scene widen={widen} K={k} B={BATCH}",
               lambda widen=widen, k=k: kernel_inputs(batched(widen), k, device))
              for widen, k in ((1.5, 1024), (1.5, 340), (1.5, 2048), (0.0, 340), (0.0, 1024))]
    scenes.append(("dense scene widen=1.5, all 8500 anchors, B=2",
                   lambda: kernel_inputs(batched(1.5, batch=2), 8500, device)))
    scenes.append((f"random boxes at the keep kernel's largest K={nk.MAX_KEEP_K}, B=2",
                   lambda: random_candidates(2, nk.MAX_KEEP_K, 0, device)))
    for label, make in scenes:
        err = check_kernels(f"b. {label}", *make(), thr)
        worst = {name: max(worst[name], e) for name, e in err.items()}

    # Times at the main path's shape: widen 0.0 (every valid row kept, few
    # pairs near the threshold) and widen 1.5 (the NMS suppresses).
    earlier = "PR 1's time on this scene, from PERF.md, not measured here"
    for widen, before in ((0.0, PR1_DENSE_MS), (1.5, None)):
        boxes, valid = kernel_inputs(batched(widen), 1024, device)
        for name, s in kernel_times(boxes, valid, thr).items():
            print(f"b. {name} at B={BATCH} K=1024 widen={widen}: {s['ms']:.4f} ms (plain "
                  f"{s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms by {s['bound_by']})"
                  + (f"; {earlier}: {before[name]} ms" if before else ""), flush=True)
        if widen == 0.0:
            # no valid row: no row kept, none OR-ed; the chain of K steps alone
            mask = nk.overlap_matrix(boxes, valid, thr)
            steps_ms = cuda_ms(lambda: nk.greedy_keep(mask, torch.zeros_like(valid)), 50)
            full_read_ms = (mask.numel() * 8 + 2 * valid.numel()) / HBM_BYTES_PER_S * 1e3
            print(f"b. greedy_keep steps only at K=1024: {steps_ms:.4f} ms for the 1024 row "
                  f"decisions with no valid row; bound if every word were read: "
                  f"{full_read_ms:.4f} ms; {earlier}: {PR1_DENSE_MS['steps only']} ms", flush=True)
    return worst


def serving_variables(seed=0):
    """Flax-layout random variables of the full-width model, with the
    obj/cls prediction biases at logit(0.1) so that thousands of anchors pass
    conf 0.001 and the NMS does real work."""
    import torch

    from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
    from cocodet_tpu_torch.utils.convert import random_variables

    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.67, width=0.75)
    variables = random_variables(shapes, seed)
    for k in range(len(STRIDES)):
        for name in (f"obj_pred{k}", f"cls_pred{k}"):
            bias = variables["params"]["head"][name]["bias"]
            bias[:] = float(_logit(0.1))
    return variables


def phase_serve(device, variables, card):
    import numpy as np
    import torch

    from cocodet_tpu_torch.entry import build_predictor
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs
    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk
    from cocodet_tpu_torch.ops.nms import batched_nms, class_offset_boxes, compact
    from cocodet_tpu_torch.ops.postprocess import _select_topk_fused, postprocess

    t0 = time.perf_counter()
    predictor = build_predictor(variables, device=device)
    setup_s = time.perf_counter() - t0
    rs = np.random.RandomState(1)
    batches = [rs.uniform(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
               for _ in range(N_BATCHES)]
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    predictor(batches[0])  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    predictor(batches[0])  # and the allocator settles after their workspaces
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(device)
    nk.reset_launch_counts()
    hs.reset_launch_counts()
    latencies, results = [], []
    t_all = time.perf_counter()
    for images in batches:
        t = time.perf_counter()
        res = predictor(images)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t) * 1e3)
        results.append(res)
    wall = time.perf_counter() - t_all
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    launches = {"overlap_matrix": nk.overlap_matrix.launches,
                "greedy_keep": nk.greedy_keep.launches,
                "hard_swish": hs.hard_swish.launches}

    for res in results:
        if res.boxes.shape != (BATCH, 300, 4):
            raise AssertionError(f"served boxes have shape {tuple(res.boxes.shape)}")
        for field in ("boxes", "scores", "obj"):
            if not torch.isfinite(getattr(res, field)).all():
                raise AssertionError(f"non-finite {field} in a served result")
    for name, n in launches.items():
        if n < N_BATCHES:
            raise AssertionError(f"{name} launched {n} times on the main path")
    dets = [int(r.valid.sum()) for r in results]
    print(f"c. setup {setup_s:.2f} s (weights from numpy seed 0, BN folded, bf16), "
          f"warm-up batch {warm_s:.2f} s; launches on the served path: {launches}; "
          f"peak device memory while serving {peak_gib:.2f} GiB", flush=True)
    print(f"c. served {N_BATCHES} batches x {BATCH} requests, {SIZE}x{SIZE} bf16, on {card}: "
          f"{N_BATCHES * BATCH / wall:.2f} img/s, batch latency ms "
          f"{', '.join(f'{x:.2f}' for x in latencies)}; detections per batch {dets}", flush=True)

    # where a batch's time goes (device time, CUDA events), after the counted run
    images = torch.from_numpy(batches[1])
    x = images.to(device)
    cfg = predictor.cfg
    with torch.inference_mode():
        maps = predictor.model(x)
        sel = _select_topk_fused(maps, STRIDES, cfg)
        boxes, scores, classes, obj, valid = sel
        thr = cfg.nms_threshold
        nms_boxes = class_offset_boxes(boxes, classes, valid).contiguous()
        # the kernels on the served candidates: checked, then timed; these
        # are the times of the kernels line
        worst = check_kernels(f"c. served candidates K={valid.shape[1]} B={BATCH}",
                              nms_boxes, valid, thr)
        stats = kernel_times(nms_boxes, valid, thr)
        for name, s in stats.items():
            s["max_abs_err"] = worst[name]
            print(f"c. {name} on the served candidates: {s['ms']:.4f} ms (plain "
                  f"{s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms by {s['bound_by']})",
                  flush=True)
        keep = nk.greedy_keep(nk.overlap_matrix(nms_boxes, valid, thr), valid)
        parts = {
            "h2d_copy": cuda_ms(lambda: images.to(device), 5),
            "forward": cuda_ms(lambda: predictor.model(x), 10),
            "postprocess": cuda_ms(lambda: postprocess(maps, STRIDES, cfg), 10),
            "of which select_topk": cuda_ms(lambda: _select_topk_fused(maps, STRIDES, cfg), 10),
            "of which nms": cuda_ms(lambda: batched_nms(
                *sel, iou_threshold=thr, max_det=cfg.max_det), 10),
            "of which class_offset": cuda_ms(
                lambda: class_offset_boxes(boxes, classes, valid).contiguous(), 10),
            "of which overlap": stats["overlap_matrix"]["ms"],
            "of which keep": stats["greedy_keep"]["ms"],
            "of which compaction": cuda_ms(
                lambda: compact(keep, boxes, scores, classes, obj, cfg.max_det), 10),
        }
        # the same parts with the card not held: the timer of PR 1's runs
        unheld = {
            "postprocess": cuda_ms(lambda: postprocess(maps, STRIDES, cfg), 10, hold=False),
            "of which select_topk": cuda_ms(
                lambda: _select_topk_fused(maps, STRIDES, cfg), 10, hold=False),
            "of which nms": cuda_ms(lambda: batched_nms(
                *sel, iou_threshold=thr, max_det=cfg.max_det), 10, hold=False),
        }
    print("c. device ms per batch: " + ", ".join(f"{k}={v:.3f}" for k, v in parts.items()),
          flush=True)
    print("c. device ms per batch, card not held while the calls are queued: "
          + ", ".join(f"{k}={v:.3f}" for k, v in unheld.items()), flush=True)
    dense = {"img/s": N_BATCHES * BATCH / wall, "latency ms": latencies,
             "forward ms": parts["forward"], "postprocess ms": parts["postprocess"],
             "peak GiB": peak_gib}
    return launches, stats, predictor, dense


def phase_reference(device, variables, predictor):
    import numpy as np
    import torch

    from cocodet_tpu_torch.entry import build_predictor
    from cocodet_tpu_torch.models import build_model
    from cocodet_tpu_torch.ops.nms import batched_nms
    from cocodet_tpu_torch.ops.postprocess import _select_topk_fused

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images = np.random.RandomState(2).uniform(0, 255, (2, 256, 256, 3)).astype(np.float32)
    ref = build_model("yolox-p6", depth=0.67, width=0.75, device="cpu", variables=variables)
    f32 = build_predictor(variables, dtype=torch.float32, device=device)
    with torch.inference_mode():
        want = ref(torch.from_numpy(images))
        got32 = f32.model(torch.from_numpy(images).to(device))
        got16 = predictor.model(torch.from_numpy(images).to(device))
    w = torch.cat([m[k].reshape(-1) for m in want for k in m])
    g32 = torch.cat([m[k].reshape(-1).float().cpu() for m in got32 for k in m])
    g16 = torch.cat([m[k].reshape(-1).float().cpu() for m in got16 for k in m])
    err32 = float(((g32 - w).abs() / (1 + w.abs())).max())
    err16 = float((g16 - w).abs().mean() / w.abs().mean())
    print(f"d. head maps at 256 px vs the unfused f32 model on the CPU: fused f32 on the card "
          f"max |d|/(1+|v|) = {err32:.3e} (limit 1e-3); bf16 served model mean |d|/mean|v| = "
          f"{err16:.3e} (limit 5e-2)", flush=True)
    if not (err32 <= 1e-3 and err16 <= 5e-2 and torch.isfinite(g16).all()):
        raise AssertionError("the model on the card disagrees with the CPU reference")

    sel = _select_topk_fused(want, STRIDES, predictor.cfg)
    cpu = batched_nms(*sel, iou_threshold=0.55, max_det=300)
    gpu = batched_nms(*(t.to(device) for t in sel), iou_threshold=0.55, max_det=300)
    same = all(torch.equal(g.cpu(), c) for g, c in zip(gpu, cpu))
    print(f"d. NMS on the same f32 candidates: card (kernels) == CPU (plain): {same} "
          f"(valid {int(cpu.valid.sum())} of {cpu.valid.numel()})", flush=True)
    if not same:
        raise AssertionError("NMS on the card disagrees with the plain version on the CPU")


def headline_variables(seed=0):
    """Flax-layout random variables of the fused slim YOLOX-M-P6 of the
    committed channel plan, with the obj/cls prediction biases at logit(0.1)
    as in serving_variables."""
    import torch

    from cocodet_tpu_torch.compress import load_slim_spec
    from cocodet_tpu_torch.entry import SLIM_SPEC
    from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
    from cocodet_tpu_torch.utils.convert import random_variables

    slim = load_slim_spec(str(SLIM_SPEC))
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.67, width=0.75, fused=True, slim=slim)
    variables = random_variables(shapes, seed)
    for k in range(len(STRIDES)):
        for name in (f"obj_pred{k}", f"cls_pred{k}"):
            variables["params"]["head"][name]["bias"][:] = float(_logit(0.1))
    return slim, variables


def build_headline_model(device):
    """bench.py's headline through entry.build_headline, on the card."""
    from cocodet_tpu_torch.entry import build_headline

    slim, variables = headline_variables(seed=0)
    headline = build_headline(device=device, variables=variables)
    return headline, (slim, variables)


def w8a8_conv_inputs(model, images):
    """(name, conv, input, output dtype) of every w8a8 conv in one forward
    of ``images`` (forward hooks), and the forward's head maps."""
    import torch

    from cocodet_tpu_torch.models.blocks import Conv2d

    records, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, Conv2d) and m.quant == "w8a8":
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, name=name: records.append((name, mod, args[0], out.dtype))))
    try:
        with torch.inference_mode():
            maps = model(images)
    finally:
        for h in hooks:
            h.remove()
    return records, maps


def conv_bound(x, weight, y_numel, out_dtype, vec):
    """(bytes, operations) of one w8a8 conv: each input read once (x, the
    int8 weight, the scales, the bias), the output written once; 2 ops a
    multiply-accumulate."""
    import torch

    o, c, kh, kw = weight.shape
    out_size = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (x.numel() * x.element_size() + weight.numel() + 4 * o + 4 * (c if vec else 1)
              + o * out_size + y_numel * out_size)
    ops = 2 * y_numel * c * kh * kw
    return nbytes, ops


def check_int8_conv(label, x, weight, act_scale, w_scale, bias, stride, out_dtype):
    """Kernel against plain version on the card, accumulators and outputs
    bit for bit, with no activation and with the fused hard-swish; returns
    the max abs error."""
    import torch

    from cocodet_tpu_torch.ops.cuda import int8_conv as ic

    pad = (weight.shape[-1] - 1) // 2
    acc_plain = ic.int8_conv_acc_plain(ic.quantize_activations(x, act_scale), weight, stride, pad)
    err = 0.0
    for act in (None, "hard_swish"):
        y, acc = ic.int8_conv_acc(x, weight, act_scale, w_scale, bias, stride, pad,
                                  dtype=out_dtype, act=act)
        y_plain = ic.apply_act(ic.rescale_plain(acc_plain, act_scale, w_scale, bias, out_dtype),
                               act)
        torch.cuda.synchronize()
        err = max(err, float((acc.double() - acc_plain.double()).abs().max()),
                  float((y.double() - y_plain.double()).nan_to_num().abs().max()))
        if not (torch.equal(acc, acc_plain) and torch.equal(y, y_plain)):
            raise AssertionError(f"int8 conv disagrees with its plain version: {label}, act "
                                 f"{act}: {int((acc != acc_plain).sum())} accumulators, "
                                 f"{int((y != y_plain).sum())} outputs differ, max err {err}")
    return err


def check_hard_swish(device):
    """The port's hard_swish on the card (the kernel) against the CPU (the
    plain version): every bf16 bit pattern that is not a NaN, and 2^20 f32
    values in [-4, 4]. Equal bits, or NaN on both (-inf gives -inf * 0)."""
    import torch

    from cocodet_tpu_torch.models.blocks import hard_swish

    bf16 = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    bf16 = bf16[~torch.isnan(bf16)]
    f32 = torch.linspace(-4, 4, 1 << 20)
    counts = []
    for x, as_int in ((bf16, torch.int16), (f32, torch.int32)):
        got, want = hard_swish(x.to(device)).cpu(), hard_swish(x)
        same = (got.view(as_int) == want.view(as_int)) | (torch.isnan(got) & torch.isnan(want))
        counts.append((int((~same).sum()), x.numel()))
    print(f"e. hard_swish on the card vs the CPU: bf16 {counts[0][0]} of {counts[0][1]} non-NaN "
          f"bit patterns differ, f32 {counts[1][0]} of {counts[1][1]} values in [-4, 4] differ",
          flush=True)
    if counts[0][0] or counts[1][0]:
        raise AssertionError("hard_swish on the card differs from the CPU")


def phase_int8_conv(device, headline):
    import numpy as np
    import torch

    from cocodet_tpu_torch.ops.cuda import int8_conv as ic

    model = headline.model
    worst = 0.0
    # every conv of the headline at its served shapes, on a batch of 2
    x2 = torch.from_numpy(np.random.RandomState(3).uniform(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)).to(device)
    records, _ = w8a8_conv_inputs(model, x2)
    if len(records) != 127:
        raise AssertionError(f"the headline has {len(records)} w8a8 convs, expected 127")
    kinds = {}
    for name, m, x, odt in records:
        worst = max(worst, check_int8_conv(name, x, m.weight, m.act_scale, m.w_scale,
                                           m.bias.detach().to(odt), m.stride, odt))
        key = (m.weight.shape[-1], m.stride, "C%32" if x.shape[1] % 32 else "C=32n")
        kinds[key] = kinds.get(key, 0) + 1
    print(f"e. int8 conv == plain version (s32 accumulators and outputs, bit for bit, with no "
          f"activation and with the fused hard-swish) on all {len(records)} w8a8 convs of the "
          f"headline at B=2 {SIZE}x{SIZE}; kinds (k, stride, C) {kinds}", flush=True)
    del records

    # ragged cases: B, C, H, W, O, k, stride, x dtype, out dtype, vector act_scale
    f32, bf16 = torch.float32, torch.bfloat16
    ragged = [(2, 12, 33, 31, 32, 3, 1, f32, bf16, False),
              (2, 12, 17, 19, 40, 3, 2, f32, f32, True),
              (2, 64, 33, 31, 64, 3, 2, bf16, f32, True), (1, 32, 7, 9, 40, 1, 1, f32, f32, False),
              (3, 48, 17, 15, 50, 3, 2, bf16, bf16, True),
              (2, 96, 21, 23, 72, 3, 1, bf16, bf16, False),
              (1, 928, 5, 5, 768, 1, 1, f32, bf16, True),
              (2, 576, 11, 9, 256, 3, 2, bf16, bf16, False),
              (2, 64, 37, 45, 96, 3, 2, bf16, bf16, True),
              (2, 160, 10, 10, 288, 3, 1, bf16, f32, True)]
    g = torch.Generator().manual_seed(0)
    for (b, c, h, w, o, k, stride, xdt, ydt, vec) in ragged:
        x = (torch.rand((b, c, h, w), generator=g) * 80 - 20).to(xdt).to(device)
        weight = torch.randint(-127, 128, (o, c, k, k), generator=g, dtype=torch.int8).to(device)
        act = (torch.rand((c,) if vec else (), generator=g) * 0.3 + 0.05).to(device)
        w_scale = (torch.rand((o,), generator=g) * 1e-2 + 1e-3).to(device)
        bias = (torch.rand((o,), generator=g) * 2 - 1).to(ydt).to(device)
        cl = torch.channels_last
        worst = max(worst, check_int8_conv(
            f"ragged {(b, c, h, w, o, k, stride, xdt, ydt, vec)}", x.contiguous(memory_format=cl),
            weight.contiguous(memory_format=cl), act, w_scale, bias, stride, ydt))
    print(f"e. int8 conv == plain version on {len(ragged)} ragged cases (cin=12, odd H and W "
          f"at stride 2, patches cut by the image edge, M not a multiple of the tile, O "
          f"above one slice of the tile plan (928 -> 768, 160 -> 288), scalar and vector "
          f"act_scale, f32 and bf16 in and out); max abs err {worst}", flush=True)
    check_hard_swish(device)

    # times on a served batch of 16, one timing for each distinct shape
    x16 = torch.from_numpy(np.random.RandomState(4).uniform(
        0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)).to(device)
    records, _ = w8a8_conv_inputs(model, x16)
    timed = {}
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
    # activation elements the kernel quantizes (its tile plan), and those the
    # convs read
    quantized = inputs = 0
    largest = None
    for name, m, x, odt in records:
        bias = m.bias.detach().to(odt)
        args = (x, m.weight, m.act_scale, m.w_scale, bias, m.stride, m.padding)
        key = (tuple(x.shape), x.dtype, tuple(m.weight.shape), m.stride, m.act_scale.dim(), odt)
        if key not in timed:  # as served: hard-swish fused
            timed[key] = (cuda_ms(lambda: ic.conv2d_w8a8(*args, dtype=odt, act="hard_swish"), 10),
                          cuda_ms(lambda: ic.conv2d_w8a8_plain(*args, dtype=odt,
                                                               act="hard_swish"), 1))
        ms, plain_ms = timed[key]
        y_numel = x.shape[0] * m.weight.shape[0] * (
            (x.shape[2] + 2 * m.padding - m.weight.shape[2]) // m.stride + 1) * (
            (x.shape[3] + 2 * m.padding - m.weight.shape[3]) // m.stride + 1)
        nbytes, ops = conv_bound(x, m.weight, y_numel, odt, m.act_scale.dim() == 1)
        quantized += ic.quantized_elements(x.shape, m.weight.shape, m.stride)
        inputs += x.numel()
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        parts = {"ms": ms, "plain_ms": plain_ms, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "ops_ms": ops / INT8_OPS_PER_S * 1e3, "bound_ms": bound}
        for k_, v in parts.items():
            total[k_] += v
        if largest is None or ms > largest[1]:
            largest = (name, ms, bound, tuple(x.shape), tuple(m.weight.shape), m.stride)
        if name == "backbone.backbone.stem.conv.conv":
            stem = (ms, bound)
    del records
    print(f"e. int8 conv at B={BATCH} {SIZE}x{SIZE}, {len(timed)} distinct shapes timed: "
          f"sum over the 127 launches {total['ms']:.4f} ms (plain version "
          f"{total['plain_ms']:.4f} ms); "
          f"bound {total['bound_ms']:.4f} ms (bytes {total['bytes_ms']:.4f} ms at 3.35 TB/s, "
          f"operations {total['ops_ms']:.4f} ms at 1979 TOP/s); activation elements quantized "
          f"{quantized / 1e9:.3f} G ({quantized / inputs:.2f}x), read by the convs "
          f"{inputs / 1e9:.3f} G; the Focus stem {stem[0]:.4f} ms (bound {stem[1]:.4f} ms); "
          f"largest single conv {largest[0]} "
          f"x {largest[3]} w {largest[4]} stride {largest[5]}: {largest[1]:.4f} ms (bound "
          f"{largest[2]:.4f} ms)", flush=True)
    if quantized > 2 * inputs:
        raise AssertionError(f"the int8 conv quantizes {quantized / inputs:.2f}x the elements "
                             f"the convs read (limit 2x)")
    return {"max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations"}


def same_set(g, w, gc, wc, box_tol=(1e-2, 1e-3), score_tol=1e-4):
    """True if the rows of g and w ((n, 4) boxes then a score column, numpy)
    with classes gc, wc are the same set: equal counts and a cover of
    same-class pairs with boxes within box_tol (px, relative) and scores
    within score_tol."""
    import numpy as np

    if len(g) != len(w):
        return False
    tol = np.concatenate([box_tol[0] + box_tol[1] * np.abs(w[:, :4]),
                          np.full((len(w), 1), score_tol)], 1)
    close = (np.abs(g[:, None, :] - w[None, :, :]) <= tol[None]).all(-1)
    match = close & (np.asarray(gc)[:, None] == np.asarray(wc)[None])
    return bool(match.any(1).all() and match.any(0).all())


def match_detections(got, want, box_tol=(1e-2, 1e-3), score_tol=1e-4):
    """True if each image's detections are the same set (``same_set``)."""
    import numpy as np

    for b in range(want.valid.shape[0]):
        n = int(want.valid[b].sum())
        if int(got.valid[b].sum()) != n or not bool(got.valid[b, :n].all()):
            return False
        g = np.concatenate([got.boxes[b, :n].numpy(), got.scores[b, :n, None].numpy()], 1)
        w = np.concatenate([want.boxes[b, :n].numpy(), want.scores[b, :n, None].numpy()], 1)
        if not same_set(g, w, got.classes[b, :n].numpy(), want.classes[b, :n].numpy(),
                        box_tol, score_tol):
            return False
    return True


def match_records(got, want):
    """True if the COCO records of each image are the same set
    (``same_set`` on the xywh boxes, scores and category ids)."""
    import numpy as np

    def by_image(records):
        out = {}
        for r in records:
            out.setdefault(r["image_id"], []).append(r)
        return out

    g, w = by_image(got), by_image(want)
    if g.keys() != w.keys():
        return False
    rows = lambda rs: np.asarray([r["bbox"] + [r["score"]] for r in rs], np.float64)
    cats = lambda rs: [r["category_id"] for r in rs]
    return all(same_set(rows(g[k]), rows(w[k]), cats(g[k]), cats(w[k])) for k in w)


def compare_card_cpu(on_card, on_cpu, images, device):
    """The int8 inputs that differ (per conv, first conv in execution order
    with any), the head maps' max |d|/(1+|v|) and mean |d|/mean|v|, and
    whether the detections are the same sets."""
    import torch

    from cocodet_tpu_torch.ops.cuda import int8_conv as ic

    rec_g, maps_g = w8a8_conv_inputs(on_card.model, images.to(device))
    rec_c, maps_c = w8a8_conv_inputs(on_cpu.model, images)
    differ = [(n, int((ic.quantize_activations(xg, mg.act_scale).cpu()
                       != ic.quantize_activations(xc, mc.act_scale)).sum()))
              for (n, mg, xg, _), (_, mc, xc, _) in zip(rec_g, rec_c)]
    if len(differ) != 127:
        raise AssertionError(f"{len(differ)} w8a8 convs, expected 127")
    n_in = sum(int(xc.numel()) for _, _, xc, _ in rec_c)
    first = next(((n, d) for n, d in differ if d), None)
    keys = ("reg", "obj", "cls")
    g = torch.cat([m[k].reshape(-1).float().cpu() for m in maps_g for k in keys])
    w = torch.cat([m[k].reshape(-1).float() for m in maps_c for k in keys])
    d = (g - w).abs()
    res = {"inputs": sum(v for _, v in differ), "max": float((d / (1 + w.abs())).max()),
           "mean": float(d.mean() / w.abs().mean())}
    with torch.inference_mode():
        det_g, det_c = on_card(images), on_cpu(images)
    res["same"] = match_detections(type(det_g)(*(t.cpu() for t in det_g)), det_c)
    res["line"] = (f"int8 inputs that differ {res['inputs']} of {n_in} over 127 convs (first: "
                   f"{first}); head maps max |d|/(1+|v|) = {res['max']:.3e}, mean |d|/mean|v| = "
                   f"{res['mean']:.3e}; detections the same sets: {res['same']} "
                   f"({int(det_c.valid.sum())} of {det_c.valid.numel()})")
    return res


def phase_headline(device, card, headline, slim_vars, dense):
    import numpy as np
    import torch

    from cocodet_tpu_torch.entry import build_w8a8_predictor, cast_parameters
    from cocodet_tpu_torch.models import build_model
    from cocodet_tpu_torch.ops.cuda import int8_conv as ic
    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk
    from cocodet_tpu_torch.ops.postprocess import postprocess

    secs = headline.seconds
    rs = np.random.RandomState(1)
    batches = [rs.uniform(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
               for _ in range(N_BATCHES)]
    for _ in range(2):  # warm-up: cuDNN picks the prediction convs' algorithms
        headline(batches[0])
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ic.reset_launch_counts()
    nk.reset_launch_counts()
    latencies, results = [], []
    t_all = time.perf_counter()
    for images in batches:
        t = time.perf_counter()
        results.append(headline(images))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t_all
    launches = {"int8_conv": ic.conv2d_w8a8.launches, "overlap_matrix": nk.overlap_matrix.launches,
                "greedy_keep": nk.greedy_keep.launches}
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    want = {"int8_conv": 127 * N_BATCHES, "overlap_matrix": N_BATCHES, "greedy_keep": N_BATCHES}
    if launches != want:
        raise AssertionError(f"headline launches {launches}, expected {want}")
    for res in results:
        if res.boxes.shape != (BATCH, 300, 4):
            raise AssertionError(f"served boxes have shape {tuple(res.boxes.shape)}")
        for field in ("boxes", "scores", "obj"):
            if not torch.isfinite(getattr(res, field)).all():
                raise AssertionError(f"non-finite {field} in a served headline result")
    dets = [int(r.valid.sum()) for r in results]
    print(f"f. build_headline: build {secs['build']:.2f} s, calibration {secs['calibrate']:.2f} s, "
          f"quantization {secs['quantize']:.2f} s (slim w8a8 YOLOX-M-P6, weights from numpy "
          f"seed 0, per-channel activation scales); launches on the served path: {launches}",
          flush=True)

    x = torch.from_numpy(batches[1]).to(device)
    model, cfg = headline.model, headline.cfg
    slim, variables = slim_vars
    cudnn_slim = cast_parameters(build_model("yolox-p6", depth=0.67, width=0.75, fused=True,
                                             slim=slim, device=device, variables=variables),
                                 torch.bfloat16)
    with torch.inference_mode():
        maps = model(x)
        forward_ms = cuda_ms(lambda: model(x), 10)
        post_ms = cuda_ms(lambda: postprocess(maps, STRIDES, cfg), 10)
        cudnn_ms = cuda_ms(lambda: cudnn_slim(x), 10)
    del cudnn_slim
    print(f"f. headline served {N_BATCHES} batches x {BATCH} requests, {SIZE}x{SIZE}, on {card}: "
          f"{N_BATCHES * BATCH / wall:.2f} img/s, batch latency ms "
          f"{', '.join(f'{v:.2f}' for v in latencies)}; device ms per batch: forward "
          f"{forward_ms:.3f}, postprocess {post_ms:.3f}; peak device memory while serving "
          f"{peak_gib:.2f} GiB; detections per batch {dets}", flush=True)
    print(f"f. for context, the same slim model in bf16 through cuDNN (a different function: "
          f"no quantization): forward {cudnn_ms:.3f} ms; the dense bf16 model of phase c: "
          f"{dense['img/s']:.2f} img/s, batch latency ms "
          f"{', '.join(f'{v:.2f}' for v in dense['latency ms'])}, forward "
          f"{dense['forward ms']:.3f} ms, postprocess {dense['postprocess ms']:.3f} ms, peak "
          f"{dense['peak GiB']:.2f} GiB",
          flush=True)

    # The headline as served on the card against the plain path on the CPU,
    # with the same quantized variables, on 2 images of 256 px. Every op but
    # the 12 float prediction convs computes alike on both: the int8 conv
    # and its fused hard-swish are bit for bit their plain version, and so
    # are the pools, the upsample, the concats and the adds. So no int8
    # input may differ (limit 0). In f32 the head maps then differ only by
    # the prediction convs' summation order, cuDNN against oneDNN (limit
    # 1e-4 * (1 + |v|), 100x the 1e-6 seen between XLA and oneDNN on the
    # CPU), and the detections must be the same sets at the tolerance of
    # tests/test_torch_entry.py. In bf16 the prediction convs round
    # differently too: the bf16 limit of phase d on the maps.
    images = torch.from_numpy(np.random.RandomState(2).uniform(
        0, 255, (2, 256, 256, 3)).astype(np.float32))
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        on_card = build_w8a8_predictor(headline.variables, slim, dtype=dtype, device=device)
        on_cpu = build_w8a8_predictor(headline.variables, slim, dtype=dtype, device="cpu")
        res = compare_card_cpu(on_card, on_cpu, images, device)
        limits = "0 inputs, 1e-4, same sets" if dtype == torch.float32 else \
            "0 inputs, mean |d|/mean|v| <= 5e-2"
        print(f"f. headline {name} as served, card vs plain path on the CPU, 2 x 256 px: "
              f"{res['line']}; limits: {limits}", flush=True)
        ok = res["inputs"] == 0 and (res["max"] <= 1e-4 and res["same"] if dtype == torch.float32
                                     else res["mean"] <= 5e-2)
        if not ok:
            raise AssertionError(f"the {name} headline on the card disagrees with the plain "
                                 f"path on the CPU")
    return launches


def training_batch(batch, size, seed, g=120, boxes=(5, 60), width=None):
    """(images (B, size, width, 3) f32 U(0, 255), labels (B, g, 5)) from a
    numpy seed: ``boxes`` boxes an image, [class, cx, cy, w, h] in pixels,
    sides 3-50% of the image, inside it, zero-padded to ``g``. ``width``
    defaults to ``size``."""
    import numpy as np

    rs = np.random.RandomState(seed)
    dims = np.array([width or size, size])
    images = rs.uniform(0, 255, (batch, size, dims[0], 3)).astype(np.float32)
    labels = np.zeros((batch, g, 5), np.float32)
    for b in range(batch):
        n = rs.randint(boxes[0], boxes[1] + 1)
        wh = rs.uniform(0.03, 0.5, (n, 2)) * dims
        c = rs.uniform(wh / 2, dims - wh / 2)
        labels[b, :n] = np.concatenate([rs.randint(0, 80, (n, 1)), c, wh], 1)
    return images, labels


def bit_diff(got, want):
    """(elements that differ, max |got - want| over them): equal bits, or NaN
    on both, is no difference."""
    import torch

    same = (got == want) & (torch.signbit(got) == torch.signbit(want))
    same |= torch.isnan(got) & torch.isnan(want)
    err = torch.where(same, 0.0, (got.double() - want.double()).abs())
    return int((~same).sum()), float(err.max())


def check_hard_swish_kernel(device):
    """g1: the hard-swish kernel against its plain version on the card, bit
    for bit, forward and backward: every non-NaN bf16 pattern (times 16
    cotangents for the backward) and 2^20 f32 values (the bend, the linear
    parts, +-3, 0, the clamp bounds and their neighbours), plus a
    misaligned view (the kernel's scalar loop) and a channels-last map with
    a cotangent in the default layout. Equal bits, or NaN on both."""
    import numpy as np
    import torch

    from cocodet_tpu_torch.ops.cuda import hard_swish as hs

    bf16 = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    bf16 = bf16[~torch.isnan(bf16)]
    rs = np.random.RandomState(10)
    cots = torch.tensor([1.0, -1.0, 0.5, 3.0, -2.5, 1e-3, 700.0, -0.3333, 1e30, 0.0]
                        + list(rs.normal(0, 2, 6)), dtype=torch.float32)
    xb = bf16.repeat(len(cots))
    gb = cots.repeat_interleave(bf16.numel()).to(torch.bfloat16)
    edges = torch.tensor([-3, 3, 0, -0.0, 6, -6, 2.9999998, -2.9999998, 3.0000002,
                          -3.0000002, float("inf"), float("-inf")])
    n = (1 << 20) - edges.numel()
    xf = torch.cat([torch.from_numpy(rs.uniform(-4, 4, n // 2).astype(np.float32)),
                    torch.from_numpy(rs.normal(0, 50, n - n // 2).astype(np.float32)), edges])
    gf = torch.from_numpy(rs.normal(0, 3, xf.numel()).astype(np.float32))
    x4 = torch.from_numpy(rs.uniform(-5, 5, (2, 24, 9, 7)).astype(np.float32))
    cases = [("bf16 all patterns", bf16, xb, gb), ("f32 2^20 values", xf, xf, gf),
             ("f32 misaligned view", xf[1:4097], xf[1:4097], gf[1:4097]),
             ("bf16 channels-last map", x4.to(torch.bfloat16).contiguous(
                 memory_format=torch.channels_last), x4.to(torch.bfloat16).contiguous(
                 memory_format=torch.channels_last), x4.flip(0).to(torch.bfloat16))]
    worst, lines = 0.0, []
    for label, x_fwd, x_bwd, g in cases:
        x_fwd, x_bwd, g = x_fwd.to(device), x_bwd.to(device), g.to(device)
        pairs = ((hs.hard_swish(x_fwd), hs.hard_swish_plain(x_fwd)),
                 (hs.hard_swish_grad(x_bwd, g), hs.hard_swish_grad_plain(x_bwd, g)))
        torch.cuda.synchronize()
        counts = []
        for got, want in pairs:
            n, err = bit_diff(got, want)
            counts.append((n, got.numel()))
            worst = max(worst, err)
        lines.append(f"{label}: forward {counts[0][0]} of {counts[0][1]} differ, backward "
                     f"{counts[1][0]} of {counts[1][1]} differ")
        if counts[0][0] or counts[1][0]:
            raise AssertionError(f"hard_swish kernel disagrees with its plain version: {label}")
    print("g1. hard_swish kernel == plain version on the card, bit for bit: "
          + "; ".join(lines), flush=True)
    return worst


def current_flags():
    """cuDNN's (deterministic, benchmark, allow_tf32) and the matmuls'
    allow_tf32."""
    import torch

    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def backend_flags(flags):
    """``current_flags()`` set to ``flags`` within; as they were afterwards."""
    import torch

    saved = current_flags()
    try:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = saved


def cudnn_deterministic():
    """cuDNN deterministic with no benchmark, TF32 off for convs and
    matmuls; the flags as they were afterwards."""
    return backend_flags((True, False, False, False))


def step_errors(a, b):
    """One train step ``a`` against ``b``, each (metrics, flat variables, fg
    mask): the largest relative difference of a loss, of a parameter leaf and
    of a BN statistic leaf (each to the leaf's largest value), and the fg
    anchors that differ."""
    import numpy as np

    out = {"loss": max(abs(a[0][k] - b[0][k]) / abs(b[0][k]) for k in b[0] if b[0][k])}
    for kind in ("params", "batch_stats"):
        out[kind] = max(float(np.abs(a[1][p] - w).max() / np.abs(w).max())
                        for p, w in b[1].items() if p[0] == kind)
    out["fg"] = int((np.asarray(a[2]) != np.asarray(b[2])).sum())
    return out


STEP_ERRORS = ("losses {loss:.2e}, params {params:.2e}, BN statistics {batch_stats:.2e}, "
               "fg anchors that differ {fg}")


def phase_train_parity(device):
    """g2: one step of build_trainer at a small size (depth 0.33, width
    0.125, 128 px, B=4, f32; TF32 off, cuDNN deterministic) on the card
    against the same step on the CPU, from the same seed. The SimOTA fg mask
    must be equal; the losses within 1e-4, each parameter leaf within 1e-3
    and each BN statistic within 1e-4 of its largest value. For scale, the
    CPU's f32 step against its own f64 step (printed beside): at this size
    f32 rounding alone moves a leaf by ~1e-4 of its value."""
    import torch

    from cocodet_tpu_torch.entry import build_trainer
    from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree

    images, labels = training_batch(4, 128, 7)
    runs = {}
    with cudnn_deterministic():
        for name, dev, dtype in (("card", device, torch.float32), ("cpu", "cpu", torch.float32),
                                 ("cpu f64", "cpu", torch.float64)):
            model, step = build_trainer(0.33, 0.125, torch.float32, dev, seed=1)
            model.to(dtype)
            model.dtype = dtype
            metrics, targets = step(torch.from_numpy(images).to(dev, dtype),
                                    torch.from_numpy(labels).to(dev), use_l1=True,
                                    return_targets=True)
            runs[name] = ({k: float(v) for k, v in metrics.items()},
                          flatten_tree(export_variables(model)), targets.fg_mask.cpu())

    card, floor = step_errors(runs["card"], runs["cpu"]), step_errors(runs["cpu"], runs["cpu f64"])
    print(f"g2. one train step, depth 0.33 width 0.125, 128 px, B=4, f32, card vs CPU (max "
          f"relative to each leaf's largest value): {STEP_ERRORS.format(**card)} (limits 1e-4, 1e-3, "
          f"1e-4, 0); num_fg {runs['card'][0]['num_fg']:.0f}; the CPU's f32 step vs its f64 "
          f"step: {STEP_ERRORS.format(**floor)}", flush=True)
    if not (card["fg"] == 0 and card["loss"] <= 1e-4 and card["params"] <= 1e-3
            and card["batch_stats"] <= 1e-4):
        raise AssertionError("the train step on the card disagrees with the CPU")


def activation_shapes(model, run):
    """{(shape, dtype): count} of each ConvBnAct's output in ``run()``: the
    maps of its BN and activation (which keep the shape and dtype)."""
    from cocodet_tpu_torch.models.blocks import ConvBnAct

    shapes, hooks = {}, []

    def hook(mod, args, out):
        key = (tuple(out.shape), out.dtype)
        shapes[key] = shapes.get(key, 0) + 1

    for m in model.modules():
        if isinstance(m, ConvBnAct):
            hooks.append(m.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return shapes


def hard_swish_times(shapes, device):
    """The standalone hard-swish kernel at each of ``shapes`` (channels-last,
    x uniform on [-5, 5]) held bit for bit against its plain version: at
    these sizes the grid takes many blocks, which g1's inputs do not. Then
    the device ms of the kernel, its plain version and F.hardswish, each
    summed over ``shapes``, with the bound: x read once and y written once
    at 3.35 TB/s, against ~5 f32 operations an element at 67 TFLOP/s."""
    import torch
    import torch.nn.functional as F

    from cocodet_tpu_torch.ops.cuda import hard_swish as hs

    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0,
           "max_abs_err": 0.0}
    gen = torch.Generator(device=device).manual_seed(11)
    for (shape, dtype), count in shapes.items():
        x = (torch.rand(shape, generator=gen, device=device) * 10 - 5).to(dtype).contiguous(
            memory_format=torch.channels_last)
        fns = (lambda: hs.hard_swish(x), lambda: hs.hard_swish_plain(x), lambda: F.hardswish(x))
        n, err = bit_diff(fns[0](), fns[1]())
        if n:
            raise AssertionError(f"hard_swish kernel disagrees with its plain version at "
                                 f"{shape} {dtype}: {n} of {x.numel()} elements")
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        for key, fn, iters in zip(("ms", "plain_ms", "library_ms"), fns, (20, 5, 20)):
            tot[key] += count * cuda_ms(fn, iters)
        tot["bytes"] += count * x.numel() * x.element_size() * 2
        tot["ops"] += count * x.numel() * 5
    bytes_ms = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = tot["ops"] / F32_OPS_PER_S * 1e3
    tot["bound_ms"] = max(bytes_ms, ops_ms)
    tot["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return tot


def phase_dense_forward(device, predictor, dense):
    """g4: phase c's dense bf16 forward at B=16 with the hard-swish kernel
    (as served) and with the plain version in its place (the parent's
    four elementwise passes), timed in turns in this run (each the median
    of 5 forwards, each queued while the card is held), and the
    activations' kernel time beside their bound."""
    import numpy as np
    import torch

    from cocodet_tpu_torch.models.blocks import ConvBnAct, hard_swish
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs

    model = predictor.model
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)).to(device)
    acts = [m for m in model.modules() if isinstance(m, ConvBnAct) and m.act is hard_swish]
    times = {}
    with torch.inference_mode():
        for label in ("kernel", "plain", "plain", "kernel"):
            for m in acts:
                m.act = hard_swish if label == "kernel" else hs.hard_swish_plain
            # one forward a hold: ten queued forwards (~500 launches each)
            # outran the hold, and their time followed the host's pace
            times.setdefault(label, []).append(
                statistics.median(cuda_ms(lambda: model(x), 1) for _ in range(5)))
        shapes = activation_shapes(model, lambda: model(x))
    for m in acts:
        m.act = hard_swish
    t = hard_swish_times(shapes, device)
    n = sum(shapes.values())
    print(f"g4. dense bf16 forward, B={BATCH} {SIZE}x{SIZE}, device ms (in turns kernel, plain, "
          f"plain, kernel): hard-swish kernel {', '.join(f'{v:.3f}' for v in times['kernel'])}; "
          f"plain version (the parent's) {', '.join(f'{v:.3f}' for v in times['plain'])}; "
          f"phase c's forward {dense['forward ms']:.3f}. Its {n} activations ({len(shapes)} "
          f"shapes; the kernel equals its plain version bit for bit at each): kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, F.hardswish "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']}",
          flush=True)
    return t


def step_kernel_count(step, images, labels):
    """(kernels, copies and fills, device busy ms) of one train step, from
    torch.profiler's CUDA activity: every kernel the step launches on the
    card (PyTorch's, cuDNN's and this repository's), and its memcpy and
    memset operations. Where the profiler records no device activity,
    (None, None, None): not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(images, labels)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None, None, None
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return len(dev) - len(copies), len(copies), busy_ms


def measure_train_step(device, card):
    """g3's measurement of the training step of the cocodet_tpu_torch
    package on sys.path (this tree's, or an earlier commit's for
    ``--step``): build_trainer at full width (YOLOX-M-P6, depth 0.67, width
    0.75, f32 parameters, bf16 compute), B=16 640 px numpy-seeded images
    and 5-60 boxes an image padded to G=120; 2 warm-up steps, then
    TRAIN_STEPS timed steps (the last with use_l1), the launch counts zeroed
    just before and read just after; one step under torch.profiler (the
    CUDA kernels a step) and one in PyTorch's sync debug mode (a step that
    waits for the card anywhere warns). Returns the numbers, the model's
    BN+act shapes (forward hooks on a warm-up step) and the metrics."""
    import importlib.util

    import torch

    from cocodet_tpu_torch.entry import build_trainer
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs

    fused = importlib.util.find_spec("cocodet_tpu_torch.ops.cuda.bn_act") is not None
    if fused:
        from cocodet_tpu_torch.ops.cuda import bn_act as bnk
    t0 = time.perf_counter()
    model, step = build_trainer(0.67, 0.75, torch.bfloat16, device, seed=0)
    setup_s = time.perf_counter() - t0
    images, labels = training_batch(BATCH, SIZE, 12)
    images = torch.from_numpy(images).to(device)
    labels = torch.from_numpy(labels).to(device)
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    shapes = activation_shapes(model, lambda: step(images, labels))
    step(images, labels)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(device)
    hs.reset_launch_counts()
    if fused:
        bnk.reset_launch_counts()
    parts = ("forward", "losses", "backward", "update")
    rows, metrics = [], []
    t_all = time.perf_counter()
    for i in range(TRAIN_STEPS):
        ev = {k: torch.cuda.Event(enable_timing=True) for k in ("start",) + parts}
        t0 = time.perf_counter()
        ev["start"].record()
        metrics.append(step(images, labels, use_l1=i == TRAIN_STEPS - 1,
                            mark=lambda name: ev[name].record()))
        queued = (time.perf_counter() - t0) * 1e3  # the host's time to queue the step
        torch.cuda.synchronize()
        names = ("start",) + parts
        rows.append({p: ev[a].elapsed_time(ev[p]) for a, p in zip(names, parts)}
                    | {"step": ev["start"].elapsed_time(ev["update"]), "queued": queued})
    wall = time.perf_counter() - t_all
    launches = {"hard_swish": hs.hard_swish.launches,
                "hard_swish_grad": hs.hard_swish_grad.launches}
    if fused:
        launches |= {f"bn_act.{fn.__name__}": fn.launches for fn in bnk.WRAPPERS}
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    kernels, copies, busy_ms = step_kernel_count(step, images, labels)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(images, labels, use_l1=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}
    return {"card": card, "setup_s": setup_s, "warm_s": warm_s, "rows": rows, "mean": mean,
            "img/s device": BATCH * 1e3 / mean["step"],
            "img/s host": TRAIN_STEPS * BATCH / wall, "peak_gib": peak_gib,
            "launches": launches, "kernels a step": kernels, "copies a step": copies,
            "device busy ms": busy_ms, "host syncs": len(syncs), "first sync": syncs[:1],
            "params": sum(p.numel() for p in model.parameters()),
            "metrics": [{k: float(v) for k, v in m.items()} for m in metrics]}, shapes


BN_ACT_SUM_TOL = 1e-5  # each sum's error over the sum of its terms' magnitudes


def bn_act_case(x, g, act, gen, determinism=False, gate=False):
    """The BN+act kernel pair against its plain stages on the card, on map
    ``x`` with cotangent ``g``: (1) the reduce's sums within BN_ACT_SUM_TOL
    of the f64 sums, each relative to the sum of its terms' magnitudes (the
    kernel adds at most ~150 f32 terms a thread, then in f64; the plain
    version's error is returned beside it); (2) given the kernel's sums, the
    vectors and the running statistics bit for bit, and so the data-parallel
    path's finish kernels from the same sums; (3) given the kernel's
    vectors, both apply stages bit for bit; the backward's reduce and its
    vectors likewise. With ``determinism``, the reduce runs twice and must
    give the same bits. Returns a dict: ``rel`` and ``rel_plain``, the sum
    errors of the kernel and of the plain version; ``bits``, the elements
    that differ where equal bits are due; and, for the kernels line, each
    kernel's largest absolute difference from its plain version on the same
    inputs: ``reduce`` (its sums, both ways), ``apply`` (y and dx) and
    ``finish`` (the data-parallel finish kernels' vectors and running
    statistics). With ``gate``, about 30% of the channels carry a closed
    ChannelMask gate folded into the vectors as the model folds it
    (models/blocks.py::ChannelMask.fold): weight 0 and bias the gate's
    offset."""
    import torch

    from cocodet_tpu_torch.ops.cuda import bn_act as bnk

    c = x.shape[1]
    dev = x.device
    weight = torch.rand(c, generator=gen, device=dev) + 0.5
    bias = torch.randn(c, generator=gen, device=dev) * 0.5
    if gate:
        scale = (torch.rand(c, generator=gen, device=dev) >= 0.3).float()
        offset = torch.randn(c, generator=gen, device=dev) * (1 - scale)
        weight, bias = weight * scale, bias * scale + offset * (1 - scale)
    stats0 = (torch.randn(c, generator=gen, device=dev) * 0.1,
              torch.rand(c, generator=gen, device=dev) + 0.5)
    ra = [t.clone() for t in stats0]
    sums, fvec = bnk.reduce(x, weight, *ra)
    rp = [t.clone() for t in stats0]
    fvec_p = bnk.finish_plain(sums, weight, *rp, 1e-3, 0.03)
    xd = x.double()
    s_plain = bnk.stats_plain(x)

    def sum_err(got, ref, mag):
        return float(((got.double() - ref) / mag.clamp_min(1e-30)).abs().max())

    dims = (0, 2, 3)
    refs = [(xd.sum(dims), xd.abs().sum(dims)), ((xd * xd).sum(dims), (xd * xd).sum(dims))]
    err = max(sum_err(sums[i * c:(i + 1) * c], r, m) for i, (r, m) in enumerate(refs))
    err_p = max(sum_err(s_plain[i * c:(i + 1) * c], r, m) for i, (r, m) in enumerate(refs))
    absdiff = {"reduce": float((sums - s_plain).abs().max()), "apply": 0.0, "finish": 0.0}
    bits = 0

    def held(got, want, kernel=None):
        nonlocal bits
        n, e = bit_diff(got, want)
        bits += n
        if kernel:
            absdiff[kernel] = max(absdiff[kernel], e)

    for got, want in ((fvec, fvec_p), (ra[0], rp[0]), (ra[1], rp[1])):
        held(got, want)
    held(bnk.apply(x, fvec, bias, act), bnk.apply_plain(x, fvec, bias, act), "apply")
    count = sums[-1:]
    gsums, bvec = bnk.grad_reduce(x, g, fvec, bias, weight, count, act)
    held(bvec, bnk.grad_finish_plain(gsums, fvec, weight, count))
    gz = bnk._grad_z(x, g, fvec, bias, act).double()
    t = (x.float() - fvec[0].view(1, -1, 1, 1)).double()
    grefs = [(gz.sum(dims), gz.abs().sum(dims)), ((gz * t).sum(dims), (gz * t).abs().sum(dims))]
    gplain = bnk.grad_stats_plain(x, g, fvec, bias, act)
    absdiff["reduce"] = max(absdiff["reduce"], float((gsums - gplain).abs().max()))
    err = max(err, *(sum_err(gsums[i * c:(i + 1) * c], r, m) for i, (r, m) in enumerate(grefs)))
    err_p = max(err_p, *(sum_err(gplain[i * c:(i + 1) * c], r, m)
                         for i, (r, m) in enumerate(grefs)))
    held(bnk.grad_apply(x, g, fvec, bias, bvec, act),
         bnk.grad_apply_plain(x, g, fvec, bias, bvec, act), "apply")
    # the data-parallel path's finish kernels against the plain finish, from
    # the same sums
    rf = [t.clone() for t in stats0]
    held(bnk.finish(sums, weight, *rf), fvec_p, "finish")
    held(rf[0], rp[0], "finish")
    held(rf[1], rp[1], "finish")
    held(bnk.grad_finish(gsums, gsums, fvec, weight, count),
         bnk.grad_finish_plain(gsums, fvec, weight, count, gsums), "finish")
    if determinism:
        again = bnk.reduce(x, weight, *[t.clone() for t in stats0])
        held(again[0], sums)
        held(again[1], fvec)
        held(bnk.grad_reduce(x, g, fvec, bias, weight, count, act)[1], bvec)
    torch.cuda.synchronize()
    return {"rel": err, "rel_plain": err_p, "bits": bits, **absdiff}


def check_bn_act_kernels(device, shapes, tag="g3.", gate=False, ragged_cases=True):
    """The BN+act pair held against its plain stages (bn_act_case) at each
    of ``shapes`` (one step's BN+act maps, channels-last) in bf16 and f32,
    each twice to show the reduce deterministic, and on ragged cases: C not
    a multiple of 8, N*H*W not a multiple of a block, a misaligned view, NCHW
    maps (H*W a multiple of 8 and not), a constant channel, C above one tile
    (f32 and bf16), a cotangent in another layout, the identity epilogue.
    Returns the worst of bn_act_case's numbers over all cases; ``tag``
    begins the printed line. ``gate`` closes ChannelMask gates in the
    vectors of every case (bn_act_case); ``ragged_cases=False`` holds the
    step's shapes only."""
    import torch

    gen = torch.Generator(device=device).manual_seed(13)
    cl = torch.channels_last

    def draw(shape, dtype, fmt=cl):
        # per-channel offsets, so E[x^2] - E[x]^2 cancels as in a real map
        off = torch.randn(shape[1], generator=gen, device=device).view(1, -1, 1, 1) * 2
        x = (torch.randn(shape, generator=gen, device=device) * 1.5 + off).to(dtype)
        return x.contiguous(memory_format=fmt)

    def misaligned(shape, dtype):
        n = torch.Size(shape).numel()
        flat = draw((1, 1, 1, n + 1), dtype).view(-1)[1:]
        nb, cb, hb, wb = shape
        return flat.view(nb, hb, wb, cb).permute(0, 3, 1, 2)

    worst, lines = {}, []

    def case(x, g, act):
        r = bn_act_case(x, g, act, gen, determinism=True, gate=gate)
        for k, v in r.items():
            worst[k] = worst.get(k, 0) + v if k == "bits" else max(worst.get(k, 0.0), v)
        return r["bits"]

    for dtype in (torch.bfloat16, torch.float32):
        for (shape, _), n in shapes.items():
            case(draw(shape, dtype), draw(shape, dtype), "hard_swish")
        lines.append(f"{len(shapes)} step shapes in {str(dtype)[6:]}")
    ragged = [
        ("C=13 bf16", draw((3, 13, 7, 5), torch.bfloat16), None, "hard_swish"),
        ("C=13 f32 identity", draw((3, 13, 7, 5), torch.float32), None, "identity"),
        ("N*H*W=715 bf16", draw((5, 24, 11, 13), torch.bfloat16), None, "hard_swish"),
        ("misaligned view bf16", misaligned((2, 16, 9, 9), torch.bfloat16), None, "hard_swish"),
        ("misaligned view f32", misaligned((2, 16, 9, 9), torch.float32), None, "identity"),
        ("NCHW bf16 H*W=64", draw((2, 16, 8, 8), torch.bfloat16, torch.contiguous_format),
         None, "hard_swish"),
        ("NCHW f32 H*W=81", draw((4, 20, 9, 9), torch.float32, torch.contiguous_format),
         None, "hard_swish"),
        ("C=1040 f32 (5 apply tiles)", draw((2, 1040, 3, 3), torch.float32), None,
         "hard_swish"),
        ("C=2056 bf16 (9 apply tiles)", draw((1, 2056, 2, 3), torch.bfloat16), None,
         "identity"),
        ("cotangent in NCHW", draw((4, 32, 6, 6), torch.bfloat16),
         draw((4, 32, 6, 6), torch.bfloat16, torch.contiguous_format), "hard_swish"),
    ]
    const = draw((4, 32, 6, 6), torch.bfloat16)
    const[:, 3] = 0.5
    ragged.append(("constant channel bf16", const, None, "hard_swish"))
    if not ragged_cases:
        ragged = []
    for label, x, g, act in ragged:
        g = draw(tuple(x.shape), x.dtype) if g is None else g
        if case(x, g, act):
            raise AssertionError(f"bn_act kernels disagree with their plain stages: {label}")
    if ragged:
        lines.append(f"{len(ragged)} ragged cases ({'; '.join(r[0] for r in ragged)})")
    if gate:
        lines.append("~30% of each case's channels gated closed")
    print(f"{tag} bn_act kernels vs their plain stages on the card: {', '.join(lines)}: vectors, "
          f"running statistics and both apply stages bit for bit ({worst['bits']} elements "
          f"differ), each reduce equal in two runs; the sums' worst error over the sum of their "
          f"terms' magnitudes: kernel {worst['rel']:.2e} (limit {BN_ACT_SUM_TOL:.0e}), plain "
          f"version {worst['rel_plain']:.2e}; largest absolute difference from the plain "
          f"version: reduce's sums {worst['reduce']!r}, apply {worst['apply']!r}, finish "
          f"{worst['finish']!r}", flush=True)
    if worst["bits"] or worst["rel"] > BN_ACT_SUM_TOL:
        raise AssertionError("the bn_act kernels disagree with their plain stages")
    return worst


def bn_act_times(shapes, device):
    """Device ms of the BN+act pair over ``shapes`` (each timed once, times
    its count), forward and backward: the kernels, their plain stages and a
    library yardstick for the pair (torch's train-mode F.batch_norm, then
    F.hardswish; their backward by autograd: cuDNN's or ATen's BN and
    hardswish_backward, which round otherwise and update the running
    variance unbiased). Each stage also beside ATen's own stage of the
    same split, the kernels of SyncBatchNorm (``<stage>_library``):
    torch.batch_norm_stats for the reduce, batch_norm_elemt for the apply,
    batch_norm_backward_reduce and batch_norm_backward_elemt backward; they
    have no activation, take ``g`` as the BN output's cotangent, compute
    Welford statistics and an inverse standard deviation, and leave the
    running statistics alone. Bounds
    from bytes (each input read once, each output written once: the reduce
    reads x, and g backward; the apply reads them and writes y or dx) at
    3.35 TB/s against ~3 (reduce) to ~20 (backward apply) f32 operations an
    element at 67 TFLOP/s."""
    import torch
    import torch.nn.functional as F

    from cocodet_tpu_torch.ops.cuda import bn_act as bnk

    gen = torch.Generator(device=device).manual_seed(17)
    keys = ("reduce", "apply", "grad_reduce", "grad_apply")
    tot = {f"{k}{s}": 0.0 for k in keys + ("finish", "grad_finish") for s in ("", "_plain")}
    tot |= {"library_fwd": 0.0, "library_bwd": 0.0} | {f"{k}_library": 0.0 for k in keys}
    elems = {"bytes": dict.fromkeys(keys, 0), "ops": dict.fromkeys(keys, 0)}
    tot["by shape"] = {}
    per_elem = {"reduce": (1, 3), "apply": (2, 10), "grad_reduce": (2, 18),
                "grad_apply": (3, 20)}
    for (shape, dtype), count in shapes.items():
        c = shape[1]
        x = (torch.randn(shape, generator=gen, device=device) * 2).to(dtype).contiguous(
            memory_format=torch.channels_last)
        g = torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(
            memory_format=torch.channels_last)
        w = torch.rand(c, generator=gen, device=device) + 0.5
        b = torch.randn(c, generator=gen, device=device)
        rm, rv = torch.zeros(c, device=device), torch.ones(c, device=device)
        sums, fvec = bnk.reduce(x, w, rm, rv)
        cnt = sums[-1:]
        gsums, bvec = bnk.grad_reduce(x, g, fvec, b, w, cnt)
        fns = {
            "reduce": lambda: bnk.reduce(x, w, rm, rv),
            "reduce_plain": lambda: bnk.reduce_plain(x, w, rm, rv, 1e-3, 0.03),
            "apply": lambda: bnk.apply(x, fvec, b),
            "apply_plain": lambda: bnk.apply_plain(x, fvec, b),
            "grad_reduce": lambda: bnk.grad_reduce(x, g, fvec, b, w, cnt),
            "grad_reduce_plain": lambda: bnk.grad_reduce_plain(x, g, fvec, b, w, cnt),
            "grad_apply": lambda: bnk.grad_apply(x, g, fvec, b, bvec),
            "grad_apply_plain": lambda: bnk.grad_apply_plain(x, g, fvec, b, bvec),
            "finish": lambda: bnk.finish(sums, w, rm, rv),
            "finish_plain": lambda: bnk.finish_plain(sums, w, rm, rv, 1e-3, 0.03),
            "grad_finish": lambda: bnk.grad_finish(gsums, gsums, fvec, w, cnt),
            "grad_finish_plain": lambda: bnk.grad_finish_plain(gsums, fvec, w, cnt, gsums),
        }
        mean, invstd = torch.batch_norm_stats(x, 1e-3)
        sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(g, x, mean, invstd, w, True,
                                                                     True, True)
        n_rows = torch.tensor([x.numel() // c], dtype=torch.int32, device=device)
        fns |= {
            "reduce_library": lambda: torch.batch_norm_stats(x, 1e-3),
            "apply_library": lambda: torch.batch_norm_elemt(x, w, b, mean, invstd, 1e-3),
            "grad_reduce_library": lambda: torch.batch_norm_backward_reduce(
                g, x, mean, invstd, w, True, True, True),
            "grad_apply_library": lambda: torch.batch_norm_backward_elemt(
                g, x, mean, invstd, w, sum_dy, sum_dy_xmu, n_rows),
        }
        ms = {k: cuda_ms(fn, 5 if k.endswith("plain") else 20) for k, fn in fns.items()}
        for k, v in ms.items():
            tot[k] += count * v
        # each kernel's time at this shape over its byte bound
        tot["by shape"][shape] = (count, {k: ms[k] / (x.numel() * x.element_size()
                                                      * per_elem[k][0] / HBM_BYTES_PER_S * 1e3)
                                          for k in keys})
        xr, wr, br = (x.detach().requires_grad_(), w.clone().requires_grad_(),
                      b.clone().requires_grad_())
        with torch.no_grad():
            tot["library_fwd"] += count * cuda_ms(lambda: F.hardswish(F.batch_norm(
                x, rm, rv, w, b, True, 0.03, 1e-3)), 20)
        y = F.hardswish(F.batch_norm(xr, rm, rv, wr, br, True, 0.03, 1e-3))
        tot["library_bwd"] += count * cuda_ms(
            lambda: torch.autograd.grad(y, (xr, wr, br), g, retain_graph=True), 20)
        for k in keys:
            elems["bytes"][k] += count * x.numel() * x.element_size() * per_elem[k][0]
            elems["ops"][k] += count * x.numel() * per_elem[k][1]
        # the finish kernels, C-length f32: forward reads the sums, the scale
        # and the running statistics and writes the 4 vectors and the
        # statistics; backward reads both sums, the vectors, the scale and
        # writes 4 vectors; ~20 operations a channel
        for k, words in (("finish", (2 * c + 1) + c + 2 * c + 4 * c + 2 * c),
                         ("grad_finish", 4 * c + 4 * c + c + 1 + 4 * c)):
            elems["bytes"][k] = elems["bytes"].get(k, 0) + count * words * 4
            elems["ops"][k] = elems["ops"].get(k, 0) + count * 20 * c
    for k in keys + ("finish", "grad_finish"):
        bytes_ms = elems["bytes"][k] / HBM_BYTES_PER_S * 1e3
        ops_ms = elems["ops"][k] / F32_OPS_PER_S * 1e3
        tot[f"{k}_bound"] = max(bytes_ms, ops_ms)
        tot[f"{k}_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return tot


def phase_train(device, card):
    """g3: the training step's measurement (measure_train_step) with its
    checks: finite losses, num_fg > 0, no host sync, and the fused BN+act
    pair launched 4 x 127 times a step (reduce and apply, forward and
    backward) with no standalone hard-swish and no data-parallel finish;
    then the pair held against its plain stages (check_bn_act_kernels) and
    timed (bn_act_times) on one step's maps."""
    import torch

    res, shapes = measure_train_step(device, card)
    n_maps = sum(shapes.values())
    launches = res["launches"]
    want = {"bn_act.reduce": n_maps, "bn_act.apply": n_maps, "bn_act.grad_reduce": n_maps,
            "bn_act.grad_apply": n_maps, "bn_act.finish": 0, "bn_act.grad_finish": 0,
            "hard_swish": 0, "hard_swish_grad": 0}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    if per_step != want:
        raise AssertionError(f"launches a step {per_step}, want {want}")
    if res["host syncs"]:
        raise AssertionError(f"the train step synchronizes with the card {res['host syncs']} "
                             f"times, first: {res['first sync'][0]}")
    for i, vals in enumerate(res["metrics"]):
        print(f"g3. step {i + 1}{' (use_l1)' if i == TRAIN_STEPS - 1 else ''}: "
              + ", ".join(f"{k}={v:.4f}" for k, v in vals.items()), flush=True)
        if not all(map(lambda v: v == v and abs(v) != float("inf"), vals.values())):
            raise AssertionError(f"non-finite training metrics at step {i + 1}: {vals}")
        if vals["num_fg"] <= 0:
            raise AssertionError(f"no foreground anchor at step {i + 1}")
    pair = sum(v for k, v in launches.items() if k.startswith("bn_act.")) // TRAIN_STEPS
    mean = res["mean"]
    kernels = ("not measured (the profiler recorded no device activity)"
               if res["kernels a step"] is None else
               f"{res['kernels a step']} kernels and {res['copies a step']} copies or fills, "
               f"device busy {res['device busy ms']:.2f} ms")
    print(f"g3. train step, YOLOX-M-P6 (depth 0.67, width 0.75, {res['params']} f32 "
          f"parameters, bf16 compute), B={BATCH} {SIZE}x{SIZE}, G=120, on {card}: setup "
          f"{res['setup_s']:.2f} s, 2 warm-up steps {res['warm_s']:.2f} s; {TRAIN_STEPS} timed "
          f"steps, device ms a step " + ", ".join(f"{r['step']:.2f}" for r in res["rows"])
          + f" (mean {mean['step']:.2f}: forward {mean['forward']:.2f}, SimOTA and losses "
          f"{mean['losses']:.2f}, backward {mean['backward']:.2f}, optimizer and EMA "
          f"{mean['update']:.2f}; the host took {mean['queued']:.2f} to queue a step: where "
          f"that is as long as the step, the host sets the pace); "
          f"{res['img/s device']:.2f} img/s on the device, {res['img/s host']:.2f} img/s by "
          f"the host clock; peak device memory {res['peak_gib']:.2f} GiB; one step under the "
          f"profiler: {kernels}; launches in the {TRAIN_STEPS} steps {launches}: the BN+act "
          f"pair {pair} a step ({n_maps} BN+act maps), the standalone hard-swish 0; host syncs "
          f"in a step (sync debug mode): 0", flush=True)
    torch.cuda.empty_cache()
    worst = check_bn_act_kernels(device, shapes)
    t = bn_act_times(shapes, device)
    fwd = {s: t[f"reduce{s}"] + t[f"apply{s}"] for s in ("", "_plain", "_bound")}
    bwd = {s: t[f"grad_reduce{s}"] + t[f"grad_apply{s}"] for s in ("", "_plain", "_bound")}
    print(f"g3. bn_act pair on one step's {n_maps} BN+act maps ({len(shapes)} shapes, bf16, "
          f"hard-swish): forward {fwd['']:.4f} ms (reduce {t['reduce']:.4f}, apply "
          f"{t['apply']:.4f}; bound {fwd['_bound']:.4f} by bytes; plain {fwd['_plain']:.4f}; "
          f"F.batch_norm + F.hardswish {t['library_fwd']:.4f}; ATen's stages "
          f"batch_norm_stats {t['reduce_library']:.4f}, batch_norm_elemt "
          f"{t['apply_library']:.4f}); backward {bwd['']:.4f} ms (reduce "
          f"{t['grad_reduce']:.4f}, apply {t['grad_apply']:.4f}; bound {bwd['_bound']:.4f}; "
          f"plain {bwd['_plain']:.4f}; autograd of the two {t['library_bwd']:.4f}; ATen's "
          f"stages batch_norm_backward_reduce {t['grad_reduce_library']:.4f}, "
          f"batch_norm_backward_elemt {t['grad_apply_library']:.4f})", flush=True)
    print("g3. bn_act, each kernel's time at each shape over its byte bound (shape x maps: "
          "reduce, apply, grad_reduce, grad_apply): " + "; ".join(
              f"{tuple(sh)} x{n}: " + ", ".join(f"{v:.2f}" for v in r.values())
              for sh, (n, r) in t["by shape"].items()), flush=True)
    print(f"g3. bn_act_finish (the data-parallel path's, after the all-reduce of the sums) "
          f"at one step's {n_maps} channel counts: forward {t['finish']:.4f} ms, backward "
          f"{t['grad_finish']:.4f} (plain {t['finish_plain']:.4f}, "
          f"{t['grad_finish_plain']:.4f}; bounds {t['finish_bound']:.4f}, "
          f"{t['grad_finish_bound']:.4f})", flush=True)
    stats = {}
    for name, keys in (("bn_act_reduce", ("reduce", "grad_reduce")),
                       ("bn_act_apply", ("apply", "grad_apply")),
                       ("bn_act_finish", ("finish", "grad_finish"))):
        stats[name] = {
            "launches": sum(launches[f"bn_act.{k}"] for k in keys),
            "max_abs_err": worst[name[len("bn_act_"):]],
            # the finish runs on the data-parallel path only: its launches
            # there are phase h2's (main() fills them in)
            "ms": sum(t[k] for k in keys), "plain_ms": sum(t[f"{k}_plain"] for k in keys),
            "bound_ms": sum(t[f"{k}_bound"] for k in keys),
            "bound_by": "bytes" if all(t[f"{k}_by"] == "bytes" for k in keys)
            else "operations",
            # ATen's stages, forward and backward (bn_act_times); no call of
            # torch computes the backward finish's coefficients from summed
            # sums, so the finish has none
            "library_ms": (None if name == "bn_act_finish"
                           else sum(t[f"{k}_library"] for k in keys))}
    return stats


def phase_repeat(device, predictor):
    """c2: the dense path's detection count on one batch, served twice with
    cuDNN deterministic and no benchmark, then twice as served (benchmark
    on: cuDNN may pick other algorithms, whose sums round otherwise). Two
    deterministic runs that differ would be a fault of the port."""
    import numpy as np
    import torch

    images = np.random.RandomState(1).uniform(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    runs = {}
    for label in ("deterministic", "deterministic", "benchmark", "benchmark"):
        if label == "deterministic":
            with cudnn_deterministic():
                res = predictor(images)
        else:
            torch.backends.cudnn.benchmark = True
            res = predictor(images)
        torch.cuda.synchronize()
        runs.setdefault(label, []).append(res)
    counts = {k: [int(r.valid.sum()) for r in v] for k, v in runs.items()}
    same = {k: all(torch.equal(getattr(v[0], f), getattr(v[1], f))
                   for f in ("boxes", "scores", "valid")) for k, v in runs.items()}
    print(f"c2. the dense batch of phase c served twice with cuDNN deterministic and no "
          f"benchmark: detections {counts['deterministic']}, outputs bit for bit equal: "
          f"{same['deterministic']}; twice with benchmark on (as served): detections "
          f"{counts['benchmark']}, equal: {same['benchmark']}", flush=True)
    return counts, same


H_WARMUP, H_STEPS = 2, 3
# h1's limits on (losses, parameters, BN statistics): g2's, and at 256x128 a
# parameter limit of 3e-3, where f32 rounding alone moves a leaf by 8.05e-4 of
# its largest value (the step in f32 against f64 on the CPU)
H_LIMITS = {"1-D": (1e-4, 1e-3, 1e-4), "2-D": (1e-4, 3e-3, 1e-4)}
# training_batch arguments of h1's batches: 128x128 and 256x128, B=4
H_PARITY = ((4, 128, 7), (4, 256, 8, 120, (5, 60), 128))


def h_rank(rank, device):
    """One rank of phase h. (h1) From seed 1 at depth 0.33, width 0.125, f32,
    cuDNN deterministic and TF32 off: one step of the 1-D mesh and one of the
    (1 data x 2 space) mesh on H_PARITY's batches: (metrics, flat variables,
    this rank's fg mask) for each. (h2) YOLOX-M-P6 from seed 0, bf16
    compute, on g3's batch over the 1-D mesh and the (1 data x 2 space)
    mesh: H_WARMUP steps, then H_STEPS timed steps (the last with use_l1)
    with the counts zeroed just before and read just after."""
    import torch
    import torch.distributed as dist

    from cocodet_tpu_torch.entry import build_trainer
    from cocodet_tpu_torch.ops.cuda import bn_act as bnk
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs
    from cocodet_tpu_torch.parallel import collectives, make_mesh, make_mesh_2d, shard_batch
    from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree

    meshes = {"1-D": make_mesh(device), "2-D": make_mesh_2d(2, device)}
    out = {"parity": {}, "main": {}}
    with cudnn_deterministic():
        for name, spec in zip(("1-D", "2-D"), H_PARITY):
            model, step = build_trainer(0.33, 0.125, torch.float32, seed=1, mesh=meshes[name])
            metrics, targets = step(*shard_batch(meshes[name], training_batch(*spec)),
                                    use_l1=True, return_targets=True)
            out["parity"][name] = ({k: float(v) for k, v in metrics.items()},
                                   flatten_tree(export_variables(model)),
                                   targets.fg_mask.cpu().numpy())
    del model, step
    torch.backends.cudnn.benchmark = True
    main_batch = training_batch(BATCH, SIZE, 12)
    for name, mesh in meshes.items():
        t0 = time.perf_counter()
        model, step = build_trainer(0.67, 0.75, torch.bfloat16, seed=0, mesh=mesh)
        local = shard_batch(mesh, main_batch)
        for _ in range(H_WARMUP):
            step(*local)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(device)
        hs.reset_launch_counts()
        bnk.reset_launch_counts()
        collectives.reset_counts()
        steps, metrics = [], []
        for i in range(H_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            m = step(*local, use_l1=i == H_STEPS - 1)
            end.record()
            torch.cuda.synchronize()
            steps.append((start.elapsed_time(end), (time.perf_counter() - t0) * 1e3))
            metrics.append({k: float(v) for k, v in m.items()})
        out["main"][name] = {
            "rows": tuple(local[0].shape), "setup_s": setup_s, "steps": steps,
            "metrics": metrics, "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "launches": {"hard_swish": hs.hard_swish.launches,
                         "hard_swish_grad": hs.hard_swish_grad.launches}
            | {f"bn_act.{fn.__name__}": fn.launches for fn in bnk.WRAPPERS},
            "calls": dict(collectives.calls), "staged": dict(collectives.host_staged),
            "host_ms": {k: v * 1e3 for k, v in collectives.host_seconds.items()}}
        del model, step, local
        torch.cuda.empty_cache()
    return out


def phase_dp(device, card):
    """h: the data-parallel train step (entry.build_trainer on a
    parallel.Mesh) on 2 ranks that share the card (gloo; every collective
    staged through host memory), in one run of ranks (h_rank). h1 holds
    the ranks' step at depth 0.33, width 0.125, f32, against the
    single-process step on the card: the 1-D mesh (one 128 px batch of 4,
    2 images a rank) and the (1 data x 2 space) mesh (256x128, 128 rows a
    rank). Only the order of the sums differs (BN's per-rank partial sums,
    the halo rows, the gradients summed over ranks): the fg mask and num_fg
    must be equal, and the losses, each parameter leaf and each BN
    statistic within H_LIMITS of its largest value; the single step in f32
    against f64 on the CPU is printed beside, for scale. h2 drives the
    main path of the slice at full width: YOLOX-M-P6, bf16 compute, g3's
    batch of 16 640 px images (G=120) on 2 data ranks of 8 images and on 1
    data x 2 space ranks of 320 rows."""
    import numpy as np
    import torch

    from cocodet_tpu_torch.entry import build_trainer
    from cocodet_tpu_torch.parallel.launch import run_ranks
    from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree

    t_phase = time.perf_counter()
    single = {}
    with cudnn_deterministic():
        for name, spec in zip(("1-D", "2-D"), H_PARITY):
            images, labels = training_batch(*spec)
            for dev, dtype in ((device, torch.float32), ("cpu", torch.float32),
                               ("cpu", torch.float64)):
                model, step = build_trainer(0.33, 0.125, torch.float32, dev, seed=1)
                model.to(dtype)
                model.dtype = dtype
                metrics, targets = step(torch.from_numpy(images).to(dev, dtype),
                                        torch.from_numpy(labels).to(dev), use_l1=True,
                                        return_targets=True)
                single[name, str(dev), dtype] = ({k: float(v) for k, v in metrics.items()},
                                                 flatten_tree(export_variables(model)),
                                                 targets.fg_mask.cpu().numpy())
    del model, step
    torch.cuda.empty_cache()
    ranks = run_ranks(h_rank, 2, device=device, timeout=600)
    lines, ok = [], True
    for name, mesh in (("1-D", "1-D mesh (2 data), 128x128"),
                       ("2-D", "(1 data x 2 space) mesh, 256x128")):
        got = [r["parity"][name] for r in ranks]
        want = single[name, str(device), torch.float32]
        # the ranks' fg masks side by side: their images on the 1-D mesh, all
        # four on each space rank
        fg = np.concatenate([g[2] for g in got]) if name == "1-D" else got[0][2]
        err = step_errors((got[0][0], got[0][1], fg), want)
        floor = step_errors(single[name, "cpu", torch.float32],
                            single[name, "cpu", torch.float64])
        same = all(g[0] == got[0][0] for g in got) and all(
            np.array_equal(v, got[0][1][p]) for g in got for p, v in g[1].items())
        limits = H_LIMITS[name]
        lines.append(f"{mesh}, B=4: {STEP_ERRORS.format(**err)} (limits "
                     f"{', '.join(map(str, limits))}, 0); num_fg {got[0][0]['num_fg']:.0f} "
                     f"(single {want[0]['num_fg']:.0f}); the ranks hold one state bit for bit: "
                     f"{same}; for scale, the single step in f32 vs f64 on the CPU: "
                     f"{STEP_ERRORS.format(**floor)}")
        ok &= (err["fg"] == 0 and got[0][0]["num_fg"] == want[0]["num_fg"] and same
               and err["loss"] <= limits[0] and err["params"] <= limits[1]
               and err["batch_stats"] <= limits[2])
    print("h1. the data-parallel step on 2 ranks sharing the card (gloo), depth 0.33 width "
          "0.125, f32, cuDNN deterministic, TF32 off, against the single-process step on the "
          "card (max relative to each leaf's largest value): " + "; ".join(lines), flush=True)
    if not ok:
        raise AssertionError("the data-parallel step disagrees with the single-process step")

    for name, mesh in (("1-D", "2 data x 1 space"), ("2-D", "1 data x 2 space")):
        runs = [r["main"][name] for r in ranks]
        for rank, r in enumerate(runs):
            ms = [d for d, _ in r["steps"]]
            host = [h for _, h in r["steps"]]
            coll = sum(r["host_ms"].values()) / H_STEPS
            print(f"h2. YOLOX-M-P6 (depth 0.67, width 0.75, bf16 compute) data-parallel on "
                  f"({mesh}), rank {rank} of 2 on {card}: local batch {r['rows']}; setup and "
                  f"{H_WARMUP} warm-up steps {r['setup_s']:.2f} s; device ms a step "
                  + ", ".join(f"{v:.2f}" for v in ms)
                  + " (host ms " + ", ".join(f"{v:.2f}" for v in host)
                  + f"); host ms in collectives a step {coll:.2f} ("
                  + ", ".join(f"{k} {v / H_STEPS:.2f}" for k, v in sorted(r["host_ms"].items()))
                  + f"); collectives a step {({k: v // H_STEPS for k, v in r['calls'].items()})}"
                  f", of which staged through the host "
                  f"{({k: v // H_STEPS for k, v in r['staged'].items()})}; peak device memory "
                  f"{r['peak_gib']:.2f} GiB; launches in {H_STEPS} steps {r['launches']}",
                  flush=True)
            # the BN+act pair with its finish between the passes (the sums
            # are all-reduced there), each way; no standalone hard-swish
            fused = [k for k in r["launches"] if k.startswith("bn_act.")]
            if not all(r["launches"][k] for k in fused) or r["launches"]["hard_swish"] \
                    or r["launches"]["hard_swish_grad"]:
                raise AssertionError(f"the BN+act kernels did not all launch, or the "
                                     f"standalone hard-swish did, on rank {rank} ({mesh})")
        for i, m in enumerate(runs[0]["metrics"]):
            print(f"h2. ({mesh}) step {i + 1}{' (use_l1)' if i == H_STEPS - 1 else ''}: "
                  + ", ".join(f"{k}={v:.4f}" for k, v in m.items()), flush=True)
            if not all(np.isfinite(v) for v in m.values()) or m["num_fg"] <= 0:
                raise AssertionError(f"({mesh}) step {i + 1}: non-finite metrics or no "
                                     f"foreground anchor: {m}")
        if any(r["metrics"] != runs[0]["metrics"] for r in runs):
            raise AssertionError(f"({mesh}): the ranks report different metrics")
    print(f"h. phase h took {time.perf_counter() - t_phase:.1f} s", flush=True)
    # the finish kernels' launches on rank 0, both meshes (the kernels line)
    return sum(ranks[0]["main"][name]["launches"][f"bn_act.{k}"]
               for name in ("1-D", "2-D") for k in ("finish", "grad_finish"))


def crafted_boxes(dataset, size, moved=False):
    """Each image's ground-truth boxes (in the dataset's order) in
    letterboxed pixels at ``size``: (cx, cy, w, h, contiguous class). With
    ``moved``, each box shifted by its own width and height (IoU 0 with
    where it was), its centre kept inside the image."""
    from cocodet_tpu_torch.data.coco import COCO_CLASS_ID

    out = []
    for img_id in dataset.coco.ids:
        im = dataset.coco.images[img_id]
        r = min(size / im["height"], size / im["width"])
        boxes = []
        for a in dataset.coco.anns_per_image.get(img_id, []):
            x, y, w, h = a["bbox"]
            cx, cy = (x + w / 2) * r, (y + h / 2) * r
            if moved:
                cx = min(cx + w * r, im["width"] * r - 1)
                cy = min(cy + h * r, im["height"] * r - 1)
            boxes.append((cx, cy, w * r, h * r, COCO_CLASS_ID.index(a["category_id"])))
        out.append(boxes)
    return out


def crafted_model(boxes_per_image, device, num_classes=80):
    """A torch module whose head maps decode to ``boxes_per_image`` (one
    list an image, as crafted_boxes gives them): its k-th call serves the
    k-th batch of images in turn (a Python counter; nothing is traced). A
    box takes the cell of its centre on the finest level whose cell is
    free, with obj and class logits 20 and every other logit -20; a box
    that finds no free cell is counted in ``dropped``."""
    import math

    import numpy as np
    import torch

    class Crafted(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.anchor = torch.nn.Parameter(torch.zeros((), device=device))  # its device
            self.strides = STRIDES
            self.served = 0
            self.dropped = 0

        def forward(self, images):
            b, h, w = images.shape[:3]
            maps = [{"reg": np.zeros((b, h // s, w // s, 4), np.float32),
                     "obj": np.full((b, h // s, w // s, 1), -20.0, np.float32),
                     "cls": np.full((b, h // s, w // s, num_classes), -20.0, np.float32)}
                    for s in STRIDES]
            for i in range(b):
                k = self.served + i
                for cx, cy, bw, bh, c in (boxes_per_image[k] if k < len(boxes_per_image)
                                          else ()):
                    for m, s in zip(maps, STRIDES):
                        gx = min(int(cx // s), m["obj"].shape[2] - 1)
                        gy = min(int(cy // s), m["obj"].shape[1] - 1)
                        if m["obj"][i, gy, gx, 0] > 0:
                            continue
                        m["reg"][i, gy, gx] = [cx / s - gx, cy / s - gy,
                                               math.log(bw / s), math.log(bh / s)]
                        m["obj"][i, gy, gx, 0] = 20.0
                        m["cls"][i, gy, gx, c] = 20.0
                        break
                    else:
                        self.dropped += 1
            self.served += b
            return [{k: torch.from_numpy(v).to(images.device) for k, v in m.items()}
                    for m in maps]

    return Crafted()


EVAL_IMAGES = 128  # phase i's synthetic val set (variant "default", 256-512 px)
CONVS = 127  # YOLOX-M-P6's convs with hard-swish, and the headline's w8a8 convs


def eval_timing_line(ev):
    t = ev.timing
    n = max(t["images"], 1)
    return (f"{n / t['total s']:.2f} img/s ({n} images, {t['batches']} batches, "
            f"{t['total s']:.2f} s), forward+NMS {1e3 * t['forward+nms s'] / n:.3f} ms/img, "
            f"host {1e3 * t['host s'] / n:.3f} ms/img")


def check_stats(label, ev):
    """The evaluator's 12 stats: finite, and equal with the plain matcher."""
    import math

    plain = ev.evaluate_prediction(ev.records, use_native=False)
    if not all(math.isfinite(v) for v in ev.stats.values()) or plain != ev.stats:
        raise AssertionError(f"{label}: stats {ev.stats}, with the plain matcher {plain}")


def phase_eval(device, card, root):
    """i1-i3: the COCO evaluator (entry.build_evaluator: 768 px, B=16, conf
    0.001, NMS 0.65, K=2000, 300 detections) on the card; i2 and i3 after a
    warm-up batch (cuDNN's algorithm search at this shape, outside the
    timed evaluation)."""
    import numpy as np
    import torch

    from cocodet_tpu_torch import entry
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs
    from cocodet_tpu_torch.ops.cuda import int8_conv as ic
    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk
    from cocodet_tpu_torch.ops.nms import class_offset_boxes
    from cocodet_tpu_torch.ops.postprocess import _select_topk_fused, postprocess

    size = entry.EVAL_SIZE
    # i1: the crafted model, boxes where the ground truth is, then moved
    for moved in (False, True):
        ev = entry.build_evaluator(root)
        model = crafted_model(crafted_boxes(ev.dataset, size, moved), device)
        ap, ap50, _ = ev.evaluate(entry.Predictor(model))
        check_stats("i1", ev)
        ok = ap50 < 0.2 if moved else (ap50 == 1.0 and ap >= 0.99)
        print(f"i1. crafted model{', every box moved' if moved else ''}, {EVAL_IMAGES} images at "
              f"{size} px on the card: AP={ap:.4f} AP50={ap50:.4f} ({len(ev.records)} records, "
              f"{model.dropped} boxes without a free cell; "
              f"{'AP50 < 0.2' if moved else 'AP50 = 1.0 and AP >= 0.99'} required)", flush=True)
        if not ok or model.dropped:
            raise AssertionError("i1: the crafted model's mAP is not what its boxes give")

    # i2: the dense bf16 model of phase c
    variables = serving_variables(seed=0)
    ev = entry.build_evaluator(root)
    predictor = entry.build_predictor(variables, device=device, cfg=ev.postprocess_config)
    warm = np.zeros((ev.batch_size, size, size, 3), np.float32)
    predictor(warm)  # warm-up: cuDNN picks its algorithms for this shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    nk.reset_launch_counts()
    hs.reset_launch_counts()
    ap, ap50, _ = ev.evaluate(predictor)
    launches = {"overlap_matrix": nk.overlap_matrix.launches,
                "greedy_keep": nk.greedy_keep.launches, "hard_swish": hs.hard_swish.launches}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    n_batches = ev.timing["batches"]
    if launches != {"overlap_matrix": n_batches, "greedy_keep": n_batches,
                    "hard_swish": CONVS * n_batches}:
        raise AssertionError(f"i2: launches {launches} for {n_batches} batches")
    check_stats("i2", ev)
    print(f"i2. dense bf16 YOLOX-M-P6 through COCOEvaluator, {size} px, B={ev.batch_size}, "
          f"K={ev.pre_nms_topk}, on {card}: {eval_timing_line(ev)}; peak device memory "
          f"{peak:.2f} GiB; launches {launches}; AP={ap:.4f} AP50={ap50:.4f}, the 12 stats "
          f"finite and equal with the plain matcher ({len(ev.records)} records)", flush=True)

    images = np.stack([ev.dataset[i][0] for i in range(ev.batch_size)])
    x = torch.from_numpy(images).to(device)
    cfg = ev.postprocess_config
    copy_ms = cuda_ms(lambda: torch.from_numpy(images).to(device), 5)
    with torch.inference_mode():
        boxes, _, classes, _, valid = _select_topk_fused(predictor.model(x), STRIDES, cfg)
        check_kernels(f"i2. NMS kernels on the first batch's candidates, K={cfg.pre_nms_topk} "
                      f"B={ev.batch_size}", class_offset_boxes(boxes, classes, valid).contiguous(),
                      valid.contiguous(), cfg.nms_threshold)
    print(f"i2. host-to-card copy of a {size} px batch ({images.nbytes / 1e6:.1f} MB f32, "
          f"pageable): {copy_ms:.3f} ms", flush=True)
    # the first batch's first two images, f32, on the card (no TF32) and on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    two = torch.from_numpy(images[:2])
    card32 = entry.build_predictor(variables, dtype=torch.float32, device=device, cfg=cfg)
    cpu32 = entry.build_predictor(variables, dtype=torch.float32, device="cpu", cfg=cfg)
    with torch.inference_mode():
        maps_g = card32.model(two.to(device))
        maps_c = cpu32.model(two)
        got = postprocess(maps_g, STRIDES, cfg)
        same_maps = postprocess([{k: v.cpu() for k, v in m.items()} for m in maps_g],
                                STRIDES, cfg)
        want = postprocess(maps_c, STRIDES, cfg)
    infos = [ev.dataset[i][2] for i in range(2)]
    ids = [ev.dataset.ids[i] for i in range(2)]

    def records(res):
        return ev.convert_to_coco_format(tuple(t.cpu().numpy() for t in (
            res.boxes, res.scores, res.classes, res.valid)), infos, ids)

    g = torch.cat([m[k].reshape(-1).cpu() for m in maps_g for k in m])
    w = torch.cat([m[k].reshape(-1) for m in maps_c for k in m])
    err = float(((g - w).abs() / (1 + w.abs())).max())
    same_path = match_records(records(got), records(same_maps))
    same = match_records(records(got), records(want))
    print(f"i2. the first batch's first two images in f32 ({int(want.valid.sum())} records): "
          f"head maps, card against CPU, max |d|/(1+|v|) = {err:.3e} (limit 1e-3, phase d's); "
          f"records the same sets (match_detections' tolerances): of the card's maps through "
          f"the card's and the CPU's postprocess {same_path}, of the card's and the CPU's own "
          f"maps {same}", flush=True)
    if not (err <= 1e-3 and same_path and same):
        raise AssertionError("i2: the evaluator's records on the card differ from the CPU's")
    del predictor, card32, cpu32
    torch.cuda.empty_cache()

    # i3: the headline (slim w8a8) through the same evaluator
    headline, _ = build_headline_model(device)
    ev = entry.build_evaluator(root)
    headline(warm)
    torch.cuda.synchronize()
    ic.reset_launch_counts()
    nk.reset_launch_counts()
    ap, ap50, _ = ev.evaluate(headline)
    n_batches = ev.timing["batches"]
    launches = {"int8_conv": ic.conv2d_w8a8.launches, "overlap_matrix": nk.overlap_matrix.launches,
                "greedy_keep": nk.greedy_keep.launches}
    if launches != {"int8_conv": CONVS * n_batches, "overlap_matrix": n_batches,
                    "greedy_keep": n_batches}:
        raise AssertionError(f"i3: launches {launches} for {n_batches} batches")
    check_stats("i3", ev)
    print(f"i3. headline (slim w8a8) through COCOEvaluator, {size} px, on {card}: "
          f"{eval_timing_line(ev)}; launches {launches}; AP={ap:.4f} AP50={ap50:.4f}", flush=True)
    del headline
    torch.cuda.empty_cache()


def phase_harness(device, card, root):
    """i4: the submission harness with harness/config/yolox_m_p6.json (832
    px, B=16, conf 0.001, NMS 0.55, K=2048, the contrast TTA), weights from
    numpy seed 0, on the generated val set."""
    import numpy as np
    import torch

    from cocodet_tpu_torch import harness
    from cocodet_tpu_torch.data.folder import FolderLoader, ImageFolderDataset
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs
    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk
    from cocodet_tpu_torch.ops.nms import class_offset_boxes
    from cocodet_tpu_torch.ops.postprocess import _select_topk_fused

    with open(os.path.join(REPO, "harness", "config", "yolox_m_p6.json")) as f:
        cfg = json.load(f)
    cfg["data_dir"] = os.path.join(root, "val2017")
    cfg["annotation"] = os.path.join(root, "annotations", "instances_val2017.json")
    report = {}
    nk.reset_launch_counts()
    hs.reset_launch_counts()
    results = harness.run(cfg, os.path.join(root, "answers.json"), profile=True,
                          device=device, report=report)
    launches = {"overlap_matrix": nk.overlap_matrix.launches,
                "greedy_keep": nk.greedy_keep.launches, "hard_swish": hs.hard_swish.launches}
    batches = len(report["shapes"]) + 1  # and the warm-up
    if launches != {"overlap_matrix": batches, "greedy_keep": batches,
                    "hard_swish": CONVS * batches}:
        raise AssertionError(f"i4: launches {launches} for {batches} batches")
    distinct = sorted(set(report["shapes"]))
    stats = report["stats"]
    print(f"i4. harness {cfg['img_size']} px, B={cfg['dataloader']['batch_size']}, on {card}: "
          f"phase seconds {json.dumps({k: round(v, 4) for k, v in report['phases'].items()})}; "
          f"{len(results)} records for {report['images']} images; self-eval mAP@0.5 = "
          f"{stats['AP50']:.4f}; launches {launches}; {len(distinct)} distinct batch shapes of "
          f"{len(report['shapes'])} batches: {distinct}", flush=True)
    if report["images"] != EVAL_IMAGES or not results:
        raise AssertionError("i4: the harness did not serve every image")

    # the kernels on a bucket batch of this run: its non-square shape if any
    predictor = harness.build_predictor_from_config(cfg, device=device)
    ds = ImageFolderDataset(cfg["data_dir"], cfg["img_size"])
    loader = FolderLoader(ds, cfg["dataloader"]["batch_size"], pad_multiple=64)
    batch = next((b for b, _ in loader if b.shape[1] != b.shape[2]), None)
    batch = next(iter(loader))[0] if batch is None else batch
    x = torch.from_numpy(batch).to(device)
    copy_ms = cuda_ms(lambda: torch.from_numpy(batch).to(device), 5)
    first_conv = next(m for m in predictor.model.modules() if hasattr(m, "act_in_conv"))
    seen = []
    hook = first_conv.conv.register_forward_hook(lambda mod, args, out: seen.append(out))
    try:
        with torch.inference_mode():
            maps = predictor.model(x * 0.9 + 11.4)
    finally:
        hook.remove()
    pcfg = predictor.cfg
    with torch.inference_mode():
        boxes, _, classes, _, valid = _select_topk_fused(maps, STRIDES, pcfg)
        check_kernels(f"i4. NMS kernels on a bucket batch {tuple(batch.shape)}, "
                      f"K={pcfg.pre_nms_topk}", class_offset_boxes(boxes, classes, valid)
                      .contiguous(), valid.contiguous(), pcfg.nms_threshold)
        act_in = seen[0]
        n, err = bit_diff(hs.hard_swish(act_in), hs.hard_swish_plain(act_in))
    print(f"i4. hard_swish kernel on the stem's activation of that batch "
          f"{tuple(act_in.shape)} {act_in.dtype}: {n} of {act_in.numel()} elements differ from "
          f"the plain version (max |d| {err}); host-to-card copy of the batch "
          f"({batch.nbytes / 1e6:.1f} MB f32, pageable): {copy_ms:.3f} ms", flush=True)
    if n:
        raise AssertionError("i4: hard_swish kernel disagrees with its plain version")


def phase_i(device, card):
    """i: the evaluation family on the port's synthetic val set."""
    import tempfile

    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        t0 = time.perf_counter()
        root = make_synthetic_coco(tmp, n_train=0, n_val=EVAL_IMAGES, size_range=(256, 512),
                                   seed=0, variant="default")
        print(f"i. synthetic val set: {EVAL_IMAGES} JPEGs (variant default, 256-512 px) "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        phase_eval(device, card, root)
        phase_harness(device, card, root)


# phase j: the training runtime (exp, trainer, CLI) with the device-mosaic
# input pipeline (csrc/train_aug.cu)
J_BATCH = 16
J_TRAIN, J_VAL = 64, 16  # the synthetic set's train and val JPEGs (256-512 px)
J_EXP = os.path.join("cocodet_tpu_torch", "exps", "p6", "yolox_m_p6.py")
TRAIN_AUG_REPLACES = {"mosaic_canvas": "cocodet_tpu/data/device_mosaic.py:160",
                      "affine_warp": "cocodet_tpu/data/device_mosaic.py:236",
                      "mixup": "cocodet_tpu/data/device_mosaic.py:287",
                      "train_aug": "cocodet_tpu/data/device_aug.py:202"}
TRAIN_AUG_LAUNCHES = {"mosaic_canvas": 1, "affine_warp": 1, "mixup": 1, "train_aug": 1}


def j_exp(root):
    """The port's yolox_m_p6 exp on the synthetic set, device mosaic on."""
    from cocodet_tpu_torch.exp import get_exp_by_file

    exp = get_exp_by_file(os.path.join(REPO, J_EXP))
    return exp.merge(["data_dir", root, "device_mosaic", "True"])


def j_batches(exp):
    """Two collated batches of 16 from the exp's device-mosaic dataset (item
    seeds as the loader's): one with mosaic and mixup on, one after
    close_mosaic (every item passed through)."""
    import random

    loader = exp.get_data_loader(batch_size=J_BATCH, cache_img=True, seed=0)
    ds, collate = loader.dataset, loader.collate_fn
    n = len(ds)
    first = collate([ds.fetch((True, i % n), random.Random(loader._item_seed(i)))
                     for i in range(J_BATCH)])[0]
    ds.close_mosaic()
    second = collate([ds.fetch((False, i % n), random.Random(loader._item_seed(100 + i)))
                      for i in range(J_BATCH)])[0]
    return first, second


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _span(lo, hi, num, den):
    """How many source positions the bilinear taps of the positions lo..hi
    (f32, in order) read, for a resize of ``den`` source positions by
    num / den (the taps are monotone in the position)."""
    import torch

    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    if hi < lo:
        return 0
    f32 = torch.float32
    i0, i1, _ = ta.lin_taps(torch.tensor([lo, hi], dtype=f32),
                            torch.tensor(num, dtype=f32) / torch.tensor(den, dtype=f32), den)
    return int(i1[1]) - int(i0[0]) + 1


def canvas_read_bytes(hw5, nhw5, yc, xc, size):
    """K1: the tile pixels that the taps of the four rectangles read."""
    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    total = 0
    for hw, nhw, y, x in zip(hw5.tolist(), nhw5.tolist(), yc.tolist(), xc.tolist()):
        for t, (x1, y1, x2, y2, padw, padh) in enumerate(ta.tile_rects(y, x, nhw[:4], *size)):
            (h0, w0), (nh, nw) = hw[t], nhw[t]
            if y2 > y1 and x2 > x1:
                total += 3 * (_span(y1 - padh, y2 - 1 - padh, nh, h0)
                              * _span(x1 - padw, x2 - 1 - padw, nw, w0))
    return total


def warp_read_bytes(m6, size):
    """K2: the canvas pixels that the warp reads, both passes composed: pass
    2's taps pick the H values each output needs, pass 1's taps the canvas
    pixels each of those reads (H, pass 1's unrounded map, is no input or
    output of the function)."""
    import torch

    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    ih, iw = size
    total = 0
    for m in m6:
        rows, _ = ta.warp_taps(m, size, 2)  # (iw, ih): the H rows of column x
        line = torch.arange(iw, device=m.device)[:, None].expand_as(rows)
        need = torch.zeros((2 * ih, iw), dtype=torch.bool, device=m.device)
        for r in (rows, rows + 1):
            ok = (r >= 0) & (r < 2 * ih)
            need[r[ok], line[ok]] = True
        cols, _ = ta.warp_taps(m, size, 1)  # (2ih, iw): the canvas column of H[r, x]
        r, x = need.nonzero(as_tuple=True)
        read = torch.zeros((2 * ih, 2 * iw), dtype=torch.bool, device=m.device)
        for c in (cols[r, x], cols[r, x] + 1):
            ok = (c >= 0) & (c < 2 * iw)
            read[r[ok], c[ok]] = True
        total += 3 * int(read.sum())
    return total


def mixup_read_bytes(hw5, nhw5, mrand, size, sh, sw):
    """K3: the warped mosaic (or the whole tile 0 of a passthrough item,
    which the mid image copies), and the partner-tile pixels that the two
    resamples read inside the live crop."""
    import torch

    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    ih, iw = size
    f32 = torch.float32
    total = 0
    for hw, nhw, mr in zip(hw5.tolist(), nhw5.tolist(), mrand.cpu()):
        mosaic = bool(mr[0] > 0)
        total += 3 * (ih * iw if mosaic else sh * sw)
        if not mr[9] > 0:
            continue
        oh, ow = (ih, iw) if mosaic else hw[0]
        tw2, th2 = int(mr[14]), int(mr[15])
        yy = torch.arange(sh, dtype=f32) + mr[13]
        xx = torch.arange(sw, dtype=f32) + mr[12]
        if mr[11] > 0:
            xx = torch.tensor(float(tw2 - 1), dtype=f32) - xx
        ry = yy[(yy < th2) & (torch.arange(sh) < oh)]
        cx = xx[(xx >= 0) & (xx < tw2) & (torch.arange(sw) < ow)]
        if not len(ry) or not len(cx):
            continue
        (h0, w0), (nh, nw) = hw[4], nhw[4]
        spans = []
        for pos, n2, n1, src, stage1 in ((ry, th2, ih, h0, nh), (cx, tw2, iw, w0, nw)):
            i0, i1, _ = ta.lin_taps(torch.stack([pos.min(), pos.max()]),
                                    torch.tensor(n2, dtype=f32) / torch.tensor(n1, dtype=f32), n1)
            spans.append(_span(int(i0[0]), min(int(i1[1]), stage1 - 1), stage1, src))
        total += 3 * spans[0] * spans[1]
    return total


def aug_read_bytes(hw, nhw):
    """K4: the mid-image pixels that the letterbox's taps read (a flip
    mirrors the columns, so the count stays)."""
    total = 0
    for (h, w), (nh, nw) in zip(hw.tolist(), nhw.tolist()):
        total += 3 * _span(0, nh - 1, nh, h) * _span(0, nw - 1, nw, w)
    return total


def train_aug_stages(batch, device, size):
    """The four kernels' calls on one batch, each with its inputs as the
    pipeline gives them: {name: ([(kernel call, plain call, args, kwargs)],
    bytes the function must move)}. A function's bytes: the input pixels
    its taps read, its small per-item inputs, its output written once."""
    import torch

    from cocodet_tpu_torch.data.device_aug import aug_inputs
    from cocodet_tpu_torch.data.device_mosaic import mosaic_mixup_batch
    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    ih, iw = size
    B, _, sh, sw, _ = t["mosaic_tiles"].shape
    yc, xc = t["mrand"][:, 1].to(torch.int32), t["mrand"][:, 2].to(torch.int32)
    m = t["mrand"][:, 3:9].contiguous()
    canvas = ta.mosaic_canvas(t["mosaic_tiles"], t["hw5"], t["nhw5"], yc, xc, size)
    warped = ta.affine_warp(canvas, m, size)
    mid, hw, boxes, _, nvalid = mosaic_mixup_batch(
        t["mosaic_tiles"], t["hw5"], t["nhw5"], t["boxes5"], t["classes5"], t["nvalid5"],
        t["mrand"], size)
    nhw = torch.where(t["mrand"][:, :1] > 0, torch.tensor([[ih, iw]], dtype=torch.int32,
                                                          device=device), t["nhw5"][:, 0])
    a = aug_inputs(hw, boxes, nvalid, t["randoms"], size)
    small = _nbytes(t["hw5"], t["nhw5"])
    args = {
        "mosaic_canvas": ([(t["mosaic_tiles"], t["hw5"], t["nhw5"], yc, xc, size)],
                          canvas_read_bytes(t["hw5"], t["nhw5"], yc, xc, size)
                          + small + _nbytes(yc, xc, canvas)),
        "affine_warp": ([(canvas, m, size)], warp_read_bytes(m, size) + _nbytes(m, warped)),
        "mixup": ([(t["mosaic_tiles"], t["hw5"], t["nhw5"], warped, t["mrand"], size)],
                  mixup_read_bytes(t["hw5"], t["nhw5"], t["mrand"], size, sh, sw)
                  + small + _nbytes(t["mrand"], mid)),
        "train_aug": ([(mid, hw, nhw, a["gains"], a["flip"], a["fallback"], size)],
                      aug_read_bytes(hw, nhw)
                      + _nbytes(hw, nhw, a["gains"], a["flip"], a["fallback"])
                      + B * ih * iw * 3 * 4),
    }
    return {name: ([(getattr(ta, name), ta.PLAIN[getattr(ta, name)], a_, {}) for a_ in calls],
                   nbytes) for name, (calls, nbytes) in args.items()}


def j1_hold(kernel, args):
    """One call of a K1-K4 wrapper and of its plain version on the same
    inputs on the card: (values that differ, max |difference|)."""
    import torch

    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    got, want = kernel(*args), ta.PLAIN[kernel](*args)
    return bit_diff(got.float() if got.dtype == torch.uint8 else got,
                    want.float() if want.dtype == torch.uint8 else want)


def warp_matrix(scale, degrees, shear_x, shear_y, tx, ty, size):
    """get_affine_params's f64 matrix for given draws (angle, scale, the two
    shears in degrees, the translations as fractions of the size), as the
    flat [m00 m01 m02 m10 m11 m12]."""
    import math

    ih, iw = size
    rad = math.radians(degrees)
    alpha, beta = scale * math.cos(rad), scale * math.sin(rad)
    sx, sy = math.tan(math.radians(shear_x)), math.tan(math.radians(shear_y))
    return [alpha + sy * -beta, beta + sy * alpha, tx * iw,
            -beta + sx * alpha, alpha + sx * beta, ty * ih]


def warp_extremes(B, size, device, scale=None):
    """(B, 6) f32 matrices at the draw's extremes (device_mosaic's draw in
    yolox_m_p6: scale 0.1-2.0, +-10 degrees, shear +-2, translation +-0.1),
    item i taking the i-th combination; ``scale`` fixes the scale."""
    import torch

    rows = []
    for i in range(B):
        bit = [(i >> k) & 1 for k in range(5)]
        s = scale if scale is not None else (0.1, 2.0)[bit[0]]
        sign = [(-1.0, 1.0)[v] for v in bit[1:]]
        rows.append(warp_matrix(s, 10.0 * sign[0], 2.0 * sign[1], -2.0 * sign[1], 0.1 * sign[2],
                                0.1 * sign[3], size))
    return torch.tensor(rows, dtype=torch.float64).to(torch.float32).to(device)


def mixup_variant(mrand, hw5, size, mosaic=None, mix=None, jit=None, flip=None, edge=None):
    """j1's mixup draws with some of them set, the rest derived as fetch
    derives them (tw2, th2 = int(iw * jit), int(ih * jit) in f64; x_off and
    y_off within the padded partner: "low" 0, "high" the most, else kept
    where they still fit)."""
    mr = mrand.clone().cpu()
    ih, iw = size
    for b in range(mr.shape[0]):
        if mosaic is not None:
            mr[b, 0] = float(mosaic)
        if mix is not None:
            mr[b, 9] = float(mix)
        j = jit if jit is not None else float(mr[b, 10]) if mr[b, 10] > 0 else 1.0
        mr[b, 10] = j
        if flip is not None:
            mr[b, 11] = float(flip)
        tw2, th2 = int(iw * j), int(ih * j)
        mr[b, 14], mr[b, 15] = tw2, th2
        oh, ow = (ih, iw) if mr[b, 0] > 0 else tuple(hw5[b, 0].tolist())
        room_x, room_y = max(tw2, ow) - ow, max(th2, oh) - oh
        if edge == "low":
            mr[b, 12], mr[b, 13] = 0, 0
        elif edge == "high":
            mr[b, 12], mr[b, 13] = room_x, room_y
        else:
            mr[b, 12], mr[b, 13] = min(float(mr[b, 12]), room_x), min(float(mr[b, 13]), room_y)
    return mr.to(mrand.device)


J1_SIZES = (640, 704, 768, 832)  # phase j's multiscale sizes (stride 64)


def j1_cases(device, exp, batches, root):
    """The cases that the block tiling of K1-K4 must hold besides j1's two
    batches: [(case, kernel, args)]. The whole pipeline (K1-K4) at each
    multiscale size, from an exp of that input size; then K1 and K4 on B=1
    and B=3, mosaic centres flush with each canvas edge (and on it),
    rectangles that leave whole blocks of background, a 1/16 downscale (its
    stages walked in bands), extents that are not multiples of the block,
    flip and fallback items in one batch, tiles as large as the input
    (scale 1, the smallest the pipeline draws), sources one pixel wide or
    high, and a 1/8 downscale; K2 on B=1 and B=3, matrices at the
    draw's extremes (scale 0.1 and 2.0, +-10 degrees, shear +-2,
    translation +-0.1), past the safe_m00 and the safe_det guards, a
    translation that leaves the whole output on the border, and extents off
    the block grid; K3 with mixup off, a passthrough origin, a flipped
    partner, crops at each edge, tw2 and th2 below and above iw and ih, a
    partner downscaled until tile 4 is walked in bands, and extents off the
    block grid."""
    import torch

    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    cases = []
    for s in J1_SIZES:
        ex = j_exp(root)
        ex.input_size = (s, s)
        for label, batch in zip(("mosaic", "passthrough"), j_batches(ex)):
            for name, (calls, _) in train_aug_stages(batch, device, (s, s)).items():
                cases += [(f"{s} px, {label} batch", getattr(ta, name), a) for _, _, a, _ in calls]
    size = tuple(exp.input_size)
    ih, iw = size
    mosaic, passthrough = (train_aug_stages(b, device, size) for b in batches)
    k1 = mosaic["mosaic_canvas"][0][0][2]  # (tiles, hw5, nhw5, yc, xc, size)
    k4 = passthrough["train_aug"][0][0][2]  # (mid, hw, nhw, gains, flip, fallback, size)
    k4_mosaic = mosaic["train_aug"][0][0][2]
    for n in (1, 3):
        cases += [(f"B={n}", ta.mosaic_canvas,
                   tuple(a[:n].contiguous() if torch.is_tensor(a) else a for a in k1)),
                  (f"B={n}", ta.train_aug,
                   tuple(a[:n].contiguous() if torch.is_tensor(a) else a for a in k4))]
    tiles, hw5, nhw5, yc, xc, _ = k1
    B = tiles.shape[0]
    i32 = dict(dtype=torch.int32, device=device)
    centres = [(0, 0), (2 * ih, 2 * iw), (0, 2 * iw), (2 * ih, 0), (ih // 2, iw // 2),
               (3 * ih // 2, 3 * iw // 2), (ih // 2, 3 * iw // 2), (3 * ih // 2, iw // 2)]
    cy = torch.tensor([centres[i % len(centres)][0] for i in range(B)], **i32)
    cx = torch.tensor([centres[i % len(centres)][1] for i in range(B)], **i32)
    cases.append(("centres flush with the canvas edges", ta.mosaic_canvas,
                  (tiles, hw5, nhw5, cy, cx, size)))
    small = nhw5.clone()
    small[:, :4] = torch.tensor([ih // 5 + 3, iw // 7 + 5], **i32)
    cases.append(("rectangles leaving whole blocks of background", ta.mosaic_canvas,
                  (tiles, hw5, small, torch.full_like(yc, ih), torch.full_like(xc, iw), size)))
    tiny = nhw5.clone()
    tiny[:, :4] = ih // 16 + 1
    cases.append(("a 1/16 downscale", ta.mosaic_canvas, (tiles, hw5, tiny, yc, xc, size)))
    thin = hw5.clone()
    thin[:, 0::2, 1] = 1  # tiles 0, 2 and 4 one pixel wide, 1 and 3 one pixel high
    thin[:, 1::2, 0] = 1
    cases.append(("one-pixel-wide and -high tiles", ta.mosaic_canvas,
                  (tiles, thin, nhw5, yc, xc, size)))
    mid, hw, nhw, gains, flip, fallback, _ = k4
    idx = torch.arange(B, device=device)
    ragged = torch.stack([ih - 17 - 32 * (idx % 3), iw - 45 - 64 * (idx % 2)], 1).to(torch.int32)
    cases.append(("extents not multiples of the block", ta.train_aug,
                  (mid, hw, torch.minimum(ragged, nhw).contiguous(), gains, flip, fallback,
                   size)))
    mixed_flip, mixed_fb = (idx % 2).to(torch.int32), ((idx // 2) % 2).to(torch.int32)
    for label, (m, h, e, g, _, _, _) in (("passthrough", k4), ("mosaic", k4_mosaic)):
        cases.append((f"flip and fallback items in one {label} batch", ta.train_aug,
                      (m, h, e, g, mixed_flip, mixed_fb, size)))
    sh, sw = mid.shape[1:3]
    full = torch.tensor([[sh, sw]], **i32).expand(B, 2).contiguous()
    cases.append(("tiles as large as the input", ta.train_aug,
                  (mid, full, torch.tensor([[ih, iw]], **i32).expand(B, 2).contiguous(), gains,
                   mixed_flip, mixed_fb, size)))
    narrow = torch.stack([torch.where(idx % 2 == 0, sh, 1), torch.where(idx % 2 == 0, 1, sw)],
                         1).to(torch.int32)
    cases.append(("one-pixel-wide and -high sources", ta.train_aug,
                  (mid, narrow, nhw, gains, mixed_flip, mixed_fb, size)))
    cases.append(("a 1/8 downscale", ta.train_aug,
                  (mid, full, torch.tensor([[sh // 8, sw // 8]], **i32).expand(B, 2).contiguous(),
                   gains, mixed_flip, mixed_fb, (sh // 8, sw // 8))))
    print(f"j1. the passthrough batch's smallest letterbox scale: "
          f"{float((nhw.float() / hw.float()).min()):.4f}", flush=True)

    # K2: the warp
    canvas, m, _ = mosaic["affine_warp"][0][0][2]
    guards = m.clone()
    guards[0] = torch.tensor([1e-4, 0.0, 0.0, 0.0, 1e-4, 0.0])    # safe_m00 and safe_det
    guards[1] = torch.tensor([1e-4, 0.02, 3.0, 0.03, 0.9, -2.0])   # safe_m00
    guards[2] = torch.tensor([0.5, 0.5, 10.0, 0.5, 0.5, 10.0])     # det 0: safe_det
    guards[3] = torch.tensor([0.3, 0.0, 5.0, 0.0, -0.2, 0.0])      # safe_det (det -0.06: kept)
    border = m.clone()
    border[:, 2] += 4 * iw  # every output pixel's canvas column lies past the canvas
    ch, cw = ih - 17, iw - 45  # (751, 723) at 768 px: off the block grid, rows not of 16 bytes
    k2 = [("B=1", (canvas[:1].contiguous(), m[:1].contiguous(), size)),
          ("B=3", (canvas[:3].contiguous(), m[:3].contiguous(), size)),
          ("matrices at the draw's extremes", (canvas, warp_extremes(B, size, device), size)),
          ("past the safe_m00 and safe_det guards", (canvas, guards, size)),
          ("a translation off the canvas (all 114)", (canvas, border, size)),
          ("extents not multiples of the block",
           (canvas[:, :2 * ch, :2 * cw].contiguous(), warp_extremes(B, (ch, cw), device),
            (ch, cw)))]
    cases += [(label, ta.affine_warp, args) for label, args in k2]

    # K3: the mixup
    tiles, hw5, nhw5, warped, mrand, _ = mosaic["mixup"][0][0][2]
    hw5c = hw5.cpu()
    k3 = [("mixup off", mixup_variant(mrand, hw5c, size, mix=0)),
          ("a passthrough origin", mixup_variant(mrand, hw5c, size, mosaic=0, mix=1)),
          ("a flipped partner", mixup_variant(mrand, hw5c, size, mix=1, flip=1)),
          ("tw2, th2 above iw, ih, crop at the low edges",
           mixup_variant(mrand, hw5c, size, mix=1, jit=1.5, edge="low")),
          ("tw2, th2 above iw, ih, crop at the high edges",
           mixup_variant(mrand, hw5c, size, mix=1, jit=1.5, edge="high")),
          ("tw2, th2 above iw, ih, flipped, crop at the high edges",
           mixup_variant(mrand, hw5c, size, mix=1, jit=1.37, flip=1, edge="high")),
          ("tw2, th2 below iw, ih", mixup_variant(mrand, hw5c, size, mix=1, jit=0.5)),
          ("tw2, th2 below iw, ih, passthrough origins, flipped",
           mixup_variant(mrand, hw5c, size, mosaic=0, mix=1, jit=0.61, flip=1, edge="high"))]
    cases += [(label, ta.mixup, (tiles, hw5, nhw5, warped, mr, size)) for label, mr in k3]
    big = hw5.clone()
    big[:, 4] = torch.tensor([tiles.shape[2], tiles.shape[3]], **i32)
    far = nhw5.clone()
    far[:, 4] = torch.tensor([ih // 16 + 1, iw // 16 + 1], **i32)
    cases.append(("a partner downscaled 1/16 (tile 4 walked in bands)", ta.mixup,
                  (tiles, big, far, warped, mixup_variant(mrand, hw5c, size, mix=1), size)))
    sh3, sw3, oh3, ow3 = tiles.shape[2] - 17, tiles.shape[3] - 45, ih - 40, iw - 75
    cut_hw = torch.minimum(hw5, torch.tensor([sh3, sw3], **i32)).contiguous()
    cut_nhw = nhw5.clone()
    for b in range(B):
        h4, w4 = cut_hw[b, 4].tolist()
        s4 = min(oh3 / h4, ow3 / w4)
        cut_nhw[b, 4] = torch.tensor([int(h4 * s4), int(w4 * s4)])
    cases.append(("extents not multiples of the block", ta.mixup,
                  (tiles[:, :, :sh3, :sw3].contiguous(), cut_hw, cut_nhw,
                   warped[:, :oh3, :ow3].contiguous(),
                   mixup_variant(mrand, cut_hw.cpu(), (oh3, ow3), mix=1), (oh3, ow3))))
    return cases


def j1_bands(kernel, args):
    """The most bands a block of the call walks (ops/cuda/train_aug.py)."""
    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    cpu = [a.cpu() if hasattr(a, "cpu") else a for a in args]
    if kernel is ta.mosaic_canvas:
        return ta.mosaic_canvas_bands(*cpu[1:5], cpu[5], cpu[0].shape[3])
    return ta.train_aug_bands(cpu[1], cpu[2], cpu[4], cpu[5], cpu[6], cpu[0].shape[2])


def phase_j1(device, exp, batches, root):
    """j1: K1-K4 against their plain versions on the card, bit for bit, on a
    mosaic batch and a passthrough batch and on ``j1_cases``; kernel and
    plain times, bounds; K2 also at each scale extreme."""
    import torch

    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    size = tuple(exp.input_size)
    stats = {}
    for label, batch in zip(("mosaic+mixup", "after close_mosaic"), batches):
        for name, (calls, _) in train_aug_stages(batch, device, size).items():
            st = stats.setdefault(name, {"max_abs_err": 0.0, "differ": 0})
            for kernel, _, args, _ in calls:
                n, err = j1_hold(kernel, args)
                st["differ"] += n
                st["max_abs_err"] = max(st["max_abs_err"], err)
            print(f"j1. {name} on the {label} batch: {st['differ']} values differ from the "
                  f"plain version", flush=True)
    for case, kernel, args in j1_cases(device, exp, batches, root):
        n, err = j1_hold(kernel, args)
        st = stats[kernel.__name__]
        st["differ"] += n
        st["max_abs_err"] = max(st["max_abs_err"], err)
        bands = (f" (at most {j1_bands(kernel, args)} band(s) a block)"
                 if kernel in (ta.mosaic_canvas, ta.train_aug) else "")
        print(f"j1. {case}: {kernel.__name__} {n} values differ from the plain version{bands}",
              flush=True)
    timed = train_aug_stages(batches[0], device, size)
    for name, (calls, nbytes) in timed.items():
        ms = sum(cuda_ms(lambda k=k, a=a, kw=kw: k(*a, **kw), 20) for k, _, a, kw in calls)
        plain_ms = sum(cuda_ms(lambda p=p, a=a, kw=kw: p(*a, **kw), 2, hold=False)
                       for _, p, a, kw in calls)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        stats[name].update(ms=round(ms, 4), plain_ms=round(plain_ms, 4), bound_ms=round(bound, 4),
                           bound_by="bytes", library_ms=None)
        print(f"j1. {name}: {ms:.4f} ms a step ({TRAIN_AUG_LAUNCHES[name]} launch(es)), "
              f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB the "
              f"function must move), {ms / bound:.1f}x it, B={J_BATCH}, {size[0]} px", flush=True)
    # K2 at each scale extreme of the draw
    canvas, _, _ = timed["affine_warp"][0][0][2]
    B = canvas.shape[0]
    for scale in (0.1, 2.0):
        mats = warp_extremes(B, size, device, scale=scale)
        bound = 1e3 * (warp_read_bytes(mats, size) + _nbytes(mats) + B * size[0] * size[1] * 3) \
            / HBM_BYTES_PER_S
        ms = cuda_ms(lambda: ta.affine_warp(canvas, mats, size), 20)
        print(f"j1. affine_warp at scale {scale} (+-10 degrees, shear +-2, translation +-0.1): "
              f"{ms:.4f} ms, bound {bound:.4f} ms, {ms / bound:.1f}x it", flush=True)
    # K3: how many of the batch's partners are unscaled at stage 1 (nh = h0
    # and nw = w0: the copy path, every stage-1 weight 0), and mixed
    tiles, hw5, nhw5, warped, mrand, _ = timed["mixup"][0][0][2]
    mixed = mrand[:, 9] > 0
    unscaled = mixed & (hw5[:, 4] == nhw5[:, 4]).all(1)
    print(f"j1. mixup: {int(mixed.sum())} of {B} items mixed; {int(unscaled.sum())} of them with "
          f"the partner unscaled at stage 1 (its copy path); stage-1 scales "
          f"{[round(v, 4) for v in (nhw5[:, 4].float() / hw5[:, 4].float()).flatten().tolist()]}",
          flush=True)
    # K4's share of its HSV jitter: the same batch with every item a fallback;
    # and both off the copy path: the pipeline's tiles are resized when they
    # load, so its resamples are unscaled (every weight 0); at 0.9 of the
    # extents every tap is blended
    img, hw, nhw, gains, flip, fallback, _ = timed["train_aug"][0][0][2]
    clean = (img, hw, nhw, gains, flip, torch.ones_like(fallback), size)
    scaled = (img, hw, (nhw * 0.9).to(torch.int32), gains, flip, fallback, size)
    tiles1, hw5_1, nhw5_1, yc, xc, _ = timed["mosaic_canvas"][0][0][2]
    scaled_canvas = (tiles1, hw5_1, (nhw5_1 * 0.9).to(torch.int32), yc, xc, size)
    scaled_mix = (tiles, hw5, (nhw5 * 0.9).to(torch.int32), warped, mrand, size)
    print(f"j1. train_aug with every item a fallback (no HSV jitter): "
          f"{cuda_ms(lambda: ta.train_aug(*clean), 20):.4f} ms; at 0.9 of the extents (every "
          f"tap blended): train_aug {cuda_ms(lambda: ta.train_aug(*scaled), 20):.4f} ms, "
          f"mosaic_canvas {cuda_ms(lambda: ta.mosaic_canvas(*scaled_canvas), 20):.4f} ms, "
          f"mixup (its stage 1) {cuda_ms(lambda: ta.mixup(*scaled_mix), 20):.4f} ms", flush=True)
    bad = [n for n, st in stats.items() if st["differ"]]
    if bad:
        raise AssertionError(f"j1: kernels differ from their plain versions: {bad}")
    return stats


def phase_j4(device, exp, batch):
    """j4: one collated batch through K1-K4 on the card and through the plain
    versions on the CPU: the images and labels must be equal bits."""
    import torch

    from cocodet_tpu_torch.data.device_aug import mosaic_preproc_batch

    size = tuple(exp.input_size)
    kw = dict(max_labels=exp.max_labels_mosaic, flip_prob=exp.flip_prob, hsv_prob=exp.hsv_prob)
    on_card = mosaic_preproc_batch({k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                   size, **kw)
    on_cpu = mosaic_preproc_batch({k: torch.from_numpy(v) for k, v in batch.items()}, size, **kw)
    for what, got, want in zip(("images", "labels"), on_card, on_cpu):
        n, err = bit_diff(got.cpu(), want)
        print(f"j4. {what} {tuple(got.shape)}: card (kernels) against CPU (plain): {n} values "
              f"differ (max {err})", flush=True)
        if n:
            raise AssertionError(f"j4: the {what} differ between the card and the CPU")
    return on_card


def j_preproc_kernels(device, exp, batch):
    """The CUDA kernels one batch's preprocessing launches (torch.profiler):
    K1-K4 found by their names, beside the wrappers' launch counts of the
    same call, and the label math's; the device busy ms of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cocodet_tpu_torch.data.device_aug import mosaic_preproc_batch
    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    size = tuple(exp.input_size)
    kw = dict(max_labels=exp.max_labels_mosaic, flip_prob=exp.flip_prob, hsv_prob=exp.hsv_prob)
    on_card = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    ta.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mosaic_preproc_batch(on_card, size, **kw)
        torch.cuda.synchronize()
    launched = sum(fn.launches for fn in ta.WRAPPERS)
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("j4. kernels of one batch's preprocessing: not measured (the profiler recorded "
              "no device activity)", flush=True)
        return
    own = [e for e in dev if any(f"{fn.__name__}_kernel" in e.name for fn in ta.WRAPPERS)]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]

    def busy(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3

    print(f"j4. kernels of one batch's preprocessing (torch.profiler): {len(dev) - len(copies)}; "
          f"of csrc/train_aug.cu {len(own)} recorded by name, {launched} launched by the "
          f"wrappers; {len(dev) - len(copies) - len(own)} others (the label math); "
          f"{len(copies)} copies or fills; device busy {busy(dev):.3f} ms, of it K1-K4 "
          f"{busy(own):.3f} ms", flush=True)


def j_argv(root, out_dir, max_epoch, cache=True):
    """The CLI line of phase j: the port's phase-1 exp at B=16, device mosaic,
    3 epochs (one warm-up, the last without aug). The exp's multiscale step of
    32 draws sizes the 4-level model cannot take (672, 736, 800: not
    multiples of its stride 64, in JAX as in the port; ROADMAP Queue 3), so
    the buckets span the same 640-832 at the stride-64 granularity of the
    reference's CustomP6Exp."""
    flags = ["-f", os.path.join(REPO, J_EXP), "-b", str(J_BATCH)] + (["--cache"] if cache else [])
    return flags + ["data_dir", root, "device_mosaic", "True", "max_epoch", str(max_epoch),
                    "warmup_epochs", "1", "no_aug_epochs", "1", "print_interval", "2",
                    "output_dir", out_dir, "multiscale_range", "(-2, 1)",
                    "multiscale_step", "64"]


def j_counts():
    from cocodet_tpu_torch.ops.cuda import bn_act as bnk
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs
    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk
    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    return ({fn.__name__: fn.launches for fn in ta.WRAPPERS}
            | {f"bn_act.{fn.__name__}": fn.launches for fn in bnk.WRAPPERS}
            | {"overlap_matrix": nk.overlap_matrix.launches,
               "greedy_keep": nk.greedy_keep.launches, "hard_swish": hs.hard_swish.launches})


def j_reset():
    from cocodet_tpu_torch.ops.cuda import bn_act as bnk
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs
    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk
    from cocodet_tpu_torch.ops.cuda import train_aug as ta

    for mod in (ta, bnk, hs, nk):
        mod.reset_launch_counts()


def same_bits(a, b):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _ms(v, fmt=".2f"):
    return "not measured" if v is None else f"{v:{fmt}}"


def j_report(trainer, label):
    for st in trainer.epoch_stats:
        print(f"{label} epoch {st['epoch']}: {st['iterations']} iterations, "
              f"{st['img_per_s']:.2f} img/s trained by the host clock (data included, "
              f"{st['seconds']:.2f} s), step {_ms(st['step_ms'])} device ms, data wait "
              f"{st['data_wait_ms']:.2f} ms a step, input kernels and label math "
              f"{_ms(st['input_ms'], '.3f')} device ms a step, sizes {st['size_sequence']}, L1 "
              f"{st['use_l1']}, peak {st['peak_mem_mb'] / 1024:.2f} GiB, non-finite losses "
              f"{st['nonfinite_losses']}", flush=True)
    for ev in trainer.eval_stats:
        print(f"{label} evaluation after epoch {ev['epoch']}: AP50 {ev['AP50']:.4f}, AP "
              f"{ev['AP']:.4f}, {ev['seconds']:.2f} s ({J_VAL} val images)", flush=True)
    for ck in trainer.ckpt_stats:
        print(f"{label} checkpoint {ck['name']}: {ck['bytes'] / 2 ** 20:.1f} MiB written in "
              f"{ck['seconds']:.2f} s", flush=True)
    bad = sum(st["nonfinite_losses"] for st in trainer.epoch_stats)
    if bad:
        raise AssertionError(f"{label}: {bad} non-finite loss values")


def phase_j2(device, root, out_dir):
    """j2: the CLI's main path in process, counts zeroed just before."""
    from cocodet_tpu_torch import entry

    j_reset()
    t0 = time.perf_counter()
    trainer = entry.train(j_argv(root, out_dir, 3), device=device)
    seconds = time.perf_counter() - t0
    counts = j_counts()
    j_report(trainer, "j2.")
    stats = trainer.epoch_stats
    switch = [st["epoch"] for st in stats if st["use_l1"]]
    print(f"j2. {len(stats)} epochs in {seconds:.2f} s; the no-aug switch and L1 from epoch "
          f"{switch[0] if switch else None}; launches {counts}", flush=True)
    if switch != [2, 3] or len(trainer.eval_stats) != 2:
        raise AssertionError(f"j2: no-aug epochs {switch}, {len(trainer.eval_stats)} "
                             "evaluations (want epochs 2 and 3, two evaluations)")
    iters = sum(st["iterations"] for st in stats)
    want = {"mosaic_canvas": iters, "affine_warp": iters, "mixup": iters, "train_aug": iters}
    zero = [k for k, v in counts.items() if v == 0 and not k.endswith("finish")]
    if zero or any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"j2: launches {counts}; want > 0 each and {want}")
    return trainer, counts


def phase_j3(device, root, out_dir, first):
    """j3: --resume from latest_ckpt.msgpack with max_epoch 4: the restored
    state equal to the saved one, bit for bit; then one more epoch."""
    import numpy as np

    from cocodet_tpu_torch.core.trainer import Trainer
    from cocodet_tpu_torch.tools.train import build
    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint
    from cocodet_tpu_torch.utils.convert import (ema_variables, export_variables,
                                                 flatten_tree, optimizer_state_dict)

    path = os.path.join(first.file_name, "latest_ckpt.msgpack")
    saved = load_checkpoint(path)
    exp, args = build(["--resume", "--device", str(device)] + j_argv(root, out_dir, 4))
    trainer = Trainer(exp, args, device=device)
    trainer.before_train()
    got = {"raw_model": export_variables(trainer.model), "model": ema_variables(trainer.state.ema),
           "opt_state": optimizer_state_dict(trainer.optimizer, trainer.model)}
    differ = {}
    for key, tree in got.items():
        want = flatten_tree(saved[key])
        have = flatten_tree(tree)
        differ[key] = sum(1 for k in want if k not in have or not same_bits(want[k], have[k]))
        differ[key] += len(set(have) - set(want))
    updates = trainer.state.ema.updates
    print(f"j3. resumed from {os.path.basename(path)}: start_epoch {trainer.start_epoch}, best_ap "
          f"{trainer.best_ap} (saved {float(saved['best_ap'])}), EMA updates {updates} "
          f"(3 x {trainer.iters_per_epoch}), leaves differing from the saved ones {differ}",
          flush=True)
    if (trainer.start_epoch != 3 or trainer.best_ap != float(saved["best_ap"])
            or updates != 3 * trainer.iters_per_epoch or any(differ.values())):
        raise AssertionError("j3: the resumed state is not the saved one")
    trainer.train_epochs()
    j_report(trainer, "j3.")


def phase_j5(device, root, out_dir):
    """j5: j2's run cold, without --cache (every tile decoded from its JPEG in
    the loader's threads), for 2 epochs, the first with mosaic and mixup: the
    wait for data against the step."""
    from cocodet_tpu_torch import entry

    trainer = entry.train(j_argv(root, out_dir, 2, cache=False) + ["no_aug_epochs", "0"],
                          device=device)
    j_report(trainer, "j5. cold:")
    if [st["use_l1"] for st in trainer.epoch_stats] != [False, True]:
        raise AssertionError("j5: want one mosaic epoch, then the no-aug epoch")


def phase_j(device, card, flags):
    """j: the training runtime on the synthetic set (see the docstring),
    with the backend ``flags`` (``current_flags()``) that the CLI's process
    starts with, whatever earlier phases set."""
    import tempfile

    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp, backend_flags(flags):
        root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=J_TRAIN, n_val=J_VAL,
                                   size_range=(256, 512), seed=0, variant="default")
        exp = j_exp(root)
        batches = j_batches(exp)
        stats = phase_j1(device, exp, batches, root)
        trainer, counts = phase_j2(device, root, os.path.join(tmp, "out"))
        for name in stats:
            stats[name]["launches"] = counts[name]
        phase_j3(device, root, os.path.join(tmp, "out"), trainer)
        del trainer
        for batch in batches:
            phase_j4(device, exp, batch)
        j_preproc_kernels(device, exp, batches[0])
        phase_j5(device, root, os.path.join(tmp, "cold"))
    print(f"j. phase j: {time.perf_counter() - t_start:.1f} s ({card}; cuDNN deterministic, "
          f"benchmark, TF32, matmul TF32: {flags})", flush=True)
    return stats


def phase_j1_alone(device, card, flags):
    """j1 alone, on phase j's synthetic set: K1-K4's checks, times and bounds."""
    import tempfile

    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_j1_") as tmp, backend_flags(flags):
        root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=J_TRAIN, n_val=J_VAL,
                                   size_range=(256, 512), seed=0, variant="default")
        exp = j_exp(root)
        stats = phase_j1(device, exp, j_batches(exp), root)
    print(f"j1. phase j1: {time.perf_counter() - t_start:.1f} s ({card})", flush=True)
    return stats


# phase k: the shipped phase-1 exp as it ships (the host mosaic path on JPEG)
K_TRAIN, K_VAL = 64, 16  # the synthetic set's train and val JPEGs (256-512 px)
K_PLAIN_IMAGES = 4  # of the set, decoded and re-encoded by the plain codec too


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def k_image(h, w, seed):
    """A seeded smooth colour field plus noise (the synthetic set's look)."""
    import numpy as np

    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 9 + p) * 60 + np.cos(yy / 13 - p) * 50 + 128
                     for p in rs.uniform(0, 6, 3)], -1)
    return np.clip(base + rs.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def phase_k1(root):
    """k1: the JPEG codec and warp.cpp against their plain versions on the
    host, bit for bit, and their times."""
    import random

    import numpy as np

    from cocodet_tpu_torch.data import image_io, jpeg_plain
    from cocodet_tpu_torch.data import transforms as T

    split = os.path.join(root, "train2017")
    files = sorted(os.path.join(split, f) for f in os.listdir(split))
    datas = []
    for f in files:
        with open(f, "rb") as fh:
            datas.append(fh.read())
    imgs = [image_io.read_image(f) for f in files]
    dec_ms = statistics.median(_median_ms(lambda d=d: image_io.decode_jpeg(d), 3) for d in datas)
    enc_ms = statistics.median(_median_ms(lambda x=x: image_io.encode_jpeg(x), 3) for x in imgs)
    bad = []
    t0 = time.perf_counter()
    for d, x, f in zip(datas[:K_PLAIN_IMAGES], imgs, files):
        plain, orientation = jpeg_plain.decode(d)
        if not same_bits(plain, x) or orientation:
            bad.append(f"decode {os.path.basename(f)}")
        if image_io.encode_jpeg(x) != jpeg_plain.encode(x):
            bad.append(f"encode {os.path.basename(f)}")
    big = k_image(480, 640, 1)
    data = image_io.encode_jpeg(big)
    back = image_io.decode_jpeg(data)
    if data != jpeg_plain.encode(big):
        bad.append("encode 480x640")
    if not same_bits(back, jpeg_plain.decode(data)[0]):
        bad.append("decode 480x640")
    plain_s = time.perf_counter() - t0
    err = np.abs(back.astype(np.int64) - big.astype(np.int64))
    big_dec = _median_ms(lambda: image_io.decode_jpeg(data), 10)
    big_enc = _median_ms(lambda: image_io.encode_jpeg(big), 10)
    print(f"k1. JPEG codec: {len(files)} train images ({sum(map(len, datas)) / 2 ** 20:.2f} MiB) "
          f"decode {dec_ms:.3f} ms and encode {enc_ms:.3f} ms an image (median, host clock); "
          f"480x640: decode {big_dec:.3f} ms, encode {big_enc:.3f} ms, {len(data)} bytes; "
          f"encode-then-decode round trip max |diff| {int(err.max())}, mean "
          f"{float(err.mean()):.4f}; C++ against the plain codec on {K_PLAIN_IMAGES} images "
          f"and the 480x640 one ({plain_s:.1f} s): {'equal' if not bad else bad}", flush=True)
    # warp and HSV: a 1536 x 1536 mosaic canvas to the exp's 768 x 768
    rng = random.Random(0)
    canvas = np.full((1536, 1536, 3), 114, np.uint8)
    for i, (y, x) in enumerate(((0, 0), (0, 768), (768, 0), (768, 768))):
        tile = T.resize(imgs[i], (768, 768))
        canvas[y:y + 768, x:x + 768] = tile
    m, _ = T.get_affine_matrix((768, 768), 10.0, 0.1, (0.1, 2.0), 2.0, rng=rng)
    warped = T.warp_affine(canvas, m, (768, 768))
    if not same_bits(warped, T.warp_affine_plain(canvas, m, (768, 768))):
        bad.append("warp 1536 -> 768")
    hsv = T.bgr_to_hsv(warped)
    if not same_bits(hsv, T.bgr_to_hsv_plain(warped)):
        bad.append("BGR->HSV 768")
    if not same_bits(T.hsv_to_bgr(hsv), T.hsv_to_bgr_plain(hsv)):
        bad.append("HSV->BGR 768")
    warp_ms = _median_ms(lambda: T.warp_affine(canvas, m, (768, 768)), 10)
    hsv_ms = _median_ms(lambda: T.hsv_to_bgr(T.bgr_to_hsv(warped)), 10)
    item = warped.copy()
    aug_ms = _median_ms(lambda: T.augment_hsv(item, rng=rng), 10)
    print(f"k1. warp.cpp: 1536x1536 canvas -> 768x768 {warp_ms:.3f} ms; BGR->HSV->BGR on "
          f"768x768 {hsv_ms:.3f} ms (augment_hsv {aug_ms:.3f} ms), host clock; against the "
          f"plain versions: {'equal' if not bad else bad}", flush=True)
    if bad:
        raise AssertionError(f"k1: the host C++ differs from its plain versions: {bad}")


def phase_k_loader(root):
    """k1: the exp's host loader alone (its 4 threads, no step): ms a batch
    of 16 with mosaic and mixup, and after close_mosaic."""
    from cocodet_tpu_torch.exp import get_exp_by_file

    exp = get_exp_by_file(os.path.join(REPO, J_EXP)).merge(["data_dir", root])
    out = {}
    for label in ("mosaic and mixup", "no aug"):
        loader = exp.get_data_loader(batch_size=J_BATCH, seed=0)
        if label == "no aug":
            loader.close_mosaic()
        it = iter(loader)
        next(it)  # the loader's first two batches are queued at once
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            imgs, labels, _, _ = next(it)
            times.append(1e3 * (time.perf_counter() - t0))
        it.close()
        out[label] = statistics.median(times)
    print(f"k1. host loader alone ({exp.data_num_workers} threads, B={J_BATCH}, "
          f"{exp.input_size[0]} px, {imgs.dtype} {tuple(imgs.shape)}): "
          + ", ".join(f"{k} {v:.1f} ms a batch" for k, v in out.items())
          + " (median of 4, host clock)", flush=True)


def k_argv(root, out_dir):
    """The CLI line of phase k: the shipped phase-1 exp with no override of
    its input path (the host mosaic), full width, bf16, B=16, no --cache; two
    epochs of K_TRAIN / 16 iterations, the last without aug (the trainer
    switches at epoch + 1 >= max_epoch - no_aug_epochs); the multiscale
    buckets span the exp's 640-832 at the stride 64 the 4-level model takes
    (see j_argv)."""
    return ["-f", os.path.join(REPO, J_EXP), "-b", str(J_BATCH), "data_dir", root,
            "max_epoch", "2", "warmup_epochs", "1", "no_aug_epochs", "0", "print_interval", "2",
            "multiscale_range", "(-2, 1)", "multiscale_step", "64", "output_dir", out_dir]


def phase_k2(device, root, out_dir):
    """k2: tools/train.py's main() in process on the exp as it ships; the
    counts zeroed just before, read after each epoch's evaluation."""
    from cocodet_tpu_torch import entry
    from cocodet_tpu_torch.core.trainer import Trainer

    per_epoch = []
    after = Trainer.after_epoch

    def counted(self):
        after(self)
        per_epoch.append(j_counts())

    j_reset()
    Trainer.after_epoch = counted
    try:
        t0 = time.perf_counter()
        trainer = entry.train(k_argv(root, out_dir), device=device)
        seconds = time.perf_counter() - t0
    finally:
        Trainer.after_epoch = after
    exp = trainer.exp
    print(f"k2. exp {J_EXP} as shipped: device_mosaic {exp.device_mosaic}, device_aug "
          f"{exp.device_aug}, depth {exp.depth}, width {exp.width}, {exp.compute_dtype}, input "
          f"{exp.input_size}, multiscale {exp.multiscale_sizes()}, {exp.data_num_workers} "
          f"loader threads; {len(trainer.epoch_stats)} epochs in {seconds:.2f} s", flush=True)
    j_report(trainer, "k2.")
    keys = ("bn_act.reduce", "bn_act.apply", "bn_act.grad_reduce", "bn_act.grad_apply",
            "overlap_matrix", "greedy_keep", "hard_swish")
    prev = {k: 0 for k in per_epoch[0]} if per_epoch else {}
    for i, counts in enumerate(per_epoch):
        delta = {k: counts[k] - prev[k] for k in keys}
        prev = counts
        print(f"k2. epoch {i + 1} launches (its steps and its evaluation): {delta}", flush=True)
    total = per_epoch[-1] if per_epoch else {}
    missing = [k for k in keys if total.get(k, 0) == 0]
    stats = trainer.epoch_stats
    if exp.device_mosaic or [st["use_l1"] for st in stats] != [False, True] or missing \
            or any(st["iterations"] != K_TRAIN // J_BATCH for st in stats):
        raise AssertionError(f"k2: want the host path, 2 epochs of {K_TRAIN // J_BATCH} "
                             f"iterations (the last without aug) and every kernel launched; "
                             f"got epochs {[(st['iterations'], st['use_l1']) for st in stats]}, "
                             f"not launched {missing}")
    return trainer


def phase_k3(device, trainer):
    """k3: the BN+act pair held against its plain stages
    (check_bn_act_kernels) at the BN+act maps of one step of k2's model at
    every size k2 trained at (with the exp's seed, its largest bucket in
    epoch 1 and 768 px in epoch 2), and at 768 px and the largest bucket in
    any case. Returns the check's worst numbers."""
    import torch

    exp = trainer.exp
    sizes = {tuple(s) for st in trainer.epoch_stats for s in st["size_sequence"]}
    sizes |= {tuple(exp.input_size), tuple(max(exp.multiscale_sizes()))}
    shapes = {}
    for h, w in sorted(sizes):
        images, labels = (torch.from_numpy(t).to(device)
                          for t in training_batch(J_BATCH, h, 12, width=w))
        run = lambda: trainer.train_step(images, labels)  # noqa: E731
        for key, n in activation_shapes(trainer.model, run).items():
            shapes[key] = shapes.get(key, 0) + n
    del images, labels
    torch.cuda.empty_cache()
    print(f"k3. BN+act maps of one B={J_BATCH} step at {sorted(sizes)}: {len(shapes)} shapes, "
          f"{sum(shapes.values())} maps", flush=True)
    return check_bn_act_kernels(device, shapes, tag="k3.")


def phase_k(device, card, flags):
    """k: the shipped exp as it ships, on a JPEG set the port's encoder
    writes (see the docstring). Returns k3's worst numbers."""
    import tempfile

    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp, backend_flags(flags):
        t0 = time.perf_counter()
        root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=K_TRAIN, n_val=K_VAL,
                                   size_range=(256, 512), seed=1, variant="default")
        print(f"k. synthetic set: {K_TRAIN} train and {K_VAL} val JPEGs (256-512 px, the port's "
              f"encoder) in {time.perf_counter() - t0:.2f} s", flush=True)
        phase_k1(root)
        phase_k_loader(root)
        trainer = phase_k2(device, root, os.path.join(tmp, "out"))
        worst = phase_k3(device, trainer)
        del trainer
    print(f"k. phase k: {time.perf_counter() - t_start:.1f} s ({card})", flush=True)
    return worst


L_TRAIN, L_VAL = 64, 16  # phase l's synthetic set (256-512 px JPEGs)
L_BATCHES = 4            # l1's served batches of BATCH
L_PRUNE_EXP = os.path.join("cocodet_tpu_torch", "exps", "prune", "yolox_m_p6_prune.py")
L_TUNE_EXP = os.path.join("cocodet_tpu_torch", "exps", "tune", "yolox_m_p6_tune_distill.py")


def l_counts():
    """Every launch counter of phase l's kernels."""
    from cocodet_tpu_torch.ops.cuda import bn_act as bnk
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs
    from cocodet_tpu_torch.ops.cuda import int8_conv as ic
    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk

    return ({f"bn_act.{fn.__name__}": fn.launches for fn in bnk.WRAPPERS}
            | {"hard_swish": hs.hard_swish.launches,
               "hard_swish_grad": hs.hard_swish_grad.launches,
               "int8_conv": ic.conv2d_w8a8.launches,
               "overlap_matrix": nk.overlap_matrix.launches,
               "greedy_keep": nk.greedy_keep.launches})


def l_reset():
    from cocodet_tpu_torch.ops.cuda import bn_act as bnk
    from cocodet_tpu_torch.ops.cuda import hard_swish as hs
    from cocodet_tpu_torch.ops.cuda import int8_conv as ic
    from cocodet_tpu_torch.ops.cuda import nms_kernels as nk

    for mod in (bnk, hs, ic, nk):
        mod.reset_launch_counts()


def l_parts(report):
    """{part: (effective, total)} of a sparsity report: the CSP backbone,
    the PAFPN neck and the head."""
    parts = {}
    for name, (eff, n) in report.items():
        part = ("backbone" if name.startswith("backbone/backbone/") else
                "neck" if name.startswith("backbone/") else "head")
        e, t = parts.get(part, (0, 0))
        parts[part] = (e + eff, t + n)
    return parts


def phase_l1(device, card):
    """l1: the magnitude chain at full width on seeded variables (the obj and
    cls biases at logit(0.1), as phase c): masks at 0.49, injected, merged,
    then the merged tree served dense in bf16 at B=16, 640 px, counts zeroed
    just before and read just after; and its detections, f32 on the card
    (TF32 off) against f32 on the CPU, under phase f's matching. Returns the
    unfused variables (l2's init)."""
    import numpy as np
    import torch

    from cocodet_tpu_torch.compress import (count_effective_params, generate_magnitude_masks,
                                            inject_masks, magnitude_threshold,
                                            merge_for_deployment, sparsity_report)
    from cocodet_tpu_torch.entry import Predictor, cast_parameters
    from cocodet_tpu_torch.models import build_model
    from cocodet_tpu_torch.utils.convert import flatten_tree

    variables = serving_variables(seed=0)
    t0 = time.perf_counter()
    masks = generate_magnitude_masks(variables["params"], prune_ratio=0.49, verbose=False)
    t1 = time.perf_counter()
    thresh = magnitude_threshold(variables["params"], 0.49)
    injected = inject_masks(variables, masks)
    t2 = time.perf_counter()
    merged = merge_for_deployment(injected)
    t3 = time.perf_counter()
    flat = flatten_tree(masks)
    kept = sum(int(m.sum()) for m in flat.values())
    total = sum(m.size for m in flat.values())
    parts = l_parts(sparsity_report(injected))
    eff, n = count_effective_params(injected, injected["masks"])
    eff_m, n_m = count_effective_params(merged)
    print(f"l1. magnitude masks at 0.49 over {len(flat)} conv kernels outside the head: kept "
          f"{kept} of {total} ({kept / total:.6f}) above |w| > {thresh!r}; effective / total "
          f"params " + ", ".join(f"{k} {e} / {t}" for k, (e, t) in sorted(parts.items()))
          + f", all {eff} / {n}; the merged tree {eff_m} nonzero of {n_m}; seconds: masks "
          f"{t1 - t0:.3f}, inject {t2 - t1:.3f}, merge {t3 - t2:.3f} (host)", flush=True)
    if not (0.505 < kept / total < 0.515 and eff < n):
        raise AssertionError(f"l1: kept share {kept / total}, effective {eff} of {n}")

    model = build_model("yolox-p6", depth=0.67, width=0.75, fused=True, device=device,
                        variables=merged)
    served = Predictor(cast_parameters(model, torch.bfloat16))
    rs = np.random.RandomState(4)
    batches = [rs.uniform(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
               for _ in range(L_BATCHES)]
    served(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    l_reset()
    t0 = time.perf_counter()
    results = [served(b) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = l_counts()
    x = torch.from_numpy(batches[1]).to(device)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: served.model(x), 5)
    dets = [int(r.valid.sum()) for r in results]
    print(f"l1. the merged tree served dense (bf16, fused) {L_BATCHES} x {BATCH} at {SIZE} px on "
          f"{card}: {L_BATCHES * BATCH / wall:.2f} img/s, forward {fwd_ms:.3f} ms a batch, peak "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB, detections {dets}; "
          f"launches {counts}", flush=True)
    want = {"hard_swish": CONVS * L_BATCHES, "overlap_matrix": L_BATCHES,
            "greedy_keep": L_BATCHES}
    if any(counts[k] != v for k, v in want.items()) or not all(dets):
        raise AssertionError(f"l1: launches {counts} (want {want}), detections {dets}")
    del served, model
    torch.cuda.empty_cache()

    images = torch.from_numpy(np.random.RandomState(2).uniform(
        0, 255, (2, 256, 256, 3)).astype(np.float32))
    with cudnn_deterministic():
        on_card = Predictor(build_model("yolox-p6", depth=0.67, width=0.75, fused=True,
                                        device=device, variables=merged))
        on_cpu = Predictor(build_model("yolox-p6", depth=0.67, width=0.75, fused=True,
                                       device="cpu", variables=merged))
        got, want_det = on_card(images), on_cpu(images)
    same = match_detections(type(got)(*(t.cpu() for t in got)), want_det)
    print(f"l1. the merged tree in f32, card (TF32 off) vs CPU, 2 x 256 px: detections the same "
          f"sets: {same} ({int(want_det.valid.sum())} of {want_det.valid.numel()})", flush=True)
    if not same or not int(want_det.valid.sum()):
        raise AssertionError("l1: the merged tree's detections on the card differ from the CPU's")
    del on_card
    torch.cuda.empty_cache()
    return variables


class StepTimer:
    """Wraps a step: per call the device ms (CUDA events), the host ms to
    queue it and the launches of each kernel it made."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        import torch

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        before = l_counts()
        ev[0].record()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        host = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        after = l_counts()
        self.calls.append((ev, host, {k: after[k] - before[k] for k in after if after[k] > before[k]}))
        return out

    def summary(self):
        import torch

        torch.cuda.synchronize()
        dev = [e[0].elapsed_time(e[1]) for e, _, _ in self.calls]
        return {"calls": len(self.calls), "device_ms": [round(v, 3) for v in dev],
                "host_ms": [round(h, 3) for _, h, _ in self.calls],
                "launches": self.calls[-1][2] if self.calls else {}}


def l_argv(exp, root, out_dir, extra):
    return ["-f", os.path.join(REPO, exp), "-b", str(BATCH), "data_dir", root,
            "output_dir", out_dir, "input_size", f"({SIZE}, {SIZE})",
            "test_size", f"({SIZE}, {SIZE})", "max_epoch", "1", "no_aug_epochs", "1",
            "print_interval", "2", *extra]


def l_hard_swish_grad(device, shapes):
    """The hard-swish backward kernel at each of ``shapes`` (the score step's
    activations, channels-last, x uniform on [-5, 5], a normal cotangent)
    held bit for bit against its plain version, then timed beside it and
    beside ATen's hardswish_backward (one PyTorch call), with its bound: x
    and g read once, dx written once. Returns the worst absolute error."""
    import torch

    from cocodet_tpu_torch.ops.cuda import hard_swish as hs

    gen = torch.Generator(device=device).manual_seed(17)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    worst, n_maps = 0.0, 0
    for (shape, dtype), count in shapes.items():
        x = (torch.rand(shape, generator=gen, device=device) * 10 - 5).to(dtype).contiguous(
            memory_format=torch.channels_last)
        g = torch.randn(shape, generator=gen, device=device).to(dtype).contiguous(
            memory_format=torch.channels_last)
        fns = (lambda: hs.hard_swish_grad(x, g), lambda: hs.hard_swish_grad_plain(x, g),
               lambda: torch.ops.aten.hardswish_backward(g, x))
        n, err = bit_diff(fns[0](), fns[1]())
        if n:
            raise AssertionError(f"hard_swish backward disagrees with its plain version at "
                                 f"{shape} {dtype}: {n} of {x.numel()} elements")
        worst = max(worst, err)
        for key, fn, iters in zip(("ms", "plain_ms", "library_ms"), fns, (10, 3, 10)):
            tot[key] += count * cuda_ms(fn, iters)
        tot["bytes"] += count * x.numel() * x.element_size() * 3
        n_maps += count
    bound = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"l2. hard_swish backward kernel == plain version, bit for bit, at the score step's "
          f"{len(shapes)} shapes ({n_maps} maps); summed over one step's maps: kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, aten.hardswish_backward "
          f"{tot['library_ms']:.4f} ms, byte bound {bound:.4f} ms", flush=True)
    return worst


def phase_l2(device, root, out_dir, init):
    """l2: the Pruner as its CLI runs it (tools/prune.py's build, Pruner,
    train) on the port's prune exp at full width, bf16, B=16, 640 px, one
    epoch of 4 iterations, prune_interval 0.5 (two prune events),
    prune_score_batches 2, the init checkpoint l1's variables; steps wrapped
    by StepTimer, counts zeroed just before. Then the BN+act pair, with
    gates closed in its vectors, held against its plain stages at the
    step's BN shapes, and the hard-swish backward at the score step's."""
    import torch

    from cocodet_tpu_torch.core.pruner import Pruner
    from cocodet_tpu_torch.tools.train import build

    exp, args = build(l_argv(L_PRUNE_EXP, root, out_dir, [
        "init_ckpt", init, "prune_score_batches", "2", "prune_interval", "0.5"]))
    t0 = time.perf_counter()
    pruner = Pruner(exp, args, device=device)
    pruner.before_train()
    pruner.train_step = step = StepTimer(pruner.train_step)
    pruner.score_step = score = StepTimer(pruner.score_step)
    torch.cuda.reset_peak_memory_stats(device)
    l_reset()
    t1 = time.perf_counter()
    pruner.train_epochs()
    t2 = time.perf_counter()
    counts = l_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    ev = pruner.prune_events
    st, sc = step.summary(), score.summary()
    print(f"l2. Pruner (CLI surface, {exp.max_epoch} epoch of {pruner.iters_per_epoch} "
          f"iterations at B={BATCH} {SIZE} px, {exp.compute_dtype}): {t2 - t0:.2f} s "
          f"({t1 - t0:.2f} s to "
          f"before_train's end); prune events {ev}; losses finite: "
          f"{pruner.epoch_stats[0]['nonfinite_losses'] == 0}; peak {peak:.2f} GiB; launches of "
          f"the run {counts}", flush=True)
    print(f"l2. Pruner step: device ms {st['device_ms']}, host ms to queue {st['host_ms']}, "
          f"launches a step {st['launches']}", flush=True)
    print(f"l2. score step: device ms {sc['device_ms']}, host ms to queue {sc['host_ms']}, "
          f"launches a step {sc['launches']}", flush=True)
    kept = [e["kept"] for e in ev]
    ok = (len(ev) == 2 and all(0 < e["pruned"] <= exp.prune_channels for e in ev)
          and kept[0] == ev[0]["total"] - ev[0]["pruned"] and kept[1] == kept[0] - ev[1]["pruned"]
          and pruner.epoch_stats[0]["nonfinite_losses"] == 0 and sc["calls"] == 4)
    need = ("bn_act.reduce", "bn_act.apply", "bn_act.grad_reduce", "bn_act.grad_apply",
            "hard_swish", "hard_swish_grad", "overlap_matrix", "greedy_keep")
    if not ok or any(counts[k] == 0 for k in need):
        raise AssertionError(f"l2: events {ev}, launches {counts}")

    images, labels = (torch.from_numpy(t).to(device) for t in training_batch(BATCH, SIZE, 21))
    for label, fn in (("Pruner step", pruner.train_step.fn), ("score step", pruner.score_step.fn)):
        kernels, copies, busy_ms = step_kernel_count(fn, images, labels)
        print(f"l2. {label}, one of B={BATCH} {SIZE} px under torch.profiler: {kernels} CUDA "
              f"kernels + {copies} copies or fills, the card busy (ms) {_ms(busy_ms, '.3f')}",
              flush=True)
    bn_shapes = activation_shapes(pruner.model, lambda: pruner.train_step.fn(images, labels))
    worst = check_bn_act_kernels(device, bn_shapes, tag="l2.", gate=True, ragged_cases=False)
    hs_shapes = activation_shapes(pruner.model, lambda: pruner.score_step.fn(images, labels))
    worst["hard_swish"] = l_hard_swish_grad(device, hs_shapes)
    ckpt = os.path.join(pruner.file_name, "latest_ckpt.msgpack")
    del pruner, images, labels
    torch.cuda.empty_cache()
    return ckpt, worst, t2 - t0


def phase_l3(device, root, out_dir, pruned):
    """l3: the Tuner as its CLI runs it on the port's tune exp from l2's
    checkpoint (the masked model, the init weights with their masks the
    teacher), one epoch of 4 iterations with distillation."""
    import torch

    from cocodet_tpu_torch.core.tuner import Tuner
    from cocodet_tpu_torch.tools.train import build

    exp, args = build(l_argv(L_TUNE_EXP, root, out_dir, [
        "init_ckpt", pruned, "warmup_epochs", "0", "eval_interval", "1"]))
    t0 = time.perf_counter()
    tuner = Tuner(exp, args, device=device)
    tuner.before_train()
    tuner.distill_step = step = StepTimer(tuner.distill_step)
    torch.cuda.reset_peak_memory_stats(device)
    l_reset()
    tuner.train_epochs()
    seconds = time.perf_counter() - t0
    counts = l_counts()
    st = step.summary()
    print(f"l3. Tuner (CLI surface, distillation from l2's checkpoint, masked teacher "
          f"{tuner.teacher_model.use_mask}): {seconds:.2f} s; losses finite: "
          f"{tuner.epoch_stats[0]['nonfinite_losses'] == 0}; eval {tuner.eval_stats}; peak "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB; launches {counts}",
          flush=True)
    print(f"l3. Tuner step: device ms {st['device_ms']}, host ms to queue {st['host_ms']}, "
          f"launches a step {st['launches']}", flush=True)
    images, labels = (torch.from_numpy(t).to(device) for t in training_batch(BATCH, SIZE, 22))
    kernels, copies, busy_ms = step_kernel_count(step.fn, images, labels)
    print(f"l3. Tuner step, one of B={BATCH} {SIZE} px under torch.profiler: {kernels} CUDA "
          f"kernels + {copies} copies or fills, the card busy (ms) {_ms(busy_ms, '.3f')}",
          flush=True)
    del images, labels
    if not (tuner.use_mask and tuner.epoch_stats[0]["nonfinite_losses"] == 0
            and st["calls"] == tuner.iters_per_epoch and counts["bn_act.reduce"]
            and counts["hard_swish"]):
        raise AssertionError(f"l3: the Tuner's run ({st}, {counts})")
    ckpt = os.path.join(tuner.file_name, "latest_ckpt.msgpack")
    del tuner
    torch.cuda.empty_cache()
    return ckpt, seconds


def phase_l4(device, card, tuned, out_dir):
    """l4: tools/compress_pipeline.py --slim on l3's checkpoint, then the w8a8
    headline built from the spec it wrote (entry.build_headline(spec_path=)
    with its slimmed tree), served at B=16, 640 px, counts zeroed just
    before; the int8 conv held against its plain version at each of its
    convs at the new widths, and the headline in f32 on the card against the
    plain path on the CPU (phase f's limits)."""
    import numpy as np
    import torch

    from cocodet_tpu_torch.compress import load_slim_spec
    from cocodet_tpu_torch.entry import build_headline, build_w8a8_predictor
    from cocodet_tpu_torch.ops.nms import class_offset_boxes
    from cocodet_tpu_torch.ops.postprocess import _select_topk_fused
    from cocodet_tpu_torch.tools import compress_pipeline
    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    written = compress_pipeline.main(["-c", tuned, "-o", os.path.join(out_dir, "weights"),
                                      "--slim"])
    seconds = time.perf_counter() - t0
    spec_path = written["files"]["slim_spec"]
    slim = load_slim_spec(spec_path)
    slimmed = load_checkpoint(written["files"]["slim"])["model"]
    widths = {k: v for k, v in slim.items() if isinstance(v, int)}
    print(f"l4. compress_pipeline --slim: {seconds:.2f} s (host; {written['seconds']}); params "
          f"before merge {written['before_merge']}, merged {written['merged']}, slimmed "
          f"{written['slim']}; spec widths {widths}", flush=True)
    headline = build_headline(spec_path, device=device, variables=slimmed)
    rs = np.random.RandomState(5)
    batches = [rs.uniform(0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    headline(batches[0])
    torch.cuda.synchronize()
    l_reset()
    t0 = time.perf_counter()
    results = [headline(b) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = l_counts()
    x = torch.from_numpy(batches[1]).to(device)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: headline.model(x), 5)
    print(f"l4. the headline from the port's spec served 2 x {BATCH} at {SIZE} px on {card}: "
          f"{2 * BATCH / wall:.2f} img/s, forward {fwd_ms:.3f} ms a batch, detections "
          f"{[int(r.valid.sum()) for r in results]}; launches {counts}", flush=True)
    if counts["int8_conv"] != CONVS * 2 or counts["overlap_matrix"] != 2:
        raise AssertionError(f"l4: launches {counts}")
    with torch.inference_mode():  # the NMS pair on this headline's served candidates
        boxes, _, classes, _, valid = _select_topk_fused(headline.model(x), STRIDES,
                                                         headline.cfg)
        nms_err = check_kernels(f"l4. NMS kernels on the served candidates, K={valid.shape[1]} "
                                f"B={BATCH}", class_offset_boxes(boxes, classes, valid)
                                .contiguous(), valid, headline.cfg.nms_threshold)
    x2 = torch.from_numpy(np.random.RandomState(3).uniform(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)).to(device)
    records, _ = w8a8_conv_inputs(headline.model, x2)
    worst = 0.0
    for name, m, x, odt in records:
        worst = max(worst, check_int8_conv(name, x, m.weight, m.act_scale, m.w_scale,
                                           m.bias.detach().to(odt), m.stride, odt))
    print(f"l4. int8 conv == plain version (s32 accumulators and outputs, bit for bit, with no "
          f"activation and with the fused hard-swish) on all {len(records)} w8a8 convs at the "
          f"port's spec's widths, B=2 {SIZE} px", flush=True)
    del records, x2, x
    images = torch.from_numpy(np.random.RandomState(2).uniform(
        0, 255, (2, 256, 256, 3)).astype(np.float32))
    on_card = build_w8a8_predictor(headline.variables, slim, dtype=torch.float32, device=device)
    on_cpu = build_w8a8_predictor(headline.variables, slim, dtype=torch.float32, device="cpu")
    with cudnn_deterministic():  # the 12 float prediction convs without TF32, as phase f's
        res = compare_card_cpu(on_card, on_cpu, images, device)
    print(f"l4. the headline in f32, card (TF32 off) vs plain path on the CPU, 2 x 256 px: "
          f"{res['line']}; limits: 0 inputs, 1e-4, same sets", flush=True)
    if not (res["inputs"] == 0 and res["max"] <= 1e-4 and res["same"]):
        raise AssertionError("l4: the headline on the card disagrees with the CPU")
    del headline, on_card
    torch.cuda.empty_cache()
    return worst, nms_err, seconds


def phase_l(device, card, flags):
    """l: the compression chain at full width (see the docstring). Returns the
    worst numbers of its kernel checks, for the kernels line."""
    import tempfile

    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
    from cocodet_tpu_torch.utils.checkpoint import save_checkpoint

    t_start = time.perf_counter()
    print("l. cuts: depth 0.67 and width 0.75 kept (YOLOX-M-P6); weights random from numpy "
          "seed 0 (no trained checkpoint here); the Pruner and Tuner 1 epoch of 4 iterations "
          f"(not 30 and 50) on {L_TRAIN} synthetic train and {L_VAL} val JPEGs at {SIZE} px "
          "(not COCO at 768), prune_score_batches 2 (not 8), 2 prune events of 64 channels",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compress_") as tmp, backend_flags(flags):
        variables = phase_l1(device, card)
        init = save_checkpoint({"model": variables}, False, tmp, "dense_init")
        root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=L_TRAIN, n_val=L_VAL,
                                   size_range=(256, 512), seed=2, variant="default")
        pruned, worst, prune_s = phase_l2(device, root, os.path.join(tmp, "out"), init)
        tuned, tune_s = phase_l3(device, root, os.path.join(tmp, "out"), pruned)
        worst["int8_conv"], nms_err, slim_s = phase_l4(device, card, tuned, tmp)
        worst.update(nms_err)
    print(f"l. phase l: {time.perf_counter() - t_start:.1f} s (the CLIs: prune {prune_s:.2f} s, "
          f"tune {tune_s:.2f} s, compress_pipeline {slim_s:.2f} s) ({card})", flush=True)
    return worst


def train_aug_kernels(aug_stats):
    """The kernels line's entries of K1-K4."""
    return [{"name": name, "route": "cuda", "source": "cocodet_tpu_torch/csrc/train_aug.cu",
             "replaces": TRAIN_AUG_REPLACES[name],
             **{k: st[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}}
            for name, st in aug_stats.items()]


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    flags = current_flags()  # before any phase sets them
    args = sys.argv[1:]
    if args and (len(args) != 2 or args not in (["--step", args[1]], ["--phase", "j"],
                                                 ["--phase", "j1"], ["--phase", "k"],
                                                 ["--phase", "l"])):
        print("usage: python3 chip_smoke.py [--step TREE | --phase j | --phase j1 | --phase k "
              "| --phase l]", file=sys.stderr)
        return 2
    tree = os.path.abspath(args[1]) if args[:1] == ["--step"] else REPO
    if not os.path.isdir(os.path.join(tree, "cocodet_tpu_torch")):
        print(f"chip_smoke: FAIL: no cocodet_tpu_torch package in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    build_s = phase_build()
    if args[:1] == ["--step"]:
        # --step TREE: g3's step measurement alone, of TREE's package
        res, _ = measure_train_step(device, card)
        print("step: " + json.dumps({"tree": tree, **res}), flush=True)
        return 0
    if args == ["--phase", "j1"]:
        print("j1: " + json.dumps(phase_j1_alone(device, card, flags)))
        return 0
    if args == ["--phase", "k"]:
        phase_k(device, card, flags)
        return 0
    if args == ["--phase", "l"]:
        phase_l(device, card, flags)
        return 0
    if args:
        # --phase j
        print(json.dumps({"kernels": train_aug_kernels(phase_j(device, card, flags))}))
        return 0
    worst = phase_kernels(device)
    variables = serving_variables(seed=0)
    launches, stats, predictor, dense = phase_serve(device, variables, card)
    phase_repeat(device, predictor)
    phase_reference(device, variables, predictor)
    hs_stats = phase_dense_forward(device, predictor, dense)
    del predictor
    headline, slim_vars = build_headline_model(device)
    int8_stats = phase_int8_conv(device, headline)
    # the NMS kernels' launches and times in the kernels line stay phase c's
    launches["int8_conv"] = phase_headline(device, card, headline, slim_vars, dense)["int8_conv"]
    del headline
    torch.cuda.empty_cache()
    hs_stats["max_abs_err"] = max(check_hard_swish_kernel(device), hs_stats["max_abs_err"])
    phase_train_parity(device)
    bn_stats = phase_train(device, card)
    torch.cuda.empty_cache()
    bn_stats["bn_act_finish"]["launches"] = phase_dp(device, card)
    phase_i(device, card)
    torch.cuda.empty_cache()
    aug_stats = phase_j(device, card, flags)
    torch.cuda.empty_cache()
    k_worst = phase_k(device, card, flags)
    torch.cuda.empty_cache()
    l_worst = phase_l(device, card, flags)
    for name, st in bn_stats.items():
        st["max_abs_err"] = max(st["max_abs_err"], k_worst[name[len("bn_act_"):]],
                                l_worst[name[len("bn_act_"):]])
    hs_stats["max_abs_err"] = max(hs_stats["max_abs_err"], l_worst["hard_swish"])
    int8_stats["max_abs_err"] = max(int8_stats["max_abs_err"], l_worst["int8_conv"])

    replaces = {"overlap_matrix": "cocodet_tpu/ops/pallas/nms_kernels.py:71",
                "greedy_keep": "cocodet_tpu/ops/nms.py:102"}
    kernels = [{"name": name, "route": "cuda",
                "source": "cocodet_tpu_torch/csrc/nms_kernels.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": max(s["max_abs_err"], worst[name], l_worst[name]),
                "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": None}
               for name, s in stats.items()]
    kernels.append({"name": "int8_conv", "route": "cuda",
                    "source": "cocodet_tpu_torch/csrc/int8_conv.cu",
                    "replaces": "cocodet_tpu/models/blocks.py:248",
                    "launches": launches["int8_conv"], **int8_stats, "library_ms": None})
    kernels.append({"name": "hard_swish", "route": "cuda",
                    "source": "cocodet_tpu_torch/csrc/hard_swish.cu",
                    "replaces": "cocodet_tpu/models/blocks.py:54",
                    "launches": launches["hard_swish"],
                    **{k: hs_stats[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}})
    for name, st in bn_stats.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "cocodet_tpu_torch/csrc/bn_act.cu",
                        "replaces": "cocodet_tpu/models/blocks.py:403", **st})
    kernels += train_aug_kernels(aug_stats)
    print(f"build_s={build_s:.2f} total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
