#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cocodet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):
  a. build every CUDA kernel from cocodet_tpu_torch/csrc/ with nvcc (one
     process per source, in parallel) into build/kernels/;
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
     before and read just after, and each kernel must have launched; then
     each kernel held against its plain version and timed on a batch's
     served candidates (the times of the kernels line), and the device time
     of a batch's parts, the NMS split into class offset, overlap, keep and
     compaction;
  d. check the served output against the plain reference on a small input:
     the f32 model on the card against the unfused f32 model on the CPU, the
     bf16 model against it at a bf16 tolerance, and the NMS on the card
     (kernels) against the NMS on the CPU (plain versions) on the same f32
     candidates, exactly;
  e. the int8 conv of the headline (bench.py's slim w8a8 YOLOX-M-P6, built
     by entry.build_headline: weights from a numpy seed, calibrated and
     quantized on the card): held against its plain version on the card on
     all 127 w8a8 convs at their served shapes (inputs collected by forward
     hooks on one served batch of 2 640x640 images) and on ragged cases
     (cin=12, odd sizes at stride 2, M not a multiple of the tile, scalar
     and vector act_scale, f32 and bf16 in and out): the s32 accumulators
     and the outputs must be equal bit for bit; then timed on each distinct
     shape of a served batch of 16, kernel and plain version, beside each
     conv's bound;
  f. the main path of the headline: 4 batches of 16 640x640 requests served
     through build_headline's Predictor after two warm-up batches, launch
     counts zeroed just before and read just after (127 int8 convs a batch,
     one launch of each NMS kernel); the device time of the forward and of
     the postprocess, beside the same slim model's bf16 forward through
     cuDNN and phase c's dense numbers; then the headline in f32 on the card
     against the plain path on the CPU with the same quantized variables.

Output: one line per phase, a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STRIDES = (8, 16, 32, 64)
BATCH = 16
SIZE = 640
N_BATCHES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 on the tensor cores
HOLD_CYCLES = 200_000_000  # ~0.1 s of the card's clock, while cuda_ms queues its calls
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
    host launches. Without it, the timer of chip_smoke.py before the hold."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from cocodet_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    built = build.build()
    seconds = time.perf_counter() - t0
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"a. build: {len(built)} of {len(build.sources())} CUDA sources compiled "
          f"in {seconds:.2f} s (nvcc {' '.join(build.NVCC_FLAGS)})", flush=True)
    return seconds


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
                "greedy_keep": nk.greedy_keep.launches}

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
    bit for bit; returns the max abs error of the two."""
    import torch

    from cocodet_tpu_torch.ops.cuda import int8_conv as ic

    pad = (weight.shape[-1] - 1) // 2
    y, acc = ic.int8_conv_acc(x, weight, act_scale, w_scale, bias, stride, pad, dtype=out_dtype)
    acc_plain = ic.int8_conv_acc_plain(ic.quantize_activations(x, act_scale), weight, stride, pad)
    y_plain = ic.rescale_plain(acc_plain, act_scale, w_scale, bias, out_dtype)
    torch.cuda.synchronize()
    err = max(float((acc.double() - acc_plain.double()).abs().max()),
              float((y.double() - y_plain.double()).abs().max()))
    if not (torch.equal(acc, acc_plain) and torch.equal(y, y_plain)):
        raise AssertionError(f"int8 conv disagrees with its plain version: {label}: "
                             f"{int((acc != acc_plain).sum())} accumulators, "
                             f"{int((y != y_plain).sum())} outputs differ, max err {err}")
    return err


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
    print(f"e. int8 conv == plain version (s32 accumulators and outputs, bit for bit) on all "
          f"{len(records)} w8a8 convs of the headline at B=2 {SIZE}x{SIZE}; kinds (k, stride, "
          f"C) {kinds}", flush=True)
    del records

    # ragged cases: B, C, H, W, O, k, stride, x dtype, out dtype, vector act_scale
    f32, bf16 = torch.float32, torch.bfloat16
    ragged = [(2, 12, 33, 31, 32, 3, 1, f32, bf16, False),
              (2, 12, 17, 19, 40, 3, 2, f32, f32, True),
              (2, 64, 33, 31, 64, 3, 2, bf16, f32, True), (1, 32, 7, 9, 40, 1, 1, f32, f32, False),
              (3, 48, 17, 15, 50, 3, 2, bf16, bf16, True),
              (2, 96, 21, 23, 72, 3, 1, bf16, bf16, False),
              (1, 928, 5, 5, 768, 1, 1, f32, bf16, True),
              (2, 576, 11, 9, 256, 3, 2, bf16, bf16, False)]
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
          f"at stride 2, M not a multiple of the 32-row tile, scalar and vector act_scale, "
          f"f32 and bf16 in and out); max abs err {worst}", flush=True)

    # times on a served batch of 16, one timing for each distinct shape
    x16 = torch.from_numpy(np.random.RandomState(4).uniform(
        0, 255, (BATCH, SIZE, SIZE, 3)).astype(np.float32)).to(device)
    records, _ = w8a8_conv_inputs(model, x16)
    timed = {}
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
    # activation elements the kernel quantizes (once for each 64-wide tile of
    # O and each step of 32 of K = k*k*C), and those the convs read
    quantized = inputs = 0
    largest = None
    for name, m, x, odt in records:
        bias = m.bias.detach().to(odt)
        args = (x, m.weight, m.act_scale, m.w_scale, bias, m.stride, m.padding)
        key = (tuple(x.shape), x.dtype, tuple(m.weight.shape), m.stride, m.act_scale.dim(), odt)
        if key not in timed:
            timed[key] = (cuda_ms(lambda: ic.conv2d_w8a8(*args, dtype=odt), 10),
                          cuda_ms(lambda: ic.conv2d_w8a8_plain(*args, dtype=odt), 1))
        ms, plain_ms = timed[key]
        y_numel = x.shape[0] * m.weight.shape[0] * (
            (x.shape[2] + 2 * m.padding - m.weight.shape[2]) // m.stride + 1) * (
            (x.shape[3] + 2 * m.padding - m.weight.shape[3]) // m.stride + 1)
        nbytes, ops = conv_bound(x, m.weight, y_numel, odt, m.act_scale.dim() == 1)
        o, c, kh, kw = m.weight.shape
        quantized += y_numel // o * -(-c * kh * kw // 32) * 32 * -(-o // 64)
        inputs += x.numel()
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        parts = {"ms": ms, "plain_ms": plain_ms, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "ops_ms": ops / INT8_OPS_PER_S * 1e3, "bound_ms": bound}
        for k_, v in parts.items():
            total[k_] += v
        if largest is None or ms > largest[1]:
            largest = (name, ms, bound, tuple(x.shape), tuple(m.weight.shape), m.stride)
    del records
    print(f"e. int8 conv at B={BATCH} {SIZE}x{SIZE}, {len(timed)} distinct shapes timed: "
          f"sum over the 127 launches {total['ms']:.4f} ms (plain version "
          f"{total['plain_ms']:.4f} ms); "
          f"bound {total['bound_ms']:.4f} ms (bytes {total['bytes_ms']:.4f} ms at 3.35 TB/s, "
          f"operations {total['ops_ms']:.4f} ms at 1979 TOP/s); activation elements quantized "
          f"{quantized / 1e9:.3f} G, read by the convs {inputs / 1e9:.3f} G; "
          f"largest single conv {largest[0]} "
          f"x {largest[3]} w {largest[4]} stride {largest[5]}: {largest[1]:.4f} ms (bound "
          f"{largest[2]:.4f} ms)", flush=True)
    return {"max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations"}


def match_detections(got, want, box_tol=(1e-2, 1e-3), score_tol=1e-4):
    """True if each image's detections are the same set: equal counts and a
    cover of same-class pairs with boxes within box_tol (px, relative) and
    scores within score_tol."""
    import numpy as np

    for b in range(want.valid.shape[0]):
        n = int(want.valid[b].sum())
        if int(got.valid[b].sum()) != n or not bool(got.valid[b, :n].all()):
            return False
        g = np.concatenate([got.boxes[b, :n].numpy(), got.scores[b, :n, None].numpy()], 1)
        w = np.concatenate([want.boxes[b, :n].numpy(), want.scores[b, :n, None].numpy()], 1)
        tol = np.concatenate([box_tol[0] + box_tol[1] * np.abs(w[:, :4]),
                              np.full((n, 1), score_tol)], 1)
        close = (np.abs(g[:, None, :] - w[None, :, :]) <= tol[None]).all(-1)
        match = close & (got.classes[b, :n].numpy()[:, None] == want.classes[b, :n].numpy()[None])
        if not (match.any(1).all() and match.any(0).all()):
            return False
    return True


def exact_hard_swish(x):
    """x * relu6(x + 3) / 6 as jax.nn.hard_swish writes it, one IEEE op at a
    time: the same arithmetic on the card and on the CPU. The 6 is a tensor
    on x's device: PyTorch's CUDA division by a Python number multiplies by
    its rounded reciprocal instead, as its CUDA hard-swish does."""
    return x * (x + 3).clamp(0, 6) / x.new_full((), 6.0)


def set_activation(model, fn):
    from cocodet_tpu_torch.models.blocks import ConvBnAct

    for m in model.modules():
        if isinstance(m, ConvBnAct):
            m.act = fn


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
    g = torch.cat([m[k].reshape(-1).cpu() for m in maps_g for k in keys])
    w = torch.cat([m[k].reshape(-1) for m in maps_c for k in keys])
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

    # The headline in f32 on the card against the plain path on the CPU,
    # with the same quantized variables, on 2 images of 256 px.
    images = torch.from_numpy(np.random.RandomState(2).uniform(
        0, 255, (2, 256, 256, 3)).astype(np.float32))
    on_card = build_w8a8_predictor(headline.variables, slim, dtype=torch.float32, device=device)
    on_cpu = build_w8a8_predictor(headline.variables, slim, dtype=torch.float32, device="cpu")
    # 1. Every op of the path with the same arithmetic on both: the int8
    # conv is exact, and so are the pools, the upsample, the concats and
    # the adds; hard-swish as jax.nn.hard_swish writes it, one IEEE op at a
    # time. So no int8 input may differ (limit 0), the head maps differ only
    # by the f32 prediction convs' summation order, cuDNN against oneDNN
    # (limit 1e-4 * (1 + |v|), 100x the 1e-6 seen between XLA and oneDNN on
    # the CPU), and the detections must be the same sets at the tolerance of
    # tests/test_torch_entry.py.
    for p in (on_card, on_cpu):
        set_activation(p.model, exact_hard_swish)
    exact = compare_card_cpu(on_card, on_cpu, images, device)
    print(f"f. headline f32, card vs plain path on the CPU, 2 x 256 px, hard-swish as "
          f"jax.nn.hard_swish on both: {exact['line']}; limits: 0 inputs, 1e-4, same sets",
          flush=True)
    # 2. As served, with PyTorch's own hard-swish on each device: the CUDA
    # kernel multiplies by the rounded 1/6 where the CPU's divides by 6, so
    # some outputs differ by an ulp; a quantizer that an ulp moves across a
    # rounding boundary changes an int8 input by one step, and the steps
    # spread through the net. Limit: the bf16 limit of phase d on the maps,
    # mean |d| / mean |v| <= 5e-2.
    for p in (on_card, on_cpu):
        set_activation(p.model, torch.nn.functional.hardswish)
    served = compare_card_cpu(on_card, on_cpu, images, device)
    t = torch.linspace(-4, 4, 1 << 20)
    hs_differ = int((torch.nn.functional.hardswish(t.to(device)).cpu()
                     != torch.nn.functional.hardswish(t)).sum())
    print(f"f. headline f32, card vs plain path on the CPU, PyTorch's hard-swish on each device "
          f"({hs_differ} of {t.numel()} hard-swish outputs on [-4, 4] differ between them): "
          f"{served['line']}; limit: mean |d|/mean |v| <= 5e-2", flush=True)
    if not (exact["inputs"] == 0 and exact["max"] <= 1e-4 and exact["same"]
            and served["mean"] <= 5e-2):
        raise AssertionError("the headline on the card disagrees with the plain path on the CPU")
    return launches


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
    if not os.path.isdir(os.path.join(REPO, "cocodet_tpu_torch")):
        print(f"chip_smoke: FAIL: no cocodet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    build_s = phase_build()
    worst = phase_kernels(device)
    variables = serving_variables(seed=0)
    launches, stats, predictor, dense = phase_serve(device, variables, card)
    phase_reference(device, variables, predictor)
    del predictor
    headline, slim_vars = build_headline_model(device)
    int8_stats = phase_int8_conv(device, headline)
    # the NMS kernels' launches and times in the kernels line stay phase c's
    launches["int8_conv"] = phase_headline(device, card, headline, slim_vars, dense)["int8_conv"]

    replaces = {"overlap_matrix": "cocodet_tpu/ops/pallas/nms_kernels.py:71",
                "greedy_keep": "cocodet_tpu/ops/nms.py:102"}
    kernels = [{"name": name, "route": "cuda",
                "source": "cocodet_tpu_torch/csrc/nms_kernels.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": max(s["max_abs_err"], worst[name]), "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": None}
               for name, s in stats.items()]
    kernels.append({"name": "int8_conv", "route": "cuda",
                    "source": "cocodet_tpu_torch/csrc/int8_conv.cu",
                    "replaces": "cocodet_tpu/models/blocks.py:248",
                    "launches": launches["int8_conv"], **int8_stats, "library_ms": None})
    print(f"build_s={build_s:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
