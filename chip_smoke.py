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
     candidates, exactly.

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
    return launches, stats, predictor


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
    launches, stats, predictor = phase_serve(device, variables, card)
    phase_reference(device, variables, predictor)

    replaces = {"overlap_matrix": "cocodet_tpu/ops/pallas/nms_kernels.py:71",
                "greedy_keep": "cocodet_tpu/ops/nms.py:102"}
    kernels = [{"name": name, "route": "cuda",
                "source": "cocodet_tpu_torch/csrc/nms_kernels.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": max(s["max_abs_err"], worst[name]), "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": None}
               for name, s in stats.items()]
    print(f"build_s={build_s:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
