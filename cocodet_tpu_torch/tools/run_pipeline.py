"""The competition pipeline in one command (tools/run_pipeline.py) on the
port:

    phase 1 training (768) -> phase 2 fine-tune (896, GIoU) -> Taylor channel
    prune -> distill tune -> merge (BN folded) and channel slim -> the
    submission harness's self-evaluation (mAP)

    python -m cocodet_tpu_torch.tools.run_pipeline --data-dir <COCO dir> --out outputs/pipeline
    python -m cocodet_tpu_torch.tools.run_pipeline --tiny --cpu   # one-box set, CPU
    python -m cocodet_tpu_torch.tools.run_pipeline --synth --arch-set depth 0.67 width 0.75

The stages run the port's exps (``cocodet_tpu_torch/exps/``) through the
port's Trainer, Pruner and Tuner, ``compress.merge_for_deployment`` and
``slim_channels``, then ``harness.run`` on the slim (or merged) checkpoint,
scored by ``evaluators/coco_metric.py::score_detections_json``; the results
go to ``pipeline_results.json`` with JAX's keys. ``--start-stage`` resumes the
chain there, reading the skipped stages' checkpoints from ``--init-from``
through the ``chain_src.txt`` lineage (``follow_chain_ckpt``); ``--resume``
resumes a stage killed mid-run; ``--prune-set``/``--tune-set`` are merged
onto the prune and tune exps, ``--arch-set`` onto every stage's, and
``--phase2-set`` (the port's addition) onto the phase-2 exp after the
``--tiny``/``--synth`` overrides. ``--tiny`` writes the one-box set of
``data.synthetic.make_fake_coco`` and ``--synth`` the port's synthetic set
under ``--out`` (JAX writes them under /tmp). It runs on the card;
``--cpu`` asks for the CPU. A stage's evaluation that
fails is logged and leaves its AP keys out, as in JAX.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
from typing import Any, Dict, Optional, Sequence

logger = logging.getLogger("cocodet_tpu_torch")

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
EXPS = {"phase1": "p6/yolox_m_p6.py", "phase2": "p6/yolox_m_p6_tune.py",
        "prune": "prune/yolox_m_p6_prune.py", "tune": "tune/yolox_m_p6_tune_distill.py"}


class Args:
    """Trainer-args shim (tools/train.py argparse surface)."""

    batch_size = 8
    resume = False
    ckpt = None
    cache = False
    no_aug = False
    experiment_name = None
    start_epoch = None


def _tiny_overrides(exp, data_dir, max_epoch=1, lr=None):
    exp.depth = 0.33
    exp.width = 0.125
    exp.data_dir = data_dir
    exp.input_size = exp.test_size = (64, 64)
    exp.multiscale_range = 0
    exp.max_epoch = max_epoch
    exp.warmup_epochs = 0
    exp.no_aug_epochs = -1
    exp.eval_interval = 100
    exp.print_interval = 1
    exp.data_num_workers = 1
    exp.mosaic_prob = 0.0
    exp.enable_mixup = False
    exp.compute_dtype = "float32"
    exp.seed = 0
    if lr is not None:
        exp.basic_lr_per_img = lr
        exp.warmup_epochs = 0
        exp.scheduler = "yoloxwarmcos"
    exp.test_conf = 0.01
    return exp


def _synth_overrides(exp, data_dir, size=256, max_epoch=20, lr=2.5e-4, workers=2):
    """Small-but-real settings for the synthetic-shapes set: the full recipe
    (mosaic, EMA, no-aug tail, eval) at reduced scale."""
    exp.depth = 0.33
    exp.width = 0.25
    exp.data_dir = data_dir
    exp.input_size = exp.test_size = (size, size)
    exp.multiscale_range = 0
    exp.max_epoch = max_epoch
    exp.warmup_epochs = 1
    exp.no_aug_epochs = max(max_epoch // 5, 1)
    exp.eval_interval = 10 ** 6  # stage-level eval below instead
    exp.print_interval = 20
    exp.data_num_workers = workers
    exp.basic_lr_per_img = lr
    exp.scheduler = "yoloxwarmcos"
    exp.seed = 0
    exp.test_conf = 0.01
    return exp


STAGES = ("phase1", "phase2", "prune", "tune", "compress")


def follow_chain_ckpt(base, name):
    """Resolve a skipped stage's ckpt through the chain_src.txt lineage: a
    resumed run's directory only holds the stages it executed, so walk back
    through its recorded sources until the artifact appears."""
    first = os.path.join(base, name, "latest_ckpt.msgpack")
    for _ in range(len(STAGES)):
        path = os.path.join(base, name, "latest_ckpt.msgpack")
        if os.path.exists(path):
            return path
        marker = os.path.join(base, "chain_src.txt")
        if not os.path.exists(marker):
            break
        with open(marker) as f:
            base = f.read().strip()
    return first  # dead end: report the first-choice path in the error


def _count(tree) -> int:
    from cocodet_tpu_torch.utils.convert import flatten_tree

    return sum(math.prod(v.shape) for v in flatten_tree(tree).values())


def run_pipeline(data_dir, out_dir, tiny=False, batch_size=8, tiny_epochs=1, synth_epochs=0,
                 synth_size=256, start_stage="phase1", init_from=None, prune_set=None,
                 tune_set=None, arch_set=None, resume=False, phase2_set=None,
                 device: Any = "cuda", stats: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Run the chain from ``start_stage`` on (run_pipeline.py:110-411);
    earlier stages' outputs are read from ``init_from`` (default: a prior
    run in ``out_dir``). Returns the results written to
    ``pipeline_results.json``; ``stats``, if given, receives each stage's
    seconds (``"seconds"``) and its runtime's epoch stats and prune events
    (``"runtimes"``)."""
    import time

    from cocodet_tpu_torch import harness
    from cocodet_tpu_torch.compress import merge_for_deployment, slim_channels
    from cocodet_tpu_torch.core.pruner import Pruner
    from cocodet_tpu_torch.core.trainer import Trainer
    from cocodet_tpu_torch.core.tuner import Tuner
    from cocodet_tpu_torch.entry import Predictor
    from cocodet_tpu_torch.evaluators.coco_metric import score_detections_json
    from cocodet_tpu_torch.exp import get_exp
    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    os.makedirs(out_dir, exist_ok=True)
    results: Dict[str, Any] = {}
    stats = {} if stats is None else stats
    stats.update(seconds={}, runtimes={})
    synth = synth_epochs > 0
    start_idx = STAGES.index(start_stage)
    src = init_from or out_dir
    if src != out_dir:
        # the resume lineage, for a later run resuming from this directory
        with open(os.path.join(out_dir, "chain_src.txt"), "w") as f:
            f.write(os.path.abspath(src))

    def _runs(stage):
        return STAGES.index(stage) >= start_idx

    def _stage_ckpt(stage, name):
        if _runs(stage):
            return os.path.join(out_dir, name, "latest_ckpt.msgpack")
        return follow_chain_ckpt(src, name)

    # skipped stages' metrics carried forward: a full trajectory
    if start_idx > 0:
        prior = os.path.join(src, "pipeline_results.json")
        if os.path.exists(prior):
            with open(prior) as f:
                for k, v in json.load(f).items():
                    if any(k.startswith(s) for s in STAGES[:start_idx]):
                        results[k] = v

    def stage_exp(stage, name, epoch_scale=1.0, lr_scale=1.0):
        exp = get_exp(exp_file=os.path.join(PACKAGE, "exps", EXPS[stage]))
        exp.output_dir = out_dir
        exp.exp_name = name
        if tiny:
            _tiny_overrides(exp, data_dir, max_epoch=tiny_epochs, lr=2e-4)
        elif synth:
            # prune and tune at lr/10 of the training phases (ref exps/prune, exps/tune)
            _synth_overrides(exp, data_dir, size=synth_size,
                             max_epoch=max(int(synth_epochs * epoch_scale), 1),
                             lr=2.5e-4 * lr_scale)
        else:
            exp.data_dir = data_dir
        if arch_set:
            exp.merge(arch_set)
        return exp

    def stage_args(name):
        """Resume iff the stage was killed mid-run (its own latest ckpt exists)."""
        a = Args()
        a.batch_size = batch_size
        stage_ckpt = os.path.join(out_dir, name, "latest_ckpt.msgpack")
        if resume and os.path.exists(stage_ckpt):
            a.resume = True
            logger.info("stage %s: resuming from %s", name, stage_ckpt)
        return a

    def stage_eval(runtime, tag):
        """The stage's val AP50 and AP (the mAP trajectory), best-effort as in
        JAX: the EMA weights through the runtime's COCOEvaluator."""
        try:
            variables = runtime.eval_variables()
            model = runtime.exp.get_model(device=runtime.device, variables=variables,
                                          use_mask=runtime.use_mask)
            ap, ap50, _ = runtime.evaluator.evaluate(Predictor(model))
            results[f"{tag}_AP50"] = round(float(ap50), 4)
            results[f"{tag}_AP"] = round(float(ap), 4)
            logger.info("stage %s eval: AP50=%.4f AP=%.4f", tag, ap50, ap)
        except Exception as e:  # the trajectory is best-effort
            logger.warning("stage %s eval failed: %r", tag, e)

    def train_stage(stage, cls, exp, name):
        t0 = time.perf_counter()
        runtime = cls(exp, stage_args(name), device=device)
        runtime.train()
        results[f"{stage}_loss"] = float(runtime.meter["loss"].latest)
        stage_eval(runtime, stage)
        stats["seconds"][stage] = time.perf_counter() - t0
        stats["runtimes"][stage] = {"epoch_stats": runtime.epoch_stats,
                                    "prune_events": getattr(runtime, "prune_events", None)}
        return runtime

    # ---- phase 1: training at 768 ----
    exp1 = stage_exp("phase1", "pipe_phase1")
    if _runs("phase1"):
        logger.info("=== pipeline stage 1/6: phase-1 training ===")
        train_stage("phase1", Trainer, exp1, "pipe_phase1")
    phase1_ckpt = _stage_ckpt("phase1", "pipe_phase1")

    # ---- phase 2: 896 GIoU fine-tune ----
    if _runs("phase2"):
        logger.info("=== pipeline stage 2/6: phase-2 fine-tune ===")
        exp2 = stage_exp("phase2", "pipe_phase2")
        if phase2_set:
            exp2.merge(phase2_set)
        exp2.init_ckpt = phase1_ckpt
        train_stage("phase2", Trainer, exp2, "pipe_phase2")
    phase2_ckpt = _stage_ckpt("phase2", "pipe_phase2")

    # ---- stage 3: Taylor channel pruning with teacher distillation ----
    if _runs("prune"):
        logger.info("=== pipeline stage 3/6: channel pruning ===")
        exp3 = stage_exp("prune", "pipe_prune", epoch_scale=0.5, lr_scale=0.1)
        exp3.init_ckpt = phase2_ckpt
        if tiny:
            exp3.prune_channels = 8
            exp3.prune_interval = 1.0
            exp3.prune_score_batches = 1
            exp3.max_epoch = min(tiny_epochs, 10)  # bound channels removed
        elif synth:
            # gentle-surgery schedule: 4 events an epoch, 3 settling epochs
            exp3.prune_interval = 0.25
            exp3.prune_score_batches = 2
            exp3.prune_channels = getattr(exp3, "prune_channels", 40)
            exp3.prune_end_epoch = max(exp3.max_epoch - 3, 1)
        if prune_set:
            exp3.merge(prune_set)
        train_stage("prune", Pruner, exp3, "pipe_prune")
    prune_ckpt = _stage_ckpt("prune", "pipe_prune")

    # ---- stage 4: post-prune recovery tune (distillation) ----
    if _runs("tune"):
        logger.info("=== pipeline stage 4/6: recovery fine-tune ===")
        exp4 = stage_exp("tune", "pipe_tune", epoch_scale=0.5, lr_scale=0.032)
        exp4.init_ckpt = prune_ckpt
        # distill toward the dense phase-2 model: the unpruned function
        exp4.teacher_ckpt = phase2_ckpt
        if tune_set:
            exp4.merge(tune_set)
        train_stage("tune", Tuner, exp4, "pipe_tune")
    tune_ckpt = _stage_ckpt("tune", "pipe_tune")

    # ---- stage 5: offline compression + channel slim ----
    logger.info("=== pipeline stage 5/6: compress + slim ===")
    t0 = time.perf_counter()
    # recovery guard: deploy the pruned checkpoint when the tune scored lower
    deploy_ckpt = tune_ckpt
    if (results.get("tune_AP50") is not None and results.get("prune_AP50") is not None
            and results["tune_AP50"] < results["prune_AP50"]):
        logger.info("tune AP50 %.4f < prune AP50 %.4f: deploying the pruned checkpoint",
                    results["tune_AP50"], results["prune_AP50"])
        deploy_ckpt = prune_ckpt
    results["deploy_stage"] = "prune" if deploy_ckpt is prune_ckpt else "tune"
    pruned_vars = load_checkpoint(deploy_ckpt)["model"]  # the masks included
    merged = merge_for_deployment(pruned_vars, eps=1e-3)
    save_checkpoint({"model": merged}, False, out_dir, "pipe_merged")
    slim_spec = None
    if "masks" in pruned_vars:
        slimmed, spec = slim_channels(merged, pruned_vars["masks"], act="hard_swish")
        save_checkpoint({"model": slimmed}, False, out_dir, "pipe_slim")
        slim_spec = os.path.join(out_dir, "pipe_slim_spec.json")
        with open(slim_spec, "w") as f:
            json.dump(spec, f)
        results["slim_layers"] = len(spec)
        results["params_dense"] = _count(merged.get("params", merged))
        results["params_slim"] = _count(slimmed.get("params", slimmed))
        results["param_ratio"] = round(results["params_slim"]
                                       / max(results["params_dense"], 1), 4)
    stats["seconds"]["compress"] = time.perf_counter() - t0

    # ---- stage 6: the submission harness's self-evaluation ----
    logger.info("=== pipeline stage 6/6: harness self-eval ===")
    t0 = time.perf_counter()
    img_size = 64 if tiny else (synth_size if synth else 896)
    cfg = {
        "model": {"type": "yolox-p6", "depth": exp1.depth, "width": exp1.width},
        "ckpt": os.path.join(out_dir, "pipe_slim_ckpt.msgpack") if slim_spec
        else os.path.join(out_dir, "pipe_merged_ckpt.msgpack"),
        "slim_spec": slim_spec,
        "img_size": img_size,
        "half": not tiny,
        "data_dir": os.path.join(data_dir, "val2017"),
        "dataloader": {"batch_size": batch_size},
        "postprocess": {"conf_threshold": 0.001, "nms_threshold": 0.65,
                        "use_pallas": False},
        "input_aug": False,
    }
    out_json = os.path.join(out_dir, "pipe_detections.json")
    harness.run(cfg, out_json, device=device)
    scored = score_detections_json(
        os.path.join(data_dir, "annotations", "instances_val2017.json"), out_json)
    results["mAP"] = scored["AP"]
    results["AP50"] = scored["AP50"]
    stats["seconds"]["harness"] = time.perf_counter() - t0

    logger.info("pipeline done: %s", results)
    with open(os.path.join(out_dir, "pipeline_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def make_parser():
    ap = argparse.ArgumentParser("run_pipeline")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out", default="outputs/pipeline")
    ap.add_argument("--tiny", action="store_true",
                    help="the one-box synthetic set, a smoke of the whole chain")
    ap.add_argument("-b", "--batch-size", type=int, default=8)
    ap.add_argument("--tiny-epochs", type=int, default=1, help="epochs per stage in --tiny")
    ap.add_argument("--synth", action="store_true",
                    help="the synthetic-shapes set: the full recipe at reduced scale")
    ap.add_argument("--synth-epochs", type=int, default=20)
    ap.add_argument("--synth-size", type=int, default=256)
    ap.add_argument("--synth-images", type=int, default=256)
    ap.add_argument("--synth-variant", default="default",
                    choices=["default", "occlusion", "crowding", "texture", "mixed"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--start-stage", choices=list(STAGES), default="phase1")
    ap.add_argument("--init-from", default=None,
                    help="prior run directory providing skipped stages' outputs")
    ap.add_argument("--prune-set", nargs="*", default=None, metavar="K V")
    ap.add_argument("--tune-set", nargs="*", default=None, metavar="K V")
    ap.add_argument("--arch-set", nargs="*", default=None, metavar="K V",
                    help="key value overrides merged onto every stage exp")
    ap.add_argument("--phase2-set", nargs="*", default=None, metavar="K V",
                    help="key value overrides merged onto the phase-2 exp last")
    ap.add_argument("--resume", action="store_true",
                    help="resume any stage whose own latest_ckpt.msgpack exists under --out")
    return ap


def main(argv: Optional[Sequence[str]] = None,
         stats: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    args = make_parser().parse_args(argv)
    data_dir = args.data_dir
    if args.tiny and data_dir is None:
        from cocodet_tpu_torch.data.synthetic import make_fake_coco

        data_dir = make_fake_coco(os.path.join(args.out, "fake_coco"), n_images=8)
    if args.synth and data_dir is None:
        from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

        suffix = "" if args.synth_variant == "default" else f"_{args.synth_variant}"
        data_dir = make_synthetic_coco(
            os.path.join(args.out, f"synth_coco{suffix}"), n_train=args.synth_images,
            n_val=max(args.synth_images // 4, 16),
            size_range=(args.synth_size, args.synth_size * 2), variant=args.synth_variant)
    if not data_dir:
        raise SystemExit("--data-dir required unless --tiny/--synth")
    return run_pipeline(data_dir, args.out, tiny=args.tiny, batch_size=args.batch_size,
                        tiny_epochs=args.tiny_epochs,
                        synth_epochs=args.synth_epochs if args.synth else 0,
                        synth_size=args.synth_size, start_stage=args.start_stage,
                        init_from=args.init_from, prune_set=args.prune_set,
                        tune_set=args.tune_set, arch_set=args.arch_set, resume=args.resume,
                        phase2_set=args.phase2_set, device="cpu" if args.cpu else "cuda",
                        stats=stats)


if __name__ == "__main__":
    main()
