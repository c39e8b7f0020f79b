"""The Tuner (cocodet_tpu/core/tuner.py): the trainer whose step adds the
attention-transfer distillation when ``distill_coefficient > 0``
(tuner.py:24-88). The teacher is ``teacher_ckpt``'s model when the exp
names one (unmasked), else the init weights, with the init checkpoint's
masks when it carries them (a pruned student's teacher computes the
function the checkpoint describes). The optimizer steps from
``tune_start_epoch`` on; the EMA runs as the exp says. A masked init
checkpoint builds the ChannelMask student, its gates fixed
(``core/trainer.py``). It inherits the Trainer's ``num_accumulate`` (the
distill step's ``optimizer.step()`` accumulates) and, without distillation,
its ranks; the distill step on several ranks raises.
"""

from __future__ import annotations

import logging
from typing import Any

from ..utils.checkpoint import load_checkpoint
from ..utils.convert import export_variables
from .pruner import distill_epoch, make_distill_train_step
from .trainer import TODO, Trainer

logger = logging.getLogger("cocodet_tpu_torch")


class Tuner(Trainer):
    @classmethod
    def trains_on_ranks(cls, exp) -> bool:
        return getattr(exp, "distill_coefficient", 0.0) <= 0

    def __init__(self, exp, args, device: Any = "cuda"):
        super().__init__(exp, args, device)
        self.distill_coefficient = getattr(exp, "distill_coefficient", 0.0)
        self.tune_start_epoch = getattr(exp, "tune_start_epoch", 0)
        if not self.trains_on_ranks(exp) and self.world > 1:
            raise NotImplementedError(f"the Tuner's distillation step (distill_coefficient > 0) "
                                      f"on several ranks is not ported {TODO}")

    def before_train(self):
        super().before_train()
        if self.distill_coefficient <= 0:
            return
        exp = self.exp
        teacher_ckpt = getattr(exp, "teacher_ckpt", None)
        if teacher_ckpt:
            ckpt = load_checkpoint(teacher_ckpt)
            tree = ckpt.get("model", ckpt)
            self.teacher_model = exp.get_model(device=self.device, variables={
                "params": tree["params"], "batch_stats": tree.get("batch_stats", {})})
            logger.info("Tuner: teacher from %s", teacher_ckpt)
        else:
            self.teacher_model = exp.get_model(device=self.device, use_mask=self.use_mask,
                                               variables=export_variables(self.model))
        self.distill_step = make_distill_train_step(
            self.state, self.teacher_model, exp.strides, num_classes=exp.num_classes,
            iou_type=exp.iou_type, distill_coefficient=self.distill_coefficient,
            simota_bf16=getattr(exp, "simota_bf16", False))
        logger.info("Tuner: distillation on (coef=%.3g)", self.distill_coefficient)

    def train_in_iter(self):
        if self.distill_coefficient <= 0:
            return super().train_in_iter()
        distill_epoch(self, self.distill_step, self.epoch >= self.tune_start_epoch)
