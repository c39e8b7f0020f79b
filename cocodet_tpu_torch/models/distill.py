"""Attention-transfer distillation losses (cocodet_tpu/models/distill.py),
plain torch ops in f32 on NCHW maps.

Per feature-map pair (ref yolox/models/distill2.py:5-103):
  at_spatial  = mean_c |x|           -> L2(student, teacher)
  at_channel  = mean_hw |x|          -> L2(student, teacher)
  at_loss     = alpha * (spatial + channel)
  masks: softmax((s+t)/T) over positions (x h*w) / channels (x c)
  am_loss     = beta * sqrt(sum((s - t)^2 * spatial_mask * channel_mask))
The teacher's maps carry no gradient.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

ALPHA = 4e-4
BETA = 2e-2
TEMPERATURE = 0.5


def distill_loss_pair(student: torch.Tensor, teacher: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, at_loss, am_loss) for one NCHW feature-map pair
    (distill.py:29-63)."""
    s = student.float()
    t = teacher.detach().float()
    b, c, h, w = s.shape
    s_abs, t_abs = s.abs(), t.abs()

    at_spatial_s = s_abs.mean(1, keepdim=True)                 # (b,1,h,w)
    at_spatial_t = t_abs.mean(1, keepdim=True)
    at_spatial_loss = (at_spatial_s - at_spatial_t).square().mean()
    spatial_mask = torch.softmax(
        ((at_spatial_s + at_spatial_t) / TEMPERATURE).reshape(b, -1), dim=-1
    ).reshape(b, 1, h, w) * (h * w)

    at_channel_s = s_abs.mean((2, 3))                           # (b,c)
    at_channel_t = t_abs.mean((2, 3))
    at_channel_loss = (at_channel_s - at_channel_t).square().mean()
    at_loss = ALPHA * (at_spatial_loss + at_channel_loss)

    channel_mask = torch.softmax((at_channel_s + at_channel_t) / TEMPERATURE,
                                 dim=-1).reshape(b, c, 1, 1) * c
    am_loss = BETA * torch.sqrt(((s - t).square() * spatial_mask * channel_mask).sum())
    return at_loss + am_loss, at_loss, am_loss


def taps_to_distill_list(taps: Mapping[str, Tuple[torch.Tensor, ...]]) -> List[torch.Tensor]:
    """The PAFPN taps in the distiller's order (distill.py:66-78):
    backbone[0..L-1], td deepest-first, pan[0..L-2] (9 maps for L = 4)."""
    return list(taps["backbone"]) + list(taps["td"]) + list(taps["pan"])[:-1]


def distiller_loss(student_taps: Mapping[str, Tuple[torch.Tensor, ...]],
                   teacher_taps: Mapping[str, Tuple[torch.Tensor, ...]]
                   ) -> Dict[str, torch.Tensor]:
    """The sum of the per-tap losses, split backbone vs fpn
    (distill.py:81-97)."""
    s_list = taps_to_distill_list(student_taps)
    t_list = taps_to_distill_list(teacher_taps)
    n_backbone = len(student_taps["backbone"])
    device = s_list[0].device
    backbone_loss = torch.zeros((), device=device)
    fpn_loss = torch.zeros((), device=device)
    for i, (s, t) in enumerate(zip(s_list, t_list)):
        loss, _, _ = distill_loss_pair(s, t)
        if i < n_backbone:
            backbone_loss = backbone_loss + loss
        else:
            fpn_loss = fpn_loss + loss
    return {"dis_loss": backbone_loss + fpn_loss, "dis_backbone_loss": backbone_loss,
            "dis_fpn_loss": fpn_loss}
