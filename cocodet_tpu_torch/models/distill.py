"""Attention-transfer distillation losses (cocodet_tpu/models/distill.py),
plain torch ops in f32 on NCHW maps.

Per feature-map pair (ref yolox/models/distill2.py:5-103):
  at_spatial  = mean_c |x|           -> L2(student, teacher)
  at_channel  = mean_hw |x|          -> L2(student, teacher)
  at_loss     = alpha * (spatial + channel)
  masks: softmax((s+t)/T) over positions (x h*w) / channels (x c)
  am_loss     = beta * sqrt(sum((s - t)^2 * spatial_mask * channel_mask))
The teacher's maps carry no gradient.

On a ``parallel.Mesh`` each rank holds its images' maps (and on a space
axis its rows of them); JAX's loss is one function of the global batch
(distill.py:31-62), and ``distiller_loss(..., mesh=)`` returns this rank's
share of it: the shares summed over the world are JAX's losses, and their
gradients, summed over the world as the train step sums every gradient,
are JAX's. The means over the global batch divide by its size; the
spatial softmax takes its max and sum over the space ranks of an image,
the channel means their sums over (H, w), and ``h * w`` is the whole map's;
``am_loss`` takes the root of its sum over the whole batch, summed over the
world first (differentiably: ``parallel/collectives.py::all_reduce_sum``).
Quantities every space rank of an image holds (its channel means and
``am_loss``) count once over the world.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..parallel.collectives import all_reduce_, all_reduce_sum

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


def _flat(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in parts])


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in like]), like)]


def mesh_losses(s_list: Sequence[torch.Tensor], t_list: Sequence[torch.Tensor],
                mesh) -> List[torch.Tensor]:
    """This rank's share of each pair's total loss on ``mesh`` (the module
    docstring): every pair's channel sums, spatial maxima and softmax
    denominators cross the space ranks in one collective each, the
    ``am_loss`` sums the world in one."""
    s_list = [s.float() for s in s_list]
    t_list = [t.detach().float() for t in t_list]
    n_space = mesh.n_space
    space = mesh.space if n_space > 1 else None
    n_batch = s_list[0].shape[0] * mesh.n_data
    abs_s = [s.abs() for s in s_list]
    abs_t = [t.abs() for t in t_list]
    # the channel means over the whole map: sums over the space ranks' rows
    sums = [a.sum((2, 3)) for a in abs_s + abs_t]
    if space is not None:
        sums = _split(all_reduce_sum(_flat(sums), space), sums)
    n = len(s_list)
    hw = [s.shape[2] * n_space * s.shape[3] for s in s_list]
    ch_s = [sums[i] / hw[i] for i in range(n)]
    ch_t = [sums[n + i] / hw[i] for i in range(n)]
    sp_s = [a.mean(1) for a in abs_s]
    sp_t = [a.mean(1) for a in abs_t]
    # the spatial softmax over an image's positions on every space rank
    z = [(a + b) / TEMPERATURE for a, b in zip(sp_s, sp_t)]
    top = [v.detach().amax((1, 2)) for v in z]
    if space is not None:
        top = _split(all_reduce_(_flat(top), space, dist.ReduceOp.MAX), top)
    e = [torch.exp(v - m.view(-1, 1, 1)) for v, m in zip(z, top)]
    den = [v.sum((1, 2)) for v in e]
    if space is not None:
        den = _split(all_reduce_sum(_flat(den), space), den)
    am_terms, at_shares = [], []
    for i, (s, t) in enumerate(zip(s_list, t_list)):
        b, c = s.shape[:2]
        spatial_mask = (e[i] / den[i].view(-1, 1, 1) * hw[i]).unsqueeze(1)
        channel_mask = torch.softmax((ch_s[i] + ch_t[i]) / TEMPERATURE, dim=-1
                                     ).reshape(b, c, 1, 1) * c
        am_terms.append(((s - t).square() * spatial_mask * channel_mask).sum())
        at_spatial = (sp_s[i] - sp_t[i]).square().sum() / (n_batch * hw[i])
        at_channel = (ch_s[i] - ch_t[i]).square().sum() / (n_batch * c * n_space)
        at_shares.append(ALPHA * (at_spatial + at_channel))
    am = BETA * torch.sqrt(all_reduce_sum(torch.stack(am_terms), mesh.world))
    return [a + m / mesh.size for a, m in zip(at_shares, am)]


def distiller_loss(student_taps: Mapping[str, Tuple[torch.Tensor, ...]],
                   teacher_taps: Mapping[str, Tuple[torch.Tensor, ...]],
                   mesh: Optional[object] = None) -> Dict[str, torch.Tensor]:
    """The sum of the per-tap losses, split backbone vs fpn
    (distill.py:81-97); on a ``mesh`` of more than one rank, this rank's
    share of each (``mesh_losses``)."""
    s_list = taps_to_distill_list(student_taps)
    t_list = taps_to_distill_list(teacher_taps)
    n_backbone = len(student_taps["backbone"])
    device = s_list[0].device
    if mesh is not None and mesh.size > 1:
        losses = mesh_losses(s_list, t_list, mesh)
    else:
        losses = [distill_loss_pair(s, t)[0] for s, t in zip(s_list, t_list)]
    backbone_loss = torch.zeros((), device=device)
    fpn_loss = torch.zeros((), device=device)
    for i, loss in enumerate(losses):
        if i < n_backbone:
            backbone_loss = backbone_loss + loss
        else:
            fpn_loss = fpn_loss + loss
    return {"dis_loss": backbone_loss + fpn_loss, "dis_backbone_loss": backbone_loss,
            "dis_fpn_loss": fpn_loss}
