"""csrc/bn_act.cu's resident kernel (bn_act_resident_kernel: a map's
train-mode BN + activation, forward or backward, in one launch of thread
block clusters), compiled by g++ against the CPU stand-in of
tests/cuda_emu/ (tests/torch_cuda_emu.py: a cluster's CTAs run at once, each
with its own shared memory, cluster.sync() a barrier of all their threads,
map_shared_rank() the same offset in another CTA's shared memory), against
the plain stages of cocodet_tpu_torch/ops/cuda/bn_act.py.

As chip_smoke.py's bn_act_case holds the card's launches: given the
kernel's own sums, its vectors and running statistics equal
``finish_plain`` / ``grad_finish_plain`` bit for bit, and y and dx equal
``apply_plain`` / ``grad_apply_plain`` given its vectors; the sums are
within 1e-5 of f64 sums, each relative to the sum of its terms'
magnitudes (f32 a thread over its rows, then f64). Clusters of 1, 2 and 4
CTAs; f32 and bf16; identity and hard-swish; 32-byte and 16-byte tiles; C a
multiple of the tile and ragged; rows that no CTA's chunk or thread's
share divides; a ChannelMask gate folded into the vectors; a chunk long
enough that a thread's copies form more than 8 cp.async groups.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_cuda_emu as emu  # noqa: E402

from cocodet_tpu_torch.ops.cuda import bn_act as bnk  # noqa: E402

SUM_TOL = 1e-5  # chip_smoke.py's BN_ACT_SUM_TOL

# (label, (N, C, H, W), dtype, act, CTAs a cluster, 16-byte groups a tile, gate)
CASES = [
    ("bf16 hswish cluster 2 C ragged", (2, 40, 7, 9), torch.bfloat16, "hard_swish", 2, 2, False),
    ("bf16 identity cluster 4 C whole", (3, 32, 5, 7), torch.bfloat16, "identity", 4, 2, False),
    ("f32 hswish cluster 4 C ragged", (5, 20, 6, 7), torch.float32, "hard_swish", 4, 2, False),
    ("f32 identity cluster 2 C whole", (1, 16, 9, 11), torch.float32, "identity", 2, 2, False),
    ("bf16 hswish cluster 4 16-byte tile", (2, 24, 9, 7), torch.bfloat16, "hard_swish", 4, 1,
     False),
    ("f32 hswish cluster 2 16-byte tile gated", (3, 12, 5, 5), torch.float32, "hard_swish", 2, 1,
     True),
    ("bf16 hswish cluster 4 gated", (2, 48, 6, 6), torch.bfloat16, "hard_swish", 4, 2, True),
    ("bf16 hswish cluster 1", (1, 16, 3, 5), torch.bfloat16, "hard_swish", 1, 2, False),
    ("bf16 hswish cluster 2 long chunk", (1, 16, 100, 91), torch.bfloat16, "hard_swish", 2, 2,
     False),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emu.build(tmp_path_factory.mktemp("bn_act_emu"), "bn_act")


def _storage(t: torch.Tensor) -> np.ndarray:
    """A channels-last map's storage ([rows, C]) as numpy (bf16 as int16)."""
    t = t.permute(0, 2, 3, 1).contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _map(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(a).reshape(like.shape[0], like.shape[2], like.shape[3], like.shape[1])
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.permute(0, 3, 1, 2)


def _inputs(shape, dtype, gate, seed):
    rs = np.random.RandomState(seed)
    c = shape[1]
    off = rs.normal(0, 2, (1, c, 1, 1))
    x = torch.from_numpy(rs.normal(0, 1.5, shape) + off).float().to(dtype)
    g = torch.from_numpy(rs.normal(0, 1, shape)).float().to(dtype)
    weight = torch.from_numpy(rs.uniform(0.5, 1.5, c)).float()
    bias = torch.from_numpy(rs.normal(0, 0.5, c)).float()
    if gate:  # a ChannelMask gate folded as models/blocks.py::ChannelMask.fold folds it
        s = torch.from_numpy((rs.uniform(0, 1, c) >= 0.3).astype(np.float32))
        offset = torch.from_numpy(rs.normal(0, 1, c)).float()
        weight, bias = weight * s, bias * s + offset * (1.0 - s)
    stats = (torch.from_numpy(rs.normal(0, 0.1, c)).float(),
             torch.from_numpy(rs.uniform(0.5, 1.5, c)).float())
    return x.contiguous(memory_format=torch.channels_last), g, weight, bias, stats


def _sum_err(got, terms):
    """Each sum's error over the sum of its terms' magnitudes (f64 terms,
    (rows, C))."""
    return float(((got.double() - terms.sum(0)) / terms.abs().sum(0).clamp_min(1e-30))
                 .abs().max())


def _launch(lib, m, backward, act, cluster, groups, **arrays):
    c = m.shape[1]
    v = 16 // m.element_size()
    a = bnk._Args(outer=m.numel() // c, inner=1, C=c, dtype=bnk._DTYPES[m.dtype],
                  act=bnk.ACTS[act], backward=int(backward), vec=1, nchw=0, groups=groups,
                  grid_x=cluster, tiles=math.ceil(c / (groups * v)), eps=float(np.float32(1e-3)),
                  keep=float(np.float32(0.97)), one_minus_keep=float(np.float32(1 - 0.97)))
    return emu.run_struct(lib, "emu_bn_act_resident", a, arrays)


@pytest.mark.parametrize("label,shape,dtype,act,cluster,groups,gate", CASES,
                         ids=[c[0] for c in CASES])
def test_resident_kernel_equals_plain_stages(lib, label, shape, dtype, act, cluster, groups,
                                             gate):
    x, g, weight, bias, stats = _inputs(shape, dtype, gate, seed=len(label))
    c = shape[1]
    rows = x.numel() // c
    assert cluster > 1 or label.endswith("cluster 1")
    # forward
    out = _launch(lib, x, False, act, cluster, groups, x=_storage(x),
                  y=np.zeros(_storage(x).shape, _storage(x).dtype), weight=weight.numpy(),
                  bias=bias.numpy(), running_mean=stats[0].numpy().copy(),
                  running_var=stats[1].numpy().copy(),
                  sums=np.full(2 * c + 1, np.nan, np.float32),
                  vec_out=np.full(4 * c, np.nan, np.float32))
    sums, fvec = torch.from_numpy(out["sums"]), torch.from_numpy(out["vec_out"]).view(4, c)
    xd = x.permute(0, 2, 3, 1).reshape(rows, c).double()
    assert sums[-1].item() == rows
    err = max(_sum_err(sums[:c], xd), _sum_err(sums[c:2 * c], xd * xd))
    assert err <= SUM_TOL, err
    rm, rv = stats[0].clone(), stats[1].clone()
    want = bnk.finish_plain(sums, weight, rm, rv, 1e-3, 0.03)
    assert torch.equal(fvec, want)
    assert torch.equal(torch.from_numpy(out["running_mean"]), rm)
    assert torch.equal(torch.from_numpy(out["running_var"]), rv)
    y = _map(out["y"], x)
    assert torch.equal(y.view(torch.int16) if dtype == torch.bfloat16 else y,
                       (lambda t: t.view(torch.int16) if dtype == torch.bfloat16 else t)(
                           bnk.apply_plain(x, fvec, bias, act).contiguous()))
    # backward, from the kernel's own forward vectors and count
    count = sums[-1:]
    out = _launch(lib, x, True, act, cluster, groups, x=_storage(x), g=_storage(g),
                  y=np.zeros(_storage(x).shape, _storage(x).dtype), fvec=fvec.numpy(),
                  bias=bias.numpy(), weight=weight.numpy(), count=count.numpy(),
                  sums=np.full(2 * c, np.nan, np.float32),
                  vec_out=np.full(4 * c, np.nan, np.float32))
    gsums, bvec = torch.from_numpy(out["sums"]), torch.from_numpy(out["vec_out"]).view(4, c)
    gz = bnk._grad_z(x, g, fvec, bias, act).double().permute(0, 2, 3, 1).reshape(rows, c)
    t = xd - fvec[0].double()
    err = max(_sum_err(gsums[:c], gz), _sum_err(gsums[c:], gz * t))
    assert err <= SUM_TOL, err
    assert torch.equal(bvec, bnk.grad_finish_plain(gsums, fvec, weight, count))
    dx = _map(out["y"], x)
    want = bnk.grad_apply_plain(x, g, fvec, bias, bvec, act).contiguous()
    if dtype == torch.bfloat16:
        dx, want = dx.contiguous().view(torch.int16), want.view(torch.int16)
    assert torch.equal(dx.contiguous(), want)
