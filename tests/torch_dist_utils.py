"""Rank bodies of the data-parallel tests (tests/test_torch_parallel.py and
tests/test_torch_dp_step.py), run by ``cocodet_tpu_torch.parallel.launch.
run_ranks`` in spawned gloo ranks on the CPU. The ranks import this module,
so it imports numpy, torch and the port only (no JAX). Each body returns
numpy arrays and numbers; the tests compare them in the parent."""

import numpy as np
import torch
import torch.distributed as dist

from cocodet_tpu_torch.core import train_state as ts
from cocodet_tpu_torch.models import build_model
from cocodet_tpu_torch.models.blocks import BatchNorm, Conv2d, SPPBottleneck
from cocodet_tpu_torch.ops.fuse import bn_stats_allreduce
from cocodet_tpu_torch.parallel import (batch_sharding_fn, make_mesh, make_mesh_2d,
                                        process_allgather_detections, replicate,
                                        shard_batch, sync_global_devices)
from cocodet_tpu_torch.parallel.collectives import (all_gather, all_reduce_, all_reduce_sum,
                                                    gather_rows, halo_exchange)
from cocodet_tpu_torch.parallel.mesh import use_mesh
from cocodet_tpu_torch.utils import lr_scheduler as tlr
from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree

STRIDES = (8, 16, 32, 64)


def train_rank(rank, device, variables, runs, schedule):
    """One step of the port's data-parallel train step for each of ``runs``:
    ``(n_space, images, labels, dtype name)``, each from ``variables``.
    Returns, for each, (metrics, flat variables, EMA shadow) as
    tests/torch_train_utils.py::port_steps does."""
    torch.set_num_threads(1)
    out = []
    for n_space, images, labels, dtype_name in runs:
        dtype = getattr(torch, dtype_name)
        mesh = make_mesh(device) if n_space == 1 else make_mesh_2d(n_space, device)
        model = build_model("yolox-p6", depth=0.33, width=0.125, device=device,
                            variables=variables).to(dtype)
        model.dtype = dtype
        opt = ts.build_optimizer(model, tlr.build_lr_schedule("yoloxwarmcos", **schedule))
        state = ts.create_train_state(model, opt, mesh=mesh)
        step = ts.make_train_step(state, STRIDES, mesh=mesh)
        local = shard_batch(mesh, (images.astype(dtype_name), labels))
        metrics = step(*local, use_l1=True)
        out.append(({k: float(v) for k, v in metrics.items()},
                    flatten_tree(export_variables(model)),
                    {name: t.clone() for name, t in state.ema.shadow.items()}))
    return out


# --------------------------------------------------------------------------
# collectives under torch.autograd.gradcheck
# --------------------------------------------------------------------------


class _Scatter(torch.autograd.Function):
    """This rank's rows of a tensor every rank holds whole; the backward
    places the cotangent in those rows and sums over the group. With
    ``gather_rows`` after it, a function of sharded rows becomes one of the
    whole tensor, the same on every rank, which gradcheck can hold: every
    rank perturbs the same element of the same whole input at once."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        rows = x.shape[dim] // n
        ctx.args = (group, dim, i, rows, x.shape)
        return x.narrow(dim, i * rows, rows).clone()

    @staticmethod
    def backward(ctx, g):
        group, dim, i, rows, shape = ctx.args
        whole = g.new_zeros(shape)
        whole.narrow(dim, i * rows, rows).copy_(g)
        return all_reduce_(whole, group), None, None


# (top, bottom, fill) of the halo_exchange cases, on shares of 1 and 2 rows
HALOS = ((1, 1, 0.0), (1, 0, 0.0), (0, 2, 0.0), (3, 2, 0.0), (5, 5, float("-inf")))
LAYERS = ("conv k=1 stride=1", "conv k=3 stride=1", "conv k=3 stride=2", "conv k=1 stride=2",
          "spp", "batchnorm")


def halo_case(rows, top, bottom, fill):
    return f"halo_exchange rows={rows} top={top} bottom={bottom} fill={fill}"


def gradcheck_rank(rank, device):
    """gradcheck in f64 of all_reduce_sum, gather_rows and halo_exchange
    (halos of 0-5 rows on 1- and 2-row shares, so some come from several
    ranks, with zero and -inf fill), each as a function of a whole tensor
    that every rank holds; returns {case: passed}."""
    torch.set_num_threads(1)
    group = dist.group.WORLD
    n = dist.get_world_size()
    rs = np.random.RandomState(5)
    out = {}

    def whole(fn, x):
        # the ranks' outputs side by side: gather_rows's backward hands each
        # rank its part of the cotangent, the same on every rank
        return gather_rows(fn(_Scatter.apply(x, group, 2)), group, 2)

    x = torch.from_numpy(rs.normal(size=(2, 3, 2 * n, 2))).requires_grad_()
    out["all_reduce_sum"] = torch.autograd.gradcheck(
        lambda x: whole(lambda t: all_reduce_sum(t * t, group), x), (x,))
    # gather_rows where every rank computes the same function of the result
    out["gather_rows"] = torch.autograd.gradcheck(
        lambda x: (lambda g: torch.sin(g) * g.sum())(
            gather_rows(_Scatter.apply(x, group, 1), group, 1)), (x,))
    for rows in (1, 2):
        x = torch.from_numpy(rs.normal(size=(1, 2, rows * n, 3))).requires_grad_()
        for top, bottom, fill in HALOS:
            def fn(t, top=top, bottom=bottom, fill=fill):
                h = halo_exchange(t, top, bottom, group, fill=fill)
                h = torch.where(torch.isinf(h), torch.zeros_like(h), h)
                # back to this rank's rows, each a function of its halo
                return torch.nn.functional.avg_pool2d(h * h, (top + bottom + 1, 1), stride=1)
            out[halo_case(rows, top, bottom, fill)] = torch.autograd.gradcheck(
                lambda x: whole(fn, x), (x,))
    return out


# --------------------------------------------------------------------------
# sharded layers against the whole layer
# --------------------------------------------------------------------------


def _grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters()}


def _run_sharded(mesh, module, x_whole, w_whole, rows_dim=2):
    """The module on this rank's share of ``x_whole`` (batch over data,
    height over space) under ``use_mesh``: (its output, the input's
    gradient, the parameters' gradients summed over the world) for the loss
    sum(w * out) whose weights are this rank's share of ``w_whole``."""
    def share(t):
        t = t.narrow(0, mesh.data_index * t.shape[0] // mesh.n_data, t.shape[0] // mesh.n_data)
        rows = t.shape[rows_dim] // mesh.n_space
        return t.narrow(rows_dim, mesh.space_index * rows, rows).contiguous()

    x = share(x_whole).requires_grad_()
    module.zero_grad()
    with use_mesh(mesh):
        y = module(x)
    (y * share(w_whole)).sum().backward()
    grads = {n: all_reduce_(g, mesh.world) for n, g in _grads(module).items()}
    return y.detach(), x.grad, grads, share


def _run_whole(module, x_whole, w_whole):
    x = x_whole.clone().requires_grad_()
    module.zero_grad()
    y = module(x)
    (y * w_whole).sum().backward()
    return y.detach(), x.grad, _grads(module)


def layers_rank(rank, device):
    """Height-sharded Conv2d (k 1 and 3, stride 1 and 2), SPPBottleneck and
    BatchNorm (train mode, global batch) on a (data x space) mesh of the
    world, in f64, against the same layer on the whole batch: {case: (max
    |output diff|, max |input grad diff|, max |param grad diff|, max |running
    stat diff|, scale)}."""
    torch.set_num_threads(1)
    n = dist.get_world_size()
    out = {}
    for n_space in [s for s in (1, 2, 4) if n % s == 0]:
        mesh = make_mesh_2d(n_space, device)
        rs = np.random.RandomState(4)
        cases = []
        for k, stride in ((1, 1), (3, 1), (3, 2), (1, 2)):
            cases.append((f"conv k={k} stride={stride}", lambda k=k, stride=stride:
                          Conv2d(6, 5, k, stride, use_bias=True), 4 * n_space))
        cases.append(("spp", lambda: SPPBottleneck(6, 8, act="hard_swish"), 2 * n_space))
        cases.append(("batchnorm", lambda: BatchNorm(6), 4 * n_space))
        for name, make, height in cases:
            torch.manual_seed(0)
            whole_mod = make().double()
            for p in whole_mod.parameters():
                p.data.uniform_(-1, 1)
            if isinstance(whole_mod, BatchNorm):
                whole_mod.running_var.uniform_(0.5, 1.5)
            shard_mod = make().double()
            shard_mod.load_state_dict(whole_mod.state_dict())
            whole_mod.train(), shard_mod.train()
            batch = 2 * mesh.n_data
            x = torch.from_numpy(rs.normal(size=(batch, 6, height, 5)))
            with torch.no_grad():
                y_shape = whole_mod(x).shape
            w = torch.from_numpy(rs.normal(size=y_shape))
            whole_mod.load_state_dict(shard_mod.state_dict())  # undo the shape probe's BN update
            yw, gw, pw = _run_whole(whole_mod, x, w)
            ys, gs, ps, share = _run_sharded(mesh, shard_mod, x, w)
            stats = [0.0]
            if isinstance(whole_mod, BatchNorm):
                stats = [float((a - b).abs().max()) for a, b in
                         ((shard_mod.running_mean, whole_mod.running_mean),
                          (shard_mod.running_var, whole_mod.running_var))]
            out[f"{name} on ({mesh.n_data} data x {n_space} space)"] = (
                float((ys - share(yw)).abs().max()), float((gs - share(gw)).abs().max()),
                max(float((ps[p] - pw[p]).abs().max()) for p in pw), max(stats),
                float(yw.abs().max()))
    return out


def quant_layers_rank(rank, device):
    """Height-sharded int8 layers on a (1 data x 2 space) mesh against the
    same layer on the whole map: a ``"calib"`` conv's ``act_absmax`` (its
    parts' too) and output, and ``"w8a8"`` convs (1x1, 3x3, 3x3 stride 2,
    the 6x6 stem on 3 channels, a parts conv with an up2x part): {case:
    (max |output diff|, max |absmax diff|)}."""
    torch.set_num_threads(1)
    mesh = make_mesh_2d(2, device)
    rs = np.random.RandomState(6)
    out = {}

    def share(t):
        rows = t.shape[2] // mesh.n_space
        return t.narrow(2, mesh.space_index * rows, rows).contiguous(
            memory_format=torch.channels_last)

    def w8a8(cin, o, k, stride):
        conv = Conv2d(cin, o, k, stride, use_bias=True, quant="w8a8")
        conv.weight.copy_(torch.from_numpy(rs.randint(-127, 128, (o, cin, k, k)).astype(np.int8)))
        conv.w_scale.copy_(torch.from_numpy((rs.rand(o) * 1e-2).astype(np.float32)))
        conv.act_scale.fill_(0.2)
        conv.bias.data.uniform_(-1, 1)
        return conv

    def image(c, h, w=6):
        return torch.from_numpy((rs.rand(1, c, h, w) * 60 - 20).astype(np.float32)).contiguous(
            memory_format=torch.channels_last)

    for name, conv, x in (("w8a8 k=1", w8a8(8, 6, 1, 1), image(8, 8)),
                          ("w8a8 k=3", w8a8(8, 6, 3, 1), image(8, 8)),
                          ("w8a8 k=3 stride 2", w8a8(8, 6, 3, 2), image(8, 8)),
                          ("w8a8 6x6 stem", w8a8(3, 6, 6, 2), image(3, 16, 8))):
        with torch.no_grad():
            whole = conv(x, act="hard_swish")
            with use_mesh(mesh):
                mine = conv(share(x), act="hard_swish")
        out[name] = (float((mine - share(whole)).abs().max()), 0.0)
    conv = w8a8(12, 6, 1, 1)
    a, b = image(4, 4, 3), image(8, 8)
    with torch.no_grad():
        whole = conv([(a, True), b])
        with use_mesh(mesh):
            mine = conv([(share(a), True), share(b)])
    out["w8a8 parts"] = (float((mine - share(whole)).abs().max()), 0.0)
    for name, parts in (("calib", False), ("calib parts", True)):
        whole_conv = Conv2d(8, 5, 3, 1, use_bias=True, quant="calib")
        torch.nn.init.uniform_(whole_conv.weight, -1, 1)
        torch.nn.init.uniform_(whole_conv.bias, -1, 1)
        shard_conv = Conv2d(8, 5, 3, 1, use_bias=True, quant="calib")
        shard_conv.load_state_dict(whole_conv.state_dict())
        x = image(8, 8)
        x[:, :3, 1] *= 3.0  # the largest values of channels 0-2 on rank 0's rows only
        inputs = [x[:, :3], x[:, 3:]] if parts else x
        with torch.no_grad():
            whole = whole_conv(inputs)
            with use_mesh(mesh):
                mine = shard_conv([share(t) for t in inputs] if parts else share(inputs))
        out[name] = (float((mine - share(whole)).abs().max()),
                     float((shard_conv.act_absmax - whole_conv.act_absmax).abs().max()))
    return out


# --------------------------------------------------------------------------
# mesh helpers
# --------------------------------------------------------------------------


def mesh_rank(rank, device, leaves):
    """shard_batch and batch_sharding_fn on ``leaves`` over a 1-D and a
    (n/2 x 2) mesh, replicate, bn_stats_allreduce,
    process_allgather_detections and sync_global_devices."""
    torch.set_num_threads(1)
    out = {"specs": {}, "shards": {}}
    for name, mesh in (("1-D", make_mesh(device)), ("2-D", make_mesh_2d(2, device))):
        out["specs"][name] = [batch_sharding_fn(mesh)(x) for x in leaves]
        out["shards"][name] = [t.numpy() for t in shard_batch(mesh, leaves)]
        out[f"coords {name}"] = (mesh.data_index, mesh.space_index, mesh.n_data, mesh.n_space)
    torch.manual_seed(rank)  # a different model on every rank
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    model[1].running_mean.normal_()
    replicate(make_mesh(device), model)
    out["replicated"] = {k: v.numpy() for k, v in model.state_dict().items()}
    bn = BatchNorm(3)
    bn.running_mean.fill_(float(rank))
    bn.running_var.fill_(float(2 * rank + 1))
    bn_stats_allreduce(bn, dist.group.WORLD)
    out["bn mean"] = (bn.running_mean.numpy(), bn.running_var.numpy())
    out["detections"] = process_allgather_detections([{"rank": rank, "i": i}
                                                      for i in range(rank + 1)])
    sync_global_devices("test")
    out["gathered"] = [t.numpy() for t in all_gather(torch.full((2,), float(rank)))]
    return out


def parallel_rank(rank, device, leaves):
    """gradcheck_rank, layers_rank and mesh_rank in one run of ranks."""
    return {"gradcheck": gradcheck_rank(rank, device), "layers": layers_rank(rank, device),
            "mesh": mesh_rank(rank, device, leaves)}


def failing_rank(rank, device, how):
    """Rank 1 raises (``how="raise"``) or never reaches the barrier the
    others wait at (``how="hang"``)."""
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails on purpose")
        import time
        time.sleep(120)
    dist.barrier()
    return rank


# --------------------------------------------------------------------------
# the compression trainers' steps on a mesh (tests/test_torch_distill_ranks.py)
# --------------------------------------------------------------------------


def distill_step(device, variables, masks, batch, lr, mesh=None):
    """The masked student's score step importance and one distill step with
    the unmasked teacher (core/pruner.py), in f64, on ``mesh`` (each rank
    its share of ``batch``) or in one process: (importance, metrics, flat
    variables) as numpy."""
    from cocodet_tpu_torch.core import pruner as tpr

    student = build_model("yolox-p6", depth=0.33, width=0.125, device=device, use_mask=True,
                          variables={**variables, "masks": masks}).to(torch.float64)
    teacher = build_model("yolox-p6", depth=0.33, width=0.125, device=device,
                          variables=variables).to(torch.float64)
    student.dtype = teacher.dtype = torch.float64
    state = ts.create_train_state(student, ts.build_optimizer(student, lr), use_ema=False,
                                  mesh=mesh)
    images, labels = batch
    local = ((torch.from_numpy(images).double(), torch.from_numpy(labels)) if mesh is None
             else shard_batch(mesh, (images.astype(np.float64), labels)))
    importance = {"/".join(k): v.numpy() for k, v in
                  tpr.make_score_step(student, STRIDES, mesh=mesh)(*local).items()}
    step = tpr.make_distill_train_step(state, teacher, STRIDES, mesh=mesh)
    metrics = {k: float(v) for k, v in step(*local, use_l1=True).items()}
    return importance, metrics, flatten_tree(export_variables(student))


def distill_rank(rank, device, variables, masks, batches, lr, taps):
    """In f64, the score step and one distill step (``distill_step``) of
    ``batches[0]`` on a 1-D data mesh of every rank and of ``batches[1]``
    on a (world/2 data x 2 space) mesh; then on the 2-D mesh the
    distillation loss of ``taps`` (NCHW student and teacher lists), each
    rank given its images' rows: its shares, the global values and its
    gradients. Returns numpy arrays and numbers."""
    from cocodet_tpu_torch.models import distill as td

    torch.set_num_threads(1)
    mesh, mesh2 = make_mesh(device), make_mesh_2d(2, device)
    importance, metrics, params = distill_step(device, variables, masks, batches[0], lr, mesh)
    out = {"importance": importance, "metrics": metrics, "params": params,
           "2-D": distill_step(device, variables, masks, batches[1], lr, mesh2)}

    def rows(a):
        b, h = a.shape[0] // mesh2.n_data, a.shape[2] // mesh2.n_space
        return torch.from_numpy(a[mesh2.data_index * b:(mesh2.data_index + 1) * b, :,
                                  mesh2.space_index * h:(mesh2.space_index + 1) * h]).clone()

    s_taps = {k: tuple(rows(a).requires_grad_() for a in v) for k, v in taps[0].items()}
    t_taps = {k: tuple(rows(a) for a in v) for k, v in taps[1].items()}
    shares = td.distiller_loss(s_taps, t_taps, mesh2)
    shares["dis_loss"].backward()
    total = all_reduce_(torch.stack([v.detach() for v in shares.values()]), mesh2.world)
    out["loss_2d"] = dict(zip(shares, total.tolist()))
    out["grads_2d"] = {k: [None if a.grad is None else a.grad.numpy() for a in v]
                       for k, v in s_taps.items()}
    out["coords_2d"] = (mesh2.data_index, mesh2.space_index)
    return out
