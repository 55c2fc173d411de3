"""Data-parallel train steps over a mesh's "data" axis, the JAX package's
``parallel/dp.py`` for PyTorch.

The data axis is the ranks of the default ``torch.distributed`` process
group (NCCL on the card, ``gloo`` on the CPU), one device each
(``mesh.local_device``). Without a group the data axis must be 1 and
every collective below is the identity. Two paths, as in the JAX
package:

1. :func:`parallelize_training`, the pjit idiom: the single-device step
   over the global batch. ``DistributedDataParallel`` all-reduces the
   gradients; BatchNorm normalizes over the GLOBAL batch, since each
   BatchNorm all-reduces its per-channel means of x and x² over the group
   before using them (:func:`sync_batch_norm`); DDP's default
   ``broadcast_buffers`` would overwrite every rank's running statistics
   with rank 0's and is off. With equal shards, the mean of the ranks'
   means is the global mean (of the pixel-mean BCE and of the per-sample
   dice alike), so the step equals the single-device step over the whole
   batch, up to float32 reduction order; at world size 1 it is the
   single-device step bit for bit.
2. :func:`shard_map_train_step`, the explicit-collective idiom: each rank
   normalizes over its own shard, then all-reduces (means) its gradients,
   loss and new running statistics by hand before the replicated update.

Adam's state and the counters stay replicated: every rank applies the
same averaged gradients. Eval metrics are all-reduced (means). A mesh
with ``spatial`` or ``model`` > 1 raises ``NotImplementedError``
(ROADMAP item 34).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.parallel import mesh as mesh_lib


@dataclass
class ReplicatedState:
    """One rank's replica of the training state: the unwrapped network
    (its parameters and BatchNorm statistics; checkpoints save its state
    dict, with no ``module.`` prefix), its optimizer, and what the step
    calls (``DistributedDataParallel`` around the network, or the network
    itself)."""

    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    module: torch.nn.Module


def _group():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _all_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the data axis (in place; the identity
    without a group)."""
    import torch.distributed as dist

    if _group() is not None:
        dist.all_reduce(t)
        t.div_(dist.get_world_size())
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, differentiable: the gradient of a sum over
    ranks is the sum over ranks of the gradients."""

    @staticmethod
    def forward(ctx, t):
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def _synced_stats(world: int) -> Callable:
    """BatchNorm's statistic hook over the group: the per-channel means
    of x and x² all-reduced (with autograd, so the backward sees the
    global batch), divided by the world size."""
    def sync(mean: torch.Tensor, sq: torch.Tensor):
        stats = _AllReduceSum.apply(torch.stack([mean, sq])) / world
        return stats[0], stats[1]

    return sync


def sync_batch_norm(net: torch.nn.Module, on: bool = True) -> None:
    """Make every BatchNorm of ``net`` normalize over the data axis's
    global batch in training (``on``), or over its own batch again."""
    from robotic_discovery_platform_tpu_torch.models.unet import BatchNorm

    _, world = mesh_lib.data_rank()
    sync = _synced_stats(world) if on and _group() is not None else None
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.sync = sync


def put_global_batch(mesh: mesh_lib.Mesh, x, spatial: bool = False
                     ) -> torch.Tensor:
    """This rank's rows of a global batch every rank holds (loaders are
    seed-deterministic), as a float32 tensor on the rank's device: rank r
    takes the r-th of ``data`` equal row blocks."""
    if spatial and mesh.shape.get("spatial", 1) > 1:
        raise NotImplementedError(f"spatial batch sharding: {mesh_lib.ITEM_34}")
    data = mesh.shape.get("data", 1)
    if x.shape[0] % data:
        raise ValueError(
            f"global batch {x.shape[0]} not divisible by the data axis "
            f"({data})"
        )
    rank, _ = mesh_lib.data_rank()
    n = x.shape[0] // data
    rows = x[rank * n:(rank + 1) * n]
    device = mesh_lib.local_device(mesh)
    if isinstance(rows, torch.Tensor):
        return rows.to(device, torch.float32)
    t = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def parallelize_training(mesh: mesh_lib.Mesh, net: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         loss_fn: Callable):
    """Return ``(train_step, eval_step, state)`` over the mesh's data
    axis: ``train_step(state, x, y) -> (state, loss)`` and
    ``eval_step(state, x, y) -> metrics`` take the GLOBAL batch (host
    arrays or tensors) and return the global loss and metrics, as the
    JAX package's jitted steps do; the state is updated in place.
    ``net`` and ``optimizer`` are this rank's replica, moved to the
    rank's device. A mesh with ``model`` or ``spatial`` > 1 (tensor
    parallelism, spatial sharding) is item 34 and raises."""
    from robotic_discovery_platform_tpu_torch.training.trainer import (
        eval_step as core_eval_step,
        train_step as core_train_step,
    )

    mesh_lib.check_data_mesh(mesh)
    device = mesh_lib.local_device(mesh)
    net.to(device)
    module = net
    if _group() is not None:
        import inspect

        from torch.nn.parallel import DistributedDataParallel

        # no buffer broadcast before each forward (the newer name first)
        params = inspect.signature(DistributedDataParallel).parameters
        no_sync = ("forward_sync_buffers" if "forward_sync_buffers" in params
                   else "broadcast_buffers")
        module = DistributedDataParallel(
            net, device_ids=[device] if device.type == "cuda" else None,
            **{no_sync: False})
    sync_batch_norm(net)
    state = ReplicatedState(net, optimizer, module)

    def train(state: ReplicatedState, x, y):
        sync_batch_norm(state.net)
        loss = core_train_step(state.module, state.optimizer, loss_fn,
                               put_global_batch(mesh, x),
                               put_global_batch(mesh, y))
        return state, _all_mean(loss.clone())

    def evals(state: ReplicatedState, x, y) -> dict:
        m = core_eval_step(state.net, loss_fn, put_global_batch(mesh, x),
                           put_global_batch(mesh, y))
        return {k: _all_mean(v.clone()) for k, v in m.items()}

    return train, evals, state


def shard_map_train_step(mesh: mesh_lib.Mesh, net: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         loss_fn: Callable):
    """The explicit-collective DP step: ``step(state, x, y) -> (state,
    loss)`` over the global batch, where ``state`` is a
    :class:`ReplicatedState` (``parallelize_training``'s, or one around
    ``net`` and ``optimizer``). Each rank runs its shard's forward and
    backward with BatchNorm over its own rows, then the gradients, the
    loss and the new running statistics are averaged over the data axis
    by hand, and every rank applies the same update."""
    mesh_lib.check_data_mesh(mesh)

    def step(state: ReplicatedState, x, y):
        net, opt = state.net, state.optimizer
        sync_batch_norm(net, on=False)
        xs, ys = put_global_batch(mesh, x), put_global_batch(mesh, y)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(net(xs, train=True), ys)
        loss.backward()
        # the collective plane: the gradient all-reduce, then the new
        # running statistics
        for p in net.parameters():
            if p.grad is not None:
                _all_mean(p.grad)
        for buf in net.buffers():
            if buf.is_floating_point():
                _all_mean(buf.data)
        opt.step()
        return state, _all_mean(loss.detach().clone())

    return step


def replicated_state(mesh: mesh_lib.Mesh, net: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> ReplicatedState:
    """A :class:`ReplicatedState` of ``net`` on this rank's device, with
    no DDP wrapper (what :func:`shard_map_train_step` needs alone)."""
    net.to(mesh_lib.local_device(mesh))
    return ReplicatedState(net, optimizer, net)
