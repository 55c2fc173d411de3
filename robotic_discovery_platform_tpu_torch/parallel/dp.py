"""Train steps over a mesh, the JAX package's ``parallel/dp.py`` for
PyTorch.

A mesh's positions are the ranks of the default ``torch.distributed``
process group (``parallel/mesh.py``: rank ``r`` at coordinate ``(d, s,
m)``), one device each (``mesh.local_device``). Without a group the mesh
must have one position and every collective below is the identity. Two
paths, as in the JAX package:

1. :func:`parallelize_training`, the pjit idiom: the single-device step
   over the global batch, split over every axis of the mesh. Rank ``(d,
   s, m)`` takes row block ``d`` of the batch and, when ``spatial`` > 1,
   H block ``s`` (:func:`put_global_batch`); when ``model`` > 1 every
   kernel that ``mesh.tp_param_specs(tp_min_channels)`` splits holds its
   ``Cout / model`` slice, and so do Adam's moments of it (the JAX
   package's ``_state_shardings``). The U-Net's forward runs over the
   split maps and kernels (``parallel/sharded.py``). BatchNorm normalizes
   over the GLOBAL batch: each BatchNorm takes its per-channel means of x
   and x² over the data x spatial group (:func:`sync_batch_norm`). The
   Dice and IoU sum their per-sample numerators and denominators over the
   spatial group (``models/losses.sample_sums``). Every gradient (a
   kernel's slice or a replicated parameter's) is averaged over the data
   x spatial group of the rank's model index by
   ``DistributedDataParallel`` on that group, its bucketed all-reduces
   overlapping the backward; DDP's default ``broadcast_buffers`` would
   overwrite every rank's running statistics with its group's rank 0's
   and is off. Every rank then applies the same update to what it holds.
   With equal shards the mean of the ranks' pixel-mean losses is the
   global loss, so the step equals the single-device step over the whole
   batch up to float32 reduction order; with one rank it is the
   single-device step bit for bit.
2. :func:`shard_map_train_step`, the explicit-collective idiom, which
   splits only the batch over "data" (the JAX package's): each rank
   normalizes over its own rows on a replicated state, then averages its
   gradients and its new running statistics over the data group by hand
   before the replicated update. Ranks at one data index compute the
   same step, so it runs on any mesh.

Losses and eval metrics are averaged over every rank, so every rank
returns the same values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.parallel import collectives
from robotic_discovery_platform_tpu_torch.parallel import mesh as mesh_lib

# models/ and parallel/sharded.py (which imports models/) load at a
# step's first build: the serving modules import this package's mesh


@dataclass
class ReplicatedState:
    """One rank's part of the training state: the network (its
    parameters, some of them ``model`` slices, and BatchNorm statistics;
    checkpoints save its state dict), its optimizer, the rank's mesh
    groups, the names of the parameters held as slices of their last
    dimension over the model group (:func:`full_state_dict` puts them
    together), and what the train step calls
    (``DistributedDataParallel`` around the network, or the network
    itself)."""

    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    groups: mesh_lib.MeshGroups | None = None
    sharded: tuple = ()
    module: torch.nn.Module | None = None


def _all_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over ``group`` (in place; the identity for
    ``None``)."""
    if group is not None:
        collectives.all_reduce_(t, group)
        t.div_(collectives.size(group))
    return t


def _synced_stats(group) -> Callable:
    """BatchNorm's statistic hook over ``group``: the per-channel means of
    x and x² summed over the group (with autograd, so the backward sees
    the global batch), divided by its size."""
    n = collectives.size(group)

    def sync(mean: torch.Tensor, sq: torch.Tensor):
        stats = collectives.sum_over(torch.stack([mean, sq]), group) / n
        return stats[0], stats[1]

    return sync


def sync_batch_norm(net: torch.nn.Module, group) -> None:
    """Make every BatchNorm of ``net`` normalize in training over the
    global batch of ``group`` (the data x spatial group), or over its own
    batch again (``None``)."""
    from robotic_discovery_platform_tpu_torch.models.unet import BatchNorm

    sync = _synced_stats(group) if group is not None else None
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.sync = sync


def put_global_batch(mesh: mesh_lib.Mesh, x, spatial: bool = False
                     ) -> torch.Tensor:
    """This rank's block of a global NHWC batch every rank holds (loaders
    are seed-deterministic), as a float32 tensor on the rank's device:
    rank ``(d, s, m)`` takes the ``d``-th of ``data`` equal row blocks
    and, with ``spatial``, the ``s``-th of ``spatial`` equal H blocks of
    it (every model rank the same block)."""
    d, s, _ = mesh_lib.mesh_coord(mesh)
    data = mesh.shape.get("data", 1)
    if x.shape[0] % data:
        raise ValueError(
            f"global batch {x.shape[0]} not divisible by the data axis "
            f"({data})"
        )
    n = x.shape[0] // data
    rows = x[d * n:(d + 1) * n]
    blocks = mesh.shape.get("spatial", 1) if spatial else 1
    if blocks > 1:
        if x.shape[1] % blocks:
            raise ValueError(
                f"global batch height {x.shape[1]} not divisible by the "
                f"spatial axis ({blocks})")
        h = x.shape[1] // blocks
        rows = rows[:, s * h:(s + 1) * h]
    device = mesh_lib.local_device(mesh)
    if isinstance(rows, torch.Tensor):
        return rows.to(device, torch.float32)
    t = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _shard_parameters(mesh: mesh_lib.Mesh, net: torch.nn.Module,
                      optimizer: torch.optim.Optimizer, specs: dict) -> None:
    """Replace each parameter named in ``specs`` by this rank's block
    (``mesh.shard_pytree``), in place, so the optimizer keeps it; its
    optimizer state of the parameter's shape (Adam's moments) likewise."""
    params = dict(net.named_parameters())
    for name, spec in specs.items():
        p = params[name]
        full = p.shape
        p.data = mesh_lib.shard_pytree(mesh, {name: p.detach()},
                                       {name: spec})[name]
        p.grad = None
        state = optimizer.state.get(p, {})
        for k, v in state.items():
            if torch.is_tensor(v) and v.shape == full:
                state[k] = mesh_lib.shard_pytree(mesh, {k: v}, {k: spec})[k]


def full_state_dict(state: ReplicatedState) -> dict:
    """Independent copies of the network's state dict at full shape: the
    ``model`` slices gathered. Collective: every rank of the model group
    calls it."""
    names = set(state.sharded)
    out = {}
    for k, v in state.net.state_dict().items():
        if k in names:
            v = collectives.all_gather(v, state.groups.model, -1)
        out[k] = v.detach().clone()
    return out


def full_optimizer_state(state: ReplicatedState) -> dict:
    """The optimizer's state dict at full shape: the state of each
    ``model`` slice of the slice's shape (Adam's moments) gathered.
    Collective, as :func:`full_state_dict`."""
    out = state.optimizer.state_dict()
    if not state.sharded:
        return out
    params = dict(state.net.named_parameters())
    sliced = {id(params[n]) for n in state.sharded}
    order = [p for g in state.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(order):
        if id(p) not in sliced or i not in out["state"]:
            continue
        entry = dict(out["state"][i])  # not the optimizer's own dict
        for k, v in entry.items():
            if torch.is_tensor(v) and v.shape == p.shape:
                entry[k] = collectives.all_gather(v, state.groups.model, -1)
        out["state"][i] = entry
    return out


def parallelize_training(mesh: mesh_lib.Mesh, net: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         loss_fn: Callable, tp_min_channels: int = 256):
    """Return ``(train_step, eval_step, state)`` over every axis of the
    mesh: ``train_step(state, x, y) -> (state, loss)`` and
    ``eval_step(state, x, y) -> metrics`` take the GLOBAL batch (host
    arrays or tensors) and return the global loss and metrics, as the
    JAX package's jitted steps do; the state is updated in place.
    ``net`` and ``optimizer`` are this rank's full replica (a restored
    optimizer state included): they move to the rank's device, and with
    ``model`` > 1 the kernels at least ``tp_min_channels`` wide (and their
    optimizer state) become this rank's slices. The mesh's shape decides
    what is split (module docstring)."""
    from robotic_discovery_platform_tpu_torch.models import losses
    from robotic_discovery_platform_tpu_torch.parallel import sharded
    from robotic_discovery_platform_tpu_torch.training.trainer import (
        eval_step as core_eval_step,
        train_step as core_train_step,
    )

    groups = mesh_lib.mesh_groups(mesh)
    net.to(mesh_lib.local_device(mesh))
    spatial = mesh.shape.get("spatial", 1)
    names = ()
    if mesh.shape.get("model", 1) > 1:
        specs = {n: s for n, s in mesh_lib.tp_param_specs(
            net.named_parameters(), tp_min_channels).items() if s}
        _shard_parameters(mesh, net, optimizer, specs)
        names = tuple(specs)
    module = net
    if groups.data_spatial is not None:
        import inspect

        from torch.nn.parallel import DistributedDataParallel

        # no buffer broadcast before each forward (the newer name first)
        params = inspect.signature(DistributedDataParallel).parameters
        no_sync = ("forward_sync_buffers" if "forward_sync_buffers" in params
                   else "broadcast_buffers")
        device = mesh_lib.local_device(mesh)
        module = DistributedDataParallel(
            net, device_ids=[device] if device.type == "cuda" else None,
            process_group=groups.data_spatial, **{no_sync: False})
    state = ReplicatedState(net, optimizer, groups, names, module)
    split = spatial > 1
    reduce = None
    if groups.spatial is not None:
        def reduce(t):
            return collectives.sum_over(t, groups.spatial)

    def hooked(net):
        sharded.install(net, groups, spatial, names)
        sync_batch_norm(net, groups.data_spatial)

    hooked(net)

    def train(state: ReplicatedState, x, y):
        hooked(state.net)
        with losses.sample_sums(reduce):
            loss = core_train_step(state.module, state.optimizer, loss_fn,
                                   put_global_batch(mesh, x, split),
                                   put_global_batch(mesh, y, split))
        return state, _all_mean(loss.clone(), groups.world)

    def evals(state: ReplicatedState, x, y) -> dict:
        hooked(state.net)
        with losses.sample_sums(reduce):
            m = core_eval_step(state.net, loss_fn,
                               put_global_batch(mesh, x, split),
                               put_global_batch(mesh, y, split))
        return {k: _all_mean(v.clone(), groups.world) for k, v in m.items()}

    return train, evals, state


def shard_map_train_step(mesh: mesh_lib.Mesh, net: torch.nn.Module,
                         optimizer: torch.optim.Optimizer,
                         loss_fn: Callable):
    """The explicit-collective step: ``step(state, x, y) -> (state,
    loss)`` over the global batch, where ``state`` is a replicated
    :class:`ReplicatedState` (:func:`replicated_state`, or
    ``parallelize_training``'s over a mesh that splits no kernel). Each
    rank runs the forward and backward of its data row block with
    BatchNorm over its own rows, then the gradients, the loss and the new
    running statistics are averaged over the data group by hand, and
    every rank applies the same update."""
    from robotic_discovery_platform_tpu_torch.parallel import sharded

    groups = mesh_lib.mesh_groups(mesh)

    def step(state: ReplicatedState, x, y):
        if state.sharded:
            raise ValueError(
                "shard_map_train_step takes a replicated state; this one "
                f"holds model slices of {len(state.sharded)} kernels")
        net, opt = state.net, state.optimizer
        sharded.install(net, groups, 1)  # the single-device forward
        sync_batch_norm(net, None)
        xs, ys = put_global_batch(mesh, x), put_global_batch(mesh, y)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(net(xs, train=True), ys)
        loss.backward()
        # the collective plane: the gradient all-reduce, then the new
        # running statistics
        for p in net.parameters():
            if p.grad is not None:
                _all_mean(p.grad, groups.data)
        for buf in net.buffers():
            if buf.is_floating_point():
                _all_mean(buf.data, groups.data)
        opt.step()
        return state, _all_mean(loss.detach().clone(), groups.world)

    return step


def replicated_state(mesh: mesh_lib.Mesh, net: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> ReplicatedState:
    """A :class:`ReplicatedState` of ``net`` on this rank's device, every
    parameter whole (what :func:`shard_map_train_step` needs alone)."""
    net.to(mesh_lib.local_device(mesh))
    return ReplicatedState(net, optimizer, mesh_lib.mesh_groups(mesh),
                           module=net)
