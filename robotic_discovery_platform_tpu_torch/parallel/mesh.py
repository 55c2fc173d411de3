"""Device meshes and the sharding vocabulary, the JAX package's
``parallel/mesh.py`` for PyTorch.

A :class:`Mesh` is a ``("data", "spatial", "model")`` array of devices,
as the JAX package's ``jax.sharding.Mesh``:

- ``data``: data parallelism. Its positions are the ranks of a
  ``torch.distributed`` process group, each holding its own device
  (``cuda:<local rank>`` on the card, the CPU under ``gloo``); the
  gradient all-reduce runs over that group (``parallel/dp.py``). The
  serving router walks the same axis in one process
  (:func:`make_serving_mesh`, :func:`device_ring`).
- ``spatial`` and ``model``: spatial sharding of H and tensor parallelism
  over output channels. :func:`make_mesh` builds every axis shape, as the
  JAX package does, but a train step over ``spatial > 1`` or
  ``model > 1`` raises ``NotImplementedError`` (ROADMAP item 34: each
  needs hand-written collectives inside the U-Net's forward and
  backward). :func:`tp_param_specs` is the pure function item 34 will
  execute.

"Available devices" are those of one device type: every card
(``torch.cuda.device_count()``), or the one CPU (:func:`available_devices`;
the CPU tests pass ``devices=`` a list of CPU positions instead, standing
in for the JAX package's virtual devices). Multi-process bring-up is
:func:`initialize_distributed`.

A ring may also be anything with a ``.devices`` array (the JAX package's
``Mesh``, or the explorer's ``FakeMesh``), flattened in row-major order as
the JAX package flattens a mesh's devices data-major.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from robotic_discovery_platform_tpu_torch.utils.config import MeshConfig

AXES = ("data", "spatial", "model")

#: the error a train step over an axis the port does not shard yet raises
ITEM_34 = ("tensor parallelism over 'model' and spatial sharding over "
           "'spatial' are ROADMAP item 34; the port's train step shards "
           "the 'data' axis only")


class Mesh:
    """A named device array (``devices`` shaped like ``axis_names``)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh devices of rank {devices.ndim} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {device_ring(self)})"


class Sharding(NamedTuple):
    """Where an array lives on a mesh: ``spec`` names the mesh axis each
    leading array axis is split over (None: not split); ``()`` is
    replicated. The JAX package's ``NamedSharding(mesh, PartitionSpec)``."""

    mesh: Mesh
    spec: tuple


def available_devices(device_type: str = "cuda") -> list[torch.device]:
    """Every device of ``device_type``: each card, or the one CPU."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    if device_type != "cuda":
        raise ValueError(f"unknown device type {device_type!r}")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device_type: str = "cuda") -> None:
    """Multi-process bring-up (a no-op for one process): joins this
    process to a ``torch.distributed`` group of ``num_processes`` ranks,
    NCCL on the card and ``gloo`` on the CPU. ``coordinator`` is
    ``host:port`` (rank 0 listens there) or an ``init_method`` URL
    (``tcp://...``, ``file://...``). On the card the rank's device is
    ``cuda:<rank % cards>``. A failed init raises; nothing falls back to
    another backend."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if coordinator is None or process_id is None:
        raise ValueError(
            "initialize_distributed needs a coordinator and a process_id "
            "for more than one process")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None,
              device_type: str = "cuda") -> Mesh:
    """Build a ("data", "spatial", "model") mesh. Axis sizes <= 0 are
    inferred from the device count; sizes must multiply to #devices."""
    devices = list(available_devices(device_type) if devices is None
                   else devices)
    n = len(devices)
    data, spatial, model = cfg.data, cfg.spatial, cfg.model
    spatial = max(1, spatial)
    model = max(1, model)
    if data <= 0:
        if n % (spatial * model):
            raise ValueError(
                f"cannot infer data axis: {n} devices not divisible by "
                f"spatial*model={spatial * model}"
            )
        data = n // (spatial * model)
    if data * spatial * model != n:
        raise ValueError(
            f"mesh {data}x{spatial}x{model} != {n} available devices"
        )
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, spatial, model), AXES)


def make_serving_mesh(chips: int = 0, devices=None,
                      device_type: str = "cuda") -> Mesh:
    """The serving router's mesh: ``chips`` devices along the "data" axis
    (spatial = model = 1). ``chips`` <= 0 takes every available device."""
    devices = list(available_devices(device_type) if devices is None
                   else devices)
    if chips > 0:
        if chips > len(devices):
            raise ValueError(
                f"serving mesh wants {chips} chips but only "
                f"{len(devices)} devices are available"
            )
        devices = devices[:chips]
    return make_mesh(MeshConfig(data=len(devices)), devices)


def device_ring(mesh) -> tuple:
    """The devices the serving router round-robins dispatches over: a
    sequence of devices as given, or ``mesh.devices`` flattened."""
    devices = getattr(mesh, "devices", mesh)
    if isinstance(devices, np.ndarray):
        return tuple(devices.reshape(-1))
    return tuple(devices)


def chip_shardings(mesh) -> tuple:
    """One device per ring position: where a round-robin dispatch on that
    position stages its batch."""
    return tuple(torch.device(d) for d in device_ring(mesh))


def least_loaded(loads, start: int = 0) -> int:
    """Index of the minimum of ``loads``, ties broken in ring order from
    ``start``: with all chips idle consecutive picks walk the ring
    (round-robin), under skewed load the emptiest chip wins."""
    n = len(loads)
    best = start % n
    for off in range(1, n):
        i = (start + off) % n
        if loads[i] < loads[best]:
            best = i
    return best


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, spatial: bool = False) -> Sharding:
    """NHWC batches: batch over "data", optionally H over "spatial"."""
    if spatial:
        return Sharding(mesh, ("data", "spatial", None, None))
    return Sharding(mesh, ("data",))


def tp_param_specs(params, min_channels: int = 256) -> dict:
    """Tensor-parallel specs for the port's parameter tree (a state dict,
    or ``(name, tensor)`` pairs such as ``net.named_parameters()``): the
    output-channel (last) dimension of every ``kernel`` at least
    ``min_channels`` wide is split over "model", everything else
    replicated (``()``). Names are the port's, which are the JAX tree's
    paths joined by dots. Pure: executing the specs is ROADMAP item 34."""
    items = params.items() if hasattr(params, "items") else params
    specs = {}
    for name, leaf in items:
        if (leaf.dim() >= 2 and leaf.shape[-1] >= min_channels
                and name.rpartition(".")[2] == "kernel"):
            specs[name] = (None,) * (leaf.dim() - 1) + ("model",)
        else:
            specs[name] = ()
    return specs


def data_rank() -> tuple[int, int]:
    """This process's (rank, world size) on the data axis: the default
    process group's, or (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def check_data_mesh(mesh: Mesh) -> int:
    """The data axis a train step over ``mesh`` runs on: ``spatial`` and
    ``model`` must be 1 (item 34), and the data axis must be the process
    group's world size (1 without a group). Returns the data size."""
    shape = mesh.shape
    if shape.get("spatial", 1) > 1 or shape.get("model", 1) > 1:
        raise NotImplementedError(f"mesh {shape}: {ITEM_34}")
    data = shape.get("data", 1)
    _, world = data_rank()
    if data != world:
        raise ValueError(
            f"the mesh's data axis ({data}) must equal the process "
            f"group's world size ({world}): one rank per data position")
    return data


def local_device(mesh: Mesh) -> torch.device:
    """The device of this process's data position."""
    rank, _ = data_rank()
    return torch.device(device_ring(mesh)[rank])


def shard_pytree(mesh: Mesh, tree, specs=None):
    """Place a tree of tensors (a dict, nested or flat) on this rank's
    device of ``mesh``: replicated by default. A spec naming an axis
    longer than 1 is item 34's and raises."""
    device = local_device(mesh)
    shape = mesh.shape

    def place(leaf, spec=()):
        if any(a is not None and shape.get(a, 1) > 1 for a in spec):
            raise NotImplementedError(f"spec {spec}: {ITEM_34}")
        return leaf.to(device)

    def walk(node, spec_node):
        if isinstance(node, dict):
            return {k: walk(v, None if spec_node is None else spec_node[k])
                    for k, v in node.items()}
        return place(node, () if spec_node is None else spec_node)

    return walk(tree, specs)
