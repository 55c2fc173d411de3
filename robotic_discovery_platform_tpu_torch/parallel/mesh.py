"""Device meshes and the sharding vocabulary, the JAX package's
``parallel/mesh.py`` for PyTorch.

A :class:`Mesh` is a ``("data", "spatial", "model")`` array of devices,
as the JAX package's ``jax.sharding.Mesh``. A train step over it runs one
rank of a ``torch.distributed`` process group per position: the group's
world size is the mesh's size, and rank ``r`` sits at the row-major
coordinate ``(d, s, m)`` of the device array (:func:`mesh_coord`), the
order in which the JAX mesh reshapes its devices. Each rank holds its own
device (``cuda:<rank % cards>`` on the card, the CPU under ``gloo``;
several ranks may share one card under ``gloo``, ``initialize_distributed
(backend=...)``).

- ``data``: data parallelism; rank ``(d, ., .)`` takes row block ``d``
  of the global batch.
- ``spatial``: H of the activations split over the ranks
  ``(d, ., m)``, with halo exchanges (``parallel/sharded.py``).
- ``model``: tensor parallelism; each kernel that :func:`tp_param_specs`
  splits holds its ``Cout / model`` slice on rank ``(., ., m)``.

:func:`mesh_groups` builds the subgroups a step over the mesh reduces
over, once per mesh. The serving router walks the data axis in one
process (:func:`make_serving_mesh`, :func:`device_ring`).

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
                           device_type: str = "cuda",
                           backend: str | None = None) -> None:
    """Multi-process bring-up (a no-op for one process): joins this
    process to a ``torch.distributed`` group of ``num_processes`` ranks
    over ``backend``: by default NCCL on the card and ``gloo`` on the
    CPU; ``"gloo"`` on the card lets several ranks share one card (NCCL
    refuses two ranks on one device; gloo runs the collectives of
    ``parallel/collectives.py`` on CUDA tensors). ``coordinator`` is ``host:port``
    (rank 0 listens there) or an ``init_method`` URL (``tcp://...``,
    ``file://...``, ``env://``). On the card the rank's device is
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
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def rank_devices(device_type: str = "cuda") -> list[torch.device]:
    """The device of each rank of the process group, in rank order
    (``cuda:<rank % cards>``; the CPU for every rank on the CPU): the
    devices to build a train mesh over when several ranks share a card.
    One device without a group."""
    devices = available_devices(device_type)
    _, world = data_rank()
    return [devices[r % len(devices)] for r in range(world)]


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
    paths joined by dots. :func:`shard_pytree` executes them, and
    ``parallel/dp.parallelize_training`` trains the slices."""
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
    """This process's (rank, world size) in the default process group,
    or (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class MeshGroups(NamedTuple):
    """This rank's place on a mesh and the subgroups a step reduces
    over. A group of one rank is ``None`` (``parallel/collectives.py``
    treats it as the identity)."""

    coord: tuple          # (d, s, m)
    model: object         # the ranks (d, s, .)
    spatial: object       # the ranks (d, ., m)
    data_spatial: object  # the ranks (., ., m): the gradient average
    data: object          # the ranks (., s, m)
    world: object         # every rank: the loss and metrics


def mesh_coord(mesh: Mesh) -> tuple:
    """This rank's row-major ``(d, s, m)`` coordinate on ``mesh``. The
    mesh's size must be the process group's world size (1 without a
    group): one rank per position; ValueError otherwise."""
    shape = tuple(mesh.shape.get(a, 1) for a in AXES)
    rank, world = data_rank()
    if int(np.prod(shape)) != world:
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} has {int(np.prod(shape))} "
            f"positions but the process group's world size is {world}: "
            "one rank per position")
    return tuple(int(i) for i in np.unravel_index(rank, shape))


def mesh_groups(mesh: Mesh) -> MeshGroups:
    """This rank's coordinate and subgroups on ``mesh`` (see
    :class:`MeshGroups`), built on the first call for a mesh and kept on
    it. ``dist.new_group`` is collective: every rank creates every
    subgroup of more than one rank, in the same order (each axis's groups
    in row-major order of the other coordinates), and keeps its own. Raises
    ValueError as :func:`mesh_coord` does."""
    coord = mesh_coord(mesh)
    import torch.distributed as dist

    world = (dist.group.WORLD if dist.is_available()
             and dist.is_initialized() else None)
    cached = getattr(mesh, "_groups", None)
    if cached is not None and cached[0] is world:
        return cached[1]
    shape = tuple(mesh.shape.get(a, 1) for a in AXES)
    ranks = np.arange(int(np.prod(shape))).reshape(shape)

    def mine(blocks):
        """Create every block of ranks (a list of rank lists) as a group,
        in order; return this rank's."""
        own = None
        for block in blocks:
            block = [int(r) for r in block]
            group = dist.new_group(block) if len(block) > 1 else None
            if ranks[coord] in block:
                own = group
        return own

    d, s, m = coord
    D, S, M = shape
    groups = MeshGroups(
        coord=coord,
        model=mine([ranks[i, j, :] for i in range(D) for j in range(S)]),
        spatial=mine([ranks[i, :, k] for i in range(D) for k in range(M)]),
        data_spatial=mine([ranks[:, :, k].ravel() for k in range(M)]),
        data=mine([ranks[:, j, k] for j in range(S) for k in range(M)]),
        world=world if ranks.size > 1 else None)
    mesh._groups = (world, groups)
    return groups


def local_device(mesh: Mesh) -> torch.device:
    """The device of this process's position."""
    rank, _ = data_rank()
    return torch.device(device_ring(mesh)[rank])


def shard_pytree(mesh: Mesh, tree, specs=None):
    """Place a tree of tensors (a dict, nested or flat) on this rank's
    device of ``mesh``: replicated by default; a leaf whose spec names a
    mesh axis for one of its dimensions becomes this rank's block of that
    dimension (for :func:`tp_param_specs`, the ``Cout / model`` slice of
    the last dimension on rank ``(., ., m)``)."""
    device = local_device(mesh)
    coord = dict(zip(AXES, mesh_coord(mesh)))
    shape = mesh.shape

    def place(leaf, spec=()):
        for dim, axis in enumerate(spec):
            n = shape.get(axis, 1) if axis is not None else 1
            if n > 1:
                if leaf.shape[dim] % n:
                    raise ValueError(
                        f"dimension {dim} of {tuple(leaf.shape)} does not "
                        f"split over {axis!r} ({n})")
                k = leaf.shape[dim] // n
                leaf = leaf.narrow(dim, coord[axis] * k, k)
        return leaf.to(device).contiguous()

    def walk(node, spec_node):
        if isinstance(node, dict):
            return {k: walk(v, None if spec_node is None else spec_node[k])
                    for k, v in node.items()}
        return place(node, () if spec_node is None else spec_node)

    return walk(tree, specs)
