"""Meshes, the serving ring and the data-parallel train steps, the JAX
package's ``parallel/`` for PyTorch (``torch.distributed`` process groups
in place of ``jax.distributed``; see :mod:`.mesh` and :mod:`.dp`)."""

from robotic_discovery_platform_tpu_torch.parallel.dp import (
    parallelize_training,
    put_global_batch,
    shard_map_train_step,
)
from robotic_discovery_platform_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    batch_sharding,
    device_ring,
    initialize_distributed,
    least_loaded,
    make_mesh,
    make_serving_mesh,
    replicated,
    shard_pytree,
    tp_param_specs,
)

__all__ = [
    "AXES",
    "Mesh",
    "batch_sharding",
    "device_ring",
    "initialize_distributed",
    "least_loaded",
    "make_mesh",
    "make_serving_mesh",
    "parallelize_training",
    "put_global_batch",
    "replicated",
    "shard_map_train_step",
    "shard_pytree",
    "tp_param_specs",
]
