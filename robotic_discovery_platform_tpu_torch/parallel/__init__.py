"""Device rings for the serving router (the part of the JAX package's
``parallel/`` that ``serving/batching.DeviceRouter`` needs).

The meshes, the data-parallel trainer and ``make_serving_mesh`` are
ROADMAP queue 1 item 14."""

from robotic_discovery_platform_tpu_torch.parallel.mesh import (
    device_ring,
    least_loaded,
)

__all__ = ["device_ring", "least_loaded"]
