"""The serving router's device ring, the port's copy of the two functions
of the JAX package's ``parallel/mesh.py`` that
``serving/batching.DeviceRouter`` reads.

A ring is a tuple of devices in the order the router walks them: a list
of ``torch.device``s, or anything with a ``.devices`` array (the JAX
package's ``Mesh``, or the explorer's ``FakeMesh``), flattened in row-major
order as the JAX package flattens a mesh's devices data-major.

Not ported (ROADMAP queue 1 item 14): ``make_mesh``,
``make_serving_mesh``, ``batch_sharding``, ``chip_shardings`` and the
sharding helpers of the mesh trainer.
"""

from __future__ import annotations

import numpy as np


def device_ring(mesh) -> tuple:
    """The devices the serving router round-robins dispatches over: a
    sequence of devices as given, or ``mesh.devices`` flattened."""
    devices = getattr(mesh, "devices", mesh)
    if isinstance(devices, np.ndarray):
        return tuple(devices.reshape(-1))
    return tuple(devices)


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
