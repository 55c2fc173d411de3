"""Deterministic fleet simulator: a discrete-event twin of the control
plane (the port's copy of the JAX package's ``sim/``, driving the port's
objects).

`analysis/explore.py` proves the CORRECTNESS half of the control plane
on a shared fake clock (exhaustive interleavings of a small alphabet);
this package is the PERFORMANCE half. One seeded discrete-event engine
(:mod:`.engine`) drives the REAL ``ReactiveController``,
``CircuitBreaker``, ``FleetRouter``, ``LeaseRegistry``,
``RolloutManager``, ``ZooPlacer``, and ``Autoscaler`` objects unmodified
-- every one of them already takes an injectable clock -- while only the
device ride is modeled, by a per-(model, placement, chips) service-time
distribution fitted from a LOADBENCH-shaped file of legs measured on the
card (:mod:`.model`; no default path). Arrivals come from Poisson /
diurnal generators or replayed traces in ``bench_load.py --trace``'s
format (:mod:`.workload`),
scenarios script correlated failures on the virtual clock
(:mod:`.scenario`), and sweeps grid failure x load in seconds on CPU
(:mod:`.sweep`), emitting the same journal events and LOADBENCH-shaped
rows as the live harness. The sim is only trusted because
:mod:`.calibrate` holds its tails against measured legs
(``chip_smoke.py``'s ``sim_phase`` measures them on the card and runs
the gate; Clockwork's bar: a predictable system is one whose simulated
tails match its measured ones).
"""

from __future__ import annotations

from robotic_discovery_platform_tpu_torch.sim.engine import (
    Engine,
    VirtualClock,
)
from robotic_discovery_platform_tpu_torch.sim.model import ServiceTimeModel
from robotic_discovery_platform_tpu_torch.sim.scenario import Scenario

__all__ = ["Engine", "VirtualClock", "ServiceTimeModel", "Scenario"]
