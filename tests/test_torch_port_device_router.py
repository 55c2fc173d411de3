"""The port's ``serving/batching.DeviceRouter`` (round_robin placement and
chip quarantine) and ``parallel/mesh``'s ring helpers against the JAX
package's, on the CPU.

Both routers run over the same ``FakeMesh`` (the explorer's: a numpy
array of fake chips) on one fake clock each, and take the same seeded
script of dispatch outcomes (ok and failed, single- and multi-model),
probes, picks and clock advances step for step: the same quarantined
sets, reinstatements, probe candidates, ``failure_confined`` answers,
``on_health`` calls, journal events and instruments. The port's ``pick``
is held against the JAX dispatcher's choice (``BatchDispatcher.
_pick_chip``: the probe first, then the least-loaded placeable chip),
written out here over the JAX router.

The sharded mode, the mode switch and the dispatcher's ``router=``
(ROADMAP item 14, once left out here) are held against the JAX package in
tests/test_torch_port_mesh_routing.py; the last test here checks their
construction rules.

Tolerances, fixed before measuring: none; every answer is compared
exactly.
"""

import random

import numpy as np
import pytest
import torch

from robotic_discovery_platform_tpu.observability import (
    instruments as jobs,
    journal as jjournal,
)
from robotic_discovery_platform_tpu.parallel import mesh as jmesh
from robotic_discovery_platform_tpu.serving import batching as jbatching
from robotic_discovery_platform_tpu_torch.observability import (
    instruments as tobs,
    journal as tjournal,
)
from robotic_discovery_platform_tpu_torch.parallel import mesh as tmesh
from robotic_discovery_platform_tpu_torch.serving import batching as tbatching

PKGS = {"port": (tbatching, tjournal, tobs, tmesh),
        "jax": (jbatching, jjournal, jobs, jmesh)}


class FakeMesh:
    """The explorer's fake mesh (``analysis/explore.FakeMesh``): n fake
    chips in a ``.devices`` array. Defined here, since importing the
    explorer turns strict lock checking on for the whole process."""

    def __init__(self, n=2):
        self.devices = np.arange(n).reshape(n)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _router(pkg, chips=4, failures=3, reset_s=10.0):
    lib = PKGS[pkg][0]
    clock, health = FakeClock(), []
    router = lib.DeviceRouter(
        FakeMesh(chips), "round_robin", breaker_failures=failures,
        breaker_reset_s=reset_s, clock=clock,
        on_health=lambda c, ok: health.append((c, ok)))
    return router, clock, health


def _jax_pick(router, loads, start, allowed=None):
    """The JAX dispatcher's ``_pick_chip`` over its router
    (``serving/batching.py`` of the JAX package), less its lock and
    cursor."""
    if router.quarantine_enabled:
        probe = router.probe_candidate()
        if probe is not None and (allowed is None or probe in allowed):
            return probe
        healthy = set(router.healthy_chips())
        placeable = (healthy if allowed is None
                     else (healthy & set(allowed)) or healthy)
    else:
        placeable = (set(range(router.chips)) if allowed is None
                     else set(allowed))
    return jmesh.least_loaded(
        [loads[i] if i in placeable else float("inf")
         for i in range(router.chips)], start)


def _script(seed: int, chips: int, steps: int = 400) -> list:
    rng = random.Random(seed)
    out = []
    for _ in range(steps):
        r = rng.random()
        chip = rng.randrange(chips)
        if r < 0.40:
            out.append(("fail", chip, rng.choice(["", "seg", "aux"]),
                        rng.random() < 0.3))
        elif r < 0.65:
            out.append(("ok", chip))
        elif r < 0.75:
            out.append(("advance", rng.choice([1.0, 4.0, 11.0])))
        elif r < 0.85:
            out.append(("probe",))
        else:
            loads = [rng.randrange(3) for _ in range(chips)]
            allowed = (None if rng.random() < 0.6 else
                       tuple(sorted(rng.sample(range(chips),
                                               rng.randrange(1, chips)))))
            out.append(("pick", tuple(loads), rng.randrange(chips),
                        allowed))
    return out


def _run(pkg, script, chips):
    router, clock, health = _router(pkg, chips=chips)
    journal = PKGS[pkg][1].JOURNAL
    events = PKGS[pkg][1].JOURNAL.events_since(0)
    cursor = events[-1].seq + 1 if events else 0
    trace = []
    for step in script:
        kind = step[0]
        if kind == "fail":
            _, chip, model, multi = step
            router.record_result(chip, False, RuntimeError("boom"),
                                 model=model, multi_model=multi)
            got = router.failure_confined(chip, model)
        elif kind == "ok":
            router.record_result(step[1], True)
            got = router.failure_confined(step[1], "")
        elif kind == "advance":
            clock.t += step[1]
            got = None
        elif kind == "probe":
            got = router.probe_candidate()
        else:
            _, loads, start, allowed = step
            got = (router.pick(list(loads), start, allowed)
                   if pkg == "port" else
                   _jax_pick(router, list(loads), start, allowed))
        trace.append((kind, got, tuple(sorted(router.quarantined)),
                      router.healthy_chips(), router.quarantines_total,
                      tuple(b.state for b in router.breakers)))
    new = [(e.kind, dict(e.attrs)) for e in journal.events_since(cursor)
           if e.kind.startswith("chip.")]
    return trace, health, new


@pytest.mark.parametrize("seed,chips", [(0, 2), (1, 4), (2, 4), (3, 3)])
def test_router_takes_the_jax_routers_steps(seed, chips):
    script = _script(seed, chips)
    port = _run("port", script, chips)
    jax_side = _run("jax", script, chips)
    assert port[0] == jax_side[0]
    assert port[1] == jax_side[1]  # on_health calls
    assert port[2] == jax_side[2]  # chip.quarantine / chip.reinstate
    assert port[1], "the script should quarantine some chip"


def test_instruments_move_as_the_jax_routers():
    def counts(pkg):
        obs = PKGS[pkg][2]
        return (obs.QUARANTINED_CHIPS.value,
                obs.CHIP_QUARANTINES.labels(chip="1").value)

    before = {pkg: counts(pkg) for pkg in PKGS}
    for pkg in PKGS:
        router, clock, _ = _router(pkg, chips=3, failures=2)
        for _ in range(2):
            router.record_result(1, False, RuntimeError("boom"))
        assert router.quarantined == frozenset({1})
        assert PKGS[pkg][2].QUARANTINED_CHIPS.value == 1
        clock.t += 11.0
        assert router.probe_candidate() == 1
        router.record_result(1, True)
        assert router.quarantined == frozenset()
    after = {pkg: counts(pkg) for pkg in PKGS}
    assert after["port"][0] == after["jax"][0] == 0
    assert after["port"][1] - before["port"][1] \
        == after["jax"][1] - before["jax"][1] == 1


def test_router_quarantines_after_threshold_and_flips_health():
    r, _, health = _router("port")
    boom = RuntimeError("boom")
    r.record_result(1, ok=False, exc=boom)
    r.record_result(1, ok=False, exc=boom)
    assert r.quarantined == frozenset()
    r.record_result(1, ok=False, exc=boom)
    assert r.quarantined == frozenset({1})
    assert r.healthy_chips() == (0, 2, 3)
    assert health == [(1, False)]
    assert r.quarantines_total == 1


def test_router_never_quarantines_the_last_healthy_chip():
    r, _, _ = _router("port", chips=2)
    boom = RuntimeError("boom")
    for _ in range(3):
        r.record_result(0, ok=False, exc=boom)
    assert r.quarantined == frozenset({0})
    for _ in range(10):
        r.record_result(1, ok=False, exc=boom)
    assert r.quarantined == frozenset({0})
    assert r.healthy_chips() == (1,)
    # with every chip quarantined but one, a pick still lands on it
    assert r.pick([0, 5], 0) in (0, 1)


def test_router_probe_after_reset_reinstates_or_requarantines():
    r, clock, health = _router("port", reset_s=10.0)
    boom = RuntimeError("boom")
    for _ in range(3):
        r.record_result(2, ok=False, exc=boom)
    assert r.probe_candidate() is None
    clock.t += 10.5
    assert r.probe_candidate() == 2
    assert r.probe_candidate() is None  # the probe slot is taken
    r.record_result(2, ok=False, exc=boom)
    clock.t += 5.0
    assert r.probe_candidate() is None
    clock.t += 5.6
    assert r.pick([0, 0, 0, 0], 0) == 2  # the probe takes the dispatch
    r.record_result(2, ok=True)
    assert r.quarantined == frozenset()
    assert health[-1] == (2, True)


def test_a_single_model_failing_never_quarantines_the_chip():
    r, _, _ = _router("port", failures=2)
    for _ in range(5):
        r.record_result(0, False, RuntimeError("model bug"), model="aux",
                        multi_model=True)
    assert r.quarantined == frozenset()
    assert r.failure_confined(0, "aux")
    r.record_result(0, False, RuntimeError("x"), model="seg",
                    multi_model=True)
    r.record_result(0, False, RuntimeError("x"), model="seg",
                    multi_model=True)
    assert r.quarantined == frozenset({0})


def test_quarantine_disabled_for_one_chip_and_no_breaker():
    for mesh in (FakeMesh(1), [torch.device("cpu")]):
        r = tbatching.DeviceRouter(mesh, "round_robin", breaker_failures=3)
        assert not r.quarantine_enabled and r.chips == 1
    r = tbatching.DeviceRouter(FakeMesh(4), "round_robin")
    assert not r.quarantine_enabled
    r.record_result(0, ok=False)  # no-op, never raises
    assert r.probe_candidate() is None
    assert r.pick([2, 1, 1, 0], 1) == 3


def test_device_ring_of_devices_and_meshes():
    devices = [torch.device("cpu"), torch.device("meta")]
    assert tmesh.device_ring(devices) == tuple(devices)
    assert tmesh.device_ring(FakeMesh(3)) == jmesh.device_ring(FakeMesh(3))
    grid = FakeMesh(4)
    grid.devices = np.arange(4).reshape(2, 2)
    assert tmesh.device_ring(grid) == jmesh.device_ring(grid) == (0, 1, 2, 3)


@pytest.mark.parametrize("loads", [
    [0, 0, 0, 0], [2, 1, 0, 1], [1, 0, 1, 1], [1, 1], [3, 1, 1, 3],
    [float("inf"), 1, float("inf"), 1], [5], [0, 2, 0, 2, 0]])
def test_least_loaded_ties_match_jax(loads):
    for start in range(-1, len(loads) + 2):
        assert tmesh.least_loaded(loads, start) \
            == jmesh.least_loaded(loads, start)
    # idle chips: consecutive picks walk the ring
    idle = [0] * len(loads)
    assert [tmesh.least_loaded(idle, s) for s in range(len(loads))] \
        == list(range(len(loads)))


def test_left_for_item_14_raises_naming_it():
    """Item 14's router parts are ported: the sharded mode and its
    analyzers, the mode switch, the dispatcher's ``router=``; what the JAX
    router refuses, the port's refuses with the same words."""
    r = tbatching.DeviceRouter(FakeMesh(2), "sharded")
    assert r.mode == "sharded" and r.sharding is not None
    assert not r.quarantine_enabled
    d = tbatching.BatchDispatcher(
        lambda *a: None, device="cpu", watchdog_interval_s=0.0,
        router=tbatching.DeviceRouter(FakeMesh(2)))
    d.stop()
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        tbatching.DeviceRouter(FakeMesh(2), "diagonal")
    r = tbatching.DeviceRouter(FakeMesh(2))
    r.set_mode("round_robin")  # same mode: no-op
    for lib in (tbatching, jbatching):
        fixed = lib.DeviceRouter(FakeMesh(2))
        with pytest.raises(ValueError, match="mode-switchable"):
            fixed.set_mode("sharded")
        assert fixed.mode == "round_robin" and not fixed.can_switch_modes
    both = tbatching.DeviceRouter(FakeMesh(2), analyzers=[len, len],
                                  sharded_analyzer=max)
    assert both.can_switch_modes
    both.set_mode("sharded")
    assert both.mode == "sharded"
    with pytest.raises(ValueError, match="expected 2 analyzer"):
        tbatching.DeviceRouter(FakeMesh(2), analyzers=[len])
