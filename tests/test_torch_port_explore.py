"""The port's schedule explorer (``analysis/explore.py``) and its copy of
statecheck's extraction (``analysis/statecheck.py``) against the JAX
package's, on the CPU.

The port's explorer drives the port's breaker, controller, rollout
manager, fleet router and lease registry and ``DeviceRouter`` through
every schedule of the ten-event alphabet up to the depth bound; its
report must equal the JAX explorer's (over the JAX objects) field for
field: schedules, states, leaves, the hash of the visited states, no
violation, and complete coverage of the edges extracted from the port's
``serving/rollout.py``, ``resilience/breaker.py`` and ``serving/fleet.py``
(8, 5 and 3, as from the JAX files). No named divergence changes the
report at depth 4, seed 0: the shadow stage's drain order (ROADMAP queue
3) acts only while live frames keep arriving, which no explored target
does.

Tolerances, fixed before measuring: none; reports are compared exactly.
"""

import dataclasses
import json
import logging

import pytest

from robotic_discovery_platform_tpu.analysis import explore as jexplore
from robotic_discovery_platform_tpu.analysis import statecheck as jstatecheck
from robotic_discovery_platform_tpu_torch.analysis import explore
from robotic_discovery_platform_tpu_torch.analysis import statecheck
from robotic_discovery_platform_tpu_torch.resilience import (
    breaker as breaker_lib,
)

#: the JAX explorer's report at depth 4, seed 0 (its own run on the CPU)
JAX_DEPTH4 = {
    "schedules": 341, "states": 127, "leaves": 93,
    "visited_hash": "8288069a6b1aa4de4032dcbee81cb13197e508a247dbc61d889fd"
                    "d134ab8081b",
}


@pytest.fixture(autouse=True)
def _quiet_fleet_logs():
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(scope="module")
def reports():
    logging.disable(logging.WARNING)
    try:
        return (explore.run(depth=4, seed=0), jexplore.run(depth=4, seed=0))
    finally:
        logging.disable(logging.NOTSET)


def test_depth4_report_equals_the_jax_explorer(reports):
    port, jax_report = reports
    assert port == jax_report
    assert {k: port[k] for k in JAX_DEPTH4} == JAX_DEPTH4
    assert port["violations"] == []
    assert {name: (cov["edges"], cov["complete"])
            for name, cov in port["coverage"].items()} == {
        "rollout._state": (8, True), "breaker._state": (5, True),
        "fleet._state": (3, True)}


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_explorer_deterministic_per_seed_and_equal_to_jax(seed):
    a = explore.run(depth=2, seed=seed, check_recurrence=False)
    b = explore.run(depth=2, seed=seed, check_recurrence=False)
    assert a == b
    assert a["violations"] == []
    assert a == jexplore.run(depth=2, seed=seed, check_recurrence=False)


def test_explorer_catches_broken_breaker():
    w = explore.World()
    w.breaker = breaker_lib.CircuitBreaker(
        failure_threshold=99, reset_timeout_s=2.0,
        name="never-trips", clock=w.clock)
    w.apply("frame-fail")
    w.check_invariants(("frame-fail",))
    w.apply("frame-fail")
    with pytest.raises(explore.InvariantViolation, match="breaker-honest"):
        w.check_invariants(("frame-fail", "frame-fail"))


def test_explorer_catches_ledger_hole():
    w = explore.World()
    w.apply("frame-ok")
    w.sent += 1  # a frame sent but never answered
    with pytest.raises(explore.InvariantViolation, match="ledger"):
        w.check_invariants(("frame-ok",))


def test_explorer_catches_an_empty_chip_ring():
    """The last-chip invariant reads the port's DeviceRouter."""
    w = explore.World()
    w.router._quarantined.update({0, 1})
    with pytest.raises(explore.InvariantViolation, match="last-chip"):
        w.check_invariants(("frame-fail",))


def test_frame_events_drive_the_chip_router_as_the_jax_world():
    """frame-fail / tick / frame-ok through both worlds: the same
    quarantines, probes and reinstatements, and the same state keys."""
    events = ["frame-fail"] * 4 + ["tick", "frame-ok", "frame-fail",
                                   "frame-fail", "tick", "frame-ok"]
    port, jax_world = explore.World(), jexplore.World()
    for i, ev in enumerate(events):
        port.apply(ev)
        jax_world.apply(ev)
        port.check_invariants(tuple(events[:i + 1]))
        assert port.router.quarantined == jax_world.router.quarantined, ev
        assert port.router.quarantines_total \
            == jax_world.router.quarantines_total
        assert port.state_key() == jax_world.state_key(), (i, ev)
    assert port.router.quarantines_total >= 1


def test_recurrence_rearms_the_world():
    w = explore.World()
    trace = ("frame-fail", "frame-fail", "replica-die", "lease-expire")
    for ev in trace:
        w.apply(ev)
    w.check_recurrence(trace)
    assert not w.router.quarantined and w.controller.level == 0


@pytest.mark.parametrize("src", ["ROLLOUT_SRC", "BREAKER_SRC", "FLEET_SRC"])
def test_extraction_equals_statecheck_over_the_port_sources(src):
    path = getattr(explore, src)
    assert path.is_file() and "robotic_discovery_platform_tpu_torch" in str(
        path)
    port = [dataclasses.asdict(m) for m in statecheck.extract_machines(path)]
    jax_side = [dataclasses.asdict(m)
                for m in jstatecheck.extract_machines(path)]
    assert port == jax_side and port


def test_extraction_over_the_other_machines_of_the_port():
    for rel in ("serving/batching.py", "serving/controller.py"):
        path = explore._PORT / rel
        assert [dataclasses.asdict(m)
                for m in statecheck.extract_machines(path)] \
            == [dataclasses.asdict(m)
                for m in jstatecheck.extract_machines(path)]
    source = "class A:\n    def f(self):\n        self._state = 'x'\n"
    assert statecheck.extract_machines_from_source(source) \
        == jstatecheck.extract_machines_from_source(source)


def test_cli_prints_the_report(capsys):
    assert explore.main(["--depth", "1", "--no-recurrence"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == explore.run(depth=1, seed=0, check_recurrence=False)
    assert explore.main(["--depth", "1", "--no-recurrence",
                         "--require-full-coverage"]) == 1
