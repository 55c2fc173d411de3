"""Bounded exhaustive schedule explorer for the serving control plane (the
port's copy of the JAX package's ``analysis/explore.py``, over the port's
objects).

statecheck.py proves properties of the transition GRAPHS; this module
drives the real OBJECTS -- ``CircuitBreaker``, ``ReactiveController``,
``RolloutManager``, ``FleetRouter``, ``DeviceRouter`` -- through every
interleaving of a small event alphabet up to a depth bound, on injected
fake clocks and fake transport (no sockets, no threads, no models, no
sleeps). Each schedule replays from a fresh world; a memo on the world
state hash prunes interleavings that converge. Everything runs under
``RDP_LOCKCHECK=strict`` so the lock-order sanitizer rides along.

The event alphabet:

==============  =============================================================
tick            advance every fake clock 3 s; controller tick, fleet poll,
                breaker/chip half-open probes
frame-ok        a frame succeeds end to end: breaker success, burn drops,
                chips report healthy dispatches
frame-fail      a frame fails: breaker failure, burn spikes, a chip takes
                a dispatch error
replica-die     fleet replica r2's health endpoint starts refusing
replica-rejoin  r2's health endpoint serves again
drift-rec       a drift recommendation lands: one full rollout cycle runs
                (candidate quality rotates good / gate-fail / promote-fail)
stage-timeout   an admitted breaker probe is abandoned mid-flight (its
                caller died) and a rollout cycle times out in DRAINING
lease-register  elastic member replica-c registers (or re-registers) its
                lease with the front-end's registry and joins the probe set
lease-expire    replica-c's lease deadline is rewound to NOW; the sweep
                takes the expiry edge and the member quarantines
lease-leave     replica-c sends Leave: graceful drain, not expiry
==============  =============================================================

Safety invariants, checked after EVERY event of every schedule:

- ledger: frames sent == frames answered (ok + error); an admitted probe
  abandoned by ``stage-timeout`` is answered-with-error at abandonment
- last-replica: a rollout cycle never drains the last serving target
- gates: a cycle that reports ``promoted`` has every gate passing
- breaker-honest: at/over the failure threshold with no success since,
  the breaker is not CLOSED
- last-chip: the device router never quarantines its last healthy chip
- lease-honest: a member whose lease is expired or left is never
  placeable (quarantined / draining, NOT silently kept in the ring),
  and an expired/left member is never dropped from the replica list
  (quarantine is recoverable; prune is far beyond the depth bound)

Recurrence, checked at every schedule leaf: after the excursion ends
(failures stop, replicas return, leased members re-register, clocks
advance), the rollout machine is IDLE, the standalone breaker
re-closes, the brownout ladder returns to level 0, and every fleet
replica -- static seed or leased member -- is placeable again.

Transition coverage ties the two halves together: the edges this
explorer WITNESSES are compared against the edges statecheck EXTRACTS
from rollout.py, breaker.py, and fleet.py (the lease machine) -- a dead
edge in the source or a schedule hole in the explorer both surface as
missing coverage.

Run: ``python -m robotic_discovery_platform_tpu_torch.analysis.explore
--depth 4 --require-full-coverage``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

# strict lock sanitizing for every world object built below; checked_lock
# resolves the mode per construction, so setting it here covers worlds
# even when the serving modules were imported earlier
os.environ.setdefault("RDP_LOCKCHECK", "strict")

import numpy as np

from robotic_discovery_platform_tpu_torch.analysis import statecheck
from robotic_discovery_platform_tpu_torch.resilience import (
    breaker as breaker_lib,
)
from robotic_discovery_platform_tpu_torch.serving import (
    batching as batching_lib,
)
from robotic_discovery_platform_tpu_torch.serving import controller as ctrl_lib
from robotic_discovery_platform_tpu_torch.serving import fleet as fleet_lib
from robotic_discovery_platform_tpu_torch.serving import health as health_lib
from robotic_discovery_platform_tpu_torch.serving import rollout as rollout_lib
from robotic_discovery_platform_tpu_torch.utils.config import (
    RolloutConfig,
    ServerConfig,
)

EVENTS = (
    "tick",
    "frame-ok",
    "frame-fail",
    "replica-die",
    "replica-rejoin",
    "drift-rec",
    "stage-timeout",
    "lease-register",
    "lease-expire",
    "lease-leave",
)

TICK_S = 3.0
# one tick crosses the reset window, so open -> half_open -> open round
# trips fit inside the CI depth bound
BREAKER_RESET_S = 2.0
FAILURE_THRESHOLD = 2

_PORT = Path(__file__).resolve().parents[1]
ROLLOUT_SRC = _PORT / "serving/rollout.py"
BREAKER_SRC = _PORT / "resilience/breaker.py"
FLEET_SRC = _PORT / "serving/fleet.py"


class InvariantViolation(AssertionError):
    """A safety invariant or leaf recurrence failed on some schedule."""


# -- fakes -------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


class _FakeHealthResp:
    def __init__(self, status):
        self.status = status


class FakeHealthStub:
    """Pre-seeded into ``Replica._health_stub``: answers from the world's
    liveness map instead of a socket."""

    def __init__(self, world, endpoint):
        self.world = world
        self.endpoint = endpoint

    def Check(self, request, timeout=None):  # noqa: N802 - gRPC surface
        if not self.world.replica_up[self.endpoint]:
            raise RuntimeError(f"connection refused: {self.endpoint}")
        return _FakeHealthResp(health_lib.SERVING)


class FakeStatsStub:
    def __init__(self, world, endpoint):
        self.world = world
        self.endpoint = endpoint

    def Get(self, request, timeout=None):  # noqa: N802 - gRPC surface
        return json.dumps({
            "inflight": 0,
            "burn": self.world.burn,
            "draining": False,
            "metrics_port": 0,
        }).encode()


class FakeDispatcher:
    """The controller-facing dispatcher surface (tuning knobs only)."""

    def __init__(self):
        self.window_ms = 8.0
        self.max_inflight = 2
        self.bucket_floor = 1
        self.deadline_safety = 1.0
        self.recent_batch = 1
        self.router = None  # no mode switching in the explored world
        self._max_batch = 8

    def set_window_ms(self, v):
        self.window_ms = float(v)

    def set_max_inflight(self, v):
        self.max_inflight = int(v)

    def set_bucket_floor(self, v):
        self.bucket_floor = int(v)

    def set_deadline_safety(self, v):
        self.deadline_safety = float(v)

    def backlog(self) -> int:
        return 0


class FakeMesh:
    """Just enough mesh for ``device_ring``: two fake chips."""

    def __init__(self, n=2):
        self.devices = np.arange(n).reshape(n)


class FakeTarget:
    """The rollout target surface over no servicer (test_rollout idiom)."""

    def __init__(self, name, streams=0, version=1):
        self.name = name
        self.streams = streams
        self.current_version = version
        self.draining = False
        self.shadow_hook = None
        self.feed_on_shadow = 0

    @property
    def active_streams(self):
        return self.streams

    def set_draining(self, draining):
        # a test fake, not the control plane: no instrumentation owed
        self.draining = bool(draining)  # statecheck: disable=SC002

    def set_shadow(self, hook):
        self.shadow_hook = hook
        if hook is not None:
            for _ in range(self.feed_on_shadow):
                hook(_shadow_sample())

    def promote(self):
        self.current_version = 7
        return True

    def reference_analyzer(self):
        return lambda rgb, depth, k, scale: _analysis(
            np.ones((8, 8), np.uint8))


class _Profile:
    def __init__(self, valid, mean_k):
        self.valid = np.bool_(valid)
        self.mean_curvature = np.float32(mean_k)
        self.max_curvature = np.float32(2 * mean_k)


class _Analysis:
    def __init__(self, mask):
        cov = 100.0 * float(np.count_nonzero(mask)) / mask.size
        self.mask = mask
        self.mask_coverage = np.float32(cov)
        self.profile = _Profile(True, 1.0)
        self.confidence_margin = np.float32(0.3)


def _analysis(mask):
    return _Analysis(mask)


def _shadow_sample():
    mask = np.ones((8, 8), np.uint8)
    return rollout_lib.ShadowSample(
        rgb=np.zeros((8, 8, 3), np.uint8),
        depth=np.full((8, 8), 500, np.uint16),
        k=np.eye(3, dtype=np.float32), depth_scale=0.001, mask=mask,
        coverage=100.0, mean_curvature=1.0, max_curvature=2.0, valid=True,
        confidence_margin=0.3, depth_valid_fraction=1.0,
    )


class _FakeTrainResult:
    def __init__(self, succeeded=True, version=7):
        self.succeeded = succeeded
        self.version = version
        self.message = ""


class ExploreManager(rollout_lib.RolloutManager):
    """RolloutManager with the model edges stubbed and every
    ``_transition`` recorded for coverage. The port's candidate is one
    callable ``analyze(rgb, depth, k, scale)`` (the JAX package's takes
    its variables first and comes with them)."""

    def __init__(self, *args, world, **kwargs):
        super().__init__(*args, **kwargs)
        self._world = world
        self.candidate_good = True
        self.promote_error = None

    def _transition(self, to, cycle=None, **labels):
        self._world.rollout_edges.add((self._state, to))
        return super()._transition(to, cycle=cycle, **labels)

    def _load_candidate(self, version):
        mask = (np.ones((8, 8), np.uint8) if self.candidate_good
                else np.zeros((8, 8), np.uint8))

        def analyze(rgb, depth, k, scale):
            return _analysis(mask)

        return analyze

    def _fixture_report(self, reference, cand_analyze):
        if self.candidate_good:
            return {"mask_iou_mean": 1.0, "curvature_err_max": 0.0}
        return {"mask_iou_mean": 0.0, "curvature_err_max": 0.0}

    def _promote(self, cycle, version):
        if self.promote_error is not None:
            raise self.promote_error
        for t in self.targets:
            t.promote()


# -- the world ---------------------------------------------------------------


class World:
    """One fresh copy of the control plane, every clock injectable."""

    ENDPOINTS = ("replica-a:1", "replica-b:1")
    #: the elastic member: joins by lease, never in the static seed list
    LEASED = "replica-c:1"

    def __init__(self):
        self.clock = FakeClock()
        self.breaker_edges: set[tuple[str, str]] = set()
        self.rollout_edges: set[tuple[str, str]] = set()
        self.lease_edges: set[tuple[str, str]] = set()

        # standalone breaker: the explored per-dependency instance
        self.breaker = breaker_lib.CircuitBreaker(
            failure_threshold=FAILURE_THRESHOLD,
            reset_timeout_s=BREAKER_RESET_S,
            name="explore", clock=self.clock,
        )
        self.consec_fails = 0
        self.sent = 0
        self.answered = 0

        # reactive controller over a fake dispatcher
        self.burn = 0.1
        self.dispatcher = FakeDispatcher()
        self.controller = ctrl_lib.ReactiveController(
            lambda: self.dispatcher, lambda: self.burn,
            refuse_streams=lambda refuse: None,
            interval_s=TICK_S, burn_high=1.0, burn_low=0.5,
            sustain_s=TICK_S, cooldown_s=TICK_S, clock=self.clock,
        )

        # rollout manager over fake targets
        self.t_live = FakeTarget("live", streams=2)
        self.t_spare = FakeTarget("spare", streams=0)
        self.t_live.feed_on_shadow = 4
        self.rollout = ExploreManager(
            [self.t_live, self.t_spare],
            RolloutConfig(
                shadow_fraction=1.0, shadow_min_frames=2, shadow_queue=16,
                drain_timeout_s=2.0, retrain_timeout_s=2.0,
                shadow_timeout_s=2.0, promote_timeout_s=2.0,
                gate_shadow_min_iou=0.5, gate_shadow_max_psi=1.0,
            ),
            ServerConfig(),
            train_fn=lambda target: _FakeTrainResult(),
            clock=self.clock, sleep=self.clock.sleep,
            device="cpu",  # stubbed model edges: nothing runs on a device
            world=self,
        )
        self.cycles: list[dict] = []
        self.fail_count = 0

        # fleet membership over fake transport, with an elastic lease
        # registry riding along: TTL far above the schedule horizon so
        # the ONLY expiries are the deterministic lease-expire event's
        # (force_expire + the sweep's honest clocked edge)
        self.replica_up = {ep: True for ep in self.ENDPOINTS}
        self.replica_up[self.LEASED] = True
        self.leases = fleet_lib.LeaseRegistry(ttl_s=1000.0,
                                              clock=self.clock)
        self.fleet = fleet_lib.FleetRouter(
            list(self.ENDPOINTS), breaker_failures=FAILURE_THRESHOLD,
            breaker_reset_s=BREAKER_RESET_S, clock=self.clock,
            channel_factory=lambda ep: None,
            registry=self.leases,
        )
        self._seed_stubs()

        # chip quarantine over a fake 2-chip mesh
        self.router = batching_lib.DeviceRouter(
            FakeMesh(2), mode="round_robin",
            breaker_failures=FAILURE_THRESHOLD,
            breaker_reset_s=BREAKER_RESET_S, clock=self.clock,
        )

    def _seed_stubs(self) -> None:
        """Fake transport onto every replica that lacks it (the statics
        at construction; the leased member each time sync_leases admits
        it)."""
        for r in self.fleet.replicas:
            if r._health_stub is None:
                r._health_stub = FakeHealthStub(self, r.endpoint)
                r._stats_stub = FakeStatsStub(self, r.endpoint)

    # -- event semantics -----------------------------------------------------

    def apply(self, event: str) -> None:
        handler = {
            "tick": self._ev_tick,
            "frame-ok": self._ev_frame_ok,
            "frame-fail": self._ev_frame_fail,
            "replica-die": self._ev_replica_die,
            "replica-rejoin": self._ev_replica_rejoin,
            "drift-rec": self._ev_drift_rec,
            "stage-timeout": self._ev_stage_timeout,
            "lease-register": self._ev_lease_register,
            "lease-expire": self._ev_lease_expire,
            "lease-leave": self._ev_lease_leave,
        }[event]
        handler()

    def _ev_tick(self) -> None:
        self.clock.t += TICK_S
        self.controller.tick()
        self.fleet.poll_once()
        # reading state runs the open -> half_open (and probe-timeout)
        # clock edges; chip probes happen on dispatch (frame events),
        # never here -- a tick that admitted-and-abandoned a chip probe
        # would wedge quarantine recovery forever
        _ = self.breaker.state

    def _ev_frame_ok(self) -> None:
        self.burn = 0.1
        self.sent += 1
        if self.breaker.allow():
            self.breaker.record_success()
            # ledger bookkeeping, not a machine
            self.consec_fails = 0  # statecheck: disable=SC002
        self.answered += 1
        # the dispatcher's probe discipline: a healthy frame first offers
        # a quarantined chip its half-open probe, then the live chips
        cand = self.router.probe_candidate()
        if cand is not None:
            self.router.record_result(cand, True)
        for chip in range(len(self.router.ring)):
            if chip not in self.router._quarantined:
                self.router.record_result(chip, True)

    def _ev_frame_fail(self) -> None:
        self.burn = 2.0
        self.sent += 1
        if self.breaker.allow():
            self.breaker.record_failure(RuntimeError("frame failed"))
            self.consec_fails += 1  # statecheck: disable=SC002
        self.answered += 1
        chip = self.fail_count % len(self.router.ring)
        self.fail_count += 1
        if (chip not in self.router._quarantined
                or self.router.breakers[chip].allow()):
            self.router.record_result(chip, False,
                                      RuntimeError("dispatch failed"))

    def _ev_replica_die(self) -> None:
        self.replica_up[self.ENDPOINTS[1]] = False
        self.fleet.poll_once()

    def _ev_replica_rejoin(self) -> None:
        self.replica_up[self.ENDPOINTS[1]] = True
        self.fleet.poll_once()

    def _ev_drift_rec(self) -> None:
        # candidate quality rotates with the failure history so the
        # schedule space reaches promoted, gate-failed, and
        # promote-failed cycles
        variant = self.fail_count % 3
        self.rollout.candidate_good = variant != 1
        self.rollout.promote_error = (
            RuntimeError("registry unreachable") if variant == 2 else None)
        self.cycles.append(self.rollout.run_cycle(_FakeRec()))

    def _ev_lease_register(self) -> None:
        # idempotent for an active lease (refresh); the re-register
        # after lease-expire / lease-leave takes the * -> active edge
        self.replica_up[self.LEASED] = True
        self.leases.register(self.LEASED)
        self.fleet.sync_leases()
        self._seed_stubs()
        self.fleet.poll_once()

    def _ev_lease_expire(self) -> None:
        # rewind the deadline; the sweep inside poll_once takes the
        # honest clocked active -> expired edge and the member drops out
        # through the forced-probe-failure path (quarantine, not removal)
        self.leases.force_expire(self.LEASED)
        self.fleet.poll_once()

    def _ev_lease_leave(self) -> None:
        self.leases.leave(self.LEASED)
        self.fleet.poll_once()

    def _ev_stage_timeout(self) -> None:
        # an admitted breaker probe is abandoned: its caller died before
        # reporting an outcome. The stream it carried is answered-with-
        # error by the front-end, so the ledger stays whole -- but the
        # breaker slot leaks until its probe timeout trips it back open.
        self.sent += 1
        self.breaker.allow()
        self.answered += 1
        # and the rollout's drain stage times out: both targets hold
        # their streams, so the drain deadline expires (fake clock only)
        live_streams, spare_streams = (self.t_live.streams,
                                       self.t_spare.streams)
        self.t_live.streams = self.t_spare.streams = 1
        try:
            self.cycles.append(self.rollout.run_cycle(_FakeRec()))
        finally:
            self.t_live.streams = live_streams
            self.t_spare.streams = spare_streams

    # -- invariants ----------------------------------------------------------

    def check_invariants(self, trace: tuple) -> None:
        def fail(name, detail):
            raise InvariantViolation(
                f"{name} after schedule {list(trace)}: {detail}")

        if self.sent != self.answered:
            fail("ledger", f"sent={self.sent} answered={self.answered}")
        draining = [t.name for t in self.rollout.targets if t.draining]
        if len(draining) >= len(self.rollout.targets):
            fail("last-replica", f"every target draining: {draining}")
        for cycle in self.cycles:
            if cycle["outcome"] == "promoted":
                bad = [g for g, v in cycle["gates"].items()
                       if not v["pass"]]
                if bad:
                    fail("gates", f"promoted with failing gates {bad}")
        if (self.consec_fails >= FAILURE_THRESHOLD
                and self.breaker.state == breaker_lib.CLOSED):
            fail("breaker-honest",
                 f"{self.consec_fails} consecutive failures yet CLOSED")
        if len(self.router._quarantined) >= len(self.router.ring):
            fail("last-chip",
                 f"all chips quarantined: {self.router._quarantined}")
        members = {r.endpoint: r for r in self.fleet.replicas}
        for ep, lease in self.leases.snapshot().items():
            if ep not in members:
                fail("lease-honest",
                     f"leased member {ep} ({lease['state']}) dropped "
                     "from the replica list (quarantine is recoverable, "
                     "removal is not)")
            if (lease["state"] != fleet_lib.LEASE_ACTIVE
                    and members[ep].placeable):
                fail("lease-honest",
                     f"{ep} placeable with lease {lease['state']!r}")

    def check_recurrence(self, trace: tuple) -> None:
        """From any leaf, ending the excursion re-arms everything."""
        self.replica_up.update((ep, True) for ep in self.ENDPOINTS)
        self.replica_up[self.LEASED] = True
        # a healthy elastic member re-registers whenever its renew is
        # refused (LeaseClient's fallback), so re-arm does the same for
        # every lease the schedule touched
        for ep in self.leases.endpoints():
            self.leases.register(ep)
        self.fleet.sync_leases()
        self._seed_stubs()
        self.burn = 0.1
        for _ in range(4):  # > reset timeout + sustain + cooldown
            self._ev_tick()
            self._ev_frame_ok()
        for _ in range(2):  # walk the ladder the rest of the way down
            self._ev_tick()
        self.check_invariants(trace)
        problems = []
        if self.rollout.state != rollout_lib.IDLE:
            problems.append(f"rollout state {self.rollout.state!r}")
        if self.breaker.state != breaker_lib.CLOSED:
            problems.append(f"breaker {self.breaker.state!r}")
        if self.controller.level != 0:
            problems.append(f"brownout level {self.controller.level}")
        not_placeable = [r.endpoint for r in self.fleet.replicas
                         if not r.placeable]
        if not_placeable:
            problems.append(f"unplaceable replicas {not_placeable}")
        if self.router._quarantined:
            problems.append(f"quarantined chips {self.router._quarantined}")
        if problems:
            raise InvariantViolation(
                f"recurrence after schedule {list(trace)}: excursion did "
                f"not re-arm: {'; '.join(problems)}")

    # -- hashing -------------------------------------------------------------

    def state_key(self) -> str:
        key = (
            self.breaker.state,
            self.breaker.failure_count,
            self.breaker._probe_in_flight,
            int(self.clock.t) // 5,
            self.controller.level,
            self.burn,
            self.rollout.state,
            len(self.cycles),
            self.cycles[-1]["outcome"] if self.cycles else None,
            tuple(sorted(self.replica_up.items())),
            tuple(r.placeable for r in self.fleet.replicas),
            tuple(sorted(
                (ep, lease["state"])
                for ep, lease in self.leases.snapshot().items())),
            tuple(sorted(self.router._quarantined)),
            self.consec_fails,
        )
        return hashlib.sha256(repr(key).encode()).hexdigest()[:16]


class _FakeRec:
    signals = ["mask_coverage"]
    reason = "explorer excursion"


# -- exploration -------------------------------------------------------------


def _alphabet_for(seed: int) -> tuple:
    """A deterministic seed-rotated event order (the visited SET depends
    only on pruning, the visit ORDER on the seed)."""
    rot = seed % len(EVENTS)
    return EVENTS[rot:] + EVENTS[:rot]


def _replay(schedule: tuple, holder: dict) -> World:
    # the holder is live BEFORE construction: breakers notify their
    # initial state (old=None) at __init__ and trip during the schedule
    world = holder["world"] = World()
    for i, ev in enumerate(schedule):
        world.apply(ev)
        world.check_invariants(schedule[:i + 1])
    return world


def run(depth: int = 4, seed: int = 0, *,
        check_recurrence: bool = True) -> dict:
    """Explore every schedule up to ``depth``; returns the report dict
    (visited/violations/coverage). Violations do not abort the sweep --
    each schedule contributes at most one."""
    alphabet = _alphabet_for(seed)
    visited: set[str] = set()
    violations: list[str] = []
    leaves = 0
    schedules = 0

    observer_restore = breaker_lib._observer
    lease_observer_restore = fleet_lib._lease_observer
    holder: dict = {"world": None}

    def observe(name, old, new):
        w = holder["world"]
        if w is not None and old is not None:
            w.breaker_edges.add((old, new))

    def observe_lease(endpoint, frm, to):
        w = holder["world"]
        if w is not None:
            w.lease_edges.add((frm, to))

    breaker_lib.set_observer(observe)
    fleet_lib.set_lease_observer(observe_lease)
    all_breaker_edges: set = set()
    all_rollout_edges: set = set()
    all_lease_edges: set = set()
    try:
        stack = [()]
        while stack:
            prefix = stack.pop()
            schedules += 1
            try:
                world = _replay(prefix, holder)
            except InvariantViolation as exc:
                violations.append(str(exc))
                if holder["world"] is not None:
                    all_breaker_edges |= holder["world"].breaker_edges
                    all_rollout_edges |= holder["world"].rollout_edges
                    all_lease_edges |= holder["world"].lease_edges
                continue
            all_breaker_edges |= world.breaker_edges
            all_rollout_edges |= world.rollout_edges
            all_lease_edges |= world.lease_edges
            key = world.state_key()
            if prefix and key in visited:
                continue  # converged with an already-explored world
            visited.add(key)
            if len(prefix) >= depth:
                leaves += 1
                if check_recurrence:
                    try:
                        world.check_recurrence(prefix)
                    except InvariantViolation as exc:
                        violations.append(str(exc))
                    all_breaker_edges |= world.breaker_edges
                    all_rollout_edges |= world.rollout_edges
                    all_lease_edges |= world.lease_edges
                continue
            for ev in reversed(alphabet):
                stack.append(prefix + (ev,))
    finally:
        breaker_lib.set_observer(observer_restore)
        fleet_lib.set_lease_observer(lease_observer_restore)
        holder["world"] = None

    coverage = {
        "rollout._state": _coverage(ROLLOUT_SRC, "_state",
                                    all_rollout_edges),
        "breaker._state": _coverage(BREAKER_SRC, "_state",
                                    all_breaker_edges),
        "fleet._state": _coverage(FLEET_SRC, "_state",
                                  all_lease_edges),
    }
    return {
        "depth": depth,
        "seed": seed,
        "schedules": schedules,
        "states": len(visited),
        "leaves": leaves,
        "visited_hash": hashlib.sha256(
            "".join(sorted(visited)).encode()).hexdigest(),
        "violations": violations,
        "coverage": coverage,
    }


def _coverage(src: Path, field: str, witnessed: set) -> dict:
    """Compare statecheck's extracted edges against the witnessed ones:
    a concrete (frm, to) edge needs that exact pair; a ``*`` edge needs
    any witnessed entry into its target."""
    machines = [m for m in statecheck.extract_machines(src)
                if m.field == field]
    if not machines:
        raise RuntimeError(f"statecheck extracted no {field!r} machine "
                           f"from {src}")
    machine = machines[0]
    required = {(t.frm, t.to) for t in machine.transitions
                if t.to not in ("?",)}
    missing = []
    for frm, to in sorted(required):
        if frm == "*":
            ok = any(w_to == to and w_frm != to
                     for w_frm, w_to in witnessed)
        else:
            ok = (frm, to) in witnessed
        if not ok:
            missing.append(f"{frm}->{to}")
    return {
        "edges": len(required),
        "witnessed": len(required) - len(missing),
        "missing": missing,
        "complete": not missing,
    }


# -- CLI ---------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m robotic_discovery_platform_tpu_torch.analysis."
             "explore",
        description="bounded exhaustive schedule explorer for the "
                    "serving control plane",
    )
    parser.add_argument("--depth", type=int, default=4,
                        help="schedule depth bound (default 4)")
    parser.add_argument("--seed", type=int, default=0,
                        help="event-order rotation seed (default 0)")
    parser.add_argument("--require-full-coverage", action="store_true",
                        help="exit 1 unless every extracted rollout and "
                             "breaker transition was witnessed")
    parser.add_argument("--no-recurrence", action="store_true",
                        help="skip the leaf recurrence checks")
    args = parser.parse_args(argv)

    report = run(args.depth, args.seed,
                 check_recurrence=not args.no_recurrence)
    print(json.dumps(report, indent=2))
    rc = 0
    if report["violations"]:
        print(f"explore: {len(report['violations'])} invariant "
              "violation(s)", file=sys.stderr)
        rc = 1
    if args.require_full_coverage:
        for name, cov in report["coverage"].items():
            if not cov["complete"]:
                print(f"explore: {name} coverage incomplete: missing "
                      f"{cov['missing']}", file=sys.stderr)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
