"""The fleet twin: the port's real control objects over a modeled device
ride (the port's copy of the JAX package's ``sim/cluster.py``).

Composition per the explore.py idiom, scaled from correctness to
performance: every replica runs a REAL ``ReactiveController`` over its
(modeled) dispatcher knob surface and a REAL ``SloTracker``; every
front-end runs a REAL ``LeaseRegistry`` + ``FleetRouter`` (fake
transport pre-seeded into each ``Replica``'s health/stats stubs, exactly
``analysis/explore.World._seed_stubs``) and a REAL ``PeerGossip`` whose
per-peer stubs answer from the sibling front-end's actual
``frontend_stats``-shaped state; the REAL ``ZooPlacer`` sees every
arrival; the REAL ``Autoscaler`` + ``planner.plan`` drive elastic
scale; the REAL ``RolloutManager`` (model edges stubbed, state machine
untouched) drains/retrains/shadows/promotes sim replicas on the virtual
clock. The ONLY modeled piece is the device: a frame's ride through
submit -> coalesce -> dispatch -> D2H is one draw from the fitted
:class:`~.model.ServiceTimeModel`,
gated by a slot model (``(chips - chips_down) x slots_per_chip``,
scaled by the controller's live ``max_inflight`` knob) so queueing
beyond the calibrated operating point emerges from the event queue.

Frames ride streams (the live protocol's unit of placement): a stream
is placed once via ``FleetRouter.pick`` and its frames ride that
replica until it dies or drains, then fail over through
``on_stream_error`` -> re-pick -- the same failover edge the live
front-end takes.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from robotic_discovery_platform_tpu_torch.observability import slo as slo_lib
from robotic_discovery_platform_tpu_torch.serving import controller as ctrl_lib
from robotic_discovery_platform_tpu_torch.serving import fleet as fleet_lib
from robotic_discovery_platform_tpu_torch.serving import health as health_lib
from robotic_discovery_platform_tpu_torch.serving import planner as planner_lib
from robotic_discovery_platform_tpu_torch.serving import rollout as rollout_lib
from robotic_discovery_platform_tpu_torch.serving import zoo as zoo_lib
from robotic_discovery_platform_tpu_torch.sim import metrics as sim_metrics
from robotic_discovery_platform_tpu_torch.sim.engine import Engine
from robotic_discovery_platform_tpu_torch.sim.model import ServiceTimeModel
from robotic_discovery_platform_tpu_torch.utils.config import (
    RolloutConfig,
    ServerConfig,
)


@dataclass
class SimConfig:
    """Topology + policy knobs for one sim run."""

    n_replicas: int = 4
    n_frontends: int = 1
    chips_per_replica: int = 4
    #: modeled concurrent frame slots per chip at the default
    #: max_inflight; the controller's max_inflight knob scales it
    slots_per_chip: int = 4
    models: tuple[str, ...] = ("seg", "aux")
    placement: str = "shared"
    precision: str = "bf16"
    slo_ms: float = 250.0
    deadline_ms: float = 250.0
    #: the modeled dispatcher's batch window at level 0, ms; a frame
    #: waits half of it on average. 8.0 is the JAX twin's fixed value; a
    #: leg replayed by :mod:`.calibrate` takes its server's
    #: ``batch_window_ms`` when the row records it (0: the direct path)
    window_ms: float = 8.0
    streams: int = 32
    #: stream failover attempts before a frame error-completes
    max_failovers: int = 2
    max_queue: int = 256
    lease_ttl_s: float = 10.0
    renew_every_s: float = 3.0
    fleet_poll_s: float = 1.0
    gossip_poll_s: float = 1.0
    controller_tick_s: float = 1.0
    breaker_failures: int = 2
    breaker_reset_s: float = 5.0
    # -- autoscaler ----------------------------------------------------------
    autoscale: bool = False
    autoscale_poll_s: float = 5.0
    autoscale_sustain_s: float = 10.0
    autoscale_cooldown_s: float = 30.0
    min_replicas: int = 1
    max_replicas: int = 64
    headroom: float = 0.7
    # -- rollout -------------------------------------------------------------
    rollout_stage_timeout_s: float = 5.0


@dataclass(eq=False)
class SimFrame:
    t_arrive: float
    model: str
    stream: int
    deadline_t: float
    failovers: int = 0


class _FakeHealthResp:
    __slots__ = ("status",)

    def __init__(self, status):
        self.status = status


class FakeHealthStub:
    """Answers from the sim replica's liveness instead of a socket."""

    def __init__(self, replica: "SimReplica"):
        self._replica = replica

    def Check(self, request, timeout=None):  # noqa: N802 - gRPC surface
        if not self._replica.alive:
            raise RuntimeError(
                f"connection refused: {self._replica.endpoint}")
        return _FakeHealthResp(health_lib.SERVING)


class FakeStatsStub:
    """The replica stats RPC, answered from live sim state: the burn the
    REAL FleetRouter scrapes here is the REAL SloTracker's, fed by
    modeled completions."""

    def __init__(self, replica: "SimReplica"):
        self._replica = replica

    def Get(self, request, timeout=None):  # noqa: N802 - gRPC surface
        r = self._replica
        if not r.alive:
            raise RuntimeError(f"connection refused: {r.endpoint}")
        return json.dumps({
            "inflight": r.busy + len(r.queue),
            "burn": round(r.slo.burn, 6),
            "draining": r.draining,
            "metrics_port": 0,
        }).encode()


class FakeFrontendStatsStub:
    """What PeerGossip polls: the sibling front-end's gossip payload
    (lease snapshot + placement loads), straight from its real registry
    and router."""

    def __init__(self, frontend: "SimFrontend"):
        self._frontend = frontend

    def Get(self, request, timeout=None):  # noqa: N802 - gRPC surface
        fe = self._frontend
        if not fe.alive:
            raise RuntimeError(f"connection refused: {fe.name}")
        return json.dumps({
            "leases": fe.registry.snapshot(),
            "replica_loads": fe.router.placement_loads(),
        }).encode()


class SimDispatcher:
    """The controller-facing knob surface (the FakeDispatcher shape from
    explore.py), except here the knobs BITE: max_inflight scales the
    replica's modeled service slots, window_ms adds coalescing delay,
    deadline_safety moves the admission shed point."""

    DEFAULT_MAX_INFLIGHT = 2

    def __init__(self, replica: "SimReplica"):
        self._replica = replica
        self.window_ms = float(replica.fleet.cfg.window_ms)
        self.max_inflight = self.DEFAULT_MAX_INFLIGHT
        self.bucket_floor = 1
        self.deadline_safety = 1.0
        self.recent_batch = 1.0
        self.router = None  # no per-chip mode switching in the twin
        self._max_batch = 8

    def set_window_ms(self, v) -> None:
        self.window_ms = float(v)

    def set_max_inflight(self, v) -> None:
        self.max_inflight = max(1, int(v))

    def set_bucket_floor(self, v) -> None:
        self.bucket_floor = int(v)

    def set_deadline_safety(self, v) -> None:
        self.deadline_safety = float(v)

    def backlog(self) -> int:
        return len(self._replica.queue)


class SimReplica:
    """One modeled replica: real controller + real SLO tracker over a
    slot-limited service station."""

    def __init__(self, endpoint: str, fleet: "SimFleet", home: int):
        cfg = fleet.cfg
        self.endpoint = endpoint
        self.fleet = fleet
        self.home = home  # preferred registrar front-end index
        self.engine: Engine = fleet.engine
        self.alive = True
        self.retired = False
        self.draining = False
        self.refusing = False
        self.version = "v1"
        self.chips = cfg.chips_per_replica
        self.chips_down = 0
        self.brownout_scale = 1.0
        self.queue: deque[SimFrame] = deque()
        self.busy = 0
        self.completed = 0
        self.shed = 0
        self._brownout_tick = 0
        self.dispatcher = SimDispatcher(self)
        self.slo = slo_lib.SloTracker(cfg.slo_ms / 1e3,
                                      window=256, name=endpoint)
        self.controller = ctrl_lib.ReactiveController(
            lambda: self.dispatcher, lambda: self.slo.burn,
            refuse_streams=self._set_refusing,
            interval_s=cfg.controller_tick_s,
            sustain_s=cfg.controller_tick_s,
            cooldown_s=2.0 * cfg.controller_tick_s,
            samples=lambda: self.slo.observed_total,
            min_samples=8,
            clock=self.engine.clock,
        )

    # -- controller hooks ----------------------------------------------------

    def _set_refusing(self, refuse: bool) -> None:
        self.refusing = bool(refuse)

    def try_enter_stream(self) -> bool:
        """The servicer's ``_enter_stream`` edge: refusal applies to NEW
        stream placement only, duty-cycled at 50% exactly like the live
        brownout rung 3 -- refusing ALL streams would starve the burn
        signal and deadlock the ladder at its top rung."""
        if not self.alive or self.retired or self.draining:
            return False
        if self.refusing:
            self._brownout_tick += 1
            if self._brownout_tick % 2:
                return False
        return True

    def slots(self) -> int:
        """Modeled concurrent service capacity right now: healthy chips
        x slots_per_chip, scaled by the controller's live max_inflight
        (relative to its default) -- tightening inflight under brownout
        really does serialize the modeled device."""
        chips = max(0, self.chips - self.chips_down)
        if chips == 0:
            return 0
        scale = (self.dispatcher.max_inflight
                 / SimDispatcher.DEFAULT_MAX_INFLIGHT)
        return max(1, int(round(
            chips * self.fleet.cfg.slots_per_chip * scale)))

    # -- the modeled device ride --------------------------------------------

    def offer(self, frame: SimFrame) -> bool:
        """Accept a frame from a placed stream onto the modeled queue;
        False = the replica is gone (caller fails over). Frames of
        already-placed streams flow even while the replica refuses NEW
        streams -- that is the live semantic, and it is what lets burn
        keep flowing so the brownout ladder's exit stays reachable."""
        if not self.alive or self.retired:
            return False
        if len(self.queue) >= self.fleet.cfg.max_queue:
            # backlog cap: served-path failure, charged to this
            # replica's SLO (drives the brownout ladder)
            self.shed += 1
            self.slo.observe(0.0, ok=False)
            self.fleet.frame_error(frame, "backlog_full")
            return True  # absorbed (as an error), no failover
        self.queue.append(frame)
        self._pump()
        return True

    def _pump(self) -> None:
        cfg = self.fleet.cfg
        while self.queue and self.busy < self.slots():
            frame = self.queue.popleft()
            now = self.engine.now()
            est = (self.fleet.service.mean_s(
                frame.model, placement=self.fleet.placer.mode,
                precision=cfg.precision) * self.dispatcher.deadline_safety)
            if frame.deadline_t - now < est:
                # unmeetable at admission: shed before staging, the
                # dispatcher's deadline discipline
                self.shed += 1
                self.slo.observe(0.0, ok=False)
                self.fleet.frame_error(frame, "deadline_shed")
                continue
            self.busy += 1
            window_s = self.dispatcher.window_ms / 2e3  # mean coalesce wait
            service_s = self.fleet.service.sample_s(
                self.engine.rng, frame.model,
                placement=self.fleet.placer.mode,
                precision=cfg.precision,
                scale=self.brownout_scale)
            self.engine.after(window_s + service_s,
                              lambda f=frame: self._complete(f))

    def _complete(self, frame: SimFrame) -> None:
        self.busy = max(0, self.busy - 1)
        if not self.alive or self.retired:
            # the replica died with this frame in flight
            self.fleet.frame_failover(frame, self,
                                      RuntimeError("replica died mid-frame"))
        else:
            latency_s = self.engine.now() - frame.t_arrive
            self.completed += 1
            self.slo.observe(latency_s, ok=True)
            self.fleet.frame_done(frame, latency_s)
        self._pump()

    # -- faults --------------------------------------------------------------

    def kill(self) -> None:
        if not self.alive:
            return
        self.alive = False
        self.engine.log.emit("replica.kill", endpoint=self.endpoint)
        # queued (not yet staged) frames die with the process NOW;
        # in-flight ones fail at their scheduled completion instant
        dead, self.queue = list(self.queue), deque()
        for frame in dead:
            self.fleet.frame_failover(
                frame, self, RuntimeError("replica killed"))

    def restart(self) -> None:
        if self.alive:
            return
        self.alive = True
        # sim-twin state, recorded on the deterministic sim log below;
        # the real journal/metric edges belong to the live servicer
        self.draining = False  # statecheck: disable=SC002
        self.refusing = False
        self.chips_down = 0
        self.brownout_scale = 1.0
        self.engine.log.emit("replica.restart", endpoint=self.endpoint)
        self.renew_lease()  # re-register immediately, the live boot path

    # -- leases --------------------------------------------------------------

    def renew_lease(self) -> None:
        if not self.alive or self.retired:
            return
        fe = self.fleet.registrar_for(self)
        if fe is None:
            return
        if fe.registry.renew(self.endpoint) is None:
            fe.registry.register(self.endpoint, version=self.version)


class SimFrontend:
    """One replicated front-end: real registry, router and gossip over
    fake transport."""

    def __init__(self, fleet: "SimFleet", idx: int):
        self.fleet = fleet
        self.idx = idx
        self.name = f"frontend-{idx}"
        self.alive = True
        self._build()

    def _build(self) -> None:
        cfg = self.fleet.cfg
        engine = self.fleet.engine
        self.registry = fleet_lib.LeaseRegistry(
            ttl_s=cfg.lease_ttl_s, clock=engine.clock)
        self.router = fleet_lib.FleetRouter(
            [], breaker_failures=cfg.breaker_failures,
            breaker_reset_s=cfg.breaker_reset_s,
            poll_s=cfg.fleet_poll_s, clock=engine.clock,
            channel_factory=lambda ep: None, registry=self.registry)
        peers = [f"frontend-{i}" for i in range(cfg.n_frontends)
                 if i != self.idx]
        self.gossip = fleet_lib.PeerGossip(
            peers, registry=self.registry, router=self.router,
            poll_s=cfg.gossip_poll_s, channel_factory=lambda ep: None)
        for peer in peers:
            i = int(peer.rsplit("-", 1)[1])
            self.gossip._stubs[peer] = FakeFrontendStatsStub(
                self.fleet.frontends_ref[i]
                if i < len(self.fleet.frontends_ref) else
                _LazyFrontend(self.fleet, i))

    def _seed_stubs(self) -> None:
        """explore.World._seed_stubs: fake transport onto every fleet
        Replica that lacks it (leased members join via sync_leases)."""
        for r in self.router.replicas:
            if r._health_stub is None:
                sim = self.fleet.replicas.get(r.endpoint)
                if sim is None:
                    continue
                r._health_stub = FakeHealthStub(sim)
                r._stats_stub = FakeStatsStub(sim)

    def poll(self) -> None:
        """One membership tick: sweep + admit leased members + seed their
        fake transport, then the router's real poll."""
        if not self.alive:
            return
        self.registry.sweep()
        self.router.sync_leases()
        self._seed_stubs()
        self.router.poll_once()

    def gossip_poll(self) -> None:
        if self.alive and self.gossip.peers:
            self.gossip.poll_once()

    def kill(self) -> None:
        if not self.alive:
            return
        self.alive = False
        self.fleet.engine.log.emit("frontend.kill", name=self.name)

    def restart(self) -> None:
        """Registrar restart: the lease table is GONE (it was process
        state). Rebuild empty, then take one immediate gossip round --
        the exact boot-time seed ``PeerGossip.start()`` now performs --
        so sibling-advertised leases are adopted before the first
        placement instead of after the ~1 TTL blind spot."""
        self.alive = True
        self._build()
        self.fleet.engine.log.emit("frontend.restart", name=self.name)
        self.gossip_poll()


class _LazyFrontend:
    """Forward reference for gossip stub seeding during construction
    (front-end i's stub may be built before sibling j exists)."""

    def __init__(self, fleet: "SimFleet", idx: int):
        self._fleet = fleet
        self._idx = idx

    @property
    def alive(self):
        return self._fleet.frontends[self._idx].alive

    @property
    def registry(self):
        return self._fleet.frontends[self._idx].registry

    @property
    def router(self):
        return self._fleet.frontends[self._idx].router


# -- rollout wiring (explore.py's stubbed model edges) -----------------------


class SimRolloutTarget:
    """The rollout target surface over a sim replica."""

    def __init__(self, replica: SimReplica):
        self.replica = replica
        self.name = replica.endpoint
        self.shadow_hook = None
        self.feed_on_shadow = 4
        self.promotions = 0

    @property
    def active_streams(self) -> int:
        return self.replica.busy + len(self.replica.queue)

    @property
    def current_version(self) -> str:
        return self.replica.version

    def set_draining(self, draining) -> None:
        # target surface over the modeled replica; the REAL journal/drain
        # instrumentation lives in the serving targets
        self.replica.draining = bool(draining)  # statecheck: disable=SC002

    def set_shadow(self, hook) -> None:
        self.shadow_hook = hook
        if hook is not None:
            for _ in range(self.feed_on_shadow):
                hook(_shadow_sample())

    def promote(self) -> bool:
        self.promotions += 1
        self.replica.version = f"v{self.promotions + 1}"
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


class SimRolloutManager(rollout_lib.RolloutManager):
    """RolloutManager with the MODEL edges stubbed (explore.py idiom);
    the drain/retrain/shadow/gate/promote machine runs unmodified on the
    engine's clock and reentrant sleep. The port's candidate is one
    callable ``analyze(rgb, depth, k, scale)`` (the JAX package's takes
    its variables first and comes with them)."""

    candidate_good = True

    def _load_candidate(self, version):
        mask = np.ones((8, 8), np.uint8) if self.candidate_good \
            else np.zeros((8, 8), np.uint8)

        def analyze(rgb, depth, k, scale):
            return _analysis(mask)

        return analyze

    def _fixture_report(self, reference, cand_analyze):
        iou = 1.0 if self.candidate_good else 0.0
        return {"mask_iou_mean": iou, "curvature_err_max": 0.0}

    def _promote(self, cycle, version):
        for t in self.targets:
            t.promote()


# -- the fleet ---------------------------------------------------------------


@dataclass
class SimResult:
    """What one run hands back: client-side latency rows in the
    LOADBENCH schema, the deterministic event log, and the control
    plane's own counters."""

    rows: dict[str, dict]
    log_text: str
    duration_s: float
    counters: dict[str, Any] = field(default_factory=dict)


class SimFleet:
    """The composed twin. Construct, optionally apply a Scenario, then
    :meth:`run` a workload schedule."""

    def __init__(self, cfg: SimConfig, engine: Engine,
                 service: ServiceTimeModel | None = None):
        self.cfg = cfg
        self.engine = engine
        self.service = service if service is not None \
            else ServiceTimeModel.synthetic(models=tuple(cfg.models),
                                            slo_ms=cfg.slo_ms,
                                            chips=cfg.chips_per_replica)
        self.placer = zoo_lib.ZooPlacer(
            tuple(cfg.models), cfg.chips_per_replica, mode=cfg.placement,
            clock=engine.clock)
        self.replicas: dict[str, SimReplica] = {}
        self.frontends: list[SimFrontend] = []
        self.frontends_ref = self.frontends  # alias for stub seeding
        self._spawned = 0
        self.streams: dict[int, tuple[int, Any]] = {}  # sid -> (fe, Replica)
        self.lat_ms: dict[str, list[float]] = {m: [] for m in cfg.models}
        self.errors: dict[str, int] = {m: 0 for m in cfg.models}
        self.arrivals_seen: dict[str, int] = {m: 0 for m in cfg.models}
        self._arrival_window: deque[float] = deque()
        self.extra_schedules: list[list[tuple[float, str]]] = []
        self.autoscaler = planner_lib.Autoscaler(
            min_replicas=cfg.min_replicas, max_replicas=cfg.max_replicas,
            sustain_s=cfg.autoscale_sustain_s,
            cooldown_s=cfg.autoscale_cooldown_s, clock=engine.clock)
        self.rollout = SimRolloutManager(
            [], RolloutConfig(
                shadow_fraction=1.0, shadow_min_frames=2, shadow_queue=16,
                drain_timeout_s=cfg.rollout_stage_timeout_s,
                retrain_timeout_s=cfg.rollout_stage_timeout_s,
                shadow_timeout_s=cfg.rollout_stage_timeout_s,
                promote_timeout_s=cfg.rollout_stage_timeout_s,
                gate_shadow_min_iou=0.5, gate_shadow_max_psi=1.0),
            ServerConfig(), train_fn=lambda target: _FakeTrainResult(),
            clock=engine.clock, sleep=engine.sleep,
            device="cpu")  # stubbed model edges: no device work
        for i in range(cfg.n_frontends):
            self.frontends.append(SimFrontend(self, i))
        for _ in range(cfg.n_replicas):
            self.spawn_replica()
        # one warm-up membership round so the fleet starts placeable
        for r in self.replicas.values():
            r.renew_lease()
        for fe in self.frontends:
            fe.poll()
            fe.gossip_poll()

    # -- membership ----------------------------------------------------------

    def spawn_replica(self) -> SimReplica:
        self._spawned += 1
        endpoint = f"replica-{self._spawned}:0"
        home = (self._spawned - 1) % max(1, len(self.frontends))
        r = SimReplica(endpoint, self, home)
        self.replicas[endpoint] = r
        self.rollout.add_target(SimRolloutTarget(r))
        r.renew_lease()
        self.engine.log.emit("replica.spawn", endpoint=endpoint)
        return r

    def registrar_for(self, replica: SimReplica) -> SimFrontend | None:
        """The replica's registrar: its home front-end, or (the live
        client re-registration path) the first living sibling."""
        n = len(self.frontends)
        for off in range(n):
            fe = self.frontends[(replica.home + off) % n]
            if fe.alive:
                return fe
        return None

    def live_replicas(self) -> list[SimReplica]:
        return [r for r in self.replicas.values()
                if r.alive and not r.retired]

    # -- frame path ----------------------------------------------------------

    def _frontend_for(self, sid: int) -> SimFrontend | None:
        n = len(self.frontends)
        for off in range(n):
            fe = self.frontends[(sid + off) % n]
            if fe.alive:
                return fe
        return None

    def _place(self, sid: int, exclude=None):
        fe = self._frontend_for(sid)
        if fe is None:
            return None
        exclude = set(exclude or ())
        # the client's placement loop: a refusing replica answers new
        # streams UNAVAILABLE and the client retries elsewhere
        for _ in range(4):
            picked = fe.router.pick(exclude=exclude)
            if picked is None:
                return None
            sim = self.replicas.get(picked.endpoint)
            if sim is not None and sim.try_enter_stream():
                self.streams[sid] = (fe.idx, picked)
                return picked
            fe.router.release(picked)
            fe.router.record_failover(rerouted=1)
            exclude.add(picked)
        return None

    def arrive(self, t: float, model: str) -> None:
        cfg = self.cfg
        self.arrivals_seen[model] = self.arrivals_seen.get(model, 0) + 1
        self._arrival_window.append(t)
        self.placer.record_arrival(model)
        sid = sum(self.arrivals_seen.values()) % max(1, cfg.streams)
        frame = SimFrame(t_arrive=t, model=model, stream=sid,
                         deadline_t=t + cfg.deadline_ms / 1e3)
        self._deliver(frame)

    def _deliver(self, frame: SimFrame) -> None:
        placed = self.streams.get(frame.stream)
        fleet_replica = None
        if placed is not None:
            fe_idx, fleet_replica = placed
            sim = self.replicas.get(fleet_replica.endpoint)
            if (sim is None or not sim.alive or sim.retired
                    or not fleet_replica.placeable):
                # the pinned replica is gone/quarantined: release and
                # re-place (the front-end's stash/re-send edge)
                if fe_idx < len(self.frontends) \
                        and self.frontends[fe_idx].alive:
                    self.frontends[fe_idx].router.release(fleet_replica)
                self.streams.pop(frame.stream, None)
                fleet_replica = None
        if fleet_replica is None:
            fleet_replica = self._place(frame.stream)
        if fleet_replica is None:
            self.frame_error(frame, "no_replica_placeable")
            return
        sim = self.replicas.get(fleet_replica.endpoint)
        fe_idx = self.streams[frame.stream][0]
        fe = self.frontends[fe_idx]
        fe.router.count_frame(fleet_replica)
        if sim is None or not sim.offer(frame):
            fe.router.on_stream_error(
                fleet_replica, RuntimeError("stream refused"))
            self.frame_failover(frame, sim, RuntimeError("offer refused"))

    def frame_done(self, frame: SimFrame, latency_s: float) -> None:
        self.lat_ms.setdefault(frame.model, []).append(latency_s * 1e3)
        placed = self.streams.get(frame.stream)
        if placed is not None:
            fe_idx, fleet_replica = placed
            if fe_idx < len(self.frontends) and self.frontends[fe_idx].alive:
                self.frontends[fe_idx].router.on_stream_ok(fleet_replica)

    def frame_error(self, frame: SimFrame, reason: str) -> None:
        self.errors[frame.model] = self.errors.get(frame.model, 0) + 1
        self.engine.log.emit("frame.error", model=frame.model,
                             reason=reason)

    def frame_failover(self, frame: SimFrame, from_replica, exc) -> None:
        """A frame lost its replica mid-ride: count the stream error
        with the placing router (breaker food), then re-place and
        re-send unless the frame is out of attempts or headroom."""
        placed = self.streams.pop(frame.stream, None)
        old = None
        if placed is not None:
            fe_idx, old = placed
            if fe_idx < len(self.frontends) and self.frontends[fe_idx].alive:
                router = self.frontends[fe_idx].router
                router.on_stream_error(old, exc)
                router.release(old)
        frame.failovers += 1
        now = self.engine.now()
        if (frame.failovers > self.cfg.max_failovers
                or frame.deadline_t <= now):
            for fe in self.frontends:
                if fe.alive:
                    fe.router.record_failover(error_completed=1)
                    break
            self.frame_error(frame, "failover_exhausted")
            return
        for fe in self.frontends:
            if fe.alive:
                fe.router.record_failover(rerouted=1)
                break
        self._deliver(frame)

    # -- autoscaler ----------------------------------------------------------

    def demand_rps(self, window_s: float = 30.0) -> float:
        now = self.engine.now()
        while self._arrival_window and \
                self._arrival_window[0] < now - window_s:
            self._arrival_window.popleft()
        horizon = min(window_s, now) or 1.0
        return len(self._arrival_window) / horizon

    def capacity(self) -> planner_lib.CapacityModel:
        cfg = self.cfg
        slots = cfg.chips_per_replica * cfg.slots_per_chip
        return planner_lib.CapacityModel(
            goodput_rps=self.service.goodput_rps(
                placement=self.placer.mode, slots=slots),
            p99_ms=max(e.p99_ms for e in self.service.entries),
            slo_ms=cfg.slo_ms, chips=cfg.chips_per_replica,
            placement=self.placer.mode, precision=cfg.precision,
            source="sim-fit")

    def autoscale_tick(self) -> None:
        live = self.live_replicas()
        if not live:
            return
        burn_max = max(r.slo.burn for r in live)
        verdict = planner_lib.plan(
            self.demand_rps(), len(live), capacity=self.capacity(),
            headroom=self.cfg.headroom, burn_max=burn_max,
            min_replicas=self.cfg.min_replicas,
            max_replicas=self.cfg.max_replicas)
        action = self.autoscaler.decide(verdict)
        if action == "scale_up":
            self.spawn_replica()
            self.engine.log.emit("autoscale.up",
                                 target=verdict.target_replicas,
                                 live=len(live))
        elif action == "scale_down":
            victim = self._scale_down_pick(live)
            if victim is not None:
                self.engine.log.emit("autoscale.down",
                                     victim=victim.endpoint,
                                     live=len(live))
                self.drain_and_retire(victim)

    def _scale_down_pick(self, live: list[SimReplica]) -> SimReplica | None:
        candidates = [r for r in live if not r.draining]
        if len(candidates) <= self.cfg.min_replicas:
            return None
        return min(candidates,
                   key=lambda r: (r.busy + len(r.queue), r.endpoint))

    def drain_and_retire(self, replica: SimReplica) -> None:
        # sim-twin state; the retire edge lands on the sim log and the
        # registry's own journaled leave() when the drain completes
        replica.draining = True  # statecheck: disable=SC002

        def maybe_retire() -> None:
            if not replica.alive or replica.retired:
                return
            if replica.busy == 0 and not replica.queue:
                fe = self.registrar_for(replica)
                if fe is not None:
                    try:
                        fe.registry.leave(replica.endpoint)
                    except KeyError:
                        pass
                replica.retired = True
                replica.alive = False
                self.engine.log.emit("replica.retired",
                                     endpoint=replica.endpoint)
            else:
                self.engine.after(1.0, maybe_retire)

        maybe_retire()

    # -- the run -------------------------------------------------------------

    def run(self, schedule: list[tuple[float, str]], duration_s: float,
            scenario=None) -> SimResult:
        cfg = self.cfg
        engine = self.engine
        if scenario is not None:
            scenario.apply(self, engine)
        merged = list(schedule)
        for extra in self.extra_schedules:
            merged.extend(extra)
        merged.sort(key=lambda tm: (tm[0], tm[1]))

        # stream the arrivals through ONE pending engine event (a
        # million-frame schedule must not be a million heap entries)
        it = iter(merged)

        def feed(first: tuple[float, str]) -> None:
            t, model = first
            self.arrive(t, model)
            nxt = next(it, None)
            if nxt is not None:
                engine.at(nxt[0], lambda: feed(nxt))

        first = next(it, None)
        if first is not None:
            engine.at(first[0], lambda: feed(first))

        alive = lambda: True  # noqa: E731 - run to the horizon
        engine.every(cfg.fleet_poll_s,
                     lambda: [fe.poll() for fe in self.frontends],
                     while_fn=alive)
        engine.every(cfg.gossip_poll_s,
                     lambda: [fe.gossip_poll() for fe in self.frontends],
                     while_fn=alive)
        engine.every(cfg.controller_tick_s,
                     lambda: [r.controller.tick()
                              for r in self.replicas.values()
                              if r.alive and not r.retired],
                     while_fn=alive)
        engine.every(cfg.renew_every_s,
                     lambda: [r.renew_lease()
                              for r in self.replicas.values()],
                     while_fn=alive)
        if cfg.autoscale:
            engine.every(cfg.autoscale_poll_s, self.autoscale_tick,
                         while_fn=alive)

        engine.run_until(duration_s)
        # drain the in-flight tail so the last arrivals complete
        engine.run_until(duration_s + cfg.slo_ms / 1e3 * 4)

        rows: dict[str, dict] = {}
        all_lat: list[float] = []
        all_err = 0
        for model in sorted(set(self.lat_ms) | set(self.errors)):
            lat = self.lat_ms.get(model, [])
            err = self.errors.get(model, 0)
            offered = self.arrivals_seen.get(model, 0) / max(duration_s,
                                                             1e-9)
            rows[model] = sim_metrics.summarize_level(
                lat, err, offered, duration_s, cfg.slo_ms)
            all_lat.extend(lat)
            all_err += err
        rows["__all__"] = sim_metrics.summarize_level(
            all_lat, all_err,
            sum(self.arrivals_seen.values()) / max(duration_s, 1e-9),
            duration_s, cfg.slo_ms)
        fe0 = next((fe for fe in self.frontends if fe.alive),
                   self.frontends[0])
        counters = {
            "events_run": engine.events_run,
            "replicas_spawned": self._spawned,
            "replicas_live": len(self.live_replicas()),
            "failovers_total": sum(fe.router.failovers_total
                                   for fe in self.frontends),
            "leases_active": len(
                fe0.registry.endpoints(fleet_lib.LEASE_ACTIVE)),
            "autoscaler_actions": self.autoscaler.actions_total,
            "placer_rebalances": self.placer.rebalances,
        }
        return SimResult(rows=rows, log_text=engine.log.text(),
                         duration_s=duration_s, counters=counters)
