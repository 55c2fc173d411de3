"""Capacity planner + drain-driven autoscaler for the elastic fleet.

The manual loop this closes: a human reads LOADBENCH.json (what one
replica sustains inside the SLO), eyeballs ``GET /federate`` (what the
fleet is being asked to do right now), and decides how many replicas to
run. The planner is that arithmetic as code; the autoscaler is the
actuator that carries its recommendation out through machinery the
serving stack already has:

- **capacity** comes from the measured load bench
  (:meth:`CapacityModel.from_loadbench`): the best goodput any
  within-violation-budget row sustained, with the row's chips/placement
  riding along -- so a plan names the full serving config (replicas, chips, precision,
  dispatch mode, batching window), not just a count;
- **demand** comes from the live ``/federate`` roll-ups the front-end
  already computes (``rdp_fleet_model_arrival_rate`` summed over models,
  ``rdp_fleet_burn{stat="max"}`` as the is-it-already-hurting signal);
- **actions** ride existing paths: scale-up spawns a replica that
  self-registers a membership lease (serving/replica.py spawner +
  serving/fleet.py LeaseClient -- the front-end needs no config edit);
  scale-down sends the Drain RPC to the least-loaded member, which takes
  it out of NEW-stream placement through the servicer's exact
  ``set_draining`` path while its in-flight streams finish;
- **discipline** is the reactive controller's idiom: a scale signal must hold
  ``sustain_s`` before anything fires, every action is followed by a
  ``cooldown_s`` sleep, and only one action is ever in flight -- the
  fleet steps, it never flaps. Every decision (including the holds) is
  journaled; every ACTION is also counted
  (``rdp_autoscaler_actions_total``) and pinned in the flight recorder,
  so the incident view shows why the fleet changed shape.

Everything is injectable (clock, observe/spawn/drain callables), so the
whole control loop runs against fakes in tests; torch- and grpc-free like
the rest of the front-end plane.

The port's copy of the JAX package's module, with one deliberate
difference: :meth:`CapacityModel.resolve` fits capacity only from the file
``planner_capacity_path`` names (else ``DEFAULT_GOODPUT_RPS``) and never
reads ``<root>/LOADBENCH.json`` or ``<root>/PALLASBENCH.json``, which in
this repository hold TPU measurements: the port's capacity is the card's
own.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from robotic_discovery_platform_tpu_torch.observability import (
    events,
    families,
    instruments as obs,
    journal as journal_lib,
    recorder as recorder_lib,
)
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: default violation-rate ceiling a bench row must beat to count as
#: "sustainable" capacity (matches the load bench's SLO budget)
VIOLATION_BUDGET = 0.05

#: the no-bench fallback: deliberately conservative so a misplaced
#: LOADBENCH.json over-provisions instead of under-provisioning
DEFAULT_GOODPUT_RPS = 20.0

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[^\s]+)$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


# -- capacity ----------------------------------------------------------------


@dataclass(frozen=True)
class CapacityModel:
    """What ONE replica sustains inside the SLO, fit from the benches."""

    goodput_rps: float
    p99_ms: float = 0.0
    slo_ms: float = 0.0
    chips: int = 1
    placement: str = "shared"
    precision: str = "f32"
    source: str = "default"

    @classmethod
    def default(cls) -> "CapacityModel":
        return cls(goodput_rps=DEFAULT_GOODPUT_RPS)

    @classmethod
    def from_loadbench(cls, path: str | Path, *,
                       violation_budget: float = VIOLATION_BUDGET,
                       precision: str = "f32") -> "CapacityModel":
        """The best goodput any within-budget row sustained, with that
        row's chips/placement. Raises on an unreadable/empty bench."""
        data = json.loads(Path(path).read_text())
        best = None
        for row in data.get("rows", []):
            try:
                rate = float(row.get("goodput_rps", 0.0))
                violations = float(row.get("violation_rate", 1.0))
            except (TypeError, ValueError):
                continue
            if violations > violation_budget or rate <= 0.0:
                continue
            if best is None or rate > float(best.get("goodput_rps", 0.0)):
                best = row
        if best is None:
            raise ValueError(
                f"{path}: no row within violation budget "
                f"{violation_budget:g}")
        return cls(
            goodput_rps=float(best["goodput_rps"]),
            p99_ms=float(best.get("p99_ms") or 0.0),
            slo_ms=float(best.get("slo_ms")
                         or data.get("slo_ms") or 0.0),
            chips=int(best.get("chips") or 1),
            placement=str(best.get("placement") or "shared"),
            precision=precision,
            source=str(path),
        )

    @classmethod
    def resolve(cls, configured_path: str = "",
                *, root: str | Path = ".") -> "CapacityModel":
        """The planner's boot-time fit: the configured load-bench path,
        else the conservative default. ``root`` is taken for the JAX
        signature and not read: the repository's own LOADBENCH.json and
        PALLASBENCH.json are TPU figures, not this card's."""
        del root
        if configured_path.strip():
            try:
                return cls.from_loadbench(configured_path)
            except (OSError, ValueError, KeyError) as exc:
                log.warning("capacity fit from %s failed (%s): planning "
                            "with the default %.1f rps", configured_path,
                            exc, DEFAULT_GOODPUT_RPS)
        return cls(goodput_rps=DEFAULT_GOODPUT_RPS)


# -- demand ------------------------------------------------------------------


def parse_federate_rollups(text: str) -> dict:
    """Pull the planner's demand inputs out of a ``GET /federate``
    exposition payload: summed per-model arrival rate
    (``rdp_fleet_model_arrival_rate``), the max-burn roll-up
    (``rdp_fleet_burn{stat="max"}``), and the live-member gauge. Tolerant
    of missing families (a cold front-end federates before any scrape)."""
    demand = 0.0
    burn_max = 0.0
    live = None
    rates: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name = m.group("name")
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
        if name == families.FLEET_MODEL_ARRIVAL_RATE:
            model = labels.get("model", "")
            rates[model] = rates.get(model, 0.0) + value
        elif name == families.FLEET_BURN and labels.get("stat") == "max":
            burn_max = max(burn_max, value)
        elif name == families.FLEET_REPLICAS_LIVE and "replica" not in labels:
            live = int(value)
    demand = sum(rates.values())
    return {"demand_rps": demand, "burn_max": burn_max,
            "live": live, "rates": rates}


# -- the plan ----------------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    """One planning verdict: the cheapest config meeting the target SLO
    at the observed demand, and how it compares to what is running."""

    target_replicas: int
    live_replicas: int
    demand_rps: float
    burn_max: float
    per_replica_rps: float
    headroom: float
    chips: int
    precision: str
    dispatch_mode: str
    window_ms: float
    recommendation: str  # "scale_up" | "scale_down" | "hold"
    reason: str

    def to_dict(self) -> dict:
        return {
            "target_replicas": self.target_replicas,
            "live_replicas": self.live_replicas,
            "demand_rps": round(self.demand_rps, 3),
            "burn_max": round(self.burn_max, 3),
            "per_replica_rps": round(self.per_replica_rps, 3),
            "headroom": self.headroom,
            "chips": self.chips,
            "precision": self.precision,
            "dispatch_mode": self.dispatch_mode,
            "window_ms": self.window_ms,
            "recommendation": self.recommendation,
            "reason": self.reason,
        }


def plan(demand_rps: float, live_replicas: int, *,
         capacity: CapacityModel, headroom: float = 0.7,
         burn_max: float = 0.0, min_replicas: int = 1,
         max_replicas: int = 4, window_ms: float = 2.0) -> Plan:
    """The planner's arithmetic, journaled and gauged. ``headroom`` is
    the utilization ceiling: capacity is derated so the plan leaves
    burst room (0.7 = plan to run at 70% of measured goodput). A burning
    fleet (``burn_max >= 1``: the SLO error budget is spent) forces at
    least one replica of growth even when the arrival-rate arithmetic
    says the fleet is big enough -- demand says "fits", the SLO says
    "doesn't", and the SLO is the contract."""
    headroom = min(max(headroom, 0.05), 1.0)
    sustainable = max(capacity.goodput_rps * headroom, 1e-9)
    needed = max(1, math.ceil(demand_rps / sustainable)) if demand_rps > 0 \
        else min_replicas
    reason = (f"demand {demand_rps:.1f} rps / "
              f"({capacity.goodput_rps:.1f} rps x {headroom:g} headroom)")
    if burn_max >= 1.0 and needed <= live_replicas:
        needed = live_replicas + 1
        reason = (f"burn {burn_max:.2f} >= 1: error budget spent, "
                  "growing past the demand fit")
    target = min(max(needed, min_replicas), max_replicas)
    if target != needed:
        reason += f"; clamped to [{min_replicas}, {max_replicas}]"
    if target > live_replicas:
        recommendation = "scale_up"
    elif target < live_replicas:
        recommendation = "scale_down"
    else:
        recommendation = "hold"
    verdict = Plan(
        target_replicas=target,
        live_replicas=live_replicas,
        demand_rps=demand_rps,
        burn_max=burn_max,
        per_replica_rps=capacity.goodput_rps,
        headroom=headroom,
        chips=capacity.chips,
        precision=capacity.precision,
        dispatch_mode=capacity.placement,
        window_ms=window_ms,
        recommendation=recommendation,
        reason=reason,
    )
    obs.PLANNER_PLANS.labels(recommendation=recommendation).inc()
    obs.PLANNER_TARGET_REPLICAS.set(target)
    journal_lib.JOURNAL.append(
        events.PLANNER_PLAN, target=target, live=live_replicas,
        demand_rps=f"{demand_rps:.3f}", burn_max=f"{burn_max:.3f}",
        recommendation=recommendation, reason=reason,
    )
    return verdict


# -- the actuator ------------------------------------------------------------


class Autoscaler:
    """The reactive controller's hysteresis around the planner's recommendation: a non-hold
    recommendation must hold ``sustain_s`` before it becomes an action,
    and after ANY action the scaler sleeps ``cooldown_s``. Pure
    decision-making (no I/O): :meth:`decide` maps (plan, now) to one of
    ``scale_up`` / ``scale_down`` / ``hold_sustain`` / ``hold_cooldown``
    / ``hold_bounds`` / ``hold``, counting every verdict."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 sustain_s: float = 5.0, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.sustain_s = max(0.0, float(sustain_s))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._clock = clock
        self._pending = ""  # the recommendation being sustained
        self._pending_since = 0.0
        self._last_action_at = -math.inf
        self.actions_total = 0

    def decide(self, verdict: Plan) -> str:
        now = self._clock()
        rec = verdict.recommendation
        action = "hold"
        if rec == "hold":
            self._pending = ""
        elif now - self._last_action_at < self.cooldown_s:
            # post-action quiet period: signals are observed (the
            # pending clock keeps running) but nothing fires
            action = "hold_cooldown"
            if rec != self._pending:
                self._pending = rec
                self._pending_since = now
        elif ((rec == "scale_up"
               and verdict.live_replicas >= self.max_replicas)
              or (rec == "scale_down"
                  and verdict.live_replicas <= self.min_replicas)):
            action = "hold_bounds"
            self._pending = ""
        elif rec != self._pending:
            self._pending = rec
            self._pending_since = now
            action = "hold_sustain"
        elif now - self._pending_since < self.sustain_s:
            action = "hold_sustain"
        else:
            action = rec
            self._pending = ""
            self._last_action_at = now
            self.actions_total += 1
        obs.AUTOSCALER_ACTIONS.labels(action=action).inc()
        return action


class ElasticSupervisor:
    """The loop that closes the plan: observe -> plan -> decide -> act.

    Side effects are injected so the whole loop runs against fakes:

    - ``observe()`` -> dict with ``demand_rps``, ``burn_max``, ``live``
      (the front-end supplies the /federate roll-ups + router live
      count);
    - ``scale_up()`` -> str description (spawn ONE self-registering
      replica; its lease registration is what admits it);
    - ``pick_drain()`` -> endpoint of the least-loaded drainable member
      (None = nothing eligible);
    - ``scale_down(endpoint)`` (send the Drain RPC / retire the
      process once idle).

    Every action is journaled (``autoscaler.action``), counted by the
    :class:`Autoscaler`, and pinned in the flight recorder -- incident
    timelines must show why the fleet changed shape."""

    def __init__(self, *, observe: Callable[[], dict],
                 scale_up: Callable[[], str],
                 scale_down: Callable[[str], None],
                 pick_drain: Callable[[], str | None],
                 capacity: CapacityModel | None = None,
                 autoscaler: Autoscaler | None = None,
                 headroom: float = 0.7, window_ms: float = 2.0,
                 poll_s: float = 1.0,
                 flight_recorder: recorder_lib.FlightRecorder | None = None):
        self._observe = observe
        self._scale_up = scale_up
        self._scale_down = scale_down
        self._pick_drain = pick_drain
        self.capacity = capacity or CapacityModel.default()
        self.autoscaler = autoscaler or Autoscaler()
        self.headroom = headroom
        self.window_ms = window_ms
        self.poll_s = max(0.05, float(poll_s))
        self.recorder = (flight_recorder if flight_recorder is not None
                         else recorder_lib.RECORDER)
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self.last_plan: Plan | None = None
        self.last_action = ""
        self.ticks = 0

    # -- one evaluation -------------------------------------------------------

    def tick(self) -> dict:
        """One observe->plan->decide->act pass (public: tests and the
        smoke tool drive the loop deterministically without the
        thread). Returns the tick's full story."""
        observed = self._observe()
        live = int(observed.get("live") or 0)
        verdict = plan(
            float(observed.get("demand_rps") or 0.0), live,
            capacity=self.capacity, headroom=self.headroom,
            burn_max=float(observed.get("burn_max") or 0.0),
            min_replicas=self.autoscaler.min_replicas,
            max_replicas=self.autoscaler.max_replicas,
            window_ms=self.window_ms,
        )
        action = self.autoscaler.decide(verdict)
        detail = ""
        if action == "scale_up":
            detail = self._act(action, verdict, self._scale_up)
        elif action == "scale_down":
            target = self._pick_drain()
            if target is None:
                action = "hold"
                detail = "no drainable member"
                obs.AUTOSCALER_ACTIONS.labels(action=action).inc()
            else:
                detail = self._act(
                    action, verdict,
                    lambda: (self._scale_down(target), target)[1])
        self.last_plan = verdict
        self.last_action = action
        self.ticks += 1
        return {"plan": verdict.to_dict(), "action": action,
                "detail": detail}

    def _act(self, action: str, verdict: Plan,
             effect: Callable[[], str]) -> str:
        """Run one actuation with full evidence: journal entry, pinned
        flight-recorder timeline, and the failure path journaled too
        (a spawn that dies must be visible, not retried silently)."""
        tl = recorder_lib.Timeline(
            events.AUTOSCALER_ACTION,
            labels={"action": action,
                    "target": str(verdict.target_replicas)})
        start_ns = time.monotonic_ns()
        span = tl.span("autoscale", start_ns=start_ns, action=action,
                       reason=verdict.reason)
        try:
            detail = str(effect() or "")
        except Exception as exc:  # noqa: BLE001 - journal, don't crash
            detail = f"failed: {exc}"
            tl.fail(detail)
            log.exception("autoscaler %s failed", action)
        span.end(time.monotonic_ns())
        self.recorder.pin(self.recorder.record(tl))
        journal_lib.JOURNAL.append(
            events.AUTOSCALER_ACTION, action=action,
            target=str(verdict.target_replicas),
            live=str(verdict.live_replicas), detail=detail,
            reason=verdict.reason,
        )
        log.info("autoscaler: %s (%s) -> %s", action, verdict.reason,
                 detail or "ok")
        return detail

    def snapshot(self) -> dict:
        return {
            "enabled": True,
            "ticks": self.ticks,
            "actions_total": self.autoscaler.actions_total,
            "last_action": self.last_action,
            "last_plan": (self.last_plan.to_dict()
                          if self.last_plan is not None else None),
            "capacity": {
                "goodput_rps": self.capacity.goodput_rps,
                "chips": self.capacity.chips,
                "placement": self.capacity.placement,
                "precision": self.capacity.precision,
                "source": self.capacity.source,
            },
        }

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.tick()
                except Exception:  # pragma: no cover - keep planning
                    log.exception("autoscaler tick failed")

        self._thread = threading.Thread(
            target=loop, name="fleet-autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
