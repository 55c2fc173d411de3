"""Scenario layer: scripted faults and traffic shaping over a SimFleet
(the port's copy of the JAX package's ``sim/scenario.py``).

A scenario is an ordered list of ``(t, kind, args)`` directives applied
to the fleet when the virtual clock reaches ``t`` -- the fault menu the
chaos-drill harness exercises live, here made deterministic and
composable:

- ``kill_replicas`` / ``restart_replicas`` -- replica SIGKILL and
  recovery, optionally correlated (n at one instant = a rack loss).
- ``kill_frontend`` / ``restart_frontend`` -- registrar loss; restart
  rebuilds an EMPTY lease table and takes the boot-time gossip seed.
- ``lease_expire`` -- force-expire a replica's lease on every live
  registrar without touching the process (the network-partition shape).
- ``chip_quarantine`` -- n chips out per replica for a duration
  (capacity loss without membership loss).
- ``brownout`` -- multiply service times by ``scale`` for a duration
  (the slow-decode / thermal-throttle shape).
- ``ramp`` -- add a deterministic extra arrival schedule (traffic
  surge), pre-merged into the run's schedule so determinism holds.
- ``drift_rec`` -- deliver a drift recommendation: one full rollout
  cycle (drain, retrain, shadow, gate, promote) runs reentrantly.

Scenarios build programmatically (:meth:`Scenario.kill_replicas` etc.,
all chainable) or from a JSON-able spec (:meth:`Scenario.from_spec`) so
sweep grids can be declared as data.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any


class _Rec:
    """A drift recommendation: just the (reason, signals) surface
    RolloutManager.run_cycle reads."""

    def __init__(self, reason: str = "sim-drift", signals=("psi",)):
        self.reason = reason
        self.signals = list(signals)


@dataclass(order=True)
class ScenarioEvent:
    t: float
    seq: int
    kind: str = field(compare=False)
    args: dict[str, Any] = field(compare=False, default_factory=dict)


class Scenario:
    """An ordered fault/traffic script. ``apply(fleet, engine)`` arms
    every directive on the engine; the directives then fire in virtual
    time against the live fleet."""

    def __init__(self, name: str = "scenario"):
        self.name = name
        self.events: list[ScenarioEvent] = []
        self._seq = 0

    #: the directive vocabulary from_spec accepts -- ONLY builders, so
    #: a spec can never dispatch to apply()/_fire()/anything else
    KINDS = frozenset({
        "kill_replicas", "restart_replicas", "kill_frontend",
        "restart_frontend", "lease_expire", "chip_quarantine",
        "brownout", "ramp", "drift_rec",
    })

    # -- builders (chainable) ------------------------------------------------

    def _add(self, t: float, kind: str, **args: Any) -> "Scenario":
        self.events.append(ScenarioEvent(float(t), self._seq, kind, args))
        self._seq += 1
        return self

    def kill_replicas(self, t: float, n: int = 1) -> "Scenario":
        """SIGKILL ``n`` live replicas at ``t`` (one instant: the
        correlated-failure shape)."""
        return self._add(t, "kill_replicas", n=int(n))

    def restart_replicas(self, t: float, n: int = 1) -> "Scenario":
        return self._add(t, "restart_replicas", n=int(n))

    def kill_frontend(self, t: float, idx: int = 0) -> "Scenario":
        return self._add(t, "kill_frontend", idx=int(idx))

    def restart_frontend(self, t: float, idx: int = 0) -> "Scenario":
        return self._add(t, "restart_frontend", idx=int(idx))

    def lease_expire(self, t: float, n: int = 1) -> "Scenario":
        return self._add(t, "lease_expire", n=int(n))

    def chip_quarantine(self, t: float, chips: int = 1,
                        duration_s: float = 10.0,
                        n_replicas: int = 1) -> "Scenario":
        return self._add(t, "chip_quarantine", chips=int(chips),
                         duration_s=float(duration_s),
                         n_replicas=int(n_replicas))

    def brownout(self, t: float, scale: float = 3.0,
                 duration_s: float = 10.0,
                 n_replicas: int = 0) -> "Scenario":
        """Service-time multiplier for ``duration_s``; ``n_replicas=0``
        means fleet-wide."""
        return self._add(t, "brownout", scale=float(scale),
                         duration_s=float(duration_s),
                         n_replicas=int(n_replicas))

    def ramp(self, t: float, rate_hz: float = 40.0,
             duration_s: float = 10.0, model: str = "seg",
             seed: int = 1) -> "Scenario":
        """Extra Poisson traffic on top of the base schedule, drawn from
        its OWN seeded stream so the base schedule's draws are
        untouched (determinism composes)."""
        return self._add(t, "ramp", rate_hz=float(rate_hz),
                         duration_s=float(duration_s), model=model,
                         seed=int(seed))

    def drift_rec(self, t: float, reason: str = "sim-drift") -> "Scenario":
        return self._add(t, "drift_rec", reason=reason)

    # -- data form -----------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: dict | list) -> "Scenario":
        """Build from JSON-able data: either a bare list of event dicts
        or ``{"name": ..., "events": [{"t": ..., "kind": ..., **args}]}``.
        Unknown kinds raise at build time, not at t."""
        if isinstance(spec, dict):
            name = str(spec.get("name") or "scenario")
            events = spec.get("events") or []
        else:
            name, events = "scenario", spec
        sc = cls(name)
        for ev in events:
            ev = dict(ev)
            t = float(ev.pop("t"))
            kind = str(ev.pop("kind"))
            if kind not in cls.KINDS:
                raise ValueError(f"unknown scenario kind: {kind!r}")
            getattr(sc, kind)(t, **ev)
        return sc

    def to_spec(self) -> dict:
        return {"name": self.name,
                "events": [{"t": ev.t, "kind": ev.kind, **ev.args}
                           for ev in sorted(self.events)]}

    # -- application ---------------------------------------------------------

    def apply(self, fleet, engine) -> None:
        for ev in sorted(self.events):
            if ev.kind == "ramp":
                # traffic shaping happens at schedule-build time: the
                # extra arrivals merge into the run's schedule before
                # the feeder starts, keeping one arrival stream
                rng = random.Random(ev.args["seed"])
                extra: list[tuple[float, str]] = []
                t = ev.t + rng.expovariate(ev.args["rate_hz"])
                while t < ev.t + ev.args["duration_s"]:
                    extra.append((t, ev.args["model"]))
                    t += rng.expovariate(ev.args["rate_hz"])
                fleet.extra_schedules.append(extra)
                continue
            engine.at(ev.t, lambda e=ev: self._fire(fleet, engine, e))

    def _fire(self, fleet, engine, ev: ScenarioEvent) -> None:
        engine.log.emit("scenario." + ev.kind, name=self.name, **ev.args)
        getattr(self, "_do_" + ev.kind)(fleet, engine, ev.args)

    # -- directive implementations (deterministic victim order:
    # sorted endpoint, no rng consumed) --------------------------------------

    @staticmethod
    def _live_sorted(fleet):
        return sorted(fleet.live_replicas(), key=lambda r: r.endpoint)

    def _do_kill_replicas(self, fleet, engine, args) -> None:
        for r in self._live_sorted(fleet)[:args["n"]]:
            r.kill()

    def _do_restart_replicas(self, fleet, engine, args) -> None:
        dead = sorted((r for r in fleet.replicas.values()
                       if not r.alive and not r.retired),
                      key=lambda r: r.endpoint)
        for r in dead[:args["n"]]:
            r.restart()

    def _do_kill_frontend(self, fleet, engine, args) -> None:
        idx = args["idx"]
        if 0 <= idx < len(fleet.frontends):
            fleet.frontends[idx].kill()

    def _do_restart_frontend(self, fleet, engine, args) -> None:
        idx = args["idx"]
        if 0 <= idx < len(fleet.frontends) and \
                not fleet.frontends[idx].alive:
            fleet.frontends[idx].restart()

    def _do_lease_expire(self, fleet, engine, args) -> None:
        victims = self._live_sorted(fleet)[:args["n"]]
        for fe in fleet.frontends:
            if not fe.alive:
                continue
            for r in victims:
                try:
                    fe.registry.force_expire(r.endpoint)
                except KeyError:
                    pass

    def _do_chip_quarantine(self, fleet, engine, args) -> None:
        victims = self._live_sorted(fleet)[:max(1, args["n_replicas"])]
        for r in victims:
            r.chips_down = min(r.chips, r.chips_down + args["chips"])

        def lift() -> None:
            for r in victims:
                r.chips_down = max(0, r.chips_down - args["chips"])
                r._pump()
            engine.log.emit("scenario.chip_quarantine_lifted",
                            name=self.name)

        engine.after(args["duration_s"], lift)

    def _do_brownout(self, fleet, engine, args) -> None:
        live = self._live_sorted(fleet)
        victims = live if not args["n_replicas"] \
            else live[:args["n_replicas"]]
        for r in victims:
            r.brownout_scale *= args["scale"]

        def lift() -> None:
            for r in victims:
                r.brownout_scale /= args["scale"]
            engine.log.emit("scenario.brownout_lifted", name=self.name)

        engine.after(args["duration_s"], lift)

    def _do_drift_rec(self, fleet, engine, args) -> None:
        cycle = fleet.rollout.run_cycle(_Rec(reason=args["reason"]))
        engine.log.emit("scenario.rollout_cycle",
                        outcome=cycle.get("outcome"),
                        replica=cycle.get("replica"))
