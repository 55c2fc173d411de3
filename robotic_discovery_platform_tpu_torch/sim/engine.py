"""The discrete-event core of the fleet's twin, the port's copy of the JAX
package's ``sim/engine.py``: virtual clock, event queue, deterministic
log.

The simulator rests on three properties this module owns:

- **One time source.** :class:`VirtualClock` is the injectable-clock
  protocol every control object of the port takes (``Callable[[],
  float]`` returning monotonic seconds), so the twin hands
  ``engine.clock`` to ``ReactiveController``, ``CircuitBreaker``,
  ``FleetRouter``, ``LeaseRegistry``, ``Autoscaler``, ``ZooPlacer`` and
  ``RolloutManager`` and they run unmodified on virtual time.
- **One randomness source.** A single seeded ``random.Random`` drawn in
  event order: same seed, same draws, same schedule.
- **Re-entrant time advance.** ``RolloutManager.run_cycle`` calls its
  injected ``sleep(dt)`` from inside what is, here, an event handler, so
  :meth:`Engine.sleep` re-enters :meth:`Engine.run_until`: the nested run
  processes every event due in the slept window, as if the manager's
  thread were blocked while the world moved on. The clock never rewinds:
  an event popped at a time the nested run already passed runs at the
  current, later, instant.

The log: :class:`SimLog` records ``(virtual_time, kind, sorted-attrs)``
lines for the twin's own records and for every journal event the real
components append to the port's ``observability/journal.JOURNAL``
(drained after each handler and stamped with virtual time; ``seq``,
``unix_ts``, ``host`` and ``trace_id`` are dropped, being wall-clock or
process-random). Two runs with the same seed and scenario give
byte-identical ``SimLog.text()``, and the same text as the JAX package's
twin (``tests/test_torch_port_sim.py``).
"""

from __future__ import annotations

import heapq
import json
import random
from dataclasses import dataclass, field
from typing import Any, Callable

from robotic_discovery_platform_tpu_torch.observability import (
    journal as journal_lib,
)


class VirtualClock:
    """Monotonic virtual seconds; the injectable-clock protocol."""

    __slots__ = ("t",)

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t


class SimLog:
    """Append-only deterministic event log on virtual time.

    Captures two streams into one causally ordered text log: sim-native
    records (arrivals, completions, faults -- whatever callers
    :meth:`emit`) and the structured journal events the REAL control
    objects append while the sim drives them. The journal capture is
    cursor-based (``events_since``), drained after every handler so each
    journal event lands at the virtual instant of the handler that
    caused it.
    """

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self.lines: list[str] = []
        self._cursor = self._journal_cursor()

    @staticmethod
    def _journal_cursor() -> int:
        events = journal_lib.JOURNAL.events_since(0)
        return events[-1].seq + 1 if events else 0

    def emit(self, kind: str, **attrs: Any) -> None:
        self.lines.append("%.6f %s %s" % (
            self._clock(), kind,
            json.dumps(attrs, sort_keys=True, default=str)))

    def drain_journal(self) -> None:
        """Fold journal events appended since the last drain into the
        log, re-stamped with virtual time. Dropped fields (seq, unix_ts,
        host, trace_id) are the wall-clock / process-random ones; kind,
        message, role and attrs are decision outputs of the clocked
        control law and therefore deterministic."""
        # O(1) fast path: the engine drains after EVERY handler, but
        # journal appends are rare (membership/planner decisions, not
        # frames). Peeking the ring's tail seq is safe single-threaded
        # and skips the O(ring) events_since scan when nothing landed.
        ring = journal_lib.JOURNAL._events
        if not ring or ring[-1].seq < self._cursor:
            return
        events = journal_lib.JOURNAL.events_since(self._cursor)
        if not events:
            return
        self._cursor = events[-1].seq + 1
        for ev in events:
            payload = dict(ev.attrs)
            if ev.message:
                payload["message"] = ev.message
            if ev.role:
                payload["role"] = ev.role
            self.lines.append("%.6f journal:%s %s" % (
                self._clock(), ev.kind,
                json.dumps(payload, sort_keys=True, default=str)))

    def text(self) -> str:
        return "\n".join(self.lines) + ("\n" if self.lines else "")


@dataclass(order=True)
class _Scheduled:
    t: float
    seq: int
    fn: Callable[[], None] = field(compare=False)


class Engine:
    """Seeded priority-queue event loop on a :class:`VirtualClock`.

    Ties at the same virtual instant run in scheduling order (the
    monotone ``seq``), so the event order -- and with it every RNG draw
    and every journal line -- is a pure function of (seed, scenario).
    """

    def __init__(self, seed: int = 0, start: float = 0.0):
        self.clock = VirtualClock(start)
        self.rng = random.Random(seed)
        self.seed = seed
        self.log = SimLog(self.clock)
        self._heap: list[_Scheduled] = []
        self._seq = 0
        self.events_run = 0

    def now(self) -> float:
        return self.clock.t

    # -- scheduling ----------------------------------------------------------

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Run ``fn`` at virtual time ``t`` (clamped to now: the past is
        immutable, a late event runs at the current instant)."""
        heapq.heappush(
            self._heap, _Scheduled(max(float(t), self.clock.t),
                                   self._seq, fn))
        self._seq += 1

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.clock.t + max(0.0, float(dt)), fn)

    def every(self, period_s: float, fn: Callable[[], None], *,
              start_in_s: float | None = None,
              while_fn: Callable[[], bool] | None = None) -> None:
        """Periodic event; stops rescheduling once ``while_fn`` (checked
        before each run) returns False."""
        period_s = max(1e-6, float(period_s))

        def tick() -> None:
            if while_fn is not None and not while_fn():
                return
            fn()
            self.after(period_s, tick)

        self.after(period_s if start_in_s is None else start_in_s, tick)

    # -- time advance --------------------------------------------------------

    def run_until(self, t_end: float) -> None:
        """Process every event due at or before ``t_end``, then land the
        clock exactly on ``t_end``. Reentrant: a handler that calls
        :meth:`sleep` advances the world from within, and this loop's
        remaining iterations simply find their events already run."""
        while self._heap and self._heap[0].t <= t_end:
            ev = heapq.heappop(self._heap)
            # never rewind: a nested advance may already have passed ev.t
            if ev.t > self.clock.t:
                self.clock.t = ev.t
            ev.fn()
            self.events_run += 1
            self.log.drain_journal()
        if t_end > self.clock.t:
            self.clock.t = t_end

    def sleep(self, dt: float) -> None:
        """The injectable ``sleep`` for components (RolloutManager) that
        block synchronously: the world keeps moving while they 'wait'."""
        self.run_until(self.clock.t + max(0.0, float(dt)))
