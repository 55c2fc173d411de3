"""The reactive SLO controller: overload control of one server, the port's
copy of the JAX package's ``serving/controller.py``.

``ServerConfig`` is the static plan; this controller perturbs it online
from the live signals:

- **AIMD in-flight window**: when burn is comfortably low and the backlog
  shows unmet demand, ``max_inflight`` steps up by one toward
  ``inflight_cap``; a sustained burn above ``burn_high`` halves it as
  part of the brownout's first rung.
- **Brownout ladder** (entered on sustained burn above ``burn_high``,
  left symmetrically on sustained burn below ``burn_low``):

  1. halve the batch window and the in-flight window;
  2. shed earlier at admission (the dispatcher's ``deadline_safety``
     rises, so the collector drops frames whose deadline is at risk, not
     only the doomed ones);
  3. refuse new streams (UNAVAILABLE at stream entry, so clients fail
     over). The servicer refuses every other new stream, so the SLO
     signal keeps flowing and the way back down stays reachable.

- **Bucket floor**: a deep backlog raises the padded-bucket floor (bigger
  dispatches when work is always waiting); an empty one lowers it again.
- **round_robin against sharded** (``_tune_mode``) acts on the
  multi-device router, which the port does not have yet (ROADMAP queue 1
  item 14): it does nothing, as the JAX controller does for a router
  that cannot switch modes.

Every decision passes **hysteresis** (burn must hold beyond its threshold
for ``sustain_s``; between ``burn_low`` and ``burn_high`` is a dead band)
and a **cooldown** (at most one action per ``cooldown_s``), so a single
slow frame moves nothing and an overload is answered one rung at a time.

``clock`` is injectable and :meth:`ReactiveController.tick` is the whole
control law, so tests drive it on a fake clock and never sleep;
:meth:`~ReactiveController.start` runs ticks on a daemon thread. The
controller touches host-side scheduling knobs only and holds no device
state, so enabled but idle it changes nothing a frame computes.

Concurrency: the controller holds no lock of its own. Every mutable field
(``level``, the hysteresis timers, the captured base knobs) is written by
the tick thread only (``tick()`` is also what tests call, never together
with ``start()``), and every actuation goes through the dispatcher's
``set_*`` methods, which take the dispatcher's own locks. So the
controller is outside the lock-order graph: it calls into the collector,
completer and watchdog and can never deadlock against them.

``ServerConfig.controller_enabled`` / ``RDP_CONTROLLER`` turn it on;
``serving/server.py`` wires the signals (the SLO tracker's burn and
sample count) and the actuators (the dispatcher's ``set_*`` methods and
the servicer's refuse-streams flag).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from robotic_discovery_platform_tpu_torch.observability import (
    events,
    instruments as obs,
    journal as journal_lib,
)
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_CONTROLLER_ENV_VAR = "RDP_CONTROLLER"

#: brownout ladder depth (level 0 = normal operation)
MAX_LEVEL = 3


def resolve_controller_enabled(configured: bool) -> bool:
    """The controller switch: ``RDP_CONTROLLER`` (1/true/yes/on) when set,
    else the configured value."""
    raw = os.environ.get(_CONTROLLER_ENV_VAR, "").strip().lower()
    if raw:
        return raw in ("1", "true", "yes", "on")
    return bool(configured)


class ReactiveController:
    """One control loop over one dispatcher.

    Args:
        dispatcher: zero-argument callable returning the live
            :class:`~serving.batching.BatchDispatcher` (or None): a hot
            reload replaces the dispatcher under a running controller.
        burn: zero-argument callable returning the error-budget burn
            (``SloTracker.burn``; above 1 the objective is breached).
        refuse_streams: called with True/False when the ladder reaches or
            leaves its top rung; None leaves rung 3 unused.
        interval_s: tick period of the background thread.
        burn_high / burn_low: the hysteresis thresholds around burn = 1.
        sustain_s: how long burn must hold beyond a threshold to count.
        cooldown_s: minimum spacing between actions.
        inflight_cap: AIMD ceiling of ``max_inflight``.
        samples: zero-argument callable returning how many frames the SLO
            tracker has observed; below ``min_samples`` the burn signal
            counts as the dead band (one slow warm-up frame in a near-empty
            window reads as a huge burn).
        clock: injectable monotonic clock.
    """

    def __init__(self, dispatcher: Callable[[], Any],
                 burn: Callable[[], float],
                 refuse_streams: Callable[[bool], None] | None = None,
                 *, interval_s: float = 0.5,
                 burn_high: float = 1.0, burn_low: float = 0.5,
                 sustain_s: float = 1.0, cooldown_s: float = 2.0,
                 inflight_cap: int = 8,
                 samples: Callable[[], int] | None = None,
                 min_samples: int = 32,
                 clock: Callable[[], float] = time.monotonic):
        if burn_low > burn_high:
            raise ValueError(
                f"burn_low ({burn_low}) must not exceed burn_high "
                f"({burn_high}): the dead band between them is the "
                "hysteresis"
            )
        self._dispatcher = dispatcher
        self._burn = burn
        self._refuse_streams = refuse_streams
        self.interval_s = float(interval_s)
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.sustain_s = float(sustain_s)
        self.cooldown_s = float(cooldown_s)
        self.inflight_cap = max(1, int(inflight_cap))
        self._samples = samples
        self.min_samples = int(min_samples)
        self._clock = clock
        #: brownout ladder position (0 = normal); written by the tick
        #: thread only
        self.level = 0
        self.actions_total = 0
        self._high_since: float | None = None
        self._low_since: float | None = None
        self._last_action = float("-inf")
        # the knob values before the brownout, captured at the first
        # escalation so the way down restores what the load found
        self._base_window_ms: float | None = None
        self._base_inflight: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        obs.CONTROLLER_LEVEL.set(0)

    # -- lifecycle --------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="slo-controller", daemon=True)
        self._thread.start()
        log.info(
            "reactive SLO controller started (tick %.2fs, burn thresholds "
            "%.2f/%.2f, cooldown %.1fs)",
            self.interval_s, self.burn_low, self.burn_high, self.cooldown_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # a control fault must not end the loop
                log.exception("controller tick failed; continuing")

    # -- the control law --------------------------------------------------------

    def tick(self) -> str | None:
        """One control evaluation; returns the action taken, or None."""
        now = self._clock()
        d = self._dispatcher()
        burn = self._burn()
        if (self._samples is not None
                and self._samples() < self.min_samples):
            # the window is not filled yet: one slow frame among a handful
            # reads as an enormous burn
            burn = float("nan")  # lands in the dead band below
        # hysteresis bookkeeping: the dead band clears both timers
        if burn > self.burn_high:
            self._low_since = None
            if self._high_since is None:
                self._high_since = now
        elif burn < self.burn_low:
            self._high_since = None
            if self._low_since is None:
                self._low_since = now
        else:
            self._high_since = self._low_since = None
        action = None
        if d is not None and now - self._last_action >= self.cooldown_s:
            sustained_high = (self._high_since is not None
                              and now - self._high_since >= self.sustain_s)
            sustained_low = (self._low_since is not None
                             and now - self._low_since >= self.sustain_s)
            if sustained_high and self.level < MAX_LEVEL:
                action = self._escalate(d)
            elif sustained_low and self.level > 0:
                action = self._deescalate(d)
            elif sustained_low:
                action = self._tune_steady(d)
            if action is not None:
                self._last_action = now
                self.actions_total += 1
                # this excursion got its answer: the signal must sustain
                # again before the next action
                self._high_since = self._low_since = None
                obs.CONTROLLER_ACTIONS.labels(action=action).inc()
                journal_lib.JOURNAL.append(
                    events.CONTROLLER_ACTION, action=action,
                    level=self.level, burn=round(burn, 3))
                log.info("controller action: %s (burn %.2f, level %d)",
                         action, burn, self.level)
        if d is not None:
            obs.CONTROLLER_INFLIGHT.set(d.max_inflight)
            obs.CONTROLLER_WINDOW_MS.set(d.window_ms)
        obs.CONTROLLER_LEVEL.set(self.level)
        return action

    def _set_level(self, new: int) -> None:
        """A rung change: the gauge and a journal entry at the change."""
        old, self.level = self.level, new
        obs.CONTROLLER_LEVEL.set(new)
        journal_lib.JOURNAL.append(events.CONTROLLER_LEVEL, frm=old, to=new)

    def _escalate(self, d) -> str:
        self._set_level(self.level + 1)
        if self.level == 1:
            self._base_window_ms = d.window_ms
            self._base_inflight = d.max_inflight
            d.set_window_ms(max(0.5, d.window_ms / 2))
            d.set_max_inflight(max(1, d.max_inflight // 2))
            return "window_down"
        if self.level == 2:
            d.set_deadline_safety(2.0)
            return "admission_tighten"
        if self._refuse_streams is not None:
            self._refuse_streams(True)
            return "refuse_streams"
        # no stream-refusal hook: rung 3 holds rung 2, shedding harder
        self._set_level(2)
        d.set_deadline_safety(3.0)
        return "admission_tighten"

    def _deescalate(self, d) -> str:
        if self.level == 3:
            self._set_level(2)
            if self._refuse_streams is not None:
                self._refuse_streams(False)
            return "accept_streams"
        if self.level == 2:
            self._set_level(1)
            d.set_deadline_safety(1.0)
            return "admission_relax"
        self._set_level(0)
        if self._base_window_ms is not None:
            d.set_window_ms(self._base_window_ms)
        if self._base_inflight is not None:
            d.set_max_inflight(self._base_inflight)
        return "window_up"

    def _tune_steady(self, d) -> str | None:
        """Level 0 under a healthy burn: more throughput where the backlog
        shows demand, less padding and parallelism where it does not."""
        backlog = d.backlog()
        if backlog > 0 and d.max_inflight < self.inflight_cap:
            d.set_max_inflight(d.max_inflight + 1)
            return "inflight_up"
        mode_action = self._tune_mode(d)
        if mode_action is not None:
            return mode_action
        if backlog >= 2 * d.bucket_floor and backlog >= 2:
            floor = min(d.bucket_floor * 2, d._max_batch)
            if floor != d.bucket_floor:
                d.set_bucket_floor(floor)
                return "floor_up"
        if backlog == 0 and d.bucket_floor > 1:
            d.set_bucket_floor(d.bucket_floor // 2)
            return "floor_down"
        return None

    def _tune_mode(self, d) -> str | None:
        """round_robin against sharded dispatch: the JAX controller flips
        the multi-device router's mode by dispatch occupancy (ROADMAP
        queue 1 item 14). The port's dispatcher has one device and no
        router, so this returns None, as the JAX controller does for a
        router that cannot switch modes."""
        return None
