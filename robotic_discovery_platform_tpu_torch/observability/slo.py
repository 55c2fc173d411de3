"""Latency SLOs: objectives, violation counting, error-budget burn.

Production serving is judged on tail latency against an objective, not on
mean FPS (InferLine's SLO-driven planning, Clockwork's predictable-tail
argument -- PAPERS.md). This module turns the platform's per-frame
latency stream into the two signals an SLO consumer (dashboard, alert, or
the ROADMAP's adaptive scheduler) actually wants:

- ``rdp_slo_violations_total`` -- frames that missed the objective (too
  slow, or failed outright: an errored frame never met its SLO);
- ``rdp_slo_error_budget_burn`` -- the violating fraction over a sliding
  window divided by the budgeted fraction. Burn 1.0 means the budget is
  being spent exactly as fast as allowed; sustained burn > 1 means the
  objective will be breached -- that gauge crossing 1 is the scheduler's
  retune trigger.

Like the resilience package, this module stays import-clean of the
metrics registry: trackers take injected counter/gauge children
(observability.instruments owns the ``rdp_slo_*`` families and the
serving layer wires them), so it is usable from tests and tools without
touching process-global state.

``ServerConfig.slo_ms`` sets the objective (0 = tracking off);
``RDP_SLO_MS`` overrides it.
"""

from __future__ import annotations

import os
import threading
from collections import deque

_SLO_ENV_VAR = "RDP_SLO_MS"


def resolve_slo_ms(configured: float) -> float | None:
    """The effective latency objective in milliseconds: ``RDP_SLO_MS``
    when set, else the configured value; None (tracking disabled) when
    the result is not positive."""
    raw = os.environ.get(_SLO_ENV_VAR, "").strip()
    value = float(raw) if raw else float(configured)
    return value if value > 0 else None


class SloTracker:
    """One latency objective, observed per frame.

    Args:
        objective_s: the latency objective in seconds.
        budget: the fraction of frames ALLOWED to violate (error budget);
            burn is the measured violating fraction divided by this.
        window: sliding-window length (frames) for the burn estimate --
            recent enough to react to a regression, long enough not to
            flap on one slow frame.
        violations / burn_gauge / objective_gauge: injected metric
            children (labeled Counter/Gauge children or None).
    """

    def __init__(self, objective_s: float, budget: float = 0.01,
                 window: int = 512, name: str = "e2e",
                 violations=None, burn_gauge=None, objective_gauge=None):
        if objective_s <= 0:
            raise ValueError(f"objective must be positive, got {objective_s}")
        self.objective_s = float(objective_s)
        self.budget = max(1e-9, float(budget))
        self.name = name
        self._window: deque[bool] = deque(maxlen=max(1, int(window)))
        self._lock = threading.Lock()
        self._violations_total = 0
        self._observed_total = 0
        self._violations = violations
        self._burn_gauge = burn_gauge
        if objective_gauge is not None:
            objective_gauge.set(self.objective_s)

    def observe(self, latency_s: float, ok: bool = True) -> bool:
        """Record one frame; returns whether it violated the objective.
        A failed frame (``ok=False``) always counts as a violation --
        shedding or erroring a frame does not meet its SLO."""
        violated = (not ok) or (latency_s > self.objective_s)
        with self._lock:
            self._window.append(violated)
            self._observed_total += 1
            if violated:
                self._violations_total += 1
            burn = (sum(self._window) / len(self._window)) / self.budget
        if violated and self._violations is not None:
            self._violations.inc()
        if self._burn_gauge is not None:
            self._burn_gauge.set(burn)
        return violated

    @property
    def violations_total(self) -> int:
        with self._lock:
            return self._violations_total

    @property
    def observed_total(self) -> int:
        with self._lock:
            return self._observed_total

    @property
    def violation_rate(self) -> float:
        """Violating fraction over the sliding window (0 when empty)."""
        with self._lock:
            if not self._window:
                return 0.0
            return sum(self._window) / len(self._window)

    @property
    def burn(self) -> float:
        """Error-budget burn rate: window violation rate / budget."""
        return self.violation_rate / self.budget
