"""Closed / open / half-open circuit breaker.

Protects a caller from a *sustained* dependency outage: after
``failure_threshold`` consecutive failures the breaker opens and callers
fast-fail (``CircuitOpenError``) without touching the dependency at all;
after ``reset_timeout_s`` one half-open probe is let through -- success
closes the breaker, failure re-opens it for another full timeout.

State transitions are logged exactly once each, which is what replaces the
old module-global rate-limited "registry unreachable" warning in
serving/server.py: during an outage the log carries one open transition
(with the triggering error) instead of either a 60-s-throttled global or a
warning per poll tick.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock
from robotic_discovery_platform_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Injectable transition observer: (breaker_name, old_state | None, new_state).
# observability.instruments installs one that drives the rdp_breaker_state
# gauge and transition counter; this module stays import-clean of
# observability (resilience sits below everything, including its logging).
# Called with old_state=None once per breaker at construction so the gauge
# exists before any transition. Invoked while the breaker lock is held --
# observers must not call back into the breaker.
_observer: Callable[[str, str | None, str], None] | None = None


def set_observer(fn: Callable[[str, str | None, str], None] | None) -> None:
    global _observer
    _observer = fn


def _notify(name: str, old: str | None, new: str) -> None:
    if _observer is None:
        return
    try:
        _observer(name, old, new)
    except Exception:  # an observability bug must never break the breaker
        log.exception("breaker transition observer failed")


class CircuitOpenError(RuntimeError):
    """The breaker is open; the protected call was not attempted."""

    def __init__(self, name: str, retry_in_s: float):
        super().__init__(
            f"circuit {name!r} is open; next probe in {retry_in_s:.1f}s"
        )
        self.name = name
        self.retry_in_s = retry_in_s


class CircuitBreaker:
    """Thread-safe breaker; ``clock`` is injectable for deterministic
    tests (no real waiting for the reset timeout)."""

    def __init__(self, *, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 name: str = "breaker",
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = checked_lock(f"breaker.{name}")
        self._state = CLOSED  # guarded_by: _lock
        self._failures = 0  # guarded_by: _lock
        self._opened_at = 0.0  # guarded_by: _lock
        self._probe_in_flight = False  # guarded_by: _lock
        self._probe_started_at = 0.0  # guarded_by: _lock
        self._last_error: BaseException | None = None  # guarded_by: _lock
        _notify(self.name, None, self._state)

    # -- state --------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def failure_count(self) -> int:
        with self._lock:
            return self._failures

    @property
    def last_error(self) -> BaseException | None:
        with self._lock:
            return self._last_error

    def _maybe_half_open(self) -> None:  # guarded_by: _lock
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = HALF_OPEN
            self._probe_in_flight = False
            log.info("circuit %r: open -> half_open (probing)", self.name)
            _notify(self.name, OPEN, HALF_OPEN)
        elif (self._state == HALF_OPEN
                and self._probe_in_flight
                and self._clock() - self._probe_started_at
                >= self.reset_timeout_s):
            # the admitted probe never reported back (its caller died or
            # hung): without this, half_open wedges forever because
            # allow() admits at most one probe at a time. A dead probe
            # is a failed probe -- re-open and retry on the next window.
            self._trip("half-open probe timed out", None)

    def allow(self) -> bool:
        """True when a call may proceed now. In half-open state exactly one
        probe is admitted at a time; its outcome decides the next state."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                self._probe_started_at = self._clock()
                return True
            return False

    def retry_in_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(
                0.0,
                self.reset_timeout_s - (self._clock() - self._opened_at),
            )

    # -- outcome reporting ---------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            if self._state != CLOSED:
                log.info("circuit %r: %s -> closed (dependency recovered)",
                         self.name, self._state)
                _notify(self.name, self._state, CLOSED)
            self._state = CLOSED
            self._failures = 0
            self._probe_in_flight = False
            self._last_error = None

    def record_failure(self, exc: BaseException | None = None) -> None:
        with self._lock:
            self._failures += 1
            self._last_error = exc
            if self._state == HALF_OPEN:
                self._trip("half-open probe failed", exc)
            elif (self._state == CLOSED
                    and self._failures >= self.failure_threshold):
                self._trip(f"{self._failures} consecutive failures", exc)

    def _trip(self, why: str, exc: BaseException | None) -> None:  # guarded_by: _lock
        old = self._state
        self._state = OPEN
        self._opened_at = self._clock()
        self._probe_in_flight = False
        log.warning(
            "circuit %r: -> open (%s%s); fast-failing for %.1fs",
            self.name, why,
            f"; last error {type(exc).__name__}: {exc}" if exc else "",
            self.reset_timeout_s,
        )
        _notify(self.name, old, OPEN)

    # -- call wrapper --------------------------------------------------------

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under the breaker: raise ``CircuitOpenError`` without
        calling when open, otherwise record the outcome."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_in_s())
        try:
            result = fn()
        except BaseException as exc:
            self.record_failure(exc)
            raise
        self.record_success()
        return result
