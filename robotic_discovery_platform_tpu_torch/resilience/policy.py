"""Retry policy, deadline budget, and transient-error classification.

Everything time-related is injectable (``clock``, ``sleep``, ``rng``) so the
unit tests drive the full backoff schedule with a fake clock and zero real
sleeps -- the same determinism discipline tests/test_supervisor.py
established for the training watchdog.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator


class DeadlineExceeded(TimeoutError):
    """An overall time budget ran out (distinct from a single attempt's
    timeout: a ``Deadline`` spans every retry of a logical operation)."""


# Injectable retry observer: (site_name | None, attempt). Installed by
# observability.instruments (rdp_retry_attempts_total); this module stays
# import-clean of observability. Fired once per *scheduled* retry, right
# before its backoff sleep. Must never raise into the retry loop.
_retry_observer: Callable[[str | None, int], None] | None = None


def set_retry_observer(
    fn: Callable[[str | None, int], None] | None,
) -> None:
    global _retry_observer
    _retry_observer = fn


def _notify_retry(name: str | None, attempt: int) -> None:
    if _retry_observer is None:
        return
    try:
        _retry_observer(name, attempt)
    except Exception:
        pass  # observability must never alter retry behavior


class Deadline:
    """A monotonic time budget. ``Deadline.after(5.0)`` expires 5 s from
    now; ``remaining()`` never goes below 0.0."""

    def __init__(self, expires_at: float,
                 clock: Callable[[], float] = time.monotonic):
        self._expires_at = expires_at
        self._clock = clock

    @classmethod
    def after(cls, budget_s: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + budget_s, clock)

    def remaining(self) -> float:
        return max(0.0, self._expires_at - self._clock())

    def expired(self) -> bool:
        return self._clock() >= self._expires_at

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(f"deadline exceeded during {what}")

    def __repr__(self) -> str:  # diagnostics in retry logs
        return f"Deadline(remaining={self.remaining():.3f}s)"


def default_retryable(exc: BaseException) -> bool:
    """Transient-error classification shared by every retry site.

    Retryable: connection-level failures (builtin ``ConnectionError`` and
    ``TimeoutError``, which ``http.client`` raises), HTTP 429 and
    5xx carried as an integer ``status`` attribute (tracking's
    ``MlflowRestError`` and the fault injector's ``InjectedHTTPError``
    both match without an import cycle), and gRPC UNAVAILABLE.

    Not retryable: a blown overall budget (``DeadlineExceeded``), HTTP 4xx
    other than 429, and anything that looks deterministic.
    """
    if isinstance(exc, DeadlineExceeded):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    status = getattr(exc, "status", None)
    if isinstance(status, int):
        return status == 429 or status >= 500
    try:
        import grpc

        if isinstance(exc, grpc.RpcError) and hasattr(exc, "code"):
            return exc.code() == grpc.StatusCode.UNAVAILABLE
    except ImportError:
        pass
    return False


@dataclass
class RetryPolicy:
    """Jittered exponential backoff.

    ``max_attempts=None`` means retry forever (the camera reconnect loop);
    bounded policies raise the last error once attempts are exhausted. A
    ``Deadline`` passed to :meth:`call` caps the whole retry sequence: a
    retry whose backoff would overshoot the budget re-raises immediately
    instead of sleeping into a guaranteed timeout.
    """

    max_attempts: int | None = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.1  # +/- fraction of each delay
    retryable: Callable[[BaseException], bool] = field(
        default=default_retryable)
    clock: Callable[[], float] = field(default=time.monotonic)
    sleep: Callable[[float], None] = field(default=time.sleep)
    rng: random.Random = field(default_factory=random.Random)

    def delays(self) -> Iterator[float]:
        """The backoff schedule: base * multiplier^k capped at max, each
        entry jittered by +/- ``jitter``. Infinite iterator (callers bound
        it by ``max_attempts`` or their own loop)."""
        delay = self.base_delay_s
        while True:
            jittered = delay
            if self.jitter > 0:
                jittered *= 1.0 + self.rng.uniform(-self.jitter, self.jitter)
            yield max(0.0, jittered)
            delay = min(delay * self.multiplier, self.max_delay_s)

    def call(self, fn: Callable[[], Any], *,
             deadline: Deadline | None = None,
             on_retry: Callable[[int, BaseException, float], None]
             | None = None,
             name: str | None = None) -> Any:
        """Run ``fn`` until it succeeds, a non-retryable error surfaces,
        attempts are exhausted, or the deadline budget cannot fit another
        backoff. Always re-raises the *underlying* error (never a synthetic
        one) so callers keep their existing except clauses. ``name`` labels
        this call site for the process-wide retry observer
        (:func:`set_retry_observer`)."""
        attempt = 0
        schedule = self.delays()
        while True:
            attempt += 1
            try:
                return fn()
            except BaseException as exc:
                if not self.retryable(exc):
                    raise
                if (self.max_attempts is not None
                        and attempt >= self.max_attempts):
                    raise
                delay = next(schedule)
                if deadline is not None and deadline.remaining() <= delay:
                    raise
                _notify_retry(name, attempt)
                if on_retry is not None:
                    on_retry(attempt, exc, delay)
                if delay > 0:
                    self.sleep(delay)
