"""Deadline-aware admission for the batch dispatcher's backlog (the port's
copy of the JAX package's ``serving/admission.py``).

- every queued item carries an absolute ``deadline_t`` (monotonic seconds;
  None = no deadline, infinite headroom);
- :meth:`DeadlineQueue.put` at the cap evicts the queued item with the
  LEAST remaining headroom in favour of the newcomer, but only when the
  newcomer's headroom exceeds the evictee's by a margin (the current
  service-time estimate); otherwise the newcomer is shed;
- :class:`ServiceTimeEstimator` keeps the best-case per-frame service time
  over a sliding window, so the collector can drop frames whose deadline
  is already unmeetable before paying staging and device time for them.

``policy="fifo"`` rejects the newcomer at the cap, never evicts, and sheds
nothing early: position-based shedding.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable

POLICIES = ("deadline", "fifo")


class OverloadedError(RuntimeError):
    """The dispatcher's backlog cap was hit; the frame was shed, not
    queued. Retryable by the client (the server surfaces it as
    RESOURCE_EXHAUSTED)."""


#: the estimator key every legacy (un-keyed) observation lands under
DEFAULT_ESTIMATE_KEY = ("", 0)


class ServiceTimeEstimator:
    """Per-frame service-time estimate (one frame's dispatch ride: host
    staging through completed D2H), as the MINIMUM over a sliding window
    of completed rides. The minimum, not a mean: shedding kills work
    permanently, so the question admission must answer is "could this
    frame make it even under best-case service?" -- and a best-case
    bound is also robust to one-off spikes (a first-use kernel build
    riding a dispatch would poison a mean so badly that every later frame
    looked unmeetable). Thread-safe. Zero until the first observation --
    admission never sheds on a guess it has not earned.

    Keyed per ``(model, bucket)``: under a model zoo one global window
    mixed every model's rides, so a cheap aux-head ride (sub-ms) could
    drive the minimum down and make the heavy segmenter's deadlines look
    meetable (never shed, queue grows) -- or the segmenter's rides could
    make the aux head's generous deadlines look doomed. ``s_for(model)``
    answers the admission question per model (best case over that
    model's buckets only); the legacy ``.s`` property is the minimum
    over everything, exactly the old single-model behavior when only one
    model observes."""

    def __init__(self, window: int = 16):
        self._lock = threading.Lock()
        self._maxlen = max(1, int(window))
        self._windows: dict[tuple, deque[float]] = {}  # guarded_by: _lock
        self._n = 0  # guarded_by: _lock

    def observe(self, seconds: float,
                key: tuple | None = None) -> None:
        """One completed ride; ``key`` is ``(model, bucket)`` (None = the
        legacy un-keyed bucket)."""
        if seconds < 0:
            return
        key = DEFAULT_ESTIMATE_KEY if key is None else key
        with self._lock:
            self._n += 1
            win = self._windows.get(key)
            if win is None:
                win = self._windows[key] = deque(maxlen=self._maxlen)
            win.append(float(seconds))

    def s_for(self, model: str = "") -> float:
        """Best-case service time over ``model``'s keys only (0 = that
        model has no completed rides yet -- admission never sheds a
        model on another model's history)."""
        with self._lock:
            mins = [min(w) for k, w in self._windows.items()
                    if k[0] == model and w]
        return min(mins) if mins else 0.0

    @property
    def s(self) -> float:
        """Best-case per-frame service time in seconds over the recent
        window of EVERY key (0 = no observations yet) -- the pre-zoo
        single-model semantics."""
        with self._lock:
            mins = [min(w) for w in self._windows.values() if w]
        return min(mins) if mins else 0.0

    @property
    def observations(self) -> int:
        with self._lock:
            return self._n


def headroom(item: Any, now: float) -> float:
    """Seconds until ``item``'s deadline; inf when it carries none."""
    deadline_t = getattr(item, "deadline_t", None)
    if deadline_t is None:
        return float("inf")
    return deadline_t - now


class DeadlineQueue:
    """Bounded FIFO whose overflow policy understands deadlines.

    Args:
        max_backlog: queued-item cap (0 = every put at the cap sheds,
            exactly the old bounded-queue semantics).
        policy: "deadline" (least-headroom eviction at the cap) or
            "fifo" (reject the newcomer at the cap, PR 2 behavior).
        on_evict: called with each evicted item BEFORE the newcomer is
            admitted (the dispatcher error-completes the evictee's
            submitter here). Runs under the queue lock -- must not call
            back into the queue.
        clock: injectable monotonic clock for deterministic tests.
    """

    def __init__(self, max_backlog: int, policy: str = "deadline",
                 on_evict: Callable[[Any], None] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; one of {POLICIES}"
            )
        self.max_backlog = int(max_backlog)
        self.policy = policy
        self._on_evict = on_evict
        self._clock = clock
        # a Condition: the collector waits on it for the next frame
        self._cond = threading.Condition()
        self._items: deque[Any] = deque()  # guarded_by: _cond
        #: items shed by least-headroom eviction since construction
        self.evictions = 0  # guarded_by: _cond

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def put(self, item: Any, margin_s: float = 0.0) -> None:
        """Admit ``item``, evicting the least-headroom queued item when at
        the cap (deadline policy) or raising :class:`OverloadedError`.

        ``margin_s`` is the eviction hysteresis: the newcomer must beat
        the evictee's headroom by at least this much (the caller passes
        its service-time estimate), so FIFO-ordered frames with identical
        budgets never churn. ``None`` is the shutdown sentinel and always
        enqueues."""
        with self._cond:
            if item is not None and len(self._items) >= self.max_backlog:
                evicted = self._pick_eviction(item, margin_s)
                if evicted is None:
                    raise OverloadedError(
                        f"dispatcher backlog at cap ({self.max_backlog} "
                        "frames queued); shedding load"
                    )
                self._items.remove(evicted)
                self.evictions += 1
                if self._on_evict is not None:
                    self._on_evict(evicted)
            self._items.append(item)
            self._cond.notify()

    def _pick_eviction(self, newcomer: Any, margin_s: float) -> Any | None:
        """The queued item to shed in favor of ``newcomer``: the one with
        the least remaining headroom, and only when the newcomer beats it
        by ``margin_s``. None = shed the newcomer instead (fifo policy,
        empty queue, or no queued item is meaningfully worse off)."""
        if self.policy != "deadline" or not self._items:
            return None
        now = self._clock()
        candidates = [i for i in self._items if i is not None]
        if not candidates:
            return None
        worst = min(candidates, key=lambda i: headroom(i, now))
        worst_headroom = headroom(worst, now)
        if worst_headroom == float("inf"):
            return None  # nobody carries a deadline: position sheds
        if headroom(newcomer, now) > worst_headroom + max(margin_s, 1e-3):
            return worst
        return None

    def requeue(self, items: list[Any]) -> None:
        """Re-admit already-admitted items at the FRONT, preserving their
        relative order, never counting against the cap (chip failover:
        these frames hold submitters that are still waiting)."""
        with self._cond:
            for item in reversed(items):
                self._items.appendleft(item)
            self._cond.notify(len(items))

    def get(self, timeout: float | None = None) -> Any:
        """Pop the head; blocks (forever when ``timeout`` is None) and
        raises :class:`queue.Empty` on timeout -- the ``queue.Queue``
        contract the collector already speaks."""
        with self._cond:
            if timeout is None:
                while not self._items:
                    self._cond.wait()
            else:
                deadline = self._clock() + timeout
                while not self._items:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        raise queue.Empty
                    self._cond.wait(remaining)
            return self._items.popleft()

    def get_nowait(self) -> Any:
        with self._cond:
            if not self._items:
                raise queue.Empty
            return self._items.popleft()
