"""Runtime lock sanitizer: instrumented locks that catch ordering bugs
while the tests can still see them.

The platform is a deeply threaded serving system (collector / completer /
watchdog, controller ticks, fleet pump threads, health pollers, metrics
writers); ``analysis/racecheck.py`` proves lock discipline *statically*,
and this module is its runtime half -- the checks static analysis cannot
close over dynamic callgraphs:

- **order inversions**: every instrumented acquisition records the edge
  ``held -> acquired`` in a process-global order graph; acquiring in the
  opposite order of an edge seen anywhere else in the process is a
  potential deadlock (two threads interleaving those two code paths can
  block forever) and raises :class:`LockOrderInversion` in strict mode
  *before* the acquisition can actually deadlock;
- **re-acquisition**: a thread acquiring a non-reentrant lock it already
  holds would deadlock silently; strict mode raises instead;
- **hold-time violations**: a lock held longer than
  ``RDP_LOCKCHECK_HOLD_S`` (default 30 s) means a blocking call snuck
  under it (the RC003 class of bug, dynamically).

Deployment knob (same env conventions as ``RDP_RECOMPILE_STRICT`` /
``RDP_TRANSFER_GUARD``): ``RDP_LOCKCHECK=strict`` raises on violations,
``RDP_LOCKCHECK=warn`` logs and records them (:func:`violations`), unset
or ``off`` swaps in a plain ``threading.Lock`` -- the default costs
nothing on the serving hot path.

Usage -- modules declare locks through the factory instead of
constructing ``threading.Lock`` directly::

    self._lock = lockcheck.checked_lock("batching.pending")

The name is the lock's identity in the order graph; per-instance locks
sharing a name (every metric family's lock, every breaker's lock) are
tracked per *object* for re-acquisition/hold checks but excluded from
same-name order edges (two same-named objects carry no global order).

``held_locks()`` snapshots every instrumented lock currently held in the
process -- the test suite's thread-leak fixture asserts it is empty after
every test.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Callable

# stdlib logger, not utils.logging.get_logger: lockcheck sits BELOW
# everything (resilience, observability, serving all construct locks
# through it), so it must import nothing that could import it back
log = logging.getLogger(__name__)

_ENV_VAR = "RDP_LOCKCHECK"
_HOLD_ENV_VAR = "RDP_LOCKCHECK_HOLD_S"
DEFAULT_HOLD_S = 30.0

MODES = ("off", "warn", "strict")


class LockCheckError(RuntimeError):
    """Base class for lock-sanitizer violations."""


class LockOrderInversion(LockCheckError):
    """Two locks were acquired in both orders somewhere in this process:
    threads interleaving those paths can deadlock."""


class LockReacquired(LockCheckError):
    """A thread acquired a non-reentrant lock it already holds (this
    would deadlock with a plain ``threading.Lock``)."""


class LockHeldTooLong(LockCheckError):
    """A lock was held across something slow (blocking call, device
    sync); every other thread needing it stalled for the duration."""


def resolve_lockcheck() -> str:
    """The effective sanitizer mode: ``RDP_LOCKCHECK`` normalized to one
    of ``off``/``warn``/``strict`` (unknown values mean ``off`` so a typo
    can never take down serving)."""
    raw = os.environ.get(_ENV_VAR, "").strip().lower()
    if raw in ("strict", "raise", "1", "true", "on"):
        return "strict"
    if raw in ("warn", "log"):
        return "warn"
    return "off"


def resolve_hold_s() -> float:
    raw = os.environ.get(_HOLD_ENV_VAR, "").strip()
    try:
        return float(raw) if raw else DEFAULT_HOLD_S
    except ValueError:
        return DEFAULT_HOLD_S


# -- process-global sanitizer state -----------------------------------------
#
# One plain (uninstrumented) lock guards the order graph, the held-lock
# map, and the violation list; instrumented locks never nest inside it
# (every graph update is a dict operation, nothing blocks).

_state_lock = threading.Lock()
# (earlier, later) lock-name pair -> "site" string of the acquisition that
# first established the order
_edges: dict[tuple[str, str], str] = {}
# thread ident -> [(InstrumentedLock, acquire_site, acquire_t), ...]
_held: dict[int, list[tuple["InstrumentedLock", str, float]]] = {}
# violations recorded in warn mode (strict raises instead)
_violations: list[str] = []


def _record_violation(kind: type[LockCheckError], msg: str,
                      strict: bool) -> None:
    if strict:
        raise kind(msg)
    with _state_lock:
        _violations.append(f"{kind.__name__}: {msg}")
    log.warning("lockcheck: %s: %s", kind.__name__, msg)


def violations() -> list[str]:
    """Violations recorded so far in warn mode (strict mode raises at the
    offending acquisition instead of recording)."""
    with _state_lock:
        return list(_violations)


def held_locks() -> list[tuple[str, str]]:
    """Every instrumented lock currently held, as (thread name or ident,
    lock name) pairs -- the thread-leak fixture asserts this is empty."""
    by_ident = {t.ident: t.name for t in threading.enumerate()}
    with _state_lock:
        return [
            (by_ident.get(ident, str(ident)), lk.name)
            for ident, stack in _held.items()
            for (lk, _site, _t) in stack
        ]


def reset() -> None:
    """Drop the order graph, held map, and recorded violations (test
    isolation; a production process never calls this)."""
    with _state_lock:
        _edges.clear()
        _held.clear()
        _violations.clear()


def _call_site(depth: int = 2) -> str:
    """file:line of the acquiring frame -- cheap (no traceback walk).
    Skips this module's own frames so a ``with lock:`` acquisition names
    the caller, not ``__enter__``."""
    try:
        f = sys._getframe(depth)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:  # pragma: no cover - shallow stack
            return "<unknown>"
        return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
    except ValueError:  # pragma: no cover - shallow stack
        return "<unknown>"


class InstrumentedLock:
    """A ``threading.Lock`` wrapper that feeds the sanitizer state.

    API-compatible with the subset of the Lock interface the platform
    uses (``acquire``/``release``/``locked``/context manager), so it can
    stand in anywhere :func:`checked_lock` is used -- including as the
    per-family lock metric children share."""

    __slots__ = ("name", "_lock", "_strict", "_hold_s",
                 "_clock")

    def __init__(self, name: str, strict: bool,
                 hold_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._lock = threading.Lock()
        self._strict = strict
        self._hold_s = hold_s if hold_s is not None else resolve_hold_s()
        self._clock = clock

    # -- checks --------------------------------------------------------------

    def _check_before_acquire(self, site: str) -> None:
        ident = threading.get_ident()
        with _state_lock:
            stack = _held.get(ident, [])
            for (held, held_site, _t) in stack:
                if held is self:
                    _held_site = held_site
                    break
            else:
                _held_site = None
        if _held_site is not None:
            _record_violation(
                LockReacquired,
                f"thread {threading.current_thread().name!r} re-acquired "
                f"{self.name!r} at {site} while already holding it "
                f"(acquired at {_held_site}); a plain Lock would deadlock "
                "here",
                self._strict,
            )
            return
        # order edges: for every DISTINCT lock name currently held, the
        # acquisition establishes held -> self; the reverse edge having
        # been observed anywhere in the process is a potential deadlock
        with _state_lock:
            stack = list(_held.get(ident, []))
            inversions = []
            for (held, held_site, _t) in stack:
                if held.name == self.name:
                    continue  # same-name siblings carry no global order
                reverse = _edges.get((self.name, held.name))
                if reverse is not None:
                    inversions.append((held, held_site, reverse))
                else:
                    _edges.setdefault((held.name, self.name), site)
        for (held, held_site, reverse_site) in inversions:
            _record_violation(
                LockOrderInversion,
                f"acquiring {self.name!r} at {site} while holding "
                f"{held.name!r} (acquired at {held_site}), but the "
                f"opposite order {self.name!r} -> {held.name!r} was "
                f"established at {reverse_site}; interleaved threads can "
                "deadlock on this pair",
                self._strict,
            )

    def _push_held(self, site: str) -> None:
        ident = threading.get_ident()
        with _state_lock:
            _held.setdefault(ident, []).append(
                (self, site, self._clock())
            )

    def _pop_held(self) -> None:
        ident = threading.get_ident()
        acquired_t = None
        site = "<unknown>"
        with _state_lock:
            stack = _held.get(ident)
            if stack:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][0] is self:
                        (_lk, site, acquired_t) = stack.pop(i)
                        break
                if not stack:
                    del _held[ident]
        if acquired_t is not None and self._hold_s > 0:
            held_for = self._clock() - acquired_t
            if held_for > self._hold_s:
                _record_violation(
                    LockHeldTooLong,
                    f"{self.name!r} held {held_for:.2f}s (> "
                    f"{self._hold_s:.1f}s budget) since {site}; something "
                    "slow ran under it",
                    self._strict,
                )

    # -- Lock API ------------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        site = _call_site()
        self._check_before_acquire(site)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._push_held(site)
        return got

    def release(self) -> None:
        self._pop_held()
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"InstrumentedLock({self.name!r})"


def checked_lock(name: str):
    """A lock for ``name`` under the current sanitizer mode: a plain
    ``threading.Lock`` when ``RDP_LOCKCHECK`` is off (the production
    default -- zero overhead), an :class:`InstrumentedLock` feeding the
    process-global order graph otherwise.

    The mode is resolved per call, so a test that sets the env (or uses
    monkeypatch) before constructing the object under test gets
    instrumented locks without any process-wide switch."""
    mode = resolve_lockcheck()
    if mode == "off":
        return threading.Lock()
    return InstrumentedLock(name, strict=(mode == "strict"))
