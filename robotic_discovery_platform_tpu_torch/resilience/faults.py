"""Deterministic fault injection at named call sites.

Real call sites (the REST tracking transport, registry resolution, the
frame analyzer, the batch collector's dispatch guard and the pipelined
completer's D2H guard) call ``inject("<site>")`` as their first
statement. With no faults configured that is a single falsy attribute
check -- production cost is nil. Chaos tests (or an operator running a
fire-drill) configure faults through the environment:

    RDP_FAULTS="tracking.rest.request:conn:2,serving.analyze:exc:1"

Grammar: a comma-separated list of ``site:kind:count`` triples.

- ``site``   the injection-point name (see ``fault_sites()`` for the
             sites a process has actually hit). ``*`` wildcards match
             per-instance site families: ``serving.chip.*.dispatch``
             arms every chip's dispatch site at once, while
             ``serving.chip.1.dispatch`` kills exactly chip 1 -- the
             quarantine/failover fire drill needs no code changes.
             An exact entry for a site wins over any wildcard.
- ``kind``   ``conn``   raise ``ConnectionError`` (transport refused),
             ``http500``/``http429`` raise :class:`InjectedHTTPError`
             with that status (server-side failure / throttling),
             ``slow``   sleep ``RDP_FAULT_SLOW_S`` seconds (default 0.05)
             then proceed (latency, not failure),
             ``exc``    raise ``RuntimeError`` (a compute bug).
- ``count``  how many times the fault fires before it is exhausted;
             ``-1`` or ``inf`` never exhausts (a sustained outage).

Tests drive the same machinery programmatically via
``configure_faults("...")`` and read back ``fired(site)`` to assert how
many times a dependency was actually touched (e.g. that an open circuit
breaker stopped calling the registry).
"""

from __future__ import annotations

import fnmatch
import os
import threading
import time
from dataclasses import dataclass

_ENV_VAR = "RDP_FAULTS"
_SLOW_ENV_VAR = "RDP_FAULT_SLOW_S"

_KINDS = ("conn", "http500", "http429", "slow", "exc")


class InjectedHTTPError(RuntimeError):
    """An injected HTTP-level failure; carries ``status`` like
    tracking.rest_backend.MlflowRestError so retry classification treats
    the two identically."""

    def __init__(self, site: str, status: int):
        super().__init__(f"injected HTTP {status} at {site!r}")
        self.status = status


@dataclass
class _Fault:
    site: str
    kind: str
    remaining: int | None  # None = unlimited (sustained outage)


class FaultRegistry:
    """Parsed fault specs plus per-site fire counters; thread-safe (the
    collector thread, the reload poller, and gRPC handler threads can all
    hit sites concurrently)."""

    def __init__(self, spec: str | None = None):
        self._lock = threading.Lock()
        self._faults: dict[str, list[_Fault]] = {}
        self._fired: dict[str, int] = {}
        self._visited: set[str] = set()
        self.configure(spec)

    def configure(self, spec: str | None) -> None:
        """(Re)load the fault table from a spec string; empty/None clears
        everything, including fire counters."""
        faults: dict[str, list[_Fault]] = {}
        for triple in (spec or "").split(","):
            triple = triple.strip()
            if not triple:
                continue
            parts = triple.split(":")
            if len(parts) != 3:
                raise ValueError(
                    f"bad fault spec {triple!r}; expected site:kind:count"
                )
            site, kind, count = parts
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; one of {_KINDS}"
                )
            remaining = (None if count in ("-1", "inf")
                         else int(count))
            faults.setdefault(site, []).append(_Fault(site, kind, remaining))
        with self._lock:
            self._faults = faults
            # wildcard specs (e.g. serving.chip.*.dispatch) are matched
            # only when no exact entry exists for the concrete site
            self._patterns = [s for s in faults if "*" in s]
            self._fired = {}

    def load_env(self) -> None:
        self.configure(os.environ.get(_ENV_VAR))

    @property
    def active(self) -> bool:
        return bool(self._faults)

    def inject(self, site: str) -> None:
        """Fire the next non-exhausted fault configured for ``site`` (one
        per call), or do nothing. The no-fault fast path takes no lock."""
        if not self._faults:
            return
        with self._lock:
            self._visited.add(site)
            configured = self._faults.get(site)
            if configured is None:
                for pattern in self._patterns:
                    if fnmatch.fnmatchcase(site, pattern):
                        configured = self._faults[pattern]
                        break
            fault = None
            for f in configured or ():
                if f.remaining is None or f.remaining > 0:
                    fault = f
                    break
            if fault is None:
                return
            if fault.remaining is not None:
                fault.remaining -= 1
            self._fired[site] = self._fired.get(site, 0) + 1
        self._fire(fault)

    def _fire(self, fault: _Fault) -> None:
        if fault.kind == "conn":
            raise ConnectionError(f"injected connection fault at "
                                  f"{fault.site!r}")
        if fault.kind == "http500":
            raise InjectedHTTPError(fault.site, 500)
        if fault.kind == "http429":
            raise InjectedHTTPError(fault.site, 429)
        if fault.kind == "exc":
            raise RuntimeError(f"injected fault at {fault.site!r}")
        # "slow": injected latency, then the real call proceeds
        time.sleep(float(os.environ.get(_SLOW_ENV_VAR, "0.05")))

    def fired(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)

    def sites(self) -> set[str]:
        """Every site this process has passed through while faults were
        configured (useful to discover valid spec names; the no-fault fast
        path records nothing, by design -- it must stay free)."""
        with self._lock:
            return set(self._visited)


# The process-global registry, seeded from the environment at import so a
# plain `RDP_FAULTS=... python -m ...serving.server` run injects without any
# code change. Tests reconfigure it via configure_faults().
REGISTRY = FaultRegistry(os.environ.get(_ENV_VAR))


def inject(site: str) -> None:
    REGISTRY.inject(site)


def configure_faults(spec: str | None) -> None:
    REGISTRY.configure(spec)


def fired(site: str) -> int:
    return REGISTRY.fired(site)


def fault_sites() -> set[str]:
    return REGISTRY.sites()
