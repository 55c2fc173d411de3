"""Structured event journal: the fleet's control-plane flight log.

The flight recorder (recorder.py) answers "what did this DISPATCH spend
its time on"; metrics answer "how often". Neither answers the incident
question -- "what happened, in what order" -- without grepping logs:
breaker and quarantine transitions, controller and brownout actions,
rollout stage changes, drift recommendations, watchdog restarts, zoo
rebalances, and fleet membership/failover decisions were each pinned or
logged by their own subsystem in its own shape. This module unifies them
into ONE bounded append-only log of structured :class:`Event`\\ s:

- a **monotonic cursor** (``seq``, strictly increasing under one lock):
  causal order within the process is the read order, and a consumer that
  remembers ``next_cursor`` tails the journal incrementally with
  ``GET /debug/events?since=<cursor>`` (exposition.py);
- every event is stamped with the process **identity**
  (:func:`~.trace.identity` -- host + role) so merged multi-process
  journals stay attributable, and with the **current trace ID** when one
  is in scope -- an event caused by a specific frame joins that frame's
  distributed trace;
- bounded (``RDP_JOURNAL_RING``, default 1024 events): the ring drops the
  oldest, and the snapshot reports how many events a ``since`` cursor
  missed (``dropped``) so a lagging consumer knows it has a gap instead
  of silently reading a hole.

Like resilience/, the journal stays import-light (trace + lockcheck
only): metric counting rides injectable observer hooks that
observability/instruments.py installs (``rdp_journal_events_total`` by
kind, ``rdp_journal_dropped_total``).
"""

from __future__ import annotations

import itertools
import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from robotic_discovery_platform_tpu_torch.observability import trace
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock

#: observer hooks installed by instruments.py (kept injectable so this
#: module never imports the metrics registry)
_on_event: Callable[[str], None] | None = None
_on_drop: Callable[[int], None] | None = None
_on_persist: Callable[[int], None] | None = None
_on_persist_error: Callable[[int], None] | None = None


def set_observer(on_event: Callable[[str], None] | None,
                 on_drop: Callable[[int], None] | None = None) -> None:
    global _on_event, _on_drop
    _on_event = on_event
    _on_drop = on_drop


def set_persist_observer(
        on_persist: Callable[[int], None] | None,
        on_error: Callable[[int], None] | None = None) -> None:
    global _on_persist, _on_persist_error
    _on_persist = on_persist
    _on_persist_error = on_error


@dataclass(frozen=True)
class Event:
    """One structured journal entry. ``seq`` is the process-wide cursor
    (strictly increasing); ``attrs`` are string key/values specific to
    the kind (replica endpoint, breaker name, rollout stage, ...)."""

    seq: int
    unix_ts: float
    kind: str
    message: str = ""
    trace_id: str | None = None
    host: str = ""
    role: str = ""
    attrs: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "unix_ts": self.unix_ts,
            "kind": self.kind,
            "message": self.message,
            "trace_id": self.trace_id,
            "host": self.host,
            "role": self.role,
            "attrs": dict(self.attrs),
        }


class JournalFile:
    """Best-effort JSONL sink for the journal (``RDP_JOURNAL_PATH``):
    each event appended as one JSON line so a SIGKILLed member's journal
    survives on disk for post-mortem merge (``tools/journal_tail.py``).
    Rotation is single-generation and bounded: when the file would
    exceed ``rotate_bytes`` it is renamed to ``<path>.1`` (replacing any
    previous generation) and a fresh file starts -- worst case
    ~2x rotate_bytes on disk. Failures count, never raise: the
    in-memory ring stays authoritative."""

    def __init__(self, path: str, rotate_bytes: int = 4 * 1024 * 1024):
        self.path = str(path)
        self.rotate_bytes = max(4096, int(rotate_bytes))
        self._lock = checked_lock("journal.file")
        try:
            self._size = os.path.getsize(self.path)  # guarded_by: _lock
        except OSError:
            self._size = 0

    def write(self, event: Event) -> bool:
        line = json.dumps(event.to_dict(), sort_keys=True) + "\n"
        data = line.encode("utf-8")
        try:
            with self._lock:
                if self._size and self._size + len(data) > self.rotate_bytes:
                    os.replace(self.path, self.path + ".1")
                    self._size = 0
                with open(self.path, "ab") as f:
                    f.write(data)
                self._size += len(data)
        except OSError:
            if _on_persist_error is not None:
                _on_persist_error(1)
            return False
        if _on_persist is not None:
            _on_persist(1)
        return True


class EventJournal:
    """Bounded, append-only, thread-safe event log with a monotonic
    cursor. ``append`` is what every instrumented control-plane site
    calls; readers tail with :meth:`events_since` / :meth:`snapshot`."""

    def __init__(self, capacity: int = 1024,
                 sink: JournalFile | None = None):
        self._capacity = max(1, int(capacity))
        self._lock = checked_lock("journal.events")
        self._events: deque[Event] = deque(
            maxlen=self._capacity)  # guarded_by: _lock
        self._seq = itertools.count()  # guarded_by: _lock
        self._dropped = 0  # guarded_by: _lock
        self._enabled = True
        self._sink = sink

    def set_sink(self, sink: JournalFile | None) -> None:
        self._sink = sink

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        """Gate appends (the observability-overhead bench's off leg).
        Reads keep working; the cursor does not advance while disabled."""
        self._enabled = bool(enabled)

    def append(self, kind: str, message: str = "",
               trace_id: str | None = None, **attrs) -> Event | None:
        """Record one event. ``trace_id`` defaults to the calling
        context's current trace (None when outside any span), so an
        event raised while serving a frame joins that frame's distributed
        trace without the call site threading anything through."""
        if not self._enabled:
            return None
        if trace_id is None:
            trace_id = trace.current_trace_id()
        host, role = trace.identity()
        with self._lock:
            dropping = len(self._events) == self._capacity
            event = Event(
                seq=next(self._seq),
                unix_ts=time.time(),
                kind=str(kind),
                message=str(message),
                trace_id=trace_id,
                host=host,
                role=role,
                attrs={str(k): str(v) for k, v in attrs.items()},
            )
            self._events.append(event)
            if dropping:
                self._dropped += 1
        # persistence outside the ring lock: the file sink serializes on
        # its own lock, so a slow disk never stalls readers of the ring
        if self._sink is not None:
            self._sink.write(event)
        if _on_event is not None:
            _on_event(event.kind)
        if dropping and _on_drop is not None:
            _on_drop(1)
        return event

    def events_since(self, cursor: int = 0) -> list[Event]:
        """Events with ``seq >= cursor``, oldest first (causal order)."""
        with self._lock:
            return [e for e in self._events if e.seq >= cursor]

    def snapshot(self, since: int = 0) -> dict:
        """The ``/debug/events?since=N`` payload: the retained events at
        or past the cursor, the cursor to resume from, and how many
        events the ring dropped before the reader caught up (a non-zero
        ``dropped`` means the consumer has a gap, not a complete log)."""
        since = max(0, int(since))
        with self._lock:
            events = [e for e in self._events if e.seq >= since]
            oldest = self._events[0].seq if self._events else 0
            next_cursor = (self._events[-1].seq + 1 if self._events
                           else 0)
            dropped_total = self._dropped
        host, role = trace.identity()
        return {
            "host": host,
            "role": role,
            "enabled": self._enabled,
            "capacity": self._capacity,
            "since": since,
            "next_cursor": next_cursor,
            "dropped": max(0, oldest - since),
            "dropped_total": dropped_total,
            "events": [e.to_dict() for e in events],
        }


def _resolve_capacity() -> int:
    """RDP_JOURNAL_RING resolver: ring size, unparsable falls back."""
    raw = os.environ.get("RDP_JOURNAL_RING", "").strip()
    try:
        return int(raw) if raw else 1024
    except ValueError:
        return 1024


def resolve_journal_path() -> str | None:
    """RDP_JOURNAL_PATH resolver: where (if anywhere) to persist each
    journal event as a JSON line. Unset/empty means in-memory only."""
    raw = os.environ.get("RDP_JOURNAL_PATH", "").strip()
    return raw or None


def resolve_journal_rotate_bytes() -> int:
    """RDP_JOURNAL_ROTATE_BYTES resolver: rotation threshold for the
    persisted journal (default 4 MiB; floor 4 KiB applied by the sink)."""
    raw = os.environ.get("RDP_JOURNAL_ROTATE_BYTES", "").strip()
    try:
        return int(raw) if raw else 4 * 1024 * 1024
    except ValueError:
        return 4 * 1024 * 1024


def _resolve_sink() -> JournalFile | None:
    path = resolve_journal_path()
    if path is None:
        return None
    return JournalFile(path, resolve_journal_rotate_bytes())


#: The process-global journal every instrumented subsystem appends to and
#: the exposition server's /debug/events reads.
JOURNAL = EventJournal(_resolve_capacity(), sink=_resolve_sink())
