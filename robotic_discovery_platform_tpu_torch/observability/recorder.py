"""Flight recorder: the last N dispatch timelines, always on.

Aggregate metrics (registry.py) answer "how often / how slow on average";
the question a tail-latency post-mortem actually asks is "what did THIS
slow dispatch spend its time on". The recorder keeps one
:class:`Timeline` -- a small tree of :class:`~.trace.SpanRecord`\\ s
(submit -> collect -> stage/H2D -> launch -> complete/D2H, labeled with
the routed chip and padded bucket) -- per batched dispatch in a bounded
ring, exposed as JSON at ``GET /debug/spans`` and summarized
``tracez``-style at ``GET /debug/tracez`` on the exposition server.

Ring semantics are "lock-free-ish": a single atomic counter
(``itertools.count`` -- one bytecode under the GIL) hands out slots,
writers store into their slot without further coordination, and readers
snapshot the slot list. A reader can observe a timeline that is one
write "old" for its slot; it can never see a torn one (slot stores are
single reference assignments). That is the right trade for an always-on
recorder riding the dispatch hot path.

Post-mortems must not race the ring: any timeline that completes with an
error -- and any watchdog-restart event -- is additionally **pinned**
into a separate bounded deque that ring wrap-around never touches, so
the offending evidence survives however much healthy traffic follows.

``RDP_SPAN_RING`` sizes the default ring (256 timelines).
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Iterable

from robotic_discovery_platform_tpu_torch.observability.trace import (
    SpanRecord,
    identity,
)
from robotic_discovery_platform_tpu_torch.utils.lockcheck import checked_lock

#: tracez-style latency buckets (ms) for the /debug/tracez summary
TRACEZ_BOUNDS_MS: tuple[float, ...] = (1.0, 10.0, 100.0, 1000.0)


class Timeline:
    """One dispatch's recorded span tree.

    Ownership is a hand-off, never shared: the collector builds it, the
    completer finishes it, and only then does it enter the recorder --
    so span appends need no lock. The first recorded span is the root by
    convention; children link to it via ``parent``."""

    __slots__ = ("name", "labels", "spans", "error", "seq",
                 "created_unix_s")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels: dict[str, str] = {
            str(k): str(v) for k, v in (labels or {}).items()
        }
        self.spans: list[SpanRecord] = []
        self.error: str | None = None
        self.seq = -1  # assigned when recorded
        self.created_unix_s = time.time()

    def span(self, name: str, start_ns: int, end_ns: int | None = None,
             parent: SpanRecord | None = None, trace_id: str | None = None,
             **attributes) -> SpanRecord:
        rec = SpanRecord(
            name=name,
            parent_id=parent.span_id if parent is not None else None,
            trace_id=trace_id,
            start_ns=int(start_ns),
            end_ns=None if end_ns is None else int(end_ns),
            attributes={k: str(v) for k, v in attributes.items()},
        )
        self.spans.append(rec)
        return rec

    @property
    def root(self) -> SpanRecord | None:
        return self.spans[0] if self.spans else None

    def fail(self, error: BaseException | str) -> "Timeline":
        if isinstance(error, BaseException):
            self.error = f"{type(error).__name__}: {error}"
        else:
            self.error = str(error)
        return self

    @property
    def duration_ms(self) -> float | None:
        return self.root.duration_ms if self.root is not None else None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seq": self.seq,
            "labels": dict(self.labels),
            "error": self.error,
            "created_unix_s": self.created_unix_s,
            "duration_ms": self.duration_ms,
            "spans": [s.to_dict() for s in self.spans],
        }


class FlightRecorder:
    """Bounded ring of recent timelines plus a pinned set of evidence.

    ``record`` is what the dispatch path calls (pins automatically when
    the timeline carries an error); ``record_event`` mints a tiny
    single-span timeline for point events (watchdog restarts, per-frame
    server errors)."""

    def __init__(self, capacity: int = 256, pin_capacity: int = 64):
        self._capacity = max(1, int(capacity))
        self._ring: list[Timeline | None] = [None] * self._capacity
        self._seq = itertools.count()
        self._pinned: deque[Timeline] = deque(maxlen=max(1, pin_capacity))  # guarded_by: _pin_lock
        self._pin_lock = checked_lock("recorder.pin")

    @property
    def capacity(self) -> int:
        return self._capacity

    def record(self, timeline: Timeline) -> Timeline:
        timeline.seq = next(self._seq)  # atomic under the GIL
        self._ring[timeline.seq % self._capacity] = timeline
        if timeline.error is not None:
            self.pin(timeline)
        return timeline

    def pin(self, timeline: Timeline) -> None:
        """Keep this timeline beyond ring wrap-around (error evidence)."""
        with self._pin_lock:
            if timeline not in self._pinned:
                self._pinned.append(timeline)

    def record_event(self, name: str, error: str | None = None,
                     trace_id: str | None = None, **labels) -> Timeline:
        tl = Timeline(name, labels)
        now = time.monotonic_ns()
        tl.span(name, start_ns=now, end_ns=now, trace_id=trace_id)
        if error is not None:
            tl.fail(error)
        return self.record(tl)

    def timelines(self) -> list[Timeline]:
        """Recent timelines, oldest first. Snapshot semantics: concurrent
        writers may overwrite slots mid-read, so entries are re-filtered
        by seq consistency rather than assumed stable."""
        seen = [t for t in list(self._ring) if t is not None]
        return sorted(seen, key=lambda t: t.seq)

    def pinned(self) -> list[Timeline]:
        with self._pin_lock:
            return list(self._pinned)

    def snapshot(self) -> dict:
        """The /debug/spans payload: recent + pinned, JSON-ready. Carries
        the process identity at top level (and every span carries its
        own host/role) so merged multi-process output -- the front-end's
        stitched ``/debug/trace`` -- stays attributable."""
        recent = self.timelines()
        host, role = identity()
        return {
            "host": host,
            "role": role,
            "capacity": self._capacity,
            "recorded_total": (recent[-1].seq + 1) if recent else 0,
            "recent": [t.to_dict() for t in recent],
            "pinned": [t.to_dict() for t in self.pinned()],
        }

    def summary(self) -> dict:
        """tracez-style rollup over the ring + pinned set: per span name,
        the count, how many rode an errored timeline, the max duration,
        and a small latency histogram -- the 10-second read before
        opening full timelines. ``groups`` repeats the rollup keyed by
        each span's ``role@host`` identity, so a summary over merged
        multi-process timelines splits per producer."""

        def _blank_row() -> dict:
            return {
                "count": 0, "errors": 0, "max_ms": 0.0,
                "latency_ms_le": {
                    **{str(b): 0 for b in TRACEZ_BOUNDS_MS},
                    "+Inf": 0,
                },
            }

        def _fold(row: dict, sp: SpanRecord, errored: bool) -> None:
            row["count"] += 1
            if errored:
                row["errors"] += 1
            dur = sp.duration_ms
            if dur is None:
                return
            row["max_ms"] = max(row["max_ms"], dur)
            for b in TRACEZ_BOUNDS_MS:
                if dur <= b:
                    row["latency_ms_le"][str(b)] += 1
                    break
            else:
                row["latency_ms_le"]["+Inf"] += 1

        rows: dict[str, dict] = {}
        groups: dict[str, dict] = {}
        seen: set[int] = set()
        all_tl: Iterable[Timeline] = [*self.timelines(), *self.pinned()]
        for tl in all_tl:
            if id(tl) in seen:
                continue
            seen.add(id(tl))
            for sp in tl.spans:
                errored = tl.error is not None
                _fold(rows.setdefault(sp.name, _blank_row()), sp, errored)
                group = groups.setdefault(
                    f"{sp.role or '-'}@{sp.host or '-'}", {"spans": {}})
                _fold(group["spans"].setdefault(sp.name, _blank_row()),
                      sp, errored)
        return {"spans": rows, "groups": groups, "timelines": len(seen)}


def _resolve_capacity() -> int:
    """RDP_SPAN_RING resolver: ring size, unparsable falls back."""
    raw = os.environ.get("RDP_SPAN_RING", "").strip()
    try:
        return int(raw) if raw else 256
    except ValueError:
        return 256


#: The process-global recorder the dispatcher and exposition share.
RECORDER = FlightRecorder(_resolve_capacity())
