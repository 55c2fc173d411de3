"""Lightweight spans with W3C-style ``traceparent`` propagation.

One gRPC analysis stream is one trace: the client mints a 16-byte trace ID,
sends it as ``traceparent`` call metadata (the W3C Trace Context header
format, ``00-<trace_id>-<span_id>-<flags>``), and the server adopts it for
the stream handler's lifetime. Every span within the stream (per-frame
work, batched dispatch) shares the trace ID with a fresh span ID, and a
``logging`` record factory stamps the current trace ID onto **every log
record in the process**, so one grep over client + server logs follows a
single frame's journey end to end.

Context lives in a ``contextvars.ContextVar``: correct across the gRPC
thread pool's handler threads without any thread-local bookkeeping.
Threads spawned mid-span (the batch collector) do NOT inherit it --
cross-thread hops carry the ``SpanContext`` object explicitly (see
``serving/batching._Pending.trace``).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import re
import socket
import time
from dataclasses import dataclass, field
from typing import Iterable

TRACEPARENT = "traceparent"

# -- process identity --------------------------------------------------------
#
# Fleet observability merges span and event output from N processes (the
# front-end stitches /debug/trace across replicas); every recorded span
# and journal event is stamped with WHERE it happened so the merged view
# stays attributable. Identity is per-process on purpose -- "replica" vs
# "frontend" is a deployment role, and one process plays one role.

_host: str = f"{socket.gethostname()}:{os.getpid()}"
_role: str = "process"


def set_identity(host: str | None = None, role: str | None = None) -> None:
    """Declare this process's observability identity. ``build_server``
    sets role="replica", ``build_frontend`` sets role="frontend"; the
    host defaults to ``hostname:pid`` (unique per process on one box)."""
    global _host, _role
    if host is not None:
        _host = str(host)
    if role is not None:
        _role = str(role)


def identity() -> tuple[str, str]:
    """The (host, role) pair stamped onto spans and journal events."""
    return _host, _role

_TP_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

_current: contextvars.ContextVar["SpanContext | None"] = (
    # a contextvar name, not a metric family, despite the rdp_ prefix
    contextvars.ContextVar(
        "rdp_trace_context", default=None  # statecheck: disable=SC004
    )
)


@dataclass(frozen=True)
class SpanContext:
    """The propagated identity of one span: W3C trace-id (32 hex) +
    span-id (16 hex)."""

    trace_id: str
    span_id: str
    flags: str = "01"  # sampled

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


@dataclass
class Span:
    """One timed operation; ``duration_s`` is set when the span closes.
    ``start_ns``/``end_ns`` are ``time.monotonic_ns`` stamps (comparable
    across threads within the process) and ``attributes`` carry string
    key/values -- both feed :class:`SpanRecord` conversion for the flight
    recorder."""

    name: str
    context: SpanContext
    started_at: float = field(default_factory=time.perf_counter)
    duration_s: float | None = None
    start_ns: int = field(default_factory=time.monotonic_ns)
    end_ns: int | None = None
    attributes: dict[str, str] = field(default_factory=dict)

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    def set_attribute(self, key: str, value) -> None:
        self.attributes[str(key)] = str(value)


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclass
class SpanRecord:
    """One *recorded* span: inert data for the flight recorder's ring and
    the ``/debug/spans`` JSON, as opposed to :class:`Span` (the live,
    contextvar-scoped object). Start/end are ``time.monotonic_ns`` stamps
    -- nanosecond resolution, comparable across the pipeline's threads --
    with an explicit parent link and string attributes, so a timeline's
    span tree reconstructs without any contextvar state."""

    name: str
    span_id: str = field(default_factory=lambda: _hex_id(8))
    parent_id: str | None = None
    trace_id: str | None = None
    start_ns: int = 0
    end_ns: int | None = None
    attributes: dict[str, str] = field(default_factory=dict)
    # stamped at creation from the process identity: merged multi-process
    # span output (the front-end's stitched /debug/trace) stays
    # attributable to the host and role that produced each span
    host: str = field(default_factory=lambda: _host)
    role: str = field(default_factory=lambda: _role)

    def end(self, ns: int | None = None) -> "SpanRecord":
        self.end_ns = time.monotonic_ns() if ns is None else int(ns)
        return self

    @property
    def duration_ms(self) -> float | None:
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "duration_ms": self.duration_ms,
            "attributes": dict(self.attributes),
            "host": self.host,
            "role": self.role,
        }


def new_context(parent: SpanContext | None = None) -> SpanContext:
    """A fresh span context: child of ``parent`` (same trace ID) when
    given, a brand-new trace otherwise."""
    trace_id = parent.trace_id if parent is not None else _hex_id(16)
    return SpanContext(trace_id=trace_id, span_id=_hex_id(8))


def current() -> SpanContext | None:
    return _current.get()


def current_trace_id() -> str | None:
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else None


@contextlib.contextmanager
def span(name: str, parent: SpanContext | None = None):
    """Run a block inside a span. Parent resolution: explicit ``parent``
    wins (remote contexts from gRPC metadata), else the calling context's
    current span, else a new trace is minted."""
    ctx = new_context(parent if parent is not None else _current.get())
    sp = Span(name=name, context=ctx)
    token = _current.set(ctx)
    try:
        yield sp
    finally:
        _current.reset(token)
        sp.end_ns = time.monotonic_ns()
        sp.duration_s = time.perf_counter() - sp.started_at


@contextlib.contextmanager
def use(ctx: SpanContext | None):
    """Enter an existing context verbatim (cross-thread handoff: the
    receiving thread re-enters the context the submitting thread carried
    over). ``None`` is a no-op so call sites need no branching."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def parse_traceparent(value: str) -> SpanContext | None:
    """A ``SpanContext`` from a W3C traceparent header; None when the
    value is malformed or carries the all-zero (invalid) IDs -- a bad
    header must degrade to "new trace", never to an error."""
    m = _TP_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return SpanContext(trace_id=trace_id, span_id=span_id, flags=flags)


def to_metadata(ctx: SpanContext) -> tuple[tuple[str, str], ...]:
    """gRPC call metadata carrying this context."""
    return ((TRACEPARENT, ctx.traceparent()),)


def from_metadata(
    metadata: Iterable[tuple[str, str]] | None,
) -> SpanContext | None:
    """The remote context from gRPC invocation metadata, if any."""
    if metadata is None:
        return None
    for key, value in metadata:
        if key.lower() == TRACEPARENT:
            return parse_traceparent(value)
    return None


# -- log correlation ---------------------------------------------------------

_factory_installed = False


def install_log_correlation() -> None:
    """Stamp ``record.trace_id`` onto every log record in the process
    (the current trace ID, or "-" outside any span). A record *factory*
    rather than a handler filter so the attribute exists no matter which
    handler -- ours, pytest's caplog, a user's -- formats the record.
    Idempotent."""
    global _factory_installed
    if _factory_installed:
        return
    _factory_installed = True
    inner = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        record = inner(*args, **kwargs)
        trace_id = current_trace_id()
        # a factory installed before this one (another package's copy of
        # this module, in a process that loads both) may have stamped the
        # record already: keep its stamp unless this module has a span
        if trace_id is not None or not hasattr(record, "trace_id"):
            record.trace_id = trace_id or "-"
        return record

    logging.setLogRecordFactory(factory)
